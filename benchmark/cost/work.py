"""The work a k-NN solve needs, from its shapes alone.

Frozen here so that no change to the program can change what its
rooflines are measured against:

- operations: 2 * Q * N * A, the dense distance products of every query
  against every row, whatever the program prunes or gates;
- bytes: the corpus and the queries read once in float32, each query's k
  result entries (a float32 distance and an int32 id) written once.
"""

from __future__ import annotations

VALUE_BYTES = 4
RESULT_ENTRY_BYTES = 8


def dense_flops(q: int, n: int, a: int) -> float:
    return 2.0 * q * n * a


def min_bytes(q: int, n: int, a: int, k: int) -> float:
    return float(VALUE_BYTES * (n * a + q * a) + RESULT_ENTRY_BYTES * q * k)


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: the larger of the operations
    over its highest dense rate and the bytes over its memory
    bandwidth."""
    return max(flops / peaks["dense_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])
