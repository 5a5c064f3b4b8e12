"""The order-sensitive FNV-1a result checksum — the correctness contract.

Reference: common.cpp:57-71. The oracle folds, in order:

1. the predicted label (cast to unsigned 64-bit);
2. each neighbor id **+ 1** ("+1 to distinguish from -1 sentinel",
   common.cpp:66), in report order (distance asc, tie -> larger id,
   engine.cpp:334-338).

Any deviation in k-selection, tie-breaking, vote, or ordering changes the
value, which is what makes it a differential-testing oracle (survey §4).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

FNV_BASIS = 1469598103934665603  # common.cpp:59
FNV_PRIME = 1099511628211        # common.cpp:62
_MASK = (1 << 64) - 1


def fnv1a_checksum(label: int, neighbor_ids: Iterable[int]) -> int:
    """Checksum of one query result (exact reimplementation of common.cpp:57-71).

    ``label`` and ids are folded with C++ ``static_cast<unsigned long long>``
    semantics: negative values wrap mod 2**64 (so the -1 sentinel id folds in
    as (+1 =) 0, and a -1 label folds as 2**64-1).
    """
    c = FNV_BASIS
    c ^= int(label) & _MASK
    c = (c * FNV_PRIME) & _MASK
    for idx in neighbor_ids:
        c ^= (int(idx) + 1) & _MASK
        c = (c * FNV_PRIME) & _MASK
    return c


def fnv1a_checksum_batch(labels: Sequence[int], neighbor_ids: np.ndarray,
                         valid_counts: Sequence[int]) -> np.ndarray:
    """Vectorized checksums for a batch of query results.

    Args:
      labels: (Q,) predicted labels.
      neighbor_ids: (Q, Kmax) neighbor ids in report order; entries at or
        beyond each query's valid count are ignored.
      valid_counts: (Q,) number of reported neighbors per query (its k).

    Returns:
      (Q,) uint64-valued Python-int array (dtype object to avoid overflow
      surprises in downstream formatting).
    """
    out = np.empty(len(labels), dtype=object)
    ids = np.asarray(neighbor_ids)
    for qi in range(len(labels)):
        out[qi] = fnv1a_checksum(int(labels[qi]), ids[qi, : int(valid_counts[qi])])
    return out
