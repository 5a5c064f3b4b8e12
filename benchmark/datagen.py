"""Seeded inputs: the corpus, its labels and the queries of a cell.

The real vectors of the sources cannot be fetched, so each configuration
states the distribution it assumes (``data`` in its file): values drawn
uniformly from ``[low, high)`` in float32, the sources' uint8 range, and
labels drawn uniformly from ``num_labels`` classes. Values are exact in
float32, stored as float64 in the program's ``KNNInput``, so staging them
in float32 loses nothing and the float64 reference sees the same numbers.

The corpus and the batch queries are drawn on the device with a
``torch.Generator`` in a few large calls; the served queries are drawn on
the host with numpy (the load generator, a process without torch, draws
the same ones). Every stream has its own seed derived from ``--seed``.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Tuple

import numpy as np


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of a run's ``--seed`` (any
    whole number, negative or beyond 64 bits included)."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _value_range(config: Dict[str, Any]) -> Tuple[float, float]:
    d = config["data"]
    return float(d["low"]), float(d["high"])


def corpus(config: Dict[str, Any], seed: int, device) -> Tuple[Any, Any]:
    """(attrs (N, A) float32, labels (N,) int32) on ``device``."""
    import torch
    n, a = int(config["num_data"]), int(config["num_attrs"])
    lo, hi = _value_range(config)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "corpus"))
    attrs = torch.rand((n, a), generator=g, device=device,
                       dtype=torch.float32)
    attrs.mul_(hi - lo).add_(lo)
    labels = torch.randint(0, int(config["num_labels"]), (n,), generator=g,
                           device=device, dtype=torch.int32)
    return attrs, labels


def batch_queries(config: Dict[str, Any], seed: int, device):
    """The batch query set (Q, A) float32 on ``device``."""
    import torch
    q, a = int(config["num_queries"]), int(config["num_attrs"])
    lo, hi = _value_range(config)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "batch_queries"))
    out = torch.rand((q, a), generator=g, device=device, dtype=torch.float32)
    return out.mul_(hi - lo).add_(lo)


def request_queries(config: Dict[str, Any], seed: int, count: int,
                    stream: str = "request_queries") -> np.ndarray:
    """``count`` served query rows (count, A), float32 values as float64:
    the same on every host for one seed and stream."""
    lo, hi = _value_range(config)
    rng = np.random.default_rng(stream_seed(seed, stream))
    v = rng.random((count, int(config["num_attrs"])), dtype=np.float32)
    v *= np.float32(hi - lo)
    v += np.float32(lo)
    return v.astype(np.float64)


def arrival_offsets(rate_per_s: float, seconds: float,
                    seed: int) -> np.ndarray:
    """Open-loop Poisson arrivals at ``rate_per_s`` over ``seconds``, as
    sorted offsets in seconds. Every seed gets the same set of gaps, the
    quantiles of the exponential distribution, in its own order: the seed
    changes when bursts come, never how much work a run offers."""
    count = max(1, int(round(rate_per_s * seconds)))
    u = (np.arange(count, dtype=np.float64) + 0.5) / count
    gaps = -np.log1p(-u) / rate_per_s
    gaps *= seconds / gaps.sum()
    rng = np.random.default_rng(stream_seed(seed, "arrivals"))
    rng.shuffle(gaps)
    return np.cumsum(gaps) - gaps[0]
