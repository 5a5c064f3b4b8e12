"""In-process metrics registry — the registry half of
``dmlp_tpu/obs/telemetry.py``.

A thread-safe store of counters, gauges and streaming histograms, and one
process-wide :func:`registry`. It is what the serving daemon's ``stats``
op and its admission controller read. Histograms use the reference's
fixed log-spaced buckets (:data:`HIST_BUCKETS_PER_DECADE` per decade), so
a quantile carries the same bounded relative error
(:data:`HIST_QUANTILE_REL_ERROR`) with O(1) memory per metric.

The reference's telemetry sessions, sampler, flight recorder, sliding
windows, exemplars and OpenMetrics export are ROADMAP item A13 and are
not here.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, List, Optional

#: log-spaced buckets per decade; 20 -> adjacent bounds grow by 10^0.05
HIST_BUCKETS_PER_DECADE = 20
#: smallest finite bucket upper bound, and the decades covered (values
#: outside clamp into the first / overflow bucket; min/max stay exact)
HIST_LO = 1e-3
HIST_DECADES = 10
#: a quantile estimate is the geometric midpoint of its bucket: the
#: worst-case relative error is sqrt(growth) - 1, about 5.9%
HIST_QUANTILE_REL_ERROR = 10 ** (1 / (2 * HIST_BUCKETS_PER_DECADE)) - 1

_GROWTH = 10 ** (1.0 / HIST_BUCKETS_PER_DECADE)
_NBUCKETS = HIST_DECADES * HIST_BUCKETS_PER_DECADE
#: bucket i covers (bounds[i-1], bounds[i]]
_BOUNDS = tuple(HIST_LO * _GROWTH ** (i + 1) for i in range(_NBUCKETS))

#: metric names are snake_case dotted paths
NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)*$")


class Counter:
    """Monotonic counter, optionally split by one label value."""

    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {}

    def inc(self, v: float = 1.0, label: str = "") -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._values[label] = self._values.get(label, 0.0) + v

    def value(self, label: str = "") -> float:
        with self._lock:
            return self._values.get(label, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def by_label(self) -> Dict[str, float]:
        with self._lock:
            return {k: v for k, v in self._values.items() if k}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {"kind": self.kind,
                                   "total": sum(self._values.values())}
            labeled = {k: v for k, v in self._values.items() if k}
            if labeled:
                out["by_label"] = labeled
            return out


class Gauge:
    """Last-written value, optionally split by one label value."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {}

    def set(self, v: float, label: str = "") -> None:
        with self._lock:
            self._values[label] = float(v)

    def value(self, label: str = "") -> Optional[float]:
        with self._lock:
            return self._values.get(label)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {"kind": self.kind}
            if "" in self._values:
                out["value"] = self._values[""]
            labeled = {k: v for k, v in self._values.items() if k}
            if labeled:
                out["by_label"] = labeled
            return out


class Histogram:
    """Streaming histogram over fixed log-spaced buckets: values at or
    below :data:`HIST_LO` land in bucket 0, values past the last bound in
    the overflow bucket; the exact min/max/sum/count ride along."""

    kind = "histogram"

    def __init__(self, name: str, help_: str = "", unit: str = ""):
        self.name, self.help, self.unit = name, help_, unit
        self._lock = threading.Lock()
        self._counts = [0] * (_NBUCKETS + 1)   # +1 = overflow (+Inf)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    @staticmethod
    def bucket_index(v: float) -> int:
        if v <= HIST_LO:
            return 0
        i = int(math.ceil(math.log(v / HIST_LO, _GROWTH))) - 1
        # float log can land one bucket off at exact bounds; fix locally
        while i < _NBUCKETS and v > _BOUNDS[i]:
            i += 1
        while i > 0 and v <= _BOUNDS[i - 1]:
            i -= 1
        return min(i, _NBUCKETS)

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return          # a NaN sample must not poison the quantiles
        i = self.bucket_index(v) if v > 0 else 0
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @staticmethod
    def _quantile_from(counts: List[int], count: int, mn: float,
                       mx: float, q: float) -> float:
        """Quantile over one consistent copy of the state."""
        if count == 0:
            return math.nan
        rank = q * (count - 1) + 1              # 1-based sample rank
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                break
        if i == 0:
            lo, hi = min(mn, HIST_LO), HIST_LO
        elif i >= _NBUCKETS:
            lo, hi = _BOUNDS[-1], mx
        else:
            lo, hi = _BOUNDS[i - 1], _BOUNDS[i]
        lo, hi = max(lo, 1e-12), max(hi, 1e-12)
        est = math.sqrt(lo * hi)
        return min(max(est, mn), mx)

    def quantile(self, q: float) -> float:
        """The geometric midpoint of the bucket holding the q-th sample,
        clamped into the exact [min, max]; NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            counts = list(self._counts)
            count, mn, mx = self._count, self._min, self._max
        return self._quantile_from(counts, count, mn, mx, q)

    def snapshot(self) -> Dict[str, Any]:
        # One lock acquisition: quantiles, count and min/max come from
        # the same state.
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
        out: Dict[str, Any] = {"kind": self.kind, "count": count,
                               "sum": round(total, 6)}
        if self.unit:
            out["unit"] = self.unit
        if count:
            out.update(
                min=mn, max=mx,
                p50=self._quantile_from(counts, count, mn, mx, 0.5),
                p95=self._quantile_from(counts, count, mn, mx, 0.95),
                p99=self._quantile_from(counts, count, mn, mx, 0.99))
        return out


class Registry:
    """Thread-safe name -> metric table with get-or-create semantics:
    re-registering a name with the same kind returns the existing metric;
    a kind conflict raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kw):
        if not NAME_RE.match(name):
            raise ValueError(f"metric name {name!r} is not snake_case "
                             "dotted")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, Counter, help_=help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, Gauge, help_=help_)

    def histogram(self, name: str, help_: str = "",
                  unit: str = "") -> Histogram:
        return self._get(name, Histogram, help_=help_, unit=unit)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self, prefix: Optional[str] = None) -> None:
        """Drop metrics: all, or those named ``prefix`` or under
        ``prefix.``."""
        with self._lock:
            if prefix is None:
                self._metrics.clear()
            else:
                for name in [n for n in self._metrics
                             if n == prefix
                             or n.startswith(prefix + ".")]:
                    del self._metrics[name]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.snapshot() for name, m in sorted(metrics.items())}


#: the one process registry
REGISTRY = Registry()


def registry() -> Registry:
    return REGISTRY
