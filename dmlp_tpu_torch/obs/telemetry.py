"""Live in-process telemetry: metrics registry, sampler, OpenMetrics
export, and the crash flight recorder — port of
``dmlp_tpu/obs/telemetry.py``.

- :class:`Registry` — a thread-safe store of counters, gauges and
  streaming histograms. Histograms use fixed log-spaced buckets
  (:data:`HIST_BUCKETS_PER_DECADE` per decade), so a quantile carries a
  bounded relative error (:data:`HIST_QUANTILE_REL_ERROR`) with O(1)
  memory per metric, and opt-in sliding windows (the SLO engine's input,
  obs.slo). One process-wide registry (:data:`REGISTRY`) always exists:
  recording is cheap and unconditional (the resilience counters and the
  serving daemon write through it); export is what ``--telemetry`` opts
  into through :class:`TelemetrySession`.
- :class:`Sampler` — a background thread polling the caching allocator of
  the engine's CUDA device (``torch.cuda.memory_allocated``,
  ``max_memory_allocated``, ``memory_reserved``, ``mem_get_info``) into
  ``mem.device.*`` gauges, heartbeat age (``$DMLP_TPU_HEARTBEAT``) and
  uptime. A CPU device sets the explicit ``mem.stats_unavailable`` gauge:
  the host has no allocator statistics to report, and the sampler never
  reads a card the engine does not run on.
- **OpenMetrics export** — :meth:`Registry.to_openmetrics` renders the
  text exposition format (dots map to underscores, counters get
  ``_total``, histograms emit cumulative ``_bucket{le=...}`` series, ``#
  EOF`` ends it); :func:`validate_openmetrics` is its structural
  validator. :class:`TelemetrySession` rewrites a snapshot file
  periodically (``--telemetry FILE``) and can serve the same text on a
  localhost HTTP endpoint (``--telemetry-port``).
- :class:`FlightRecorder` — a bounded ring of recent spans, instants,
  explicit events and counter deltas, dumped to ``FLIGHT_<reason>.json``
  on a crash, a fatal fault (resilience.retry) or SIGTERM.

Span-derived phase latencies come from one seam: while a session is
active, :mod:`dmlp_tpu_torch.obs.trace` forwards every completed span and
instant here (``<span>.ms`` histograms and flight events), whether or not
a Tracer is installed. The contract channels stay byte-identical:
everything here writes to files, the HTTP endpoint or stderr only.

Import-light (standard library only, torch imported where the sampler
reads a card).
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# -- histogram bucketing ------------------------------------------------------

#: log-spaced buckets per decade; 20 → adjacent bounds grow by 10^0.05
HIST_BUCKETS_PER_DECADE = 20
#: smallest / largest finite bucket upper bounds (values outside clamp
#: into the first / overflow bucket; min/max are tracked exactly)
HIST_LO = 1e-3
HIST_DECADES = 10
#: documented quantile relative error: a quantile estimate is the
#: geometric midpoint of its bucket, so the worst-case relative error is
#: sqrt(growth) - 1 ≈ 5.9% at 20 buckets/decade (tests verify against
#: numpy.percentile within this bound, away from the clamp edges)
HIST_QUANTILE_REL_ERROR = 10 ** (1 / (2 * HIST_BUCKETS_PER_DECADE)) - 1

_GROWTH = 10 ** (1.0 / HIST_BUCKETS_PER_DECADE)
_NBUCKETS = HIST_DECADES * HIST_BUCKETS_PER_DECADE
#: shared upper-bound table: bucket i covers (bounds[i-1], bounds[i]]
_BOUNDS = tuple(HIST_LO * _GROWTH ** (i + 1) for i in range(_NBUCKETS))

#: metric names are literal snake_case dotted paths, checked here
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
        _notify_counter_delta(self.name, label, v)

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

    def remove(self, label: str) -> None:
        """Drop one label's sample. Gauges describe CURRENT state, so
        an entity that ceases to exist (a retired fleet replica) must
        leave the exposition — a counter's history, by contrast, is
        never removed."""
        with self._lock:
            self._values.pop(label, None)

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


#: default windowed-quantile sub-window width (seconds) — the sliding
#: window's time resolution; enable_windows() overrides per histogram
WINDOW_SUB_S = 2.5
#: default longest sliding window served (seconds)
WINDOW_MAX_S = 300.0


class _WindowFrame:
    """One sub-window of a windowed histogram: a SPARSE bucket->count
    map plus exact count/sum/min/max, stamped with its grid-aligned
    start time. Sparse because a sub-window typically touches a few
    buckets out of 201."""

    __slots__ = ("start", "counts", "count", "sum", "mn", "mx")

    def __init__(self, start: float):
        self.start = start
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.mn = math.inf
        self.mx = -math.inf


class Histogram:
    """Streaming histogram over fixed log-spaced buckets.

    O(1) memory, bounded-error quantiles (module docstring): values at
    or below :data:`HIST_LO` land in bucket 0, values beyond the last
    bound in the overflow bucket; exact min/max/sum/count ride along so
    the clamp never hides the extremes.

    **Sliding windows** (opt-in via :meth:`enable_windows`): a rotating
    ring of sub-window bucket snapshots (:class:`_WindowFrame`, width
    ``sub_s``) so p50/p95/p99 are computable over the trailing 10 s /
    1 m / 5 m instead of cumulative-since-start. A window quantile
    carries the SAME :data:`HIST_QUANTILE_REL_ERROR` bound as the
    cumulative one (the bucket grid is shared; min/max are exact per
    frame), plus a time-resolution slack of at most one sub-window of
    extra trailing data. The streaming SLO engine (obs.slo) is the
    consumer."""

    kind = "histogram"

    def __init__(self, name: str, help_: str = "", unit: str = ""):
        self.name, self.help, self.unit = name, help_, unit
        self._lock = threading.Lock()
        self._counts = [0] * (_NBUCKETS + 1)   # +1 = overflow (+Inf)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # bucket index -> (exemplar id, value): the LAST exemplar-
        # carrying observation per bucket, so a p99 bucket links back
        # to one reconstructable request (rid) in the merged trace.
        self._exemplars: Dict[int, Tuple[str, float]] = {}
        # sliding-window ring (None until enable_windows): guarded by
        # _lock like every other field — observe() appends into the
        # open frame, readers merge the frames inside the window.
        self._frames: Optional[deque] = None
        self._sub_s = WINDOW_SUB_S
        self._time = time.monotonic

    def enable_windows(self, max_window_s: float = WINDOW_MAX_S,
                       sub_s: float = WINDOW_SUB_S,
                       time_fn=None) -> None:
        """Turn on the sliding-window ring (idempotent; the FIRST
        enablement pins the geometry). ``time_fn`` injects a clock for
        deterministic rotation-boundary tests; production uses
        ``time.monotonic``."""
        if sub_s <= 0 or max_window_s < sub_s:
            raise ValueError(
                f"window geometry max={max_window_s} sub={sub_s} "
                "needs 0 < sub_s <= max_window_s")
        with self._lock:
            if self._frames is not None:
                return
            if time_fn is not None:
                self._time = time_fn
            self._sub_s = float(sub_s)
            cap = int(math.ceil(max_window_s / self._sub_s)) + 1
            self._frames = deque(maxlen=max(cap, 2))
            self._frames.append(_WindowFrame(self._time()))

    @property
    def windowed(self) -> bool:
        with self._lock:
            return self._frames is not None

    def _rotate_locked(self) -> float:
        """Close the open frame if its sub-window elapsed; returns
        ``now``. The new frame's start is GRID-ALIGNED to the first
        frame's schedule, so an idle gap yields a fresh frame at the
        right phase instead of one frame stretched across the gap
        (stale samples would then never age out)."""
        # check: allow-concurrency=R702 — every caller holds self._lock
        # (the ``_locked`` suffix is the contract); _time/_frames/_sub_s
        # change only under that lock.
        now, frames, sub_s = self._time(), self._frames, self._sub_s
        last = frames[-1]
        if now - last.start >= sub_s:
            steps = int((now - last.start) // sub_s)
            frames.append(_WindowFrame(last.start + steps * sub_s))
        return now

    def _window_merge_locked(self, window_s: float
                             ) -> Tuple[List[int], int, float, float,
                                        float]:
        """Merge every frame overlapping the trailing ``window_s``
        into one (counts, count, sum, min, max) state. Caller holds
        the lock."""
        # check: allow-concurrency=R702 — the caller holds self._lock (the
        # ``_locked`` suffix is the contract); _frames/_sub_s change only
        # under that lock.
        frames, sub_s = self._frames, self._sub_s
        now = self._rotate_locked()
        cutoff = now - float(window_s)
        counts = [0] * (_NBUCKETS + 1)
        count, total = 0, 0.0
        mn, mx = math.inf, -math.inf
        for fr in frames:
            if fr.start + sub_s <= cutoff:
                continue                     # fully aged out
            for i, c in fr.counts.items():
                counts[i] += c
            count += fr.count
            total += fr.sum
            mn = min(mn, fr.mn)
            mx = max(mx, fr.mx)
        return counts, count, total, mn, mx

    @staticmethod
    def bucket_index(v: float) -> int:
        if v <= HIST_LO:
            return 0
        # Past the last bound the log's index would run off the table
        # (the reference raises IndexError there): clamp to the overflow
        # bucket first.
        i = min(int(math.ceil(math.log(v / HIST_LO, _GROWTH))) - 1,
                _NBUCKETS)
        # float log can land one bucket off at exact bounds; fix locally
        while i < _NBUCKETS and v > _BOUNDS[i]:
            i += 1
        while i > 0 and v <= _BOUNDS[i - 1]:
            i -= 1
        return min(i, _NBUCKETS)

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
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
            if exemplar is not None:
                self._exemplars[i] = (str(exemplar), v)
            if self._frames is not None:
                self._rotate_locked()
                fr = self._frames[-1]
                fr.counts[i] = fr.counts.get(i, 0) + 1
                fr.count += 1
                fr.sum += v
                fr.mn = min(fr.mn, v)
                fr.mx = max(fr.mx, v)

    def exemplars(self) -> Dict[int, Tuple[str, float]]:
        """bucket index -> (exemplar id, observed value) snapshot."""
        with self._lock:
            return dict(self._exemplars)

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
        """Quantile math over one CONSISTENT state copy — quantile()
        and snapshot() both route through this so a concurrent
        observe() between two lock acquisitions can never mix counts
        from one state with min/max from another."""
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
        """Bounded-error quantile estimate (see HIST_QUANTILE_REL_ERROR):
        the geometric midpoint of the bucket holding the q-th sample,
        clamped into the exact [min, max] envelope. NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            counts = list(self._counts)
            count, mn, mx = self._count, self._min, self._max
        return self._quantile_from(counts, count, mn, mx, q)

    def window_quantile(self, window_s: float, q: float) -> float:
        """Bounded-error quantile over the trailing ``window_s``
        seconds (same :data:`HIST_QUANTILE_REL_ERROR` bound as
        :meth:`quantile`). NaN when the window holds no samples.
        Raises if :meth:`enable_windows` was never called."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if self._frames is None:
                raise ValueError(
                    f"histogram {self.name!r} has no window ring "
                    "(call enable_windows first)")
            counts, count, _, mn, mx = self._window_merge_locked(
                window_s)
        return self._quantile_from(counts, count, mn, mx, q)

    def window_snapshot(self, window_s: float) -> Dict[str, Any]:
        """count/sum/min/max/p50/p95/p99 over the trailing
        ``window_s`` seconds from ONE consistent merged state (same
        one-lock-acquisition discipline as :meth:`snapshot`)."""
        with self._lock:
            if self._frames is None:
                raise ValueError(
                    f"histogram {self.name!r} has no window ring "
                    "(call enable_windows first)")
            counts, count, total, mn, mx = self._window_merge_locked(
                window_s)
        out: Dict[str, Any] = {"window_s": float(window_s),
                               "count": count, "sum": round(total, 6)}
        if count:
            out.update(
                min=mn, max=mx,
                p50=self._quantile_from(counts, count, mn, mx, 0.5),
                p95=self._quantile_from(counts, count, mn, mx, 0.95),
                p99=self._quantile_from(counts, count, mn, mx, 0.99))
        return out

    def window_above(self, window_s: float,
                     threshold: float) -> Tuple[int, int]:
        """(bad, total) sample counts over the trailing ``window_s``:
        ``bad`` counts samples above ``threshold`` at BUCKET
        resolution — samples sharing the threshold's own bucket count
        as good, so the split carries the same relative-error bound as
        the quantiles. The burn-rate evaluator's primitive."""
        with self._lock:
            if self._frames is None:
                raise ValueError(
                    f"histogram {self.name!r} has no window ring "
                    "(call enable_windows first)")
            counts, count, _, mn, mx = self._window_merge_locked(
                window_s)
        if count == 0:
            return 0, 0
        if mx <= threshold:          # exact max rules the window good
            return 0, count
        ti = self.bucket_index(threshold)
        bad = sum(counts[ti + 1:])
        return bad, count

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """(upper bound, cumulative count) pairs, ending with +Inf."""
        with self._lock:
            out = []
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                bound = _BOUNDS[i] if i < _NBUCKETS else math.inf
                out.append((bound, cum))
            return out

    def snapshot(self) -> Dict[str, Any]:
        # ONE lock acquisition for the whole snapshot: computing the
        # quantiles via self.quantile() would re-lock per call, so a
        # concurrent observe() between p50 and p99 could yield
        # quantiles from a different distribution than count/min/max
        # in the same snapshot.
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
    """Thread-safe name → metric table with get-or-create semantics.

    Re-registering an existing name with the SAME kind returns the
    existing metric (one declaration, any number of use sites); a kind
    conflict raises — two subsystems silently sharing one name as
    counter-and-gauge would corrupt both."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kw):
        if not NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} is not snake_case dotted")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
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
        """Drop metrics (all, or those under ``prefix.``) — run-scoped
        emitters (the CLI, the train loop) reset at start the way
        resilience.stats always has."""
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

    # -- OpenMetrics text exposition -----------------------------------------
    def to_openmetrics(self) -> str:
        """The OpenMetrics text format (the serving scrape contract):
        dotted names map to underscores, counters emit ``<name>_total``,
        histograms the cumulative ``_bucket{le=...}`` + ``_sum`` +
        ``_count`` family, ``# EOF`` terminates."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            name = _om_name(m.name)
            lines.append(f"# TYPE {name} {m.kind}")
            if m.help:
                lines.append(f"# HELP {name} {_om_escape(m.help)}")
            if isinstance(m, Counter):
                snap = m.snapshot()
                lines.append(f"{name}_total {_om_num(snap['total'])}")
                for lab, v in sorted(snap.get("by_label", {}).items()):
                    lines.append(f'{name}_total{{key="{_om_escape(lab)}"}}'
                                 f" {_om_num(v)}")
            elif isinstance(m, Gauge):
                snap = m.snapshot()
                if "value" in snap:
                    lines.append(f"{name} {_om_num(snap['value'])}")
                for lab, v in sorted(snap.get("by_label", {}).items()):
                    lines.append(f'{name}{{key="{_om_escape(lab)}"}}'
                                 f" {_om_num(v)}")
            else:                                   # Histogram
                prev = 0
                exem = m.exemplars()
                for bi, (bound, cum) in enumerate(m.bucket_counts()):
                    if cum == prev and bound != math.inf:
                        continue    # sparse render: skip empty prefixes
                    le = "+Inf" if bound == math.inf else _om_num(bound)
                    lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
                    # Exemplar as a comment line the validator (and any
                    # plain-Prometheus scraper) tolerates: the last rid
                    # observed into this bucket, so a tail bucket links
                    # back to one reconstructable request in the trace.
                    ex = exem.get(bi)
                    if ex is not None and cum > prev:
                        lines.append(
                            f'# EXEMPLAR {name}_bucket{{le="{le}"}} '
                            f'{_om_escape(ex[0])} {_om_num(ex[1])}')
                    prev = cum
                lines.append(f"{name}_sum {_om_num(m.sum)}")
                lines.append(f"{name}_count {m.count}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _om_name(dotted: str) -> str:
    return dotted.replace(".", "_")


def _om_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")


def _om_num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? (?P<value>\S+)$")
_META_RE = re.compile(
    r"^# (TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)"
    r"|HELP .*|EXEMPLAR .*|EOF)$")


def validate_openmetrics(text: str) -> List[str]:
    """Structural OpenMetrics validation (no external deps): returns a
    list of problems, empty when the exposition is well-formed —
    ``# EOF`` terminated, every sample line parseable, every sample
    name declared by a preceding ``# TYPE``, histogram buckets
    cumulative and consistent with ``_count``."""
    problems: List[str] = []
    lines = text.splitlines()
    if not lines or lines[-1] != "# EOF":
        problems.append("missing terminal '# EOF'")
    declared: Dict[str, str] = {}
    buckets: Dict[str, List[int]] = {}
    counts: Dict[str, int] = {}
    for i, line in enumerate(lines, 1):
        if not line:
            continue
        if line.startswith("#"):
            if not _META_RE.match(line):
                problems.append(f"line {i}: malformed metadata {line!r}")
            elif line.startswith("# TYPE "):
                _, _, name, kind = line.split(" ")
                declared[name] = kind
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {i}: malformed sample {line!r}")
            continue
        try:
            # float() accepts every value repr the emitter can produce
            # (scientific notation incl. negative exponents, inf/nan) —
            # a handwritten character class once rejected '5e-05'.
            float(m.group("value"))
        except ValueError:
            problems.append(f"line {i}: non-numeric sample value "
                            f"{m.group('value')!r}")
            continue
        name = re.split(r"[{ ]", line, 1)[0]
        base = re.sub(r"(_total|_bucket|_sum|_count)$", "", name)
        if name not in declared and base not in declared:
            problems.append(f"line {i}: sample {name!r} has no "
                            "preceding # TYPE")
            continue
        if name.endswith("_bucket"):
            buckets.setdefault(base, []).append(
                int(float(line.rsplit(" ", 1)[1])))
        elif name.endswith("_count") and declared.get(base) == "histogram":
            counts[base] = int(float(line.rsplit(" ", 1)[1]))
    for base, cums in buckets.items():
        if any(b > a for b, a in zip(cums, cums[1:])):
            problems.append(f"histogram {base}: non-cumulative buckets")
        if base in counts and cums and cums[-1] != counts[base]:
            problems.append(f"histogram {base}: +Inf bucket "
                            f"{cums[-1]} != _count {counts[base]}")
    return problems


# -- process-wide registry + enablement --------------------------------------

#: the one process registry: recording is always-on (resilience writes
#: through it); sessions only add export/sampling/flight machinery
REGISTRY = Registry()

_session_lock = threading.Lock()
_session: Optional["TelemetrySession"] = None


def registry() -> Registry:
    return REGISTRY


def enabled() -> bool:
    """Is a TelemetrySession active (export/sampler/flight on)?"""
    return _session is not None


def session() -> Optional["TelemetrySession"]:
    return _session


def _notify_counter_delta(name: str, label: str, v: float) -> None:
    s = _session
    if s is not None and s.flight is not None:
        s.flight.record("metric", name,
                        **({"delta": v, "key": label} if label
                           else {"delta": v}))


# -- span observer (fed by obs.trace) ----------------------------------------

def observe_span(name: str, dur_ms: float, args: Dict[str, Any]) -> None:
    """Called by obs.trace for every completed span while a session is
    active: span-derived phase latency histograms + flight events."""
    s = _session
    if s is None:
        return
    try:
        # One histogram per span name; the name itself rides as the
        # label so the metric name stays a literal.
        REGISTRY.histogram("span.latency_ms", unit="ms").observe(dur_ms)
        h = s.span_histograms.get(name)
        if h is None:
            safe = re.sub(r"[^a-z0-9_.]", "_", name.lower())
            if NAME_RE.match(safe):
                # Span names are dotted identifiers already; this is the
                # one seam that registers metric names dynamically.
                h = REGISTRY.histogram(safe + ".ms", unit="ms")  # check: allow-metric-name
            s.span_histograms[name] = h
        if h is not None:
            h.observe(dur_ms)
        if s.flight is not None:
            s.flight.record("span", name, dur_ms=round(dur_ms, 3),
                            **{k: v for k, v in args.items()
                               if isinstance(v, (str, int, float, bool))})
    except Exception:  # check: no-retry — telemetry must not fail the run
        pass


def observe_instant(name: str, args: Dict[str, Any]) -> None:
    s = _session
    if s is None or s.flight is None:
        return
    try:
        s.flight.record("instant", name,
                        **{k: v for k, v in args.items()
                           if isinstance(v, (str, int, float, bool))})
    except Exception:  # check: no-retry — telemetry must not fail the run
        pass


# -- flight recorder ----------------------------------------------------------

#: default ring capacity; $DMLP_TPU_FLIGHT_EVENTS overrides
FLIGHT_EVENTS_DEFAULT = 512


class FlightRecorder:
    """Bounded ring buffer of recent spans/instants/events/metric
    deltas; ``dump()`` writes the post-mortem artifact."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity or int(os.environ.get("DMLP_TPU_FLIGHT_EVENTS",
                                             FLIGHT_EVENTS_DEFAULT))
        self._events: deque = deque(maxlen=max(cap, 8))
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.dumped: List[str] = []

    def record(self, kind: str, name: str, **data) -> None:
        ev = {"t_ms": round((time.monotonic() - self._t0) * 1e3, 3),
              "kind": kind, "name": name}
        if data:
            ev["data"] = data
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def dump(self, directory: str, reason: str) -> str:
        """Write ``FLIGHT_<reason>.json``: the last N events, the full
        registry snapshot, and the resilience counters — atomic rename,
        one file per (reason, pid) so concurrent ranks cannot clobber
        each other."""
        os.makedirs(directory, exist_ok=True)
        safe = re.sub(r"[^A-Za-z0-9_]+", "_", reason) or "unknown"
        path = os.path.join(directory,
                            f"FLIGHT_{safe}_pid{os.getpid()}.json")
        doc = {
            "flight_schema": 1,
            "reason": reason,
            "unix_time": time.time(),
            "pid": os.getpid(),
            "events": self.events(),
            "metrics": REGISTRY.snapshot(),
        }
        try:
            from dmlp_tpu_torch.resilience import stats as rs_stats
            doc["resilience"] = rs_stats.snapshot()
        except Exception:  # check: no-retry — dump must still land
            pass
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self.dumped.append(path)
        return path


def flight_event(name: str, **data) -> None:
    """Record an explicit flight event (no-op without a session) —
    the resilience degrade/supervise paths call this."""
    s = _session
    if s is not None and s.flight is not None:
        try:
            s.flight.record("event", name, **data)
        except Exception:  # check: no-retry — telemetry never raises
            pass


def flight_fault(site: str, classification: str, error: str,
                 dump: bool = False) -> None:
    """Resilience-retry hook: record a fault event; a fatal-classified
    (or retries-exhausted) fault additionally dumps the flight artifact
    immediately — the process may be about to die with the exception."""
    s = _session
    if s is None:
        return
    try:
        REGISTRY.counter("resilience.fatal_faults").inc(
            label=classification)
        if s.flight is not None:
            s.flight.record("fault", site, classification=classification,
                            error=error)
            if dump:
                s.flight.dump(s.flight_dir, "fatal_fault")
    except Exception:  # check: no-retry — telemetry never raises
        pass


def dump_on_crash(reason: str = "crash") -> Optional[str]:
    """Dump the flight buffer if a session is active (the CLI's
    top-level except hook); returns the artifact path or None."""
    s = _session
    if s is None or s.flight is None:
        return None
    try:
        return s.flight.dump(s.flight_dir, reason)
    except Exception:  # check: no-retry — a failing dump must not mask
        return None    # the original crash


# -- background sampler -------------------------------------------------------

#: default sampling interval; $DMLP_TPU_TELEMETRY_INTERVAL_S overrides
SAMPLE_INTERVAL_S = 0.25


class Sampler:
    """Background poll of device memory, heartbeat age and uptime into
    gauges. ``device`` is the engine's device: a CUDA device is read
    through its caching allocator, the CPU reports the explicit
    ``mem.stats_unavailable`` marker, and None reads the current card
    only once the process has initialized CUDA (never initializing it).
    start()/stop() are idempotent; the thread is a daemon so a wedged
    exit never hangs the process."""

    def __init__(self, interval_s: Optional[float] = None, device=None):
        self.interval_s = interval_s if interval_s is not None else float(
            os.environ.get("DMLP_TPU_TELEMETRY_INTERVAL_S",
                           SAMPLE_INTERVAL_S))
        self.device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.ticks = 0
        #: peak observed bytes per basis across the sampler's lifetime
        self.peaks: Dict[str, int] = {}

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return                       # idempotent
            # Each loop gets its OWN stop event, bound at start: with a
            # shared event, stop();start() racing from two threads
            # could clear the flag before the old loop observed it and
            # leave two sampler loops running.
            stop = threading.Event()
            self._stop = stop
            self._thread = threading.Thread(
                target=self._loop, args=(stop,),
                name="telemetry-sampler", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
            self._stop.set()     # the event BOUND to t's loop; setting
            #                      it under the lock orders against a
            #                      concurrent start()'s rebind
        if t is None:
            return                           # idempotent
        t.join(timeout=5.0)

    @property
    def running(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    @staticmethod
    def _next_deadline(prev_deadline: float, now: float,
                       interval: float) -> Tuple[float, float]:
        """Advance the tick deadline on a MONOTONIC grid: the next
        deadline is ``prev + k*interval`` for the smallest k landing
        in the future, so the effective period is ``interval`` — not
        ``interval + work time`` (the drift the old sleep-after-work
        loop accumulated: a 0.25 s sampler doing 50 ms of polling ran
        at 0.3 s and every derived rate read ~17% low). Overruns skip
        the missed grid points (no catch-up burst) but keep the
        phase. Returns (new deadline, seconds to wait)."""
        nxt = prev_deadline + interval
        if nxt <= now:
            missed = math.floor((now - prev_deadline) / interval)
            nxt = prev_deadline + (missed + 1) * interval
        return nxt, max(nxt - now, 0.0)

    def _loop(self, stop: threading.Event) -> None:
        deadline = time.monotonic()
        while not stop.is_set():
            self.sample_now()
            deadline, delay = self._next_deadline(
                deadline, time.monotonic(), self.interval_s)
            stop.wait(delay)

    def sample_now(self) -> None:
        """One synchronous sampling tick — also exposed so the engines
        can stamp the watermark exactly at peak residency (between the
        solve enqueue and the result fetch)."""
        try:
            self._sample_memory()
            self._sample_heartbeat()
            REGISTRY.gauge("telemetry.uptime_s").set(
                round(time.monotonic() - self._t0, 3))
            self.ticks += 1
            REGISTRY.gauge("telemetry.sampler_ticks").set(self.ticks)
        except Exception:  # check: no-retry — sampling must never raise
            pass

    def _sample_memory(self) -> None:
        from dmlp_tpu_torch.obs import memwatch
        stats = memwatch.device_memory_stats(self._poll_device())
        if stats is None:
            REGISTRY.gauge("mem.stats_unavailable").set(1)
            return
        label = str(stats["index"])
        REGISTRY.gauge("mem.stats_unavailable").set(0)
        # Literal names (check rule R6), one gauge per allocator field.
        REGISTRY.gauge("mem.device.bytes_in_use").set(
            stats["bytes_in_use"], label=label)
        REGISTRY.gauge("mem.device.peak_bytes_in_use").set(
            stats["peak_bytes_in_use"], label=label)
        REGISTRY.gauge("mem.device.bytes_reserved").set(
            stats["bytes_reserved"], label=label)
        REGISTRY.gauge("mem.device.bytes_limit").set(
            stats["bytes_limit"], label=label)
        self.peaks["max_memory_allocated"] = max(
            self.peaks.get("max_memory_allocated", 0),
            stats["peak_bytes_in_use"])

    def _poll_device(self):
        """The device to read: the configured one, or with none the
        current card once this process has initialized CUDA."""
        if self.device is not None:
            return self.device
        import sys
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            return torch.device("cuda", torch.cuda.current_device())
        return None

    def _sample_heartbeat(self) -> None:
        path = os.environ.get("DMLP_TPU_HEARTBEAT")
        if not path:
            return
        try:
            age = time.time() - os.stat(path).st_mtime
            REGISTRY.gauge("heartbeat.age_s").set(round(age, 3))
        except OSError:
            REGISTRY.gauge("heartbeat.age_s").set(-1)  # no beat yet

    def measured_peak(self) -> Dict[str, Any]:
        """The watermark this sampler saw: the allocator's peak
        (``torch.cuda.max_memory_allocated``, basis
        ``max_memory_allocated``), or the explicit unavailability marker
        where the device reports nothing (the CPU)."""
        peak = self.peaks.get("max_memory_allocated")
        if peak:
            return {"bytes": peak, "basis": "max_memory_allocated"}
        return {"unavailable": "the device reports no allocator stats "
                               "(a CPU engine, or no CUDA tick sampled)"}


def sample_memory_now() -> None:
    """Engine hook: force one sampler tick at peak residency; no-op
    without an active session."""
    s = _session
    if s is not None and s.sampler is not None:
        s.sampler.sample_now()


# -- HTTP endpoint -------------------------------------------------------------

def _start_http(port: int):
    """Opt-in localhost scrape endpoint: GET /metrics (or /) returns
    the OpenMetrics text. Returns the server (its port in
    ``server_address[1]``; pass port=0 for an ephemeral one)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = REGISTRY.to_openmetrics().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "application/openmetrics-text; version=1.0.0")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # silence per-request stderr noise
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    t = threading.Thread(target=srv.serve_forever,
                         name="telemetry-http", daemon=True)
    t.start()
    return srv


# -- session -------------------------------------------------------------------

class TelemetrySession:
    """Everything ``--telemetry`` turns on, as one start/close bundle:
    the sampler, the periodic OpenMetrics snapshot rewrite, the opt-in
    HTTP endpoint, the flight recorder, the trace→telemetry span
    bridge, and the SIGTERM dump hook. Construct via :func:`start`."""

    def __init__(self, path: Optional[str] = None, port: Optional[int] = None,
                 interval_s: Optional[float] = None,
                 flight_dir: Optional[str] = None,
                 handle_signals: bool = True, device=None):
        self.path = path
        self.flight_dir = flight_dir or (
            os.path.dirname(os.path.abspath(path)) if path else ".")
        self.flight = FlightRecorder()
        self.sampler = Sampler(interval_s=interval_s, device=device)
        self.span_histograms: Dict[str, Optional[Histogram]] = {}
        self.http_server = None
        self.http_port: Optional[int] = None
        self._export_stop = threading.Event()
        self._export_thread: Optional[threading.Thread] = None
        self._prev_sigterm = None
        self._signals_installed = False
        self._port = port
        self._handle_signals = handle_signals
        self._closed = False
        self._drain_hook = None

    def _activate(self) -> None:
        self.sampler.start()
        if self._port is not None:
            self.http_server = _start_http(self._port)
            self.http_port = self.http_server.server_address[1]
            REGISTRY.gauge("telemetry.http_port").set(self.http_port)
        if self.path:
            self._export_thread = threading.Thread(
                target=self._export_loop, name="telemetry-export",
                daemon=True)
            self._export_thread.start()
        if self._handle_signals:
            self._install_sigterm()
        from dmlp_tpu_torch.obs import trace as obs_trace
        obs_trace.set_telemetry_observer(observe_span, observe_instant)

    def _install_sigterm(self) -> None:
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
            self._signals_installed = True
        except ValueError:
            pass    # not the main thread: skip, dump-on-crash still works

    def set_sigterm_drain(self, hook) -> None:
        """Register a graceful-drain hook: while set, SIGTERM invokes
        ``hook()`` (which should only set an event — signal context)
        instead of dumping the flight ring and re-raising the kill. An
        ORDERLY shutdown is not a crash: the serving daemon finishes
        its in-flight micro-batches, flushes the final snapshot itself,
        and exits clean with no FLIGHT artifact. Pass None to restore
        the post-mortem behavior."""
        self._drain_hook = hook

    def _on_sigterm(self, signum, frame):
        hook = self._drain_hook
        if hook is not None:
            try:
                self.flight.record("event", "sigterm_drain")
                hook()
            except Exception:  # check: no-retry — a failing hook must
                pass           # not resurrect the kill mid-drain
            return
        try:
            self.flight.record("event", "sigterm")
            self.flight.dump(self.flight_dir, "sigterm")
            self.write_snapshot()
        finally:
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

    def _export_loop(self) -> None:
        interval = max(self.sampler.interval_s * 4, 1.0)
        while not self._export_stop.wait(interval):
            self.write_snapshot()

    def write_snapshot(self) -> None:
        """Atomic rewrite of the OpenMetrics snapshot file (the
        ``--telemetry FILE`` contract: readers always see a complete,
        valid exposition)."""
        if not self.path:
            return
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(REGISTRY.to_openmetrics())
            os.replace(tmp, self.path)
        except Exception:  # check: no-retry — export must not kill a run
            pass

    def snapshot_record(self, extra_config: Optional[dict] = None):
        """The telemetry snapshot as a schema RunRecord (kind
        "telemetry") — the ledger-ingestible serialization. Scalar
        gauges/counters become metrics; histograms contribute their
        p50/p95/p99/count."""
        from dmlp_tpu_torch.obs.run import RunRecord, current_device
        metrics: Dict[str, Any] = {}
        for name, snap in REGISTRY.snapshot().items():
            key = name.replace(".", "_")
            if snap["kind"] == "counter":
                metrics[key + "_total"] = snap["total"]
            elif snap["kind"] == "gauge" and "value" in snap:
                metrics[key] = snap["value"]
            elif snap["kind"] == "histogram" and snap["count"]:
                for q in ("p50", "p95", "p99"):
                    metrics[f"{key}_{q}"] = round(snap[q], 6)
                metrics[key + "_count"] = snap["count"]
        return RunRecord(kind="telemetry", tool="dmlp_tpu_torch.telemetry",
                         config=dict(extra_config or {}), metrics=metrics,
                         device=current_device(self.sampler.device))

    def close(self) -> None:
        """Final snapshot write + teardown. Idempotent."""
        global _session
        if self._closed:
            return
        self._closed = True
        from dmlp_tpu_torch.obs import trace as obs_trace
        obs_trace.set_telemetry_observer(None, None)
        self._export_stop.set()
        t = self._export_thread
        if t is not None:
            t.join(timeout=5.0)
        self.sampler.sample_now()     # one last tick: final gauges
        self.sampler.stop()
        if self.http_server is not None:
            self.http_server.shutdown()
            self.http_server = None
        if self._signals_installed and self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
        self.write_snapshot()
        with _session_lock:
            if _session is self:
                _session = None


def start(path: Optional[str] = None, port: Optional[int] = None,
          interval_s: Optional[float] = None,
          flight_dir: Optional[str] = None,
          handle_signals: bool = True, device=None) -> TelemetrySession:
    """Start the process's telemetry session (sampler + export + flight
    recorder) for an engine on ``device`` (see :class:`Sampler`). One
    session at a time: starting over a live session closes the old one
    first."""
    global _session
    s = TelemetrySession(path=path, port=port, interval_s=interval_s,
                         flight_dir=flight_dir,
                         handle_signals=handle_signals, device=device)
    with _session_lock:
        prev = _session
        _session = s
    if prev is not None:
        prev.close()
        with _session_lock:
            _session = s    # prev.close() cleared the slot it owned
    try:
        s._activate()
    except BaseException:
        # A failed activation (e.g. the HTTP port is taken) must not
        # leave a half-started session installed with its sampler
        # thread running and no handle to close it.
        s.close()
        raise
    return s


__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY", "registry",
    "Sampler", "FlightRecorder", "TelemetrySession", "start", "enabled",
    "session", "sample_memory_now", "flight_event", "flight_fault",
    "dump_on_crash", "observe_span", "observe_instant",
    "validate_openmetrics", "HIST_QUANTILE_REL_ERROR",
    "HIST_BUCKETS_PER_DECADE", "SAMPLE_INTERVAL_S",
]
