"""Lightweight span tracer exporting Chrome-trace / Perfetto JSON — port of
``dmlp_tpu/obs/trace.py``.

One process-wide :class:`Tracer` (installed with :func:`install`) collects
complete-duration events (``ph: "X"``) from ``with span("name"):`` blocks
in the engines, the CLI and the serving daemon. When no tracer is
installed and no telemetry session observes, every hook is one
module-global read returning a shared no-op span.

Device work is asynchronous under PyTorch on the card, so a span that
brackets only the enqueue of a launch would lie about where the time
goes. ``sp.fence(tensor)`` makes the span's closing edge synchronize the
tensor's CUDA device, so the recorded duration covers the device work the
block launched (the reference's ``jax.block_until_ready``). A CPU tensor
needs no fence. Fences run only while a span is real: with tracing off,
nothing waits.

Export is the Chrome trace-event JSON format, loadable in
https://ui.perfetto.dev or chrome://tracing: ``ts``/``dur`` are
microseconds from the tracer's epoch. ``Tracer(annotate=True)`` also
mirrors every span into ``torch.profiler.record_function``, so the same
names appear inside a ``torch.profiler`` capture (the CLI's
``--profile``).

Import-light (no torch at module level): the CLI imports it
unconditionally.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_clock = time.perf_counter

# -- telemetry bridge ---------------------------------------------------------
# When a telemetry session (obs.telemetry) is active it registers observers
# here; every completed span and instant is forwarded (span latency
# histograms and flight-recorder events) whether or not a Tracer is
# installed. Both None (the default) keeps the fast path at one
# module-global read.
_span_observer = None
_instant_observer = None


def set_telemetry_observer(span_cb, instant_cb) -> None:
    """Install or clear the telemetry forwarding callbacks:
    ``span_cb(name, dur_ms, args)``, ``instant_cb(name, args)``."""
    global _span_observer, _instant_observer
    _span_observer = span_cb
    _instant_observer = instant_cb


def _fence_all(values) -> None:
    """Wait for the CUDA device of every tensor in ``values``; best
    effort (a span still records when the wait fails)."""
    try:
        import torch
        devices = {v.device for v in values
                   if isinstance(v, torch.Tensor) and v.is_cuda}
        from dmlp_tpu_torch.check.sanitize import fenced
        for dev in devices:
            with fenced("trace.span_fence"):
                torch.cuda.synchronize(dev)
    except Exception:  # fencing never fails a span
        pass


class _TelemetrySpan:
    """Minimal timing span used when telemetry observes but no Tracer is
    installed: measures wall duration (honouring fences) and forwards one
    observation; no event storage."""

    __slots__ = ("name", "args", "_t0", "_fences")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = dict(args) if args else {}
        self._t0 = 0.0
        self._fences: list = []

    def set(self, **kwargs) -> None:
        self.args.update(kwargs)

    def fence(self, value) -> None:
        self._fences.append(value)

    def __enter__(self) -> "_TelemetrySpan":
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        if self._fences:
            _fence_all(self._fences)
            self._fences = []
        cb = _span_observer
        if cb is not None:
            cb(self.name, (_clock() - self._t0) * 1e3, self.args)
        return False


class _NullSpan:
    """Shared no-op span: the uninstrumented fast path. Stateless, so one
    singleton serves every (nested, concurrent) site."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kwargs) -> None:
        pass

    def fence(self, value) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One traced region. A context manager; ``set()`` attaches args,
    ``fence()`` registers tensors whose device is synchronized before the
    closing timestamp."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_fences", "_annot")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.args = dict(args) if args else {}
        self._t0 = 0.0
        self._fences: list = []
        self._annot = None

    def set(self, **kwargs) -> None:
        self.args.update(kwargs)

    def fence(self, value) -> None:
        self._fences.append(value)

    def __enter__(self) -> "Span":
        if self._tracer._annotate:
            try:
                from torch.profiler import record_function
                self._annot = record_function(self.name)
                self._annot.__enter__()
            except Exception:  # annotation is optional
                self._annot = None
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        if self._fences:
            _fence_all(self._fences)
            self._fences = []
        t1 = _clock()
        if self._annot is not None:
            try:
                self._annot.__exit__(*exc)
            except Exception:  # best effort: a span records regardless
                pass
        self._tracer._complete(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    """Thread-safe collector of Chrome-trace events. ``annotate=True``
    mirrors spans into ``torch.profiler.record_function``."""

    #: the tracer's clock domain: ``time.perf_counter`` is monotonic with a
    #: process-private epoch, so two processes' traces compare only after a
    #: merge aligns them on a shared sync event (tools/merge_traces.py).
    clock_source = "monotonic"

    def __init__(self, annotate: bool = False):
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._epoch = _clock()
        self._pid = os.getpid()
        self._tids: Dict[int, int] = {}
        self._annotate = annotate

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **args) -> Span:
        return Span(self, name, args)

    def instant(self, name: str, ts: float = None, **args) -> None:
        """A zero-duration marker (``ph: "i"``). ``ts`` (epoch-relative
        us) lets a caller that already read the clock reuse that read."""
        if ts is None:
            ts = (_clock() - self._epoch) * 1e6
        self._append({"name": name, "ph": "i", "ts": ts, "s": "t",
                      "pid": self._pid, "tid": self._tid(),
                      **({"args": args} if args else {})})

    def counter(self, name: str, **series) -> None:
        """A counter sample (``ph: "C"``): Perfetto renders a track."""
        ts = (_clock() - self._epoch) * 1e6
        self._append({"name": name, "ph": "C", "ts": ts, "pid": self._pid,
                      "args": {k: float(v) for k, v in series.items()}})

    def sync_instant(self, name: str, **args) -> None:
        """A clock-sync marker pairing one perf_counter read with one
        wall-clock read taken back to back, for processes with no shared
        barrier (the serving daemons)."""
        t = _clock()
        unix_ms = time.time() * 1e3
        self.instant(name, ts=(t - self._epoch) * 1e6,
                     unix_ms=unix_ms, **args)

    def _complete(self, name: str, t0: float, t1: float,
                  args: Dict[str, Any]) -> None:
        ev = {"name": name, "ph": "X",
              "ts": (t0 - self._epoch) * 1e6,
              "dur": max((t1 - t0) * 1e6, 0.0),
              "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._append(ev)
        cb = _span_observer
        if cb is not None:
            cb(name, max((t1 - t0) * 1e3, 0.0), args)

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            return self._tids.setdefault(ident, len(self._tids))

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[dict]:
        """Thread-safe snapshot of the recorded events."""
        with self._lock:
            return list(self._events)

    # -- export --------------------------------------------------------------
    def to_dict(self, process_name: str = "dmlp_tpu_torch") -> dict:
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "args": {"name": process_name}}]
        with self._lock:
            events = meta + list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "clock": {"source": self.clock_source}}

    def write(self, path: str, process_name: str = "dmlp_tpu_torch") -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(process_name), f)
        os.replace(tmp, path)


# -- process-wide hook -------------------------------------------------------
_active: Optional[Tracer] = None


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-wide collector hooks report to."""
    global _active
    _active = tracer
    return tracer


def uninstall() -> None:
    global _active
    _active = None


def active() -> Optional[Tracer]:
    return _active


def span(name: str, **args):
    """Instrumentation hook: a Span on the installed tracer, a timing span
    when only a telemetry session observes, or the shared no-op span when
    both are off."""
    t = _active
    if t is not None:
        return t.span(name, **args)
    if _span_observer is not None:
        return _TelemetrySpan(name, args)
    return NULL_SPAN


def instant(name: str, **args) -> None:
    t = _active
    if t is not None:
        t.instant(name, **args)
    cb = _instant_observer
    if cb is not None:
        cb(name, args)


def counter(name: str, **series) -> None:
    t = _active
    if t is not None:
        t.counter(name, **series)


def sinks_active() -> bool:
    """True when completed spans go anywhere (Tracer or telemetry
    observer). Request-phase instrumentation gates its clock reads on
    it."""
    return _active is not None or _span_observer is not None


def complete_at(name: str, t0: float, t1: float, **args) -> None:
    """Record a span from caller-measured ``perf_counter`` endpoints: a
    request phase starts on one thread and ends on another, so the
    producer stamps ``t0`` and the consumer ``t1``. Same tracer and
    observer fan-out as a Span's exit; a no-op with no sink."""
    t = _active
    if t is not None:
        t._complete(name, t0, t1, args)
        return
    cb = _span_observer
    if cb is not None:
        cb(name, max((t1 - t0) * 1e3, 0.0), args)
