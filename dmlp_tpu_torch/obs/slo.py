"""Streaming SLO engine: declarative objectives, multi-window burn
rates, and the predictive-autoscaling signal — port of
``dmlp_tpu/obs/slo.py`` (pure Python, unchanged in behaviour).

Objectives are declared as strings and evaluated continuously against
the process registry's windowed histograms (obs.telemetry's rotating
sub-window rings), with the alert lifecycle and trend slopes exported on
the registry, the trace and the flight recorder.

- **Objectives** (:func:`parse_objective`)::

      fleet.request_latency_ms p99 < 50 over 60s
      serve.ok/serve.requests availability > 0.99 over 1m

  A latency objective ``pQQ < X over W`` budgets a ``1 - QQ`` bad
  fraction (samples slower than X ms) over window W; an availability
  objective ``good/total > Y`` budgets ``1 - Y`` failed requests.

- **Dual-window burn rates.** Burn = observed bad fraction over a
  window, divided by the budget: burn 1.0 consumes the error budget
  exactly at the sustainable rate. Each objective is evaluated on a
  FAST window (onset detection, default ``window_s / 6``) and its
  SLOW declared window (sustained-violation confirmation) — the
  Google-SRE multi-window rule scaled to in-process horizons.

- **Alert lifecycle with hysteresis** (flap suppression):
  ``ok → pending`` when the fast burn exceeds budget; ``pending →
  firing`` only after BOTH windows burn hot for ``for_ticks``
  consecutive evaluations; ``firing → ok`` (and ``pending → ok``)
  only after ``clear_ticks`` consecutive healthy evaluations. A load
  spike that alternates good/bad ticks parks in ``pending`` instead
  of flapping fire/clear. Every transition is emitted as an
  ``slo.alert`` trace instant (validated by ``tools/check_trace.py
  --fleet``), a flight-recorder event, and an ``slo.transitions``
  counter; entering ``firing`` additionally dumps the flight ring
  (``FLIGHT_slo_breach_*.json`` — the last 512 events around the
  violation are always captured).

- **Trend estimators.** Per tracked latency series the evaluator
  records the fast-window median each tick and fits a robust
  Theil–Sen slope (median of pairwise slopes — one straggler tick
  cannot bend it). Exposed as ``slo.trend.slope_ms_per_s`` +
  ``slo.trend.projected_crossing_s`` gauges; the projected time to
  threshold crossing is the LEADING signal
  ``fleet.autoscale.predictive_target_replicas`` consumes — scale on
  latency slope, not queue depth.

- **OpenMetrics.** The ``slo_*`` family rides the existing registry
  exposition: ``slo_ok`` / ``slo_pending`` / ``slo_firing`` (one-hot
  per objective, keyed by objective id), ``slo_burn_rate_fast`` /
  ``slo_burn_rate_slow``, and the trend gauges — a scraper needs no
  new endpoint to see objective state.

Import-light (stdlib only), lock-discipline clean: state mutates under
the evaluator's lock, emission (gauges, trace instants, flight dumps)
happens strictly after release — no registry or sink call ever runs
under it.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from dmlp_tpu_torch.obs import telemetry
from dmlp_tpu_torch.obs import trace as obs_trace

# -- objective grammar --------------------------------------------------------

#: alert lifecycle states (ordered by severity)
OK, PENDING, FIRING = "ok", "pending", "firing"
_STATE_LEVEL = {OK: 0, PENDING: 1, FIRING: 2}

_LATENCY_RE = re.compile(
    r"^(?P<metric>[a-z][a-z0-9_.]*)\s+p(?P<q>\d{1,2}(\.\d+)?)\s*<\s*"
    r"(?P<x>[0-9.]+)\s+over\s+(?P<w>[0-9.]+(ms|s|m|h)?)$")
_AVAIL_RE = re.compile(
    r"^(?P<good>[a-z][a-z0-9_.]*)/(?P<total>[a-z][a-z0-9_.]*)\s+"
    r"availability\s*>\s*(?P<y>0?\.[0-9]+|1(\.0+)?)\s+"
    r"over\s+(?P<w>[0-9.]+(ms|s|m|h)?)$")
_WINDOW_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_window(text: str) -> float:
    """``"10s"`` / ``"1m"`` / ``"0.5h"`` / bare seconds -> seconds."""
    m = re.match(r"^([0-9.]+)(ms|s|m|h)?$", text.strip())
    if not m:
        raise ValueError(f"unparseable window {text!r}")
    return float(m.group(1)) * _WINDOW_UNITS.get(m.group(2) or "s", 1.0)


class Objective:
    """One declared objective. ``kind`` is ``"latency"`` (histogram
    quantile under a threshold) or ``"availability"`` (good/total
    counter ratio above a target). ``budget`` is the allowed bad
    fraction the burn rate is normalized by."""

    def __init__(self, name: str, kind: str, *, metric: str = "",
                 quantile: float = 0.99, threshold: float = 0.0,
                 good: str = "", total: str = "", target: float = 0.0,
                 window_s: float = 60.0,
                 sample_fn: Optional[Callable[[], Tuple[float, float]]]
                 = None):
        if kind not in ("latency", "availability"):
            raise ValueError(f"objective kind {kind!r}")
        self.name = name
        self.kind = kind
        self.metric = metric
        self.quantile = float(quantile)
        self.threshold = float(threshold)
        self.good = good
        self.total = total
        self.target = float(target)
        self.window_s = float(window_s)
        #: cumulative (good, total) override — the router feeds
        #: fleet-wide availability from the MERGED scrape through this
        self.sample_fn = sample_fn
        if kind == "latency" and not (0.0 < self.quantile < 1.0):
            raise ValueError(f"latency quantile {quantile}")
        if kind == "availability" and not (0.0 < self.target < 1.0):
            raise ValueError(f"availability target {target}")

    @property
    def budget(self) -> float:
        """Allowed bad fraction: ``1 - q`` / ``1 - target``."""
        return (1.0 - self.quantile if self.kind == "latency"
                else 1.0 - self.target)

    def window_label(self) -> str:
        w = self.window_s
        return f"{w / 60:g}m" if w >= 60 else f"{w:g}s"

    def describe(self) -> str:
        if self.kind == "latency":
            return (f"{self.metric} p{self.quantile * 100:g} < "
                    f"{self.threshold:g} over {self.window_label()}")
        return (f"{self.good}/{self.total} availability > "
                f"{self.target:g} over {self.window_label()}")


def parse_objective(spec: str, name: Optional[str] = None) -> Objective:
    """Parse one declarative objective string (module docstring
    grammar). ``name`` defaults to a derived id such as
    ``fleet.request_latency_ms:p99``."""
    s = spec.strip()
    m = _LATENCY_RE.match(s)
    if m:
        q = float(m.group("q")) / 100.0
        return Objective(
            name or f"{m.group('metric')}:p{m.group('q')}", "latency",
            metric=m.group("metric"), quantile=q,
            threshold=float(m.group("x")),
            window_s=parse_window(m.group("w")))
    m = _AVAIL_RE.match(s)
    if m:
        return Objective(
            name or f"{m.group('total')}:availability", "availability",
            good=m.group("good"), total=m.group("total"),
            target=float(m.group("y")),
            window_s=parse_window(m.group("w")))
    raise ValueError(
        f"unparseable objective {spec!r} (expected "
        "'<metric> pQQ < X over W' or "
        "'<good>/<total> availability > Y over W')")


# -- robust trend -------------------------------------------------------------

def theil_sen(points: Sequence[Tuple[float, float]]) -> float:
    """Median of all pairwise slopes — the robust trend estimator (up
    to ~29% outlier points cannot bend it, unlike least squares).
    NaN below two distinct x values."""
    slopes: List[float] = []
    n = len(points)
    for i in range(n):
        xi, yi = points[i]
        for j in range(i + 1, n):
            xj, yj = points[j]
            if xj != xi:
                slopes.append((yj - yi) / (xj - xi))
    if not slopes:
        return math.nan
    slopes.sort()
    mid = len(slopes) // 2
    if len(slopes) % 2:
        return slopes[mid]
    return 0.5 * (slopes[mid - 1] + slopes[mid])


# -- evaluator ----------------------------------------------------------------

class _ObjectiveState:
    """Mutable per-objective evaluation state (guarded by the
    evaluator's lock)."""

    def __init__(self, obj: Objective):
        self.obj = obj
        self.state = OK
        self.bad_streak = 0
        self.good_streak = 0
        #: (t, cumulative good, cumulative total) ring (availability)
        self.counter_ring: deque = deque()
        #: (t, fast-window median) ring for the trend fit
        self.trend_ring: deque = deque()
        self.signals: Dict[str, Any] = {"state": OK}
        self.cycles = 0            # completed ok->...->ok alert cycles


class SLOEvaluator:
    """Continuous evaluation of declared objectives against a live
    registry. ``tick()`` is one evaluation pass (tests and in-process
    hosts drive it directly); ``start()`` runs it on a deadline-
    anchored background thread.

    ``trend_metrics`` names EXTRA histograms (e.g. the queue-phase
    latency) whose fast-window median slope is tracked and exported
    even without an objective on them — the queue-phase tripwire."""

    def __init__(self, objectives: Sequence[Any],
                 registry: Optional[telemetry.Registry] = None, *,
                 fast_s: Optional[float] = None,
                 for_ticks: int = 2, clear_ticks: int = 3,
                 min_samples: int = 1, trend_points: int = 12,
                 trend_metrics: Sequence[str] = (),
                 sub_s: Optional[float] = None,
                 time_fn=None, flight_dump: bool = True):
        self.registry = registry or telemetry.REGISTRY
        self.objectives: List[Objective] = [
            o if isinstance(o, Objective) else parse_objective(o)
            for o in objectives]
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.for_ticks = max(int(for_ticks), 1)
        self.clear_ticks = max(int(clear_ticks), 1)
        self.min_samples = max(int(min_samples), 1)
        self.trend_points = max(int(trend_points), 3)
        self.trend_metrics = list(trend_metrics)
        self.flight_dump = flight_dump
        self._time = time_fn or time.monotonic
        self._fast_s = fast_s
        self._sub_s = sub_s
        self._lock = threading.Lock()
        self._states = {o.name: _ObjectiveState(o)
                        for o in self.objectives}
        self._trend_rings: Dict[str, deque] = {
            m: deque() for m in self.trend_metrics}
        self.transitions: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._bind_windows()

    # -- window plumbing -------------------------------------------------------

    def fast_window(self, obj: Objective) -> float:
        if self._fast_s is not None:
            return min(float(self._fast_s), obj.window_s)
        return max(obj.window_s / 6.0, 2.0 * self._sub_for(obj))

    def _sub_for(self, obj: Objective) -> float:
        if self._sub_s is not None:
            return float(self._sub_s)
        # Enough resolution for the fast window: >= 4 sub-windows in
        # window_s / 6, capped at the module default.
        return min(telemetry.WINDOW_SUB_S, obj.window_s / 24.0)

    def _bind_windows(self) -> None:
        """Enable the sliding-window ring on every histogram an
        objective or trend series reads (get-or-create: declaring an
        objective before the serving path registers the histogram is
        fine, the registry returns the same object later)."""
        horizons = [o.window_s for o in self.objectives] or [60.0]
        max_w = max(horizons)
        for obj in self.objectives:
            if obj.kind != "latency":
                continue
            h = self.registry.histogram(obj.metric, unit="ms")  # check: allow-metric-name — objective-declared series
            h.enable_windows(max_window_s=max(max_w, obj.window_s),
                             sub_s=self._sub_for(obj),
                             time_fn=self._time)
        sub = (float(self._sub_s) if self._sub_s is not None
               else min(telemetry.WINDOW_SUB_S, max_w / 24.0))
        for name in self.trend_metrics:
            h = self.registry.histogram(name, unit="ms")  # check: allow-metric-name — trend-declared series
            h.enable_windows(max_window_s=max_w, sub_s=sub,
                             time_fn=self._time)

    # -- one evaluation pass ---------------------------------------------------

    def _measure(self, st: _ObjectiveState, now: float
                 ) -> Dict[str, Any]:
        """Raw window measurements for one objective — registry reads
        only, NO evaluator state mutation (runs outside the lock)."""
        obj = st.obj
        out: Dict[str, Any] = {"objective": obj.name,
                               "window": obj.window_label(),
                               "budget": obj.budget}
        if obj.kind == "latency":
            out["threshold"] = obj.threshold
            h = self.registry.get(obj.metric)
            fast = self.fast_window(obj)
            bf, nf = h.window_above(fast, obj.threshold)
            bs, ns = h.window_above(obj.window_s, obj.threshold)
            out["fast_n"], out["slow_n"] = nf, ns
            out["burn_fast"] = (bf / nf / obj.budget) if nf else 0.0
            out["burn_slow"] = (bs / ns / obj.budget) if ns else 0.0
            out["p_fast"] = h.window_quantile(fast, obj.quantile)
            out["p_window"] = h.window_quantile(obj.window_s,
                                                obj.quantile)
            out["median_fast"] = h.window_quantile(fast, 0.5)
        else:
            if obj.sample_fn is not None:
                good, total = obj.sample_fn()
            else:
                g = self.registry.get(obj.good)
                t = self.registry.get(obj.total)
                good = g.total() if g is not None else 0.0
                total = t.total() if t is not None else 0.0
            out["cum_good"], out["cum_total"] = float(good), float(total)
        return out

    def _avail_burns(self, st: _ObjectiveState, now: float,
                     meas: Dict[str, Any]) -> None:
        """Availability burn rates from the cumulative-counter ring
        (mutates the ring — caller holds the lock)."""
        obj = st.obj
        ring = st.counter_ring
        ring.append((now, meas["cum_good"], meas["cum_total"]))
        while len(ring) > 2 and ring[1][0] <= now - obj.window_s:
            ring.popleft()

        def burn(window: float) -> Tuple[float, float]:
            base = ring[0]
            for entry in ring:
                if entry[0] >= now - window:
                    break
                base = entry
            dgood = meas["cum_good"] - base[1]
            dtotal = meas["cum_total"] - base[2]
            if dtotal <= 0:
                return 0.0, 0.0
            bad_frac = max(dtotal - dgood, 0.0) / dtotal
            return bad_frac / obj.budget, dtotal

        meas["burn_fast"], meas["fast_n"] = burn(self.fast_window(obj))
        meas["burn_slow"], meas["slow_n"] = burn(obj.window_s)

    @staticmethod
    def next_state(state: str, hot_fast: bool, hot_slow: bool,
                   bad_streak: int, good_streak: int,
                   for_ticks: int, clear_ticks: int) -> str:
        """The PURE lifecycle rule (unit-testable): dual-window entry,
        streak-based hysteresis, no firing->pending shortcut."""
        if state == OK:
            return PENDING if hot_fast else OK
        if state == PENDING:
            if hot_fast and hot_slow and bad_streak >= for_ticks:
                return FIRING
            if not hot_fast and good_streak >= clear_ticks:
                return OK
            return PENDING
        # FIRING clears only after a full healthy streak on BOTH
        # windows — a single good tick inside a flapping overload
        # must not clear (and re-fire) the alert.
        if not hot_fast and not hot_slow \
                and good_streak >= clear_ticks:
            return OK
        return FIRING

    def tick(self) -> List[Dict[str, Any]]:
        """One evaluation pass over every objective. Returns the
        transitions it emitted (empty list most ticks)."""
        now = self._time()
        measures = [self._measure(st, now)
                    for st in self._states.values()]
        trend_raw: Dict[str, float] = {}
        for name in self.trend_metrics:
            h = self.registry.get(name)
            if isinstance(h, telemetry.Histogram) and h.windowed:
                sub = h._sub_s
                trend_raw[name] = h.window_quantile(
                    max(4 * sub, 10.0), 0.5)
        emitted: List[Dict[str, Any]] = []
        gauge_sets: List[Tuple[str, float, str]] = []
        with self._lock:
            for meas in measures:
                st = self._states[meas["objective"]]
                obj = st.obj
                if obj.kind == "availability":
                    self._avail_burns(st, now, meas)
                hot_fast = meas["burn_fast"] > 1.0 \
                    and meas["fast_n"] >= self.min_samples
                hot_slow = meas["burn_slow"] > 1.0 \
                    and meas["slow_n"] >= self.min_samples
                if hot_fast:
                    st.bad_streak += 1
                    st.good_streak = 0
                else:
                    st.good_streak += 1
                    st.bad_streak = 0
                new = self.next_state(
                    st.state, hot_fast, hot_slow, st.bad_streak,
                    st.good_streak, self.for_ticks, self.clear_ticks)
                med = meas.get("median_fast")
                if med is not None and not math.isnan(med):
                    st.trend_ring.append((now, med))
                    while len(st.trend_ring) > self.trend_points:
                        st.trend_ring.popleft()
                slope = theil_sen(list(st.trend_ring))
                meas["slope_ms_per_s"] = slope
                p_now = meas.get("p_fast")
                if obj.kind == "latency" and p_now is not None \
                        and not math.isnan(p_now) \
                        and not math.isnan(slope) and slope > 0 \
                        and p_now < obj.threshold:
                    meas["projected_s"] = \
                        (obj.threshold - p_now) / slope
                else:
                    meas["projected_s"] = math.inf
                meas["state"], meas["prev"] = new, st.state
                if new != st.state:
                    if new == OK and st.state != OK:
                        st.cycles += 1
                    tr = {"objective": obj.name, "prev": st.state,
                          "state": new, "window": obj.window_label(),
                          "burn_fast": round(meas["burn_fast"], 4),
                          "burn_slow": round(meas["burn_slow"], 4),
                          "t": now}
                    self.transitions.append(tr)
                    emitted.append(tr)
                    st.state = new
                    st.bad_streak = 0
                    st.good_streak = 0
                st.signals = dict(meas)
                lvl = _STATE_LEVEL[new]
                gauge_sets += [
                    ("slo.state", float(lvl), obj.name),
                    ("slo.ok", 1.0 if lvl == 0 else 0.0, obj.name),
                    ("slo.pending", 1.0 if lvl == 1 else 0.0,
                     obj.name),
                    ("slo.firing", 1.0 if lvl == 2 else 0.0,
                     obj.name),
                    ("slo.burn_rate.fast",
                     round(meas["burn_fast"], 4), obj.name),
                    ("slo.burn_rate.slow",
                     round(meas["burn_slow"], 4), obj.name)]
                if not math.isnan(slope):
                    gauge_sets.append(("slo.trend.slope_ms_per_s",
                                       round(slope, 4), obj.name))
                    if math.isfinite(meas["projected_s"]):
                        gauge_sets.append(
                            ("slo.trend.projected_crossing_s",
                             round(meas["projected_s"], 3), obj.name))
            for name, med in trend_raw.items():
                ring = self._trend_rings[name]
                if not math.isnan(med):
                    ring.append((now, med))
                    while len(ring) > self.trend_points:
                        ring.popleft()
                slope = theil_sen(list(ring))
                if not math.isnan(slope):
                    gauge_sets.append(("slo.trend.slope_ms_per_s",
                                       round(slope, 4), name))
        # Emission strictly AFTER the evaluator lock is released: the
        # registry's metric locks and the trace/flight sinks stay leaf
        # locks.
        for name, value, label in gauge_sets:
            # Names are the literal slo.* family above, routed through
            # one emission loop; the objective id rides as the label.
            self.registry.gauge(name).set(value, label=label)  # check: allow-metric-name
        for tr in emitted:
            self.registry.counter("slo.transitions").inc(
                label=tr["state"])
            obs_trace.instant("slo.alert", objective=tr["objective"],
                              prev=tr["prev"], state=tr["state"],
                              window=tr["window"],
                              burn_fast=tr["burn_fast"],
                              burn_slow=tr["burn_slow"])
            telemetry.flight_event("slo.alert",
                                   objective=tr["objective"],
                                   prev=tr["prev"], state=tr["state"],
                                   window=tr["window"])
            if tr["state"] == FIRING and self.flight_dump:
                safe = re.sub(r"[^A-Za-z0-9_]+", "_", tr["objective"])
                telemetry.dump_on_crash(f"slo_breach_{safe}")
        return emitted

    # -- signal taps -----------------------------------------------------------

    def signals(self, objective: str) -> Dict[str, Any]:
        """The latest evaluation of one objective — burn rates, window
        quantiles, slope, projected crossing, state. The predictive
        autoscale policy's input."""
        with self._lock:
            st = self._states[objective]
            return dict(st.signals)

    def trend_slope(self, metric: str) -> float:
        """Latest Theil–Sen slope (ms/s) of a trend-tracked metric."""
        with self._lock:
            ring = self._trend_rings.get(metric)
            pts = list(ring) if ring else []
        return theil_sen(pts)

    def state(self, objective: str) -> str:
        with self._lock:
            return self._states[objective].state

    def alert_cycles(self, objective: str) -> int:
        """Completed ok -> (pending|firing)+ -> ok cycles."""
        with self._lock:
            return self._states[objective].cycles

    def snapshot(self) -> Dict[str, Any]:
        """Stats-endpoint view: per-objective spec, state, burn rates,
        transition count."""
        with self._lock:
            out: Dict[str, Any] = {"objectives": {}}
            for name, st in self._states.items():
                sig = st.signals
                out["objectives"][name] = {
                    "spec": st.obj.describe(),
                    "state": st.state,
                    "burn_fast": round(sig.get("burn_fast", 0.0), 4),
                    "burn_slow": round(sig.get("burn_slow", 0.0), 4),
                    "cycles": st.cycles}
            out["transitions"] = len(self.transitions)
            return out

    # -- background loop -------------------------------------------------------

    def start(self, interval_s: float = 0.5) -> None:
        """Evaluate every ``interval_s`` on a daemon thread (deadline-
        anchored — the Sampler's drift fix applies here too)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = threading.Event()
        stop = self._stop

        def loop() -> None:
            deadline = time.monotonic()
            while not stop.is_set():
                try:
                    self.tick()
                except Exception:  # evaluation must never kill the
                    pass           # host; the next tick re-reads all
                deadline, delay = telemetry.Sampler._next_deadline(
                    deadline, time.monotonic(), float(interval_s))
                stop.wait(delay)

        self._thread = threading.Thread(target=loop, name="slo-eval",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5.0)


__all__ = [
    "OK", "PENDING", "FIRING", "Objective", "parse_objective",
    "parse_window", "theil_sen", "SLOEvaluator",
]
