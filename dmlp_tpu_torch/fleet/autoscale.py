"""Supervised replicas: the fleet's lifecycle owner.

Port of ``dmlp_tpu/fleet/autoscale.py``: ``resilience/supervise.py``'s
heartbeat, deadline and bounded relaunch lifted to the fleet, where the
router's health prober is the heartbeat.

- **Crash detection.** Each managed replica is watched two ways: its
  process (``poll()``: a killed or crashed daemon is seen within one tick;
  a mesh replica's daemon exits non-zero when one of its worker ranks
  dies) and its probe health (marked down by the prober for longer than
  ``unhealthy_deadline_s``: a hung interpreter).
- **Bounded relaunch.** A crashed or hung replica leaves the routing
  table, is killed if still alive, and is relaunched from the spec, at
  most ``relaunch_budget`` times over the supervisor's life. An exhausted
  budget degrades to a smaller fleet (``fleet.scale.degraded`` gauge and
  a flight event) instead of crash-looping.
- **Scaling.** ``target_replicas`` is a pure function of a window of the
  offered load (mean in-flight relays per available replica);
  ``predictive_target_replicas`` one of an SLO objective's burn rate and
  latency slope (``obs.slo``). Scale-up spawns and registers a replica;
  scale-down retires one through the drain choreography (mark draining,
  in-band drain, wait for exit 0), the path the re-split uses too.
- **Re-split trigger.** When a replica's probed corpus rows cross
  ``reshard_threshold`` of its capacity, the supervisor hands it to
  ``fleet/reshard.py`` (one split in flight at a time).

Every transition is a ``fleet.scale.*`` counter and a trace instant; the
router's ``stats`` carries the supervisor's snapshot.
"""

from __future__ import annotations

import math
import os
import subprocess
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from dmlp_tpu_torch.fleet import harness as fh
from dmlp_tpu_torch.fleet.router import FleetRouter, Replica
from dmlp_tpu_torch.obs import telemetry
from dmlp_tpu_torch.obs.trace import instant as obs_instant


class ReplicaSpec:
    """How to spawn one replica daemon (the supervisor's template).

    ``flags`` are the daemon's own (``--device cpu``, ``--pallas``,
    ``--mesh RxC --backend gloo``, ...). A mesh replica's daemon starts
    its R·C − 1 worker ranks itself from ``--mesh``; the environment
    carries no compiler setting for them. ``compile_cache`` is every
    spawn's ``--compile-cache`` (``utils.compile_cache``): relaunches,
    scale-ups and re-splits load the first generation's libraries instead
    of building them again."""

    def __init__(self, corpus_path: str, out_dir: str,
                 warm_spec: str = "1x1", batch_cap: int = 32,
                 flags: Optional[List[str]] = None,
                 env_extra: Optional[Dict[str, str]] = None,
                 capacity: Optional[int] = None,
                 compile_cache: Optional[str] = None):
        self.corpus_path = os.path.abspath(corpus_path)
        self.out_dir = os.path.abspath(out_dir)
        self.warm_spec = warm_spec
        self.batch_cap = int(batch_cap)
        self.flags = list(flags or [])
        self.env_extra = dict(env_extra or {})
        self.capacity = capacity
        self.compile_cache = (os.path.abspath(compile_cache)
                              if compile_cache else None)

    def spawn(self, name: str,
              capacity: Optional[int] = None) -> fh.FleetProc:
        flags = list(self.flags)
        cap = capacity or self.capacity
        if cap:
            flags += ["--capacity", str(int(cap))]
        cache = {"compile_cache": self.compile_cache} \
            if self.compile_cache else {}
        return fh.spawn_replica(self.corpus_path, self.out_dir, name,
                                self.warm_spec,
                                batch_cap=self.batch_cap, flags=flags,
                                env_extra=self.env_extra, **cache)


class ManagedReplica:
    """One supervised replica: the spawned process + its routing-table
    entry + lifecycle bookkeeping."""

    def __init__(self, name: str, proc: fh.FleetProc, replica: Replica,
                 capacity: Optional[int] = None, generation: int = 0):
        self.name = name
        self.proc = proc
        self.replica = replica
        self.capacity = capacity
        self.generation = generation
        self.retiring = False

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "replica": self.replica.name,
                "pid": self.proc.proc.pid,
                "port": self.proc.ready.get("port"),
                "capacity": self.capacity,
                "generation": self.generation,
                "retiring": self.retiring}


def target_replicas(window: List[float], current: int, minimum: int,
                    maximum: int, high: float, low: float) -> int:
    """The PURE scaling policy: median of the load window (mean
    in-flight per available replica) against the high/low watermarks.
    One step at a time, clamped to [minimum, maximum]."""
    if not window:
        return current
    med = sorted(window)[len(window) // 2]
    if med > high and current < maximum:
        return current + 1
    if med < low and current > minimum:
        return current - 1
    return current


def predictive_target_replicas(signals: Dict[str, Any], current: int,
                               minimum: int, maximum: int, *,
                               lead_time_s: float = 10.0,
                               down_margin: float = 0.5) -> int:
    """The PURE predictive policy over one SLO objective's live
    signals (``obs.slo.SLOEvaluator.signals``): scale on the LEADING
    indicators — error-budget burn and latency slope — not on queue
    depth, which only moves once the SLO is already slipping.

    Scale UP one step when the fast-window burn rate exceeds budget
    (burn > 1: the objective is being violated right now) OR the
    Theil–Sen latency slope projects the threshold crossing within
    ``lead_time_s`` (``projected_s`` — the time a replica spawn +
    warm takes is exactly the lead this buys). Scale DOWN one step
    only when the picture is unambiguously calm: zero burn on BOTH
    windows, non-positive slope, and the fast-window quantile under
    ``down_margin`` of the threshold — the hysteresis gap between the
    up and down conditions is what keeps flat load from oscillating
    (a flat series trips neither side, so the decision is a fixed
    point). One step at a time, clamped to [minimum, maximum]."""
    burn_fast = float(signals.get("burn_fast", 0.0))
    burn_slow = float(signals.get("burn_slow", 0.0))
    slope = float(signals.get("slope_ms_per_s", 0.0))
    projected = float(signals.get("projected_s", math.inf))
    p_fast = signals.get("p_fast")
    threshold = signals.get("threshold")
    if math.isnan(slope):
        slope = 0.0
    if current < maximum and (burn_fast > 1.0
                              or projected <= lead_time_s):
        return current + 1
    calm = burn_fast == 0.0 and burn_slow == 0.0 and slope <= 0.0
    if calm and isinstance(p_fast, (int, float)) \
            and isinstance(threshold, (int, float)) \
            and not math.isnan(p_fast) \
            and p_fast < down_margin * float(threshold) \
            and current > minimum:
        return current - 1
    return current


class FleetSupervisor:
    """Spawns, watches, scales, re-splits, and retires the managed
    replica fleet behind one :class:`FleetRouter`."""

    def __init__(self, router: FleetRouter,
                 spec: Optional[ReplicaSpec] = None, *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 relaunch_budget: int = 3, poll_s: float = 0.5,
                 unhealthy_deadline_s: float = 20.0,
                 scale_high: float = 4.0, scale_low: float = 0.25,
                 scale_window: int = 6,
                 load_fn: Optional[Callable[[], float]] = None,
                 reshard_threshold: Optional[float] = None,
                 grow_factor: int = 2,
                 ready_timeout_s: float = 600.0,
                 drain_timeout_s: float = 120.0,
                 policy: str = "reactive",
                 slo: Optional[Any] = None,
                 slo_objective: Optional[str] = None,
                 lead_time_s: float = 10.0):
        if policy not in ("reactive", "predictive"):
            raise ValueError(f"scaling policy {policy!r}")
        self.router = router
        self.spec = spec
        self.min_replicas = int(min_replicas)
        self.max_replicas = max(int(max_replicas), self.min_replicas)
        self.relaunch_budget = int(relaunch_budget)
        self.poll_s = poll_s
        self.unhealthy_deadline_s = unhealthy_deadline_s
        self.scale_high = scale_high
        self.scale_low = scale_low
        self.scale_window = max(int(scale_window), 1)
        self.load_fn = load_fn
        self.reshard_threshold = reshard_threshold
        self.grow_factor = max(int(grow_factor), 2)
        self.ready_timeout_s = ready_timeout_s
        self.drain_timeout_s = drain_timeout_s
        #: "reactive" (watermarks over the in-flight window — the
        #: fallback and A/B arm) or "predictive" (obs.slo burn + slope
        #: signals; reverts to reactive while signals are absent)
        self.policy = policy
        self.slo = slo
        if slo_objective is None and slo is not None:
            # Default to the first declared latency objective — the
            # burn/slope signal set the predictive policy consumes.
            slo_objective = next(
                (o.name for o in getattr(slo, "objectives", [])
                 if getattr(o, "kind", "") == "latency"), None)
        self.slo_objective = slo_objective
        self.lead_time_s = float(lead_time_s)
        self._lock = threading.Lock()     # guards managed/retired lists
        self.managed: List[ManagedReplica] = []
        self.retired: List[Dict[str, Any]] = []
        self.degraded = False
        self._seq = 0
        self._load_window: Deque[float] = deque(maxlen=self.scale_window)
        self._resharding = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        router.supervisor = self

    # -- introspection ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            managed = [m.snapshot() for m in self.managed]
            retired = list(self.retired)
        return {"managed": managed, "retired": retired,
                "relaunch_budget_left": self.relaunch_budget,
                "degraded": self.degraded,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas}

    def _managed_list(self) -> List[ManagedReplica]:
        with self._lock:
            return list(self.managed)

    # -- spawn / register / retire ---------------------------------------------

    def _next_name(self) -> str:
        with self._lock:
            self._seq += 1
            return f"replica_s{self._seq:02d}"

    def spawn_proc(self, name: str,
                   capacity: Optional[int] = None) -> fh.FleetProc:
        """Spawn one replica daemon from the spec and block until it
        is ready (scrape port announced). The re-shard choreography
        calls this to stage a replacement BEFORE it enters the table."""
        if self.spec is None:
            raise RuntimeError("supervisor has no ReplicaSpec to "
                               "spawn from")
        fp = self.spec.spawn(name, capacity=capacity)
        fh.await_replica(fp, timeout_s=self.ready_timeout_s)
        return fp

    def register(self, fp: fh.FleetProc,
                 capacity: Optional[int] = None,
                 generation: int = 0) -> ManagedReplica:
        """Enter a ready replica into the routing table + the managed
        set."""
        rep = self.router.add_replica("127.0.0.1", fp.ready["port"],
                                      scrape_port=fp.scrape_port)
        mr = ManagedReplica(fp.name, fp, rep, capacity=capacity,
                            generation=generation)
        with self._lock:
            self.managed.append(mr)
        telemetry.registry().gauge("fleet.scale.replicas").set(
            len(self._managed_list()))
        return mr

    def spawn_one(self, capacity: Optional[int] = None,
                  generation: int = 0) -> ManagedReplica:
        fp = self.spawn_proc(self._next_name(), capacity=capacity)
        return self.register(fp, capacity=capacity or
                             (self.spec.capacity if self.spec else None),
                             generation=generation)

    def retire(self, mr: ManagedReplica, drain: bool = True,
               reason: str = "scale_down") -> Optional[int]:
        """The drain choreography: mark + remove from the table, wait
        for the daemon's orderly exit (0). Returns the exit code."""
        mr.retiring = True
        self.router.remove_replica(mr.replica.name, drain=drain)
        rc: Optional[int] = None
        try:
            rc = mr.proc.proc.wait(timeout=self.drain_timeout_s)
        except subprocess.TimeoutExpired:
            mr.proc.proc.kill()
            rc = mr.proc.proc.wait(timeout=30)
        with self._lock:
            if mr in self.managed:
                self.managed.remove(mr)
            self.retired.append({"name": mr.name, "rc": rc,
                                 "reason": reason,
                                 "generation": mr.generation})
        telemetry.registry().gauge("fleet.scale.replicas").set(
            len(self._managed_list()))
        obs_instant("fleet.scale.retire", replica=mr.name, rc=rc,
                    reason=reason)
        return rc

    # -- lifecycle -------------------------------------------------------------

    def start(self, initial: Optional[int] = None) -> None:
        """Spawn the initial fleet (``min_replicas`` by default), then
        start the watch thread."""
        for _ in range(initial if initial is not None
                       else self.min_replicas):
            self.spawn_one()
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch_loop,
                                        name="fleet-supervisor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop watching (no more relaunches) — call BEFORE the router
        drains, or the supervisor would read the drain as a mass crash
        and relaunch the fleet it is trying to shut down."""
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=30)

    def wait_children(self, timeout_s: float = 120.0
                      ) -> List[Dict[str, Any]]:
        """After the router's drain propagated: collect every managed
        replica's exit code (the all-rc-0 contract)."""
        out = []
        for mr in self._managed_list():
            try:
                rc = mr.proc.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                mr.proc.proc.kill()
                rc = mr.proc.proc.wait(timeout=30)
            out.append({"name": mr.name, "rc": rc})
        return out

    # -- the watch loop --------------------------------------------------------

    def _watch_loop(self) -> None:
        while not self._stop.wait(timeout=self.poll_s):
            try:
                self.poll_once()
            except Exception as e:  # check: no-retry — the supervisor outlives any
                # single poll failure: the event is recorded, the next
                # tick re-evaluates from scratch
                obs_instant("fleet.scale.poll_error",
                            error=f"{type(e).__name__}: {e}")

    def poll_once(self) -> None:
        """One supervision tick: crash detection -> re-shard check ->
        scaling decision. Tests drive this directly (no thread)."""
        if self._stop.is_set():
            return
        self._check_crashes()
        self._check_reshard()
        self._check_scaling()

    # -- crash detection + bounded relaunch ------------------------------------

    def _check_crashes(self) -> None:
        for mr in self._managed_list():
            if mr.retiring:
                continue
            rc = mr.proc.proc.poll()
            hung = (rc is None and self.unhealthy_deadline_s > 0
                    and mr.replica.down_for() > self.unhealthy_deadline_s)
            if rc is None and not hung:
                continue
            reason = (f"exited rc {rc}" if rc is not None else
                      f"probe-dead > {self.unhealthy_deadline_s:.3g}s "
                      "(hung)")
            self._handle_crash(mr, reason)

    def _handle_crash(self, mr: ManagedReplica, reason: str) -> None:
        reg = telemetry.registry()
        reg.counter("fleet.scale.crashes").inc(
            label="hung" if "hung" in reason else "exited")
        obs_instant("fleet.scale.crash", replica=mr.name,
                    reason=reason)
        telemetry.flight_event("fleet.scale.crash", replica=mr.name,
                               reason=reason)
        mr.retiring = True
        self.router.remove_replica(mr.replica.name, drain=False)
        if mr.proc.proc.poll() is None:
            mr.proc.proc.kill()
            try:
                mr.proc.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass   # kernel owns it now; the table no longer does
        with self._lock:
            if mr in self.managed:
                self.managed.remove(mr)
            self.retired.append({"name": mr.name,
                                 "rc": mr.proc.proc.poll(),
                                 "reason": f"crash: {reason}",
                                 "generation": mr.generation})
        if self.relaunch_budget > 0:
            self.relaunch_budget -= 1
            reg.counter("fleet.scale.relaunches").inc()
            obs_instant("fleet.scale.relaunch", replaces=mr.name,
                        budget_left=self.relaunch_budget)
            try:
                self.spawn_one(capacity=mr.capacity,
                               generation=mr.generation + 1)
                return
            except Exception as e:  # check: no-retry — a failed relaunch is the
                # budget's problem, not a crash loop
                obs_instant("fleet.scale.relaunch_failed",
                            error=f"{type(e).__name__}: {e}")
        # Budget exhausted (or relaunch failed): degraded smaller
        # fleet — recorded loudly, served quietly.
        self.degraded = True
        telemetry.registry().gauge("fleet.scale.degraded").set(1)
        telemetry.flight_event("fleet.scale.degraded",
                               replicas=len(self._managed_list()),
                               lost=mr.name)
        obs_instant("fleet.scale.degraded", lost=mr.name,
                    replicas=len(self._managed_list()))

    # -- staged shard re-split -------------------------------------------------

    def _check_reshard(self) -> None:
        if self.reshard_threshold is None or self._resharding \
                or self.spec is None:
            return
        for mr in self._managed_list():
            if mr.retiring:
                continue
            sig = mr.replica.last_corpus
            cap = mr.replica.capacity_rows
            if not sig or not cap:
                continue
            if sig["rows"] < self.reshard_threshold * cap:
                continue
            from dmlp_tpu_torch.fleet import reshard
            self._resharding = True
            try:
                reshard.execute_resplit(self, mr,
                                        grow_factor=self.grow_factor)
            finally:
                self._resharding = False
            return           # staged: one split per tick, at most

    def force_resplit(self, mr: Optional[ManagedReplica] = None
                      ) -> Dict[str, Any]:
        """Operator/chaos hook: split now, threshold or not."""
        from dmlp_tpu_torch.fleet import reshard
        target = mr or next((m for m in self._managed_list()
                             if not m.retiring), None)
        if target is None:
            return {"ok": False, "reason": "no managed replica"}
        self._resharding = True
        try:
            return reshard.execute_resplit(self, target,
                                           grow_factor=self.grow_factor)
        finally:
            self._resharding = False

    # -- scaling ---------------------------------------------------------------

    def offered_load(self) -> float:
        """Mean in-flight relays per available replica, from the
        router's per-replica load tracking."""
        reps = [r for r in self.router.replica_list() if r.available()]
        if not reps:
            return 0.0
        return sum(r.load() for r in reps) / len(reps)

    def _check_scaling(self) -> None:
        if self.policy == "predictive" \
                and self._check_scaling_predictive():
            return
        load = (self.load_fn or self.offered_load)()
        self._load_window.append(float(load))
        if len(self._load_window) < self.scale_window:
            return
        current = len([m for m in self._managed_list()
                       if not m.retiring])
        target = target_replicas(list(self._load_window), current,
                                 self.min_replicas, self.max_replicas,
                                 self.scale_high, self.scale_low)
        telemetry.registry().gauge("fleet.scale.target_replicas").set(
            target)
        if target == current:
            return
        self._load_window.clear()     # re-observe after acting
        self._act_on_target(current, target, "reactive")

    def _check_scaling_predictive(self) -> bool:
        """The predictive arm: one scaling decision from the SLO
        evaluator's live burn-rate + slope signals. Returns False
        (-> reactive fallback) while the evaluator has no usable
        signal yet — an SLO engine that has not evaluated anything
        must not freeze scaling entirely."""
        if self.slo is None or not self.slo_objective:
            return False
        try:
            sig = self.slo.signals(self.slo_objective)
        except KeyError:
            return False
        if "burn_fast" not in sig:
            return False               # no evaluation tick yet
        current = len([m for m in self._managed_list()
                       if not m.retiring])
        target = predictive_target_replicas(
            sig, current, self.min_replicas, self.max_replicas,
            lead_time_s=self.lead_time_s)
        telemetry.registry().gauge("fleet.scale.target_replicas").set(
            target)
        if target != current:
            self._act_on_target(current, target, "predictive")
        return True

    def _act_on_target(self, current: int, target: int,
                       policy: str) -> None:
        """Shared one-step actuation for both policies: spawn or
        retire, with the policy stamped on the trace event so the A/B
        arms are attributable in the merged fleet trace."""
        reg = telemetry.registry()
        if target > current:
            reg.counter("fleet.scale.up").inc(label=policy)
            obs_instant("fleet.scale.up", replicas=target,
                        policy=policy)
            try:
                self.spawn_one()
            except Exception as e:  # check: no-retry — scale-up is best effort:
                # the next window re-decides
                obs_instant("fleet.scale.up_failed",
                            error=f"{type(e).__name__}: {e}")
        else:
            victim = next((m for m in reversed(self._managed_list())
                           if not m.retiring), None)
            if victim is not None:
                reg.counter("fleet.scale.down").inc(label=policy)
                obs_instant("fleet.scale.down", replica=victim.name,
                            policy=policy)
                self.retire(victim, drain=True, reason="scale_down")
