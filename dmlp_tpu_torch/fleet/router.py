"""The fleet front end: one line-JSON TCP port over N daemon replicas.

Port of ``dmlp_tpu/fleet/router.py``. The router speaks the daemon's wire
protocol on both sides and stays thin: it reads no query payload beyond
the ``op`` field and relays each replica's response line verbatim, so a
client sees exactly the bytes one daemon produced (fleet byte identity
reduces to daemon byte identity).

Routing policy:

- **Queries** go to the least-loaded healthy, non-draining replica. They
  are idempotent reads, so a replica failing mid-request (connection
  refused, reset or EOF, classified by ``resilience.retry.classify``) is
  retried on a different replica, at most once per replica; the client
  still receives exactly one response. A ``rejected: draining`` response
  is replica-local and retries elsewhere too. Every other rejection
  (admission sheds, shape and k caps) is the fleet's explicit
  backpressure and reaches the client unretried.
- **Ingest** fans out to every live replica. Any failure reports which
  replicas diverged, never retried (ingest is not idempotent).
- **stats** aggregates the replicas' state with the router's counters;
  **drain** propagates to every replica, then drains the router (rc 0).

Health: a background prober calls each replica's ``stats`` op on an
interval; request-path failures mark a replica down at once, and a
marked-down replica rejoins only after ``revive_probes`` consecutive
healthy probes. The prober also compares the replicas' corpus signatures
and, on divergence seen on consecutive rounds, drives the checksum-driven
repair (``fleet/consistency.py``); unrepairable divergence quarantines
the replica (down for good; ``fleet.consistency.*`` counters).

The replica table is dynamic: :meth:`FleetRouter.add_replica` and
:meth:`FleetRouter.remove_replica` let the supervisor
(``fleet/autoscale.py``) and the re-split (``fleet/reshard.py``) grow,
shrink and swap entries while traffic flows. Replica connections are per
request, so no thread blocks on I/O while it holds a lock.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dmlp_tpu_torch.obs import telemetry
from dmlp_tpu_torch.obs import trace as obs_trace
from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.resilience.retry import classify

from dmlp_tpu_torch.serve.protocol import MAX_LINE_BYTES, encode


class Replica:
    """One backend daemon endpoint + its guarded health/load state.

    I/O is connection-per-call: ``call`` opens a fresh socket, sends
    one line, reads one line — never under any lock (leaf ``_lock``
    guards pure state only)."""

    def __init__(self, host: str, port: int,
                 scrape_port: Optional[int] = None, index: int = 0,
                 revive_probes: int = 1):
        self.host, self.port = host, int(port)
        self.scrape_port = scrape_port
        self.index = index
        self.name = f"{host}:{port}"
        self.revive_probes = max(int(revive_probes), 1)
        self._lock = threading.Lock()
        self._healthy = True
        self._draining = False
        self._force_drain = False      # router-side freeze: sticky
        #                                against probe updates
        self._quarantined = False
        self._streak = 0               # consecutive healthy probes
        self._down_since: Optional[float] = None
        self._inflight = 0
        self._requests = 0
        self._failures = 0
        self._last_error: Optional[str] = None
        #: last probed corpus signature ({rows, checksum, epoch}) and
        #: engine capacity — the consistency/re-shard inputs
        self.last_corpus: Optional[Dict[str, int]] = None
        self.capacity_rows: Optional[int] = None

    # -- guarded state ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"replica": self.name, "healthy": self._healthy,
                    "draining": self._draining,
                    "quarantined": self._quarantined,
                    "inflight": self._inflight,
                    "requests": self._requests,
                    "failures": self._failures,
                    "last_error": self._last_error,
                    "corpus": dict(self.last_corpus)
                    if self.last_corpus else None,
                    "capacity_rows": self.capacity_rows}

    def mark(self, healthy: Optional[bool] = None,
             draining: Optional[bool] = None,
             error: Optional[str] = None) -> None:
        with self._lock:
            if healthy is not None:
                self._healthy = healthy
                self._streak = 0       # request-path verdicts reset
                #                        the revive hysteresis either way
                self._down_since = None if healthy else (
                    self._down_since or time.monotonic())
            if draining is not None:
                # An explicit mark is the ROUTER's decision (re-shard
                # freeze, drain propagation) and must survive probe
                # refreshes — the probed replica's own admission state
                # says nothing about a router-side freeze.
                self._draining = draining
                self._force_drain = draining
            if error is not None:
                self._last_error = error
                self._failures += 1

    def probe_ok(self, draining: bool = False,
                 corpus: Optional[Dict[str, int]] = None,
                 capacity_rows: Optional[int] = None) -> None:
        """One healthy probe. A marked-down replica needs
        ``revive_probes`` CONSECUTIVE healthy probes before it routes
        again — a flapping replica must not rejoin on its first good
        answer and eat a retry budget per flap. Quarantine never
        revives (the consistency escalation is terminal), and a
        router-side drain freeze (``mark(draining=True)``) is sticky —
        the probed daemon's admission state cannot un-freeze it."""
        with self._lock:
            self._draining = draining or self._force_drain
            if corpus is not None:
                self.last_corpus = corpus
            if capacity_rows is not None:
                self.capacity_rows = int(capacity_rows)
            if self._quarantined:
                return
            if not self._healthy:
                self._streak += 1
                if self._streak >= self.revive_probes:
                    self._healthy = True
                    self._streak = 0
                    self._down_since = None
            else:
                self._down_since = None

    def probe_fail(self, error: str) -> None:
        with self._lock:
            self._healthy = False
            self._streak = 0
            self._down_since = self._down_since or time.monotonic()
            self._last_error = error
            self._failures += 1

    def quarantine(self, reason: str) -> None:
        """Terminal mark-down: unrepairable divergence. The prober
        keeps probing but never revives a quarantined replica."""
        with self._lock:
            self._quarantined = True
            self._healthy = False
            self._streak = 0
            self._last_error = f"quarantined: {reason}"

    def down_for(self) -> float:
        """Seconds this replica has been continuously marked down
        (0 while healthy) — the supervisor's hung-replica deadline."""
        with self._lock:
            if self._down_since is None:
                return 0.0
            return max(time.monotonic() - self._down_since, 0.0)

    def available(self) -> bool:
        with self._lock:
            return (self._healthy and not self._draining
                    and not self._quarantined)

    def load(self) -> int:
        with self._lock:
            return self._inflight

    def _begin(self, probe: bool) -> None:
        with self._lock:
            self._inflight += 1
            if not probe:
                self._requests += 1

    def _end(self) -> None:
        with self._lock:
            self._inflight -= 1

    # -- the wire --------------------------------------------------------------

    def call(self, line: bytes, timeout_s: float = 600.0,
             probe: bool = False) -> bytes:
        """One request line -> the replica's raw response line. Raises
        OSError/ConnectionError on transport failure (the router
        classifies and retries); inflight accounting brackets the call
        so least-loaded picking sees in-progress work. ``probe=True``
        (health probes, drain propagation) keeps the per-replica
        ``requests`` stat CLIENT traffic only — a replica that served
        nothing must not look busy because the prober pinged it."""
        self._begin(probe)
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=timeout_s) as sock:
                sock.sendall(line)
                with sock.makefile("rb") as rf:
                    resp = rf.readline(MAX_LINE_BYTES + 1)
            if not resp:
                raise ConnectionError(
                    f"replica {self.name} closed the connection "
                    "mid-request")
            return resp
        finally:
            self._end()


class _RouterHandler(socketserver.StreamRequestHandler):
    """One client connection: requests answered strictly in line order
    (mirrors the daemon handler's framing and size-cap discipline)."""

    def handle(self):  # noqa: D102 (socketserver API)
        router: FleetRouter = self.server.router
        while True:
            raw = self.rfile.readline(MAX_LINE_BYTES + 1)
            if not raw:
                break
            if len(raw) > MAX_LINE_BYTES:
                self.wfile.write(encode(
                    {"ok": False,
                     "error": "request line exceeds the size cap"}))
                break
            if not raw.strip():
                continue
            router._track_inflight(+1)
            try:
                resp_line, closing = router.handle_line(raw)
                self.wfile.write(resp_line)
                self.wfile.flush()
            finally:
                router._track_inflight(-1)
            if closing:
                break


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class FleetRouter:
    """Lifecycle owner: replica table + health prober + TCP front end
    + aggregated telemetry endpoint."""

    def __init__(self, replicas: List[Tuple[str, int]],
                 scrape_ports: Optional[List[Optional[int]]] = None,
                 port: int = 0, health_interval_s: float = 1.0,
                 request_timeout_s: float = 600.0,
                 telemetry_port: Optional[int] = None,
                 revive_probes: int = 1, repair: bool = True,
                 divergence_probes: int = 2,
                 allow_empty: bool = False,
                 trace_path: Optional[str] = None,
                 objectives: Optional[List[Any]] = None,
                 slo_trend_metrics: Optional[List[str]] = None):
        scrape_ports = scrape_ports or [None] * len(replicas)
        if len(scrape_ports) != len(replicas):
            raise ValueError("one scrape port per replica (or none)")
        if not replicas and not allow_empty:
            raise ValueError("a fleet needs at least one replica "
                             "(allow_empty is the supervised-spawn "
                             "bootstrap only)")
        # The registry is process-global but stats() divides by THIS
        # router's lifetime: zero the fleet.* counters so a second
        # router in one process (tests, embedders) doesn't inherit the
        # first one's retries/rejections — same discipline as the
        # daemon's serve.* reset.
        telemetry.registry().reset(prefix="fleet")
        self.revive_probes = max(int(revive_probes), 1)
        self.repair = bool(repair)
        self.divergence_probes = max(int(divergence_probes), 1)
        # The replica TABLE is mutable (autoscale/reshard add, remove,
        # and swap entries live); mutations run under _lock, iteration
        # sites take a list() snapshot (atomic under the GIL) and never
        # hold the lock across I/O.
        self.replicas = [Replica(h, p, scrape_port=sp, index=i,
                                 revive_probes=self.revive_probes)
                         for i, ((h, p), sp)
                         in enumerate(zip(replicas, scrape_ports))]
        self._next_index = len(self.replicas)
        #: optional fleet supervisor (autoscale.FleetSupervisor sets
        #: itself here so stats() can expose its snapshot)
        self.supervisor = None
        self.request_timeout_s = request_timeout_s
        self.health_interval_s = health_interval_s
        self._lock = threading.Lock()     # guards _rr + _draining +
        #                                   replica-table mutations only
        self._rr = 0
        self._draining = False
        self._div_streak = 0              # health-thread-local state
        self._scrape_cache = None         # lazy fleet.scrape.ScrapeCache
        self._drain_event = threading.Event()
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        self._stop_health = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._server = _Server(("127.0.0.1", port), _RouterHandler)
        self._server.router = self
        self.port = self._server.server_address[1]
        self._server_thread: Optional[threading.Thread] = None
        self._telemetry_port = telemetry_port
        self._telemetry_httpd = None
        self._t_ready: Optional[float] = None
        # Request tracing opt-in (same contract as the daemon's):
        # process-wide Tracer + the clock-sync marker the fleet merge
        # aligns on; written at drain/close.
        self.trace_path = trace_path
        self._tracer = None
        if trace_path:
            self._tracer = obs_trace.install(obs_trace.Tracer())
            self._tracer.sync_instant("fleet.clock_sync")
        # Fleet-level SLO objectives (obs.slo): latency objectives read
        # the router's own end-to-end fleet.request_latency_ms windowed
        # histogram; availability objectives sample good/total counters
        # from the MERGED replica scrape (the fleet served what its
        # replicas served). Evaluated on the health thread's cadence.
        self.slo = None
        if objectives:
            from dmlp_tpu_torch.obs import slo as obs_slo
            objs: List[Any] = []
            for spec in objectives:
                obj = obs_slo.parse_objective(spec) \
                    if isinstance(spec, str) else spec
                if obj.kind == "availability" \
                        and obj.sample_fn is None:
                    obj.sample_fn = self._scrape_availability(obj)
                objs.append(obj)
            self.slo = obs_slo.SLOEvaluator(
                objs, telemetry.REGISTRY,
                trend_metrics=list(slo_trend_metrics or []))

    # -- the dynamic replica table ---------------------------------------------

    def replica_list(self) -> List[Replica]:
        """Snapshot of the live table (iteration never holds _lock)."""
        return list(self.replicas)

    def find_replica(self, name: str) -> Optional[Replica]:
        return next((r for r in self.replica_list() if r.name == name),
                    None)

    def add_replica(self, host: str, port: int,
                    scrape_port: Optional[int] = None) -> Replica:
        """Register a new backend (autoscale scale-up / re-shard swap-
        in). Probed once BEFORE it enters the table so the first client
        request never lands on a replica we have not seen answer."""
        rep = Replica(host, port, scrape_port=scrape_port,
                      revive_probes=self.revive_probes)
        self._probe(rep)
        with self._lock:
            rep.index = self._next_index
            self._next_index += 1
            self.replicas.append(rep)
        telemetry.registry().counter("fleet.scale.table").inc(
            label="add")
        return rep

    def remove_replica(self, name: str,
                       drain: bool = False) -> Optional[Replica]:
        """Drop a backend from the table (scale-down retire / crash /
        re-shard swap-out); ``drain=True`` also sends the in-band drain
        op (the daemon finishes queued work and exits 0 — the caller
        owns waiting on the process). In-flight relays complete on
        their own per-request connections either way."""
        with self._lock:
            rep = next((r for r in self.replicas if r.name == name),
                       None)
            if rep is not None:
                self.replicas.remove(rep)
        if rep is None:
            return None
        rep.mark(draining=True)
        if drain:
            try:
                rep.call(b'{"op": "drain"}\n', timeout_s=30.0,
                         probe=True)
            except OSError:
                pass   # already gone: that IS drained
        if self._scrape_cache is not None:
            self._scrape_cache.forget(rep.name)
        # The freshness gauges describe live table entries: a retired
        # replica's labels must leave the merged exposition too, or a
        # long-lived supervised fleet accumulates one dead label pair
        # per retirement.
        reg = telemetry.registry()
        reg.gauge("fleet.replica_scrape_age_s").remove(rep.name)
        reg.gauge("fleet.replica_scrape_stale").remove(rep.name)
        reg.counter("fleet.scale.table").inc(label="remove")
        return rep

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._probe_all()
        stop = self._stop_health
        self._health_thread = threading.Thread(
            target=self._health_loop, args=(stop,), name="fleet-health",
            daemon=True)
        self._health_thread.start()
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, name="fleet-accept",
            daemon=True)
        self._server_thread.start()
        if self._telemetry_port is not None:
            self._start_telemetry_http(self._telemetry_port)
        self._t_ready = time.monotonic()
        telemetry.registry().gauge("fleet.ready").set(1)

    def run_until_drained(self) -> None:
        while not self._drain_event.wait(timeout=0.2):
            pass
        self.drain()

    def request_drain(self) -> None:
        self._drain_event.set()

    def drain(self, propagate: bool = True) -> None:
        """Shed new work, propagate the drain to every replica, wait
        for in-flight relays to finish, close. rc 0 — not a crash."""
        with self._lock:
            self._draining = True
        telemetry.registry().gauge("fleet.ready").set(0)
        if propagate:
            for rep in self.replica_list():
                try:
                    rep.call(b'{"op": "drain"}\n', timeout_s=30.0,
                             probe=True)
                except OSError:
                    pass   # already gone: that IS drained
                rep.mark(draining=True)
        # shutdown() blocks on serve_forever's ack — which never comes
        # if start() was never called (embedders, tests): skip it then.
        if self._server_thread is not None:
            self._server.shutdown()
        self._wait_inflight_drained()
        self._stop_health.set()
        self._write_trace()
        if self._telemetry_httpd is not None:
            self._telemetry_httpd.shutdown()
        self._server.server_close()

    def _write_trace(self) -> None:
        if self._tracer is None:
            return
        try:
            self._tracer.write(self.trace_path,
                               process_name=f"router:{self.port}")
        except Exception:  # check: no-retry — a trace never kills a drain
            pass
        if obs_trace.active() is self._tracer:
            obs_trace.uninstall()
        self._tracer = None

    def close(self) -> None:
        """Abrupt teardown for tests (no drain propagation)."""
        with self._lock:
            self._draining = True
        self._drain_event.set()
        self._stop_health.set()
        if self._server_thread is not None:
            self._server.shutdown()
        self._write_trace()
        if self._telemetry_httpd is not None:
            self._telemetry_httpd.shutdown()
        self._server.server_close()

    def _track_inflight(self, delta: int) -> None:
        with self._inflight_cond:
            self._inflight += delta
            if self._inflight <= 0:
                self._inflight_cond.notify_all()

    def _wait_inflight_drained(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        with self._inflight_cond:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._inflight_cond.wait(timeout=left)

    # -- health ----------------------------------------------------------------

    def _probe(self, rep: Replica) -> None:
        try:
            raw = rep.call(b'{"op": "stats"}\n', timeout_s=10.0,
                           probe=True)
            doc = json.loads(raw)
            st = doc.get("stats", {}) if isinstance(doc, dict) else {}
            draining = bool(st.get("admission", {}).get("draining"))
            corpus = st.get("corpus")
            cap = st.get("engine", {}).get("capacity_rows")
            rep.probe_ok(draining=draining,
                         corpus=corpus if isinstance(corpus, dict)
                         else None,
                         capacity_rows=cap if isinstance(cap, int)
                         else None)
        except (OSError, ValueError) as e:
            rep.probe_fail(f"probe: {e}")

    def _probe_all(self) -> None:
        reps = self.replica_list()
        for rep in reps:
            self._probe(rep)
        telemetry.registry().gauge("fleet.replicas_healthy").set(
            sum(1 for r in reps if r.available()))
        if self.repair:
            self._consistency_tick()

    def _consistency_tick(self) -> None:
        """Compare the probed corpus signatures; on divergence seen on
        ``divergence_probes`` CONSECUTIVE rounds (one round can catch a
        fan-out mid-flight — replicas legitimately disagree for the
        milliseconds between sequential ingests), drive the targeted
        delta re-ingest; unrepairable divergence quarantines. Runs on
        the health thread, no locks held across the repair I/O."""
        from dmlp_tpu_torch.fleet import consistency as ccs
        reg = telemetry.registry()
        sigs = [(r, r.last_corpus) for r in self.replica_list()
                if r.available() and r.last_corpus]
        if len(sigs) < 2:
            self._div_streak = 0
            return
        verdict = ccs.diagnose([(r.name, sig) for r, sig in sigs])
        if verdict is None:
            self._div_streak = 0
            return
        self._div_streak += 1
        if self._div_streak < self.divergence_probes:
            return
        self._div_streak = 0
        reg.counter("fleet.consistency.divergences").inc()
        by_name = {r.name: r for r, _sig in sigs}
        ref = by_name.get(verdict["reference"])
        if ref is None:
            return
        from dmlp_tpu_torch.obs.trace import instant as obs_instant
        obs_instant("fleet.consistency.divergence",
                    reference=verdict["reference"],
                    rows=verdict["rows"],
                    divergent=",".join(verdict["divergent"]))
        for name in verdict["divergent"]:
            tgt = by_name.get(name)
            if tgt is None:
                continue
            res = ccs.repair_replica(ref, tgt)
            if res["repaired"]:
                reg.counter("fleet.consistency.repairs").inc()
                reg.counter("fleet.consistency.repaired_rows").inc(
                    res["replayed_rows"])
                obs_instant("fleet.consistency.repair", replica=name,
                            rows=res["replayed_rows"],
                            rounds=res["rounds"])
            else:
                # Escalation: a replica the repair cannot converge is
                # marked down FOR GOOD — serving two truths is the one
                # failure byte-identity cannot absorb.
                reg.counter("fleet.consistency.unrepairable").inc()
                tgt.quarantine(res.get("reason", "divergence"))
                telemetry.flight_event(
                    "fleet.consistency.unrepairable", replica=name,
                    reason=res.get("reason", ""))

    def _scrape_availability(self, obj):
        """Cumulative (good, total) for one availability objective,
        summed across every replica via the merged fleet scrape."""
        from dmlp_tpu_torch.fleet import scrape as fscrape

        def sample():
            parsed = fscrape.parse_exposition(self.fleet_metrics_text())
            return (fscrape.counter_total(parsed, obj.good),
                    fscrape.counter_total(parsed, obj.total))

        return sample

    def _health_loop(self, stop: threading.Event) -> None:
        while not stop.wait(timeout=self.health_interval_s):
            self._probe_all()
            if self.slo is not None:
                try:
                    self.slo.tick()
                except Exception:  # check: no-retry — a failing SLO tick never
                    pass           # stops the health probing

    # -- routing ---------------------------------------------------------------

    def _pick(self, exclude) -> Optional[Replica]:
        """Least-inflight available replica, round-robin on ties."""
        avail = [r for r in self.replica_list()
                 if r not in exclude and r.available()]
        if not avail:
            return None
        with self._lock:
            self._rr += 1
            rr = self._rr
        return min(avail,
                   key=lambda r: (r.load(), (r.index - rr) % 1009))

    def _draining_now(self) -> bool:
        with self._lock:
            return self._draining

    def handle_line(self, raw: bytes) -> Tuple[bytes, bool]:
        """One client line -> (response line, close-connection?)."""
        reg = telemetry.registry()
        t0 = time.monotonic()
        rid = ""
        try:
            obj = json.loads(raw)
            op = obj.get("op", "query") if isinstance(obj, dict) \
                else "invalid"
            if isinstance(obj, dict):
                rid = str(obj.get("rid", "") or "")
        except ValueError:
            op = "query"    # let a daemon produce the protocol error
        rargs = {"rid": rid} if rid else {}
        reg.counter("fleet.requests").inc(label=str(op))
        if op == "stats":
            return encode({"ok": True, "stats": self.stats()}), False
        if op == "drain":
            self._drain_event.set()
            return encode({"ok": True, "draining": True}), True
        if self._draining_now():
            reg.counter("fleet.rejected").inc(label="draining")
            # A rejected request still gets its terminal router span —
            # the merged causal tree must explain every rid, shed ones
            # included.
            with obs_span("fleet.route", op=str(op),
                          outcome="rejected_draining", **rargs):
                pass
            return encode({"ok": False, "error": "rejected: draining",
                           "draining": True}), True
        with obs_span("fleet.route", op=str(op), **rargs) as sp:
            if op == "ingest":
                resp = self._route_ingest(raw, rid)
                sp.set(outcome="done")
            else:
                resp, hops, outcome = self._route_query(raw, rid)
                sp.set(outcome=outcome, hops=hops)
        reg.histogram("fleet.request_latency_ms", unit="ms").observe(
            (time.monotonic() - t0) * 1e3, exemplar=rid or None)
        return resp, False

    def _route_query(self, raw: bytes,
                     rid: str = "") -> Tuple[bytes, int, str]:
        """Bounded retry-on-replica-failure: transport failures and
        replica-local draining rejections move on to the next replica
        (queries are idempotent reads — exactly one response either
        way); everything else relays verbatim. Returns (response line,
        hops, outcome): ``hops`` counts replica attempts, recorded in
        the ``fleet.retry_hops`` histogram and — for retried requests
        only, so the single-hop relay stays byte-verbatim — surfaced
        as ``"hops"`` in the response envelope (the re-encode is
        byte-stable: the daemon used the same sort_keys encoder)."""
        reg = telemetry.registry()
        tried: set = set()
        last_error = "no healthy replica"
        rargs = {"rid": rid} if rid else {}
        hops = 0
        for _attempt in range(max(len(self.replicas), 1)):
            rep = self._pick(tried)
            if rep is None:
                break
            tried.add(rep)
            hops += 1
            with obs_span("fleet.hop", attempt=hops, replica=rep.name,
                          **rargs) as hop:
                try:
                    resp = rep.call(raw,
                                    timeout_s=self.request_timeout_s)
                except OSError as e:
                    # The resilience classification decides
                    # retryability: connection refused/reset/EOF/
                    # timeouts all classify transient — mark the
                    # replica down (the prober revives it) and retry
                    # on a healthy one.
                    kind = classify(e)
                    rep.mark(healthy=False, error=str(e))
                    reg.counter("fleet.replica_failures").inc(
                        label=rep.name)
                    last_error = f"replica {rep.name}: {e}"
                    hop.set(outcome=f"error_{kind}")
                    if kind not in ("transient", "oom"):
                        break
                    reg.counter("fleet.retries").inc(label="failure")
                    continue
                try:
                    doc = json.loads(resp)
                except ValueError:
                    doc = {}
                err = str(doc.get("error", ""))
                if doc.get("ok") is False and "draining" in err:
                    # Replica-local shutdown, not fleet backpressure.
                    rep.mark(draining=True)
                    reg.counter("fleet.retries").inc(label="draining")
                    last_error = f"replica {rep.name}: draining"
                    hop.set(outcome="draining")
                    continue
                if doc.get("ok") is False and err.startswith("rejected"):
                    # Admission shed: the explicit backpressure signal,
                    # propagated unretried.
                    reg.counter("fleet.rejected").inc(label="admission")
                    outcome = "rejected_admission"
                else:
                    outcome = "ok" if doc.get("ok") else "relayed"
                hop.set(outcome=outcome)
            reg.histogram("fleet.retry_hops").observe(
                hops, exemplar=rid or None)
            if hops > 1 and doc:
                doc["hops"] = hops
                resp = encode(doc)
            return resp, hops, outcome
        reg.counter("fleet.rejected").inc(label="unavailable")
        reg.histogram("fleet.retry_hops").observe(
            max(hops, 1), exemplar=rid or None)
        out = {"ok": False, "error": f"rejected: {last_error}"}
        if hops > 1:
            out["hops"] = hops
        return encode(out), hops, "unavailable"

    def _route_ingest(self, raw: bytes, rid: str = "") -> bytes:
        """Fan-out to every available replica; ALL must accept (a
        partial ingest forks the fleet corpus — the response names the
        divergent replicas instead of hiding them)."""
        reg = telemetry.registry()
        targets = [r for r in self.replica_list() if r.available()]
        if not targets:
            reg.counter("fleet.rejected").inc(label="unavailable")
            return encode({"ok": False,
                           "error": "rejected: no healthy replica"})
        oks: List[bytes] = []
        failures: List[str] = []
        rargs = {"rid": rid} if rid else {}
        for rep in targets:
            with obs_span("fleet.hop", replica=rep.name, fanout=True,
                          **rargs) as hop:
                try:
                    resp = rep.call(raw,
                                    timeout_s=self.request_timeout_s)
                    doc = json.loads(resp)
                except (OSError, ValueError) as e:
                    rep.mark(healthy=False, error=str(e))
                    failures.append(f"{rep.name}: {e}")
                    hop.set(outcome="error_transport")
                    continue
                if doc.get("ok"):
                    oks.append(resp)
                    hop.set(outcome="ok")
                else:
                    failures.append(f"{rep.name}: {doc.get('error')}")
                    hop.set(outcome="error_replica")
        if failures or not oks:
            reg.counter("fleet.ingest_divergence").inc()
            return encode({"ok": False, "error":
                           "ingest diverged: " + "; ".join(failures),
                           "accepted_replicas": len(oks)})
        return oks[0]

    # -- stats + telemetry -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        reg = telemetry.registry()
        reps = self.replica_list()
        elapsed = (time.monotonic() - self._t_ready) \
            if self._t_ready else 0.0
        out: Dict[str, Any] = {
            "fleet": True,
            "replicas": [r.snapshot() for r in reps],
            "healthy_replicas": sum(1 for r in reps
                                    if r.available()),
            "draining": self._draining_now(),
            "uptime_s": round(elapsed, 3),
            "requests": reg.counter("fleet.requests").by_label(),
            "retries": reg.counter("fleet.retries").by_label(),
            "rejected": reg.counter("fleet.rejected").by_label(),
            "consistency": {
                "divergences": int(reg.counter(
                    "fleet.consistency.divergences").total()),
                "repairs": int(reg.counter(
                    "fleet.consistency.repairs").total()),
                "repaired_rows": int(reg.counter(
                    "fleet.consistency.repaired_rows").total()),
                "unrepairable": int(reg.counter(
                    "fleet.consistency.unrepairable").total()),
            },
            "scale": {
                "up": int(reg.counter("fleet.scale.up").total()),
                "down": int(reg.counter("fleet.scale.down").total()),
                "crashes": int(reg.counter(
                    "fleet.scale.crashes").total()),
                "relaunches": int(reg.counter(
                    "fleet.scale.relaunches").total()),
                "splits": int(reg.counter(
                    "fleet.reshard.splits").total()),
            },
        }
        if self.supervisor is not None:
            try:
                out["supervisor"] = self.supervisor.snapshot()
            except Exception:  # check: no-retry — stats never fail
                pass
        if self.slo is not None:
            try:
                out["slo"] = self.slo.snapshot()
            except Exception:  # check: no-retry — stats never fail
                pass
        h = reg.get("fleet.request_latency_ms")
        if h is not None and h.count:
            out["request_latency_ms"] = {
                "p50": round(h.quantile(0.5), 3),
                "p95": round(h.quantile(0.95), 3),
                "p99": round(h.quantile(0.99), 3),
                "count": h.count,
            }
        return out

    def fleet_metrics_text(self) -> str:
        """The aggregated fleet OpenMetrics view: every replica's live
        scrape (those with a scrape port) merged by fleet.scrape, plus
        the router's own registry as one more 'replica'. A replica
        whose live scrape fails keeps its LAST-GOOD exposition in the
        merge — stamped, never silent: the router publishes per-replica
        ``fleet_replica_scrape_age_s`` (0 when live) and
        ``fleet_replica_scrape_stale`` gauges alongside the merged
        counters, so a dashboard can tell fresh fleet totals from ones
        coasting on a cached scrape."""
        from dmlp_tpu_torch.fleet import scrape as fscrape
        if self._scrape_cache is None:
            self._scrape_cache = fscrape.ScrapeCache()
        reg = telemetry.registry()
        texts: List[str] = []
        names: List[str] = []
        for rep in self.replica_list():
            if rep.scrape_port is None:
                continue
            text, age_s, stale = self._scrape_cache.fetch(
                rep.name,
                f"http://{rep.host}:{rep.scrape_port}/metrics")
            if text is None:
                continue   # never scraped: nothing to go stale
            reg.gauge("fleet.replica_scrape_age_s").set(
                round(age_s, 3), label=rep.name)
            reg.gauge("fleet.replica_scrape_stale").set(
                int(stale), label=rep.name)
            texts.append(text)
            names.append(rep.name)
        # The router's own registry is SNAPSHOTTED after the loop so
        # the freshness gauges just written land in this very
        # exposition (merge order is cosmetic).
        texts.insert(0, reg.to_openmetrics())
        names.insert(0, "router")
        merged, _problems = fscrape.merge_expositions(texts, names)
        return merged

    def _start_telemetry_http(self, port: int) -> None:
        import http.server

        router = self

        class _MetricsHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = router.fleet_metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/openmetrics-text")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-scrape stderr
                pass

        class _Httpd(http.server.ThreadingHTTPServer):
            daemon_threads = True

        self._telemetry_httpd = _Httpd(("127.0.0.1", port),
                                       _MetricsHandler)
        self.telemetry_port = self._telemetry_httpd.server_address[1]
        threading.Thread(target=self._telemetry_httpd.serve_forever,
                         name="fleet-metrics", daemon=True).start()
        telemetry.registry().gauge("fleet.telemetry_http_port").set(
            self.telemetry_port)
