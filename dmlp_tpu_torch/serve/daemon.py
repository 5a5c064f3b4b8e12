"""The serving daemon: parse once, stage once, build each bucket once,
serve.

Port of ``dmlp_tpu/serve/daemon.py``. ``python -m dmlp_tpu_torch.serve
--corpus FILE`` builds a :class:`~dmlp_tpu_torch.serve.engine.
ResidentEngine` over the corpus file's data section, warms the shape
buckets derived from its query section (plus ``--warm-buckets``), and
serves the line-JSON protocol (:mod:`dmlp_tpu_torch.serve.protocol`) on a
localhost TCP port. Request latencies land in the registry's histograms
(``obs.telemetry``) and ``stats`` reports them.

Observability, each opt-in: ``telemetry_path`` / ``telemetry_port`` start
the telemetry session (OpenMetrics snapshot and scrape endpoint, the
device-memory sampler, the flight recorder) and install a cost probe, so
every micro-batch's kernel launches are recorded, timed on the card and
logged beside its launch counts (``batch_log``); ``trace_path`` installs a
tracer for the rid-tagged request-phase spans, written at drain;
``objectives`` are SLO specs (``obs.slo``) evaluated while the daemon
runs, reported by ``stats`` and the ``slo_*`` metrics; ``record_path``
appends the serving state as a RunRecord at drain.

Shutdown: SIGTERM, or an in-band ``drain`` op, stops admission
("draining" rejections), lets the batcher finish every queued micro-batch,
waits for the handlers to write their responses, and exits 0.

Not here yet, with its ROADMAP item: the mesh-resident replica
(``mesh_shape``, A12); periodic records (``--snapshot-every-s``, A15).
"""

from __future__ import annotations

import json
import os
import signal
import socketserver
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.io.grammar import KNNInput
from dmlp_tpu_torch.obs import counters as obs_counters
from dmlp_tpu_torch.obs import telemetry
from dmlp_tpu_torch.obs import trace as obs_trace
from dmlp_tpu_torch.serve import protocol
from dmlp_tpu_torch.serve.admission import AdmissionController
from dmlp_tpu_torch.serve.batching import MicroBatcher, Request
from dmlp_tpu_torch.serve.engine import ResidentEngine


def default_warm_buckets(corpus: KNNInput) -> List[Tuple[int, int]]:
    """Warm-up shapes: every (count, k) of the corpus file's own query
    section (the operator's declaration of expected traffic), plus the
    smallest bucket."""
    out = [(1, 1)]
    nq = corpus.params.num_queries
    if nq:
        out.append((nq, int(corpus.ks.max())))
        out.append((1, int(corpus.ks.min())))
    return out


class _Handler(socketserver.StreamRequestHandler):
    """One connection: requests answered strictly in line order."""

    def handle(self):  # noqa: D102 (socketserver API)
        daemon: ServeDaemon = self.server.daemon
        while True:
            # Bounded read: an oversized line never buffers past the cap;
            # it has lost its framing, so reject and drop the connection.
            raw = self.rfile.readline(protocol.MAX_LINE_BYTES + 1)
            if not raw:
                break
            if len(raw) > protocol.MAX_LINE_BYTES:
                self.wfile.write(protocol.encode(
                    {"ok": False,
                     "error": "request line exceeds the size cap"}))
                break
            try:
                line = raw.decode("utf-8", errors="strict").strip()
            except UnicodeDecodeError:
                self.wfile.write(protocol.encode(
                    {"ok": False, "error": "request is not UTF-8"}))
                continue
            if not line:
                continue
            # In-flight accounting brackets the response write: drain()
            # waits for it, so a drained request's response reaches the
            # client before the process exits.
            daemon._track_inflight(+1)
            try:
                try:
                    resp = daemon.handle_line(line)
                except protocol.ProtocolError as e:
                    resp = {"ok": False, "error": str(e)}
                except Exception as e:  # the connection survives a bad
                    # request; solve failures come back per request
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                w0 = (time.perf_counter()
                      if obs_trace.sinks_active() else 0.0)
                self.wfile.write(protocol.encode(resp))
                self.wfile.flush()
                if w0:
                    rid = resp.get("rid", "")
                    obs_trace.complete_at(
                        "serve.phase.write", w0, time.perf_counter(),
                        **({"rid": rid} if rid else {}))
            finally:
                daemon._track_inflight(-1)
            if resp.get("draining"):
                break


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class ServeDaemon:
    """Lifecycle owner: engine, admission, batcher, TCP server and the
    drain."""

    def __init__(self, corpus: KNNInput, config: EngineConfig = None,
                 port: int = 0, capacity: Optional[int] = None,
                 gate_carry: bool = True,
                 budget_bytes: Optional[int] = None,
                 max_batch_queries: int = 1024,
                 max_queue_queries: int = 4096,
                 max_k: Optional[int] = None,
                 tick_s: float = 0.002,
                 warm_buckets: Optional[List[Tuple[int, int]]] = None,
                 telemetry_path: Optional[str] = None,
                 telemetry_port: Optional[int] = None,
                 record_path: Optional[str] = None,
                 trace_path: Optional[str] = None,
                 objectives: Optional[List[Any]] = None):
        self.corpus = corpus
        self.record_path = record_path
        config = config or EngineConfig()
        # Request tracing: a process-wide tracer and the clock-sync marker
        # a merge of several processes' traces aligns on; written at
        # drain or close.
        self.trace_path = trace_path
        self._tracer = None
        if trace_path:
            self._tracer = obs_trace.install(obs_trace.Tracer())
            self._tracer.sync_instant("fleet.clock_sync")
        self.session = None
        self._probe = None
        if telemetry_path or telemetry_port is not None:
            # The session owns the SIGTERM handler; the daemon registers
            # its drain hook below, so an orderly SIGTERM drains instead
            # of dumping a flight artifact.
            self.session = telemetry.start(path=telemetry_path,
                                           port=telemetry_port,
                                           device=config.device)
            self._probe = obs_counters.install()
        # The registry is process-wide, but stats() divides by this
        # daemon's uptime: a second daemon in one process must not
        # inherit the first one's serve.* counts.
        telemetry.registry().reset(prefix="serve")
        self.engine = ResidentEngine(corpus, config, capacity=capacity,
                                     gate_carry=gate_carry)
        self.admission = AdmissionController(
            self.engine, budget_bytes=budget_bytes,
            max_queue_queries=max_queue_queries,
            max_request_queries=max_batch_queries, max_k=max_k,
            batch_queries_cap=max_batch_queries)
        self.batcher = MicroBatcher(self.engine, self.admission,
                                    max_batch_queries=max_batch_queries,
                                    tick_s=tick_s)
        # SLO objectives (spec strings or obs.slo.Objective): bound after
        # the serve.* reset above, so the windowed histograms are the
        # ones this daemon observes into; ticked by run_until_drained().
        self.slo = None
        if objectives:
            from dmlp_tpu_torch.obs import slo as obs_slo
            self.slo = obs_slo.SLOEvaluator(
                [obs_slo.parse_objective(o) if isinstance(o, str) else o
                 for o in objectives], telemetry.registry())
        self._warm = (warm_buckets if warm_buckets is not None
                      else default_warm_buckets(corpus))
        self._drain_event = threading.Event()
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        self._server = _Server(("127.0.0.1", port), _Handler)
        self._server.daemon = self
        self.port = self._server.server_address[1]
        self._server_thread: Optional[threading.Thread] = None
        self._t_ready: Optional[float] = None
        self.warmup_ms: Dict[str, float] = {}
        self._sigterm_prev = None
        self._sigterm_handler = None
        if self.session is not None:
            self.session.set_sigterm_drain(self._drain_event.set)
            return
        # The handler holds the drain event weakly: a strong closure in
        # the signal module would pin this daemon's engine (its resident
        # device buffer included) for the life of the process.
        ev_ref = weakref.ref(self._drain_event)

        def _on_sigterm(signum, frame, _ev_ref=ev_ref):
            ev = _ev_ref()
            if ev is not None:
                ev.set()
        try:
            self._sigterm_prev = signal.signal(signal.SIGTERM, _on_sigterm)
            self._sigterm_handler = _on_sigterm
        except ValueError:
            pass    # not the main thread: the drain op only

    # -- startup ---------------------------------------------------------------

    def start(self) -> None:
        """Warm the buckets, then open for traffic."""
        self.warmup_ms = self.engine.warmup(self._warm)
        self.batcher.start()
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, name="serve-accept",
            daemon=True)
        self._server_thread.start()
        self._t_ready = time.monotonic()
        telemetry.registry().gauge("serve.ready").set(1)

    def write_ready_file(self, path: str) -> None:
        stats = self.engine.bucket_stats()
        doc = {
            "port": self.port, "pid": os.getpid(),
            "cold_start_compile_ms": self.engine.cold_start_compile_ms,
            "compile_count": self.engine.compile_count,
            "kernel_loads": stats["kernel_loads"],
            "buckets": stats["buckets"],
            "paths": stats["paths"],
            "telemetry_port": self.session.http_port
            if self.session is not None else None,
            "hlo_schedule": stats["hlo_schedule"],
            "warmup_ms": self.warmup_ms,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    # -- request plumbing ------------------------------------------------------

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
                    return      # give up rather than wedge the drain
                self._inflight_cond.wait(timeout=left)

    def handle_line(self, line: str) -> Dict[str, Any]:
        obj = protocol.parse_request(line, self.corpus.params.num_attrs)
        if isinstance(obj, dict):                 # control ops
            if obj.get("op") == "stats":
                return {"ok": True, "stats": self.stats()}
            self._drain_event.set()               # "drain"
            return {"ok": True, "draining": True}
        req: Request = obj
        self.batcher.submit(req)
        req.done.wait()
        if req.kind == "ingest":
            return protocol.ingest_response(req)
        if req.kind == "corpus":
            return protocol.corpus_response(req)
        return protocol.query_response(req)

    def stats(self) -> Dict[str, Any]:
        """Engine, corpus, admission and request counters (host state
        only: a handler thread calls this while the batcher solves)."""
        reg = telemetry.registry()
        eng = self.engine
        elapsed = (time.monotonic() - self._t_ready) \
            if self._t_ready else 0.0
        done = reg.counter("serve.requests_completed").total()
        out = {
            "protocol": protocol.PROTOCOL_VERSION,
            "engine": eng.bucket_stats(),
            "corpus": eng.corpus_state(),
            "admission": self.admission.snapshot(),
            "requests_completed": done,
            "queries_completed":
                reg.counter("serve.queries_completed").total(),
            "batches": self.batcher.batches,
            "uptime_s": round(elapsed, 3),
            "requests_per_sec": round(done / elapsed, 3) if elapsed
            else None,
        }
        if eng.device.type == "cuda":
            # The caching allocator's counters: host reads, no CUDA call.
            import torch
            out["device_memory"] = {
                "allocated_bytes": int(torch.cuda.memory_allocated(
                    eng.device)),
                "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(
                    eng.device)),
                "model_bytes": eng.resident_model_bytes()}
        h = reg.get("serve.request_latency_ms")
        if h is not None and h.count:
            out["request_latency_ms"] = {
                "p50": round(h.quantile(0.5), 3),
                "p95": round(h.quantile(0.95), 3),
                "p99": round(h.quantile(0.99), 3),
                "count": h.count,
            }
        if self.slo is not None:
            try:
                out["slo"] = self.slo.snapshot()
            except Exception:  # stats never fail on the SLO block
                telemetry.registry().counter("obs.errors").inc(label="slo")
        return out

    # -- run records -----------------------------------------------------------

    def snapshot_record(self):
        """The serving state as a RunRecord (kind "serve"): cold start,
        buckets, request rates and latency quantiles, the gate's share."""
        from dmlp_tpu_torch.obs.run import RunRecord, current_device
        reg = telemetry.registry()
        eng = self.engine
        elapsed = (time.monotonic() - self._t_ready) \
            if self._t_ready else 0.0
        done = reg.counter("serve.requests_completed").total()
        stats = eng.bucket_stats()
        metrics: Dict[str, Any] = {
            "cold_start_compile_ms": eng.cold_start_compile_ms,
            "compile_count": eng.compile_count,
            "warm_buckets": len(stats["buckets"]),
            "admitted_total": reg.counter("serve.admitted").total(),
            "rejected_total": reg.counter("serve.rejected").total(),
            "batches_total": reg.counter("serve.batches").total(),
        }
        if elapsed and done:
            metrics["requests_per_sec"] = round(done / elapsed, 3)
            metrics["queries_per_sec"] = round(
                reg.counter("serve.queries_completed").total() / elapsed,
                3)
        h = reg.get("serve.request_latency_ms")
        if h is not None and h.count:
            metrics["request_latency_p50_ms"] = round(h.quantile(0.5), 3)
            metrics["request_latency_p95_ms"] = round(h.quantile(0.95), 3)
            metrics["request_latency_p99_ms"] = round(h.quantile(0.99), 3)
            metrics["request_count"] = h.count
        if eng.last_gated_fraction is not None:
            metrics["gate_gated_fraction"] = round(
                eng.last_gated_fraction, 6)
        return RunRecord(
            kind="serve", tool="dmlp_tpu_torch.serve",
            config={"corpus_rows": eng.n_real,
                    "capacity_rows": eng.capacity_rows,
                    "num_attrs": eng.num_attrs,
                    "gate_carry": eng.gate_carry, "mode": "resident",
                    "buckets": stats["buckets"]},
            metrics=metrics, device=current_device(eng.device))

    def _append_record(self) -> None:
        if self.record_path:
            try:
                self.snapshot_record().append_jsonl(self.record_path)
            except Exception:  # a record never kills the drain: counted
                telemetry.registry().counter("obs.errors").inc(
                    label="record")

    # -- run / drain -----------------------------------------------------------

    def run_until_drained(self) -> None:
        """Block until a drain is requested (SIGTERM or the in-band op),
        then drain and shut down."""
        while not self._drain_event.wait(timeout=0.2):
            if self.slo is not None:
                try:
                    self.slo.tick()
                except Exception:  # evaluation never takes the serve
                    # loop down: counted, and the next tick re-reads all
                    telemetry.registry().counter("obs.errors").inc(
                        label="slo")
        self.drain()

    def _restore_sigterm(self) -> None:
        """Undo the SIGTERM hook, only while it is still ours."""
        if self._sigterm_handler is None:
            return
        try:
            if signal.getsignal(signal.SIGTERM) is self._sigterm_handler:
                signal.signal(signal.SIGTERM,
                              self._sigterm_prev or signal.SIG_DFL)
        except ValueError:
            pass
        self._sigterm_handler = None
        self._sigterm_prev = None

    def drain(self) -> None:
        """The orderly shutdown: shed new work, finish queued work, wait
        for the responses to be written, close."""
        self.admission.draining = True
        telemetry.registry().gauge("serve.ready").set(0)
        self._server.shutdown()
        self.batcher.stop(drain=True)
        self._wait_inflight_drained()
        self._append_record()
        self._close_obs()
        self._restore_sigterm()
        self._server.server_close()

    def _close_obs(self) -> None:
        """Write the trace and close the telemetry session (its final
        snapshot) and the cost probe, each only while it is this
        daemon's."""
        if self._tracer is not None:
            try:
                self._tracer.write(self.trace_path,
                                   process_name=f"serve:{self.port}")
            except Exception:  # a trace never kills the drain: counted
                telemetry.registry().counter("obs.errors").inc(
                    label="trace")
            if obs_trace.active() is self._tracer:
                obs_trace.uninstall()
            self._tracer = None
        if self._probe is not None:
            if obs_counters.active() is self._probe:
                obs_counters.uninstall()
            self._probe = None
        if self.session is not None:
            self.session.set_sigterm_drain(None)
            self.session.close()     # writes the final snapshot
            self.session = None

    def close(self) -> None:
        """Abrupt teardown (no drain semantics)."""
        self._drain_event.set()
        self.admission.draining = True
        self._server.shutdown()
        self.batcher.stop(drain=False)
        self._close_obs()
        self._restore_sigterm()
        self._server.server_close()
