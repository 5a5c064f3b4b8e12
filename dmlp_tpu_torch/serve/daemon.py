"""The serving daemon: parse once, stage once, build each bucket once,
serve.

Port of ``dmlp_tpu/serve/daemon.py``. ``python -m dmlp_tpu_torch.serve
--corpus FILE`` builds a :class:`~dmlp_tpu_torch.serve.engine.
ResidentEngine` over the corpus file's data section, warms the shape
buckets derived from its query section (plus ``--warm-buckets``), and
serves the line-JSON protocol (:mod:`dmlp_tpu_torch.serve.protocol`) on a
localhost TCP port. Request latencies land in the registry's histograms
(``obs.telemetry``) and ``stats`` reports them.

Shutdown: SIGTERM, or an in-band ``drain`` op, stops admission
("draining" rejections), lets the batcher finish every queued micro-batch,
waits for the handlers to write their responses, and exits 0.

Not here yet, each with its ROADMAP item: the mesh-resident replica
(``mesh_shape``, A12); the telemetry session, SLO objectives and the trace
sink (A13); ``snapshot_record`` and ``--record`` (A15).
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
from dmlp_tpu_torch.obs import telemetry
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
                self.wfile.write(protocol.encode(resp))
                self.wfile.flush()
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
                 warm_buckets: Optional[List[Tuple[int, int]]] = None):
        self.corpus = corpus
        # The registry is process-wide, but stats() divides by this
        # daemon's uptime: a second daemon in one process must not
        # inherit the first one's serve.* counts.
        telemetry.registry().reset(prefix="serve")
        self.engine = ResidentEngine(corpus, config or EngineConfig(),
                                     capacity=capacity,
                                     gate_carry=gate_carry)
        self.admission = AdmissionController(
            self.engine, budget_bytes=budget_bytes,
            max_queue_queries=max_queue_queries,
            max_request_queries=max_batch_queries, max_k=max_k,
            batch_queries_cap=max_batch_queries)
        self.batcher = MicroBatcher(self.engine, self.admission,
                                    max_batch_queries=max_batch_queries,
                                    tick_s=tick_s)
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
        return out

    # -- run / drain -----------------------------------------------------------

    def run_until_drained(self) -> None:
        """Block until a drain is requested (SIGTERM or the in-band op),
        then drain and shut down."""
        while not self._drain_event.wait(timeout=0.2):
            pass
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
        self._restore_sigterm()
        self._server.server_close()

    def close(self) -> None:
        """Abrupt teardown (no drain semantics)."""
        self._drain_event.set()
        self.admission.draining = True
        self._server.shutdown()
        self.batcher.stop(drain=False)
        self._restore_sigterm()
        self._server.server_close()
