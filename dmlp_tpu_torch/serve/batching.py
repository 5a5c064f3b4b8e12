"""Continuous micro-batching: coalesce whatever is queued each tick.

Port of ``dmlp_tpu/serve/batching.py``. Requests arrive one at a time with
few queries each; the kernels want full tiles. The :class:`MicroBatcher`
drains the admission queue each tick into one micro-batch: variable
(nq, k) requests concatenate, the combined shape buckets to the engine's
power-of-two buckets, and per-request results slice back out with the
bytes of the request's solo solve.

One consumer thread: the engine, its ingest path, its warm-up
(:meth:`MicroBatcher.call`) and every device launch and readback run on
the batcher thread alone, so the resident buffer never races a solve and
a mesh engine's collectives come from one thread in one order. While the
queue is empty the thread calls the engine's ``idle`` hook, if it has one
(the mesh engine's heartbeat), and on stop its ``close`` hook, if it has
one, after the last queued batch. Requests complete through a per-request
event; connection handlers block on it and write the response.

While a trace sink is active (``obs.trace.sinks_active``) every request's
phases are rid-tagged spans, the reference's: ``serve.phase.admission``
(the handler thread's admission decision, concurrent with the queue wait),
then ``serve.phase.queue`` -> ``coalesce`` -> ``solve`` -> ``finalize``
(the daemon adds ``write``), and ``serve.micro_batch`` around each batch
solve. With no sink none of the clock reads happen.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from dmlp_tpu_torch.obs import telemetry
from dmlp_tpu_torch.obs import trace as obs_trace
from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.resilience import inject as rs_inject
from dmlp_tpu_torch.serve.admission import ACCEPT, AdmissionController

#: default batcher tick: how long a lone request waits for company
TICK_S = 0.002


@dataclasses.dataclass
class Request:
    """One admitted unit of work. ``kind`` is "query" | "ingest" |
    "corpus" | "call"; the non-query kinds execute alone between
    micro-batches (the one batcher thread orders them against solves, so a
    ``corpus`` read never sees a torn ingest)."""

    kind: str
    req_id: str = ""
    rid: str = ""                                 # request id, echoed back
    #                                               and tagging the spans
    query_attrs: Optional[np.ndarray] = None      # (nq, na) float64
    ks: Optional[np.ndarray] = None               # (nq,) int32
    labels: Optional[np.ndarray] = None           # ingest: (m,) int32
    attrs: Optional[np.ndarray] = None            # ingest: (m, na) f64
    start: Optional[int] = None                   # ingest row-write /
    #                                               corpus read offset
    count: Optional[int] = None                   # corpus read length
    debug: bool = False                           # echo neighbors/dists
    t_enqueue: float = dataclasses.field(default_factory=time.monotonic)
    # The same instant in the tracer's clock domain: request phases are
    # cross-thread intervals recorded through trace.complete_at.
    t_enqueue_pc: float = dataclasses.field(
        default_factory=time.perf_counter)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    results: Optional[List] = None                # QueryResults (local ids)
    error: Optional[str] = None
    latency_ms: Optional[float] = None
    corpus_rows: Optional[int] = None             # ingest outcome
    payload: Optional[Dict[str, Any]] = None      # corpus outcome
    fn: Optional[Callable[[], Any]] = None        # call: the work
    value: Any = None                             # call: its result
    exc: Optional[BaseException] = None           # call: its exception

    @property
    def nq(self) -> int:
        return 0 if self.ks is None else len(self.ks)

    def complete(self, results=None, error=None, corpus_rows=None) -> None:
        self.results = results
        self.error = error
        self.corpus_rows = corpus_rows
        self.latency_ms = (time.monotonic() - self.t_enqueue) * 1e3
        self.done.set()


class MicroBatcher:
    """The admission queue and the one batch-execution thread."""

    def __init__(self, engine, admission: AdmissionController,
                 max_batch_queries: int = 1024, tick_s: float = TICK_S):
        self.engine = engine
        self.admission = admission
        self.max_batch_queries = max_batch_queries
        self.tick_s = tick_s
        self._queue: deque = deque()
        self._queued_queries = 0
        self._queued_kmax = 0     # max k among queued query requests
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.batches = 0
        # perf_counter at which the consumer woke for the current collect
        # cycle: the queue / coalesce boundary of the phase spans. Read
        # and written on the batcher thread only.
        self._wake_pc = 0.0

    # -- producer side ---------------------------------------------------------

    def submit(self, req: Request) -> Dict[str, Any]:
        """Admission decision and enqueue; returns the decision dict. A
        rejected request completes at once with the reason.

        Two phases: the request-local half (shape caps and the
        ``serve.admit`` injection hook, which may sleep for a delay fault)
        runs before the queue lock; only the queue-state half, pure reads
        and arithmetic, runs under it, so decision and enqueue are atomic
        without a blocking call under the lock."""
        if req.kind == "query":
            kmax = int(req.ks.max()) if req.nq else 0
            a0 = time.perf_counter() if obs_trace.sinks_active() else 0.0
            pre = self.admission.precheck(req.nq, kmax)
            with self._cond:
                decision = self.admission.decide_queued(
                    req.nq, kmax, self._queued_queries,
                    queued_kmax=self._queued_kmax, prechecked=pre)
                if decision["verdict"] == ACCEPT:
                    self._queue.append(req)
                    self._queued_queries += req.nq
                    self._queued_kmax = max(self._queued_kmax, kmax)
                    telemetry.registry().gauge("serve.queue_depth").set(
                        self._queued_queries)
                    self._cond.notify()
            if a0:
                # On the handler thread, concurrent with the queue wait:
                # reported, and left out of a request's phase sum.
                self._phase("serve.phase.admission", a0,
                            time.perf_counter(), req.rid,
                            verdict=decision["verdict"])
            if decision["verdict"] != ACCEPT:
                req.complete(error=f"rejected: {decision['reason']}")
            return decision
        # Ingests and corpus reads ride the same queue (ordered against
        # solves) but skip the per-query gates; capacity errors surface
        # at execution.
        with self._cond:
            if self.admission.draining:
                req.complete(error="rejected: draining")
                return {"verdict": "reject", "reason": "draining"}
            self._queue.append(req)
            self._cond.notify()
        return {"verdict": ACCEPT, "reason": "ok"}

    # -- consumer side ---------------------------------------------------------

    def start(self) -> None:
        # One critical section for check-then-spawn: two start() calls
        # must not both spawn a consumer (the engine relies on exactly
        # one).
        with self._cond:
            if self._thread is not None:
                return
            self._stop = False
            t = self._thread = threading.Thread(
                target=self._run_loop, name="serve-batcher", daemon=True)
            t.start()

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` on the batcher thread, ordered against the queued
        work, and return its result (or raise its exception). Not subject
        to admission: the daemon's own work (the warm-up)."""
        req = Request(kind="call", fn=fn)
        with self._cond:
            self._queue.append(req)
            self._cond.notify()
        req.done.wait()
        if req.exc is not None:
            raise req.exc
        return req.value

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the batcher thread. ``drain=True`` finishes everything
        already queued first (the SIGTERM path); ``drain=False`` fails
        queued requests with a shutdown error. The engine's ``close`` hook
        runs on the batcher thread after the last queued work."""
        with self._cond:
            self._stop = True
            if not drain:
                while self._queue:
                    self._queue.popleft().complete(error="shutdown")
                self._queued_queries = 0
                self._queued_kmax = 0
            self._cond.notify_all()
            t = self._thread
            self._thread = None
        # The join must not hold the lock: the consumer needs it to
        # finish draining.
        if t is not None:
            t.join(timeout=timeout)

    def _collect(self) -> List[Request]:
        """Wait (at most 0.1 s) for work, then drain the queue up to the
        batch cap. A lone request waits one tick for company."""
        with self._cond:
            # One bounded wait: an empty return lets the loop run the
            # engine's idle hook.
            if not self._queue and not self._stop:
                self._cond.wait(timeout=0.1)
            if not self._queue:
                return []
            self._wake_pc = time.perf_counter()
            if not self._stop and self.tick_s > 0 \
                    and self._queued_queries < self.max_batch_queries:
                self._cond.wait(timeout=self.tick_s)
            batch: List[Request] = []
            total = 0
            while self._queue:
                head = self._queue[0]
                if head.kind != "query":
                    if batch:
                        break          # solve what we have first
                    self._queue.popleft()
                    return [head]      # ingest/corpus execute alone
                if batch and total + head.nq > self.max_batch_queries:
                    break
                self._queue.popleft()
                batch.append(head)
                total += head.nq
            self._queued_queries -= total
            if self._queued_queries == 0:
                self._queued_kmax = 0   # reset only when nothing is queued
            telemetry.registry().gauge("serve.queue_depth").set(
                self._queued_queries)
            return batch

    def _run_loop(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                with self._cond:
                    done = self._stop and not self._queue
                if done:
                    close = getattr(self.engine, "close", None)
                    if close is not None:
                        self._run_hook(close, "close")
                    return
                idle = getattr(self.engine, "idle", None)
                if idle is not None:
                    self._run_hook(idle, "idle")
                continue
            if batch[0].kind == "call":
                req = batch[0]
                try:
                    req.value = req.fn()
                except BaseException as e:  # check: no-retry — raised on the caller's thread
                    req.exc = e
                req.complete()
            elif batch[0].kind == "ingest":
                self._execute_ingest(batch[0])
            elif batch[0].kind == "corpus":
                self._execute_corpus(batch[0])
            else:
                self._execute_batch(batch)

    @staticmethod
    def _run_hook(fn: Callable[[], Any], label: str) -> None:
        """An engine hook on the batcher thread; a failure is counted (the
        engine records what it means: a mesh engine marks itself broken,
        and the daemon exits)."""
        try:
            fn()
        except Exception:  # check: no-retry — counted; the daemon reads the engine's state
            telemetry.registry().counter("serve.hook_errors").inc(
                label=label)

    def _phase(self, name: str, t0: float, t1: float, rid: str,
               **args) -> None:
        """One request-phase span through the complete_at seam (tracer
        and telemetry observer), rid-tagged when the request carried one.
        Callers gate on sinks_active()."""
        if rid:
            args["rid"] = rid
        obs_trace.complete_at(name, t0, max(t0, t1), **args)

    def _execute_ingest(self, req: Request) -> None:
        e0 = 0.0
        if obs_trace.sinks_active():
            e0 = time.perf_counter()
            # check: allow-concurrency=R702 — _wake_pc is written in
            # _collect and read here, both only on the batcher thread
            # (_run is the sole caller of either); the write holds
            # _cond only because _collect already does.
            self._phase("serve.phase.queue", req.t_enqueue_pc,
                        max(req.t_enqueue_pc, self._wake_pc), req.rid,
                        kind="ingest")
        try:
            # A transient fault here fails this ingest before any state
            # is touched.
            rs_inject.fire("serve.ingest", rows=int(len(req.labels)),
                           start=-1 if req.start is None
                           else int(req.start))
            rows = self.engine.ingest(req.labels, req.attrs,
                                      start=req.start)
            req.complete(corpus_rows=rows)
        except Exception as e:  # check: no-retry — surfaced to the client
            req.complete(error=f"{type(e).__name__}: {e}")
        if e0:
            self._phase("serve.phase.ingest", e0, time.perf_counter(),
                        req.rid, ok=req.error is None)

    def _execute_corpus(self, req: Request) -> None:
        """One ``corpus`` read on the batcher thread: the rows and the
        signature are one snapshot (no ingest can interleave)."""
        e0 = 0.0
        if obs_trace.sinks_active():
            e0 = time.perf_counter()
            # check: allow-concurrency=R702 — batcher-thread-only read
            # (see _execute_ingest).
            self._phase("serve.phase.queue", req.t_enqueue_pc,
                        max(req.t_enqueue_pc, self._wake_pc), req.rid,
                        kind="corpus")
        try:
            state = self.engine.corpus_state()
            labels, attrs = self.engine.corpus_slice(req.start or 0,
                                                     req.count or 0)
            req.payload = {
                "start": max(0, min(int(req.start or 0), state["rows"])),
                "labels": [int(v) for v in labels],
                "rows": [[float(x) for x in row] for row in attrs],
                "corpus_rows": state["rows"],
                "checksum": state["checksum"],
                "epoch": state["epoch"],
            }
            req.complete()
        except Exception as e:  # check: no-retry — surfaced to the client
            req.complete(error=f"{type(e).__name__}: {e}")
        if e0:
            self._phase("serve.phase.corpus", e0, time.perf_counter(),
                        req.rid, ok=req.error is None)

    def _execute_batch(self, batch: List[Request]) -> None:
        reg = telemetry.registry()
        total = sum(r.nq for r in batch)
        q = np.concatenate([r.query_attrs for r in batch])
        ks = np.concatenate([r.ks for r in batch])
        qpad, _ = self.engine.bucket_shape(
            total, int(ks.max()) if total else 1)
        tracing = obs_trace.sinks_active()
        rids = ",".join(r.rid for r in batch if r.rid) if tracing else ""
        t0 = time.perf_counter()
        try:
            # A delay fault here slows this batch; a transient one fails
            # the whole batch visibly (serve.batch_errors).
            rs_inject.fire("serve.solve", requests=len(batch),
                           queries=total)
            with obs_span("serve.micro_batch", requests=len(batch),
                          queries=total, qpad=qpad,
                          **({"rids": rids} if rids else {})):
                if rids:
                    # One batcher thread: the engine reads this inside
                    # solve_batch to rid-tag its own spans.
                    self.engine.trace_rids = rids
                try:
                    results = self.engine.solve_batch(q, ks)
                finally:
                    if rids:
                        self.engine.trace_rids = None
        except Exception as e:  # check: no-retry — the batch fails visibly, the daemon lives
            reg.counter("serve.batch_errors").inc()
            msg = f"{type(e).__name__}: {e}"
            for r in batch:
                r.complete(error=msg)
            return
        t1 = time.perf_counter()
        ms = (t1 - t0) * 1e3
        with self._cond:
            # Handler threads read `batches` through daemon.stats().
            self.batches += 1
        reg.counter("serve.batches").inc()
        reg.histogram("serve.batch_latency_ms", unit="ms").observe(ms)
        reg.histogram("serve.batch_queries").observe(total)
        reg.gauge("serve.batch_fill").set(round(total / max(qpad, 1), 6))
        off = 0
        for r in batch:
            sub = results[off:off + r.nq]
            # Query ids relative to the request: the bytes of its solo
            # solve over the same corpus.
            local = [dataclasses.replace(qr, query_id=qr.query_id - off)
                     for qr in sub]
            off += r.nq
            r.complete(results=local)
            reg.counter("serve.requests_completed").inc()
            reg.counter("serve.queries_completed").inc(r.nq)
            reg.histogram("serve.request_latency_ms", unit="ms").observe(
                (time.monotonic() - r.t_enqueue) * 1e3,
                exemplar=r.rid or None)
            if tracing:
                # Per-request phases: queue ends when the consumer woke
                # (a request that arrived during the coalesce tick waited
                # none), coalesce runs to the solve's start, and the whole
                # batch solve is attributed to every coalesced request
                # (one rid's phases tile its wall time; they do not sum
                # across rids).
                # check: allow-concurrency=R702 — batcher-thread-only
                # read (see _execute_ingest).
                q1 = min(max(self._wake_pc, r.t_enqueue_pc), t0)
                self._phase("serve.phase.queue", r.t_enqueue_pc, q1,
                            r.rid)
                self._phase("serve.phase.coalesce", q1, t0, r.rid,
                            requests=len(batch))
                self._phase("serve.phase.solve", t0, t1, r.rid,
                            queries=total, qpad=qpad)
                self._phase("serve.phase.finalize", t1,
                            time.perf_counter(), r.rid)
