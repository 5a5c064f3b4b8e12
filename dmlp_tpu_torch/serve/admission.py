"""Admission control: shed load before the allocator runs out of memory.

Port of ``dmlp_tpu/serve/admission.py``, unchanged but for the memory
basis. The analytic model (``obs.memwatch.serve_engine_model``) knows what
a micro-batch of a given shape bucket makes resident, and the caching
allocator knows the live bytes, so the decision compares
``max(live, modeled resident set) + batch bytes`` against the budget and
rejects when the headroom is gone, before any allocation. The budget is
the card's total memory (``torch.cuda.mem_get_info``); on the CPU there is
none and memory shedding is off, as in the reference. A rejection is a
counter (``serve.rejected``) and a clean protocol error; the degradation
ladder stays the backstop.

An ``oom`` fault at the ``serve.admit`` injection site makes the
controller behave as if the budget were gone: the daemon sheds that
request and the ladder is untouched.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from dmlp_tpu_torch.obs import memwatch, telemetry
from dmlp_tpu_torch.resilience import inject as rs_inject
from dmlp_tpu_torch.resilience.retry import classify

#: decision verdicts
ACCEPT = "accept"
REJECT = "reject"


class AdmissionController:
    """Per-request accept/reject decisions for the serving daemon.

    ``budget_bytes``: the device-memory budget admission defends.
    ``None`` = auto: the engine's card's total memory, else (on the
    CPU) memory-based shedding is off, an explicit marker in
    :meth:`snapshot`, never a guess.
    """

    def __init__(self, engine, budget_bytes: Optional[int] = None,
                 max_queue_queries: int = 4096,
                 max_request_queries: int = 1024,
                 max_k: Optional[int] = None,
                 batch_queries_cap: Optional[int] = None):
        self.engine = engine
        self.budget_bytes = (budget_bytes if budget_bytes is not None
                             else self._auto_budget())
        self.max_queue_queries = max_queue_queries
        self.max_request_queries = max_request_queries
        #: the batcher's per-micro-batch query cap — memory pricing is
        #: against the COALESCED batch this request may join, not the
        #: lone request (64 small admits must not OOM as one batch)
        self.batch_queries_cap = batch_queries_cap or max_request_queries
        self.max_k = min(max_k or engine.max_k, engine.max_k)
        self.draining = False
        # Guards the memoized resident-model total: decide_queued()
        # (under the batcher's queue lock) and snapshot() (handler
        # threads, no batcher lock) both read it — without the guard
        # two threads could interleave the (chunks_staged, total)
        # check-then-write. Leaf lock: nothing is acquired under it.
        self._lock = threading.Lock()
        self._model_cache = None

    def _auto_budget(self) -> Optional[int]:
        """The engine's device's total memory (``torch.cuda.mem_get_info``),
        read once here on the constructing thread; None on the CPU, which
        turns memory shedding off."""
        stats = memwatch.device_memory_stats(self.engine.device)
        if not stats:
            return None
        limit = stats.get("bytes_limit")
        return int(limit) if limit else None

    # -- the memory model ------------------------------------------------------

    def batch_bytes(self, nq: int, kmax: int) -> int:
        """Marginal resident bytes a micro-batch of this shape bucket
        adds on top of the resident corpus — every resident engine
        prices its own per-bucket terms at its own ``bucket_plan``
        (ResidentServingCore.batch_model_bytes: the one kcap
        derivation, so pricing cannot drift from what the solve
        allocates; term names differ between the single-chip and mesh
        models, which is why the engine owns the sum)."""
        return int(self.engine.batch_model_bytes(nq, kmax))

    def _resident_model_bytes(self) -> int:
        """The corpus-only model total, cached — it only moves when
        the engine's resident_state_key changes (lazy stagings: extract
        chunks, the wide-k multipass concat, the mesh monolithic
        layout), so rebuilding the model per request is pure hot-path
        waste. The memo is read both under the batcher's queue lock
        (decide_queued) and from handler threads (snapshot), hence its
        own guard."""
        # The engine names its own invalidation state (chunk staging,
        # the wide-k multipass concat, the mesh monolithic layout —
        # each a resident allocation the floor must follow).
        state = self.engine.resident_state_key()
        with self._lock:
            cached = self._model_cache
        if cached is not None and cached[0] == state:
            return cached[1]
        total = int(self.engine.resident_model_bytes())
        with self._lock:
            self._model_cache = (state, total)
        return total

    def headroom_bytes(self) -> Optional[int]:
        """Budget minus the max of (live allocated bytes, modeled resident
        set); None when no budget basis exists. Reads host state only
        (the caching allocator's counters), so a handler thread may call
        it."""
        if self.budget_bytes is None:
            return None
        measured = memwatch.measured_watermark(self.engine.device)
        used = int(measured.get("bytes", 0) or 0)
        used = max(used, self._resident_model_bytes())
        return self.budget_bytes - used

    # -- the decision ----------------------------------------------------------

    def precheck(self, nq: int, kmax: int) -> Optional[Dict[str, Any]]:
        """The request-local half of admission: shape/k caps plus the
        ``serve.admit`` injection hook. Reads no queue state — and MAY
        BLOCK (an injected straggler ``delay`` fault sleeps here), so
        the batcher calls it OUTSIDE its queue lock (a sleep under the
        lock would stall every submitter and the consumer). Returns a rejection dict, or None to proceed to the
        queue-state checks. Counters are recorded by decide_queued —
        exactly once per decision."""
        if nq < 1 or nq > self.max_request_queries:
            return {"verdict": REJECT, "reason": "shape"}
        if kmax < 1 or kmax > self.max_k:
            return {"verdict": REJECT, "reason": "k_too_large"}
        try:
            rs_inject.fire("serve.admit", nq=nq, k=kmax)
        except Exception as e:
            # An injected RESOURCE_EXHAUSTED here IS the memory
            # squeeze: treat the budget as swallowed. Anything else
            # is a real bug and must propagate.
            if classify(e) != "oom":
                raise
            return {"verdict": REJECT, "reason": "injected_squeeze"}
        return None

    def decide_queued(self, nq: int, kmax: int, queued_queries: int,
                      queued_kmax: int = 0,
                      prechecked: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        """The queue-state half: draining, queue depth, and the memory
        pricing of the micro-batch this request would COALESCE into
        (bounded by the batcher's cap; ``queued_queries``/
        ``queued_kmax`` describe the admitted-and-waiting work). Pure
        state reads and arithmetic — safe under the batcher's queue
        lock, which is what makes decision + enqueue atomic (two
        concurrent submits must not both price against the same queue
        state). ``prechecked`` is :meth:`precheck`'s verdict; the one
        admitted/rejected counter bump per decision happens here."""
        reg = telemetry.registry()
        verdict, reason = ACCEPT, "ok"
        if self.draining:
            verdict, reason = REJECT, "draining"
        elif prechecked is not None:
            verdict, reason = prechecked["verdict"], prechecked["reason"]
        elif queued_queries + nq > self.max_queue_queries:
            verdict, reason = REJECT, "queue_full"
        elif self.budget_bytes is not None:
            # Priced only when a budget exists: a no-budget backend
            # (memory shedding off) must not pay the model per
            # request for a comparison that can never fire.
            headroom = self.headroom_bytes()
            eff_nq = min(queued_queries + nq,
                         max(self.batch_queries_cap, nq))
            need = self.batch_bytes(eff_nq, max(kmax, queued_kmax))
            reg.gauge("serve.headroom_bytes").set(headroom)
            if need > headroom:
                verdict, reason = REJECT, "memory"
        if verdict == ACCEPT:
            reg.counter("serve.admitted").inc()
        else:
            reg.counter("serve.rejected").inc(label=reason)
        return {"verdict": verdict, "reason": reason, "nq": nq, "k": kmax}

    def decide(self, nq: int, kmax: int, queued_queries: int,
               queued_kmax: int = 0) -> Dict[str, Any]:
        """One standalone admission decision (tests, non-batcher
        callers): precheck + queue-state checks in order. The batcher
        composes the halves itself so the blocking half runs outside
        its queue lock."""
        return self.decide_queued(
            nq, kmax, queued_queries, queued_kmax=queued_kmax,
            prechecked=self.precheck(nq, kmax))

    def snapshot(self) -> Dict[str, Any]:
        reg = telemetry.registry()
        return {
            "budget_bytes": self.budget_bytes,
            "memory_shedding": self.budget_bytes is not None,
            "headroom_bytes": self.headroom_bytes(),
            "max_k": self.max_k,
            "max_request_queries": self.max_request_queries,
            "max_queue_queries": self.max_queue_queries,
            "admitted": reg.counter("serve.admitted").total(),
            "rejected": reg.counter("serve.rejected").by_label(),
            "draining": self.draining,
        }
