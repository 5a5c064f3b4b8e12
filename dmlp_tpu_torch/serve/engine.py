"""Resident serving engine: stage once, build each shape bucket once.

Port of ``dmlp_tpu/serve/engine.py``. :class:`ResidentEngine` is the
serving daemon's solve core. It differs from the batch
:class:`~dmlp_tpu_torch.engine.single.SingleChipEngine` only where a
persistent server needs it to; the candidates -> host float64 finalize ->
boundary repair pipeline (the byte-identity contract with the golden
oracle) is inherited unchanged.

- **One resident device buffer.** The corpus is staged once, in the
  staging dtype, as one tensor of ``max(capacity_rows, extraction rows)``
  rows (``capacity_rows`` is the row count padded to a power of two,
  ``tune.cache.shape_bucket``). Rows past ``n_real`` carry id -1, which
  every select path masks to +inf. The extraction chunks are row views of
  it (``buf[c*cr:(c+1)*cr]``), the streaming path reads
  ``buf[:capacity_rows]``, and the multi-pass sweep reads the chunks' rows
  as one view. The reference keeps up to three copies (the streaming
  buffer, one per chunk, their concatenation); here an ingest is one
  ``copy_`` into the touched rows plus their labels and ids.
- **Buckets without compilation.** Requests bucket to power-of-two
  (qpad, k) shapes. PyTorch has no ahead-of-time program: a bucket's build
  resolves its path ("extract", "multipass" or "stream") and candidate
  width, and :attr:`compile_count` counts builds. The kernel libraries
  build once per process at first use (``kernels.load``, counted in
  ``kernels.LOADS``); the warm-up triggers that. A replay whose buckets
  were all warmed changes neither count.
- **Cross-request gate warm-up.** The extraction path folds the same
  resident chunks for every request. With ``gate_carry`` on, chunks fold
  in descending order of past winners ("hot chunks first"), so each
  query's k-th-best threshold, the K1 gate's input, tightens early and
  cold chunks gate out. The carried state is the winner histogram, never a
  threshold: carry on and off print the same bytes. K1 then receives a
  carry whose ids lie above the chunk's; its split merge keeps the carry's
  order on ties, so its lists do not depend on S (``ops.extract``).
- **Wide-k multi-pass buckets.** A k-bucket whose candidate width exceeds
  the kernel's one-pass window runs the batch engine's multi-pass driver
  against the resident rows: pass 1 folds the resident chunks, passes 2+
  sweep all of them with the on-device floor chain (``_mp_floor``), and
  ``_mp_merge`` dedups and sorts to the bucket's width; the driver's stall
  and shortfall flags feed run()'s exact repair.
- **Pruning.** One summary block per resident extraction chunk, scored on
  the device per micro-batch (``ops.summaries.score_blocks``); the host
  reads the (blocks,) survivor mask once per batch. An ingest rebuilds
  exactly the blocks it touches.

Every device launch and readback runs on the caller's thread: in the
daemon, the batcher's. The methods a request handler thread calls
(:meth:`bucket_stats`, :meth:`corpus_state`, the memory-model hooks) read
host state only. The reference's spans ride the resident paths
(``serve.warmup_bucket``, ``serve.stage_resident``, ``serve.summary_build``,
``serve.ingest``, ``serve.fold_schedule``, ``serve.prune_score``,
``serve.solve_extract``, ``serve.solve_multipass``, ``serve.solve_stream``,
rid-tagged while the batcher traces; there is no ``serve.stage_chunks``:
the chunks are row views), and with a cost probe installed (the daemon's
telemetry session) each batch's recorded launches and their device ms
join its ``batch_log`` entry. The reference's persistent compile cache
has nothing to cache here.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmlp_tpu_torch import kernels
from dmlp_tpu_torch.check.sanitize import fenced, readback
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.finalize import (EPS_CANCEL_COEF, EPS_REL_BF16,
                                            EPS_REL_F32, LOWP_COEF)
from dmlp_tpu_torch.engine.single import (_BF16_AUTO_K_CAP, ChunkThrottle,
                                          SingleChipEngine, _mp_floor,
                                          _mp_merge, active_precision,
                                          extract_finalize, fit_blocks,
                                          host_staging, plan_chunks, put,
                                          resilient_get, resolve_kcap,
                                          round_up)
from dmlp_tpu_torch.fleet import consistency as ccs
from dmlp_tpu_torch.io.grammar import KNNInput, Params
from dmlp_tpu_torch.io.report import QueryResult
from dmlp_tpu_torch.obs import counters as obs_counters
from dmlp_tpu_torch.obs import memwatch, telemetry
from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.ops import fused
from dmlp_tpu_torch.ops import summaries as osum
from dmlp_tpu_torch.ops.topk import TopK, streaming_topk
from dmlp_tpu_torch.resilience import degrade as rs_degrade
from dmlp_tpu_torch.tune.cache import shape_bucket


class CapacityError(RuntimeError):
    """An ingest would exceed the resident buffer's capacity (the daemon
    reports it as a rejected ingest, never a crash)."""


class RequestShapeError(ValueError):
    """A request shape the resident engine cannot serve (k beyond the
    serving cap); admission rejects these before the solve."""


def query_bucket(nq: int, granule: int = 8) -> int:
    """Query count -> power-of-two bucket (>= ``granule``; the extraction
    path's granule is the kernel's QUERY_TILE)."""
    return max(shape_bucket(max(nq, 1)), granule)


def k_bucket(kmax: int) -> int:
    """Per-request max k -> power-of-two bucket: the candidate width
    derives from the bucket, so every k in (bucket/2, bucket] shares one
    bucket."""
    return shape_bucket(max(kmax, 1))


class _Bucket:
    """One (qpad, k-bucket) shape bucket: the resolved candidate width,
    the chosen path, and the query blocking of the streaming path."""

    __slots__ = ("qpad", "kb", "kcap", "path", "qb", "nqb", "stream")

    def __init__(self, qpad: int, kb: int, kcap: int, path: str,
                 qb: int, nqb: int):
        self.qpad, self.kb, self.kcap = qpad, kb, kcap
        self.path = path          # "extract" | "multipass" | "stream"
        self.qb, self.nqb = qb, nqb
        # Whether the streaming path was built for this bucket: at build
        # time for a stream bucket, on first use for an extraction bucket
        # degraded to the streaming rung (counted then as a build).
        self.stream = path == "stream"

    @property
    def key(self) -> str:
        return f"q{self.qpad}k{self.kb}"


class ResidentServingCore:
    """The serving surface of a resident engine: bucket bookkeeping,
    warm-up, the corpus signature, the corpus max squared norm, and the
    memory-model hooks that admission reads.

    Subclass contract: ``bucket_shape``/``_build_bucket``/``max_k``/
    ``solve_batch`` plus the resident state the hooks read; the subclass
    implements :meth:`mem_model`, :meth:`batch_model_bytes` and
    :meth:`resident_state_key`."""

    #: the current micro-batch's request ids, set by the batcher while it
    #: traces (one batcher thread), riding the engine's spans
    trace_rids: Optional[str] = None

    def _rid_args(self) -> Dict[str, Any]:
        """Span args carrying the current batch's rids; empty untraced."""
        t = self.trace_rids
        return {"rids": t} if t else {}

    def _bucket_entry(self, nq: int, kmax: int):
        """The bucket for (nq, kmax), built (and counted) on first use;
        the warm-up drives this so steady-state serving takes the dict
        hit only."""
        if kmax > self.max_k:
            raise RequestShapeError(
                f"k={kmax} beyond the serving cap {self.max_k}")
        key = self.bucket_shape(nq, kmax)
        entry = self._buckets.get(key)
        if entry is None:
            t0 = time.perf_counter()
            entry = self._build_bucket(*key)
            self._buckets[key] = entry
            ms = (time.perf_counter() - t0) * 1e3
            self.bucket_compile_ms[entry.key] = round(ms, 3)
            self.compile_count += 1
            reg = telemetry.registry()
            reg.counter("serve.bucket_compiles").inc(label=entry.key)
            reg.histogram("serve.bucket_compile_ms", unit="ms").observe(ms)
        return entry

    def warmup(self, buckets) -> Dict[str, float]:
        """Drive one synthetic micro-batch through every (nq, k) in
        ``buckets`` before serving: builds the buckets and loads the
        kernel libraries, and records ``cold_start_compile_ms``. Returns
        per-bucket wall ms."""
        t0 = time.perf_counter()
        per: Dict[str, float] = {}
        seen = set()
        for nq, k in buckets:
            # Clamp to the serving cap only: k > n_real is a legal
            # request shape (sentinel padding), so it warms that bucket.
            k = max(1, min(int(k), self.max_k))
            nq = max(1, int(nq))
            key = self.bucket_shape(nq, k)
            if key in seen:
                continue
            seen.add(key)
            tb = time.perf_counter()
            idx = np.arange(nq) % self.n_real
            q = self._host_attrs[:self.n_real][idx]
            ks = np.full(nq, k, np.int32)
            with obs_span("serve.warmup_bucket", qpad=key[0], kb=key[1]):
                self.solve_batch(q, ks)
            per[f"q{key[0]}k{key[1]}"] = round(
                (time.perf_counter() - tb) * 1e3, 3)
        self.cold_start_compile_ms = round(
            (time.perf_counter() - t0) * 1e3, 3)
        reg = telemetry.registry()
        reg.gauge("serve.cold_start_compile_ms").set(
            self.cold_start_compile_ms)
        reg.gauge("serve.warm_buckets").set(len(self._buckets))
        return per

    # -- corpus signature (the fleet's consistency check reads it) ---------

    def _sig_init(self) -> None:
        """Seed the rolling corpus signature (fleet.consistency): a pure
        function of (global row id, label, attribute bits)."""
        n = self.n_real
        self._row_hash = np.zeros(len(self._host_labels), np.uint64)
        fold = 0
        if n:
            self._row_hash[:n] = ccs.row_hashes(
                self._host_labels[:n], self._host_attrs[:n])
            fold = ccs.fold_terms(0, self._row_hash[:n])
        # One tuple, assigned at once: stats handlers read it while the
        # batcher thread ingests.
        self._corpus_sig = (n, fold, 0)

    def _sig_update(self, start: int, end: int) -> None:
        """Fold rows ``[start, end)``'s new content in (O(m); idempotent
        overwrites are exact no-ops) and bump the ingest epoch."""
        n0, fold, epoch = self._corpus_sig
        new_h = ccs.row_hashes(self._host_labels[start:end],
                               self._host_attrs[start:end])
        fold = ccs.fold_replace(fold, start,
                                self._row_hash[start:end], new_h)
        self._row_hash[start:end] = new_h
        self._corpus_sig = (max(n0, end), fold, epoch + 1)

    def corpus_state(self) -> Dict[str, int]:
        """Row count, rolling checksum and ingest epoch."""
        n, fold, epoch = self._corpus_sig
        return {"rows": n, "checksum": fold, "epoch": epoch}

    def corpus_slice(self, start: int, count: int):
        """Host rows ``[start, start+count)`` clamped to the resident row
        count (the ``corpus`` wire op's source)."""
        n = self._corpus_sig[0]
        start = max(0, min(int(start), n))
        end = max(start, min(start + int(count), n))
        return (self._host_labels[start:end].copy(),
                self._host_attrs[start:end].copy())

    # -- corpus max squared norm (multi-pass floors) ------------------------

    def _dn_max(self) -> float:
        if self._dn_max_cache is None:
            a = self._host_attrs[:self.n_real]
            self._dn_max_cache = float(
                np.einsum("na,na->n", a, a).max()) if self.n_real else 0.0
        return self._dn_max_cache

    def _note_ingested_norms(self, attrs: np.ndarray) -> None:
        """The max squared norm only grows on ingest (an overwrite may
        leave it too large, which only widens an eps)."""
        if self._dn_max_cache is not None and len(attrs):
            nn = np.einsum("ma,ma->m", attrs, attrs).max()
            self._dn_max_cache = max(self._dn_max_cache, float(nn))

    # -- memory-model hooks (admission reads these) -------------------------

    def mem_model(self, nq: int = 0, kmax: int = 0):
        raise NotImplementedError

    def batch_model_bytes(self, nq: int, kmax: int) -> int:
        raise NotImplementedError

    def resident_state_key(self):
        """The resident state whose change invalidates a cached
        resident-floor total (admission memoizes on it)."""
        raise NotImplementedError

    def resident_model_bytes(self) -> int:
        """The resident floor: corpus terms only, no batch."""
        return int(self.mem_model(0, 0)["total_bytes"])


class ResidentEngine(ResidentServingCore, SingleChipEngine):
    """Resident engine of the serving daemon.

    ``corpus`` supplies the data (its query section, if any, is ignored
    here; the daemon seeds its warm-up from it). ``capacity`` is the
    ingest ceiling in rows (default: the corpus row count's power-of-two
    bucket). The device is ``config.device``: "cuda" raises without a
    card."""

    BATCH_LOG = 128

    def __init__(self, corpus: KNNInput, config: EngineConfig = None,
                 capacity: Optional[int] = None, gate_carry: bool = True):
        super().__init__(config or EngineConfig())
        cfg = self.config
        n = corpus.params.num_data
        na = corpus.params.num_attrs
        if n < 1:
            raise ValueError("resident corpus must have at least one row")
        cap = capacity or shape_bucket(n)
        if cap < n:
            raise ValueError(f"capacity {cap} < corpus rows {n}")
        self.num_attrs = na
        self.gate_carry = bool(gate_carry)
        # First-pass precision plan, frozen here: bucket windows, the
        # staged summary eps and the active cast (active_precision clamps
        # to it) all derive from one plan.
        self._precision_plan = cfg.resolve_precision()

        # -- the streaming layout, planned once at capacity shape ----------
        self._stream_select = cfg.resolve_streaming_select(
            round_up(cap, 8))
        granule = cfg.resolve_granule(self._stream_select)
        self._data_block = fit_blocks(
            cap, cfg.resolve_data_block(self._stream_select),
            granule=granule)
        self.capacity_rows = round_up(cap, self._data_block)

        # -- extraction eligibility and chunk plan --------------------------
        self._extract_ok = (cfg.use_pallas and cfg.resolve_select(
            round_up(cap, 8)) == "extract")
        if self._extract_ok:
            eg = cfg.resolve_granule("extract")
            _, self._ex_nchunks, self._ex_chunk_rows = plan_chunks(
                self.capacity_rows, eg, cfg.data_block)
            self._ex_rows = self._ex_nchunks * self._ex_chunk_rows
        else:
            self._ex_nchunks = self._ex_chunk_rows = self._ex_rows = 0
        self._chunks_ready = False
        self.resident_rows = max(self.capacity_rows, self._ex_rows)

        # -- host originals (the float64 finalize rescores from these) -----
        rows = self.resident_rows
        self._host_attrs = np.zeros((rows, na), np.float64)
        self._host_attrs[:n] = corpus.data_attrs
        self._host_labels = np.full(rows, -1, np.int32)
        self._host_labels[:n] = corpus.labels
        self.n_real = n
        self._sig_init()

        # -- the one resident device buffer, with its labels and ids --------
        ids = np.full(rows, -1, np.int32)
        ids[:n] = np.arange(n, dtype=np.int32)
        dev = self.device
        with obs_span("serve.stage_resident", rows=rows, na=na):
            with fenced("serve.stage_resident"):
                self._buf = host_staging(self._host_attrs, dev,
                                         self._staging).to(dev)
            self._d_labels = put(self._host_labels.copy(), dev,
                                 "serve.stage_resident")
            self._d_ids = put(ids, dev, "serve.stage_resident")

        # -- bucket registry and build bookkeeping --------------------------
        self._buckets: Dict[Tuple[int, int], _Bucket] = {}
        self.compile_count = 0
        self.cold_start_compile_ms: Optional[float] = None
        self.bucket_compile_ms: Dict[str, float] = {}
        self._dn_max_cache: Optional[float] = None
        # Cross-request gate state: the per-chunk winner histogram, and
        # the last batch's gated-tile stats (device count, tile count).
        self._block_hits = np.zeros(max(self._ex_nchunks, 1), np.int64)
        self._pending_gate: Optional[Tuple] = None
        self.last_gated_fraction: Optional[float] = None
        self.last_precision: Optional[dict] = None
        # One record per solved micro-batch, the last BATCH_LOG of them:
        # its bucket, path, rung, prune and phase times, and the kernel
        # launches it made (kernels.LAUNCHES and LAUNCH_VARIANTS deltas),
        # so a caller can hold every batch's launches against its plan.
        self.batch_log: collections.deque = collections.deque(
            maxlen=self.BATCH_LOG)
        self.batches_solved = 0
        # Pruned two-stage solve: host f64 summaries per resident chunk
        # and their conservative f32 device copies, built with the first
        # extraction bucket and rebuilt per touched block on ingest.
        self._summ = None
        self._summ_dev = None
        self.summary_rebuilds = 0
        self.last_prune_fraction: Optional[float] = None
        reg = telemetry.registry()
        reg.gauge("serve.corpus_rows").set(n)
        reg.gauge("serve.capacity_rows").set(self.capacity_rows)
        reg.gauge("serve.gate.carry_enabled").set(int(self.gate_carry))

    # -- shape buckets --------------------------------------------------------

    @property
    def query_granule(self) -> int:
        if self._extract_ok:
            from dmlp_tpu_torch.ops.extract import QUERY_TILE
            return QUERY_TILE
        return 8

    @property
    def max_k(self) -> int:
        """Largest per-query k served: the corpus capacity, and the bf16
        cap under bfloat16 staging."""
        cap = self.capacity_rows
        if self._staging == "bfloat16":
            cap = min(cap, _BF16_AUTO_K_CAP)
        return cap

    def bucket_shape(self, nq: int, kmax: int) -> Tuple[int, int]:
        return (query_bucket(nq, self.query_granule), k_bucket(kmax))

    def _kcap_for(self, kb: int) -> int:
        return resolve_kcap(self.config, kb, self._stream_select,
                            self.capacity_rows, staging=self._staging,
                            precision=self._precision_plan)

    def bucket_plan(self, nq: int, kmax: int) -> Tuple[int, int, int]:
        """(qpad, k-bucket, kcap) of a batch shape: the one derivation of
        the candidate width, read by admission and the memory model."""
        qpad, kb = self.bucket_shape(nq, kmax)
        return qpad, kb, self._kcap_for(kb)

    def _build_bucket(self, qpad: int, kb: int) -> _Bucket:
        cfg = self.config
        kcap = self._kcap_for(kb)
        qb = min(1 << max(min(cfg.query_block, qpad).bit_length() - 1, 3),
                 qpad)
        nqb = qpad // qb
        path = "stream"
        if self._extract_ok and kcap <= 512:
            kern, _ = fused.resolve_topk_kernel(
                qpad, self._ex_chunk_rows, self.num_attrs, kcap)
            if kern is not None:
                path = "extract"
                self._ensure_chunks()
        elif self._extract_ok and kcap > self._MP_KC \
                and -(-kcap // self._MP_KC) <= self._MP_MAX_PASSES:
            # k past the kernel's one-pass window: the multi-pass driver
            # against the resident rows.
            kern, _ = fused.resolve_topk_kernel(
                qpad, self._ex_chunk_rows, self.num_attrs, self._MP_KC)
            if kern is not None:
                path = "multipass"
                self._ensure_chunks()
        return _Bucket(qpad, kb, kcap, path, qb, nqb)

    # -- resident chunks (row views) and their summaries -----------------------

    def _chunk(self, c: int) -> torch.Tensor:
        cr = self._ex_chunk_rows
        return self._buf[c * cr:(c + 1) * cr]

    def _ensure_chunks(self) -> None:
        """Mark the extraction chunks in use and build their summaries
        (the reference stages its chunk copies here; the port's chunks
        are views of the resident buffer)."""
        if self._chunks_ready or not self._extract_ok:
            return
        self._chunks_ready = True
        self._build_summaries()

    def _chunk_span(self, c: int) -> Tuple[int, int]:
        cr = self._ex_chunk_rows
        return c * cr, min(c * cr + cr, self.n_real)

    def _build_summaries(self) -> None:
        """Stage 0 at ingest granularity: one summary block per resident
        extraction chunk, host f64 plus device f32 copies."""
        if not self._extract_ok or self._ex_nchunks <= 1 \
                or not osum.prune_enabled():
            return
        with obs_span("serve.summary_build", blocks=self._ex_nchunks):
            self._summ = osum.build_summaries(
                self._host_attrs,
                [self._chunk_span(c) for c in range(self._ex_nchunks)])
            self._stage_summaries()
        telemetry.registry().gauge("prune.summary_blocks").set(
            self._ex_nchunks)

    def _stage_summaries(self) -> None:
        dev = osum.stage_summaries(self._summ, self.device)
        rel = EPS_REL_BF16 if self._staging == "bfloat16" else EPS_REL_F32
        # score_blocks widens thresholds by eps_rel * sqrt(thr * scale) +
        # eps_cancel * scale; folding the plan's LOWP_COEF into eps_cancel
        # composes the bf16 first-pass bound additively, as prune_mask
        # widens by lowp_eps (plan-level: on the f32 rungs the extra slack
        # only keeps a few more blocks).
        dev["eps_rel"] = torch.tensor(np.float32(rel), device=self.device)
        dev["eps_cancel"] = torch.tensor(
            np.float32(EPS_CANCEL_COEF * (self.num_attrs + 2)
                       + LOWP_COEF[self._precision_plan]),
            device=self.device)
        self._summ_dev = dev

    def _rebuild_summary_blocks(self, blocks) -> None:
        """Rebuild exactly the touched blocks' summaries from their
        current host rows, then restage the device copies (counted, so
        tests can assert the rebuild happened)."""
        if self._summ is None:
            return
        blocks = list(blocks)
        for c in blocks:
            lo, hi = self._chunk_span(c)
            osum.update_block(self._summ, c, self._host_attrs[lo:hi],
                              lo_hi=(lo, hi))
        self._stage_summaries()
        self.summary_rebuilds += len(blocks)
        telemetry.registry().counter("prune.summary_rebuilds").inc(
            len(blocks))

    # -- incremental ingestion ------------------------------------------------

    def ingest(self, labels, attrs, start: Optional[int] = None) -> int:
        """Write rows into the resident corpus; returns the new row count.
        ``start=None`` appends; ``start <= n_real`` writes at that global
        row (an idempotent row-write: the same rows at the same positions
        change nothing, the corpus signature included). No bucket is
        rebuilt: the device work is one copy into the touched rows of the
        resident buffer, plus their labels and ids."""
        labels = np.asarray(labels, np.int32).reshape(-1)
        attrs = np.asarray(attrs, np.float64)
        if attrs.ndim != 2 or attrs.shape[1] != self.num_attrs:
            raise ValueError(
                f"ingest rows must be (m, {self.num_attrs}), "
                f"got {attrs.shape}")
        m = attrs.shape[0]
        if m != labels.shape[0]:
            raise ValueError("labels/attrs row-count mismatch")
        if m == 0:
            return self.n_real
        at = self.n_real if start is None else int(start)
        if at < 0 or at > self.n_real:
            raise ValueError(
                f"ingest start {at} beyond resident rows {self.n_real} "
                "(row-writes may overwrite or append, never leave gaps)")
        end = at + m
        new_n = max(self.n_real, end)
        if end > self.capacity_rows:
            raise CapacityError(
                f"ingest of {m} rows at {at} exceeds capacity "
                f"{self.capacity_rows} (resident: {self.n_real})")
        with obs_span("serve.ingest", rows=m, corpus_rows=new_n):
            self._host_attrs[at:end] = attrs
            self._host_labels[at:end] = labels
            self.n_real = new_n
            dev = self.device
            self._buf[at:end].copy_(
                host_staging(self._host_attrs[at:end], dev, self._staging),
                non_blocking=True)
            self._d_labels[at:end].copy_(torch.from_numpy(labels))
            self._d_ids[at:end].copy_(torch.arange(at, end,
                                                   dtype=torch.int32))
        if self._chunks_ready:
            cr = self._ex_chunk_rows
            # The summaries of exactly the touched blocks rebuild with the
            # rows: a stale one could keep a block pruned whose new rows
            # belong in a top-k.
            self._rebuild_summary_blocks(range(at // cr, -(-end // cr)))
        self._note_ingested_norms(attrs)
        self._sig_update(at, end)
        reg = telemetry.registry()
        reg.counter("serve.ingested_rows").inc(m)
        reg.gauge("serve.corpus_rows").set(new_n)
        return new_n

    # -- resident solves ------------------------------------------------------

    def _batch_input(self, query_attrs: np.ndarray,
                     ks: np.ndarray) -> KNNInput:
        """A micro-batch as a KNNInput over the resident corpus (host views
        feed the float64 finalize and repair)."""
        nq = len(ks)
        return KNNInput(
            Params(self.n_real, nq, self.num_attrs),
            self._host_labels[:self.n_real],
            self._host_attrs[:self.n_real],
            np.asarray(ks, np.int32),
            np.asarray(query_attrs, np.float64))

    def _solve_resident_stream(self, inp: KNNInput,
                               entry: _Bucket) -> Tuple[TopK, int]:
        """The streaming fold over ``buf[:capacity_rows]`` (K3 under the
        "seg" select), one query block at a time."""
        if not entry.stream:
            # An extraction bucket degraded to streaming: its streaming
            # path is built now, once, and counted as a build.
            t0 = time.perf_counter()
            entry.stream = True
            self.compile_count += 1
            telemetry.registry().counter("serve.bucket_compiles").inc(
                label=entry.key + "_stream_fallback")
            self.bucket_compile_ms[entry.key + "_stream_fallback"] = \
                round((time.perf_counter() - t0) * 1e3, 3)
        t0 = time.perf_counter()
        q_dev = self._stage_queries(inp.query_attrs, entry.qpad)
        self._last_select = self._stream_select
        rows = self.capacity_rows
        d, lab, ids = (self._buf[:rows], self._d_labels[:rows],
                       self._d_ids[:rows])
        qb = entry.qb
        with obs_span("serve.solve_stream", qpad=entry.qpad,
                      kcap=entry.kcap, **self._rid_args()):
            outs = [streaming_topk(q_dev[b * qb:(b + 1) * qb], d, lab,
                                   ids, entry.kcap, self._data_block,
                                   self._stream_select,
                                   self.config.use_pallas)
                    for b in range(entry.nqb)]
        # The streaming fold scans the whole resident buffer: a dense
        # scan, recorded as such.
        dense = self.n_real * self.num_attrs * self._staging_itemsize()
        osum.note_scan(self, scanned_bytes=dense, dense_bytes=dense,
                       blocks_total=1, blocks_pruned=0)
        self.last_phase_ms["enqueue"] = (time.perf_counter() - t0) * 1e3
        return TopK(*(torch.cat(p) for p in zip(*outs))), entry.qpad

    def _prune_survivors(self, inp: KNNInput, entry: _Bucket, q_dev):
        """Stage 1 per micro-batch: score the resident summaries on the
        device and read back the (blocks,) survivor mask. Active on the
        ladder's top rungs in exact mode only; returns (mask, stats), or
        (None, None) for a dense fold."""
        if (self._summ_dev is None
                or self._degrade_rung not in ("lowp", "prune")
                or not self.config.exact or not osum.prune_enabled()):
            return None, None
        t0 = time.perf_counter()
        nq = inp.params.num_queries
        ks = np.ones(entry.qpad, np.int32)
        ks[:nq] = inp.ks
        qvalid = np.zeros(entry.qpad, bool)
        qvalid[:nq] = True
        sd = self._summ_dev
        dev = self.device
        with obs_span("serve.prune_score", blocks=self._ex_nchunks,
                      qpad=entry.qpad, **self._rid_args()):
            mask = osum.score_blocks(
                q_dev, put(qvalid, dev, "serve.prune_stage"),
                put(ks, dev, "serve.prune_stage"), sd["counts"],
                sd["nmin"], sd["nmax"], sd["lo"], sd["hi"], sd["dn_max"],
                sd["eps_rel"], sd["eps_cancel"])
            # The mask decides which chunks the folds launch over, so the
            # host reads it (O(blocks) bytes) before launching them.
            keep = readback(mask, "serve.prune_mask")  # check: allow-host-sync
        self.last_phase_ms["prune"] = (time.perf_counter() - t0) * 1e3
        total = int(np.count_nonzero(
            self._summ.counts[:self._ex_nchunks] > 0))
        pruned = total - int(np.count_nonzero(keep))
        if not keep.any():
            return None, None   # belt: score_blocks keeps >= 1 block
        return keep, {"blocks_total": total, "blocks_pruned": pruned}

    def _solve_resident_extract(self, inp: KNNInput, entry: _Bucket
                                ) -> Optional[Tuple[TopK, int]]:
        kern, impl = fused.resolve_topk_kernel(
            entry.qpad, self._ex_chunk_rows, self.num_attrs, entry.kcap,
            rung=self._degrade_rung)
        if kern is None:
            return None
        t0 = time.perf_counter()
        na = self.num_attrs
        prec = active_precision(self)
        q_dev = self._stage_queries(inp.query_attrs, entry.qpad)
        cr = self._ex_chunk_rows
        order = self._chunk_order()
        survivors, prune_stats = self._prune_survivors(inp, entry, q_dev)
        if survivors is not None:
            # Survivors in hot-first order: pruned chunks drop out.
            order = [c for c in order if survivors[c]]
        od = oi = None
        gz = None
        ntiles = 0
        scanned = 0
        item = self._staging_itemsize()
        throttle = ChunkThrottle(self.device)
        self._last_select = "extract"
        self.last_extract_impl = impl
        with obs_span("serve.solve_extract", qpad=entry.qpad,
                      kcap=entry.kcap, impl=impl, carry=self.gate_carry,
                      scheduled=len(order), **self._rid_args()):
            for c in order:
                lo = c * cr
                nr = min(self.n_real - lo, cr)
                if nr <= 0:
                    continue
                od, oi, iters = kern(q_dev, self._chunk(c), od, oi,
                                     n_real=nr, id_base=lo, kc=entry.kcap,
                                     precision=prec)
                scanned += nr * na * item
                # Gate statistics stay on the device until the batch ends.
                z = (iters == 0).sum()
                gz = z if gz is None else gz + z
                ntiles += iters.numel()
                throttle.tick()
        if od is None:
            # Every scheduled chunk was empty (a sound mask cannot do
            # that; the belt above): the dense streaming fold instead.
            return None
        self._pending_gate = (gz, ntiles)
        osum.note_scan(self, scanned_bytes=scanned,
                       dense_bytes=self.n_real * na * item,
                       blocks_total=(prune_stats or {}).get(
                           "blocks_total", -(-self.n_real // cr)),
                       blocks_pruned=(prune_stats or {}).get(
                           "blocks_pruned", 0))
        self.last_prune_fraction = self.last_prune["pruned_fraction"]
        top = extract_finalize(od, oi, self._d_labels, k=entry.kcap)
        self.last_phase_ms["enqueue"] = (time.perf_counter() - t0) * 1e3
        return top, entry.qpad

    def _solve_resident_multipass(self, inp: KNNInput, entry: _Bucket
                                  ) -> Optional[Tuple[TopK, int]]:
        """k past the kernel's one-pass window, on the batch engine's
        multi-pass driver against the resident rows: pass 1 folds the
        resident chunks, passes 2+ sweep all of them with the on-device
        floor chain, and ``_mp_merge`` dedups and sorts to the bucket
        width. The stall and shortfall flags set ``_mp_hazard`` for run()'s
        exact repair."""
        kc = self._MP_KC
        kcap = entry.kcap
        if not self._chunks_ready or -(-kcap // kc) > self._MP_MAX_PASSES:
            return None
        kern, impl = fused.resolve_topk_kernel(
            entry.qpad, self._ex_chunk_rows, self.num_attrs, kc,
            rung=self._degrade_rung)
        if kern is None:
            return None
        kern_full, _ = fused.resolve_topk_kernel(
            entry.qpad, self._ex_rows, self.num_attrs, kc,
            rung=self._degrade_rung)
        if kern_full is None:
            return None
        t0 = time.perf_counter()
        npasses = -(-kcap // kc)
        nq = inp.params.num_queries
        na = self.num_attrs
        n = self.n_real
        cr = self._ex_chunk_rows
        prec = active_precision(self)
        q_dev = self._stage_queries(inp.query_attrs, entry.qpad)
        self._last_select = "extract"
        self.last_extract_impl = impl
        od = oi = None
        throttle = ChunkThrottle(self.device)
        with obs_span("serve.solve_multipass", qpad=entry.qpad, kcap=kcap,
                      passes=npasses, impl=impl, **self._rid_args()):
            for c in range(self._ex_nchunks):
                lo = c * cr
                nr = min(n - lo, cr)
                if nr <= 0:
                    continue
                od, oi, _its = kern(q_dev, self._chunk(c), od, oi, n_real=nr,
                                    id_base=lo, kc=kc, precision=prec)
                throttle.tick()
            if od is None:
                return None
            ods, ois = [od], [oi]
            qn_host = np.zeros(entry.qpad, np.float64)
            qn_host[:nq] = np.einsum("qa,qa->q", inp.query_attrs,
                                     inp.query_attrs)
            dev = self.device
            qn_dev = put(qn_host.astype(np.float32), dev, "serve.mp_stage")
            dn_dev = put(np.float32(self._dn_max()), dev, "serve.mp_stage")
            d_full = self._buf[:self._ex_rows]
            fds = []
            for _p in range(1, npasses):
                floor, fd = _mp_floor(ods[-1], qn_dev, dn_dev,
                                      staging=self._staging, na=na,
                                      precision=prec)
                fds.append(fd)
                od, oi, _its = kern_full(q_dev, d_full, n_real=n, id_base=0,
                                         kc=kc, floor=floor, precision=prec)
                throttle.tick()
                ods.append(od)
                ois.append(oi)
            fds.append(_mp_floor(ods[-1], qn_dev, dn_dev,
                                 staging=self._staging, na=na,
                                 precision=prec)[1])
            top, valid = _mp_merge(torch.cat(ods, 1), torch.cat(ois, 1),
                                   self._d_labels, kcap=kcap)
        self.last_mp_passes = len(ods)
        # The multi-pass plan sweeps the whole resident corpus: a dense
        # scan by design.
        dense = n * na * self._staging_itemsize()
        osum.note_scan(self, scanned_bytes=dense, dense_bytes=dense,
                       blocks_total=self._ex_nchunks, blocks_pruned=0)
        self.last_phase_ms["enqueue"] = (time.perf_counter() - t0) * 1e3
        # One readback for both checks: the fd chain (stall) and the valid
        # counts (shortfall); run()'s repair makes both exact.
        valid_h, fd_h = resilient_get([valid, torch.stack(fds)])
        stalled = np.zeros(entry.qpad, bool)
        for prev, cur in zip(fd_h, fd_h[1:]):
            stalled |= np.isfinite(cur) & (cur <= prev)
        needed = np.minimum(inp.ks.astype(np.int64), n)
        self._mp_hazard = stalled[:nq] | (valid_h[:nq] < needed)
        telemetry.registry().counter("serve.multipass_batches").inc()
        return top, entry.qpad

    def _chunk_order(self) -> List[int]:
        """Fold order over the resident chunks: hottest (most past
        winners) first with gate carry on, natural otherwise; a stable
        sort keeps cold chunks in their natural order."""
        with obs_span("serve.fold_schedule", chunks=self._ex_nchunks,
                      carry=self.gate_carry, **self._rid_args()):
            idx = range(self._ex_nchunks)
            if not self.gate_carry:
                return list(idx)
            return [int(c) for c in np.argsort(
                -self._block_hits[:self._ex_nchunks], kind="stable")]

    # -- SingleChipEngine seam overrides --------------------------------------

    def _solve(self, inp: KNNInput) -> Tuple[TopK, int]:
        self.last_phase_ms = {}
        self.last_extract_impl = None
        self.last_prune = None
        if inp.params.num_data != self.n_real:
            raise ValueError(
                f"resident solve got a foreign corpus "
                f"({inp.params.num_data} rows, resident {self.n_real}); "
                "build micro-batches with _batch_input/solve_batch")
        nq = inp.params.num_queries
        kmax = int(inp.ks.max()) if nq else 1
        entry = self._bucket_entry(nq, kmax)
        out = None
        if self._degrade_rung != "streaming":
            if entry.path == "extract":
                out = self._solve_resident_extract(inp, entry)
            elif entry.path == "multipass":
                out = self._solve_resident_multipass(inp, entry)
        return out if out is not None \
            else self._solve_resident_stream(inp, entry)

    def _solve_segments(self, inp: KNNInput, allow_multipass: bool = True):
        # No heterogeneous-k routing on the resident paths: one segment
        # per micro-batch keeps the per-request slicing trivial. Wide-k
        # buckets take _solve_resident_multipass inside _solve.
        self.last_hetk = None
        self._mp_hazard = None
        self.last_mp_passes = 0
        top, qpad = self._solve(inp)
        return [(top, qpad, None, self._last_select)]

    def run(self, inp: KNNInput) -> List[QueryResult]:
        kmax = int(inp.ks.max()) if inp.params.num_queries else 0
        if kmax > self.max_k:
            raise RequestShapeError(
                f"k={kmax} beyond the serving cap {self.max_k}")
        return rs_degrade.run_ladder(self, inp, self._run)

    # -- the serving entry ----------------------------------------------------

    def solve_batch(self, query_attrs, ks) -> List[QueryResult]:
        """One coalesced micro-batch end to end: bucket, solve, float64
        finalize and repair, then update the cross-request gate state.
        Results carry query ids 0..nq-1 in batch order; the batcher slices
        them per request."""
        inp = self._batch_input(np.asarray(query_attrs, np.float64),
                                np.asarray(ks, np.int32))
        self._pending_gate = None
        launches = dict(kernels.LAUNCHES)
        variants = {k: dict(v) for k, v in kernels.LAUNCH_VARIANTS.items()}
        probe = obs_counters.active()
        recorded = probe.dispatch_counts() if probe is not None else None
        results = self.run(inp)
        self._after_batch(results)
        self._log_batch(inp, launches, variants)
        if probe is not None:
            self._log_dispatches(probe, recorded)
        return results

    def _log_dispatches(self, probe, before: Dict[str, int]) -> None:
        """With a cost probe installed (the daemon's telemetry session):
        the batch's recorded launches per kernel and their CUDA-event
        device ms (the results are fetched, so the events have finished)
        into the batch's log entry and the registry's
        ``serve.kernel_dispatches`` / ``serve.kernel_device_ms``."""
        now = probe.dispatch_counts()
        delta = {k: n - before.get(k, 0) for k, n in now.items()
                 if n - before.get(k, 0)}
        ms = probe.drain_events()
        reg = telemetry.registry()
        for k, n in delta.items():
            reg.counter("serve.kernel_dispatches").inc(n, label=k)
        for k, v in ms.items():
            reg.counter("serve.kernel_device_ms").inc(v, label=k)
        self.batch_log[-1].update(dispatches=delta, device_ms=ms)

    def _log_batch(self, inp: KNNInput, launches, variants) -> None:
        nq = inp.params.num_queries
        qpad, kb = self.bucket_shape(nq, int(inp.ks.max()) if nq else 1)
        entry = self._buckets.get((qpad, kb))
        lp = self.last_prune
        delta_v = {}
        for k, per in kernels.LAUNCH_VARIANTS.items():
            d = {s: n - variants.get(k, {}).get(s, 0)
                 for s, n in per.items()}
            d = {s: n for s, n in d.items() if n}
            if d:
                delta_v[k] = d
        self.batches_solved += 1
        self.batch_log.append({
            "seq": self.batches_solved,
            "bucket": entry.key if entry is not None else None,
            "path": entry.path if entry is not None else None,
            "qpad": qpad, "nq": nq, "n_real": self.n_real,
            "rung": self.last_degrade_rung, "repairs": self.last_repairs,
            "mp_passes": self.last_mp_passes,
            "blocks_pruned": lp.get("blocks_pruned") if lp else None,
            "gated_fraction": self.last_gated_fraction,
            "phase_ms": dict(self.last_phase_ms),
            "launches": {k: v - launches.get(k, 0)
                         for k, v in kernels.LAUNCHES.items()},
            "launch_variants": delta_v})

    def _after_batch(self, results: List[QueryResult]) -> None:
        if self._pending_gate is not None:
            gz, ntiles = self._pending_gate
            self._pending_gate = None
            # The one read of the batch's gate count (the results were
            # fetched already, so this waits on nothing).
            gated = int(readback(gz, "serve.gate_count"))  # check: allow-host-sync
            frac = gated / max(ntiles, 1)
            self.last_gated_fraction = frac
            reg = telemetry.registry()
            reg.gauge("serve.gate.gated_fraction").set(round(frac, 6))
            reg.counter("serve.gate.tiles_total").inc(ntiles)
            reg.counter("serve.gate.tiles_gated").inc(gated)
        if self.gate_carry and self._ex_nchunks and results:
            ids = np.concatenate(
                [np.asarray(r.neighbor_ids, np.int64) for r in results])
            ids = ids[ids >= 0]
            if ids.size:
                hits = np.bincount(ids // self._ex_chunk_rows,
                                   minlength=self._ex_nchunks)
                self._block_hits[:len(hits)] += hits

    # -- memory-model hooks ---------------------------------------------------

    def mem_model(self, nq: int = 0, kmax: int = 0):
        """The analytic model (obs.memwatch.serve_engine_model) at this
        engine's own bucket_plan; batch terms iff ``nq > 0``. It counts
        what the port allocates: one resident buffer, no chunk copies."""
        qpad = kcap = 0
        if nq > 0:
            qpad, _kb, kcap = self.bucket_plan(nq, max(kmax, 1))
        return memwatch.serve_engine_model(
            self.resident_rows, self.num_attrs, staging=self._staging,
            qpad=qpad, kcap=kcap,
            summary_blocks=(self._ex_nchunks
                            if self._summ_dev is not None else 0))

    def batch_model_bytes(self, nq: int, kmax: int) -> int:
        terms = self.mem_model(nq, kmax)["terms"]
        return int(terms["query_blocks"] + terms["topk_carries"])

    def resident_state_key(self):
        # The floor moves only when the summaries stage (with the first
        # extraction bucket): the chunks are views, not copies.
        return (self._summ_dev is not None,)

    # -- introspection --------------------------------------------------------

    def bucket_stats(self) -> Dict[str, object]:
        # Snapshot the bucket table first (handler threads call this while
        # the batcher thread may insert a bucket; list() of a dict is one
        # read), and read last_prune once (the batcher resets it).
        entries = list(self._buckets.values())
        lp = self.last_prune
        lprec = self.last_precision
        return {
            "buckets": sorted(e.key for e in entries),
            "paths": {e.key: e.path for e in entries},
            # No compiled program to fingerprint in this package.
            "hlo_schedule": {},
            "compile_count": self.compile_count,
            "kernel_loads": sum(kernels.LOADS.values()),
            "bucket_compile_ms": dict(self.bucket_compile_ms),
            "cold_start_compile_ms": self.cold_start_compile_ms,
            "corpus_rows": self.n_real,
            "capacity_rows": self.capacity_rows,
            "chunk_rows": self._ex_chunk_rows,
            "data_block": self._data_block,
            "gate_carry": self.gate_carry,
            "last_gated_fraction": self.last_gated_fraction,
            "extract_chunks": self._ex_nchunks if self._chunks_ready else 0,
            "summary_blocks": self._ex_nchunks if self._summ else 0,
            "summary_rebuilds": self.summary_rebuilds,
            "last_prune_fraction": self.last_prune_fraction,
            "last_prune": dict(lp) if isinstance(lp, dict) else None,
            "precision_plan": self._precision_plan,
            "last_precision": dict(lprec) if isinstance(lprec, dict)
            else None,
            "batch_log": list(self.batch_log),
        }
