"""Mesh-resident serving engine: the sharded corpus held resident.

Port of ``dmlp_tpu/fleet/mesh_engine.py``. :class:`MeshResidentEngine` is
to :class:`~dmlp_tpu_torch.engine.sharded.ShardedEngine` what
:class:`~dmlp_tpu_torch.serve.engine.ResidentEngine` is to the
single-device engine. One process per rank of a ("data", "query") mesh
(``parallel.mesh``), SPMD: rank 0 is the serving daemon (admission, the
micro-batcher, the float64 finalize), the other ranks run
:meth:`serve_worker`, a command loop that rank 0 drives with
``broadcast_object``. The daemon's batcher thread is the only thread that
issues a collective once the daemon serves: solves, ingests, the warm-up,
idle heartbeats and the closing command all run on it.

- **Staging.** The corpus is planned once at capacity shape: each data
  shard holds ``shard_rows`` rows in ``nchunks`` chunks of ``chunk_rows``
  (``plan_chunks(ceil(capacity / R), granule, data_block)``). Rank 0
  scatters every shard once; each rank keeps its shard in one device
  buffer whose row views are the chunks, with the shard's labels and
  global ids beside it. Global row ids are affine per piece:
  ``rr * shard_rows + t * chunk_rows + j`` (:meth:`_block_span`, the one
  derivation staging, summaries, ingest and the kernel's ``id_base`` /
  ``n_real`` share).
- **Summaries.** Rank 0 keeps the per-(shard, chunk) block summaries of
  the pruned two-stage solve on the host and scores them per micro-batch
  into an (R, T) live mask (``ops.summaries.prune_mask``); a block no
  query can reach is never launched.
- **Per micro-batch.** Rank 0 broadcasts the batch: the padded queries in
  float32, the candidate width, the live mask and the fold order (hottest
  chunks first under the gate-carry histogram, as the single-device
  resident engine orders them). Every rank folds its live pieces with K1
  (``ops.fused.fused_topk``) into running lists for its query shard; the
  lists merge over the data axis (``allgather_merge_topk``,
  ``ring_allreduce_topk`` or, for ``merge="auto"``, the "gspmd"
  ``gspmd_merge_topk``), row 0 gathers them over the query axis, and
  rank 0 finalizes in float64 with the boundary repair, so every response
  carries the golden oracle's checksums. Each rank's launches of the
  batch, its phase times and its gated tiles come back to rank 0 with one
  object gather and land in the batch's ``batch_log`` entry.
- **Wide k.** A bucket whose candidate width exceeds the kernel's one-pass
  window (512) takes the stream path on the same buffer (the monolithic
  layout: the port's chunks are views of it), the mesh engines' merged
  path: the streaming select over the whole shard (K3 under ``seg``), one
  query block at a time, then the same merge and gather.
- **Ingest.** Rank 0 validates, broadcasts the rows, and every rank copies
  the part its shard owns into its buffer; rank 0 rebuilds exactly the
  touched blocks' summaries and updates the corpus signature and the
  cached corpus norm (``dn_max``, never recomputed per batch).
- **Memory and comms.** ``mem_model`` is ``obs.memwatch.
  fleet_engine_model`` (per rank); ``last_comms`` is ``obs.comms``' model
  of the batch's merge and gather.

``merge="auto"`` is the reference's compiler-scheduled merge, the
engine-internal "gspmd" strategy: K1 still folds the resident chunks and
only the merge changes, to a DTensor redistribution of the lists from
data-sharded to query-sharded (``engine.sharded.ShardedEngine._merge``).
Its ``last_comms`` carries no merge record (``obs.comms.engine_comms``),
and its memory model prices the all-gather's buffer, the worst case.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmlp_tpu_torch import kernels
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.finalize import (boundary_overflow, finalize_host,
                                            lowp_eps,
                                            repair_boundary_overflow,
                                            staging_eps)
from dmlp_tpu_torch.engine.sharded import ShardedEngine, _labels_for_ids
from dmlp_tpu_torch.engine.single import (_BF16_AUTO_K_CAP, ChunkThrottle,
                                          MeasuredIters, fit_blocks,
                                          flush_measured_iters, host_staging,
                                          plan_chunks, resilient_get,
                                          resolve_kcap, round_up, stage)
from dmlp_tpu_torch.io.grammar import KNNInput, Params
from dmlp_tpu_torch.io.report import QueryResult
from dmlp_tpu_torch.obs import comms as obs_comms
from dmlp_tpu_torch.obs import memwatch, telemetry
from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.ops import fused
from dmlp_tpu_torch.ops import summaries as osum
from dmlp_tpu_torch.ops.topk import TopK, init_topk, streaming_topk
from dmlp_tpu_torch.parallel.collectives import (broadcast_object,
                                                 gather_objects)
from dmlp_tpu_torch.serve.engine import (CapacityError, ResidentServingCore,
                                         k_bucket, query_bucket)
from dmlp_tpu_torch.tune.cache import shape_bucket

#: merge strategies of the mesh-resident engine ("auto" is taken as the
#: engine-internal "gspmd")
MERGES = ("allgather", "ring", "gspmd")

#: a mesh replica's process-group timeout: a dead or hung rank ends the
#: replica within it, so the fleet supervisor sees the crash and relaunches
#: (shorter than ``parallel.distributed.DEFAULT_TIMEOUT_S``, which bounds
#: one-shot jobs)
GROUP_TIMEOUT_S = 60.0

#: seconds between rank 0's idle heartbeats: a quarter of the group
#: timeout, so an idle worker never reaches it
HEARTBEAT_S = GROUP_TIMEOUT_S / 4


def check_merge(merge: str) -> str:
    """The engine-internal merge strategy of ``merge`` ("auto" is
    "gspmd"); refuses a strategy the engine does not have."""
    if merge == "auto":
        merge = "gspmd"
    if merge not in MERGES:
        raise ValueError(f"unknown merge strategy {merge!r}")
    return merge


class _MeshBucket:
    """One (qpad, k-bucket) shape bucket: the candidate width and the path
    ("extract" folds the resident chunks, "stream" runs the streaming
    select over each whole shard)."""

    __slots__ = ("qpad", "kb", "kcap", "path", "qloc")

    def __init__(self, qpad: int, kb: int, kcap: int, path: str,
                 qloc: int):
        self.qpad, self.kb, self.kcap = qpad, kb, kcap
        self.path = path
        self.qloc = qloc

    @property
    def key(self) -> str:
        return f"q{self.qpad}k{self.kb}"


class MeshBrokenError(RuntimeError):
    """A collective of the mesh failed (a rank died or timed out): the
    replica cannot serve any more and its daemon must exit non-zero."""


class MeshResidentEngine(ResidentServingCore, ShardedEngine):
    """Resident engine of a mesh replica; one per rank, built in step on
    every rank (``corpus`` on rank 0, None elsewhere). Rank 0 is the
    daemon's drop-in for :class:`~dmlp_tpu_torch.serve.engine.
    ResidentEngine` (``solve_batch``, ``ingest``, ``warmup``,
    ``bucket_plan``, ``bucket_stats``, the memory hooks); the other ranks
    call :meth:`serve_worker`."""

    BATCH_LOG = 128

    def __init__(self, corpus: Optional[KNNInput],
                 config: EngineConfig = None, mesh=None,
                 capacity: Optional[int] = None, merge: str = "allgather",
                 gate_carry: bool = True):
        merge = check_merge(merge)
        cfg = config or EngineConfig(mode="sharded")
        ShardedEngine.__init__(self, cfg, mesh)
        self._merge_strategy = merge
        self.gate_carry = bool(gate_carry)
        self.broken: Optional[BaseException] = None
        self._t_command = time.monotonic()
        r, c = self.mesh.shape
        geo = None
        if self.root:
            n = corpus.params.num_data
            if n < 1:
                raise ValueError("resident corpus must have at least one "
                                 "row")
            cap = capacity or shape_bucket(n)
            if cap < n:
                raise ValueError(f"capacity {cap} < corpus rows {n}")
            geo = {"n": n, "na": corpus.params.num_attrs, "cap": cap,
                   "precision": cfg.resolve_precision()}
        geo = broadcast_object(geo)
        n, na, cap = geo["n"], geo["na"], geo["cap"]
        self.num_attrs = na
        self.n_real = n
        # First-pass precision plan, frozen at construction (rank 0's, so
        # every rank plans the same windows).
        self._precision_plan = geo["precision"]

        # -- the per-shard plan at capacity shape (fixed for life) ---------
        per_shard = max(-(-cap // r), 1)
        self._extract_ok = (cfg.use_pallas and cfg.resolve_select(
            round_up(per_shard, 8)) == "extract")
        granule = cfg.resolve_granule("extract") if self._extract_ok else 8
        self._shard_rows, self._nchunks, self._chunk_rows = plan_chunks(
            per_shard, granule, cfg.data_block)
        self.capacity_rows = r * self._shard_rows
        self._stream_select = cfg.resolve_streaming_select(
            round_up(self._shard_rows, 8))
        self._data_block = fit_blocks(
            self._shard_rows, cfg.resolve_data_block(self._stream_select),
            granule=cfg.resolve_granule(self._stream_select))
        self._stream_rows = round_up(self._shard_rows, self._data_block)
        ex_rows = self._nchunks * self._chunk_rows if self._extract_ok \
            else 0
        self._buf_rows = max(ex_rows, self._stream_rows)

        # -- rank 0's host originals (the float64 rescore reads these) -----
        if self.root:
            self._host_attrs = np.zeros((self.capacity_rows, na),
                                        np.float64)
            self._host_attrs[:n] = corpus.data_attrs
            self._host_labels = np.full(self.capacity_rows, -1, np.int32)
            self._host_labels[:n] = corpus.labels
            self._sig_init()
        self._dn_max_cache: Optional[float] = None

        # -- every rank's resident shard -------------------------------------
        self._stage_shards()

        # -- rank 0's summaries, gate state and bucket registry --------------
        self._summ = None
        self.summary_rebuilds = 0
        self.last_prune_fraction: Optional[float] = None
        self.last_gated_fraction: Optional[float] = None
        self._block_hits = np.zeros((r, max(self._nchunks, 1)), np.int64)
        if self.root and self._extract_ok:
            self._build_summaries()
        self._buckets: Dict[Tuple[int, int], _MeshBucket] = {}
        self.compile_count = 0
        self.cold_start_compile_ms: Optional[float] = None
        self.bucket_compile_ms: Dict[str, float] = {}
        self.batch_log: collections.deque = collections.deque(
            maxlen=self.BATCH_LOG)
        self.batches_solved = 0
        if self.root:
            reg = telemetry.registry()
            reg.gauge("serve.corpus_rows").set(n)
            reg.gauge("serve.capacity_rows").set(self.capacity_rows)
            reg.gauge("serve.mesh_shards").set(r)
            reg.gauge("serve.gate.carry_enabled").set(int(self.gate_carry))

    # -- resident staging ------------------------------------------------------

    def _block_span(self, rr: int, t: int) -> Tuple[int, int]:
        """Global row range of shard ``rr``'s piece of chunk ``t``."""
        lo = rr * self._shard_rows + t * self._chunk_rows
        hi = min(lo + self._chunk_rows, (rr + 1) * self._shard_rows,
                 self.n_real)
        return lo, max(hi, lo)

    def _stage_shards(self) -> None:
        """Rank 0 scatters each shard (float64, so every rank casts to the
        staging dtype from the same values the single engine casts); each
        rank stages its own into the resident buffer."""
        r, c = self.mesh.shape
        sr, na = self._shard_rows, self.num_attrs
        attrs = labels = None
        if self.root:
            attrs, labels = self._host_attrs, self._host_labels
        with obs_span("fleet.stage_resident", chunks=self._nchunks,
                      mesh=[r, c]):
            a_sh = self._scatter_rows(attrs, sr, (na,), torch.float64)
            l_sh = self._scatter_rows(labels, sr, (), torch.int32)
            rows = self._buf_rows
            host = np.zeros((rows, na), np.float64)
            host[:sr] = a_sh.cpu().numpy()
            lab = np.full(rows, -1, np.int32)
            lab[:sr] = l_sh.cpu().numpy()
            base = self.coords[0] * sr
            ids = np.full(rows, -1, np.int32)
            real = max(min(self.n_real - base, sr), 0)
            ids[:real] = np.arange(base, base + real, dtype=np.int32)
            dev = self.device
            self._buf = host_staging(host, dev, self._staging).to(dev)
            self._d_labels = torch.from_numpy(lab).to(dev)
            self._d_ids = torch.from_numpy(ids).to(dev)

    def _chunk(self, t: int) -> torch.Tensor:
        cr = self._chunk_rows
        return self._buf[t * cr:(t + 1) * cr]

    # -- rank 0's resident summaries ---------------------------------------------

    def _block_ranges(self) -> List[Tuple[int, int]]:
        r = self.mesh.shape[0]
        return [self._block_span(rr, t)
                for rr in range(r) for t in range(self._nchunks)]

    def _build_summaries(self) -> None:
        r = self.mesh.shape[0]
        if r * self._nchunks <= 1 or not osum.prune_enabled():
            return
        with obs_span("fleet.summary_build", blocks=r * self._nchunks):
            self._summ = osum.build_summaries(self._host_attrs,
                                              self._block_ranges())
        telemetry.registry().gauge("prune.summary_blocks").set(
            r * self._nchunks)

    def _rebuild_summary_blocks(self, blocks) -> None:
        """Rebuild exactly the touched (shard, chunk) blocks' summaries
        from their current host rows (a stale one could keep a block
        pruned whose new rows belong in a top-k)."""
        if self._summ is None:
            return
        blocks = list(blocks)
        for rr, t in blocks:
            lo, hi = self._block_span(rr, t)
            osum.update_block(self._summ, rr * self._nchunks + t,
                              self._host_attrs[lo:hi], lo_hi=(lo, hi))
        self.summary_rebuilds += len(blocks)
        telemetry.registry().counter("prune.summary_rebuilds").inc(
            len(blocks))

    def _prune_live(self, inp: KNNInput):
        """Stage 1 per micro-batch on rank 0: the (R, T) live mask and its
        stats, or (None, None) for a dense fold."""
        if (self._summ is None or not self.config.exact
                or not osum.prune_enabled()
                or inp.params.num_queries == 0):
            return None, None
        r = self.mesh.shape[0]
        with obs_span("fleet.prune_score", blocks=r * self._nchunks,
                      **self._rid_args()):
            keep, stats = osum.prune_mask(inp.query_attrs, inp.ks,
                                          self._summ, staging=self._staging,
                                          precision=self._active_prec())
        self.last_prune_fraction = stats["pruned_fraction"]
        return keep.reshape(r, self._nchunks), stats

    # -- shape buckets -----------------------------------------------------------

    @property
    def query_granule(self) -> int:
        if self._extract_ok:
            from dmlp_tpu_torch.ops.extract import QUERY_TILE
            return QUERY_TILE
        return 8

    @property
    def max_k(self) -> int:
        cap = self.capacity_rows
        if self._staging == "bfloat16":
            cap = min(cap, _BF16_AUTO_K_CAP)
        return cap

    def bucket_shape(self, nq: int, kmax: int) -> Tuple[int, int]:
        c = self.mesh.shape[1]
        qloc = query_bucket(max(-(-max(nq, 1) // c), 1),
                            self.query_granule)
        return (c * qloc, k_bucket(kmax))

    def _kcap_for(self, kb: int) -> int:
        return resolve_kcap(self.config, kb, "extract", self.capacity_rows,
                            staging=self._staging,
                            precision=self._precision_plan)

    def bucket_plan(self, nq: int, kmax: int) -> Tuple[int, int, int]:
        """(qpad, k-bucket, kcap): the one candidate-width derivation
        admission and the memory model share with the solve."""
        qpad, kb = self.bucket_shape(nq, kmax)
        return qpad, kb, self._kcap_for(kb)

    def _active_prec(self) -> str:
        """The batch's first-pass precision: the configured one (the
        environment's kill switch read per call) clamped to the plan. The
        mesh engines have no degradation ladder."""
        prec = self.config.resolve_precision()
        return prec if prec == self._precision_plan == "bf16" else "f32"

    def _build_bucket(self, qpad: int, kb: int) -> _MeshBucket:
        c = self.mesh.shape[1]
        qloc = qpad // c
        kcap = self._kcap_for(kb)
        path = "stream"
        if self._extract_ok and kcap <= 512:
            kern, _ = fused.resolve_topk_kernel(
                qloc, self._chunk_rows, self.num_attrs, kcap)
            if kern is not None:
                path = "extract"
        return _MeshBucket(qpad, kb, kcap, path, qloc)

    # -- the command loop (SPMD) -------------------------------------------------

    def _command(self, cmd: Optional[Dict[str, Any]]):
        """Rank 0 sends ``cmd`` to every rank (the others receive it); a
        failed collective marks the mesh broken for good."""
        if self.broken is not None:
            raise MeshBrokenError(f"the mesh is broken: {self.broken}")
        try:
            out = broadcast_object(cmd)
        except Exception as e:  # a dead or hung rank: recorded, re-raised
            self._mark_broken(e)
            raise MeshBrokenError(f"mesh command failed: {e}") from e
        self._t_command = time.monotonic()
        return out

    def _mark_broken(self, exc: BaseException) -> None:
        if self.broken is None:
            self.broken = exc
            telemetry.flight_event("fleet.mesh.broken",
                                   error=f"{type(exc).__name__}: {exc}")

    def _spmd(self, fn, *args):
        """Run one SPMD step; a collective failure inside it marks the
        mesh broken."""
        try:
            return fn(*args)
        except Exception as e:
            if self.root:
                self._mark_broken(e)
                raise MeshBrokenError(f"mesh step failed: {e}") from e
            raise

    def serve_worker(self) -> None:
        """Every rank but 0: execute rank 0's commands until it sends
        "close". A failed collective (rank 0 gone, or the group's timeout)
        raises, and the worker process exits non-zero."""
        while True:
            cmd = broadcast_object(None)
            op = cmd["op"]
            if op == "close":
                return
            if op == "solve":
                self._solve_step(cmd)
            elif op == "ingest":
                self._ingest_local(cmd["labels"], cmd["attrs"],
                                   cmd["at"])
                _ack()
            elif op == "ping":
                _ack()

    def idle(self) -> None:
        """The batcher's idle hook on rank 0: a heartbeat command when no
        command went out for ``HEARTBEAT_S``, so a worker blocked on the
        next command never reaches the group timeout, and a dead worker
        is found while the daemon idles."""
        if time.monotonic() - self._t_command >= HEARTBEAT_S:
            self._command({"op": "ping"})
            # A broadcast's root only sends; the acknowledgement is what
            # finds a dead worker.
            self._spmd(_ack)

    def close(self) -> None:
        """Rank 0: release the workers (their loop returns and they leave
        the group). Nothing is sent when the mesh is broken."""
        if self.root and self.broken is None \
                and torch.distributed.get_world_size() > 1:
            self._command({"op": "close"})

    # -- resident solves (every rank) ---------------------------------------------

    def _phase(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self._step_ms[name] = self._step_ms.get(name, 0.0) \
            + (now - t0) * 1e3
        return now

    def _solve_step(self, cmd: Dict[str, Any]):
        """One micro-batch on this rank: fold (or stream) its shard for its
        query shard, merge over the data axis, gather over the query axis.
        Returns rank 0's gathered lists and every rank's step record (None
        elsewhere)."""
        r, c = self.mesh.shape
        rr, cc = self.coords
        qloc, k = cmd["qloc"], cmd["kcap"]
        self._step_ms: Dict[str, float] = {}
        launches = dict(kernels.LAUNCHES)
        variants = {kk: dict(v) for kk, v in kernels.LAUNCH_VARIANTS.items()}
        t0 = time.perf_counter()
        q_host = cmd["q"][cc * qloc:(cc + 1) * qloc]
        q_dev = stage(host_staging(q_host, self.device, self._staging),
                      self.device)
        t0 = self._phase("stage", t0)
        gated = tiles = 0
        if cmd["path"] == "extract":
            top, gated, tiles = self._fold_chunks(cmd, q_dev)
        else:
            top = self._stream_shard(cmd, q_dev)
        self._sync()
        t0 = self._phase("fold", t0)
        with obs_span("fleet.merge", mesh=[r, c], kc=k, **self._rid_args()):
            merged = self._merge(top, k)
            self._sync()
        t0 = self._phase("merge", t0)
        with obs_span("fleet.gather", mesh=[r, c], **self._rid_args()):
            out = self._gather(merged)
        self._phase("gather", t0)
        step = {"rank": self.rank, "coords": [rr, cc],
                "launches": {kk: v - launches.get(kk, 0)
                             for kk, v in kernels.LAUNCHES.items()},
                "launch_variants": _variant_delta(variants),
                "kernel_loads": sum(kernels.LOADS.values()),
                "phase_ms": dict(self._step_ms),
                "gated": int(gated), "tiles": int(tiles)}
        steps = gather_objects(step)
        return out, steps

    def _fold_chunks(self, cmd: Dict[str, Any], q_dev: torch.Tensor):
        """The extract path on this rank: K1 over its live resident pieces
        in rank 0's order, at each piece's global ``id_base`` and real
        row count."""
        rr = self.coords[0]
        k, qloc = cmd["kcap"], cmd["qloc"]
        kern, impl = fused.resolve_topk_kernel(
            qloc, self._chunk_rows, self.num_attrs, k)
        od = oi = None
        gz = None
        tiles = 0
        throttle = ChunkThrottle(self.device)
        mi = MeasuredIters(self, impl, (qloc, self._chunk_rows,
                                        self.num_attrs, k))
        self.last_extract_impl = impl
        with obs_span("fleet.solve_resident", qloc=qloc, kcap=k,
                      chunks=self._nchunks, scheduled=len(cmd["order"]),
                      impl=impl, carry=self.gate_carry, **self._rid_args()):
            for t in cmd["order"]:
                live = cmd["live"]
                if live is not None and not live[rr][t]:
                    continue
                lo, hi = self._block_span(rr, t)
                if hi <= lo:
                    continue
                od, oi, iters = kern(q_dev, self._chunk(t), od, oi,
                                     n_real=hi - lo, id_base=lo, kc=k,
                                     precision=cmd["precision"])
                mi.add(iters)
                z = (iters == 0).sum()
                gz = z if gz is None else gz + z
                tiles += iters.numel()
                throttle.tick()
            mi.done()
        if od is None:          # every piece of this shard pruned or empty
            empty = init_topk(qloc, k, self.device)
            od, oi = empty.dists, empty.ids
        base = rr * self._shard_rows
        top = TopK(od, _labels_for_ids(oi, self._d_labels, base), oi)
        return top, (0 if gz is None else int(gz.item())), tiles

    def _stream_shard(self, cmd: Dict[str, Any],
                      q_dev: torch.Tensor) -> TopK:
        """The stream path on this rank: the streaming select over the
        whole shard, one query block at a time."""
        qloc, k = cmd["qloc"], cmd["kcap"]
        rows = self._stream_rows
        d, lab, ids = (self._buf[:rows], self._d_labels[:rows],
                       self._d_ids[:rows])
        qb = min(1 << max(min(self.config.query_block, qloc).bit_length()
                          - 1, 3), qloc)
        with obs_span("fleet.solve_stream", qloc=qloc, kcap=k,
                      **self._rid_args()):
            outs = [streaming_topk(q_dev[b:b + qb], d, lab, ids, k,
                                   self._data_block, self._stream_select,
                                   self.config.use_pallas)
                    for b in range(0, qloc, qb)]
        return TopK(*(torch.cat(p) for p in zip(*outs)))

    # -- the serving entry (rank 0) -----------------------------------------------

    def _batch_input(self, query_attrs: np.ndarray,
                     ks: np.ndarray) -> KNNInput:
        nq = len(ks)
        return KNNInput(
            Params(self.n_real, nq, self.num_attrs),
            self._host_labels[:self.n_real],
            self._host_attrs[:self.n_real],
            np.asarray(ks, np.int32),
            np.asarray(query_attrs, np.float64))

    def _chunk_order(self) -> List[int]:
        """Fold order over the resident chunks: one permutation of t for
        every shard, by the chunks' across-shard winner counts (hottest
        first, stable) with gate carry on, natural otherwise."""
        with obs_span("fleet.fold_schedule", chunks=self._nchunks,
                      carry=self.gate_carry, **self._rid_args()):
            if not self.gate_carry:
                return list(range(self._nchunks))
            heat = self._block_hits.sum(axis=0)[:self._nchunks]
            return [int(t) for t in np.argsort(-heat, kind="stable")]

    def solve_batch(self, query_attrs, ks) -> List[QueryResult]:
        """One coalesced micro-batch over the mesh: bucket, broadcast, fold
        or stream on every rank, merge, gather, then the float64 finalize
        and boundary repair on rank 0. Results carry query ids 0..nq-1 in
        batch order."""
        inp = self._batch_input(np.asarray(query_attrs, np.float64),
                                np.asarray(ks, np.int32))
        n = self.n_real
        nq = inp.params.num_queries
        kmax = int(inp.ks.max()) if nq else 1
        self.last_phase_ms = {}
        self.last_prune = None
        self.last_prune_fraction = None
        self.last_extract_impl = None
        self._pending_iters = []
        prec = self._active_prec()
        self.last_precision = {"active": prec,
                               "configured": self._precision_plan}
        memwatch.note_engine_model(self, inp)
        entry = self._bucket_entry(nq, kmax)
        r, c = self.mesh.shape
        t0 = time.perf_counter()
        q = np.zeros((entry.qpad, self.num_attrs), np.float32)
        q[:nq] = inp.query_attrs
        cmd = {"op": "solve", "q": q, "qloc": entry.qloc,
               "kcap": entry.kcap, "path": entry.path, "precision": prec,
               "order": None, "live": None}
        stats = None
        if entry.path == "extract":
            keep, stats = self._prune_live(inp)
            cmd["order"] = self._chunk_order()
            cmd["live"] = None if keep is None else keep.tolist()
        self.last_phase_ms["plan"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        self._command(cmd)
        self.last_phase_ms["broadcast"] = (time.perf_counter() - t0) * 1e3
        top, steps = self._spmd(self._solve_step, cmd)
        for name, ms in self._step_ms.items():
            self.last_phase_ms[name] = ms
        self._note_scan(entry, cmd, stats)
        self.last_comms = (obs_comms.engine_comms(
            self._merge_strategy, (r, c), entry.qloc, entry.kcap)
            + obs_comms.gather_comms((r, c), entry.qloc, entry.kcap))
        telemetry.sample_memory_now()
        self.last_repairs = 0
        t0 = time.perf_counter()
        with obs_span("fleet.fetch", **self._rid_args()):
            od, ol, oi = resilient_get([top.dists, top.labels, top.ids],
                                       site="sharded.fetch")
        dists = np.asarray(od, np.float64)[:nq]
        labels, ids = ol[:nq], oi[:nq]
        t0 = self._phase_root("fetch", t0)
        with obs_span("fleet.finalize", exact=self.config.exact,
                      **self._rid_args()):
            results = finalize_host(dists, labels, ids, inp.ks,
                                    inp.query_attrs, inp.data_attrs,
                                    exact=self.config.exact)
            if dists.shape[1] < n:
                # The merged kcap-th bounds every shard's horizon, so the
                # eps-widened boundary test covers per-shard truncation.
                dn_max = self._dn_max()
                qn = np.einsum("qa,qa->q", inp.query_attrs,
                               inp.query_attrs)
                eps = staging_eps(dists[:, -1], qn, dn_max, self._staging,
                                  self.num_attrs)
                if prec == "bf16" and entry.path == "extract":
                    eps = eps + lowp_eps("bf16", qn, dn_max)
                suspects = np.nonzero(boundary_overflow(dists, inp.ks,
                                                        eps))[0]
                if suspects.size:
                    repair_boundary_overflow(results, suspects, inp)
                    self.last_repairs += int(suspects.size)
        self._phase_root("finalize", t0)
        flush_measured_iters(self)
        self._after_batch(results, steps)
        self._log_batch(entry, nq, cmd["live"], steps)
        return results

    def _phase_root(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.last_phase_ms[name] = (now - t0) * 1e3
        return now

    def _note_scan(self, entry: _MeshBucket, cmd: Dict[str, Any],
                   stats) -> None:
        """Rank 0's scan accounting of the batch over every shard."""
        item = self._itemsize()
        na = self.num_attrs
        dense = self.n_real * na * item
        if entry.path != "extract":
            osum.note_scan(self, scanned_bytes=dense, dense_bytes=dense,
                           blocks_total=self.mesh.shape[0],
                           blocks_pruned=0)
            return
        live = cmd["live"]
        scanned = nonempty = 0
        for rr in range(self.mesh.shape[0]):
            for t in range(self._nchunks):
                lo, hi = self._block_span(rr, t)
                nonempty += hi > lo
                if live is None or live[rr][t]:
                    scanned += (hi - lo) * na * item
        osum.note_scan(self, scanned_bytes=scanned, dense_bytes=dense,
                       blocks_total=(stats or {}).get("blocks_total",
                                                      nonempty),
                       blocks_pruned=(stats or {}).get("blocks_pruned", 0))

    def _after_batch(self, results: List[QueryResult], steps) -> None:
        """The gate statistics summed over ranks, and each winner row's
        owning (shard, chunk) block credited in the carried histogram."""
        gated = sum(s["gated"] for s in steps)
        tiles = sum(s["tiles"] for s in steps)
        if tiles:
            frac = gated / tiles
            self.last_gated_fraction = frac
            reg = telemetry.registry()
            reg.gauge("serve.gate.gated_fraction").set(round(frac, 6))
            reg.counter("serve.gate.tiles_total").inc(tiles)
            reg.counter("serve.gate.tiles_gated").inc(gated)
        if self.gate_carry and self._nchunks and results:
            ids = np.concatenate(
                [np.asarray(q.neighbor_ids, np.int64) for q in results])
            ids = ids[ids >= 0]
            if ids.size:
                r = self.mesh.shape[0]
                rr = ids // self._shard_rows
                t = np.minimum((ids - rr * self._shard_rows)
                               // self._chunk_rows, self._nchunks - 1)
                hits = np.bincount(rr * self._nchunks + t,
                                   minlength=r * self._nchunks)
                self._block_hits += hits.reshape(r, self._nchunks)

    def _log_batch(self, entry: _MeshBucket, nq: int, live,
                   steps) -> None:
        lp = self.last_prune
        self.batches_solved += 1
        self.batch_log.append({
            "seq": self.batches_solved, "bucket": entry.key,
            "path": entry.path, "qpad": entry.qpad, "qloc": entry.qloc,
            "kcap": entry.kcap, "nq": nq, "n_real": self.n_real,
            "rung": "fused", "repairs": self.last_repairs,
            "blocks_pruned": lp.get("blocks_pruned") if lp else None,
            # The (R, T) live mask the ranks folded by (None: every
            # non-empty piece).
            "live": live,
            "gated_fraction": self.last_gated_fraction,
            "phase_ms": dict(self.last_phase_ms),
            # Every rank's launches, in rank order; "launches" sums them.
            "launches": {kk: sum(s["launches"].get(kk, 0) for s in steps)
                         for kk in kernels.LAUNCHES},
            "launches_by_rank": [s["launches"] for s in steps],
            "launch_variants_by_rank": [s["launch_variants"]
                                        for s in steps],
            "phase_ms_by_rank": [s["phase_ms"] for s in steps],
            "kernel_loads_by_rank": [s["kernel_loads"] for s in steps]})

    # -- ingest ----------------------------------------------------------------------

    def ingest(self, labels, attrs, start: Optional[int] = None) -> int:
        """Write rows behind the row count (rank 0): ``start=None``
        appends; ``start <= n_real`` is the idempotent row-write by global
        row id that the consistency repair replays. Every rank copies the
        part its shard owns; rank 0 rebuilds the touched blocks'
        summaries and updates the signature."""
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
        if end > self.capacity_rows:
            raise CapacityError(
                f"ingest of {m} rows at {at} exceeds capacity "
                f"{self.capacity_rows} (resident: {self.n_real})")
        new_n = max(self.n_real, end)
        with obs_span("fleet.ingest", rows=m, corpus_rows=new_n):
            self._command({"op": "ingest", "labels": labels,
                           "attrs": attrs, "at": at})
            self._spmd(self._ingest_local, labels, attrs, at)
            self._spmd(_ack)
            self._host_attrs[at:end] = attrs
            self._host_labels[at:end] = labels
            self._note_ingested_norms(attrs)
            self._sig_update(at, end)
            self._rebuild_summary_blocks(self._touched(at, end))
        reg = telemetry.registry()
        reg.counter("serve.ingested_rows").inc(m)
        reg.gauge("serve.corpus_rows").set(new_n)
        return new_n

    def _touched(self, at: int, end: int) -> List[Tuple[int, int]]:
        """The (shard, chunk) blocks rows ``[at, end)`` fall in, by block
        arithmetic."""
        sr, cr = self._shard_rows, self._chunk_rows
        out = []
        for rr in range(self.mesh.shape[0]):
            lo, hi = max(at, rr * sr), min(end, (rr + 1) * sr)
            if hi <= lo:
                continue
            t_lo = (lo - rr * sr) // cr
            t_hi = (hi - 1 - rr * sr) // cr
            out.extend((rr, min(t, self._nchunks - 1))
                       for t in range(t_lo, t_hi + 1))
        return sorted(set(out))

    def _ingest_local(self, labels: np.ndarray, attrs: np.ndarray,
                      at: int) -> None:
        """Every rank: the rows of ``[at, at + m)`` its shard owns into its
        resident buffer, labels and ids; then the global row count."""
        end = at + len(labels)
        sr = self._shard_rows
        base = self.coords[0] * sr
        lo, hi = max(at, base), min(end, base + sr)
        if hi > lo:
            dev = self.device
            self._buf[lo - base:hi - base].copy_(
                host_staging(attrs[lo - at:hi - at], dev, self._staging),
                non_blocking=True)
            self._d_labels[lo - base:hi - base].copy_(
                torch.from_numpy(np.ascontiguousarray(
                    labels[lo - at:hi - at])))
            self._d_ids[lo - base:hi - base].copy_(
                torch.arange(lo, hi, dtype=torch.int32))
        self.n_real = max(self.n_real, end)

    # -- memory-model hooks ----------------------------------------------------------

    def mem_model(self, nq: int = 0, kmax: int = 0) -> Dict[str, object]:
        """Per-rank model (``obs.memwatch.fleet_engine_model``) at this
        engine's own bucket_plan; batch terms iff ``nq > 0``."""
        r, c = self.mesh.shape
        qloc = kcap = 0
        if nq > 0:
            qpad, _kb, kcap = self.bucket_plan(nq, max(kmax, 1))
            qloc = qpad // c
        return memwatch.fleet_engine_model(
            mesh_shape=(r, c), shard_rows=self._shard_rows,
            na=self.num_attrs, staging=self._staging,
            resident_rows=self._buf_rows, qloc=qloc, kcap=kcap,
            merge=self._merge_strategy)

    def batch_model_bytes(self, nq: int, kmax: int) -> int:
        """Marginal per-rank bytes of one micro-batch: the query shard,
        the local lists and the merge buffer."""
        terms = self.mem_model(nq, kmax)["terms"]
        return int(terms.get("query_shard", 0)
                   + terms.get("local_topk", 0)
                   + terms.get("merge_buffer", 0))

    def resident_state_key(self):
        # The floor never moves: the shard buffer is staged once.
        return (self._buf_rows,)

    # -- introspection -------------------------------------------------------------

    def bucket_stats(self) -> Dict[str, object]:
        entries = list(self._buckets.values())
        lp = self.last_prune
        lprec = self.last_precision
        r, c = self.mesh.shape
        return {
            "buckets": sorted(e.key for e in entries),
            "paths": {e.key: e.path for e in entries},
            "hlo_schedule": {},
            "compile_count": self.compile_count,
            "kernel_loads": sum(kernels.LOADS.values()),
            "bucket_compile_ms": dict(self.bucket_compile_ms),
            "cold_start_compile_ms": self.cold_start_compile_ms,
            "corpus_rows": self.n_real,
            "capacity_rows": self.capacity_rows,
            "chunk_rows": self._chunk_rows,
            "data_block": self._data_block,
            "gate_carry": self.gate_carry,
            "last_gated_fraction": self.last_gated_fraction,
            "extract_chunks": self._nchunks if self._extract_ok else 0,
            "summary_blocks": r * self._nchunks if self._summ else 0,
            "summary_rebuilds": self.summary_rebuilds,
            "last_prune_fraction": self.last_prune_fraction,
            "last_prune": dict(lp) if isinstance(lp, dict) else None,
            "precision_plan": self._precision_plan,
            "last_precision": dict(lprec) if isinstance(lprec, dict)
            else None,
            "mesh": [r, c],
            "merge": self._merge_strategy,
            "backend": self.backend,
            "shard_rows": self._shard_rows,
            "batch_log": list(self.batch_log),
        }


def _ack() -> None:
    """Every rank's acknowledgement of a command (a barrier): the round
    trip that fails, or times out, when a rank is gone."""
    if torch.distributed.get_world_size() > 1:
        torch.distributed.barrier()


def _variant_delta(before: Dict[str, Dict[int, int]]
                   ) -> Dict[str, Dict[str, int]]:
    """Launches by split count since ``before`` (string keys: the record
    travels as JSON)."""
    out: Dict[str, Dict[str, int]] = {}
    for k, per in kernels.LAUNCH_VARIANTS.items():
        d = {str(s): n - before.get(k, {}).get(s, 0)
             for s, n in per.items()}
        d = {s: n for s, n in d.items() if n}
        if d:
            out[k] = d
    return out
