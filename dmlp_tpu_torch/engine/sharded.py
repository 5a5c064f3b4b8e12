"""2D-mesh sharded KNN engines — port of ``dmlp_tpu/engine/sharded.py``.

The reference program runs one rank per cell of a 2D grid: rank 0 reads
the input and scatters the data rows over the grid's rows and the queries
over its columns, every rank runs the local hot loop on its (data shard x
query shard) tile, the candidates merge across each column, and rank 0
finalizes. Here every rank of a ``torch.distributed`` process group holds
one engine for its (r, c) cell of the ("data", "query") ``DeviceMesh``
(``parallel.mesh``) and calls the same method in step (SPMD): rank 0 with
the parsed input, the others with None.

1. Rank 0 plans the solve (the path, chunking, kernel, candidate width,
   the router's split and the prune mask) and broadcasts the plan.
2. Rank 0 scatters each data-axis row shard and each query-axis query
   shard (the ``Scatterv`` analog, inside the timed region).
3. Every rank folds its row shard into running lists for its query shard:
   chunk by chunk with K1 (``ops.fused.fused_topk``, or K2
   ``ops.extract.extract_topk`` under ``DMLP_TPU_FUSED=0``) and the
   shard's ``id_base`` / ``n_real``, and the router's wide-k outliers
   through the "seg" fold (K3 under ``--pallas``) on the same staged
   chunks; or, where the extraction kernel does not apply, through the
   streaming select on the whole shard.
4. The lists merge across the data axis: ``ShardedEngine`` by all-gather,
   ``RingEngine`` by a ring all-reduce, and the "gspmd" strategy (the
   compiler-sharded engine, ``engine.auto``, and the fleet's
   ``merge="auto"``) by a DTensor redistribution (``parallel.
   collectives``).
5. Row 0 gathers the merged lists over the query axis to rank 0, which
   finalizes in float64 and repairs the boundary hazards with the full
   input (``engine.finalize``), as the single-device engine does.

Rank 0's ``last_phase_ms`` splits the solve: ``prune`` (scoring),
``stage_enqueue`` (plan broadcast, scatter and staging of the query
shards), ``fold`` (its own shard's launches, to the device's end),
``merge``, ``gather``, ``fetch`` and ``finalize``. The mesh engines have
no degradation ladder, as in the reference.

Observability (``dmlp_tpu_torch.obs``): the reference's spans by the
reference's names (``sharded.prune_score``, ``sharded.stage_enqueue``,
``sharded.enqueue_chunked``, ``sharded.merge``, ``sharded.solve_merge``,
``sharded.solve_local_shards``, ``sharded.fetch``, ``sharded.finalize``,
``sharded.device_full``) plus ``sharded.gather``; ``last_comms``, the
analytic traffic of the solve's collectives (``obs.comms``: the root's
scatters, the data-axis merge, the query-axis gather), the same on every
rank; the memory model on rank 0; and with a cost probe installed each
rank's K1/K2 ``iters``, read back once after the solve.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from dmlp_tpu_torch.check.sanitize import fenced
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.finalize import (boundary_overflow, finalize_host,
                                            lowp_eps,
                                            repair_boundary_overflow,
                                            staging_eps)
from dmlp_tpu_torch.engine.single import (ChunkThrottle, MeasuredIters,
                                          _device_epilogue, fit_blocks,
                                          flush_measured_iters, hetk_split,
                                          plan_chunks, resilient_get,
                                          resolve_kcap, round_up)
from dmlp_tpu_torch.io.grammar import KNNInput, subset_queries
from dmlp_tpu_torch.io.report import QueryResult
from dmlp_tpu_torch.obs import comms as obs_comms
from dmlp_tpu_torch.obs import memwatch, telemetry
from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.ops.summaries import (build_summaries, note_scan,
                                          prune_enabled, prune_mask)
from dmlp_tpu_torch.ops.topk import (TopK, init_topk, make_block_step,
                                     select_topk, streaming_fallback,
                                     streaming_topk)
from dmlp_tpu_torch.parallel.collectives import (allgather_merge_topk, move,
                                                 broadcast_object,
                                                 gather_topk,
                                                 gspmd_merge_topk,
                                                 ring_allreduce_topk,
                                                 scatter_from_root)
from dmlp_tpu_torch.parallel.distributed import rank_device
from dmlp_tpu_torch.parallel.mesh import (DATA_AXIS, QUERY_AXIS, make_mesh,
                                          mesh_coords)
from dmlp_tpu_torch.resilience import inject as rs_inject
from dmlp_tpu_torch.resilience import retry as rs_retry


def _chunk_span(n: int, shard: int, shard_rows: int, toff: int,
                ck: int):
    """(id_base, n_real) of shard ``shard``'s chunk at offset ``toff``.
    Caps the real rows at BOTH the dataset's end and the shard's boundary:
    plan_chunks may overshoot (nchunks * chunk_rows > shard_rows), and an
    uncapped tail would fold the next shard's first rows again — duplicate
    candidates after the merge. The bulk and the outlier folds share it,
    so the cap cannot differ between them."""
    id_base = shard * shard_rows + toff
    n_real = min(max(min(n - id_base, shard_rows - toff), 0), ck)
    return id_base, n_real


def _tile(n: int, target: int, granule: int) -> int:
    """Largest granule-multiple divisor of n that is <= target (n itself
    if none exists)."""
    t = min(target, n)
    t -= t % granule
    while t >= granule:
        if n % t == 0:
            return t
        t -= granule
    return n


def _kernel(impl: str):
    from dmlp_tpu_torch.ops.extract import extract_topk
    from dmlp_tpu_torch.ops.fused import fused_topk
    return fused_topk if impl == "fused" else extract_topk


def _labels_for_ids(ids: torch.Tensor, labels: torch.Tensor,
                    base: int) -> torch.Tensor:
    """Labels of the global ids ``ids`` from a shard's labels starting at
    global row ``base`` (-1 stays -1)."""
    nl = labels.shape[0]
    local = torch.clamp(ids.long() - base, 0, max(nl - 1, 0))
    return torch.where(ids >= 0, labels[local], -1).to(torch.int32)


class ShardedEngine:
    """All-gather-merge engine over a 2D ("data", "query") mesh; one per
    rank, all ranks calling the same methods in step."""

    _merge_strategy = "allgather"
    _fetch_site = "sharded.fetch"

    def __init__(self, config: EngineConfig = EngineConfig(mode="sharded"),
                 mesh=None):
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh(
            config.mesh_shape)
        self.device = rank_device(config.device)
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.coords = mesh_coords(self.mesh)
        self._data_group = self.mesh.get_group(DATA_AXIS)
        self._query_group = self.mesh.get_group(QUERY_AXIS)
        self._staging = config.resolve_dtype()
        # The mesh engines have no degradation ladder: the kernel
        # selector sees the "fused" rung, as the reference's does.
        self._degrade_rung = "fused"
        self._last_select = None
        self.last_phase_ms: dict = {}
        self.last_hetk = None       # (bulk, outlier) counts when routed
        self.last_extract_impl = None
        self.last_prune = None
        self.last_precision = None
        self.last_repairs = 0
        self.last_comms: list = []
        self.last_mem_model = None
        self._pending_iters: list = []

    @property
    def root(self) -> bool:
        return self.rank == 0

    def _itemsize(self) -> int:
        return 2 if self._staging == "bfloat16" else 4

    def _staging_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self._staging == "bfloat16" \
            else torch.float32

    def _merge(self, top: TopK, k: int) -> TopK:
        """The cross-shard merge of this engine (data axis)."""
        if self._merge_strategy == "allgather":
            return allgather_merge_topk(top, k, self._data_group)
        if self._merge_strategy == "gspmd":
            return gspmd_merge_topk(top, k, self.mesh)
        return ring_allreduce_topk(top, k, self._data_group)

    def _gather(self, top: TopK) -> Optional[TopK]:
        """Row 0 gathers the merged lists over the query axis to rank 0."""
        if self.coords[0] != 0:
            return None
        return gather_topk(top, self._query_group, dst=0)

    def _staged(self, t: torch.Tensor, rows: int) -> torch.Tensor:
        """``t`` (a received shard) zero-padded to ``rows`` rows in the
        staging dtype, where the chunk loop slices it: pinned host memory
        when it lies on the host and the ranks compute on the card."""
        out = torch.zeros((rows,) + tuple(t.shape[1:]),
                          dtype=self._staging_dtype(), device=t.device)
        out[:t.shape[0]] = t
        if out.device.type == "cpu" and self.device.type == "cuda":
            out = out.pin_memory()
        return out

    def _scatter_rows(self, full: Optional[np.ndarray], shard_rows: int,
                      trailing, dtype):
        """Scatter row shard r of ``full`` (rank 0's (R * shard_rows, ...)
        array) to every rank of mesh row r."""
        r, c = self.mesh.shape
        parts = None if full is None else [
            full[(i // c) * shard_rows:(i // c + 1) * shard_rows]
            for i in range(r * c)]
        return scatter_from_root(parts, (shard_rows, *trailing), dtype,
                                 self.device)

    def _scatter_queries(self, queries: Optional[np.ndarray], qloc: int,
                         na: int) -> torch.Tensor:
        """Scatter query shard c (``qloc`` rows, zero-padded) to every rank
        of mesh column c; returns it staged on this rank's device."""
        r, c = self.mesh.shape
        parts = None
        if queries is not None:
            q = np.zeros((c * qloc, na), np.float32)
            q[:len(queries)] = queries
            parts = [q[(i % c) * qloc:(i % c + 1) * qloc]
                     for i in range(r * c)]
        got = scatter_from_root(parts, (qloc, na), torch.float32,
                                self.device)
        return move(got.to(self._staging_dtype()), self.device,
                    "sharded.stage_queries")

    # -- planning (rank 0) ---------------------------------------------------
    def _plan_prune_mesh(self, inp: KNNInput, shard_rows: int, nchunks: int,
                         chunk_rows: int, allow_prune: bool,
                         precision: str = "f32"):
        """Stages 0 and 1 of the pruned two-stage solve for the mesh chunk
        fold: the per-(shard, chunk) survivor mask ((R, T) bool) and its
        stats, or (None, None) when pruning is off. Blocks are each shard's
        chunk-aligned row ranges — exactly what the fold covers — scored
        against every query (every data shard meets every query shard
        across the mesh's columns)."""
        n = inp.params.num_data
        r = self.mesh.shape[0]
        if (not allow_prune or not self.config.exact or n == 0
                or inp.params.num_queries == 0 or r * nchunks <= 1
                or not prune_enabled()):
            return None, None
        ranges = []
        for rr in range(r):
            for t in range(nchunks):
                lo = rr * shard_rows + t * chunk_rows
                hi = min(lo + chunk_rows, (rr + 1) * shard_rows, n)
                ranges.append((lo, max(hi, lo)))
        with obs_span("sharded.prune_score", blocks=len(ranges)):
            summ = build_summaries(inp.data_attrs, ranges)
            keep, stats = prune_mask(inp.query_attrs, inp.ks, summ,
                                     staging=self._staging,
                                     precision=precision)
        return keep.reshape(r, nchunks), stats

    def _plan_chunked(self, inp: KNNInput, routed: bool, allow_prune: bool,
                      precision: str):
        """The chunked extract plan, or None where the extraction kernel
        does not apply (the caller then plans the merged path). Returns
        (plan, split, prune stats)."""
        from dmlp_tpu_torch.ops.extract import QUERY_TILE
        from dmlp_tpu_torch.ops.fused import resolve_topk_kernel

        cfg = self.config
        n, nq, na = (inp.params.num_data, inp.params.num_queries,
                     inp.params.num_attrs)
        r, c = self.mesh.shape
        if n == 0 or nq == 0:
            return None
        gate_rows = round_up(max(-(-n // r), 1), 8)
        if cfg.resolve_select(gate_rows) != "extract":
            return None
        split = hetk_split(cfg, self._staging, inp.ks, n, gate_rows) \
            if routed else None
        idx = np.arange(nq) if split is None else split[0]
        shard_rows, nchunks, chunk_rows = plan_chunks(
            max(-(-n // r), 1), cfg.resolve_granule("extract"),
            cfg.data_block)
        qloc = round_up(max(-(-len(idx) // c), 1), QUERY_TILE)
        k = resolve_kcap(cfg, int(inp.ks[idx].max()), "extract",
                         r * shard_rows, staging=self._staging)
        kern, impl = resolve_topk_kernel(qloc, chunk_rows, na, k,
                                         rung=self._degrade_rung)
        if kern is None:
            return None
        plan = {"path": "chunked", "n": n, "na": na,
                "shard_rows": shard_rows, "nchunks": nchunks,
                "chunk_rows": chunk_rows, "qloc": qloc, "k": k,
                "impl": impl, "precision": precision, "outliers": None}
        if split is not None:
            select_out = streaming_fallback(cfg.use_pallas)
            plan["outliers"] = {
                "select": select_out,
                "k": resolve_kcap(cfg, int(inp.ks[split[1]].max()),
                                  select_out, r * shard_rows,
                                  staging=self._staging),
                "qloc": round_up(max(-(-len(split[1]) // c), 1), 8)}
        t0 = time.perf_counter()
        keep, stats = self._plan_prune_mesh(inp, shard_rows, nchunks,
                                            chunk_rows, allow_prune,
                                            precision)
        self.last_phase_ms["prune"] = (time.perf_counter() - t0) * 1e3
        plan["keep"] = None if keep is None else keep.tolist()
        return plan, split, stats

    def _plan_local(self, inp: KNNInput):
        """(select, data_block, qgran, k) of the merged path: the
        extraction kernel over each whole shard where it tiles it (query
        shards then pad to whole query tiles), else the streaming select;
        an explicit data_block pins streaming."""
        from dmlp_tpu_torch.ops.extract import QUERY_TILE
        from dmlp_tpu_torch.ops.extract import supports as ex_supports

        cfg = self.config
        n = inp.params.num_data
        r, c = self.mesh.shape
        kmax = int(inp.ks.max()) if inp.params.num_queries else 1
        shard_rows_est = round_up(max(-(-n // r), 1), 8)
        if cfg.data_block is None \
                and cfg.resolve_select(shard_rows_est) == "extract":
            sr = round_up(max(-(-n // r), 1),
                          cfg.resolve_granule("extract"))
            qb_local = round_up(max(-(-inp.params.num_queries // c), 1),
                                QUERY_TILE)
            k = resolve_kcap(cfg, kmax, "extract", sr * r,
                             staging=self._staging)
            if ex_supports(qb_local, sr, inp.params.num_attrs, k):
                return "extract", sr, QUERY_TILE, k
        select = cfg.resolve_streaming_select(shard_rows_est)
        if cfg.data_block is not None:
            data_block = min(cfg.data_block, shard_rows_est)
        else:
            data_block = fit_blocks(max(-(-n // r), 1),
                                    cfg.resolve_data_block(select),
                                    granule=cfg.resolve_granule(select))
        shard_rows = round_up(max(-(-n // r), 1), data_block)
        return select, data_block, 8, resolve_kcap(
            cfg, kmax, select, shard_rows * r, staging=self._staging)

    def _plan_merged(self, inp: KNNInput, precision: str):
        from dmlp_tpu_torch.ops.fused import resolve_topk_kernel

        select, data_block, qgran, k = self._plan_local(inp)
        r, c = self.mesh.shape
        n, nq, na = (inp.params.num_data, inp.params.num_queries,
                     inp.params.num_attrs)
        # r * round_up(ceil(n / r), b) == round_up(n, r * b): every shard
        # is whole blocks.
        shard_rows = round_up(max(n, 1), r * data_block) // r
        qloc = round_up(max(-(-nq // c), 1), qgran)
        impl = None
        if select == "extract":
            impl = resolve_topk_kernel(qloc, shard_rows, na, k,
                                       rung=self._degrade_rung)[1]
        return {"path": "merged", "select": select, "data_block": data_block,
                "k": k, "n": n, "na": na, "shard_rows": shard_rows,
                "qloc": qloc, "impl": impl,
                "precision": precision if select == "extract" else "f32"}

    # -- the solve (every rank) ----------------------------------------------
    def _solve_segments(self, inp: Optional[KNNInput], routed: bool = True,
                        allow_prune: bool = True):
        """Every rank: plan on rank 0, broadcast, solve. Returns rank 0's
        segments [(TopK, qpad, query_idx | None, select), ...] (one, or two
        when the router splits wide-k outliers off the kernel's bulk);
        the other ranks get the same list with None for each TopK."""
        self.last_hetk = None
        self.last_phase_ms = {}
        self.last_extract_impl = None
        self.last_prune = None
        self._pending_iters = []
        if inp is not None:
            memwatch.note_engine_model(self, inp)
        prec = self.config.resolve_precision()
        self.last_precision = {"active": prec, "configured": prec}
        plan = split = stats = None
        if self.root:
            got = self._plan_chunked(inp, routed,
                                     allow_prune and self.config.exact,
                                     prec)
            if got is None:
                plan = self._plan_merged(inp, prec)
            else:
                plan, split, stats = got
        t0 = time.perf_counter()
        plan = broadcast_object(plan)
        self.last_phase_ms["stage_enqueue"] = (time.perf_counter() - t0) \
            * 1e3
        self._last_select = "extract" if plan["path"] == "chunked" \
            else plan["select"]
        if plan["impl"] is not None:
            self.last_extract_impl = plan["impl"]
        self.last_comms = self._plan_comms(plan)
        if plan["path"] == "chunked":
            if split is not None:
                self.last_hetk = (int(split[0].size), int(split[1].size))
            return self._solve_chunked(inp, plan, split, stats)
        return self._solve_merged(inp, plan)

    def _plan_comms(self, plan: dict) -> list:
        """The analytic traffic of the plan's collectives (obs.comms), in
        the order the solve issues them: the root's scatters of the row
        shards and the query shards, the data-axis merge of each segment,
        row 0's query-axis gather of each segment."""
        shape = tuple(self.mesh.shape)
        outl = plan.get("outliers")
        segs = [(plan["qloc"], plan["k"])] + (
            [(outl["qloc"], outl["k"])] if outl else [])
        out = obs_comms.scatter_comms(shape, plan["shard_rows"], plan["na"],
                                      [q for q, _ in segs],
                                      with_ids=plan["path"] == "merged")
        for q, k in segs:
            out += obs_comms.engine_comms(self._merge_strategy, shape, q, k)
        for q, k in segs:
            out += obs_comms.gather_comms(shape, q, k)
        return out

    def _phase(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.last_phase_ms[name] = self.last_phase_ms.get(name, 0.0) \
            + (now - t0) * 1e3
        return now

    def _sync(self) -> None:
        if self.device.type == "cuda":
            # The phase boundary's fence is a deliberate host wait.
            with fenced("sharded.phase_sync"):
                torch.cuda.synchronize(self.device)

    def _solve_chunked(self, inp: Optional[KNNInput], plan: dict, split,
                       stats):
        """The chunked extract fold on every rank: this rank's row shard
        in ~chunk_rows pieces, each folded by the extraction kernel into
        the running (qloc, k) lists of its query shard (global ids affine
        per piece: id = r * shard_rows + toff + j, the kernel's id
        contract), and the router's outliers through the streaming fold on
        the same staged pieces. A piece that the prune mask drops, or that
        holds no real row, is never staged."""
        n, na = plan["n"], plan["na"]
        shard_rows, nchunks, ck = (plan["shard_rows"], plan["nchunks"],
                                   plan["chunk_rows"])
        qloc, k, prec = plan["qloc"], plan["k"], plan["precision"]
        outl = plan["outliers"]
        keep = plan["keep"]
        r, c = self.mesh.shape
        rr = self.coords[0]
        dev = self.device
        t0 = time.perf_counter()

        with obs_span("sharded.stage_enqueue", mesh=[r, c], path="chunked"):
            attrs = labels = None
            if self.root:
                attrs = np.zeros((r * shard_rows, na), np.float32)
                attrs[:n] = inp.data_attrs
                labels = np.full(r * shard_rows, -1, np.int32)
                labels[:n] = inp.labels
            a_sh = self._scatter_rows(attrs, shard_rows, (na,),
                                      torch.float32)
            l_sh = self._scatter_rows(labels, shard_rows, (), torch.int32)
            del attrs, labels
            q_all = None if not self.root else (
                inp.query_attrs if split is None
                else inp.query_attrs[split[0]])
            q_dev = self._scatter_queries(q_all, qloc, na)
            if outl is not None:
                qo_dev = self._scatter_queries(
                    inp.query_attrs[split[1]] if self.root else None,
                    outl["qloc"], na)
            rows = nchunks * ck
            host = self._staged(a_sh, rows)
            lab_pad = torch.full((rows,), -1, dtype=torch.int32,
                                 device=l_sh.device)
            lab_pad[:shard_rows] = l_sh
            labels_dev = move(lab_pad, dev, "sharded.stage_labels")
        t0 = self._phase("stage_enqueue", t0)

        kern = _kernel(plan["impl"])
        od = oi = None
        if outl is not None:
            ostep = make_block_step(outl["select"], outl["k"],
                                    self.config.use_pallas)
            carry_o = init_topk(outl["qloc"], outl["k"], dev)
        throttle = ChunkThrottle(dev)
        mi = MeasuredIters(self, plan["impl"], (qloc, ck, na, k))
        with obs_span("sharded.enqueue_chunked", chunks=nchunks, kc=k,
                      impl=plan["impl"]):
            for t in range(nchunks):
                if keep is not None and not keep[rr][t]:
                    continue
                toff = t * ck
                id_base, n_real = _chunk_span(n, rr, shard_rows, toff, ck)
                if n_real == 0:
                    continue
                da = host[toff:toff + ck].to(dev, non_blocking=True)
                od, oi, iters = kern(q_dev, da, od, oi, n_real=n_real,
                                     id_base=id_base, kc=k, precision=prec)
                mi.add(iters)
                if outl is not None:
                    iota = torch.arange(ck, dtype=torch.int32, device=dev)
                    bids = torch.where(iota < n_real, id_base + iota, -1)
                    carry_o = ostep(carry_o, qo_dev, da,
                                    labels_dev[toff:toff + ck], bids)
                throttle.tick()
                telemetry.sample_memory_now()
            mi.done()
            if od is None:     # every piece of this shard pruned or empty
                empty = init_topk(qloc, k, dev)
                od, oi = empty.dists, empty.ids
            base = rr * shard_rows
            top = TopK(od, _labels_for_ids(oi, labels_dev, base), oi)
            self._sync()
        t0 = self._phase("fold", t0)

        if self.root:
            self._note_chunked_scan(inp, plan, stats)
        with obs_span("sharded.merge", mesh=[r, c], kc=k):
            merged = self._merge(top, k)
            merged_o = self._merge(carry_o, outl["k"]) if outl else None
            self._sync()
        t0 = self._phase("merge", t0)
        with obs_span("sharded.gather", mesh=[r, c]):
            top_b = self._gather(merged)
            top_o = self._gather(merged_o) if outl else None
        self._phase("gather", t0)
        qpad = c * qloc
        if outl is None:
            return [(top_b, qpad, None, "extract")]
        return [(top_b, qpad, None if split is None else split[0],
                 "extract"),
                (top_o, c * outl["qloc"],
                 None if split is None else split[1], outl["select"])]

    def _note_chunked_scan(self, inp: KNNInput, plan: dict, stats) -> None:
        """Rank 0's scan accounting of a chunked solve over every shard
        (``ops.summaries.note_scan``): corpus rows staged, blocks scored
        and pruned."""
        n, na = plan["n"], plan["na"]
        shard_rows, nchunks, ck = (plan["shard_rows"], plan["nchunks"],
                                   plan["chunk_rows"])
        keep = plan["keep"]
        r = self.mesh.shape[0]
        scanned = nonempty = 0
        for rr in range(r):
            for t in range(nchunks):
                real = _chunk_span(n, rr, shard_rows, t * ck, ck)[1]
                nonempty += real > 0
                if keep is None or keep[rr][t]:
                    scanned += real * na * self._itemsize()
        note_scan(self, scanned_bytes=scanned,
                  dense_bytes=n * na * self._itemsize(),
                  blocks_total=(stats or {}).get("blocks_total", nonempty),
                  blocks_pruned=(stats or {}).get("blocks_pruned", 0))

    def _solve_shard(self, plan: dict, q: torch.Tensor, d: torch.Tensor,
                     labels: torch.Tensor, ids: torch.Tensor,
                     id_base: int, n_real: int) -> TopK:
        """One rank's (query shard x whole row shard) top-k, with no
        collective: the extraction kernel over the shard, or the
        streaming select's fold. The kernel's lists come back unsorted;
        both merges and the per-shard rescore re-select or sort them."""
        k = plan["k"]
        if plan["select"] == "extract":
            mi = MeasuredIters(self, plan["impl"], (q.shape[0], d.shape[0],
                                                    q.shape[1], k))
            od, oi, iters = _kernel(plan["impl"])(
                q, d, n_real=n_real, id_base=id_base, kc=k,
                precision=plan["precision"])
            mi.add(iters)
            mi.done()
            return TopK(od, _labels_for_ids(oi, labels, id_base), oi)
        return streaming_topk(q, d, labels, ids, k, plan["data_block"],
                              plan["select"], self.config.use_pallas)

    def _solve_merged(self, inp: Optional[KNNInput], plan: dict):
        """Whole-shard staging and one per-rank solve (no chunking), then
        the merge and the gather."""
        n, na = plan["n"], plan["na"]
        shard_rows, qloc, k = plan["shard_rows"], plan["qloc"], plan["k"]
        r, c = self.mesh.shape
        dev = self.device
        t0 = time.perf_counter()
        with obs_span("sharded.stage_enqueue", mesh=[r, c], path="merged"):
            attrs = labels = ids = None
            if self.root:
                attrs = np.zeros((r * shard_rows, na), np.float32)
                attrs[:n] = inp.data_attrs
                labels = np.full(r * shard_rows, -1, np.int32)
                labels[:n] = inp.labels
                ids = np.full(r * shard_rows, -1, np.int32)
                ids[:n] = np.arange(n, dtype=np.int32)
            a_sh = self._scatter_rows(attrs, shard_rows, (na,),
                                      torch.float32)
            l_sh = self._scatter_rows(labels, shard_rows, (), torch.int32)
            i_sh = self._scatter_rows(ids, shard_rows, (), torch.int32)
            q_dev = self._scatter_queries(
                inp.query_attrs if self.root else None, qloc, na)
            d = move(a_sh.to(self._staging_dtype()), dev,
                     "sharded.stage_rows")
            lab = move(l_sh, dev, "sharded.stage_rows")
            ids_dev = move(i_sh, dev, "sharded.stage_rows")
        if self.root:
            dense = n * na * self._itemsize()
            note_scan(self, scanned_bytes=dense, dense_bytes=dense,
                      blocks_total=r, blocks_pruned=0)
        t0 = self._phase("stage_enqueue", t0)
        # Shards hold contiguous global rows with sentinel tails, so ids
        # are affine per shard: base from the first id, count from the
        # mask.
        n_real = int(min(max(n - self.coords[0] * shard_rows, 0),
                         shard_rows))
        id_base = self.coords[0] * shard_rows

        def _op():
            rs_inject.fire("sharded.solve", which="merge")
            return self._solve_shard(plan, q_dev, d, lab, ids_dev, id_base,
                                     n_real)

        with obs_span("sharded.solve_merge", select=plan["select"],
                      mesh=[r, c], kcap=k):
            top = rs_retry.call_with_retry(_op, "sharded.solve")
            self._sync()
        t0 = self._phase("fold", t0)
        with obs_span("sharded.merge", mesh=[r, c], kc=k):
            merged = self._merge(top, k)
            self._sync()
        t0 = self._phase("merge", t0)
        with obs_span("sharded.gather", mesh=[r, c]):
            out = self._gather(merged)
        self._phase("gather", t0)
        return [(out, c * qloc, None, plan["select"])]

    # -- public API ----------------------------------------------------------
    def candidates(self, inp: Optional[KNNInput]):
        """Every rank: the dense solve (no routing, no pruning). Rank 0
        returns the (Q, K) selection-ordered candidate lists (float64
        dists, labels, ids); the others None."""
        (top, _qpad, _idx, _select), = self._solve_segments(
            inp, routed=False, allow_prune=False)
        flush_measured_iters(self)
        if not self.root:
            return None
        nq = inp.params.num_queries
        od, ol, oi = resilient_get([top.dists, top.labels, top.ids],
                                   site=self._fetch_site)
        return od.astype(np.float64)[:nq], ol[:nq], oi[:nq]

    def solve_local_shards(self, d_attrs: np.ndarray, d_labels: np.ndarray,
                           d_ids: np.ndarray, q_attrs: np.ndarray,
                           kmax: int):
        """This rank's own (query shard x row shard) candidate lists with
        no cross-shard merge, for the multi-process contract run
        (``parallel.distributed``), whose float64 rescore reads the k-th
        and last positions: selection-ordered (qloc, K) numpy (f32 dists,
        labels, ids). ``d_ids`` are the shard's global ids (affine, -1
        padding)."""
        plan = self._plan_shard(d_attrs.shape[0], q_attrs.shape[0],
                                d_attrs.shape[1], kmax)
        dev = self.device
        site = "sharded.stage_local"
        q = move(torch.from_numpy(q_attrs).to(self._staging_dtype()), dev,
                 site)
        d = move(torch.from_numpy(d_attrs).to(self._staging_dtype()), dev,
                 site)
        lab = move(torch.from_numpy(d_labels), dev, site)
        ids = move(torch.from_numpy(d_ids), dev, site)
        n_real = int((d_ids >= 0).sum())
        id_base = int(max(d_ids[0], 0)) if len(d_ids) else 0

        def _op():
            rs_inject.fire("sharded.solve", which="local_shards")
            top = self._solve_shard(plan, q, d, lab, ids, id_base, n_real)
            if plan["select"] == "extract":
                top = select_topk(top.dists, top.labels, top.ids,
                                  plan["k"])
            return top

        self._pending_iters = []
        self.last_comms = []
        with obs_span("sharded.solve_local_shards", select=plan["select"],
                      kcap=plan["k"]) as sp:
            top = rs_retry.call_with_retry(_op, "sharded.solve")
            sp.fence(top.dists)
        out = resilient_get([top.dists, top.labels, top.ids],
                            site=self._fetch_site)
        flush_measured_iters(self)
        return out

    def _plan_shard(self, shard_rows: int, qloc: int, na: int,
                    kmax: int) -> dict:
        """Per-shard plan of ``solve_local_shards``: the extraction kernel
        where the shard's fixed shape supports it, else the streaming
        select with the largest block dividing the shard."""
        from dmlp_tpu_torch.ops.extract import supports as ex_supports
        from dmlp_tpu_torch.ops.fused import resolve_topk_kernel

        cfg = self.config
        prec = cfg.resolve_precision()
        self._last_select = None
        if cfg.data_block is None \
                and cfg.resolve_select(shard_rows) == "extract":
            k = resolve_kcap(cfg, kmax, "extract", shard_rows,
                             staging=self._staging)
            if ex_supports(qloc, shard_rows, na, k):
                self._last_select = "extract"
                impl = resolve_topk_kernel(qloc, shard_rows, na, k,
                                           rung=self._degrade_rung)[1]
                self.last_extract_impl = impl
                return {"select": "extract", "k": k, "impl": impl,
                        "precision": prec}
        select = cfg.resolve_streaming_select(shard_rows)
        granule = cfg.resolve_granule(select)
        block = _tile(shard_rows, min(cfg.data_block
                                      or cfg.resolve_data_block(select),
                                      shard_rows), min(granule, shard_rows))
        self._last_select = select
        return {"select": select, "data_block": block,
                "k": resolve_kcap(cfg, kmax, select, shard_rows,
                                  staging=self._staging)}

    def run(self, inp: Optional[KNNInput]) -> Optional[List[QueryResult]]:
        """Every rank: the mesh solve; rank 0 then fetches the merged
        lists, finalizes them in float64 and repairs the boundary hazards
        with the full input, and returns the results (the others None)."""
        n = inp.params.num_data if self.root else 0
        segments = self._solve_segments(inp)
        self.last_repairs = 0
        telemetry.sample_memory_now()
        if not self.root:
            flush_measured_iters(self)
            return None
        merged: List[QueryResult] = [None] * inp.params.num_queries
        dn_max = None
        fetch_ms = final_ms = 0.0
        for top, _qpad, idx, select in segments:
            sub = inp if idx is None else subset_queries(inp, idx)
            nq = sub.params.num_queries
            t0 = time.perf_counter()
            with obs_span("sharded.fetch", select=select):
                od, ol, oi = resilient_get([top.dists, top.labels, top.ids],
                                           site=self._fetch_site)
            dists = od.astype(np.float64)[:nq]
            labels, ids = ol[:nq], oi[:nq]
            fetch_ms += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            with obs_span("sharded.finalize", exact=self.config.exact) as sp:
                results = finalize_host(dists, labels, ids, sub.ks,
                                        sub.query_attrs, sub.data_attrs,
                                        exact=self.config.exact,
                                        query_ids=idx)
                if dists.shape[1] < n:
                    # A point dropped by shard s has a device distance
                    # above that shard's horizon, and the merged k-th is
                    # at most any shard's k-th, so the same eps-widened
                    # boundary test covers the merge. A width of n or more
                    # holds every real point: nothing was truncated.
                    if dn_max is None:
                        dn_max = float(np.einsum("na,na->n", inp.data_attrs,
                                                 inp.data_attrs).max())
                    qn = np.einsum("qa,qa->q", sub.query_attrs,
                                   sub.query_attrs)
                    eps = staging_eps(dists[:, -1], qn, dn_max,
                                      self._staging, inp.params.num_attrs)
                    if self.last_precision["active"] == "bf16" \
                            and select == "extract":
                        eps = eps + lowp_eps("bf16", qn, dn_max)
                    suspects = np.nonzero(boundary_overflow(dists, sub.ks,
                                                            eps))[0]
                    if suspects.size:
                        repair_boundary_overflow(results, suspects, sub)
                        self.last_repairs += int(suspects.size)
                        sp.set(repairs=int(suspects.size))
            if idx is None:
                merged = results
            else:
                for local_i, orig in enumerate(idx):
                    merged[int(orig)] = results[local_i]
            final_ms += (time.perf_counter() - t0) * 1e3
        self.last_phase_ms["fetch"] = fetch_ms
        self.last_phase_ms["finalize"] = final_ms
        flush_measured_iters(self)
        return merged

    def run_device_full(self, inp: Optional[KNNInput]
                        ) -> Optional[List[QueryResult]]:
        """Every rank: the all-device pipeline (the reference's benchmark
        mode) over the mesh — the same dense segments (no prune plan, no
        repair), then on rank 0 the vote and the report order on its card
        in f32 over the gathered lists (``engine.single._device_epilogue``);
        only the (Q, K) predictions, report ids and f32 distances are
        fetched, and they are the result."""
        with obs_span("sharded.device_full", mesh=list(self.mesh.shape)):
            segments = self._solve_segments(inp, allow_prune=False)
        self.last_repairs = 0
        self.last_prune = None
        telemetry.sample_memory_now()
        if not self.root:
            flush_measured_iters(self)
            return None
        n = inp.params.num_data
        num_labels = int(inp.labels.max()) + 1 if n else 1
        merged: List[QueryResult] = [None] * inp.params.num_queries
        for top, qpad, idx, _select in segments:
            sub = inp if idx is None else subset_queries(inp, idx)
            nq = sub.params.num_queries
            ks_pad = np.zeros(qpad, np.int32)
            ks_pad[:nq] = sub.ks
            top = TopK(*(move(t, self.device, "sharded.epilogue_stage")
                         for t in top))
            pred, rids, rd = resilient_get(list(_device_epilogue(
                top, move(torch.from_numpy(ks_pad), self.device,
                          "sharded.epilogue_stage"),
                num_labels=num_labels)), site=self._fetch_site)
            rd = rd.astype(np.float64)
            gids = np.arange(nq) if idx is None else idx
            for qi in range(nq):
                k = int(sub.ks[qi])
                merged[int(gids[qi])] = QueryResult(
                    int(gids[qi]), k, int(pred[qi]),
                    rids[qi, :k].astype(np.int64), rd[qi, :k])
        flush_measured_iters(self)
        return merged


class RingEngine(ShardedEngine):
    """Ring-streaming engine: the merge is a merge-top-k ring all-reduce
    over "data" — an O(k) accumulator per hop instead of an O(R * k)
    gather."""

    _merge_strategy = "ring"

    def __init__(self, config: EngineConfig = EngineConfig(mode="ring"),
                 mesh=None):
        super().__init__(config, mesh)
