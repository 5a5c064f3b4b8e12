"""Compiler-sharded KNN engine — port of ``dmlp_tpu/engine/auto.py``.

The reference expresses the mesh solve as one ``jit`` program whose
inputs carry ``NamedSharding`` placements (rows over "data", queries over
"query") and whose merge point is a ``with_sharding_constraint`` from
data-partitioned per-shard lists to query-partitioned merged lists: XLA's
GSPMD partitioner picks the collective that the hand-rolled engines spell
out. PyTorch has no partitioner for a whole program; its placement layer
is ``torch.distributed.tensor`` (DTensor). Here every rank of the
("data", "query") mesh runs :class:`AutoShardedEngine` in step (SPMD), as
the mesh engines do:

1. Rank 0 plans: the streaming select of the estimated shard rows
   (``resolve_streaming_select``: "seg" under ``--pallas``, whose step is
   K3 on the card), ``data_block`` from ``fit_blocks`` at the select's
   granule, the candidate width from ``resolve_kcap`` over R x
   shard_rows, and the prune plan (``_plan_prune_mesh``: whole (shard,
   block) pieces no query can reach are staged as sentinel rows —
   attributes 0, labels and ids -1 — which the fold provably ignores).
2. The root scatters the row shards and the query shards (the engine's
   own scatters); each rank wraps its pieces as DTensors placed ``[Shard(0),
   Replicate()]`` (rows) and ``[Replicate(), Shard(0)]`` (queries), the
   analog of the reference's ``device_put`` with its shardings. No rank
   gathers the full corpus.
3. Each rank folds its (query shard x row shard) cell with
   ``ops.topk.streaming_topk`` — the reference's vmapped per-shard fold.
4. The merge point: ``parallel.collectives.gspmd_merge_topk`` places the
   lists as the data-sharded candidate matrix and redistributes them to
   query-sharded (DTensor issues one all-gather over "data"), then
   re-selects.
5. Row 0 gathers over "query" to rank 0, which runs the inherited float64
   finalize and boundary repair (``ShardedEngine.run``), so the output is
   byte-identical to golden's.

Precision: a "bf16" first pass is bf16 staging, in exact mode only
(``_precision_staging``), so the existing kcap window and ``staging_eps``
keep the rescore exact. No analytic comms model claims the merge
(``obs.comms.engine_comms("gspmd", ...)`` is empty, and ``last_comms`` is
``[]`` after a solve); :meth:`AutoShardedEngine.comms_from_hlo` fills it
from ``obs.hlo``'s record of the collectives the last solve issued, when a
recording was asked for (the CLI's ``--hlo-report``).

Spans ``auto.stage_enqueue``, ``auto.solve``, ``auto.merge`` and
``auto.gather``; fault site ``auto.solve``; fetch site ``auto.fetch``.
Phases as the mesh engines': ``prune``, ``stage_enqueue``, ``fold``,
``merge``, ``gather``, ``fetch``, ``finalize``.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.sharded import ShardedEngine
from dmlp_tpu_torch.engine.single import fit_blocks, resolve_kcap, round_up
from dmlp_tpu_torch.io.grammar import KNNInput
from dmlp_tpu_torch.io.report import QueryResult
from dmlp_tpu_torch.obs import comms as obs_comms
from dmlp_tpu_torch.obs import memwatch, telemetry
from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.ops.summaries import note_scan
from dmlp_tpu_torch.ops.topk import streaming_topk
from dmlp_tpu_torch.parallel.collectives import broadcast_object
from dmlp_tpu_torch.parallel.mesh import DATA_AXIS, QUERY_AXIS, make_mesh
from dmlp_tpu_torch.resilience import inject as rs_inject
from dmlp_tpu_torch.resilience import retry as rs_retry

_MULTI_HOST = ("AutoShardedEngine has no multi-host contract path yet; "
               "use mode='sharded'/'ring' for parallel.distributed feeds")


def plan_auto(cfg: EngineConfig, n: int, nq: int, kmax: int, mesh_shape,
              staging: str = "float32") -> dict:
    """The auto solve's plan on an (R, C) mesh: the streaming select of
    the estimated shard rows, ``data_block`` (``fit_blocks`` at the
    select's granule, or the configured block), the shard rows (whole
    blocks), the blocks per shard, the padded query shard and the
    candidate width over R x shard_rows."""
    r, c = mesh_shape
    shard_rows_est = round_up(max(-(-n // r), 1), 8)
    select = cfg.resolve_streaming_select(shard_rows_est)
    if cfg.data_block is not None:
        data_block = min(cfg.data_block, shard_rows_est)
    else:
        data_block = fit_blocks(max(-(-n // r), 1),
                                cfg.resolve_data_block(select),
                                granule=cfg.resolve_granule(select))
    # r * round_up(ceil(n / r), b) == round_up(n, r * b): every shard is
    # whole blocks.
    shard_rows = round_up(max(n, 1), r * data_block) // r
    return {"select": select, "data_block": data_block,
            "shard_rows": shard_rows, "nblocks": shard_rows // data_block,
            "qloc": round_up(max(-(-nq // c), 1), 8),
            "k": resolve_kcap(cfg, kmax, select, r * shard_rows,
                              staging=staging)}


class AutoShardedEngine(ShardedEngine):
    """DTensor-placed engine over the same 2D ("data", "query") mesh; one
    per rank, all ranks calling the same methods in step. It inherits the
    host-side contract of :class:`~dmlp_tpu_torch.engine.sharded.
    ShardedEngine` (``run``'s fetch, float64 finalize and boundary repair,
    ``candidates``, ``run_device_full``) and replaces the device solve."""

    _merge_strategy = "gspmd"
    _fetch_site = "auto.fetch"

    def __init__(self, config: EngineConfig = EngineConfig(mode="auto"),
                 mesh=None):
        if mesh is None:
            mesh = make_mesh(config.mesh_shape)
        # The placements below name these dimensions: fail here, with the
        # contract, rather than inside the first redistribute.
        names = tuple(mesh.mesh_dim_names or ())
        missing = sorted({DATA_AXIS, QUERY_AXIS} - set(names))
        if missing:
            raise ValueError(
                f"auto engine mesh must declare axes ({DATA_AXIS!r}, "
                f"{QUERY_AXIS!r}); got {names} (missing {missing})")
        super().__init__(config, mesh)
        self.last_plan = None
        self._last_record = None

    # -- precision composition (resolved before the solve) -------------------
    @contextlib.contextmanager
    def _precision_staging(self):
        """The bf16 first pass is bf16 staging for the solve, so the kcap
        window and the ``staging_eps`` hazard test apply unchanged. Only in
        exact mode (``resolve_precision`` is "f32" in fast mode) and only
        when staging is not bf16 already."""
        if self.config.resolve_precision() != "bf16" \
                or self._staging != "float32":
            yield
            return
        self._staging = "bfloat16"
        try:
            yield
        finally:
            self._staging = "float32"

    def run(self, inp: Optional[KNNInput]) -> Optional[List[QueryResult]]:
        with self._precision_staging():
            return super().run(inp)

    # -- the solve (every rank) ----------------------------------------------
    def _reset_solve_state(self) -> None:
        self.last_hetk = None        # the streaming selects take any k
        self.last_phase_ms = {}
        self.last_comms = []         # no analytic claim (module docstring)
        self._last_record = None
        self._pending_iters = []
        self.last_extract_impl = None
        self.last_prune = None

    def _solve_segments(self, inp: Optional[KNNInput], routed: bool = True,
                        allow_prune: bool = True):
        """Every rank: the auto solve. Returns rank 0's one segment
        [(TopK, qpad, None, select)] (None for the TopK elsewhere)."""
        self._reset_solve_state()
        if inp is not None:
            memwatch.note_engine_model(self, inp)
        prec = self.config.resolve_precision()
        self.last_precision = {
            "active": "bf16" if prec == "bf16"
            and self._staging == "bfloat16" else "f32",
            "configured": prec}
        return self._solve_auto(inp, allow_prune and self.config.exact)

    def _plan_auto(self, inp: KNNInput, allow_prune: bool):
        """Rank 0's plan (select, data_block, shard rows, query shard, the
        candidate width and the prune mask) and the prune stats."""
        n, nq = inp.params.num_data, inp.params.num_queries
        plan = plan_auto(self.config, n, nq,
                         int(inp.ks.max()) if nq else 1, self.mesh.shape,
                         staging=self._staging)
        t0 = time.perf_counter()
        keep, stats = self._plan_prune_mesh(
            inp, plan["shard_rows"], plan["nblocks"], plan["data_block"],
            allow_prune, precision="f32")
        self.last_phase_ms["prune"] = (time.perf_counter() - t0) * 1e3
        plan.update(path="auto", n=n, na=inp.params.num_attrs,
                    keep=None if keep is None else keep.tolist())
        return plan, stats

    def _root_arrays(self, inp: KNNInput, plan: dict, stats):
        """Rank 0's padded (attrs, labels, ids) with the pruned pieces
        masked to sentinel rows, and its scan accounting."""
        n, na = plan["n"], plan["na"]
        shard_rows, blk = plan["shard_rows"], plan["data_block"]
        r = self.mesh.shape[0]
        attrs = np.zeros((r * shard_rows, na), np.float32)
        attrs[:n] = inp.data_attrs
        labels = np.full(r * shard_rows, -1, np.int32)
        labels[:n] = inp.labels
        ids = np.full(r * shard_rows, -1, np.int32)
        ids[:n] = np.arange(n, dtype=np.int32)
        item = self._itemsize()
        scanned = n * na * item
        nonempty = 0
        for rr in range(r):
            for t in range(plan["nblocks"]):
                lo = rr * shard_rows + t * blk
                hi = min(lo + blk, (rr + 1) * shard_rows, n)
                nonempty += hi > lo
                if plan["keep"] is None or plan["keep"][rr][t] or hi <= lo:
                    continue
                attrs[lo:hi] = 0
                labels[lo:hi] = -1
                ids[lo:hi] = -1
                scanned -= (hi - lo) * na * item
        stats = stats or {}
        note_scan(self, scanned_bytes=scanned, dense_bytes=n * na * item,
                  blocks_total=stats.get("blocks_total", nonempty),
                  blocks_pruned=stats.get("blocks_pruned", 0))
        return attrs, labels, ids

    def _place(self, t: torch.Tensor, placements):
        """``t`` (this rank's piece) as a DTensor on the mesh; it lies
        where the mesh's collectives want it (the host on a gloo mesh)."""
        from torch.distributed.tensor import DTensor
        if t.device.type != self.mesh.device_type:
            t = t.to(self.mesh.device_type)
        return DTensor.from_local(t, self.mesh, placements, run_check=False)

    def _solve_auto(self, inp: Optional[KNNInput], allow_prune: bool):
        from torch.distributed.tensor import Replicate, Shard

        r, c = self.mesh.shape
        dev = self.device
        plan = stats = None
        if self.root:
            plan, stats = self._plan_auto(inp, allow_prune)
        t0 = time.perf_counter()
        with obs_span("auto.stage_enqueue", mesh=[r, c]):
            plan = broadcast_object(plan)
            self.last_plan = {k: plan[k] for k in (
                "select", "data_block", "shard_rows", "na", "qloc", "k")}
            self._last_select = plan["select"]
            attrs = labels = ids = None
            if self.root:
                attrs, labels, ids = self._root_arrays(inp, plan, stats)
            na, shard_rows, qloc = plan["na"], plan["shard_rows"], \
                plan["qloc"]
            rows = [Shard(0), Replicate()]
            a_sh = self._place(self._scatter_rows(
                attrs, shard_rows, (na,), torch.float32), rows)
            l_sh = self._place(self._scatter_rows(
                labels, shard_rows, (), torch.int32), rows)
            i_sh = self._place(self._scatter_rows(
                ids, shard_rows, (), torch.int32), rows)
            del attrs, labels, ids
            q_sh = self._place(self._scatter_queries(
                inp.query_attrs if self.root else None, qloc, na),
                [Replicate(), Shard(0)])
            d = a_sh.to_local().to(self._staging_dtype()).to(dev)
            lab, ids_dev = l_sh.to_local().to(dev), i_sh.to_local().to(dev)
            q = q_sh.to_local().to(dev)
        t0 = self._phase("stage_enqueue", t0)

        def _op():
            rs_inject.fire("auto.solve", which="gspmd")
            return streaming_topk(q, d, lab, ids_dev, plan["k"],
                                  plan["data_block"], plan["select"],
                                  self.config.use_pallas)

        with obs_span("auto.solve", select=plan["select"], mesh=[r, c],
                      kcap=plan["k"]):
            # The fold reads only staged tensors: running it again is
            # idempotent, the retry wrapper's requirement.
            top = rs_retry.call_with_retry(_op, "auto.solve")
            self._sync()
        t0 = self._phase("fold", t0)
        telemetry.sample_memory_now()
        with obs_span("auto.merge", mesh=[r, c], kc=plan["k"]):
            merged = self._merge(top, plan["k"])
            self._sync()
        t0 = self._phase("merge", t0)
        with obs_span("auto.gather", mesh=[r, c]):
            out = self._gather(merged)
        self._phase("gather", t0)
        return [(out, c * qloc, None, plan["select"])]

    # -- the collective record -----------------------------------------------
    def allgather_twin_comms(self) -> list:
        """The analytic traffic the hand-rolled all-gather engine would
        issue for the last solve's plan (``obs.comms``: the root's scatters
        with ids, the all-gather merge, row 0's gather): what ``obs.hlo``
        holds this engine's record against."""
        p = self.last_plan
        if p is None:
            return []
        shape = tuple(self.mesh.shape)
        return (obs_comms.scatter_comms(shape, p["shard_rows"], p["na"],
                                        [p["qloc"]], with_ids=True)
                + obs_comms.engine_comms("allgather", shape, p["qloc"],
                                         p["k"])
                + obs_comms.gather_comms(shape, p["qloc"], p["k"]))

    def comms_from_hlo(self):
        """Fill ``last_comms`` with ``gspmd_*`` traffic records from
        ``obs.hlo``'s record of the collectives the last solve issued, and
        return that :class:`~dmlp_tpu_torch.obs.hlo.HloReport`; None when
        the last solve was not recorded (no ``obs.hlo.recording``)."""
        from dmlp_tpu_torch.obs import hlo as obs_hlo
        rep = self._last_record
        if rep is None:
            return None
        self.last_comms = obs_hlo.traffic_from_report(rep)
        return rep

    # -- multi-host contract -------------------------------------------------
    def solve_global(self, d_attrs, d_labels, d_ids, q_attrs, kmax: int):
        raise NotImplementedError(_MULTI_HOST)

    def solve_local_shards(self, d_attrs, d_labels, d_ids, q_attrs,
                           kmax: int):
        raise NotImplementedError(_MULTI_HOST)
