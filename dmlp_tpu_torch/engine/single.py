"""Single-device KNN engine — port of ``dmlp_tpu/engine/single.py``.

The same solve as the reference engine on one device: the data is padded
and staged in chunks, each chunk is folded into running (Q, K) candidate
lists, and the host rescores the candidates in float64, votes, and repairs
the queries whose candidate boundary may have truncated a tie group. The
device paths, picked by ``EngineConfig.resolve_select``:

- "sort" (<= 8192 padded rows): whole-dataset staging and a strict
  (dist asc, id desc) blockwise merge;
- "topk" / "seg": chunked staging from pinned host memory with a running
  top-k that keeps the lowest position on ties; "seg" reads the K3 kernel
  (``ops.dist_segmin``) with the hand-written kernels on;
- "extract" (``use_pallas``): chunked staging and the hand-written
  extraction kernel (``ops.fused.fused_topk``, or ``ops.extract.
  extract_topk`` with ``DMLP_TPU_FUSED=0``). Where some queries' candidate
  width exceeds the kernel's kc <= 512, the heterogeneous-k router keeps
  the rest on the kernel and folds the wide-k outliers through "seg" on
  the same staged chunks; where every query's does, the multi-pass driver
  sweeps the resident dataset in floor-raised passes of kc = 512; where
  neither applies, the solve streams through "seg".

``run()`` goes through the degradation ladder (``resilience.degrade``): it
enters on the top rung, ``lowp``, where the chunked paths stage only the
chunks that some query's top-k could need (``_plan_prune``, the pruned
two-stage solve of ``ops.summaries``), and on an OOM it steps down a rung.
Staging and readback go through the injection sites and the transient
retry of ``resilience``. ``candidates()`` stays dense.

``run_device_full()`` is the reference's benchmark mode: the same
segments, then the vote and the report order on the device in f32
(``ops.vote``), with no float64 finalize and no repair.

The kernels' launch knobs (S of K1/K2, G of K3) and the prune scoring's
block chunk resolve through the tune cache (``tune.cache``) where it
holds a measured winner, else through their heuristics. On the CPU every
kernel runs its plain PyTorch version. The mesh engines are
``engine.sharded``.

Observability (``dmlp_tpu_torch.obs``), each hook one module-global read
when it is off: the reference's spans (``single.prune_score``,
``single.solve_scan``, ``single.enqueue_pipelined``,
``single.enqueue_extract``, ``single.fetch``, ``single.finalize``), the
memory model and sampler ticks at peak residency, ``last_comms`` (empty:
one device runs no collective), and with a cost probe installed the K1/K2
``iters`` summed on the device per launch shape (:class:`MeasuredIters`)
and read back once, after the solve's fetch.
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

import numpy as np
import torch

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.finalize import (EPS_CANCEL_COEF, EPS_REL_BF16,
                                            EPS_REL_F32, LOWP_COEF,
                                            boundary_hazard, finalize_host,
                                            lowp_eps,
                                            repair_boundary_overflow,
                                            staging_eps)
from dmlp_tpu_torch.io.grammar import KNNInput, subset_queries
from dmlp_tpu_torch.io.report import QueryResult
from dmlp_tpu_torch.obs import counters as obs_counters
from dmlp_tpu_torch.obs import memwatch, telemetry
from dmlp_tpu_torch.obs import trace as obs_trace
from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.ops.summaries import (build_summaries, note_scan,
                                          prune_enabled, prune_mask,
                                          resolve_score_variant)
from dmlp_tpu_torch.ops.topk import (TopK, init_topk, make_block_step,
                                     select_topk, streaming_fallback,
                                     streaming_topk)
from dmlp_tpu_torch.ops.vote import majority_vote, report_order
from dmlp_tpu_torch.resilience import degrade as rs_degrade
from dmlp_tpu_torch.resilience import inject as rs_inject
from dmlp_tpu_torch.resilience import retry as rs_retry

# Per-chunk distance-tile budget of the "topk" driver (bytes): the live
# (query rows x chunk rows) f32 tile stays below it.
_TILE_BUDGET = 1 << 30

# Max staged-but-unfolded chunks in flight (the reference's window).
_CHUNK_WINDOW = 8

# Widest k a bfloat16-staged resident engine serves (the reference's
# constant): the bf16 kcap margin (96 + k/2, resolve_kcap) was calibrated
# inside the extraction kernel's window and stops clearing the bf16 eps on
# dense distance spectra far beyond it.
_BF16_AUTO_K_CAP = 512


class ChunkThrottle:
    """Sliding-window backpressure for chunked staging: ``tick()`` after
    each chunk's fold records a CUDA event on the current stream and waits
    on the one from ``window`` chunks back, so at most that many staged
    chunks are in flight on the card. On the CPU every step is already
    synchronous and ``tick`` does nothing."""

    def __init__(self, device: torch.device, window: int = _CHUNK_WINDOW):
        self._cuda = device.type == "cuda"
        self._window = window
        self._pending: list = []

    def tick(self) -> None:
        if not self._cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self._pending.append(ev)
        if len(self._pending) > self._window:
            self._pending.pop(0).synchronize()


class MeasuredIters:
    """Per launch shape, the sum of K1/K2's ``iters`` outputs on the
    device while a cost probe is installed (one tiny reduction per launch,
    none without a probe); ``done()`` queues it on the engine for
    :func:`flush_measured_iters` after the solve's fetch."""

    def __init__(self, engine, impl: str, shape: Tuple[int, int, int, int]):
        self._on = obs_counters.active() is not None
        self._engine = engine
        self._kernel = "fused_topk" if impl == "fused" else "extract_topk"
        self._shape = tuple(int(v) for v in shape)
        self._sum = None

    def add(self, iters: torch.Tensor) -> None:
        if self._on:
            s = iters.sum()
            self._sum = s if self._sum is None else self._sum + s

    def done(self) -> None:
        if self._sum is not None:
            self._engine._pending_iters.append(
                (self._kernel, self._sum, self._shape))


def flush_measured_iters(engine) -> None:
    """Read back the engine's queued ``iters`` sums (the solve's results
    are fetched already, so this waits on nothing) and hand them to the
    installed probe: the measured extraction term of obs.kernel_cost."""
    pend = getattr(engine, "_pending_iters", [])
    engine._pending_iters = []
    for kernel, total, shape in pend:
        obs_counters.record_measured_iters(kernel, int(total), shape)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def host_staging(arr: np.ndarray, device: torch.device,
                 staging: str = "float32") -> torch.Tensor:
    """A host tensor in the staging dtype, pinned when the copy goes to
    the card (so the host-to-device copy can run asynchronously)."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(
        torch.bfloat16 if staging == "bfloat16" else torch.float32)
    return t.pin_memory() if device.type == "cuda" else t


def stage(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host-to-device copy, asynchronous from pinned memory: the staging
    chokepoint of every solve path, so it is the ``single.stage_put``
    injection site, and a transient failure retries the copy (copying the
    same host tensor again is idempotent)."""
    def _op():
        rs_inject.fire("single.stage_put")
        return host.to(device, non_blocking=True)

    return rs_retry.call_with_retry(_op, "single.stage_put")


def resilient_get(values: List[torch.Tensor], site: str = "single.fetch"
                  ) -> List[np.ndarray]:
    """Readback of device tensors to numpy (the fetch is the solve's
    fence), at the ``single.fetch`` injection site with the transient
    retry: reading values already computed again is idempotent.
    ``$DMLP_TPU_OP_TIMEOUT_S`` (off by default) bounds each attempt with a
    worker-thread deadline whose ``OperationTimeout`` retries; with
    ``DMLP_TPU_RESILIENCE=0`` the read is a direct call."""
    deadline = float(os.environ.get("DMLP_TPU_OP_TIMEOUT_S", "0") or 0)

    def _get():
        rs_inject.fire(site)
        return [v.cpu().numpy() for v in values]

    def _op():
        if deadline > 0 and rs_retry.resilience_enabled():
            return rs_retry.call_with_timeout(_get, deadline, site=site)
        return _get()

    return rs_retry.call_with_retry(_op, site)


def plan_chunks(n: int, granule: int, target: int | None) -> Tuple[int, int, int]:
    """(npad, nchunks, chunk_rows): ~``target``-row chunks (default
    51200) of whole ``granule`` blocks covering ``n``."""
    npad = round_up(max(n, 1), granule)
    t = round_up(target or 51200, granule)
    nchunks = max(1, -(-npad // t))
    chunk_rows = round_up(-(-npad // nchunks), granule)
    return npad, nchunks, chunk_rows


def fold_plan(cfg: EngineConfig, n: int, nq: int, select: str
              ) -> Tuple[int, int, int, int]:
    """(query rows per block, query blocks, chunks, chunk rows) of the
    pipelined chunk fold on ``select``."""
    _, nchunks, chunk_rows = plan_chunks(n, cfg.resolve_granule(select),
                                         cfg.data_block)
    # Query padding: whole 1024-row blocks for the K3-fed seg fold on
    # large query sets (the reference's tiling rule), 8 otherwise.
    qgran = 1024 if (cfg.use_pallas and select == "seg"
                     and nq > 1024) else 8
    qpad = round_up(max(nq, 1), qgran)
    # The live (query rows x chunk rows) f32 tile stays below both the
    # configured query_block and the tile budget.
    qsb = min(qpad, round_up(cfg.query_block, qgran))
    while qsb > qgran and qsb * chunk_rows * 4 > _TILE_BUDGET:
        qsb -= qgran
    return qsb, -(-qpad // qsb), nchunks, chunk_rows


def fit_blocks(n: int, target_block: int, granule: int = 8) -> int:
    """A data_block (multiple of ``granule``, <= ~target_block) whose
    padding wastes < granule * nblocks rows of n."""
    n = max(n, 1)
    nblocks = max(1, -(-n // max(target_block, granule)))
    return round_up(-(-n // nblocks), granule)


def resolve_kcap(cfg: EngineConfig, kmax: int, select: str, cap: int,
                 staging: str = "float32",
                 precision: str | None = None) -> int:
    """Device candidate-list width: kmax + margin, rounded to 8, clamped
    to [kmax, cap] — the reference rule unchanged (>= 8 slack on the
    fast selects; 96 + k/2 for a bf16 pass or bf16 staging; k/8 for f32
    staging in exact mode)."""
    if precision is None:
        precision = cfg.resolve_precision()
    extra = cfg.margin if cfg.exact else 0
    if select in ("sort", "topk", "seg", "extract"):
        extra = max(extra, 8)
    if precision == "bf16" and cfg.exact:
        extra = max(extra, 96 + kmax // 2)
    if staging == "bfloat16" and cfg.exact:
        extra = max(extra, 96 + kmax // 2)
    elif cfg.exact:
        extra = max(extra, kmax // 8)
    return max(min(round_up(kmax + extra, 8), cap), kmax)


def pad_dataset(inp: KNNInput, multiple: int, dtype: np.dtype
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (attrs, labels, ids) to a multiple of ``multiple`` rows; the
    sentinel rows carry label = -1 and id = -1."""
    n = inp.params.num_data
    npad = round_up(max(n, 1), multiple)
    attrs = np.zeros((npad, inp.params.num_attrs), dtype)
    attrs[:n] = inp.data_attrs
    labels = np.full(npad, -1, np.int32)
    labels[:n] = inp.labels
    ids = np.full(npad, -1, np.int32)
    ids[:n] = np.arange(n, dtype=np.int32)
    return attrs, labels, ids


def hetk_split(cfg: EngineConfig, staging: str, ks: np.ndarray,
               num_data: int, gate_rows: int):
    """Heterogeneous-k split plan: (bulk_idx, out_idx) or None.

    k is legal up to num_data, but the extraction kernel's lists cap at
    kc <= 512. The split keeps the queries whose candidate width fits on
    the kernel ("bulk") and folds only the wide-k outliers through the
    streaming select; each query is solved once. ``gate_rows`` is the row
    count the auto-select gate sees."""
    from dmlp_tpu_torch.ops.extract import KC_MAX
    if len(ks) == 0 or num_data == 0 or not cfg.use_pallas:
        return None
    if cfg.select not in ("auto", "extract"):
        return None
    if cfg.resolve_select(gate_rows) != "extract":
        return None
    # Largest per-query k whose candidate width still fits the kernel
    # (the margin is k- and staging-dependent, resolve_kcap).
    k_fit = next((k for k in range(KC_MAX, 0, -1)
                  if resolve_kcap(cfg, k, "extract", 1 << 30,
                                  staging) <= KC_MAX), 0)
    if k_fit == 0 or int(ks.max()) <= k_fit:
        return None      # everything fits: no routing needed
    bulk = np.nonzero(ks <= k_fit)[0]
    out = np.nonzero(ks > k_fit)[0]
    if bulk.size == 0:
        return None      # nothing the kernel could take
    return bulk, out


def active_precision(engine) -> str:
    """The first-pass dot precision this launch runs at: "bf16" only when
    the configuration resolves to it (``$DMLP_TPU_PRECISION`` included),
    the solve is exact (the f64 rescore and the boundary repair make a
    lossy first pass sound), and the degradation ladder still sits on its
    top "lowp" rung: the first OOM step gives the low-precision pass back.
    Candidate windows do not consult this; resolve_kcap plans from the
    configured precision, so a window stays the same across rungs. An
    engine that freezes a precision plan at construction (the resident
    serving engine: its bucket windows and staged summary eps derive from
    it) exposes ``_precision_plan``, and the pass clamps to it: flipping
    ``$DMLP_TPU_PRECISION`` to "bf16" under windows planned for f32 never
    runs a bf16 pass."""
    if engine._degrade_rung != "lowp":
        return "f32"
    if not engine.config.exact:
        return "f32"
    plan = getattr(engine, "_precision_plan", None)
    if plan is not None and plan != "bf16":
        return "f32"
    return engine.config.resolve_precision()


def _outlier_fold(carry: TopK, q: torch.Tensor, battrs: torch.Tensor,
                  labels_all: torch.Tensor, lo: int, n_real: int, *,
                  k: int, select: str, use_pallas: bool) -> TopK:
    """Fold one already-staged data chunk into the wide-k outlier queries'
    running top-k. The chunk's labels are a slice of the once-staged
    padded label vector and its ids come from its row range, masked at
    ``n_real``: the outliers add no host-to-device attribute traffic."""
    rows = battrs.shape[0]
    blabels = labels_all[lo:lo + rows]
    ri = torch.arange(lo, lo + rows, dtype=torch.int32, device=q.device)
    bids = torch.where(ri < n_real, ri, -1)
    step = make_block_step(select, k, use_pallas)
    return step(carry, q, battrs, blabels, bids)


def _mp_floor(od: torch.Tensor, qn: torch.Tensor, dn_max: torch.Tensor, *,
              staging: str, na: int, precision: str = "f32"):
    """Next-pass floor of the multi-pass driver, on the device (passes
    chain with no host readback): floor = max(od) - eps(max(od)), the
    staging eps of engine.finalize plus the bf16 pass's lowp term, in f32
    and in the reference's operation order; exhausted rows (max = inf) get
    +inf. Returns (floor (Q, 1) f32, fd (Q,) f32 for the stall check)."""
    fd = od.max(1).values
    rel = EPS_REL_BF16 if staging == "bfloat16" else EPS_REL_F32
    scale = qn + dn_max
    eps = (rel * torch.sqrt(torch.clamp_min(fd, 0.0) * scale)
           + (EPS_CANCEL_COEF * (na + 2) + LOWP_COEF[precision]) * scale)
    floor = torch.where(torch.isfinite(fd), fd - eps, torch.inf)
    return floor[:, None].float(), fd


def _mp_merge(dists: torch.Tensor, ids: torch.Tensor,
              glabels: torch.Tensor, *, kcap: int):
    """Merge the multi-pass slabs: (Q, P*kc) lists -> dedup by id (the
    eps-overlapped floors re-extract boundary candidates on purpose) ->
    labels from ids -> the final (Q, kcap) selection order. Also returns
    each row's count of valid candidates for the shortfall check."""
    order = torch.argsort(ids, dim=1, stable=True)
    sid = torch.gather(ids, 1, order)
    sd = torch.gather(dists, 1, order)
    dup = torch.cat([torch.zeros_like(sid[:, :1], dtype=torch.bool),
                     sid[:, 1:] == sid[:, :-1]], 1)
    invalid = dup | (sid < 0)
    sd = torch.where(invalid, torch.inf, sd)
    sid = torch.where(invalid, -1, sid)
    n = glabels.shape[0]
    lab = torch.where(sid >= 0,
                      glabels[torch.clamp(sid.long(), 0, max(n - 1, 0))],
                      -1).to(torch.int32)
    return select_topk(sd, lab, sid, kcap), (sid >= 0).sum(1)


def boundary_cols(dists: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """(kth, last) candidate-distance columns, stacked (2, Q), computed on
    the device so exact mode never fetches the (Q, K) distance matrix."""
    kcap = dists.shape[1]
    last = dists[:, kcap - 1]
    kth = torch.gather(dists, 1, torch.clamp(ks[:, None].long() - 1, 0,
                                             kcap - 1))[:, 0]
    return torch.stack([kth, last])


def extract_finalize(od: torch.Tensor, oi: torch.Tensor,
                     glabels: torch.Tensor, k: int) -> TopK:
    """Kernel epilogue: labels from global ids, then the unordered lists
    sorted into the selection order (dist asc, id desc)."""
    n = glabels.shape[0]
    labels = torch.where(oi >= 0,
                         glabels[torch.clamp(oi.long(), 0, max(n - 1, 0))],
                         -1).to(torch.int32)
    return select_topk(od, labels, oi, k)


def _device_epilogue(top: TopK, ks: torch.Tensor, *, num_labels: int):
    """Vote and report order on the device over (Q, K) selection-ordered
    lists, the reference's result post-processing (engine.cpp:314-347):
    (predicted (Q,), report ids (Q, K), report f32 distances (Q, K))."""
    rd, rids, in_k = report_order(top, ks)
    valid = in_k & (top.ids >= 0)
    return majority_vote(top.labels, valid, num_labels), rids, rd


class SingleChipEngine:
    """The one-device engine: on the card by default, on the CPU when the
    configuration asks for it."""

    # Multi-pass resident-dataset budget, pass cap and slots per pass: the
    # reference's constants, kept so that an input takes the same path in
    # both packages.
    _MP_RESIDENT_BUDGET = 2 << 30
    _MP_MAX_PASSES = 16
    _MP_KC = 512

    def __init__(self, config: EngineConfig = EngineConfig()):
        if config.mode != "single":
            raise ValueError(
                f"mode {config.mode!r} is not the one-device engine's: the "
                "mesh engines are dmlp_tpu_torch.engine.sharded "
                "(ShardedEngine, RingEngine), built by cli.make_engine")
        self.config = config
        self.device = config.torch_device()
        self._staging = config.resolve_dtype()
        self._last_select = None
        self.last_phase_ms: dict = {}
        self.last_extract_impl = None
        self.last_repairs = 0
        self.last_hetk = None       # (bulk, outlier) counts when routed
        self.last_mp_passes = 0     # multi-pass extraction pass count
        self._mp_hazard = None      # its per-query loss flags (run repairs)
        # Degradation-ladder rung (resilience.degrade): "fused" outside
        # run(), so candidates() stays dense; run() enters at "lowp".
        # last_degrade_rung is the rung the last run() settled on.
        self._degrade_rung = "fused"
        self.last_degrade_rung = "fused"
        # Scan accounting of the last chunked solve (ops.summaries.
        # note_scan): blocks_total/blocks_pruned/scanned_bytes/dense_bytes.
        self.last_prune = None
        # The first pass's precision record (run()), the collectives of
        # the last solve (obs.comms: none on one device), the memory model
        # (obs.memwatch, with a telemetry session) and the queued iters
        # sums of a probed solve.
        self.last_precision = None
        self.last_comms: list = []
        self.last_mem_model = None
        self._pending_iters: list = []

    def _staging_itemsize(self) -> int:
        return 2 if self._staging == "bfloat16" else 4

    def _plan_prune(self, inp: KNNInput, nchunks: int, chunk_rows: int):
        """Stages 0 and 1 of the pruned two-stage solve for a chunked
        solve path: (survivor chunk schedule, chunks pruned). Active only
        on the ladder's top ``lowp``/``prune`` rungs, in exact mode, with
        the ``DMLP_TPU_PRUNE`` kill switch on and more than one chunk to
        choose between; under a bf16 first pass the thresholds widen by
        ``lowp_eps``. The schedule keeps the chunks' order (affine ids,
        throttle); a pruned chunk is never staged. The scoring is timed
        as ``last_phase_ms["prune"]``, inside the enqueue window."""
        t0 = time.perf_counter()
        n = inp.params.num_data
        schedule, pruned = list(range(nchunks)), 0
        if (nchunks > 1 and n > 0 and inp.params.num_queries > 0
                and self._degrade_rung in ("lowp", "prune")
                and self.config.exact and prune_enabled()):
            ranges = [(c * chunk_rows, min((c + 1) * chunk_rows, n))
                      for c in range(nchunks)]
            with obs_span("single.prune_score", blocks=nchunks):
                summ = build_summaries(inp.data_attrs, ranges)
                chunk = resolve_score_variant(
                    nchunks, inp.params.num_attrs, inp.params.num_queries,
                    self.device)["tile_q"]
                keep, stats = prune_mask(inp.query_attrs, inp.ks, summ,
                                         staging=self._staging,
                                         precision=active_precision(self),
                                         block_chunk=chunk)
            # An empty chunk never survives and counts as no prune.
            schedule = [c for c in schedule if keep[c]]
            pruned = stats["blocks_pruned"]
        self.last_phase_ms["prune"] = (time.perf_counter() - t0) * 1e3
        return schedule, pruned

    def _host_queries(self, query_attrs: np.ndarray,
                      qpad: int) -> torch.Tensor:
        """The queries padded with zero rows to ``qpad``, as one host
        tensor in the staging dtype."""
        q = np.zeros((qpad, query_attrs.shape[1]), np.float32)
        q[:len(query_attrs)] = query_attrs
        return host_staging(q, self.device, self._staging)

    def _stage_queries(self, query_attrs: np.ndarray,
                       qpad: int) -> torch.Tensor:
        return stage(self._host_queries(query_attrs, qpad), self.device)

    def _pinned_chunks(self, inp: KNNInput, rows: int) -> torch.Tensor:
        """The dataset padded with zero rows to ``rows``, as one (pinned,
        on the card) host tensor the chunk loop slices."""
        a = np.zeros((rows, inp.params.num_attrs), np.float32)
        n = inp.params.num_data
        a[:n] = inp.data_attrs
        return host_staging(a, self.device, self._staging)

    def _padded_ids_labels(self, inp: KNNInput, rows: int):
        """(labels, ids) padded to ``rows`` with -1, on the device."""
        n = inp.params.num_data
        labels = np.full(rows, -1, np.int32)
        labels[:n] = inp.labels
        ids = np.full(rows, -1, np.int32)
        ids[:n] = np.arange(n, dtype=np.int32)
        return (torch.from_numpy(labels).to(self.device),
                torch.from_numpy(ids).to(self.device))

    def _solve_scan(self, inp: KNNInput) -> Tuple[TopK, int]:
        """Whole-dataset staging and one blockwise fold ("sort")."""
        cfg = self.config
        n = inp.params.num_data
        nq = inp.params.num_queries
        select = cfg.resolve_streaming_select(round_up(max(n, 1), 8))
        if cfg.data_block is not None:
            data_block = min(cfg.data_block, round_up(max(n, 1), 8))
        else:
            data_block = fit_blocks(n, cfg.resolve_data_block(select),
                                    granule=cfg.resolve_granule(select))
        attrs, labels, ids = pad_dataset(inp, data_block, np.float32)
        kmax = int(inp.ks.max()) if nq else 1
        k = resolve_kcap(cfg, kmax, select, attrs.shape[0],
                         staging=self._staging)
        self._last_select = select
        dev = self.device
        d_attrs = stage(host_staging(attrs, dev, self._staging), dev)
        d_labels = torch.from_numpy(labels).to(dev)
        d_ids = torch.from_numpy(ids).to(dev)
        qb = min(cfg.query_block, round_up(max(nq, 1), 8))
        qpad = round_up(max(nq, 1), qb)
        q_dev = self._stage_queries(inp.query_attrs, qpad)
        with obs_span("single.solve_scan", select=select, qpad=qpad) as sp:
            outs = [streaming_topk(q_dev[i:i + qb], d_attrs, d_labels,
                                   d_ids, k, data_block, select,
                                   cfg.use_pallas)
                    for i in range(0, qpad, qb)]
            sp.fence(outs[-1].dists)
        dense = n * inp.params.num_attrs * self._staging_itemsize()
        note_scan(self, scanned_bytes=dense, dense_bytes=dense,
                  blocks_total=1, blocks_pruned=0)
        return TopK(*(torch.cat(parts) for parts in zip(*outs))), qpad

    def _solve_pipelined(self, inp: KNNInput) -> Tuple[TopK, int]:
        """Chunked staging from pinned host memory + one fold per chunk
        and query block ("topk"/"seg"), under the ChunkThrottle window.
        Reached when the select is not "extract", or when the extraction
        kernel cannot take the input: then the streaming select."""
        cfg = self.config
        n = inp.params.num_data
        na = inp.params.num_attrs
        nq = inp.params.num_queries
        select = cfg.resolve_streaming_select(round_up(max(n, 1), 8))
        self._last_select = select
        t0 = time.perf_counter()
        qsb, nqb, nchunks, chunk_rows = fold_plan(cfg, n, nq, select)
        qpad = nqb * qsb
        kmax = int(inp.ks.max()) if nq else 1
        k = resolve_kcap(cfg, kmax, select, nchunks * chunk_rows,
                         staging=self._staging)

        dev = self.device
        # One staged tensor per query block, as the reference stages them.
        q_host = self._host_queries(inp.query_attrs, qpad)
        q_dev = [stage(q_host[b * qsb:(b + 1) * qsb], dev)
                 for b in range(nqb)]
        schedule, pruned = self._plan_prune(inp, nchunks, chunk_rows)
        host = self._pinned_chunks(inp, nchunks * chunk_rows)
        d_labels, d_ids = self._padded_ids_labels(inp, nchunks * chunk_rows)
        step = make_block_step(select, k, cfg.use_pallas)
        carries = [init_topk(qsb, k, dev) for _ in range(nqb)]
        throttle = ChunkThrottle(dev)
        scanned = 0
        with obs_span("single.enqueue_pipelined", select=select,
                      chunks=nchunks, scheduled=len(schedule), qblocks=nqb,
                      k=k):
            for c in schedule:
                lo, hi = c * chunk_rows, (c + 1) * chunk_rows
                da = stage(host[lo:hi], dev)
                scanned += max(min(hi, n) - lo, 0) * na \
                    * self._staging_itemsize()
                for b in range(nqb):
                    carries[b] = step(carries[b], q_dev[b], da,
                                      d_labels[lo:hi], d_ids[lo:hi])
                throttle.tick()
                # A watermark tick while the chunk is referenced (no-op
                # without a telemetry session).
                telemetry.sample_memory_now()
        note_scan(self, scanned_bytes=scanned,
                  dense_bytes=n * na * self._staging_itemsize(),
                  blocks_total=nchunks,
                  blocks_pruned=pruned)
        self.last_phase_ms["enqueue"] = (time.perf_counter() - t0) * 1e3
        return TopK(*(torch.cat(parts) for parts in zip(*carries))), qpad

    def _solve_extract(self, inp: KNNInput) -> Tuple[TopK, int] | None:
        """Chunked staging + the extraction kernel ("extract"). Chunks
        are contiguous row ranges, so the kernel's ids are affine (id_base
        = chunk start). None for an empty problem or when the kernel
        cannot take the shape (the caller then streams)."""
        from dmlp_tpu_torch.ops import fused
        from dmlp_tpu_torch.ops.extract import QUERY_TILE

        cfg = self.config
        n = inp.params.num_data
        na = inp.params.num_attrs
        nq = inp.params.num_queries
        if n == 0 or nq == 0:
            return None
        rs_inject.fire("single.extract_solve", rung=self._degrade_rung,
                       path="single")
        granule = cfg.resolve_granule("extract")
        t0 = time.perf_counter()
        _, nchunks, chunk_rows = plan_chunks(n, granule, cfg.data_block)
        qpad = round_up(nq, QUERY_TILE)
        kmax = int(inp.ks.max())
        k = resolve_kcap(cfg, kmax, "extract", nchunks * chunk_rows,
                         staging=self._staging)
        kern, impl = fused.resolve_topk_kernel(qpad, chunk_rows, na, k,
                                               rung=self._degrade_rung)
        if kern is None:
            return None
        prec = active_precision(self)
        self._last_select = "extract"
        self.last_extract_impl = impl

        schedule, pruned = self._plan_prune(inp, nchunks, chunk_rows)
        # An all-padding final chunk is never staged.
        live = [c for c in schedule if c * chunk_rows < n]
        dev = self.device
        q_dev = self._stage_queries(inp.query_attrs, qpad)
        host = self._pinned_chunks(inp, nchunks * chunk_rows)
        od = oi = None   # the first survivor starts the lists fresh
        scanned = 0
        throttle = ChunkThrottle(dev)
        mi = MeasuredIters(self, impl, (qpad, chunk_rows, na, k))
        with obs_span("single.enqueue_extract", chunks=nchunks, kc=k,
                      impl=impl, scheduled=len(live)):
            for c in live:
                lo = c * chunk_rows
                hi = min(lo + chunk_rows, n)
                da = stage(host[lo:lo + chunk_rows], dev)
                scanned += (hi - lo) * na * self._staging_itemsize()
                od, oi, iters = kern(q_dev, da, od, oi, n_real=hi - lo,
                                     id_base=lo, kc=k, precision=prec)
                mi.add(iters)
                throttle.tick()
                telemetry.sample_memory_now()   # staging window live
        mi.done()
        note_scan(self, scanned_bytes=scanned,
                  dense_bytes=n * na * self._staging_itemsize(),
                  blocks_total=min(nchunks, -(-n // chunk_rows)),
                  blocks_pruned=pruned)
        self.last_phase_ms["enqueue"] = (time.perf_counter() - t0) * 1e3
        glabels = torch.from_numpy(inp.labels.astype(np.int32)).to(dev)
        return extract_finalize(od, oi, glabels, k), qpad

    def _solve_extract_multipass(self, inp: KNNInput):
        """All-wide-k solve on the extraction kernel in P floor-raised
        passes of kc = 512.

        When every query's candidate width overflows the kernel, the
        chunks are staged once (pass 1 overlaps the staging) and the
        resident dataset is swept P = ceil(kcap / 512) times more or less:
        pass p+1 masks candidates below that row's previous maximum minus
        the staging eps (the kernel's ``floor``), so each pass extracts
        the next slab of the top-k; the eps overlap re-extracts boundary
        candidates rather than lose a tie, and _mp_merge dedups by id.
        The two loss modes flag for exact repair in run(): STALL (a tie
        plateau wider than 512 pins the floor, so fd stops rising) and
        SHORTFALL (fewer than min(k, n) distinct candidates in a row).

        Returns a run()-compatible segment list, or None when the plan does
        not apply (k fits one pass, the kernel cannot tile, the dataset
        exceeds the resident budget, or P would exceed _MP_MAX_PASSES)."""
        from dmlp_tpu_torch.ops import fused
        from dmlp_tpu_torch.ops.extract import QUERY_TILE

        cfg = self.config
        n = inp.params.num_data
        na = inp.params.num_attrs
        nq = inp.params.num_queries
        if n == 0 or nq == 0 or not cfg.use_pallas:
            return None
        if cfg.select not in ("auto", "extract"):
            return None
        if cfg.resolve_select(round_up(max(n, 1), 8)) != "extract":
            return None
        kc = self._MP_KC
        kmax = int(inp.ks.max())
        if resolve_kcap(cfg, kmax, "extract", 1 << 30, self._staging) <= kc:
            return None  # one pass (or the router) owns this k
        granule = cfg.resolve_granule("extract")
        npad, nchunks, chunk_rows = plan_chunks(n, granule, cfg.data_block)
        kcap = resolve_kcap(cfg, kmax, "extract", npad,
                            staging=self._staging)
        npasses = -(-kcap // kc)
        if npasses > self._MP_MAX_PASSES:
            return None
        itemsize = 2 if self._staging == "bfloat16" else 4
        if npad * na * itemsize > self._MP_RESIDENT_BUDGET:
            return None
        qpad = round_up(nq, QUERY_TILE)
        kern, impl = fused.resolve_topk_kernel(qpad, chunk_rows, na, kc,
                                               rung=self._degrade_rung)
        if kern is None:
            return None
        # Passes 2..P launch over the whole resident array; nothing
        # guarantees a shape the kernel tiles per chunk tiles there too,
        # so say so loudly instead of mis-tiling every later pass.
        n_staged = min(nchunks, -(-n // chunk_rows))
        full_rows = n_staged * chunk_rows
        kern_full, _ = fused.resolve_topk_kernel(qpad, full_rows, na, kc,
                                                 rung=self._degrade_rung)
        if kern_full is None:
            raise AssertionError(
                f"multi-pass extract: full-array sweep shape (qb={qpad}, "
                f"rows={full_rows}, a={na}, kc={kc}) is untileable even "
                f"though the per-chunk shape (rows={chunk_rows}) tiles")
        prec = active_precision(self)
        self._last_select = "extract"
        self.last_extract_impl = impl
        rs_inject.fire("single.extract_solve", rung=self._degrade_rung,
                       path="multipass")

        t0 = time.perf_counter()
        # The multi-pass plan never prunes: every block stays competitive
        # against the floor-raised passes (the reference's rule).
        self.last_phase_ms["prune"] = 0.0
        dev = self.device
        q_dev = self._stage_queries(inp.query_attrs, qpad)
        host = self._pinned_chunks(inp, nchunks * chunk_rows)
        chunks: List[torch.Tensor] = []
        od = oi = None
        throttle = ChunkThrottle(dev)
        mi = MeasuredIters(self, impl, (qpad, chunk_rows, na, kc))
        for c in range(n_staged):
            lo = c * chunk_rows
            hi = min(lo + chunk_rows, n)
            chunks.append(stage(host[lo:lo + chunk_rows], dev))
            od, oi, iters = kern(q_dev, chunks[-1], od, oi, n_real=hi - lo,
                                 id_base=lo, kc=kc, precision=prec)
            mi.add(iters)
            throttle.tick()
        mi.done()
        ods, ois = [od], [oi]

        qn_host = np.zeros(qpad, np.float64)
        qn_host[:nq] = np.einsum("qa,qa->q", inp.query_attrs,
                                 inp.query_attrs)
        dn_max = float(np.einsum("na,na->n", inp.data_attrs,
                                 inp.data_attrs).max())
        qn_dev = torch.from_numpy(qn_host.astype(np.float32)).to(dev)
        dn_dev = torch.tensor(np.float32(dn_max), device=dev)
        # One launch per later pass over the resident dataset; the chunk
        # list goes once the concatenation is queued, so the dataset is
        # not resident twice for the sweep.
        d_full = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        telemetry.sample_memory_now()  # the dataset twice: the concat peak
        del chunks
        fds = []
        mir = MeasuredIters(self, impl, (qpad, full_rows, na, kc))
        for _ in range(1, npasses):
            floor, fd = _mp_floor(ods[-1], qn_dev, dn_dev,
                                  staging=self._staging, na=na,
                                  precision=prec)
            fds.append(fd)
            od, oi, iters = kern_full(q_dev, d_full, n_real=n, id_base=0,
                                      kc=kc, floor=floor, precision=prec)
            mir.add(iters)
            throttle.tick()
            ods.append(od)
            ois.append(oi)
        mir.done()
        # The last pass's fd too: a plateau pinning the last boundary
        # flags as well.
        fds.append(_mp_floor(ods[-1], qn_dev, dn_dev, staging=self._staging,
                             na=na, precision=prec)[1])
        self.last_phase_ms["enqueue"] = (time.perf_counter() - t0) * 1e3
        self.last_mp_passes = len(ods)
        obs_trace.instant("single.multipass_sweep", passes=len(ods),
                          kcap=kcap, chunks=n_staged)
        dense = n * na * self._staging_itemsize()
        note_scan(self, scanned_bytes=dense, dense_bytes=dense,
                  blocks_total=n_staged, blocks_pruned=0)

        glabels = torch.from_numpy(inp.labels.astype(np.int32)).to(dev)
        top, valid = _mp_merge(torch.cat(ods, 1), torch.cat(ois, 1),
                               glabels, kcap=kcap)
        # One readback for both checks: the fd sequence (stall) and the
        # valid counts (shortfall).
        valid_h, fd_h = resilient_get([valid, torch.stack(fds)])
        stalled = np.zeros(qpad, bool)
        for prev, cur in zip(fd_h, fd_h[1:]):
            stalled |= np.isfinite(cur) & (cur <= prev)
        needed = np.minimum(inp.ks.astype(np.int64), n)
        self._mp_hazard = stalled[:nq] | (valid_h[:nq] < needed)
        return [(top, qpad, None, "extract")]

    def _solve(self, inp: KNNInput) -> Tuple[TopK, int]:
        self.last_phase_ms = {}
        self.last_extract_impl = None
        self.last_prune = None
        select = self.config.resolve_select(
            round_up(max(inp.params.num_data, 1), 8))
        if select == "sort":
            return self._solve_scan(inp)
        # The "streaming" rung launches no extraction kernel: the
        # chunk fold below keeps no running-list kernel state.
        if select == "extract" and self._degrade_rung != "streaming":
            out = self._solve_extract(inp)
            if out is not None:
                return out
            # Empty problem, or a shape the extraction kernel cannot take:
            # the chunk fold on the streaming select.
        return self._solve_pipelined(inp)

    def _solve_extract_routed(self, inp: KNNInput, plan):
        """Split solve: the extraction kernel for the bulk queries and the
        streaming fold for the wide-k outliers, sharing one staging pass.
        Each chunk is staged once; the bulk's kernel launch and the
        outliers' fold run on the same device tensor. Returns a segment
        list for run(), or None when the bulk shape cannot tile."""
        from dmlp_tpu_torch.ops import fused
        from dmlp_tpu_torch.ops.extract import QUERY_TILE

        bulk, outl = plan
        cfg = self.config
        n = inp.params.num_data
        na = inp.params.num_attrs
        granule = cfg.resolve_granule("extract")
        t0 = time.perf_counter()
        _, nchunks, chunk_rows = plan_chunks(n, granule, cfg.data_block)
        qpad_b = round_up(len(bulk), QUERY_TILE)
        kb = resolve_kcap(cfg, int(inp.ks[bulk].max()), "extract",
                          nchunks * chunk_rows, staging=self._staging)
        kern, impl = fused.resolve_topk_kernel(qpad_b, chunk_rows, na, kb,
                                               rung=self._degrade_rung)
        if kern is None:
            return None
        select_out = streaming_fallback(cfg.use_pallas)
        ko = resolve_kcap(cfg, int(inp.ks[outl].max()), select_out,
                          nchunks * chunk_rows, staging=self._staging)
        prec = active_precision(self)
        self._last_select = "extract"
        self.last_extract_impl = impl
        self.last_hetk = (int(bulk.size), int(outl.size))
        rs_inject.fire("single.extract_solve", rung=self._degrade_rung,
                       path="routed")

        dev = self.device
        qb_dev = self._stage_queries(inp.query_attrs[bulk], qpad_b)
        qo_pad = round_up(len(outl), 8)
        qo_dev = self._stage_queries(inp.query_attrs[outl], qo_pad)
        labels_dev, _ = self._padded_ids_labels(inp, nchunks * chunk_rows)
        # One schedule for both query sets (they ride the same per-query
        # ks): the shared sweep skips only a chunk no query of either
        # segment can need.
        schedule, pruned = self._plan_prune(inp, nchunks, chunk_rows)
        live = [c for c in schedule if c * chunk_rows < n]
        host = self._pinned_chunks(inp, nchunks * chunk_rows)
        carry_o = init_topk(qo_pad, ko, dev)
        od = oi = None
        scanned = 0
        throttle = ChunkThrottle(dev)
        mi = MeasuredIters(self, impl, (qpad_b, chunk_rows, na, kb))
        for c in live:
            lo = c * chunk_rows
            hi = min(lo + chunk_rows, n)
            da = stage(host[lo:lo + chunk_rows], dev)
            scanned += (hi - lo) * na * self._staging_itemsize()
            od, oi, iters = kern(qb_dev, da, od, oi, n_real=hi - lo,
                                 id_base=lo, kc=kb, precision=prec)
            mi.add(iters)
            carry_o = _outlier_fold(carry_o, qo_dev, da, labels_dev, lo, n,
                                    k=ko, select=select_out,
                                    use_pallas=cfg.use_pallas)
            throttle.tick()
            telemetry.sample_memory_now()
        mi.done()
        note_scan(self, scanned_bytes=scanned,
                  dense_bytes=n * na * self._staging_itemsize(),
                  blocks_total=min(nchunks, -(-n // chunk_rows)),
                  blocks_pruned=pruned)
        self.last_phase_ms["enqueue"] = (time.perf_counter() - t0) * 1e3
        glabels = torch.from_numpy(inp.labels.astype(np.int32)).to(dev)
        top_b = extract_finalize(od, oi, glabels, kb)
        return [(top_b, qpad_b, bulk, "extract"),
                (carry_o, qo_pad, outl, select_out)]

    def _solve_segments(self, inp: KNNInput, allow_multipass: bool = True):
        """Solve as a list of (TopK, qpad, query_idx | None, select)
        segments: one for homogeneous k, two when the router splits the
        wide-k outliers off the extraction kernel's bulk. run() and
        run_device_full merge them by original query index.

        ``allow_multipass`` gates the all-wide-k multi-pass driver: only
        run()'s host repair makes its loss modes (a tie plateau, an
        eps-window shortfall) exact, so run_device_full, which has no
        repair, streams instead."""
        self.last_hetk = None
        self._mp_hazard = None
        self.last_mp_passes = 0
        self.last_extract_impl = None
        self.last_prune = None
        # The routed and multi-pass paths launch the extraction kernel;
        # the "streaming" rung goes straight to _solve, whose own gate
        # lands on the chunk fold.
        streaming = self._degrade_rung == "streaming"
        plan = None if streaming else hetk_split(
            self.config, self._staging, inp.ks, inp.params.num_data,
            round_up(max(inp.params.num_data, 1), 8))
        if plan is not None:
            self.last_phase_ms = {}
            segs = self._solve_extract_routed(inp, plan)
            if segs is not None:
                return segs
        if allow_multipass and not streaming:
            self.last_phase_ms = {}
            segs = self._solve_extract_multipass(inp)
            if segs is not None:
                return segs
        top, qpad = self._solve(inp)
        return [(top, qpad, None, self._last_select)]

    def candidates(self, inp: KNNInput
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Device pass: (Q, K) selection-ordered candidate lists."""
        memwatch.note_engine_model(self, inp)
        self._pending_iters = []
        out, _ = self._solve(inp)
        telemetry.sample_memory_now()
        nq = inp.params.num_queries
        od, ol, oi = resilient_get([out.dists, out.labels, out.ids])
        flush_measured_iters(self)
        return od.astype(np.float64)[:nq], ol[:nq], oi[:nq]

    def run(self, inp: KNNInput) -> List[QueryResult]:
        """Device candidates + host float64 finalize + boundary repair,
        through the degradation ladder: on an OOM, injected or real, the
        solve steps down a rung (``resilience.degrade``), every rung
        printing the same bytes."""
        return rs_degrade.run_ladder(self, inp, self._run)

    def _run(self, inp: KNNInput) -> List[QueryResult]:
        """One attempt at the current rung: the segments' candidates, then
        the host finalize, segment by segment, merged by original query
        index.

        In exact mode only the candidate ids and the two boundary columns
        are fetched (labels come from the ids on the host, distances are
        rescored in float64); fast mode also fetches the f32 distances,
        which are then the result. The fetch is the solve's fence."""
        cfg = self.config
        n = inp.params.num_data
        memwatch.note_engine_model(self, inp)
        self._pending_iters = []
        segments = self._solve_segments(inp)
        # A watermark tick at peak residency: the solve is enqueued,
        # nothing fetched yet (no-op without a telemetry session).
        telemetry.sample_memory_now()
        prec = active_precision(self)
        # What the first pass ran at, and the window slots the bound
        # inflation bought the rescore (kcap minus an f32 plan's).
        kcap0 = int(segments[0][0].dists.shape[1])
        kmax0 = int(inp.ks.max()) if inp.params.num_queries else 0
        self.last_precision = {
            "active": prec, "configured": cfg.resolve_precision(),
            "kcap": kcap0,
            "kcap_inflation": kcap0 - resolve_kcap(
                cfg, kmax0, self._last_select, kcap0,
                staging=self._staging, precision="f32")}
        self.last_repairs = 0
        merged: List[QueryResult] = [None] * inp.params.num_queries
        dn_max = None
        fetch_ms = final_ms = 0.0
        for top, qpad, idx, select in segments:
            sub = inp if idx is None else subset_queries(inp, idx)
            nq = sub.params.num_queries
            kcap = top.dists.shape[1]

            t0 = time.perf_counter()
            cols_dev = None
            if kcap < n:   # else every real row is a candidate: no hazard
                ks_pad = np.ones(qpad, np.int32)
                ks_pad[:nq] = sub.ks
                cols_dev = boundary_cols(
                    top.dists, torch.from_numpy(ks_pad).to(self.device))
            with obs_span("single.fetch", select=select, kcap=kcap):
                fetched = resilient_get(
                    ([] if cfg.exact else [top.dists]) + [top.ids]
                    + ([cols_dev] if cols_dev is not None else []))
            dists = None if cfg.exact \
                else fetched.pop(0).astype(np.float64)[:nq]
            ids = fetched.pop(0)[:nq]
            flags = None
            if cols_dev is not None:
                kth, last = fetched.pop(0).astype(np.float64)[:, :nq]
                if dn_max is None:
                    dn_max = float(np.einsum("na,na->n", inp.data_attrs,
                                             inp.data_attrs).max())
                qn = np.einsum("qa,qa->q", sub.query_attrs, sub.query_attrs)
                eps = staging_eps(last, qn, dn_max, self._staging,
                                  inp.params.num_attrs)
                if prec == "bf16" and select == "extract":
                    # The bf16 first pass perturbs the kernel's distances on
                    # top of the staging rounding; the seg fold never casts.
                    eps = eps + lowp_eps("bf16", qn, dn_max)
                flags = boundary_hazard(kth, last, eps)
            # The multi-pass driver's own loss flags join the test.
            if self._mp_hazard is not None and idx is None:
                flags = self._mp_hazard if flags is None \
                    else flags | self._mp_hazard
            labels = np.where(ids >= 0,
                              inp.labels[np.clip(ids, 0, max(n - 1, 0))],
                              -1) if n else np.full_like(ids, -1)
            fetch_ms += (time.perf_counter() - t0) * 1e3

            t0 = time.perf_counter()
            with obs_span("single.finalize", exact=cfg.exact) as sp:
                results = finalize_host(dists, labels, ids, sub.ks,
                                        sub.query_attrs, sub.data_attrs,
                                        exact=cfg.exact, query_ids=idx)
                if flags is not None:
                    suspects = np.nonzero(flags)[0]
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

    def run_device_full(self, inp: KNNInput) -> List[QueryResult]:
        """The all-device pipeline (the reference's benchmark mode): the
        same segments as run(), then the vote and the report order on the
        device in f32 (``_device_epilogue``); only the (Q, K) predictions,
        report ids and f32 distances are fetched, and they are the result.

        As in the reference it runs at the engine's own rung ("fused":
        dense, no prune plan), not through the ladder, and without the
        multi-pass driver (only run()'s repair makes that exact). Nothing
        is repaired, so ``last_repairs`` is 0, and ``last_prune`` is None:
        no prune plan ran. An explicit bfloat16 staging is honoured; "auto"
        stages float32 in the port, so the reference's no_auto_coarsen has
        nothing to do here."""
        n = inp.params.num_data
        num_labels = int(inp.labels.max()) + 1 if n else 1
        merged: List[QueryResult] = [None] * inp.params.num_queries
        memwatch.note_engine_model(self, inp)
        self._pending_iters = []
        segments = self._solve_segments(inp, allow_multipass=False)
        telemetry.sample_memory_now()
        fetch_ms = final_ms = 0.0
        for top, qpad, idx, _select in segments:
            sub = inp if idx is None else subset_queries(inp, idx)
            nq = sub.params.num_queries
            t0 = time.perf_counter()
            ks_pad = np.zeros(qpad, np.int32)
            ks_pad[:nq] = sub.ks
            pred, rids, rd = resilient_get(list(_device_epilogue(
                top, torch.from_numpy(ks_pad).to(self.device),
                num_labels=num_labels)))
            fetch_ms += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            rd = rd.astype(np.float64)
            gids = np.arange(nq) if idx is None else idx
            for qi in range(nq):
                k = int(sub.ks[qi])
                merged[int(gids[qi])] = QueryResult(
                    int(gids[qi]), k, int(pred[qi]),
                    rids[qi, :k].astype(np.int64), rd[qi, :k])
            final_ms += (time.perf_counter() - t0) * 1e3
        self.last_phase_ms["fetch"] = fetch_ms
        self.last_phase_ms["finalize"] = final_ms
        self.last_repairs = 0
        self.last_prune = None
        self.last_degrade_rung = self._degrade_rung
        flush_measured_iters(self)
        return merged
