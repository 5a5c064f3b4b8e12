"""Single-device KNN engine — port of ``dmlp_tpu/engine/single.py``.

The same solve as the reference engine on one device: the data is padded
and staged in chunks, each chunk is folded into running (Q, K) candidate
lists, and the host rescores the candidates in float64, votes, and repairs
the queries whose candidate boundary may have truncated a tie group. Three
device paths, picked by ``EngineConfig.resolve_select``:

- "sort" (<= 8192 padded rows): whole-dataset staging and a strict
  (dist asc, id desc) blockwise merge;
- "topk": chunked staging from pinned host memory with a running top-k
  that keeps the lowest position on ties;
- "extract" (``use_pallas``): chunked staging and the hand-written
  extraction kernel (``ops.fused.fused_topk``, or ``ops.extract.
  extract_topk`` with ``DMLP_TPU_FUSED=0``); on the CPU its plain PyTorch
  version.

Not ported yet (ROADMAP.md): the pruned two-stage solve (A6 — the port
scans every chunk), the degradation ladder (A7; the engine runs at the top
rung's kernel choice), the tune cache (A8), the heterogeneous-k router and
the multi-pass wide-k driver (slice 2; a kc above the kernel's 512 raises
NotImplementedError), ``run_device_full`` and observability.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.finalize import (boundary_hazard, finalize_host,
                                            lowp_eps,
                                            repair_boundary_overflow,
                                            staging_eps)
from dmlp_tpu_torch.io.grammar import KNNInput
from dmlp_tpu_torch.io.report import QueryResult
from dmlp_tpu_torch.ops.topk import (SEG_NOT_PORTED, TopK, init_topk,
                                     make_block_step, select_topk,
                                     streaming_topk)

# Per-chunk distance-tile budget of the "topk" driver (bytes): the live
# (query rows x chunk rows) f32 tile stays below it.
_TILE_BUDGET = 1 << 30

# Max staged-but-unfolded chunks in flight (the reference's window).
_CHUNK_WINDOW = 8


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
    """Host-to-device copy, asynchronous from pinned memory."""
    return host.to(device, non_blocking=True)


def plan_chunks(n: int, granule: int, target: int | None) -> Tuple[int, int, int]:
    """(npad, nchunks, chunk_rows): ~``target``-row chunks (default
    51200) of whole ``granule`` blocks covering ``n``."""
    npad = round_up(max(n, 1), granule)
    t = round_up(target or 51200, granule)
    nchunks = max(1, -(-npad // t))
    chunk_rows = round_up(-(-npad // nchunks), granule)
    return npad, nchunks, chunk_rows


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


class SingleChipEngine:
    """The one-device engine: on the card by default, on the CPU when the
    configuration asks for it."""

    def __init__(self, config: EngineConfig = EngineConfig()):
        if config.mode != "single":
            raise NotImplementedError(
                f"mode {config.mode!r}: the mesh engines are ROADMAP.md "
                "item A9 — not ported yet")
        self.config = config
        self.device = config.torch_device()
        self._staging = config.resolve_dtype()
        self._last_select = None
        self.last_phase_ms: dict = {}
        self.last_extract_impl = None
        self.last_repairs = 0

    def _stage_queries(self, inp: KNNInput, qpad: int) -> torch.Tensor:
        q = np.zeros((qpad, inp.params.num_attrs), np.float32)
        q[:inp.params.num_queries] = inp.query_attrs
        return stage(host_staging(q, self.device, self._staging),
                     self.device)

    def _pinned_chunks(self, inp: KNNInput, rows: int) -> torch.Tensor:
        """The dataset padded with zero rows to ``rows``, as one (pinned,
        on the card) host tensor the chunk loop slices."""
        a = np.zeros((rows, inp.params.num_attrs), np.float32)
        n = inp.params.num_data
        a[:n] = inp.data_attrs
        return host_staging(a, self.device, self._staging)

    def _solve_scan(self, inp: KNNInput) -> Tuple[TopK, int]:
        """Whole-dataset staging and one blockwise fold ("sort")."""
        cfg = self.config
        n = inp.params.num_data
        nq = inp.params.num_queries
        select = cfg.resolve_streaming_select(round_up(max(n, 1), 8))
        if select == "seg":
            raise NotImplementedError(SEG_NOT_PORTED)
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
        q_dev = self._stage_queries(inp, qpad)
        outs = [streaming_topk(q_dev[i:i + qb], d_attrs, d_labels, d_ids,
                               k, data_block, select)
                for i in range(0, qpad, qb)]
        return TopK(*(torch.cat(parts) for parts in zip(*outs))), qpad

    def _solve_pipelined(self, inp: KNNInput,
                         select: str | None = None) -> Tuple[TopK, int]:
        """Chunked staging from pinned host memory + one fold per chunk
        ("topk"), under the ChunkThrottle window."""
        cfg = self.config
        n = inp.params.num_data
        na = inp.params.num_attrs
        nq = inp.params.num_queries
        if select is None:
            select = cfg.resolve_streaming_select(round_up(max(n, 1), 8))
        if select == "seg":
            raise NotImplementedError(SEG_NOT_PORTED)
        self._last_select = select
        granule = cfg.resolve_granule(select)
        t0 = time.perf_counter()
        _, nchunks, chunk_rows = plan_chunks(n, granule, cfg.data_block)
        qgran = 8
        qpad = round_up(max(nq, 1), qgran)
        qsb = min(qpad, round_up(cfg.query_block, qgran))
        while qsb > qgran and qsb * chunk_rows * 4 > _TILE_BUDGET:
            qsb -= qgran
        nqb = -(-qpad // qsb)
        qpad = nqb * qsb
        kmax = int(inp.ks.max()) if nq else 1
        k = resolve_kcap(cfg, kmax, select, nchunks * chunk_rows,
                         staging=self._staging)

        dev = self.device
        q_dev = self._stage_queries(inp, qpad)
        host = self._pinned_chunks(inp, nchunks * chunk_rows)
        labels = np.full(nchunks * chunk_rows, -1, np.int32)
        labels[:n] = inp.labels
        ids = np.full(nchunks * chunk_rows, -1, np.int32)
        ids[:n] = np.arange(n, dtype=np.int32)
        d_labels = torch.from_numpy(labels).to(dev)
        d_ids = torch.from_numpy(ids).to(dev)
        step = make_block_step(select, k)
        carries = [init_topk(qsb, k, dev) for _ in range(nqb)]
        throttle = ChunkThrottle(dev)
        for c in range(nchunks):
            lo, hi = c * chunk_rows, (c + 1) * chunk_rows
            da = stage(host[lo:hi], dev)
            for b in range(nqb):
                carries[b] = step(carries[b], q_dev[b * qsb:(b + 1) * qsb],
                                  da, d_labels[lo:hi], d_ids[lo:hi])
            throttle.tick()
        self.last_phase_ms["enqueue"] = (time.perf_counter() - t0) * 1e3
        return TopK(*(torch.cat(parts) for parts in zip(*carries))), qpad

    def _solve_extract(self, inp: KNNInput) -> Tuple[TopK, int] | None:
        """Chunked staging + the extraction kernel ("extract"). Chunks
        are contiguous row ranges, so the kernel's ids are affine (id_base
        = chunk start). None for an empty problem."""
        from dmlp_tpu_torch.ops import fused
        from dmlp_tpu_torch.ops.extract import KC_MAX, QUERY_TILE

        cfg = self.config
        n = inp.params.num_data
        na = inp.params.num_attrs
        nq = inp.params.num_queries
        if n == 0 or nq == 0:
            return None
        granule = cfg.resolve_granule("extract")
        t0 = time.perf_counter()
        _, nchunks, chunk_rows = plan_chunks(n, granule, cfg.data_block)
        qpad = round_up(nq, QUERY_TILE)
        kmax = int(inp.ks.max())
        k = resolve_kcap(cfg, kmax, "extract", nchunks * chunk_rows,
                         staging=self._staging)
        kern, impl = fused.resolve_topk_kernel(qpad, chunk_rows, na, k)
        if kern is None:
            raise NotImplementedError(
                f"candidate width kc={k} exceeds the extraction kernel's "
                f"{KC_MAX}: the heterogeneous-k router and the multi-pass "
                "driver are ROADMAP.md slice 2 — not ported yet")
        prec = cfg.resolve_precision()
        self._last_select = "extract"
        self.last_extract_impl = impl

        dev = self.device
        q_dev = self._stage_queries(inp, qpad)
        host = self._pinned_chunks(inp, nchunks * chunk_rows)
        od = oi = None
        throttle = ChunkThrottle(dev)
        for c in range(nchunks):
            lo = c * chunk_rows
            if lo >= n:
                break   # an all-padding final chunk is never staged
            hi = min(lo + chunk_rows, n)
            da = stage(host[lo:lo + chunk_rows], dev)
            od, oi, _iters = kern(q_dev, da, od, oi, n_real=hi - lo,
                                  id_base=lo, kc=k, precision=prec)
            throttle.tick()
        self.last_phase_ms["enqueue"] = (time.perf_counter() - t0) * 1e3
        glabels = torch.from_numpy(inp.labels.astype(np.int32)).to(dev)
        return extract_finalize(od, oi, glabels, k), qpad

    def _solve(self, inp: KNNInput) -> Tuple[TopK, int]:
        self.last_phase_ms = {}
        self.last_extract_impl = None
        select = self.config.resolve_select(
            round_up(max(inp.params.num_data, 1), 8))
        if select == "sort":
            return self._solve_scan(inp)
        if select == "seg":
            raise NotImplementedError(SEG_NOT_PORTED)
        if select == "extract":
            out = self._solve_extract(inp)
            if out is not None:
                return out
            # Empty problem (no data or no queries): nothing to extract;
            # the plain chunk fold gives the padded (-1) result.
            return self._solve_pipelined(inp, select="topk")
        return self._solve_pipelined(inp)

    def candidates(self, inp: KNNInput
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Device pass: (Q, K) selection-ordered candidate lists."""
        out, _ = self._solve(inp)
        nq = inp.params.num_queries
        dists = out.dists.cpu().numpy().astype(np.float64)[:nq]
        return dists, out.labels.cpu().numpy()[:nq], out.ids.cpu().numpy()[:nq]

    def run(self, inp: KNNInput) -> List[QueryResult]:
        """Device candidates + host float64 finalize + boundary repair.

        In exact mode only the candidate ids and the two boundary columns
        are fetched (labels come from the ids on the host, distances are
        rescored in float64); fast mode also fetches the f32 distances,
        which are then the result. The fetch is the solve's fence."""
        cfg = self.config
        n = inp.params.num_data
        nq = inp.params.num_queries
        top, qpad = self._solve(inp)
        select = self._last_select
        kcap = top.dists.shape[1]
        self.last_repairs = 0

        t0 = time.perf_counter()
        cols_dev = None
        if kcap < n:   # else every real row is a candidate: no hazard
            ks_pad = np.ones(qpad, np.int32)
            ks_pad[:nq] = inp.ks
            cols_dev = boundary_cols(
                top.dists, torch.from_numpy(ks_pad).to(self.device))
        dists = None if cfg.exact \
            else top.dists.cpu().numpy().astype(np.float64)[:nq]
        ids = top.ids.cpu().numpy()[:nq]
        flags = None
        if cols_dev is not None:
            kth, last = cols_dev.cpu().numpy().astype(np.float64)[:, :nq]
            dn_max = float(np.einsum("na,na->n", inp.data_attrs,
                                     inp.data_attrs).max()) if n else 0.0
            qn = np.einsum("qa,qa->q", inp.query_attrs, inp.query_attrs)
            eps = staging_eps(last, qn, dn_max, self._staging,
                              inp.params.num_attrs)
            if cfg.resolve_precision() == "bf16" and select == "extract":
                eps = eps + lowp_eps("bf16", qn, dn_max)
            flags = boundary_hazard(kth, last, eps)
        labels = np.where(ids >= 0,
                          inp.labels[np.clip(ids, 0, max(n - 1, 0))], -1) \
            if n else np.full_like(ids, -1)
        self.last_phase_ms["fetch"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        results = finalize_host(dists, labels, ids, inp.ks, inp.query_attrs,
                                inp.data_attrs, exact=cfg.exact)
        if flags is not None:
            suspects = np.nonzero(flags)[0]
            if suspects.size:
                repair_boundary_overflow(results, suspects, inp)
                self.last_repairs = int(suspects.size)
        self.last_phase_ms["finalize"] = (time.perf_counter() - t0) * 1e3
        return results
