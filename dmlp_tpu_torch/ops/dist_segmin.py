"""Fused masked distance tile + per-segment minima (K3): wrapper and plain
version.

Port of ``dmlp_tpu/ops/pallas_distance.py``. The "seg" fold
(``ops.topk.make_block_step``) needs two views of each distance tile: the
tile itself, to gather candidate columns from, and the minimum of every
SEG-column segment, to pick the candidate segments. ``fused_dist_segmin``
has the reference signature and outputs minus ``interpret``: on a CUDA
tensor it launches the hand-written kernel
``dmlp_tpu_torch/kernels/dist_segmin.cu`` (built at first use; any failure
raises), on a CPU tensor it runs :func:`fused_dist_segmin_plain`. Nothing
else picks between them. The reference emits segmin transposed for Mosaic's
tiling; here it is (Qb, B/SEG).

The kernel tiles the output in QUERY_TILE x SEG tiles, and each CTA walks
``group`` consecutive segments of one row tile: G from the tune cache's
``fused_dist_segmin`` namespace where it holds a winner for the launch,
else :func:`choose_group` (:func:`resolve_group`). The plain version takes
the same G and computes the tile one group of segments at a time. The
kernel reads its operands attribute-major, as :func:`prepare_operands`
makes them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dmlp_tpu_torch.kernels import (KernelBuildError, KernelLaunchError,
                                    note_launch)
from dmlp_tpu_torch.obs import counters as obs_counters
from dmlp_tpu_torch.ops.distance import masked_pairwise_sq_l2
from dmlp_tpu_torch.tune.cache import dtype_key, lookup_variant

SEG = 128         # candidate-segment width: sets the seg select's gather order
QUERY_TILE = 128  # kernel TQ: query rows per tile (ragged tiles are masked)
CTAS_PER_SM = 2   # kernel CTAS_PER_SM: resident CTAs per SM (launch bounds)
# choose_group's cost model: a CTA pays about GROUP_OVERHEAD tiles' time
# before its first tile (the ring's first chunks in flight, nothing to
# overlap them with); fitted to chip_smoke.py's g_sweep on an H100 80GB
# HBM3 (700 W): at 5,624 x 50,176 x 64, G = 1 (66 waves) ran 2.5% slower
# than one wave of G = 66.
GROUP_OVERHEAD = 0.025


def supports(qb: int, b: int, a: int) -> bool:
    """Shapes the kernel takes: any qb >= 1 (a ragged last query tile is
    masked), whole SEG-column segments, any attribute count (attributes
    are staged in chunks, so ``a`` sets no budget). At most one CTA per
    (QUERY_TILE-row tile, segment), so that grid must fit 2^31 - 1."""
    return (qb >= 1 and a >= 1 and b >= SEG and b % SEG == 0
            and (b // SEG) * -(-qb // QUERY_TILE) < 2 ** 31)


def segment_groups(nseg: int, group: int) -> list:
    """The segments each CTA of one row tile walks, as the kernel assigns
    them: CTA g takes [g * group, min((g + 1) * group, nseg))."""
    return [range(s, min(s + group, nseg)) for s in range(0, nseg, group)]


@functools.lru_cache(maxsize=256)
def choose_group(qb: int, b: int, sm_count: int) -> int:
    """G, the segments one CTA walks, on a card with ``sm_count`` SMs; a
    pure function.

    CTAs = ceil(qb / QUERY_TILE) * ceil(nseg / G) run in waves of
    sm_count * CTAS_PER_SM; each takes G tiles after about GROUP_OVERHEAD
    tiles of start-up, so cost(G) = waves(G) * (G + GROUP_OVERHEAD).
    Returns the smallest G of the least cost."""
    tiles, nseg = -(-qb // QUERY_TILE), b // SEG
    slots = sm_count * CTAS_PER_SM
    costs = [-(-tiles * -(-nseg // g) // slots) * (g + GROUP_OVERHEAD)
             for g in range(1, nseg + 1)]
    return costs.index(min(costs)) + 1


def resolve_group(qb: int, b: int, a: int, *, device,
                  precision: str = "f32", dtype: str = "float32") -> int:
    """G for one launch: the tune cache's measured winner where one exists
    and lies within 1..nseg, else the heuristic — :func:`choose_group` for
    the card's SM count on a CUDA device, nseg (one group: the whole tile)
    on the CPU (:func:`heuristic_group`). A misfit never disables the
    kernel."""
    nseg = b // SEG
    v = lookup_variant("fused_dist_segmin", qb=qb, b=b, a=a, kc=0,
                                  device=device, dtype=dtype,
                                  precision=precision)
    if v is not None and v["group"] <= nseg:
        return v["group"]
    return heuristic_group(qb, b, device)


def heuristic_group(qb: int, b: int, device) -> int:
    """G without the tune cache: :func:`choose_group` for the card's SM
    count on a CUDA device, nseg (the whole tile) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return b // SEG
    return choose_group(qb, b, torch.cuda.get_device_properties(
        device).multi_processor_count)


def prepare_operands(q_attrs: torch.Tensor, d_attrs: torch.Tensor,
                     precision: str = "f32"):
    """The kernel's operands: (qT (A, ldq), dT (A, B), qn (Qb,), dn (B,)).

    qT and dT are the rows transposed to attribute-major, so each chunk of
    attributes is contiguous per side; qT's columns are padded with zeros
    to ldq, a multiple of QUERY_TILE. For bf16 both are rounded to
    bfloat16 here, once (round to nearest even). qn and dn are the f32
    squared norms of the unrounded rows."""
    q, d = q_attrs.float(), d_attrs.float()
    qn, dn = (q * q).sum(-1), (d * d).sum(-1)
    if precision == "bf16":
        q, d = q.to(torch.bfloat16).float(), d.to(torch.bfloat16).float()
    qb, na = q.shape
    qT = q.new_empty((na, -(-qb // QUERY_TILE) * QUERY_TILE))
    qT[:, :qb] = q.t()
    if qT.shape[1] > qb:
        qT[:, qb:] = 0.0
    return qT, d.t().contiguous(), qn, dn


def fused_dist_segmin_plain(q_attrs: torch.Tensor, d_attrs: torch.Tensor,
                            data_ids: torch.Tensor, precision: str = "f32",
                            group: int | None = None):
    """The plain PyTorch version: ``masked_pairwise_sq_l2`` (IEEE f32;
    "bf16" rounds the product's operands, the norms stay f32), then the
    min of every SEG-column segment of that tile. With ``group`` the tile
    is computed ``group`` segments at a time, the columns a kernel CTA
    walks (:func:`segment_groups`); None is one group."""
    b = d_attrs.shape[0]
    nseg = b // SEG
    if group is None or group >= nseg:
        dist = masked_pairwise_sq_l2(q_attrs, d_attrs, data_ids, precision)
    else:
        dist = torch.cat([masked_pairwise_sq_l2(
            q_attrs, d_attrs[g.start * SEG:g.stop * SEG],
            data_ids[g.start * SEG:g.stop * SEG], precision)
            for g in segment_groups(nseg, group)], 1)
    qb = dist.shape[0]
    return dist, dist.view(qb, nseg, SEG).min(-1).values


def _kernel_lib() -> ctypes.CDLL:
    from dmlp_tpu_torch import kernels
    lib = kernels.load("dist_segmin")
    if not getattr(lib, "_dmlp_checked", False):
        for f in ("dmlp_segmin_seg", "dmlp_segmin_tile_q",
                  "dmlp_segmin_ctas_per_sm", "dmlp_segmin_occupancy"):
            getattr(lib, f).restype = ctypes.c_int
        got = (lib.dmlp_segmin_seg(), lib.dmlp_segmin_tile_q(),
               lib.dmlp_segmin_ctas_per_sm())
        if got != (SEG, QUERY_TILE, CTAS_PER_SM):
            raise KernelBuildError(
                f"dist_segmin.cu tiles {got} != wrapper's "
                f"{(SEG, QUERY_TILE, CTAS_PER_SM)}")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dmlp_dist_segmin.restype = i
        lib.dmlp_dist_segmin.argtypes = [p] * 7 + [i] * 5 + [p]
        lib._dmlp_checked = True
    return lib


def _fused_dist_segmin_cuda(q_attrs, d_attrs, data_ids, precision):
    qb, na = q_attrs.shape
    b = d_attrs.shape[0]
    dev = q_attrs.device
    if d_attrs.device != dev or data_ids.device != dev:
        raise ValueError("all inputs must be on one device")
    if data_ids.shape != (b,):
        raise ValueError(f"ids must be ({b},), got {tuple(data_ids.shape)}")
    group = resolve_group(qb, b, q_attrs.shape[1], device=dev,
                          precision=precision, dtype=dtype_key(d_attrs))
    dist = torch.empty((qb, b), dtype=torch.float32, device=dev)
    segmin = torch.empty((qb, b // SEG), dtype=torch.float32, device=dev)
    _launch(*launch_operands(q_attrs, d_attrs, data_ids, precision), dist,
            segmin, group, precision)
    return dist, segmin


def launch_operands(q_attrs, d_attrs, data_ids, precision: str = "f32"):
    """:func:`prepare_operands` plus the ids as the kernel reads them
    (int32, 16-byte aligned: it loads them as int4s), in :func:`_launch`'s
    order."""
    ids = data_ids.to(torch.int32).contiguous()
    if ids.data_ptr() % 16:
        ids = ids.clone()
    return (*prepare_operands(q_attrs, d_attrs, precision), ids)


def _launch_shape(qb: int, b: int, na: int, precision: str,
                  group) -> dict:
    """One K3 launch's shape as obs.counters records it."""
    return {"qb": qb, "b": b, "a": na, "precision": precision,
            "group": group}


def _launch(qT, dT, qn, dn, ids, dist, segmin, group: int,
            precision: str = "f32") -> None:
    """One kernel launch on operands as :func:`prepare_operands` makes
    them (ids int32, 16-byte aligned) into preallocated outputs, with
    each CTA walking ``group`` segments (1 <= group <= B/SEG); raises when
    the launch fails, counts it when it succeeds. ``precision`` is what
    the operands were prepared at (for the cost record only)."""
    lib = _kernel_lib()
    dev = dist.device
    # Asynchronous on the current stream; the temporaries freed on return
    # go back to the caching allocator for that stream (see ops.extract).
    with torch.cuda.device(dev):
        rec = obs_counters.record_dispatch(
            "fused_dist_segmin", _launch_shape(
                dist.shape[0], dist.shape[1], qT.shape[0],
                precision, group), dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dmlp_dist_segmin(
            qT.data_ptr(), dT.data_ptr(), qn.data_ptr(), dn.data_ptr(),
            ids.data_ptr(), dist.data_ptr(), segmin.data_ptr(),
            dist.shape[0], qT.shape[1], dist.shape[1], qT.shape[0], group,
            stream)
        if rec is not None:
            rec.done()
    if rc != 0:
        raise KernelLaunchError(f"dist_segmin kernel launch failed "
                                f"(cudaError {rc})")
    note_launch("fused_dist_segmin", group)


def fused_dist_segmin(q_attrs: torch.Tensor, d_attrs: torch.Tensor,
                      data_ids: torch.Tensor, precision: str = "f32"):
    """(queries (Qb, A), data (B, A), ids (B,)) -> (dist (Qb, B) f32,
    segmin (Qb, B/SEG) f32). Sentinel columns (id < 0) give +inf; B must
    be whole SEG-column segments. ``precision`` ("f32" | "bf16") is the
    product's operand type; bf16 distances carry
    ``engine.finalize.lowp_eps``."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unsupported first-pass precision {precision!r}")
    qb, a = q_attrs.shape
    b = d_attrs.shape[0]
    if not supports(qb, b, a):
        raise ValueError(f"untileable shape (qb={qb}, b={b}, a={a}); "
                         "gate on supports() first")
    if q_attrs.is_cuda:
        return _fused_dist_segmin_cuda(q_attrs, d_attrs, data_ids, precision)
    if q_attrs.device.type != "cpu":
        raise ValueError(f"fused_dist_segmin runs on cuda or cpu, not "
                         f"{q_attrs.device}")
    group = resolve_group(qb, b, a, device=q_attrs.device,
                          precision=precision, dtype=dtype_key(d_attrs))
    obs_counters.record_dispatch("fused_dist_segmin",
                                 _launch_shape(qb, b, a, precision, group))
    return fused_dist_segmin_plain(q_attrs, d_attrs, data_ids, precision,
                                   group)
