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
"""

from __future__ import annotations

import ctypes

import torch

from dmlp_tpu_torch.kernels import LAUNCHES
from dmlp_tpu_torch.ops.distance import masked_pairwise_sq_l2

SEG = 128       # candidate-segment width: sets the seg select's gather order
QUERY_TILE = 64  # kernel TQ: query rows per CTA (ragged tiles are masked)


def supports(qb: int, b: int, a: int) -> bool:
    """Shapes the kernel takes: any qb >= 1 (a ragged last query tile is
    masked), whole SEG-column segments, any attribute count (attributes
    are staged through shared memory in chunks, so ``a`` sets no budget).
    One CTA per (64-row tile, segment), so the grid must fit 2^31 - 1."""
    return (qb >= 1 and a >= 1 and b >= SEG and b % SEG == 0
            and (b // SEG) * -(-qb // QUERY_TILE) < 2 ** 31)


def fused_dist_segmin_plain(q_attrs: torch.Tensor, d_attrs: torch.Tensor,
                            data_ids: torch.Tensor, precision: str = "f32"):
    """The plain PyTorch version: ``masked_pairwise_sq_l2`` (IEEE f32;
    "bf16" rounds the product's operands, the norms stay f32), then the
    min of every SEG-column segment of that tile."""
    dist = masked_pairwise_sq_l2(q_attrs, d_attrs, data_ids, precision)
    qb, b = dist.shape
    return dist, dist.view(qb, b // SEG, SEG).min(-1).values


def _kernel_lib() -> ctypes.CDLL:
    from dmlp_tpu_torch import kernels
    lib = kernels.load("dist_segmin")
    if not getattr(lib, "_dmlp_checked", False):
        lib.dmlp_segmin_seg.restype = ctypes.c_int
        lib.dmlp_segmin_tile_q.restype = ctypes.c_int
        got = (lib.dmlp_segmin_seg(), lib.dmlp_segmin_tile_q())
        if got != (SEG, QUERY_TILE):
            raise RuntimeError(f"dist_segmin.cu tiles {got} != wrapper's "
                               f"{(SEG, QUERY_TILE)}")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dmlp_dist_segmin.restype = i
        lib.dmlp_dist_segmin.argtypes = [p] * 7 + [i] * 4 + [p]
        lib._dmlp_checked = True
    return lib


def _fused_dist_segmin_cuda(q_attrs, d_attrs, data_ids, precision):
    qb, na = q_attrs.shape
    b = d_attrs.shape[0]
    dev = q_attrs.device
    q = q_attrs.float().contiguous()
    d = d_attrs.float().contiguous()
    ids = data_ids.to(torch.int32).contiguous()
    if d.device != dev or ids.device != dev:
        raise ValueError("all inputs must be on one device")
    if ids.shape != (b,):
        raise ValueError(f"ids must be ({b},), got {tuple(ids.shape)}")
    qn = (q * q).sum(-1)
    dn = (d * d).sum(-1)
    dist = torch.empty((qb, b), dtype=torch.float32, device=dev)
    segmin = torch.empty((qb, b // SEG), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    # Asynchronous on the current stream; the temporaries freed on return
    # go back to the caching allocator for that stream (see ops.extract).
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dmlp_dist_segmin(
            q.data_ptr(), d.data_ptr(), qn.data_ptr(), dn.data_ptr(),
            ids.data_ptr(), dist.data_ptr(), segmin.data_ptr(), qb, b, na,
            int(precision == "bf16"), stream)
    if rc != 0:
        raise RuntimeError(f"dist_segmin kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES["fused_dist_segmin"] += 1
    return dist, segmin


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
    return fused_dist_segmin_plain(q_attrs, d_attrs, data_ids, precision)
