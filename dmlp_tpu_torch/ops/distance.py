"""Pairwise squared-L2 distance through the norm expansion, in PyTorch.

Port of ``dmlp_tpu/ops/distance.py``: |q - d|^2 = |q|^2 + |d|^2 - 2 <q, d>,
clamped at 0, with padded (id < 0) points pushed to +inf. The cross term is
one ``torch.matmul``. On the card it must run in IEEE float32: the eps
bounds of ``engine.finalize`` (EPS_REL_F32, EPS_CANCEL_COEF) hold only for
full-precision products, and TF32 keeps about three decimal digits — the
Hopper form of the TPU's DEFAULT-precision trap that the reference pins
``Precision.HIGHEST`` against. ``require_ieee_f32`` refuses to run
otherwise; nothing here ever changes the global matmul precision.
"""

from __future__ import annotations

import torch


def require_ieee_f32(t: torch.Tensor) -> None:
    """Raise unless float32 matmuls on ``t``'s device are full IEEE f32."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmuls are set to TF32 (allow_tf32 / "
            "float32_matmul_precision); the distance eps bounds need IEEE "
            "float32 products")


def pairwise_sq_l2(queries: torch.Tensor, data: torch.Tensor,
                   precision: str = "f32") -> torch.Tensor:
    """(Q, A) x (N, A) -> (Q, N) float32 squared distances, clamped at 0.
    ``precision="bf16"`` rounds the product's operands to bfloat16; the
    norms stay those of the float32 rows."""
    q = queries.float()
    d = data.float()
    require_ieee_f32(q)
    qn = (q * q).sum(-1)
    dn = (d * d).sum(-1)
    if precision == "bf16":
        # check: lowp-eps=lowp_eps
        q, d = q.to(torch.bfloat16).float(), d.to(torch.bfloat16).float()
    cross = q @ d.T
    return torch.clamp_min(qn[:, None] + dn[None, :] - 2.0 * cross, 0.0)


def masked_pairwise_sq_l2(queries: torch.Tensor, data: torch.Tensor,
                          data_ids: torch.Tensor,
                          precision: str = "f32") -> torch.Tensor:
    """Like :func:`pairwise_sq_l2`, with +inf where ``data_ids < 0`` (the
    id = -1 sentinel rows that pad the dataset to whole blocks)."""
    dist = pairwise_sq_l2(queries, data, precision)
    return torch.where(data_ids[None, :] < 0, torch.inf, dist)
