"""The gated extraction kernel (K1) and the engine's kernel selector.

Port of ``dmlp_tpu/ops/pallas_fused.py``. ``fused_topk`` is
``extract_topk`` with the norm-bound tile gate on: per data block, a sound
per-row lower bound from the streamed norms ((|q| - |d|)^2 over the block's
real |d| range, deflated by the f32 error bound of engine.finalize) skips
the product and the extraction when no row can improve. Gate on and gate off
give identical lists. ``DMLP_TPU_FUSED=0`` turns the gate off everywhere,
and so do the degradation ladder's rungs below "fused".
There is no tune cache yet (ROADMAP A8): every shape resolves to the
kernel's fixed tiles.
"""

from __future__ import annotations

import os

from dmlp_tpu_torch.ops.extract import (extract_topk, resolve_variant,
                                         supports)


def fused_enabled() -> bool:
    """The fused-path kill switch ($DMLP_TPU_FUSED=0 disables), read per
    call."""
    return os.environ.get("DMLP_TPU_FUSED", "1") != "0"


def variant_for(impl: str, kc: int, b: int, qb: int | None = None,
                a: int | None = None, precision: str = "f32") -> dict:
    """The variant an impl label ("fused" | "extract") runs with."""
    return resolve_variant(kc, b, qb, a, precision)


def fused_topk(q_attrs, d_attrs, carry_d=None, carry_i=None, *, n_real,
               id_base=0, kc: int, block_skip: bool = True, floor=None,
               precision: str = "f32", splits: int | None = None):
    """extract_topk with the norm gate on; same outputs, identical lists.
    ``iters`` reports 0 for blocks either the gate or the prefilter
    skipped. ``splits`` as for extract_topk."""
    return extract_topk(q_attrs, d_attrs, carry_d, carry_i, n_real=n_real,
                        id_base=id_base, kc=kc, block_skip=block_skip,
                        mxu_gate=True, floor=floor, precision=precision,
                        splits=splits)


def resolve_topk_kernel(qb: int, b: int, a: int, kc: int,
                        rung: str = "fused"):
    """(kernel callable, impl label) for one extract dispatch shape, or
    (None, None) when the kernel cannot tile it: the gated kernel while
    the kill switch allows it and the degradation rung is at or above
    "fused" (resilience.degrade), else the ungated one."""
    if not supports(qb, b, a, kc):   # the gate adds only per-block scalars
        return None, None
    if rung in ("lowp", "prune", "fused") and fused_enabled():
        return fused_topk, "fused"
    return extract_topk, "extract"
