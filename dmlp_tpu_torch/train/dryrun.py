"""Multi-rank training dry run — port of ``dmlp_tpu/train/dryrun.py``.

Over the ranks of the initialized process group: a (dp, tp) mesh runs
two steps of the full train step (forward, backward, the dp gradient
all-reduce, tp-sharded weights) on small shapes, with finite losses, the
second below the first on the same batch, and the first equal to a
one-rank run of the same step. With 4 ranks or more it also runs one step
of each pipeline and MoE family against its flat or unsharded oracle, all
at rtol 2e-5 as in the reference: dp x pp against ``flat_forward``, the
dense and the all-to-all MoE (capacity = the local tokens, so nothing
drops) against ``moe_reference_forward``, and dp x tp x pp on (n / 4, 2,
2) against ``pp3_reference_forward``.

Every rank calls :func:`dryrun_train` with the same arguments; a failed
check raises on every rank that sees it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dmlp_tpu_torch.train.sharding import (batch_slice, dp_group,
                                           full_tensor, in_mesh,
                                           make_train_mesh)
from dmlp_tpu_torch.train.step import (global_metrics, make_optimizer,
                                       make_train_step)

RTOL = 2e-5


def _close(got: float, want: float, what: str) -> None:
    if not np.isclose(got, want, rtol=RTOL, atol=0):
        raise AssertionError(f"dry run, {what}: {got} against {want} "
                             f"(rtol {RTOL})")


def _full(state):
    """Every parameter whole, as the step starts (collective)."""
    with torch.no_grad():
        return {n: full_tensor(p.detach()).clone()
                for n, p in state["params"].named_parameters()}


def _ce(logits: torch.Tensor, y: np.ndarray) -> float:
    return float(F.cross_entropy(logits, torch.from_numpy(y).long().to(
        logits.device)))


def dryrun_train(device="cuda") -> dict:
    """The dry run on every rank of the initialized group (one rank
    without one); returns the losses it checked."""
    from dmlp_tpu_torch.train.loop import build_sharded_state
    from dmlp_tpu_torch.train.model import resolve_device

    device = resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    tp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // tp
    dims = (16, 32, 32, 8)
    batch = 8 * dp
    optimizer = make_optimizer("sgd", 0.05)
    out = {}

    mesh = make_train_mesh((dp, tp), device_type=device.type)
    state = build_sharded_state(mesh, dims, optimizer, seed=3, device=device)
    step_fn = make_train_step(optimizer, dp_group=dp_group(mesh))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], batch).astype(np.int32)
    xs, ys = (torch.from_numpy(a).to(device) for a in batch_slice(x, y,
                                                                  mesh))
    losses = []
    for _ in range(2):
        state, m = step_fn(state, xs, ys)
        losses.append(global_metrics(m, dp_group(mesh))["loss"])
    if not (np.isfinite(losses).all() and losses[1] < losses[0]):
        raise AssertionError(f"dry run, dp x tp: losses {losses}; the "
                             "second step on the same batch must be lower")
    # The sharded step against one rank's run of the same step.
    one = build_sharded_state(None, dims, optimizer, seed=3, device=device)
    _, sm = make_train_step(optimizer)(one, torch.from_numpy(x).to(device),
                                       torch.from_numpy(y).to(device))
    _close(global_metrics(sm)["loss"], losses[0], "dp x tp vs one rank")
    out["dp_tp"] = losses

    if n < 4:
        return out
    from dmlp_tpu_torch.train import experts as ex
    from dmlp_tpu_torch.train import pipeline as pl

    dt = device.type
    d_pp = n // 4
    xb = rng.normal(size=(8 * d_pp, 6)).astype(np.float32)
    yb = rng.integers(0, 4, 8 * d_pp).astype(np.int32)
    x_all = torch.from_numpy(xb).to(device)

    def local(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays]

    # The meshes take the first 4 * (n // 4) ranks; the others make the
    # meshes with them and sit the steps out.
    pmesh = pl.make_pp_mesh(d_pp, 4, dt)
    emesh = ex.make_ep_mesh(d_pp, 4, dt)
    p3mesh = pl.make_pp3_mesh(d_pp, 2, 2, dt)
    if not in_mesh(pmesh):
        return out

    # dp x pp: one microbatched step against the flat stack.
    pstate = pl.build_pp_state(pmesh, optimizer, 6, 16, 4, 2, seed=5,
                               device=device)
    flat = pl.flatten_pipeline(_full(pstate))
    pstep = pl.make_pp_train_step(pmesh, optimizer, n_micro=2, n_classes=4)
    pstate, pm = pstep(pstate, *local(batch_slice(xb, yb, pmesh)))
    got = pstep.global_metrics(pm)["loss"]
    _close(got, _ce(pl.flat_forward(flat, x_all), yb), "dp x pp vs flat")
    out["dp_pp"] = got

    # dp x ep, dense: one step against the unsharded forward.
    estate = ex.build_moe_state(emesh, optimizer, 6, 16, 24, 4, 8, seed=9,
                                device=device)
    ref = _full(estate)
    want = _ce(ex.moe_reference_forward(ref, x_all), yb)
    estep = ex.make_moe_train_step(emesh, optimizer, n_experts=8,
                                   n_classes=4)
    estate, em = estep(estate, *local(batch_slice(xb, yb, emesh)))
    got = estep.global_metrics(em)["loss"]
    _close(got, want, "dp x ep dense vs unsharded")
    out["dp_ep_dense"] = got

    # The capacity + all-to-all dispatch with capacity >= the local tokens
    # (cf = ep): nothing drops, so the same unsharded loss.
    cap = ex.a2a_capacity(xb.shape[0], d_pp, 4, capacity_factor=4.0)
    if cap < xb.shape[0] // (d_pp * 4):
        raise AssertionError(f"capacity {cap} below the local tokens")
    astate = ex.build_moe_state(emesh, optimizer, 6, 16, 24, 4, 8, seed=9,
                                device=device)
    astep = ex.make_moe_a2a_train_step(emesh, optimizer, n_experts=8,
                                       n_classes=4, capacity=cap)
    astate, am = astep(astate, *local(ex.a2a_batch_slice(xb, yb, emesh)))
    got = astep.global_metrics(am)["loss"]
    _close(got, want, "dp x ep a2a vs unsharded")
    out["dp_ep_a2a"] = got

    # dp x tp x pp on (n / 4, 2, 2) against the unsharded, unpipelined
    # forward.
    p3state = pl.build_pp3_state(p3mesh, optimizer, 6, 16, 4, 2, seed=13,
                                 device=device)
    p3ref = _full(p3state)
    p3step = pl.make_pp3_train_step(p3mesh, optimizer, n_micro=2,
                                    n_classes=4)
    p3state, p3m = p3step(p3state, *local(batch_slice(xb, yb, p3mesh)))
    got = p3step.global_metrics(p3m)["loss"]
    _close(got, _ce(pl.pp3_reference_forward(p3ref, x_all), yb),
           "dp x tp x pp vs unsharded")
    out["dp_pp3"] = got
    return out


__all__ = ["dryrun_train"]
