"""Expert parallelism: a top-1-routed MoE FFN with experts sharded over a
("dp", "ep") mesh — port of ``dmlp_tpu/train/experts.py``.

The expert weights are stacked (E, H, F) / (E, F, H) and held as DTensors
placed ``Shard(0)`` on "ep" (:data:`MOE_PSPECS`), so each rank computes on
its E / ep local experts. Two dispatches, as in the reference:

- DENSE one-hot (:func:`make_moe_train_step`): every rank runs its local
  experts over all of its dp row's tokens under the routing mask and the
  contributions are summed over ep (``train.collectives.psum``: an
  all-reduce forward and backward); exact and capacity-free.
- CAPACITY + ALL-TO-ALL (:func:`make_moe_a2a_train_step`): the batch
  splits over both axes; each rank scatters its tokens into an (ep,
  capacity, H) send buffer by destination, three all-to-alls move the
  tokens out, the int32 slot metadata (no gradient) and the results back
  (``train.collectives.AllToAll``: two more in the backward), and tokens
  past ``capacity`` per (source, destination) take the residual path
  only.

Routing is the reference's exactly: top-1 by ``argmax`` of the router
logits (the first index on ties, in both libraries), the gate is the
chosen expert's softmax probability, a token's rank within its
destination is its position order (``cumsum``).

The loss leaves each cell as a partial (nonzero on ep cell 0 for the dense
dispatch; per-cell cross-entropy sums over the global batch for a2a) and
each gradient is summed over the axes its parameter is replicated on, as
in ``train.pipeline``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dmlp_tpu_torch.train.collectives import all_to_all, psum
from dmlp_tpu_torch.train.model import resolve_device
from dmlp_tpu_torch.train.pipeline import (DP_AXIS, PartialsStep, Spec,
                                           _he, _loss_acc,
                                           _partials_train_step, axis_group,
                                           axis_index, axis_size,
                                           make_axes_mesh, place_state)

EP_AXIS = "ep"

MoeParams = Dict[str, torch.Tensor]


def make_ep_mesh(dp: int, ep: int, device_type: Optional[str] = None):
    return make_axes_mesh({DP_AXIS: dp, EP_AXIS: ep}, device_type)


def init_moe(gen: torch.Generator, d_in: int, hidden: int, ffn: int,
             n_classes: int, n_experts: int) -> MoeParams:
    """The MoE classifier's parameters drawn on the host from ``gen``
    (every rank draws the same)."""
    h, f, e = hidden, ffn, n_experts
    return {"in_w": _he(gen, (d_in, h), d_in), "in_b": torch.zeros(h),
            "router": torch.randn((h, e), generator=gen)
            * math.sqrt(1.0 / h),
            "up": _he(gen, (e, h, f), h), "down": _he(gen, (e, f, h), f),
            "out_w": _he(gen, (h, n_classes), h),
            "out_b": torch.zeros(n_classes)}


MOE_PSPECS: Dict[str, Spec] = {
    "in_w": (None, None), "in_b": (None,),
    "router": (None, None),
    "up": (EP_AXIS, None, None),
    "down": (EP_AXIS, None, None),
    "out_w": (None, None), "out_b": (None,),
}


def _route(p, x):
    h = x.to(p["in_w"].dtype) @ p["in_w"] + p["in_b"]
    logits = h @ p["router"]
    probs = torch.softmax(logits, -1)
    sel = logits.argmax(-1)
    return h, probs, sel


def moe_reference_forward(params: Mapping[str, torch.Tensor],
                          x: torch.Tensor) -> torch.Tensor:
    """The unsharded forward (the equivalence oracle): top-1 routing,
    router-probability scaling, residual."""
    n_experts = params["router"].shape[1]
    h, probs, sel = _route(params, x)
    onehot = F.one_hot(sel, n_experts).to(h.dtype)
    gate = (probs * onehot).sum(-1, keepdim=True)
    up = torch.einsum("bh,ehf->ebf", h, params["up"])
    down = torch.einsum("ebf,efh->ebh", torch.relu(up), params["down"])
    expert_out = torch.einsum("ebh,be->bh", down, onehot)
    h = h + gate * expert_out
    return h @ params["out_w"] + params["out_b"]


def _moe_body(p, x, y, *, n_experts: int, ep_idx: int, ep_group):
    """This (dp, ep) cell's loss partial: its expert slice over its dp
    row's tokens, summed over ep."""
    e_local = p["up"].shape[0]
    e_base = ep_idx * e_local
    h, probs, sel = _route(p, x)
    onehot = F.one_hot(sel, n_experts).to(h.dtype)
    gate = (probs * onehot).sum(-1, keepdim=True)
    local_hot = onehot[:, e_base:e_base + e_local]
    up = torch.einsum("bh,ehf->ebf", h, p["up"])
    down = torch.einsum("ebf,efh->ebh", torch.relu(up), p["down"])
    local_out = torch.einsum("ebh,be->bh", down, local_hot)
    # check: comms-model=ep_psum_combine_traffic
    expert_out = psum(local_out, ep_group)
    h = h + gate * expert_out
    loss, acc = _loss_acc(h @ p["out_w"] + p["out_b"], y)
    w = 1.0 if ep_idx == 0 else 0.0
    return loss * w, acc * w, [], {}


def _check_experts(mesh, n_experts: int) -> None:
    ep = axis_size(mesh, EP_AXIS)
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts do not split over ep = {ep}")


def make_moe_train_step(mesh, optimizer, *, n_experts: int, n_classes: int
                        ) -> PartialsStep:
    """The dense one-hot step over ("dp", "ep"); ``x``/``y`` are this
    rank's dp slice; state from :func:`build_moe_state`."""
    _check_experts(mesh, n_experts)
    n_dp = axis_size(mesh, DP_AXIS)
    ep_idx = axis_index(mesh, EP_AXIS)
    ep_group = axis_group(mesh, (EP_AXIS,))

    def body(p, x, y):
        assert p["out_w"].shape[1] == n_classes, (p["out_w"].shape,
                                                  n_classes)
        return _moe_body(p, x, y, n_experts=n_experts, ep_idx=ep_idx,
                         ep_group=ep_group)
    return _partials_train_step(mesh, optimizer, MOE_PSPECS, body, n_dp)


def build_moe_state(mesh, optimizer, d_in: int, hidden: int, ffn: int,
                    n_classes: int, n_experts: int, seed: int = 0,
                    device="cuda", params=None):
    """Draw (or take, ``params``) the MoE's parameters and place each
    rank's experts on ``device``."""
    _check_experts(mesh, n_experts)
    device = resolve_device(device)
    if params is None:
        params = init_moe(torch.Generator().manual_seed(seed), d_in, hidden,
                          ffn, n_classes, n_experts)
    return place_state(params, mesh, MOE_PSPECS, optimizer, device)


# -- capacity + all-to-all ----------------------------------------------------

def _moe_a2a_body(p, x, y, *, capacity: int, n_ep: int, ep_group):
    """This cell's cross-entropy and accuracy sums over its tokens; the
    dropped-token count rides along."""
    e_local = p["up"].shape[0]
    hdim = p["in_w"].shape[1]
    h, probs, sel = _route(p, x)
    gate = probs.gather(1, sel[:, None])                 # (Bl, 1)
    dest = sel // e_local                                 # owning ep cell
    e_loc = sel % e_local
    # Rank of each token within its destination group (position order).
    hot = (dest[:, None] == torch.arange(n_ep, device=h.device)[None, :]
           ).to(torch.int32)
    rank = (hot.cumsum(0) - 1).gather(1, dest[:, None])[:, 0]
    kept = rank < capacity
    dk, rk = dest[kept], rank[kept]
    # Slot [d, c] of the send buffer: this cell's c-th token bound for ep
    # cell d; its metadata the expert-local id + 1 (0: an empty slot).
    send = h.new_zeros((n_ep, capacity, hdim)).index_put((dk, rk), h[kept])
    meta = torch.zeros((n_ep, capacity), dtype=torch.int32,
                       device=h.device).index_put(
        (dk, rk), (e_loc[kept] + 1).to(torch.int32))
    # check: comms-model=moe_a2a_traffic
    recv = all_to_all(send, ep_group)
    # check: comms-model=moe_a2a_traffic
    rmeta = all_to_all(meta, ep_group)
    toks = recv.reshape(n_ep * capacity, hdim)
    tmeta = rmeta.reshape(n_ep * capacity).long()
    ehot = F.one_hot((tmeta - 1).clamp(min=0), e_local).to(toks.dtype) \
        * (tmeta > 0)[:, None].to(toks.dtype)             # empty slots -> 0
    up = torch.einsum("th,ehf->tef", toks, p["up"])
    down = torch.einsum("tef,efh->teh", torch.relu(up), p["down"])
    out_toks = torch.einsum("teh,te->th", down, ehot)
    # Back through the reverse all-to-all (the same slot layout).
    # check: comms-model=moe_a2a_traffic
    ret = all_to_all(out_toks.reshape(n_ep, capacity, hdim), ep_group)
    # Dropped tokens read slot (0, 0) and are masked to the residual path.
    got = ret[torch.where(kept, dest, 0), torch.where(kept, rank, 0)]
    expert_out = torch.where(kept[:, None], got, torch.zeros_like(got))
    h = h + gate * expert_out
    out = h @ p["out_w"] + p["out_b"]
    ce = F.cross_entropy(out, y.long(), reduction="none")
    acc = (out.argmax(-1) == y).float()
    return ce.sum(), acc.sum(), [], {"dropped": (~kept).sum()}


def a2a_capacity(batch: int, dp: int, ep: int,
                 capacity_factor: float = 1.0) -> int:
    """Dispatch slots per (source cell, destination cell): local tokens
    per cell = batch / (dp * ep), uniform routing sends local / ep of them
    to each destination, so capacity = ceil(cf * local / ep); cf >= ep
    makes it at least the local tokens (no drop whatever the routing)."""
    if batch % (dp * ep):
        raise ValueError(f"a2a dispatch needs batch divisible by dp*ep "
                         f"({batch} % {dp * ep})")
    local = batch // (dp * ep)
    return max(1, int(np.ceil(capacity_factor * local / ep)))


def a2a_batch_slice(x: np.ndarray, y: np.ndarray, mesh):
    """This rank's block of a global batch split over both mesh axes
    (cell (d, e) takes block d * ep + e): the a2a step's input layout
    (the dense step keeps ``train.sharding.batch_slice``)."""
    n_dp, n_ep = axis_size(mesh, DP_AXIS), axis_size(mesh, EP_AXIS)
    cells = n_dp * n_ep
    n = x.shape[0]
    if n % cells:
        raise ValueError(f"batch {n} does not split over dp*ep = {cells}")
    cell = axis_index(mesh, DP_AXIS) * n_ep + axis_index(mesh, EP_AXIS)
    rows = slice(cell * n // cells, (cell + 1) * n // cells)
    return x[rows], y[rows]


def make_moe_a2a_train_step(mesh, optimizer, *, n_experts: int,
                            n_classes: int, capacity: int) -> PartialsStep:
    """The capacity + all-to-all step over ("dp", "ep"): ``x``/``y`` are
    this rank's block of the batch split over both axes
    (:func:`a2a_batch_slice`); the cross-entropy sums are divided by the
    global batch; the metrics carry this cell's dropped tokens
    (``dropped``)."""
    if capacity < 1:
        raise ValueError("capacity must be >= 1 (0 would make zero-width "
                         "dispatch buffers; to drop everything, don't run "
                         "the experts)")
    _check_experts(mesh, n_experts)
    n_ep = axis_size(mesh, EP_AXIS)
    cells = axis_size(mesh, DP_AXIS) * n_ep
    ep_group = axis_group(mesh, (EP_AXIS,))

    def body(p, x, y):
        assert p["out_w"].shape[1] == n_classes
        return _moe_a2a_body(p, x, y, capacity=capacity, n_ep=n_ep,
                             ep_group=ep_group)
    return PartialsStep(mesh, optimizer, MOE_PSPECS, body,
                        lambda x: x.shape[0] * cells)


__all__ = ["EP_AXIS", "make_ep_mesh", "init_moe", "MOE_PSPECS",
           "moe_reference_forward", "make_moe_train_step", "build_moe_state",
           "a2a_capacity", "a2a_batch_slice", "make_moe_a2a_train_step"]
