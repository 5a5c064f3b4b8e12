"""The collectives on the loss path of the pipeline and MoE families, and
the gradient reduction by placement.

The reference differentiates its ``lax.ppermute``, ``psum`` and
``all_to_all`` inside one jitted ``shard_map`` program (``check_vma=False``)
and XLA emits their transposes. The port has no compiler doing that: each
is a ``torch.autograd.Function`` with its transpose written out, so that
autograd's backward issues the mirrored collectives.

- :class:`PPermute` — the pipeline hand-off: this rank's block to its
  successor on the pp axis, its predecessor's block back (zeros where
  there is none); backward, the inverse permutation of the cotangent.
- :class:`AllReduceSum` — an all-reduce forward and an all-reduce of the
  cotangent backward: the transpose ``shard_map`` gives ``psum`` under
  ``check_vma=False``. It is exact together with the reference's loss rule
  (each dp row's loss partial nonzero on exactly one cell), under which
  each cell's cotangent of a replicated activation is a partial sum of the
  true one.
- :class:`AllToAll` — split and concatenate on dim 0 over a group; its own
  transpose.

Wire. Under gloo, point-to-point and all-to-all tensors go through host
memory: PyTorch's backend table lists CUDA support for neither under gloo
(of this slice's collectives only all-reduce and broadcast take CUDA
tensors there), so they are copied off the card before the collective and
back after it, as ``parallel.collectives`` does for the ring merge; the
all-reduce takes its tensor where it lies. Under NCCL everything stays on
the card. The backend chooses, never a failure.

Order. Every rank of a group issues the same collectives in the same
order: each one sits on the activation chain, so autograd's backward runs
them in the reverse of the forward's order on every rank. A group of one
rank (or ``None``) issues nothing.

:func:`reduce_grads` is the rule ``shard_map``'s transpose of an implicit
broadcast applies: a parameter's gradient summed over every mesh axis it
is replicated on (one all-reduce per group, of the concatenated
gradients).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from dmlp_tpu_torch.parallel.collectives import _wire_device


def group_size(group) -> int:
    """The ranks of ``group``; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def neighbours(group, ring: bool):
    """(successor, predecessor) global ranks of this rank on ``group``'s
    chain ``(i, i + 1)`` or, with ``ring``, the ring ``(i, (i + 1) % n)``;
    None where the chain has no such rank."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    nxt = ranks[(me + 1) % n] if ring or me + 1 < n else None
    prv = ranks[(me - 1) % n] if ring or me > 0 else None
    return nxt, prv


def _exchange(send: torch.Tensor, dst: Optional[int], src: Optional[int],
              group) -> torch.Tensor:
    """``send`` to global rank ``dst`` (None: nothing) and a tensor of its
    shape and dtype from ``src`` (None: zeros), in one batch."""
    dev = send.device
    wire = _wire_device(group, dev)
    ops, buf = [], None
    if dst is not None:
        # check: comms-model=pipeline_ppermute_traffic
        ops.append(dist.P2POp(dist.isend, send.detach().contiguous().to(wire),
                              dst, group))
    if src is not None:
        buf = torch.empty(send.shape, dtype=send.dtype, device=wire)
        # check: comms-model=pipeline_ppermute_traffic
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if buf is None:
        return torch.zeros_like(send)
    return buf.to(dev)


class PPermute(torch.autograd.Function):
    """The pipeline hand-off over ``group``: ``x`` to global rank ``nxt``,
    the block from ``prv`` back (zeros for None); backward sends the
    cotangent to ``prv`` and takes ``x``'s from ``nxt``."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.hop = (group, nxt, prv)
        return _exchange(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        group, nxt, prv = ctx.hop
        return _exchange(g, prv, nxt, group), None, None, None


class HandOff:
    """One pipeline's hand-off on this rank: the chain or the ring over
    the pp ``group`` (the identity for a group of one rank)."""

    def __init__(self, group, ring: bool):
        self.group = group if group_size(group) > 1 else None
        self.nxt = self.prv = None
        if self.group is not None:
            self.nxt, self.prv = neighbours(self.group, ring)

    def __call__(self, out: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return out
        return PPermute.apply(out, self.group, self.nxt, self.prv)


class AllReduceSum(torch.autograd.Function):
    """``psum`` over ``group`` as ``shard_map`` transposes it under
    ``check_vma=False``: all-reduce forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        # check: comms-model=tp_psum_activation_traffic,ep_psum_combine_traffic
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        # check: comms-model=tp_psum_activation_traffic,ep_psum_combine_traffic
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`AllReduceSum` of ``x`` (``x`` itself over one rank)."""
    if group_size(group) == 1:
        return x
    return AllReduceSum.apply(x, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    wire = _wire_device(group, x.device)
    src = x.detach().contiguous().to(wire)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)  # check: comms-model=moe_a2a_traffic
    return out.to(x.device)


class AllToAll(torch.autograd.Function):
    """``x`` split on dim 0 into one block per rank of ``group``, block i
    to rank i, the blocks received concatenated in rank order; the
    backward is the same exchange of the cotangent (its own
    transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`AllToAll` of ``x`` (``x`` itself over one rank; an integer
    tensor carries no gradient)."""
    if group_size(group) == 1:
        return x
    return AllToAll.apply(x, group)


@torch.no_grad()
def reduce_grads(grads: Sequence[torch.Tensor], groups: Sequence) -> None:
    """Each gradient summed over its group in place (None or one rank:
    nothing). The gradients of one group travel as one all-reduce of
    their concatenation, the groups in order of first appearance (the
    same on every rank: the parameters' order)."""
    by_group: Dict[object, List[torch.Tensor]] = {}
    for g, grp in zip(grads, groups):
        if group_size(grp) > 1:
            by_group.setdefault(grp, []).append(g)
    for grp, gs in by_group.items():
        flat = torch.cat([g.reshape(-1) for g in gs])
        # check: no-traffic (the sums by placement, over the world, dp
        # and dp,tp groups, are not modelled: psum_traffic prices only
        # the dp x tp family's dp sum, which train.step issues)
        dist.all_reduce(flat, group=grp)
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))


__all__ = ["group_size", "neighbours", "PPermute", "HandOff",
           "AllReduceSum", "psum", "AllToAll", "all_to_all", "reduce_grads"]
