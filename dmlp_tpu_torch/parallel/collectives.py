"""Collectives over the mesh — port of ``dmlp_tpu/parallel/collectives.py``.

Two ways to combine per-shard top-k lists across the "data" axis, both
exact because the selection key (distance asc, id desc) is a strict total
order (``ops.topk``):

- :func:`allgather_merge_topk` — one all-gather and a re-select: the
  analog of the reference's candidate gather and root merge, except that
  every rank of the axis gets the result;
- :func:`ring_allreduce_topk` — a ring all-reduce with merge-top-k as the
  combiner: R - 1 hops of the O(k) accumulator to rank (r + 1) mod R.

Besides them, the root's data movement of the mesh engines: the
``Scatterv`` of row and query shards (:func:`scatter_from_root`), the
gather of the merged lists over the query axis (:func:`gather_topk`), and
object broadcasts and gathers of small plans and records.

Every collective moves one tensor: a list's three (Q, K) arrays travel
packed as int32 (the distances' float32 bits unchanged). Under gloo the
tensors go through host memory — copied off the card before the
collective and back after it, here and nowhere else; under NCCL they stay
on the card. A group of one rank runs no collective at all.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dmlp_tpu_torch.ops.topk import TopK, merge_topk, select_topk


def _wire_device(group, device: torch.device) -> torch.device:
    """Where a collective's tensors must live: the compute device under
    NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return device
    return torch.device("cpu")


def _pack(top: TopK) -> torch.Tensor:
    """(3, Q, K) int32: distance bits, labels, ids."""
    return torch.stack([top.dists.contiguous().view(torch.int32),
                        top.labels.to(torch.int32), top.ids.to(torch.int32)])


def _unpack(packed: torch.Tensor) -> TopK:
    return TopK(packed[0].contiguous().view(torch.float32),
                packed[1].contiguous(), packed[2].contiguous())


def allgather_merge_topk(local: TopK, k: int, group=None) -> TopK:
    """All-gather per-shard candidates over ``group`` (the data axis) and
    re-select k: per query, the concatenation of every shard's lists in
    group order, (Q, R * K), through ``select_topk``."""
    n = dist.get_world_size(group)
    if n == 1:
        return select_topk(local.dists, local.labels, local.ids, k)
    dev = local.dists.device
    mine = _pack(local).to(_wire_device(group, dev))
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    # (R, 3, Q, K) -> (3, Q, R*K): per query, all shards' candidates.
    g = torch.stack(parts).to(dev)
    _, three, q, kk = g.shape
    flat = _unpack(g.permute(1, 2, 0, 3).reshape(three, q, n * kk))
    return select_topk(flat.dists, flat.labels, flat.ids, k)


def ring_allreduce_topk(local: TopK, k: int, group=None) -> TopK:
    """Ring all-reduce with merge-top-k as the combiner.

    After step t rank r's accumulator covers shards {r - t, ..., r};
    merging the incoming accumulator (shards {r - 1 - t, ..., r - 1}) with
    rank r's own list extends that by one and never duplicates a shard.
    At R = 1 the list is still re-selected: the extraction kernel's lists
    arrive unsorted, and both merges promise selection order."""
    n = dist.get_world_size(group)
    if n == 1:
        return select_topk(local.dists, local.labels, local.ids, k)
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    dev = local.dists.device
    wire = _wire_device(group, dev)
    acc = local
    for _ in range(n - 1):
        out = _pack(acc).to(wire)
        inc = torch.empty_like(out)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out, nxt, group),
                dist.P2POp(dist.irecv, inc, prv, group)]):
            req.wait()
        acc = merge_topk(_unpack(inc.to(dev)), local, k)
    return acc


def gather_topk(top: TopK, group, dst: int = 0) -> Optional[TopK]:
    """Gather ``top`` from every rank of ``group`` to global rank ``dst``,
    concatenated along the query axis in group order; None elsewhere."""
    n = dist.get_world_size(group)
    if n == 1:
        return top
    dev = top.dists.device
    mine = _pack(top).to(_wire_device(group, dev))
    parts = [torch.empty_like(mine) for _ in range(n)] \
        if dist.get_rank() == dst else None
    dist.gather(mine, parts, dst=dst, group=group)
    if parts is None:
        return None
    return _unpack(torch.cat(parts, 1).to(dev))


def scatter_from_root(parts: Optional[Sequence[np.ndarray]], shape,
                      dtype: torch.dtype, device: torch.device,
                      src: int = 0) -> torch.Tensor:
    """The ``Scatterv`` analog over the whole process group: rank ``src``
    passes one array of ``shape`` per rank (in rank order), every rank
    receives its own. The result lies where the collective put it: on the
    host under gloo, on ``device`` under NCCL."""
    n = dist.get_world_size()
    if n == 1:
        return torch.from_numpy(np.ascontiguousarray(parts[0]))
    wire = _wire_device(None, device)
    out = torch.empty(tuple(shape), dtype=dtype, device=wire)
    lst = None
    if dist.get_rank() == src:
        lst = [torch.from_numpy(np.ascontiguousarray(p)).to(wire)
               for p in parts]
    dist.scatter(out, lst, src=src)
    return out


def broadcast_object(obj, src: int = 0):
    """``obj`` from rank ``src`` on every rank (a small picklable plan)."""
    if dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def gather_objects(obj, dst: int = 0) -> Optional[List]:
    """Every rank's ``obj`` on rank ``dst`` (rank order); None elsewhere."""
    if dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size() if dist.get_rank() == dst else None
    dist.gather_object(obj, out, dst=dst)
    return out


def all_gather_arrays(arrays: Sequence[np.ndarray]) -> List[List[np.ndarray]]:
    """Every rank's ``arrays`` (same shapes and dtypes on every rank) on
    every rank, through the host: [rank][array]."""
    n = dist.get_world_size()
    if n == 1:
        return [list(arrays)]
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dist.get_backend() == "nccl":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
        out.append([p.cpu().numpy() for p in parts])
    return [list(per_rank) for per_rank in zip(*out)]
