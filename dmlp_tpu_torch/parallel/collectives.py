"""Collectives over the mesh — port of ``dmlp_tpu/parallel/collectives.py``.

Two ways to combine per-shard top-k lists across the "data" axis, both
exact because the selection key (distance asc, id desc) is a strict total
order (``ops.topk``):

- :func:`allgather_merge_topk` — one all-gather and a re-select: the
  analog of the reference's candidate gather and root merge, except that
  every rank of the axis gets the result;
- :func:`ring_allreduce_topk` — a ring all-reduce with merge-top-k as the
  combiner: R - 1 hops of the O(k) accumulator to rank (r + 1) mod R;
- :func:`gspmd_merge_topk` — the reference's compiler-scheduled merge
  point: the lists placed as a ``DTensor`` on the mesh and redistributed
  from data-sharded to query-sharded, DTensor choosing the collective.

Besides them, the root's data movement of the mesh engines: the
``Scatterv`` of row and query shards (:func:`scatter_from_root`), the
broadcast of a held-shard solve's queries (:func:`broadcast_from_root`),
the gather of the merged lists over the query axis (:func:`gather_topk`),
and object broadcasts and gathers of small plans and records.

Every collective moves one tensor: a list's three (Q, K) arrays travel
packed as int32 (the distances' float32 bits unchanged). Under gloo the
tensors go through host memory — copied off the card before the
collective and back after it, here and nowhere else; under NCCL they stay
on the card. A group of one rank runs no collective at all. Those copies
and the object collectives (which read their pickled sizes back) are the
mesh's deliberate syncs: each sits in a named ``check.sanitize.fenced``
site, so a ``--sanitize`` run passes them and lists them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dmlp_tpu_torch.check.sanitize import fenced, readback
from dmlp_tpu_torch.ops.topk import TopK, merge_topk, select_topk


def _wire_device(group, device: torch.device) -> torch.device:
    """Where a collective's tensors must live: the compute device under
    NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return device
    return torch.device("cpu")


def move(t: torch.Tensor, device, site: str) -> torch.Tensor:
    """``t`` on ``device``; a move between the card and the host (gloo's
    wire) is a deliberate sync, fenced as ``site``."""
    device = torch.device(device)
    if t.device.type == device.type:
        return t.to(device)
    with fenced(site):
        return t.to(device)


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
    mine = move(_pack(local), _wire_device(group, dev),
                  "collectives.allgather_wire")
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)  # check: comms-model=allgather_topk_traffic
    # (R, 3, Q, K) -> (3, Q, R*K): per query, all shards' candidates.
    g = move(torch.stack(parts), dev, "collectives.allgather_wire")
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
        out = move(_pack(acc), wire, "collectives.ring_wire")
        inc = torch.empty_like(out)
        # check: comms-model=ring_topk_traffic
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out, nxt, group),
                dist.P2POp(dist.irecv, inc, prv, group)]):
            req.wait()
        acc = merge_topk(_unpack(move(inc, dev, "collectives.ring_wire")),
                         local, k)
    return acc


def gspmd_merge_topk(local: TopK, k: int, mesh) -> TopK:
    """The "gspmd" merge: the reference's ``with_sharding_constraint``
    merge point over a ``torch.distributed.tensor`` placement.

    This rank's (Q, K) lists, packed as (3, Q, K) int32, are its block of
    the logical (3, C * Q, R * K) candidate matrix placed ``[Shard(2),
    Shard(1)]`` on the ("data", "query") mesh: the data axis shards the
    candidate columns, the query axis the rows (the (C * Q, R * K)
    matrix's ``[Shard(1), Shard(0)]`` with the packing axis in front).
    ``redistribute`` to ``[Replicate(), Shard(1)]`` leaves every rank its
    query shard's (Q, R * K) candidates, shard-major within each row — the
    column order of :func:`allgather_merge_topk`, so the re-selected lists
    equal its lists bit for bit — and DTensor picks the collective (one
    all-gather over the data axis). Every rank's block has the same shape,
    so DTensor never pads an uneven shard. A failed ``redistribute``
    raises; nothing falls back to another merge. The lists cross in the
    mesh's device type: through host memory on a "cpu" (gloo) mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    r = mesh.size(0)
    dev = local.dists.device
    wire = dev if mesh.device_type == dev.type else torch.device("cpu")
    mine = move(_pack(local), wire, "collectives.gspmd_wire")
    placed = DTensor.from_local(mine, mesh, [Shard(2), Shard(1)],
                                run_check=False)
    got = placed.redistribute(mesh, [Replicate(), Shard(1)]).to_local()
    three, q, kk = mine.shape
    if tuple(got.shape) != (three, q, r * kk):
        raise RuntimeError(f"gspmd merge: redistribute gave "
                           f"{tuple(got.shape)}, want {(three, q, r * kk)}")
    flat = _unpack(move(got, dev, "collectives.gspmd_wire"))
    return select_topk(flat.dists, flat.labels, flat.ids, k)


def gather_topk(top: TopK, group, dst: int = 0) -> Optional[TopK]:
    """Gather ``top`` from every rank of ``group`` to global rank ``dst``,
    concatenated along the query axis in group order; None elsewhere."""
    n = dist.get_world_size(group)
    if n == 1:
        return top
    dev = top.dists.device
    mine = move(_pack(top), _wire_device(group, dev),
                  "collectives.gather_wire")
    parts = [torch.empty_like(mine) for _ in range(n)] \
        if dist.get_rank() == dst else None
    dist.gather(mine, parts, dst=dst, group=group)  # check: comms-model=gather_topk_traffic
    if parts is None:
        return None
    return _unpack(move(torch.cat(parts, 1), dev,
                          "collectives.gather_wire"))


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
        lst = [move(torch.from_numpy(np.ascontiguousarray(p)), wire,
                      "collectives.scatter_stage") for p in parts]
    dist.scatter(out, lst, src=src)  # check: comms-model=scatter_traffic
    return out


def broadcast_from_root(t: Optional[torch.Tensor], shape,
                        dtype: torch.dtype, device: torch.device,
                        src: int = 0) -> torch.Tensor:
    """Rank ``src``'s tensor ``t`` of ``shape`` and ``dtype`` on every
    rank of the whole group, on ``device``; the other ranks pass None.
    Under NCCL it goes card to card, under gloo through host memory."""
    if dist.get_world_size() == 1:
        return t
    wire = _wire_device(None, device)
    if dist.get_rank() == src:
        buf = move(t.contiguous(), wire, "collectives.broadcast_wire")
    else:
        buf = torch.empty(tuple(shape), dtype=dtype, device=wire)
    dist.broadcast(buf, src=src)  # check: comms-model=broadcast_traffic
    return move(buf, device, "collectives.broadcast_wire")


def broadcast_object(obj, src: int = 0):
    """``obj`` from rank ``src`` on every rank (a small picklable plan)."""
    if dist.get_world_size() == 1:
        return obj
    box = [obj]
    with fenced("collectives.broadcast_object"):
        # check: no-traffic (a pickled plan or command of a few hundred
        # bytes: the record names it "broadcast"; no model prices it)
        dist.broadcast_object_list(box, src=src)
    return box[0]


def gather_objects(obj, dst: int = 0) -> Optional[List]:
    """Every rank's ``obj`` on rank ``dst`` (rank order); None elsewhere."""
    if dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size() if dist.get_rank() == dst else None
    with fenced("collectives.gather_objects"):
        # check: no-traffic (each rank's pickled run summary, once a
        # run, after the timed region; no model prices it)
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
            t = move(t, torch.device("cuda", torch.cuda.current_device()),
                       "collectives.all_gather_arrays")
        parts = [torch.empty_like(t) for _ in range(n)]
        # check: comms-model=host_allgather_candidates_traffic
        dist.all_gather(parts, t)
        out.append(readback(  # check: allow-host-sync
            parts, "collectives.all_gather_arrays"))
    return [list(per_rank) for per_rank in zip(*out)]
