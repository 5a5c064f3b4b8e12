"""Blocked, sharded k-nearest-neighbour search: the reference of a corpus
held over the ranks of a data axis, each rank with its own shard.

Each rank walks its shard in row blocks, casts each block to float64 and
takes each block's k nearest rows with ``knn.knn`` (exact, ties to the
larger id); the per-block lists merge into the shard's, and the shards'
lists merge across the ranks through ``torch.distributed`` (an all-gather,
then the same order). Top-k of a union is top-k of the union of top-ks
under one strict order, so the result equals ``knn.knn`` over the whole
corpus. Plain PyTorch: nothing of the program, nothing of JAX.

The blocks are handed in by the caller (``benchmark.shardgen`` draws them
again from their seeds), so the reference never reads the program's copy
of the corpus.

``precision`` names a control that stands in for the program in a lower
precision: ``"tf32"`` takes the products in TF32 (``knn.knn``'s own), and
``"bfloat16"`` computes the float32 expansion and keeps each distance in
bfloat16, selecting by those values.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from benchmark.reference import knn as ref

PRECISIONS = ("float64", "tf32", "bfloat16")


def _bfloat16_topk(queries: torch.Tensor, data: torch.Tensor, k: int,
                   query_block: int = 1024
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dists, ids) by distances held in bfloat16: the float32 expansion
    (TF32 off), each value rounded to bfloat16, ordered by those values
    and then by the tie rule."""
    x = data.float()
    xn = (x * x).sum(1)
    kk = min(k, x.shape[0])
    out_d, out_i = [], []
    prev = None
    if x.device.type == "cuda":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for q0 in range(0, queries.shape[0], query_block):
            q = queries[q0:q0 + query_block].float()
            d = (q * q).sum(1, keepdim=True) - 2.0 * (q @ x.T) + xn[None, :]
            d = d.to(torch.bfloat16).double()
            cd, ci = torch.topk(d, kk, dim=1, largest=False)
            cd, ci = ref._order(cd, ci)
            out_d.append(cd)
            out_i.append(ci)
    finally:
        if prev is not None:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.cat(out_d), torch.cat(out_i)


def block_topk(queries: torch.Tensor, block: torch.Tensor, base: int,
               k: int, precision: str = "float64"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dists (Q, k) float64, global ids (Q, k) int64) of each query's k
    nearest rows of ``block`` (rows of any real dtype, global ids from
    ``base``), padded with (+inf, -1) past the block's rows. ``queries``
    are float64 on the block's device."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "bfloat16":
        d, i = _bfloat16_topk(queries, block, k)
    else:
        d, i = ref.knn(queries, block.double(), k, precision=precision)
    i = torch.where(i >= 0, i + base, -1)
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.cat([d, d.new_full((d.shape[0], pad), torch.inf)], 1)
        i = torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1)
    return d, i


def merge_lists(d: torch.Tensor, i: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first k of rows of concatenated lists (Q, m) in report order."""
    d, i = ref._order(d, i)
    return d[:, :k], i[:, :k]


def shard_knn(queries: torch.Tensor,
              blocks: Iterable[Tuple[int, torch.Tensor]], k: int,
              precision: str = "float64"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's (dists, ids) over the blocks of its shard, each a
    (global base, rows) pair."""
    acc = None
    for base, block in blocks:
        d, i = block_topk(queries, block, base, k, precision)
        acc = (d, i) if acc is None else merge_lists(
            torch.cat([acc[0], d], 1), torch.cat([acc[1], i], 1), k)
    if acc is None:
        raise ValueError("a shard of no blocks")
    return acc


def merge_ranks(dists: torch.Tensor, ids: torch.Tensor, k: int,
                group: Optional[object] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (dists, ids) of the same queries, merged on every rank
    of ``group`` (an all-gather, then the report order)."""
    n = dist.get_world_size(group)
    dg = [torch.empty_like(dists) for _ in range(n)]
    ig = [torch.empty_like(ids) for _ in range(n)]
    dist.all_gather(dg, dists.contiguous(), group=group)
    dist.all_gather(ig, ids.contiguous(), group=group)
    return merge_lists(torch.cat(dg, 1), torch.cat(ig, 1), k)
