"""Exact-tie-break k-selection and blockwise merge, in PyTorch.

Port of ``dmlp_tpu/ops/topk.py``. Selection follows the measured
oracle-binary comparator (distance asc, id desc) — a strict total order, so
top-k of a union equals top-k of the concatenated per-block top-k's. The
reference expresses it as a two-key ``lax.sort``; here it is two composed
stable sorts, least-significant key first.

The "topk" step keeps the reference ``lax.top_k`` tie rule: on equal
distances the LOWEST POSITION wins (carry slots before block columns).
``torch.topk`` promises no tie order, so the step uses a stable ascending
sort instead. The "seg" step needs the K3 kernel (``fused_dist_segmin``),
which is ROADMAP slice 2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmlp_tpu_torch.ops.distance import masked_pairwise_sq_l2

SEG_NOT_PORTED = ("select='seg' needs the K3 kernel (fused_dist_segmin) "
                  "and the seg fold, ROADMAP.md queue B / slice 2 — not "
                  "ported yet")


def streaming_fallback(use_pallas: bool) -> str:
    """The array-ids selection used where the extraction kernel cannot
    run: "seg" with the hand kernels, "topk" without."""
    return "seg" if use_pallas else "topk"


class TopK(NamedTuple):
    """Per-query candidate lists, (..., k). Padding is (+inf, -1, -1)."""

    dists: torch.Tensor   # float32
    labels: torch.Tensor  # int32
    ids: torch.Tensor     # int32


def select_topk(dists: torch.Tensor, labels: torch.Tensor,
                ids: torch.Tensor, k: int) -> TopK:
    """The k best by (dist asc, id desc) along the last axis; labels and
    ids broadcast against ``dists``. Pads with (+inf, -1, -1) when k
    exceeds the axis size."""
    labels = torch.broadcast_to(labels, dists.shape)
    ids = torch.broadcast_to(ids, dists.shape)
    n = dists.shape[-1]
    if k > n:
        shape = dists.shape[:-1] + (k - n,)
        dists = torch.cat([dists, dists.new_full(shape, torch.inf)], -1)
        labels = torch.cat([labels, labels.new_full(shape, -1)], -1)
        ids = torch.cat([ids, ids.new_full(shape, -1)], -1)
    # Least-significant key first: id desc, then a stable sort by dist.
    order = torch.argsort(-ids, dim=-1, stable=True)
    by_d = torch.argsort(torch.gather(dists, -1, order), dim=-1, stable=True)
    order = torch.gather(order, -1, by_d)[..., :k]
    return TopK(torch.gather(dists, -1, order),
                torch.gather(labels, -1, order),
                torch.gather(ids, -1, order))


def merge_topk(a: TopK, b: TopK, k: int) -> TopK:
    """Merge two candidate lists into the k best (root-merge analog)."""
    return select_topk(torch.cat([a.dists, b.dists], -1),
                       torch.cat([a.labels, b.labels], -1),
                       torch.cat([a.ids, b.ids], -1), k)


def init_topk(qb: int, k: int, device) -> TopK:
    """Empty running top-k carry: every slot (+inf, -1, -1)."""
    return TopK(torch.full((qb, k), torch.inf, device=device),
                torch.full((qb, k), -1, dtype=torch.int32, device=device),
                torch.full((qb, k), -1, dtype=torch.int32, device=device))


def make_block_step(select: str, k: int):
    """One running-top-k fold step: (carry, queries, block attrs, block
    labels, block ids) -> carry."""

    def step_sort(carry: TopK, q, battrs, blabels, bids) -> TopK:
        tile = masked_pairwise_sq_l2(q, battrs, bids)
        return merge_topk(carry, TopK(tile, blabels.expand_as(tile),
                                      bids.expand_as(tile)), k)

    def step_topk(carry: TopK, q, battrs, blabels, bids) -> TopK:
        tile = masked_pairwise_sq_l2(q, battrs, bids)
        alld = torch.cat([carry.dists, tile], -1)
        # Stable ascending sort == lax.top_k(-d): ties keep the lowest
        # position, so carry slots win over block columns.
        idx = torch.argsort(alld, dim=-1, stable=True)[:, :k]
        from_carry = idx < k
        cidx = torch.clamp_max(idx, k - 1)
        bidx = torch.clamp_min(idx - k, 0)
        labels = torch.where(from_carry,
                             torch.gather(carry.labels, -1, cidx),
                             blabels[bidx])
        ids = torch.where(from_carry, torch.gather(carry.ids, -1, cidx),
                          bids[bidx])
        return TopK(torch.gather(alld, -1, idx), labels, ids)

    if select == "seg":
        raise NotImplementedError(SEG_NOT_PORTED)
    if select not in ("sort", "topk"):
        raise ValueError(f"unknown select {select!r}")
    return {"sort": step_sort, "topk": step_topk}[select]


def streaming_topk(query_attrs: torch.Tensor, data_attrs: torch.Tensor,
                   data_labels: torch.Tensor, data_ids: torch.Tensor, k: int,
                   data_block: int, select: str = "sort") -> TopK:
    """Top-k per query, folding data blocks of ``data_block`` rows into a
    running carry (``data_attrs`` is padded to whole blocks with id = -1
    sentinel rows)."""
    n = data_attrs.shape[0]
    if n % data_block:
        raise ValueError("pad data to a multiple of data_block first")
    step = make_block_step(select, k)
    carry = init_topk(query_attrs.shape[0], k, query_attrs.device)
    for lo in range(0, n, data_block):
        hi = lo + data_block
        carry = step(carry, query_attrs, data_attrs[lo:hi],
                     data_labels[lo:hi], data_ids[lo:hi])
    return carry
