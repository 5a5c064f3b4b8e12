"""Exact-tie-break k-selection and blockwise merge, in PyTorch.

Port of ``dmlp_tpu/ops/topk.py``. Selection follows the measured
oracle-binary comparator (distance asc, id desc) — a strict total order, so
top-k of a union equals top-k of the concatenated per-block top-k's. The
reference expresses it as a two-key ``lax.sort``; here it is two composed
stable sorts, least-significant key first.

The "topk" and "seg" steps keep the reference ``lax.top_k`` tie rule: on
equal distances the LOWEST POSITION wins (carry slots before block
columns, and lower segment indices first when picking segments).
``torch.topk`` promises no tie order, so they use stable ascending sorts
instead. The "seg" step reads the K3 kernel (``ops.dist_segmin``) with the
hand-written kernels on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmlp_tpu_torch.obs import counters as obs_counters
from dmlp_tpu_torch.ops.distance import masked_pairwise_sq_l2


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


def _tile(q, battrs, bids) -> torch.Tensor:
    """The masked distance tile of the "sort"/"topk" steps (and "seg"
    without the hand-written kernels): a plain ``torch.matmul`` product,
    recorded into an installed cost probe as ``distance_product``."""
    rec = obs_counters.record_dispatch("distance_product", {
        "qb": q.shape[0], "b": battrs.shape[0], "a": q.shape[1]}, q.device)
    tile = masked_pairwise_sq_l2(q, battrs, bids)
    if rec is not None:
        rec.done()
    return tile


def make_block_step(select: str, k: int, use_pallas: bool = False):
    """One running-top-k fold step: (carry, queries, block attrs, block
    labels, block ids) -> carry."""

    def step_sort(carry: TopK, q, battrs, blabels, bids) -> TopK:
        tile = _tile(q, battrs, bids)
        return merge_topk(carry, TopK(tile, blabels.expand_as(tile),
                                      bids.expand_as(tile)), k)

    def merge_cand(carry: TopK, cand_d, cand_l, cand_i) -> TopK:
        """The k smallest of carry ++ candidate columns. A stable ascending
        sort == lax.top_k(-d): ties keep the lowest position, so carry
        slots win over candidates."""
        alld = torch.cat([carry.dists, cand_d], -1)
        idx = torch.argsort(alld, dim=-1, stable=True)[:, :k]
        from_carry = idx < k
        cidx = torch.clamp_max(idx, k - 1)
        bidx = torch.clamp_min(idx - k, 0)
        labels = torch.where(from_carry,
                             torch.gather(carry.labels, -1, cidx),
                             torch.gather(cand_l, -1, bidx))
        ids = torch.where(from_carry, torch.gather(carry.ids, -1, cidx),
                          torch.gather(cand_i, -1, bidx))
        return TopK(torch.gather(alld, -1, idx), labels, ids)

    def step_full(carry: TopK, tile, blabels, bids) -> TopK:
        return merge_cand(carry, tile, blabels.expand_as(tile),
                          bids.expand_as(tile))

    def step_topk(carry: TopK, q, battrs, blabels, bids) -> TopK:
        return step_full(carry, _tile(q, battrs, bids), blabels, bids)

    def step_seg(carry: TopK, q, battrs, blabels, bids) -> TopK:
        """Segment-min threshold selection: the exact tile top-k from the
        S = min(nseg, k + 16) segments with the smallest minima (every
        tile-top-k point lies in a segment whose min is <= the k-th
        smallest segment min T). When the S-th picked min still ties T
        (more eligible segments may lie beyond S) the step takes the full
        tile instead — decided on the host, one flag read per step."""
        from dmlp_tpu_torch.ops.dist_segmin import SEG, fused_dist_segmin
        if use_pallas:
            tile, segmin = fused_dist_segmin(q, battrs, bids)
        else:
            tile = _tile(q, battrs, bids)
            segmin = tile.view(tile.shape[0], -1, SEG).min(-1).values
        qb, bcols = tile.shape
        nseg = bcols // SEG
        s = min(nseg, k + 16)
        if s == nseg:
            return step_full(carry, tile, blabels, bids)
        seg_idx = torch.argsort(segmin, dim=-1, stable=True)[:, :s]
        sel_min = torch.gather(segmin, -1, seg_idx)
        t = sel_min[:, min(k, s) - 1]
        last = sel_min[:, -1]
        if bool((torch.isfinite(last) & (last <= t)).any()):
            return step_full(carry, tile, blabels, bids)
        # Whole SEG-column segments, gathered in pick order.
        cand_d = torch.gather(tile.view(qb, nseg, SEG), 1,
                              seg_idx[:, :, None].expand(qb, s, SEG))
        cand_l = blabels.view(nseg, SEG)[seg_idx]
        cand_i = bids.view(nseg, SEG)[seg_idx]
        return merge_cand(carry, cand_d.reshape(qb, s * SEG),
                          cand_l.reshape(qb, s * SEG),
                          cand_i.reshape(qb, s * SEG))

    if select not in ("sort", "topk", "seg"):
        raise ValueError(f"unknown select {select!r}")
    return {"sort": step_sort, "topk": step_topk, "seg": step_seg}[select]


def streaming_topk(query_attrs: torch.Tensor, data_attrs: torch.Tensor,
                   data_labels: torch.Tensor, data_ids: torch.Tensor, k: int,
                   data_block: int, select: str = "sort",
                   use_pallas: bool = False) -> TopK:
    """Top-k per query, folding data blocks of ``data_block`` rows into a
    running carry (``data_attrs`` is padded to whole blocks with id = -1
    sentinel rows). "extract" takes the array-ids fallback (its kernel
    needs affine ids); "seg" on blocks that are not whole 128-column
    segments of at least two takes "topk", as the reference does."""
    n = data_attrs.shape[0]
    if n % data_block:
        raise ValueError("pad data to a multiple of data_block first")
    if select == "extract":
        select = streaming_fallback(use_pallas)
    if select == "seg" and (data_block % 128 != 0 or data_block < 256):
        select = "topk"
    step = make_block_step(select, k, use_pallas)
    carry = init_topk(query_attrs.shape[0], k, query_attrs.device)
    for lo in range(0, n, data_block):
        hi = lo + data_block
        carry = step(carry, query_attrs, data_attrs[lo:hi],
                     data_labels[lo:hi], data_ids[lo:hi])
    return carry
