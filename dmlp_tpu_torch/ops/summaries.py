"""Per-block coarse summaries and sound bound-based scan pruning.

Port of ``dmlp_tpu/ops/summaries.py``: stages 0 and 1 of the pruned
two-stage solve, on the host in float64, with the reference's operations in
the reference's order, so that a survivor mask is equal bit for bit.

- **Stage 0 (build)** — :func:`build_summaries`: per extract-chunk-aligned
  block, the row-norm band [min |x|, max |x|], the per-attribute bounding
  box [lo_a, hi_a], and the same over a 2-piece median split plus the
  block's norm median with its exact cover count.
- **Stage 1 (prune)** — :func:`prune_mask`: a sound per-(query, block)
  lower bound on the squared distance (``max(norm band, box gap)``) is
  compared with a per-query upper bound on the k-th-best distance (block
  upper bounds accumulated in ascending order until >= k real rows are
  covered). A block is pruned only when its lower bound clears the
  threshold by more than the staging-eps margin
  (``engine.finalize.staging_eps``, plus ``lowp_eps`` under a bf16 first
  pass), for every query. A pruned block provably holds no row of any
  query's float64 top-k, so the exact stage over the survivors prints the
  dense scan's bytes.

Kill switch: ``DMLP_TPU_PRUNE=0``. The engine prunes only on the
degradation ladder's top ``lowp``/``prune`` rungs and in exact mode.

The host scoring's block chunk resolves through the tune cache's
``prune_score`` namespace (:func:`resolve_score_variant`); a chunk changes
how the bounds are sliced, never a survivor mask, and the sweep persists
only a chunk whose masks are equal bit for bit.

The resident serving engine (``serve.engine``) keeps one summary block per
resident extraction chunk, rebuilds exactly the blocks an ingest touches
(:func:`update_block`), and scores them per micro-batch on the device
(:func:`stage_summaries`, :func:`score_blocks`: plain torch in f32 with
the same bound, threshold and eps structure as :func:`prune_mask`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dmlp_tpu_torch.engine.finalize import lowp_eps, staging_eps

#: sub-block pieces per block (a median split on the max-spread
#: attribute). Whole-block boxes go vacuous on uniform corpora (every box
#: is the full cube); two pieces make each box a half-cube, so queries in
#: the other half see a strictly positive gap.
PIECES = 2

#: host-scoring block chunk (blocks per vectorized slab): bounds the
#: (Q, chunk, A) f64 temporary
_SCORE_BLOCK_CHUNK = 128


def prune_enabled() -> bool:
    """The prune-path kill switch ($DMLP_TPU_PRUNE=0 disables), read per
    call so tests and operators can flip it without re-imports."""
    return os.environ.get("DMLP_TPU_PRUNE", "1") != "0"


def resolve_score_variant(n_blocks: int, a: int, nq: Optional[int] = None,
                          device="cpu") -> dict:
    """Scoring-pass tiling (``tile_q`` is the host block chunk): with the
    query count ``nq``, the tune cache's measured ``prune_score`` winner
    for this scoring on ``device``'s machine where one exists, else the
    deterministic default. Any chunk >= 1 fits."""
    if nq is not None:
        from dmlp_tpu_torch.tune import cache as tune_cache
        v = tune_cache.lookup_variant("prune_score", qb=nq, b=n_blocks, a=a,
                                      kc=0, device=device, dtype="float64")
        if v is not None:
            return {"tile_q": v["tile_q"], "ne": 1, "unroll": 1}
    return {"tile_q": _SCORE_BLOCK_CHUNK, "ne": 1, "unroll": 1}


@dataclasses.dataclass
class BlockSummaries:
    """Coarse per-block summaries over contiguous global row ranges.

    ``ranges[b] = (lo, hi)`` is block b's real-row span (empty blocks carry
    count 0 and never survive). Norms are L2 (not squared); boxes are
    closed per-attribute intervals. All float64: the bounds must dominate
    the golden model's float64 distances."""

    ranges: List[Tuple[int, int]]
    counts: np.ndarray        # (B,)   int64 real rows per block
    nmin: np.ndarray          # (B,)   f64 min row norm (+inf if empty)
    nmax: np.ndarray          # (B,)   f64 max row norm (-inf if empty)
    lo: np.ndarray            # (B, A) f64 box lower (+inf if empty)
    hi: np.ndarray            # (B, A) f64 box upper (-inf if empty)
    # The 2-piece split (None = whole-block only):
    pcounts: Optional[np.ndarray] = None  # (B, P)    int64 rows per piece
    pnmin: Optional[np.ndarray] = None    # (B, P)    f64 min piece norm
    pnmax: Optional[np.ndarray] = None    # (B, P)    f64 max piece norm
    plo: Optional[np.ndarray] = None      # (B, P, A) f64 piece box lower
    phi: Optional[np.ndarray] = None      # (B, P, A) f64 piece box upper
    # Per-block norm median and the exact count of rows at or below it:
    nq50: Optional[np.ndarray] = None      # (B,) f64 (+inf if empty)
    nq50_cnt: Optional[np.ndarray] = None  # (B,) int64

    @property
    def n_blocks(self) -> int:
        return len(self.ranges)

    @property
    def nbytes(self) -> int:
        base = (self.counts.nbytes + self.nmin.nbytes + self.nmax.nbytes
                + self.lo.nbytes + self.hi.nbytes)
        for extra in (self.pcounts, self.pnmin, self.pnmax, self.plo,
                      self.phi, self.nq50, self.nq50_cnt):
            if extra is not None:
                base += extra.nbytes
        return base


def summarize_rows(rows: np.ndarray, na: int):
    """(count, nmin, nmax, lo, hi) of one block's real rows."""
    m = rows.shape[0]
    if m == 0:
        return 0, np.inf, -np.inf, np.full(na, np.inf), np.full(na, -np.inf)
    r = np.asarray(rows, np.float64)
    norms = np.sqrt(np.einsum("ia,ia->i", r, r))
    return (m, float(norms.min()), float(norms.max()),
            r.min(axis=0), r.max(axis=0))


def split_rows(rows: np.ndarray, na: int):
    """Piece-level summaries of one block: a median split on the
    max-spread attribute, plus the norm median and its exact cover count.
    Returns ``(pieces, nq50, nq50_cnt)``. Any partition is sound, so the
    degenerate split (every row equal on the attribute) halves by
    position."""
    r = np.asarray(rows, np.float64)
    m = r.shape[0]
    if m == 0:
        empty = summarize_rows(r, na)
        return [empty] * PIECES, np.inf, 0
    norms = np.sqrt(np.einsum("ia,ia->i", r, r))
    nq50 = float(np.quantile(norms, 0.5))
    nq50_cnt = int((norms <= nq50).sum())
    spread = r.max(axis=0) - r.min(axis=0)
    ax = int(np.argmax(spread))
    left = r[:, ax] <= float(np.median(r[:, ax]))
    if left.all() or not left.any():
        left = np.arange(m) < (m // 2)
    pieces = [summarize_rows(r[left], na), summarize_rows(r[~left], na)]
    return pieces, nq50, nq50_cnt


def build_summaries(attrs: np.ndarray,
                    ranges: Sequence[Tuple[int, int]],
                    pieces: int = PIECES) -> BlockSummaries:
    """Stage 0: summaries for ``attrs`` over ``ranges`` (blocks whose span
    is empty or past the data end count 0); ``pieces`` <= 1 builds the
    whole-block-only format. Only each block's slice is cast to float64,
    never the whole corpus."""
    attrs = np.asarray(attrs)
    n, na = attrs.shape if attrs.ndim == 2 else (0, 1)
    nb = len(ranges)
    counts = np.zeros(nb, np.int64)
    nmin = np.full(nb, np.inf)
    nmax = np.full(nb, -np.inf)
    lo = np.full((nb, na), np.inf)
    hi = np.full((nb, na), -np.inf)
    split = pieces > 1
    pcounts = np.zeros((nb, PIECES), np.int64) if split else None
    pnmin = np.full((nb, PIECES), np.inf) if split else None
    pnmax = np.full((nb, PIECES), -np.inf) if split else None
    plo = np.full((nb, PIECES, na), np.inf) if split else None
    phi = np.full((nb, PIECES, na), -np.inf) if split else None
    nq50 = np.full(nb, np.inf) if split else None
    nq50_cnt = np.zeros(nb, np.int64) if split else None
    for b, (blo, bhi) in enumerate(ranges):
        blo, bhi = max(blo, 0), min(bhi, n)
        rows = attrs[blo:bhi]
        counts[b], nmin[b], nmax[b], lo[b], hi[b] = summarize_rows(
            rows, na)
        if split:
            pc, nq50[b], nq50_cnt[b] = split_rows(rows, na)
            for p, (cm, cn, cx, cl, ch) in enumerate(pc):
                pcounts[b, p], pnmin[b, p], pnmax[b, p] = cm, cn, cx
                plo[b, p], phi[b, p] = cl, ch
    return BlockSummaries(list((int(a), int(b)) for a, b in ranges),
                          counts, nmin, nmax, lo, hi,
                          pcounts, pnmin, pnmax, plo, phi,
                          nq50, nq50_cnt)


def update_block(summ: BlockSummaries, b: int, rows: np.ndarray,
                 lo_hi: Optional[Tuple[int, int]] = None) -> None:
    """Rebuild exactly block ``b`` from its current real rows, pieces
    included: the serving ingest path calls it for every block it touches
    (a stale summary could keep a block pruned whose new rows belong in a
    top-k, the one fault the boundary repair cannot catch)."""
    if lo_hi is not None:
        summ.ranges[b] = (int(lo_hi[0]), int(lo_hi[1]))
    na = summ.lo.shape[1]
    rows = np.asarray(rows, np.float64)
    (summ.counts[b], summ.nmin[b], summ.nmax[b],
     summ.lo[b], summ.hi[b]) = summarize_rows(rows, na)
    if summ.pcounts is not None:
        pc, summ.nq50[b], summ.nq50_cnt[b] = split_rows(rows, na)
        for p, (cm, cn, cx, cl, ch) in enumerate(pc):
            summ.pcounts[b, p], summ.pnmin[b, p], summ.pnmax[b, p] = \
                cm, cn, cx
            summ.plo[b, p], summ.phi[b, p] = cl, ch


def block_bounds(queries: np.ndarray, summ: BlockSummaries,
                 block_chunk: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(query, block) squared-distance bounds, f64: ``lb`` a lower
    bound to any real row of the block (max of the norm-band and box-gap
    bounds), ``ub`` an upper bound to every real row (min of the
    farthest-corner and norm-sum bounds); +inf for empty blocks."""
    q = np.asarray(queries, np.float64)
    nq, na = q.shape
    nb = summ.n_blocks
    qnorm = np.sqrt(np.einsum("qa,qa->q", q, q))
    lb = np.empty((nq, nb))
    ub = np.empty((nq, nb))
    chunk = block_chunk or resolve_score_variant(nb, na)["tile_q"]
    for b0 in range(0, nb, chunk):
        b1 = min(b0 + chunk, nb)
        nmin, nmax = summ.nmin[b0:b1], summ.nmax[b0:b1]
        band = np.maximum(nmin[None, :] - qnorm[:, None],
                          qnorm[:, None] - nmax[None, :])
        lbn = np.square(np.maximum(band, 0.0))
        dlo = summ.lo[None, b0:b1] - q[:, None, :]
        dhi = q[:, None, :] - summ.hi[None, b0:b1]
        gap = np.maximum(np.maximum(dlo, dhi), 0.0)
        lbb = np.einsum("qba,qba->qb", gap, gap)
        lb[:, b0:b1] = np.maximum(lbn, lbb)
        far = np.maximum(np.abs(q[:, None, :] - summ.lo[None, b0:b1]),
                         np.abs(q[:, None, :] - summ.hi[None, b0:b1]))
        ubb = np.einsum("qba,qba->qb", far, far)
        ub[:, b0:b1] = np.minimum(
            ubb, np.square(qnorm[:, None] + nmax[None, :]))
    empty = summ.counts <= 0
    lb[:, empty] = np.inf
    ub[:, empty] = np.inf
    return lb, ub


def piece_bounds(queries: np.ndarray, summ: BlockSummaries,
                 block_chunk: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(query, block, piece) bounds, f64: the block_bounds formulas
    over the piece norm bands and boxes (+inf for empty pieces). Requires
    the split format."""
    q = np.asarray(queries, np.float64)
    nq_, na = q.shape
    nb = summ.n_blocks
    npieces = summ.pcounts.shape[1]
    qnorm = np.sqrt(np.einsum("qa,qa->q", q, q))
    plb = np.empty((nq_, nb, npieces))
    pub = np.empty((nq_, nb, npieces))
    # block_bounds' chunk, divided by the pieces: the (Q, chunk, P, A)
    # temporary is P times the whole-block one.
    chunk = block_chunk or max(
        1, resolve_score_variant(nb, na)["tile_q"] // npieces)
    for b0 in range(0, nb, chunk):
        b1 = min(b0 + chunk, nb)
        nmin, nmax = summ.pnmin[b0:b1], summ.pnmax[b0:b1]   # (c, P)
        band = np.maximum(nmin[None] - qnorm[:, None, None],
                          qnorm[:, None, None] - nmax[None])
        lbn = np.square(np.maximum(band, 0.0))
        dlo = summ.plo[None, b0:b1] - q[:, None, None, :]
        dhi = q[:, None, None, :] - summ.phi[None, b0:b1]
        gap = np.maximum(np.maximum(dlo, dhi), 0.0)
        lbb = np.einsum("qbpa,qbpa->qbp", gap, gap)
        plb[:, b0:b1] = np.maximum(lbn, lbb)
        far = np.maximum(
            np.abs(q[:, None, None, :] - summ.plo[None, b0:b1]),
            np.abs(q[:, None, None, :] - summ.phi[None, b0:b1]))
        ubb = np.einsum("qbpa,qbpa->qbp", far, far)
        pub[:, b0:b1] = np.minimum(
            ubb, np.square(qnorm[:, None, None] + nmax[None]))
    emptyp = summ.pcounts <= 0
    plb[:, emptyp] = np.inf
    pub[:, emptyp] = np.inf
    return plb, pub


def kth_thresholds(ub: np.ndarray, counts: np.ndarray,
                   ks: np.ndarray) -> np.ndarray:
    """Per-query upper bound on the true k-th-best squared distance:
    block upper bounds accumulated ascending until >= k real rows are
    covered. +inf when the corpus holds fewer than k rows."""
    ks = np.asarray(ks, np.int64)
    order = np.argsort(ub, axis=1, kind="stable")
    sub = np.take_along_axis(ub, order, axis=1)
    csum = np.cumsum(np.asarray(counts, np.int64)[order], axis=1)
    reached = csum >= ks[:, None]
    idx = np.argmax(reached, axis=1)
    thr = np.take_along_axis(sub, idx[:, None], axis=1)[:, 0]
    return np.where(reached.any(axis=1), thr, np.inf)


def prune_mask(queries: np.ndarray, ks: np.ndarray,
               summ: BlockSummaries, *, staging: str = "float32",
               precision: str = "f32",
               block_chunk: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
    """Stage 1 on the host (f64): the survivor mask over ``summ``'s blocks
    for this query batch, and a stats record.

    Block b is pruned iff for every query q ``lb(q, b) > thr(q) + eps(q)``,
    with eps the staging eps at the threshold plus, under a "bf16" first
    pass, ``lowp_eps``. With the split format three independently sound
    thresholds (block, piece, and the per-block norm split; each over
    disjoint row groups) combine by elementwise min, and the block lower
    bound sharpens to the max of its own and its pieces' minimum.
    ``block_chunk`` slices the bounds ``block_chunk`` blocks at a time
    (the pieces at half that), None at the default."""
    q = np.asarray(queries, np.float64)
    na = q.shape[1]
    lb, ub = block_bounds(q, summ, block_chunk)
    thr = kth_thresholds(ub, summ.counts, ks)
    plb = None
    if summ.pcounts is not None:
        plb, pub = piece_bounds(q, summ, block_chunk and max(
            1, block_chunk // summ.pcounts.shape[1]))
        lb = np.maximum(lb, plb.min(axis=2))
        thr = np.minimum(thr, kth_thresholds(
            pub.reshape(len(q), -1), summ.pcounts.reshape(-1), ks))
        qnorm = np.sqrt(np.einsum("qa,qa->q", q, q))
        near = np.square(qnorm[:, None] + summ.nq50[None, :])
        thr = np.minimum(thr, kth_thresholds(
            np.concatenate([near, ub], axis=1),
            np.concatenate([summ.nq50_cnt,
                            summ.counts - summ.nq50_cnt]), ks))
    live = summ.counts > 0
    dn_max = float(np.square(summ.nmax[live]).max()) if live.any() else 0.0
    qn = np.einsum("qa,qa->q", q, q)
    eps = staging_eps(thr, qn, dn_max, staging, na) \
        + lowp_eps(precision, qn, dn_max)
    keep = lb <= (thr + eps)[:, None]
    survivors = live & keep.any(axis=0)
    total = int(live.sum())
    pruned = int(total - int((survivors & live).sum()))
    stats = {
        "blocks_total": total,
        "blocks_pruned": pruned,
        "pruned_fraction": round(pruned / total, 6) if total else 0.0,
        "summary_bytes": int(summ.nbytes),
    }
    if plb is not None:
        # Fraction of (query, live piece) pairs with a strictly positive
        # lower bound: the split's non-vacuity meter.
        livep = (summ.pcounts > 0).reshape(-1)
        flat = plb.reshape(len(q), -1)[:, livep]
        stats["lb_positive_fraction"] = (
            round(float((flat > 0.0).mean()), 6) if flat.size else 0.0)
    return survivors, stats


def _directed_f32(x, up: bool) -> np.ndarray:
    """float64 -> float32 rounded up (``up``) or down, so the f32 value
    bounds the f64 one on the stated side."""
    x = np.asarray(x, np.float64)
    x32 = x.astype(np.float32)
    back = x32.astype(np.float64)
    bad = (back < x) if up else (back > x)
    adj = np.nextafter(x32, np.float32(np.inf if up else -np.inf))
    return np.where(bad, adj, x32).astype(np.float32)


def stage_summaries(summ: BlockSummaries, device) -> Dict:
    """Conservative f32 copies of the whole-block summaries on ``device``
    (O(blocks * a) bytes). Box lows and norm minima round down, box highs
    and norm maxima round up, so the f32 box and band contain the f64
    ones: the device lower bounds can only loosen, never become unsound;
    the scorer's own f32 arithmetic error is the eps margin's job."""
    import torch
    live = summ.counts > 0
    dn_max = float(np.square(summ.nmax[live]).max()) if live.any() else 0.0

    def put(a):
        return torch.as_tensor(np.array(a)).to(device)

    return {
        "counts": put(np.asarray(summ.counts, np.int32)),
        "nmin": put(_directed_f32(summ.nmin, up=False)),
        "nmax": put(_directed_f32(summ.nmax, up=True)),
        "lo": put(_directed_f32(summ.lo, up=False)),
        "hi": put(_directed_f32(summ.hi, up=True)),
        "dn_max": put(_directed_f32(np.float64(dn_max), up=True)),
    }


def score_terms(q, qvalid, ks, counts, nmin, nmax, lo, hi, dn_max,
                eps_rel, eps_cancel):
    """The terms of :func:`score_blocks`, in f32 on the tensors' device:
    (lb (Qp, B) lower bounds, thr (Qp,) k-th-best upper bounds, eps (Qp,)
    margins, keep (B,) survivor mask)."""
    import torch
    q32 = q.float()
    qn = (q32 * q32).sum(-1)
    qnorm = torch.sqrt(qn)
    band = torch.maximum(nmin[None, :] - qnorm[:, None],
                         qnorm[:, None] - nmax[None, :])
    lbn = torch.square(torch.clamp_min(band, 0.0))
    gap = torch.clamp_min(torch.maximum(lo[None] - q32[:, None, :],
                                        q32[:, None, :] - hi[None]), 0.0)
    lbb = (gap * gap).sum(-1)
    far = torch.maximum(torch.abs(q32[:, None, :] - lo[None]),
                        torch.abs(q32[:, None, :] - hi[None]))
    ubb = (far * far).sum(-1)
    ub = torch.minimum(ubb, torch.square(qnorm[:, None] + nmax[None, :]))
    empty = counts <= 0
    ub = torch.where(empty[None, :], torch.inf, ub)
    lb = torch.where(empty[None, :], torch.inf, torch.maximum(lbn, lbb))
    # The accumulation's order must be stable, as jnp.argsort's is.
    order = torch.argsort(ub, dim=1, stable=True)
    sub = torch.gather(ub, 1, order)
    csum = torch.cumsum(counts.long()[order], dim=1)
    reached = csum >= ks.long()[:, None]
    idx = torch.argmax(reached.to(torch.int8), dim=1)
    thr = torch.where(reached.any(1),
                      torch.gather(sub, 1, idx[:, None])[:, 0], torch.inf)
    scale = qn + dn_max
    eps = (eps_rel * torch.sqrt(torch.clamp_min(thr, 0.0) * scale)
           + eps_cancel * scale)
    keep = qvalid[:, None] & (lb <= (thr + eps)[:, None])
    return lb, thr, eps, keep.any(0) & ~empty


def score_blocks(q, qvalid, ks, counts, nmin, nmax, lo, hi, dn_max,
                 eps_rel, eps_cancel):
    """Stage 1 on the device for one padded micro-batch: the (B,) bool
    survivor mask over the resident summaries, with the bound, threshold
    and eps structure of :func:`prune_mask` in f32. ``qvalid`` masks the
    bucket's padding queries out of the union; ``eps_rel`` and
    ``eps_cancel`` are the staging-eps constants, prescaled on the host
    (rel, and EPS_CANCEL_COEF * (na + 2) plus the plan's LOWP_COEF)."""
    from dmlp_tpu_torch.obs import counters as obs_counters
    rec = obs_counters.record_dispatch("summaries_score", {
        "qb": q.shape[0], "nblocks": counts.shape[0], "a": q.shape[1]},
        q.device)
    keep = score_terms(q, qvalid, ks, counts, nmin, nmax, lo, hi, dn_max,
                       eps_rel, eps_cancel)[3]
    if rec is not None:
        rec.done()
    return keep


def note_scan(engine, *, scanned_bytes: int, dense_bytes: int,
              blocks_total: int, blocks_pruned: int) -> None:
    """Fold one solve's scan accounting into ``engine.last_prune`` and the
    telemetry registry (``scan.bytes_streamed``, ``prune.blocks_total``,
    ``prune.blocks_pruned``, ``prune.gated_fraction``, the reference's
    metric names). Dense solves record too (blocks_pruned 0).
    ``scanned_bytes`` counts the corpus rows staged to the device: a
    pruned chunk is never copied."""
    rec = engine.last_prune if isinstance(
        getattr(engine, "last_prune", None), dict) else {}
    rec.update(blocks_total=int(blocks_total),
               blocks_pruned=int(blocks_pruned),
               scanned_bytes=int(scanned_bytes),
               dense_bytes=int(dense_bytes))
    rec["pruned_fraction"] = (round(blocks_pruned / blocks_total, 6)
                              if blocks_total else 0.0)
    engine.last_prune = rec
    from dmlp_tpu_torch.obs import telemetry
    reg = telemetry.registry()
    reg.counter("scan.bytes_streamed").inc(int(scanned_bytes))
    reg.counter("prune.blocks_total").inc(int(blocks_total))
    reg.counter("prune.blocks_pruned").inc(int(blocks_pruned))
    reg.gauge("prune.gated_fraction").set(rec["pruned_fraction"])
