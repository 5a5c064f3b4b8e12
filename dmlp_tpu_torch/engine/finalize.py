"""Host-side result finalization shared by all engines.

The device engines return, per query, a selection-ordered candidate list of
size K >= max-k (+ margin). This module turns those lists into final
``QueryResult``s: optional exact float64 rescoring (restoring the reference's
double-precision ordering, engine.cpp:12 / common.h:13, without paying f64 on
the device), the per-query k cut, the majority vote (engine.cpp:320-332), the
report sort (engine.cpp:334-338), and -1-sentinel padding (common.cpp:66).

Everything is vectorized NumPy over (Q, K) arrays — K is small (tens), so
this is a negligible epilogue next to the O(Q*N*A) device work.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dmlp_tpu_torch.io.report import QueryResult


def _row_lexsort(primary: np.ndarray, *descending_ints: np.ndarray) -> np.ndarray:
    """Row-wise argsort by (primary asc, then each int key desc), stable.

    Implemented as composed stable sorts, least-significant key first (the
    radix trick), all vectorized along axis 1.
    """
    idx = np.broadcast_to(np.arange(primary.shape[1]), primary.shape).copy()
    keys = [(-k).astype(np.int64) for k in reversed(descending_ints)] + [primary]
    for key in keys:  # least-significant first; stable sorts compose
        cur = np.take_along_axis(key, idx, axis=1)
        order = np.argsort(cur, axis=1, kind="stable")
        idx = np.take_along_axis(idx, order, axis=1)
    return idx


def _vote_batch(labels: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Vectorized majority vote with tie -> larger label; -1 if none valid."""
    q = labels.shape[0]
    masked = np.where(valid, labels, -1)
    num_labels = int(masked.max()) + 1 if masked.size and masked.max() >= 0 else 0
    if num_labels == 0:
        return np.full(q, -1, np.int64)
    counts = np.zeros((q, num_labels), np.int64)
    rows = np.broadcast_to(np.arange(q)[:, None], labels.shape)
    sel = masked >= 0
    np.add.at(counts, (rows[sel], masked[sel]), 1)
    best = counts.max(axis=1)
    is_best = counts == best[:, None]
    predicted = num_labels - 1 - np.argmax(is_best[:, ::-1], axis=1)
    return np.where(best > 0, predicted, -1)


def rescore_f64(cand_ids: np.ndarray, query_attrs: np.ndarray,
                data_attrs: np.ndarray, block: int = 512) -> np.ndarray:
    """Exact float64 distances for candidate ids (difference form, like
    computeDistance at engine.cpp:12-18). ids < 0 map to +inf.

    ``block`` bounds the (block, K, A) gather temp. 512 measured 2.4x
    faster than 1024 at the wide-k shape (10240 x 4608 x 64: 36 s vs
    87 s — the 2.4 GB temps of block=1024 fall out of cache); 64-512
    are within noise of each other there and at narrow k the temps are
    tiny either way."""
    q, k = cand_ids.shape
    out = np.empty((q, k), np.float64)
    safe = np.clip(cand_ids, 0, data_attrs.shape[0] - 1)
    for q0 in range(0, q, block):
        q1 = min(q0 + block, q)
        gathered = data_attrs[safe[q0:q1]]                       # (b, K, A)
        diff = gathered - query_attrs[q0:q1, None, :]
        out[q0:q1] = np.einsum("qka,qka->qk", diff, diff)
    out[cand_ids < 0] = np.inf
    return out


# Calibrated eps-bound constants — THE single definition, shared by the
# host hazard test below and the device-side multi-pass floor
# (engine.single._mp_floor); a recalibration here propagates to both.
EPS_REL_BF16 = 2.0 ** -6
EPS_REL_F32 = 2.0 ** -21
EPS_CANCEL_COEF = 3.0 * 2.0 ** -22

#: Low-precision FIRST-PASS coefficients (the tentpole's ``lowp_eps``
#: bound): casting the streamed q/d tiles to the pass dtype perturbs
#: each operand by a relative half-ulp u (2^-8 for bfloat16's 7
#: explicit mantissa bits), so the f32-accumulated cross term errs by
#: at most (2u + u^2) * |q||d| <= (2u + u^2) * (qn + dn)/2 per dot
#: (AM-GM), i.e. the norm-expansion distance by (2u + u^2)(qn + dn) —
#: a bound on the MAGNITUDE scale, independent of the distance itself
#: (unlike staging_eps term 1, which shrinks with sqrt(dist)). The
#: coefficient folds the 2u, the second-order u^2, and a 2x safety
#: slack: 2^-6 = 8 * 2^-9 >= (2*2^-8 + 2^-16) * 2. f32 is the exact
#: pass (zero cast error — the f32 accumulation itself is already
#: covered by the EPS_CANCEL_COEF term everywhere this composes).
#: tests/test_precision.py fuzzes the bound with directed adversarial
#: magnitude-cancellation corpora. int8 has NO entry: an int8 pass
#: needs data-dependent quantization scales, so its bound cannot be a
#: static coefficient — the ROADMAP follow-on.
LOWP_COEF = {"f32": 0.0, "bf16": 2.0 ** -6}


def lowp_eps(precision: str, qn: np.ndarray, dn_max: float) -> np.ndarray:
    """Per-query bound on the distance perturbation a low-precision
    FIRST PASS (ops.extract with ``precision != "f32"``) can add
    on top of the staging/f32 terms: ``LOWP_COEF[precision] * (qn +
    dn_max)``. Composes ADDITIVELY with :func:`staging_eps` (the cast
    error of the pass dtype and the staging/accumulation errors act on
    the same computed distance, so their bounds sum) at every decision
    the low-precision distances feed: the truncation-hazard test, the
    prune thresholds, the norm-bound tile gate, and the multi-pass floor.
    Zero for the exact "f32" pass. Raises KeyError on a precision with
    no static bound (int8 — see LOWP_COEF)."""
    coef = LOWP_COEF[precision]
    if not coef:
        return np.zeros_like(np.asarray(qn, np.float64))
    return coef * (np.asarray(qn, np.float64) + dn_max)


def staging_eps(last: np.ndarray, qn: np.ndarray, dn_max: float,
                staging: str, na: int) -> np.ndarray:
    """Per-query bound on the distance perturbation the device pipeline
    can introduce, for the truncation-hazard test. Two terms:

    1. ATTR ROUNDING — casting attrs to the staging dtype perturbs each
       computed distance by at most (first order, Cauchy-Schwarz over the
       per-attr terms)

           |d~ - d| <= 2 * u * sqrt(d) * sqrt(2 * (|q|^2 + |x|^2))

       with u the half-ulp relative rounding (2^-9 for bfloat16, 2^-24
       for float32).
    2. COMPUTATION — the norm-expansion form qn + dn - 2 q.x evaluates
       three terms of magnitude ~(qn + dn) in f32 and CANCELS them, so
       its rounding error scales with the MAGNITUDES, not the result:
       ~(na + 2) * u32 * (qn + dn). When true distances are tiny against
       the coordinate scale (clustered data), this term dwarfs term 1 —
       the fuzz case the original attr-only bound missed: near-duplicate
       points at coordinate scale ~5 have gaps ~1e-6 but f32 cancellation
       error ~1e-5, silently reordering candidates past the margin.

    Neither error is monotone across points, so two points' device
    distances can swap even without an exact device tie — an
    exact-equality hazard test is sound only for exact device arithmetic.
    Comparing the k-th candidate against a potentially missed point
    doubles both bounds; the constants fold the doubling, sqrt(2), a
    >= 1.4x second-order slack, and (term 2) u32 = 2^-22 covering an
    IEEE f32 product (no TF32) on top of f32 accumulation. ``dn_max``
    (max squared data-row norm, f64) bounds
    |x|^2 over every point, known or missed.
    """
    rel = EPS_REL_BF16 if staging == "bfloat16" else EPS_REL_F32
    scale = qn + dn_max
    return (rel * np.sqrt(np.maximum(last, 0.0) * scale)
            + EPS_CANCEL_COEF * (na + 2) * scale)


def boundary_hazard(kth: np.ndarray, last: np.ndarray,
                    eps: np.ndarray | float = 0.0) -> np.ndarray:
    """The (eps-widened) truncation-hazard predicate on the two boundary
    columns — THE single definition; boundary_overflow, the single-chip
    engine (which fetches only these columns), and the distributed
    rescore all evaluate this. +inf in the last slot means the candidate
    list wasn't even full of real points — nothing can have been
    truncated."""
    return np.isfinite(last) & (last <= kth + eps)


def boundary_overflow(device_dists: np.ndarray, ks: np.ndarray,
                      eps: np.ndarray | float = 0.0) -> np.ndarray:
    """Queries whose fast-path candidate set may have truncated a tie group.

    The "topk" selection keeps the K smallest device distances with ties
    broken by position, not by the reference's larger-id preference
    (dmlp_tpu_torch.ops.topk). A query's true top-k can then be missing
    from the candidates only if >= K entries tie at or below its k-th
    distance — which implies its k-th candidate distance equals the K-th
    (last) one. That equality is the hazard test: exact (conservative — it
    can flag safe queries, never miss an unsafe one) and computable from the
    raw device distances alone. Flagged queries are recomputed exactly on
    host (engines call dmlp_tpu_torch.golden on just those), so parity survives
    adversarial duplicate-heavy data on the fast path too.

    ``eps`` widens the test to ``last <= kth + eps`` for staging dtypes
    whose rounding perturbs distances non-monotonically (staging_eps): a
    true neighbor can then sit up to eps ABOVE the k-th device distance,
    so the list has provably captured the true top-k only when the
    candidate horizon (last) clears the k-th distance by more than eps.
    With eps = 0 this reduces to the exact-tie test.

    Args:
      device_dists: (Q, K) raw device candidate distances, selection order.
      ks: (Q,) per-query k.
      eps: scalar or (Q,) staging-dtype perturbation bound.

    Returns:
      (Q,) bool mask of suspect queries.
    """
    q, kcap = device_dists.shape
    if q == 0 or kcap == 0:
        return np.zeros(q, bool)
    last = device_dists[:, kcap - 1]
    kth = device_dists[np.arange(q), np.clip(np.asarray(ks) - 1, 0, kcap - 1)]
    return boundary_hazard(kth, last, eps)


def repair_boundary_overflow(results: List[QueryResult],
                             suspect_idx: np.ndarray, inp) -> None:
    """Recompute the flagged queries exactly (golden model) in place.

    ``suspect_idx`` holds local query indices (positions in ``results`` /
    ``inp`` row order); the repaired entries keep their original query ids.

    Repairs run through the vectorized oracle (golden.fast: BLAS coarse
    pass + exact f64 rescore + strict fallback), not the per-query strict
    model: staging-eps hazards can flag thousands of queries at once
    (bf16 on dense distance distributions), and the repair must stay a
    BLAS pass, not a Python loop over full-dataset solves.
    """
    from dmlp_tpu_torch.golden.fast import knn_golden_fast
    from dmlp_tpu_torch.io.grammar import subset_queries

    fixed_all = knn_golden_fast(subset_queries(inp, suspect_idx))
    for j, qi in enumerate(np.asarray(suspect_idx)):
        fixed = fixed_all[j]
        results[qi] = QueryResult(results[qi].query_id, fixed.k,
                                  fixed.predicted_label, fixed.neighbor_ids,
                                  fixed.neighbor_dists)


def finalize_host(cand_dists: np.ndarray | None, cand_labels: np.ndarray,
                  cand_ids: np.ndarray, ks: np.ndarray,
                  query_attrs: np.ndarray, data_attrs: np.ndarray,
                  exact: bool = True,
                  query_ids: np.ndarray | None = None) -> List[QueryResult]:
    """Candidate lists -> final per-query results.

    Args:
      cand_dists/labels/ids: (Q, K) device candidate lists (selection order).
        ``cand_dists`` may be None when ``exact`` (distances are rescored
        from the float64 originals anyway — engines then skip fetching the
        device distance matrix entirely).
      ks: (Q,) per-query k (K >= ks.max() required).
      query_attrs/data_attrs: float64 originals, used only when ``exact``.
      exact: rescore candidates in float64 and re-select (parity mode).
      query_ids: (Q,) global query ids; defaults to arange (single process).
    """
    q, kcap = cand_ids.shape
    ks = np.asarray(ks, np.int64)
    if q and kcap < ks.max():
        raise ValueError(f"candidate width {kcap} < max k {ks.max()}")
    cand_ids = np.asarray(cand_ids, np.int64)
    cand_labels = np.asarray(cand_labels, np.int64)
    d = rescore_f64(cand_ids, query_attrs, data_attrs) if exact \
        else np.asarray(cand_dists, np.float64)

    # Re-derive the selection order (dist asc, id desc — the measured
    # label-free oracle-binary comparator, golden.reference); after
    # float64 rescoring the device's f32 order may no longer be sorted.
    order = _row_lexsort(d, cand_ids)
    d = np.take_along_axis(d, order, axis=1)
    labels = np.take_along_axis(cand_labels, order, axis=1)
    ids = np.take_along_axis(cand_ids, order, axis=1)

    pos = np.arange(kcap)[None, :]
    in_k = pos < ks[:, None]
    valid = in_k & (ids >= 0)
    predicted = _vote_batch(labels, valid)

    # Report order == selection order under the measured label-free
    # comparator (one (dist asc, id desc) total order governs both): the
    # list is already sorted, and masking the beyond-k tail to (inf, -1)
    # preserves sortedness (the tail is contiguous at the end) — the
    # former second lexsort was an identity permutation (and measured
    # ~9.5 s at the 10240 x 4608 wide-k shape).
    rd = np.where(valid, d, np.inf)
    rids = np.where(valid, ids, -1)

    if query_ids is None:
        query_ids = np.arange(q, dtype=np.int64)
    results: List[QueryResult] = []
    for qi in range(q):
        k = int(ks[qi])
        results.append(QueryResult(int(query_ids[qi]), k, int(predicted[qi]),
                                   rids[qi, :k].copy(), rd[qi, :k].copy()))
    return results
