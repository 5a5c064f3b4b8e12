"""Pure-NumPy golden KNN model — the portable differential-testing oracle.

The reference verifies engines against four stripped x86/MPI oracle binaries
(benchmarks/bench_1..4, survey §4). Build round 5 ran those binaries in this
container (isolated-singleton Open MPI; tools/capture_oracle.sh) and MEASURED
their semantics on tie-adversarial inputs, so this oracle implements the
binaries' observed contract, not the author engine.cpp's:

- squared Euclidean distance, float64, difference form (engine.cpp:12-18);
- k-selection comparator: distance asc, tie -> **larger id** first —
  LABEL-FREE. The author's engine.cpp breaks selection ties by larger label
  (engine.cpp:251-254), but the actual oracle binaries bench_1/2/3 match
  the label-free order exactly on 300/300 tie-adversarial fuzz cases
  (TIE_SEMANTICS_r05.json), while the label-aware order mismatched 18% of
  cases in the discovery census; bench_4 disagrees with its own siblings
  on ties — id-ASC report order — so the majority semantics is the
  contract;
- majority vote over the selected k with tie -> **larger label**
  (engine.cpp:326-332; confirmed on the binaries with crafted vote-tie
  inputs);
- report order: distance asc, tie -> **larger id** first (engine.cpp:334-338;
  identical to the selection order — one comparator governs both);
- pad with the id = -1 sentinel when fewer than k candidates exist
  (common.cpp:66); padded entries carry dist = +inf and do not vote.

On tie-free inputs — every graded benchmark input; continuous draws tie with
probability ~0 — the label-free and label-aware orders coincide, which is
why all 21,000 captured benchmark checksums match either way
(oracle_capture/ORACLE_GOLDEN.json). Known defects of the author's engine
are deliberately not inherited (survey §7 quirks Q1-Q3: wrong merge offsets
for heterogeneous k, zero-padding of short shards, duplicated report loop).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from dmlp_tpu_torch.io.grammar import KNNInput, parse_input_text
from dmlp_tpu_torch.io.report import QueryResult, format_results


def _select_order(dists: np.ndarray, labels: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Indices sorting by the selection total order (dist asc, id desc).

    Labels play no role in selection — measured, not assumed: build round
    5 ran the actual oracle binaries (isolated-singleton Open MPI) on
    tie-adversarial inputs and bench_1/2/3 match this label-free order
    exactly (0/300 mismatches; TIE_SEMANTICS_r05.json), while the
    author's engine.cpp label-aware comparator (engine.cpp:251-254)
    mismatched 18% in the discovery census. (bench_4 orders report ties
    id-ASC — inconsistent with its own siblings; see the artifact.)
    ``labels`` stays in the signature for call-site symmetry."""
    del labels
    return np.lexsort((-ids, dists))


def vote(labels: np.ndarray) -> int:
    """Majority vote with tie -> larger label (engine.cpp:320-332).

    Returns -1 for an empty candidate set (the C++ ``predicted_label``
    initializer at engine.cpp:326).
    """
    if labels.size == 0:
        return -1
    uniq, counts = np.unique(labels, return_counts=True)
    best = counts.max()
    return int(uniq[counts == best].max())


def finalize_query(drow: np.ndarray, labels: np.ndarray, ids: np.ndarray,
                   k: int, qi: int) -> QueryResult:
    """Candidate distances for one query -> its final QueryResult.

    THE definition of the output contract, shared by the strict and fast
    oracles: select by (dist asc, id desc), vote (tie -> larger
    label), report order (dist asc, id desc), pad to k with the id = -1 /
    dist = +inf sentinel (common.cpp:66). ``drow``/``labels``/``ids`` may be
    the full dataset row or any candidate subset that contains the true
    top-k.
    """
    order = _select_order(drow, labels, ids)[: min(k, drow.shape[0])]
    sel_d, sel_l, sel_i = drow[order], labels[order], ids[order]
    predicted = vote(sel_l)
    # Selection order IS the report order under the measured label-free
    # comparator (one (dist asc, id desc) total order governs both) —
    # no second sort.
    out_ids, out_dists = sel_i, sel_d
    if out_ids.size < k:
        pad = k - out_ids.size
        out_ids = np.concatenate([out_ids, np.full(pad, -1, np.int64)])
        out_dists = np.concatenate([out_dists, np.full(pad, np.inf)])
    return QueryResult(qi, k, predicted, out_ids.astype(np.int64),
                       out_dists.astype(np.float64))


def knn_golden(inp: KNNInput, dtype=np.float64,
               query_block: int = 256) -> List[QueryResult]:
    """Solve a problem instance exactly; returns per-query results in id order.

    ``dtype`` controls the distance arithmetic (float64 = reference parity;
    float32 mirrors the on-device engines for like-for-like differential
    tests). Queries are processed in blocks so the (Q, N) distance matrix is
    never fully materialized.
    """
    nd = inp.params.num_data
    nq = inp.params.num_queries
    data = inp.data_attrs.astype(dtype)
    queries = inp.query_attrs.astype(dtype)
    labels = inp.labels.astype(np.int64)
    ids = np.arange(nd, dtype=np.int64)

    results: List[QueryResult] = []
    data_block = 8192  # bounds the (qb, nb, A) diff tensor
    for q0 in range(0, nq, query_block):
        q1 = min(q0 + query_block, nq)
        # Difference form, like computeDistance (engine.cpp:12-18) — exact in
        # the working dtype, unlike the norm+matmul form the device uses.
        # Blocked over data too so the diff tensor stays bounded.
        dists = np.empty((q1 - q0, nd), dtype)
        for n0 in range(0, nd, data_block):
            n1 = min(n0 + data_block, nd)
            diff = queries[q0:q1, None, :] - data[None, n0:n1, :]
            dists[:, n0:n1] = np.einsum("qna,qna->qn", diff, diff)
        for qi in range(q0, q1):
            results.append(finalize_query(dists[qi - q0], labels, ids,
                                          int(inp.ks[qi]), qi))
    return results


def solve_text(text: str, dtype=np.float64, debug: bool = False,
               inp: Optional[KNNInput] = None) -> str:
    """End-to-end oracle: input grammar text -> stdout channel text."""
    if inp is None:
        inp = parse_input_text(text)
    return format_results(knn_golden(inp, dtype=dtype), debug=debug)
