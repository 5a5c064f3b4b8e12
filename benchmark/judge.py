"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/knn.py``), run once the window
has closed.

Batch solves (``answer_err``). Each answer is a query's k neighbour ids in
report order, their distances and a vote label. The program works in
float32, so an answer is judged by how far it lies from the exact one:

- ``rank_gap``: the j-th returned neighbour's exact float64 distance over
  the reference's j-th smallest, less 1 (the worst j);
- ``dist_err``: a returned distance's relative error against the exact
  distance of the id it names;
- an answer with a missing row, an id outside the corpus, a repeated id,
  or a label other than the vote over its own ids' labels is wrong
  outright and reads 1.

``answer_err`` is the largest of these over every judged answer.

Served requests (``wrong``). The serving path is exact, so each
response's label and checksum must equal the reference's; ``wrong``
counts the responses that differ and the requests never answered.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import knn as ref


@dataclasses.dataclass
class Answer:
    """One query's answer, as the program's ``QueryResult`` carries it."""

    neighbor_ids: np.ndarray
    neighbor_dists: np.ndarray
    predicted_label: int


def answers(ids: np.ndarray, dists: np.ndarray, pred: np.ndarray
            ) -> List[Answer]:
    """Answers from (Q, k) arrays: how a control that stands in for the
    program hands its results to the judge."""
    return [Answer(ids[i], dists[i], int(pred[i])) for i in range(len(pred))]


def batch_answer_err(results: Sequence[Any], queries: torch.Tensor,
                     data: torch.Tensor, labels: torch.Tensor, k: int,
                     num_labels: int, ref_dists: torch.Tensor
                     ) -> Dict[str, float]:
    """Judge one solve's answers (a sequence of objects with
    ``neighbor_ids``, ``neighbor_dists`` and ``predicted_label``, or None,
    one per query) against the reference's distances ``ref_dists`` (Q, k).
    Tensors live on one device; returns the numbers as floats."""
    q = queries.shape[0]
    ids = np.full((q, k), -1, np.int64)
    rd = np.full((q, k), np.nan, np.float64)
    pred = np.full(q, -2, np.int64)
    shape_bad = np.zeros(q, bool)
    if len(results) != q:
        shape_bad[:] = True
    for i, r in enumerate(results[:q]):
        if r is None:
            shape_bad[i] = True
            continue
        ri = np.asarray(r.neighbor_ids, np.int64)
        rdi = np.asarray(r.neighbor_dists, np.float64)
        if ri.shape != (k,) or rdi.shape != (k,):
            shape_bad[i] = True
            continue
        ids[i], rd[i], pred[i] = ri, rdi, int(r.predicted_label)
    dev = queries.device
    t_ids = torch.from_numpy(ids).to(dev)
    n = data.shape[0]
    srt = torch.sort(t_ids, 1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    invalid = ((t_ids < 0) | (t_ids >= n)).any(1) | dup
    invalid |= torch.from_numpy(shape_bad).to(dev)
    exact = ref.exact_dists(queries, data, t_ids)
    floor = torch.clamp_min(ref_dists, torch.finfo(torch.float64).tiny)
    gap = ((exact - ref_dists) / floor).max(1).values
    t_rd = torch.from_numpy(rd).to(dev)
    err = ((t_rd - exact).abs() / torch.clamp_min(
        exact, torch.finfo(torch.float64).tiny)).max(1).values
    voted = ref.vote(labels, t_ids, num_labels)
    vote_bad = voted != torch.from_numpy(pred).to(dev)
    outright = invalid | vote_bad | torch.isnan(err) | torch.isnan(gap)
    per = torch.where(outright, 1.0,
                      torch.clamp(torch.maximum(gap, err), 0.0, 1.0))
    ok = ~outright
    return {
        "answer_err": float(per.max()) if q else 0.0,
        "rank_gap": float(gap[ok].max()) if bool(ok.any()) else 1.0,
        "dist_err": float(err[ok].max()) if bool(ok.any()) else 1.0,
        "invalid_answers": int(invalid.sum()),
        "vote_mismatches": int((vote_bad & ~invalid).sum()),
        "answers": int(q),
    }


def serve_wrong(responses: List[Optional[Dict[str, Any]]],
                ref_labels: np.ndarray, ref_checksums: np.ndarray
                ) -> Dict[str, int]:
    """Judge served responses, one per request in due order (None for a
    request never answered; ``ok: false`` for a refused one, which is
    counted as failed and not judged), each of one query."""
    wrong = unanswered = refused = judged = 0
    for i, r in enumerate(responses):
        if r is None:
            unanswered += 1
            continue
        if not r.get("ok"):
            refused += 1
            continue
        judged += 1
        labels, sums = r.get("labels"), r.get("checksums")
        if (not isinstance(labels, list) or not isinstance(sums, list)
                or len(labels) != 1 or len(sums) != 1
                or int(labels[0]) != int(ref_labels[i])
                or int(sums[0]) != int(ref_checksums[i])):
            wrong += 1
    return {"wrong": wrong + unanswered, "unanswered": unanswered,
            "refused": refused, "judged": judged}
