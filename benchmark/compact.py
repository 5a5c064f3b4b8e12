"""Judging answers against a corpus too large to hold in one place: the
rows the answers name, gathered into a compact table.

``judge.batch_answer_err`` reads the exact distances and the labels of the
ids an answer names from the corpus it is given. Over a corpus held on
several cards, the caller gathers just those rows (``wanted_ids``, then
the rows drawn again from their seeds) and hands the judge a compact table
with every id remapped to its row there. What the remap cannot carry is
checked here first, on the global ids: an answer with an id outside the
corpus or a repeated id is wrong outright, as the judge reads it on the
full table, and goes to the judge as a missing answer, which it reads
the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from benchmark import judge


def _global_ids(answer: Any, n: int, k: int) -> Optional[np.ndarray]:
    """An answer's ids as int64, or None where they are wrong outright:
    not k of them, one outside [0, n), or one repeated."""
    if answer is None:
        return None
    ids = np.asarray(answer.neighbor_ids, np.int64)
    if ids.shape != (k,) or (ids < 0).any() or (ids >= n).any() \
            or np.unique(ids).size != k:
        return None
    return ids


def wanted_ids(solves: Sequence[Sequence[Any]], n: int,
               k: int) -> np.ndarray:
    """The sorted distinct ids of every answer of ``solves`` (lists of
    answers) that is not wrong outright."""
    found = [ids for res in solves for a in res
             if (ids := _global_ids(a, n, k)) is not None]
    if not found:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(found))


def compact_answer_err(results: Sequence[Any], queries, ids: np.ndarray,
                       rows, labels, n: int, k: int, num_labels: int,
                       ref_dists) -> Dict[str, float]:
    """``judge.batch_answer_err`` of one solve's answers over a compact
    table: ``ids`` (m,) sorted global ids, ``rows`` (m, A) float64 and
    ``labels`` (m,) their rows and labels, tensors on the device of
    ``queries``; ``n`` is the whole corpus's row count."""
    remapped = []
    for a in results:
        gi = _global_ids(a, n, k)
        pos = None if gi is None else np.searchsorted(ids, gi)
        if pos is None or (pos >= ids.size).any() \
                or (ids[np.minimum(pos, ids.size - 1)] != gi).any():
            remapped.append(None)
            continue
        remapped.append(judge.Answer(pos, a.neighbor_dists,
                                     a.predicted_label))
    return judge.batch_answer_err(remapped, queries, rows, labels, k,
                                  num_labels, ref_dists)
