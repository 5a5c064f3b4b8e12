"""Result reporting — both output modes of the reference harness.

Reference common.cpp:57-79:

- release mode: one line per query, ``Query <id> checksum: <c>`` on stdout;
- ``-DDEBUG`` mode (Makefile:14-15, mirrored by benchmarks/bench.debug):
  ``Label for Query <id> : <label>``, ``Top-<k> neighbors:``, then one
  ``<id> : <dist>`` line per neighbor.

stdout is the results channel, stderr the metrics channel (``Time taken:``,
common.cpp:130); :mod:`dmlp_tpu_torch.utils.timing` owns the stderr side.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from dmlp_tpu_torch.io.checksum import fnv1a_checksum


@dataclasses.dataclass
class QueryResult:
    """Final result for one query, in report order.

    ``neighbor_ids``/``neighbor_dists`` are length-k, sorted by
    (distance asc, tie -> larger id) per engine.cpp:334-338, padded with the
    id = -1 sentinel (common.cpp:66) when fewer than k candidates exist.
    """

    query_id: int
    k: int
    predicted_label: int
    neighbor_ids: np.ndarray
    neighbor_dists: np.ndarray

    def checksum(self) -> int:
        return fnv1a_checksum(self.predicted_label, self.neighbor_ids)


def _format_double(v: float) -> str:
    # C++ `std::cout << double` default formatting: 6 significant digits,
    # fixed/scientific whichever is shorter — i.e. printf %g.
    return "%g" % v


def format_results(results: Sequence[QueryResult], debug: bool = False) -> str:
    """Render the stdout channel for a batch of query results."""
    out: List[str] = []
    if not debug:
        for r in results:
            out.append(f"Query {r.query_id} checksum: {r.checksum()}")
    else:
        for r in results:
            out.append(f"Label for Query {r.query_id} : {r.predicted_label}")
            out.append(f"Top-{r.k} neighbors:")
            for nid, nd in zip(r.neighbor_ids, r.neighbor_dists):
                out.append(f"{int(nid)} : {_format_double(float(nd))}")
    return "\n".join(out) + ("\n" if out else "")
