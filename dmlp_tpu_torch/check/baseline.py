"""Findings baseline: pin accepted pre-existing findings, fail new ones.

The port's baseline, ``dmlp_tpu_torch/check/check_baseline.json``
(:func:`default_path`), stores fingerprints (rule, path, scope, key) —
no line numbers, so baselined findings survive unrelated edits — with
multiplicity. The diff is a multiset comparison:

- a finding whose fingerprint has remaining baseline budget is
  *baselined* (reported, never fails);
- a finding without budget is *new* (fails the checker);
- unspent baseline entries are *stale* (reported so the baseline gets
  pruned as fixes land; never fail).

The ``check_baseline.json`` at the repository root is the JAX package's
and is never written from here. The goal state is an EMPTY baseline — the file exists so adopting the
analyzer never requires fixing the world in one PR, not to let
findings rot.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Tuple

from dmlp_tpu_torch.check.findings import Finding

BASELINE_SCHEMA = 1
DEFAULT_NAME = "check_baseline.json"


def default_path() -> str:
    """The port's committed baseline, beside this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        DEFAULT_NAME)


def load_baseline(path: str) -> Counter:
    """Fingerprint multiset from a baseline file; empty if absent."""
    if not os.path.exists(path):
        return Counter()
    with open(path) as f:
        data = json.load(f)
    if data.get("baseline_schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"{path}: baseline_schema {data.get('baseline_schema')!r} "
            f"!= {BASELINE_SCHEMA}")
    out: Counter = Counter()
    for e in data.get("findings", []):
        fp = (e["rule"], e["path"], e.get("scope", ""), e["key"])
        out[fp] += int(e.get("count", 1))
    return out


def save_baseline(path: str, findings: List[Finding]) -> dict:
    counts: Counter = Counter(f.fingerprint() for f in findings)
    data = {
        "baseline_schema": BASELINE_SCHEMA,
        "findings": [
            {"rule": r, "path": p, "scope": s, "key": k, "count": n}
            for (r, p, s, k), n in sorted(counts.items())
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return data


def diff_baseline(findings: List[Finding], baseline: Counter
                  ) -> Tuple[List[Finding], List[Finding],
                             Dict[Tuple[str, str, str, str], int]]:
    """(new, baselined, stale): findings split against the baseline
    multiset; ``stale`` maps unspent fingerprints to leftover counts."""
    budget = Counter(baseline)
    new: List[Finding] = []
    matched: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if budget[fp] > 0:
            budget[fp] -= 1
            matched.append(f)
        else:
            new.append(f)
    stale = {fp: n for fp, n in budget.items() if n > 0}
    return new, matched, stale
