"""Replica consistency: the corpus signature, divergence diagnosis and
the checksum-driven repair — port of ``dmlp_tpu/fleet/consistency.py``.

- **Corpus signature.** Every resident engine keeps a rolling corpus
  checksum: a 64-bit per-row hash (FNV-1a over the row's float64 attribute
  bits and its label), times a position mix (splitmix64 of the global row
  id), folded by a wrapping 64-bit sum. An ingest of m rows updates it in
  O(m), and rewriting a row subtracts its old term and adds the new one,
  so an idempotent row-write leaves it unchanged. It is a pure function of
  (row position, label, attribute bits): a plain and a mesh-resident
  replica holding the same rows report the same signature, and it equals
  the reference's.
- **Diagnosis** (:func:`diagnose`): from every healthy replica's (rows,
  checksum), the reference is the largest row count (ingest only appends,
  so the replica ahead holds what the others lack), ties broken by the
  most-agreed signature, then by name; the others are divergent.
- **Repair** (:func:`repair_replica`): the lagging replica's missing rows
  ``[t.rows, ref.rows)`` are read from the reference over the wire (the
  daemon's ``corpus`` op) and written into the laggard as ``ingest``
  requests with an explicit ``start``: idempotent row-writes, so a repair
  racing a fan-out converges. Equal rows with different checksums and a
  target ahead of every reference are unrepairable; the router
  quarantines such a replica.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)
_MASK = (1 << 64) - 1


def row_hashes(labels, attrs) -> np.ndarray:
    """Per-row 64-bit FNV-1a over (attribute float64 bits, label),
    position-independent; :func:`fold_terms` adds the position mix."""
    a = np.ascontiguousarray(np.asarray(attrs, np.float64))
    a = a.reshape(len(a), -1).view(np.uint64)
    lab = np.asarray(labels, np.int64).astype(np.uint64)
    h = np.full(len(lab), _FNV_OFFSET, np.uint64)
    for j in range(a.shape[1]):
        h = (h ^ a[:, j]) * _FNV_PRIME
    return (h ^ lab) * _FNV_PRIME


def _position_mix(start: int, count: int) -> np.ndarray:
    """splitmix64 finalizer over global row ids ``[start, start+count)``,
    so swapped rows change the fold."""
    z = (np.arange(start, start + count, dtype=np.uint64)
         + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def fold_terms(start: int, hashes: np.ndarray) -> int:
    """The rows' contribution to the corpus fold: the wrapping 64-bit sum
    of ``hash * mix(position)``."""
    if len(hashes) == 0:
        return 0
    terms = np.asarray(hashes, np.uint64) * _position_mix(start,
                                                          len(hashes))
    return int(np.sum(terms, dtype=np.uint64))


def fold_replace(fold: int, start: int, old_hashes: np.ndarray,
                 new_hashes: np.ndarray) -> int:
    """The fold after rows ``[start, start+m)`` change from
    ``old_hashes`` to ``new_hashes`` (an idempotent overwrite is exactly a
    no-op)."""
    return (fold - fold_terms(start, old_hashes)
            + fold_terms(start, new_hashes)) & _MASK


def corpus_fold(labels, attrs) -> int:
    """The signature of a whole corpus, computed from scratch."""
    return fold_terms(0, row_hashes(labels, attrs))


# -- diagnosis ----------------------------------------------------------------

def diagnose(sigs: List[Tuple[str, Dict[str, Any]]]
             ) -> Optional[Dict[str, Any]]:
    """``sigs`` is ``[(replica_name, {"rows", "checksum"}), ...]`` for
    every healthy replica. None when all agree, else ``{"reference",
    "rows", "checksum", "divergent": [names]}``: the reference has the most
    rows, then the most replicas agreeing with it, then the first name."""
    groups: Dict[Tuple[int, int], List[str]] = {}
    for name, sig in sigs:
        key = (int(sig["rows"]), int(sig["checksum"]))
        groups.setdefault(key, []).append(name)
    if len(groups) <= 1:
        return None
    ref_key = max(groups,
                  key=lambda k: (k[0], len(groups[k]),
                                 sorted(groups[k])[0]))
    divergent = [n for k, names in groups.items() if k != ref_key
                 for n in names]
    return {"reference": sorted(groups[ref_key])[0],
            "rows": ref_key[0], "checksum": ref_key[1],
            "divergent": sorted(divergent)}


# -- wire helpers (the daemon protocol, replica side) -------------------------

def _call(rep, obj: Dict[str, Any], timeout_s: float = 60.0
          ) -> Optional[Dict[str, Any]]:
    """One control-plane request to a replica (``probe=True``: repair
    traffic is not client traffic); None on a transport or JSON failure."""
    from dmlp_tpu_torch.serve.protocol import encode
    try:
        return json.loads(rep.call(encode(obj), timeout_s=timeout_s,
                                   probe=True))
    except (OSError, ValueError):
        return None


def corpus_state_via_wire(rep) -> Optional[Dict[str, int]]:
    """A replica's live (rows, checksum, epoch) through the ``corpus`` op
    with ``count=0``."""
    doc = _call(rep, {"op": "corpus", "start": 0, "count": 0})
    if not doc or not doc.get("ok"):
        return None
    return {"rows": int(doc["corpus_rows"]),
            "checksum": int(doc["checksum"]),
            "epoch": int(doc.get("epoch", 0))}


def repair_replica(ref, target, fetch_rows: int = 2048,
                   max_rounds: int = 8) -> Dict[str, Any]:
    """Re-ingest the delta from ``ref`` into ``target`` until their corpus
    signatures match. Returns ``{"repaired": bool, "replayed_rows",
    "rounds", "reason"?}`` and never raises: a transport failure reports
    as unrepaired (the caller escalates)."""
    # The server clamps corpus reads at the protocol's CORPUS_FETCH_MAX;
    # the paging here uses the same definition.
    from dmlp_tpu_torch.serve.protocol import CORPUS_FETCH_MAX
    fetch_rows = min(int(fetch_rows), CORPUS_FETCH_MAX)
    replayed = 0
    rounds = 0
    for _round in range(max(max_rounds, 1)):
        s = corpus_state_via_wire(ref)
        t = corpus_state_via_wire(target)
        if s is None or t is None:
            return {"repaired": False, "replayed_rows": replayed,
                    "rounds": rounds,
                    "reason": "replica unreachable during repair"}
        if t["rows"] == s["rows"]:
            if t["checksum"] == s["checksum"]:
                return {"repaired": True, "replayed_rows": replayed,
                        "rounds": rounds}
            return {"repaired": False, "replayed_rows": replayed,
                    "rounds": rounds,
                    "reason": "checksum mismatch at equal row counts "
                              "(content divergence — delta unknown)"}
        if t["rows"] > s["rows"]:
            return {"repaired": False, "replayed_rows": replayed,
                    "rounds": rounds,
                    "reason": "target ahead of reference"}
        rounds += 1
        at = t["rows"]
        while at < s["rows"]:
            doc = _call(ref, {"op": "corpus", "start": at,
                              "count": min(fetch_rows, s["rows"] - at)})
            if not doc or not doc.get("ok") or not doc.get("rows"):
                break     # the source moved or is gone: re-diagnose
            push = _call(target, {"op": "ingest",
                                  "labels": doc["labels"],
                                  "rows": doc["rows"], "start": at})
            if not push or not push.get("ok"):
                return {"repaired": False, "replayed_rows": replayed,
                        "rounds": rounds,
                        "reason": "delta re-ingest rejected: "
                                  f"{(push or {}).get('error')}"}
            m = len(doc["rows"])
            at += m
            replayed += m
    return {"repaired": False, "replayed_rows": replayed,
            "rounds": rounds,
            "reason": f"no convergence after {max_rounds} rounds "
                      "(ingest outrunning repair?)"}
