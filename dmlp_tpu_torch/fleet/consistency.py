"""The corpus signature — the signature half of
``dmlp_tpu/fleet/consistency.py``.

Every resident engine keeps a rolling corpus checksum: a 64-bit per-row
hash (FNV-1a over the row's float64 attribute bits and its label), times a
position mix (splitmix64 of the global row id), folded by a wrapping
64-bit sum. An ingest of m rows updates it in O(m), and rewriting a row
subtracts its old term and adds the new one, so an idempotent row-write
leaves it unchanged. It is a pure function of (row position, label,
attribute bits), so it equals the reference's for the same rows: the
fleet's prober compares it across replicas. Diagnosis and the wire repair
come with the fleet (ROADMAP A12).
"""

from __future__ import annotations

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
