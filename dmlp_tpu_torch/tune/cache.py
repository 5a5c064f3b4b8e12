"""Persisted variant cache of the port's launch knobs.

Port of ``dmlp_tpu/tune/cache.py``. One small versioned JSON file maps
(kernel, device kind, shape buckets, kc, dtype, precision) to the fastest
measured variant. The sweep (``python -m dmlp_tpu_torch.tune``,
:mod:`dmlp_tpu_torch.tune.sweep`) writes it; the launch paths read it
through :func:`lookup_variant`:

- ``ops.extract.resolve_splits`` — S, the data-axis split of K1/K2, under
  the ``fused_topk`` (gate on) and ``extract_topk`` (gate off) namespaces;
- ``ops.dist_segmin.resolve_group`` — G, the segments one K3 CTA walks,
  under ``fused_dist_segmin``;
- ``ops.summaries.resolve_score_variant`` — the host prune scoring's block
  chunk, under ``prune_score``.

The reference's design rules hold:

- **An absent cache means today's behaviour.** With no file the lookup
  returns None and touches no CUDA API: the device's name is read only
  once a file with entries exists (``torch.cuda.get_device_name``
  initialises CUDA).
- **Keys are buckets.** Row counts bucket to the next power of two; kc
  keys directly. A corrupt entry misses only itself.
- **A hit never disables a kernel.** The callers re-validate a hit against
  the concrete launch (``ops.extract.check_splits``, G within 1..nseg) and
  fall through to the heuristic on a misfit.
- :func:`suppressed` turns lookups off (the degradation ladder's
  ``heuristic`` rung); :func:`clear_lookup_memo` drops the per-process
  memo; :meth:`VariantCache.validate_doc` is the strict whole-file check.

What differs from the reference:

- the device kind is ``torch.cuda.get_device_name()`` for a CUDA device
  and ``"cpu"`` for the CPU, where the same knobs drive the plain
  versions;
- the variants are the port's knobs — ``{"splits": S}``, ``{"group": G}``
  and ``{"tile_q": chunk}`` — not the Pallas tile space;
- the key carries a bucket of qb (the query rows of the launch) beside b,
  a, kc, dtype and precision, because both S and G depend on the number
  of query tiles;
- the envelope is the port's own family at schema 1, so neither package
  loads the other's file. The file is ``$DMLP_TPU_TUNE_CACHE``, else
  ``~/.cache/dmlp_tpu_torch/variants.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

CACHE_SCHEMA = 1
#: the envelope's family: the reference's files say "pallas_topk"
FAMILY = "dmlp_tpu_torch_variants"
#: kernel namespace -> the one knob its variants carry
KNOBS = {"fused_topk": "splits", "extract_topk": "splits",
         "fused_dist_segmin": "group", "prune_score": "tile_q"}
PRECISIONS = ("f32", "bf16")


def cache_path() -> str:
    """``$DMLP_TPU_TUNE_CACHE``, else ``~/.cache/dmlp_tpu_torch/
    variants.json``."""
    env = os.environ.get("DMLP_TPU_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "dmlp_tpu_torch",
                        "variants.json")


def shape_bucket(n: int) -> int:
    """The smallest power of two >= n (1 for n <= 1)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def make_key(kernel: str, device_kind: str, *, qb: int, b: int, a: int,
             kc: int, dtype: str, precision: str) -> str:
    return (f"{kernel}|{device_kind}|q{shape_bucket(qb)}|b{shape_bucket(b)}"
            f"|a{shape_bucket(a)}|kc{int(kc)}|{dtype}|{precision}")


def validate_variant(kernel: str, v: Any) -> bool:
    """Structural sanity of one variant: exactly the namespace's knob, a
    positive int (not a bool)."""
    knob = KNOBS.get(kernel)
    return (knob is not None and isinstance(v, dict) and set(v) == {knob}
            and isinstance(v[knob], int) and not isinstance(v[knob], bool)
            and v[knob] >= 1)


class VariantCache:
    """The in-memory form of the cache file; save() and load() round-trip
    it."""

    def __init__(self, entries: Optional[Dict[str, Dict]] = None,
                 created_unix: Optional[float] = None):
        self.entries: Dict[str, Dict] = dict(entries or {})
        self.created_unix = (time.time() if created_unix is None
                             else created_unix)

    def put(self, kernel: str, device_kind: str, variant: Dict, *, qb: int,
            b: int, a: int, kc: int, dtype: str = "float32",
            precision: str = "f32", **record) -> str:
        """Record the winning ``variant`` under its key and return the key.
        ``record`` keeps what the sweep measured beside it (measured_ms,
        heuristic_ms, the heuristic's variant, swept, shape). Raises
        ValueError on an invalid variant, namespace or precision: a sweep
        never persists what a launch would have to reject."""
        if not validate_variant(kernel, variant):
            raise ValueError(f"invalid {kernel!r} variant {variant!r}")
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        key = make_key(kernel, device_kind, qb=qb, b=b, a=a, kc=kc,
                       dtype=dtype, precision=precision)
        self.entries[key] = {"variant": dict(variant),
                             "created_unix": time.time(), **record}
        return key

    def get(self, kernel: str, device_kind: str, *, qb: int, b: int, a: int,
            kc: int, dtype: str = "float32",
            precision: str = "f32") -> Optional[Dict]:
        """The cached variant for this key after per-entry validation, or
        None on a miss or a corrupt entry."""
        e = self.entries.get(make_key(kernel, device_kind, qb=qb, b=b, a=a,
                                      kc=kc, dtype=dtype,
                                      precision=precision))
        if not isinstance(e, dict) or not validate_variant(
                kernel, e.get("variant")):
            return None
        return dict(e["variant"])

    def to_dict(self) -> Dict[str, Any]:
        return {"schema": CACHE_SCHEMA, "kernel": FAMILY,
                "created_unix": self.created_unix, "entries": self.entries}

    def save(self, path: Optional[str] = None) -> str:
        path = path or cache_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @staticmethod
    def validate_doc(doc: Any) -> None:
        """Raise ValueError naming the first violation: the envelope (this
        family at schema 1) and every entry (a known namespace, a legal
        precision suffix, a valid variant)."""
        if not isinstance(doc, dict):
            raise ValueError("cache is not a JSON object")
        if doc.get("schema") != CACHE_SCHEMA or doc.get("kernel") != FAMILY:
            raise ValueError(
                f"not a schema-{CACHE_SCHEMA} {FAMILY} cache (schema "
                f"{doc.get('schema')!r}, kernel {doc.get('kernel')!r}); "
                "regenerate with python -m dmlp_tpu_torch.tune")
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            raise ValueError("cache entries block missing or not a dict")
        for key, e in entries.items():
            parts = key.split("|")
            if len(parts) != 8 or parts[0] not in KNOBS:
                raise ValueError(f"entry {key!r} has no kernel namespace")
            if parts[-1] not in PRECISIONS:
                raise ValueError(f"entry {key!r} has no precision suffix")
            if not isinstance(e, dict) or not validate_variant(
                    parts[0], e.get("variant")):
                raise ValueError(f"entry {key!r} carries an invalid "
                                 f"variant: {e!r}")

    @classmethod
    def load(cls, path: Optional[str] = None) -> "VariantCache":
        """Load with envelope validation only: raises on an unreadable
        file or another family's (the reference's included); a corrupt
        entry is left to miss at get()."""
        path = path or cache_path()
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("schema") != CACHE_SCHEMA \
                or doc.get("kernel") != FAMILY \
                or not isinstance(doc.get("entries"), dict):
            raise ValueError(f"{path}: not a schema-{CACHE_SCHEMA} {FAMILY} "
                             "variant cache (regenerate with python -m "
                             "dmlp_tpu_torch.tune)")
        return cls(entries=doc["entries"],
                   created_unix=doc.get("created_unix"))


# -- the launch-path lookup (memoized, never raises) -------------------------
_memo: Dict[str, Optional[VariantCache]] = {}
_kind_memo: Dict[int, str] = {}
_suppress_depth = 0
#: lookups made (not suppressed) and entries they found, since reset_stats
STATS = {"lookups": 0, "hits": 0}


@contextlib.contextmanager
def suppressed():
    """Lookups return None for the duration (the ``heuristic`` rung)."""
    global _suppress_depth
    _suppress_depth += 1
    try:
        yield
    finally:
        _suppress_depth -= 1


def clear_lookup_memo() -> None:
    """Drop the per-process file and device-name memo (after a sweep
    rewrites the file, or in tests)."""
    _memo.clear()
    _kind_memo.clear()


def reset_stats() -> None:
    STATS.update(lookups=0, hits=0)


def dtype_key(t) -> str:
    """The key's dtype for a launch's data tensor ``t``."""
    import torch
    return "bfloat16" if t.dtype == torch.bfloat16 else "float32"


def device_kind(device) -> str:
    """The cache's device kind: ``torch.cuda.get_device_name`` of a CUDA
    device (memoized), ``"cpu"`` otherwise."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _kind_memo:
        _kind_memo[index] = torch.cuda.get_device_name(index)
    return _kind_memo[index]


def _cache_at(path: str) -> Optional[VariantCache]:
    if path not in _memo:
        cache = None
        if os.path.exists(path):
            try:
                cache = VariantCache.load(path)
            except Exception:   # unreadable or foreign: the heuristic
                cache = None
        _memo[path] = cache
    return _memo[path]


def lookup_variant(kernel: str, *, qb: int, b: int, a: int, kc: int,
                   device="cpu", dtype: str = "float32",
                   precision: str = "f32",
                   path: Optional[str] = None) -> Optional[Dict]:
    """The cached variant for one launch on ``device``, or None: when
    suppressed, when the file is absent, unreadable or another family's,
    or when the entry is missing or corrupt. Never raises. The device's
    name is read only when the file holds entries."""
    if _suppress_depth:
        return None
    STATS["lookups"] += 1
    cache = _cache_at(path or cache_path())
    if cache is None or not cache.entries:
        return None
    v = cache.get(kernel, device_kind(device), qb=qb, b=b, a=a, kc=kc,
                  dtype=dtype, precision=precision)
    if v is not None:
        STATS["hits"] += 1
    return v
