"""Per-file AST fingerprint cache for the analyzer.

The checker re-runs constantly; almost nothing changes between runs.
This cache keys everything by **content hash** (sha256 of the file
bytes), under ``~/.cache/dmlp_tpu_torch/check/``
(``$DMLP_TPU_CHECK_CACHE`` overrides; ``--no-cache`` bypasses; the JAX
package's checker keeps its own entries under ``~/.cache/dmlp_tpu``).
Two levels, both sound:

- **facts** (:func:`dmlp_tpu_torch.check.facts.module_facts`) are a pure
  function of one file's content → cached per content hash. Unchanged
  files never re-parse.
- **findings** for a file depend on (its content, its repo-relative
  path, the merged package facts, the rule families, the checker's own
  source). The cache key is exactly that tuple — so an edit that
  changes a file's *facts* (a new lock, a renamed comms model)
  invalidates everyone, while a facts-neutral edit (the common case)
  re-analyzes only the edited file.

The checker's own source digest rides in every key: editing a rule
module invalidates the world, so a stale cache can never mask a new
rule. Entries are one JSON file per content hash; corrupt or
foreign-schema entries are treated as misses, never errors.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

CACHE_SCHEMA = 1
CACHE_ENV = "DMLP_TPU_CHECK_CACHE"
#: cap of findings-variant entries kept per file (distinct ctx/family
#: combinations); oldest-insertion beyond it are dropped on save
_MAX_VARIANTS = 8


def cache_dir() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "dmlp_tpu_torch", "check")


_checker_digest_memo: Optional[str] = None


def checker_digest() -> str:
    """Digest of the check package's own sources — rule edits must
    invalidate every cached verdict."""
    global _checker_digest_memo
    if _checker_digest_memo is not None:
        return _checker_digest_memo
    h = hashlib.sha256()
    pkg = os.path.dirname(os.path.abspath(__file__))
    for fn in sorted(os.listdir(pkg)):
        if fn.endswith(".py"):
            with open(os.path.join(pkg, fn), "rb") as f:
                h.update(fn.encode())
                h.update(f.read())
    _checker_digest_memo = h.hexdigest()
    return _checker_digest_memo


def content_sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class CheckCache:
    """One run's view of the on-disk cache. ``enabled=False`` turns
    every operation into a no-op (the ``--no-cache`` path reuses the
    same object shape)."""

    def __init__(self, directory: Optional[str] = None,
                 enabled: bool = True):
        self.dir = directory or cache_dir()
        self.enabled = enabled
        self.hits = 0
        self.misses = 0
        self._loaded: Dict[str, Dict[str, Any]] = {}
        self._dirty: Dict[str, bool] = {}

    # -- entry IO -------------------------------------------------------------
    def _path(self, sha: str) -> str:
        return os.path.join(self.dir, f"{sha}.json")

    def _entry(self, sha: str) -> Dict[str, Any]:
        if sha in self._loaded:
            return self._loaded[sha]
        entry: Dict[str, Any] = {"cache_schema": CACHE_SCHEMA,
                                 "checker": checker_digest(),
                                 "facts": None, "findings": {}}
        if self.enabled:
            try:
                with open(self._path(sha), encoding="utf-8") as f:
                    got = json.load(f)
                if got.get("cache_schema") == CACHE_SCHEMA \
                        and got.get("checker") == checker_digest():
                    entry = got
            except (OSError, ValueError):
                pass                     # corrupt entry == miss
        self._loaded[sha] = entry
        return entry

    def _save(self, sha: str) -> None:
        if not self.enabled or not self._dirty.get(sha):
            return
        entry = self._loaded[sha]
        findings = entry.get("findings", {})
        if len(findings) > _MAX_VARIANTS:
            for key in list(findings)[:len(findings) - _MAX_VARIANTS]:
                del findings[key]
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self._path(sha) + f".tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(entry, f, sort_keys=True)
            os.replace(tmp, self._path(sha))
            self._dirty[sha] = False
        except OSError:
            pass                         # cache is best-effort only

    # -- facts ----------------------------------------------------------------
    def get_facts(self, sha: str) -> Optional[Dict[str, Any]]:
        if not self.enabled:
            return None
        return self._entry(sha).get("facts")

    def put_facts(self, sha: str, facts: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        entry = self._entry(sha)
        if entry.get("facts") != facts:
            entry["facts"] = facts
            self._dirty[sha] = True

    # -- findings -------------------------------------------------------------
    @staticmethod
    def findings_key(relpath: str, ctx_digest: str,
                     families_key: str) -> str:
        return f"{relpath}|{families_key}|{ctx_digest}"

    def get_findings(self, sha: str, key: str
                     ) -> Optional[List[Dict[str, Any]]]:
        if not self.enabled:
            return None
        got = self._entry(sha).get("findings", {}).get(key)
        if got is not None:
            self.hits += 1
        else:
            self.misses += 1
        return got

    def put_findings(self, sha: str, key: str,
                     findings: List[Dict[str, Any]]) -> None:
        if not self.enabled:
            return
        entry = self._entry(sha)
        entry.setdefault("findings", {})[key] = findings
        self._dirty[sha] = True

    def flush(self) -> None:
        for sha in list(self._dirty):
            self._save(sha)
