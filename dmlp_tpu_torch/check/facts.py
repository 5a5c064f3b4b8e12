"""Per-file cross-module facts — the analyzer's cacheable interface.

The cross-module rule families (R6 metric names, R7 concurrency) need
package-wide context. Each file reduces to a small JSON-safe *facts*
dict (:func:`module_facts` — a pure function of that one file's AST),
and :class:`PackageFacts` merges the per-file dicts into the tables the
rules consume. The split is what makes per-file caching sound: a file's
findings depend only on (its own content, the merged facts), so the
cache key is (content hash, facts digest) — see
:mod:`dmlp_tpu_torch.check.cache`.

The JAX package's facts also carry the mesh-axis constants, the comms
models, the kernel-cost table and the eps bounds of its R1, R8 and R10
families; those come with the families that read them.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Tuple

from dmlp_tpu_torch.check.common import ModuleInfo

FACTS_SCHEMA = 1


def module_facts(mod: ModuleInfo) -> Dict[str, Any]:
    """JSON-safe cross-module facts for one file (content-only: no
    paths inside, so a moved file keeps its facts)."""
    from dmlp_tpu_torch.check.concurrency import module_conc_facts
    from dmlp_tpu_torch.check.metricnames import registration_facts
    return {
        "facts_schema": FACTS_SCHEMA,
        "metric_sites": registration_facts(mod),
        "concurrency": module_conc_facts(mod),
    }


class PackageFacts:
    """Merged package-wide context, built from (relpath, facts) pairs."""

    def __init__(self, pairs: List[Tuple[str, Dict[str, Any]]]):
        from dmlp_tpu_torch.check.concurrency import ConcurrencyGraph
        self.pairs = sorted(pairs)
        metric_sites: List[Tuple[str, int, str, str]] = []
        conc_pairs: List[Tuple[str, Dict[str, Any]]] = []
        for rel, facts in self.pairs:
            for seq, (name, kind) in enumerate(
                    facts.get("metric_sites", [])):
                metric_sites.append((rel, seq, name, kind))
            conc_pairs.append((rel, facts.get("concurrency", {})))
        #: literal metric name -> (kind, relpath) of its first
        #: (path, document-order)-ranked registration (the R602
        #: table). No line numbers anywhere in the facts: a pure line
        #: shift in a metric-registering file must not change the
        #: merged digest (and with it invalidate EVERY file's cached
        #: verdict) — same rule the concurrency facts follow.
        self.metric_first: Dict[str, Tuple[str, str]] = {}
        for rel, seq, name, kind in sorted(
                metric_sites, key=lambda s: (s[0], s[1])):
            self.metric_first.setdefault(name, (kind, rel))
        self.concurrency = ConcurrencyGraph(conc_pairs)

    def digest(self) -> str:
        """Stable digest of the merged facts inputs — part of every
        per-file findings cache key (a change to any file's FACTS
        invalidates every file's findings; a facts-neutral edit only
        invalidates the edited file)."""
        blob = json.dumps(self.pairs, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()


def build_package_facts(modules: List[ModuleInfo]) -> PackageFacts:
    """The no-cache path: facts straight from parsed modules."""
    return PackageFacts([(m.relpath, module_facts(m)) for m in modules])
