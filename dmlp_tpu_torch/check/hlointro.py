"""R10 — the collective-record reconcile contract.

R1's traffic rules (R103/R104) make every byte-moving collective in
``engine/``, ``parallel/``, ``train/`` carry a ``# check:
comms-model=<fn>`` annotation naming its analytic model in
``obs/comms.py``. ``obs/hlo.py`` holds those models against the
collectives a run actually issued — but only for models its
``MODEL_COLLECTIVE_KINDS`` table maps to a collective kind. An
annotation naming a model the table lacks passes R104 (the function
exists) yet reconciles NOTHING: the model-vs-record comparison silently
skips the site.

- **R1001**: every ``comms-model=`` annotation in the traffic scope
  must name a key of ``obs/hlo.py``'s ``MODEL_COLLECTIVE_KINDS`` that
  is still a function of ``obs/comms.py`` (a key whose model was
  renamed away maps nothing). When a model is genuinely
  un-reconcilable, map it in the table or waive the site with ``#
  check: allow-hlo-model``.

The table keys ride the package facts like the R104 comms-model set
(this package's own ``obs/hlo.py`` stands in for fixture runs that lack
one, folded into the merged digest); when the table is unknown the rule
stays silent rather than flagging everything.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from dmlp_tpu_torch.check.collectives import in_scope
from dmlp_tpu_torch.check.common import ModuleInfo
from dmlp_tpu_torch.check.findings import Finding

ALLOW = "allow-hlo-model"
_PREFIX = "comms-model="


def _stmt_at(mod: ModuleInfo, line: int) -> Optional[ast.stmt]:
    """The innermost statement whose span covers ``line`` (None for an
    annotation with no code under it)."""
    best: Optional[ast.stmt] = None
    best_span = None
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.stmt):
            continue
        lo = getattr(node, "lineno", 0)
        hi = getattr(node, "end_lineno", 0) or lo
        if not (lo <= line <= hi):
            continue
        span = hi - lo
        if best_span is None or span <= best_span:
            best, best_span = node, span
    return best


class HloIntroRule:
    """One instance runs over the whole package; the reconcile table
    comes from the merged facts."""

    def __init__(self, facts):
        self.hlo_models = facts.hlo_models   # None = unknown: silent

    def run(self, mod: ModuleInfo, add) -> None:
        if self.hlo_models is None or not in_scope(mod.relpath):
            return
        for line in sorted(mod.directives):
            models: List[str] = []
            for d in sorted(mod.directives[line]):
                if d.startswith(_PREFIX):
                    models.extend(x for x in d[len(_PREFIX):].split(",")
                                  if x)
            for m in models:
                if m in self.hlo_models:
                    continue
                stmt = _stmt_at(mod, line)
                if stmt is not None \
                        and mod.allowed_value(stmt, ALLOW, "R1001"):
                    continue
                add(Finding(
                    "R1001", mod.relpath, line, 0,
                    mod.scope_of(stmt) if stmt is not None else "",
                    f"comms-model:{m}",
                    f"comms-model annotation names {m!r}, which "
                    f"obs/hlo.py's MODEL_COLLECTIVE_KINDS does not map to "
                    f"a collective kind of a live obs/comms.py model — the "
                    f"model-vs-record reconcile silently skips this site "
                    f"(map it or annotate `# check: allow-hlo-model`)"))
