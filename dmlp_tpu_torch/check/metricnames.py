"""R6 — metric-name contract for the telemetry registry.

The telemetry registry (obs.telemetry) is get-or-create by name: any
call site can "declare" a metric, so two failure modes are one typo
away — a DYNAMIC name (f-string, concatenation, variable) silently
forks a metric family per interpolation (unbounded cardinality, and the
scrape's series names become unpredictable), and the SAME literal name
registered under two different kinds corrupts both users (the registry
raises at runtime, but only on the execution path that collides). Both
are statically decidable, so they fail the checker instead:

- **R601** — a ``registry.counter/gauge/histogram(...)`` name argument
  that is not a literal snake_case dotted string
  (``telemetry.NAME_RE``: ``span.latency_ms``, ``mem.device
  .bytes_in_use``). The one deliberate dynamic-registration seam (the
  span-name bridge in obs.telemetry) carries the explicit
  ``# check: allow-metric-name`` annotation.
- **R602** — one literal name registered with conflicting kinds across
  the package (counter vs gauge vs histogram); flagged at every site
  disagreeing with the first (path, line)-ordered registration.

Scope: any call ``<recv>.counter|gauge|histogram(...)`` whose receiver
is a registry — a name ending in ``registry``/``REGISTRY`` or a call of
``telemetry.registry()``. Labels stay dynamic on purpose: bounded
cardinality is the label's job, the NAME is the contract.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from dmlp_tpu_torch.check.common import ModuleInfo, call_name, dotted
from dmlp_tpu_torch.check.findings import Finding

ALLOW = "allow-metric-name"

_REG_METHODS = ("counter", "gauge", "histogram")

# Mirrors dmlp_tpu_torch.obs.telemetry.NAME_RE without importing it (the
# checker must analyze a tree whose package may not import cleanly;
# tests/test_torch_check.py holds the two equal).
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)*$")


def _is_registry_recv(node: ast.AST) -> bool:
    """Does this expression denote the telemetry registry? Covers the
    module global (``REGISTRY``), locals/attributes named ``registry``,
    and the accessor call ``telemetry.registry()``."""
    name = dotted(node)
    if name and name.split(".")[-1].lower() == "registry":
        return True
    if isinstance(node, ast.Call):
        cn = call_name(node)
        return bool(cn and cn.split(".")[-1] == "registry")
    return False


def _registration_sites(mod: ModuleInfo
                        ) -> List[Tuple[ast.Call, str, object]]:
    """(call node, kind, name arg | None) for every registry
    registration call in one module."""
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _REG_METHODS:
            continue
        if not _is_registry_recv(node.func.value):
            continue
        arg = node.args[0] if node.args else None
        out.append((node, node.func.attr, arg))
    return out


def registration_facts(mod: ModuleInfo) -> List[List[str]]:
    """Cacheable per-file facts: ``[name, kind]`` in document order
    for every literal registration (the cross-module R602 input). No
    line numbers — facts must survive pure line shifts so one comment
    edit does not invalidate every file's cached verdict."""
    out = []
    for node, kind, arg in _registration_sites(mod):
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append([arg.value, kind])
    return out


class MetricNameRule:
    """Cross-module rule: the package-wide first-registration table
    (PackageFacts.metric_first) lets R602 see kind conflicts across
    files."""

    def __init__(self, facts):
        # literal name -> (kind, relpath) of its FIRST
        # (path, document-order)-ranked registration
        self._first: Dict[str, Tuple[str, str]] = facts.metric_first

    def run(self, mod: ModuleInfo, add) -> None:
        for node, kind, arg in _registration_sites(mod):
            literal = (arg.value
                       if isinstance(arg, ast.Constant)
                       and isinstance(arg.value, str) else None)
            if literal is None or not _NAME_RE.match(literal):
                if mod.allowed(node, ALLOW):
                    continue
                what = ("dynamic (non-literal)" if literal is None
                        else f"non-snake-case {literal!r}")
                add(Finding(
                    "R601", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), f"{kind}:{what}",
                    f"registry.{kind}(...) metric name must be a "
                    f"literal snake_case dotted string — {what} names "
                    "fork unbounded series / unpredictable scrape "
                    "names (use a label for the dynamic part, or "
                    "annotate `# check: allow-metric-name` for a "
                    "deliberate seam)"))
                continue
            first = self._first.get(literal)
            if first is not None and first[0] != kind:
                add(Finding(
                    "R602", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), f"{literal}:{kind}vs{first[0]}",
                    f"metric {literal!r} registered here as {kind} but "
                    f"as {first[0]} in {first[1]} — one "
                    "name, one kind (the registry raises at runtime "
                    "only on the colliding path)"))
