"""R5 — silent-swallow hazards in resilience-wrapped paths.

The resilience layer's whole contract is that recovery is *visible*:
every retry, degradation, and rollback is counted and traced. A bare
``except Exception`` handler that neither re-raises nor carries the
explicit ``# check: no-retry`` annotation defeats that contract — it
can eat an :class:`InjectedTransientError` or a real RESOURCE_EXHAUSTED
before the retry/ladder machinery ever classifies it, turning a
recoverable fault into a silently wrong or silently degraded run.

Scope: modules inside ``dmlp_tpu_torch/resilience/``,
``dmlp_tpu_torch/serve/``, and ``dmlp_tpu_torch/fleet/``
(the serving daemon's per-request error paths swallow by design and
must say so), plus any module that imports
``dmlp_tpu_torch.resilience``
(i.e. paths actually wrapped by the layer). A handler is compliant
when it catches something narrower than
``Exception``/``BaseException``, re-raises (any ``raise`` in its body),
or is annotated ``# check: no-retry`` — the annotation documents "this
swallow is deliberate and out of the retry path" (observability
best-effort blocks, already-killed-process cleanup).

- **R501** broad ``except Exception`` handler in a resilience-wrapped
  module without a re-raise or a ``# check: no-retry`` annotation.
"""

from __future__ import annotations

import ast

from dmlp_tpu_torch.check.common import ModuleInfo
from dmlp_tpu_torch.check.findings import Finding

ALLOW = "no-retry"

_BROAD = ("Exception", "BaseException")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    """Catches Exception/BaseException (bare ``except:`` is R002's)."""
    t = handler.type
    if t is None:
        return False
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for node in types:
        name = node.id if isinstance(node, ast.Name) else (
            node.attr if isinstance(node, ast.Attribute) else None)
        if name in _BROAD:
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    """Any ``raise`` in the handler body (bare or transforming) means
    the error is propagated, not swallowed. A ``raise`` inside a
    function merely *defined* in the handler does not count — defining
    a raiser is not raising."""
    stack: list = list(handler.body)
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


def in_resilient_scope(mod: ModuleInfo) -> bool:
    rel = mod.relpath.replace("\\", "/")
    if rel.startswith(("dmlp_tpu_torch/resilience/",
                       "dmlp_tpu_torch/serve/", "dmlp_tpu_torch/fleet/")):
        return True
    return any(src.startswith("dmlp_tpu_torch.resilience")
               for src in mod.imports.values())


class ResilientRule:
    def run(self, mod: ModuleInfo, add) -> None:
        if not in_resilient_scope(mod):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node) or _reraises(node):
                continue
            if mod.allowed(node, ALLOW):
                continue
            add(Finding(
                "R501", mod.relpath, node.lineno, node.col_offset,
                mod.scope_of(node), "broad-except-swallow",
                "broad `except Exception` in a resilience-wrapped path "
                "swallows retryable/classifiable errors — re-raise, "
                "narrow the type, or annotate `# check: no-retry` if "
                "the swallow is deliberate"))
