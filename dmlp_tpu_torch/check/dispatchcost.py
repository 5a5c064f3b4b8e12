"""R1 extension — kernel-dispatch cost coverage (R105/R106).

The measured-extraction-term contract: every top-k kernel call in the
engines is paired with a ``MeasuredIters`` probe so the extraction term
stays ``measured``, not modeled, and every kernel launch is recorded for
the analytic cost counters (``obs_counters.record_dispatch``, resolving
through ``obs.kernel_cost.analytic_cost`` — a hand-written CUDA kernel
has no library cost analysis). The port records inside the kernel
wrappers (``ops/extract.py``, ``ops/dist_segmin.py``), beside the
``kernels.note_launch`` that counts the launch, not in ``engine/``.
Both halves drift silently, so:

- **R105**: an ``engine/`` call of a top-k kernel — a name bound from
  ``resolve_topk_kernel`` (``kern, impl = resolve_topk_kernel(...)``),
  or ``fused_topk``/``extract_topk`` imported from ``ops`` — whose
  enclosing function neither constructs a ``MeasuredIters`` probe nor
  routes through ``_queue_iters``: the call would report a modeled
  (lower-bound) extraction term.
- **R106**: a ``record_dispatch`` or ``note_launch`` whose kernel name
  (a string, a conditional of strings, or a local bound to one) is not
  a key of ``obs/kernel_cost.py::_MODELS`` — its counters would
  silently count nothing; a ``note_launch`` in a function that records
  no dispatch; and a key of ``kernels/__init__.py::LAUNCHES`` (the set
  of launch counters) with no model.

R105 scopes to ``engine/`` (the hot-path dispatch sites; tools and
tests measure what they please), R106 to the whole package. Both honor
the R1 family's ``# check: allow-collective`` directive.
"""

from __future__ import annotations

import ast
from typing import Optional, Set

from dmlp_tpu_torch.check.common import ModuleInfo, call_name
from dmlp_tpu_torch.check.findings import Finding

#: functions whose return value IS a top-k kernel callable
KERNEL_RESOLVERS = {"resolve_topk_kernel"}
#: the top-k kernel wrappers an engine may call directly
TOPK_KERNELS = {"fused_topk", "extract_topk"}
#: the probe protocol: an enclosing function satisfies R105 when it
#: constructs the accumulator itself or routes through the shared queue
PROBE_CALLS = {"MeasuredIters", "_queue_iters"}
#: the recording hooks whose first argument names a kernel
RECORD_CALLS = {"record_dispatch"}
LAUNCH_CALLS = {"note_launch"}

ALLOW = "allow-collective"


def _leaf(call: ast.Call) -> Optional[str]:
    name = call_name(call)
    return name.rsplit(".", 1)[-1] if name else None


def kernel_names(expr, fn) -> Optional[Set[str]]:
    """The kernel names a record's first argument can take, or None
    (opaque)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return {expr.value}
    if isinstance(expr, ast.IfExp):
        a, b = kernel_names(expr.body, fn), kernel_names(expr.orelse, fn)
        return a | b if a is not None and b is not None else None
    if isinstance(expr, ast.Name) and fn is not None:
        out: Set[str] = set()
        seen = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == expr.id
                    for t in node.targets):
                got = kernel_names(node.value, None)
                if got is None:
                    return None
                out |= got
                seen = True
        return out if seen else None
    return None


class DispatchCostRule:
    """R105 over every engine-module kernel call, R106 over every
    recording and counting site."""

    def __init__(self, facts):
        self._modeled = facts.modeled_kernels
        self._launches = facts.launch_names

    def run(self, mod: ModuleInfo, add) -> None:
        rel = mod.relpath.replace("\\", "/")
        if "engine/" in rel:
            self._check_probes(mod, add)
        self._check_models(mod, add)
        if rel.endswith("kernels/__init__.py"):
            self._check_launch_table(mod, add)

    # -- R105 -----------------------------------------------------------------
    def _ops_kernels(self, mod: ModuleInfo) -> Set[str]:
        """Local names of the top-k wrappers imported from ``ops``."""
        out = set()
        for local, src in mod.imports.items():
            parts = src.split(".")
            if "ops" in parts[:-1] and parts[-1] in TOPK_KERNELS:
                out.add(local)
        return out

    @staticmethod
    def _kernel_vars(fn: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Call) \
                    or _leaf(node.value) not in KERNEL_RESOLVERS:
                continue
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                if elts and isinstance(elts[0], ast.Name):
                    out.add(elts[0].id)
        return out

    @staticmethod
    def _has_probe(fn: ast.AST) -> bool:
        return any(isinstance(n, ast.Call) and _leaf(n) in PROBE_CALLS
                   for n in ast.walk(fn))

    def _check_probes(self, mod: ModuleInfo, add) -> None:
        ops_kernels = self._ops_kernels(mod)
        memo = {}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Name):
                continue
            encl = mod.enclosing_funcs(node)
            fn = encl[0] if encl else None
            if fn is None:
                continue
            if fn not in memo:
                memo[fn] = (self._kernel_vars(fn), self._has_probe(fn))
            kvars, probed = memo[fn]
            arg = node.func.id
            if arg not in ops_kernels and arg not in kvars:
                continue
            if probed or mod.allowed(node, ALLOW):
                continue
            add(Finding(
                "R105", mod.relpath, node.lineno, node.col_offset,
                mod.scope_of(node), f"probe:{arg}",
                f"kernel call {arg}(...) but {fn.name} threads no "
                f"MeasuredIters/_queue_iters probe — the extraction term "
                f"degrades to modeled"))

    # -- R106 -----------------------------------------------------------------
    def _check_models(self, mod: ModuleInfo, add) -> None:
        if self._modeled is None:
            return            # no model table known: stay silent
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            leaf = _leaf(node)
            if leaf not in RECORD_CALLS and leaf not in LAUNCH_CALLS:
                continue
            encl = mod.enclosing_funcs(node)
            fn = encl[0] if encl else None
            if fn is not None and fn.name in RECORD_CALLS | LAUNCH_CALLS:
                continue          # the hook's own definition
            if mod.allowed(node, ALLOW):
                continue
            names = kernel_names(node.args[0], fn)
            for name in sorted(names or ()):
                if name not in self._modeled:
                    add(Finding(
                        "R106", mod.relpath, node.lineno, node.col_offset,
                        mod.scope_of(node), f"model:{name}",
                        f"{leaf} names kernel {name!r}, which has no "
                        f"entry in obs/kernel_cost.py's _MODELS — its "
                        f"counters would silently count nothing"))
            if leaf in LAUNCH_CALLS and fn is not None and not any(
                    isinstance(n, ast.Call) and _leaf(n) in RECORD_CALLS
                    for n in ast.walk(fn)):
                add(Finding(
                    "R106", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), "launch-unrecorded",
                    f"{leaf} counts a launch in {fn.name}, which records "
                    f"no dispatch (obs_counters.record_dispatch) — the "
                    f"launch is missing from the cost counters"))

    def _check_launch_table(self, mod: ModuleInfo, add) -> None:
        if self._modeled is None:
            return
        for stmt in mod.tree.body:
            value = getattr(stmt, "value", None)
            targets = getattr(stmt, "targets", None) or [
                getattr(stmt, "target", None)]
            if not isinstance(value, ast.Dict) or not any(
                    isinstance(t, ast.Name) and t.id == "LAUNCHES"
                    for t in targets):
                continue
            for key in value.keys:
                if isinstance(key, ast.Constant) \
                        and isinstance(key.value, str) \
                        and key.value not in self._modeled \
                        and not mod.allowed(key, ALLOW):
                    add(Finding(
                        "R106", mod.relpath, key.lineno, key.col_offset,
                        "", f"model:{key.value}",
                        f"LAUNCHES counts kernel {key.value!r}, which "
                        f"has no entry in obs/kernel_cost.py's _MODELS"))
