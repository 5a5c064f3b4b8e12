"""R3 — host-sync hazards on the hot paths (``engine/``, ``ops/``,
``parallel/``, ``serve/``, ``fleet/``).

A single stray ``.item()`` or implicit ``np.asarray`` readback in the
enqueue loop serializes the whole chunk pipeline against the card: the
host waits for every queued launch before it can queue the next one.
The rule flags the readback methods themselves plus implicit conversions
of device-producing expressions, with a light forward taint pass per
function:

- seeds: ``torch.*`` calls that return tensors (the metadata, CUDA,
  distributed and backend namespaces return host values and are not
  seeds), and calls of the port's kernel wrappers and device ops
  (:data:`DEVICE_PRODUCERS`);
- propagation: assignment targets whose right side contains a tainted
  name or a seed call become tainted (tuple unpacking included);
  metadata reads (``.shape``, ``.dtype``, ``.numel()``, ``len(x)``, ...)
  are host values and carry no taint.

Flagged:

- **R301** ``.item()`` on anything, ``.cpu()`` and ``.numpy()`` on
  anything, ``.tolist()`` on a tainted value;
- **R302** every call of the explicit readback,
  :func:`dmlp_tpu_torch.check.sanitize.readback` (the port's
  ``jax.device_get``), unless annotated ``# check: allow-host-sync``;
- **R303** ``float()``/``int()``/``bool()`` of a tainted value;
- **R304** ``np.asarray``/``np.array`` of a tainted value;
- **R305** an ``if``/``while``/``assert``/conditional expression whose
  test is a tainted value (an implicit ``Tensor.__bool__`` readback).

Intentional, fenced readbacks are part of the design (the result fetch
IS a readback): they go through ``readback`` and carry ``# check:
allow-host-sync``, which the ``--sanitize`` run permits while implicit
conversions raise. What R3 wants annotated is what
:func:`~dmlp_tpu_torch.check.sanitize.sanitized` rejects un-annotated.
``readback`` (and ``resilient_get``, the engine's retry-wrapped
readback) clear taint: their results are host arrays.

Known limit (documented, deliberate): taint is per-function and
syntactic, so a device value returned through ``self._solve(...)`` is
not tracked across the method boundary. The runtime sanitizer covers
that remainder.
"""

from __future__ import annotations

import ast
from typing import Set

from dmlp_tpu_torch.check.common import ModuleInfo, call_name
from dmlp_tpu_torch.check.findings import Finding

#: path fragments that make a module a hot path for this family
HOT_DIRS = ("dmlp_tpu_torch/engine/", "dmlp_tpu_torch/ops/",
            "dmlp_tpu_torch/parallel/", "dmlp_tpu_torch/serve/",
            "dmlp_tpu_torch/fleet/")

#: canonical prefixes of torch calls whose results are host values
HOST_TORCH = (
    "torch.device", "torch.cuda.", "torch.distributed.", "torch.backends.",
    "torch.utils.", "torch.profiler.", "torch.autograd.", "torch.overrides.",
    "torch.library.", "torch._C.", "torch.finfo", "torch.iinfo",
    "torch.Size", "torch.Generator", "torch.is_tensor",
    "torch.is_floating_point", "torch.get_default_dtype", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.set_grad_enabled",
    "torch.is_grad_enabled", "torch.manual_seed", "torch.get_num_threads",
    "torch.set_num_threads", "torch.use_deterministic_algorithms",
    "torch.equal", "torch.allclose", "torch.promote_types",
    "torch.result_type", "torch.can_cast", "torch.dtype", "torch.get_",
    "torch.set_", "torch.is_",
)
#: the port's kernel wrappers and device ops, by leaf name
DEVICE_PRODUCERS = {
    "extract_topk", "fused_topk", "fused_dist_segmin", "streaming_topk",
    "step_seg", "step_seg_outliers", "init_topk", "select_topk",
    "merge_topk", "stage", "host_staging", "masked_pairwise_sq_l2",
    "merge_partials", "split_partials_plain", "allgather_merge_topk",
    "ring_merge_topk", "gspmd_merge_topk", "device_vote",
}
#: tensor attributes and methods whose value is host metadata
META_ATTRS = {
    "shape", "dtype", "device", "ndim", "is_cuda", "is_sparse",
    "requires_grad", "layout", "numel", "dim", "size", "element_size",
    "nelement", "stride", "is_contiguous", "get_device", "storage_offset",
    "nbytes", "itemsize", "data_ptr", "is_floating_point", "grad_fn",
}
#: builtins whose result is host metadata of their argument
_META_CALLS = {"len", "isinstance", "type", "id", "hasattr", "callable",
               "_ptr"}
#: conversions that force an implicit device->host transfer
_CONVERTERS = {"float": "R303", "int": "R303", "bool": "R303",
               "np.asarray": "R304", "np.array": "R304",
               "numpy.asarray": "R304", "numpy.array": "R304"}
#: readback methods flagged on any receiver / only on a tainted one
_READ_ANY = {"item", "cpu", "numpy"}
_READ_TAINTED = {"tolist"}
#: the explicit readback (R302) by leaf name
READBACK = {"readback"}

ALLOW = "allow-host-sync"


def in_scope(relpath: str) -> bool:
    rel = relpath.replace("\\", "/")
    return any(rel.startswith(d) or f"/{d}" in rel for d in HOT_DIRS)


def _is_device_call(mod: ModuleInfo, node: ast.Call) -> bool:
    name = call_name(node)
    if name is None:
        return False
    canon = mod.canon(name) or name
    if canon.startswith("torch."):
        return not canon.startswith(HOST_TORCH)
    return name.rsplit(".", 1)[-1] in DEVICE_PRODUCERS


def _meta_nodes(node: ast.AST) -> Set[int]:
    """ids of the subtrees under metadata reads (``x.shape``,
    ``x.numel()``, ``len(x)``): host values whatever ``x`` is."""
    out: Set[int] = set()
    for sub in ast.walk(node):
        inner = None
        if isinstance(sub, ast.Attribute) and sub.attr in META_ATTRS:
            inner = sub.value
        elif isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id in _META_CALLS:
            inner = sub
        if inner is not None:
            out.update(id(n) for n in ast.walk(inner))
    return out


def _contains_device_expr(mod: ModuleInfo, node: ast.AST,
                          tainted: Set[str]) -> bool:
    skip = _meta_nodes(node)
    for sub in ast.walk(node):
        if id(sub) in skip:
            continue
        if isinstance(sub, ast.Call) and _is_device_call(mod, sub):
            return True
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                and sub.id in tainted:
            return True
    return False


def _taint_targets(target: ast.AST, tainted: Set[str]) -> None:
    for sub in ast.walk(target):
        if isinstance(sub, ast.Name):
            tainted.add(sub.id)


#: wrappers _launders looks through to find the converting call
_TRANSPARENT = {"list", "tuple", "sorted", "reversed"}
#: calls whose RESULT is a host value even from device inputs
_LAUNDERING = set(_CONVERTERS) | {"readback", "resilient_get",
                                  "np.ascontiguousarray",
                                  "numpy.ascontiguousarray", "str"}
_LAUNDERING_METHODS = _READ_ANY | _READ_TAINTED | META_ATTRS


def _launders(expr: ast.AST) -> bool:
    """Does this RHS produce a HOST value even from device inputs?
    ``readback(x)[:n]``, ``x.item()``, ``x.shape[0]``, ``x is None`` —
    conversions, readbacks and metadata launder taint; flagging their
    *results* downstream would double-count the one real sync."""
    while isinstance(expr, (ast.Subscript, ast.Starred)):
        expr = expr.value
    if isinstance(expr, ast.Compare) \
            and all(isinstance(op, (ast.Is, ast.IsNot))
                    for op in expr.ops):
        return True
    if isinstance(expr, ast.Attribute) and expr.attr in META_ATTRS:
        return True
    if isinstance(expr, ast.Call):
        name = call_name(expr) or ""
        if name in _LAUNDERING or name.rsplit(".", 1)[-1] in READBACK:
            return True
        if name in _META_CALLS:
            return True
        if isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in _LAUNDERING_METHODS:
            return True
        if name in _TRANSPARENT and expr.args:
            return _launders(expr.args[0])
    return False


def _is_none_test(expr: ast.AST) -> bool:
    return isinstance(expr, ast.Compare) \
        and all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops)


class HostSyncRule:
    def run(self, mod: ModuleInfo, add) -> None:
        if not in_scope(mod.relpath):
            return
        for fn in ast.walk(mod.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._run_function(mod, fn, add)

    def _run_function(self, mod: ModuleInfo, fn, add) -> None:
        """One forward pass in STATEMENT order: each statement is checked
        against the taint state as of its execution point, then updates
        it — so a laundering rebind (``x = readback(x)``) clears ``x``
        for everything after it but not before. Loop-carried taint (a
        use textually before its loop-body def) is the documented miss
        of the single pass."""
        scope = (mod.scope_of(fn) + "." + fn.name).lstrip(".")
        tainted: Set[str] = set()

        def untaint(target: ast.AST) -> None:
            for sub in ast.walk(target):
                if isinstance(sub, ast.Name):
                    tainted.discard(sub.id)

        def branch(test: ast.AST, node: ast.AST) -> None:
            if _is_none_test(test) or _launders(test):
                return
            if _contains_device_expr(mod, test, tainted) \
                    and not mod.allowed(node, ALLOW):
                add(Finding(
                    "R305", mod.relpath, node.lineno, node.col_offset,
                    scope, "tensor-branch",
                    "Python branch on a device tensor — an implicit "
                    "Tensor.__bool__ readback; read it back explicitly "
                    "(sanitize.readback) if the sync is intended"))

        def check_exprs(node: ast.AST) -> None:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    self._check_call(mod, sub, scope, tainted, add)
                elif isinstance(sub, ast.IfExp):
                    branch(sub.test, sub)

        def visit(stmts) -> None:
            for st in stmts:
                if isinstance(st, ast.Assign):
                    check_exprs(st.value)
                    self._update(mod, st.targets, st.value, tainted,
                                 untaint)
                elif isinstance(st, ast.AnnAssign) \
                        and st.value is not None:
                    check_exprs(st.value)
                    self._update(mod, [st.target], st.value, tainted,
                                 untaint)
                elif isinstance(st, ast.AugAssign):
                    check_exprs(st.value)
                    if _contains_device_expr(mod, st.value, tainted) \
                            and not _launders(st.value):
                        _taint_targets(st.target, tainted)
                elif isinstance(st, (ast.For, ast.AsyncFor)):
                    check_exprs(st.iter)
                    if _contains_device_expr(mod, st.iter, tainted) \
                            and not _launders(st.iter):
                        _taint_targets(st.target, tainted)
                    visit(st.body)
                    visit(st.orelse)
                elif isinstance(st, (ast.If, ast.While)):
                    check_exprs(st.test)
                    branch(st.test, st)
                    visit(st.body)
                    visit(st.orelse)
                elif isinstance(st, ast.Assert):
                    check_exprs(st)
                    branch(st.test, st)
                elif isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        check_exprs(item.context_expr)
                    visit(st.body)
                elif isinstance(st, ast.Try):
                    visit(st.body)
                    for h in st.handlers:
                        visit(h.body)
                    visit(st.orelse)
                    visit(st.finalbody)
                elif isinstance(st, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    pass  # nested defs run as their own functions
                else:
                    check_exprs(st)

        visit(fn.body)

    @staticmethod
    def _update(mod, targets, value, tainted: Set[str], untaint) -> None:
        if _launders(value):
            for t in targets:
                untaint(t)
        elif _contains_device_expr(mod, value, tainted):
            for t in targets:
                _taint_targets(t, tainted)
        else:
            for t in targets:
                untaint(t)

    def _check_call(self, mod: ModuleInfo, node: ast.Call, scope: str,
                    tainted: Set[str], add) -> None:
        name = call_name(node)
        if isinstance(node.func, ast.Attribute) and not node.args:
            leaf = node.func.attr
            hit = leaf in _READ_ANY or (
                leaf in _READ_TAINTED and _contains_device_expr(
                    mod, node.func.value, tainted))
            if hit:
                if not mod.allowed(node, ALLOW):
                    add(Finding(
                        "R301", mod.relpath, node.lineno,
                        node.col_offset, scope, leaf,
                        f".{leaf}() forces a blocking device readback; "
                        f"fence it with sanitize.readback (and annotate "
                        f"`# check: allow-host-sync`) if intentional"))
                return
        if name is not None and name.rsplit(".", 1)[-1] in READBACK:
            if not mod.allowed(node, ALLOW):
                add(Finding(
                    "R302", mod.relpath, node.lineno, node.col_offset,
                    scope, "readback",
                    "explicit readback — if this fence is intentional, "
                    "annotate `# check: allow-host-sync`"))
            return
        rule = _CONVERTERS.get(name or "")
        if rule and node.args \
                and _contains_device_expr(mod, node.args[0], tainted) \
                and not _launders(node.args[0]) \
                and not mod.allowed(node, ALLOW):
            add(Finding(
                rule, mod.relpath, node.lineno, node.col_offset, scope,
                f"convert:{name}",
                f"{name}() on a device-producing expression forces an "
                f"implicit readback; fence it explicitly with "
                f"sanitize.readback (and annotate) if intentional"))
