"""R1 — the collective-axis contract, over ``torch.distributed``.

The port's collectives are ``torch.distributed`` calls on process
groups (and ``torch.distributed._functional_collectives``); a
``dist.P2POp(dist.isend, ...)`` names its op as a value, not a call, and
counts as that op's site. Four checks:

- **R101**: the ``group`` argument must resolve to a mesh axis some
  ``*_AXIS`` constant in the package declares (``parallel/mesh.py``,
  ``train/sharding.py``, ``train/pipeline.py``, ``train/experts.py``),
  or to the world group. A group of an undeclared axis is the classic
  silent-wrong-program bug: ``mesh.get_group("dta")`` fails only when
  the mesh runs, on every rank at once.
- **R102**: when the module builds a mesh itself
  (``init_device_mesh(..., mesh_dim_names=...)``, ``DeviceMesh(...)``),
  the resolved axis must be one of that mesh's dim names — a collective
  over an axis the module's own mesh lacks is a wrong-mesh bug.
- **R103/R104**: traffic-bearing collectives in ``engine/``,
  ``parallel/``, ``train/`` must carry a
  ``# check: comms-model=<fn>[,<fn>]`` annotation naming their analytic
  traffic model in ``obs/comms.py`` (or ``# check: no-traffic`` with the
  reason written on the line). This is the static half of the
  model-vs-record reconcile (``obs/hlo.py``): a new collective without a
  model, or a model function renamed away, fails the check instead of
  silently skewing every comms record.

A group resolves through: no group, ``None`` or ``dist.group.WORLD``
(the world group); ``<mesh>.get_group(X)``, ``get_group(mesh_dim=X)``
and ``<mesh>[X].get_group()`` with ``X`` a string or a ``*_AXIS``
constant (local or imported); a call of a package function that makes
its group that way (``axis_group(mesh, (EP_AXIS,))``,
``dp_group(mesh)``); a ``(mesh, X)`` pair (the functional collectives);
a local name, or a ``self.<attr>`` of the enclosing class, every
binding of which resolves so; and a function parameter — then the axis
is checked where the helper is called (one level, as the reference's
``axis_name`` helpers are), since that is where it is chosen.
Everything else is opaque: skipped, never guessed. DTensor's implicit
collectives (``redistribute``, ``full_tensor``, ``distribute_tensor``)
are R9's, as GSPMD's are in the reference.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from dmlp_tpu_torch.check.common import ModuleInfo, call_name, dotted
from dmlp_tpu_torch.check.findings import Finding

_C10D = "torch.distributed."
_FUNCOL = "torch.distributed._functional_collectives."

#: c10d collective -> positional index of its ``group`` argument
C10D_GROUP_ARG = {
    "all_reduce": 2, "all_gather": 2, "all_gather_into_tensor": 2,
    "all_gather_object": 2, "reduce_scatter": 3,
    "reduce_scatter_tensor": 3, "all_to_all": 2, "all_to_all_single": 4,
    "broadcast": 2, "broadcast_object_list": 2, "scatter": 3,
    "scatter_object_list": 3, "gather": 3, "gather_object": 3,
    "reduce": 3, "send": 2, "recv": 2, "isend": 2, "irecv": 2,
    "barrier": 0, "monitored_barrier": 0,
}
#: functional collective -> positional index of its ``group`` argument
FUNCOL_GROUP_ARG = {
    "all_reduce": 2, "all_reduce_coalesced": 2, "all_gather_tensor": 2,
    "all_gather_tensor_autograd": 2, "reduce_scatter_tensor": 3,
    "reduce_scatter_tensor_autograd": 3, "all_to_all_single": 3,
    "all_to_all_single_autograd": 3, "broadcast": 2, "permute_tensor": 2,
}
#: collectives that move no payload of their own
NO_PAYLOAD = {"barrier", "monitored_barrier"}
#: positional index of ``group`` in ``dist.P2POp(op, tensor, peer, group)``
P2POP_GROUP_ARG = 3
#: directories whose collectives must map to an obs/comms.py model
TRAFFIC_SCOPE = ("dmlp_tpu_torch/engine/", "dmlp_tpu_torch/parallel/",
                 "dmlp_tpu_torch/train/")
#: the world group's axis name (``obs.hlo`` names it so)
WORLD = "world"
_WORLD_NAMES = {"torch.distributed.group.WORLD",
                "torch.distributed.GroupMember.WORLD"}

ALLOW = "allow-collective"


def in_scope(relpath: str, scope=TRAFFIC_SCOPE) -> bool:
    rel = relpath.replace("\\", "/")
    return any(rel.startswith(p) or f"/{p}" in rel for p in scope)


def collective_site(call: ast.Call, mod: ModuleInfo):
    """(kind, group expression or None) of a collective call site, else
    None. ``dist.P2POp(dist.isend, ...)`` is the site of its op."""
    name = mod.canon(call_name(call))
    if not name:
        return None
    if name == _C10D + "P2POp":
        op = call.args[0] if call.args else None
        for kw in call.keywords:
            if kw.arg == "op":
                op = kw.value
        kind = (mod.canon(dotted(op)) if op is not None else None) or ""
        kind = kind.rsplit(".", 1)[-1] if kind.startswith(_C10D) else "p2p"
        return kind, _group_arg(call, P2POP_GROUP_ARG)
    for prefix, table in ((_FUNCOL, FUNCOL_GROUP_ARG),
                          (_C10D, C10D_GROUP_ARG)):
        if name.startswith(prefix) and name[len(prefix):] in table:
            kind = name[len(prefix):]
            return kind, _group_arg(call, table[kind])
    return None


def _group_arg(call: ast.Call, idx: int) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "group":
            return kw.value
    if 0 <= idx < len(call.args) \
            and not isinstance(call.args[idx], ast.Starred):
        return call.args[idx]
    return None


class GroupResolver:
    """Resolves group and axis expressions in one module against the
    package's declared axes and group-making helpers."""

    def __init__(self, mod: ModuleInfo, facts):
        self.mod = mod
        self.axis_consts: Dict[str, str] = facts.axis_consts
        self.makers: Dict[str, List] = facts.group_makers

    # -- axes -----------------------------------------------------------------
    def axis(self, expr) -> object:
        """A set of axis names, ``("param", name)``, or None (opaque)."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return {expr.value}
        if isinstance(expr, (ast.Tuple, ast.List)):
            out: Set[str] = set()
            for e in expr.elts:
                r = self.axis(e)
                if not isinstance(r, set):
                    return None
                out |= r
            return out
        if isinstance(expr, ast.Name):
            if expr.id in self.mod.str_consts:
                return {self.mod.str_consts[expr.id]}
            src = self.mod.imports.get(expr.id, "")
            leaf = src.rsplit(".", 1)[-1] if src else expr.id
            if leaf in self.axis_consts:
                return {self.axis_consts[leaf]}
            fn = self._enclosing_fn(expr)
            if fn is not None and expr.id in _param_names(fn):
                return ("param", expr.id)
        return None

    # -- groups ---------------------------------------------------------------
    def group(self, expr, node: ast.AST, depth: int = 0) -> object:
        """The axes the group expression ``expr`` (at ``node``) spans: a
        set (``{"world"}`` for the world group), ``("param", name)``, or
        None (opaque)."""
        if expr is None or (isinstance(expr, ast.Constant)
                            and expr.value is None):
            return {WORLD}
        if depth > 3:
            return None
        mod = self.mod
        if isinstance(expr, (ast.Attribute, ast.Name)) \
                and mod.canon(dotted(expr)) in _WORLD_NAMES:
            return {WORLD}
        if isinstance(expr, ast.IfExp):
            a = self.group(expr.body, node, depth + 1)
            b = self.group(expr.orelse, node, depth + 1)
            if isinstance(a, set) and isinstance(b, set):
                return a | b
            return None
        if isinstance(expr, ast.Tuple) and len(expr.elts) == 2:
            return self.axis(expr.elts[1])       # (mesh, X)
        if isinstance(expr, ast.Call):
            return self._group_call(expr)
        if isinstance(expr, ast.Name):
            fn = self._enclosing_fn(node)
            if fn is not None and expr.id in _param_names(fn):
                return ("param", expr.id)
            values = name_bindings(fn, expr.id) if fn is not None \
                else []
            if fn is None or not values:
                values = [s.value for s in mod.tree.body
                          if isinstance(s, ast.Assign)
                          and any(isinstance(t, ast.Name)
                                  and t.id == expr.id for t in s.targets)]
            return self._bound(values, depth)
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            cls = self._enclosing_class(node)
            if cls is None:
                return None
            return self._bound(attr_bindings(cls, expr.attr), depth)
        return None

    def _bound(self, values: List[ast.AST], depth) -> object:
        """The union over every binding's value, each resolved where it
        is written; opaque if any is."""
        if not values:
            return None
        out: Set[str] = set()
        for v in values:
            r = self.group(v, v, depth + 1)
            if not isinstance(r, set):
                return None
            out |= r
        return out

    def _group_call(self, call: ast.Call) -> object:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "get_group":
            arg = call.args[0] if call.args else None
            for kw in call.keywords:
                if kw.arg == "mesh_dim":
                    arg = kw.value
            if arg is None and isinstance(func.value, ast.Subscript):
                arg = func.value.slice            # mesh[X].get_group()
            r = self.axis(arg) if arg is not None else None
            return r if isinstance(r, set) else None
        name = call_name(call)
        leaf = name.rsplit(".", 1)[-1] if name else None
        how = self.makers.get(leaf)
        if how is None:
            return None
        if how[0] == "axes":
            return set(how[1])
        if how[0] == "const":
            ax = self.axis_consts.get(how[1])
            return {ax} if ax else None
        idx = how[1]
        if idx < len(call.args):
            r = self.axis(call.args[idx])
            return r if isinstance(r, set) else None
        return None

    # -- structure ------------------------------------------------------------
    def _enclosing_fn(self, node):
        fns = self.mod.enclosing_funcs(node)
        return fns[0] if fns else None

    def _enclosing_class(self, node):
        cur = self.mod.parents.get(node)
        while cur is not None and not isinstance(cur, ast.ClassDef):
            cur = self.mod.parents.get(cur)
        return cur


def _param_names(fn) -> Set[str]:
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}


def name_bindings(scope, name: str) -> List[ast.AST]:
    """Every value ``name`` is bound to by a plain assignment in
    ``scope`` (nested defs included); [] when a tuple unpack or any
    other binding makes it opaque."""
    out: List[ast.AST] = []
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    out.append(node.value)
                elif isinstance(t, (ast.Tuple, ast.List)) and any(
                        isinstance(e, ast.Name) and e.id == name
                        for e in t.elts):
                    return []
        elif isinstance(node, (ast.For, ast.With, ast.AugAssign,
                               ast.AnnAssign, ast.NamedExpr)):
            targets = [getattr(node, "target", None)] + [
                i.optional_vars for i in getattr(node, "items", [])]
            if any(isinstance(t, ast.Name) and t.id == name
                   for t in targets if t is not None):
                return []
    return out


def attr_bindings(cls: ast.ClassDef, attr: str) -> List[ast.AST]:
    out: List[ast.AST] = []
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == attr \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    out.append(node.value)
    return out


def module_mesh_axes(mod: ModuleInfo, resolver: GroupResolver
                     ) -> Optional[Set[str]]:
    """The dim names of the meshes this module builds, when it builds
    one and every one's names resolve; else None (R102 stays silent)."""
    names: Set[str] = set()
    built = False
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        leaf = (call_name(node) or "").rsplit(".", 1)[-1]
        if leaf not in ("init_device_mesh", "DeviceMesh"):
            continue
        built = True
        expr = next((kw.value for kw in node.keywords
                     if kw.arg == "mesh_dim_names"), None)
        r = resolver.axis(expr) if expr is not None else None
        if not isinstance(r, set):
            return None
        names |= r
    return names if built else None


class CollectiveRule:
    """One instance runs over the whole package: the declared axes, the
    comms models and the group helpers come from the merged facts."""

    def __init__(self, facts):
        self.facts = facts
        self.declared: Set[str] = facts.declared
        self.comms_models: Set[str] = facts.comms_models
        self.helpers: Dict[str, List] = facts.group_helpers

    def run(self, mod: ModuleInfo, add) -> None:
        res = GroupResolver(mod, self.facts)
        mesh_axes = None
        mesh_axes_done = False
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            site = collective_site(node, mod)
            if site is not None:
                kind, gexpr = site
                what = kind
            else:
                name = call_name(node)
                leaf = name.rsplit(".", 1)[-1] if name else None
                if leaf not in self.helpers:
                    continue
                idx, pname = self.helpers[leaf]
                gexpr = next((kw.value for kw in node.keywords
                              if kw.arg == pname), None)
                if gexpr is None:
                    if not (0 <= idx < len(node.args)):
                        continue
                    gexpr = node.args[idx]
                kind, what = None, f"{leaf}({pname})"
            axes = res.group(gexpr, node)
            if isinstance(axes, set) and not mod.allowed(node, ALLOW):
                if not mesh_axes_done:
                    mesh_axes = module_mesh_axes(mod, res)
                    mesh_axes_done = True
                self._check_axes(mod, node, what, axes, mesh_axes, add)
            if kind is not None and kind not in NO_PAYLOAD:
                self._check_traffic(mod, node, kind, add)

    def _check_axes(self, mod, node, what, axes, mesh_axes, add) -> None:
        for ax in sorted(axes - {WORLD}):
            if ax not in self.declared:
                add(Finding(
                    "R101", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), f"{what}:{ax}",
                    f"{what} runs over the group of mesh axis {ax!r}, "
                    f"which no *_AXIS constant declares (declared: "
                    f"{sorted(self.declared)})"))
            elif mesh_axes is not None and ax not in mesh_axes:
                add(Finding(
                    "R102", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), f"{what}:{ax}",
                    f"{what} runs over axis {ax!r}, but the mesh this "
                    f"module builds names only {sorted(mesh_axes)}"))

    def _check_traffic(self, mod: ModuleInfo, node: ast.Call, kind: str,
                       add) -> None:
        if not in_scope(mod.relpath):
            return
        if mod.allowed(node, "no-traffic") or mod.allowed(node, ALLOW):
            return
        models: List[str] = []
        for v in mod.directive_values(node, "comms-model"):
            models.extend(x for x in v.split(",") if x)
        if not models:
            add(Finding(
                "R103", mod.relpath, node.lineno, node.col_offset,
                mod.scope_of(node), kind,
                f"{kind} moves bytes but carries no `# check: "
                f"comms-model=<fn>` annotation naming its analytic "
                f"model in obs/comms.py (or `# check: no-traffic` with "
                f"its reason)"))
            return
        for m in models:
            if m not in self.comms_models:
                add(Finding(
                    "R104", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), f"{kind}:{m}",
                    f"comms-model annotation names {m!r}, but "
                    f"obs/comms.py defines no such function"))
