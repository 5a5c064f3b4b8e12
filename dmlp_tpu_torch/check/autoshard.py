"""R9 — the DTensor placement contract.

R1 guards the explicit collectives; this family extends the same axis
discipline to the declarative sharding surface: ``DeviceMesh`` dims and
the DTensor placements on them (``engine/auto.py``,
``parallel/collectives.py::gspmd_merge_topk``, ``train/``). In torch a
placement names no axis: entry i of a placements list is mesh dim i's,
so what can silently go wrong is a mesh dim named off the declared set,
and a list with more or fewer entries than the mesh has dims (DTensor
raises on some of those at run time, on every rank; a wrong entry count
through a reused variable reads as a different program).

- **R901**: every ``init_device_mesh``/``DeviceMesh`` names its dims
  from declared axes (``*_AXIS`` constants; literal or constant names —
  opaque ones are skipped), and every placements list literal
  (``[Shard(i)|Replicate()|Partial(), ...]``) passed to
  ``DTensor.from_local``, ``distribute_tensor`` or ``redistribute`` on
  a mesh that resolves in the same function (or, for ``self.<attr>``,
  the same class) has one entry per mesh dim.
- **R902**: in ``engine/auto.py`` every ``DTensor.from_local``,
  ``distribute_tensor`` and ``redistribute`` passes its placements
  explicitly: the torch analog of pinning a jit's in and out
  shardings — a defaulted placement (replicate) lets the engine
  benchmark a different program than the one its record names.
- **R903**: a placements list that reaches one of those calls through
  a local variable resolves through that binding to a list literal and
  is held to R901's entry count; names bound to anything else are
  skipped, not guessed at.

A mesh resolves from ``init_device_mesh(dev, (r, c), ...)`` or a
constructor with literal ``mesh_dim_names``, from a call of a package
function that returns such a mesh (``make_mesh``, ``make_train_mesh``),
and from ``<mesh>[X]`` (one dim, or as many as ``X`` names).
``# check: allow-auto-shard`` (or ``=R90x``) waives a site.
"""

from __future__ import annotations

import ast
from typing import Optional

from dmlp_tpu_torch.check.collectives import (GroupResolver, attr_bindings,
                                              name_bindings)
from dmlp_tpu_torch.check.common import ModuleInfo, call_name
from dmlp_tpu_torch.check.facts import mesh_ctor_ndim
from dmlp_tpu_torch.check.findings import Finding

ALLOW = "allow-auto-shard"
#: the one file whose placement sites carry the R902 pinning contract
AUTO_ENGINE_PATH = "dmlp_tpu_torch/engine/auto.py"
_PLACEMENTS = ("Shard", "Replicate", "Partial")
_MESH_CTORS = ("init_device_mesh", "DeviceMesh")


def _leaf(call: ast.Call) -> str:
    return (call_name(call) or "").rsplit(".", 1)[-1]


def placement_site(call: ast.Call):
    """(what, mesh expression, placements expression, explicit?) of a
    DTensor placement call, else None."""
    func = call.func
    if not isinstance(func, (ast.Attribute, ast.Name)):
        return None
    leaf = _leaf(call)
    if leaf == "from_local" or leaf == "distribute_tensor":
        mesh_i, pl_i = 1, 2
    elif leaf == "redistribute" and isinstance(func, ast.Attribute):
        mesh_i, pl_i = 0, 1
    else:
        return None
    mesh = call.args[mesh_i] if len(call.args) > mesh_i else None
    pl = call.args[pl_i] if len(call.args) > pl_i else None
    for kw in call.keywords:
        if kw.arg == "device_mesh":
            mesh = kw.value
        elif kw.arg == "placements":
            pl = kw.value
    explicit = pl is not None and not (isinstance(pl, ast.Constant)
                                       and pl.value is None)
    return leaf, mesh, pl, explicit


def _placements_literal(expr) -> Optional[int]:
    """Entry count of a placements list/tuple literal, else None."""
    if not isinstance(expr, (ast.List, ast.Tuple)):
        return None
    for e in expr.elts:
        if not (isinstance(e, ast.Call) and _leaf(e) in _PLACEMENTS):
            if not isinstance(e, ast.IfExp):
                return None
    return len(expr.elts)


class AutoShardRule:
    """One instance runs over the whole package; the declared axes and
    the package's mesh factories come from the merged facts."""

    def __init__(self, facts):
        self.facts = facts
        self.declared = facts.declared
        self.factories = facts.mesh_factories

    def run(self, mod: ModuleInfo, add) -> None:
        res = GroupResolver(mod, self.facts)
        auto = mod.relpath.replace("\\", "/").endswith(AUTO_ENGINE_PATH)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if _leaf(node) in _MESH_CTORS:
                self._check_dim_names(mod, node, res, add)
                continue
            site = placement_site(node)
            if site is None:
                continue
            what, mesh, pl, explicit = site
            if auto and not explicit \
                    and not mod.allowed_value(node, ALLOW, "R902"):
                add(Finding(
                    "R902", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), f"{what}:placements",
                    f"{what} in the auto engine must pass its placements "
                    f"explicitly (or carry `# check: allow-auto-shard`): "
                    f"a defaulted placement replicates, and the engine "
                    f"would run another program than its record names"))
            if pl is None:
                continue
            ndim = self._mesh_ndim(mod, mesh, node)
            if ndim is None:
                continue
            rule, n = "R901", _placements_literal(pl)
            if n is None and isinstance(pl, ast.Name):
                rule, n = "R903", self._bound_count(mod, pl, node)
            if n is None or n == ndim \
                    or mod.allowed_value(node, ALLOW, rule):
                continue
            via = f" (through {pl.id})" if rule == "R903" else ""
            add(Finding(
                rule, mod.relpath, node.lineno, node.col_offset,
                mod.scope_of(node), f"{what}:{n}!={ndim}",
                f"{what} places on a {ndim}-dim mesh with {n} "
                f"placement(s){via}: one entry per mesh dim"))

    def _check_dim_names(self, mod, node: ast.Call, res: GroupResolver,
                         add) -> None:
        expr = next((kw.value for kw in node.keywords
                     if kw.arg == "mesh_dim_names"), None)
        if not isinstance(expr, (ast.Tuple, ast.List)):
            return              # absent or opaque: not guessed at
        for e in expr.elts:
            r = res.axis(e)
            if not isinstance(r, set):
                continue
            for ax in sorted(r - self.declared):
                if mod.allowed_value(node, ALLOW, "R901"):
                    continue
                add(Finding(
                    "R901", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), f"mesh_dim:{ax}",
                    f"mesh dim {ax!r} is not a declared axis (no *_AXIS "
                    f"constant names it; declared: "
                    f"{sorted(self.declared)})"))

    # -- resolution -----------------------------------------------------------
    def _mesh_ndim(self, mod, expr, node, depth: int = 0) -> Optional[int]:
        if expr is None or depth > 3:
            return None
        if isinstance(expr, ast.Call):
            nd = mesh_ctor_ndim(expr, mod)
            if nd is not None:
                return nd
            return self.factories.get(_leaf(expr))
        if isinstance(expr, ast.Subscript):
            sl = expr.slice
            if isinstance(sl, (ast.Tuple, ast.List)):
                return len(sl.elts)
            return 1
        values = None
        if isinstance(expr, ast.Name):
            fns = mod.enclosing_funcs(node)
            if fns:
                values = name_bindings(fns[0], expr.id)
        elif isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            cls = mod.parents.get(node)
            while cls is not None and not isinstance(cls, ast.ClassDef):
                cls = mod.parents.get(cls)
            if cls is not None:
                values = attr_bindings(cls, expr.attr)
        if not values:
            return None
        dims = {self._mesh_ndim(mod, v, v, depth + 1) for v in values}
        return dims.pop() if len(dims) == 1 else None

    @staticmethod
    def _bound_count(mod, name: ast.Name, node) -> Optional[int]:
        fns = mod.enclosing_funcs(node)
        if not fns:
            return None
        counts = {_placements_literal(v)
                  for v in name_bindings(fns[0], name.id)}
        if len(counts) != 1:
            return None
        return counts.pop()
