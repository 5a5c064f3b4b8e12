"""Per-file cross-module facts — the analyzer's cacheable interface.

The cross-module rule families (R1 collectives, R105/R106 dispatch
cost, R6 metric names, R7 concurrency, R8's eps bounds, R9's meshes, R10
the reconcile table) need package-wide context. Each file reduces to a
small JSON-safe *facts* dict (:func:`module_facts` — a pure function of
that one file's content), and :class:`PackageFacts` merges the per-file
dicts into the tables the rules consume. The split is what makes
per-file caching sound: a file's findings depend only on (its own
content, the merged facts), so the cache key is (content hash, facts
digest) — see :mod:`dmlp_tpu_torch.check.cache`.

The tables: the declared mesh axes (module-level ``*_AXIS`` string
constants), the function names of ``obs/comms.py`` (the comms models),
the keys of ``obs/kernel_cost.py::_MODELS`` and of
``kernels/__init__.py::LAUNCHES``, the eps functions of
``engine/finalize.py``, the keys of ``obs/hlo.py::MODEL_COLLECTIVE_KINDS``,
and, from every file, the defs that take a process ``group``, the defs
that make a group from a mesh axis and the defs that build a mesh. No
line numbers anywhere: a pure line shift must not change the merged
digest (and with it every file's cached verdict), while a change to any
table (a renamed comms model) does.

When the analyzed set lacks one of the single-file tables (a fixture
run over a temporary tree), the table falls back to this package's own
file, and the fallback rides in the digest too.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Set, Tuple

from dmlp_tpu_torch.check.common import CudaModule, ModuleInfo, call_name

FACTS_SCHEMA = 2

#: parameter names that carry a process group into a helper (the torch
#: analog of the reference's ``axis_name`` helpers)
GROUP_PARAMS = ("group", "process_group", "pg")


def module_facts(mod) -> Dict[str, Any]:
    """JSON-safe cross-module facts for one file (content-only: no
    paths inside, so a moved file keeps its facts)."""
    if isinstance(mod, CudaModule):
        return {"facts_schema": FACTS_SCHEMA, "kind": "cuda"}
    from dmlp_tpu_torch.check.concurrency import module_conc_facts
    from dmlp_tpu_torch.check.metricnames import registration_facts
    return {
        "facts_schema": FACTS_SCHEMA,
        "metric_sites": registration_facts(mod),
        "concurrency": module_conc_facts(mod),
        "axis_consts": {n: v for n, v in sorted(mod.str_consts.items())
                        if n.endswith("_AXIS")},
        "defs": sorted(mod.defs),
        "group_helpers": _group_helpers(mod),
        "group_makers": _group_makers(mod),
        "mesh_factories": _mesh_factories(mod),
        "modeled_kernels": dict_keys(mod.tree, "_MODELS"),
        "launch_names": dict_keys(mod.tree, "LAUNCHES"),
        "hlo_model_keys": dict_keys(mod.tree, "MODEL_COLLECTIVE_KINDS"),
    }


def dict_keys(tree: ast.AST, name: str) -> List[str]:
    """String keys of a module-level ``name = {...}`` dict literal (plain
    or annotated assignment); [] when there is none."""
    for stmt in getattr(tree, "body", []):
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            target = stmt.targets[0].id
        elif isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name):
            target = stmt.target.id
        if target != name or not isinstance(stmt.value, ast.Dict):
            continue
        return sorted(k.value for k in stmt.value.keys
                      if isinstance(k, ast.Constant)
                      and isinstance(k.value, str))
    return []


def _call_params(fn: ast.AST, mod: ModuleInfo) -> Tuple[str, List[str]]:
    """(name callers use, positional parameter names as callers pass
    them): a method drops ``self``/``cls``, and ``__init__`` is called by
    its class's name."""
    args = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    parent = mod.parents.get(fn)
    name = fn.name
    if isinstance(parent, ast.ClassDef):
        static = any(isinstance(d, ast.Name) and d.id == "staticmethod"
                     for d in fn.decorator_list)
        if not static and args and args[0] in ("self", "cls"):
            args = args[1:]
        if name == "__init__":
            name = parent.name
    return name, args


def _group_helpers(mod: ModuleInfo) -> Dict[str, List]:
    """def name -> [positional index, parameter name] of its process-group
    parameter: the group its callers choose. Only modules that import
    ``torch.distributed`` hold such helpers."""
    out: Dict[str, List] = {}
    if not any(src == "torch.distributed"
               or src.startswith("torch.distributed.")
               for src in mod.aliases.values()):
        return out          # a "group" here is no process group
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        name, params = _call_params(node, mod)
        kwonly = [a.arg for a in node.args.kwonlyargs]
        for p in GROUP_PARAMS:
            if p in params:
                out.setdefault(name, [params.index(p), p])
                break
            if p in kwonly:
                out.setdefault(name, [-1, p])
                break
    return out


def _group_makers(mod: ModuleInfo) -> Dict[str, List]:
    """def name -> how the group it returns names its axis: ``["param",
    i]`` when it returns ``<mesh>.get_group(p)`` (or ``p[0]``; directly
    or through a local) of its parameter ``i``, ``["axes", [a]]`` when
    ``A`` is a string or a module-level constant, ``["const", NAME]`` for
    an imported ``*_AXIS`` constant."""
    out: Dict[str, List] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        fns = mod.enclosing_funcs(node)
        if not fns or fns[0].name in out:
            continue
        fn = fns[0]
        calls = [c for c in ast.walk(node.value) if _is_get_group(c)]
        names = {n.id for n in ast.walk(node.value)
                 if isinstance(n, ast.Name)}
        if names:
            calls += [a.value for a in ast.walk(fn)
                      if isinstance(a, ast.Assign)
                      and _is_get_group(a.value)
                      and any(isinstance(t, ast.Name) and t.id in names
                              for t in a.targets)]
        name, params = _call_params(fn, mod)
        for call in calls:
            how = _axis_source(call.args[0], params, mod)
            if how is not None:
                out[name] = how
                break
    return out


def _is_get_group(node) -> bool:
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and node.func.attr == "get_group" and bool(node.args)


def _axis_source(arg, params: List[str], mod: ModuleInfo):
    if isinstance(arg, ast.Subscript):
        arg = arg.value
    if isinstance(arg, ast.Name) and arg.id in params:
        return ["param", params.index(arg.id)]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return ["axes", [arg.value]]
    if isinstance(arg, ast.Name) and arg.id in mod.str_consts:
        return ["axes", [mod.str_consts[arg.id]]]
    if isinstance(arg, ast.Name) and arg.id.endswith("_AXIS"):
        return ["const", arg.id]
    return None


def mesh_ctor_ndim(call: ast.Call, mod: ModuleInfo) -> Optional[int]:
    """The number of dims of a ``init_device_mesh``/``DeviceMesh``
    construction when its literal dim names or shape say it, else
    None."""
    leaf = (call_name(call) or "").rsplit(".", 1)[-1]
    if leaf not in ("init_device_mesh", "DeviceMesh"):
        return None
    for kw in call.keywords:
        if kw.arg == "mesh_dim_names" \
                and isinstance(kw.value, (ast.Tuple, ast.List)):
            return len(kw.value.elts)
    if leaf == "init_device_mesh":
        shape = call.args[1] if len(call.args) > 1 else None
        for kw in call.keywords:
            if kw.arg == "mesh_shape":
                shape = kw.value
        if isinstance(shape, (ast.Tuple, ast.List)):
            return len(shape.elts)
    return None


def _mesh_factories(mod: ModuleInfo) -> Dict[str, int]:
    """def name -> mesh dims, for defs that return a mesh construction
    whose dims are literal."""
    dims: Dict[ast.AST, Set[int]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Return) \
                and isinstance(node.value, ast.Call):
            nd = mesh_ctor_ndim(node.value, mod)
            fns = mod.enclosing_funcs(node)
            if nd is not None and fns:
                dims.setdefault(fns[0], set()).add(nd)
    return {_call_params(fn, mod)[0]: nds.pop()
            for fn, nds in dims.items() if len(nds) == 1}


class PackageFacts:
    """Merged package-wide context, built from (relpath, facts) pairs."""

    def __init__(self, pairs: List[Tuple[str, Dict[str, Any]]]):
        from dmlp_tpu_torch.check.concurrency import ConcurrencyGraph
        self.pairs = sorted(pairs)
        metric_sites: List[Tuple[str, int, str, str]] = []
        conc_pairs: List[Tuple[str, Dict[str, Any]]] = []
        #: ``*_AXIS`` constant name -> axis, and the set of declared axes
        self.axis_consts: Dict[str, str] = {}
        self.declared: Set[str] = set()
        #: function names of obs/comms.py: the R104 table
        self.comms_models: Set[str] = set()
        self.group_helpers: Dict[str, List] = {}
        self.group_makers: Dict[str, List] = {}
        self.mesh_factories: Dict[str, int] = {}
        tables: Dict[str, Optional[Set[str]]] = {}
        saw_comms = False
        for rel, facts in self.pairs:
            rel_n = rel.replace("\\", "/")
            for seq, (name, kind) in enumerate(
                    facts.get("metric_sites", [])):
                metric_sites.append((rel, seq, name, kind))
            if facts.get("kind") == "cuda":
                continue
            conc_pairs.append((rel, facts.get("concurrency", {})))
            for name, val in facts.get("axis_consts", {}).items():
                self.axis_consts[name] = val
                self.declared.add(val)
            self.group_helpers.update(facts.get("group_helpers", {}))
            self.group_makers.update(facts.get("group_makers", {}))
            self.mesh_factories.update(facts.get("mesh_factories", {}))
            if rel_n.endswith("obs/comms.py"):
                saw_comms = True
                self.comms_models.update(facts.get("defs", []))
            for suffix, key in _TABLES.items():
                if rel_n.endswith(suffix):
                    tables.setdefault(suffix, set()).update(
                        _table_of(key, facts))
        #: literal metric name -> (kind, relpath) of its first
        #: (path, document-order)-ranked registration (the R602
        #: table).
        self.metric_first: Dict[str, Tuple[str, str]] = {}
        for rel, seq, name, kind in sorted(
                metric_sites, key=lambda s: (s[0], s[1])):
            self.metric_first.setdefault(name, (kind, rel))
        self.concurrency = ConcurrencyGraph(conc_pairs)
        # The single-file tables: the analyzed copy when the run holds
        # the file, else this package's own (its content folds into the
        # digest). None = unknown: the rule reading it stays silent.
        self._fallbacks: Dict[str, Optional[List[str]]] = {}
        for suffix, key in _TABLES.items():
            if suffix in tables:
                got = tables[suffix] or None
            else:
                got = _own_table(suffix, key)
                self._fallbacks[suffix] = sorted(got) if got else None
            setattr(self, _ATTRS[suffix], got)
        #: R1001's table: the MODEL_COLLECTIVE_KINDS keys that name a
        #: comms model (a key whose function is gone reconciles nothing)
        if saw_comms and self.hlo_models is not None:
            self.hlo_models = (self.hlo_models & self.comms_models) or None

    def digest(self) -> str:
        """Stable digest of the merged facts inputs — part of every
        per-file findings cache key (a change to any file's FACTS
        invalidates every file's findings; a facts-neutral edit only
        invalidates the edited file)."""
        blob = json.dumps([self.pairs, sorted(self._fallbacks.items())],
                          sort_keys=True, separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()


#: single-file table -> the facts key it is read from
_TABLES = {"obs/kernel_cost.py": "modeled_kernels",
           "engine/finalize.py": "eps_fns",
           "obs/hlo.py": "hlo_model_keys",
           "kernels/__init__.py": "launch_names"}
#: single-file table -> the PackageFacts attribute holding it
_ATTRS = {"obs/kernel_cost.py": "modeled_kernels",
          "engine/finalize.py": "eps_models",
          "obs/hlo.py": "hlo_models",
          "kernels/__init__.py": "launch_names"}


def _table_of(key: str, facts: Dict[str, Any]) -> List[str]:
    if key == "eps_fns":
        return [n for n in facts.get("defs", []) if "eps" in n]
    return list(facts.get(key, []))


def _own_table(suffix: str, key: str) -> Optional[Set[str]]:
    """The table from this package's own copy of ``suffix``."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(pkg, *suffix.split("/"))
    try:
        with open(path, encoding="utf-8") as f:
            mod = ModuleInfo(path, suffix, f.read())
    except (OSError, SyntaxError):
        return None
    return set(_table_of(key, module_facts(mod))) or None


def build_package_facts(modules: List) -> PackageFacts:
    """The no-cache path: facts straight from parsed modules."""
    return PackageFacts([(m.relpath, module_facts(m)) for m in modules])
