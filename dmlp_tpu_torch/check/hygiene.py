"""R0 — generic hygiene: the conservative ruff subset, reimplemented.

The JAX package's ``pyproject.toml`` ``[tool.ruff]`` config selects
exactly these rules for environments that have ruff; this family gives
the port the same gate without it:

- **R001** unused imports (F401) — skipped in ``__init__.py`` files,
  whose imports are re-exports by convention;
- **R002** bare ``except:`` (E722);
- **R003** mutable default arguments (B006) on every def (the JAX
  package leaves jitted defs to its recompile family, which has no
  torch analog);
- **R004** f-strings without placeholders (F541).
"""

from __future__ import annotations

import ast
from typing import Set

from dmlp_tpu_torch.check.common import ModuleInfo, call_name
from dmlp_tpu_torch.check.findings import Finding

ALLOW = "allow-hygiene"

_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)


def _used_names(mod: ModuleInfo) -> Set[str]:
    used: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Assign):
            # __all__ strings are uses (re-export surface)
            t = node.targets[0] if len(node.targets) == 1 else None
            if isinstance(t, ast.Name) and t.id == "__all__":
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Constant) \
                            and isinstance(sub.value, str):
                        used.add(sub.value)
    return used


def _noqa(mod: ModuleInfo, node: ast.AST) -> bool:
    """Honor ruff/flake8 ``# noqa`` on the statement's lines — the two
    allowlist dialects must agree or every re-export needs both."""
    lines = mod.source.splitlines()
    for ln in {getattr(node, "lineno", 0),
               getattr(node, "end_lineno", 0) or 0}:
        if 0 < ln <= len(lines) and "# noqa" in lines[ln - 1]:
            return True
    return False


class HygieneRule:
    def run(self, mod: ModuleInfo, add) -> None:
        self._unused_imports(mod, add)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None \
                    and not mod.allowed(node, ALLOW):
                add(Finding(
                    "R002", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), "bare-except",
                    "bare `except:` catches SystemExit/KeyboardInterrupt"
                    " too — name the exceptions"))
            elif isinstance(node, ast.JoinedStr) \
                    and not isinstance(mod.parents.get(node),
                                       ast.FormattedValue) \
                    and not any(isinstance(v, ast.FormattedValue)
                                for v in node.values) \
                    and not mod.allowed(node, ALLOW):
                add(Finding(
                    "R004", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), "fstring-no-placeholder",
                    "f-string without placeholders — drop the prefix"))
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                scope = (mod.scope_of(node) + "." + node.name).lstrip(".")
                for d in list(node.args.defaults) + [
                        d for d in node.args.kw_defaults if d is not None]:
                    mutable = isinstance(d, _MUTABLE_LITERALS) or (
                        isinstance(d, ast.Call) and call_name(d) in
                        ("list", "dict", "set", "bytearray"))
                    if mutable and not mod.allowed(d, ALLOW):
                        add(Finding(
                            "R003", mod.relpath, d.lineno, d.col_offset,
                            scope, "mutable-default",
                            f"mutable default argument on {node.name} "
                            f"is shared across calls"))

    def _unused_imports(self, mod: ModuleInfo, add) -> None:
        if mod.relpath.replace("\\", "/").endswith("__init__.py"):
            return
        used = _used_names(mod)
        for node in ast.walk(mod.tree):
            aliases = []
            if isinstance(node, ast.Import):
                aliases = [(a, (a.asname or a.name.split(".")[0]))
                           for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                aliases = [(a, (a.asname or a.name)) for a in node.names
                           if a.name != "*"]
            for alias, bound in aliases:
                if bound not in used and not mod.allowed(node, ALLOW) \
                        and not _noqa(mod, node):
                    add(Finding(
                        "R001", mod.relpath, node.lineno,
                        node.col_offset, mod.scope_of(node),
                        f"unused:{bound}",
                        f"import {bound!r} is never used"))
