"""Shared AST machinery for the rule modules.

One :class:`ModuleInfo` per source file carries everything every rule
family needs — the parsed tree, parent links, ``# check:`` directives by
line and the import table — so each rule module stays a thin visitor over
pre-digested facts.

The JAX package's copy also finds the *traced* defs (jit-decorated, or
passed into ``jax.jit``/``shard_map``), its recompile family's and its
traced-branch rule's input. Eager PyTorch has no traced bodies, so that
table is dropped here: a branch on a device tensor is a host sync
wherever it sits (:mod:`.hostsync`), and R003 applies to every def.

The CUDA sources (``kernels/*.cu``) are modules of their own kind,
:class:`CudaModule`: their text with comments blanked, and their
``// check:`` directives by line. Only the low-precision family (R8)
reads them.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

CHECK_COMMENT = "# check:"
CUDA_CHECK_COMMENT = "// check:"
#: file suffixes the analyzer loads as :class:`CudaModule`
CUDA_SUFFIXES = (".cu", ".cuh")


def parse_directives(source: str, marker: str = CHECK_COMMENT
                     ) -> Dict[int, Set[str]]:
    """``# check: <d1> <d2>`` comments by 1-based line.

    A directive silences findings on its own line; a *standalone*
    comment line (nothing but the comment) also covers the next
    non-comment line, so multi-line calls can carry their annotation
    above the statement.
    """
    out: Dict[int, Set[str]] = {}
    carry: Set[str] = set()
    for i, raw in enumerate(source.splitlines(), start=1):
        line = raw.strip()
        ds: Set[str] = set()
        pos = raw.find(marker)
        # Only real comments count: a '# check:' inside a string literal
        # has code (an opening quote) before the '#' on the line — the
        # cheap test below is "comment starts the stripped line or is
        # preceded by code"; string false-positives only ADD allow
        # directives, never hide real code, so the cheap test is enough.
        if pos >= 0:
            ds = set(raw[pos + len(marker):].split())
        if line.startswith(marker.split()[0]):
            carry |= ds
            continue
        if ds or carry:
            out[i] = ds | carry
        carry = set()
    return out


def dotted(node: ast.AST) -> Optional[str]:
    """``jax.lax.psum`` for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def is_docstring(node: ast.AST, parents: Dict[ast.AST, ast.AST]) -> bool:
    """Is this Constant-str the docstring expression of its scope?"""
    p = parents.get(node)
    if not (isinstance(p, ast.Expr) and isinstance(node, ast.Constant)
            and isinstance(node.value, str)):
        return False
    gp = parents.get(p)
    return isinstance(gp, (ast.Module, ast.FunctionDef,
                           ast.AsyncFunctionDef, ast.ClassDef)) \
        and gp.body and gp.body[0] is p


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


class ModuleInfo:
    """Parsed + pre-digested facts about one source file."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.directives = parse_directives(source)
        #: (line, directive) pairs that suppressed (or would suppress)
        #: a finding this run — consumed by ``--stale-allows``
        self.used_allows: Set[Tuple[int, str]] = set()
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.scopes: Dict[ast.AST, str] = {}
        self._link(self.tree, None, [])
        # import name -> dotted import source, as the import statement
        # spells it (``import a.b`` -> "a" -> "a.b"; R5's scope test)
        self.imports: Dict[str, str] = {}
        # import name -> what the name is bound to ("np" -> "numpy",
        # "F" -> "torch.nn.functional"; ``import torch.cuda`` binds
        # "torch" -> "torch"): the table call names canonicalize by
        self.aliases: Dict[str, str] = {}
        self._scan_imports()
        #: module-level ``NAME = "literal"`` string constants
        self.str_consts: Dict[str, str] = {}
        #: def name -> its first def node (any depth)
        self.defs: Dict[str, ast.AST] = {}
        self._scan_module_level()

    # -- structure ----------------------------------------------------------
    def _link(self, node: ast.AST, parent, scope: List[str]):
        if parent is not None:
            self.parents[node] = parent
        self.scopes[node] = ".".join(scope)
        push = isinstance(node, _FUNC_NODES + (ast.ClassDef,))
        for child in ast.iter_child_nodes(node):
            self._link(child, node,
                       scope + [node.name] if push else scope)

    def scope_of(self, node: ast.AST) -> str:
        return self.scopes.get(node, "")

    def enclosing_funcs(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first chain of enclosing function defs."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, _FUNC_NODES):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def _directive_lines(self, node: ast.AST) -> set:
        """Lines whose directives govern ``node``: the node's own span
        and its statement's first line. Line-above annotations are
        handled by parse_directives' standalone-comment carry (the
        directive lands ON the next code line) — consulting
        ``lineno - 1`` directly would let a TRAILING directive on one
        statement silently cover the next one too."""
        lines = {getattr(node, "lineno", 0),
                 getattr(node, "end_lineno", 0) or 0}
        stmt = self.parents.get(node)
        while stmt is not None and not isinstance(stmt, ast.stmt):
            stmt = self.parents.get(stmt)
        if stmt is not None:
            lines.add(stmt.lineno)
        return lines

    def allowed(self, node: ast.AST, directive: str) -> bool:
        """Is ``node`` governed by ``directive``? A match is recorded in
        :attr:`used_allows` — rules only consult this at would-be
        finding sites, so the recorded set is exactly the directives
        that still suppress something (the ``--stale-allows`` feed)."""
        hit = False
        for ln in self._directive_lines(node):
            if directive in self.directives.get(ln, ()):
                self.used_allows.add((ln, directive))
                hit = True
        return hit

    def allowed_value(self, node: ast.AST, prefix: str,
                      value: str) -> bool:
        """Directive match for the ``<prefix>=<value>`` form (e.g.
        ``allow-concurrency=R703``), also accepting the bare
        ``<prefix>`` as a family-wide waiver. Matches are recorded for
        stale-allow tracking like :meth:`allowed`."""
        if self.allowed(node, prefix):
            return True
        scoped = f"{prefix}={value}"
        hit = False
        for ln in self._directive_lines(node):
            if scoped in self.directives.get(ln, ()):
                self.used_allows.add((ln, scoped))
                hit = True
        return hit

    def directive_values(self, node: ast.AST, prefix: str) -> List[str]:
        """Values of ``<prefix>=<value>`` directives governing ``node``."""
        vals = []
        for ln in sorted(self._directive_lines(node)):
            for d in sorted(self.directives.get(ln, ())):
                if d.startswith(prefix + "="):
                    vals.append(d[len(prefix) + 1:])
        return vals

    # -- module-level tables -------------------------------------------------
    def _scan_module_level(self):
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and isinstance(stmt.value, ast.Constant) \
                    and isinstance(stmt.value.value, str):
                self.str_consts[stmt.targets[0].id] = stmt.value.value
        for node in ast.walk(self.tree):
            if isinstance(node, _FUNC_NODES):
                self.defs.setdefault(node.name, node)

    def _scan_imports(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    bound = a.asname or a.name.split(".")[0]
                    self.imports[bound] = a.name
                    self.aliases[bound] = (a.name if a.asname
                                           else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    self.imports[a.asname or a.name] = f"{mod}.{a.name}"
                    self.aliases[a.asname or a.name] = f"{mod}.{a.name}"

    def canon(self, name: Optional[str]) -> Optional[str]:
        """A dotted call name through the alias table (``dist.barrier``
        -> ``torch.distributed.barrier``); names not imported pass."""
        if not name:
            return None
        head, _, rest = name.partition(".")
        src = self.aliases.get(head)
        if src:
            return f"{src}.{rest}" if rest else src
        return name


def _blank_comments(source: str, strings: bool = True) -> str:
    """``source`` with C/C++ comments (and, with ``strings``, string
    literals) blanked to spaces (newlines kept, so offsets and line
    numbers hold)."""
    out = list(source)
    i, n = 0, len(source)
    while i < n:
        c = source[i]
        two = source[i:i + 2]
        if two == "//":
            j = source.find("\n", i)
            j = n if j < 0 else j
        elif two == "/*":
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            j = min(j + 1, n)
            if not strings:         # keep the literal, skip past it
                i = j
                continue
        else:
            i += 1
            continue
        for k in range(i, j):
            if out[k] != "\n":
                out[k] = " "
        i = j
    return "".join(out)


class CudaModule:
    """A CUDA source file: its text, the same text with comments and
    string literals blanked (``code``, what the rules match against),
    with comments alone blanked (``code_asm``: inline PTX lives in string
    literals), and its ``// check:`` directives by line, carried from a
    standalone comment line to the next code line as in Python files."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.code = _blank_comments(source)
        self.code_asm = _blank_comments(source, strings=False)
        self.directives = parse_directives(source, CUDA_CHECK_COMMENT)
        self.used_allows: Set[Tuple[int, str]] = set()
        starts = [0]
        for i, c in enumerate(source):
            if c == "\n":
                starts.append(i + 1)
        self._line_starts = starts

    def line_of(self, offset: int) -> int:
        """1-based line of a character offset."""
        import bisect
        return bisect.bisect_right(self._line_starts, offset)

    def allowed(self, line: int, directive: str) -> bool:
        if directive in self.directives.get(line, ()):
            self.used_allows.add((line, directive))
            return True
        return False

    def directive_values(self, line: int, prefix: str) -> List[str]:
        return sorted(d[len(prefix) + 1:]
                      for d in self.directives.get(line, ())
                      if d.startswith(prefix + "="))


def is_cuda_path(path: str) -> bool:
    return path.endswith(CUDA_SUFFIXES)
