"""R8 — the low-precision contract, over the CUDA sources and torch code.

The bf16 first pass (``precision="bf16"``) is exact only because of a
two-part contract: every product keeps its accumulator in f32 (a bf16
or f16 accumulator, or TF32 inputs, would void the
:func:`~dmlp_tpu_torch.engine.finalize.lowp_eps` bound entirely), and
every site that casts operands below f32 declares *which* analytic
error bound covers the cast, so the window inflation can be audited
from the source alone. Both halves are silent to violate — a half
accumulator still returns plausible neighbours, just no longer
byte-identical ones.

Scope: the hand-written kernels, ``kernels/*.cu``, and the wrappers and
plain versions that stand in for the reference's ``ops/pallas_*.py``:
``ops/{extract,fused,dist_segmin,distance}.py``. The TF32 switch is
checked in every module of the package.

- **R801** a low-precision accumulator. In CUDA: a ``__half``,
  ``__nv_bfloat16``, ``half2`` or ``__nv_bfloat162`` value accumulated
  with ``+=``/``-=``, the half arithmetic intrinsics (``__hadd``,
  ``__hfma``, ``__hmul`` and their ``2`` forms), or an ``mma``/``wmma``
  whose accumulator fragment is f16/bf16. In torch: a product
  (``@``, ``mm``, ``matmul``, ``bmm``, ``einsum``, ``linear``) on an
  operand cast below f32 and not promoted back, without
  ``out_dtype=torch.float32``. Anywhere in the package: turning TF32
  on (``allow_tf32 = True``, ``fp32_precision = "tf32"``,
  ``set_float32_matmul_precision("high"|"medium")``) — IEEE f32 is
  the contract the eps bounds are derived for.
- **R802** a cast below f32 (``.to(torch.bfloat16|torch.float16)``,
  ``.bfloat16()``, ``.half()``; ``__float2bfloat16*``,
  ``__float2half*``, and calls of a device function that wraps one)
  without a governing ``# check: lowp-eps=<fn>`` (``// check:`` in a
  ``.cu`` file) naming the bound that covers it.
- **R803** a ``lowp-eps=<fn>`` naming a function ``engine/finalize.py``
  does not define.

``# check: allow-lowprec`` (``// check: allow-lowprec``) waives a site.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from typing import List, Optional, Set

from dmlp_tpu_torch.check.common import (CudaModule, ModuleInfo, call_name,
                                         dotted)
from dmlp_tpu_torch.check.findings import Finding

ALLOW = "allow-lowprec"
EPS_DIRECTIVE = "lowp-eps"

#: the torch modules the product and cast rules read
TORCH_SCOPE = ("dmlp_tpu_torch/ops/extract.py", "dmlp_tpu_torch/ops/fused.py",
               "dmlp_tpu_torch/ops/dist_segmin.py",
               "dmlp_tpu_torch/ops/distance.py")
CUDA_SCOPE = ("dmlp_tpu_torch/kernels/*.cu", "dmlp_tpu_torch/kernels/*.cuh")

#: torch dtypes below f32 (floating: the operand types of a product)
LOW_DTYPES = ("bfloat16", "float16", "half", "float8_e4m3fn",
              "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz")
_LOW_METHODS = ("bfloat16", "half")
_PRODUCT_CALLS = ("mm", "matmul", "bmm", "einsum", "linear", "addmm",
                  "baddbmm", "addbmm", "mv")

# -- CUDA patterns ------------------------------------------------------------
_HALF_TYPES = r"(?:__half2?|half2?|__nv_bfloat162?|nv_bfloat162?)"
_HALF_DECL = re.compile(
    r"\b" + _HALF_TYPES + r"\s*[*&]?\s*(?:__restrict__\s+)?(\w+)\s*"
    r"(?=[;=,\[)])")
_HALF_ARITH = re.compile(r"\b(__h(?:add|fma|mul|sub)2?(?:_rn|_sat)?)\s*\(")
_WMMA_HALF_ACC = re.compile(
    r"fragment\s*<\s*(?:nvcuda\s*::\s*)?(?:wmma\s*::\s*)?accumulator\s*,"
    r"[^>]*\b(half|__half|__nv_bfloat16|nv_bfloat16)\s*>")
_MMA_HALF_ACC = re.compile(
    r"\bw?g?mma(?:[.\w]*?)\.m\d+n\d+k\d+(?:\.(?:row|col))*\.(f16|bf16)\b")
_CUDA_CAST = re.compile(r"\b(__float2bfloat16\w*|__float2half\w*|"
                        r"__floats2bfloat162\w*|__floats2half2\w*|"
                        r"__float22bfloat162\w*|__float22half2\w*)\s*\(")


def _match(rel: str, patterns) -> bool:
    rel = rel.replace("\\", "/")
    return any(fnmatch.fnmatch(rel, p) or fnmatch.fnmatch(rel, "*/" + p)
               for p in patterns)


def _dtype_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    name = dotted(node)
    return name.rsplit(".", 1)[-1] if name else None


def low_cast_dtype(call: ast.Call) -> Optional[str]:
    """The sub-f32 dtype a torch call casts to, else None:
    ``x.to(torch.bfloat16)`` (any positional or ``dtype=``),
    ``x.type(torch.half)``, ``x.bfloat16()``, ``x.half()``."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in _LOW_METHODS and not call.args:
        return attr
    if attr not in ("to", "type"):
        return None
    for cand in list(call.args) + [kw.value for kw in call.keywords
                                   if kw.arg == "dtype"]:
        dt = _dtype_name(cand)
        if dt in LOW_DTYPES:
            return dt
    return None


class LowPrecRule:
    #: the analyzer runs this rule over CUDA modules too
    cuda = True

    def __init__(self, facts):
        self._eps_fns = facts.eps_models

    def run(self, mod, add) -> None:
        if isinstance(mod, CudaModule):
            if _match(mod.relpath, CUDA_SCOPE):
                self._run_cuda(mod, add)
            return
        self._check_tf32(mod, add)
        if _match(mod.relpath, TORCH_SCOPE):
            self._run_torch(mod, add)

    # -- the eps annotation (both languages) ----------------------------------
    def _check_eps(self, mod, where, line, col, scope, what, declared,
                   add) -> None:
        allowed = (lambda: mod.allowed(where, ALLOW))
        if not declared:
            if allowed():
                return
            add(Finding(
                "R802", mod.relpath, line, col, scope,
                f"lowp-cast-unbounded:{what}",
                f"cast `{what}` below f32 without a `check: lowp-eps=<fn>` "
                f"annotation naming the analytic bound that covers the "
                f"precision loss (engine/finalize.py)"))
            return
        if self._eps_fns is None:
            return            # finalize.py table unknown: stay silent
        for fn in declared:
            if fn in self._eps_fns or allowed():
                continue
            add(Finding(
                "R803", mod.relpath, line, col, scope,
                f"lowp-eps-unknown:{fn}",
                f"`lowp-eps={fn}` names a bound engine/finalize.py does "
                f"not define — the annotation must reference a real eps "
                f"function so the inflation it promises can be audited"))

    # -- torch ----------------------------------------------------------------
    def _check_tf32(self, mod: ModuleInfo, add) -> None:
        for node in ast.walk(mod.tree):
            hit = None
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Constant):
                for t in node.targets:
                    name = dotted(t) or ""
                    if name.endswith("allow_tf32") \
                            and node.value.value is True:
                        hit = f"{name} = True"
                    elif name.endswith("fp32_precision") \
                            and node.value.value == "tf32":
                        hit = f"{name} = 'tf32'"
            elif isinstance(node, ast.Call) and (call_name(node) or "") \
                    .endswith("set_float32_matmul_precision") \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value in ("high", "medium"):
                hit = f"set_float32_matmul_precision({node.args[0].value!r})"
            if hit is None or mod.allowed(node, ALLOW):
                continue
            add(Finding(
                "R801", mod.relpath, node.lineno, node.col_offset,
                mod.scope_of(node), "tf32",
                f"`{hit}` turns TF32 on: float32 products would round "
                f"their inputs to 10 mantissa bits, outside every eps "
                f"bound (IEEE f32 is the contract)"))

    def _run_torch(self, mod: ModuleInfo, add) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                dt = low_cast_dtype(node)
                if dt is not None:
                    self._check_eps(
                        mod, node, node.lineno, node.col_offset,
                        mod.scope_of(node), dt,
                        mod.directive_values(node, EPS_DIRECTIVE), add)
            operands = _product_operands(node)
            if operands is None or _has_f32_out(node):
                continue
            fn = (mod.enclosing_funcs(node) or [None])[0]
            low = [o for o in operands if self._is_low(o, fn)]
            if low and not mod.allowed(node, ALLOW):
                add(Finding(
                    "R801", mod.relpath, node.lineno, node.col_offset,
                    mod.scope_of(node), "product-low-operand",
                    "product on an operand cast below f32 and not "
                    "promoted back: its result rounds to that dtype; "
                    "promote the operands (`.float()`) or pass "
                    "`out_dtype=torch.float32`"))

    def _is_low(self, expr, fn) -> bool:
        if isinstance(expr, ast.Call):
            return low_cast_dtype(expr) is not None
        if isinstance(expr, ast.Name) and fn is not None:
            values = [n.value for n in ast.walk(fn)
                      if isinstance(n, ast.Assign) and any(
                          isinstance(t, ast.Name) and t.id == expr.id
                          for t in n.targets)]
            return bool(values) and all(
                isinstance(v, ast.Call) and low_cast_dtype(v) is not None
                for v in values)
        return False

    # -- CUDA -----------------------------------------------------------------
    def _run_cuda(self, mod: CudaModule, add) -> None:
        code = mod.code
        half_vars = {m.group(1) for m in _HALF_DECL.finditer(code)}
        acc = []
        for v in sorted(half_vars):
            pat = re.compile(r"\b" + re.escape(v) + r"\s*(?:\[[^\]]*\]\s*)?"
                             r"[+\-]=")
            acc += [(m.start(), f"{v} +=") for m in pat.finditer(code)]
        acc += [(m.start(), m.group(1)) for m in _HALF_ARITH.finditer(code)]
        acc += [(m.start(), f"wmma accumulator {m.group(1)}")
                for m in _WMMA_HALF_ACC.finditer(code)]
        acc += [(m.start(), f"mma accumulator .{m.group(1)}")
                for m in _MMA_HALF_ACC.finditer(mod.code_asm)]
        for off, what in sorted(acc):
            line = mod.line_of(off)
            if mod.allowed(line, ALLOW):
                continue
            add(Finding(
                "R801", mod.relpath, line, 0, "",
                f"half-accumulator:{what.split()[0]}",
                f"`{what}` accumulates below f32 — the products' sum "
                f"rounds at every step, voiding the lowp_eps bound; keep "
                f"the accumulator in float"))
        for line, what in _cuda_cast_sites(code, mod):
            self._check_eps(mod, line, line, 0, "", what,
                            mod.directive_values(line, EPS_DIRECTIVE), add)


def _cuda_cast_sites(code: str, mod: CudaModule) -> List[tuple]:
    """(line, what) of every cast below f32 in a CUDA source: the cast
    intrinsics, and the calls of a function whose body holds one."""
    sites = [(mod.line_of(m.start()), m.group(1))
             for m in _CUDA_CAST.finditer(code)]
    wrappers: Set[str] = set()
    spans = []
    for m in re.finditer(r"\b(\w+)\s*\([^;{}]*\)\s*(?:const\s*)?\{", code):
        name = m.group(1)
        if name in ("if", "for", "while", "switch", "return", "sizeof"):
            continue
        end = _block_end(code, m.end() - 1)
        if _CUDA_CAST.search(code, m.end(), end):
            wrappers.add(name)
            spans.append((m.start(), end))
    starts = {lo for lo, _hi in spans}
    for name in sorted(wrappers):
        for m in re.finditer(r"\b" + re.escape(name) + r"\s*\(", code):
            if m.start() not in starts:         # not its own definition
                sites.append((mod.line_of(m.start()), f"{name}()"))
    return sorted(set(sites))


def _block_end(code: str, brace: int) -> int:
    depth = 0
    for i in range(brace, len(code)):
        if code[i] == "{":
            depth += 1
        elif code[i] == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(code)


def _product_operands(node) -> Optional[List[ast.AST]]:
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
        return [node.left, node.right]
    if not isinstance(node, ast.Call):
        return None
    name = call_name(node) or ""
    leaf = name.rsplit(".", 1)[-1]
    if leaf not in _PRODUCT_CALLS:
        return None
    args = list(node.args)
    if leaf == "einsum":
        return args[1:]
    if leaf in ("addmm", "baddbmm", "addbmm"):
        return args[1:3]
    if isinstance(node.func, ast.Attribute) and leaf != "linear" \
            and not name.startswith(("torch.", "F.")):
        return [node.func.value] + args[:1]     # x.mm(y)
    return args[:2]


def _has_f32_out(call) -> bool:
    if not isinstance(call, ast.Call):
        return False
    for kw in call.keywords:
        if kw.arg in ("out_dtype", "dtype") \
                and _dtype_name(kw.value) in ("float32", "float"):
            return True
    return False
