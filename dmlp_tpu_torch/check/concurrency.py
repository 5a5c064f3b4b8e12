"""R7 — concurrency discipline for the threaded serving/telemetry surface.

The serving daemon's ThreadingTCPServer handlers, the MicroBatcher
consumer thread, the telemetry Sampler/export threads, the mesh
replica's heartbeat, the fleet router's prober and the retry-timeout
workers all share mutable state under ad-hoc locks. A lock-order
inversion or an unguarded field ships silently unless something checks
the discipline. This family is the static half (the runtime half is
:mod:`.racecheck`):

- **R701 — lock-order inversions.** The analyzer infers every lock the
  package creates (``self._lock = threading.Lock()`` / module-level
  ``Lock()``/``RLock()``/``Condition()``), builds the package-wide
  acquisition graph (``with self._lock:`` nesting plus ``acquire()``/
  ``release()`` regions, propagated one call-graph fixpoint through
  resolvable calls), and flags every acquisition edge that sits on a
  cycle — two locks taken in opposite orders anywhere in the package is
  a latent deadlock, even if no single run interleaves it. A nested
  re-acquisition of the same non-reentrant ``Lock`` is the degenerate
  self-cycle and flags too.
- **R702 — guarded-field discipline.** Per class, a field written under
  one of the class's locks anywhere (outside ``__init__``) is *guarded*;
  every other non-``__init__`` access that does not hold one of its
  guard locks flags, and so does ``return self._field`` of a guarded
  mutable (list/dict/set/deque) — handing out a reference exports the
  race to every caller.
- **R703 — blocking calls under a lock.** ``time.sleep``, socket sends/
  receives, ``urlopen``, subprocess waits, ``Thread.join``,
  ``Event.wait`` (on anything but the held lock), queue gets, CUDA
  fences (``torch.cuda.synchronize``, ``Event.synchronize``,
  ``Stream.synchronize``), device readbacks (``.item()``, ``.cpu()``,
  ``.tolist()``, the explicit ``sanitize.readback``) and
  ``torch.distributed`` collectives, ``barrier``, ``recv`` and
  ``Work.wait`` made while holding an inferred lock — directly or
  through a resolvable call chain — stall every thread contending for
  that lock (an injected straggler delay under the admission path's
  queue lock would freeze the whole daemon; a gloo collective under the
  mesh replica's lock waits on every other rank).
- **R704 — thread lifecycle.** A ``threading.Thread`` started without
  ``daemon=True`` and without a reachable ``join()`` on its binding
  wedges interpreter shutdown; every thread needs a stop path or an
  explicit daemon declaration.

Escape hatch: ``# check: allow-concurrency`` waives the family at a
site, ``# check: allow-concurrency=R70x`` one rule — every in-tree use
must state the invariant that makes the pattern safe (mirroring
``allow-host-sync``).

Known limits (deliberate; the runtime sanitizer covers the remainder):
call resolution is name/annotation-based (``self.attr.m()`` resolves
through ``__init__`` constructor assignments and parameter/variable
annotations; unresolvable receivers are skipped, never guessed), and
held-lock state does not flow into closures defined under a lock.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

from dmlp_tpu_torch.check.common import ModuleInfo, call_name, dotted
from dmlp_tpu_torch.check.findings import Finding

ALLOW = "allow-concurrency"

#: canonical factory -> lock kind ("lock" is non-reentrant)
LOCK_FACTORIES = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "cond",
}
#: canonical factory -> special receiver type marker
SPECIAL_FACTORIES = {
    "torch.cuda.Event": "@cuda_event",       # .wait() is device-side
    "torch.cuda.Stream": "@cuda_stream",
    "threading.Event": "@event",
    "threading.Thread": "@thread",
    "subprocess.Popen": "@proc",
    "queue.Queue": "@queue",
    "queue.SimpleQueue": "@queue",
}

#: canonical dotted names that block the calling thread outright
BLOCKING_DOTTED = {
    "time.sleep", "subprocess.run", "subprocess.check_output",
    "subprocess.check_call", "subprocess.call",
    "socket.create_connection", "urllib.request.urlopen",
    "torch.cuda.synchronize",
    "dmlp_tpu_torch.check.sanitize.readback",
}
#: ``torch.distributed`` calls that wait on every rank of the group
#: (blocking unless called with ``async_op=True``, which returns a Work)
COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
    "broadcast", "broadcast_object_list", "gather", "gather_object",
    "monitored_barrier", "recv", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "scatter", "scatter_object_list", "send",
}
#: attribute leaves that block regardless of receiver type
BLOCKING_LEAVES = {"sendall", "recv", "accept", "communicate", "urlopen",
                   "create_connection",
                   # CUDA fences: torch.cuda / Event / Stream synchronize
                   "synchronize",
                   # device readbacks of a tensor
                   "cpu", "tolist"}
#: attribute leaves that block only on typed receivers
_RECV_BLOCKING = {
    ("@event", "wait"), ("@thread", "join"), ("@proc", "wait"),
    ("@queue", "get"), ("@queue", "join"), ("@work", "wait"),
}

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_MUTABLE_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                  ast.DictComp, ast.SetComp)
_MUTABLE_CALLS = {"list", "dict", "set", "bytearray", "deque",
                  "collections.deque", "defaultdict",
                  "collections.defaultdict", "OrderedDict",
                  "collections.OrderedDict"}


def _canon(mod: ModuleInfo, name: Optional[str]) -> Optional[str]:
    """Canonicalize a dotted name through the module's import table
    (``rs_inject.fire`` -> ``dmlp_tpu_torch.resilience.inject.fire``)."""
    return mod.canon(name)


def _is_async(call: ast.Call) -> bool:
    return any(kw.arg == "async_op" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _ann_class(mod: ModuleInfo, ann: Optional[ast.AST]) -> Optional[str]:
    """Class dotted path from an annotation, unwrapping Optional[...] /
    ``X | None`` / string annotations."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.Subscript):
        base = dotted(ann.value)
        if base and base.rsplit(".", 1)[-1] == "Optional":
            inner = ann.slice
            return _ann_class(mod, inner)
        return None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        for side in (ann.left, ann.right):
            got = _ann_class(mod, side)
            if got:
                return got
        return None
    name = dotted(ann)
    if name in ("None", "bool", "int", "float", "str", "bytes"):
        return None
    return _canon(mod, name)


@dataclasses.dataclass
class _Event:
    """One interesting occurrence inside a function body, with the
    lockrefs held at that point. ``kind`` is "acquire" | "call" |
    "blocking"; ``target``: lockref / canonical call name / blocking
    descriptor. ``node`` is present only in live (run-time) scans."""

    kind: str
    target: str
    line: int
    held: Tuple[str, ...]
    node: Optional[ast.AST] = None


@dataclasses.dataclass
class _FieldAccess:
    field: str
    write: bool
    held: Tuple[str, ...]
    in_init: bool
    line: int
    escape: bool = False
    node: Optional[ast.AST] = None


@dataclasses.dataclass
class _ThreadSite:
    line: int
    daemon: bool
    binding: Optional[str]     # "self.x" / local name / None
    node: Optional[ast.AST] = None


class ModuleConcScan:
    """Everything R7 needs from one module: lock definitions, typed
    names, per-function event streams with held-lock context, per-class
    field accesses, and thread-construction sites. Used both to build
    the cacheable cross-module facts and (re-run live) to place
    findings."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        # local lockref -> kind; lockrefs: "Class.attr" | ":name" |
        # "fnkey:<name>" for function-locals
        self.locks: Dict[str, str] = {}
        # typed names: module globals / class attrs / special markers
        self.module_types: Dict[str, str] = {}
        self.class_attr_types: Dict[str, Dict[str, str]] = {}
        self.classes: List[str] = []
        # fnkey ("Class.method" | "fn") -> event list
        self.functions: Dict[str, List[_Event]] = {}
        self.fn_defs: Dict[str, ast.AST] = {}
        # class -> list of field accesses / mutable fields
        self.class_fields: Dict[str, List[_FieldAccess]] = {}
        self.mutable_fields: Dict[str, Set[str]] = {}
        self.thread_sites: List[_ThreadSite] = []
        self._scan()

    # -- prepass: lock/type tables -------------------------------------------
    def _factory_kind(self, value: ast.AST) -> Optional[str]:
        if not isinstance(value, ast.Call):
            return None
        name = _canon(self.mod, call_name(value))
        if name in LOCK_FACTORIES:
            return LOCK_FACTORIES[name]
        leaf = (name or "").rsplit(".", 1)[-1]
        if f"threading.{leaf}" in LOCK_FACTORIES \
                and leaf in ("Lock", "RLock", "Condition"):
            return LOCK_FACTORIES[f"threading.{leaf}"]
        return None

    def _special_type(self, value: ast.AST) -> Optional[str]:
        if not isinstance(value, ast.Call):
            return None
        name = _canon(self.mod, call_name(value))
        if name in SPECIAL_FACTORIES:
            return SPECIAL_FACTORIES[name]
        if (name or "").startswith("torch."):
            if name.startswith("torch.distributed.") and _is_async(value):
                return "@work"
            return None
        leaf = (name or "").rsplit(".", 1)[-1]
        for canon, marker in SPECIAL_FACTORIES.items():
            if canon.endswith("." + leaf):
                return marker
        return None

    def _value_type(self, value: ast.AST, env: Dict[str, str]
                    ) -> Optional[str]:
        """Type marker for an assignment RHS: special factory marker,
        constructed class's dotted path, or an alias's known type."""
        special = self._special_type(value)
        if special:
            return special
        if isinstance(value, ast.Call):
            name = _canon(self.mod, call_name(value))
            if name:
                leaf = name.rsplit(".", 1)[-1]
                if leaf[:1].isupper():         # constructor by convention
                    return name
            return None
        if isinstance(value, ast.Name):
            return env.get(value.id) or self.module_types.get(value.id)
        if isinstance(value, ast.Attribute):
            d = dotted(value)
            if d and d.startswith("self."):
                cls = env.get("@class")
                if cls:
                    return self.class_attr_types.get(cls, {}).get(d[5:])
        return None

    def _scan(self):
        mod = self.mod
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                name = stmt.targets[0].id
                kind = self._factory_kind(stmt.value)
                if kind:
                    self.locks[f":{name}"] = kind
                    continue
                t = self._value_type(stmt.value, {})
                if t:
                    self.module_types[name] = t
                # blocking alias: `_sleep = time.sleep`
                src = _canon(mod, dotted(stmt.value)) \
                    if isinstance(stmt.value, (ast.Attribute, ast.Name)) \
                    else None
                if src in BLOCKING_DOTTED:
                    self.module_types[name] = f"@blocking:{src}"
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                cls = _ann_class(mod, stmt.annotation)
                if cls:
                    self.module_types[stmt.target.id] = cls
        # classes: collect lock attrs + attr types from every method
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                self._scan_class_decls(node)
        # function event streams
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, _FUNC_NODES):
                        self._scan_function(sub, cls=node.name)
            elif isinstance(node, _FUNC_NODES):
                self._scan_function(node, cls=None)

    def _scan_class_decls(self, cnode: ast.ClassDef):
        cls = cnode.name
        self.classes.append(cls)
        attrs = self.class_attr_types.setdefault(cls, {})
        self.mutable_fields.setdefault(cls, set())
        for fn in cnode.body:
            if not isinstance(fn, _FUNC_NODES):
                continue
            params = {a.arg: _ann_class(self.mod, a.annotation)
                      for a in fn.args.args + fn.args.kwonlyargs}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    d = dotted(tgt)
                    if not d or not d.startswith("self.") \
                            or d.count(".") != 1:
                        continue
                    attr = d[5:]
                    kind = self._factory_kind(node.value)
                    if kind:
                        self.locks[f"{cls}.{attr}"] = kind
                        continue
                    t = self._value_type(node.value, {"@class": cls})
                    if t is None and isinstance(node.value, ast.Name):
                        t = params.get(node.value.id)
                    if t and attr not in attrs:
                        attrs[attr] = t
                    if fn.name == "__init__":
                        v = node.value
                        is_mut = isinstance(v, _MUTABLE_NODES) or (
                            isinstance(v, ast.Call)
                            and (_canon(self.mod, call_name(v))
                                 in _MUTABLE_CALLS
                                 or (call_name(v) or "").rsplit(
                                     ".", 1)[-1] in _MUTABLE_CALLS))
                        if is_mut:
                            self.mutable_fields[cls].add(attr)

    # -- lock-expression resolution ------------------------------------------
    def _lockref_of(self, expr: ast.AST, cls: Optional[str], fnkey: str,
                    env: Dict[str, str]) -> Optional[str]:
        d = dotted(expr)
        if d is None:
            return None
        if d.startswith("self.") and cls is not None and d.count(".") == 1:
            ref = f"{cls}.{d[5:]}"
            return ref if ref in self.locks else None
        if "." not in d:
            if f":{d}" in self.locks:
                return f":{d}"
            local = f"{fnkey}:{d}"
            return local if local in self.locks else None
        # typed receiver: x.attr where x's class is known
        head, _, attr = d.rpartition(".")
        recv_t = self._recv_type(head, cls, env)
        if recv_t and not recv_t.startswith("@"):
            return f"@ext:{recv_t}.{attr}"
        return None

    def _recv_type(self, head: str, cls: Optional[str],
                   env: Dict[str, str]) -> Optional[str]:
        if head == "self" and cls:
            return f"@local_class:{cls}"
        if head.startswith("self.") and cls and head.count(".") == 1:
            return self.class_attr_types.get(cls, {}).get(head[5:])
        if "." not in head:
            return env.get(head) or self.module_types.get(head)
        return None

    # -- function body walk ---------------------------------------------------
    def _scan_function(self, fn: ast.AST, cls: Optional[str]):
        fnkey = f"{cls}.{fn.name}" if cls else fn.name
        if fnkey in self.functions:      # duplicate def: first wins
            return
        events: List[_Event] = []
        self.functions[fnkey] = events
        self.fn_defs[fnkey] = fn
        env: Dict[str, str] = {"@class": cls or ""}
        for a in fn.args.args + fn.args.kwonlyargs:
            t = _ann_class(self.mod, a.annotation)
            if t:
                env[a.arg] = t
        accesses = (self.class_fields.setdefault(cls, [])
                    if cls else None)
        in_init = fn.name == "__init__"
        self._walk(list(fn.body), held=[], fnkey=fnkey, cls=cls, env=env,
                   events=events, accesses=accesses, in_init=in_init)

    def _walk(self, stmts, held: List[str], fnkey: str,
              cls: Optional[str], env: Dict[str, str],
              events: List[_Event], accesses, in_init: bool):
        for st in stmts:
            if isinstance(st, _FUNC_NODES + (ast.ClassDef,)):
                # a closure defined here runs LATER: its body gets a
                # fresh (empty) held context
                if isinstance(st, _FUNC_NODES):
                    self._walk(list(st.body), [], fnkey, cls, env,
                               events, accesses, in_init=False)
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                pushed = 0
                for item in st.items:
                    ref = self._lockref_of(item.context_expr, cls, fnkey,
                                           env)
                    self._exprs(item.context_expr, held, fnkey, cls, env,
                                events, accesses, in_init)
                    if ref is not None:
                        events.append(_Event("acquire", ref,
                                             item.context_expr.lineno,
                                             tuple(held),
                                             item.context_expr))
                        held.append(ref)
                        pushed += 1
                self._walk(list(st.body), held, fnkey, cls, env, events,
                           accesses, in_init)
                for _ in range(pushed):
                    held.pop()
                continue
            if isinstance(st, ast.Assign):
                # function-local lock / typed binding
                kind = self._factory_kind(st.value)
                if kind and len(st.targets) == 1 \
                        and isinstance(st.targets[0], ast.Name):
                    self.locks[f"{fnkey}:{st.targets[0].id}"] = kind
                t = self._value_type(st.value, env)
                if t and len(st.targets) == 1 \
                        and isinstance(st.targets[0], ast.Name):
                    env[st.targets[0].id] = t
                self._maybe_thread_site(st.value, st.targets, cls)
                self._exprs(st, held, fnkey, cls, env, events, accesses,
                            in_init)
                continue
            if isinstance(st, ast.Return):
                self._exprs(st, held, fnkey, cls, env, events, accesses,
                            in_init)
                if accesses is not None and st.value is not None:
                    d = dotted(st.value)
                    if d and d.startswith("self.") and d.count(".") == 1:
                        accesses.append(_FieldAccess(
                            d[5:], False, tuple(held), in_init,
                            st.lineno, escape=True, node=st))
                continue
            if isinstance(st, (ast.For, ast.AsyncFor)):
                self._exprs(st.iter, held, fnkey, cls, env, events,
                            accesses, in_init)
                self._target_writes(st.target, held, accesses, in_init)
                self._walk(list(st.body) + list(st.orelse), held, fnkey,
                           cls, env, events, accesses, in_init)
                continue
            if isinstance(st, (ast.If, ast.While)):
                self._exprs(st.test, held, fnkey, cls, env, events,
                            accesses, in_init)
                self._walk(list(st.body) + list(st.orelse), held, fnkey,
                           cls, env, events, accesses, in_init)
                continue
            if isinstance(st, ast.Try):
                body = list(st.body) + list(st.orelse) + list(st.finalbody)
                for h in st.handlers:
                    body += list(h.body)
                self._walk(body, held, fnkey, cls, env, events, accesses,
                           in_init)
                continue
            if isinstance(st, ast.Expr):
                # bare acquire()/release() region tracking
                call = st.value if isinstance(st.value, ast.Call) else None
                leaf = None
                if call is not None and isinstance(call.func,
                                                   ast.Attribute):
                    leaf = call.func.attr
                if leaf in ("acquire", "release") and call is not None:
                    ref = self._lockref_of(call.func.value, cls, fnkey,
                                           env)
                    if ref is not None:
                        if leaf == "acquire":
                            events.append(_Event(
                                "acquire", ref, st.lineno, tuple(held),
                                call))
                            held.append(ref)
                        elif ref in held:
                            held.remove(ref)
                        continue
                self._exprs(st, held, fnkey, cls, env, events, accesses,
                            in_init)
                continue
            self._maybe_thread_site(getattr(st, "value", None), [], cls)
            self._exprs(st, held, fnkey, cls, env, events, accesses,
                        in_init)

    def _target_writes(self, target: ast.AST, held, accesses, in_init):
        if accesses is None:
            return
        for sub in ast.walk(target):
            d = dotted(sub) if isinstance(sub, ast.Attribute) else None
            if d and d.startswith("self.") and d.count(".") == 1:
                accesses.append(_FieldAccess(
                    d[5:], True, tuple(held), in_init, sub.lineno,
                    node=sub))

    def _maybe_thread_site(self, value, targets, cls: Optional[str]):
        """Record ``threading.Thread(...)`` constructions (R704)."""
        calls = []
        if isinstance(value, ast.Call):
            calls.append((value, targets))
        for call, tgts in calls:
            inner = call
            # `threading.Thread(...).start()` — unwrap the chain
            if isinstance(call.func, ast.Attribute) \
                    and isinstance(call.func.value, ast.Call):
                inner = call.func.value
            if self._special_type(inner) != "@thread":
                continue
            daemon = any(
                kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in inner.keywords)
            binding = None
            for tgt in (tgts or []):
                d = dotted(tgt)
                if d:
                    binding = d
            self.thread_sites.append(_ThreadSite(
                inner.lineno, daemon, binding, node=inner))

    # -- expression-level events ----------------------------------------------
    def _blocking_desc(self, call: ast.Call, cls: Optional[str],
                       env: Dict[str, str],
                       held: List[str], fnkey: str) -> Optional[str]:
        name = call_name(call)
        canon = _canon(self.mod, name)
        if canon in BLOCKING_DOTTED:
            return canon
        if canon and canon.startswith("torch.distributed.") \
                and canon.rsplit(".", 1)[-1] in COLLECTIVES \
                and not _is_async(call):
            return canon
        if name and "." not in name:
            t = env.get(name) or self.module_types.get(name)
            if t and t.startswith("@blocking:"):
                return t[len("@blocking:"):]
        if isinstance(call.func, ast.Attribute):
            leaf = call.func.attr
            if leaf == "item" and not call.args and not call.keywords:
                return ".item()"
            if leaf in BLOCKING_LEAVES:
                return f".{leaf}()"
            recv = call.func.value
            d = dotted(recv)
            recv_t = None
            if d is not None:
                if d.startswith("self.") and cls and d.count(".") == 1:
                    attr = d[5:]
                    if f"{cls}.{attr}" in self.locks:
                        recv_t = f"@lockobj:{cls}.{attr}"
                    else:
                        recv_t = self.class_attr_types.get(
                            cls, {}).get(attr)
                elif "." not in d:
                    if f":{d}" in self.locks or f"{fnkey}:{d}" in self.locks:
                        recv_t = "@lockobj:" + (
                            f":{d}" if f":{d}" in self.locks
                            else f"{fnkey}:{d}")
                    else:
                        recv_t = env.get(d) or self.module_types.get(d)
            if recv_t:
                if recv_t.startswith("@lockobj:"):
                    # cond.wait on the HELD lock releases it: legal.
                    ref = recv_t[len("@lockobj:"):]
                    if leaf == "wait" and ref not in held:
                        return f"{d}.wait()"
                    return None
                for marker, bleaf in _RECV_BLOCKING:
                    if recv_t == marker and leaf == bleaf:
                        return f"{d}.{leaf}()"
        return None

    def _exprs(self, node: ast.AST, held: List[str], fnkey: str,
               cls: Optional[str], env: Dict[str, str],
               events: List[_Event], accesses, in_init: bool):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                desc = self._blocking_desc(sub, cls, env, held, fnkey)
                if desc is not None:
                    events.append(_Event("blocking", desc, sub.lineno,
                                         tuple(held), sub))
                    continue
                target = self._call_target(sub, cls, fnkey, env)
                if target is not None:
                    events.append(_Event("call", target, sub.lineno,
                                         tuple(held), sub))
            elif accesses is not None and isinstance(sub, ast.Attribute):
                d = dotted(sub)
                if d and d.startswith("self.") and d.count(".") == 1 \
                        and isinstance(sub.ctx, (ast.Store, ast.Del)):
                    accesses.append(_FieldAccess(
                        d[5:], True, tuple(held), in_init, sub.lineno,
                        node=sub))
                elif d and d.startswith("self.") and d.count(".") == 1:
                    accesses.append(_FieldAccess(
                        d[5:], False, tuple(held), in_init, sub.lineno,
                        node=sub))

    def _call_target(self, call: ast.Call, cls: Optional[str],
                     fnkey: str, env: Dict[str, str]) -> Optional[str]:
        """Partially-resolved callee: ``local:<fnkey>`` for same-module
        defs, ``ext:<dotted>`` for import/annotation-resolved targets,
        None when the receiver cannot be typed."""
        name = call_name(call)
        if name is None:
            return None
        if "." not in name:
            if name in self.functions or any(
                    isinstance(n, _FUNC_NODES) and n.name == name
                    for n in self.mod.tree.body):
                return f"local:{name}"
            src = self.mod.imports.get(name)
            if src:
                return f"ext:{src}"
            if name in self.module_types \
                    and not self.module_types[name].startswith("@"):
                # ClassName(...) constructor of a typed name
                return None
            if name[:1].isupper():
                canon = _canon(self.mod, name)
                if canon and canon != name:
                    return f"ext:{canon}.__init__"
                return f"local:{name}.__init__"
            return None
        head, _, leaf = name.rpartition(".")
        if head == "self" and cls:
            return f"local:{cls}.{leaf}"
        recv_t = self._recv_type(head, cls, env)
        if recv_t:
            if recv_t.startswith("@local_class:"):
                return f"local:{recv_t.split(':', 1)[1]}.{leaf}"
            if not recv_t.startswith("@"):
                if "." not in recv_t and recv_t in self.classes:
                    return f"local:{recv_t}.{leaf}"
                return f"ext:{recv_t}.{leaf}"
            return None
        canon = _canon(self.mod, name)
        if canon and canon != name:
            return f"ext:{canon}"
        return None

    # -- cacheable facts ------------------------------------------------------
    def facts(self) -> Dict[str, Any]:
        """JSON-safe cross-module facts (no AST nodes — and no line
        numbers: facts must be stable under pure line shifts so a
        comment edit in a lock-bearing file does not invalidate every
        OTHER file's cached verdict). Duplicate events collapse."""
        fns: Dict[str, List[List[Any]]] = {}
        for fnkey, evs in self.functions.items():
            seen = set()
            rows = []
            for e in evs:
                sig = (e.kind, e.target, e.held)
                if sig in seen:
                    continue
                seen.add(sig)
                rows.append([e.kind, e.target, list(e.held)])
            fns[fnkey] = rows
        return {
            "locks": dict(self.locks),
            "classes": list(self.classes),
            "functions": fns,
        }


# -- global graph -------------------------------------------------------------

def _module_dotted(relpath: str) -> str:
    rel = relpath.replace("\\", "/")
    if rel.endswith(".py"):
        rel = rel[:-3]
    if rel.endswith("/__init__"):
        rel = rel[:-len("/__init__")]
    return rel.replace("/", ".")


class ConcurrencyGraph:
    """Package-wide lock graph built from per-module facts: resolves
    cross-module call targets, closes may-acquire/may-block over the
    call graph, and computes the cyclic (inversion) edge set."""

    def __init__(self, fact_pairs: List[Tuple[str, Dict[str, Any]]]):
        self.lock_kinds: Dict[str, str] = {}
        self.class_home: Dict[str, str] = {}       # dotted class -> relpath
        #: fnref -> [(kind, target, held lockrefs)] (line-free facts)
        self.fn_events: Dict[str, List[Tuple[str, str, List[str]]]] = {}
        self._mod_by_dotted: Dict[str, str] = {}
        for rel, facts in fact_pairs:
            md = _module_dotted(rel)
            self._mod_by_dotted[md] = rel
            for ref, kind in facts.get("locks", {}).items():
                self.lock_kinds[self._g(rel, ref)] = kind
            for cls in facts.get("classes", []):
                self.class_home[f"{md}.{cls}"] = rel
            for fnkey, evs in facts.get("functions", {}).items():
                self.fn_events[f"{rel}::{fnkey}"] = [
                    (k, t, h) for k, t, h in evs]
        self._close()

    @staticmethod
    def _g(rel: str, ref: str) -> str:
        return f"{rel}::{ref}"

    def resolve_lock(self, rel: str, ref: str) -> Optional[str]:
        if ref.startswith("@ext:"):
            dotted_attr = ref[len("@ext:"):]
            cls_path, _, attr = dotted_attr.rpartition(".")
            home = self.class_home.get(cls_path)
            if home is None:
                return None
            cls = cls_path.rsplit(".", 1)[-1]
            g = self._g(home, f"{cls}.{attr}")
            return g if g in self.lock_kinds else None
        g = self._g(rel, ref)
        return g if g in self.lock_kinds else None

    def resolve_call(self, rel: str, target: str) -> Optional[str]:
        kind, _, name = target.partition(":")
        if kind == "local":
            ref = f"{rel}::{name}"
            return ref if ref in self.fn_events else None
        # ext: dotted — try module fn, then class method/constructor
        parts = name.split(".")
        for split in range(len(parts) - 1, 0, -1):
            mod_dotted = ".".join(parts[:split])
            rest = ".".join(parts[split:])
            home = self._mod_by_dotted.get(mod_dotted)
            if home is None:
                continue
            ref = f"{home}::{rest}"
            if ref in self.fn_events:
                return ref
        # class path: a.b.Class.m -> module a.b, fnkey Class.m handled
        # above; constructor a.b.Class -> Class.__init__
        home = None
        cls_path = name
        if cls_path in self.class_home:
            home = self.class_home[cls_path]
            cls = cls_path.rsplit(".", 1)[-1]
            ref = f"{home}::{cls}.__init__"
            return ref if ref in self.fn_events else None
        return None

    def _close(self):
        """Fixpoint may-acquire / may-block over the resolved call
        graph, then the edge set + cycle detection."""
        self.may_acquire: Dict[str, Set[str]] = {}
        self.may_block: Dict[str, Set[str]] = {}
        calls: Dict[str, Set[str]] = {}
        for fnref, evs in self.fn_events.items():
            rel = fnref.split("::", 1)[0]
            acq, blk, outs = set(), set(), set()
            for k, t, _h in evs:
                if k == "acquire":
                    g = self.resolve_lock(rel, t)
                    if g:
                        acq.add(g)
                elif k == "blocking":
                    blk.add(t)
                elif k == "call":
                    c = self.resolve_call(rel, t)
                    if c:
                        outs.add(c)
            self.may_acquire[fnref] = acq
            self.may_block[fnref] = blk
            calls[fnref] = outs
        for _ in range(20):                      # fixpoint (shallow)
            changed = False
            for fnref, outs in calls.items():
                for c in outs:
                    na = self.may_acquire[c] - self.may_acquire[fnref]
                    if na:
                        self.may_acquire[fnref] |= na
                        changed = True
                    nb = self.may_block[c] - self.may_block[fnref]
                    if nb:
                        self.may_block[fnref] |= nb
                        changed = True
            if not changed:
                break
        # edges: held lock -> acquired lock, with one example function
        # as the counter-site (facts carry no line numbers — stability
        # under line shifts is what keeps the cache per-file)
        self.edge_sites: Dict[Tuple[str, str], str] = {}
        self.self_edges: Dict[str, str] = {}
        for fnref, evs in self.fn_events.items():
            rel = fnref.split("::", 1)[0]
            for k, t, h in evs:
                helds = [self.resolve_lock(rel, x) for x in h]
                helds = [x for x in helds if x]
                if not helds:
                    continue
                acquired: Set[str] = set()
                if k == "acquire":
                    g = self.resolve_lock(rel, t)
                    if g:
                        acquired.add(g)
                elif k == "call":
                    c = self.resolve_call(rel, t)
                    if c:
                        acquired |= self.may_acquire[c]
                for m in acquired:
                    for hl in helds:
                        if hl == m:
                            if self.lock_kinds.get(m) == "lock" \
                                    and k == "acquire":
                                self.self_edges.setdefault(m, fnref)
                            continue
                        self.edge_sites.setdefault((hl, m), fnref)
        self.cyclic_edges = self._cyclic(set(self.edge_sites))

    @staticmethod
    def _cyclic(edges: Set[Tuple[str, str]]) -> Set[Tuple[str, str]]:
        """Edges inside a strongly connected component of size >= 2."""
        adj: Dict[str, Set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        stack: List[str] = []
        comp: Dict[str, int] = {}
        counter = [0]
        ncomp = [0]

        def strongconnect(v0: str):
            work = [(v0, iter(sorted(adj[v0])))]
            index[v0] = low[v0] = counter[0]
            counter[0] += 1
            stack.append(v0)
            on.add(v0)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    if w in on:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        comp[w] = ncomp[0]
                        if w == v:
                            break
                    ncomp[0] += 1

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)
        sizes: Dict[int, int] = {}
        for v, c in comp.items():
            sizes[c] = sizes.get(c, 0) + 1
        return {(a, b) for a, b in edges
                if comp.get(a) == comp.get(b) and sizes.get(comp.get(a),
                                                            0) >= 2}


def _short(lockref: str) -> str:
    """Human form of a global lockref for messages."""
    rel, _, ref = lockref.partition("::")
    return f"{rel}:{ref.lstrip(':')}"


class ConcurrencyRule:
    """R701-R704 over each module, against the package-wide graph."""

    def __init__(self, graph: ConcurrencyGraph):
        self.graph = graph

    # -- driver ---------------------------------------------------------------
    def run(self, mod: ModuleInfo, add) -> None:
        scan = ModuleConcScan(mod)
        rel = mod.relpath
        g = self.graph
        for fnkey, events in scan.functions.items():
            for e in events:
                helds = [(x, g.resolve_lock(rel, x)) for x in e.held]
                helds = [(loc, glo) for loc, glo in helds if glo]
                if not helds:
                    continue
                if e.kind == "blocking":
                    self._r703(mod, e, e.target, helds, add,
                               via=None)
                elif e.kind == "call":
                    target = g.resolve_call(rel, e.target)
                    if target is None:
                        continue
                    blocks = g.may_block.get(target, set())
                    if blocks:
                        self._r703(mod, e, sorted(blocks)[0], helds, add,
                                   via=target)
                    for m in sorted(g.may_acquire.get(target, set())):
                        self._r701(mod, e, helds, m, add, via=target)
                elif e.kind == "acquire":
                    m = g.resolve_lock(rel, e.target)
                    if m is None:
                        continue
                    if any(glo == m for _loc, glo in helds) \
                            and g.lock_kinds.get(m) == "lock":
                        if not mod.allowed_value(e.node, ALLOW, "R701"):
                            add(Finding(
                                "R701", rel, e.line,
                                getattr(e.node, "col_offset", 0),
                                mod.scope_of(e.node), f"self:{m}",
                                f"nested acquisition of non-reentrant "
                                f"lock {_short(m)} — guaranteed "
                                f"self-deadlock (use RLock or "
                                f"restructure)"))
                        continue
                    self._r701(mod, e, helds, m, add, via=None)
        self._r702(mod, scan, add)
        self._r704(mod, scan, add)

    def _r701(self, mod, e: _Event, helds, m: str, add, via):
        for _loc, hl in helds:
            if hl == m:
                continue
            if (hl, m) in self.graph.cyclic_edges:
                counter = self.graph.edge_sites.get((m, hl))
                where = (f" (reverse order in {counter})"
                         if counter else "")
                via_s = f" via {via.split('::')[-1]}()" if via else ""
                if mod.allowed_value(e.node, ALLOW, "R701"):
                    continue
                add(Finding(
                    "R701", mod.relpath, e.line,
                    getattr(e.node, "col_offset", 0),
                    mod.scope_of(e.node), f"{hl}->{m}",
                    f"acquiring {_short(m)}{via_s} while holding "
                    f"{_short(hl)} inverts the package's lock order"
                    f"{where} — potential deadlock"))

    def _r703(self, mod, e: _Event, desc: str, helds, add, via):
        if mod.allowed_value(e.node, ALLOW, "R703"):
            return
        hl = helds[-1][1]
        via_s = f" via {via.split('::')[-1]}()" if via else ""
        add(Finding(
            "R703", mod.relpath, e.line,
            getattr(e.node, "col_offset", 0), mod.scope_of(e.node),
            f"block:{desc}",
            f"blocking call {desc}{via_s} while holding {_short(hl)} — "
            f"every thread contending for the lock stalls behind it; "
            f"move the call outside the guard or annotate "
            f"`# check: allow-concurrency=R703` with the invariant"))

    # -- R702 -----------------------------------------------------------------
    def _r702(self, mod: ModuleInfo, scan: ModuleConcScan, add) -> None:
        for cls, accesses in scan.class_fields.items():
            class_locks = {r for r in scan.locks
                           if r.startswith(f"{cls}.")}
            if not class_locks:
                continue
            guards: Dict[str, Set[str]] = {}
            for a in accesses:
                if a.write and not a.in_init and a.held:
                    locks_held = {h for h in a.held if h in scan.locks}
                    if locks_held:
                        guards.setdefault(a.field, set()).update(
                            locks_held)
            for a in accesses:
                if a.in_init or a.field not in guards:
                    continue
                if a.field in scan.locks or f"{cls}.{a.field}" \
                        in scan.locks:
                    continue
                gset = guards[a.field]
                if a.escape and a.field in scan.mutable_fields.get(
                        cls, set()):
                    if not mod.allowed_value(a.node, ALLOW, "R702"):
                        add(Finding(
                            "R702", mod.relpath, a.line,
                            getattr(a.node, "col_offset", 0),
                            mod.scope_of(a.node),
                            f"escape:{cls}.{a.field}",
                            f"returning guarded mutable self."
                            f"{a.field} by reference escapes the "
                            f"{'/'.join(sorted(gset))} guard — return "
                            f"a copy (list(...)/dict(...))"))
                    continue
                if set(a.held) & gset:
                    continue
                if mod.allowed_value(a.node, ALLOW, "R702"):
                    continue
                kind = "write" if a.write else "read"
                add(Finding(
                    "R702", mod.relpath, a.line,
                    getattr(a.node, "col_offset", 0),
                    mod.scope_of(a.node),
                    f"{kind}:{cls}.{a.field}",
                    f"{kind} of self.{a.field} outside its guard "
                    f"{'/'.join(sorted(gset))} (every other write "
                    f"holds it) — take the lock, or annotate "
                    f"`# check: allow-concurrency=R702` with the "
                    f"invariant that makes the race benign"))

    # -- R704 -----------------------------------------------------------------
    def _r704(self, mod: ModuleInfo, scan: ModuleConcScan, add) -> None:
        src = mod.source
        for site in scan.thread_sites:
            if site.daemon:
                continue
            if site.binding:
                leaf = site.binding.rsplit(".", 1)[-1]
                if f"{leaf}.join(" in src:
                    continue
            if mod.allowed_value(site.node, ALLOW, "R704"):
                continue
            add(Finding(
                "R704", mod.relpath, site.line,
                getattr(site.node, "col_offset", 0),
                mod.scope_of(site.node), "thread-lifecycle",
                "thread started without daemon=True and without a "
                "reachable join()/stop path — it can wedge interpreter "
                "shutdown; declare daemon=True or keep a joined handle"))


def module_conc_facts(mod: ModuleInfo) -> Dict[str, Any]:
    """The cacheable per-file R7 facts (locks + event streams)."""
    return ModuleConcScan(mod).facts()
