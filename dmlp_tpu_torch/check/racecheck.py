"""Runtime race sanitizer — the dynamic half of check family R7.

``DMLP_TPU_RACECHECK=1`` (or an explicit :func:`install`) wraps the
``threading.Lock`` / ``RLock`` / ``Condition`` factories so every lock
created afterwards is *tracked*: each acquisition records the
per-thread held stack and feeds a process-global acquisition-order
graph. Two violation classes are detected as they happen:

- **inversion** — lock B acquired while holding A after some earlier
  acquisition (any thread) took A while holding B. This is the runtime
  proof of check rule R701: the static rule flags *potential* cycles,
  this records the orders a real run actually exhibited.
- **blocking_under_lock** — an instrumented blocking primitive
  (``time.sleep``, ``threading.Thread.join``) entered while the calling
  thread holds any tracked lock (runtime R703).

Lock identity is the **creation site** (``file:line`` of the factory
call), so every instance of ``Registry._lock`` shares one node — the
same granularity the static analyzer reasons at, which keeps the order
graph finite and the reports readable.

The instrumentation is for the stress harness
(``python -m dmlp_tpu_torch.check.race_stress``) — NOT for production
serving: acquire/release pay a dict update each. :func:`report` returns the verdict;
``DMLP_TPU_RACECHECK_OUT=<path>`` makes the serving daemon write it at
drain. ``install`` also retrofits the already-created process-global
telemetry locks (REGISTRY, session slot) when obs.telemetry was
imported first, so registry edges are visible even in in-process
harnesses.

Caveat (documented, deliberate): a wrapped lock fed into
``threading.Condition(lock=...)`` uses the stdlib's acquire/release
fallback, so tracked Conditions must not rely on re-entrant waiter
internals — the tree's Conditions are all created standalone AFTER
install, which wraps their inner RLock transparently.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

RACECHECK_ENV = "DMLP_TPU_RACECHECK"
RACECHECK_OUT_ENV = "DMLP_TPU_RACECHECK_OUT"

_state_lock = threading.Lock()     # guards the graph/violation tables
_installed = False
_orig: Dict[str, Any] = {}
#: (held_site, acquired_site) -> first (file:line, thread name) seen
_edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
_violations: List[Dict[str, Any]] = []
_locks_created = 0
_tls = threading.local()


def enabled() -> bool:
    return _installed


def _held() -> List[Tuple[str, Any]]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _caller_site(depth: int = 2) -> str:
    f = sys._getframe(depth)
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _record_violation(kind: str, **data) -> None:
    v = {"kind": kind, "thread": threading.current_thread().name,
         **data}
    with _state_lock:
        _violations.append(v)


class _TrackedLock:
    """Wrapper over a real Lock/RLock: order-graph bookkeeping around
    the native primitive. Exposes the lock protocol (acquire/release/
    context manager/locked) so it drops into Condition and `with`."""

    __slots__ = ("_inner", "site", "kind")

    def __init__(self, inner, site: str, kind: str):
        self._inner = inner
        self.site = site
        self.kind = kind

    # -- bookkeeping -----------------------------------------------------------
    def _before_acquire(self, acquire_site: str) -> None:
        held = _held()
        me = self.site
        for held_site, _obj in held:
            if held_site == me:
                continue
            with _state_lock:
                _edges.setdefault(
                    (held_site, me),
                    (acquire_site, threading.current_thread().name))
                rev = _edges.get((me, held_site))
            if rev is not None:
                _record_violation(
                    "inversion", held=held_site, acquiring=me,
                    site=acquire_site, reverse_site=rev[0],
                    reverse_thread=rev[1])

    # -- lock protocol ---------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        site = _caller_site()
        if blocking:
            self._before_acquire(site)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held().append((self.site, self))
        return got

    def release(self):
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                del held[i]
                break
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # concurrent.futures.thread registers its module lock's reinit
        # with os.register_at_fork at import: a tracked lock must offer it
        self._inner._at_fork_reinit()

    # Condition(lock=...) compatibility passthroughs when present.
    def _is_owned(self):
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<TrackedLock {self.kind} @{self.site}>"


def _wrap_factory(kind: str):
    orig = _orig[kind]

    def factory(*args, **kwargs):
        global _locks_created
        inner = orig(*args, **kwargs)
        site = f"{kind}@{_caller_site()}"
        with _state_lock:
            _locks_created += 1
        return _TrackedLock(inner, site, kind)

    return factory


class _TrackedCondition:
    """Condition wrapper: acquisition tracking on the outer lock,
    held-stack handoff around wait() (which releases the lock)."""

    def __init__(self, inner, site: str):
        self._inner = inner
        self.site = site
        self.kind = "Condition"

    def acquire(self, *a, **kw):
        site = _caller_site()
        _TrackedLock._before_acquire(self, site)   # shared bookkeeping
        got = self._inner.acquire(*a, **kw)
        if got:
            _held().append((self.site, self))
        return got

    def release(self):
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                del held[i]
                break
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None):
        # wait() releases the condition's lock for its duration: pop it
        # from the held stack so a sleep inside another thread's guard
        # is not misattributed to this one.
        held = _held()
        idx = next((i for i in range(len(held) - 1, -1, -1)
                    if held[i][1] is self), None)
        if idx is not None:
            entry = held.pop(idx)
        try:
            return self._inner.wait(timeout)
        finally:
            if idx is not None:
                held.append(entry)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            left = None if deadline is None \
                else deadline - time.monotonic()
            if left is not None and left <= 0:
                break
            self.wait(left)
            result = predicate()
        return result

    def notify(self, n: int = 1):
        return self._inner.notify(n)

    def notify_all(self):
        return self._inner.notify_all()

    def __repr__(self):
        return f"<TrackedCondition @{self.site}>"


def _condition_factory(lock=None):
    # The stdlib Condition would otherwise build its inner RLock
    # through the PATCHED threading.RLock — one shared creation site
    # (threading.py) for every condition, which would alias all
    # conditions to one graph node and fabricate inversions. Hand it a
    # raw primitive; the wrapper is the tracked surface.
    if lock is None:
        lock = _orig["RLock"]()
    elif isinstance(lock, _TrackedLock):
        lock = lock._inner
    inner = _orig["Condition"](lock)
    site = f"Condition@{_caller_site()}"
    with _state_lock:
        global _locks_created
        _locks_created += 1
    return _TrackedCondition(inner, site)


def _blocking_wrapper(name: str, orig):
    def wrapped(*args, **kwargs):
        held = _held()
        if held:
            _record_violation(
                "blocking_under_lock", call=name,
                held=[site for site, _obj in held],
                site=_caller_site())
        return orig(*args, **kwargs)
    wrapped.__name__ = getattr(orig, "__name__", name)
    return wrapped


def _thread_join_wrapper(orig):
    def join(self, timeout: Optional[float] = None):
        held = _held()
        if held:
            _record_violation(
                "blocking_under_lock", call="Thread.join",
                held=[site for site, _obj in held],
                site=_caller_site())
        return orig(self, timeout)
    return join


def install() -> bool:
    """Idempotently instrument the lock factories + blocking
    primitives; returns True when active after the call. Also swaps
    the pre-existing process-global telemetry locks if obs.telemetry
    was imported before install."""
    global _installed
    if _installed:
        return True
    _orig["Lock"] = threading.Lock
    _orig["RLock"] = threading.RLock
    _orig["Condition"] = threading.Condition
    _orig["time.sleep"] = time.sleep
    _orig["Thread.join"] = threading.Thread.join
    threading.Lock = _wrap_factory("Lock")
    threading.RLock = _wrap_factory("RLock")
    threading.Condition = _condition_factory
    time.sleep = _blocking_wrapper("time.sleep", _orig["time.sleep"])
    threading.Thread.join = _thread_join_wrapper(_orig["Thread.join"])
    _installed = True
    _retrofit_telemetry()
    return True


def _retrofit_telemetry() -> None:
    """Wrap the known module-level locks created at import time
    (obs.telemetry's REGISTRY table + session slot locks,
    resilience.stats' degradation-list lock) so their edges show up
    even when those modules were imported before install()."""
    tm = sys.modules.get("dmlp_tpu_torch.obs.telemetry")
    if tm is not None:
        reg = getattr(tm, "REGISTRY", None)
        if reg is not None and not isinstance(
                getattr(reg, "_lock", None), _TrackedLock):
            reg._lock = _TrackedLock(reg._lock,
                                     "Lock@telemetry.REGISTRY", "Lock")
        slot = getattr(tm, "_session_lock", None)
        if slot is not None and not isinstance(slot, _TrackedLock):
            tm._session_lock = _TrackedLock(
                slot, "Lock@telemetry._session_lock", "Lock")
    st = sys.modules.get("dmlp_tpu_torch.resilience.stats")
    if st is not None:
        lk = getattr(st, "_lock", None)
        if lk is not None and not isinstance(lk, _TrackedLock):
            st._lock = _TrackedLock(lk, "Lock@resilience.stats._lock",
                                    "Lock")


def uninstall() -> None:
    """Restore the native factories (tracked locks already handed out
    keep working — they wrap real primitives)."""
    global _installed
    if not _installed:
        return
    threading.Lock = _orig["Lock"]
    threading.RLock = _orig["RLock"]
    threading.Condition = _orig["Condition"]
    time.sleep = _orig["time.sleep"]
    threading.Thread.join = _orig["Thread.join"]
    _installed = False


def reset() -> None:
    """Clear the order graph and violation log (harness phases)."""
    global _locks_created
    with _state_lock:
        _edges.clear()
        _violations.clear()
        _locks_created = 0


def report() -> Dict[str, Any]:
    with _state_lock:
        return {
            "racecheck_schema": 1,
            "installed": _installed,
            "locks_created": _locks_created,
            "edges": len(_edges),
            "violations": list(_violations),
            "inversions": sum(1 for v in _violations
                              if v["kind"] == "inversion"),
            "blocking_under_lock": sum(
                1 for v in _violations
                if v["kind"] == "blocking_under_lock"),
            "ok": not _violations,
        }


def write_report_if_requested() -> Optional[str]:
    """Write the report to ``$DMLP_TPU_RACECHECK_OUT`` (the daemon's
    drain hook); returns the path written, or None."""
    path = os.environ.get(RACECHECK_OUT_ENV)
    if not path or not _installed:
        return None
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report(), f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def install_from_env() -> bool:
    """The entry-point hook: install iff ``DMLP_TPU_RACECHECK=1``."""
    if os.environ.get(RACECHECK_ENV) == "1":
        return install()
    return False
