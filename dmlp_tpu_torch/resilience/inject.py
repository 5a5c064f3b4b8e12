"""Deterministic, seedable fault injection at named hazard points — port of
``dmlp_tpu/resilience/inject.py``.

A fault *schedule* (JSON, from ``--faults FILE`` or ``$DMLP_TPU_FAULTS``)
names injection sites and fires deterministic faults there; the same
schedule and seed give the same injection log, run after run, in either
package. The site catalog is the reference's whole catalog, so a schedule
valid for one package is valid for the other; a site whose module is not
ported yet simply never fires.

Schedule schema (``schema: 1``)::

    {"schema": 1, "seed": 7, "faults": [
        {"site": "single.stage_put", "kind": "delay", "ms": 40,
         "times": 2, "prob": 0.5},
        {"site": "single.fetch", "kind": "transient"},
        {"site": "single.extract_solve", "kind": "oom", "times": 2},
        {"site": "io.parse", "kind": "corrupt"}
    ]}

Per entry: ``site`` is an exact name or an ``fnmatch`` glob over
:data:`SITES` (a pattern matching no site is a load-time error); ``kind``
is ``delay`` (sleep ``ms``), ``transient`` (raise
:class:`InjectedTransientError`, which the retry layer retries), ``oom``
(raise :class:`SimulatedResourceExhausted`, which the degradation ladder
steps down on), or the passive ``corrupt`` / ``nan`` that the consuming
site applies itself; ``times`` bounds the fires (default 1), ``after``
skips the first N eligible hits, ``prob`` fires from the schedule's own
seeded PRNG in hit order, and ``when`` restricts to hits whose context
matches. :func:`fire` is a module-global None check when nothing is
installed.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import time
from typing import Any, Dict, List, Optional, Sequence

from dmlp_tpu_torch.resilience import stats

#: Injection-site catalog (the reference's, unchanged).
SITES: Dict[str, str] = {
    "io.parse": "input-grammar parse of the full problem payload "
                "(io.grammar.parse_input; corrupt faults truncate the "
                "bytes, the parser raises ParseError, the pristine "
                "payload is re-parsed)",
    "single.stage_put": "host->device staging of one data/query block "
                        "(engine.single.stage — every chunked path "
                        "stages through it)",
    "single.fetch": "fenced device readback of candidate lists "
                    "(engine.single.resilient_get)",
    "single.extract_solve": "extract-kernel solve dispatch "
                            "(engine.single._solve_extract*; oom faults "
                            "here drive the degradation ladder)",
    "sharded.solve": "a rank's shard solve in the mesh engines "
                     "(engine.sharded: the merged path and "
                     "solve_local_shards; rank-local, so a transient "
                     "retries without a collective)",
    "sharded.fetch": "rank 0's readback of the merged lists in the mesh "
                     "engines (engine.sharded, through resilient_get)",
    "dist.rank_solve": "per-rank shard solve inside the distributed "
                       "contract (parallel.distributed."
                       "distributed_contract_run)",
    "dist.allgather": "host all-gather of the rescored candidate lists "
                      "(parallel.distributed.distributed_contract_run)",
    "train.step": "one optimizer step (the train extension; not ported "
                  "yet)",
    "serve.admit": "serving-daemon admission decision (serve.admission "
                   "precheck; an oom fault is the memory squeeze: the "
                   "request is shed, the ladder untouched)",
    "serve.solve": "serving-daemon micro-batch solve (serve.batching)",
    "serve.ingest": "serving-daemon ingest execution (serve.batching)",
}

KINDS = ("delay", "transient", "oom", "corrupt", "nan")

#: passive kinds are actions the site itself applies (fire() returns
#: them), so a schedule placing one anywhere but its consuming site(s) is
#: rejected at load time: it would count as fired while doing nothing.
PASSIVE_CONSUMERS = {"corrupt": ("io.parse",), "nan": ("train.step",)}

#: injectable sleep for tests (delay faults must not slow the suite)
_sleep = time.sleep


class InjectedFault(RuntimeError):
    """Base class for all injected failures."""


class InjectedTransientError(InjectedFault):
    """A transient failure (classified retryable by resilience.retry)."""


class SimulatedResourceExhausted(InjectedFault):
    """A simulated device OOM; the message carries the RESOURCE_EXHAUSTED
    marker, and resilience.retry.classify treats it as a real one."""


class FaultEntry:
    """One schedule line plus its runtime fire-count state."""

    __slots__ = ("site", "kind", "times", "prob", "after", "ms", "when",
                 "message", "hits", "fired")

    def __init__(self, site: str, kind: str, times: int = 1,
                 prob: float = 1.0, after: int = 0, ms: float = 0.0,
                 when: Optional[Dict[str, Any]] = None, message: str = ""):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(valid: {', '.join(KINDS)})")
        if not any(fnmatch.fnmatchcase(name, site) for name in SITES):
            raise ValueError(
                f"fault site {site!r} matches no registered injection "
                f"site (catalog: {', '.join(sorted(SITES))})")
        consumers = PASSIVE_CONSUMERS.get(kind)
        if consumers is not None:
            stray = [n for n in SITES
                     if fnmatch.fnmatchcase(n, site) and n not in consumers]
            if stray:
                raise ValueError(
                    f"passive fault kind {kind!r} is only consumed at "
                    f"{', '.join(consumers)}; site {site!r} also matches "
                    f"{', '.join(stray)}, where it would count as fired "
                    "while doing nothing")
        if not (0.0 <= prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        if times < 1 or after < 0 or ms < 0:
            raise ValueError("times >= 1, after >= 0, ms >= 0 required")
        self.site, self.kind = site, kind
        self.times, self.prob, self.after = int(times), float(prob), int(after)
        self.ms = float(ms)
        self.when = dict(when or {})
        self.message = message
        self.hits = 0
        self.fired = 0

    def matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        if not fnmatch.fnmatchcase(site, self.site):
            return False
        return all(ctx.get(k) == v for k, v in self.when.items())


class FaultSchedule:
    """A loaded, validated schedule with its seeded PRNG and fire log."""

    def __init__(self, entries: Sequence[FaultEntry], seed: int = 0,
                 source: Optional[str] = None):
        self.entries = list(entries)
        self.seed = int(seed)
        self.source = source
        self._rng = random.Random(self.seed)
        self.log: List[dict] = []

    @classmethod
    def from_dict(cls, doc: Dict[str, Any],
                  source: Optional[str] = None) -> "FaultSchedule":
        if doc.get("schema") != 1:
            raise ValueError(f"fault schedule schema must be 1, got "
                             f"{doc.get('schema')!r}")
        faults = doc.get("faults")
        if not isinstance(faults, list) or not faults:
            raise ValueError("fault schedule needs a non-empty 'faults' "
                             "list")
        entries = []
        for i, f in enumerate(faults):
            if not isinstance(f, dict) or "site" not in f or "kind" not in f:
                raise ValueError(f"faults[{i}] must be an object with "
                                 "'site' and 'kind'")
            known = {"site", "kind", "times", "prob", "after", "ms",
                     "when", "message"}
            extra = set(f) - known
            if extra:
                raise ValueError(f"faults[{i}] has unknown field(s) "
                                 f"{sorted(extra)}")
            entries.append(FaultEntry(**f))
        return cls(entries, seed=int(doc.get("seed", 0)), source=source)

    @classmethod
    def from_file(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"fault schedule {path} is not JSON: "
                                 f"{e}") from None
        return cls.from_dict(doc, source=path)

    def fire(self, site: str, ctx: Dict[str, Any]) -> List[str]:
        """Evaluate every matching entry at this hit: raise for active
        faults, sleep for delays, return the passive actions for the site
        to apply; log every decision. A passive entry fired earlier in a
        call that then raises is rolled back (budget and log), since the
        caller never sees the actions list: the log never claims a fault
        that had no effect."""
        actions: List[str] = []
        pending: List[tuple] = []   # (passive entry, its log index)
        for e in self.entries:
            if not e.matches(site, ctx):
                continue
            e.hits += 1
            if e.hits <= e.after or e.fired >= e.times:
                continue
            fired = True if e.prob >= 1.0 else self._rng.random() < e.prob
            self.log.append({"site": site, "kind": e.kind, "hit": e.hits,
                             "fired": fired,
                             **({"ctx": _json_ctx(ctx)} if ctx else {})})
            if not fired:
                continue
            if e.kind in ("transient", "oom"):
                for p, idx in reversed(pending):
                    p.fired -= 1
                    del self.log[idx]
            e.fired += 1
            stats.record_fault(site, e.kind)
            from dmlp_tpu_torch.obs import trace as obs_trace
            obs_trace.instant("resilience.fault", site=site, kind=e.kind)
            detail = f" ({e.message})" if e.message else ""
            if e.kind == "delay":
                _sleep(e.ms / 1e3)
            elif e.kind == "transient":
                raise InjectedTransientError(
                    f"injected transient fault at {site}{detail}")
            elif e.kind == "oom":
                raise SimulatedResourceExhausted(
                    f"RESOURCE_EXHAUSTED (injected) at {site}{detail}")
            else:
                actions.append(e.kind)
                pending.append((e, len(self.log) - 1))
        return actions

    def log_json(self) -> str:
        return json.dumps({"schema": 1, "seed": self.seed,
                           "source": self.source, "log": self.log},
                          sort_keys=True, indent=1)

    def write_log(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.log_json() + "\n")
        os.replace(tmp, path)


def _json_ctx(ctx: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in ctx.items()
            if isinstance(v, (str, int, float, bool, type(None)))}


# -- the process-wide hook ----------------------------------------------------
_active: Optional[FaultSchedule] = None


def install(schedule: FaultSchedule) -> FaultSchedule:
    global _active
    _active = schedule
    return schedule


def uninstall() -> None:
    global _active
    _active = None


def active() -> Optional[FaultSchedule]:
    return _active


def fire(site: str, **ctx) -> Optional[List[str]]:
    """The hook every registered hazard point calls: the passive actions
    to apply (or None, the fast path); raises for transient/oom faults. A
    no-op unless a schedule is installed and resilience is enabled."""
    sched = _active
    if sched is None:
        return None
    if os.environ.get("DMLP_TPU_RESILIENCE", "1") == "0":
        return None
    return sched.fire(site, ctx)


def install_from_env(flag_path: Optional[str] = None
                     ) -> Optional[FaultSchedule]:
    """Install a schedule from ``flag_path`` (the CLI's ``--faults``) or
    ``$DMLP_TPU_FAULTS``; returns it, or None when neither is set."""
    path = flag_path or os.environ.get("DMLP_TPU_FAULTS")
    if not path:
        return None
    return install(FaultSchedule.from_file(path))


def write_log_if_requested() -> None:
    """Write the active schedule's injection log to
    ``$DMLP_TPU_FAULT_LOG`` when that is set."""
    sched = _active
    path = os.environ.get("DMLP_TPU_FAULT_LOG")
    if sched is not None and path:
        sched.write_log(path)


def corrupt_bytes(data):
    """Deterministic payload corruption for ``corrupt`` actions: truncate
    to <= 3/4 of the length at a line boundary, so at least one whole
    record line disappears and the grammar's record-count check is sure
    to raise ParseError (a mid-token cut could still parse). Bytes or
    str."""
    nl = b"\n" if isinstance(data, bytes) else "\n"
    empty = b"" if isinstance(data, bytes) else ""
    if not data:
        return empty
    # Exclude a trailing newline, so the cut always removes >= 1 line.
    body = data[:-1] if data.endswith(nl) else data
    cut = body.rfind(nl, 0, min((len(data) * 3) // 4, len(body)))
    if cut <= 0:
        return empty
    return data[: cut + 1]
