"""The program's spans over a profiled stretch of batch solves: each
solve's root span and how much of it no child covers, and the device's
idle time put down to the innermost span open on the host while it
lasted.

    python3 -m benchmark.spans --workload sift1m.batch --seed N \
        [--solves 8] [--out FILE]

It sets the cell up as ``drivers/batch.py``'s ``run`` does (its
``make_input``, then the same engine, entry and warm solves), then
profiles two stretches of ``--solves`` solves each with that driver's
``profiling.Stretch``: the first as the driver's traced stretch (no
tracer), the second with ``obs.trace.Tracer(annotate=True)`` installed,
so that every span of the engine is also a ``record_function`` range on
the profiler's own clock. It prints one JSON object: for each solve of
the second stretch the root span's duration, the share of it no child
span covers, its ``h2d_bytes`` and the engine's ``last_phase_ms`` (the
split the per-layer metrics read); the idle seconds of the second
stretch by innermost program span; the tracing-on cost (the second
stretch's median solve over the first's); and which host clock the
profiler's timestamps follow. The same numbers are logged on standard
error. It needs a CUDA card, like ``run.py``, and exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from benchmark.profiling import Stretch, _activities, _times_us, _union

ROOT_SPAN = "single.run_device_full"
NO_SPAN = "(no program span)"


# -- the tracer's events -------------------------------------------------------

def _children(spans: List[dict]) -> Dict[Any, List[dict]]:
    out: Dict[Any, List[dict]] = {}
    for e in spans:
        out.setdefault(e["args"].get("parent"), []).append(e)
    return out


def self_us(e: dict, kids: Dict[Any, List[dict]]) -> float:
    """A span's duration less the part of it its children cover."""
    cover = _union([(c["ts"], c["ts"] + c["dur"])
                    for c in kids.get(e["args"]["id"], ())])
    return e["dur"] - sum(b - a for a, b in cover)


def roots(events: Iterable[dict], root: str = ROOT_SPAN) -> List[dict]:
    """Per root span, in order: its duration in ms, the share of it no
    child span covers, and its ``h2d_bytes``."""
    spans = [e for e in events if e.get("ph") == "X"
             and "id" in e.get("args", {})]
    kids = _children(spans)
    return [{"solve_ms": r["dur"] / 1e3,
             "self_pct": 100.0 * self_us(r, kids) / r["dur"]
             if r["dur"] else 0.0,
             "h2d_bytes": r["args"].get("h2d_bytes", 0)}
            for r in sorted((e for e in spans if e["name"] == root),
                            key=lambda e: e["ts"])]


# -- idle time by program span -------------------------------------------------

Interval = Tuple[float, float]


def _gaps(busy: List[Interval], lo: float, hi: float) -> List[Interval]:
    edges = [lo] + [x for ab in _union(busy) for x in ab] + [hi]
    return [(max(a, lo), min(b, hi)) for a, b in zip(edges[::2], edges[1::2])
            if min(b, hi) > max(a, lo)]


def _innermost(spans: List[Tuple[float, float, str]], a: float,
               b: float) -> str:
    """The span open over all of [a, b] that opened last (nested spans:
    the innermost), or NO_SPAN."""
    best = None
    for s0, s1, name in spans:
        if s0 <= a and s1 >= b and (best is None or s0 > best[0]
                                    or (s0 == best[0] and s1 < best[1])):
            best = (s0, s1, name)
    return best[2] if best else NO_SPAN


def idle_by_span(busy: List[Interval], spans: List[Tuple[float, float, str]],
                 lo: float, hi: float) -> Tuple[Dict[str, float], List[list]]:
    """The device's idle time in [lo, hi] (outside every ``busy``
    interval), each instant put down to the innermost host span open
    then: ({span name: idle time}, [[winner, gap length], ...] longest gap
    first), where a gap's winner is the span that is innermost over the
    largest part of it. Times in the inputs' unit."""
    by_name: Dict[str, float] = {}
    named = []
    for g0, g1 in _gaps(busy, lo, hi):
        cuts = sorted({g0, g1} | {x for s0, s1, _ in spans
                                  for x in (s0, s1) if g0 < x < g1})
        part: Dict[str, float] = {}
        for a, b in zip(cuts, cuts[1:]):
            name = _innermost(spans, a, b)
            part[name] = part.get(name, 0.0) + (b - a)
        for name, t in part.items():
            by_name[name] = by_name.get(name, 0.0) + t
        named.append([max(part, key=lambda k: (part[k], k != NO_SPAN)),
                      g1 - g0])
    named.sort(key=lambda x: -x[1])
    return by_name, named


# -- the profiled stretches ----------------------------------------------------

def _stretch(device, engine, solve, inp, m: int):
    """m solves in a ``Stretch``: (the stretch, host seconds a solve, the
    engine's ``last_phase_ms`` of each). A device-full solve ends on its
    readback, so each solve's time holds its device work."""
    times, phases = [], []
    st = Stretch(device)
    st.start()
    for _ in range(m):
        t = time.perf_counter()
        solve(inp)
        times.append(time.perf_counter() - t)
        phases.append(dict(engine.last_phase_ms))
    st.stop()
    return st, times, phases


def _clock_probe(device) -> Dict[str, Any]:
    """Which host clock the profiler's timestamps follow: the offset (us)
    of one ``record_function``'s start from each clock read just before
    it; the clock with the smallest is the profiler's."""
    from torch.profiler import profile, record_function
    reads = {}
    with profile(activities=_activities(device)) as prof:
        reads["perf_counter"] = time.perf_counter_ns()
        reads["monotonic"] = time.monotonic_ns()
        reads["time"] = time.time_ns()
        with record_function("spans.clock_probe"):
            pass
    start_us = next(_times_us(e)[0]
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "spans.clock_probe")
    off = {k: start_us - v / 1e3 for k, v in reads.items()}
    return {"offset_us": off, "clock": min(off, key=lambda k: abs(off[k]))}


def tracer_residual_us(prof, events: List[dict]) -> List[float]:
    """Per root span, its start in the profiler less its start in the
    tracer carried to the wall clock by the tracer's ``sync_instant``
    (a perf_counter and a wall-clock read back to back): near zero when
    the profiler's timestamps are wall-clock time."""
    sync = next(e for e in events if e["name"] == "spans.clock_sync")
    roots = sorted(e["ts"] for e in events
                   if e.get("ph") == "X" and e["name"] == ROOT_SPAN)
    import torch
    dev_type = torch.autograd.DeviceType.CUDA
    starts = sorted(_times_us(e)[0]
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == ROOT_SPAN and e.device_type() != dev_type)
    return [p - (t - sync["ts"] + sync["args"]["unix_ms"] * 1e3)
            for p, t in zip(starts, roots)]


def reduce_traced(prof, events: List[dict]) -> Dict[str, Any]:
    """The device's busy time and its idle time by program span over one
    profiled stretch whose spans ``events`` (the tracer's) mirrored into
    ``prof``. Device-side copies of the annotations are not busy time."""
    import torch
    names = {e["name"] for e in events if e.get("ph") == "X"}
    dev_type = torch.autograd.DeviceType.CUDA
    busy, spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        a, b = _times_us(e)
        if e.device_type() == dev_type:
            if e.name() not in names:
                busy.append((a, b))
        elif e.name() in names:
            spans.append((a, b, e.name()))
        else:
            host.append((a, b))
    every = busy + host + [(a, b) for a, b, _ in spans]
    if not every:
        return {}
    lo, hi = min(a for a, _ in every), max(b for _, b in every)
    by_name, named = idle_by_span(busy, spans, lo, hi)
    idle = sum(by_name.values())
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in _union(busy)) / 1e6,
            "idle_s": idle / 1e6,
            "idle_named_pct": 100.0 * (1 - by_name.get(NO_SPAN, 0.0) / idle)
            if idle else None,
            "idle_s_by_span": {k: v / 1e6 for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])},
            "longest_gaps": [[n, s / 1e6] for n, s in named[:10]]}


def measure(r, solves: int) -> Dict[str, Any]:
    """Set up run ``r``'s cell as ``drivers/batch.py``'s ``run`` does and
    measure both stretches (see the module's docstring)."""
    from benchmark.drivers.batch import make_input
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import SingleChipEngine
    from dmlp_tpu_torch.obs import trace as obs_trace

    tr = r.cell.traffic
    inp = make_input(r)
    engine = SingleChipEngine(EngineConfig(device=r.device.type,
                                           **tr["engine_config"]))
    solve = getattr(engine, tr["entry"])
    for _ in range(int(tr["warm_solves"])):
        solve(inp)
    plain, plain_s, _ = _stretch(r.device, engine, solve, inp, solves)
    tracer = obs_trace.install(obs_trace.Tracer(annotate=True))
    try:
        tracer.sync_instant("spans.clock_sync")
        traced, traced_s, phases = _stretch(r.device, engine, solve, inp,
                                            solves)
    finally:
        obs_trace.uninstall()
    events = tracer.events()
    prof = traced._prof
    rows = roots(events)
    for row, ph in zip(rows, phases):
        row["phase_ms"] = ph
    med_plain, med_traced = (statistics.median(plain_s),
                             statistics.median(traced_s))
    return {"workload": r.cell.name, "seed": r.seed, "solves": solves,
            "solve_s_untraced": plain_s, "solve_s_traced": traced_s,
            "tracing_cost_pct": 100.0 * (med_traced / med_plain - 1),
            "untraced": {k: plain.summary().get(k)
                         for k in ("busy_s", "window_s")},
            "per_solve": rows, "idle": reduce_traced(prof, events),
            "clock": dict(_clock_probe(r.device),
                          tracer_residual_us=tracer_residual_us(prof,
                                                                events))}


def log(out: Dict[str, Any]) -> None:
    def say(msg: str) -> None:
        print(f"[{out['workload']}] {msg}", file=sys.stderr)

    on, off = (statistics.median(out["solve_s_traced"]),
               statistics.median(out["solve_s_untraced"]))
    say(f"tracing on: median solve {on:.4f} s against {off:.4f} s off "
        f"({out['tracing_cost_pct']:+.2f}%)")
    u = out["untraced"]
    if u.get("busy_s"):
        say(f"untraced stretch: device busy {u['busy_s']:.4f} s of "
            f"{u['window_s']:.4f} s")
    for row in out["per_solve"]:
        say("solve " + ", ".join(f"{k} {v:.6g}" for k, v in row.items()
                                 if not isinstance(v, dict)))
    idle = out["idle"]
    if idle:
        say(f"idle {idle['idle_s']:.4f} s of {idle['window_s']:.4f} s, "
            f"{idle['idle_named_pct']:.2f}% under a program span")
        for name, s in idle["idle_s_by_span"].items():
            say(f"  idle under {name}: {s:.6f} s")
    c = out["clock"]
    say(f"profiler clock: {c['clock']} (offsets us {c['offset_us']}); "
        f"its root spans start {c['tracer_residual_us']} us after the "
        "tracer's, carried by the sync instant")


def main(argv: Optional[List[str]] = None) -> int:
    from benchmark.run import prepare_env
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--solves", type=int, default=None,
                    help="solves a stretch (default: the mix's "
                         "trace_solves)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    prepare_env()

    import torch

    from benchmark.drivers.common import Run
    from benchmark.harness import power_limit
    from benchmark.spec import Spec
    cell = Spec.load().cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA card", file=sys.stderr)
        return 2
    r = Run(cell=cell, seed=args.seed, seconds=0.0, trace=True,
            device=torch.device("cuda", 0), t0=t0)
    out = measure(r, args.solves or int(cell.traffic["trace_solves"]))
    out["device"] = {"kind": torch.cuda.get_device_name(r.device),
                     "power_limit": power_limit()}
    log(out)
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
