"""Open-loop load: p50/p95/p99 under offered load, one record per level.

Port of ``dmlp_tpu/fleet/loadgen.py``. A closed-loop replay
(``serve.client.replay``) slows down exactly when the server does, so it
cannot say what p99 is at twice today's load. This module drives
:func:`dmlp_tpu_torch.serve.client.replay_open_loop` over speed
multipliers of a paced trace: requests fire on the trace's schedule
whether or not earlier ones completed, so queueing shows up in the
latency quantiles. Each level becomes one RunRecord (``obs.run``, kind
"fleet", keyed by its ``level_tag``); the ramp arms become kind "slo"
records. ``reps >= 3`` gives each level's quantiles a noise band. The
ledger that reads these records is not ported yet (ROADMAP A15).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from dmlp_tpu_torch.obs.run import RunRecord, current_device
from dmlp_tpu_torch.serve import client as sc


def offered_qps(requests: List[Dict[str, Any]],
                speed: float = 1.0) -> Optional[float]:
    """The load a paced replay OFFERS: total queries over the trace's
    t_ms span (compressed by ``speed``), independent of how fast the
    daemon answers. None for an unpaced trace."""
    ts = [float(r.get("t_ms", 0)) for r in requests]
    span_s = (max(ts) / 1e3 / max(speed, 1e-9)) if ts else 0.0
    queries = sum(int(r["nq"]) for r in requests)
    if span_s <= 0:
        return None
    return round(queries / span_s, 3)


def run_level(port: int, header: Dict[str, Any],
              requests: List[Dict[str, Any]], speed: float,
              reps: int = 1) -> Dict[str, Any]:
    """``reps`` open-loop replays at one speed multiplier -> metrics:
    per-rep p50/p95/p99/max client latency (measured from the
    SCHEDULED fire time — queue delay included), dispatch lag, error
    and rejection counts, achieved vs offered qps. Scalar metrics are
    the median across reps; ``*_reps`` carry the raw per-rep lists so
    the ledger can qualify noise bands."""
    per_rep: Dict[str, List[float]] = {
        "p50_ms": [], "p95_ms": [], "p99_ms": [], "max_ms": [],
        "lag_p95_ms": [], "achieved_qps": []}
    errors = 0
    rejected = 0
    total = 0
    for _rep in range(max(reps, 1)):
        res = sc.replay_open_loop(port, header, requests, speed=speed)
        total += len(res)
        ok = [r for r in res if r.get("ok")]
        errors += sum(1 for r in res
                      if not r.get("ok")
                      and not str(r.get("error", "")).startswith(
                          "rejected"))
        rejected += sum(1 for r in res
                        if not r.get("ok")
                        and str(r.get("error", "")).startswith(
                            "rejected"))
        lat = np.asarray([r["client_ms"] for r in ok], np.float64)
        lag = np.asarray([r.get("lag_ms", 0.0) for r in res],
                         np.float64)
        if lat.size:
            per_rep["p50_ms"].append(float(np.percentile(lat, 50)))
            per_rep["p95_ms"].append(float(np.percentile(lat, 95)))
            per_rep["p99_ms"].append(float(np.percentile(lat, 99)))
            per_rep["max_ms"].append(float(lat.max()))
        if lag.size:
            per_rep["lag_p95_ms"].append(float(np.percentile(lag, 95)))
        # Achieved = completed queries over the wall span actually
        # taken (first scheduled fire to last completion).
        if ok:
            span_ms = max(float(r.get("t_ms", 0)) / max(speed, 1e-9)
                          + q["client_ms"]
                          for r, q in zip(requests, res) if q.get("ok"))
            done_q = sum(int(r["nq"]) for r, q in zip(requests, res)
                         if q.get("ok"))
            if span_ms > 0:
                per_rep["achieved_qps"].append(
                    round(done_q / (span_ms / 1e3), 3))
    metrics: Dict[str, Any] = {
        "requests": total, "errors": errors, "rejected": rejected,
    }
    for key, vals in per_rep.items():
        if not vals:
            continue
        metrics[key] = round(float(np.median(vals)), 3)
        if len(vals) > 1:
            metrics[f"{key}_reps"] = [round(v, 3) for v in vals]
    return metrics


def level_tag(speed: float) -> str:
    s = f"{speed:g}".replace(".", "p")
    return f"x{s}"


def run_levels(port: int, header: Dict[str, Any],
               requests: List[Dict[str, Any]],
               speeds: Sequence[float], reps: int = 1,
               replicas: int = 1, trace: str = "",
               tool: str = "dmlp_tpu_torch.fleet.loadgen"
               ) -> List[RunRecord]:
    """The p99-vs-offered-load curve: one RunRecord per speed level,
    slowest level first (a warm daemon sees rising load, like
    production). Each record's config pins the level tag the ledger
    keys the series by (``fleet/x2/p99_ms``), the offered qps, and the
    fleet topology."""
    device = current_device()
    out: List[RunRecord] = []
    for speed in sorted(speeds):
        metrics = run_level(port, header, requests, speed, reps=reps)
        oq = offered_qps(requests, speed)
        if oq is not None:
            metrics["offered_qps"] = oq
        out.append(RunRecord(
            kind="fleet", tool=tool,
            config={"level": level_tag(speed), "speed": speed,
                    "replicas": replicas, "trace": trace,
                    "mode": "open_loop",
                    "requests_per_rep": len(requests), "reps": reps},
            metrics=metrics, device=device))
    return out


# -- the SLO ramp (predictive-vs-reactive A/B) --------------------------------

def _fleet_slo_stats(port: int) -> Dict[str, Any]:
    """One ``stats`` op against the front-end: the router's SLO
    snapshot + replica count, shape-normalized for the ramp record."""
    st = sc.ServeClient(port).stats().get("stats", {})
    out: Dict[str, Any] = {
        "replicas": st.get("healthy_replicas"),
        "objectives": {},
    }
    for name, o in (st.get("slo") or {}).get("objectives", {}).items():
        out["objectives"][name] = {
            "state": o.get("state"), "cycles": o.get("cycles", 0),
            "burn_fast": o.get("burn_fast", 0.0),
            "burn_slow": o.get("burn_slow", 0.0)}
    return out


def run_ramp(port: int, header: Dict[str, Any],
             requests: List[Dict[str, Any]],
             speeds: Sequence[float], *,
             settle_s: float = 0.0,
             stats_fn: Optional[Callable[[], Dict[str, Any]]] = None
             ) -> List[Dict[str, Any]]:
    """The escalating-load ramp the SLO engine is judged on: each
    speed level runs one open-loop replay (ASCENDING — the fleet sees
    load rise, which is what a leading autoscale signal must get ahead
    of), then the front-end's stats op is sampled for the SLO
    snapshot. ``settle_s`` idles between levels so a predictive
    scale-up spawned mid-level can become ready before the next step
    (the lead time the policy is buying). Returns one step dict per
    level: the replay metrics plus ``slo`` (per-objective state /
    burn / completed alert cycles) and the live replica count."""
    steps: List[Dict[str, Any]] = []
    for speed in list(speeds):
        metrics = run_level(port, header, requests, speed, reps=1)
        oq = offered_qps(requests, speed)
        if oq is not None:
            metrics["offered_qps"] = oq
        step: Dict[str, Any] = {"speed": speed,
                                "level": level_tag(speed),
                                "metrics": metrics}
        try:
            step["slo"] = (stats_fn or
                           (lambda: _fleet_slo_stats(port)))()
        except Exception as e:  # check: no-retry — a stats blip never aborts
            # the ramp mid-experiment
            step["slo"] = {"error": f"{type(e).__name__}: {e}"}
        steps.append(step)
        if settle_s > 0:
            import time
            time.sleep(settle_s)
    return steps


def ramp_record(arm: str, objective: str,
                steps: List[Dict[str, Any]], *,
                replicas: int = 1, trace: str = "",
                tool: str = "dmlp_tpu_torch.fleet.loadgen") -> RunRecord:
    """One kind="slo" RunRecord summarizing a ramp arm (series
    ``slo/<arm>/<metric>``). The A/B
    contract the smoke asserts lives in these metrics: the predictive
    arm's ``breach_cycles`` stays 0 (and ``max_burn_fast`` <= 1)
    at ramp levels where the reactive arm's breach fires."""
    peak = steps[-1]["metrics"] if steps else {}
    max_burn_fast = 0.0
    max_burn_slow = 0.0
    breach_cycles = 0
    worst = 0                     # 0 ok / 1 pending / 2 firing
    replicas_final = replicas
    for step in steps:
        slo = step.get("slo") or {}
        if slo.get("replicas"):
            replicas_final = int(slo["replicas"])
        # Burn maxima are scoped to the DECLARED objective: a canary
        # objective the predictive policy follows is EXPECTED to burn
        # (that is the lead it buys) and must not pollute the gated
        # customer-objective series.
        target = (slo.get("objectives") or {}).get(objective, {})
        max_burn_fast = max(max_burn_fast,
                            float(target.get("burn_fast", 0.0)))
        max_burn_slow = max(max_burn_slow,
                            float(target.get("burn_slow", 0.0)))
        breach_cycles = max(breach_cycles,
                            int(target.get("cycles", 0)))
        state = str(target.get("state", "ok"))
        worst = max(worst, {"ok": 0, "pending": 1,
                            "firing": 2}.get(state, 0))
        if state == "firing":
            breach_cycles = max(breach_cycles, 1)
    metrics: Dict[str, Any] = {
        "levels": len(steps),
        "breach_cycles": breach_cycles,
        "worst_state_level": worst,
        "max_burn_fast": round(max_burn_fast, 4),
        "max_burn_slow": round(max_burn_slow, 4),
        "replicas_final": replicas_final,
    }
    for key in ("p99_ms", "p95_ms", "p50_ms", "offered_qps",
                "achieved_qps"):
        if key in peak:
            metrics[f"peak_{key}"] = peak[key]
    errors = sum(int(s["metrics"].get("errors", 0)) for s in steps)
    rejected = sum(int(s["metrics"].get("rejected", 0)) for s in steps)
    metrics["errors"] = errors
    metrics["rejected"] = rejected
    return RunRecord(
        kind="slo", tool=tool,
        config={"arm": arm, "objective": objective, "mode": "ramp",
                "levels": [s["level"] for s in steps],
                "replicas": replicas, "trace": trace},
        metrics=metrics, device=current_device())


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m dmlp_tpu_torch.fleet.loadgen`` — drive one arm of the
    ramp against a running front-end and append its kind="slo"
    RunRecord (``slo/<arm>/...`` ledger series)."""
    import argparse
    import json
    import sys
    p = argparse.ArgumentParser(prog="dmlp_tpu_torch.fleet.loadgen")
    p.add_argument("--port", type=int, required=True,
                   help="front-end (or daemon) port to drive")
    p.add_argument("--trace", required=True,
                   help="paced replay trace (serve.client.load_trace)")
    p.add_argument("--ramp", required=True, metavar="S,S,S",
                   help="ascending speed multipliers, e.g. 1,2,4")
    p.add_argument("--arm", required=True,
                   help="A/B arm tag recorded in the slo/ series "
                        "(e.g. predictive, reactive)")
    p.add_argument("--objective", required=True, metavar="ID",
                   help="objective id the ramp verdict keys on")
    p.add_argument("--record", default=None, metavar="FILE",
                   help="append the arm's kind=slo RunRecord here")
    p.add_argument("--settle-s", type=float, default=0.0)
    p.add_argument("--replicas", type=int, default=1)
    args = p.parse_args(argv)
    header, reqs = sc.load_trace(args.trace)
    speeds = [float(s) for s in args.ramp.split(",") if s.strip()]
    steps = run_ramp(args.port, header, reqs, speeds,
                     settle_s=args.settle_s)
    rec = ramp_record(args.arm, args.objective, steps,
                      replicas=args.replicas, trace=args.trace)
    if args.record:
        rec.append_jsonl(args.record)
    json.dump({"arm": args.arm, "metrics": rec.metrics},
              sys.stdout, indent=1, sort_keys=True)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
