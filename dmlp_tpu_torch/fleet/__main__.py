"""``python -m dmlp_tpu_torch.fleet`` — the fleet front-end router CLI.

Two modes:

**Static**: route over an existing replica set::

    python -m dmlp_tpu_torch.fleet --replicas H:P,H:P[,...]
        [--scrape-ports Q,Q,...] [--port 0] [--ready-file PATH]
        [--telemetry-port PORT] [--record FILE] [--trace FILE]
        [--health-interval-s S] [--request-timeout-s S]
        [--revive-probes N] [--repair on|off] [--slo SPEC ...]

**Supervised**: the router spawns and owns its replicas (``python -m
dmlp_tpu_torch.serve`` each): crash detection with bounded relaunch,
load-driven scaling between ``--spawn-replicas`` and ``--max-replicas``,
and the staged re-split when ingest approaches a replica's capacity::

    python -m dmlp_tpu_torch.fleet --spawn-corpus FILE
        [--spawn-replicas N] [--max-replicas N] [--out-dir DIR]
        [--spawn-warm NQxK,...] [--spawn-batch-cap N]
        [--spawn-flags "--device cpu --mesh 2x1 --backend gloo ..."]
        [--spawn-capacity ROWS] [--relaunch-budget N]
        [--reshard-threshold F] [--scale-high F] [--scale-low F]
        [--poll-s S] [--policy reactive|predictive] ...

Spawned replicas run on the card unless ``--spawn-flags`` carries
``--device cpu``. Either way the router fans the daemon wire protocol
over the replicas (queries load-balanced with bounded retry and revive
hysteresis, ingest fanned out with checksum-driven repair, stats
aggregated); ``--telemetry-port`` serves the merged fleet OpenMetrics
view with per-replica scrape-freshness gauges. Prints
``dmlp_tpu_torch.fleet: ready port=P replicas=N`` on stderr (and writes
``--ready-file``), then routes until SIGTERM or an in-band ``drain`` op,
which stops the supervisor first (no relaunch storm), propagates the
drain to every replica, finishes in-flight relays, appends the final
fleet RunRecord, and exits 0 only when every managed replica exited 0.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import sys
from typing import List, Optional, Sequence, Tuple

from dmlp_tpu_torch.check import racecheck


def _parse_replicas(spec: str) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            host, port = part.rsplit(":", 1)
            out.append((host or "127.0.0.1", int(port)))
        except ValueError:
            raise SystemExit(
                f"--replicas entries are HOST:PORT, got {part!r}")
    if not out:
        raise SystemExit("--replicas lists no endpoints")
    return out


def _parse_ports(spec: Optional[str], n: int) -> List[Optional[int]]:
    if not spec:
        return [None] * n
    out: List[Optional[int]] = []
    for part in spec.split(","):
        part = part.strip()
        out.append(int(part) if part and part != "-" else None)
    if len(out) != n:
        raise SystemExit("--scrape-ports needs one entry per replica "
                         "('-' for none)")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="dmlp_tpu_torch.fleet",
                                description=__doc__)
    p.add_argument("--replicas", default=None, metavar="H:P,H:P",
                   help="existing daemon replica endpoints (static "
                        "mode; omit with --spawn-corpus)")
    p.add_argument("--scrape-ports", default=None, metavar="Q,Q",
                   help="per-replica telemetry ports for the "
                        "aggregated fleet scrape ('-' skips one)")
    p.add_argument("--port", type=int, default=0,
                   help="front-end TCP port (0 = ephemeral)")
    p.add_argument("--ready-file", metavar="PATH", default=None)
    p.add_argument("--telemetry-port", type=int, default=None,
                   metavar="PORT",
                   help="serve the merged fleet OpenMetrics view here "
                        "(0 = ephemeral, announced in the ready file)")
    p.add_argument("--record", metavar="FILE", default=None,
                   help="append the final fleet-router RunRecord here")
    p.add_argument("--trace", metavar="FILE", default=None,
                   help="write the router's Chrome-trace JSON "
                        "(rid-tagged route/hop spans) here on drain; "
                        "merge with the replicas' --trace files via "
                        "tools/merge_traces.py --fleet")
    p.add_argument("--health-interval-s", type=float, default=1.0)
    p.add_argument("--request-timeout-s", type=float, default=600.0)
    p.add_argument("--revive-probes", type=int, default=1,
                   help="consecutive healthy probes before a marked-"
                        "down replica routes again (flap hysteresis)")
    p.add_argument("--repair", choices=["on", "off"], default="on",
                   help="checksum-driven consistency repair of "
                        "divergent replicas (targeted delta re-ingest)")
    # -- supervised mode -------------------------------------------------------
    p.add_argument("--spawn-corpus", metavar="FILE", default=None,
                   help="supervise mode: spawn replicas over this "
                        "corpus file instead of fanning over --replicas")
    p.add_argument("--spawn-replicas", type=int, default=2,
                   help="initial (and minimum) supervised fleet size")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="auto-scaling ceiling (default: initial + 2)")
    p.add_argument("--out-dir", metavar="DIR", default=".",
                   help="supervised replicas' scratch dir (ready "
                        "files, telemetry snapshots, stderr logs)")
    p.add_argument("--spawn-warm", metavar="NQxK,...", default="1x1",
                   help="warm-bucket spec passed to spawned replicas")
    p.add_argument("--spawn-batch-cap", type=int, default=32)
    p.add_argument("--spawn-flags", default="",
                   help="extra daemon flags for spawned replicas "
                        "(quoted), e.g. '--device cpu' or '--mesh 2x1 "
                        "--backend gloo'")
    p.add_argument("--spawn-capacity", type=int, default=None,
                   help="explicit --capacity for spawned replicas")
    p.add_argument("--relaunch-budget", type=int, default=3,
                   help="total crashed-replica relaunches before "
                        "degrading to a smaller fleet")
    p.add_argument("--unhealthy-deadline-s", type=float, default=20.0,
                   help="probe-dead seconds before a hung replica is "
                        "treated as crashed")
    p.add_argument("--reshard-threshold", type=float, default=0.9,
                   help="corpus rows / capacity ratio that triggers "
                        "the staged shard re-split (<=0 disables)")
    p.add_argument("--scale-high", type=float, default=4.0)
    p.add_argument("--scale-low", type=float, default=0.25)
    p.add_argument("--poll-s", type=float, default=0.5,
                   help="supervisor watch interval")
    # -- SLO objectives + predictive autoscaling -------------------------------
    p.add_argument("--slo", action="append", default=None,
                   metavar="SPEC",
                   help="fleet-level SLO objective (repeatable), e.g. "
                        "'fleet.request_latency_ms p99 < 50 over 1m'; "
                        "availability specs sample good/total from the "
                        "merged fleet scrape. Evaluated in the health "
                        "loop (dmlp_tpu_torch.obs.slo); transitions emit "
                        "slo.alert events and the slo_* gauge family")
    p.add_argument("--slo-trend", default=None, metavar="M,M",
                   help="extra metrics to track Theil-Sen latency "
                        "slopes for (slo.trend.* gauges)")
    p.add_argument("--policy", choices=["reactive", "predictive"],
                   default="reactive",
                   help="supervised auto-scaling policy: 'reactive' = "
                        "in-flight watermarks; 'predictive' = scale on "
                        "the SLO burn rate / trend-projected crossing "
                        "(falls back to reactive without signals)")
    p.add_argument("--slo-objective", default=None, metavar="ID",
                   help="objective id the predictive policy follows "
                        "(default: the first --slo latency objective)")
    p.add_argument("--lead-time-s", type=float, default=10.0,
                   help="predictive policy scales up when the trend "
                        "projects an SLO crossing within this horizon")
    args = p.parse_args(argv)
    # Idempotent backstop (the real install runs in fleet/__init__,
    # before any serving lock exists).
    racecheck.install_from_env()

    from dmlp_tpu_torch.fleet.router import FleetRouter

    supervised = args.spawn_corpus is not None
    if not supervised and not args.replicas:
        raise SystemExit("need --replicas (static) or --spawn-corpus "
                         "(supervised)")

    if supervised:
        replicas: List[Tuple[str, int]] = []
        scrape_ports: List[Optional[int]] = []
    else:
        replicas = _parse_replicas(args.replicas)
        scrape_ports = _parse_ports(args.scrape_ports, len(replicas))
    if args.policy == "predictive" and not args.slo:
        raise SystemExit("--policy predictive needs at least one --slo "
                         "objective to read burn/trend signals from")
    trend = ([m.strip() for m in args.slo_trend.split(",") if m.strip()]
             if args.slo_trend else None)
    router = FleetRouter(replicas, scrape_ports=scrape_ports,
                         port=args.port,
                         health_interval_s=args.health_interval_s,
                         request_timeout_s=args.request_timeout_s,
                         telemetry_port=args.telemetry_port,
                         revive_probes=args.revive_probes,
                         repair=args.repair == "on",
                         allow_empty=supervised,
                         trace_path=args.trace,
                         objectives=args.slo,
                         slo_trend_metrics=trend)
    supervisor = None
    if supervised:
        from dmlp_tpu_torch.fleet.autoscale import FleetSupervisor, ReplicaSpec
        os.makedirs(args.out_dir, exist_ok=True)
        spec = ReplicaSpec(args.spawn_corpus, args.out_dir,
                           warm_spec=args.spawn_warm,
                           batch_cap=args.spawn_batch_cap,
                           flags=shlex.split(args.spawn_flags),
                           capacity=args.spawn_capacity)
        supervisor = FleetSupervisor(
            router, spec,
            min_replicas=args.spawn_replicas,
            max_replicas=(args.max_replicas
                          if args.max_replicas is not None
                          else args.spawn_replicas + 2),
            relaunch_budget=args.relaunch_budget,
            poll_s=args.poll_s,
            unhealthy_deadline_s=args.unhealthy_deadline_s,
            scale_high=args.scale_high, scale_low=args.scale_low,
            reshard_threshold=(args.reshard_threshold
                               if args.reshard_threshold > 0 else None),
            policy=args.policy, slo=router.slo,
            slo_objective=args.slo_objective,
            lead_time_s=args.lead_time_s)
        supervisor.start()
    try:
        signal.signal(signal.SIGTERM,
                      lambda s, f: router.request_drain())
    except ValueError:
        pass   # not the main thread (embedders): drain op only
    router.start()
    sys.stderr.write(f"dmlp_tpu_torch.fleet: ready port={router.port} "
                     f"replicas={len(router.replicas)}"
                     f"{' (supervised)' if supervised else ''}\n")
    sys.stderr.flush()
    if args.ready_file:
        doc = {"port": router.port, "pid": os.getpid(),
               "replicas": [r.name for r in router.replica_list()],
               "telemetry_port": getattr(router, "telemetry_port",
                                         None)}
        if supervisor is not None:
            doc["managed"] = supervisor.snapshot()["managed"]
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, args.ready_file)
    # Wait for the drain signal OURSELVES (not run_until_drained): the
    # supervisor must stop BEFORE the drain propagates, or it would
    # read the fleet-wide orderly shutdown as a mass crash and spend
    # its relaunch budget resurrecting the replicas being drained.
    while not router._drain_event.wait(timeout=0.2):
        pass
    child_rcs = []
    if supervisor is not None:
        supervisor.stop()
    router.drain()
    if supervisor is not None:
        child_rcs = supervisor.wait_children()
    if args.record:
        from dmlp_tpu_torch.obs.run import RunRecord, current_device
        stats = router.stats()
        metrics = {
            "healthy_replicas": stats["healthy_replicas"],
            "requests_total": sum(stats["requests"].values()),
            "retries_total": sum(stats["retries"].values()),
            "rejected_total": sum(stats["rejected"].values()),
            "divergences": stats["consistency"]["divergences"],
            "repairs": stats["consistency"]["repairs"],
            "relaunches": stats["scale"]["relaunches"],
            "splits": stats["scale"]["splits"],
        }
        lat = stats.get("request_latency_ms")
        if lat:
            metrics["request_latency_p50_ms"] = lat["p50"]
            metrics["request_latency_p99_ms"] = lat["p99"]
            metrics["request_count"] = lat["count"]
        RunRecord(kind="fleet", tool="dmlp_tpu_torch.fleet",
                  config={"level": "router",
                          "replicas": len(router.replicas),
                          "supervised": supervised,
                          "mode": "closed_loop"},
                  metrics=metrics,
                  device=current_device()).append_jsonl(args.record)
    racecheck.write_report_if_requested()
    bad = [c for c in child_rcs if c["rc"] != 0]
    if supervisor is not None:
        # Orderly retirements BEFORE the drain (scale-down, re-shard
        # swap-outs) are held to the same rc-0 contract; seeded/real
        # crashes are excluded — those are the failures the supervisor
        # already absorbed by relaunching or degrading.
        bad += [e for e in supervisor.snapshot()["retired"]
                if not str(e["reason"]).startswith("crash")
                and e["rc"] != 0]
    if bad:
        sys.stderr.write(f"dmlp_tpu_torch.fleet: drained, but managed "
                         f"replica(s) exited nonzero: {bad}\n")
        return 1
    sys.stderr.write("dmlp_tpu_torch.fleet: drained clean\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
