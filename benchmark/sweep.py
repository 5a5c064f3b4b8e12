"""The knee sweep of an open-loop cell: one daemon, one window at each
offered rate, in one process.

    python3 -m benchmark.sweep --config sift1m --traffic open_single \
        --seed N --seconds 15 --rates 100,200,400 [--connections 2048]

(or ``--workload <cell>`` for a cell of ``BENCHMARK.json``).

For each rate it prints one JSON line: requests offered and answered,
the client's p50 / p95 / p99 from the due time, the backlog (the median
latency of the window's last fifth over its first fifth: above 1 the
queue grew), the generator's lateness and the mean micro-batch. The knee
is the highest rate whose backlog stays flat and whose p95 stays within
the limit the mix then fixes; the cell runs at about four fifths of it.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

from benchmark.run import prepare_env
from benchmark.spec import add_cell_args


def summarize(records, seconds: float, fail_ms: float):
    from benchmark.drivers.open_loop import latencies
    lat = latencies(records, seconds, fail_ms)
    s = sorted(lat)
    pick = (lambda p: s[max(0, -(-len(s) * p // 100) - 1)]) if s else None
    due = [rec for rec in records if rec[0] <= seconds]
    fifth = max(1, len(due) // 5)

    def med(rs):
        v = sorted(rec[1] if rec[2] == "ok" else fail_ms for rec in rs)
        return v[len(v) // 2]
    return {"offered": len(due),
            "answered": sum(1 for rec in due if rec[2] == "ok"),
            "p50_ms": pick(50), "p95_ms": pick(95), "p99_ms": pick(99),
            "backlog": med(due[-fifth:]) / max(med(due[:fifth]), 1e-9)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_cell_args(ap)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--connections", type=int, default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    prepare_env()
    import torch
    from benchmark.drivers.common import Run
    from benchmark.drivers.open_loop import LoadGen, drive, start_daemon
    from benchmark.spec import cli_cell

    cell = cli_cell(args)
    r = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
            device=torch.device("cuda", 0), t0=t0)
    daemon, _ = start_daemon(r)
    engine = daemon.engine
    engine.batch_log = collections.deque(engine.batch_log)
    fail_ms = float(cell.traffic["drain_timeout_s"]) * 1e3
    gen = None
    try:
        gen = LoadGen(r, daemon.port, args.connections
                      or int(cell.traffic["connections"]))
        print(json.dumps({"setup_s": time.perf_counter() - t0,
                          **gen.ready}), flush=True)
        for rate in (float(x) for x in args.rates.split(",")):
            seq0 = engine.batches_solved
            out = drive(daemon, gen, rate, args.seconds)
            nq = [e["nq"] for e in engine.batch_log if e["seq"] > seq0]
            line = {"rate_per_s": rate,
                    **summarize(out["records"], args.seconds, fail_ms),
                    "lateness_ms": out["lateness_ms"],
                    "connections_opened": out["connections_opened_in_window"],
                    "batches": len(nq),
                    "mean_batch": sum(nq) / len(nq) if nq else None}
            print(json.dumps(line), flush=True)
    finally:
        if gen is not None:
            gen.close()
        daemon.drain()
    return 0


if __name__ == "__main__":
    sys.exit(main())
