"""The controls of the comparison that decides ``correct``, on the card
at a cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds a,b,c \
        [--seconds S] [--program-bf16]

(or ``--config`` and ``--traffic`` in place of ``--workload``).

For each seed it prints one JSON line: the numbers the cell's judge gives
when the reference, computed in the precision just below the one the
cell states, stands in for the program (batch cells: TF32 products;
served cells: float32 over the requests a window of ``--seconds``, by
default ``run_seconds``, sends). With ``--program-bf16`` a batch cell's
line also judges the program's own bfloat16-staged path. Each number has
to fail its limit on every seed: ``tests/test_bench_control.py`` holds
the same at a test's size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark.run import prepare_env
from benchmark.spec import add_cell_args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_cell_args(ap)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--program-bf16", action="store_true")
    args = ap.parse_args(argv)
    prepare_env()
    import torch
    from benchmark.drivers.common import Run
    from benchmark.harness import driver
    from benchmark.spec import Spec, cli_cell

    cell = cli_cell(args)
    seconds = args.seconds or float(Spec.load().doc["run_seconds"])
    kind = driver(cell.traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                device=torch.device("cuda", 0), t0=t0)
        extra = {"program_bf16": True} if args.program_bf16 else {}
        out = kind.control(r, **extra)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "limits": cell.traffic["limits"], **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
