"""Drop-in engine CLI: reads the input grammar on stdin, writes results.

Port of ``dmlp_tpu/cli.py``. stdout carries the per-query results
(checksums, or the -DDEBUG listing with ``--debug``) and stderr the
``Time taken: <ms> ms`` contract line, byte for byte as the reference
package. The timed region is the solve and the result formatting (parsing
excluded), ended by the fetch of the results from the device.

Usage::

    python -m dmlp_tpu_torch [--device cuda|cpu] [--engine torch|golden]
                             [--pallas] [--debug] [--fast]
                             [--faults FILE] < input.in
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import IO, Optional, Sequence

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.io.grammar import parse_input
from dmlp_tpu_torch.io.report import format_results
from dmlp_tpu_torch.utils.timing import EngineTimer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dmlp_tpu_torch", description=__doc__)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the engine runs (default: the card; "
                             "no fallback when there is none)")
    parser.add_argument("--engine", default="torch",
                        choices=["torch", "golden"],
                        help="'golden' runs the NumPy oracle")
    parser.add_argument("--debug", action="store_true",
                        help="human-readable output (the -DDEBUG build)")
    parser.add_argument("--fast", action="store_true",
                        help="skip the float64 host rescore (f32 ordering)")
    parser.add_argument("--data-block", type=int, default=None,
                        help="data rows per chunk (default: per select)")
    parser.add_argument("--query-block", type=int, default=1024)
    parser.add_argument("--dtype", default="auto",
                        choices=["auto", "float32", "bfloat16"],
                        help="staging dtype; auto = float32")
    parser.add_argument("--select", default="auto",
                        choices=["auto", "sort", "topk", "seg", "extract"],
                        help="device k-selection strategy")
    parser.add_argument("--pallas", action="store_true",
                        help="the hand-written kernels (implies extract "
                             "selection on large inputs)")
    parser.add_argument("--warmup", action="store_true",
                        help="run the solve once untimed first (kernel "
                             "build and first-launch costs)")
    parser.add_argument("--phase-times", action="store_true",
                        help="per-phase ms breakdown on stderr, then the "
                             "repairs, the degradation rung and the scan "
                             "accounting of the solve")
    parser.add_argument("--faults", metavar="FILE", default=None,
                        help="deterministic fault-injection schedule (JSON; "
                             "dmlp_tpu_torch.resilience.inject); "
                             "$DMLP_TPU_FAULTS sets it too. Recovery keeps "
                             "stdout byte-identical")
    return parser


def main(argv: Optional[Sequence[str]] = None,
         stdin: Optional[IO] = None,
         stdout: Optional[IO] = None,
         stderr: Optional[IO] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr

    from dmlp_tpu_torch.resilience import inject as rs_inject
    from dmlp_tpu_torch.resilience import stats as rs_stats
    rs_stats.reset()
    schedule = rs_inject.install_from_env(args.faults)
    try:
        return _run_cli(args, stdin, stdout, stderr)
    finally:
        if schedule is not None:
            rs_inject.write_log_if_requested()
            rs_inject.uninstall()


def _run_cli(args, stdin, stdout, stderr) -> int:
    config = EngineConfig(debug=args.debug, exact=not args.fast,
                          data_block=args.data_block,
                          query_block=args.query_block, dtype=args.dtype,
                          select=args.select, use_pallas=args.pallas,
                          device=args.device)
    engine = None
    if args.engine == "torch":
        # Built before parsing so a missing card fails fast.
        from dmlp_tpu_torch.engine.single import SingleChipEngine
        engine = SingleChipEngine(config)

    timer = EngineTimer()
    with timer.phase("parse"):
        inp = parse_input(stdin)

    # Only the solve is timed, matching the reference's timed region
    # (common.cpp:122-131 brackets Engine::KNN after ingest).
    if engine is None:
        timer.start()
        from dmlp_tpu_torch.golden.reference import knn_golden
        results = knn_golden(inp)
    else:
        if args.warmup:
            with timer.phase("warmup"):
                engine.run(inp)
        timer.start()
        results = engine.run(inp)
    with timer.phase("format"):
        text = format_results(results, debug=config.debug)
    timer.stop()

    stdout.write(text)
    stderr.write(timer.stderr_line())
    if args.phase_times:
        phases = dict(timer.phase_ms)
        if engine is not None:
            phases.update({f"engine.{k}": v
                           for k, v in engine.last_phase_ms.items()})
        for name, ms in phases.items():
            stderr.write(f"phase {name}: {ms:.1f} ms\n")
        if engine is not None:
            stderr.write(f"repairs: {engine.last_repairs}\n")
            stderr.write(f"rung: {engine.last_degrade_rung}\n")
            stderr.write(f"prune: {json.dumps(engine.last_prune)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
