"""Drop-in engine CLI: reads the input grammar on stdin, writes results.

Port of ``dmlp_tpu/cli.py``. stdout carries the per-query results
(checksums, or the -DDEBUG listing with ``--debug``) and stderr the
``Time taken: <ms> ms`` contract line, byte for byte as the reference
package. The timed region is the solve and the result formatting (parsing
excluded), ended by the fetch of the results from the device.

Usage::

    python -m dmlp_tpu_torch [--device cuda|cpu] [--engine torch|golden]
                             [--mode single|sharded|ring] [--mesh R,C]
                             [--backend nccl|gloo]
                             [--pallas] [--debug] [--fast] [--device-full]
                             [--faults FILE] < input.in

``--device-full`` solves with ``engine.run_device_full`` (warm-up
included): the vote and the report order on the device, in f32.

``--mode sharded|ring`` runs the mesh engines (``engine.sharded``) on an
(R, C) ("data", "query") mesh of R * C ranks, one process each: this
process is rank 0 (it alone reads stdin and prints) and starts the other
ranks on this host before the timer starts, the ``mpirun -np`` analog
(``parallel.distributed.local_cluster``); under torchrun (``RANK`` and
``WORLD_SIZE`` set) each process is the rank torchrun made it. Without
``--mesh`` the shape is ``balanced_dims`` of the visible cards, or on
``--device cpu`` of min(8, the CPU count). The collectives run on NCCL
on the card and gloo on the CPU; ``--backend gloo`` runs the ranks on
shared cards (NCCL takes one card per rank) with gloo collectives staged
through host memory. ``--phase-times`` then also prints the mesh, the
backend and each rank's device, phases and kernel launches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
    parser.add_argument("--mode", default="single",
                        choices=["single", "sharded", "ring", "auto"],
                        help="engine: one device, or the mesh engines "
                             "(all-gather or ring merge); 'auto' (the "
                             "compiler-sharded engine) is not ported")
    parser.add_argument("--mesh", default=None, metavar="R,C",
                        help="mesh shape (data x query axes) of the mesh "
                             "engines: R * C ranks; default balanced_dims "
                             "of the cards (of min(8, CPUs) on --device "
                             "cpu)")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="collectives of the mesh engines (default: "
                             "nccl on cuda, gloo on cpu); gloo on cuda "
                             "runs several ranks per card")
    parser.add_argument("--engine", default="torch",
                        choices=["torch", "golden"],
                        help="'golden' runs the NumPy oracle")
    parser.add_argument("--debug", action="store_true",
                        help="human-readable output (the -DDEBUG build)")
    parser.add_argument("--fast", action="store_true",
                        help="skip the float64 host rescore (f32 ordering)")
    parser.add_argument("--device-full", action="store_true",
                        help="vote + report ordering on the device too "
                             "(f32 ordering, dense, no repair)")
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


def parse_mesh_arg(parser, value):
    """Validate an R,C mesh flag (an argparse usage error, not a
    traceback)."""
    if not value:
        return None
    parts = value.split(",")
    if len(parts) != 2 or not all(p.strip().lstrip("-").isdigit()
                                  for p in parts):
        parser.error(f"--mesh expects R,C (two integers), got {value!r}")
    r, c = int(parts[0]), int(parts[1])
    if r <= 0 or c <= 0:
        parser.error(f"--mesh axes must be positive, got {value!r}")
    return (r, c)


def default_mesh_shape(device: str):
    """``balanced_dims`` of the visible cards, or of min(8, the CPU count)
    ranks on the CPU."""
    from dmlp_tpu_torch.parallel.mesh import balanced_dims
    if device == "cuda":
        import torch
        return balanced_dims(max(torch.cuda.device_count(), 1))
    return balanced_dims(min(os.cpu_count() or 1, 8))


def make_engine(config: EngineConfig):
    """The engine registry. The mesh engines need the process group up
    (``parallel.distributed.initialize``); a mesh shape is never swapped
    for another."""
    if config.mode == "single":
        from dmlp_tpu_torch.engine.single import SingleChipEngine
        return SingleChipEngine(config)
    if config.mode == "sharded":
        from dmlp_tpu_torch.engine.sharded import ShardedEngine
        return ShardedEngine(config)
    if config.mode == "ring":
        from dmlp_tpu_torch.engine.ring import RingEngine
        return RingEngine(config)
    raise NotImplementedError(
        f"mode {config.mode!r}: the compiler-sharded engine is ROADMAP.md "
        "item A10 — not ported yet")


def main(argv: Optional[Sequence[str]] = None,
         stdin: Optional[IO] = None,
         stdout: Optional[IO] = None,
         stderr: Optional[IO] = None) -> int:
    parser = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    args.mesh_shape = parse_mesh_arg(parser, args.mesh)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr

    from dmlp_tpu_torch.resilience import inject as rs_inject
    from dmlp_tpu_torch.resilience import stats as rs_stats
    rs_stats.reset()
    schedule = rs_inject.install_from_env(args.faults)
    try:
        if args.engine == "torch" and args.mode in ("sharded", "ring"):
            return _run_mesh_cli(args, argv, stdin, stdout, stderr)
        return _run_cli(args, stdin, stdout, stderr)
    finally:
        if schedule is not None:
            rs_inject.write_log_if_requested()
            rs_inject.uninstall()


def _config(args) -> EngineConfig:
    return EngineConfig(mode=args.mode, mesh_shape=args.mesh_shape,
                        debug=args.debug, exact=not args.fast,
                        data_block=args.data_block,
                        query_block=args.query_block, dtype=args.dtype,
                        select=args.select, use_pallas=args.pallas,
                        device=args.device)


def _run_cli(args, stdin, stdout, stderr) -> int:
    config = _config(args)
    engine = None
    if args.engine == "torch":
        # Built before parsing so a missing card fails fast.
        engine = make_engine(config)

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
        solve = engine.run_device_full if args.device_full else engine.run
        if args.warmup:
            with timer.phase("warmup"):
                solve(inp)
        timer.start()
        results = solve(inp)
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


def _run_mesh_cli(args, argv, stdin, stdout, stderr) -> int:
    """The mesh engines: join the cluster torchrun started, or start one
    of R * C ranks on this host with this process as rank 0."""
    from dmlp_tpu_torch.parallel import distributed as pd
    from dmlp_tpu_torch.parallel.mesh import balanced_dims

    config = _config(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        shape = config.mesh_shape or balanced_dims(
            int(os.environ["WORLD_SIZE"]))
        group = pd.process_group(auto=True, device=args.device,
                                 backend=args.backend)
    else:
        shape = config.mesh_shape or default_mesh_shape(args.device)
        world = shape[0] * shape[1]
        # NCCL with more ranks than cards is refused before anything starts.
        pd.resolve_backend(args.device, args.backend, world)
        if args.device == "cuda" and args.pallas and world > 1:
            # Once here, not once per rank.
            from dmlp_tpu_torch import kernels
            kernels.build_all()
        group = pd.process_group(device=args.device, backend=args.backend) \
            if world == 1 else pd.local_cluster(
                world, ["-m", "dmlp_tpu_torch", *argv], device=args.device,
                backend=args.backend)
    config = dataclasses.replace(config, mesh_shape=tuple(shape))
    with group:
        return _solve_on_mesh(args, config, stdin, stdout, stderr)


def _solve_on_mesh(args, config, stdin, stdout, stderr) -> int:
    """Every rank: the same solves in step; rank 0 parses, times, prints."""
    from dmlp_tpu_torch import kernels
    from dmlp_tpu_torch.parallel.collectives import gather_objects

    engine = make_engine(config)
    timer = EngineTimer()
    inp = None
    if engine.root:
        with timer.phase("parse"):
            inp = parse_input(stdin)
    solve = engine.run_device_full if args.device_full else engine.run
    if args.warmup:
        with timer.phase("warmup"):
            solve(inp)
    timer.start()
    results = solve(inp)
    text = None
    if engine.root:
        with timer.phase("format"):
            text = format_results(results, debug=config.debug)
        timer.stop()
    ranks = gather_objects({
        "rank": engine.rank, "coords": list(engine.coords),
        "device": str(engine.device), "phases_ms": engine.last_phase_ms,
        "launches": dict(kernels.LAUNCHES)}) if args.phase_times else None
    if not engine.root:
        return 0
    stdout.write(text)
    stderr.write(timer.stderr_line())
    if args.phase_times:
        phases = dict(timer.phase_ms)
        phases.update({f"engine.{k}": v
                       for k, v in engine.last_phase_ms.items()})
        for name, ms in phases.items():
            stderr.write(f"phase {name}: {ms:.1f} ms\n")
        stderr.write(f"repairs: {engine.last_repairs}\n")
        stderr.write(f"prune: {json.dumps(engine.last_prune)}\n")
        stderr.write(f"hetk: {json.dumps(engine.last_hetk)}\n")
        stderr.write("mesh: " + json.dumps({
            "mode": config.mode, "shape": list(config.mesh_shape),
            "backend": engine.backend, "ranks": ranks}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
