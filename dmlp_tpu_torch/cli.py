"""Drop-in engine CLI: reads the input grammar on stdin, writes results.

Port of ``dmlp_tpu/cli.py``. stdout carries the per-query results
(checksums, or the -DDEBUG listing with ``--debug``) and stderr the
``Time taken: <ms> ms`` contract line, byte for byte as the reference
package. The timed region is the solve and the result formatting (parsing
excluded), ended by the fetch of the results from the device.

Usage::

    python -m dmlp_tpu_torch [--device cuda|cpu]
                             [--engine torch|golden|auto]
                             [--mode single|sharded|ring|auto] [--mesh R,C]
                             [--backend nccl|gloo]
                             [--pallas] [--debug] [--fast] [--device-full]
                             [--faults FILE] [--hlo-report FILE] < input.in

``--device-full`` solves with ``engine.run_device_full`` (warm-up
included): the vote and the report order on the device, in f32.

``--mode sharded|ring|auto`` runs the mesh engines (``engine.sharded``;
``auto``, the compiler-sharded engine, is ``engine.auto``: DTensor
placements and a DTensor redistribution as the merge; ``--engine auto``
is its shorthand) on an (R, C) ("data", "query") mesh of R * C ranks,
one process each: this
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

Observability (``dmlp_tpu_torch.obs``) is opt-in and leaves both contract
channels byte-identical; its extra stderr lines come after ``Time
taken``. ``--trace FILE`` writes a Perfetto-loadable span trace,
``--metrics FILE`` appends JSONL records whose final summary carries the
per-kernel cost counters (analytic FLOPs and bytes of every launch, and
on the card each kernel's CUDA-event device time and roofline share),
the collective traffic of the mesh engines, the memory model against the
allocator's peak, the scan, precision and resilience records;
``--counters`` prints the ``counters:`` / ``roofline:`` summary on stderr;
``--telemetry FILE`` / ``--telemetry-port PORT`` run the live telemetry
session (OpenMetrics snapshot and scrape endpoint, device-memory sampler,
crash flight recorder, ``FLIGHT_*.json`` beside FILE); ``--profile DIR``
writes a ``torch.profiler`` Chrome trace of the timed solve, and the
summary's ``profile`` block the device's busy time and idle share over
it. ``--hlo-report FILE`` records the collectives every rank issues in
the timed solve (``obs.hlo``: a dispatch mode, entered only with this
flag) and appends one ``kind="hlo"`` RunRecord: the record's bytes per
kind and mesh axis, held against ``obs.comms``' models (the auto engine's
against the all-gather engine's model of its plan) and the allocator's
peak against the memory model. On the mesh
rank 0 writes every artifact, and the ranks' counters are gathered into
its record.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from typing import IO, Optional, Sequence

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.io.grammar import parse_input
from dmlp_tpu_torch.io.report import format_results
from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.utils.timing import EngineTimer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dmlp_tpu_torch", description=__doc__)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the engine runs (default: the card; "
                             "no fallback when there is none)")
    parser.add_argument("--mode", default="single",
                        choices=["single", "sharded", "ring", "auto"],
                        help="engine: one device, or the mesh engines "
                             "(all-gather or ring merge, or 'auto': the "
                             "compiler-sharded engine, its merge a "
                             "DTensor redistribution)")
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
                        choices=["torch", "golden", "auto"],
                        help="'golden' runs the NumPy oracle; 'auto' is "
                             "--mode auto")
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
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler Chrome trace of the "
                             "timed solve to DIR/profile.json")
    parser.add_argument("--trace", metavar="FILE", default=None,
                        help="write a Perfetto/Chrome-trace JSON of the "
                             "run's spans to FILE (obs.trace)")
    parser.add_argument("--metrics", metavar="FILE", default=None,
                        help="append JSONL metrics to FILE; the final "
                             "summary record carries the cost counters and "
                             "the collective traffic")
    parser.add_argument("--counters", action="store_true",
                        help="print the cost counters and the roofline on "
                             "stderr after the contract line")
    parser.add_argument("--hlo-report", metavar="FILE", default=None,
                        help="append one kind='hlo' RunRecord to FILE: the "
                             "collectives every rank issued in the timed "
                             "solve (obs.hlo), reconciled against the "
                             "obs.comms models and the memory model. "
                             "Contract channels stay byte-identical")
    parser.add_argument("--telemetry", metavar="FILE", default=None,
                        help="live telemetry (obs.telemetry): rewrite FILE "
                             "as an OpenMetrics snapshot, sample the "
                             "device's memory, arm the crash flight "
                             "recorder (FLIGHT_*.json beside FILE)")
    parser.add_argument("--telemetry-port", type=int, default=None,
                        metavar="PORT",
                        help="serve the OpenMetrics text on "
                             "localhost:PORT/metrics (0 = ephemeral; "
                             "implies the telemetry session)")
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
    if config.mode == "auto":
        from dmlp_tpu_torch.engine.auto import AutoShardedEngine
        return AutoShardedEngine(config)
    raise ValueError(f"unknown mode {config.mode!r}")


def main(argv: Optional[Sequence[str]] = None,
         stdin: Optional[IO] = None,
         stdout: Optional[IO] = None,
         stderr: Optional[IO] = None) -> int:
    parser = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    args.mesh_shape = parse_mesh_arg(parser, args.mesh)
    if args.engine == "auto":
        # --engine auto == the torch engine in the compiler-sharded mode.
        args.engine, args.mode = "torch", "auto"
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr

    from dmlp_tpu_torch.resilience import inject as rs_inject
    from dmlp_tpu_torch.resilience import stats as rs_stats
    mesh = args.engine == "torch" and args.mode in ("sharded", "ring",
                                                    "auto")
    # A mesh rank started by local_cluster or torchrun carries RANK: only
    # rank 0 writes the trace, the telemetry file and the metrics; every
    # rank counts its own launches for rank 0's record.
    root = not mesh or os.environ.get("RANK", "0") == "0"
    rs_stats.reset()   # resets the registry's resilience.* counters too
    tracer = probe = session = None
    telemetry_on = root and (args.telemetry
                             or args.telemetry_port is not None)
    if (args.metrics or telemetry_on) and args.device == "cuda":
        import torch
        if torch.cuda.is_available():
            # The memory record and the sampler read the allocator's
            # peak: this run's, not one an earlier caller in this process
            # reached (reset before the sampler's first tick).
            torch.cuda.reset_peak_memory_stats()
    if telemetry_on:
        from dmlp_tpu_torch.obs import telemetry
        session = telemetry.start(path=args.telemetry,
                                  port=args.telemetry_port,
                                  device=args.device)
    if root and args.trace:
        from dmlp_tpu_torch.obs import trace as obs_trace
        tracer = obs_trace.install(
            obs_trace.Tracer(annotate=bool(args.profile)))
    if args.metrics or args.counters:
        from dmlp_tpu_torch.obs import counters as obs_counters
        probe = obs_counters.install()
    schedule = rs_inject.install_from_env(args.faults)
    try:
        if mesh:
            return _run_mesh_cli(args, argv, stdin, stdout, stderr, probe)
        return _run_cli(args, stdin, stdout, stderr, probe, tracer)
    except Exception:
        # The flight recorder's reason to exist: the last spans, events
        # and metric deltas survive the crash as FLIGHT_*.json. A usage
        # error's SystemExit is not a crash.
        if session is not None:
            from dmlp_tpu_torch.obs import telemetry
            telemetry.dump_on_crash("crash")
        raise
    finally:
        if schedule is not None:
            rs_inject.write_log_if_requested()
            rs_inject.uninstall()
        if tracer is not None:
            from dmlp_tpu_torch.obs import trace as obs_trace
            obs_trace.uninstall()
        if probe is not None:
            from dmlp_tpu_torch.obs import counters as obs_counters
            obs_counters.uninstall()
        if session is not None:
            session.close()


def _config(args) -> EngineConfig:
    return EngineConfig(mode=args.mode, mesh_shape=args.mesh_shape,
                        debug=args.debug, exact=not args.fast,
                        data_block=args.data_block,
                        query_block=args.query_block, dtype=args.dtype,
                        select=args.select, use_pallas=args.pallas,
                        device=args.device)


def _profiled(args, out: dict):
    """``--profile DIR``: a torch.profiler capture of the timed solve
    (the card's kernels and copies with it on CUDA), written as
    DIR/profile.json; ``out`` receives the device's busy time and idle
    share over the window (obs.counters.profile_block)."""
    if not args.profile:
        return contextlib.nullcontext()
    import time

    from torch.profiler import ProfilerActivity, profile

    from dmlp_tpu_torch.obs.counters import profile_block

    @contextlib.contextmanager
    def capture():
        acts = [ProfilerActivity.CPU]
        if args.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            yield
            wall_ms = (time.perf_counter() - t0) * 1e3
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "profile.json")
        prof.export_chrome_trace(path)
        out.update(profile_block(prof, wall_ms), trace=path)
    return capture()


def _run_cli(args, stdin, stdout, stderr, probe, tracer) -> int:
    config = _config(args)
    engine = None
    if args.engine == "torch":
        # Built before parsing so a missing card fails fast.
        engine = make_engine(config)

    timer = EngineTimer()
    prof = {}    # --profile's device busy time and idle share
    with timer.phase("parse"), obs_span("cli.parse"):
        inp = parse_input(stdin)

    # Only the solve is timed, matching the reference's timed region
    # (common.cpp:122-131 brackets Engine::KNN after ingest).
    if engine is None:
        timer.start()
        from dmlp_tpu_torch.golden.reference import knn_golden
        with obs_span("cli.solve", engine="golden"):
            results = knn_golden(inp)
    else:
        solve = engine.run_device_full if args.device_full else engine.run
        if args.warmup:
            with timer.phase("warmup"), obs_span("cli.warmup_compile"):
                solve(inp)
            if probe is not None:
                # The warm-up recorded the launches the timed solve is
                # about to make; counters cover the timed solve only.
                probe.reset()
        with _profiled(args, prof):
            timer.start()
            with obs_span("cli.solve", mode=args.mode, engine="torch"):
                results = solve(inp)
    with timer.phase("format"), obs_span("cli.format_results"):
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
    # -- the observability epilogue (after the contract lines) -------------
    if args.hlo_report:
        # A one-device solve issues no collective: nothing is recorded.
        _emit_hlo_report(args, inp, engine, None)
    if probe is not None or tracer is not None:
        counters = None
        if probe is not None:
            with obs_span("cli.collect_counters"):
                counters = probe.collect()
        _epilogue(args, inp, timer, engine, counters, stderr, prof=prof)
        if tracer is not None:
            tracer.write(args.trace)
    return 0


def _epilogue(args, inp, timer, engine, counters, stderr, comms=None,
              prof=None) -> None:
    """The metrics record and the ``--counters`` lines of one run (rank 0
    on the mesh), outside the timed region."""
    phase_ms = dict(timer.phase_ms)
    if engine is not None:
        phase_ms.update(getattr(engine, "last_phase_ms", {}))
    if comms is None and engine is not None and engine.last_comms:
        from dmlp_tpu_torch.obs.comms import summarize
        comms = summarize(engine.last_comms)
    kernel_ms = sum(p.get("device_ms", 0.0) for p in (counters or {}).get(
        "per_kernel", {}).values())
    if kernel_ms and timer.elapsed_ms:
        # The timed region as the kernels' events see it: any other
        # device work (copies, PyTorch's own kernels) counts as idle, so
        # this idle share is an upper bound (--profile measures it).
        counters["kernels_device_ms"] = kernel_ms
        counters["kernels_idle_share"] = 1.0 - kernel_ms / timer.elapsed_ms
    mem = None
    if args.metrics and engine is not None:
        # The memory model against the sampler's tracked peak when a
        # session ran, else the allocator's peak (the explicit marker
        # on the CPU).
        from dmlp_tpu_torch.obs import memwatch, telemetry
        try:
            model = memwatch.model_for_engine(engine, inp)
            sess = telemetry.session()
            measured = (sess.sampler.measured_peak() if sess
                        else memwatch.peak_watermark(engine.device))
            mem = memwatch.reconcile(model, measured)
        except Exception:  # obs never fails a run: counted, not raised
            telemetry.registry().counter("obs.errors").inc(label="mem")
    if args.metrics:
        _emit_metrics(args, inp, timer, phase_ms, counters, comms, engine,
                      mem, prof)
    if args.counters:
        _emit_counters_stderr(counters, timer.elapsed_ms, stderr,
                              engine.device if engine is not None
                              else None)


def _emit_metrics(args, inp, timer, phase_ms, counters, comms, engine,
                  mem, prof) -> None:
    """Append per-phase records and one run summary to the metrics JSONL.
    The summary always carries a ``counters`` block: the cost counters or
    the explicit ``counters_unavailable`` marker, never silence."""
    from dmlp_tpu_torch.obs.run import SCHEMA_VERSION
    from dmlp_tpu_torch.resilience import inject as rs_inject
    from dmlp_tpu_torch.resilience import stats as rs_stats
    from dmlp_tpu_torch.utils.metrics_log import MetricsLogger

    with MetricsLogger(path=args.metrics) as mlog:
        for name, ms in phase_ms.items():
            mlog.log(event="phase", name=name, ms=round(ms, 3))
        summary = {
            "event": "summary", "schema": SCHEMA_VERSION,
            "mode": args.mode, "engine": args.engine,
            "exact": not args.fast,
            "elapsed_ms": round(timer.elapsed_ms, 3),
            "num_data": inp.params.num_data,
            "num_queries": inp.params.num_queries,
            "num_attrs": inp.params.num_attrs,
            "counters": counters if counters is not None
            else {"counters_unavailable": True},
        }
        extras = {"comms": comms, "profile": prof or None,
                  "extract_impl": getattr(engine, "last_extract_impl",
                                          None),
                  "mem": mem, "prune": getattr(engine, "last_prune", None),
                  "precision": getattr(engine, "last_precision", None)}
        summary.update({k: v for k, v in extras.items() if v is not None})
        # Recovery is never silent: with any resilience activity, or a
        # fault schedule installed, the summary carries the counters.
        if rs_stats.any_activity() or rs_inject.active() is not None:
            summary["resilience"] = rs_stats.snapshot()
        mlog.log(**summary)


def _emit_hlo_report(args, inp, engine, report) -> None:
    """Append the ``kind="hlo"`` RunRecord of the timed solve's record
    (``obs.hlo``), outside the timed region: the comms leg holds it
    against ``obs.comms``' models — the engine's ``last_comms``, or for
    the auto engine the all-gather engine's model of its plan, since its
    own ``last_comms`` is derived from the record — and the memory leg
    the allocator's peak against the memory model."""
    from dmlp_tpu_torch.obs import hlo as obs_hlo
    from dmlp_tpu_torch.obs import memwatch
    from dmlp_tpu_torch.obs.run import (RunRecord, current_device,
                                        round_from_name)
    reports = [] if report is None else [(report, 1, "cli.solve")]
    traffics = engine.allgather_twin_comms() \
        if hasattr(engine, "allgather_twin_comms") \
        else getattr(engine, "last_comms", None)
    mem = None
    if engine is not None and inp is not None:
        mem = {"model_bytes": memwatch.model_for_engine(engine, inp)[
            "total_bytes"]}
    doc = obs_hlo.build_report_doc(reports, traffics=traffics,
                                   mem_block=mem)
    mesh = getattr(engine, "mesh", None)
    RunRecord(
        kind="hlo", tool="dmlp_tpu_torch.cli",
        config={"mode": args.mode, "engine": args.engine,
                "exact": not args.fast,
                **({"mesh": list(mesh.shape)} if mesh is not None else {}),
                **({"plan": engine.last_plan}
                   if getattr(engine, "last_plan", None) else {})},
        metrics=obs_hlo.flat_metrics(doc), comms=doc,
        device=current_device(getattr(engine, "device", None)),
        round=round_from_name(args.hlo_report)).append_jsonl(
            args.hlo_report)


def _emit_counters_stderr(counters, elapsed_ms: float, stderr,
                          device) -> None:
    """The ``--counters`` summary, after the contract line."""
    if not counters or counters.get("counters_unavailable"):
        stderr.write("counters: unavailable (no recorded launches)\n")
        return
    from dmlp_tpu_torch.obs.counters import roofline
    stderr.write(f"counters: flops={counters['flops']:.4e} "
                 f"hbm_bytes={counters['bytes_accessed']:.4e} "
                 f"dispatches={counters['dispatches_recorded']}\n")
    rl = roofline(counters["flops"], counters["bytes_accessed"],
                  elapsed_ms / 1e3, device=device)
    if "achieved_flops_per_s" in rl:
        line = f"roofline: {rl['achieved_flops_per_s']:.4e} FLOP/s achieved"
        if "utilization_vs_peak" in rl:
            line += (f", {rl['utilization_vs_peak'] * 100:.3f}% of "
                     f"{rl['peak_flops_per_chip']:.3g} peak")
        if "arithmetic_intensity" in rl:
            line += f", {rl['arithmetic_intensity']:.2f} FLOP/B"
        stderr.write(line + "\n")


def _run_mesh_cli(args, argv, stdin, stdout, stderr, probe) -> int:
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
        return _solve_on_mesh(args, config, stdin, stdout, stderr, probe)


def _solve_on_mesh(args, config, stdin, stdout, stderr, probe) -> int:
    """Every rank: the same solves in step; rank 0 parses, times, prints."""
    from dmlp_tpu_torch import kernels
    from dmlp_tpu_torch.parallel.collectives import gather_objects

    engine = make_engine(config)
    timer = EngineTimer()
    prof = {}
    inp = None
    if engine.root:
        with timer.phase("parse"), obs_span("cli.parse"):
            inp = parse_input(stdin)
    solve = engine.run_device_full if args.device_full else engine.run
    if args.warmup:
        with timer.phase("warmup"), obs_span("cli.warmup_compile"):
            solve(inp)
        if probe is not None:
            probe.reset()
    record = contextlib.nullcontext()
    if args.hlo_report:
        from dmlp_tpu_torch.obs import hlo as obs_hlo
        record = obs_hlo.recording(engine, label="cli.solve")
    with _profiled(args, prof) if engine.root \
            else contextlib.nullcontext():
        timer.start()
        with record as recorder, obs_span("cli.solve", mode=args.mode,
                                          engine="torch"):
            results = solve(inp)
    if args.hlo_report and hasattr(engine, "comms_from_hlo"):
        # The auto engine's last_comms from what it issued, before the
        # metrics summarize them.
        engine.comms_from_hlo()
    text = None
    if engine.root:
        with timer.phase("format"), obs_span("cli.format_results"):
            text = format_results(results, debug=config.debug)
        timer.stop()
    # Every rank's counters and traffic record, gathered to rank 0 (the
    # same flags on every rank, so every rank takes part).
    obs_ranks = gather_objects({
        "rank": engine.rank,
        "counters": probe.collect(),
        "comms": [t.to_dict() for t in engine.last_comms]}) \
        if probe is not None else None
    ranks = gather_objects({
        "rank": engine.rank, "coords": list(engine.coords),
        "device": str(engine.device), "phases_ms": engine.last_phase_ms,
        "launches": dict(kernels.LAUNCHES)}) if args.phase_times else None
    if not engine.root:
        return 0
    stdout.write(text)
    stderr.write(timer.stderr_line())
    if args.hlo_report:
        _emit_hlo_report(args, inp, engine, recorder.report)
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
    if obs_ranks is not None:
        from dmlp_tpu_torch.obs.comms import summarize
        from dmlp_tpu_torch.obs.counters import merge_collected
        comms = summarize(engine.last_comms)
        # Every rank models the whole mesh's traffic from the one plan.
        comms["ranks_agree"] = all(r["comms"] == obs_ranks[0]["comms"]
                                   for r in obs_ranks)
        _epilogue(args, inp, timer, engine,
                  merge_collected([r["counters"] for r in obs_ranks]),
                  stderr, comms=comms, prof=prof)
    from dmlp_tpu_torch.obs import trace as obs_trace
    tracer = obs_trace.active()
    if tracer is not None:
        tracer.write(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
