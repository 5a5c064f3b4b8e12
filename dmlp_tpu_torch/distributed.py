"""Multi-process launcher: ``mpirun ./engine < input`` — port of
``dmlp_tpu/distributed.py``.

One process per rank of an (R, C) ("data", "query") mesh, each running::

    python -m dmlp_tpu_torch.distributed --input FILE \\
        [--coordinator HOST:PORT --processes N --process-id I | --auto]
        [--mode sharded|ring] [--mesh R,C] [--select ...] [--pallas]
        [--device cuda|cpu] [--backend nccl|gloo] [--warmup]

Per rank (``parallel.distributed.distributed_contract_run``): the process
group comes up (``--auto`` reads torchrun's environment) -> the rank
parses only its own rows of the file -> its per-shard top-k on the card
-> the float64 rescore on the rank that owns the shard -> a host
all-gather of the small candidate lists -> every rank merges and
finalizes; rank 0 prints the checksums in query order on stdout and
``Time taken: <ms> ms`` on stderr.

``--supervise N`` is the launcher mode: this process starts N rank
processes of this entry on this host under heartbeat and deadline
supervision (``resilience.supervise``); a dead or hung rank kills and
relaunches the cluster (``--max-launches``), and then the solve degrades
to one in-process rank with the same checksums.

``--trace DIR`` writes one ``DIR/trace-rank<NN>.json`` per rank
(``obs.dist_trace``: the rank is the Perfetto pid, with a clock-sync
marker stamped right after the contract barrier; merge the files with
``tools/merge_traces.py``). ``--telemetry FILE`` runs each rank's live
telemetry session (``FILE.rank<NN>`` when there is more than one rank),
with the crash flight recorder beside it.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dmlp_tpu_torch.distributed",
                                description=__doc__)
    p.add_argument("--input", required=True,
                   help="input file (every rank reads its own slice — "
                        "stdin cannot be sharded)")
    p.add_argument("--mode", default="sharded", choices=["sharded", "ring"])
    p.add_argument("--mesh", default=None, help="R,C (data x query axes); "
                   "default balanced_dims of the process count")
    p.add_argument("--select", default="auto",
                   choices=["auto", "sort", "topk", "seg", "extract"])
    p.add_argument("--data-block", type=int, default=None)
    p.add_argument("--pallas", action="store_true",
                   help="the hand-written kernels")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--warmup", action="store_true",
                   help="run the solve once untimed first")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="collectives (default: nccl on cuda, gloo on cpu); "
                        "gloo on cuda runs several ranks per card")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of process 0")
    p.add_argument("--processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--auto", action="store_true",
                   help="read the topology from torchrun's environment")
    p.add_argument("--phase-times", action="store_true",
                   help="rank 0 prints, after Time taken, one 'mesh:' "
                        "line: the backend and each rank's coordinates, "
                        "device and kernel launches")
    p.add_argument("--faults", metavar="FILE", default=None,
                   help="deterministic fault-injection schedule (JSON; "
                        "dmlp_tpu_torch.resilience.inject); "
                        "$DMLP_TPU_FAULTS sets it too")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="per-rank span traces: DIR/trace-rank<NN>.json "
                        "with clock-sync markers (obs.dist_trace)")
    p.add_argument("--telemetry", metavar="FILE", default=None,
                   help="per-rank live telemetry (obs.telemetry): an "
                        "OpenMetrics snapshot of FILE (.rankNN-suffixed "
                        "with more than one rank) and the crash flight "
                        "recorder")
    p.add_argument("--supervise", type=int, default=None, metavar="N",
                   help="launcher mode: start N rank processes of this "
                        "entry under heartbeat and deadline supervision")
    p.add_argument("--supervise-timeout", type=float, default=300.0,
                   help="cluster deadline per supervised launch (s)")
    p.add_argument("--supervise-dir", default=None,
                   help="supervisor workdir for the ranks' logs and "
                        "heartbeat files (default: a temporary directory)")
    p.add_argument("--max-launches", type=int, default=2,
                   help="supervised cluster launches before the "
                        "single-process fallback")
    return p


def _config(args, mesh_shape):
    from dmlp_tpu_torch.config import EngineConfig
    return EngineConfig(mode=args.mode, mesh_shape=mesh_shape,
                        select=args.select, data_block=args.data_block,
                        use_pallas=args.pallas, debug=args.debug,
                        device=args.device)


def _contract_run(args, mesh_shape, out, err) -> None:
    """This process's rank of the contract run, on the process group that
    is up: the engine over the whole group, then the run."""
    import torch.distributed as dist

    from dmlp_tpu_torch.cli import make_engine
    from dmlp_tpu_torch.parallel.distributed import distributed_contract_run
    from dmlp_tpu_torch.parallel.mesh import balanced_dims

    shape = mesh_shape or balanced_dims(dist.get_world_size())
    engine = make_engine(_config(args, tuple(shape)))
    tracer = None
    if args.trace:
        from dmlp_tpu_torch.obs import dist_trace
        tracer = dist_trace.install(args.trace, dist.get_rank(),
                                    dist.get_world_size())
        tracer.record_mesh(engine.mesh)
    try:
        distributed_contract_run(args.input, engine, out=out, err=err,
                                 warmup=args.warmup)
    finally:
        if tracer is not None:
            # The rank file is filesystem-only: the contract channels
            # stay byte-identical with tracing on.
            from dmlp_tpu_torch.obs import trace as obs_trace
            try:
                tracer.write_rank_file(args.trace)
            finally:
                obs_trace.uninstall()
    if args.phase_times:
        import json

        from dmlp_tpu_torch import kernels
        from dmlp_tpu_torch.parallel.collectives import gather_objects
        ranks = gather_objects({"rank": engine.rank,
                                "coords": list(engine.coords),
                                "device": str(engine.device),
                                "repairs": engine.last_repairs,
                                "launches": dict(kernels.LAUNCHES)})
        if engine.root:
            # A query rescored exactly on several ranks counts once on each.
            err.write(f"repairs: {sum(rk['repairs'] for rk in ranks)}\n")
            err.write("mesh: " + json.dumps({
                "mode": args.mode, "shape": list(shape),
                "backend": engine.backend, "ranks": ranks}) + "\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    from dmlp_tpu_torch.cli import parse_mesh_arg
    mesh_shape = parse_mesh_arg(p, args.mesh)
    if args.supervise is not None:
        return _run_supervisor(args)

    # A supervised rank carries $DMLP_TPU_HEARTBEAT: beat, so that the
    # supervisor can tell a crashed or frozen rank from a slow one.
    from dmlp_tpu_torch.resilience.supervise import \
        maybe_start_heartbeat_from_env
    maybe_start_heartbeat_from_env()
    from dmlp_tpu_torch.resilience import inject as rs_inject
    schedule = rs_inject.install_from_env(args.faults)

    from dmlp_tpu_torch.parallel.distributed import process_group
    session = None
    if args.telemetry:
        # One file per rank (the ranks share the argv), the fault log's
        # suffix convention.
        from dmlp_tpu_torch.obs import telemetry
        tpath = args.telemetry
        if (args.processes or 1) > 1:
            tpath += f".rank{args.process_id or 0:02d}"
        session = telemetry.start(path=tpath, device=args.device)
    try:
        with process_group(device=args.device, backend=args.backend,
                           coordinator=args.coordinator,
                           num_processes=args.processes,
                           process_id=args.process_id, auto=args.auto):
            _contract_run(args, mesh_shape, sys.stdout, sys.stderr)
    except Exception:
        if session is not None:
            # The dying rank's own post-mortem: the supervisor sees only
            # the failed launch.
            from dmlp_tpu_torch.obs import telemetry
            telemetry.dump_on_crash("crash")
        raise
    finally:
        if session is not None:
            session.close()
        if schedule is not None:
            # One injection log per rank: the ranks share the environment.
            import os
            log_path = os.environ.get("DMLP_TPU_FAULT_LOG")
            if log_path and (args.processes or 1) > 1:
                log_path += f".rank{args.process_id or 0:02d}"
            if log_path:
                schedule.write_log(log_path)
            rs_inject.uninstall()
    sys.stdout.flush()
    return 0


def _run_supervisor(args) -> int:
    """Launcher mode (``--supervise N``): per-rank argvs of this same
    entry (a fresh coordinator port per attempt) under the heartbeat and
    deadline loop, degrading to an in-process one-rank contract run when
    every launch failed; the checksums are the same either way."""
    import io
    import tempfile

    from dmlp_tpu_torch.parallel.distributed import free_port, process_group
    from dmlp_tpu_torch.resilience.supervise import run_supervised

    if args.device == "cuda" and args.pallas:
        # The kernels build once here, not once per rank.
        from dmlp_tpu_torch import kernels
        kernels.build_all()
    workdir = args.supervise_dir or tempfile.mkdtemp(prefix="dmlp-sup-")
    base = [sys.executable, "-m", "dmlp_tpu_torch.distributed",
            "--input", args.input, "--mode", args.mode,
            "--select", args.select, "--device", args.device]
    if args.backend:
        base += ["--backend", args.backend]
    if args.mesh:
        base += ["--mesh", args.mesh]
    if args.data_block is not None:
        base += ["--data-block", str(args.data_block)]
    for flag, on in (("--pallas", args.pallas), ("--debug", args.debug),
                     ("--warmup", args.warmup),
                     ("--phase-times", args.phase_times)):
        if on:
            base.append(flag)
    if args.faults:
        base += ["--faults", args.faults]
    if args.trace:
        base += ["--trace", args.trace]
    if args.telemetry:
        base += ["--telemetry", args.telemetry]

    def make_cluster(attempt: int):
        port = free_port()
        return [base + ["--coordinator", f"localhost:{port}",
                        "--processes", str(args.supervise),
                        "--process-id", str(rank)]
                for rank in range(args.supervise)]

    def fallback():
        out, err = io.StringIO(), io.StringIO()
        with process_group(device=args.device, backend=args.backend):
            _contract_run(args, (1, 1), out, err)
        return out.getvalue().encode(), err.getvalue().encode()

    out_b, err_b, report = run_supervised(
        make_cluster, workdir, cluster_timeout_s=args.supervise_timeout,
        max_launches=args.max_launches, fallback=fallback)
    for launch in report["launches"]:
        if launch.get("failure"):
            sys.stderr.write(f"supervise: launch {launch['attempt']} "
                             f"failed: {launch['failure']}\n")
    if report["fallback"]:
        sys.stderr.write("supervise: degraded to single-process "
                         "fallback (checksums unchanged)\n")
    sys.stdout.buffer.write(out_b)
    sys.stdout.flush()
    sys.stderr.write(err_b.decode())
    return 0


if __name__ == "__main__":
    sys.exit(main())
