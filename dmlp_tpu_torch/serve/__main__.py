"""``python -m dmlp_tpu_torch.serve`` — the resident serving daemon CLI.

Usage::

    python -m dmlp_tpu_torch.serve --corpus FILE [--port 0]
        [--device cuda|cpu] [--capacity ROWS] [--max-k K]
        [--max-batch-queries N] [--max-queue-queries N] [--tick-ms MS]
        [--gate-carry on|off] [--hbm-budget BYTES|auto] [--pallas]
        [--select auto|...] [--dtype auto|float32|bfloat16]
        [--precision auto|f32|bf16] [--data-block N]
        [--warm-buckets NQxK,NQxK,...] [--ready-file PATH] [--faults FILE]
        [--telemetry FILE] [--telemetry-port PORT] [--trace FILE]
        [--slo SPEC ...] [--record FILE] [--compile-cache DIR]
        [--mesh RxC [--mesh-merge allgather|ring|auto] [--backend nccl|gloo]]

The corpus file is the standard input grammar: its data section becomes
the resident corpus, its query section seeds the warm-up buckets. The
daemon prints ``dmlp_tpu_torch.serve: ready port=P`` on stderr (and writes
``--ready-file``) once every warm bucket is built, then serves until
SIGTERM or an in-band ``drain`` op, which finishes the queued micro-batches
and exits 0. ``--device cuda`` (the default) raises without a card.

``--telemetry`` / ``--telemetry-port`` run the telemetry session (the
OpenMetrics snapshot and the ``GET /metrics`` endpoint, whose port the
snapshot carries as ``telemetry_http_port``), ``--trace`` writes the
rid-tagged request-phase spans at drain, ``--slo`` declares objectives
(repeatable) and ``--record`` appends the serving RunRecord at drain.

``--mesh RxC`` serves mesh-resident (``fleet.mesh_engine``): this process
is rank 0 of an R·C-rank process group and starts the other ranks itself
(``parallel.distributed.local_cluster``: ``python -m dmlp_tpu_torch.serve``
with the same arguments and torchrun's environment), each holding one
shard's resident chunks and running the command loop. The group's
timeout is ``fleet.mesh_engine.GROUP_TIMEOUT_S``: a dead or hung rank
makes the daemon exit non-zero within it. NCCL takes one card per rank,
so more ranks than cards need ``--backend gloo``, given explicitly;
without it the daemon refuses to start. ``--mesh-merge auto`` is the
reference's compiler-scheduled merge (the engine's "gspmd" strategy: K1
folds the chunks as before, and the lists merge by a DTensor
redistribution from data-sharded to query-sharded).

``--compile-cache DIR`` (``$DMLP_TPU_COMPILE_CACHE`` the ambient form)
builds and loads the kernel libraries and the native parser in DIR
(``utils.compile_cache``), shared with the worker ranks and, through the
fleet's spawns, with every replica. ``--snapshot-every-s S`` appends
the RunRecord to ``--record`` every S seconds while serving.
``DMLP_TPU_RACECHECK=1`` runs the daemon under the race sanitizer
(``check.racecheck``, installed by this package's ``__init__`` before any
serving lock exists); ``DMLP_TPU_RACECHECK_OUT=FILE`` writes its verdict
at drain.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import List, Optional, Sequence, Tuple

from dmlp_tpu_torch.check import racecheck


def _parse_warm_buckets(spec: str) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            nq, k = part.lower().split("x")
            out.append((int(nq), int(k)))
        except ValueError:
            raise SystemExit(
                f"--warm-buckets entries are NQxK, got {part!r}")
    return out


def _parse_mesh(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    if not spec:
        return None
    try:
        r, c = spec.lower().split("x")
        shape = (int(r), int(c))
    except ValueError:
        raise SystemExit(f"--mesh is RxC, got {spec!r}")
    if min(shape) < 1:
        raise SystemExit(f"--mesh axes must be positive, got {spec!r}")
    return shape


def _die_with_parent() -> None:
    """A worker rank dies with the daemon that started it (Linux's
    parent-death signal), so a killed replica leaves no rank behind."""
    try:
        import ctypes
        import signal
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass     # elsewhere the group's timeout ends the worker


def _serve_worker(args, config, mesh_shape) -> int:
    """A worker rank of a mesh replica: join the group, build the engine
    in step with rank 0, and run rank 0's commands until it closes."""
    from dmlp_tpu_torch.fleet.mesh_engine import (GROUP_TIMEOUT_S,
                                                  MeshResidentEngine)
    from dmlp_tpu_torch.parallel import distributed as pd
    from dmlp_tpu_torch.parallel.mesh import make_mesh
    _die_with_parent()
    pd.initialize(device=args.device, backend=args.backend, auto=True,
                  timeout_s=GROUP_TIMEOUT_S)
    engine = MeshResidentEngine(
        None, config, mesh=make_mesh(mesh_shape), capacity=args.capacity,
        merge=args.mesh_merge, gate_carry=args.gate_carry == "on")
    engine.serve_worker()
    pd.shutdown()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="dmlp_tpu_torch.serve",
                                description=__doc__)
    p.add_argument("--corpus", required=True,
                   help="input-grammar file; data section = resident "
                        "corpus, query section = warm-up shapes")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = ephemeral; announced on stderr "
                        "and in --ready-file)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs: the card (default; raises "
                        "without one) or the CPU with the kernels' plain "
                        "versions")
    p.add_argument("--capacity", type=int, default=None,
                   help="ingest ceiling in rows (default: corpus rows "
                        "rounded to the next power of two)")
    p.add_argument("--max-k", type=int, default=None,
                   help="largest per-query k admitted (default: the "
                        "engine's serving cap)")
    p.add_argument("--max-batch-queries", type=int, default=1024)
    p.add_argument("--max-queue-queries", type=int, default=4096)
    p.add_argument("--tick-ms", type=float, default=2.0,
                   help="micro-batch coalescing tick")
    p.add_argument("--gate-carry", choices=["on", "off"], default="on",
                   help="cross-request gate warm-up (hot-chunks-first fold "
                        "order); results are byte-identical either way")
    p.add_argument("--hbm-budget", default="auto",
                   help="admission memory budget in bytes ('auto' = the "
                        "card's total memory; memory shedding is off on "
                        "the CPU)")
    p.add_argument("--pallas", action="store_true",
                   help="the hand-written kernels: the extraction kernel's "
                        "resident path where supported (the reference's "
                        "flag name)")
    p.add_argument("--select", default="auto",
                   choices=["auto", "sort", "topk", "seg", "extract"])
    p.add_argument("--dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"])
    p.add_argument("--precision", default="auto",
                   choices=["auto", "f32", "bf16"],
                   help="first-pass dot precision of the extraction "
                        "kernels (plan frozen at startup; "
                        "$DMLP_TPU_PRECISION=f32 is the live kill switch)")
    p.add_argument("--data-block", type=int, default=None)
    p.add_argument("--warm-buckets", default=None, metavar="NQxK,...",
                   help="extra shape buckets to build before ready")
    p.add_argument("--ready-file", metavar="PATH", default=None)
    p.add_argument("--faults", metavar="FILE", default=None,
                   help="fault-injection schedule "
                        "(dmlp_tpu_torch.resilience.inject; the "
                        "serve.admit oom fault is the memory squeeze)")
    p.add_argument("--telemetry", metavar="FILE", default=None,
                   help="OpenMetrics snapshot file of the live telemetry "
                        "session (flight recorder beside it)")
    p.add_argument("--telemetry-port", type=int, default=None,
                   metavar="PORT",
                   help="serve the OpenMetrics text on "
                        "localhost:PORT/metrics (0 = ephemeral)")
    p.add_argument("--trace", metavar="FILE", default=None,
                   help="write a Chrome-trace JSON of the rid-tagged "
                        "request-phase spans here at drain")
    p.add_argument("--slo", action="append", default=None, metavar="SPEC",
                   help="declare an SLO objective (repeatable), e.g. "
                        "'serve.request_latency_ms p99 < 50 over 1m' or "
                        "'serve.requests_completed/serve.admitted "
                        "availability > 0.999 over 5m' (obs.slo); the "
                        "stats op carries its state")
    p.add_argument("--record", metavar="FILE", default=None,
                   help="append the serving RunRecord here at drain")
    p.add_argument("--snapshot-every-s", type=float, default=0.0,
                   metavar="S",
                   help="also append the RunRecord to --record every S "
                        "seconds while serving (0 = at drain only)")
    p.add_argument("--mesh", default=None, metavar="RxC",
                   help="serve mesh-resident over an RxC (data x query) "
                        "mesh of ranks, this process rank 0 "
                        "(dmlp_tpu_torch.fleet.mesh_engine)")
    p.add_argument("--mesh-merge", default="allgather",
                   help="candidate merge over the data axis for --mesh: "
                        "allgather, ring or auto (a DTensor "
                        "redistribution, the reference's 'gspmd')")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="collective backend of --mesh (default: nccl on "
                        "the card, gloo on the CPU; more ranks than cards "
                        "need gloo, given explicitly)")
    p.add_argument("--compile-cache", metavar="DIR", default=None,
                   help="build directory of the kernel and parser "
                        "libraries (utils.compile_cache; raises when "
                        "unusable); $DMLP_TPU_COMPILE_CACHE is the ambient "
                        "form (flag wins)")
    args = p.parse_args(argv)
    # The DMLP_TPU_RACECHECK=1 install happens in serve/__init__.py, which
    # `python -m dmlp_tpu_torch.serve` runs before this module creates any
    # lock; this call is the idempotent backstop for embedders.
    racecheck.install_from_env()
    mesh_shape = _parse_mesh(args.mesh)

    from dmlp_tpu_torch.utils.compile_cache import enable_from_flag
    # Before any library is built: the warm-up builds and loads them.
    enable_from_flag(args.compile_cache)

    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.io.grammar import parse_input
    from dmlp_tpu_torch.resilience import inject as rs_inject
    from dmlp_tpu_torch.serve.daemon import default_warm_buckets

    config = EngineConfig(dtype=args.dtype, select=args.select,
                          use_pallas=args.pallas,
                          data_block=args.data_block,
                          precision=args.precision, device=args.device)
    if mesh_shape is not None:
        # The engine's own refusal, before any rank is started.
        from dmlp_tpu_torch.fleet.mesh_engine import check_merge
        try:
            check_merge(args.mesh_merge)
        except ValueError as e:
            raise SystemExit(f"dmlp_tpu_torch.serve: {e}") from None
    if mesh_shape is not None and os.environ.get("RANK", "0") != "0":
        return _serve_worker(args, config, mesh_shape)
    budget = None
    if args.hbm_budget != "auto":
        budget = int(args.hbm_budget)
    with open(args.corpus, "rb") as f:
        corpus = parse_input(f)
    warm = None
    if args.warm_buckets:
        warm = default_warm_buckets(corpus) \
            + _parse_warm_buckets(args.warm_buckets)
    schedule = rs_inject.install_from_env(args.faults)
    try:
        with _mesh_group(args, mesh_shape, argv):
            return _serve(args, corpus, config, budget, warm, mesh_shape)
    finally:
        if schedule is not None:
            rs_inject.write_log_if_requested()
            rs_inject.uninstall()


def _mesh_group(args, mesh_shape, argv):
    """The process group of a mesh replica (this process its rank 0, the
    others started here), or nothing without ``--mesh``."""
    if mesh_shape is None:
        return contextlib.nullcontext()
    from dmlp_tpu_torch.fleet.mesh_engine import GROUP_TIMEOUT_S
    from dmlp_tpu_torch.parallel import distributed as pd
    world = mesh_shape[0] * mesh_shape[1]
    if world == 1:
        return pd.process_group(device=args.device, backend=args.backend,
                                timeout_s=GROUP_TIMEOUT_S)
    rest = list(argv) if argv is not None else sys.argv[1:]
    return pd.local_cluster(world, ["-m", "dmlp_tpu_torch.serve", *rest],
                            device=args.device, backend=args.backend,
                            timeout_s=GROUP_TIMEOUT_S)


def _serve(args, corpus, config, budget, warm, mesh_shape) -> int:
    """Rank 0 (or the only process): the daemon from start to drain."""
    from dmlp_tpu_torch.serve.daemon import ServeDaemon
    daemon = None
    try:
        daemon = ServeDaemon(
            corpus, config, port=args.port, capacity=args.capacity,
            gate_carry=args.gate_carry == "on", budget_bytes=budget,
            max_batch_queries=args.max_batch_queries,
            max_queue_queries=args.max_queue_queries, max_k=args.max_k,
            tick_s=args.tick_ms / 1e3, warm_buckets=warm,
            telemetry_path=args.telemetry,
            telemetry_port=args.telemetry_port, record_path=args.record,
            trace_path=args.trace, objectives=args.slo,
            mesh_shape=mesh_shape, mesh_merge=args.mesh_merge,
            snapshot_every_s=args.snapshot_every_s)
        daemon.start()
        sys.stderr.write(f"dmlp_tpu_torch.serve: ready port={daemon.port} "
                         f"cold_start_compile_ms="
                         f"{daemon.engine.cold_start_compile_ms}\n")
        sys.stderr.flush()
        if args.ready_file:
            daemon.write_ready_file(args.ready_file)
        daemon.run_until_drained()
        racecheck.write_report_if_requested()
        sys.stderr.write("dmlp_tpu_torch.serve: drained clean\n")
        return 0
    except Exception:
        if daemon is not None and daemon.session is not None:
            from dmlp_tpu_torch.obs import telemetry
            telemetry.dump_on_crash("serve_crash")
        raise


if __name__ == "__main__":
    sys.exit(main())
