"""``python -m dmlp_tpu_torch.serve`` — the resident serving daemon CLI.

Usage::

    python -m dmlp_tpu_torch.serve --corpus FILE [--port 0]
        [--device cuda|cpu] [--capacity ROWS] [--max-k K]
        [--max-batch-queries N] [--max-queue-queries N] [--tick-ms MS]
        [--gate-carry on|off] [--hbm-budget BYTES|auto] [--pallas]
        [--select auto|...] [--dtype auto|float32|bfloat16]
        [--precision auto|f32|bf16] [--data-block N]
        [--warm-buckets NQxK,NQxK,...] [--ready-file PATH] [--faults FILE]

The corpus file is the standard input grammar: its data section becomes
the resident corpus, its query section seeds the warm-up buckets. The
daemon prints ``dmlp_tpu_torch.serve: ready port=P`` on stderr (and writes
``--ready-file``) once every warm bucket is built, then serves until
SIGTERM or an in-band ``drain`` op, which finishes the queued micro-batches
and exits 0. ``--device cuda`` (the default) raises without a card.

The reference's ``--mesh`` and ``--mesh-merge`` (ROADMAP A12),
``--telemetry``, ``--telemetry-port``, ``--trace`` and ``--slo`` (A13),
``--record`` and ``--snapshot-every-s`` (A15), and ``--compile-cache`` (no
compiled program to cache) are not flags here.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple


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
    args = p.parse_args(argv)

    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.io.grammar import parse_input
    from dmlp_tpu_torch.resilience import inject as rs_inject
    from dmlp_tpu_torch.serve.daemon import ServeDaemon, default_warm_buckets

    budget = None
    if args.hbm_budget != "auto":
        budget = int(args.hbm_budget)
    with open(args.corpus, "rb") as f:
        corpus = parse_input(f)
    warm = None
    if args.warm_buckets:
        warm = default_warm_buckets(corpus) \
            + _parse_warm_buckets(args.warm_buckets)
    config = EngineConfig(dtype=args.dtype, select=args.select,
                          use_pallas=args.pallas,
                          data_block=args.data_block,
                          precision=args.precision, device=args.device)
    schedule = rs_inject.install_from_env(args.faults)
    try:
        daemon = ServeDaemon(
            corpus, config, port=args.port, capacity=args.capacity,
            gate_carry=args.gate_carry == "on", budget_bytes=budget,
            max_batch_queries=args.max_batch_queries,
            max_queue_queries=args.max_queue_queries, max_k=args.max_k,
            tick_s=args.tick_ms / 1e3, warm_buckets=warm)
        daemon.start()
        sys.stderr.write(f"dmlp_tpu_torch.serve: ready port={daemon.port} "
                         f"cold_start_compile_ms="
                         f"{daemon.engine.cold_start_compile_ms}\n")
        sys.stderr.flush()
        if args.ready_file:
            daemon.write_ready_file(args.ready_file)
        daemon.run_until_drained()
        sys.stderr.write("dmlp_tpu_torch.serve: drained clean\n")
        return 0
    finally:
        if schedule is not None:
            rs_inject.write_log_if_requested()
            rs_inject.uninstall()


if __name__ == "__main__":
    sys.exit(main())
