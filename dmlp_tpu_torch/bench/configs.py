"""Benchmark config registry — port of ``dmlp_tpu/bench/configs.py``.

Configs 1-5 with the reference's generator arguments, seeds and input
names (``input2.in`` serves configs 2 and 3, as ``input2.in`` served
the reference's configs 2 and 3), so the port's inputs and oracle outputs
are byte-identical to the reference harness's. Each config maps to the
generator's parameters, an engine mode, a mesh shape and the engine's
device path flags.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One benchmark configuration (the analog of a run_bench.sh block).

    ``use_pallas``/``select`` choose the engine's device path (the port
    keeps the reference's flag name ``--pallas`` for its hand-written
    kernels); the large configs pin them on. ``backend`` is the mesh's
    collective backend, passed as ``--backend``: ``None`` lets the CLI
    choose (NCCL on the card, gloo on the CPU); "gloo" runs several ranks
    on one card, which NCCL refuses (one card per rank). ``procs`` > 1
    runs a real ``procs``-process cluster through ``python -m
    dmlp_tpu_torch.distributed``, each process one rank — the
    mpirun-across-nodes analog (run_bench.sh:82-84)."""

    config_id: int
    # generator args (generate_input.py grammar, seeded)
    num_data: int
    num_queries: int
    num_attrs: int
    min_attr: float
    max_attr: float
    min_k: int
    max_k: int
    num_labels: int
    seed: int
    input_name: str          # shared inputs, like input2.in serving configs 2+3
    mode: str = "single"     # engine mode to benchmark
    mesh_shape: Optional[Tuple[int, int]] = None
    use_pallas: bool = False
    select: str = "auto"
    backend: Optional[str] = None   # --backend of a mesh / cluster config
    procs: int = 1                  # processes of the cluster
    # Per-config engine kill timeout override (seconds); None = the
    # harness-wide --timeout. A config that blows it records the
    # explicit `timed_out` marker in its RunRecord (markers never
    # gate) and the rest of the bench run proceeds.
    timeout_s: Optional[float] = None


BENCH_CONFIGS: Dict[int, BenchConfig] = {
    1: BenchConfig(1, 20_000, 1_000, 32, 0.0, 100.0, 1, 16, 10, 42,
                   "input1.in"),
    2: BenchConfig(2, 100_000, 5_000, 64, 0.0, 100.0, 1, 32, 10, 42,
                   "input2.in", use_pallas=True),
    # Config 3: config 2's input on a (4, 2) mesh, 8 ranks. On one card
    # the ranks share it, so the collectives run on gloo (given
    # explicitly: the CLI refuses more NCCL ranks than cards). It pins the
    # hand-written kernels as config 2 does (the reference's config 3 ran
    # without them: its mesh configs validated shard_map on virtual CPU
    # devices): K1 in each rank's chunk fold, K3 in the auto engine's.
    3: BenchConfig(3, 100_000, 5_000, 64, 0.0, 100.0, 1, 32, 10, 42,
                   "input2.in", mode="sharded", mesh_shape=(4, 2),
                   use_pallas=True, backend="gloo"),
    4: BenchConfig(4, 200_000, 10_000, 64, 0.0, 100.0, 1, 32, 10, 42,
                   "input3.in", use_pallas=True),
    # Config 5: the run_bench.sh multi-node analog — a real 2-process
    # cluster on gloo (both ranks on one card), proc-0 stdout diffed.
    5: BenchConfig(5, 50_000, 2_000, 32, 0.0, 100.0, 1, 24, 10, 42,
                   "input5.in", mode="sharded", procs=2, backend="gloo"),
}
