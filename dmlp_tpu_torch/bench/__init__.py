"""Benchmark harness — port of ``dmlp_tpu/bench`` (the run_bench.sh of
the reference, L4).

``python -m dmlp_tpu_torch.bench 1|2|3|4|5|all|serve [--device cuda|cpu]``:
a config registry (configs 1-5, the reference's generator arguments and
seeds), seeded input regeneration, the port's float64 oracle with output
caching (the analog of outputs/test_N.{out,err} caching at
run_bench.sh:79-84), checksum diffing, the same compare_times report, the
repeated runs and the A/B arms; ``python -m dmlp_tpu_torch.bench.driver``
is the port of the root ``bench.py`` (one JSON line).
"""

from dmlp_tpu_torch.bench.configs import BENCH_CONFIGS, BenchConfig  # noqa: F401
from dmlp_tpu_torch.bench.harness import run_config  # noqa: F401
