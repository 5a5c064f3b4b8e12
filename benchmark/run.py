"""Run one benchmark cell once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m benchmark.run ...`` from the checkout's root). The last
line of standard output is the result: one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each compared number beside its
limit; the same numbers are the last lines of standard error.

It needs as many CUDA cards as the cell asks for and exits 2, printing
no result, without them; it exits 3, printing no result, when the JAX
stack or the JAX package was loaded by the time the window closed. Every
build and kernel cache the program keeps goes to ``.bench_cache/`` in the
checkout, at fixed paths, so only a checkout's first run builds.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
CACHE_DIRS = {"DMLP_TPU_COMPILE_CACHE": "build",
              "TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "nv"}


def prepare_env() -> None:
    for var, sub in CACHE_DIRS.items():
        d = CACHE / sub
        d.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(d)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()

    from benchmark import guard
    from benchmark.spec import Spec

    spec = Spec.load(ROOT / "BENCHMARK.json")
    chips = spec.cell(args.workload).chips
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark.harness import run_cell
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T0)
    found = guard.banned_modules()
    if found:
        print("benchmark: loaded modules the port must not load: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
