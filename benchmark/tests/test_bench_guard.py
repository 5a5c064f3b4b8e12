"""The import guard: the harness loads nothing of JAX or the JAX
package, and the reference nothing of the program."""

import subprocess
import sys

from benchmark.guard import banned_modules
from benchmark.spec import ROOT


def test_names_are_compared_whole_by_their_top_level_part():
    names = ["dmlp_tpu_torch", "dmlp_tpu_torch.ops", "jaxtyping", "numpy",
             "dmlp_tpu", "dmlp_tpu.ops", "jax.numpy", "jaxlib", "flax.core"]
    assert banned_modules(names) == ["dmlp_tpu", "dmlp_tpu.ops", "flax.core",
                                     "jax.numpy", "jaxlib"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sys.modules))"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return {m.split(".")[0] for m in out.stdout.split()}


def test_what_a_run_loads_holds_no_jax():
    code = ("import benchmark.run as r; r.prepare_env()\n"
            "from benchmark import harness, loadgen, control, sweep\n"
            "from benchmark.drivers import batch, open_loop\n"
            "from benchmark.spec import Spec\n"
            "s = Spec.load()\n"
            "[harness.reader(m.name) for m in s.end_to_end + s.per_layer]\n"
            "import dmlp_tpu_torch.engine.single, dmlp_tpu_torch.serve.daemon")
    top = _loaded(code)
    assert not top & {"jax", "jaxlib", "flax", "dmlp_tpu"}
    assert "dmlp_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import benchmark.reference.knn, benchmark.judge, "
                  "benchmark.datagen, benchmark.cost.work")
    assert not top & {"dmlp_tpu_torch", "dmlp_tpu", "jax"}


def test_run_refuses_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "sift1m.batch", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
