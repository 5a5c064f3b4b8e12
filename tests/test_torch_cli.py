"""The port's CLI contract: stdout byte-identical to ``python -m dmlp_tpu``
and to ``--engine golden``, the stderr ``Time taken`` line, no JAX and no
``dmlp_tpu`` module anywhere in the port, and no silent CPU fallback."""

import ast
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

from dmlp_tpu import cli as ref_cli  # noqa: E402
from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu_torch import cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "dmlp_tpu")

INPUTS = {   # path -> (datagen args, flags that select it)
    "sort": ((2500, 30, 6, -10.0, 10.0, 1, 12, 4), []),
    "topk": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5), []),
    "extract": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5), ["--pallas"]),
    # The router: k past the kernel's width for some queries.
    "mixed_k": ((9000, 24, 6, 0.0, 50.0, 1, 900, 5), ["--pallas"]),
    # The multi-pass driver: k past the kernel's width for every query.
    "wide_k": ((9000, 8, 4, 0.0, 50.0, 600, 700, 5), ["--pallas"]),
    "seg": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5), ["--select", "seg",
                                                 "--pallas"]),
}


def _run(main, argv, text):
    out, err = io.StringIO(), io.StringIO()
    assert main(argv, stdin=io.StringIO(text), stdout=out, stderr=err) == 0
    return out.getvalue(), err.getvalue()


MODES = {"exact": [], "fast": ["--fast"], "debug": ["--debug"]}
# Fast mode prints the f32 device ordering. At k in the hundreds on
# continuous data, f32 near-ties fall differently in any two frameworks'
# sums (and from the float64 oracle in both), so the wide-k inputs are
# held in exact and debug mode here; test_torch_engine holds the router's
# fast mode on an integer grid, where f32 is exact.
WIDE_K = ("mixed_k", "wide_k")


@pytest.mark.parametrize("path,mode", [
    pytest.param(p, MODES[m], id=f"{p}-{m}") for p in INPUTS for m in MODES
    if not (m == "fast" and p in WIDE_K)])
def test_stdout_matches_reference_and_golden(path, mode):
    gen, flags = INPUTS[path]
    text = generate_input_text(*gen, seed=7)
    got, err = _run(cli.main, ["--device", "cpu", *flags, *mode], text)
    want, _ = _run(ref_cli.main, [*flags, *mode], text)
    golden, _ = _run(cli.main, ["--engine", "golden",
                                *[m for m in mode if m == "--debug"]], text)
    assert got == want
    assert got == golden
    assert re.fullmatch(r"Time taken: \d+ ms\n", err)


def test_module_entry_point_imports_no_reference(tmp_path):
    """``python -m dmlp_tpu_torch`` end to end in a fresh interpreter:
    golden-identical stdout, the stderr contract line, and afterwards no
    jax / jaxlib / dmlp_tpu module in sys.modules."""
    gen, _ = INPUTS["extract"]
    text = generate_input_text(*gen, seed=3)
    src = tmp_path / "in.txt"
    src.write_text(text)
    probe = (
        "import runpy, sys\n"
        "sys.argv = ['dmlp_tpu_torch', '--device', 'cpu', '--pallas',"
        " '--phase-times']\n"
        "try:\n"
        "    runpy.run_module('dmlp_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" {FORBIDDEN!r})\n"
        "sys.stderr.write('FORBIDDEN=%r\\n' % bad)\n")
    with open(src) as f:
        p = subprocess.run([sys.executable, "-c", probe], stdin=f,
                           capture_output=True, text=True, cwd=ROOT,
                           timeout=300)
    assert p.returncode == 0, p.stderr
    golden, _ = _run(cli.main, ["--engine", "golden"], text)
    assert p.stdout == golden
    lines = p.stderr.splitlines()
    assert re.fullmatch(r"Time taken: \d+ ms", lines[0])
    assert any(ln.startswith("phase engine.") for ln in lines)
    assert lines[-1] == "FORBIDDEN=[]"


# A tiny bench config 1 for the bench's entry (its oracle and one engine
# run in a few seconds).
TINY_BENCH = ("from dmlp_tpu_torch.bench import configs\n"
              "configs.BENCH_CONFIGS[1] = configs.BenchConfig(1, 200, 20, "
              "4, 0.0, 10.0, 1, 8, 4, 7, 'tiny.in')\n")


@pytest.mark.parametrize("entry", ["device_full", "tune_smoke", "bench",
                                   "bench_driver", "report", "perf_gate"])
def test_device_full_and_tune_smoke_import_no_reference(entry, tmp_path):
    """The same scan after a ``--device-full`` solve of an input past the
    native parser's threshold, after ``python -m dmlp_tpu_torch.tune
    --smoke``, and after the tooling entry points: ``python -m
    dmlp_tpu_torch.bench`` (a tiny config 1), ``.bench.driver`` (a small
    ``BENCH_*`` shape), ``.report`` and ``.perf_gate`` over the root."""
    text, setup = "", ""
    if entry == "device_full":
        text = generate_input_text(12000, 100, 16, 0.0, 50.0, 1, 16, 5,
                                   seed=4)
        module, argv = "dmlp_tpu_torch", [
            "dmlp_tpu_torch", "--device", "cpu", "--pallas", "--device-full",
            "--phase-times"]
    elif entry == "tune_smoke":
        module, argv = "dmlp_tpu_torch.tune", [
            "tune", "--smoke", "--out", str(tmp_path / "smoke.json")]
    elif entry == "bench":
        setup = TINY_BENCH
        module, argv = "dmlp_tpu_torch.bench", [
            "bench", "1", "--device", "cpu", "--base-dir", str(tmp_path),
            "--record", str(tmp_path / "runs.jsonl")]
    elif entry == "bench_driver":
        setup = ("import os\nos.environ.update(BENCH_NUM_DATA='2000', "
                 "BENCH_NUM_QUERIES='64', BENCH_NUM_ATTRS='8', "
                 "BENCH_K='8', BENCH_REPEATS='1')\n")
        module, argv = "dmlp_tpu_torch.bench.driver", [
            "driver", "--device", "cpu"]
    elif entry == "report":
        module, argv = "dmlp_tpu_torch.report", [
            "report", "--root", str(ROOT), "--out",
            str(tmp_path / "L.json"), "--min-coverage", "0.9"]
    else:
        module, argv = "dmlp_tpu_torch.perf_gate", [
            "perf_gate", "--root", str(ROOT)]
    probe = (
        "import runpy, sys\n"
        + setup +
        f"sys.argv = {argv!r}\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "from dmlp_tpu_torch.io import grammar\n"
        "sys.stderr.write('PARSER=%s\\n' % grammar.last_parser)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" {FORBIDDEN!r})\n"
        "sys.stderr.write('FORBIDDEN=%r\\n' % bad)\n")
    p = subprocess.run([sys.executable, "-c", probe], input=text,
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    lines = p.stderr.splitlines()
    assert lines[-1] == "FORBIDDEN=[]"
    if entry == "device_full":
        assert p.stdout.count("\n") == 100
        assert "prune: null" in lines and lines[-2] == "PARSER=native"
    elif entry == "tune_smoke":
        assert '"device_kind": "cpu"' in p.stdout.splitlines()[-1]
    elif entry == "bench":
        assert "Config 1: checksums PASS" in p.stdout
        rec = json.loads((tmp_path / "runs.jsonl").read_text())
        assert (rec["tool"], rec["device"]) == ("dmlp_tpu_torch.bench",
                                                "cpu")
    elif entry == "bench_driver":
        assert json.loads(p.stdout)["path"]["device"] == "cpu"
    elif entry == "report":
        assert json.loads((tmp_path / "L.json").read_text())["coverage"][
            "fraction"] >= 0.9
    else:
        assert "gated series checked" in p.stdout


def test_no_source_in_the_port_imports_the_reference_or_jax():
    files = sorted((ROOT / "dmlp_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # the checker's own copy is scanned too (stdlib AST modules included)
    assert {"analyzer.py", "racecheck.py", "sanitize.py"} <= {
        f.name for f in files if f.parent.name == "check"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{f}: {n}"


def test_cuda_without_a_card_raises_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out, err = io.StringIO(), io.StringIO()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main([], stdin=io.StringIO("1 1 1\n0 1\nQ 1 1\n"), stdout=out,
                 stderr=err)
    assert out.getvalue() == "" and err.getvalue() == ""
