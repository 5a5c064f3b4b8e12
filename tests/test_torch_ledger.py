"""The port's ledger, report and perf gate (``dmlp_tpu_torch.obs.ledger``,
``dmlp_tpu_torch.report``, ``dmlp_tpu_torch.perf_gate``) held against the
reference's over the repository root; the port's bench records kept apart
from the TPU-era rounds of their series; and the compile cache
(``dmlp_tpu_torch.utils.compile_cache``): the build directory of the
kernel and parser libraries for every entry point."""

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from dmlp_tpu.obs import ledger as ref_ledger
from dmlp_tpu.obs.run import RunRecord as RefRunRecord
from dmlp_tpu import report as ref_report
from dmlp_tpu_torch import perf_gate
from dmlp_tpu_torch import report
from dmlp_tpu_torch.obs import ledger
from dmlp_tpu_torch.obs.run import RunRecord
from dmlp_tpu_torch.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"


def _ref_gate():
    spec = importlib.util.spec_from_file_location(
        "perf_gate", ROOT / "tools" / "perf_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


# -- the ledger over the repository root -------------------------------------

def test_ledger_document_equals_the_reference_over_the_root():
    got = ledger.build_ledger(str(ROOT))
    want = ref_ledger.build_ledger(str(ROOT))
    assert got == want
    assert got["coverage"]["files"] >= 40
    assert ledger.ARTIFACT_PATTERNS == ref_ledger.ARTIFACT_PATTERNS
    assert (ledger.MIN_TRIALS, ledger.NOISE_Z, ledger.NOISE_REL_FLOOR) == (
        ref_ledger.MIN_TRIALS, ref_ledger.NOISE_Z,
        ref_ledger.NOISE_REL_FLOOR)


def test_report_and_gate_equal_the_reference_over_the_root(tmp_path):
    doc = ledger.build_ledger(str(ROOT))
    assert report.render_markdown(doc) == ref_report.render_markdown(doc)
    assert perf_gate.run_gate(str(ROOT)) == _ref_gate().run_gate(str(ROOT))
    assert perf_gate.GATED_PREFIXES == _ref_gate().GATED_PREFIXES
    rc, out = _stdout(perf_gate.main, ["--root", str(ROOT)])
    ref_rc, ref_out = _stdout(_ref_gate().main, ["--root", str(ROOT)])
    assert (rc, out) == (ref_rc, ref_out) == (0, ref_out)
    assert "gated series checked" in out
    files = {}
    for name, main in (("port", report.main), ("ref", ref_report.main)):
        d = tmp_path / name
        d.mkdir()
        assert main(["--root", str(ROOT), "--out", str(d / "L.json"),
                     "--md", str(d / "R.md"), "--min-coverage", "0.9"]) == 0
        files[name] = ((d / "L.json").read_text(), (d / "R.md").read_text())
    assert files["port"] == files["ref"]


def _pt(value, trials=None, device="cpu", round_=1, better="lower"):
    return {"series": "s", "value": value, "trials": trials,
            "device": device, "round": round_, "better": better}


# The reference's compare_points / noise_band / _better_direction cases
# (tests/test_ledger.py), each through both packages.
CASES = {
    "within_noise": ("cmp", _pt(100, [95, 100, 105]),
                     _pt(102, [97, 102, 106], round_=2)),
    "regression": ("cmp", _pt(100, [99, 100, 101]),
                   _pt(200, [198, 200, 202], round_=2)),
    "improvement": ("cmp", _pt(200, [198, 200, 202]),
                    _pt(100, [99, 100, 101], round_=2)),
    "higher_better": ("cmp", _pt(100, [99, 100, 101], better="higher"),
                      _pt(50, [49, 50, 51], round_=2, better="higher")),
    "insufficient_none": ("cmp", _pt(100), _pt(500, [499, 500, 501], 2)),
    "insufficient_short": ("cmp", _pt(1, [1, 1]), _pt(9, [9, 9, 9], 2)),
    "device_mismatch": ("cmp", _pt(100, [1, 2, 3]),
                        _pt(900, [1, 2, 3], device="TPU v5 lite")),
    "card_vs_unspecified": ("cmp", _pt(100, [99, 100, 101],
                                       device="unspecified"),
                            _pt(100, [99, 100, 101], device=H100)),
    "noise_quantized": ("band", [1000, 1000, 1001]),
    "noise_spread": ("band", [90, 100, 130, 95, 101]),
    "dir_repairs": ("dir", "capacity:tools.capacity_beyond_hbm/repairs"),
    "dir_pairs_per_sec": ("dir", "bench/qd_pairs_per_sec/x"),
    "dir_engine_ms": ("dir", "harness/config4/engine_ms"),
    "dir_info": ("dir", "harness/config4/checksums"),
    "dir_warmup": ("dir", "auto/config3/warmup_ms_auto"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_noise_aware_comparison_equals_the_reference(case):
    kind, *args = CASES[case]
    if kind == "cmp":
        got = ledger.compare_points(*args)
        assert got == ref_ledger.compare_points(*args)
        if "mismatch" in case or "unspecified" in case:
            assert got["marker"] == "device_mismatch"
            assert "regressed" not in got
    elif kind == "band":
        got = ledger.noise_band(args[0])
        assert got == ref_ledger.noise_band(args[0])
        assert got >= 0.02 * ledger._median(args[0]) and math.isfinite(got)
    else:
        assert ledger._better_direction(args[0]) == \
            ref_ledger._better_direction(args[0])


# -- the port's bench records beside the TPU-era rounds ----------------------

def _card_round(root, round_, reps, device=H100):
    RunRecord(kind="bench", tool="dmlp_tpu_torch.bench",
              config={"config_id": 4},
              metrics={"engine_ms": sorted(reps)[len(reps) // 2],
                       "engine_ms_reps": reps},
              device=device, round=round_).append_jsonl(
        str(root / f"BENCH_r{round_:02d}.jsonl"))


def _tpu_era_root(tmp_path):
    for name in ("HARNESS_r03.json", "HARNESS_r04.json", "HARNESS_r05.json"):
        shutil.copy(ROOT / name, tmp_path / name)
    return tmp_path


def test_card_rounds_are_never_compared_with_tpu_era_rounds(tmp_path):
    root = _tpu_era_root(tmp_path)
    _card_round(root, 17, [1000, 1010, 990])
    doc = ledger.build_ledger(str(root))
    pts = doc["series"]["harness/config4/engine_ms"]
    assert {p["round"] for p in pts} == {3, 4, 5, 17}
    card = [p for p in pts if p["round"] == 17]
    assert card[0]["device"] == H100 and card[0]["trials"] == [1000, 1010,
                                                               990]
    deltas = [d for d in ledger.series_deltas(doc)
              if d["series"] == "harness/config4/engine_ms"]
    for d in deltas:
        if 17 in (d["prev_round"], d["cur_round"]):
            assert d["marker"] == "device_mismatch"
            assert "regressed" not in d and "significant" not in d
    gate = perf_gate.run_gate(str(root))
    assert not gate["regressions"]
    assert perf_gate.main(["--root", str(root)]) == 0


def test_a_regressed_card_round_fails_the_gate(tmp_path):
    root = _tpu_era_root(tmp_path)
    _card_round(root, 17, [1000, 1010, 990])
    _card_round(root, 18, [2000, 2020, 1990])
    gate = perf_gate.run_gate(str(root))
    (reg,) = [r for r in gate["regressions"]
              if r["series"] == "harness/config4/engine_ms"]
    assert (reg["prev_round"], reg["cur_round"]) == (17, 18)
    assert reg["regressed"] and reg["median_cur"] == 2000
    rc, _ = _stdout(perf_gate.main, ["--root", str(root)])
    assert rc == 1


def test_a_single_shot_card_round_is_reported_not_failed(tmp_path):
    root = _tpu_era_root(tmp_path)
    _card_round(root, 17, [1000, 1010, 990])
    RunRecord(kind="bench", tool="dmlp_tpu_torch.bench",
              config={"config_id": 4}, metrics={"engine_ms": 4000},
              device=H100, round=18).append_jsonl(
        str(root / "BENCH_r18.jsonl"))
    gate = perf_gate.run_gate(str(root))
    assert not gate["regressions"]
    unq = [u for u in gate["unqualified"]
           if u["series"] == "harness/config4/engine_ms"
           and u["cur_round"] == 18]
    assert unq and unq[0]["marker"] == "insufficient_trials"
    assert unq[0]["prev_round"] == 17
    rc, out = _stdout(perf_gate.main, ["--root", str(root)])
    assert rc == 0 and "insufficient_trials" in out


def test_the_reference_reads_the_ports_records(tmp_path):
    """The port's records keep the reference's envelope: the reference's
    reader loads them, and both ledgers ingest them alike."""
    _card_round(tmp_path, 17, [1000, 1010, 990])
    line = (tmp_path / "BENCH_r17.jsonl").read_text().splitlines()[0]
    assert RefRunRecord.from_dict(json.loads(line)).device == H100
    got = ledger.ingest_file(str(tmp_path / "BENCH_r17.jsonl"))
    assert got["status"] == "parsed"
    assert {p["series"] for p in got["points"]} == {
        "harness/config4/engine_ms"}


# -- the compile cache --------------------------------------------------------

@pytest.fixture
def no_cache(monkeypatch):
    """No cache directory set; whatever the test exports is undone."""
    monkeypatch.setenv(compile_cache.ENV_VAR, "")
    return monkeypatch


def test_flag_wins_over_the_environment(no_cache, tmp_path):
    assert compile_cache.resolve_cache_dir() is None
    assert compile_cache.resolve_cache_dir("flag") == "flag"
    no_cache.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    assert compile_cache.resolve_cache_dir() == str(tmp_path / "env")
    assert compile_cache.resolve_cache_dir(str(tmp_path / "flag")) == \
        str(tmp_path / "flag")
    got = compile_cache.enable_from_flag(str(tmp_path / "flag"))
    assert got == str(tmp_path / "flag") and Path(got).is_dir()
    assert os.environ[compile_cache.ENV_VAR] == got   # exported


def test_library_paths_follow_the_cache_per_call(no_cache, tmp_path):
    from dmlp_tpu_torch import kernels
    from dmlp_tpu_torch.io import native
    default = kernels.library_path("extract_topk")
    assert default.parent == kernels.BUILD_DIR
    assert native.library_path().parent == native.BUILD_DIR
    no_cache.setenv(compile_cache.ENV_VAR, str(tmp_path))
    for name in kernels.SOURCES:
        lib = kernels.library_path(name)
        assert lib.parent == tmp_path and lib.name == default.name \
            .replace("extract_topk", name).replace(
                kernels.source_hash("extract_topk"),
                kernels.source_hash(name))
        argv, tmp = kernels.build_command(name, nvcc="nvcc")
        assert Path(argv[argv.index("-o") + 1]) == tmp
        assert tmp.parent == tmp_path
    assert native.library_path().parent == tmp_path
    no_cache.setenv(compile_cache.ENV_VAR, "")
    assert kernels.library_path("extract_topk") == default


def test_an_unusable_directory_raises(no_cache, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(compile_cache.CompileCacheError,
                       match="cannot be created"):
        compile_cache.enable_from_flag(str(blocker / "sub"))
    assert compile_cache.resolve_cache_dir() is None   # nothing exported
    from dmlp_tpu_torch import cli
    with pytest.raises(compile_cache.CompileCacheError):
        cli.main(["--device", "cpu", "--compile-cache", str(blocker)],
                 stdin=io.StringIO(""), stdout=io.StringIO(),
                 stderr=io.StringIO())


def test_cli_with_a_cache_prints_what_it_prints_without(no_cache, tmp_path):
    """Past the native parser's threshold the parser is built (g++) into
    the cache directory and serves the solve."""
    from dmlp_tpu_torch import cli
    from dmlp_tpu_torch.io import grammar, native
    from dmlp_tpu_torch.io.datagen import generate_input_text
    text = generate_input_text(12000, 60, 16, 0.0, 50.0, 1, 16, 5, seed=3)
    assert len(text) >= grammar._NATIVE_THRESHOLD_BYTES

    def solve(extra):
        out, err = io.StringIO(), io.StringIO()
        assert cli.main(["--device", "cpu", *extra],
                        stdin=io.StringIO(text), stdout=out,
                        stderr=err) == 0
        return out.getvalue()

    plain = solve([])
    cache = tmp_path / "cache"
    no_cache.setattr(native, "_tried", False)
    no_cache.setattr(native, "_lib", None)
    no_cache.setattr(native, "build_error", None)
    assert solve(["--compile-cache", str(cache)]) == plain
    assert grammar.last_parser == "native"
    assert [p.name for p in cache.glob("fastparse-*.so")] == [
        native.library_path().name]


def test_daemon_and_tune_take_the_flag(no_cache, tmp_path):
    """The serve daemon comes up, answers and drains with the flag; tune
    --smoke --record writes its kind="tune" RunRecord."""
    from dmlp_tpu_torch.io.datagen import generate_input_text
    from dmlp_tpu_torch.serve import client as sc
    from dmlp_tpu_torch.tune.__main__ import main as tune_main
    corpus = tmp_path / "corpus.in"
    corpus.write_text(generate_input_text(600, 4, 4, 0.0, 10.0, 1, 4, 3,
                                          seed=2))
    cache, ready = tmp_path / "daemon_cache", tmp_path / "ready.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlp_tpu_torch.serve", "--device", "cpu",
         "--corpus", str(corpus), "--port", "0", "--ready-file",
         str(ready), "--compile-cache", str(cache)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, env=env,
        cwd=tmp_path)
    try:
        doc = sc.await_ready(proc, str(ready), timeout_s=120)
        cli = sc.ServeClient(doc["port"])
        assert cli.stats()["ok"]
        cli.close()
        sc.sigterm_drain(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    assert cache.is_dir()
    rec_path = tmp_path / "tune.json"
    rc, out = _stdout(tune_main, [
        "--smoke", "--out", str(tmp_path / "variants.json"), "--record",
        str(rec_path), "--compile-cache", str(tmp_path / "tune_cache")])
    assert rc == 0 and (tmp_path / "tune_cache").is_dir()
    rec = RunRecord.load(str(rec_path))
    assert (rec.kind, rec.tool, rec.device) == ("tune",
                                                "dmlp_tpu_torch.tune", "cpu")
    assert rec.config["smoke"] and rec.metrics["winners"]
    assert rec.artifacts["cache"] == str(tmp_path / "variants.json")


def test_every_fleet_spawn_carries_the_cache(no_cache, tmp_path):
    from dmlp_tpu_torch.fleet import harness as fh
    from dmlp_tpu_torch.fleet.autoscale import ReplicaSpec
    cmds = []

    class FakePopen:
        def __init__(self, cmd, **kw):
            cmds.append(cmd)

    no_cache.setattr(fh.subprocess, "Popen", FakePopen)
    spec = ReplicaSpec(str(tmp_path / "c.in"), str(tmp_path),
                       flags=["--device", "cpu"], compile_cache="cc")
    spec.spawn("replica00")                     # first generation
    spec.spawn("replica01", capacity=4096)      # a re-split's capacity
    fh.spawn_replica(str(tmp_path / "c.in"), str(tmp_path), "plain", "1x1")
    want = str(Path("cc").resolve())
    for cmd in cmds[:2]:
        i = cmd.index("--compile-cache")
        assert cmd[i + 1] == want
    assert "--compile-cache" not in cmds[2]
    assert "--capacity" in cmds[1]
