"""The port's bench harness and driver (``dmlp_tpu_torch.bench``) on the
CPU, held against the reference's (``dmlp_tpu.bench``, the root
``bench.py``) at a tiny configuration: the same inputs, oracle outputs,
report text, reference-binary fields and engine stdout; the repeats, the
kill timeout, error isolation and the engine flags; the driver's JSON
line. The A/B arms are in ``test_torch_bench_ab.py``, the mesh, cluster
and serving modes in ``test_torch_bench_mesh.py``."""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dmlp_tpu.bench import configs as ref_configs
from dmlp_tpu.bench import harness as ref_harness
from dmlp_tpu_torch.bench import configs, harness

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(config_id=1, num_data=200, num_queries=20, num_attrs=4,
            min_attr=0.0, max_attr=10.0, min_k=1, max_k=8, num_labels=4,
            seed=7, input_name="tiny.in")


@pytest.fixture
def tiny(monkeypatch):
    """Config 1 shrunk to 200 x 20 x 4 in both packages."""
    cfg = configs.BenchConfig(**TINY)
    monkeypatch.setitem(configs.BENCH_CONFIGS, 1, cfg)
    monkeypatch.setitem(ref_configs.BENCH_CONFIGS, 1,
                        ref_configs.BenchConfig(**TINY))
    return cfg


def test_configs_are_the_references():
    """Configs 1-5: the reference's generator arguments, seeds, input
    names, modes, meshes and paths, but config 3 pins the hand-written
    kernels as config 2 does; the mesh and cluster configs name gloo (the
    ranks share one card)."""
    gen = ("num_data", "num_queries", "num_attrs", "min_attr", "max_attr",
           "min_k", "max_k", "num_labels", "seed", "input_name", "mode",
           "mesh_shape", "use_pallas", "select", "procs", "timeout_s")
    assert set(configs.BENCH_CONFIGS) == set(ref_configs.BENCH_CONFIGS)
    for cid, cfg in configs.BENCH_CONFIGS.items():
        ref = ref_configs.BENCH_CONFIGS[cid]
        differ = {f for f in gen if getattr(cfg, f) != getattr(ref, f)}
        assert differ == ({"use_pallas"} if cid == 3 else set())
        assert cfg.backend == ("gloo" if cid in (3, 5) else None)
    assert configs.BENCH_CONFIGS[3].use_pallas


def test_inputs_and_oracle_are_byte_identical(tiny, tmp_path):
    port = harness.ensure_input(tiny, str(tmp_path / "port"))
    ref = ref_harness.ensure_input(ref_configs.BENCH_CONFIGS[1],
                                   str(tmp_path / "ref"))
    assert Path(port).read_bytes() == Path(ref).read_bytes()
    mtime = os.path.getmtime(port)
    assert harness.ensure_input(tiny, str(tmp_path / "port")) == port
    assert os.path.getmtime(port) == mtime          # cached
    buf, rbuf = io.StringIO(), io.StringIO()
    out, _ = harness.ensure_oracle(tiny, port, str(tmp_path / "po"), buf)
    rout, _ = ref_harness.ensure_oracle(ref_configs.BENCH_CONFIGS[1], ref,
                                        str(tmp_path / "ro"), rbuf)
    assert Path(out).read_bytes() == Path(rout).read_bytes()
    assert buf.getvalue() == rbuf.getvalue() == ""
    harness.ensure_oracle(tiny, port, str(tmp_path / "po"), buf)
    assert buf.getvalue() == "Output found in cache. Skipping...\n"


@pytest.mark.parametrize("oracle,engine", [
    ("Time taken: 100 ms\n", "Time taken: 80 ms\n"),
    ("Time taken: 80 ms\n", "Time taken: 100 ms\n"),
    ("Time taken: 7 ms\n", "Time taken: 7 ms\n"),
    ("Time taken: 0 ms\n", "Time taken: 3 ms\n"),
    ("nope\n", "Time taken: 1 ms\n")])
def test_compare_times_prints_the_references_text(oracle, engine):
    out, ref = io.StringIO(), io.StringIO()
    pct = harness.compare_times(oracle, engine, out)
    assert pct == ref_harness.compare_times(oracle, engine, ref)
    assert out.getvalue() == ref.getvalue()


@pytest.mark.parametrize("cid", [1, 2, 3, 4])
def test_reference_binary_fields_equal_the_references(cid, tmp_path):
    cap = str(ROOT / "oracle_capture" / "ORACLE_GOLDEN.json")
    got = harness.reference_binary_fields(cap, cid, 123.0)
    assert got and got == ref_harness.reference_binary_fields(cap, cid,
                                                              123.0)
    assert harness.reference_binary_fields(str(tmp_path / "no"), cid,
                                           123.0) == {}


def test_engine_flags_carry_the_configs_path():
    c3 = configs.BENCH_CONFIGS[3]
    assert harness._engine_flags(c3, "sharded") == [
        "--mesh", "4,2", "--backend", "gloo", "--pallas", "--device", "cuda"]
    assert harness._engine_flags(c3, "single", "cpu") == [
        "--pallas", "--device", "cpu"]
    assert harness._engine_flags(configs.BENCH_CONFIGS[5], "sharded") == [
        "--backend", "gloo", "--device", "cuda"]
    c = configs.BenchConfig(**{**TINY, "use_pallas": True,
                               "select": "seg"})
    assert harness._engine_flags(c, "single", "cpu") == [
        "--pallas", "--select", "seg", "--device", "cpu"]


def test_run_config_end_to_end_equals_the_reference(tiny, tmp_path):
    """One run_config in both packages: the same verdict, byte-identical
    tmp.out, the same result keys but ``counters_dispatches`` (the port
    reads its ``--counters`` line's recorded launches), a RunRecord on
    each side that names the CPU."""
    buf, rbuf = io.StringIO(), io.StringIO()
    res = harness.run_config(1, base_dir=str(tmp_path / "port"), out=buf,
                             counters=True, device="cpu",
                             record_path=str(tmp_path / "port_r01.jsonl"))
    ref = ref_harness.run_config(1, base_dir=str(tmp_path / "ref"),
                                 out=rbuf, counters=True,
                                 record_path=str(tmp_path / "ref_r01.jsonl"))
    assert res["checksums_match"] and ref["checksums_match"]
    tmp = [(tmp_path / d / "outputs" / "tmp.out").read_bytes()
           for d in ("port", "ref")]
    assert tmp[0] == tmp[1] and tmp[0].count(b"\n") == 20
    port_only = {"counters_dispatches"}
    assert set(res) - port_only == set(ref)
    assert res["counters_dispatches"] >= 1
    for text in (buf.getvalue(), rbuf.getvalue()):
        assert "Config 1: checksums PASS (20 queries)" in text
        assert "=== Performance Comparison ===" in text
    rec = json.loads((tmp_path / "port_r01.jsonl").read_text())
    ref_rec = json.loads((tmp_path / "ref_r01.jsonl").read_text())
    assert (rec["kind"], rec["tool"], rec["device"], rec["round"]) == (
        "bench", "dmlp_tpu_torch.bench", "cpu", 1)
    assert ref_rec["device"] == "cpu"
    assert set(rec) == set(ref_rec)


def test_reps_report_the_median_of_every_run(tiny, tmp_path):
    res = harness.run_config(1, base_dir=str(tmp_path), reps=3,
                             out=io.StringIO(), device="cpu")
    assert res["checksums_match"] and len(res["engine_ms_reps"]) == 3
    assert res["engine_ms"] == round(sorted(res["engine_ms_reps"])[1])


def test_a_rep_with_wrong_output_drops_the_timings(tiny, tmp_path,
                                                   monkeypatch):
    times, wrong = iter([30, 10, 20]), {2}
    calls = []

    def fake(cfg, input_path, outputs_dir, **kw):
        calls.append(kw)
        want = (tmp_path / "outputs" / "test_1.out").read_text()
        out, err = (Path(outputs_dir) / "tmp.out",
                    Path(outputs_dir) / "tmp.err")
        out.write_text("bad\n" if len(calls) in wrong else want)
        err.write_text(f"Time taken: {next(times)} ms\n")
        return str(out), str(err)

    monkeypatch.setattr(harness, "run_engine", fake)
    res = harness.run_config(1, base_dir=str(tmp_path), reps=3,
                             out=io.StringIO(), device="cpu")
    assert not res["checksums_match"] and "engine_ms_reps" not in res
    assert len(calls) == 2 and calls[0]["device"] == "cpu"
    wrong.clear()
    times, calls[:] = iter([30, 10, 20]), []
    res = harness.run_config(1, base_dir=str(tmp_path), reps=3,
                             out=io.StringIO(), device="cpu")
    assert res["engine_ms_reps"] == [30, 10, 20] and res["engine_ms"] == 20


def test_the_kill_timeout_records_timed_out(tiny, tmp_path):
    inp = harness.ensure_input(tiny, str(tmp_path / "inputs"))
    with pytest.raises(harness.EngineTimeout):
        harness.run_engine(tiny, inp, str(tmp_path), timeout_s=0.01,
                           device="cpu")
    buf = io.StringIO()
    rec_path = tmp_path / "runs.jsonl"
    res = harness.run_config(1, base_dir=str(tmp_path), out=buf,
                             timeout_s=0.01, device="cpu",
                             record_path=str(rec_path),
                             profile_dir=str(tmp_path / "prof"))
    assert res["timed_out"] is True and not res["checksums_match"]
    assert "TIMEOUT" in buf.getvalue()
    rec = json.loads(rec_path.read_text())
    assert rec["metrics"]["timed_out"] and rec["device"] == "cpu"
    assert "profile_unavailable" in rec["metrics"]


def test_an_engine_error_is_isolated_and_the_default_is_the_card(
        tiny, tmp_path, monkeypatch, capsys):
    """``all`` runs on past a config whose engine fails (its record
    carries the error); without ``--device`` the engine runs on the card,
    which this machine lacks, so the run fails rather than fall back."""
    monkeypatch.setitem(configs.BENCH_CONFIGS, 2, configs.BenchConfig(
        **{**TINY, "config_id": 2, "select": "nope"}))
    monkeypatch.setattr(configs, "BENCH_CONFIGS",
                        {k: configs.BENCH_CONFIGS[k] for k in (2, 1)})
    monkeypatch.setattr(harness, "BENCH_CONFIGS", configs.BENCH_CONFIGS)
    rec_path = tmp_path / "runs.jsonl"
    rc = harness.main(["all", "--device", "cpu", "--base-dir",
                       str(tmp_path), "--record", str(rec_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "Config 2: ERROR" in out and "Config 1: checksums PASS" in out
    recs = [json.loads(ln) for ln in rec_path.read_text().splitlines()]
    assert [r["config"]["config_id"] for r in recs] == [2, 1]
    assert "error" in recs[0]["metrics"] and recs[1]["metrics"][
        "checksums_match"]
    import torch
    if not torch.cuda.is_available():
        assert harness.main(["1", "--base-dir", str(tmp_path)]) == 1
        assert "torch.cuda.is_available" in capsys.readouterr().out


def _driver_keys(cmd, env_extra):
    env = dict(os.environ, BENCH_NUM_DATA="3000", BENCH_NUM_QUERIES="128",
               BENCH_NUM_ATTRS="8", BENCH_K="8", BENCH_REPEATS="1",
               PYTHONPATH=str(ROOT), **env_extra)
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    (line,) = p.stdout.splitlines()
    return json.loads(line)


def test_driver_prints_the_reference_benchs_line():
    """One JSON line with the root ``bench.py``'s top-level keys at the
    same shape; the same workload, so the same shape block. On the CPU
    the device solve (CUDA events) says why it is absent."""
    port = _driver_keys([sys.executable, "-m", "dmlp_tpu_torch.bench.driver",
                         "--device", "cpu"], {})
    ref = _driver_keys([sys.executable, "bench.py"],
                       {"BENCH_DEVICE_SOLVE": "0"})
    assert set(port) == set(ref)
    assert port["shape"] == ref["shape"] and port["metric"] == "knn_solve_ms"
    assert port["path"]["device"] == "cpu" and port["value"] > 0
    assert "device_solve_unavailable" in port["path"]
    assert port["baseline_kind"] == ref["baseline_kind"]
