"""The port's bench on the mesh, the cluster and the daemon, on the CPU:
``--auto-ab`` at (2, 1) on gloo (auto, sharded and ring byte-equal, each
rank's launches, the per-arm collective bytes of ``--hlo-report``, a
``kind="auto"`` RunRecord), a 2-process analog of config 5 through
``python -m dmlp_tpu_torch.distributed`` on gloo, and ``bench serve``
over ``inputs/serve_trace2.jsonl`` (every response the oracle's, both
gate-carry arms, the build and load counters flat, SIGTERM drains)."""

import io
import json
from pathlib import Path

from dmlp_tpu_torch.bench import configs, harness

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(num_data=600, num_queries=24, num_attrs=4, min_attr=0.0,
             max_attr=10.0, min_k=1, max_k=8, num_labels=4, seed=7)


def test_auto_ab_on_a_two_rank_gloo_mesh(monkeypatch, tmp_path):
    cfg = configs.BenchConfig(3, **SMALL, input_name="mesh.in",
                              mode="sharded", mesh_shape=(2, 1),
                              backend="gloo")
    monkeypatch.setitem(configs.BENCH_CONFIGS, 3, cfg)
    rec_path = tmp_path / "auto_r03.jsonl"
    buf = io.StringIO()
    res = harness.run_config(3, base_dir=str(tmp_path), out=buf,
                             auto_ab=True, device="cpu",
                             record_path=str(rec_path))
    assert res["checksums_match"], buf.getvalue()
    assert res["auto_ab_identical"] is True
    assert res["auto_ab_mesh_ranks"] == 2
    assert "auto_ab_degenerate_mesh" not in res
    for arm in ("auto", "sharded", "ring"):
        assert len(res[f"engine_ms_{arm}_reps"]) == 1
        assert res[f"warmup_ms_{arm}"] >= 0
        ranks = res["auto_ab_launches"][arm]
        assert len(ranks) == 2 and all(isinstance(r, dict) for r in ranks)
        assert f"auto_hlo_bytes_{arm}" in res, res.get(
            "auto_hlo_unavailable")
    assert "compile_ms_auto" not in res
    assert set(res["auto_ab_repairs"]) == {"auto", "sharded", "ring"}
    assert "auto A/B" in buf.getvalue()
    recs = [json.loads(ln) for ln in rec_path.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["auto", "bench"]
    assert recs[0]["device"] == "cpu" and recs[0]["round"] == 3
    assert recs[0]["metrics"]["engine_ms_auto"] == res["engine_ms_auto"]


def test_a_two_process_cluster_analog_of_config5(monkeypatch, tmp_path):
    cfg = configs.BenchConfig(5, **SMALL, input_name="c5.in",
                              mode="sharded", procs=2, backend="gloo")
    monkeypatch.setitem(configs.BENCH_CONFIGS, 5, cfg)
    buf = io.StringIO()
    res = harness.run_config(5, base_dir=str(tmp_path), out=buf,
                             device="cpu", counters=True,
                             record_path=str(tmp_path / "c5_r01.jsonl"))
    assert res["checksums_match"], buf.getvalue()
    assert "single-process configs only" in buf.getvalue()
    assert (tmp_path / "outputs" / "tmp.out").read_text().count("\n") == 24
    rec = json.loads((tmp_path / "c5_r01.jsonl").read_text())
    assert rec["config"]["procs"] == 2 and rec["device"] == "cpu"


def test_serve_replays_trace2_golden_in_both_arms(tmp_path):
    rec_path = tmp_path / "serve_r01.jsonl"
    buf = io.StringIO()
    res = harness.run_serve(
        base_dir=str(tmp_path),
        trace_path=str(ROOT / "inputs" / "serve_trace2.jsonl"), reps=1,
        record_path=str(rec_path), timeout_s=180, device="cpu", out=buf)
    assert res["ok"] and res["checksums_match"]
    assert res["requests"] == 14
    for arm in ("on", "off"):
        assert res[f"requests_per_sec_carry_{arm}"] > 0
        assert len(res[f"carry_{arm}_latency_ms"]) == 14
    assert "byte-identical to the golden oracle" in buf.getvalue()
    (rec,) = [json.loads(ln) for ln in rec_path.read_text().splitlines()]
    assert (rec["kind"], rec["tool"], rec["device"]) == (
        "serve", "dmlp_tpu_torch.bench", "cpu")
    assert rec["config"]["trace"] == "serve_trace2.jsonl"
