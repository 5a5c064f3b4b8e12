"""The port's bench A/B arms on the CPU (``dmlp_tpu_torch.bench.harness``):
``--fused-ab`` (``DMLP_TPU_FUSED``: K1 against K2, both arms' stdout
byte-equal, each arm's recorded launches, the vacuous marker where the
solve never takes the fused path), ``--prune-ab`` (``DMLP_TPU_PRUNE``)
and ``--precision-ab`` (``DMLP_TPU_PRECISION``), each with its own
``kind`` RunRecord naming the device."""

import io
import json

import pytest

from dmlp_tpu_torch.bench import configs, harness
from dmlp_tpu_torch.obs import ledger

TINY = dict(config_id=1, num_data=1024, num_queries=40, num_attrs=6,
            min_attr=0.0, max_attr=10.0, min_k=1, max_k=8, num_labels=4,
            seed=7, input_name="tiny_ab.in")


def _records(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_extract_config_arms(monkeypatch, tmp_path):
    """The extraction path pinned (``--pallas --select extract``): the
    fused arm dispatches K1, the two-pass arm K2, byte-identical to each
    other and to the oracle; the prune and precision A/Bs record their
    arms and their own RunRecords."""
    cfg = configs.BenchConfig(**TINY, use_pallas=True, select="extract")
    monkeypatch.setitem(configs.BENCH_CONFIGS, 1, cfg)
    rec_path = tmp_path / "bench_r02.jsonl"
    buf = io.StringIO()
    res = harness.run_config(1, base_dir=str(tmp_path), out=buf,
                             fused_ab=True, prune_ab=True,
                             precision_ab=True, device="cpu",
                             record_path=str(rec_path))
    assert res["checksums_match"], buf.getvalue()
    assert res["fused_ab_identical"] is True
    assert "fused_ab_vacuous" not in res
    assert res["fused_ab_impls"] == {"fused": ["fused"],
                                     "two_pass": ["extract"]}
    launches = res["fused_ab_launches"]
    assert launches["fused"].get("fused_topk", 0) >= 1
    assert launches["fused"].get("extract_topk", 0) == 0
    assert launches["two_pass"].get("extract_topk", 0) >= 1
    assert launches["two_pass"].get("fused_topk", 0) == 0
    assert len(res["engine_ms_fused_reps"]) == 1
    assert "fused A/B" in buf.getvalue()
    assert res["prune_ab_identical"] is True
    assert res["scanned_bytes_pruned"] <= res["scanned_bytes_dense"]
    assert res["precision_ab_identical"] is True
    assert "engine_ms_bf16" in res or res.get("precision_ab_vacuous")
    recs = _records(rec_path)
    assert [r["kind"] for r in recs] == ["prune", "precision", "bench"]
    assert all(r["device"] == "cpu" and r["round"] == 2
               and r["tool"] == "dmlp_tpu_torch.bench" for r in recs)
    assert recs[-1]["metrics"]["engine_ms_fused"] == res["engine_ms_fused"]
    series = ledger.build_ledger(str(tmp_path))["series"]
    assert "harness/config1/engine_ms_fused" in series
    assert "prune/config1/engine_ms_pruned" in series
    assert any(s.startswith("precision/config1/") for s in series)


def test_fused_ab_without_the_extract_path_is_vacuous(monkeypatch,
                                                      tmp_path):
    """A config that sorts (no kernel path): identical arms, timings
    withheld, the explicit vacuous marker."""
    cfg = configs.BenchConfig(**{**TINY, "num_data": 200})
    monkeypatch.setitem(configs.BENCH_CONFIGS, 1, cfg)
    res = harness.run_config(1, base_dir=str(tmp_path), out=io.StringIO(),
                             fused_ab=True, device="cpu")
    assert res["checksums_match"]
    assert res["fused_ab_vacuous"] is True
    assert res["fused_ab_identical"] is True
    assert "never takes the fused path" in res["fused_ab_unavailable"]
    assert "engine_ms_fused" not in res


@pytest.mark.parametrize("fn,marker", [
    (harness._measure_fused_ab, "fused_ab_unavailable"),
    (harness._measure_prune_ab, "prune_ab_unavailable"),
    (harness._measure_precision_ab, "precision_ab_unavailable"),
    (harness._measure_auto_ab, "auto_ab_unavailable"),
    (harness._measure_obs_overhead, "obs_overhead_unavailable")])
def test_arms_refuse_a_cluster_config_with_their_marker(fn, marker):
    kw = dict(input_path="x", outputs_dir="y", out=io.StringIO(),
              fast=False, timeout_s=1.0, env=None, pairs=1, device="cpu")
    if fn is not harness._measure_auto_ab:
        kw["mode"] = None
    if fn is not harness._measure_obs_overhead:
        kw["oracle_want"] = None
    res = fn(configs.BENCH_CONFIGS[5], **kw)
    assert set(res) == {marker} and "multi-process" in res[marker]


def test_a_mismatching_arm_withholds_the_timings(monkeypatch, tmp_path):
    """An arm whose stdout differs from the other's: identity false,
    no engine_ms_* in the result."""
    from pathlib import Path
    calls = []

    def fake(cfg, input_path, outputs_dir, **kw):
        calls.append(kw)
        out = Path(outputs_dir) / "tmp.out"
        err = Path(outputs_dir) / "tmp.err"
        out.write_text(f"checksum: {len(calls) % 2}\n")
        err.write_text("Time taken: 5 ms\n")
        metrics = kw["obs_flags"][1]
        with open(metrics, "a") as f:
            f.write(json.dumps({"event": "summary", "extract_impl": "fused"})
                    + "\n")
        return str(out), str(err)

    monkeypatch.setattr(harness, "run_engine", fake)
    res = harness._measure_fused_ab(
        configs.BenchConfig(**TINY), "in", str(tmp_path), io.StringIO(),
        mode=None, fast=False, timeout_s=1.0, env=None, pairs=1,
        oracle_want=None, device="cpu")
    assert res == {"fused_ab_unavailable": res["fused_ab_unavailable"],
                   "fused_ab_identical": False}
    assert {c["device"] for c in calls} == {"cpu"}
