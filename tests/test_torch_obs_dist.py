"""Per-rank traces of the multi-process contract run on the CPU: ``python
-m dmlp_tpu_torch.distributed --trace DIR`` on 2 gloo ranks writes one
``trace-rank<NN>.json`` per rank with a clock-sync marker; the
reference's ``tools/merge_traces.py`` merges them (its all-gather byte
reconciliation included) and ``tools/check_trace.py --dist --ranks 2``
accepts the result, with stdout golden's and a telemetry file per rank."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_two_rank_traces_merge_and_pass_the_checker(tmp_path):
    text = generate_input_text(9000, 24, 6, 0.0, 50.0, 1, 16, 5, seed=7)
    src = tmp_path / "in.txt"
    src.write_text(text)
    tdir = tmp_path / "traces"
    p = subprocess.run(
        [sys.executable, "-m", "dmlp_tpu_torch.distributed", "--device",
         "cpu", "--supervise", "2", "--pallas", "--input", str(src),
         "--trace", str(tdir), "--telemetry", str(tmp_path / "t.om"),
         "--supervise-dir", str(tmp_path / "sup")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    golden = subprocess.run(
        [sys.executable, "-m", "dmlp_tpu_torch", "--engine", "golden"],
        input=text, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.stdout == golden.stdout
    assert "supervise:" not in p.stderr
    files = sorted(tdir.glob("trace-rank*.json"))
    assert [f.name for f in files] == ["trace-rank00.json",
                                       "trace-rank01.json"]
    for rank, f in enumerate(files):
        doc = json.loads(f.read_text())
        assert doc["dist"]["rank"] == rank and doc["dist"]["num_ranks"] == 2
        assert doc["dist"]["mesh"]["mesh_shape"] == {"data": 2, "query": 1}
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"dist.clock_sync", "dist.solve", "dist.allgather_candidates",
                "dist.solve_local_shards"} <= names
    assert sorted(x.name for x in tmp_path.glob("t.om.rank*")) == [
        "t.om.rank00", "t.om.rank01"]
    merged = tmp_path / "merged.json"
    m = subprocess.run([sys.executable, "tools/merge_traces.py", str(tdir),
                        "-o", str(merged)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert m.returncode == 0, m.stdout + m.stderr
    c = subprocess.run([sys.executable, "tools/check_trace.py", "--dist",
                        str(merged), "--ranks", "2"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert c.returncode == 0, c.stdout + c.stderr
    assert "comms reconcile ok" in c.stdout
    rec = json.loads(merged.read_text())["dist"]["comms_reconcile"]
    assert all(e["match"] for e in rec.values()) and len(rec) == 2
