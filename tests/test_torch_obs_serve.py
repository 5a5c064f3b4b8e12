"""The serving daemon with observability on, on the CPU: the telemetry
session's ``GET /metrics`` (request latency histogram, kernel dispatches)
validates, the SLO block rides ``stats``, every micro-batch logs the
launches its cost probe recorded, each rid's request-phase spans come in
the canonical order, and ``python -m dmlp_tpu_torch.serve`` takes
``--telemetry``, ``--telemetry-port``, ``--trace``, ``--slo`` and
``--record`` through a SIGTERM drain."""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

pytest.importorskip("jax")

from dmlp_tpu_torch.config import EngineConfig  # noqa: E402
from dmlp_tpu_torch.io.grammar import parse_input_text  # noqa: E402
from dmlp_tpu_torch.obs import counters as obs_counters  # noqa: E402
from dmlp_tpu_torch.obs import telemetry  # noqa: E402
from dmlp_tpu_torch.obs import trace as obs_trace  # noqa: E402
from dmlp_tpu_torch.serve import client as sc  # noqa: E402
from dmlp_tpu_torch.serve.daemon import ServeDaemon  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TRACE = sc.load_trace(str(ROOT / "inputs" / "serve_trace2.jsonl"))
ORDER = ("queue", "coalesce", "solve", "finalize", "write")
SLO = "serve.request_latency_ms p99 < 60000 over 1m"


def _phase_order_ok(events):
    """Per rid: one span of each of its serve.phase.* phases (admission
    aside, it runs beside the queue wait), starting in the canonical order
    (the reference checker's rule: a phase never starts before the one
    ahead of it; a zero queue wait ties the coalesce start)."""
    by_rid = {}
    for e in events:
        name = e["name"]
        rid = e.get("args", {}).get("rid")
        if e.get("ph") == "X" and rid and name.startswith("serve.phase.") \
                and name != "serve.phase.admission":
            by_rid.setdefault(rid, {}).setdefault(
                name.split(".")[2], []).append(e["ts"])
    for rid, phases in by_rid.items():
        assert set(ORDER) == set(phases), (rid, sorted(phases))
        assert all(len(v) == 1 for v in phases.values()), (rid, phases)
        starts = [phases[p][0] for p in ORDER]
        assert starts == sorted(starts), (rid, phases)
    return by_rid


def test_daemon_telemetry_slo_and_request_phases(tmp_path):
    header, reqs = TRACE
    corpus = parse_input_text(sc.corpus_text(header))
    trace_path = tmp_path / "serve.json"
    d = ServeDaemon(corpus, EngineConfig(use_pallas=True, device="cpu"),
                    port=0, telemetry_port=0, trace_path=str(trace_path),
                    objectives=[SLO],
                    record_path=str(tmp_path / "rec.jsonl"))
    d.start()
    try:
        part = reqs[:10]
        res = sc.replay_open_loop(d.port, header, part, speed=50,
                                  rid_prefix="r")
        assert all(r["ok"] for r in res), res
        assert sc.contract_text([r["checksums"] for r in res]) == \
            sc.contract_text(sc.golden_reference(corpus, header, part))
        cli = sc.ServeClient(d.port)
        st = cli.stats()["stats"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.session.http_port}/metrics",
                timeout=10) as r:
            text = r.read().decode()
        assert telemetry.validate_openmetrics(text) == []
        assert f"serve_request_latency_ms_count {len(part)}" in text
        assert 'serve_kernel_dispatches_total{key="fused_topk"}' in text
        assert st["slo"]["objectives"]["serve.request_latency_ms:p99"][
            "state"] == "ok"
        for b in st["engine"]["batch_log"]:
            # On the CPU no kernel launches: the probe records the plain
            # versions' calls, one K1 per non-empty scheduled chunk.
            assert b["dispatches"].get("fused_topk", 0) >= 1
        cli.drain()
        cli.close()
        t = threading.Thread(target=d.run_until_drained, daemon=True)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        d.close()
    assert telemetry.session() is None and obs_counters.active() is None
    assert obs_trace.active() is None
    events = json.loads(trace_path.read_text())["traceEvents"]
    assert len(_phase_order_ok(events)) == len(reqs[:10])
    names = {e["name"] for e in events}
    assert {"client.request", "serve.micro_batch", "fleet.clock_sync",
            "serve.phase.admission", "serve.stage_resident",
            "serve.warmup_bucket", "serve.fold_schedule",
            "serve.solve_extract", "single.fetch"} <= names
    # The engine's spans of a traced batch carry its rids.
    tagged = [e for e in events if e["name"] == "serve.solve_extract"
              and e.get("args", {}).get("rids")]
    assert tagged and all(r.startswith("r") for e in tagged
                          for r in e["args"]["rids"].split(","))
    rec = json.loads((tmp_path / "rec.jsonl").read_text().splitlines()[-1])
    assert rec["kind"] == "serve" and rec["device"] == "cpu"
    assert rec["metrics"]["request_count"] == len(reqs[:10])


def test_serve_entry_takes_the_obs_flags(tmp_path):
    """The daemon's CLI in a fresh interpreter with every obs flag: ready
    file with the scrape port, a replay, SIGTERM, then the trace, the
    record and the final snapshot on disk."""
    header, reqs = TRACE
    corpus_path = tmp_path / "corpus.txt"
    corpus_path.write_text(sc.corpus_text(header))
    ready = tmp_path / "ready.json"
    err = tmp_path / "err.txt"
    with open(err, "w") as ef:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dmlp_tpu_torch.serve", "--device",
             "cpu", "--pallas", "--corpus", str(corpus_path), "--port", "0",
             "--ready-file", str(ready), "--telemetry",
             str(tmp_path / "t.om"), "--telemetry-port", "0", "--trace",
             str(tmp_path / "tr.json"), "--slo", SLO, "--record",
             str(tmp_path / "rec.jsonl")],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=ef,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    try:
        doc = sc.await_ready(proc, str(ready), timeout_s=240,
                             errlog=str(err))
        assert doc["telemetry_port"]
        res = sc.replay(doc["port"], header, reqs[:4], connections=2)
        assert all(r["ok"] for r in res)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{doc['telemetry_port']}/metrics",
                timeout=10) as r:
            assert telemetry.validate_openmetrics(r.read().decode()) == []
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert "drained clean" in err.read_text()
    assert not list(tmp_path.glob("FLIGHT_*.json"))   # a drain, no crash
    snap = (tmp_path / "t.om").read_text()
    assert telemetry.validate_openmetrics(snap) == []
    assert "serve_ready 0" in snap
    assert json.loads((tmp_path / "tr.json").read_text())["traceEvents"]
    rec = json.loads((tmp_path / "rec.jsonl").read_text().splitlines()[-1])
    assert rec["metrics"]["request_count"] == 4
