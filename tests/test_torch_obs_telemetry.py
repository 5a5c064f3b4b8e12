"""The port's live telemetry (``obs.telemetry``) against the reference's:
byte-equal OpenMetrics from one script of registry operations, equal
windowed quantiles, the session's scrape endpoint, the device-memory
sampler's CPU marker, and the SLO engine (``obs.slo``) evaluating the same
objectives over the same sample stream to the same states."""

import json
import math
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from dmlp_tpu.obs import slo as ref_slo  # noqa: E402
from dmlp_tpu.obs import telemetry as ref_tel  # noqa: E402
from dmlp_tpu_torch.obs import memwatch, slo, telemetry  # noqa: E402
from dmlp_tpu_torch.obs.run import RunRecord, round_from_name  # noqa: E402


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _drive(mod, clock):
    """One script of counter, gauge and histogram operations on a fresh
    registry of ``mod`` (a telemetry module)."""
    reg = mod.Registry()
    rng = np.random.default_rng(21)
    c = reg.counter("serve.requests", "requests seen")
    c.inc()
    c.inc(4, label="shed")
    c.inc(2.5, label="ok")
    g = reg.gauge("mem.device.bytes_in_use")
    g.set(123456789, label="0")
    g.set(7.25)
    reg.gauge("resilience.degrade_rung").set(0)
    h = reg.histogram("serve.request_latency_ms", unit="ms")
    h.enable_windows(max_window_s=60, sub_s=2.5, time_fn=clock)
    for i, v in enumerate(rng.lognormal(3.0, 1.2, 400)):
        h.observe(float(v), exemplar=f"r{i}" if i % 37 == 0 else None)
        clock.t += 0.11
    h.observe(0.0)
    h.observe(math.nan)
    h.observe(9e6)
    h2 = reg.histogram("span.latency_ms", "spans", unit="ms")
    for v in (1e-4, 0.001, 0.5, 3.0, 3.0, 999.0):
        h2.observe(v)
    return reg


def test_openmetrics_is_byte_equal_to_the_reference():
    port = _drive(telemetry, Clock())
    ref = _drive(ref_tel, Clock())
    text = port.to_openmetrics()
    assert text == ref.to_openmetrics()
    assert telemetry.validate_openmetrics(text) == []
    assert ref_tel.validate_openmetrics(text) == []
    assert port.snapshot() == ref.snapshot()


def test_window_quantiles_equal_the_reference():
    cp, cr = Clock(), Clock()
    hp = _drive(telemetry, cp).get("serve.request_latency_ms")
    hr = _drive(ref_tel, cr).get("serve.request_latency_ms")
    for w in (5.0, 10.0, 30.0, 60.0):
        assert hp.window_snapshot(w) == hr.window_snapshot(w)
        for thr in (10.0, 40.0, 200.0):
            assert hp.window_above(w, thr) == hr.window_above(w, thr)


def test_values_past_the_last_bound_go_to_the_overflow_bucket():
    """The reference's ``bucket_index`` raises IndexError for a value past
    its last bound (1e7); the port's clamps it into the +Inf bucket."""
    h = telemetry.Registry().histogram("x.ms")
    assert telemetry.Histogram.bucket_index(5e12) == telemetry._NBUCKETS
    with pytest.raises(IndexError):
        ref_tel.Histogram.bucket_index(5e12)
    h.observe(5e12)
    assert h.bucket_counts()[-1] == (math.inf, 1)
    assert h.bucket_counts()[-2][1] == 0


def test_validator_flags_a_broken_exposition():
    text = _drive(telemetry, Clock()).to_openmetrics()
    bad = text.replace("# EOF\n", "")
    assert telemetry.validate_openmetrics(bad) == \
        ref_tel.validate_openmetrics(bad) != []


def test_session_serves_the_registry_on_its_port(tmp_path):
    """``GET /metrics`` on an ephemeral port serves exactly the registry's
    text; the snapshot file holds it at close; a CPU session reports the
    explicit no-stats marker and the port gauge."""
    sess = telemetry.start(path=str(tmp_path / "t.om"), port=0,
                           interval_s=3600, handle_signals=False,
                           device="cpu")
    try:
        telemetry.sample_memory_now()
        telemetry.registry().counter("serve.batches").inc(3)
        url = f"http://127.0.0.1:{sess.http_port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            body = r.read().decode()
        assert body == telemetry.registry().to_openmetrics()
        assert telemetry.validate_openmetrics(body) == []
        assert f"telemetry_http_port {sess.http_port}" in body
        assert "mem_stats_unavailable 1" in body
        assert sess.sampler.measured_peak()["unavailable"]
    finally:
        sess.close()
    assert telemetry.session() is None
    snap = (tmp_path / "t.om").read_text()
    assert telemetry.validate_openmetrics(snap) == []
    rec = sess.snapshot_record().to_dict()
    assert rec["kind"] == "telemetry" and rec["device"] == "cpu"
    assert rec["metrics"]["serve_batches_total"] >= 3


def test_memory_model_and_reconcile_on_the_cpu():
    """The CPU reports no allocator stats: reconcile carries the explicit
    marker beside the model's bytes; a measured basis gets the verdict."""
    model = memwatch.single_engine_model(9000, 24, 6, 16)
    assert model["select"] == "topk"
    got = memwatch.reconcile(model, memwatch.peak_watermark("cpu"))
    assert got["mem_stats_unavailable"]
    assert got["model_bytes"] == model["total_bytes"] == sum(
        model["terms"].values())
    ok = memwatch.reconcile(model, {"bytes": 2 * model["total_bytes"],
                                    "basis": "max_memory_allocated"})
    assert ok["within_tolerance"] and ok["ratio"] == 2.0


def test_run_record_round_trips(tmp_path):
    rec = RunRecord(kind="engine", tool="t", metrics={"x": 1.5},
                    device="cpu", round=round_from_name("BENCH_r11.json"))
    path = rec.append_jsonl(str(tmp_path / "r.jsonl"))
    back = RunRecord.load(path)
    assert back.to_dict() == rec.to_dict() and back.round == 11


# -- SLO ----------------------------------------------------------------------

OBJECTIVES = ["serve.request_latency_ms p99 < 50 over 20s",
              "serve.requests_completed/serve.requests availability > 0.9 "
              "over 10s"]


def _slo_run(tel, slo_mod):
    """The same objectives and synthetic stream in one package: latency
    bursts that go bad, recover and go bad again, with failed requests in
    the middle; returns the evaluator after 60 ticks."""
    clock = Clock()
    reg = tel.Registry()
    ev = slo_mod.SLOEvaluator(OBJECTIVES, reg, time_fn=clock,
                              flight_dump=False, sub_s=0.5,
                              trend_metrics=["serve.phase.queue.ms"])
    h = reg.histogram("serve.request_latency_ms", unit="ms")
    q = reg.histogram("serve.phase.queue.ms", unit="ms")
    ok, total = reg.counter("serve.requests_completed"), \
        reg.counter("serve.requests")
    rng = np.random.default_rng(8)
    out = []
    for tick in range(60):
        slow = 15 <= tick < 30 or tick >= 45
        for v in rng.lognormal(4.5 if slow else 2.0, 0.3, 20):
            h.observe(float(v))
            q.observe(float(v) * 0.3 + tick)
        total.inc(20)
        ok.inc(10 if 20 <= tick < 28 else 20)
        clock.t += 0.5
        out.append(ev.tick())
    return ev, out


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b)) \
            or abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1.0)
    return a == b


def test_slo_states_transitions_and_signals_equal_the_reference():
    ev, trans = _slo_run(telemetry, slo)
    rev, rtrans = _slo_run(ref_tel, ref_slo)
    assert json.dumps(trans) == json.dumps(rtrans)
    assert ev.transitions == rev.transitions
    states = [t["state"] for tick in trans for t in tick]
    assert "firing" in states and "ok" in states
    for o in ev.objectives:
        assert ev.state(o.name) == rev.state(o.name)
        assert ev.alert_cycles(o.name) == rev.alert_cycles(o.name)
        a, b = ev.signals(o.name), rev.signals(o.name)
        assert set(a) == set(b)
        assert all(_close(a[k], b[k]) for k in a), (a, b)
    assert _close(ev.trend_slope("serve.phase.queue.ms"),
                  rev.trend_slope("serve.phase.queue.ms"))
    assert ev.snapshot() == rev.snapshot()


def test_slo_grammar_and_trend_equal_the_reference():
    for spec in OBJECTIVES + ["fleet.x_ms p95 < 12.5 over 1m",
                              "a.ok/a.all availability > 0.999 over 0.5h"]:
        a, b = slo.parse_objective(spec), ref_slo.parse_objective(spec)
        assert (a.name, a.kind, a.budget, a.window_s, a.describe()) == \
            (b.name, b.kind, b.budget, b.window_s, b.describe())
    with pytest.raises(ValueError):
        slo.parse_objective("latency is fine")
    pts = [(float(i), float(i * i % 7)) for i in range(12)]
    assert slo.theil_sen(pts) == ref_slo.theil_sen(pts)
    assert math.isnan(slo.theil_sen([(1.0, 2.0)]))
