"""The port's resilience layer against the reference's.

The same seeded fault schedule goes through both packages' engines (the
reference's kernels in Pallas interpret mode, the port's on their plain
versions): ``oom`` x 1..6 must land on the same rung with the same
degradation list and the same stdout; transients must be retried with the
same ``stats.snapshot()``; the same schedule file must write the same
injection log; malformed schedules must be rejected with the same message.
Plus the port's own units: ``classify`` on a real ``torch.cuda.
OutOfMemoryError`` and on the kernel errors, the ladder giving the failed
attempt's memory back, the kill switches, and ``--faults`` through both
CLIs in fresh interpreters.
"""

import gc
import io
import json
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dmlp_tpu import cli as ref_cli  # noqa: E402
from dmlp_tpu.config import EngineConfig as RefConfig  # noqa: E402
from dmlp_tpu.engine import single as ref_single  # noqa: E402
from dmlp_tpu.golden.reference import knn_golden  # noqa: E402
from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu.io.grammar import KNNInput, Params  # noqa: E402
from dmlp_tpu.io.grammar import parse_input as ref_parse_input  # noqa: E402
from dmlp_tpu.io.grammar import parse_input_text  # noqa: E402
from dmlp_tpu.io.report import format_results  # noqa: E402
from dmlp_tpu.ops import pallas_fused as ref_fused  # noqa: E402
from dmlp_tpu.resilience import degrade as ref_degrade  # noqa: E402
from dmlp_tpu.resilience import inject as ref_inject  # noqa: E402
from dmlp_tpu.resilience import retry as ref_retry  # noqa: E402
from dmlp_tpu.resilience import stats as ref_stats  # noqa: E402
from dmlp_tpu_torch import cli  # noqa: E402
from dmlp_tpu_torch.engine import single  # noqa: E402
from dmlp_tpu_torch.io.convert import (config_from_reference,  # noqa: E402
                                       from_reference)
from dmlp_tpu_torch.io.grammar import parse_input  # noqa: E402
from dmlp_tpu_torch.io.report import format_results as port_format  # noqa: E402
from dmlp_tpu_torch.kernels import (KernelBuildError,  # noqa: E402
                                    KernelLaunchError)
from dmlp_tpu_torch.ops import fused  # noqa: E402
from dmlp_tpu_torch.resilience import degrade, inject, retry, stats  # noqa: E402
from dmlp_tpu_torch.resilience.inject import (  # noqa: E402
    FaultSchedule, InjectedTransientError, SimulatedResourceExhausted)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_resilience_state(monkeypatch):
    """No schedule installed and zero counters in both packages, before
    and after every test."""
    for var in ("DMLP_TPU_FAULTS", "DMLP_TPU_RESILIENCE", "DMLP_TPU_PRUNE",
                "DMLP_TPU_FUSED", "DMLP_TPU_PRECISION", "DMLP_TPU_FAULT_LOG",
                "DMLP_TPU_OP_TIMEOUT_S"):
        monkeypatch.delenv(var, raising=False)
    for mod_stats, mod_inject in ((stats, inject), (ref_stats, ref_inject)):
        mod_stats.reset()
        mod_inject.uninstall()
    yield
    for mod_stats, mod_inject in ((stats, inject), (ref_stats, ref_inject)):
        mod_inject.uninstall()
        mod_stats.reset()


def _doc(faults, seed=0):
    return {"schema": 1, "seed": seed, "faults": faults}


def _solve_both(inp, faults, seed=0, **kw):
    """Solve ``inp`` under one configuration in both packages, each with a
    fresh copy of the schedule installed and fresh counters. Returns
    {"ref"|"port": (stdout, engine, snapshot, injection log)}."""
    cfg = RefConfig(**kw)
    out = {}
    for side, eng_cls, fmt, conv, mod_inject, mod_stats in (
            ("ref", ref_single.SingleChipEngine, format_results,
             lambda x: x, ref_inject, ref_stats),
            ("port", single.SingleChipEngine, port_format, from_reference,
             inject, stats)):
        mod_stats.reset()
        sched = mod_inject.install(
            mod_inject.FaultSchedule.from_dict(_doc(faults, seed)))
        try:
            eng = eng_cls(cfg if side == "ref"
                          else config_from_reference(cfg, device="cpu"))
            text = fmt(eng.run(conv(inp)))
        finally:
            mod_inject.uninstall()
        out[side] = (text, eng, mod_stats.snapshot(), sched.log)
    return out


def _assert_same(out, inp, rung):
    (rtext, ref, rsnap, rlog), (ptext, port, psnap, plog) = \
        out["ref"], out["port"]
    assert ptext == rtext == format_results(knn_golden(inp))
    assert port.last_degrade_rung == ref.last_degrade_rung == rung
    assert psnap == rsnap
    assert plog == rlog
    assert port._degrade_rung == ref._degrade_rung == "fused"


def _small_input():
    """tests/test_resilience.py's input: 96 rows, the "sort" path."""
    return parse_input_text(
        generate_input_text(96, 12, 4, -5, 5, 1, 8, 3, seed=21))


def _banded_input():
    """tests/test_prune.py's banded corpus: 8 blocks of 256 rows at
    --select topk --data-block 256 (the pipelined path, pruning)."""
    rng = np.random.default_rng(61)
    n, nq, na, block = 2048, 12, 5, 256
    data = rng.uniform(0, 5, (n, na))
    for b in range(n // block):
        data[b * block:(b + 1) * block] += 40.0 * b
    labels = rng.integers(0, 6, n).astype(np.int32)
    ks = rng.integers(1, 17, nq).astype(np.int32)
    q = rng.uniform(0, 5, (nq, na))
    q[-1] = data[n - block // 2] + rng.uniform(-0.5, 0.5, na)
    return KNNInput(Params(n, nq, na), labels, data, ks, q)


RUNG_AFTER = {1: "prune", 2: "fused", 3: "tuned", 4: "heuristic",
              5: "streaming", 6: "host"}


@pytest.mark.parametrize("times", list(RUNG_AFTER))
@pytest.mark.parametrize("path", ["sort", "topk"])
def test_stage_put_oom_ladder_matches_reference(path, times):
    inp, kw = (_small_input(), dict(data_block=32, query_block=8)) \
        if path == "sort" else (_banded_input(),
                                dict(select="topk", data_block=256,
                                     query_block=8))
    out = _solve_both(inp, [{"site": "single.stage_put", "kind": "oom",
                             "times": times}], **kw)
    _assert_same(out, inp, RUNG_AFTER[times])
    assert len(out["port"][2]["degradations"]) == times
    if path == "topk" and times < 6:
        port, ref = out["port"][1], out["ref"][1]
        assert port.last_prune == ref.last_prune
        assert (port.last_prune["blocks_pruned"] > 0) == (times == 1)


def _extract_input(ks=None):
    rng = np.random.default_rng(5)
    n, na = 2048, 4
    ks = rng.integers(1, 9, 10) if ks is None else np.asarray(ks)
    return KNNInput(Params(n, len(ks), na),
                    rng.integers(0, 4, n).astype(np.int32),
                    rng.uniform(-10, 10, (n, na)), ks.astype(np.int32),
                    rng.uniform(-10, 10, (len(ks), na)))


@pytest.mark.parametrize("times", list(RUNG_AFTER))
def test_extract_solve_oom_ladder_matches_reference(times):
    """--pallas: every rung down to "heuristic" launches the extraction
    kernel (K1 on the top three, K2 below); "streaming" folds through the
    seg step and never reaches the site, so a sixth fault stays unfired
    there."""
    inp = _extract_input()
    out = _solve_both(inp, [{"site": "single.extract_solve", "kind": "oom",
                             "times": times}], select="extract",
                      use_pallas=True)
    _assert_same(out, inp, RUNG_AFTER[min(times, 5)])
    port, ref = out["port"][1], out["ref"][1]
    assert len(out["port"][2]["degradations"]) == min(times, 5)
    assert (port._last_select, port.last_extract_impl) == \
        (ref._last_select, ref.last_extract_impl)
    assert port.last_extract_impl == (
        "fused" if times < 3 else "extract" if times < 5 else None)


@pytest.mark.parametrize("ks,times,rung", [
    ([3, 700, 1, 5, 900, 2], 2, "fused"),     # the router's fire
    ([600, 700, 650], 3, "tuned"),            # the multi-pass path's
    ([600, 700, 650], 5, "streaming")])
def test_extract_solve_oom_on_router_and_multipass(ks, times, rung):
    inp = _extract_input(ks)
    out = _solve_both(inp, [{"site": "single.extract_solve", "kind": "oom",
                             "times": times}], select="extract",
                      use_pallas=True)
    _assert_same(out, inp, rung)
    port, ref = out["port"][1], out["ref"][1]
    assert (port.last_hetk, port.last_mp_passes, port._last_select) == \
        (ref.last_hetk, ref.last_mp_passes, ref._last_select)


def test_transients_retried_with_the_same_counts():
    inp = _small_input()
    out = _solve_both(inp, [
        {"site": "single.stage_put", "kind": "transient", "times": 2},
        {"site": "single.fetch", "kind": "transient"}],
        data_block=32, query_block=8)
    _assert_same(out, inp, "lowp")
    snap = out["port"][2]
    assert snap["retries"] == 3 and snap["faults_injected"] == 3
    assert snap["retry_sites"] == {"single.stage_put": 2, "single.fetch": 1}


def test_probabilistic_faults_same_log_on_the_pipelined_path():
    """Seeded ``prob`` draws in hit order, delays, and transients at
    every site of the pipelined path: the same decisions, the same
    counters and the same bytes in both packages."""
    inp = _banded_input()
    out = _solve_both(inp, [
        {"site": "single.*", "kind": "delay", "times": 40, "prob": 0.5},
        {"site": "single.stage_put", "kind": "transient", "times": 2,
         "prob": 0.4, "after": 1}], seed=11, select="topk",
        data_block=256, query_block=8)
    _assert_same(out, inp, "lowp")
    assert any(e["fired"] for e in out["port"][3])
    assert not all(e["fired"] for e in out["port"][3])


def test_io_parse_corrupt_recovers():
    text = generate_input_text(64, 8, 3, -5, 5, 1, 8, 3, seed=4)
    want = parse_input_text(text)
    for mod_inject, mod_stats, parse in ((inject, stats, parse_input),
                                         (ref_inject, ref_stats,
                                          ref_parse_input)):
        mod_inject.install(mod_inject.FaultSchedule.from_dict(
            _doc([{"site": "io.parse", "kind": "corrupt"}])))
        got = parse(io.StringIO(text))
        np.testing.assert_array_equal(got.data_attrs, want.data_attrs)
        np.testing.assert_array_equal(got.ks, want.ks)
        assert mod_stats.snapshot()["retries"] == 1
        assert [e["fired"] for e in mod_inject.active().log] == [True]


def _cli_in_process(main, argv, text):
    out, err = io.StringIO(), io.StringIO()
    assert main(argv, stdin=io.StringIO(text), stdout=out, stderr=err) == 0
    return out.getvalue()


def test_same_schedule_file_same_injection_log(tmp_path, monkeypatch):
    text = generate_input_text(9000, 12, 4, 0, 50, 1, 16, 3, seed=9)
    sched = tmp_path / "sched.json"
    sched.write_text(json.dumps(_doc([
        {"site": "io.parse", "kind": "corrupt"},
        {"site": "single.extract_solve", "kind": "oom", "times": 2},
        {"site": "single.stage_put", "kind": "transient", "prob": 0.5,
         "times": 3},
        {"site": "single.fetch", "kind": "transient"},
        {"site": "single.*", "kind": "delay", "times": 5}], seed=5)))
    outs, logs = [], []
    for main, argv in ((ref_cli.main, []), (cli.main, ["--device", "cpu"])):
        log = tmp_path / f"log{len(logs)}.json"
        monkeypatch.setenv("DMLP_TPU_FAULT_LOG", str(log))
        outs.append(_cli_in_process(
            main, [*argv, "--pallas", "--faults", str(sched)], text))
        logs.append(log.read_text())
    assert outs[0] == outs[1]
    assert logs[0] == logs[1]
    fired = [e for e in json.loads(logs[1])["log"] if e["fired"]]
    assert {e["kind"] for e in fired} >= {"corrupt", "oom", "transient"}


MALFORMED = {
    "unknown_site": _doc([{"site": "engine.nope", "kind": "delay"}]),
    "unknown_kind": _doc([{"site": "single.fetch", "kind": "explode"}]),
    "unknown_field": _doc([{"site": "single.fetch", "kind": "delay",
                            "mss": 5}]),
    "bad_schema": {"schema": 2, "faults": []},
    "no_faults": {"schema": 1, "faults": []},
    "not_an_object": _doc(["single.fetch"]),
    "passive_at_wrong_site": _doc([{"site": "single.fetch",
                                    "kind": "nan"}]),
    "passive_glob": _doc([{"site": "*", "kind": "corrupt"}]),
    "bad_prob": _doc([{"site": "single.fetch", "kind": "delay",
                       "prob": 1.5}]),
    "bad_times": _doc([{"site": "single.fetch", "kind": "delay",
                        "times": 0}]),
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_schedule_validation_matches_reference(name):
    with pytest.raises(ValueError) as ref_err:
        ref_inject.FaultSchedule.from_dict(MALFORMED[name])
    with pytest.raises(ValueError) as port_err:
        FaultSchedule.from_dict(MALFORMED[name])
    assert str(port_err.value) == str(ref_err.value)


def test_schedule_file_not_json(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{schema: 1")
    with pytest.raises(ValueError, match="is not JSON"):
        FaultSchedule.from_file(str(bad))


def test_fire_semantics_match_reference():
    """after / when / times / passive rollback: the same returns and the
    same log, hit by hit, in both packages."""
    doc = _doc([{"site": "train.step", "kind": "nan", "when": {"step": 2}},
                {"site": "train.step", "kind": "transient",
                 "when": {"step": 2}},
                {"site": "single.fetch", "kind": "delay", "after": 1,
                 "times": 2}])
    trace = []
    for mod in (ref_inject, inject):
        s = mod.install(mod.FaultSchedule.from_dict(doc))
        seen = []
        for site, ctx in (("train.step", {"step": 1}),
                          ("train.step", {"step": 2}),
                          ("train.step", {"step": 2}),
                          ("single.fetch", {}), ("single.fetch", {}),
                          ("single.fetch", {}), ("single.fetch", {})):
            try:
                seen.append(mod.fire(site, **ctx))
            except mod.InjectedTransientError:
                seen.append("raised")
        mod.uninstall()
        trace.append((seen, s.log))
    assert trace[0] == trace[1]
    assert trace[1][0][:3] == [[], "raised", ["nan"]]


def test_corrupt_bytes_matches_reference():
    data = b"3 1 2\n" + b"0 1.0 2.0\n" * 3 + b"Q 1 0.5 0.5\n"
    for payload in (data, data.decode(), b"x" * 100, b"", "a\nb"):
        assert inject.corrupt_bytes(payload) == \
            ref_inject.corrupt_bytes(payload)


# -- retry and classify ------------------------------------------------------

def test_classify_torch_oom_and_kernel_errors():
    assert retry.classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 160.00 GiB")) == "oom"
    assert retry.classify(torch.cuda.OutOfMemoryError()) == "oom"
    assert retry.classify(SimulatedResourceExhausted("x")) == "oom"
    # A kernel that failed to build or launch is never walked past, even
    # when its message reads like an OOM.
    assert retry.classify(KernelBuildError("nvcc not found")) == "fatal"
    assert retry.classify(KernelLaunchError(
        "extract_topk kernel launch failed (cudaError 2): out of "
        "memory")) == "fatal"


@pytest.mark.parametrize("exc", [
    ConnectionError(), TimeoutError(), InterruptedError(),
    RuntimeError("... UNAVAILABLE: socket closed"),
    RuntimeError("DEADLINE_EXCEEDED"),
    RuntimeError("RESOURCE_EXHAUSTED: while allocating 1.2G"),
    RuntimeError("CUDA error: out of memory"), ValueError("bad k"),
    RuntimeError("plain bug")])
def test_classify_matches_reference_on_generic_errors(exc):
    assert retry.classify(exc) == ref_retry.classify(exc)


def test_classify_injected_and_timeout():
    assert retry.classify(InjectedTransientError("x")) == "transient"
    assert retry.classify(retry.OperationTimeout("deadline")) == "transient"


def test_backoff_equals_reference():
    for pol, rpol in ((retry.RetryPolicy(), ref_retry.RetryPolicy()),
                      (retry.RetryPolicy(seed=3, jitter=0.5),
                       ref_retry.RetryPolicy(seed=3, jitter=0.5))):
        for attempt in range(10):
            for site in ("single.fetch", "single.stage_put"):
                assert retry.backoff_ms(pol, site, attempt) == \
                    ref_retry.backoff_ms(rpol, site, attempt)


def test_call_with_retry_recovers_exhausts_and_propagates():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise InjectedTransientError("flaky")
        return "ok"

    slept = []
    assert retry.call_with_retry(flaky, "t", policy=retry.RetryPolicy(),
                                 sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2
    assert stats.snapshot()["retry_sites"] == {"t": 2}

    def always():
        raise InjectedTransientError("always")

    with pytest.raises(InjectedTransientError):
        retry.call_with_retry(always, "u", sleep=lambda s: None)
    assert stats.snapshot()["retries"] == 4

    for exc in (ValueError("fatal"), SimulatedResourceExhausted("oom"),
                torch.cuda.OutOfMemoryError("CUDA out of memory")):
        seen = []

        def op(exc=exc):
            seen.append(1)
            raise exc

        with pytest.raises(type(exc)):
            retry.call_with_retry(op, "v", sleep=lambda s: None)
        assert len(seen) == 1
    assert stats.snapshot()["retries"] == 4


def test_call_with_timeout():
    assert retry.call_with_timeout(lambda: 42, 5.0, site="ok") == 42
    with pytest.raises(ValueError, match="boom"):
        retry.call_with_timeout(
            lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0)
    t0 = time.monotonic()
    with pytest.raises(retry.OperationTimeout, match="exceeded"):
        retry.call_with_timeout(lambda: time.sleep(2), 0.05, site="hung")
    assert time.monotonic() - t0 < 1.5
    assert stats.snapshot()["timeouts"] == 1


def test_resilient_get_deadline_retries_a_slow_fetch(monkeypatch):
    """$DMLP_TPU_OP_TIMEOUT_S bounds each readback attempt: a fetch
    delayed past it times out, classifies transient, and the retry
    reads the values."""
    monkeypatch.setattr(inject, "_sleep", time.sleep)
    monkeypatch.setenv("DMLP_TPU_OP_TIMEOUT_S", "0.05")
    inject.install(FaultSchedule.from_dict(_doc([
        {"site": "single.fetch", "kind": "delay", "ms": 400}])))
    got, = single.resilient_get([torch.arange(4)])
    assert got.tolist() == [0, 1, 2, 3]
    snap = stats.snapshot()
    assert snap["timeouts"] == 1 and snap["retry_sites"] == \
        {"single.fetch": 1}
    # With the kill switch the read is a direct call: no deadline.
    monkeypatch.setenv("DMLP_TPU_RESILIENCE", "0")
    single.resilient_get([torch.arange(4)])
    assert stats.snapshot()["timeouts"] == 1


# -- the ladder ---------------------------------------------------------------

class _FakeEngine:
    _degrade_rung = "fused"
    last_degrade_rung = "fused"
    device = torch.device("cpu")


@pytest.mark.parametrize("error", ["injected", "torch"])
def test_ladder_steps_down_per_oom(error):
    eng, seen = _FakeEngine(), []

    def solve(inp):
        seen.append(eng._degrade_rung)
        if len(seen) < 6:
            raise (SimulatedResourceExhausted("RESOURCE_EXHAUSTED")
                   if error == "injected" else
                   torch.cuda.OutOfMemoryError("CUDA out of memory"))
        return "answer"

    assert degrade.run_ladder(eng, None, solve) == "answer"
    assert seen == list(degrade.RUNGS[:6]) == list(ref_degrade.RUNGS[:6])
    assert eng.last_degrade_rung == "streaming"
    assert eng._degrade_rung == "fused"
    assert stats.snapshot()["degradations"] == [
        "lowp->prune", "prune->fused", "fused->tuned", "tuned->heuristic",
        "heuristic->streaming"]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_host_rung_only_for_an_engine_on_the_cpu(device):
    """Six OOMs: an engine on the CPU ends on the host oracle, one on a
    card raises the streaming rung's OOM and never reports a host result."""
    eng, seen = _FakeEngine(), []
    eng.device = torch.device(device)
    inp = _small_input()

    def solve(inp):
        seen.append(eng._degrade_rung)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    steps = ["lowp->prune", "prune->fused", "fused->tuned",
             "tuned->heuristic", "heuristic->streaming"]
    if device == "cpu":
        got = degrade.run_ladder(eng, from_reference(inp), solve)
        assert port_format(got) == format_results(knn_golden(inp))
        assert eng.last_degrade_rung == "host"
        steps.append("streaming->host")
    else:
        with pytest.raises(torch.cuda.OutOfMemoryError):
            degrade.run_ladder(eng, from_reference(inp), solve)
        assert eng.last_degrade_rung == "streaming"
    assert seen == list(degrade.RUNGS[:6])
    assert eng._degrade_rung == "fused"
    assert stats.snapshot()["degradations"] == steps


def test_ladder_propagates_fatal_errors():
    eng = _FakeEngine()
    for exc in (ValueError("a real bug"), KernelLaunchError("launch failed"),
                KernelBuildError("nvcc failed")):
        def solve(inp, exc=exc):
            raise exc

        with pytest.raises(type(exc)):
            degrade.run_ladder(eng, None, solve)
    assert stats.snapshot()["degradations"] == []


def test_ladder_gives_the_failed_attempts_memory_back():
    """Nothing of a failed attempt survives into the next rung: its
    tensors are freed before the next attempt starts."""
    eng, refs = _FakeEngine(), []

    def solve(inp):
        if refs:
            gc.collect()
            assert refs[0]() is None, "the failed attempt's tensor lives"
            return "ok"
        big = torch.empty(1 << 20)
        refs.append(weakref.ref(big))
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    assert degrade.run_ladder(eng, None, solve) == "ok"
    assert eng.last_degrade_rung == "prune"


def test_resilience_kill_switch(monkeypatch):
    """DMLP_TPU_RESILIENCE=0: no fault fires, no step-down, the solve runs
    on the top rung, and an OOM propagates."""
    monkeypatch.setenv("DMLP_TPU_RESILIENCE", "0")
    inp = _small_input()
    out = _solve_both(inp, [{"site": "single.stage_put", "kind": "oom"}],
                      data_block=32, query_block=8)
    _assert_same(out, inp, "lowp")
    assert out["port"][3] == []
    with pytest.raises(torch.cuda.OutOfMemoryError):
        degrade.run_ladder(_FakeEngine(), None, lambda inp: (_ for _ in (
            )).throw(torch.cuda.OutOfMemoryError("CUDA out of memory")))
    assert stats.snapshot()["degradations"] == []


@pytest.mark.parametrize("fused_env", ["1", "0"])
def test_kernel_choice_per_rung_matches_reference(monkeypatch, fused_env):
    monkeypatch.setenv("DMLP_TPU_FUSED", fused_env)
    for rung in degrade.RUNGS:
        _, impl = fused.resolve_topk_kernel(128, 12800, 8, 32, rung=rung)
        _, ref_impl = ref_fused.resolve_topk_kernel(128, 12800, 8, 32,
                                                    rung=rung)
        assert impl == ref_impl


def test_precision_kill_switch_and_active_precision(monkeypatch):
    """DMLP_TPU_PRECISION=bf16 runs the bf16 first pass only on "lowp"
    and only in exact mode, as the reference's active_precision; an OOM
    step gives it back, and the answer stays the same bytes."""
    monkeypatch.setenv("DMLP_TPU_PRECISION", "bf16")
    for exact in (True, False):
        cfg = RefConfig(select="extract", use_pallas=True, exact=exact)
        ref = ref_single.SingleChipEngine(cfg)
        port = single.SingleChipEngine(config_from_reference(cfg, "cpu"))
        for rung in degrade.RUNGS[:-1]:
            ref._degrade_rung = port._degrade_rung = rung
            assert single.active_precision(port) == \
                ref_single.active_precision(ref)
        assert single.active_precision(port) == "f32"
    port._degrade_rung = "lowp"
    monkeypatch.setenv("DMLP_TPU_PRECISION", "f32")
    assert single.active_precision(port) == "f32"
    monkeypatch.setenv("DMLP_TPU_PRECISION", "bf16")
    inp = _extract_input()
    never = {"site": "train.step", "kind": "delay"}
    for faults, rung in (
            ([never], "lowp"),
            ([{"site": "single.extract_solve", "kind": "oom"}], "prune")):
        out = _solve_both(inp, faults, select="extract", use_pallas=True)
        _assert_same(out, inp, rung)


# -- the CLI ------------------------------------------------------------------

def test_cli_faults_cmp_equal_to_reference(tmp_path):
    """``python -m dmlp_tpu_torch --device cpu --faults FILE`` and
    ``python -m dmlp_tpu --faults FILE`` in fresh interpreters: stdout
    byte-identical (and to the fault-free golden), the same injection
    log."""
    text = generate_input_text(9000, 12, 4, -5, 5, 1, 8, 3, seed=19)
    src = tmp_path / "in.txt"
    src.write_text(text)
    sched = tmp_path / "sched.json"
    sched.write_text(json.dumps(_doc([
        {"site": "single.extract_solve", "kind": "oom", "times": 3},
        {"site": "single.fetch", "kind": "transient"},
        {"site": "io.parse", "kind": "corrupt"}], seed=3)))
    runs = []
    for module, extra in (("dmlp_tpu", []),
                          ("dmlp_tpu_torch", ["--device", "cpu"])):
        log = tmp_path / f"{module}.log.json"
        env = dict(os.environ, DMLP_TPU_FAULT_LOG=str(log))
        with open(src) as f:
            p = subprocess.run(
                [sys.executable, "-m", module, *extra, "--pallas",
                 "--faults", str(sched)], stdin=f, capture_output=True,
                env=env, cwd=ROOT, timeout=300)
        assert p.returncode == 0, p.stderr.decode()
        runs.append((p.stdout, log.read_text()))
    assert runs[0] == runs[1]
    golden = _cli_in_process(cli.main, ["--engine", "golden"], text)
    assert runs[1][0].decode() == golden
