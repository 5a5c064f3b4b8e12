"""The port's train loop (``dmlp_tpu_torch.train.loop``) and benchmark on
the CPU: checkpoint and resume, the NaN guard's four cases of the
reference (``tests/test_train.py``), the offload levels through the loop,
the flags left to later items, the metrics events, and the entry points
in fresh interpreters (no ``jax``, ``jaxlib`` or ``dmlp_tpu*`` module
loaded; no run without a card unless ``--device cpu``).

Everything here is the port against itself: the same seed gives the same
parameters bit for bit, so a rolled-back run and a resumed run must end
on the fault-free run's checksum exactly.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dmlp_tpu_torch.train import loop
from dmlp_tpu_torch.train.loop import _params_checksum, train
from dmlp_tpu_torch.utils.metrics_log import MetricsLogger

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "dmlp_tpu")


def _params(state):
    return [p.detach().clone() for p in state["params"].parameters()]


def test_loss_decreases_on_teacher_task():
    _, last = train(steps=60, batch=256, dims=(8, 32, 4), mesh_shape=(1, 1),
                    lr=0.1, log_every=60, device="cpu")
    assert last["loss"] < 1.0 and last["accuracy"] > 0.5
    assert last["step"] == 60


def test_checkpoint_resume_roundtrip(tmp_path):
    ckdir = str(tmp_path / "ck")
    s1, _ = train(steps=5, batch=64, dims=(6, 16, 3), checkpoint_dir=ckdir,
                  ckpt_every=5, log_every=5, device="cpu")
    s2, _ = train(steps=0, batch=64, dims=(6, 16, 3), checkpoint_dir=ckdir,
                  resume=True, log_every=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_params(s1), _params(s2)))
    assert s2["step"] == 5


def test_resume_continues_counting(tmp_path):
    """4 steps, then 3 resumed: step 7. The resumed run's batch stream
    starts again at the seed, as the reference's does, so its parameters
    are not a 7-step run's."""
    kw = dict(batch=32, dims=(4, 8, 2), log_every=100, device="cpu")
    ckdir = str(tmp_path / "ck")
    train(steps=4, checkpoint_dir=ckdir, ckpt_every=4, **kw)
    resumed, last = train(steps=3, checkpoint_dir=ckdir, resume=True, **kw)
    assert resumed["step"] == 7 and last["step"] == 7
    whole, _ = train(steps=7, **kw)
    assert _params_checksum(resumed) != _params_checksum(whole)


@pytest.mark.parametrize("level", ["params", "all"])
def test_offload_through_the_loop_equals_resident(level):
    kw = dict(steps=6, batch=32, dims=(8, 16, 3), lr=0.05, log_every=3,
              device="cpu")
    resident, a = train(**kw)
    offloaded, b = train(offload=level, **kw)
    assert _params_checksum(resident) == _params_checksum(offloaded)
    assert a["loss"] == b["loss"]


def test_families_of_a14b_and_a15_flags_raise(monkeypatch, tmp_path):
    """The pipeline and MoE families (A14b) run, under the reference's
    flag rules: each raises where its dims or default mesh do not fit;
    ``--sanitize`` (A15b) runs every step under the sanitizer, through
    the API and the CLI, and ``--compile-cache`` (A15a) runs, its
    directory made and exported."""
    for fam, dims, match in (("dp_pp", (4, 8, 8, 2), "wants --dims"),
                             ("dp_pp3", (4, 8, 2), "mesh axes must be"),
                             ("dp_ep", (4, 8, 2), "wants --dims")):
        with pytest.raises(ValueError, match=match):
            train(steps=1, batch=8, dims=dims, parallelism=fam,
                  device="cpu")
    with pytest.raises(ValueError, match="moe-dispatch"):
        train(steps=1, batch=8, dims=(4, 8, 2), moe_dispatch="a2a",
              device="cpu")
    with pytest.raises(ValueError, match="capacity-factor"):
        train(steps=1, batch=8, dims=(4, 8, 2), capacity_factor=2.0,
              device="cpu")
    with pytest.raises(ValueError, match="pp-schedule"):
        train(steps=1, batch=8, dims=(4, 8, 2), pp_schedule="interleaved",
              device="cpu")
    _, last = train(steps=1, batch=8, dims=(4, 8, 2), sanitize=True,
                    log_every=1, device="cpu")
    assert last["step"] == 1 and np.isfinite(last["loss"])
    assert loop.main(["--device", "cpu", "--steps", "1", "--batch", "8",
                      "--dims", "4,8,2", "--sanitize"]) == 0
    with pytest.raises(ValueError, match="dp_ep wants --dims"):
        loop.main(["--device", "cpu", "--steps", "1", "--parallelism",
                   "dp_ep", "--dims", "4,8,2"])
    from dmlp_tpu_torch.utils import compile_cache
    monkeypatch.setenv(compile_cache.ENV_VAR, "")
    cache = tmp_path / "cache"
    assert loop.main(["--device", "cpu", "--steps", "1", "--batch", "8",
                      "--dims", "4,8,2", "--compile-cache",
                      str(cache)]) == 0
    assert cache.is_dir()
    assert compile_cache.resolve_cache_dir() == str(cache)


def test_metrics_events(tmp_path):
    path = tmp_path / "m.jsonl"
    with MetricsLogger(path=str(path)) as m:
        train(steps=4, batch=32, dims=(8, 16, 3), log_every=2, metrics=m,
              device="cpu")
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    # One rank: no comms event (no collectives), and the first step's
    # record says so.
    assert not any(r.get("event") == "comms" for r in recs)
    hlo = [r for r in recs if r.get("event") == "hlo"]
    assert len(hlo) == 1 and hlo[0]["no_collectives"]
    windows = [r for r in recs if "step" in r]
    assert [r["step"] for r in windows] == [2, 4]
    for r in windows:
        for k in ("loss", "accuracy", "samples_per_sec_per_chip", "mfu",
                  "model_flops_per_step", "step_time_ms"):
            assert np.isfinite(r[k]), k


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from dmlp_tpu_torch.train import bench
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        loop.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train(steps=1, batch=8, dims=(4, 8, 2))
    from dmlp_tpu_torch.train.model import init_mlp
    from dmlp_tpu_torch.train.step import make_optimizer
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        init_mlp(torch.Generator().manual_seed(0), (4, 8, 2))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        loop.build_sharded_state(None, (4, 8, 2), make_optimizer())


# -- NaN guard -> checkpoint rollback (the reference's four cases) ----------

def _nan_sched(step, times=1):
    from dmlp_tpu_torch.resilience.inject import FaultSchedule
    return FaultSchedule.from_dict(
        {"schema": 1, "seed": 0, "faults": [
            {"site": "train.step", "kind": "nan", "times": times,
             "when": {"step": step}}]})


@pytest.fixture()
def _resilience_clean():
    from dmlp_tpu_torch.resilience import inject, stats
    stats.reset()
    inject.uninstall()
    yield
    inject.uninstall()
    stats.reset()


def test_nan_guard_rollback_is_step_identical(tmp_path, _resilience_clean):
    from dmlp_tpu_torch.resilience import inject, stats
    kw = dict(steps=6, batch=64, dims=(6, 16, 3), mesh_shape=(1, 1),
              ckpt_every=2, log_every=3, nan_guard=True, device="cpu")
    plain, plain_last = train(checkpoint_dir=str(tmp_path / "ck_a"), **kw)
    inject.install(_nan_sched(step=4))
    faulted, faulted_last = train(checkpoint_dir=str(tmp_path / "ck_b"),
                                  **kw)
    assert stats.snapshot()["rollbacks"] == 1
    assert all(torch.equal(a, b)
               for a, b in zip(_params(plain), _params(faulted)))
    assert plain_last["loss"] == faulted_last["loss"]
    assert plain_last["step"] == faulted_last["step"] == 6


def test_nan_guard_without_checkpoint_dir_raises(_resilience_clean):
    from dmlp_tpu_torch.resilience import inject
    inject.install(_nan_sched(step=1))
    with pytest.raises(RuntimeError, match="no.*checkpoint|checkpoint.*"):
        train(steps=3, batch=32, dims=(4, 8, 2), log_every=3,
              nan_guard=True, device="cpu")


def test_nan_guard_persistent_divergence_decays_lr(tmp_path,
                                                   _resilience_clean):
    from dmlp_tpu_torch.resilience import inject, stats
    inject.install(_nan_sched(step=2, times=2))
    state, _ = train(steps=4, batch=32, dims=(4, 8, 2),
                     checkpoint_dir=str(tmp_path / "ck"), ckpt_every=1,
                     log_every=4, nan_guard=True, device="cpu")
    assert stats.snapshot()["rollbacks"] == 2
    assert state["step"] == 4
    inject.uninstall()
    stats.reset()
    inject.install(_nan_sched(step=2, times=5))
    with pytest.raises(RuntimeError, match="persisted through"):
        train(steps=4, batch=32, dims=(4, 8, 2),
              checkpoint_dir=str(tmp_path / "ck2"), ckpt_every=1,
              log_every=4, nan_guard=True, max_rollbacks=2, device="cpu")


def test_nan_guard_recovers_before_first_periodic_checkpoint(
        tmp_path, _resilience_clean):
    from dmlp_tpu_torch.resilience import inject, stats
    inject.install(_nan_sched(step=1))
    state, _ = train(steps=4, batch=32, dims=(4, 8, 2),
                     checkpoint_dir=str(tmp_path / "ck"), ckpt_every=100,
                     log_every=4, nan_guard=True, device="cpu")
    assert stats.snapshot()["rollbacks"] == 1
    assert state["step"] == 4


def test_nan_guard_refuses_stale_future_checkpoint(tmp_path,
                                                   _resilience_clean):
    from dmlp_tpu_torch.resilience import inject
    ckdir = str(tmp_path / "ck")
    train(steps=6, batch=32, dims=(4, 8, 2), checkpoint_dir=ckdir,
          ckpt_every=6, log_every=6, device="cpu")   # leaves step 6
    inject.install(_nan_sched(step=2))
    with pytest.raises(RuntimeError, match="AHEAD"):
        train(steps=6, batch=32, dims=(4, 8, 2), checkpoint_dir=ckdir,
              ckpt_every=100, log_every=6, nan_guard=True, device="cpu")


# -- the entry points in fresh interpreters ----------------------------------

def _fresh(module, argv, env=None):
    """``python -m module argv`` in a fresh interpreter; returns
    (stdout, stderr lines, the modules of FORBIDDEN it loaded)."""
    probe = (
        "import runpy, sys\n"
        f"sys.argv = {[module] + list(argv)!r}\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" {FORBIDDEN!r})\n"
        "sys.stderr.write('FORBIDDEN=%r\\n' % bad)\n")
    import os
    p = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env=dict(os.environ, **(env or {})))
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout, p.stderr.splitlines()


def test_loop_cli_nan_fault_resumes_to_the_fault_free_checksum(tmp_path):
    """The CLI with a ``nan`` fault at step 5 under ``--nan-guard``: its
    record's ``params_checksum`` equals the fault-free run's, one
    rollback is counted, the trace holds the reference's spans and the
    rollback instant, and no reference module was loaded."""
    sched = tmp_path / "sched.json"
    sched.write_text(json.dumps({"schema": 1, "seed": 0, "faults": [
        {"site": "train.step", "kind": "nan", "when": {"step": 5}}]}))
    common = ["--device", "cpu", "--steps", "8", "--batch", "64", "--dims",
              "8,32,4", "--ckpt-every", "3", "--log-every", "4",
              "--nan-guard"]
    recs = {}
    for name, extra in (("plain", []),
                        ("faulted", ["--faults", str(sched), "--trace",
                                     str(tmp_path / "t.json"),
                                     "--metrics-file",
                                     str(tmp_path / "m.jsonl"),
                                     "--telemetry",
                                     str(tmp_path / "t.om")])):
        out, err = _fresh("dmlp_tpu_torch.train.loop", common + [
            "--checkpoint-dir", str(tmp_path / f"ck_{name}"), "--record",
            str(tmp_path / f"{name}.json"), *extra])
        assert err[-1] == "FORBIDDEN=[]"
        assert out.splitlines()[-1].startswith("final: {'step': 8,")
        recs[name] = json.loads((tmp_path / f"{name}.json").read_text())
    p, f = recs["plain"]["metrics"], recs["faulted"]["metrics"]
    assert f["params_checksum"] == p["params_checksum"]
    assert f["resilience"]["rollbacks"] == 1
    assert f["loss"] == p["loss"]
    assert f["mem"]["mem_stats_unavailable"]
    assert recs["faulted"]["kind"] == "train" and \
        recs["faulted"]["device"] == "cpu"
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"train.step", "train.log_window", "train.checkpoint",
            "resilience.rollback"} <= names
    from dmlp_tpu_torch.obs.telemetry import validate_openmetrics
    om = (tmp_path / "t.om").read_text()
    assert validate_openmetrics(om) == [] and "resilience_rollbacks" in om


def test_loop_cli_mesh_starts_its_ranks(tmp_path):
    """``--mesh 2,1`` starts the second rank itself; the global loss
    equals the one-rank run's (the dp slices' means, averaged)."""
    common = ["--device", "cpu", "--steps", "3", "--batch", "32", "--dims",
              "8,16,3", "--log-every", "3"]
    finals = {}
    for name, extra in (("one", []), ("mesh", ["--mesh", "2,1",
                                               "--metrics-file",
                                               str(tmp_path / "m.jsonl")])):
        out, err = _fresh("dmlp_tpu_torch.train.loop", common + extra)
        assert err[-1] == "FORBIDDEN=[]"
        line = out.splitlines()[-1]
        finals[name] = eval(line[len("final: "):])   # the reference's repr
    np.testing.assert_allclose(finals["mesh"]["loss"], finals["one"]["loss"],
                               rtol=2e-5)
    recs = [json.loads(ln)
            for ln in (tmp_path / "m.jsonl").read_text().splitlines()]
    comms = [r for r in recs if r.get("event") == "comms"]
    hlo = [r for r in recs if r.get("event") == "hlo"]
    assert comms[0]["bytes_by_axis"] == {"dp": hlo[0]["by_axis"][
        "all-reduce@dp"] * 3}   # the model's 3 steps, the record's one


def test_bench_cli_on_the_cpu():
    out, err = _fresh("dmlp_tpu_torch.train.bench", ["--device", "cpu"],
                      env={"TRAIN_DIMS": "8,16,4", "TRAIN_BATCH": "32",
                           "TRAIN_STEPS": "3", "TRAIN_DTYPE": "float32"})
    assert err[-1] == "FORBIDDEN=[]"
    res = json.loads(out.splitlines()[-1])
    assert res["metric"] == "train_samples_per_sec_per_chip"
    assert res["value"] > 0 and np.isfinite(res["mfu"])
    assert res["shape"]["device_kind"] == "cpu"
    assert res["shape"]["dims"] == [8, 16, 4]


def test_source_scan_covers_the_train_modules():
    """The port's source scan (tests/test_torch_cli.py) walks every file
    of the package: the train modules are among them."""
    files = {f.name for f in (ROOT / "dmlp_tpu_torch" / "train").glob("*.py")}
    assert {"model.py", "step.py", "sharding.py", "data.py",
            "checkpoint.py", "metrics.py", "loop.py", "bench.py",
            "__init__.py"} <= files
