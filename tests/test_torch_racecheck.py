"""dmlp_tpu_torch.check.racecheck — the port's runtime race sanitizer
(dynamic R7): the reference's ``tests/test_racecheck.py`` cases against
the port's module, then ``python -m dmlp_tpu_torch.check.race_stress
--device cpu`` end to end.

The load-bearing property is TEETH: a seeded lock-order inversion and a
seeded blocking-call-under-lock must be caught, and a disciplined
consistent-order run must come back clean — otherwise the race-smoke
harness's empty verdict over the real daemon proves nothing.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

from dmlp_tpu_torch.check import racecheck


@pytest.fixture
def sanitizer():
    """Installed sanitizer with guaranteed restore: a leaked patch of
    threading.Lock would contaminate every later test in the
    process."""
    racecheck.install()
    racecheck.reset()
    try:
        yield racecheck
    finally:
        racecheck.reset()
        racecheck.uninstall()


def test_install_uninstall_restore_factories():
    orig_lock = threading.Lock
    orig_sleep = time.sleep
    racecheck.install()
    try:
        assert threading.Lock is not orig_lock
        assert racecheck.enabled()
        assert racecheck.install()       # idempotent
    finally:
        racecheck.uninstall()
    assert threading.Lock is orig_lock
    assert time.sleep is orig_sleep
    assert not racecheck.enabled()
    racecheck.uninstall()                # idempotent


def test_seeded_inversion_is_caught(sanitizer):
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    r = sanitizer.report()
    assert r["inversions"] == 1
    v = [x for x in r["violations"] if x["kind"] == "inversion"][0]
    assert v["held"] != v["acquiring"]
    assert "reverse_site" in v
    assert not r["ok"]


def test_cross_thread_inversion_is_caught(sanitizer):
    a = threading.Lock()
    b = threading.Lock()

    def t1():
        with a:
            with b:
                pass

    th = threading.Thread(target=t1, daemon=True)
    th.start()
    th.join()
    with b:
        with a:        # opposite order, different thread
            pass
    assert sanitizer.report()["inversions"] == 1


def test_consistent_order_and_reentrant_use_clean(sanitizer):
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    r = sanitizer.report()
    assert r["ok"] and r["edges"] == 1


def test_sleep_under_lock_caught_and_clean_sleep_ignored(sanitizer):
    lk = threading.Lock()
    time.sleep(0.001)                 # no lock held: clean
    assert sanitizer.report()["ok"]
    with lk:
        time.sleep(0.001)
    r = sanitizer.report()
    assert r["blocking_under_lock"] == 1
    v = r["violations"][0]
    assert v["call"] == "time.sleep" and v["held"]


def test_thread_join_under_lock_caught(sanitizer):
    lk = threading.Lock()
    t = threading.Thread(target=lambda: None, daemon=True)
    t.start()
    with lk:
        t.join()
    r = sanitizer.report()
    assert r["blocking_under_lock"] == 1
    assert r["violations"][0]["call"] == "Thread.join"


def test_condition_wait_releases_held_tracking(sanitizer):
    """cond.wait releases the lock: a timeout-wait under the condition
    must not count as blocking-under-lock, and the handoff must
    restore the held stack for the code after wait()."""
    cond = threading.Condition()
    lk = threading.Lock()
    with cond:
        cond.wait(timeout=0.01)
        with lk:                      # still inside the cond guard
            pass
    r = sanitizer.report()
    assert r["ok"]
    assert r["edges"] == 1            # cond -> lk recorded after wait


def test_condition_producer_consumer_clean(sanitizer):
    cond = threading.Condition()
    items = []
    got = []

    def consumer():
        with cond:
            while not items:
                cond.wait(timeout=1.0)
            got.append(items.pop())

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    time.sleep(0.02)
    with cond:
        items.append(7)
        cond.notify()
    t.join(timeout=5)
    assert not t.is_alive() and got == [7]
    assert sanitizer.report()["ok"]


def test_reset_clears_graph_and_violations(sanitizer):
    a = threading.Lock()
    with a:
        time.sleep(0.001)
    assert not sanitizer.report()["ok"]
    sanitizer.reset()
    r = sanitizer.report()
    assert r["ok"] and r["edges"] == 0 and r["violations"] == []


def test_write_report_if_requested(sanitizer, tmp_path, monkeypatch):
    out = tmp_path / "RACECHECK.json"
    monkeypatch.setenv(racecheck.RACECHECK_OUT_ENV, str(out))
    a = threading.Lock()
    with a:
        pass
    path = sanitizer.write_report_if_requested()
    assert path == str(out)
    doc = json.loads(out.read_text())
    assert doc["racecheck_schema"] == 1 and doc["ok"] is True


def test_install_from_env(monkeypatch):
    monkeypatch.delenv(racecheck.RACECHECK_ENV, raising=False)
    assert racecheck.install_from_env() is False
    monkeypatch.setenv(racecheck.RACECHECK_ENV, "1")
    try:
        assert racecheck.install_from_env() is True
        assert racecheck.enabled()
    finally:
        racecheck.reset()
        racecheck.uninstall()


def test_race_stress_on_the_cpu(tmp_path):
    """The stress harness as users run it, in a fresh interpreter: teeth,
    the concurrent workers against a live daemon with the sampler, scrape
    and a fault schedule, every response the oracle's, squeeze and drain,
    and an empty sanitizer verdict; no reference module loaded."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    probe = (
        "import runpy, sys\n"
        f"sys.argv = ['race_stress', '--device', 'cpu', '--pallas',"
        f" '--json', '--out', {str(tmp_path)!r}]\n"
        "try:\n"
        "    runpy.run_module('dmlp_tpu_torch.check.race_stress',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'dmlp_tpu'))\n"
        "sys.stderr.write('FORBIDDEN=%r\\n' % bad)\n")
    p = subprocess.run([sys.executable, "-c", probe], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    verdict = json.loads(p.stdout)
    assert verdict["ok"] and verdict["device"] == "cpu"
    assert verdict["select"] == "extract"
    rc = verdict["racecheck"]
    assert rc["inversions"] == 0 and rc["blocking_under_lock"] == 0
    assert rc["locks_created"] > 50 and rc["edges"] > 0
    assert verdict["stats_ops"] > 0 and verdict["scrapes"] > 0
    assert "sanitizer teeth OK" in p.stderr and "PASS" in p.stderr
    assert p.stderr.splitlines()[-1] == "FORBIDDEN=[]"
    saved = json.loads((tmp_path / "RACE_STRESS.json").read_text())
    assert saved["racecheck"]["ok"] is True


def test_daemon_and_router_under_the_racecheck_env(tmp_path, monkeypatch):
    """``DMLP_TPU_RACECHECK=1`` on ``python -m dmlp_tpu_torch.serve`` and
    ``.fleet``: each installs at import and writes its verdict to
    ``DMLP_TPU_RACECHECK_OUT`` at drain, clean; the daemon's
    ``--snapshot-every-s`` appends its RunRecord while serving as well as
    at drain."""
    import time
    from dmlp_tpu_torch.fleet import harness as fh
    from dmlp_tpu_torch.serve import client as sc
    header = {"serve_trace_schema": 1, "corpus": dict(
        num_data=500, num_queries=4, num_attrs=5, min_attr=0.0,
        max_attr=60.0, min_k=1, max_k=8, num_labels=4, seed=93)}
    corpus = tmp_path / "corpus.in"
    corpus.write_text(sc.corpus_text(header))
    rep_out, router_out = tmp_path / "rc_replica.json", \
        tmp_path / "rc_router.json"
    record = tmp_path / "serve_records.jsonl"
    monkeypatch.setenv("DMLP_TPU_RACECHECK", "1")
    monkeypatch.setenv("DMLP_TPU_RACECHECK_OUT", str(router_out))
    rep = fh.spawn_replica(str(corpus), str(tmp_path), "r0", "8x4",
                           flags=["--device", "cpu",
                                  "--snapshot-every-s", "0.2"],
                           env_extra={"DMLP_TPU_RACECHECK_OUT":
                                      str(rep_out)},
                           record=str(record))
    router = None
    try:
        fh.await_all([rep], timeout_s=120)
        router = fh.spawn_router(str(tmp_path), [rep])
        cli = sc.ServeClient(router.ready["port"])
        try:
            q = sc.materialize_queries({"nq": 3, "seed": 5}, header)
            assert cli.query(q, k=3, req_id="a")["ok"]
        finally:
            cli.close()
        deadline = time.monotonic() + 30
        while not record.exists() and time.monotonic() < deadline:
            time.sleep(0.1)
        periodic = len(record.read_text().splitlines())
        assert periodic >= 1           # appended before any drain
        fh.drain_fleet(router, [rep])
        router = None
    finally:
        if router is not None:
            fh.kill_all([router, rep])
    assert len(record.read_text().splitlines()) >= periodic + 1
    for path in (rep_out, router_out):
        rep_doc = json.loads(path.read_text())
        assert rep_doc["installed"] and rep_doc["ok"], rep_doc
        assert rep_doc["locks_created"] > 0
