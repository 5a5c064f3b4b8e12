"""The port's self-healing fleet against the reference's and the oracle.

The counterpart of ``tests/test_fleet_selfheal.py`` on the CPU (the
daemons' engines run the kernels' plain versions): the corpus signature
and idempotent row-keyed ingest (the fold equal to the reference's on the
same rows), the ``corpus`` wire op, the checksum-driven repair and its
quarantine, the router's revive hysteresis and sticky drain freeze, the
dynamic replica table under a racing query wave, the supervisor (bounded
relaunch, budget exhaustion, scale-down by drain, a forced capacity
re-split of a real subprocess replica with no response lost or wrong),
scrape staleness, and a mesh replica whose worker rank dies. Responses
are held against the float64 oracle byte for byte (tolerance none).
Every spawned process is waited on with a deadline.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from dmlp_tpu.fleet import consistency as ref_ccs  # noqa: E402
from dmlp_tpu_torch.config import EngineConfig  # noqa: E402
from dmlp_tpu_torch.fleet import consistency as ccs  # noqa: E402
from dmlp_tpu_torch.fleet import scrape as fscrape  # noqa: E402
from dmlp_tpu_torch.fleet.autoscale import (FleetSupervisor,  # noqa: E402
                                            ReplicaSpec, target_replicas)
from dmlp_tpu_torch.fleet.mesh_engine import GROUP_TIMEOUT_S  # noqa: E402
from dmlp_tpu_torch.fleet.reshard import (grown_capacity,  # noqa: E402
                                          needs_resplit)
from dmlp_tpu_torch.fleet.router import FleetRouter, Replica  # noqa: E402
from dmlp_tpu_torch.golden.fast import knn_golden_fast  # noqa: E402
from dmlp_tpu_torch.io.grammar import KNNInput, Params  # noqa: E402
from dmlp_tpu_torch.io.grammar import format_input  # noqa: E402
from dmlp_tpu_torch.io.grammar import parse_input_text  # noqa: E402
from dmlp_tpu_torch.obs.telemetry import validate_openmetrics  # noqa: E402
from dmlp_tpu_torch.serve import client as sc  # noqa: E402
from dmlp_tpu_torch.serve.daemon import ServeDaemon  # noqa: E402
from dmlp_tpu_torch.serve.engine import ResidentEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu")


def make_corpus(n=600, na=5, labels=4, seed=3, spread=50.0) -> KNNInput:
    rng = np.random.default_rng(seed)
    return KNNInput(
        Params(n, 0, na), rng.integers(0, labels, n).astype(np.int32),
        rng.uniform(0, spread, (n, na)), np.zeros(0, np.int32),
        np.zeros((0, na)))


def golden_for(labels, attrs, q, ks):
    inp = KNNInput(Params(len(labels), len(ks), attrs.shape[1]),
                   np.asarray(labels, np.int32), attrs,
                   np.asarray(ks, np.int32), np.asarray(q, np.float64))
    return [int(r.checksum()) for r in knn_golden_fast(inp)]


def _start_daemon(corpus, **kw):
    kw.setdefault("tick_s", 0.001)
    d = ServeDaemon(corpus, CPU, port=0, **kw)
    d.start()
    return d


def _sig(d):
    s = d.engine.corpus_state()
    return (s["rows"], s["checksum"])


def _query(port, q, ks, req_id=""):
    cli = sc.ServeClient(port)
    try:
        return cli.query(q, ks=[int(v) for v in ks], req_id=req_id)
    finally:
        cli.close()


def _wait_for(fn, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    return fn()


# -- corpus signature ----------------------------------------------------------

def test_row_hash_fold_incremental_and_equal_to_the_reference():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 9, 50).astype(np.int32)
    attrs = rng.uniform(-3, 3, (50, 4))
    full = ccs.corpus_fold(labels, attrs)
    assert full == ref_ccs.corpus_fold(labels, attrs)
    assert np.array_equal(ccs.row_hashes(labels, attrs),
                          ref_ccs.row_hashes(labels, attrs))
    h1 = ccs.row_hashes(labels[:30], attrs[:30])
    h2 = ccs.row_hashes(labels[30:], attrs[30:])
    assert (ccs.fold_terms(0, h1) + ccs.fold_terms(30, h2)) \
        & ((1 << 64) - 1) == full
    assert ccs.fold_replace(full, 10, h1[10:20], h1[10:20]) == full
    other = ccs.row_hashes(labels[:10], attrs[:10] + 1.0)
    changed = ccs.fold_replace(full, 10, h1[10:20], other)
    assert changed != full
    assert changed == ref_ccs.fold_replace(full, 10, h1[10:20], other)
    assert ccs.fold_replace(changed, 10, other, h1[10:20]) == full
    assert ccs.fold_terms(0, h1) != ccs.fold_terms(1, h1)


def test_diagnose_picks_max_rows_then_majority():
    a = {"rows": 10, "checksum": 111}
    b = {"rows": 12, "checksum": 222}
    assert ccs.diagnose([("r0", a), ("r1", dict(a))]) is None
    v = ccs.diagnose([("r0", a), ("r1", b)])
    assert v["reference"] == "r1" and v["divergent"] == ["r0"]
    c = {"rows": 12, "checksum": 333}
    v = ccs.diagnose([("r0", b), ("r1", dict(b)), ("r2", c)])
    assert v["reference"] in ("r0", "r1") and v["divergent"] == ["r2"]


def test_ingest_start_is_idempotent_and_rejects_gaps():
    corpus = make_corpus()
    eng = ResidentEngine(corpus, CPU)
    rng = np.random.default_rng(11)
    newl = rng.integers(0, 4, 5).astype(np.int32)
    newa = rng.uniform(0, 50, (5, 5))
    eng.ingest(newl, newa)
    sig0 = eng.corpus_state()
    assert eng.ingest(newl, newa, start=600) == 605
    sig1 = eng.corpus_state()
    assert (sig1["rows"], sig1["checksum"]) == (sig0["rows"],
                                                sig0["checksum"])
    assert sig1["epoch"] == sig0["epoch"] + 1
    with pytest.raises(ValueError, match="gap"):
        eng.ingest(newl, newa, start=700)
    repl = rng.uniform(0, 50, (5, 5))
    eng.ingest(newl, repl, start=600)
    q = rng.uniform(0, 50, (2, 5))
    ks = np.asarray([4, 6], np.int32)
    got = [int(r.checksum()) for r in eng.solve_batch(q, ks)]
    assert got == golden_for(np.concatenate([corpus.labels, newl]),
                             np.vstack([corpus.data_attrs, repl]), q, ks)


# -- the corpus wire op and the repair -----------------------------------------

def test_corpus_wire_op_and_repair_replica_over_the_wire():
    """``corpus`` reads rows clamped to the corpus with the signature;
    re-ingesting them at their own ids changes nothing; and
    ``repair_replica`` copies a lagging replica's missing rows until the
    signatures match."""
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    d2 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    try:
        cli = sc.ServeClient(d1.port)
        doc = cli.call({"op": "corpus", "start": 590, "count": 20})
        assert doc["ok"] and doc["corpus_rows"] == 600
        assert len(doc["rows"]) == 10
        assert doc["checksum"] == d1.engine.corpus_state()["checksum"]
        np.testing.assert_array_equal(np.asarray(doc["rows"]),
                                      corpus.data_attrs[590:600])
        probe = cli.call({"op": "corpus", "count": 0})
        assert probe["ok"] and probe["rows"] == []
        r2 = cli.call({"op": "ingest", "labels": doc["labels"],
                       "rows": doc["rows"], "start": 590})
        assert r2["ok"] and r2["corpus_rows"] == 600
        assert d1.engine.corpus_state()["checksum"] == doc["checksum"]
        assert not cli.call({"op": "corpus", "start": -1})["ok"]
        rng = np.random.default_rng(2)
        cli.ingest([int(v) for v in rng.integers(0, 4, 9)],
                   rng.uniform(0, 50, (9, 5)))
        cli.close()
        ref, tgt = Replica("127.0.0.1", d1.port), Replica("127.0.0.1",
                                                           d2.port)
        assert ccs.corpus_state_via_wire(tgt)["rows"] == 600
        res = ccs.repair_replica(ref, tgt, fetch_rows=4)
        assert res == {"repaired": True, "replayed_rows": 9, "rounds": 1}
        assert _sig(d1) == _sig(d2)
        # Equal rows, different content: unrepairable, never "repaired".
        cli = sc.ServeClient(d2.port)
        cli.call({"op": "ingest", "labels": [0], "rows": [[1.0] * 5],
                  "start": 608})
        cli.close()
        bad = ccs.repair_replica(ref, tgt)
        assert not bad["repaired"] and "content" in bad["reason"]
    finally:
        d1.close()
        d2.close()


def test_prober_detects_and_repairs_dropped_ingest():
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    d2 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    router = FleetRouter([("127.0.0.1", d1.port), ("127.0.0.1", d2.port)],
                         port=0, health_interval_s=0.05,
                         divergence_probes=2)
    router.start()
    try:
        rng = np.random.default_rng(13)
        newl = rng.integers(0, 4, 7).astype(np.int32)
        newa = rng.uniform(0, 50, (7, 5))
        cli = sc.ServeClient(d1.port)
        cli.ingest([int(v) for v in newl], newa)
        cli.close()
        st = _wait_for(lambda: (lambda s: s if s["consistency"][
            "repairs"] >= 1 else None)(router.stats()))
        assert st["consistency"]["divergences"] >= 1
        assert st["consistency"]["repaired_rows"] >= 7
        assert _sig(d1) == _sig(d2)
        q = rng.uniform(0, 50, (2, 5))
        want = golden_for(np.concatenate([corpus.labels, newl]),
                          np.vstack([corpus.data_attrs, newa]), q, [4, 6])
        for i in range(4):
            r = _query(router.port, q, [4, 6], str(i))
            assert r["ok"] and r["checksums"] == want
    finally:
        router.close()
        d1.close()
        d2.close()


def test_unrepairable_content_divergence_quarantines():
    corpus = make_corpus()
    ds = [_start_daemon(corpus, warm_buckets=[(2, 8)]) for _ in range(3)]
    router = FleetRouter([("127.0.0.1", d.port) for d in ds], port=0,
                         health_interval_s=0.05, divergence_probes=2)
    router.start()
    try:
        rng = np.random.default_rng(17)
        cli = sc.ServeClient(ds[2].port)
        r = cli.call({"op": "ingest",
                      "labels": [int(v) for v in rng.integers(0, 4, 5)],
                      "rows": rng.uniform(0, 50, (5, 5)).tolist(),
                      "start": 595})
        cli.close()
        assert r["ok"]
        st = _wait_for(lambda: (lambda s: s if s["consistency"][
            "unrepairable"] >= 1 else None)(router.stats()))
        quar = [x["replica"] for x in st["replicas"] if x["quarantined"]]
        assert quar == [f"127.0.0.1:{ds[2].port}"]
        time.sleep(0.3)
        assert not router.find_replica(quar[0]).available()
        q = rng.uniform(0, 50, (2, 5))
        r = _query(router.port, q, [4, 6])
        assert r["ok"] and r["checksums"] == golden_for(
            corpus.labels, corpus.data_attrs, q, [4, 6])
    finally:
        router.close()
        for d in ds:
            d.close()


# -- revive hysteresis and the drain freeze ------------------------------------

def test_revive_hysteresis_requires_consecutive_healthy_probes():
    rep = Replica("127.0.0.1", 1, revive_probes=3)
    assert rep.available()
    rep.probe_fail("boom")
    rep.probe_ok()
    rep.probe_ok()
    assert not rep.available()
    rep.probe_ok()
    assert rep.available()
    rep.probe_fail("again")
    rep.probe_ok()
    rep.probe_fail("flap")
    rep.probe_ok()
    rep.probe_ok()
    assert not rep.available()
    rep.probe_ok()
    assert rep.available()


def test_router_drain_freeze_is_sticky_against_probes():
    rep = Replica("127.0.0.1", 1)
    rep.mark(draining=True)
    rep.probe_ok(draining=False)
    assert not rep.available()
    rep.mark(draining=False)
    rep.probe_ok(draining=False)
    assert rep.available()
    rep.probe_ok(draining=True)
    assert not rep.available()
    rep.probe_ok(draining=False)
    assert rep.available()


def test_router_flap_scenario_with_real_probes():
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    router = FleetRouter([("127.0.0.1", d1.port), ("127.0.0.1", 1)],
                         port=0, health_interval_s=600, revive_probes=2,
                         repair=False)
    router.start()
    try:
        dead = router.replicas[1]
        router._probe(dead)
        assert not dead.available()
        dead.port = d1.port
        router._probe(dead)
        assert not dead.available()
        router._probe(dead)
        assert dead.available()
    finally:
        router.close()
        d1.close()


def test_swap_race_query_wave_none_lost():
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    d2 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    router = FleetRouter([("127.0.0.1", d1.port)], port=0,
                         health_interval_s=0.05)
    router.start()
    try:
        rng = np.random.default_rng(23)
        q = rng.uniform(0, 50, (2, 5))
        want = golden_for(corpus.labels, corpus.data_attrs, q, [4, 6])
        out = [None] * 12

        def worker(i):
            out[i] = _query(router.port, q, [4, 6], str(i))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads[:5]:
            t.start()
        router.add_replica("127.0.0.1", d2.port)
        router.find_replica(f"127.0.0.1:{d1.port}").mark(draining=True)
        for t in threads[5:9]:
            t.start()
        router.remove_replica(f"127.0.0.1:{d1.port}")
        for t in threads[9:]:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None for r in out)
        ok = [r for r in out if r.get("ok")]
        assert all(r["checksums"] == want for r in ok)
        assert all("rejected" in str(r.get("error", ""))
                   for r in out if not r.get("ok"))
        assert len(ok) >= 10
        assert [r["replica"] for r in router.stats()["replicas"]] == \
            [f"127.0.0.1:{d2.port}"]
    finally:
        router.close()
        d1.close()
        d2.close()


# -- the supervisor ------------------------------------------------------------

def test_target_replicas_policy():
    assert target_replicas([], 2, 1, 4, 4.0, 0.25) == 2
    assert target_replicas([5, 6, 7], 2, 1, 4, 4.0, 0.25) == 3
    assert target_replicas([5, 6, 7], 4, 1, 4, 4.0, 0.25) == 4
    assert target_replicas([0, 0, 0.1], 3, 1, 4, 4.0, 0.25) == 2
    assert target_replicas([0, 0, 0], 1, 1, 4, 4.0, 0.25) == 1
    assert target_replicas([1, 1, 2], 2, 1, 4, 4.0, 0.25) == 2


class _FakePopen:
    def __init__(self, pid=0):
        self.pid = pid
        self.rc = None

    def poll(self):
        return self.rc

    def wait(self, timeout=None):
        if self.rc is None:
            self.rc = 0
        return self.rc

    def kill(self):
        if self.rc is None:
            self.rc = -9


class _FakeProc:
    def __init__(self, name, port, pid):
        self.name = name
        self.proc = _FakePopen(pid)
        self.ready = {"port": port}
        self.scrape_port = None
        self.errlog = ""


def _supervised_fixture(daemons, budget):
    """Router and supervisor whose spawn hands out in-process daemons."""
    router = FleetRouter([], allow_empty=True, health_interval_s=600,
                         repair=False)
    sup = FleetSupervisor(router, spec=None, min_replicas=1,
                          max_replicas=4, relaunch_budget=budget,
                          unhealthy_deadline_s=0)
    pool = list(daemons)

    def fake_spawn(name, capacity=None):
        if not pool:
            raise RuntimeError("fixture pool exhausted")
        return _FakeProc(name, pool.pop(0).port, pid=9000 + len(pool))

    sup.spawn_proc = fake_spawn
    return router, sup


def test_supervisor_relaunch_and_budget_exhaustion_degrade():
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(1, 4)])
    d2 = _start_daemon(corpus, warm_buckets=[(1, 4)])
    router, sup = _supervised_fixture([d1, d2], budget=1)
    try:
        mr = sup.register(sup.spawn_proc("replica_s01"))
        assert [r.name for r in router.replica_list()] == \
            [f"127.0.0.1:{d1.port}"]
        mr.proc.proc.rc = 1
        sup.poll_once()
        assert sup.relaunch_budget == 0
        assert [r.name for r in router.replica_list()] == \
            [f"127.0.0.1:{d2.port}"]
        assert [e["reason"] for e in sup.retired] == ["crash: exited rc 1"]
        assert not sup.degraded
        sup.managed[0].proc.proc.rc = -9
        sup.poll_once()
        assert sup.degraded and sup.managed == []
        assert len(router.replica_list()) == 0
        snap = sup.snapshot()
        assert snap["degraded"] and snap["relaunch_budget_left"] == 0
        st = router.stats()
        assert st["scale"]["crashes"] == 2 and st["scale"]["relaunches"] == 1
    finally:
        router.close()
        d1.close()
        d2.close()


def test_supervisor_scale_down_uses_drain_choreography():
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(1, 4)])
    d2 = _start_daemon(corpus, warm_buckets=[(1, 4)])
    router, sup = _supervised_fixture([d1, d2], budget=0)
    try:
        sup.register(sup.spawn_proc("replica_s01"))
        mr2 = sup.register(sup.spawn_proc("replica_s02"))
        assert len(router.replica_list()) == 2
        assert sup.retire(mr2, drain=True, reason="scale_down") == 0
        assert len(router.replica_list()) == 1
        assert sup.retired[-1]["reason"] == "scale_down"
        assert d2._drain_event.is_set() and not d1._drain_event.is_set()
    finally:
        router.close()
        d1.close()
        d2.close()


def test_reshard_planning_helpers():
    assert not needs_resplit(100, 256, threshold=0.9)
    assert needs_resplit(231, 256, threshold=0.9)
    assert grown_capacity(256, 235) == 512
    assert grown_capacity(256, 600) >= 1024


def test_forced_resplit_of_a_real_replica_loses_no_response(tmp_path):
    """A supervised fleet of one subprocess replica (``python -m
    dmlp_tpu_torch.serve --device cpu``), grown by a wire ingest, is
    re-split by force while a query wave runs: the grown replacement
    holds the same corpus signature, every response is the oracle's or
    an explicit rejection, and the old replica drains with exit code 0."""
    path = tmp_path / "corpus.txt"
    path.write_text(format_input(make_corpus()))
    corpus = parse_input_text(path.read_text())   # the file's own rows
    router = FleetRouter([], allow_empty=True, health_interval_s=0.2,
                         repair=False)
    spec = ReplicaSpec(str(path), str(tmp_path), warm_spec="2x8",
                       flags=["--device", "cpu"],
                       env_extra={"OMP_NUM_THREADS": "1"})
    sup = FleetSupervisor(router, spec, min_replicas=1, max_replicas=1,
                          relaunch_budget=0, poll_s=600,
                          ready_timeout_s=120, drain_timeout_s=60)
    router.start()
    try:
        sup.start()
        (old,) = sup.managed
        rng = np.random.default_rng(31)
        newl = rng.integers(0, 4, 40).astype(np.int32)
        newa = rng.uniform(0, 50, (40, 5))
        cli = sc.ServeClient(router.port)
        assert cli.ingest([int(v) for v in newl], newa)["ok"]
        cli.close()
        labels = np.concatenate([corpus.labels, newl])
        attrs = np.vstack([corpus.data_attrs, newa])
        q = rng.uniform(0, 50, (2, 5))
        want = golden_for(labels, attrs, q, [4, 6])
        out = []
        stop = threading.Event()

        def wave():
            i = 0
            while not stop.is_set():
                out.append(_query(router.port, q, [4, 6], f"w{i}"))
                i += 1

        t = threading.Thread(target=wave)
        t.start()
        try:
            res = sup.force_resplit()
        finally:
            stop.set()
            t.join(timeout=60)
        assert res["ok"], res
        assert res["capacity"] == 2048 and res["old_rc"] == 0
        assert res["replayed_rows"] == 40
        (new,) = sup.managed
        assert new.generation == old.generation + 1
        assert ccs.corpus_state_via_wire(new.replica)["checksum"] == \
            ccs.corpus_fold(labels, attrs)
        assert out and all(r["checksums"] == want for r in out
                           if r.get("ok"))
        assert all("rejected" in r["error"] for r in out if not r["ok"])
        assert sum(1 for r in out if r.get("ok")) >= len(out) - 2
        r = _query(router.port, q, [4, 6])
        assert r["ok"] and r["checksums"] == want
        assert router.stats()["scale"]["splits"] == 1
    finally:
        sup.stop()
        router.drain()
        rcs = sup.wait_children(timeout_s=60)
        assert all(c["rc"] == 0 for c in rcs), rcs


# -- scrape staleness ----------------------------------------------------------

def test_scrape_cache_stamps_age_and_stale():
    calls = {"fail": False}

    def fetch(url):
        if calls["fail"]:
            raise OSError("down")
        return "# TYPE x counter\nx_total 4\n# EOF\n"

    clock = [100.0]
    cache = fscrape.ScrapeCache(clock=lambda: clock[0], fetch=fetch)
    text, age, stale = cache.fetch("a", "http://x/metrics")
    assert text and age == 0.0 and not stale
    calls["fail"] = True
    clock[0] = 103.5
    text2, age2, stale2 = cache.fetch("a", "http://x/metrics")
    assert text2 == text and age2 == pytest.approx(3.5) and stale2
    none_text, _age, none_stale = cache.fetch("b", "http://y/metrics")
    assert none_text is None and none_stale
    cache.forget("a")
    t3, _a3, s3 = cache.fetch("a", "http://x/metrics")
    assert t3 is None and s3


def test_router_metrics_text_marks_stale_replica_scrapes():
    import http.server

    exposition = ("# TYPE serve_requests_completed counter\n"
                  "serve_requests_completed_total 4\n# EOF\n")

    class _H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = exposition.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _H)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(1, 4)])
    router = FleetRouter([("127.0.0.1", d1.port)],
                         scrape_ports=[httpd.server_address[1]], port=0,
                         health_interval_s=600, repair=False)
    router.start()
    try:
        om = router.fleet_metrics_text()
        assert validate_openmetrics(om) == []
        line = next(ln for ln in om.splitlines()
                    if ln.startswith("fleet_replica_scrape_stale"))
        assert line.endswith(" 0")
        assert "serve_requests_completed_total 4" in om
        httpd.shutdown()
        httpd.server_close()
        time.sleep(0.05)
        om2 = router.fleet_metrics_text()
        assert validate_openmetrics(om2) == []
        assert "serve_requests_completed_total 4" in om2
        line = next(ln for ln in om2.splitlines()
                    if ln.startswith("fleet_replica_scrape_stale"))
        assert line.endswith(" 1")
    finally:
        router.close()
        d1.close()


def test_daemon_stats_expose_corpus_signature():
    corpus = make_corpus()
    d = _start_daemon(corpus, warm_buckets=[(1, 4)])
    try:
        cli = sc.ServeClient(d.port)
        st = cli.stats()["stats"]
        cli.close()
        assert st["corpus"] == {
            "rows": 600, "epoch": 0,
            "checksum": ref_ccs.corpus_fold(corpus.labels,
                                            corpus.data_attrs)}
    finally:
        d.close()


# -- a mesh replica's dead worker ----------------------------------------------

def test_mesh_replica_dead_worker_ends_its_daemon(tmp_path):
    """``python -m dmlp_tpu_torch.serve --mesh 2x1``: golden before and
    after a wire ingest, the mesh in the ready file and every rank's
    launches in the batch log; then a SIGKILLed worker rank ends the
    daemon non-zero within the group's timeout, leaving no process."""
    rng = np.random.default_rng(3)
    n, na = 3000, 8
    inp = KNNInput(Params(n, 4, na), rng.integers(0, 5, n).astype(np.int32),
                   rng.uniform(0, 100, (n, na)),
                   rng.integers(1, 8, 4).astype(np.int32),
                   rng.uniform(0, 100, (4, na)))
    path = tmp_path / "corpus.txt"
    path.write_text(format_input(inp))
    inp = parse_input_text(path.read_text())    # the file's own rows
    ready, err = tmp_path / "ready.json", tmp_path / "mesh.err"
    with open(err, "w") as ef:
        p = subprocess.Popen(
            [sys.executable, "-m", "dmlp_tpu_torch.serve", "--corpus",
             str(path), "--device", "cpu", "--port", "0", "--ready-file",
             str(ready), "--tick-ms", "1", "--mesh", "2x1", "--pallas",
             "--select", "extract", "--warm-buckets", "32x8"], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
            stdout=subprocess.DEVNULL, stderr=ef)
    try:
        doc = sc.await_ready(p, str(ready), timeout_s=120, errlog=str(err))
        assert doc["mesh"] == [2, 1] and doc["backend"] == "gloo"
        q = rng.uniform(0, 100, (6, na))
        ks = rng.integers(1, 8, 6)
        r = _query(doc["port"], q, ks)
        assert r["ok"] and r["checksums"] == golden_for(
            inp.labels, inp.data_attrs, q, ks)
        newl, newa = rng.integers(0, 5, 9), rng.uniform(0, 100, (9, na))
        cli = sc.ServeClient(doc["port"])
        assert cli.ingest([int(v) for v in newl], newa)["ok"]
        labels = np.concatenate([inp.labels, newl])
        attrs = np.vstack([inp.data_attrs, newa])
        r = cli.query(q, ks=[int(v) for v in ks])
        st = cli.stats()["stats"]
        cli.close()
        assert r["checksums"] == golden_for(labels, attrs, q, ks)
        assert st["corpus"]["checksum"] == ccs.corpus_fold(labels, attrs)
        assert len(st["engine"]["batch_log"][-1]["launches_by_rank"]) == 2
        kids = subprocess.run(["pgrep", "-P", str(p.pid)],
                              capture_output=True, text=True).stdout.split()
        assert len(kids) == 1
        t0 = time.monotonic()
        os.kill(int(kids[0]), signal.SIGKILL)
        rc = p.wait(timeout=GROUP_TIMEOUT_S + 30)
        assert rc != 0 and time.monotonic() - t0 < GROUP_TIMEOUT_S
        assert "lost a rank" in err.read_text()
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
