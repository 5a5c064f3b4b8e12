"""Request-scoped fleet tracing in the port, checked by the reference's tools.

The counterpart of ``tests/test_fleet_trace.py``:

- **Races in one process.** The port's router and daemons (CPU, the
  kernels' plain versions) share this process's tracer: a replica crash
  mid-request (one rid, two attempt-numbered ``fleet.hop`` spans under one
  ``fleet.route``), a drain racing a query wave (every shed rid keeps its
  terminal route span), ingest fan-out concurrent with queries (no shared
  rid), and untraced requests emitting nothing.
- **A real fleet end to end.** Two replicas (``python -m
  dmlp_tpu_torch.serve --device cpu --trace``) behind ``python -m
  dmlp_tpu_torch.fleet --trace`` started as a user would, an open-loop
  replay with rids from this process's own tracer (the client trace), and
  the in-band drain with every process exiting 0; then the reference's
  ``tools/merge_traces.py --fleet`` and ``tools/check_trace.py --fleet``
  (standard library only in fleet mode) run as subprocesses on the files,
  every request reconciled within the tools' 75 ms residual budget, and
  the router's interpreter holding no jax, jaxlib or dmlp_tpu module.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.fleet import harness as fh
from dmlp_tpu_torch.fleet.router import FleetRouter
from dmlp_tpu_torch.io.grammar import (KNNInput, Params, format_input,
                                       parse_input_text)
from dmlp_tpu_torch.obs import telemetry
from dmlp_tpu_torch.obs import trace as obs_trace
from dmlp_tpu_torch.serve import client as sc
from dmlp_tpu_torch.serve.daemon import ServeDaemon

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "dmlp_tpu")
CPU = EngineConfig(device="cpu")


def make_corpus(n=300, na=4, labels=4, seed=3, spread=50.0) -> KNNInput:
    rng = np.random.default_rng(seed)
    return KNNInput(Params(n, 0, na),
                    rng.integers(0, labels, n).astype(np.int32),
                    rng.uniform(0.0, spread, (n, na)),
                    np.zeros(0, np.int32), np.zeros((0, na)))


def _start_daemon(corpus, **kw):
    kw.setdefault("tick_s", 0.001)
    d = ServeDaemon(corpus, CPU, port=0, **kw)
    d.start()
    return d


def _query(port, corpus, rid, nq=2, seed=61, k=8):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 50.0, (nq, corpus.params.num_attrs))
    cli = sc.ServeClient(port)
    try:
        return cli.call({"op": "query", "id": rid, "rid": rid,
                         "queries": q.tolist(), "k": k})
    finally:
        cli.close()


@pytest.fixture
def tracer():
    t = obs_trace.install(obs_trace.Tracer())
    t.sync_instant("fleet.clock_sync")
    yield t
    obs_trace.uninstall()


def _spans(tracer, name, rid=None):
    return [e for e in tracer.to_dict()["traceEvents"]
            if e.get("ph") == "X" and e.get("name") == name
            and (rid is None or e.get("args", {}).get("rid") == rid)]


class _CrashingReplica:
    """Healthy to stats probes; closes the connection on any query."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                try:
                    doc = json.loads(conn.makefile("rb").readline())
                    if doc.get("op") == "stats":
                        conn.sendall(json.dumps(
                            {"ok": True, "stats": {"admission":
                             {"draining": False}}}).encode() + b"\n")
                except (OSError, ValueError):
                    pass

    def close(self):
        self.sock.close()


# -- races ---------------------------------------------------------------------

def test_rid_survives_crash_retry_with_two_hop_spans(tracer):
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    crasher = _CrashingReplica()
    router = FleetRouter([("127.0.0.1", crasher.port),
                          ("127.0.0.1", d1.port)], port=0,
                         health_interval_s=600)
    router.start()
    try:
        retried = None
        for i in range(6):
            r = _query(router.port, corpus, f"race-{i}")
            assert r["ok"] and r["rid"] == f"race-{i}", r
            if r.get("hops"):
                retried = r
                break
        assert retried is not None and retried["hops"] == 2
        rid = retried["rid"]
        hops = _spans(tracer, "fleet.hop", rid=rid)
        assert sorted(h["args"]["attempt"] for h in hops) == [1, 2]
        outcomes = [h["args"]["outcome"] for h in hops]
        assert outcomes[0].startswith("error_") and outcomes[1] == "ok"
        (route,) = _spans(tracer, "fleet.route", rid=rid)
        assert route["args"]["hops"] == 2
        assert route["args"]["outcome"] == "ok"
        assert _spans(tracer, "serve.phase.solve", rid=rid)
        assert _spans(tracer, "serve.phase.queue", rid=rid)
    finally:
        router.close()
        d1.close()
        crasher.close()


def test_drain_racing_query_wave_sheds_with_terminal_spans(tracer):
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    router = FleetRouter([("127.0.0.1", d1.port)], port=0,
                         health_interval_s=600)
    router.start()
    try:
        out = {}

        def worker(rid):
            out[rid] = _query(router.port, corpus, rid)

        def wave(ids):
            ts = [threading.Thread(target=worker, args=(f"w-{i}",))
                  for i in ids]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)

        wave(range(3))
        with router._lock:          # the drain lands mid-wave
            router._draining = True
        wave(range(3, 6))
        for i in range(6):
            rid = f"w-{i}"
            (route,) = _spans(tracer, "fleet.route", rid=rid)
            if i < 3:
                assert out[rid]["ok"]
                assert route["args"]["outcome"] == "ok"
            else:
                assert not out[rid]["ok"]
                assert "draining" in out[rid]["error"]
                assert route["args"]["outcome"] == "rejected_draining"
    finally:
        router.close()
        d1.close()


def test_concurrent_ingest_and_queries_never_share_a_rid(tracer):
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    d2 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    router = FleetRouter([("127.0.0.1", d1.port), ("127.0.0.1", d2.port)],
                         port=0, health_interval_s=600)
    router.start()
    try:
        rows = np.random.default_rng(7).uniform(0.0, 50.0, (5, 4))
        results = {}

        def do_ingest():
            cli = sc.ServeClient(router.port)
            try:
                results["ing"] = cli.call(
                    {"op": "ingest", "id": "ing", "rid": "ing-0",
                     "labels": [0, 1, 2, 3, 0], "rows": rows.tolist()})
            finally:
                cli.close()

        def do_query(i):
            results[f"q-{i}"] = _query(router.port, corpus, f"q-{i}")

        threads = [threading.Thread(target=do_ingest)] + \
            [threading.Thread(target=do_query, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert results["ing"]["ok"] and results["ing"]["rid"] == "ing-0"
        ing_hops = _spans(tracer, "fleet.hop", rid="ing-0")
        assert len(ing_hops) == 2
        assert all(h["args"].get("fanout") for h in ing_hops)
        assert _spans(tracer, "serve.phase.ingest", rid="ing-0")
        query_rids = {h["args"]["rid"] for h in _spans(tracer, "fleet.hop")
                      if "attempt" in h["args"]}
        assert query_rids == {f"q-{i}" for i in range(4)}
        assert all(results[f"q-{i}"]["ok"] for i in range(4))
    finally:
        router.close()
        d1.close()
        d2.close()


def test_untraced_requests_emit_no_spans_and_echo_no_rid():
    assert not obs_trace.sinks_active()
    corpus = make_corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    try:
        q = np.random.default_rng(61).uniform(0.0, 50.0, (2, 4))
        cli = sc.ServeClient(d1.port)
        r = cli.call({"op": "query", "id": "0", "queries": q.tolist(),
                      "k": 8})
        cli.close()
        assert r["ok"] and "rid" not in r
    finally:
        d1.close()


# -- a real fleet, its traces and the reference's tools ------------------------

def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


def test_traced_static_fleet_passes_the_reference_tools(tmp_path):
    rng = np.random.default_rng(3)
    n, na = 3000, 8
    text = format_input(KNNInput(
        Params(n, 4, na), rng.integers(0, 5, n).astype(np.int32),
        rng.uniform(0, 100, (n, na)), rng.integers(1, 8, 4).astype(
            np.int32), rng.uniform(0, 100, (4, na))))
    corpus_path = tmp_path / "corpus.txt"
    corpus_path.write_text(text)
    corpus = parse_input_text(text)
    traces = tmp_path / "traces"
    traces.mkdir()
    reps = [fh.spawn_replica(
        str(corpus_path), str(tmp_path), f"replica{i:02d}", "8x8",
        flags=["--device", "cpu", "--trace",
               str(traces / f"trace-replica{i:02d}.json")],
        env_extra={"OMP_NUM_THREADS": "1"}) for i in range(2)]
    fh.await_all(reps, timeout_s=120)
    # The router as ``python -m dmlp_tpu_torch.fleet``, scanned for
    # forbidden modules at its exit.
    probe = (
        "import runpy, sys, atexit\n"
        "def scan():\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" {FORBIDDEN!r})\n"
        "    sys.stderr.write('FORBIDDEN=%r\\n' % bad)\n"
        "atexit.register(scan)\n"
        "sys.argv = ['dmlp_tpu_torch.fleet'] + sys.argv[1:]\n"
        "runpy.run_module('dmlp_tpu_torch.fleet', run_name='__main__')\n")
    ready, err = tmp_path / "router_ready.json", tmp_path / "router.err"
    with open(err, "w") as ef:
        router = subprocess.Popen(
            [sys.executable, "-c", probe, "--replicas",
             ",".join(f"127.0.0.1:{fp.ready['port']}" for fp in reps),
             "--scrape-ports", ",".join(str(fp.scrape_port) for fp in reps),
             "--port", "0", "--ready-file", str(ready),
             "--telemetry-port", "0", "--trace",
             str(traces / "trace-router.json")], cwd=ROOT, env=_env(),
            stdout=subprocess.DEVNULL, stderr=ef)
    client = obs_trace.install(obs_trace.Tracer())
    client.sync_instant("fleet.clock_sync")
    try:
        doc = sc.await_ready(router, str(ready), timeout_s=60,
                             errlog=str(err))
        header = {"serve_trace_schema": 1, "corpus": {
            "num_data": n, "num_attrs": na, "min_attr": 0.0,
            "max_attr": 100.0, "num_labels": 5}}
        reqs = [{"t_ms": 25 * i, "nq": 1 + i % 3, "k": 3 + i % 5,
                 "seed": 70 + i} for i in range(12)]
        res = sc.replay_open_loop(doc["port"], header, reqs,
                                  rid_prefix="lvl1-", level=1.0)
        want = sc.golden_reference(corpus, header, reqs)
        assert [r["checksums"] for r in res] == want
        assert [r["rid"] for r in res] == [f"lvl1-{i}" for i in range(12)]
        st = sc.ServeClient(doc["port"])
        stats = st.stats()["stats"]
        st.close()
        assert all(r["requests"] > 0 for r in stats["replicas"]), stats
        with urllib.request.urlopen(
                f"http://127.0.0.1:{doc['telemetry_port']}/metrics",
                timeout=30) as resp:
            om = resp.read().decode()
        assert telemetry.validate_openmetrics(om) == []
        count = [int(ln.split()[1]) for ln in om.splitlines()
                 if ln.startswith("serve_request_latency_ms_count ")]
        assert count == [12]
        client.write(str(traces / "trace-client.json"),
                     process_name="client")
        rfp = fh.FleetProc("router", router, str(ready), str(err))
        rfp.ready = doc
        fh.drain_fleet(rfp, reps, timeout_s=60)
        lines = err.read_text().splitlines()
        assert "dmlp_tpu_torch.fleet: drained clean" in lines
        assert lines[-1] == "FORBIDDEN=[]"
    finally:
        obs_trace.uninstall()
        fh.kill_all(reps)
        if router.poll() is None:
            router.kill()
            router.wait(timeout=30)
    merged = tmp_path / "merged.json"
    m = subprocess.run(
        [sys.executable, "tools/merge_traces.py", "--fleet", str(traces),
         "-o", str(merged)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert m.returncode == 0, m.stderr
    fleet = json.loads(merged.read_text())["fleet"]
    assert set(fleet["processes"]) == {"client", "router", "replica00",
                                       "replica01"}
    rec = fleet["reconcile"]
    assert rec["n_requests"] == rec["n_reconciled"] == 12, rec
    assert rec["tol_abs_ms"] == 75.0
    c = subprocess.run(
        [sys.executable, "tools/check_trace.py", "--fleet", str(merged)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert c.returncode == 0, c.stdout + c.stderr
    assert "all fleet-trace invariants hold" in c.stdout
