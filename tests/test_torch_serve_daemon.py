"""The port's serving daemon against the reference's, end to end.

Both daemons run in this process on real sockets (the reference's kernels
in Pallas interpret mode, the port's on the CPU with their plain versions)
and replay the committed serve traces with ``client.replay`` over several
connections: their ``contract_text`` must be byte-identical to each
other's and to the port's float64 oracle, before and after a wire ingest,
and the corpus signatures equal. Then the port alone: the compile-once
contract over a warmed replay, the admission squeeze, the degradation
ladder under a fault schedule, and ``python -m dmlp_tpu_torch.serve
--device cpu`` in a fresh interpreter through one replay and a SIGTERM
drain, after which no jax, jaxlib or dmlp_tpu module is loaded.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from dmlp_tpu.config import EngineConfig as RefConfig  # noqa: E402
from dmlp_tpu.io.grammar import parse_input_text as ref_parse  # noqa: E402
from dmlp_tpu.serve import client as ref_client  # noqa: E402
from dmlp_tpu.serve.daemon import ServeDaemon as RefDaemon  # noqa: E402
from dmlp_tpu_torch.config import EngineConfig  # noqa: E402
from dmlp_tpu_torch.io.grammar import KNNInput, Params  # noqa: E402
from dmlp_tpu_torch.io.grammar import parse_input_text  # noqa: E402
from dmlp_tpu_torch.resilience import inject as rs_inject  # noqa: E402
from dmlp_tpu_torch.resilience import stats as rs_stats  # noqa: E402
from dmlp_tpu_torch.serve import client as sc  # noqa: E402
from dmlp_tpu_torch.serve.daemon import ServeDaemon  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TRACES = {name: sc.load_trace(str(ROOT / "inputs" / f"{name}.jsonl"))
          for name in ("serve_trace1", "serve_trace2")}
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "dmlp_tpu")


def _drain(daemon, cli):
    assert cli.drain()["draining"]
    cli.close()
    t = threading.Thread(target=daemon.run_until_drained, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "drain hung"
    assert daemon._inflight == 0


def _grown(corpus: KNNInput, labels, rows) -> KNNInput:
    m = len(labels)
    return KNNInput(Params(corpus.params.num_data + m, 0,
                           corpus.params.num_attrs),
                    np.concatenate([corpus.labels,
                                    np.asarray(labels, np.int32)]),
                    np.vstack([corpus.data_attrs, rows]),
                    np.zeros(0, np.int32),
                    np.zeros((0, corpus.params.num_attrs)))


# (trace, use_pallas): the first on the streaming fold, the second on the
# resident extraction path (K1 under the reference's Pallas kernel).
@pytest.mark.parametrize("trace,pallas", [("serve_trace1", False),
                                          ("serve_trace2", True)])
def test_daemons_replay_the_traces_byte_identically(trace, pallas):
    header, reqs = TRACES[trace]
    text = sc.corpus_text(header)
    assert text == ref_client.corpus_text(header)
    corpus = parse_input_text(text)
    port = ServeDaemon(corpus, EngineConfig(use_pallas=pallas,
                                            device="cpu"), port=0)
    ref = RefDaemon(ref_parse(text), RefConfig(use_pallas=pallas), port=0)
    port.start()
    ref.start()
    try:
        outs = {}
        for name, d in (("port", port), ("ref", ref)):
            res = sc.replay(d.port, header, reqs, connections=4)
            assert all(r["ok"] for r in res), res
            outs[name] = sc.contract_text([r["checksums"] for r in res])
        golden = sc.contract_text(sc.golden_reference(corpus, header, reqs))
        assert outs["port"] == outs["ref"] == golden
        # A wire ingest, then a replay over the grown corpus.
        rng = np.random.default_rng(5)
        rows = rng.uniform(header["corpus"]["min_attr"],
                           header["corpus"]["max_attr"],
                           (300, corpus.params.num_attrs))
        labels = [int(v) for v in rng.integers(0, 10, 300)]
        clis = {"port": sc.ServeClient(port.port),
                "ref": sc.ServeClient(ref.port)}
        for cli in clis.values():
            r = cli.ingest(labels, rows)
            assert r["ok"] and r["corpus_rows"] == 16300
        grown = _grown(corpus, labels, rows)
        part = reqs[:6]
        for name, d in (("port", port), ("ref", ref)):
            res = sc.replay(d.port, header, part, connections=2)
            outs[name] = sc.contract_text([r["checksums"] for r in res])
        assert outs["port"] == outs["ref"] == sc.contract_text(
            sc.golden_reference(grown, header, part))
        # The corpus op: the same rows and signature from both daemons.
        probe = {"op": "corpus", "start": 15990, "count": 20}
        got = {name: cli.call(probe) for name, cli in clis.items()}
        assert got["port"] == got["ref"]
        assert got["port"]["corpus_rows"] == 16300
        assert len(got["port"]["rows"]) == 20
        st = {name: cli.stats()["stats"] for name, cli in clis.items()}
        assert st["port"]["corpus"] == st["ref"]["corpus"]
        assert st["port"]["corpus"]["rows"] == 16300
        assert st["port"]["requests_completed"] == len(reqs) + len(part)
        assert st["port"]["request_latency_ms"]["count"] == \
            len(reqs) + len(part)
        assert set(st["ref"]) - set(st["port"]) <= {"slo"}
        eng = st["port"]["engine"]
        assert set(ref.engine.bucket_stats()) - set(eng) == set()
        assert eng["hlo_schedule"] == {}
        paths = set(eng["paths"].values())
        assert paths == ({"extract"} if pallas else {"stream"})
        for name, d in (("port", port), ("ref", ref)):
            _drain(d, clis[name])
    finally:
        for d in (port, ref):
            if not d._drain_event.is_set():
                d.close()


def _daemon(corpus, **kw):
    return ServeDaemon(corpus, EngineConfig(select="extract",
                                            use_pallas=True,
                                            data_block=2048,
                                            device="cpu"),
                       port=0, **kw)


def _small_corpus(n=6000, na=6, seed=4):
    rng = np.random.default_rng(seed)
    return KNNInput(Params(n, 0, na), rng.integers(0, 5, n).astype(np.int32),
                    rng.uniform(-10, 10, (n, na)), np.zeros(0, np.int32),
                    np.zeros((0, na)))


HEADER = {"serve_trace_schema": 1,
          "corpus": {"num_attrs": 6, "min_attr": -10, "max_attr": 10}}


def test_warmed_replay_builds_nothing_and_the_squeeze_sheds_one():
    corpus = _small_corpus()
    reqs = [{"nq": 1 + (i * 7) % 40, "k": 1 + (i * 5) % 30, "seed": 50 + i}
            for i in range(12)]
    warm = sc.warm_buckets_for_trace(reqs, 64)
    d = _daemon(corpus, warm_buckets=warm, max_batch_queries=64)
    d.start()
    try:
        ready = d.engine.bucket_stats()
        res = sc.replay(d.port, HEADER, reqs, connections=3)
        assert all(r["ok"] for r in res)
        assert sc.contract_text([r["checksums"] for r in res]) == \
            sc.contract_text(sc.golden_reference(corpus, HEADER, reqs))
        # Open loop: every request fires at its (sped-up) offset on its
        # own connection; the daemon echoes each rid.
        timed = [{**r, "t_ms": 5 * i} for i, r in enumerate(reqs[:4])]
        res = sc.replay_open_loop(d.port, HEADER, timed, speed=10.0,
                                  rid_prefix="t")
        assert [r["rid"] for r in res] == ["t0", "t1", "t2", "t3"]
        assert sc.contract_text([r["checksums"] for r in res]) == \
            sc.contract_text(sc.golden_reference(corpus, HEADER, timed))
        after = d.engine.bucket_stats()
        assert after["compile_count"] == ready["compile_count"]
        assert after["kernel_loads"] == ready["kernel_loads"]
        assert after["buckets"] == ready["buckets"]
        # The admission squeeze: one request shed, the next served, and
        # the ladder untouched.
        rs_stats.reset()
        rs_inject.install(rs_inject.FaultSchedule.from_dict(
            {"schema": 1, "faults": [{"site": "serve.admit",
                                      "kind": "oom"}]}))
        try:
            cli = sc.ServeClient(d.port)
            shed = cli.query(np.zeros((2, 6)), k=3)
            served = cli.query(np.zeros((2, 6)), k=3)
        finally:
            rs_inject.uninstall()
        assert not shed["ok"] and shed["error"] == \
            "rejected: injected_squeeze"
        assert served["ok"]
        assert rs_stats.snapshot()["degradations"] == []
        assert cli.stats()["stats"]["admission"]["rejected"] == {
            "injected_squeeze": 1}
        _drain(d, cli)
    finally:
        if not d._drain_event.is_set():
            d.close()


@pytest.mark.parametrize("times,rung", [(3, "tuned"), (5, "streaming")])
def test_fault_schedule_lands_a_batch_on_its_rung(times, rung):
    """``oom`` at ``single.stage_put`` (each rung's attempt stages the
    batch's queries once), installed before the daemon starts as
    ``--faults`` installs it and skipping the warm-up's one hit per warm
    bucket: 3 faults land the first replayed batch on ``tuned`` (K2), 5
    on ``streaming`` (K3's fold), each golden-identical; the next batch
    is back on ``lowp``."""
    corpus = _small_corpus()
    warm = [(8, 8), (5, 7)]             # one bucket, q32 k8
    rs_stats.reset()
    rs_inject.install(rs_inject.FaultSchedule.from_dict(
        {"schema": 1, "faults": [{"site": "single.stage_put",
                                  "kind": "oom", "times": times,
                                  "after": 1}]}))
    try:
        d = _daemon(corpus, warm_buckets=warm)
        d.start()
        try:
            assert len(d.engine.bucket_stats()["buckets"]) == 1
            reqs = [{"nq": 8, "k": 8, "seed": 7},
                    {"nq": 3, "k": 5, "seed": 8}]
            cli = sc.ServeClient(d.port)
            first = sc.replay(d.port, HEADER, reqs[:1], connections=1)
            landed = d.engine.last_degrade_rung
            second = sc.replay(d.port, HEADER, reqs[1:], connections=1)
            assert landed == rung
            assert d.engine.last_degrade_rung == "lowp"
            got = sc.contract_text([r["checksums"]
                                    for r in first + second])
            assert got == sc.contract_text(
                sc.golden_reference(corpus, HEADER, reqs))
            assert len(rs_stats.snapshot()["degradations"]) == times
            _drain(d, cli)
        finally:
            if not d._drain_event.is_set():
                d.close()
    finally:
        rs_inject.uninstall()


def test_module_daemon_in_a_fresh_interpreter_imports_no_reference(
        tmp_path):
    header, reqs = TRACES["serve_trace2"]
    corpus_file = tmp_path / "corpus.txt"
    corpus_file.write_text(sc.corpus_text(header))
    ready = tmp_path / "ready.json"
    probe = (
        "import runpy, sys\n"
        "sys.argv = ['dmlp_tpu_torch.serve', '--device', 'cpu', '--pallas',"
        f" '--corpus', {str(corpus_file)!r}, '--port', '0',"
        f" '--ready-file', {str(ready)!r}, '--warm-buckets', '8x4,16x8']\n"
        "try:\n"
        "    runpy.run_module('dmlp_tpu_torch.serve', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" {FORBIDDEN!r})\n"
        "sys.stderr.write('FORBIDDEN=%r\\n' % bad)\n")
    err = tmp_path / "err.txt"
    with open(err, "w") as ef:
        proc = subprocess.Popen([sys.executable, "-c", probe], cwd=ROOT,
                                stdout=subprocess.DEVNULL, stderr=ef,
                                env={**os.environ,
                                     "PYTHONPATH": str(ROOT)})
        try:
            doc = sc.await_ready(proc, str(ready), timeout_s=120,
                                 errlog=str(err))
            res = sc.replay(doc["port"], header, reqs, connections=3)
            assert all(r["ok"] for r in res)
            corpus = parse_input_text(corpus_file.read_text())
            assert sc.contract_text([r["checksums"] for r in res]) == \
                sc.contract_text(sc.golden_reference(corpus, header, reqs))
            sc.sigterm_drain(proc, timeout_s=60, errlog=str(err))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    lines = err.read_text().splitlines()
    assert "dmlp_tpu_torch.serve: drained clean" in lines
    assert lines[-1] == "FORBIDDEN=[]"
    assert json.loads(ready.read_text())["compile_count"] == \
        len(doc["buckets"])
