"""The port's serving fleet (dmlp_tpu_torch.fleet) against the reference's.

- **The mesh-resident engine.** The port's ``MeshResidentEngine`` at (2, 1)
  and (1, 2), with the all-gather and the ring merge, as gloo ranks (one
  spawn of 2 processes per mesh shape for the module, every process group
  with a 60 s timeout, every process waited on with a deadline) against
  the reference's ``MeshResidentEngine`` on the conftest's virtual devices
  (Pallas in interpret mode) and the float64 oracle, on the same numpy
  corpora and batches: the stream path, the extract path, an ingest, the
  prune, the wide-k stream path and the gate-carry fold order. Checksums:
  equal to each other and to ``golden.fast``, tolerance none.
- **The pure functions** against the reference's on the same inputs:
  the scrape merge byte for byte, ``diagnose``, ``target_replicas``,
  ``predictive_target_replicas``, ``grown_capacity``, ``needs_resplit``,
  ``offered_qps`` and ``level_tag``.
- **The router** over in-process port daemons on the CPU: byte identity
  and spread, a replica that crashes mid-request (bounded retry), a drain
  racing a query wave, an admission shed propagated unretried, the ingest
  fan-out; the open-loop replay and the load levels' RunRecords.
- **Entry points**: a ``--mesh-merge auto`` replica (the "gspmd" merge)
  serving golden's checksums from a fresh interpreter, and a mesh
  replica's spec carrying its rank count.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from dmlp_tpu.config import EngineConfig as RefConfig  # noqa: E402
from dmlp_tpu.fleet import autoscale as ref_autoscale  # noqa: E402
from dmlp_tpu.fleet import consistency as ref_ccs  # noqa: E402
from dmlp_tpu.fleet import loadgen as ref_loadgen  # noqa: E402
from dmlp_tpu.fleet import reshard as ref_reshard  # noqa: E402
from dmlp_tpu.fleet import scrape as ref_scrape  # noqa: E402
from dmlp_tpu.fleet.mesh_engine import \
    MeshResidentEngine as RefMesh  # noqa: E402
from dmlp_tpu.io.grammar import KNNInput as RefInput  # noqa: E402
from dmlp_tpu.io.grammar import Params as RefParams  # noqa: E402
from dmlp_tpu_torch.config import EngineConfig  # noqa: E402
from dmlp_tpu_torch.fleet import autoscale, loadgen, reshard  # noqa: E402
from dmlp_tpu_torch.fleet import consistency as ccs  # noqa: E402
from dmlp_tpu_torch.fleet import scrape as fscrape  # noqa: E402
from dmlp_tpu_torch.fleet.router import FleetRouter  # noqa: E402
from dmlp_tpu_torch.golden.fast import knn_golden_fast  # noqa: E402
from dmlp_tpu_torch.io.grammar import KNNInput, Params  # noqa: E402
from dmlp_tpu_torch.io.grammar import format_input  # noqa: E402
from dmlp_tpu_torch.obs import telemetry  # noqa: E402
from dmlp_tpu_torch.serve import client as sc  # noqa: E402
from dmlp_tpu_torch.serve.daemon import ServeDaemon  # noqa: E402
from dmlp_tpu_torch.serve.engine import ResidentEngine  # noqa: E402

from test_torch_mesh import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(2, 1), (1, 2)]
MERGES = ["allgather", "ring"]
CPU = EngineConfig(device="cpu")


def make_corpus(n=600, na=5, labels=4, seed=3, spread=50.0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, labels, n).astype(np.int32),
            rng.uniform(0, spread, (n, na)))


def banded(n, na, scales, seed):
    """Norm-banded rows (attribute offsets per band of rows) over several
    per-shard chunks: queries near one band let the prune drop the
    others."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, (n, na))
    scale = np.repeat(scales, n // len(scales) + 1)[:n]
    return (rng.integers(0, 4, n).astype(np.int32),
            base + np.asarray(scale)[:, None])


def batch(na, nq, seed, kmax=12, spread=50.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, spread, (nq, na)),
            rng.integers(1, kmax, nq).astype(np.int32))


def golden(labels, attrs, q, ks):
    inp = KNNInput(Params(len(labels), len(ks), attrs.shape[1]),
                   np.asarray(labels, np.int32), np.asarray(attrs),
                   np.asarray(ks, np.int32), np.asarray(q, np.float64))
    return [int(r.checksum()) for r in knn_golden_fast(inp)]


EXTRACT = {"select": "extract", "use_pallas": True}


def _data():
    """Every corpus, batch and ingest of the mesh cases (numpy, seeded)."""
    d = {}
    d["small_labels"], d["small_attrs"] = make_corpus()
    for name, seed in (("b11", 11), ("b12", 12), ("b21", 21), ("b41", 41)):
        d[name + "_q"], d[name + "_ks"] = batch(5, 4, seed)
    rng = np.random.default_rng(9)
    d["new_labels"] = rng.integers(0, 4, 7).astype(np.int32)
    d["new_attrs"] = rng.uniform(0, 50, (7, 5))
    d["band_labels"], d["band_attrs"] = banded(
        26000, 4, [1.0, 40.0, 400.0, 4000.0], 5)
    d["band_q"] = d["band_attrs"][:2] + 0.01
    d["band_ks"] = np.asarray([3, 6], np.int32)
    d["wide_labels"], d["wide_attrs"] = make_corpus(1408, 4, seed=7,
                                                    spread=60.0)
    rng = np.random.default_rng(17)
    d["wide_q"] = rng.uniform(0, 60, (2, 4))
    d["wide_ks"] = np.asarray([520, 600], np.int32)
    d["gate_labels"], d["gate_attrs"] = banded(26000, 4,
                                               [1.0, 40.0, 400.0], 29)
    a = d["gate_attrs"]
    for s in (1, 2, 3, 4):
        d[f"gate{s}_q"] = a[-3:-1] + 0.01 * s
    d["gate_ks"] = np.asarray([6, 6], np.int32)
    d["gate0_q"] = a[:2] + 0.01
    d["gate0_ks"] = np.asarray([4, 4], np.int32)
    return d


def _solve(q, ks=None):
    return {"op": "solve", "q": q + "_q", "ks": (ks or q) + "_ks"}


# name: (corpus, config, warm buckets, steps, gate carry, capacity). The
# gate cases' capacity of 26,000 rows puts the last band's nearest rows in
# the late chunk of the last shard, so the hot chunk is not chunk 0.
CASES = {
    "stream": ("small", {}, [(4, 12), (1, 4)],
               [_solve("b11"), _solve("b12")], True, None),
    "extract": ("small", dict(EXTRACT, data_block=256), [(4, 12)],
                [_solve("b21")], True, None),
    "ingest": ("small", dict(EXTRACT, data_block=256), [(4, 12)],
               [{"op": "ingest", "labels": "new_labels",
                 "attrs": "new_attrs"}, _solve("b41")], True, None),
    "prune": ("band", dict(EXTRACT, data_block=12800), [(2, 6)],
              [_solve("band")], True, None),
    "widek": ("wide", dict(EXTRACT, data_block=512), [(2, 600)],
              [_solve("wide")], True, None),
    "gate_on": ("gate", dict(EXTRACT, data_block=12800), [(2, 6), (2, 4)],
                [_solve(f"gate{s}", "gate") for s in (1, 2, 3, 4)]
                + [_solve("gate1", "gate"), _solve("gate0")], True, 26000),
    "gate_off": ("gate", dict(EXTRACT, data_block=12800), [(2, 6)],
                 [_solve(f"gate{s}", "gate") for s in (1, 2, 3, 4)],
                 False, 26000),
}

RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.fleet.mesh_engine import MeshResidentEngine
from dmlp_tpu_torch.io.grammar import KNNInput, Params
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.parallel.mesh import make_mesh

work = sys.argv[1]
spec = json.load(open(work + "/spec.json"))
data = np.load(work + "/data.npz")
initialize(auto=True, device="cpu", timeout_s=60)
shape = tuple(spec["shape"])
mesh = make_mesh(shape)
root = dist.get_rank() == 0


def corpus(name):
    lab, att = data[name + "_labels"], data[name + "_attrs"]
    na = att.shape[1]
    return KNNInput(Params(len(lab), 0, na), lab, att,
                    np.zeros(0, np.int32), np.zeros((0, na)))


def plain(o):
    return o.item() if hasattr(o, "item") else str(o)


out = {}
for name, (cname, cfg, warm, steps, carry, cap) in spec["cases"].items():
    for merge in ("allgather", "ring"):
        eng = MeshResidentEngine(
            corpus(cname) if root else None,
            EngineConfig(mode="sharded", device="cpu", **cfg), mesh=mesh,
            capacity=cap, merge=merge, gate_carry=carry)
        if not root:
            eng.serve_worker()
            continue
        rec = {"sig0": eng.corpus_state(), "nchunks": eng._nchunks,
               "floor": eng.resident_model_bytes(),
               "marginal": eng.batch_model_bytes(8, 8),
               "mem": eng.mem_model(8, 8)}
        eng.warmup([tuple(w) for w in warm])
        cc = eng.compile_count
        rb = eng.summary_rebuilds
        rec["solves"] = []
        for step in steps:
            if step["op"] == "ingest":
                rec["rows"] = eng.ingest(data[step["labels"]],
                                         data[step["attrs"]])
                continue
            res = eng.solve_batch(data[step["q"]], data[step["ks"]])
            rec["solves"].append({
                "checksums": [int(r.checksum()) for r in res],
                "prune": eng.last_prune, "order": eng._chunk_order(),
                "hits": eng._block_hits.tolist(),
                "gated": eng.last_gated_fraction,
                "log": eng.batch_log[-1]})
        st = eng.bucket_stats()
        st.pop("batch_log")
        rec.update(compile_delta=eng.compile_count - cc, stats=st,
                   sig=eng.corpus_state(),
                   rebuilds=eng.summary_rebuilds - rb)
        eng.close()
        out[name + "/" + merge] = rec
if root:
    json.dump(out, open(work + "/out.json", "w"), default=plain)
shutdown()
"""


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def mesh_runs(data, tmp_path_factory):
    """The port's results of a mesh shape: one spawn of its 2 ranks,
    which run every case with both merges, made at the first request."""
    cache = {}

    def get(shape):
        if shape not in cache:
            work = tmp_path_factory.mktemp(f"fleet{shape[0]}x{shape[1]}")
            np.savez(work / "data.npz", **data)
            (work / "spec.json").write_text(json.dumps(
                {"shape": shape, "cases": CASES}))
            spawn_ranks(work, RANK_SCRIPT, 2, timeout=240)
            cache[shape] = json.loads((work / "out.json").read_text())
        return cache[shape]
    return get


@pytest.fixture(scope="module")
def reference(data):
    """The reference's MeshResidentEngine of a (shape, case, merge): its
    checksums per solve, run once."""
    cache = {}

    def get(shape, name, merge):
        key = (shape, name, merge)
        if key not in cache:
            cname, cfg, warm, steps, carry, cap = CASES[name]
            lab, att = data[cname + "_labels"], data[cname + "_attrs"]
            na = att.shape[1]
            eng = RefMesh(RefInput(RefParams(len(lab), 0, na), lab, att,
                                   np.zeros(0, np.int32),
                                   np.zeros((0, na))),
                          RefConfig(mode="sharded", **cfg),
                          mesh_shape=shape, capacity=cap, merge=merge,
                          gate_carry=carry)
            eng.warmup(warm)
            got = []
            for step in steps:
                if step["op"] == "ingest":
                    eng.ingest(data[step["labels"]], data[step["attrs"]])
                    continue
                got.append([int(r.checksum()) for r in eng.solve_batch(
                    data[step["q"]], data[step["ks"]])])
            cache[key] = (got, eng.corpus_state())
        return cache[key]
    return get


def _want(data, name):
    """The oracle's checksums of every solve of a case."""
    cname, _cfg, _warm, steps, _carry, _cap = CASES[name]
    lab, att = data[cname + "_labels"], data[cname + "_attrs"]
    out = []
    for step in steps:
        if step["op"] == "ingest":
            lab = np.concatenate([lab, data[step["labels"]]])
            att = np.vstack([att, data[step["attrs"]]])
            continue
        out.append(golden(lab, att, data[step["q"]], data[step["ks"]]))
    return out, lab, att


MESH_PARAMS = [pytest.param(shape, name, merge,
                            id=f"{shape[0]}x{shape[1]}-{name}-{merge}")
               for shape in SHAPES for name in CASES for merge in MERGES]


@pytest.mark.parametrize("shape,name,merge", MESH_PARAMS)
def test_mesh_resident_matches_reference_and_golden(
        mesh_runs, reference, data, shape, name, merge):
    """Every solve's checksums equal the reference engine's and the
    oracle's; no bucket is built after the warm-up; the corpus signature
    equals the reference's and the from-scratch fold."""
    rec = mesh_runs(shape)[f"{name}/{merge}"]
    want, lab, att = _want(data, name)
    ref, ref_sig = reference(shape, name, merge)
    got = [s["checksums"] for s in rec["solves"]]
    assert got == ref == want
    assert rec["compile_delta"] == 0
    assert rec["stats"]["mesh"] == list(shape)
    assert rec["stats"]["merge"] == merge
    assert (rec["sig"]["rows"], rec["sig"]["checksum"]) == \
        (ref_sig["rows"], ref_sig["checksum"]) == \
        (len(lab), ccs.corpus_fold(lab, att))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_resident_paths_ingest_and_prune(mesh_runs, shape):
    """The stream and extract buckets, the wide-k bucket on the stream
    path, an ingest's rows and rebuilt summaries, and the banded corpus
    pruning blocks (on the data axis) with fewer bytes scanned."""
    out = mesh_runs(shape)
    for merge in MERGES:
        assert set(out[f"stream/{merge}"]["stats"]["paths"].values()) \
            == {"stream"}
        assert "extract" in out[f"extract/{merge}"]["stats"][
            "paths"].values()
        wide = out[f"widek/{merge}"]
        assert set(wide["stats"]["paths"].values()) == {"stream"}
        assert wide["solves"][0]["log"]["kcap"] > 512
        ing = out[f"ingest/{merge}"]
        assert ing["rows"] == 607
        if ing["stats"]["summary_blocks"]:
            assert ing["rebuilds"] > 0
        pr = out[f"prune/{merge}"]
        assert pr["nchunks"] > 1
        lp = pr["solves"][0]["prune"]
        if shape[0] > 1:
            assert lp["blocks_pruned"] > 0
            assert lp["scanned_bytes"] < lp["dense_bytes"]
        assert pr["floor"] > 0 and pr["marginal"] > 0
        assert pr["mem"]["per_device"] is True
        assert pr["mem"]["total_bytes"] >= pr["floor"]


def test_mesh_gate_carry_reorders_folds_and_stays_byte_identical(
        mesh_runs, data):
    """Gate carry on and off give the same bytes; with it on the winner
    histogram is per (shard, chunk), a late chunk folds first, and band-0
    queries credit shard 0's blocks only."""
    out = mesh_runs((2, 1))
    for merge in MERGES:
        on, off = out[f"gate_on/{merge}"], out[f"gate_off/{merge}"]
        assert [s["checksums"] for s in on["solves"][:4]] == \
            [s["checksums"] for s in off["solves"]]
        hits = np.asarray(on["solves"][3]["hits"])
        assert hits.shape == (2, on["nchunks"]) and hits.sum() > 0
        hot = int(np.argmax(hits.sum(axis=0)))
        assert hot != 0 and on["solves"][4]["order"][0] == hot
        assert off["solves"][-1]["order"] == list(range(off["nchunks"]))
        assert on["solves"][4]["gated"] is not None
        delta = np.asarray(on["solves"][5]["hits"]) \
            - np.asarray(on["solves"][4]["hits"])
        assert delta[0].sum() > 0 and delta[1].sum() == 0


def test_signatures_identical_across_engine_layouts_and_packages(
        mesh_runs, data):
    """A plain ResidentEngine, the mesh-resident engine (both layouts) and
    the reference's fold report one signature for one corpus, before and
    after the same ingest."""
    lab, att = data["small_labels"], data["small_attrs"]
    inp = KNNInput(Params(len(lab), 0, 5), lab, att, np.zeros(0, np.int32),
                   np.zeros((0, 5)))
    plain = ResidentEngine(inp, CPU)
    s0 = plain.corpus_state()
    assert s0["checksum"] == ref_ccs.corpus_fold(lab, att)
    plain.ingest(data["new_labels"], data["new_attrs"])
    s1 = plain.corpus_state()
    for shape in SHAPES:
        ing = mesh_runs(shape)["ingest/allgather"]
        assert (ing["sig0"]["rows"], ing["sig0"]["checksum"]) == \
            (s0["rows"], s0["checksum"])
        assert (ing["sig"]["rows"], ing["sig"]["checksum"]) == \
            (s1["rows"], s1["checksum"])


# -- the pure functions against the reference's -------------------------------

def _registries(seed):
    rng = np.random.default_rng(seed)
    regs = []
    for _ in range(3):
        reg = telemetry.Registry()
        reg.counter("serve.requests_completed").inc(
            int(rng.integers(1, 50)))
        reg.counter("serve.rejected").inc(int(rng.integers(1, 5)),
                                          label="memory")
        reg.gauge("serve.corpus_rows").set(int(rng.integers(100, 999)))
        h = reg.histogram("serve.request_latency_ms", unit="ms")
        for v in rng.uniform(0.01, 5000.0, 40):
            h.observe(float(v))
        regs.append(reg)
    return regs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scrape_merge_is_byte_equal_to_the_reference(seed):
    """The port's merge of three seeded expositions is byte for byte the
    reference's merge of the same texts, and validates."""
    texts = [r.to_openmetrics() for r in _registries(seed)]
    got, problems = fscrape.merge_expositions(texts, ["a", "b", "c"])
    want, ref_problems = ref_scrape.merge_expositions(texts,
                                                      ["a", "b", "c"])
    assert got == want and problems == ref_problems == []
    assert telemetry.validate_openmetrics(got) == []
    parsed = fscrape.parse_exposition(got)
    ref_parsed = ref_scrape.parse_exposition(got)
    assert parsed.samples == ref_parsed.samples
    assert parsed.hists == ref_parsed.hists
    assert fscrape.counter_total(parsed, "serve.requests_completed") == \
        ref_scrape.counter_total(ref_parsed, "serve.requests_completed")


def test_scrape_merge_sums_counters_and_merges_buckets():
    r1, r2 = telemetry.Registry(), telemetry.Registry()
    for reg, base in ((r1, 3), (r2, 5)):
        reg.counter("serve.requests_completed").inc(base)
        reg.counter("serve.rejected").inc(2, label="memory")
        reg.gauge("serve.corpus_rows").set(100 * base)
        h = reg.histogram("serve.request_latency_ms", unit="ms")
        for v in (base, base * 10, base * 100):
            h.observe(v)
    merged, problems = fscrape.merge_expositions(
        [r1.to_openmetrics(), r2.to_openmetrics()], ["a", "b"])
    assert problems == [] and telemetry.validate_openmetrics(merged) == []
    lines = merged.splitlines()
    assert "serve_requests_completed_total 8" in lines
    assert 'serve_rejected_total{key="memory"} 4' in lines
    assert "serve_request_latency_ms_count 6" in lines
    assert 'serve_corpus_rows{replica="a"} 300' in lines
    assert 'serve_corpus_rows{replica="b"} 500' in lines
    # One value in both replicas: one bucket line carrying 2.
    a, b = telemetry.Registry(), telemetry.Registry()
    a.histogram("x.ms").observe(1.0)
    b.histogram("x.ms").observe(1.0)
    m2, _ = fscrape.merge_expositions([a.to_openmetrics(),
                                       b.to_openmetrics()])
    buckets = [ln for ln in m2.splitlines()
               if ln.startswith("x_ms_bucket") and "+Inf" not in ln]
    assert len(buckets) == 1 and buckets[0].endswith(" 2")


def test_fleet_view_degrades_on_unreachable_replica(tmp_path):
    reg = telemetry.Registry()
    reg.counter("serve.requests_completed").inc(4)
    snap = tmp_path / "a.prom"
    snap.write_text(reg.to_openmetrics())
    merged, problems = fscrape.fleet_view(
        [str(snap), str(tmp_path / "missing.prom")], ["a", "b"])
    assert "serve_requests_completed_total 4" in merged
    assert any("unreachable" in p for p in problems)


@pytest.mark.parametrize("seed", range(4))
def test_diagnose_verdicts_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 6))
        sigs = [(f"r{i}", {"rows": int(rng.integers(8, 11)),
                           "checksum": int(rng.integers(0, 3))})
                for i in range(n)]
        assert ccs.diagnose(sigs) == ref_ccs.diagnose(sigs)


@pytest.mark.parametrize("seed", range(4))
def test_scaling_policies_equal_the_reference(seed):
    """``target_replicas`` over seeded load windows and
    ``predictive_target_replicas`` over seeded SLO signals."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        window = [float(v) for v in rng.uniform(0, 6, rng.integers(0, 7))]
        cur = int(rng.integers(1, 5))
        args = (window, cur, 1, 4, 4.0, 0.25)
        assert autoscale.target_replicas(*args) == \
            ref_autoscale.target_replicas(*args)
        sig = {"burn_fast": float(rng.choice([0.0, 0.5, 1.5])),
               "burn_slow": float(rng.choice([0.0, 0.3])),
               "slope_ms_per_s": float(rng.choice([-1.0, 0.0, 2.0,
                                                   np.nan])),
               "projected_s": float(rng.choice([5.0, 30.0, np.inf])),
               "p_fast": float(rng.uniform(0, 100)), "threshold": 50.0}
        assert autoscale.predictive_target_replicas(sig, cur, 1, 4) == \
            ref_autoscale.predictive_target_replicas(sig, cur, 1, 4)


def test_reshard_and_load_helpers_equal_the_reference():
    rng = np.random.default_rng(7)
    for _ in range(200):
        cap = int(rng.choice([256, 1000, 4096, 262144]))
        rows = int(rng.integers(0, 2 * cap))
        f = int(rng.integers(1, 4))
        assert reshard.grown_capacity(cap, rows, f) == \
            ref_reshard.grown_capacity(cap, rows, f)
        t = float(rng.uniform(0.5, 1.0))
        assert reshard.needs_resplit(rows, cap, t) == \
            ref_reshard.needs_resplit(rows, cap, t)
    reqs = [{"t_ms": float(t), "nq": int(n)} for t, n in
            zip(np.cumsum(rng.uniform(0, 30, 20)), rng.integers(1, 9, 20))]
    for speed in (0.5, 1.0, 2.0, 3.5):
        assert loadgen.offered_qps(reqs, speed) == \
            ref_loadgen.offered_qps(reqs, speed)
        assert loadgen.level_tag(speed) == ref_loadgen.level_tag(speed)
    assert loadgen.offered_qps([{"nq": 3}]) is None


# -- the router over in-process port daemons -----------------------------------

def _corpus():
    lab, att = make_corpus()
    return KNNInput(Params(len(lab), 0, 5), lab, att, np.zeros(0, np.int32),
                    np.zeros((0, 5)))


def _start_daemon(corpus, **kw):
    kw.setdefault("tick_s", 0.001)
    d = ServeDaemon(corpus, CPU, port=0, **kw)
    d.start()
    return d


class _CrashingReplica:
    """Healthy to stats probes; closes the connection on any query."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.queries_seen = 0
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
                    elif doc.get("op") == "drain":
                        conn.sendall(b'{"ok": true, "draining": true}\n')
                    else:
                        self.queries_seen += 1
                except (OSError, ValueError):
                    pass

    def close(self):
        self.sock.close()


def _query(port, q, ks, req_id=""):
    cli = sc.ServeClient(port)
    try:
        return cli.query(q, ks=[int(v) for v in ks], req_id=req_id)
    finally:
        cli.close()


def test_router_byte_identity_and_spread_across_replicas():
    corpus = _corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(4, 8)])
    d2 = _start_daemon(corpus, warm_buckets=[(4, 8)])
    router = FleetRouter([("127.0.0.1", d1.port), ("127.0.0.1", d2.port)],
                         port=0)
    router.start()
    try:
        q, ks = batch(5, 4, 51, kmax=8)
        want = golden(corpus.labels, corpus.data_attrs, q, ks)
        for i in range(6):
            r = _query(router.port, q, ks, str(i))
            assert r["ok"] and r["checksums"] == want, r
        st = router.stats()
        assert all(rep["requests"] > 0 for rep in st["replicas"]), st
        assert sum(rep["requests"] for rep in st["replicas"]) == 6
    finally:
        router.close()
        d1.close()
        d2.close()


def test_router_replica_crash_mid_request_bounded_retry():
    corpus = _corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    crasher = _CrashingReplica()
    router = FleetRouter([("127.0.0.1", crasher.port),
                          ("127.0.0.1", d1.port)], port=0,
                         health_interval_s=600)
    router.start()
    try:
        q, ks = batch(5, 2, 61, kmax=8)
        want = golden(corpus.labels, corpus.data_attrs, q, ks)
        out = [_query(router.port, q, ks, str(i)) for i in range(6)]
        assert all(r["ok"] and r["checksums"] == want for r in out), out
        assert crasher.queries_seen >= 1
        assert any(r.get("hops", 0) >= 2 for r in out)
        assert all(r["hops"] >= 2 for r in out if "hops" in r)
        st = router.stats()
        crashed = next(rep for rep in st["replicas"]
                       if rep["replica"].endswith(str(crasher.port)))
        assert not crashed["healthy"]
        assert sum(st["retries"].values()) >= 1
    finally:
        router.close()
        d1.close()
        crasher.close()


def test_router_drain_racing_query_wave():
    corpus = _corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    d2 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    router = FleetRouter([("127.0.0.1", d1.port), ("127.0.0.1", d2.port)],
                         port=0, health_interval_s=0.05)
    router.start()
    try:
        q, ks = batch(5, 2, 71, kmax=8)
        want = golden(corpus.labels, corpus.data_attrs, q, ks)
        out = [None] * 12

        def worker(i):
            out[i] = _query(router.port, q, ks, str(i))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads[:4]:
            t.start()
        cli = sc.ServeClient(d1.port)
        cli.drain()
        cli.close()
        for t in threads[4:]:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None and r["ok"] for r in out), out
        assert all(r["checksums"] == want for r in out)
    finally:
        router.close()
        d1.close()
        d2.close()


def test_router_propagates_admission_shed_unretried():
    corpus = _corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 4)], max_k=4)
    d2 = _start_daemon(corpus, warm_buckets=[(2, 4)], max_k=4)
    router = FleetRouter([("127.0.0.1", d1.port), ("127.0.0.1", d2.port)],
                         port=0)
    router.start()
    try:
        q, _ = batch(5, 2, 81, kmax=4)
        r = _query(router.port, q, [9, 9])
        assert not r["ok"] and "rejected" in r["error"] \
            and "k_too_large" in r["error"]
        st = router.stats()
        assert sum(st["retries"].values()) == 0
        assert st["rejected"].get("admission", 0) >= 1
        assert _query(router.port, q, [3, 3])["ok"]
    finally:
        router.close()
        d1.close()
        d2.close()


def test_router_ingest_fans_out_to_every_replica():
    corpus = _corpus()
    d1 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    d2 = _start_daemon(corpus, warm_buckets=[(2, 8)])
    router = FleetRouter([("127.0.0.1", d1.port), ("127.0.0.1", d2.port)],
                         port=0)
    router.start()
    try:
        rng = np.random.default_rng(13)
        newl = rng.integers(0, 4, 5).astype(np.int32)
        newa = rng.uniform(0, 50, (5, 5))
        cli = sc.ServeClient(router.port)
        r = cli.ingest([int(v) for v in newl], newa)
        cli.close()
        assert r["ok"] and r["corpus_rows"] == 605
        assert d1.engine.n_real == d2.engine.n_real == 605
        assert d1.engine.corpus_state() == d2.engine.corpus_state()
        q, ks = batch(5, 2, 91, kmax=8)
        want = golden(np.concatenate([corpus.labels, newl]),
                      np.vstack([corpus.data_attrs, newa]), q, ks)
        for i in range(4):
            got = _query(router.port, q, ks, str(i))
            assert got["ok"] and got["checksums"] == want
    finally:
        router.close()
        d1.close()
        d2.close()


# -- open-loop load ------------------------------------------------------------

def _header(corpus):
    return {"serve_trace_schema": 1, "corpus": {
        "num_data": corpus.params.num_data,
        "num_attrs": corpus.params.num_attrs, "min_attr": 0.0,
        "max_attr": 50.0, "num_labels": 4}}


def test_open_loop_replay_fires_on_schedule():
    corpus = _corpus()
    d = _start_daemon(corpus, warm_buckets=[(2, 8), (1, 8)])
    try:
        header = _header(corpus)
        reqs = [{"t_ms": i * 40, "nq": 1 + (i % 2), "k": 5,
                 "seed": 500 + i} for i in range(6)]
        t0 = time.monotonic()
        res = sc.replay_open_loop(d.port, header, reqs, speed=1.0)
        assert time.monotonic() - t0 >= 0.2
        assert all(r.get("ok") and "client_ms" in r and "lag_ms" in r
                   for r in res), res
        assert [r["checksums"] for r in res] == \
            sc.golden_reference(corpus, header, reqs)
    finally:
        d.close()


def test_load_levels_emit_fleet_records(tmp_path):
    """One RunRecord per level (kind "fleet", the level tag and offered
    load in it, per-rep quantiles with reps >= 2), appended and read back;
    the ledger that keys them into series is not ported yet."""
    corpus = _corpus()
    d = _start_daemon(corpus, warm_buckets=[(2, 8), (1, 8)])
    try:
        reqs = [{"t_ms": i * 20, "nq": 1, "k": 5, "seed": 600 + i}
                for i in range(5)]
        recs = loadgen.run_levels(d.port, _header(corpus), reqs,
                                  speeds=[4.0, 2.0], reps=2, replicas=1,
                                  trace="unit")
        assert [r.config["level"] for r in recs] == ["x2", "x4"]
        path = tmp_path / "fleet.jsonl"
        for rec in recs:
            assert rec.kind == "fleet" and rec.metrics["errors"] == 0
            assert rec.metrics["p99_ms"] > 0
            assert len(rec.metrics["p99_ms_reps"]) == 2
            assert rec.metrics["offered_qps"] == \
                loadgen.offered_qps(reqs, rec.config["speed"])
            rec.append_jsonl(str(path))
        back = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert [b["config"]["level"] for b in back] == ["x2", "x4"]
        assert back[0]["device"] == "cpu"
    finally:
        d.close()


# -- entry points in fresh interpreters ----------------------------------------

def _corpus_file(tmp_path, n=3000, na=8, nq=4):
    rng = np.random.default_rng(3)
    text = format_input(KNNInput(
        Params(n, nq, na), rng.integers(0, 5, n).astype(np.int32),
        rng.uniform(0, 100, (n, na)), rng.integers(1, 8, nq).astype(
            np.int32), rng.uniform(0, 100, (nq, na))))
    path = tmp_path / "corpus.txt"
    path.write_text(text)
    return path, text


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return env


def test_mesh_merge_auto_raises_and_names_its_item(tmp_path):
    """``--mesh-merge auto`` is ported (the "gspmd" merge): a mesh replica
    started with it in a fresh interpreter (2 gloo ranks) reports the
    engine-internal "gspmd", answers a request with golden's checksums and
    drains with exit code 0; an unknown strategy still raises, naming
    itself."""
    from dmlp_tpu_torch.fleet import harness as fh
    from dmlp_tpu_torch.fleet.mesh_engine import check_merge
    from dmlp_tpu_torch.io.grammar import parse_input_text
    assert check_merge("auto") == "gspmd"
    corpus, text = _corpus_file(tmp_path, n=300, na=5)
    p = subprocess.run(
        [sys.executable, "-m", "dmlp_tpu_torch.serve", "--corpus",
         str(corpus), "--device", "cpu", "--mesh", "2x1", "--mesh-merge",
         "bogus"], cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0 and "bogus" in p.stderr
    fp = fh.spawn_replica(str(corpus), str(tmp_path), "auto", "4x8",
                          flags=["--device", "cpu", "--mesh", "2x1",
                                 "--mesh-merge", "auto", "--backend",
                                 "gloo"],
                          env_extra={"OMP_NUM_THREADS": "1"})
    try:
        ready = fh.await_replica(fp, timeout_s=240)
        assert ready["merge"] == "gspmd" and ready["mesh"] == [2, 1]
        parsed = parse_input_text(text)
        q, ks = batch(5, 4, 61, kmax=8)
        r = _query(ready["port"], q, ks)
        assert r["ok"] and r["checksums"] == golden(
            parsed.labels, parsed.data_attrs, q, ks), r
        cli = sc.ServeClient(ready["port"])
        cli.drain()
        cli.close()
        assert fp.proc.wait(timeout=120) == 0
    finally:
        fh.kill_all([fp])


def test_replica_spec_passes_the_mesh_to_the_daemon_and_no_xla_flags(
        monkeypatch):
    """The counterpart of the reference's XLA device-count setting: the
    spawned daemon gets ``--mesh RxC --backend gloo`` (it starts its R·C
    ranks from them) and an environment with no compiler flag."""
    seen = {}

    def fake_spawn(corpus, out_dir, name, warm, batch_cap, flags,
                   env_extra):
        seen.update(flags=flags, env=env_extra)
        return name

    monkeypatch.setattr(autoscale.fh, "spawn_replica", fake_spawn)
    spec = autoscale.ReplicaSpec("c.in", ".", flags=[
        "--device", "cpu", "--mesh", "2x2", "--backend", "gloo"],
        env_extra={"OMP_NUM_THREADS": "1"})
    assert spec.spawn("r0", capacity=512) == "r0"
    assert seen["flags"] == ["--device", "cpu", "--mesh", "2x2",
                             "--backend", "gloo", "--capacity", "512"]
    assert seen["env"] == {"OMP_NUM_THREADS": "1"}
    autoscale.ReplicaSpec("c.in", ".").spawn("r1")
    assert seen["flags"] == [] and "XLA_FLAGS" not in seen["env"]
