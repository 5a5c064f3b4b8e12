"""The port's compiler-sharded engine (``engine.auto.AutoShardedEngine``;
gloo ranks on the CPU) against the reference's on the conftest's 8 virtual
devices, and the "gspmd" merge it shares with the fleet's mesh engine.

The cases mirror ``tests/test_auto.py``: seeds 611-618 at (4, 2); one
input at every mesh shape, (1, 1) included; the k-boundary tie grid; a
``data_block`` that gives several blocks per shard; the bf16 first pass
(``DMLP_TPU_PRECISION=bf16``); a banded corpus whose far band prunes, with
pruning on and off; fast mode; and inputs that take the "seg" fold, whose
step is K3 under ``--pallas``. Each runs without and with ``use_pallas``
(the reference's K3 in Pallas interpret mode, the port's plain version on
the CPU). Both packages parse the same text. Tolerances: stdout (the
checksums and the ``--debug`` listing) byte-identical to the reference
engine's, to the golden oracle's and to the port's own sharded engine's;
the prune accounting equal; on integer attributes the candidate distances
equal and the candidate ids equal outside each row's last tie group; the
gspmd merge's lists bit for bit equal to ``allgather_merge_topk``'s on the
same seeded lists.

The port's ranks are spawned once per rank count for the module (8 ranks
run the four 8-rank meshes in turn, 1 rank the (1, 1) mesh, 2 ranks the
fleet's mesh engine at (2, 1) and (1, 2)), every process group with a
60 s timeout and every subprocess waited on with a deadline.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from dmlp_tpu.config import EngineConfig as RefConfig  # noqa: E402
from dmlp_tpu.engine.auto import AutoShardedEngine as RefAuto  # noqa: E402
from dmlp_tpu.fleet.mesh_engine import \
    MeshResidentEngine as RefMesh  # noqa: E402
from dmlp_tpu.golden.reference import knn_golden  # noqa: E402
from dmlp_tpu.io.grammar import KNNInput, Params  # noqa: E402
from dmlp_tpu.io.grammar import format_input, parse_input_text  # noqa: E402
from dmlp_tpu.io.report import format_results  # noqa: E402
from dmlp_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402
from dmlp_tpu_torch.obs import memwatch  # noqa: E402
from dmlp_tpu_torch.obs.comms import engine_comms  # noqa: E402

from test_torch_mesh import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES8 = [(4, 2), (2, 4), (8, 1), (1, 8)]
ALL_SHAPES = SHAPES8 + [(1, 1)]


def _case(seed: int, kmax: int = 48) -> KNNInput:
    """The reference test's duplicate-biased corpora straddling block
    granules, k pushed to the cap boundary."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(120, 700))
    nq = int(rng.integers(1, 32))
    na = int(rng.integers(1, 9))
    if rng.random() < 0.5:   # integer grid: exact f32 and many ties
        data = rng.integers(0, 3, (n, na)).astype(np.float64)
        queries = rng.integers(0, 3, (nq, na)).astype(np.float64)
    else:
        data = rng.uniform(-20, 20, (n, na))
        queries = rng.uniform(-20, 20, (nq, na))
    labels = rng.integers(0, 5, n).astype(np.int32)
    ks = rng.integers(1, min(n, kmax) + 1, nq).astype(np.int32)
    return KNNInput(Params(n, nq, na), labels, data, ks, queries)


def _tie_grid() -> KNNInput:
    """k == 1, k == n, and a duplicate group astride the shard edge."""
    rng = np.random.default_rng(91)
    n, na = 264, 3
    data = rng.integers(0, 2, (n, na)).astype(np.float64)
    data[128:144] = data[0]
    queries = data[[0, 5, 130, 263]].copy()
    ks = np.array([1, n, 48, 7], np.int32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    return KNNInput(Params(n, 4, na), labels, data, ks, queries)


def _banded() -> KNNInput:
    """A clustered corpus with a far band: whole blocks prunable."""
    rng = np.random.default_rng(55)
    n, nq, na = 4096, 6, 3
    data = rng.uniform(0, 1, (n, na))
    data[3584:] += 500.0
    return KNNInput(Params(n, nq, na),
                    rng.integers(0, 4, n).astype(np.int32), data,
                    rng.integers(1, 6, nq).astype(np.int32),
                    rng.uniform(0, 1, (nq, na)))


def _grid(n, nq, na, seed, hi=3, kmax=12) -> KNNInput:
    """Integer attributes (exact float32 distances, many ties)."""
    rng = np.random.default_rng(seed)
    return KNNInput(Params(n, nq, na),
                    rng.integers(0, 4, n).astype(np.int32),
                    rng.integers(0, hi, (n, na)).astype(np.float64),
                    rng.integers(1, kmax + 1, nq).astype(np.int32),
                    rng.integers(0, hi, (nq, na)).astype(np.float64))


# name: (input, config, shapes, environment, extra). Extra: "candidates"
# compares the dense candidate lists, "prune" the prune accounting.
CASES = {
    **{f"seed{s}": (lambda s=s: _case(s), {}, [(4, 2)], {}, ())
       for s in range(611, 619)},
    "mesh733": (lambda: _case(733), {}, ALL_SHAPES, {}, ()),
    "tie_grid": (_tie_grid, {}, [(4, 2)], {}, ("candidates",)),
    "data_block": (lambda: _case(645), {"data_block": 64}, [(4, 2)], {},
                   ()),
    "bf16": (lambda: _case(821), {}, [(4, 2)],
             {"DMLP_TPU_PRECISION": "bf16"}, ()),
    "prune_on": (_banded, {"data_block": 512}, [(4, 2)],
                 {"DMLP_TPU_PRUNE": "1"}, ("prune",)),
    "prune_off": (_banded, {"data_block": 512}, [(4, 2)],
                  {"DMLP_TPU_PRUNE": "0"}, ("prune",)),
    "fast": (lambda: _grid(300, 5, 4, 71), {"exact": False}, [(4, 2)], {},
             ()),
    # The "seg" fold: whole 1,024-row blocks (K3's granule), several per
    # shard with the data_block.
    "seg": (lambda: _grid(5000, 9, 4, 5), {"select": "seg"},
            [(4, 2), (1, 1)], {}, ("candidates",)),
    "seg_blocks": (lambda: _grid(9000, 7, 3, 6), {"select": "seg",
                                                  "data_block": 1024},
                   [(2, 4)], {}, ("candidates",)),
    # Above the 8,192-row select threshold: the select itself streams
    # with "seg" under --pallas (the chip runs' path).
    "threshold": (lambda: _grid(9000, 8, 3, 8, hi=40), {}, [(1, 1)], {},
                  ()),
}
PALLAS = (False, True)

RANK_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.auto import AutoShardedEngine
from dmlp_tpu_torch.engine.sharded import ShardedEngine
from dmlp_tpu_torch.io.grammar import parse_input_text
from dmlp_tpu_torch.io.report import format_results
from dmlp_tpu_torch.obs import memwatch
from dmlp_tpu_torch.ops.topk import TopK
from dmlp_tpu_torch.parallel import collectives as coll
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.parallel.mesh import make_mesh, mesh_coords

work = sys.argv[1]
spec = json.load(open(work + "/cases.json"))
initialize(auto=True, device="cpu", timeout_s=60)
rank = dist.get_rank()
root = rank == 0
out = {}


def raises(fn):
    try:
        fn()
    except Exception as e:
        return [type(e).__name__, str(e)]
    return None


for shape in spec["shapes"]:
    shape = tuple(shape)
    key = f"{shape[0]}x{shape[1]}"
    mesh = make_mesh(shape)
    for case in spec["cases"]:
        if list(shape) not in case["shapes"]:
            continue
        inp = parse_input_text(open(case["input"]).read()) if root else None
        for pallas in (False, True):
            os.environ.update(case["env"])
            try:
                cfg = dict(case["config"], use_pallas=pallas, device="cpu")
                eng = AutoShardedEngine(EngineConfig(
                    mode="auto", mesh_shape=shape, **cfg), mesh=mesh)
                res = eng.run(inp)
                rec = {"select": eng._last_select, "prune": eng.last_prune,
                       "precision": eng.last_precision,
                       "comms": [t.to_dict() for t in eng.last_comms],
                       "from_hlo": eng.comms_from_hlo() is None,
                       "plan": eng.last_plan, "hetk": eng.last_hetk,
                       "phases": sorted(eng.last_phase_ms)}
                if root:
                    rec.update(stdout=format_results(res),
                               debug=format_results(res, debug=True),
                               mem_mode=memwatch.model_for_engine(
                                   eng, inp)["mode"])
                if "candidates" in case["extra"]:
                    cand = eng.candidates(inp)
                    if root:
                        rec["cand"] = [cand[0].tolist(), cand[2].tolist()]
                sh = ShardedEngine(EngineConfig(
                    mode="sharded", mesh_shape=shape, **cfg), mesh=mesh)
                res = sh.run(inp)
                if root:
                    rec["sharded_stdout"] = format_results(res)
            finally:
                for k in case["env"]:
                    os.environ.pop(k, None)
            out[f"{key}/{case['name']}/{int(pallas)}"] = rec
    # The gspmd merge against the all-gather merge on seeded lists.
    rr, cc = mesh_coords(mesh)
    rng = np.random.default_rng(100 * rr + cc)
    q, k = 6, 8
    d = rng.integers(0, 5, (q, k)).astype(np.float32)
    lab = rng.integers(0, 3, (q, k)).astype(np.int32)
    ids = np.stack([rng.permutation(k) + 100 * rr for _ in range(q)])
    sent = rng.random((q, k)) < 0.2
    d[sent], lab[sent] = np.inf, -1
    ids = np.where(sent, -1, ids).astype(np.int32)
    top = TopK(*(torch.from_numpy(x) for x in (d, lab, ids)))
    a = coll.gspmd_merge_topk(top, k, mesh)
    b = coll.allgather_merge_topk(top, k, mesh.get_group("data"))
    same = bool(torch.equal(a.dists.view(torch.int32),
                            b.dists.view(torch.int32))
                and torch.equal(a.labels, b.labels)
                and torch.equal(a.ids, b.ids))
    every = [None] * dist.get_world_size() if root else None
    dist.gather_object(same, every, dst=0)
    out[f"{key}/merge_equal"] = every
# The contract: named dimensions, and no multi-host path.
world = dist.get_world_size()
bare = init_device_mesh("cpu", (world, 1))
out["unnamed"] = raises(lambda: AutoShardedEngine(
    EngineConfig(mode="auto", device="cpu"), mesh=bare))
eng = AutoShardedEngine(EngineConfig(mode="auto", device="cpu"),
                        mesh=make_mesh((world, 1)))
out["solve_global"] = raises(lambda: eng.solve_global(None, None, None,
                                                      None, 5))
out["solve_local_shards"] = raises(lambda: eng.solve_local_shards(
    None, None, None, None, 5))
if root:
    json.dump(out, open(work + f"/out{world}.json", "w"))
shutdown()
"""


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def texts():
    return {name: format_input(case[0]()) for name, case in CASES.items()}


@pytest.fixture(scope="module")
def port_runs(texts, tmp_path_factory):
    """Every (shape, case, pallas) record of the port: one spawn of 8
    ranks for the 8-rank meshes and one of a single rank for (1, 1)."""
    work = tmp_path_factory.mktemp("auto")
    cases = []
    for name, (_, cfg, shapes, env, extra) in CASES.items():
        path = work / f"{name}.in"
        path.write_text(texts[name])
        cases.append({"name": name, "input": str(path), "config": cfg,
                      "shapes": [list(s) for s in shapes], "env": env,
                      "extra": list(extra)})
    out = {}
    for world, shapes in ((8, SHAPES8), (1, [(1, 1)])):
        (work / "cases.json").write_text(json.dumps(
            {"shapes": shapes, "cases": cases}))
        spawn_ranks(work, RANK_SCRIPT, world, timeout=600)
        out[world] = json.loads((work / f"out{world}.json").read_text())
    return out


class _env:
    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def reference(texts):
    """The reference's auto engine of a (shape, case, pallas), its input
    and results, solved once."""
    cache = {}

    def get(shape, name, pallas):
        if (shape, name, pallas) not in cache:
            _, cfg, _, env, _ = CASES[name]
            eng = RefAuto(RefConfig(mode="auto", use_pallas=pallas, **cfg),
                          mesh=ref_make_mesh(shape, devices=jax.devices()[
                              :shape[0] * shape[1]]))
            inp = parse_input_text(texts[name])
            with _env(env):
                res = eng.run(inp)
            cache[shape, name, pallas] = (eng, inp, res)
        return cache[shape, name, pallas]
    return get


def _rec(port_runs, shape, name, pallas):
    world = shape[0] * shape[1]
    return port_runs[world][f"{_key(shape)}/{name}/{int(pallas)}"]


PARAMS = [pytest.param(shape, name, pallas,
                       id=f"{_key(shape)}-{name}-{'pallas' if pallas else 'plain'}")
          for name, case in CASES.items() for shape in case[2]
          for pallas in PALLAS]


@pytest.mark.parametrize("shape,name,pallas", PARAMS)
def test_stdout_matches_reference_golden_and_sharded(port_runs, reference,
                                                     shape, name, pallas):
    """Byte-identical stdout (checksums and --debug) to the reference's
    auto engine, the golden oracle and the port's own sharded engine; the
    same select; no router split; no analytic comms record."""
    rec = _rec(port_runs, shape, name, pallas)
    ref, inp, want = reference(shape, name, pallas)
    assert rec["stdout"] == format_results(want)
    assert rec["debug"] == format_results(want, debug=True)
    assert rec["stdout"] == format_results(knn_golden(inp))
    assert rec["sharded_stdout"] == rec["stdout"]
    assert rec["select"] == ref._last_select
    assert rec["hetk"] is None
    assert rec["comms"] == [] and rec["from_hlo"]


@pytest.mark.parametrize("pallas", PALLAS, ids=["plain", "pallas"])
def test_seg_fold_and_k3_path(port_runs, pallas):
    """The "seg" cases fold with "seg" (K3 under --pallas) in whole
    1,024-row blocks; seg_blocks takes several blocks per shard; above
    the 8,192-row threshold --pallas picks "seg" itself."""
    rec = _rec(port_runs, (4, 2), "seg", pallas)
    assert rec["select"] == "seg"
    assert rec["plan"]["data_block"] % (1024 if pallas else 128) == 0
    rec = _rec(port_runs, (2, 4), "seg_blocks", pallas)
    assert rec["plan"]["shard_rows"] // rec["plan"]["data_block"] == 5
    rec = _rec(port_runs, (1, 1), "threshold", pallas)
    assert rec["select"] == ("seg" if pallas else "topk")


@pytest.mark.parametrize("name,shape", [("tie_grid", (4, 2)),
                                        ("seg", (4, 2)), ("seg", (1, 1)),
                                        ("seg_blocks", (2, 4))])
@pytest.mark.parametrize("pallas", PALLAS, ids=["plain", "pallas"])
def test_candidates_match_reference(port_runs, reference, name, shape,
                                    pallas):
    """On integer attributes the dense candidate distances equal the
    reference's exactly, and the ids outside each row's last tie group
    (where the two packages may keep different members)."""
    ref, inp, _ = reference(shape, name, pallas)
    d, _lab, ids = ref._candidates(inp)
    got_d, got_ids = (np.asarray(x) for x in
                      _rec(port_runs, shape, name, pallas)["cand"])
    assert np.array_equal(got_d, d)
    inner = d < d[:, -1:]
    assert np.array_equal(got_ids[inner], ids[inner])


@pytest.mark.parametrize("pallas", PALLAS, ids=["plain", "pallas"])
def test_bf16_first_pass_and_prune_composition(port_runs, reference,
                                               pallas):
    """The bf16 first pass is active (bf16 staging) as in the reference;
    the banded corpus prunes the same blocks with the same scanned bytes
    as the reference, and scans dense with pruning off."""
    shape = (4, 2)
    rec = _rec(port_runs, shape, "bf16", pallas)
    ref = reference(shape, "bf16", pallas)[0]
    assert rec["precision"] == ref.last_precision
    assert rec["precision"]["active"] == "bf16"
    keys = ("blocks_total", "blocks_pruned", "scanned_bytes", "dense_bytes")
    for name in ("prune_on", "prune_off"):
        got = _rec(port_runs, shape, name, pallas)["prune"]
        want = reference(shape, name, pallas)[0].last_prune
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    on = _rec(port_runs, shape, "prune_on", pallas)["prune"]
    off = _rec(port_runs, shape, "prune_off", pallas)["prune"]
    assert off["blocks_pruned"] == 0 < on["blocks_pruned"]
    assert on["scanned_bytes"] < off["dense_bytes"]


@pytest.mark.parametrize("shape", SHAPES8, ids=_key)
def test_gspmd_merge_equals_allgather_merge_bit_for_bit(port_runs, shape):
    """Every rank's gspmd-merged lists (a DTensor redistribution) equal the
    all-gather merge's on the same seeded lists: distances as bits,
    labels, ids. Tolerance: none."""
    assert port_runs[8][f"{_key(shape)}/merge_equal"] == [True] * 8


def test_no_analytic_comms_and_memory_model_prices_allgather(port_runs):
    """``engine_comms("gspmd", ...)`` is an explicit empty list; a solve
    leaves ``last_comms == []`` and ``comms_from_hlo()`` None (nothing
    recorded); the memory model names the engine's own mode and prices
    the all-gather's merge buffer, the worst case."""
    assert engine_comms("gspmd", (4, 2), 8, 5) == []
    rec = _rec(port_runs, (4, 2), "mesh733", False)
    assert rec["comms"] == [] and rec["from_hlo"]
    assert rec["mem_mode"] == "auto"
    kw = dict(mesh_shape=(4, 2), shard_rows=256, na=8, qloc=64, kcap=32)
    auto_m = memwatch.fleet_engine_model(merge="gspmd", **kw)
    ag_m = memwatch.fleet_engine_model(merge="allgather", **kw)
    ring_m = memwatch.fleet_engine_model(merge="ring", **kw)
    assert auto_m["total_bytes"] == ag_m["total_bytes"] \
        >= ring_m["total_bytes"]
    m = memwatch.mesh_engine_model(3000, 40, 8, 16, (4, 2), mode="auto")
    assert m["path"] == "merged"
    assert m["terms"]["merge_buffer"] == 4 * m["q_local"] * m["kcap"] * 12
    assert memwatch.resident_bytes_model(
        "auto", n=3000, nq=40, na=8, kmax=16,
        mesh_shape=(4, 2))["total_bytes"] == m["total_bytes"]


def test_mesh_without_named_dims_rejected_and_no_multi_host(port_runs):
    for world in (8, 1):
        out = port_runs[world]
        assert out["unnamed"][0] == "ValueError"
        assert "must declare axes" in out["unnamed"][1]
        for call in ("solve_global", "solve_local_shards"):
            assert out[call][0] == "NotImplementedError"
            assert "multi-host" in out[call][1]


def test_reference_rejects_the_same_mesh():
    """The reference's own refusal, for the record beside the port's."""
    devs = np.array(jax.devices()[:2]).reshape(2, 1)
    with pytest.raises(ValueError, match="must declare axes"):
        RefAuto(RefConfig(mode="auto"), mesh=Mesh(devs, ("rows", "cols")))


# -- the fleet's mesh engine with merge="auto" ---------------------------------

FLEET_SCRIPT = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.fleet.mesh_engine import MeshResidentEngine
from dmlp_tpu_torch.io.grammar import KNNInput, Params
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.parallel.mesh import make_mesh

work = sys.argv[1]
data = np.load(work + "/fleet.npz")
initialize(auto=True, device="cpu", timeout_s=60)
root = dist.get_rank() == 0
out = {}
for shape in ((2, 1), (1, 2)):
    mesh = make_mesh(shape)
    for name, cfg in json.load(open(work + "/fleet.json")).items():
        lab, att = data["labels"], data["attrs"]
        corpus = KNNInput(Params(len(lab), 0, att.shape[1]), lab, att,
                          np.zeros(0, np.int32), np.zeros((0, 5)))
        eng = MeshResidentEngine(corpus if root else None,
                                 EngineConfig(mode="sharded", device="cpu",
                                              **cfg),
                                 mesh=mesh, merge="auto")
        if not root:
            eng.serve_worker()
            continue
        res = eng.solve_batch(data["q"], data["ks"])
        st = eng.bucket_stats()
        out[f"{shape[0]}x{shape[1]}/{name}"] = {
            "checksums": [int(r.checksum()) for r in res],
            "merge": st["merge"], "path": eng.batch_log[-1]["path"],
            "comms": [t.to_dict() for t in eng.last_comms]}
        eng.close()
if root:
    json.dump(out, open(work + "/fleet_out.json", "w"))
shutdown()
"""

FLEET_CASES = {"plain": {},
               "pallas": {"select": "extract", "use_pallas": True,
                          "data_block": 256}}


def _fleet_data():
    rng = np.random.default_rng(17)
    n, na = 600, 5
    return {"labels": rng.integers(0, 4, n).astype(np.int32),
            "attrs": rng.uniform(0, 50, (n, na)),
            "q": rng.uniform(0, 50, (7, na)),
            "ks": np.array([1, 3, 8, 12, 5, 2, 7], np.int32)}


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("fleet_auto")
    np.savez(work / "fleet.npz", **_fleet_data())
    (work / "fleet.json").write_text(json.dumps(FLEET_CASES))
    spawn_ranks(work, FLEET_SCRIPT, 2, timeout=300)
    return json.loads((work / "fleet_out.json").read_text())


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=_key)
@pytest.mark.parametrize("name", list(FLEET_CASES))
def test_fleet_mesh_engine_auto_merge(fleet_runs, shape, name):
    """``MeshResidentEngine(merge="auto")``: the engine-internal "gspmd"
    merge after the fold (the stream path, or K1's plain version on the
    extract path), checksums equal to the reference's ``merge="auto"``
    engine and to golden's, no analytic merge record."""
    d = _fleet_data()
    rec = fleet_runs[f"{_key(shape)}/{name}"]
    n, na = d["attrs"].shape
    corpus = KNNInput(Params(n, 0, na), d["labels"], d["attrs"],
                      np.zeros(0, np.int32), np.zeros((0, na)))
    ref = RefMesh(corpus, RefConfig(**FLEET_CASES[name]), mesh_shape=shape,
                  merge="auto")
    want = [r.checksum() for r in ref.solve_batch(d["q"], d["ks"])]
    inp = KNNInput(Params(n, len(d["ks"]), na), d["labels"], d["attrs"],
                   d["ks"], d["q"])
    assert rec["checksums"] == want == [r.checksum()
                                        for r in knn_golden(inp)]
    assert rec["merge"] == ref.bucket_stats()["merge"] == "gspmd"
    assert rec["path"] == ("extract" if name == "pallas" else "stream")
    assert not any(c["collective"].endswith("merge_topk")
                   for c in rec["comms"])


# -- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--mode", "auto", "--pallas"],
                                   ["--engine", "auto"]],
                         ids=["mode-auto-pallas", "engine-auto"])
def test_cli_auto_stdout_matches_reference_and_golden(tmp_path, flags):
    """``python -m dmlp_tpu_torch --device cpu --mesh 2,2`` with ``--mode
    auto --pallas`` or ``--engine auto`` in a fresh interpreter (4 gloo
    ranks): stdout byte-identical to the reference's auto engine and to
    golden, the ``Time taken`` line on stderr."""
    inp = _grid(5000, 9, 4, 12)
    text = format_input(inp)
    path = tmp_path / "in.txt"
    path.write_text(text)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    with open(path) as f:
        p = subprocess.run(
            [sys.executable, "-m", "dmlp_tpu_torch", "--device", "cpu",
             "--mesh", "2,2", *flags], stdin=f, capture_output=True,
            text=True, cwd=ROOT, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    pallas = "--pallas" in flags
    ref = RefAuto(RefConfig(mode="auto", use_pallas=pallas),
                  mesh=ref_make_mesh((2, 2), devices=jax.devices()[:4]))
    parsed = parse_input_text(text)
    assert p.stdout == format_results(ref.run(parsed)) \
        == format_results(knn_golden(parsed))
    assert "Time taken: " in p.stderr
