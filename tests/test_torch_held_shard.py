"""The mesh engine's held-shard solve (``ShardedEngine.hold_shard`` and
``run_device_full`` on a ``QueryBatch``) on the CPU over gloo: four ranks,
each holding its own 10,000 x 128 uint8 shard of a 40,000-row corpus drawn
block by block from seeds (``benchmark/shardgen.py``), 64 queries.

uint8 queries (and float queries whose values are integers in 0..255) take
the integer route: the queries travel as uint8 and K1 (its plain version
here) takes each held chunk as it lies, counted as ``fused_topk_u8``, with
no byte cast; a query with any other value takes the cast route, each
chunk cast into float32 for the FMA kernel. Both routes give the same
answers.

Every value is an integer, so every float32 distance is exact: the held
solve's ids, distances and votes equal the blocked, sharded float64
reference (``benchmark/reference/sharded.py``, which draws the blocks again
and never reads the program's tensor) and the scatter path's
(``run_device_full`` on the same rows as a float64 ``KNNInput``) entry for
entry. The solve is one linked span tree whose counts are the byte
arithmetic of its queries and its shard; it issues no row scatter; its
memory model prices the held shard; a bad layout, the exact path and an
input other than a ``QueryBatch`` raise on every rank."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine import sharded as sharded_mod
from dmlp_tpu_torch.obs import comms, memwatch
from dmlp_tpu_torch.obs import trace as obs_trace
from dmlp_tpu_torch.parallel.distributed import free_port

ROOT = Path(__file__).resolve().parents[1]
WORLD, N, NA, NQ, KMAX, SEED = 4, 40000, 128, 64, 12, 2**40 + 25
# Chunks of 2,560 rows over a 10,000-row shard: the last holds 2,320
# real rows, its tail the previous chunk's; blocks of 3,000 rows, so the
# generator's blocks and the engine's chunks do not line up.
BLOCK, GEN_BLOCK = 2560, 3000
CHILDREN_ROOT = {"sharded.stage_queries", "sharded.enqueue_chunked",
                 "sharded.merge", "sharded.gather", "sharded.epilogue",
                 "sharded.fetch", "sharded.finalize"}

RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from benchmark import shardgen
from benchmark.reference import knn as ref
from benchmark.reference import sharded as ref_sharded
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.sharded import ShardedEngine
from dmlp_tpu_torch.io.grammar import KNNInput, Params, QueryBatch
from dmlp_tpu_torch.engine import sharded as sharded_mod
from dmlp_tpu_torch.obs import counters as obs_counters
from dmlp_tpu_torch.obs import trace as obs_trace
from dmlp_tpu_torch.parallel.collectives import gather_objects
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown

work, spec = sys.argv[1], json.loads(sys.argv[2])
world, n, na, nq, kmax, seed = (spec[k] for k in
                                ("world", "n", "na", "nq", "kmax", "seed"))
cfg = {"num_data": n, "num_attrs": na, "num_queries": nq, "num_labels": 10}
initialize(auto=True, device="cpu", timeout_s=60)
rank = dist.get_rank()
root = rank == 0
conf = EngineConfig(mode="sharded", mesh_shape=(world, 1), device="cpu",
                    use_pallas=True, data_block=spec["block"])
out = {}
eng = ShardedEngine(conf)
rr = eng.coords[0]
attrs, labels = shardgen.draw_shard(cfg, seed, rr, world, spec["gen_block"],
                                    "cpu")
# A layout that does not tile the corpus raises on every rank.
try:
    eng.hold_shard(attrs, labels, n - 1)
    out["bad_layout"] = None
except ValueError as e:
    out["bad_layout"] = str(e)
eng.hold_shard(attrs, labels, n)
qall = shardgen.queries(cfg, seed)
ks = (1 + np.arange(nq) % kmax).astype(np.int32)
qb = QueryBatch(ks=ks, query_attrs=qall) if root else None

def routed(batch):
    # One traced and probed solve: its results, K1's dispatches by kernel
    # name, and the root span's byte counts.
    tr = obs_trace.install(obs_trace.Tracer())
    probe = obs_counters.install(obs_counters.CostProbe())
    try:
        res = eng.run_device_full(batch)
    finally:
        obs_counters.uninstall()
        obs_trace.uninstall()
    per = probe.collect().get("per_kernel", {})
    root_args = next(e for e in tr.events() if e["ph"] == "X" and
                     e["name"] == "sharded.held_device_full")["args"]
    return res, tr, {"dispatches": {k: v["dispatches"]
                                    for k, v in per.items()},
                     "bytes": {k: root_args.get(k, 0) for k in
                               ("h2d_bytes", "cast_bytes", "pad_bytes")}}


held, tracer, out["integer"] = routed(qb)
out["phases"] = sorted(eng.last_phase_ms)
out["comms"] = [t.to_dict() for t in eng.last_comms]
# The same queries forced onto the cast route (the route is the plan's,
# made on rank 0), float32 queries of integer values, and float32 queries
# with a fractional value.
real_integer_queries = sharded_mod.integer_queries
sharded_mod.integer_queries = lambda q: False
try:
    cast, _, out["cast"] = routed(qb)
finally:
    sharded_mod.integer_queries = real_integer_queries
qf = qall.astype(np.float32)
qfrac = qf.copy()
qfrac[3, 7] += 0.5
f32int, _, out["f32_integers"] = routed(
    QueryBatch(ks=ks, query_attrs=qf) if root else None)
_, _, out["f32_fraction"] = routed(
    QueryBatch(ks=ks, query_attrs=qfrac) if root else None)
out["shard_rows"] = eng.held.shard_rows
try:
    eng.run(None)
    out["exact_raises"] = None
except RuntimeError as e:
    out["exact_raises"] = str(e)
try:
    eng.run_device_full(KNNInput(Params(1, 1, na), np.zeros(1, np.int32),
                                 np.zeros((1, na)), np.ones(1, np.int32),
                                 np.zeros((1, na))) if root else None)
    out["wrong_input"] = None
except ValueError as e:
    out["wrong_input"] = str(e)

# The reference: every rank draws its blocks again.
lo, hi = shardgen.shard_span(cfg, world, rr)
q64 = torch.from_numpy(qall).double()
blocks = ((lo + a, shardgen.draw_block(cfg, seed, rr, b, z - a, "cpu")[0])
          for b, a, z in shardgen.blocks(hi - lo, spec["gen_block"]))
rd, ri = ref_sharded.merge_ranks(*ref_sharded.shard_knn(q64, blocks, kmax),
                                 kmax)

# The scatter path on the same rows, every shard drawn again on rank 0.
inp = None
if root:
    parts = [shardgen.draw_shard(cfg, seed, s, world, spec["gen_block"], "cpu")
             for s in range(world)]
    all_attrs = torch.cat([p[0] for p in parts]).numpy()
    all_labels = torch.cat([p[1] for p in parts]).numpy()
    inp = KNNInput(Params(n, nq, na), all_labels,
                   all_attrs.astype(np.float64), ks, qall.astype(np.float64))
scatter = ShardedEngine(conf).run_device_full(inp)
facts = gather_objects(out)
if root:
    lab = torch.from_numpy(all_labels)
    votes = [int(ref.vote(lab, ri[i:i + 1, :ks[i]], 10)[0])
             for i in range(nq)]

    def arrays(res):
        return ([r.neighbor_ids.tolist() for r in res],
                [r.neighbor_dists.tolist() for r in res],
                [r.predicted_label for r in res], [r.k for r in res],
                [r.query_id for r in res])
    json.dump({"ranks": facts, "held": arrays(held),
               "scatter": arrays(scatter), "cast": arrays(cast),
               "f32_integers": arrays(f32int),
               "ref": ([ri[i, :ks[i]].tolist() for i in range(nq)],
                       [rd[i, :ks[i]].tolist() for i in range(nq)], votes),
               "ks": ks.tolist(),
               "events": [e for e in tracer.events() if e["ph"] == "X"]},
              open(work + "/out.json", "w"))
shutdown()
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One spawn of four gloo ranks; rank 0's record of everything."""
    work = tmp_path_factory.mktemp("held")
    spec = json.dumps({"world": WORLD, "n": N, "na": NA, "nq": NQ,
                       "kmax": KMAX, "seed": SEED, "block": BLOCK,
                       "gen_block": GEN_BLOCK})
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(WORLD),
               LOCAL_WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(work), spec], cwd=ROOT,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, outs[r][1][-6000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, bad
    return json.loads((work / "out.json").read_text())


def test_the_held_solve_equals_the_sharded_float64_reference(run):
    ids, dists, pred, ks, qids = run["held"]
    rids, rdists, rvotes = run["ref"]
    assert qids == list(range(NQ)) and ks == run["ks"]
    assert ids == rids
    assert dists == rdists            # integers: float32 holds them exactly
    assert pred == rvotes
    assert all(len(i) == k for i, k in zip(ids, ks))


def test_the_held_solve_equals_the_scatter_path_on_the_same_rows(run):
    assert run["held"] == run["scatter"]


def test_a_held_solve_is_one_linked_tree_counting_queries_and_casts(run):
    spans = run["events"]
    assert obs_trace.tree_faults(spans) == []
    roots = [e for e in spans if e["args"]["parent"] is None]
    assert [e["name"] for e in roots] == ["sharded.held_device_full"]
    root = roots[0]
    kids = {e["name"] for e in spans
            if e["args"]["parent"] == root["args"]["id"]}
    assert kids == CHILDREN_ROOT
    qpad = -(-NQ // 32) * 32
    # The uint8 queries and the ks cross to the device; the corpus never
    # does. No byte is cast: only the short last chunk is copied into a
    # uint8 buffer of whole blocks.
    assert root["args"]["h2d_bytes"] == qpad * NA + qpad * 4
    shard = run["ranks"][0]["shard_rows"]
    tail = shard % BLOCK
    assert "cast_bytes" not in root["args"]
    assert root["args"]["pad_bytes"] == tail * NA
    fold = next(e for e in spans if e["name"] == "sharded.enqueue_chunked")
    assert fold["args"]["pad_bytes"] == tail * NA
    assert fold["args"]["chunks"] == -(-N // WORLD // BLOCK)


def test_the_held_chunk_loop_is_one_span_under_the_root_timed_as_fold(run):
    """The held solve's chunk loop (``engine.chunks.fold_chunks`` under
    ``ShardedEngine._fold``): one ``sharded.enqueue_chunked`` span, a
    child of the root, with the plan's chunks, list width and kernel,
    that opens nothing of its own on the CPU (no chunk window waits
    there); every rank times it as ``fold``."""
    spans = run["events"]
    root = next(e for e in spans if e["name"] == "sharded.held_device_full")
    loops = [e for e in spans if e["name"] == "sharded.enqueue_chunked"]
    assert len(loops) == 1
    loop = loops[0]["args"]
    assert loop["parent"] == root["args"]["id"]
    assert loop["chunks"] == -(-N // WORLD // BLOCK)
    assert loop["impl"] == "fused" and loop["kc"] >= KMAX
    assert not [e for e in spans if e["args"]["parent"] == loop["id"]]
    for facts in run["ranks"]:
        assert "fold" in facts["phases"]


def test_every_rank_times_its_phases_and_records_no_row_scatter(run):
    qpad = -(-NQ // 32) * 32
    want = [comms.broadcast_traffic(WORLD, qpad * NA,
                                    "query block").to_dict()]
    kc = run["ranks"][0]["comms"][1]["note"]
    assert "q_local=64" in kc
    for rank, facts in enumerate(run["ranks"]):
        assert facts["comms"][0] == want[0]
        assert [c["collective"] for c in facts["comms"]] == [
            "broadcast_from_root", "all_gather_merge_topk"]
        assert facts["phases"] == sorted(
            {"stage_queries", "fold", "merge", "gather"}
            | ({"epilogue", "fetch", "finalize"} if rank == 0 else set()))


def test_both_routes_give_the_same_answers_and_count_their_own_work(run):
    """The integer route and the cast route on the same queries: the same
    answers; K1 named apart, once a chunk on every rank; the cast route
    stages float32 queries and casts every held row, the integer route
    casts none and copies only the short last chunk."""
    assert run["cast"] == run["held"]
    chunks = -(-N // WORLD // BLOCK)
    qpad = -(-NQ // 32) * 32
    shard = run["ranks"][0]["shard_rows"]
    for rank, facts in enumerate(run["ranks"]):
        got, cast = facts["integer"], facts["cast"]
        assert got["dispatches"] == {"fused_topk_u8": chunks}
        assert cast["dispatches"] == {"fused_topk": chunks}
        assert got["bytes"]["cast_bytes"] == 0
        assert got["bytes"]["pad_bytes"] == (shard % BLOCK) * NA
        assert cast["bytes"]["cast_bytes"] == shard * NA * 4
        assert cast["bytes"]["pad_bytes"] == 0
        if rank == 0:
            assert got["bytes"]["h2d_bytes"] == qpad * NA + qpad * 4
            assert cast["bytes"]["h2d_bytes"] == qpad * NA * 4 + qpad * 4


def test_float_queries_take_the_route_their_values_allow(run):
    """float32 queries of integer values in 0..255 take the integer route
    and answer as the uint8 queries do; one fractional value sends the
    whole solve down the cast route."""
    assert run["f32_integers"] == run["held"]
    chunks = -(-N // WORLD // BLOCK)
    for facts in run["ranks"]:
        assert facts["f32_integers"]["dispatches"] == {
            "fused_topk_u8": chunks}
        assert facts["f32_fraction"]["dispatches"] == {
            "fused_topk": chunks}
        assert facts["f32_fraction"]["bytes"]["cast_bytes"] > 0


@pytest.mark.parametrize("values,integer", [
    (np.array([[0, 255], [7, 8]], np.uint8), True),
    (np.array([[0.0, 255.0], [7.0, 8.0]], np.float32), True),
    (np.array([[0, 255], [7, 8]], np.int64), True),
    (np.array([[0.0, 255.5]], np.float32), False),
    (np.array([[0.0, 256.0]], np.float64), False),
    (np.array([[-1.0, 3.0]], np.float32), False),
    (np.array([[np.nan, 3.0]], np.float32), False),
    (np.zeros((0, 4), np.float32), False),
])
def test_integer_queries_reads_the_values(values, integer):
    assert sharded_mod.integer_queries(values) is integer


def test_bad_layouts_the_exact_path_and_wrong_inputs_raise_everywhere(run):
    for facts in run["ranks"]:
        assert "do not tile" in facts["bad_layout"]
        assert "only run_device_full" in facts["exact_raises"]
        assert "QueryBatch" in facts["wrong_input"]


def test_the_memory_model_prices_the_held_shard_and_no_staged_chunks():
    cfg = EngineConfig(mode="sharded", mesh_shape=(4, 1), device="cpu",
                       use_pallas=True)
    m = memwatch.held_shard_model(250_000_000, 128, 1000, 10, (4, 1),
                                  config=cfg)
    t = m["terms"]
    assert t["held_shard"] == 250_000_000 * 128
    assert t["held_labels"] == 250_000_000 * 4
    assert t["cast_buffer"] == 51200 * 128 * 4
    assert t["query_blocks"] == 1024 * 128 * 4
    assert "staged_corpus" not in t
    assert t["merge_buffer"] == 4 * 1024 * m["kcap"] * 12
    assert m["path"] == "held" and m["total_bytes"] == sum(t.values())
    assert 32e9 < m["total_bytes"] < 34e9


def test_the_memory_model_of_the_integer_route_prices_uint8_pieces():
    """With integer queries no float32 piece is made: the short last
    chunk's uint8 piece and uint8 query blocks instead."""
    cfg = EngineConfig(mode="sharded", mesh_shape=(4, 1), device="cpu",
                       use_pallas=True)
    m = memwatch.held_shard_model(250_000_000, 128, 1000, 10, (4, 1),
                                  config=cfg, integer=True)
    t = m["terms"]
    assert "cast_buffer" not in t
    assert t["pad_buffer"] == 51200 * 128
    assert t["query_blocks"] == 1024 * 128
    assert t["held_shard"] == 250_000_000 * 128
    assert m["total_bytes"] == sum(t.values())
