"""The sharded batch cell's own pieces on the CPU: the shard generator
drawn again block by block, the blocked and sharded reference against the
whole-table one, the compact-table judge against the full-table judge,
the readers the cell is listed under, and ``drivers/sharded_batch.py`` on a program
without the held-shard entry."""

import time

import numpy as np
import pytest
import torch

from benchmark import compact, judge, shardgen
from benchmark.drivers import sharded_batch
from benchmark.drivers.common import Run
from benchmark.harness import reader
from benchmark.reference import knn as ref
from benchmark.reference import sharded as ref_sharded
from benchmark.spec import SPEC_PATH, Cell, file_cell, load_json

PEAKS = {"dense_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
CFG = {"num_data": 10_003, "num_attrs": 16, "num_labels": 10,
       "num_queries": 40}
SEED = 2**41 + 3


def small_cell(**over) -> Cell:
    """``bigann1b.batch_sharded`` at a test's size: 4 gloo ranks."""
    c = file_cell("bigann1b.batch_sharded", "bigann1b", "batch_sharded", 4)
    cfg = {**c.config, "num_data": 40_000, "num_queries": 128,
           "queries_per_solve": 64, **over.get("config", {})}
    tr = {**c.traffic, "block_rows": 3000, "group_timeout_s": 60,
          **over.get("traffic", {})}
    return Cell(c.name, c.config_name, c.traffic_name, 4, cfg, tr)


@pytest.mark.parametrize("ranks,block", [(1, 10_003), (3, 1000), (4, 777)])
def test_a_shard_drawn_again_block_by_block_is_the_shard(ranks, block):
    for rank in range(ranks):
        attrs, labels = shardgen.draw_shard(CFG, SEED, rank, ranks, block,
                                            "cpu")
        lo, hi = shardgen.shard_span(CFG, ranks, rank)
        assert attrs.shape == (hi - lo, 16) and attrs.dtype == torch.uint8
        assert labels.dtype == torch.int32
        for b, a, z in shardgen.blocks(hi - lo, block):
            ga, gl = shardgen.draw_block(CFG, SEED, rank, b, z - a, "cpu")
            assert torch.equal(ga, attrs[a:z]) and torch.equal(gl,
                                                               labels[a:z])
    spans = [shardgen.shard_span(CFG, ranks, r) for r in range(ranks)]
    assert spans[0][0] == 0 and spans[-1][1] == CFG["num_data"]
    assert all(spans[i][1] == spans[i + 1][0] for i in range(ranks - 1))
    assert int(attrs.max()) == 255 and int(labels.max()) == 9


def test_the_shard_drawn_on_the_card_is_the_blocks_drawn_again(cuda):
    attrs, labels = shardgen.draw_shard(CFG, SEED, 1, 3, 1000, cuda)
    for b, a, z in shardgen.blocks(attrs.shape[0], 1000):
        ga, gl = shardgen.draw_block(CFG, SEED, 1, b, z - a, cuda)
        assert torch.equal(ga, attrs[a:z]) and torch.equal(gl, labels[a:z])


def test_the_queries_are_the_seeds_alone():
    q = shardgen.queries(CFG, SEED)
    assert q.shape == (40, 16) and q.dtype == np.uint8
    assert np.array_equal(q, shardgen.queries(CFG, SEED))
    assert not np.array_equal(q, shardgen.queries(CFG, SEED + 1))


@pytest.mark.parametrize("ranks,block,k", [(1, 2000, 10), (3, 1500, 7),
                                           (4, 401, 25)])
def test_the_blocked_sharded_reference_is_the_whole_table_one(ranks, block,
                                                             k):
    q64 = torch.from_numpy(shardgen.queries(CFG, SEED)).double()
    parts, whole = [], []
    for rank in range(ranks):
        lo, hi = shardgen.shard_span(CFG, ranks, rank)
        blocks = [(lo + a, shardgen.draw_block(CFG, SEED, rank, b, z - a,
                                               "cpu")[0])
                  for b, a, z in shardgen.blocks(hi - lo, block)]
        whole += [x for _, x in blocks]
        parts.append(ref_sharded.shard_knn(q64, blocks, k))
    # the merge over the ranks is the all-gather's concatenation, ordered
    d, i = ref_sharded.merge_lists(torch.cat([p[0] for p in parts], 1),
                                   torch.cat([p[1] for p in parts], 1), k)
    wd, wi = ref.knn(q64, torch.cat(whole).double(), k)
    assert torch.equal(i, wi) and torch.equal(d, wd)


def test_a_block_shorter_than_k_pads_and_the_controls_lose_bits():
    q64 = torch.from_numpy(shardgen.queries(CFG, SEED)).double()
    x = shardgen.draw_block(CFG, SEED, 0, 0, 5, "cpu")[0]
    d, i = ref_sharded.block_topk(q64, x, 100, 8)
    assert (i[:, :5] >= 100).all() and (i[:, 5:] == -1).all()
    assert torch.isinf(d[:, 5:]).all()
    big = shardgen.draw_block(CFG, SEED, 0, 0, 3000, "cpu")[0]
    exact = ref_sharded.block_topk(q64, big, 0, 10)
    # TF32 holds 8-bit integers and float32 their sums: exact here
    tf = ref_sharded.block_topk(q64, big, 0, 10, "tf32")
    assert torch.equal(tf[0], exact[0])
    bf = ref_sharded.block_topk(q64, big, 0, 10, "bfloat16")
    assert not torch.equal(bf[0], exact[0])
    with pytest.raises(ValueError):
        ref_sharded.block_topk(q64, big, 0, 10, "float16")


def _table(n, a, seed):
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, (n, a)).astype(np.float64))
    labels = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32))
    q = torch.from_numpy(rng.integers(0, 256, (30, a)).astype(np.float64))
    return data, labels, q


def test_the_compact_judge_is_the_full_table_judge():
    n, a, k = 3000, 8, 6
    data, labels, q = _table(n, a, 5)
    ref_d, ref_i = ref.knn(q, data, k)
    pred = ref.vote(labels, ref_i, 4)
    ans = judge.answers(ref_i.numpy(), ref_d.numpy(), pred.numpy())
    # wrong in every way the judge knows: a farther row, an id outside
    # the corpus (both ends), a repeat, a wrong vote, a wrong distance, a
    # missing answer, a short one
    ans[1].neighbor_ids = ans[1].neighbor_ids.copy()
    ans[1].neighbor_ids[-1] = int(np.setdiff1d(np.arange(n),
                                               ans[1].neighbor_ids)[0])
    ans[2].neighbor_ids = ans[2].neighbor_ids.copy()
    ans[2].neighbor_ids[0] = n
    ans[3].neighbor_ids = ans[3].neighbor_ids.copy()
    ans[3].neighbor_ids[2] = -1
    ans[4].neighbor_ids = ans[4].neighbor_ids.copy()
    ans[4].neighbor_ids[1] = ans[4].neighbor_ids[0]
    ans[5].predicted_label = (ans[5].predicted_label + 1) % 4
    ans[6].neighbor_dists = ans[6].neighbor_dists * (1 + 1e-3)
    ans[7] = None
    ans[8].neighbor_ids = ans[8].neighbor_ids[:-1]
    full = judge.batch_answer_err(ans, q, data, labels, k, 4, ref_d)
    ids = compact.wanted_ids([ans], n, k)
    assert ids.size < n and np.all(np.diff(ids) > 0)
    at = torch.from_numpy(ids)
    got = compact.compact_answer_err(ans, q, ids, data[at], labels[at], n,
                                     k, 4, ref_d)
    assert got == full
    assert full["answer_err"] == 1.0 and full["invalid_answers"] == 5
    assert full["vote_mismatches"] >= 1 and full["rank_gap"] > 0
    right = judge.answers(ref_i.numpy(), ref_d.numpy(), pred.numpy())
    ids = compact.wanted_ids([right], n, k)
    at = torch.from_numpy(ids)
    assert compact.compact_answer_err(
        right, q, ids, data[at], labels[at], n, k, 4, ref_d) == \
        judge.batch_answer_err(right, q, data, labels, k, 4, ref_d)
    assert judge.batch_answer_err(right, q, data, labels, k, 4,
                                  ref_d)["answer_err"] == 0.0


def test_an_id_the_table_lacks_is_wrong_outright():
    n, a, k = 500, 4, 3
    data, labels, q = _table(n, a, 6)
    ref_d, ref_i = ref.knn(q, data, k)
    ans = judge.answers(ref_i.numpy(), ref_d.numpy(),
                        ref.vote(labels, ref_i, 4).numpy())
    ids = compact.wanted_ids([ans[1:]], n, k)
    at = torch.from_numpy(ids)
    got = compact.compact_answer_err(ans, q, ids, data[at], labels[at], n,
                                     k, 4, ref_d)
    assert got["answer_err"] == 1.0 and got["invalid_answers"] >= 1


def test_the_cells_readers():
    """The cell's observations (rank 0's share of the work, its phases
    and its card's trace) give a number to every reader the cell is
    listed under, and the two readers of its own to nothing else."""
    obs = {"queries_done": 30000, "window_s": 50.0, "solves": 30,
           "phase_ms": [{"fold": 1000.0, "merge": 3.0, "fetch": 1.0,
                         "finalize": 2.0},
                        {"fold": 3000.0, "merge": 5.0, "fetch": 3.0,
                         "finalize": 4.0}],
           "work": {"dense_flops": 6.4e13, "min_bytes": 1.28e11},
           "peaks": PEAKS,
           "trace": {"solves": 2, "busy_s": 9.0, "window_s": 10.0,
                     "kernel_s": {"void extract_topk_kernel<1>(x)": 8.0,
                                  "void extract_merge_kernel<1>(y)": 0.5,
                                  "elementwise copy": 0.4}}}
    assert reader("sharded.fold_ms")(obs) == 2000.0
    assert reader("sharded.merge_ms")(obs) == 4.0
    assert reader("batch.fetch_ms")(obs) == 2.0
    assert reader("batch.finalize_ms")(obs) == 3.0
    assert reader("device_idle_pct.batch")(obs) == pytest.approx(10.0)
    least = 6.4e13 / 989e12
    assert reader("extract_roofline_pct.batch")(obs) == \
        pytest.approx(100 * least * 2 / 8.5)
    assert reader("solve_peak_pct.batch")(obs) == \
        pytest.approx(100 * 30 * 6.4e13 / (50 * 989e12))
    assert reader("queries_per_s")(obs) == 600.0
    listed = [m["name"] for m in load_json(SPEC_PATH)["per_layer"]
              if "bigann1b.batch_sharded" in m.get("workloads", ())]
    assert sorted(listed) == sorted(
        ["batch.fetch_ms", "batch.finalize_ms", "extract_roofline_pct.batch",
         "solve_peak_pct.batch", "device_idle_pct.batch", "sharded.fold_ms",
         "sharded.merge_ms"])
    for name in listed:
        assert reader(name)(obs) is not None, name
        assert reader(name)({}) is None, name
    # a batch cell's observations have nothing the cell's own readers read
    batch = dict(obs, phase_ms=[{"enqueue": 1.0, "fetch": 2.0}])
    for name in ("sharded.fold_ms", "sharded.merge_ms"):
        assert reader(name)(batch) is None


def test_the_driver_refuses_a_program_without_the_held_entry(monkeypatch):
    from dmlp_tpu_torch.engine.sharded import ShardedEngine
    monkeypatch.delattr(ShardedEngine, "hold_shard")
    started = []
    monkeypatch.setattr(sharded_batch.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    r = Run(cell=small_cell(), seed=SEED, seconds=1.0, trace=False,
            device=torch.device("cpu"), t0=time.perf_counter())
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="held-shard entry"):
        sharded_batch.run(r)
    assert not started and time.perf_counter() - t0 < 5
