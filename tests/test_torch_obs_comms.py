"""The mesh engines' collective-traffic records (``engine.last_comms``,
``obs.comms``) on the CPU with gloo, at meshes (2, 4), (4, 2), (8, 1),
(1, 8) and (1, 1): in both modes, on the chunked extraction path with the
router's outliers and on the merged path, every rank's record equals the
bytes computed here by hand from the plan (the root's scatters, the
data-axis merge, row 0's query-axis gather), and the mesh CLI's metrics
record carries it on rank 0 with every rank's counters gathered in.

The reference's own ``last_comms`` checks fail on every tree of this round
(ROADMAP queue C), so the records are held against hand-counted bytes,
not against the reference's engines."""

import json

import pytest

pytest.importorskip("jax")

from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu_torch.config import EngineConfig  # noqa: E402
from dmlp_tpu_torch.engine.single import (hetk_split,  # noqa: E402
                                          plan_chunks, resolve_kcap,
                                          round_up)
from dmlp_tpu_torch.io.grammar import parse_input_text  # noqa: E402
from dmlp_tpu_torch.obs import comms  # noqa: E402

from test_torch_mesh import spawn_ranks  # noqa: E402

SHAPES = [(2, 4), (4, 2), (8, 1), (1, 8)]
CASES = {
    # The chunked extraction path with the router: k past the kernel's
    # window for some queries, so two segments (bulk and outliers).
    "routed": (generate_input_text(12000, 40, 5, 0.0, 50.0, 1, 900, 4,
                                   seed=23),
               {"select": "extract", "use_pallas": True,
                "data_block": 2560}),
    # The merged path: the streaming select on whole shards.
    "merged": (generate_input_text(600, 33, 6, -5, 5, 1, 11, 4, seed=17),
               {"data_block": 16}),
}

RANK_SCRIPT = r"""
import json, sys
import torch.distributed as dist
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.sharded import RingEngine, ShardedEngine
from dmlp_tpu_torch.io.grammar import parse_input_text
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.parallel.mesh import make_mesh

work = sys.argv[1]
spec = json.load(open(work + "/cases.json"))
initialize(auto=True, device="cpu", timeout_s=60)
root = dist.get_rank() == 0
out = {}
for shape in spec["shapes"]:
    mesh = make_mesh(tuple(shape))
    for case in spec["cases"]:
        inp = parse_input_text(open(case["input"]).read()) if root else None
        for mode, cls in (("sharded", ShardedEngine), ("ring", RingEngine)):
            eng = cls(EngineConfig(mode=mode, mesh_shape=tuple(shape),
                                   device="cpu", **case["config"]),
                      mesh=mesh)
            eng.run(inp)
            got = [t.to_dict() for t in eng.last_comms]
            key = f"{shape[0]}x{shape[1]}/{case['name']}/{mode}"
            recs = [None] * dist.get_world_size() if root else None
            dist.gather_object(got, recs, dst=0)
            if root:
                out[key] = {"ranks": recs, "hetk": eng.last_hetk,
                            "select": eng._last_select}
if root:
    json.dump(out, open(work + f"/out{dist.get_world_size()}.json", "w"))
shutdown()
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every (shape, case, mode)'s per-rank records: one spawn of 8 ranks
    for the four 8-rank meshes, one of a single rank for (1, 1)."""
    work = tmp_path_factory.mktemp("comms")
    cases = []
    for name, (text, cfg) in CASES.items():
        (work / f"{name}.in").write_text(text)
        cases.append({"name": name, "input": str(work / f"{name}.in"),
                      "config": cfg})
    out = {}
    for world, shapes in ((8, SHAPES), (1, [(1, 1)])):
        (work / "cases.json").write_text(json.dumps(
            {"shapes": shapes, "cases": cases}))
        spawn_ranks(work, RANK_SCRIPT, world, timeout=240)
        out.update(json.loads((work / f"out{world}.json").read_text()))
    return out


def _expected(name, shape):
    """The plan's traffic, by hand: (collective, bytes_out_per_device,
    bytes_in_per_device, n_groups, senders, bytes_total) in issue order."""
    text, kw = CASES[name]
    inp = parse_input_text(text)
    cfg = EngineConfig(mode="sharded", mesh_shape=shape, device="cpu", **kw)
    n, nq, na = (inp.params.num_data, inp.params.num_queries,
                 inp.params.num_attrs)
    r, c = shape
    world = r * c
    if name == "routed":
        shard_rows = plan_chunks(-(-n // r), 256, kw["data_block"])[0]
        bulk, outl = hetk_split(cfg, "float32", inp.ks, n,
                                round_up(-(-n // r), 8))
        segs = [(round_up(-(-len(bulk) // c), 32),
                 resolve_kcap(cfg, int(inp.ks[bulk].max()), "extract",
                              r * shard_rows)),
                (round_up(-(-len(outl) // c), 8),
                 resolve_kcap(cfg, int(inp.ks[outl].max()), "topk",
                              r * shard_rows))]
        ids = 0
    else:
        shard_rows = round_up(n, r * kw["data_block"]) // r
        segs = [(round_up(-(-nq // c), 8),
                 resolve_kcap(cfg, int(inp.ks.max()), "topk",
                              shard_rows * r))]
        ids = 1
    rows = []
    if world > 1:
        for payload in [shard_rows * na * 4, shard_rows * 4] \
                + [shard_rows * 4] * ids + [q * na * 4 for q, _ in segs]:
            rows.append(("scatter_from_root", (world - 1) * payload,
                         payload, 1, 1, (world - 1) * payload))
    if r > 1:
        for q, k in segs:
            peer = (r - 1) * q * k * 12
            rows.append(("merge", peer, peer, c, 0, peer * r * c))
    if c > 1:
        for q, k in segs:
            rows.append(("gather_topk", q * k * 12, (c - 1) * q * k * 12, 1,
                         c - 1, (c - 1) * q * k * 12))
    return rows


@pytest.mark.parametrize("shape", SHAPES + [(1, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mode", ["sharded", "ring"])
def test_last_comms_equal_the_hand_counted_bytes(records, shape, name,
                                                 mode):
    rec = records[f"{shape[0]}x{shape[1]}/{name}/{mode}"]
    ranks = rec["ranks"]
    assert all(r == ranks[0] for r in ranks), "ranks disagree"
    got = [(t["collective"], t["bytes_out_per_device"],
            t["bytes_in_per_device"], t["n_groups"], t["senders"],
            t["bytes_total"]) for t in ranks[0]]
    merge = "ring_allreduce_topk" if mode == "ring" \
        else "all_gather_merge_topk"
    want = [(merge if row[0] == "merge" else row[0], *row[1:])
            for row in _expected(name, shape)]
    assert got == want
    if name == "routed":
        assert rec["hetk"] is not None and rec["select"] == "extract"
    summary = comms.summarize([comms.CollectiveTraffic(**{
        k: v for k, v in t.items() if k != "bytes_total"})
        for t in ranks[0]])
    assert summary["bytes_total"] == sum(row[-1] for row in want)


def test_mesh_cli_metrics_gather_every_ranks_counters(tmp_path):
    """``--mode sharded --mesh 2,2 --metrics``: rank 0's summary carries
    the comms block (every rank's record equal) and the counters of all
    four ranks, each rank's K1 launch recorded."""
    import io

    from dmlp_tpu_torch import cli
    text = generate_input_text(30000, 300, 16, 0.0, 100.0, 1, 32, 10,
                               seed=42)
    m = tmp_path / "m.jsonl"
    out, err = io.StringIO(), io.StringIO()
    assert cli.main(["--device", "cpu", "--mode", "sharded", "--mesh",
                     "2,2", "--pallas", "--warmup", "--metrics", str(m),
                     "--counters"], stdin=io.StringIO(text), stdout=out,
                    stderr=err) == 0
    golden = io.StringIO()
    cli.main(["--engine", "golden"], stdin=io.StringIO(text),
             stdout=golden, stderr=io.StringIO())
    assert out.getvalue() == golden.getvalue()
    rec = json.loads(m.read_text().splitlines()[-1])
    assert rec["comms"]["ranks_agree"]
    assert rec["comms"]["bytes_by_axis"].keys() == {"world", "data",
                                                    "query"}
    c = rec["counters"]
    assert [p["per_kernel"]["fused_topk"]["dispatches"]
            for p in c["per_rank"]] == [1, 1, 1, 1]
    assert c["per_kernel"]["fused_topk"]["dispatches"] == 4
    assert c["extraction_term"] == "measured"
    assert err.getvalue().splitlines()[1].startswith("counters: ")
