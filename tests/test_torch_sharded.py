"""The port's mesh engines (``ShardedEngine``, ``RingEngine``; gloo ranks on
the CPU) against the reference's on the conftest's 8 virtual devices.

Both packages solve the identical instance (the test writes it once in the
input grammar; the reference parses it here, the port's rank 0 parses it
in its own process) under the identical configuration. Every case holds
the port's stdout (the checksums and the ``--debug`` listing) byte for
byte against the reference engine's and the golden oracle's, and the
router's ``last_hetk`` and the select against the reference engine's.
Where both packages plan the same chunks (rows that fill whole chunks of
both: the port's extraction granule is 256 rows, the reference's 12,800)
and the attributes are integers (so float32 distances are exact), the
candidate distances and the prune accounting must be equal too, and the
candidate ids but for the members of each row's last tie group:
tolerance none.

The port's ranks of each mesh shape are spawned once for the module (one
process per rank, every process group with a 60 s timeout, every
subprocess waited on with a deadline) and solve every case in turn; the
reference's kernels run in Pallas interpret mode, the port's plain
versions.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from dmlp_tpu.config import EngineConfig as RefConfig  # noqa: E402
from dmlp_tpu.engine.sharded import RingEngine as RefRing  # noqa: E402
from dmlp_tpu.engine.sharded import ShardedEngine as RefSharded  # noqa: E402
from dmlp_tpu.golden.reference import knn_golden  # noqa: E402
from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu.io.grammar import KNNInput, Params  # noqa: E402
from dmlp_tpu.io.grammar import format_input, parse_input_text  # noqa: E402
from dmlp_tpu.io.report import format_results  # noqa: E402
from dmlp_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402

from test_torch_mesh import spawn_ranks  # noqa: E402

SHAPES = [(2, 4), (4, 2), (8, 1), (1, 8), (1, 1)]
CHUNK = 12800   # a whole chunk of both packages (the reference's granule)


def _ints(n, nq, na, seed, hi=17, kmax=13, banded=None):
    """Integer-valued attributes (exact float32 sums), seeded; ``banded``
    = (rows per band, query band) moves attribute 0 by 1,000 per band of
    rows, the queries sitting in the query band's."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, hi, (n, na)).astype(np.float64)
    queries = rng.integers(0, hi, (nq, na)).astype(np.float64)
    if banded is not None:
        rows, qband = banded
        data[:, 0] += 1000.0 * (np.arange(n) // rows - qband)
    labels = rng.integers(0, 4, n).astype(np.int32)
    ks = rng.integers(1, kmax + 1, nq).astype(np.int32)
    return format_input(KNNInput(Params(n, nq, na), labels, data, ks,
                                 queries))


def _routed():
    """Wide-k outliers beside small k (the reference's multi-host routing
    case): the router keeps the bulk on the kernel."""
    rng = np.random.default_rng(91)
    n, nq, na = 700, 12, 4
    data = rng.uniform(0, 40, (n, na))
    queries = rng.uniform(0, 40, (nq, na))
    labels = rng.integers(0, 5, n).astype(np.int32)
    ks = rng.integers(1, 25, nq).astype(np.int32)
    ks[3], ks[9] = 600, 700
    return format_input(KNNInput(Params(n, nq, na), labels, data, ks,
                                 queries))


def _rows(shape):
    """Rows that fill two whole chunks per shard at one or two data
    shards, one at four and eight."""
    r = shape[0]
    return r * CHUNK * (2 if r <= 2 else 1)


EXTRACT = {"select": "extract", "use_pallas": True, "data_block": CHUNK}
# name: (input text for a mesh shape, config, shapes it runs at, what
# else: "candidates" and "prune" compare more, "device_full" solves with
# run_device_full in both packages)
CASES = {
    "merged_sort": (lambda s: generate_input_text(
        230, 33, 6, -5, 5, 1, 11, 4, seed=17), {"data_block": 16},
        SHAPES, ()),
    "tiny_uneven": (lambda s: generate_input_text(
        3, 5, 2, 0, 1, 1, 3, 2, seed=4), {}, SHAPES, ()),
    "fast_ties": (lambda s: _ints(64, 16, 3, 7, hi=4, kmax=19),
                  {"exact": False, "data_block": 8}, SHAPES, ()),
    "extract_chunks": (lambda s: _ints(_rows(s), 17, 5, 29), EXTRACT,
                       SHAPES, ("candidates",)),
    "banded_prune": (lambda s: _ints(_rows(s), 9, 5, 31, hi=100,
                                     banded=(CHUNK, 1)),
                     EXTRACT, SHAPES, ("prune",)),
    "routed": (lambda s: _routed(), {"select": "extract",
                                     "use_pallas": True}, SHAPES, ()),
    # The all-device pipeline (vote and report order on rank 0's device,
    # f32 ordering, no repair) on integer attributes, where it is exact.
    "device_full": (lambda s: _ints(96, 24, 4, 11, hi=7, kmax=8),
                    {"exact": False, "data_block": 8, "query_block": 8},
                    SHAPES, ("device_full",)),
    # n = 120,000 at R = 2 with data_block 25,600: each shard's 3 chunks
    # overshoot its rows; an uncapped fold would read the next shard's.
    "overshoot": (lambda s: generate_input_text(
        120000, 9, 3, -6, 6, 1, 11, 3, seed=33),
        {"select": "extract", "use_pallas": True, "data_block": 25600},
        [(2, 4)], ()),
}

RANK_SCRIPT = r"""
import json, sys
import torch.distributed as dist
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.sharded import RingEngine, ShardedEngine
from dmlp_tpu_torch.io.grammar import parse_input_text
from dmlp_tpu_torch.io.report import format_results
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.parallel.mesh import make_mesh

work = sys.argv[1]
spec = json.load(open(work + "/cases.json"))
initialize(auto=True, device="cpu", timeout_s=60)
shape = tuple(spec["shape"])
mesh = make_mesh(shape)
root = dist.get_rank() == 0
out = {}
for case in spec["cases"]:
    inp = parse_input_text(open(case["input"]).read()) if root else None
    for mode, cls in (("sharded", ShardedEngine), ("ring", RingEngine)):
        eng = cls(EngineConfig(mode=mode, mesh_shape=shape, device="cpu",
                               **case["config"]), mesh=mesh)
        solve = eng.run_device_full if "device_full" in case["extra"] \
            else eng.run
        res = solve(inp)
        rec = {"hetk": eng.last_hetk, "prune": eng.last_prune,
               "select": eng._last_select}
        if root:
            rec.update(stdout=format_results(res),
                       debug=format_results(res, debug=True))
        if "candidates" in case["extra"]:
            cand = eng.candidates(inp)
            if root:
                rec["cand"] = [cand[0].tolist(), cand[2].tolist()]
        out[case["name"] + "/" + mode] = rec
if root:
    json.dump(out, open(work + "/out.json", "w"))
shutdown()
"""


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def texts():
    cache = {}

    def get(name, shape):
        key = (name, _rows(shape) if name in ("extract_chunks",
                                              "banded_prune") else 0)
        if key not in cache:
            cache[key] = CASES[name][0](shape)
        return cache[key]
    return get


@pytest.fixture(scope="module")
def reference(texts):
    """The reference engine of a (shape, case, mode) and its results,
    solved once."""
    cache = {}

    def get(shape, name, mode):
        if (shape, name, mode) not in cache:
            cls = RefSharded if mode == "sharded" else RefRing
            eng = cls(RefConfig(mode=mode, **CASES[name][1]),
                      mesh=ref_make_mesh(shape, devices=jax.devices()[
                          :shape[0] * shape[1]]))
            inp = parse_input_text(texts(name, shape))
            solve = eng.run_device_full if "device_full" in CASES[name][3] \
                else eng.run
            cache[shape, name, mode] = (eng, inp, solve(inp))
        return cache[shape, name, mode]
    return get


@pytest.fixture(scope="module")
def port_runs(texts, tmp_path_factory):
    """The port's results of a mesh shape: one spawn of its ranks, which
    solve every case in both modes, made at the first request."""
    cache = {}

    def get(shape):
        if shape not in cache:
            work = tmp_path_factory.mktemp(f"sharded{_key(shape)}")
            cases = []
            for name, (_, cfg, shapes, extra) in CASES.items():
                if shape not in shapes:
                    continue
                path = work / f"{name}.in"
                path.write_text(texts(name, shape))
                cases.append({"name": name, "input": str(path),
                              "config": cfg, "extra": list(extra)})
            (work / "cases.json").write_text(json.dumps(
                {"shape": shape, "cases": cases}))
            spawn_ranks(work, RANK_SCRIPT, shape[0] * shape[1], timeout=240)
            cache[shape] = json.loads((work / "out.json").read_text())
        return cache[shape]
    return get


PARAMS = [pytest.param(shape, name, mode,
                       id=f"{_key(shape)}-{name}-{mode}")
          for shape in SHAPES for name, case in CASES.items()
          if shape in case[2] for mode in ("sharded", "ring")]


@pytest.mark.parametrize("shape,name,mode", PARAMS)
def test_stdout_matches_reference_and_golden(port_runs, reference, shape,
                                             name, mode):
    """Byte-identical stdout (checksums and --debug) to the reference's
    engine of the same mode and to the golden oracle; the same select and
    router split."""
    rec = port_runs(shape)[f"{name}/{mode}"]
    ref, inp, want = reference(shape, name, mode)
    assert rec["stdout"] == format_results(want)
    assert rec["debug"] == format_results(want, debug=True)
    assert rec["stdout"] == format_results(knn_golden(inp))
    assert rec["select"] == ref._last_select
    want_hetk = None if ref.last_hetk is None else list(ref.last_hetk)
    assert rec["hetk"] == want_hetk
    if name == "routed":
        assert want_hetk is not None and want_hetk[1] == 2


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_candidates_and_prune_match_reference(port_runs, reference, shape):
    """Where the chunk plans agree: the dense candidate lists of both modes
    equal the reference engine's (float32 distances exactly, on integer
    attributes; ids but for the members of each row's last tie group),
    and the banded corpus prunes the same
    (shard, chunk) pieces — every one but the queries' band — with the
    same scanned bytes."""
    out = port_runs(shape)
    for mode in ("sharded", "ring"):
        ref, inp, _ = reference(shape, "extract_chunks", mode)
        d, _lab, ids = ref.candidates(inp)
        rec = out[f"extract_chunks/{mode}"]
        got_d, got_ids = (np.asarray(x) for x in rec["cand"])
        # Distances equal exactly; ids equal in order except inside the
        # tie group at a row's last distance, where the two kernels'
        # eviction order among equal distances may keep different
        # members (the boundary test flags those rows for the float64
        # repair).
        assert np.array_equal(got_d, d)
        inner = d < d[:, -1:]
        assert inner.sum() > d.shape[0]
        assert np.array_equal(got_ids[inner], ids[inner])
        ref_b = reference(shape, "banded_prune", mode)[0]
        want = {k: ref_b.last_prune[k] for k in (
            "blocks_total", "blocks_pruned", "scanned_bytes",
            "dense_bytes")}
        got = out[f"banded_prune/{mode}"]["prune"]
        assert {k: got[k] for k in want} == want
        assert want["blocks_pruned"] == want["blocks_total"] - 1 > 0


def test_overshoot_plan_crosses_the_shard_boundary():
    """The overshoot case really overshoots in the port's plan: 3 chunks
    of each 60,000-row shard reach past it."""
    from dmlp_tpu_torch.engine.single import plan_chunks
    shard_rows, nchunks, chunk_rows = plan_chunks(60000, 256, 25600)
    assert nchunks * chunk_rows > shard_rows
