"""The port's mesh layer (``dmlp_tpu_torch.parallel``) against the
reference's: ``balanced_dims``, the rank layout of ``make_mesh``, and the
two cross-shard merges, bit for bit.

The port's ranks are processes: one module-scoped spawn of 8 gloo ranks
on the CPU (every process group with a 60 s timeout, every subprocess
waited on with a deadline) builds the meshes and runs the collectives; the
reference runs its collectives under ``shard_map`` on the conftest's
virtual CPU devices.
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
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from dmlp_tpu.ops.topk import TopK as RefTopK  # noqa: E402
from dmlp_tpu.parallel import collectives as ref_coll  # noqa: E402
from dmlp_tpu.parallel.mesh import balanced_dims as ref_balanced  # noqa: E402
from dmlp_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402
from dmlp_tpu.utils.compat import shard_map  # noqa: E402
from dmlp_tpu_torch.parallel.distributed import free_port  # noqa: E402
from dmlp_tpu_torch.parallel.mesh import balanced_dims  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
SHAPES = [(2, 4), (4, 2), (8, 1), (1, 8)]
Q, K = 6, 8   # queries and list width per shard

# One rank: the meshes' layouts, then on the (4, 2) and (1, 8) meshes the
# two merges of this rank's seeded lists over its data-axis group, the
# query-axis gather of the merged lists to rank 0, and a scatter from
# rank 0. Each rank writes what it saw to out/rank<r>.npz.
RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlp_tpu_torch.ops.topk import TopK
from dmlp_tpu_torch.parallel import collectives as coll
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.parallel.mesh import make_mesh, mesh_coords

work = sys.argv[1]
initialize(auto=True, device="cpu", timeout_s=60)
rank = dist.get_rank()
out = {}
layouts = {}
for r, c in json.load(open(work + "/shapes.json")):
    mesh = make_mesh((r, c))
    layouts[f"{r}x{c}"] = {
        "mesh": mesh.mesh.tolist(), "coords": list(mesh_coords(mesh)),
        "data": dist.get_process_group_ranks(mesh.get_group("data")),
        "query": dist.get_process_group_ranks(mesh.get_group("query"))}
    if (r, c) in ((4, 2), (1, 8)):
        lists = np.load(work + f"/lists_R{r}.npz")
        rr, cc = mesh_coords(mesh)
        mine = TopK(torch.from_numpy(lists["d"][rr]),
                    torch.from_numpy(lists["l"][rr]),
                    torch.from_numpy(lists["i"][rr]))
        k = int(lists["k"])
        for name, fn in (("allgather", coll.allgather_merge_topk),
                         ("ring", coll.ring_allreduce_topk)):
            got = fn(mine, k, mesh.get_group("data"))
            for f, t in zip("dli", got):
                out[f"{name}_R{r}_{f}"] = t.numpy()
            if rr == 0:
                g = coll.gather_topk(got, mesh.get_group("query"), dst=0)
                if rank == 0:
                    for f, t in zip("dli", g):
                        out[f"gather_{name}_R{r}_{f}"] = t.numpy()
parts = None
if rank == 0:
    parts = [np.full((3, 2), i, np.int32) for i in range(dist.get_world_size())]
out["scatter"] = coll.scatter_from_root(parts, (3, 2), torch.int32,
                                        torch.device("cpu")).numpy()
objs = coll.gather_objects({"rank": rank})
if rank == 0:
    out["gathered_ranks"] = np.asarray([o["rank"] for o in objs])
out["bcast"] = np.asarray(coll.broadcast_object(
    {"v": 42} if rank == 0 else None)["v"])
np.savez(work + f"/rank{rank}.npz", **out)
json.dump(layouts, open(work + f"/layout{rank}.json", "w"))
shutdown()
"""


def seeded_lists(r: int, seed: int = 5):
    """Per-shard candidate lists as the kernels leave them: unsorted,
    integer-valued distances (ties within and across shards), ids unique
    across shards, and (+inf, -1, -1) sentinels."""
    rng = np.random.default_rng(seed + r)
    d = rng.integers(0, 5, (r, Q, K)).astype(np.float32)
    lab = rng.integers(0, 3, (r, Q, K)).astype(np.int32)
    ids = np.stack([np.stack([rng.permutation(K) + 100 * s
                              for _ in range(Q)]) for s in range(r)])
    ids = ids.astype(np.int32)
    sent = rng.random((r, Q, K)) < 0.2
    d[sent], lab[sent], ids[sent] = np.inf, -1, -1
    return d, lab, ids


def spawn_ranks(work: Path, script: str, world: int, timeout: float = 120,
                extra_env=None):
    """``world`` ranks of ``script`` with torchrun's environment; returns
    when every one exited, failing on a non-zero exit."""
    port = free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", **(extra_env or {}))
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(work)], cwd=ROOT,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, outs[r][1][-2000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, bad
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    (work / "shapes.json").write_text(json.dumps(SHAPES))
    for r in (4, 1):
        d, lab, ids = seeded_lists(r)
        np.savez(work / f"lists_R{r}.npz", d=d, l=lab, i=ids, k=K)
    spawn_ranks(work, RANK_SCRIPT, WORLD)
    return {"npz": [dict(np.load(work / f"rank{r}.npz"))
                    for r in range(WORLD)],
            "layout": [json.loads((work / f"layout{r}.json").read_text())
                       for r in range(WORLD)]}


def test_balanced_dims_equals_reference():
    for n in range(1, 65):
        assert balanced_dims(n) == ref_balanced(n), n


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_make_mesh_layout_equals_reference(ranks, shape):
    """Row-major, as the reference's Mesh(devices.reshape(R, C)): rank
    r * C + c sits at (r, c); its data-axis group is its column and its
    query-axis group its row."""
    r, c = shape
    ref = np.vectorize(lambda d: d.id)(ref_make_mesh(shape).devices)
    for rank, lay in enumerate(ranks["layout"]):
        got = lay[f"{r}x{c}"]
        assert got["mesh"] == ref.tolist()
        rr, cc = got["coords"]
        assert ref[rr, cc] == rank
        assert got["data"] == ref[:, cc].tolist()
        assert got["query"] == ref[rr, :].tolist()


def _reference_merge(fn, r):
    """The reference's merge under shard_map over ``r`` virtual devices:
    every shard's merged (Q, K) lists, stacked (R, Q, K)."""
    d, lab, ids = seeded_lists(r)
    mesh = Mesh(np.asarray(jax.devices()[:r]), ("data",))

    def local(dd, ll, ii):
        top = fn(RefTopK(dd[0], ll[0], ii[0]), K, "data")
        return top.dists[None], top.labels[None], top.ids[None]

    f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"),) * 3,
                          out_specs=(P("data"),) * 3, check_vma=False))
    return [np.asarray(x) for x in f(d, lab, ids)]


@pytest.mark.parametrize("r", [4, 1])
@pytest.mark.parametrize("name", ["allgather", "ring"])
def test_merge_equals_reference_bit_for_bit(ranks, name, r):
    """The seeded lists (distance ties, -1 sentinels) merged across a
    gloo data-axis group of ``r`` ranks equal the reference's merge on
    ``r`` virtual devices: every rank's lists, bit for bit (the float32
    distances compared as bits). Tolerance: none."""
    fn = {"allgather": ref_coll.allgather_merge_topk,
          "ring": ref_coll.ring_allreduce_topk}[name]
    want = _reference_merge(fn, r)
    shape = (4, 2) if r == 4 else (1, 8)
    for rank, npz in enumerate(ranks["npz"]):
        rr = ranks["layout"][rank][f"{shape[0]}x{shape[1]}"]["coords"][0]
        got = [npz[f"{name}_R{r}_{f}"] for f in "dli"]
        assert np.array_equal(got[0].view(np.int32),
                              want[0][rr].view(np.int32)), (rank, rr)
        assert np.array_equal(got[1], want[1][rr]), (rank, rr)
        assert np.array_equal(got[2], want[2][rr]), (rank, rr)


@pytest.mark.parametrize("name", ["allgather", "ring"])
def test_query_axis_gather_concatenates_in_column_order(ranks, name):
    """Row 0's merged lists gathered over its query-axis group arrive on
    rank 0 concatenated along the queries in column order."""
    npz = ranks["npz"]
    for r, c in ((4, 2), (1, 8)):
        want = [np.concatenate([npz[j][f"{name}_R{r}_{f}"]
                                for j in range(c)]) for f in "dli"]
        got = [npz[0][f"gather_{name}_R{r}_{f}"] for f in "dli"]
        for g, w in zip(got, want):
            assert np.array_equal(g.view(np.int32), w.view(np.int32))


def test_scatter_broadcast_and_object_gather(ranks):
    """The root's scatter gives rank i its part, the broadcast every rank
    the root's object, and the object gather rank 0 every rank's in rank
    order."""
    for rank, npz in enumerate(ranks["npz"]):
        assert np.array_equal(npz["scatter"], np.full((3, 2), rank))
        assert int(npz["bcast"]) == 42
    assert ranks["npz"][0]["gathered_ranks"].tolist() == list(range(WORLD))
