"""The port's MoE family (``dmlp_tpu_torch.train.experts``) over gloo
ranks against the reference's ``dmlp_tpu.train.experts`` on the
conftest's virtual devices, and the dry run and the sweep.

One module-scoped spawn of 8 gloo ranks on the CPU (every process group
with a 60 s timeout) runs the reference's parametrisations, each mesh on
the first ranks: the dense one-hot dispatch and the capacity +
all-to-all dispatch at full capacity (no drop) on (dp, ep) = (1, 4), (2,
2), (2, 4); the capacity-1 drop case of the reference
(``tests/test_train_experts.py:126``); and one 2-step Adam case a
dispatch. The reference's initial parameters are carried across with
numpy, the same numpy batches split as each reference step splits them
(over dp for dense, over dp x ep for a2a), 3 SGD steps (momentum 0.9), the
first under ``obs.hlo``'s collective record. Losses and parameters are
held at ``rtol=2e-5`` (parameters also ``atol=1e-7``).

The record against ``obs.comms.train_step_comms``: the dense combine's
``all-reduce@ep`` is the forward's all-reduce the model prices plus the
backward's, of the same bytes; the a2a's ``all-to-all@ep`` is the
forward's three all-to-alls the model prices (tokens out, int32 slot
metadata, tokens back) exactly, plus the backward's two token
all-to-alls, which it does not price: 2 x ep x capacity x hidden x 4
bytes x (ep - 1) / ep a rank.

Then the loop CLI on a (2, 2) ep mesh (a2a dispatch) with checkpoints,
the NaN guard and ``--resume``; ``dryrun_train`` on 4 ranks and the
sweep at mesh sizes 1 and 2 in one 4-rank spawn.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dmlp_tpu.train import experts as ref  # noqa: E402
from dmlp_tpu.train.step import make_optimizer as ref_opt  # noqa: E402
from dmlp_tpu_torch.obs import comms  # noqa: E402
from dmlp_tpu_torch.train import experts as ex  # noqa: E402
from dmlp_tpu_torch.train import loop  # noqa: E402

from test_torch_mesh import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEPS, LR, WORLD, EXPERTS = 3, 0.05, 8, 8
DENSE_DIMS, A2A_DIMS = (6, 16, 24, 4), (5, 12, 20, 3)


def _case(dispatch, mesh, opt="sgd", steps=STEPS, bl=16, capacity=None,
          seed=None):
    dims = DENSE_DIMS if dispatch == "dense" else A2A_DIMS
    tag = f"{dispatch}_{mesh[0]}x{mesh[1]}" + \
        (f"_cap{capacity}" if capacity is not None else "") + \
        ("" if opt == "sgd" else f"_{opt}")
    return {"id": tag, "dispatch": dispatch, "mesh": list(mesh),
            "dims": list(dims), "opt": opt,
            "lr": LR if opt == "sgd" else 1e-3, "steps": steps,
            "bl": bl, "capacity": bl if capacity is None else capacity,
            "seed": seed if seed is not None else
            (11 if dispatch == "dense" else 21)}


MESHES = [(1, 4), (2, 2), (2, 4)]
CASES = ([_case("dense", m) for m in MESHES]
         + [_case("a2a", m) for m in MESHES]
         + [_case("a2a", (1, 4), bl=4, capacity=1, seed=3),
            _case("dense", (2, 2), "adam", steps=2),
            _case("a2a", (2, 2), "adam", steps=2)])
DROP = "a2a_1x4_cap1"

RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlp_tpu_torch.obs import hlo
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.train import experts as ex, loop, pipeline as pl
from dmlp_tpu_torch.train import step as S
from dmlp_tpu_torch.train.model import params_from_jax
from dmlp_tpu_torch.train.sharding import batch_slice, full_tensor, in_mesh

work = sys.argv[1]
initialize(auto=True, device="cpu", timeout_s=60)
rank = dist.get_rank()
cfg = json.load(open(work + "/cfg.json"))
for case in cfg["cases"]:
    tag, a2a = case["id"], case["dispatch"] == "a2a"
    d_in, hidden, ffn, classes = case["dims"]
    data = np.load(f"{work}/{tag}_in.npz")
    init = params_from_jax({k[5:]: data[k] for k in data.files
                            if k.startswith("init_")})
    opt = S.make_optimizer(case["opt"], case["lr"])
    mesh = ex.make_ep_mesh(*case["mesh"], "cpu")
    inside = in_mesh(mesh)
    if inside:
        state = ex.build_moe_state(mesh, opt, d_in, hidden, ffn, classes,
                                   cfg["experts"], params=init, device="cpu")
        if a2a:
            fn = ex.make_moe_a2a_train_step(
                mesh, opt, n_experts=cfg["experts"], n_classes=classes,
                capacity=case["capacity"])
        else:
            fn = ex.make_moe_train_step(mesh, opt, n_experts=cfg["experts"],
                                        n_classes=classes)
    cut = ex.a2a_batch_slice if a2a else batch_slice
    out, losses, drops = {}, [], []
    for i in range(case["steps"]):
        if inside:
            x, y = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                    cut(data[f"x{i}"], data[f"y{i}"], mesh))
        if i == 0:
            with hlo.recording(mesh=mesh if inside else None, device="cpu",
                               label="train.step",
                               axes=pl.mesh_axes(mesh) if inside else None
                               ) as rec:
                if inside:
                    state, m = fn(state, x, y)
            if rank == 0:
                out["by_axis"] = np.asarray(json.dumps(
                    loop.hlo_event(rec.report)["by_axis"]))
        elif inside:
            state, m = fn(state, x, y)
        if inside:
            losses.append(fn.global_metrics(m)["loss"])
            if a2a:
                d = m["dropped"].reshape(1).clone()
                dist.all_reduce(d, group=pl.world_group(mesh))
                drops.append(int(d))
    if inside:
        full = {n: full_tensor(p.detach()).numpy()
                for n, p in state["params"].named_parameters()}
        if rank == 0:
            out["losses"] = np.asarray(losses)
            out["drops"] = np.asarray(drops)
            out.update({f"param_{n}": a for n, a in full.items()})
            np.savez(f"{work}/{tag}_out.npz", **out)
    dist.barrier()
shutdown()
"""

DRY_SCRIPT = r"""
import io, json, sys
import torch.distributed as dist
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.train import dryrun, sweep

work = sys.argv[1]
initialize(auto=True, device="cpu", timeout_s=60)
rank = dist.get_rank()
got = dryrun.dryrun_train(device="cpu")
buf = io.StringIO()
points = sweep.run_sweep([1, 2], (16, 32, 32, 4), 16, 2, dtype=None,
                         out=buf if rank == 0 else None, device="cpu")
with open(f"{work}/dry{rank}.json", "w") as f:
    json.dump({"dryrun": got, "points": points,
               "lines": buf.getvalue().splitlines()}, f)
shutdown()
"""


def _reference(case):
    """The reference's run of ``case``: initial parameters, batches,
    per-step losses, final parameters, and (a2a) each step's dropped
    tokens from its routing."""
    dp, ep = case["mesh"]
    d_in, hidden, ffn, classes = case["dims"]
    opt = ref_opt(case["opt"], case["lr"])
    mesh = ref.make_ep_mesh(dp, ep, jax.devices()[:dp * ep])
    state = ref.build_moe_state(mesh, opt, d_in, hidden, ffn, classes,
                                EXPERTS, seed=case["seed"])
    init = {k: np.array(v) for k, v in state["params"].items()}
    rng = np.random.default_rng(7)
    a2a = case["dispatch"] == "a2a"
    batch = dp * ep * case["bl"] if a2a else dp * 32
    batches = [(rng.normal(size=(batch, d_in)).astype(np.float32),
                rng.integers(0, classes, batch).astype(np.int32))
               for _ in range(case["steps"])]
    if a2a:
        step = ref.make_moe_a2a_train_step(mesh, opt, n_experts=EXPERTS,
                                           n_classes=classes,
                                           capacity=case["capacity"])
        xsh, ysh = ref.a2a_batch_shardings(mesh)
    else:
        step = ref.make_moe_train_step(mesh, opt, n_experts=EXPERTS,
                                       n_classes=classes)
    losses, drops = [], []
    for x, y in batches:
        if a2a:
            drops.append(_drops(state["params"], x, dp * ep, ep,
                                case["capacity"]))
            state, m = step(state, jax.device_put(jnp.asarray(x), xsh),
                            jax.device_put(jnp.asarray(y), ysh))
        else:
            state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
    return {"init": init, "batches": batches, "losses": np.asarray(losses),
            "drops": np.asarray(drops),
            "params": {k: np.array(v) for k, v in state["params"].items()}}


def _drops(params, x, cells, ep, capacity):
    """Tokens past ``capacity`` per (source cell, destination) under the
    reference's routing (its forward pieces in jnp, as its own drop test
    computes them)."""
    p = {k: jnp.asarray(np.asarray(v)) for k, v in params.items()}
    h = jnp.asarray(x) @ p["in_w"] + p["in_b"]
    sel = np.asarray(jnp.argmax(h @ p["router"], -1))
    per_cell = EXPERTS // ep
    bl = x.shape[0] // cells
    dropped = 0
    for cell in range(cells):
        counts = {}
        for i in range(cell * bl, (cell + 1) * bl):
            d = sel[i] // per_cell
            counts[d] = counts.get(d, 0) + 1
            dropped += counts[d] > capacity
    return dropped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_experts")
    refs = {}
    for case in CASES:
        r = refs[case["id"]] = _reference(case)
        np.savez(work / f"{case['id']}_in.npz",
                 **{f"init_{k}": v for k, v in r["init"].items()},
                 **{f"{n}{i}": a for i, xy in enumerate(r["batches"])
                    for n, a in zip("xy", xy)})
    (work / "cfg.json").write_text(json.dumps(
        {"experts": EXPERTS, "cases": CASES}))
    spawn_ranks(work, RANK_SCRIPT, WORLD, timeout=240)
    return {c["id"]: (refs[c["id"]], dict(np.load(work / f"{c['id']}_out.npz")))
            for c in CASES}


def _ids(cases):
    return [c["id"] for c in cases]


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_step_equals_reference(runs, case):
    """Per-step losses and the final parameters against the reference's
    run of the same dispatch on the same parameters and batches."""
    want, got = runs[case["id"]]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    assert sorted(k[6:] for k in got if k.startswith("param_")) == \
        sorted(want["params"])
    for k, w in want["params"].items():
        np.testing.assert_allclose(got[f"param_{k}"], w, rtol=2e-5,
                                   atol=1e-7, err_msg=k)


def test_capacity_one_drops_to_the_residual(runs):
    """capacity = 1: each cell forwards at most one token a destination;
    the port drops exactly the tokens the reference's routing drops, on
    every step, and there are some."""
    want, got = runs[DROP]
    assert got["drops"].tolist() == want["drops"].tolist()
    assert want["drops"][0] > 0


def test_full_capacity_drops_nothing(runs):
    for case in CASES:
        if case["dispatch"] == "a2a" and case["id"] != DROP:
            assert runs[case["id"]][1]["drops"].tolist() == \
                [0] * case["steps"], case["id"]


SGD_CASES = [c for c in CASES if c["opt"] == "sgd"]


@pytest.mark.parametrize("case", SGD_CASES, ids=_ids(SGD_CASES))
def test_collective_record_against_the_model(runs, case):
    """The first step's record against ``train_step_comms``: the forward
    that the model prices equal to it exactly, the backward beside it."""
    _, got = runs[case["id"]]
    by_axis = json.loads(str(got["by_axis"]))
    dp, ep = case["mesh"]
    hidden = case["dims"][1]
    if case["dispatch"] == "dense":
        tokens = 32                       # the dp row's tokens
        (model,) = [t for t in comms.train_step_comms(
            0, (dp, ep), steps=1, moe_dense={
                "ep": ep, "tokens": tokens, "hidden": hidden})
            if t.collective == "psum_ep_combine"]
        # forward (priced) + the backward's all-reduce of the cotangent
        assert by_axis["all-reduce@ep"] == 2 * model.bytes_total
        assert "all-to-all@ep" not in by_axis
    else:
        cap = case["capacity"]
        (model,) = [t for t in comms.train_step_comms(
            0, (dp, ep), steps=1, moe={
                "ep": ep, "capacity": cap, "hidden": hidden})
            if t.collective == "moe_all_to_all"]
        send = ep * cap * hidden * 4
        backward = dp * ep * round(2 * send * (ep - 1) / ep)
        assert by_axis["all-to-all@ep"] == model.bytes_total + backward
        assert "all-reduce@ep" not in by_axis
    assert by_axis["all-reduce@world"] > 0
    assert ("all-reduce@dp" in by_axis) == (dp > 1)


def test_a2a_helpers_and_refusals():
    for batch, dp, ep, cf in [(4096, 2, 4, 1.25), (64, 1, 4, 4.0),
                              (48, 2, 2, 1.0), (16, 1, 4, 0.1)]:
        assert ex.a2a_capacity(batch, dp, ep, cf) == \
            ref.a2a_capacity(batch, dp, ep, cf)
    assert ex.a2a_capacity(4096, 2, 4, 1.25) == 160
    with pytest.raises(ValueError, match="divisible by dp\\*ep"):
        ex.a2a_capacity(10, 2, 4)
    from dmlp_tpu_torch.train.step import make_optimizer
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        ex.make_moe_a2a_train_step(None, make_optimizer("sgd", 0.1),
                                   n_experts=8, n_classes=3, capacity=0)
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    y = np.arange(8, dtype=np.int32)
    xs, ys = ex.a2a_batch_slice(x, y, None)
    assert (xs == x).all() and (ys == y).all()


def test_one_rank_dispatches_equal_the_reference_forward():
    """Without a process group: one dense and one a2a step (capacity = all
    tokens) on one rank, each loss equal to the unsharded forward's, the
    port against itself."""
    import torch
    import torch.nn.functional as F
    from dmlp_tpu_torch.train.step import make_optimizer
    opt = make_optimizer("sgd", LR)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(24, 5)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 24).astype(np.int32))
    for fn in (ex.make_moe_train_step(None, opt, n_experts=4, n_classes=3),
               ex.make_moe_a2a_train_step(None, opt, n_experts=4,
                                          n_classes=3, capacity=24)):
        st = ex.build_moe_state(None, opt, 5, 12, 20, 3, 4, seed=2,
                                device="cpu")
        full = {n: p.detach().clone()
                for n, p in st["params"].named_parameters()}
        want = F.cross_entropy(ex.moe_reference_forward(full, x), y.long())
        st, m = fn(st, x, y)
        assert fn.global_metrics(m)["loss"] == pytest.approx(want.item(),
                                                             rel=1e-6)


def test_loop_flag_rules():
    kw = dict(steps=1, batch=8, device="cpu")
    with pytest.raises(ValueError, match="dp_ep wants --dims"):
        loop.train(dims=(4, 8, 2), parallelism="dp_ep", **kw)
    with pytest.raises(ValueError, match="moe-dispatch applies to dp_ep"):
        loop.train(dims=(4, 8, 2), parallelism="dp_pp", moe_dispatch="a2a",
                   **kw)
    with pytest.raises(ValueError, match="capacity-factor applies"):
        loop.train(dims=(4, 8, 16, 2), parallelism="dp_ep",
                   capacity_factor=2.0, **kw)
    with pytest.raises(ValueError, match="compute-dtype applies to dp_tp"):
        loop.train(dims=(4, 8, 16, 2), parallelism="dp_ep",
                   compute_dtype="bfloat16", **kw)
    with pytest.raises(ValueError, match="DP,EP for dp_ep"):
        loop.main(["--device", "cpu", "--parallelism", "dp_ep", "--mesh",
                   "1,2,2", "--dims", "4,8,16,2"])


def test_loop_cli_checkpoints_on_an_ep_mesh(tmp_path):
    """The loop CLI on a (2, 2) ep mesh, a2a dispatch (4 gloo ranks): 4
    uninterrupted steps with checkpoints; the same run with a ``nan``
    fault at step 3 rolled back under ``--nan-guard``; a ``--resume`` of
    the first run's latest checkpoint (0 more steps): all three records
    carry the uninterrupted run's ``params_checksum``."""
    sched = tmp_path / "sched.json"
    sched.write_text(json.dumps({"schema": 1, "seed": 0, "faults": [
        {"site": "train.step", "kind": "nan", "when": {"step": 3}}]}))
    common = ["--device", "cpu", "--parallelism", "dp_ep", "--mesh", "2,2",
              "--dims", "6,16,24,4", "--experts", "4", "--moe-dispatch",
              "a2a", "--capacity-factor", "1.5", "--batch", "32",
              "--log-every", "2", "--ckpt-every", "2"]
    recs = {}
    for name, extra in (
            ("whole", ["--steps", "4", "--checkpoint-dir",
                       str(tmp_path / "a")]),
            ("nan", ["--steps", "4", "--checkpoint-dir", str(tmp_path / "b"),
                     "--nan-guard", "--faults", str(sched)]),
            ("resumed", ["--steps", "0", "--resume", "--checkpoint-dir",
                         str(tmp_path / "a")])):
        rec = tmp_path / f"{name}.json"
        p = subprocess.run(
            [sys.executable, "-m", "dmlp_tpu_torch.train.loop", *common,
             *extra, "--record", str(rec)], capture_output=True, text=True,
            cwd=ROOT, timeout=120)
        assert p.returncode == 0, p.stderr[-3000:]
        recs[name] = json.loads(rec.read_text())["metrics"]
    whole = recs["whole"]["params_checksum"]
    assert recs["nan"]["params_checksum"] == whole
    assert recs["nan"]["resilience"]["rollbacks"] == 1
    assert recs["resumed"]["params_checksum"] == whole
    assert recs["whole"]["step"] == 4 and np.isfinite(recs["whole"]["loss"])


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_dryrun")
    spawn_ranks(work, DRY_SCRIPT, 4, timeout=180)
    return [json.loads((work / f"dry{r}.json").read_text())
            for r in range(4)]


def test_dryrun_on_four_ranks(dry):
    """dp x tp against one rank, then dp x pp, the dense and a2a MoE and
    dp x tp x pp against their oracles at rtol 2e-5 (``dryrun_train``
    raises otherwise); every rank agrees on the losses."""
    got = dry[0]["dryrun"]
    assert set(got) == {"dp_tp", "dp_pp", "dp_ep_dense", "dp_ep_a2a",
                        "dp_pp3"}
    a, b = got["dp_tp"]
    assert np.isfinite([a, b]).all() and b < a
    # no drop at cf = ep: the a2a loss is the dense one's
    assert got["dp_ep_a2a"] == pytest.approx(got["dp_ep_dense"], rel=2e-5)
    for r in dry[1:]:
        assert r["dryrun"] == got


def test_sweep_at_mesh_sizes_one_and_two(dry):
    """The weak-scaling sweep over the first 1 and 2 ranks: per-rung
    records with the global batch growing with the mesh, the
    decomposition's summary line, and the plumbing-only scope on the
    CPU."""
    lines = [json.loads(ln) for ln in dry[0]["lines"]]
    points, summary = lines[:2], lines[2]
    assert [p["n_chips"] for p in points] == [1, 2]
    assert [p["global_batch"] for p in points] == [16, 32]
    for p in points:
        assert p["samples_per_sec_per_chip"] > 0 and p["dtype"] == "float32"
        assert p["device"] == "cpu" and p["backend"] == "gloo"
    assert [r["n_chips"] for r in summary["per_rung_comm"]] == [1, 2]
    assert summary["per_rung_comm"][0]["comm_overhead_ms"] == 0.0
    assert summary["summary"]["model"].startswith("step_ms")
    assert summary["scope"].startswith("plumbing-only")
    assert [p["n_chips"] for p in dry[1]["points"]] == [2]
    assert dry[2]["points"] == [] and dry[2]["lines"] == []
