"""The port's dp x tp train step over gloo ranks against its one-rank run
and the reference's ``dp_tp`` run on the conftest's virtual devices.

One module-scoped spawn of 4 gloo ranks on the CPU (every process group
with a 60 s timeout) runs the meshes (2, 2), (4, 1) and (1, 2) (the last
on ranks 0 and 1, as the reference's mesh takes the first devices): the
reference's initial parameters carried across with ``params_from_jax``,
the same numpy batches split over dp, 3 SGD steps, the first one under
``obs.hlo``'s collective record; then the same meshes with bf16 compute.
Then the loop itself on (2, 2): checkpoints (sharded DCP) and a resumed
run. Tolerance: ``rtol=2e-5`` (the reference's ``dryrun.py:49``;
parameters also ``atol=1e-7`` for entries near zero); for bf16, see
:func:`test_bf16_mesh_equals_one_rank_and_reference`.

The record's dp all-reduce bytes equal ``obs.comms.train_step_comms``
exactly at tp = 1. At tp > 1 the reference's model divides every
gradient by tp (``dmlp_tpu/obs/comms.py:283-291``), but the row-parallel
layers' biases are replicated over tp, so each rank's dp payload exceeds
the model's by those biases' other shards: 128 floats (512 bytes) at
dims 64,256,256,10 with tp = 2 (ROADMAP queue C).
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dmlp_tpu.train import model as ref_model  # noqa: E402
from dmlp_tpu.train.loop import build_sharded_state as ref_build  # noqa: E402
from dmlp_tpu.train.sharding import (batch_shardings,  # noqa: E402
                                     make_train_mesh)
from dmlp_tpu.train.step import make_optimizer as ref_opt  # noqa: E402
from dmlp_tpu.train.step import make_train_step as ref_step  # noqa: E402
from dmlp_tpu_torch.obs import comms  # noqa: E402
from dmlp_tpu_torch.train import step as port_step  # noqa: E402
from dmlp_tpu_torch.train.loop import build_sharded_state  # noqa: E402
from dmlp_tpu_torch.train.model import params_from_jax  # noqa: E402

from test_torch_mesh import spawn_ranks  # noqa: E402

DIMS = [64, 256, 256, 10]
BATCH, STEPS, LR, SEED = 32, 3, 0.05, 3
SHAPES = [(2, 2), (4, 1), (1, 2)]
WORLD = 4

RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlp_tpu_torch.obs import hlo
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.train import loop, sharding, step as S

work = sys.argv[1]
initialize(auto=True, device="cpu", timeout_s=60)
rank = dist.get_rank()
cfg = json.load(open(work + "/cfg.json"))
init = np.load(work + "/init.npz")
params = {k: torch.from_numpy(init[k]) for k in init.files}
batches = np.load(work + "/batches.npz")
opt = S.make_optimizer("sgd", cfg["lr"])
out = {}
for dtype, shapes in (("float32", cfg["shapes"]), ("bfloat16", cfg["bf16"])):
    cdtype = torch.bfloat16 if dtype == "bfloat16" else None
    for dp, tp in shapes:
        tag = f"{dp}x{tp}" + ("_bf16" if cdtype else "")
        mesh = sharding.make_train_mesh((dp, tp), "cpu")
        inside = sharding.in_mesh(mesh)
        if inside:
            state = loop.build_sharded_state(mesh, cfg["dims"], opt,
                                             params=params, device="cpu")
            fn = S.make_train_step(opt, cdtype, sharding.dp_group(mesh))
        losses = []
        for i in range(cfg["steps"]):
            if inside:
                x, y = sharding.batch_slice(batches[f"x{i}"],
                                            batches[f"y{i}"], mesh)
                x, y = torch.from_numpy(x), torch.from_numpy(y)
            if i == 0 and cdtype is None:
                # every rank of the group takes part in the record
                with hlo.recording(mesh=mesh if inside else None,
                                   device="cpu", label="train.step") as rec:
                    if inside:
                        state, m = fn(state, x, y)
                mine = [op for op in rec.ops
                        if op["kind"] == "all-reduce" and op["axis"] == "dp"]
                out[f"{tag}_dp_operand"] = np.asarray(
                    sum(op["operand_bytes"] for op in mine))
                if rank == 0:
                    out[f"{tag}_by_axis"] = np.asarray(json.dumps(
                        loop.hlo_event(rec.report)["by_axis"]))
            elif inside:
                state, m = fn(state, x, y)
            if inside:
                losses.append(S.global_metrics(
                    m, sharding.dp_group(mesh))["loss"])
        if inside:
            full = {}
            for name, p in state["params"].named_parameters():
                t = p.detach()
                whole = sharding.full_tensor(t)   # gathered by an all-reduce
                if hasattr(t, "full_tensor"):
                    assert torch.equal(whole, t.full_tensor()), name
                full[name] = whole.numpy()
            out[f"{tag}_local_bytes"] = np.asarray(
                sharding.local_param_bytes(state["params"]))
            out[f"{tag}_coord"] = np.asarray(mesh.get_coordinate())
            if rank == 0:
                out[f"{tag}_losses"] = np.asarray(losses)
                for name, a in full.items():
                    out[f"{tag}_param_{name}"] = a
        dist.barrier()

# The loop on (2, 2): 3 steps with checkpoints at 2 and 3; 2 steps, then
# 1 resumed; a fresh state restored from each of the first run's steps.
kw = dict(batch=cfg["batch"], dims=tuple(cfg["dims"]), mesh_shape=(2, 2),
          lr=cfg["lr"], log_every=1, device="cpu", seed=5)
whole, _ = loop.train(steps=3, checkpoint_dir=work + "/ck_a", ckpt_every=2,
                      **kw)
two, _ = loop.train(steps=2, checkpoint_dir=work + "/ck_b", ckpt_every=2,
                    **kw)
sums = [loop._params_checksum(whole), loop._params_checksum(two)]
resumed, _ = loop.train(steps=1, checkpoint_dir=work + "/ck_b",
                        resume=True, **kw)
from dmlp_tpu_torch.train import checkpoint as ck
restored = loop.build_sharded_state(sharding.make_train_mesh((2, 2), "cpu"),
                                    cfg["dims"], opt, seed=9, device="cpu")
steps = [whole["step"], two["step"], resumed["step"]]
for at in (2, None):
    ck.restore_checkpoint(work + "/ck_a", restored, step=at)
    steps.append(restored["step"])
    sums.append(loop._params_checksum(restored))
out["loop_steps"] = np.asarray(steps)
out["loop_sums"] = np.asarray(sums)
np.savez(work + f"/rank{rank}.npz", **out)
shutdown()
"""


def _batches():
    rng = np.random.default_rng(11)
    return [(rng.normal(size=(BATCH, DIMS[0])).astype(np.float32),
             rng.integers(0, DIMS[-1], BATCH).astype(np.int32))
            for _ in range(STEPS)]


def _reference(shape, compute_dtype=None):
    """The reference's dp_tp run: per-step losses, final params."""
    dp, tp = shape
    mesh = make_train_mesh(shape, jax.devices()[:dp * tp])
    opt = ref_opt("sgd", LR)
    state = ref_build(mesh, DIMS, opt, seed=SEED)
    fn = ref_step(opt, compute_dtype)
    xsh, ysh = batch_shardings(mesh)
    losses = []
    for x, y in _batches():
        state, m = fn(state, jax.device_put(x, xsh), jax.device_put(y, ysh))
        losses.append(float(m["loss"]))
    params = jax.tree.map(np.array, state["params"])
    return np.asarray(losses), {f"{l}.{k}": params[l][k]
                                for l in params for k in params[l]}


def _port_one_rank(compute_dtype=None):
    init = jax.tree.map(np.asarray,
                        ref_model.init_mlp(jax.random.PRNGKey(SEED), DIMS))
    opt = port_step.make_optimizer("sgd", LR)
    state = build_sharded_state(None, DIMS, opt,
                                params=params_from_jax(init), device="cpu")
    fn = port_step.make_train_step(opt, compute_dtype)
    losses = []
    for x, y in _batches():
        state, m = fn(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(port_step.global_metrics(m)["loss"])
    return np.asarray(losses), {k: v.detach().numpy().copy() for k, v in
                                state["params"].named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_mesh")
    init = jax.tree.map(np.asarray,
                        ref_model.init_mlp(jax.random.PRNGKey(SEED), DIMS))
    np.savez(work / "init.npz", **{k: v.numpy() for k, v in
                                   params_from_jax(init).items()})
    np.savez(work / "batches.npz",
             **{f"{n}{i}": a for i, xy in enumerate(_batches())
                for n, a in zip("xy", xy)})
    (work / "cfg.json").write_text(json.dumps(
        {"dims": DIMS, "batch": BATCH, "steps": STEPS, "lr": LR,
         "shapes": SHAPES, "bf16": SHAPES}))
    spawn_ranks(work, RANK_SCRIPT, WORLD, timeout=180)
    return {"ranks": [dict(np.load(work / f"rank{r}.npz"))
                      for r in range(WORLD)],
            "one": _port_one_rank(),
            "one_bf16": _port_one_rank(torch.bfloat16),
            "init": {k: v.numpy() for k, v in
                     params_from_jax(init).items()},
            "ref": {s: _reference(s) for s in SHAPES + [(1, 1)]},
            "ref_bf16": {s: _reference(s, jnp.bfloat16)
                         for s in SHAPES + [(1, 1)]}}


def change_err(got, want, start):
    """The distance of the parameter change ``got - start`` from ``want -
    start``, relative to the latter's norm."""
    return np.linalg.norm(got - want) / np.linalg.norm(want - start)


def _port(runs, shape, suffix=""):
    tag = f"{shape[0]}x{shape[1]}{suffix}"
    r0 = runs["ranks"][0]
    params = {k[len(tag) + 7:]: v for k, v in r0.items()
              if k.startswith(f"{tag}_param_")}
    return r0[f"{tag}_losses"], params


def test_one_rank_equals_reference(runs):
    losses, params = runs["one"]
    ref_losses, ref_params = runs["ref"][(1, 1)]
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-5)
    for k in ref_params:
        np.testing.assert_allclose(params[k], ref_params[k], rtol=2e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_equals_one_rank_and_reference(runs, shape):
    losses, params = _port(runs, shape)
    one_losses, one_params = runs["one"]
    ref_losses, ref_params = runs["ref"][shape]
    np.testing.assert_allclose(losses, one_losses, rtol=2e-5)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-5)
    assert sorted(params) == sorted(ref_params)
    for k in ref_params:
        np.testing.assert_allclose(params[k], one_params[k], rtol=2e-5,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(params[k], ref_params[k], rtol=2e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bf16_mesh_equals_one_rank_and_reference(runs, shape):
    """The bf16 compute path on the mesh: each rank's local bf16
    products, the weight gradients rounded after the dp sum and a
    column-parallel layer's input gradient after the tp sum, as the
    reference rounds the whole sums. Only the f32 accumulation order
    differs from the one-rank run, and bf16 roundings it flips move the
    parameter change by about 1e-5 of its norm; against the reference's
    dp_tp run (another library's f32 order) by about 4e-4. Rounding the
    weight gradients before the dp sum moves it by 2e-3 to 5e-3, rounding
    a column-parallel input gradient before the tp sum by up to 7e-3
    (:func:`change_err`)."""
    losses, params = _port(runs, shape, "_bf16")
    one_losses, one_params = runs["one_bf16"]
    ref_losses, ref_params = runs["ref_bf16"][shape]
    np.testing.assert_allclose(losses, one_losses, rtol=2e-5)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert sorted(params) == sorted(ref_params)
    for k in ref_params:
        init = runs["init"][k]
        assert params[k].dtype == np.float32   # f32 storage
        assert change_err(params[k], one_params[k], init) < 1e-4, k
        assert change_err(params[k], ref_params[k], init) < 2e-3, k


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_layout_and_local_shards(runs, shape):
    """Row-major coordinates (rank r * tp + c at (r, c)), and each rank's
    parameter bytes: the tp shards plus the replicated row biases."""
    dp, tp = shape
    pbytes = sum(a * b + b for a, b in zip(DIMS[:-1], DIMS[1:])) * 4
    row_bias = sum(DIMS[i + 1] for i in range(1, len(DIMS) - 1, 2)) * 4
    for rank in range(dp * tp):
        got = runs["ranks"][rank]
        tag = f"{dp}x{tp}"
        assert got[f"{tag}_coord"].tolist() == [rank // tp, rank % tp]
        want = pbytes if tp == 1 else \
            pbytes // tp + row_bias - row_bias // tp
        assert int(got[f"{tag}_local_bytes"]) == want


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dp_allreduce_record_against_the_model(runs, shape):
    dp, tp = shape
    tag = f"{dp}x{tp}"
    pbytes = sum(a * b + b for a, b in zip(DIMS[:-1], DIMS[1:])) * 4
    model = comms.train_step_comms(pbytes, shape, steps=1)
    by_axis = json.loads(str(runs["ranks"][0][f"{tag}_by_axis"]))
    record = by_axis.get("all-reduce@dp", 0)
    if dp == 1:
        assert model == [] and record == 0
        assert by_axis.get("all-reduce@tp", 0) > 0
        return
    (psum,) = model
    payload = pbytes // tp           # the model's per-group payload
    for rank in range(dp * tp):
        got = int(runs["ranks"][rank][f"{tag}_dp_operand"])
        assert got - payload == (0 if tp == 1 else 512), (rank, got)
    excess = 0 if tp == 1 else dp * tp * round(2 * (dp - 1) * 512 / dp)
    assert record == psum.bytes_total + excess
    if tp > 1:
        assert by_axis["all-reduce@tp"] > 0   # DTensor's, unmodelled


def test_loop_checkpoints_and_resume_on_the_mesh(runs):
    """Sharded DCP checkpoints of the loop on (2, 2): a fresh state
    restored from the 3-step run's step 2 holds the 2-step run's
    parameters bit for bit, and from its latest step (3) the 3-step run's;
    a run resumed at step 2 counts on to 3. Every rank agrees."""
    for r in range(WORLD):
        got = runs["ranks"][r]
        assert got["loop_steps"].tolist() == [3, 2, 3, 2, 3]
        sum_whole, sum_two, sum_r2, sum_r3 = (str(s)
                                              for s in got["loop_sums"])
        assert sum_r2 == sum_two and sum_r3 == sum_whole
        assert sum_two != sum_whole
        assert got["loop_sums"].tolist() == \
            runs["ranks"][0]["loop_sums"].tolist()
