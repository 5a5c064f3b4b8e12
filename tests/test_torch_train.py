"""The port's train extension (``dmlp_tpu_torch.train``, the dp x tp
family) against the reference's ``dmlp_tpu.train`` on one rank: the
forward, SGD and Adam steps in f32 and the bf16 compute path, the data
streams, the parameter checksum, the FLOP, throughput, comms and memory
models, checkpoints and the offload levels.

Parameters are carried across with ``params_from_jax`` and batches come
from the same numpy seeds; the JAX side runs on the CPU as
``tests/test_train.py`` runs it. Tolerances: f32 logits ``rtol=1e-5,
atol=1e-6``; SGD steps ``rtol=1e-5`` (params also ``atol=1e-7``, for
entries near zero); Adam steps ``rtol=1e-4, atol=1e-6`` (optax and
PyTorch order the bias corrections differently); the bf16 compute path's
forward loss ``rtol=1e-2``, its steps' losses ``rtol=1e-4`` and their
parameter changes within 1e-4 (SGD) and 3e-4 (Adam) of their norm;
everything within the port (offload, checkpoints) bit for bit.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dmlp_tpu.obs import comms as ref_comms  # noqa: E402
from dmlp_tpu.obs import memwatch as ref_memwatch  # noqa: E402
from dmlp_tpu.train import data as ref_data  # noqa: E402
from dmlp_tpu.train import metrics as ref_metrics  # noqa: E402
from dmlp_tpu.train import model as ref_model  # noqa: E402
from dmlp_tpu.train import step as ref_step  # noqa: E402
from dmlp_tpu.train.loop import _params_checksum as ref_checksum  # noqa: E402
from dmlp_tpu_torch.obs import comms, memwatch  # noqa: E402
from dmlp_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from dmlp_tpu_torch.train import data, metrics, model, step  # noqa: E402
from dmlp_tpu_torch.train.loop import (_params_checksum,  # noqa: E402
                                       build_sharded_state,
                                       resolve_offload_level)

DIMS = (8, 32, 32, 5)


def ref_params(dims=DIMS, seed=0):
    """The reference's He init, as numpy arrays."""
    return jax.tree.map(np.asarray,
                        ref_model.init_mlp(jax.random.PRNGKey(seed), dims))


def port_model(np_params, dims=DIMS):
    m = model.init_mlp(torch.Generator().manual_seed(0), dims, device="cpu")
    m.load_state_dict(model.params_from_jax(np_params))
    return m


def leaves(m):
    """Copies: the step updates the parameters in place."""
    return {k: v.detach().numpy().copy() for k, v in m.named_parameters()}


def batch(n=16, na=DIMS[0], nc=DIMS[-1], seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, na)).astype(np.float32),
            rng.integers(0, nc, n).astype(np.int32))


def test_params_from_jax_keeps_names_and_layout():
    p = ref_params()
    m = port_model(p)
    got = leaves(m)
    assert sorted(got) == sorted(f"{l}.{k}" for l in p for k in p[l])
    for l in p:
        for k in p[l]:
            assert np.array_equal(got[f"{l}.{k}"], p[l][k])
    assert got["layer0.w"].shape == (DIMS[0], DIMS[1])


def test_forward_f32_equals_reference():
    p = ref_params()
    x, _ = batch()
    want = np.asarray(ref_model.mlp_apply(p, x))
    got = port_model(p)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_forward_bf16_logits_stay_f32_and_track_reference():
    p = ref_params()
    x, y = batch()
    want = np.asarray(ref_model.mlp_apply(p, x, jnp.bfloat16))
    got = port_model(p)(torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.float32
    loss_ref = float(jnp.mean(
        -jax.nn.log_softmax(want)[np.arange(len(y)), y]))
    loss = float(torch.nn.functional.cross_entropy(
        got.detach(), torch.from_numpy(y).long()))
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-2)


def test_matmul_f32_on_cpu_is_the_upcast_product():
    """The CPU plain form of the bf16 product: the bf16-rounded operands
    upcast, an f32 product (the CUDA form is ``mm.dtype``)."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 32)).astype(np.float32))
    hb, wb = h.bfloat16(), w.bfloat16()
    got = model.matmul_f32(hb, wb)
    assert got.dtype == torch.float32
    assert torch.equal(got, hb.float() @ wb.float())
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(h.numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.numpy()).astype(jnp.bfloat16),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def _run_both(opt_name, cdtype, steps=5, lr=1e-2):
    """(reference, port) per-step (loss, accuracy, params)."""
    p = ref_params()
    x, y = batch(32)
    ro = ref_step.make_optimizer(opt_name, lr)
    rs = ref_step.init_state(ref_model.init_mlp(jax.random.PRNGKey(0),
                                                DIMS), ro)
    rfn = ref_step.make_train_step(ro, jnp.bfloat16 if cdtype else None)
    po = step.make_optimizer(opt_name, lr)
    ps = step.init_state(port_model(p), po)
    pfn = step.make_train_step(po, torch.bfloat16 if cdtype else None)
    ref, port = [], []
    for _ in range(steps):
        rs, rm = rfn(rs, x, y)
        # Copies: the reference's step donates its state.
        ref.append((float(rm["loss"]), float(rm["accuracy"]),
                    jax.tree.map(np.array, rs["params"])))
        ps, pm = pfn(ps, torch.from_numpy(x), torch.from_numpy(y))
        g = step.global_metrics(pm)
        port.append((g["loss"], g["accuracy"], leaves(ps["params"])))
    assert ps["step"] == int(rs["step"]) == steps
    return ref, port


@pytest.mark.parametrize("opt_name,rtol,atol", [("sgd", 1e-5, 1e-7),
                                                ("adam", 1e-4, 1e-6)])
def test_five_f32_steps_equal_reference(opt_name, rtol, atol):
    ref, port = _run_both(opt_name, None)
    for i, ((rl, ra, rp), (pl, pa, pp)) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(pl, rl, rtol=rtol, err_msg=f"step {i}")
        assert pa == ra, (i, pa, ra)
        for l in rp:
            for k in rp[l]:
                np.testing.assert_allclose(pp[f"{l}.{k}"], rp[l][k],
                                           rtol=rtol, atol=atol,
                                           err_msg=f"step {i} {l}.{k}")


def change_err(got, want, start):
    """The distance of the parameter change ``got - start`` from ``want -
    start``, relative to the latter's norm."""
    return np.linalg.norm(got - want) / np.linalg.norm(want - start)


@pytest.mark.parametrize("opt_name,tol", [("sgd", 1e-4), ("adam", 3e-4)])
def test_bf16_compute_steps_track_reference(opt_name, tol):
    """Loss and parameters after each of 5 bf16 steps. Only the f32
    accumulation order differs from the reference: the parameter change
    is within about 1e-6 (SGD) and 1e-4 (Adam, whose update magnifies
    small gradients) of its norm, where a gradient rounded to bf16 before
    its products, weight gradients left unrounded or bf16 accumulation
    move it by 1e-3 or more (:func:`change_err`)."""
    ref, port = _run_both(opt_name, "bf16")
    init = ref_params()
    for i, ((rl, _, rp), (pl, _, pp)) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(pl, rl, rtol=1e-4, err_msg=f"step {i}")
        for l in rp:
            for k in rp[l]:
                got = pp[f"{l}.{k}"]
                assert got.dtype == np.float32   # f32 storage
                assert change_err(got, rp[l][k], init[l][k]) < tol, \
                    (i, l, k)


def test_bf16_product_and_gradients_equal_reference():
    """One bf16 product with an f32 cotangent: the output, the
    activation's gradient and the weight's (rounded as the step rounds
    it) against ``jax.vjp`` of the reference's ``dot_general``."""
    rng = np.random.default_rng(2)
    h = rng.normal(size=(48, 96)).astype(np.float32)
    w = rng.normal(size=(96, 24)).astype(np.float32)
    g = rng.normal(size=(48, 24)).astype(np.float32)
    hj = jnp.asarray(h).astype(jnp.bfloat16)
    out, vjp = jax.vjp(lambda a, b: jax.lax.dot_general(
        a, b.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32), hj, jnp.asarray(w))
    want_gh, want_gw = (np.asarray(t, np.float32) for t in vjp(
        jnp.asarray(g)))
    ht = torch.from_numpy(h).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = model.matmul_f32(ht, wt)
    gh, gw = torch.autograd.grad(got, (ht, wt), torch.from_numpy(g))
    model.round_weight_grads(["layer0.w"], [gw], torch.bfloat16)
    assert gh.dtype == torch.bfloat16 and gw.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    # Both round to bf16 at the end: at most one bf16 step apart.
    for a, b in ((gh.float(), want_gh), (gw, want_gw)):
        np.testing.assert_allclose(a.numpy(), b, rtol=2 ** -7, atol=1e-5)
        assert np.mean(a.numpy() != b) < 0.01


def test_split_bf16_sums_exactly():
    """The CUDA form's split of an f32 operand: three bf16 parts whose sum
    is the f32 value exactly."""
    rng = np.random.default_rng(3)
    t = torch.from_numpy((rng.normal(size=4096)
                          * 10.0 ** rng.uniform(-20, 20, 4096))
                         .astype(np.float32))
    parts = model.split_bf16(t)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    total = sum(p.double() for p in parts)
    assert torch.equal(total, t.double())


def test_loss_decreases_on_teacher_task():
    o = step.make_optimizer("sgd", 0.1)
    st = build_sharded_state(None, (8, 32, 4), o, seed=1, device="cpu")
    fn = step.make_train_step(o)
    it = data.teacher_batches(8, 4, 256, seed=2)
    for _ in range(60):
        x, y = next(it)
        st, m = fn(st, torch.from_numpy(x), torch.from_numpy(y))
    g = step.global_metrics(m)
    assert g["loss"] < 1.0 and g["accuracy"] > 0.5


@pytest.mark.parametrize("args", [(4, 3, 8, 7), (64, 10, 33, 1),
                                  (1, 2, 5, 0)])
def test_teacher_batches_byte_identical(args):
    a, b = ref_data.teacher_batches(*args), data.teacher_batches(*args)
    for _ in range(3):
        (rx, ry), (px, py) = next(a), next(b)
        assert rx.tobytes() == px.tobytes() and rx.dtype == px.dtype
        assert ry.tobytes() == py.tobytes() and ry.dtype == py.dtype


def test_knn_input_batches_byte_identical():
    from dmlp_tpu_torch.io.datagen import generate_input_text
    from dmlp_tpu_torch.io.grammar import parse_input_text
    inp = parse_input_text(generate_input_text(50, 2, 4, 0, 1, 1, 3, 4))
    a = ref_data.knn_input_batches(inp, batch_size=16, seed=5)
    b = data.knn_input_batches(inp, batch_size=16, seed=5)
    for _ in range(7):   # past an epoch boundary
        (rx, ry), (px, py) = next(a), next(b)
        assert rx.tobytes() == px.tobytes() and ry.tobytes() == py.tobytes()
    with pytest.raises(ValueError):
        next(data.knn_input_batches(inp, batch_size=51))


def test_prefetch_to_device_preserves_stream():
    raw = [next(data.teacher_batches(4, 3, 8, seed=s)) for s in range(5)]
    got = list(data.prefetch_to_device(iter(raw), "cpu", depth=2))
    assert len(got) == 5
    for (x0, y0), (xd, yd) in zip(raw, got):
        assert np.array_equal(x0, xd.numpy()) and np.array_equal(y0,
                                                                 yd.numpy())


def test_params_checksum_equals_reference():
    p = ref_params((6, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 3))
    m = port_model(p, (6,) + (16,) * 10 + (3,))   # layer10 sorts early
    assert _params_checksum({"params": m}) == ref_checksum({"params": p})


def test_num_matmul_params_every_family_equals_reference():
    from dmlp_tpu.train.experts import init_moe
    from dmlp_tpu.train.pipeline import init_pipeline, init_pipeline3
    key = jax.random.PRNGKey(0)
    families = [ref_params(),
                init_pipeline(key, 6, 16, 4, 2, 2),
                init_pipeline3(key, 6, 16, 4, 2, 2),
                init_moe(key, 6, 16, 24, 4, 8)]
    for p in families:
        p = jax.tree.map(np.asarray, p)
        assert model.num_matmul_params(p) == ref_model.num_matmul_params(p)
    assert model.num_matmul_params(port_model(ref_params())) == \
        ref_model.num_matmul_params(ref_params())


def test_flops_and_throughput_equal_reference():
    p = ref_params((10, 20, 5))
    m = port_model(p, (10, 20, 5))
    assert metrics.train_step_flops(m, 2) == \
        ref_metrics.train_step_flops(p, 2) == 6.0 * 2 * 300
    for args in [(100, 0.5, 4), (8192, 0.0123, 1)]:
        want = ref_metrics.throughput_metrics(p, *args, peak_per_chip=1e12)
        got = metrics.throughput_metrics(m, *args, peak_per_chip=1e12)
        assert got == want
    assert metrics.peak_flops_per_chip("cpu") == \
        metrics.FALLBACK_PEAK_FLOPS == ref_metrics.FALLBACK_PEAK_FLOPS


COMMS_CASES = {
    "dp_tp_4x1": dict(param_bytes=340008, mesh_shape=(4, 1), steps=3),
    "dp_tp_2x2": dict(param_bytes=340008, mesh_shape=(2, 2), steps=1),
    "dp_tp_1x2": dict(param_bytes=340008, mesh_shape=(1, 2), steps=5),
    "pp": dict(param_bytes=70000, mesh_shape=(2, 4), steps=2,
               pipeline={"pp": 4, "n_micro": 8, "micro_rows": 16,
                         "hidden": 256, "schedule": "gpipe",
                         "n_virtual": 1, "n_groups": 2}),
    "pp_interleaved": dict(param_bytes=70000, mesh_shape=(1, 4), steps=1,
                           pipeline={"pp": 4, "n_micro": 4,
                                     "micro_rows": 8, "hidden": 64,
                                     "schedule": "interleaved",
                                     "n_virtual": 2, "n_groups": 1}),
    "pp3": dict(param_bytes=90000, mesh_shape=(2, 2, 2), steps=3,
                pipeline={"pp": 2, "n_micro": 4, "micro_rows": 8,
                          "hidden": 128, "schedule": "gpipe",
                          "n_virtual": 1, "n_groups": 4, "tp": 2,
                          "n_pairs": 2}),
    "moe_dense": dict(param_bytes=123456, mesh_shape=(2, 4), steps=4,
                      moe_dense={"ep": 4, "hidden": 256, "tokens": 512}),
    "moe_a2a": dict(param_bytes=123456, mesh_shape=(2, 4), steps=4,
                    moe={"ep": 4, "hidden": 256, "capacity": 40}),
}


@pytest.mark.parametrize("case", sorted(COMMS_CASES))
def test_train_step_comms_equal_reference(case):
    kw = COMMS_CASES[case]
    want = [t.to_dict() for t in ref_comms.train_step_comms(**kw)]
    got = [t.to_dict() for t in comms.train_step_comms(**kw)]
    assert [d.pop("senders") for d in got] == [0] * len(got)
    assert got == want
    # The summaries too, past the port's extra "senders" (0: every rank
    # of the axis sends, the reference's convention).
    got_sum = comms.summarize(comms.train_step_comms(**kw))
    for d in got_sum["collectives"]:
        assert d.pop("senders") == 0
    assert got_sum == ref_comms.summarize(ref_comms.train_step_comms(**kw))


MEM_CASES = [
    dict(dims=[64, 256, 256, 10], batch=1024),
    dict(dims=[1024, 8192, 8192, 1024], batch=8192, optimizer="sgd",
         compute_dtype="bfloat16"),
    dict(dims=[64, 512, 512, 10], batch=4096, optimizer="adam",
         mesh_shape=(2, 2)),
    dict(dims=[8, 16, 3], batch=7, mesh_shape=(4, 1), optimizer="sgd"),
]


@pytest.mark.parametrize("i", range(len(MEM_CASES)))
def test_train_step_model_equals_reference(i):
    kw = MEM_CASES[i]
    assert memwatch.train_step_model(**kw) == \
        ref_memwatch.train_step_model(**kw)
    assert memwatch.resident_bytes_model("train", **kw) == \
        ref_memwatch.resident_bytes_model("train", **kw)


def test_checkpoint_roundtrip_restores_in_place(tmp_path):
    o = step.make_optimizer("adam", 1e-2)
    st = build_sharded_state(None, DIMS, o, seed=3, device="cpu")
    fn = step.make_train_step(o)
    x, y = (torch.from_numpy(a) for a in batch(16))
    for _ in range(3):
        st, _ = fn(st, x, y)
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), st)
    assert path.endswith("step_3") and ckpt.latest_step(
        str(tmp_path / "ck")) == 3
    fresh = build_sharded_state(None, DIMS, o, seed=4, device="cpu")
    before = [p.data_ptr() for p in fresh["params"].parameters()]
    ckpt.restore_checkpoint(str(tmp_path / "ck"), fresh)
    assert fresh["step"] == 3
    assert [p.data_ptr() for p in fresh["params"].parameters()] == before
    for a, b in zip(fresh["params"].parameters(), st["params"].parameters()):
        assert torch.equal(a, b)
    for mname in ("mu", "nu"):
        for n in st["opt"][mname]:
            assert torch.equal(fresh["opt"][mname][n], st["opt"][mname][n])
    # The next step from the restored state equals the original's.
    st, m1 = fn(st, x, y)
    fresh, m2 = fn(fresh, x, y)
    assert torch.equal(m1["loss"], m2["loss"])
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), fresh)


@pytest.mark.parametrize("level", ["params", "all"])
@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_offload_levels_equal_resident_bit_for_bit(level, opt_name):
    dims = (6, 16, 16, 4)
    o = step.make_optimizer(opt_name, 1e-1)
    res = build_sharded_state(None, dims, o, seed=5, device="cpu")
    off = build_sharded_state(None, dims, o, seed=5, offload=level,
                              device="cpu")
    fa = step.make_train_step(o)
    fb = step.make_offload_train_step(o)
    x, y = (torch.from_numpy(a) for a in batch(16, 6, 4, seed=5))
    for _ in range(3):
        res, ma = fa(res, x, y)
        off, mb = fb(off, x, y)
        assert torch.equal(ma["loss"], mb["loss"])
    step.settle(off)
    for a, b in zip(res["params"].parameters(), off["params"].parameters()):
        assert torch.equal(a, b)
    for m in res["opt"]:
        for n in res["opt"][m]:
            assert torch.equal(res["opt"][m][n], off["opt"][m][n])
    assert off["step"] == res["step"] == 3


def test_resolve_offload_level():
    assert resolve_offload_level(False) == "none"
    assert resolve_offload_level(True) == "all"
    assert resolve_offload_level(None) == "none"
    assert resolve_offload_level("params") == "params"
    assert resolve_offload_level("1") == "all"
    assert resolve_offload_level("0") == "none"
    with pytest.raises(ValueError):
        resolve_offload_level("moments")


def test_optimizer_names():
    with pytest.raises(ValueError, match="unknown optimizer"):
        step.make_optimizer("lamb")
    assert step.make_optimizer("sgd", 0.5) == step.Optimizer("sgd", 0.5,
                                                             0.9)
