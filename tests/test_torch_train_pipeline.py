"""The port's pipeline families (``dmlp_tpu_torch.train.pipeline``) over
gloo ranks against the reference's ``dmlp_tpu.train.pipeline`` on the
conftest's virtual devices.

One module-scoped spawn of 8 gloo ranks on the CPU (every process group
with a 60 s timeout) runs every case of the reference's own
parametrisations in turn, each mesh on the first ranks: GPipe (dp, pp, M)
= (1, 4, 4), (2, 2, 2), (2, 4, 8); dp x tp x pp (dp, tp, pp) = (1, 2, 4),
(2, 2, 2); interleaved (dp, pp, V, M) = (2, 4, 2, 4), (1, 4, 3, 2), (1, 2,
2, 2); and one 2-step Adam case a family. The reference's initial
parameters are carried across with numpy (``model.params_from_jax``), the
same numpy batches split over dp as the reference's step splits them, 3
SGD steps (momentum 0.9), the first under ``obs.hlo``'s collective
record. Losses and parameters are held at ``rtol=2e-5`` (parameters also
``atol=1e-7``), the reference's ``dryrun.py:49``.

The record's hand-off bytes (``collective-permute@pp``) equal
``obs.comms.pipeline_ppermute_traffic`` at count 2 (forward and the
mirrored backward, bubble ticks included) exactly, and dp x tp x pp's
tp all-reduce bytes ``tp_psum_activation_traffic``. Then the loop CLI on
a (2, 2) pp mesh: an uninterrupted run, a run with a ``nan`` fault rolled
back under ``--nan-guard``, and a ``--resume`` of the first run's
checkpoint all end on the uninterrupted run's ``params_checksum``.
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

from dmlp_tpu.train import pipeline as ref  # noqa: E402
from dmlp_tpu.train.step import make_optimizer as ref_opt  # noqa: E402
from dmlp_tpu_torch.obs import comms  # noqa: E402
from dmlp_tpu_torch.train import pipeline as pl  # noqa: E402
from dmlp_tpu_torch.train import loop  # noqa: E402

from test_torch_mesh import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D_IN, HIDDEN, CLASSES = 6, 16, 4
STEPS, LR, WORLD = 3, 0.05, 8


def _case(family, mesh, n_micro, opt="sgd", n_virtual=1, steps=STEPS):
    tag = f"{family}_{'x'.join(map(str, mesh))}_m{n_micro}" + \
        (f"_v{n_virtual}" if family == "ppi" else "") + \
        ("" if opt == "sgd" else f"_{opt}")
    return {"id": tag, "family": family, "mesh": list(mesh),
            "n_micro": n_micro, "n_virtual": n_virtual, "opt": opt,
            "lr": LR if opt == "sgd" else 1e-3, "steps": steps}


PP = [(1, 4, 4), (2, 2, 2), (2, 4, 8)]
PP3 = [(1, 2, 4), (2, 2, 2)]
PPI = [(2, 4, 2, 4), (1, 4, 3, 2), (1, 2, 2, 2)]
CASES = ([_case("pp", (dp, pp), m) for dp, pp, m in PP]
         + [_case("pp3", s, 4) for s in PP3]
         + [_case("ppi", (dp, pp), m, n_virtual=v) for dp, pp, v, m in PPI]
         + [_case("pp", (2, 2), 2, "adam", steps=2),
            _case("pp3", (2, 2, 2), 4, "adam", steps=2),
            _case("ppi", (2, 4), 4, "adam", n_virtual=2, steps=2)])

RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlp_tpu_torch.obs import hlo
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.train import loop, pipeline as pl, step as S
from dmlp_tpu_torch.train.model import params_from_jax
from dmlp_tpu_torch.train.sharding import batch_slice, full_tensor, in_mesh

work = sys.argv[1]
initialize(auto=True, device="cpu", timeout_s=60)
rank = dist.get_rank()
cfg = json.load(open(work + "/cfg.json"))
d_in, hidden, classes = cfg["dims"]
for case in cfg["cases"]:
    tag, fam = case["id"], case["family"]
    data = np.load(f"{work}/{tag}_in.npz")
    init = params_from_jax({k[5:]: data[k] for k in data.files
                            if k.startswith("init_")})
    opt = S.make_optimizer(case["opt"], case["lr"])
    mesh = (pl.make_pp3_mesh if fam == "pp3" else pl.make_pp_mesh)(
        *case["mesh"], "cpu")
    inside = in_mesh(mesh)
    if inside:
        kw = dict(params=init, device="cpu")
        if fam == "pp":
            state = pl.build_pp_state(mesh, opt, d_in, hidden, classes, 2, **kw)
            fn = pl.make_pp_train_step(mesh, opt, n_micro=case["n_micro"],
                                       n_classes=classes)
        elif fam == "ppi":
            state = pl.build_ppi_state(mesh, opt, d_in, hidden, classes,
                                       case["n_virtual"], 2, **kw)
            fn = pl.make_ppi_train_step(mesh, opt, n_micro=case["n_micro"],
                                        n_virtual=case["n_virtual"],
                                        n_classes=classes)
        else:
            state = pl.build_pp3_state(mesh, opt, d_in, hidden, classes, 2,
                                       **kw)
            fn = pl.make_pp3_train_step(mesh, opt, n_micro=case["n_micro"],
                                        n_classes=classes)
    out, losses = {}, []
    for i in range(case["steps"]):
        if inside:
            x, y = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                    batch_slice(data[f"x{i}"], data[f"y{i}"], mesh))
        if i == 0:
            # every rank of the group takes part in the record
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
    if inside:
        full = {n: full_tensor(p.detach()).numpy()
                for n, p in state["params"].named_parameters()}
        checksum = loop._params_checksum(state)
        if rank == 0:
            out["checksum"] = np.asarray(checksum)
            out["losses"] = np.asarray(losses)
            out.update({f"param_{n}": a for n, a in full.items()})
            np.savez(f"{work}/{tag}_out.npz", **out)
    dist.barrier()
shutdown()
"""


def _reference(case):
    """The reference's run of ``case``: its initial parameters, the
    batches, the per-step losses and the final parameters."""
    fam, shape = case["family"], tuple(case["mesh"])
    n_dev = int(np.prod(shape))
    opt = ref_opt(case["opt"], case["lr"])
    devices = jax.devices()[:n_dev]
    if fam == "pp3":
        mesh = ref.make_pp3_mesh(*shape, devices=devices)
        state = ref.build_pp3_state(mesh, opt, D_IN, HIDDEN, CLASSES, 2,
                                    seed=13)
        step = ref.make_pp3_train_step(mesh, opt, n_micro=case["n_micro"],
                                       n_classes=CLASSES)
    elif fam == "ppi":
        mesh = ref.make_pp_mesh(*shape, devices=devices)
        state = ref.build_ppi_state(mesh, opt, D_IN, HIDDEN, CLASSES,
                                    n_virtual=case["n_virtual"],
                                    layers_per_chunk=2, seed=13)
        step = ref.make_ppi_train_step(mesh, opt, n_micro=case["n_micro"],
                                       n_virtual=case["n_virtual"],
                                       n_classes=CLASSES)
    else:
        mesh = ref.make_pp_mesh(*shape, devices=devices)
        state = ref.build_pp_state(mesh, opt, D_IN, HIDDEN, CLASSES, 2,
                                   seed=3)
        step = ref.make_pp_train_step(mesh, opt, n_micro=case["n_micro"],
                                      n_classes=CLASSES)
    init = {k: np.array(v) for k, v in state["params"].items()}
    rng = np.random.default_rng(4)
    batch = shape[0] * case["n_micro"] * 8
    batches = [(rng.normal(size=(batch, D_IN)).astype(np.float32),
                rng.integers(0, CLASSES, batch).astype(np.int32))
               for _ in range(case["steps"])]
    losses = []
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
    return {"init": init, "batches": batches, "losses": np.asarray(losses),
            "params": {k: np.array(v) for k, v in state["params"].items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_pipeline")
    refs = {}
    for case in CASES:
        r = refs[case["id"]] = _reference(case)
        np.savez(work / f"{case['id']}_in.npz",
                 **{f"init_{k}": v for k, v in r["init"].items()},
                 **{f"{n}{i}": a for i, xy in enumerate(r["batches"])
                    for n, a in zip("xy", xy)})
    (work / "cfg.json").write_text(json.dumps(
        {"dims": [D_IN, HIDDEN, CLASSES], "cases": CASES}))
    spawn_ranks(work, RANK_SCRIPT, WORLD, timeout=240)
    return {c["id"]: (refs[c["id"]], dict(np.load(work / f"{c['id']}_out.npz")))
            for c in CASES}


def _ids(cases):
    return [c["id"] for c in cases]


def change_err(got, want, start):
    """The distance of the parameter change ``got - start`` from ``want -
    start``, relative to the latter's norm."""
    return np.linalg.norm(got - want) / np.linalg.norm(want - start)


#: the case whose 24 relu layers (V 3 x S 4 x 2) put a pre-activation
#: within f32 rounding of zero by its later steps (the smallest |z| of its
#: first step is 2.5e-5): see test_step_equals_reference
KINKED = "ppi_1x4_m2_v3"


def _float64_run(case, want):
    """SGD (momentum 0.9) on the flat or unsharded stack in float64 from
    the reference's initial parameters and batches: the final
    parameters."""
    import torch
    import torch.nn.functional as F
    p = {k: torch.tensor(v, dtype=torch.float64)
         for k, v in want["init"].items()}
    trace = {k: torch.zeros_like(v) for k, v in p.items()}
    for x, y in want["batches"]:
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xt = torch.tensor(x, dtype=torch.float64)
        if case["family"] == "pp3":
            logits = pl.pp3_reference_forward(leaves, xt)
        else:
            flat = (pl.flatten_interleaved if case["family"] == "ppi"
                    else pl.flatten_pipeline)(leaves)
            logits = pl.flat_forward(flat, xt)
        loss = F.cross_entropy(logits, torch.tensor(y).long())
        for (k, v), g in zip(leaves.items(),
                             torch.autograd.grad(loss, list(leaves.values()))):
            trace[k] = 0.9 * trace[k] + g
            p[k] = v.detach() - case["lr"] * trace[k]
    return {k: v.numpy() for k, v in p.items()}


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_step_equals_reference(runs, case):
    """Per-step losses and the final parameters against the reference's
    run of the same family on the same parameters and batches.

    One case is wider: in ``ppi_1x4_m2_v3`` (24 relu layers of width 16)
    the two libraries' f32 roundings put a pre-activation on either side
    of zero by step 2 or 3, so the reference's parameter change parts from
    the port's by up to 6.8e-3 of its norm (measured: in_w 6.8e-3, in_b
    4.1e-3, pp_w 4.1e-3, pp_b 2.2e-3, out_w 1.3e-4), held below 1e-2
    here; its losses stay within 2e-5. On that case the reference's own
    flat f32 stack reads the same as its pipeline (3.5e-6) and its first
    step's gradients are within 1.1e-6 of float64, while both part from a
    float64 run by the same 6.8e-3 and the port stays within 2e-5 of it
    (test_step_equals_float64_run)."""
    want, got = runs[case["id"]]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    assert sorted(k[6:] for k in got if k.startswith("param_")) == \
        sorted(want["params"])
    for k, w in want["params"].items():
        if case["id"] == KINKED:
            assert change_err(got[f"param_{k}"], w, want["init"][k]) < 1e-2
            continue
        np.testing.assert_allclose(got[f"param_{k}"], w, rtol=2e-5,
                                   atol=1e-7, err_msg=k)


SGD_RUNS = [c for c in CASES if c["opt"] == "sgd"]


@pytest.mark.parametrize("fam", ["pp", "pp3", "ppi"])
def test_params_checksum_hashes_as_the_reference(runs, fam):
    """The loop's ``params_checksum`` of a final pipeline state (gathered
    from its shards) equals the reference's ``_params_checksum`` of the
    same arrays: the same leaves, order and encoding."""
    from dmlp_tpu.train.loop import _params_checksum as ref_checksum
    case = next(c for c in CASES if c["family"] == fam)
    _, got = runs[case["id"]]
    params = {k[6:]: v for k, v in got.items() if k.startswith("param_")}
    assert str(got["checksum"]) == ref_checksum({"params": params})


@pytest.mark.parametrize("case", SGD_RUNS, ids=_ids(SGD_RUNS))
def test_step_equals_float64_run(runs, case):
    """The port's parameters after 3 SGD steps against a float64 run of
    the flat (pp, interleaved) or unsharded (pp3) stack from the same
    start and batches: each parameter's change within 2e-5 of its
    norm."""
    want, got = runs[case["id"]]
    exact = _float64_run(case, want)
    for k, w in exact.items():
        assert change_err(got[f"param_{k}"], w, want["init"][k]) < 2e-5, k


@pytest.mark.parametrize("case", SGD_RUNS, ids=_ids(SGD_RUNS))
def test_collective_record_against_the_model(runs, case):
    """The first step's hand-off bytes equal the reference's model at
    count 2 (forward and the reverse schedule's backward, bubbles
    included), and dp x tp x pp's tp all-reduce bytes its activation
    psum model; both from the record of every rank."""
    _, got = runs[case["id"]]
    by_axis = json.loads(str(got["by_axis"]))
    shape = case["mesh"]
    dp, pp = shape[0], shape[-1]
    sched = "interleaved" if case["family"] == "ppi" else "gpipe"
    n_micro = case["n_micro"]
    micro_rows = 8           # the local batch (n_micro * 8) over n_micro
    model = {t.collective: t.bytes_total for t in comms.train_step_comms(
        0, tuple(shape), steps=1, pipeline={
            "pp": pp, "n_micro": n_micro, "micro_rows": micro_rows,
            "hidden": HIDDEN, "schedule": sched,
            "n_virtual": case["n_virtual"],
            "n_groups": int(np.prod(shape[:-1])),
            **({"tp": shape[1], "n_pairs": 2}
               if case["family"] == "pp3" else {})})}
    assert by_axis.get("collective-permute@pp", 0) == \
        model["ppermute_pipeline"]
    ticks = pl.schedule_ticks(sched, n_micro, pp, case["n_virtual"])
    links = pp if sched == "interleaved" else pp - 1
    assert model["ppermute_pipeline"] == \
        2 * ticks * links * micro_rows * HIDDEN * 4 * int(
            np.prod(shape[:-1]))
    if case["family"] == "pp3":
        assert by_axis["all-reduce@tp"] == model["psum_tp_activations"]
    else:
        assert "all-reduce@tp" not in by_axis
    # The gradient sums: the replicated parameters over the whole mesh,
    # the stacked stages over dp (none at dp = 1).
    assert by_axis["all-reduce@world"] > 0
    assert ("all-reduce@dp" in by_axis) == (dp > 1)


def test_schedule_arithmetic_and_gates():
    for sched, m, s, v in [("gpipe", 4, 4, 1), ("interleaved", 4, 4, 2),
                           ("gpipe", 8, 2, 1), ("interleaved", 2, 4, 3)]:
        assert pl.schedule_ticks(sched, m, s, v) == \
            ref.schedule_ticks(sched, m, s, v)
        assert pl.bubble_fraction(sched, m, s, v) == \
            ref.bubble_fraction(sched, m, s, v)
    assert pl.schedule_ticks("gpipe", 4, 4) == 7
    assert pl.schedule_ticks("interleaved", 4, 4, 2) == 11
    assert pl.bubble_fraction("gpipe", 4, 4) == pytest.approx(3 / 7)
    assert pl.bubble_fraction("interleaved", 4, 4, 2) < \
        pl.bubble_fraction("gpipe", 4, 4)
    with pytest.raises(ValueError, match="unknown schedule"):
        pl.schedule_ticks("1f1b", 4, 4)
    from dmlp_tpu_torch.train.step import make_optimizer
    with pytest.raises(ValueError, match="n_micro <= n_stages"):
        pl.make_ppi_train_step(None, make_optimizer("sgd", 0.1), n_micro=4,
                               n_virtual=2, n_classes=3)
    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        pl.make_pp3_mesh(1, 2, 0)


def test_one_rank_pipeline_equals_flat_stack():
    """Without a process group, a (1, 1) mesh: the schedule on one stage
    equals the flat stack's loss, and a step equals plain autograd SGD on
    it (the port against itself, exactly)."""
    import torch
    import torch.nn.functional as F
    from dmlp_tpu_torch.train.step import make_optimizer
    opt = make_optimizer("sgd", LR, momentum=0.0)
    state = pl.build_pp_state(None, opt, D_IN, HIDDEN, CLASSES, 3, seed=7,
                              device="cpu")
    full = {n: p.detach().clone()
            for n, p in state["params"].named_parameters()}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(16, D_IN)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, CLASSES, 16).astype(np.int32))
    fn = pl.make_pp_train_step(None, opt, n_micro=2, n_classes=CLASSES)
    state, m = fn(state, x, y)
    leaves = {k: v.clone().requires_grad_(True) for k, v in full.items()}
    loss = F.cross_entropy(pl.flat_forward(pl.flatten_pipeline(leaves), x),
                           y.long())
    assert fn.global_metrics(m)["loss"] == pytest.approx(loss.item(),
                                                         rel=1e-6)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (k, v), g in zip(full.items(), grads):
        torch.testing.assert_close(state["params"].get_parameter(k).detach(),
                                   v - LR * g, rtol=1e-5, atol=1e-7)


def test_loop_flag_rules():
    """The reference's flag rules for the pipeline families
    (``dmlp_tpu/train/loop.py:119-175``), each raising before any rank
    starts work."""
    kw = dict(steps=1, batch=8, device="cpu")
    with pytest.raises(ValueError, match="wants --dims in,hidden,classes"):
        loop.train(dims=(4, 8, 8, 2), parallelism="dp_pp", **kw)
    with pytest.raises(ValueError, match="wants --dims in,hidden,classes"):
        loop.train(dims=(4, 8, 8, 2), parallelism="dp_pp3",
                   mesh_shape=(1, 1, 1), **kw)
    with pytest.raises(ValueError, match="compute-dtype applies to dp_tp"):
        loop.train(dims=(4, 8, 2), parallelism="dp_pp",
                   compute_dtype="bfloat16", **kw)
    with pytest.raises(ValueError, match="offload applies to dp_tp"):
        loop.train(dims=(4, 8, 2), parallelism="dp_pp3", offload="all",
                   **kw)
    with pytest.raises(ValueError, match="virtual-stages must divide"):
        loop.train(dims=(4, 8, 2), parallelism="dp_pp",
                   pp_schedule="interleaved", n_virtual=3, **kw)
    with pytest.raises(ValueError, match="virtual-stages applies"):
        loop.train(dims=(4, 8, 2), parallelism="dp_pp", n_virtual=3, **kw)
    with pytest.raises(ValueError, match="pp-schedule applies to dp_pp"):
        loop.train(dims=(4, 8, 2), parallelism="dp_pp3",
                   pp_schedule="interleaved", **kw)
    with pytest.raises(ValueError, match="n_micro <= n_stages"):
        loop.train(dims=(4, 8, 2), parallelism="dp_pp",
                   pp_schedule="interleaved", n_micro=2, **kw)
    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        loop.train(dims=(4, 8, 2), parallelism="dp_pp3", **kw)
    with pytest.raises(ValueError, match="DP,TP,PP for dp_pp3"):
        loop.main(["--device", "cpu", "--parallelism", "dp_pp3", "--mesh",
                   "2,2", "--dims", "4,8,2"])
    with pytest.raises(ValueError, match="DP,PP for dp_pp"):
        loop.main(["--device", "cpu", "--parallelism", "dp_pp", "--mesh",
                   "1,2,2", "--dims", "4,8,2"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        loop.main(["--parallelism", "dp_pp", "--dims", "4,8,2"])


def test_one_rank_families_through_the_loop():
    """dp_pp (both schedules) and dp_pp3 on one rank through ``train``:
    finite, falling losses; interleaved V = 2 is the gpipe branch's model
    (the same draws in the same layer order), so both give one loss."""
    kw = dict(steps=6, batch=32, dims=(8, 16, 3), lr=0.05, log_every=6,
              device="cpu")
    _, a = loop.train(parallelism="dp_pp", **kw)
    _, b = loop.train(parallelism="dp_pp", pp_schedule="interleaved",
                      n_micro=1, **kw)
    assert np.isfinite(a["loss"]) and a["step"] == 6
    _, c = loop.train(parallelism="dp_pp", n_micro=1, **kw)
    assert b["loss"] == pytest.approx(c["loss"], rel=1e-6)


def _cli(argv, tmp):
    p = subprocess.run(
        [sys.executable, "-m", "dmlp_tpu_torch.train.loop", "--device", "cpu",
         *argv], capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_loop_cli_checkpoints_on_a_pp_mesh(tmp_path):
    """The loop CLI on a (2, 2) pp mesh (4 gloo ranks): 4 uninterrupted
    steps with checkpoints; the same run with a ``nan`` fault at step 3
    rolled back under ``--nan-guard``; and a ``--resume`` of the first
    run's latest checkpoint (0 more steps): all three records carry the
    uninterrupted run's ``params_checksum``."""
    sched = tmp_path / "sched.json"
    sched.write_text(json.dumps({"schema": 1, "seed": 0, "faults": [
        {"site": "train.step", "kind": "nan", "when": {"step": 3}}]}))
    common = ["--parallelism", "dp_pp", "--mesh", "2,2", "--dims", "6,16,4",
              "--batch", "32", "--log-every", "2", "--ckpt-every", "2"]
    recs = {}
    for name, extra in (
            ("whole", ["--steps", "4", "--checkpoint-dir",
                       str(tmp_path / "a")]),
            ("nan", ["--steps", "4", "--checkpoint-dir", str(tmp_path / "b"),
                     "--nan-guard", "--faults", str(sched)]),
            ("resumed", ["--steps", "0", "--resume", "--checkpoint-dir",
                         str(tmp_path / "a")])):
        rec = tmp_path / f"{name}.json"
        _cli(common + extra + ["--record", str(rec)], tmp_path)
        recs[name] = json.loads(rec.read_text())["metrics"]
    whole = recs["whole"]["params_checksum"]
    assert recs["nan"]["params_checksum"] == whole
    assert recs["nan"]["resilience"]["rollbacks"] == 1
    assert recs["resumed"]["params_checksum"] == whole
    assert recs["whole"]["step"] == 4 and np.isfinite(recs["whole"]["loss"])
    assert [r["device"] for r in recs["whole"]["ranks"]] == ["cpu"] * 4


def test_source_scan_covers_the_pipeline_modules():
    """The port's source scan (tests/test_torch_cli.py) walks every file
    of the package: this slice's modules are among them."""
    files = {f.name for f in (ROOT / "dmlp_tpu_torch" / "train").glob("*.py")}
    assert {"pipeline.py", "experts.py", "collectives.py", "dryrun.py",
            "sweep.py"} <= files
