"""The runtime sanitizer (``dmlp_tpu_torch.check.sanitize``) on the CPU.

Proves four things: (1) teeth — every implicit host readback of a tensor
inside ``sanitized()`` raises (``item``, ``bool``, ``float``, ``int``,
``tolist``, ``numpy``, ``cpu``, ``np.asarray``), on CPU tensors as on the
card, while the explicit ``readback`` and a named ``fenced`` region pass
and are counted; (2) the port's solve paths are clean end to end — a
sanitized solve is byte-identical to the plain one (single, device-full,
``--select seg``, the sharded and ring engines at (2, 1), the CLI's
``--sanitize``), and the mesh solves name every deliberate sync they took
(gloo's wire copies, the object collectives); (3) nothing falls back: a
flagged sync raises through the degradation ladder; (4) the env and flag
plumbing, and a sanitized train step.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from dmlp_tpu_torch import cli
from dmlp_tpu_torch.check import sanitize
from dmlp_tpu_torch.check.sanitize import (ImplicitSyncError, fenced,
                                           maybe_sanitized, readback,
                                           sanitize_enabled, sanitized)
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine.single import SingleChipEngine
from dmlp_tpu_torch.io.datagen import generate_input_text
from dmlp_tpu_torch.io.grammar import parse_input_text


@pytest.fixture
def small_input():
    return parse_input_text(generate_input_text(300, 40, 8, -10, 10, 1, 12,
                                                5, seed=21))


def _checksums(results):
    return [r.checksum() for r in results]


IMPLICIT = {
    "item": lambda t: t[0].item(),
    "bool": lambda t: bool(t[0]),
    "if": lambda t: 1 if t.sum() else 0,
    "float": lambda t: float(t[0]),
    "int": lambda t: int(t[0]),
    "tolist": lambda t: t.tolist(),
    "numpy": lambda t: t.numpy(),
    "cpu": lambda t: t.cpu(),
    "np_asarray": lambda t: np.asarray(t),
}


@pytest.mark.parametrize("how", sorted(IMPLICIT))
def test_implicit_readback_raises_on_the_cpu(how):
    t = torch.arange(8.0) * 2
    with sanitized():
        with pytest.raises(ImplicitSyncError, match="implicit host readback"):
            IMPLICIT[how](t)
    IMPLICIT[how](t)        # outside the region: plain torch again


def test_explicit_readback_and_fences_pass_and_are_named():
    sanitize.reset_fences()
    t = torch.arange(8.0) * 2
    with sanitized():
        got = readback([t, {"x": t[:2]}], "test.read")  # check: allow-host-sync
        with fenced("test.fence"):
            assert t[1].item() == 2.0
        # staging to the run's device (the CPU here) is not a readback
        assert t.to("cpu").sum().dtype == torch.float32
        with pytest.raises(ImplicitSyncError):
            t[1].item()     # the fence closed
        with sanitized():   # nesting keeps the outer region armed
            pass
        with pytest.raises(ImplicitSyncError):
            float(t[0])
    assert isinstance(got[0], np.ndarray) and got[1]["x"].tolist() == [0, 2]
    assert sanitize.FENCED == {"test.read": 1, "test.fence": 1}
    assert sanitize._active == 0 and sanitize._fences == 0
    # off: readback is the plain conversion and fenced is a null context
    assert readback(t).shape == (8,)  # check: allow-host-sync
    assert isinstance(fenced("x"), contextlib.nullcontext)


def test_single_engine_sanitized_byte_identical(small_input):
    eng = SingleChipEngine(EngineConfig(data_block=64, query_block=16,
                                        device="cpu"))
    plain = _checksums(eng.run(small_input))
    with sanitized():
        assert _checksums(eng.run(small_input)) == plain


def test_single_engine_device_full_sanitized(small_input):
    eng = SingleChipEngine(EngineConfig(data_block=64, query_block=16,
                                        device="cpu", use_pallas=True))
    plain = _checksums(eng.run_device_full(small_input))
    with sanitized():
        assert _checksums(eng.run_device_full(small_input)) == plain


def _cli(argv, text):
    out, err = io.StringIO(), io.StringIO()
    assert cli.main(argv, stdin=io.StringIO(text), stdout=out,
                    stderr=err) == 0
    assert "Time taken:" in err.getvalue()
    return out.getvalue()


SOLVES = {
    # input (datagen args), flags
    "pallas": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5), ["--pallas"]),
    "seg": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5),
            ["--select", "seg", "--pallas"]),
    "mixed_k": ((9000, 24, 6, 0.0, 50.0, 1, 900, 5), ["--pallas"]),
    "device_full": ((9000, 24, 6, 0.0, 50.0, 1, 16, 5),
                    ["--pallas", "--device-full"]),
    "debug": ((200, 20, 6, -5.0, 5.0, 1, 9, 4), ["--debug"]),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_cli_sanitize_flag_byte_identical(case):
    gen, flags = SOLVES[case]
    text = generate_input_text(*gen, seed=3)
    argv = ["--device", "cpu", *flags]
    assert _cli([*argv, "--sanitize"], text) == _cli(argv, text)


@pytest.mark.parametrize("mode", ["sharded", "ring"])
def test_mesh_engines_sanitized_name_their_fences(mode):
    """(2, 1) on two gloo ranks: byte-identical, and rank 0's deliberate
    syncs are the named ones — the plan's object broadcasts, the result
    fetch (on the CPU gloo's wire is this device: no copy to fence)."""
    text = generate_input_text(9000, 24, 6, 0.0, 50.0, 1, 16, 5, seed=3)
    argv = ["--device", "cpu", "--mode", mode, "--mesh", "2,1", "--pallas"]
    plain = _cli(argv, text)
    sanitize.reset_fences()
    assert _cli([*argv, "--sanitize"], text) == plain
    sites = set(sanitize.FENCED)
    assert {"collectives.broadcast_object", "sharded.fetch"} <= sites
    assert sites <= {
        "collectives.broadcast_object", "collectives.gather_objects",
        "collectives.allgather_wire", "collectives.ring_wire",
        "collectives.gather_wire", "collectives.scatter_stage",
        "collectives.all_gather_arrays", "sharded.fetch",
        "sharded.stage_queries", "sharded.stage_labels",
        "sharded.stage_rows", "sharded.stage_local",
        "sharded.epilogue_stage", "sharded.phase_sync", "single.put",
        "summaries.stage", "extract.plain_gate", "extract.plain_rows",
        "topk.seg_tie"}, sites


def test_sanitize_env_var_reaches_the_cli(monkeypatch):
    text = generate_input_text(200, 20, 6, -5, 5, 1, 9, 4, seed=7)
    plain = _cli(["--device", "cpu"], text)
    monkeypatch.setenv("DMLP_TPU_SANITIZE", "1")
    sanitize.reset_fences()
    assert _cli(["--device", "cpu"], text) == plain
    assert sanitize.FENCED.get("single.fetch") == 1


def test_flagged_sync_raises_through_the_ladder(small_input, monkeypatch):
    """A planted implicit readback inside the solve raises: the ladder
    does not read it as an OOM and step down, and no rung answers."""
    eng = SingleChipEngine(EngineConfig(data_block=64, query_block=16,
                                        device="cpu"))
    real = eng._solve

    def leaky(inp):
        top, n = real(inp)
        float(top.dists[0, 0])        # the planted sync
        return top, n

    monkeypatch.setattr(eng, "_solve", leaky)
    with sanitized():
        with pytest.raises(ImplicitSyncError):
            eng.run(small_input)
    assert eng.last_degrade_rung == "lowp"
    assert len(eng.run(small_input)) == 40      # unsanitized: fine


def test_sanitize_enabled_env_parsing():
    assert not sanitize_enabled({})
    for v in ("1", "true", "ON", "yes"):
        assert sanitize_enabled({"DMLP_TPU_SANITIZE": v})
    for v in ("0", "false", "", "off"):
        assert not sanitize_enabled({"DMLP_TPU_SANITIZE": v})


def test_maybe_sanitized_plumbing():
    assert isinstance(maybe_sanitized(environ={}), contextlib.nullcontext)
    assert not isinstance(maybe_sanitized(force=True),
                          contextlib.nullcontext)
    assert not isinstance(
        maybe_sanitized(environ={"DMLP_TPU_SANITIZE": "1"}),
        contextlib.nullcontext)


@pytest.mark.parametrize("kw", [{}, {"compute_dtype": "bfloat16"},
                                {"offload": "params"}],
                         ids=["f32", "bf16", "offload"])
def test_sanitized_train_steps_equal_plain(kw):
    from dmlp_tpu_torch.train.loop import train
    _, a = train(steps=2, batch=64, dims=(8, 16, 4), log_every=1,
                 sanitize=True, device="cpu", **kw)
    _, b = train(steps=2, batch=64, dims=(8, 16, 4), log_every=1,
                 device="cpu", **kw)
    assert a["step"] == 2 and a["loss"] == b["loss"]


def test_sanitized_train_step_raises_on_a_nan_backward():
    """Train mode's anomaly check: a NaN made in the backward raises at
    the op."""
    x = torch.tensor([0.0], requires_grad=True)
    with sanitized(train=True):
        y = torch.sqrt(x) * 0.0      # d sqrt(x)/dx at 0 is inf; x 0 -> nan
        with pytest.raises(RuntimeError, match="nan"):
            y.sum().backward()


def test_mesh_resident_gate_count_is_read_after_the_gather():
    """A fault the checker found: the mesh replica read its fold's gate count with
    ``.item()`` right after queueing the folds, before the merge; it is
    now read once after the gather, fenced. A sanitized (1, 1) solve
    passes, byte-identical, and names that read."""
    from dmlp_tpu_torch.fleet.mesh_engine import MeshResidentEngine
    from dmlp_tpu_torch.parallel import distributed as pd
    from dmlp_tpu_torch.parallel.mesh import make_mesh
    inp = parse_input_text(generate_input_text(3000, 16, 6, 0.0, 50.0, 1,
                                               8, 4, seed=5))
    with pd.process_group(device="cpu", timeout_s=60):
        eng = MeshResidentEngine(inp, EngineConfig(
            mode="sharded", device="cpu", use_pallas=True,
            select="extract"), mesh=make_mesh((1, 1)))
        try:
            plain = _checksums(eng.solve_batch(inp.query_attrs, inp.ks))
            assert eng.batch_log[-1]["path"] == "extract"
            sanitize.reset_fences()
            with sanitized():
                got = _checksums(eng.solve_batch(inp.query_attrs, inp.ks))
        finally:
            eng.close()
    assert got == plain
    assert sanitize.FENCED["fleet.gate_count"] == 1
