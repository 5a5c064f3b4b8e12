"""The port's SingleChipEngine (device="cpu") against the reference's.

Both engines solve the identical instance (io.convert carries it across)
under the identical configuration; QueryResults and the stdout bytes
(format_results, checksums and the --debug listing) must match exactly, on
the "sort", "topk", "seg" and "extract" paths, through the
heterogeneous-k router and the multi-pass wide-k driver, in exact and fast
mode; the path bookkeeping (``_last_select``, ``last_hetk``,
``last_mp_passes``) must match too. On the CPU the reference's kernels run
in Pallas interpret mode (through its own native_pallas_backend probe) and
the port's run their plain PyTorch versions.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dmlp_tpu.config import EngineConfig as RefConfig  # noqa: E402
from dmlp_tpu.engine.single import SingleChipEngine as RefEngine  # noqa: E402
from dmlp_tpu.golden.reference import knn_golden  # noqa: E402
from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu.io.grammar import KNNInput as RefInput  # noqa: E402
from dmlp_tpu.io.grammar import Params as RefParams  # noqa: E402
from dmlp_tpu.io.grammar import parse_input_text  # noqa: E402
from dmlp_tpu.io.report import format_results  # noqa: E402
from dmlp_tpu_torch.config import EngineConfig  # noqa: E402
from dmlp_tpu_torch.engine.single import SingleChipEngine  # noqa: E402
from dmlp_tpu_torch.io.convert import (config_from_reference,  # noqa: E402
                                       from_reference)
from dmlp_tpu_torch.io.report import format_results as port_format  # noqa: E402

# name: (datagen args, reference config kwargs, expected select)
CASES = {
    "sort": ((3000, 40, 8, -10.0, 10.0, 1, 16, 5), {}, "sort"),
    "topk": ((9500, 48, 8, 0.0, 100.0, 1, 24, 6), {}, "topk"),
    "extract": ((13000, 64, 16, 0.0, 100.0, 1, 32, 10),
                {"use_pallas": True}, "extract"),
    # Bench config 1's generator arguments (bench/configs.py), rows and
    # queries reduced: 20,000 x 1,000 -> 9,000 x 100.
    "config1_reduced": ((9000, 100, 32, 0.0, 100.0, 1, 16, 10), {}, "topk"),
}


def _solve(name, exact):
    gen, kw, select = CASES[name]
    inp = parse_input_text(generate_input_text(*gen, seed=42))
    cfg = RefConfig(exact=exact, **kw)
    ref = RefEngine(cfg)
    want = ref.run(inp)
    port = SingleChipEngine(config_from_reference(cfg, device="cpu"))
    got = port.run(from_reference(inp))
    assert port._last_select == ref._last_select == select
    return inp, got, want


def _assert_same(got, want, dists=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.query_id, g.k, g.predicted_label) == \
            (w.query_id, w.k, w.predicted_label)
        assert np.array_equal(g.neighbor_ids, w.neighbor_ids)
        if dists:
            assert np.array_equal(g.neighbor_dists, w.neighbor_dists)


@pytest.mark.parametrize("name", list(CASES))
def test_exact_matches_reference_and_golden(name):
    inp, got, want = _solve(name, exact=True)
    _assert_same(got, want)
    for debug in (False, True):
        text = port_format(got, debug=debug)
        assert text == format_results(want, debug=debug)
    assert port_format(got) == format_results(knn_golden(inp))


@pytest.mark.parametrize("name", ["sort", "topk", "extract"])
def test_fast_matches_reference(name):
    """Fast mode prints the device's f32 ordering: the same neighbours and
    checksums; the f32 distances themselves may differ by the f32
    cancellation error of the norm expansion (finalize.staging_eps term 2,
    EPS_CANCEL_COEF * (na + 2) * (qn + dn_max)) between the two
    frameworks' sums."""
    from dmlp_tpu_torch.ops.extract import list_tolerance
    inp, got, want = _solve(name, exact=False)
    _assert_same(got, want, dists=False)
    tol = list_tolerance(
        torch.from_numpy((inp.query_attrs ** 2).sum(1)),
        float((inp.data_attrs ** 2).sum(1).max()), inp.params.num_attrs)
    for g, w, t in zip(got, want, tol.tolist()):
        np.testing.assert_allclose(g.neighbor_dists, w.neighbor_dists,
                                   rtol=0, atol=t)
    assert port_format(got) == format_results(want)


def test_extract_path_kernel_choice(monkeypatch):
    """The engine sits at the top rung: the gated kernel unless
    DMLP_TPU_FUSED=0; both give the same results."""
    inp = parse_input_text(generate_input_text(9000, 16, 4, 0, 10, 1, 8, 3,
                                               seed=1))
    outs = {}
    for fused, impl in (("1", "fused"), ("0", "extract")):
        monkeypatch.setenv("DMLP_TPU_FUSED", fused)
        eng = SingleChipEngine(EngineConfig(use_pallas=True, device="cpu"))
        outs[impl] = eng.run(from_reference(inp))
        assert eng.last_extract_impl == impl
    _assert_same(outs["fused"], outs["extract"])


def test_duplicate_ties_repaired_on_every_path():
    """A duplicate-heavy grid forces boundary repairs; every path still
    matches the golden model byte for byte."""
    rng = np.random.default_rng(3)
    from dmlp_tpu_torch.io.grammar import KNNInput, Params
    n = 9000
    data = rng.integers(0, 3, (n, 3)).astype(np.float64)
    q = rng.integers(0, 3, (24, 3)).astype(np.float64)
    labels = rng.integers(0, 5, n).astype(np.int32)
    ks = rng.integers(1, 20, 24).astype(np.int32)
    inp = KNNInput(Params(n, 24, 3), labels, data, ks, q)
    want = port_format(knn_golden(inp))
    for kw in ({"select": "sort"}, {}, {"use_pallas": True}):
        eng = SingleChipEngine(EngineConfig(device="cpu", **kw))
        assert port_format(eng.run(inp)) == want
        assert eng.last_repairs > 0


def _against_reference(inp, exact=True, **kw):
    """Solve ``inp`` (a reference KNNInput) with both engines under one
    configuration; results, stdout bytes and path bookkeeping must be
    equal. Returns the port's engine."""
    cfg = RefConfig(exact=exact, **kw)
    ref = RefEngine(cfg)
    want = ref.run(inp)
    port = SingleChipEngine(config_from_reference(cfg, device="cpu"))
    got = port.run(from_reference(inp))
    _assert_same(got, want)
    assert port_format(got) == format_results(want)
    assert port_format(got) == format_results(knn_golden(inp))
    assert (port._last_select, port.last_hetk, port.last_mp_passes) == \
        (ref._last_select, ref.last_hetk, ref.last_mp_passes)
    return port


def _uniform(seed, n, nq, na, lo, hi, ks, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        data = rng.integers(lo, hi, (n, na)).astype(np.float64)
        queries = rng.integers(lo, hi, (nq, na)).astype(np.float64)
    else:
        data = rng.uniform(lo, hi, (n, na))
        queries = rng.uniform(lo, hi, (nq, na))
    labels = rng.integers(0, 5, n).astype(np.int32)
    return RefInput(RefParams(n, nq, na), labels, data,
                    np.asarray(ks, np.int32), queries)


def test_router_splits_wide_k_outliers():
    inp = _uniform(77, 2000, 6, 4, -30, 30, [700, 1, 640, 2000, 513, 512])
    port = _against_reference(inp, select="extract", use_pallas=True)
    assert port.last_hetk == (1, 5)


@pytest.mark.parametrize("seed", [201, 202, 203])
def test_router_random_mixed_k(seed):
    """The reference's mixed-k fuzz inputs: most queries small-k, a few
    wide, duplicate-heavy about half the time."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(600, 2200))
    nq = int(rng.integers(3, 30))
    na = int(rng.integers(1, 7))
    if rng.random() < 0.5:
        data = rng.integers(0, 3, (n, na)).astype(np.float64)
        queries = rng.integers(0, 3, (nq, na)).astype(np.float64)
    else:
        data = rng.uniform(-20, 20, (n, na))
        queries = rng.uniform(-20, 20, (nq, na))
    labels = rng.integers(0, 5, n).astype(np.int32)
    ks = rng.integers(1, 40, nq).astype(np.int32)
    n_out = int(rng.integers(1, max(2, nq // 3)))
    out_rows = rng.choice(nq, n_out, replace=False)
    ks[out_rows] = rng.integers(520, n + 1, n_out)
    inp = RefInput(RefParams(n, nq, na), labels, data, ks, queries)
    port = _against_reference(inp, select="extract", use_pallas=True)
    assert port.last_hetk == (nq - n_out, n_out)


def test_router_fast_mode():
    """Fast mode prints the device's f32 ordering; integer attributes make
    it exact, so distances match too."""
    ks = np.random.default_rng(88).integers(1, 30, 10)
    ks[2], ks[7] = 900, 1500
    inp = _uniform(88, 1500, 10, 4, -7, 8, ks, integer=True)
    port = _against_reference(inp, exact=False, select="extract",
                              use_pallas=True)
    assert port.last_hetk == (8, 2)


def test_multipass_all_wide_k():
    inp = _uniform(80, 1200, 4, 3, -10, 10, [600, 700, 1200, 997])
    port = _against_reference(inp, select="extract", use_pallas=True)
    assert port.last_hetk is None and port.last_mp_passes >= 2


def test_streaming_seg_driver():
    """--select seg --pallas: K3 feeds the fold; nseg = 40 > S = 32, so
    the segment gather runs."""
    inp = parse_input_text(generate_input_text(9000, 40, 6, -5, 5, 1, 4, 4,
                                               seed=51))
    port = _against_reference(inp, use_pallas=True, select="seg",
                              data_block=8192, query_block=16, margin=0)
    assert port._last_select == "seg"


def test_multipass_declines_and_streams():
    """Every k near 8,000 at n = 9,000 needs more than 16 passes: no
    router bulk, no multi-pass, and the extraction kernel cannot take the
    width, so the solve streams through "seg"."""
    inp = parse_input_text(generate_input_text(9000, 4, 4, 0, 100, 7900,
                                               8100, 5, seed=4))
    port = _against_reference(inp, use_pallas=True)
    assert port._last_select == "seg" and port.last_mp_passes == 0


def test_not_ported_paths_raise():
    """What the port once refused here (a kc above 512 with --pallas, and
    select="seg") now equals the reference. The one-device engine refuses
    a mesh mode and points to the mesh engines; the compiler-sharded
    "auto" mode is not ported and raises naming its ROADMAP item."""
    import io

    from dmlp_tpu_torch import cli
    inp = parse_input_text(generate_input_text(9000, 4, 4, 0, 10, 600, 600,
                                               3, seed=2))
    assert _against_reference(inp, use_pallas=True).last_mp_passes == 2
    assert _against_reference(inp, select="seg")._last_select == "seg"
    with pytest.raises(ValueError, match="engine.sharded"):
        SingleChipEngine(EngineConfig(mode="sharded", device="cpu"))
    with pytest.raises(NotImplementedError, match="A10"):
        cli.main(["--device", "cpu", "--mode", "auto"],
                 stdin=io.StringIO("1 1 1\n0 1\nQ 1 1\n"),
                 stdout=io.StringIO(), stderr=io.StringIO())


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SingleChipEngine(EngineConfig())
