"""``run_device_full`` and ``--device-full`` against the reference.

Device-full prints the device's f32 ordering with no float64 rescore and
no repair, so it is held byte for byte only on inputs whose f32 distances
are exact: the distinct-distance construction of
``tests/test_pallas_extract.py`` (1-D distinct integers, queries offset by
0.25) and integer attributes. There the port's plain versions and the
reference's Pallas kernels in interpret mode compute the same floats, and
the reports must equal each other and, where every tie group fits the
candidate window, the golden oracle. The paths: the extraction kernel,
the heterogeneous-k router, the streaming seg fold, and the all-wide-k
input, on which the multi-pass driver is refused (it is exact only with
run()'s repair) and the solve streams, as in the reference.
"""

import io

import numpy as np
import pytest

pytest.importorskip("jax")

from dmlp_tpu import cli as ref_cli  # noqa: E402
from dmlp_tpu.config import EngineConfig as RefConfig  # noqa: E402
from dmlp_tpu.engine.single import SingleChipEngine as RefEngine  # noqa: E402
from dmlp_tpu.golden.reference import knn_golden  # noqa: E402
from dmlp_tpu.io.grammar import KNNInput as RefInput  # noqa: E402
from dmlp_tpu.io.grammar import Params as RefParams  # noqa: E402
from dmlp_tpu.io.grammar import format_input  # noqa: E402
from dmlp_tpu.io.report import format_results  # noqa: E402
from dmlp_tpu_torch import cli  # noqa: E402
from dmlp_tpu_torch.engine.single import SingleChipEngine  # noqa: E402
from dmlp_tpu_torch.io.convert import (config_from_reference,  # noqa: E402
                                       from_reference)
from dmlp_tpu_torch.io.report import format_results as port_format  # noqa: E402


def _distinct(n, nq, ks, seed=31, num_labels=5):
    """Pairwise-distinct, f32-exact distances: 1-D distinct integer data,
    queries offset by 0.25 (every term a small multiple of 1/16). With
    n <= 700 every norm, product and sum fits f32's 24 bits, so the
    --debug listing's distances are exact too."""
    rng = np.random.default_rng(seed)
    data = (rng.permutation(n).astype(np.float64) + 1.0)[:, None]
    queries = (rng.permutation(nq).astype(np.float64) + 0.25)[:, None]
    labels = rng.integers(0, num_labels, n).astype(np.int32)
    return RefInput(RefParams(n, nq, 1), labels, data,
                    np.asarray(ks, np.int32), queries)


def _integer_router_input():
    """The integer-attribute router input of tests/test_extract_fuzz.py:
    f32 sums of small integers are exact."""
    rng = np.random.default_rng(88)
    n, nq, na = 1500, 10, 4
    data = rng.integers(-7, 8, (n, na)).astype(np.float64)
    queries = rng.integers(-7, 8, (nq, na)).astype(np.float64)
    labels = rng.integers(0, 4, n).astype(np.int32)
    ks = rng.integers(1, 30, nq).astype(np.int32)
    ks[2], ks[7] = 900, 1500
    return RefInput(RefParams(n, nq, na), labels, data, ks, queries)


def _ks(seed, nq, lo, hi):
    return np.random.default_rng(seed).integers(lo, hi, nq)


def _mixed_ks():
    ks = _ks(5, 24, 1, 40)
    ks[[3, 11, 17]] = [700, 600, 520]
    return ks


# name: (input builder, reference config kwargs, golden-equal, checks).
# The integer grid has tie groups wider than the candidate window, where
# the f32 device ordering (both packages') and the oracle part ways.
CASES = {
    "extract": (lambda: _distinct(600, 24, _ks(1, 24, 1, 17)),
                dict(select="extract", use_pallas=True), True,
                dict(select="extract", hetk=None)),
    "router": (lambda: _distinct(700, 24, _mixed_ks()),
               dict(select="extract", use_pallas=True), True,
               dict(select="extract", hetk=(21, 3))),
    "router_integer": (_integer_router_input,
                       dict(select="extract", use_pallas=True), False,
                       dict(select="extract", hetk=(8, 2))),
    "seg": (lambda: _distinct(700, 24, _ks(2, 24, 1, 33)),
            dict(select="seg", use_pallas=True), True,
            dict(select="seg", hetk=None)),
    "all_wide_k": (lambda: _distinct(700, 8, _ks(3, 8, 500, 701)),
                   dict(select="extract", use_pallas=True), True,
                   dict(select="seg", hetk=None)),
}


def _solve_both(name):
    build, kw, golden_equal, checks = CASES[name]
    inp = build()
    ref = RefEngine(RefConfig(**kw))
    want = ref.run_device_full(inp)
    port = SingleChipEngine(config_from_reference(RefConfig(**kw),
                                                  device="cpu"))
    got = port.run_device_full(from_reference(inp))
    return inp, ref, want, port, got, golden_equal, checks


@pytest.mark.parametrize("name", list(CASES))
def test_run_device_full_equals_reference_and_golden(name):
    inp, ref, want, port, got, golden_equal, checks = _solve_both(name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.query_id, g.k, g.predicted_label) == \
            (w.query_id, w.k, w.predicted_label)
        np.testing.assert_array_equal(g.neighbor_ids, w.neighbor_ids)
        np.testing.assert_array_equal(g.neighbor_dists, w.neighbor_dists)
    for debug in (False, True):
        assert port_format(got, debug=debug) == \
            format_results(want, debug=debug)
    if golden_equal:
        assert port_format(got) == format_results(knn_golden(inp))
    assert (port._last_select, port.last_hetk) == \
        (ref._last_select, ref.last_hetk) == \
        (checks["select"], checks["hetk"])
    # No multi-pass (refused), no repair, no prune plan, the engine's rung.
    assert port.last_mp_passes == ref.last_mp_passes == 0
    assert port.last_repairs == 0 and port.last_prune is None
    assert port.last_degrade_rung == "fused"
    assert {"fetch", "finalize"} <= set(port.last_phase_ms)


def test_all_wide_k_run_takes_the_multipass_device_full_does_not():
    inp = from_reference(CASES["all_wide_k"][0]())
    cfg = config_from_reference(RefConfig(select="extract", use_pallas=True),
                                device="cpu")
    eng = SingleChipEngine(cfg)
    eng.run(inp)
    assert eng.last_mp_passes >= 2
    eng.run_device_full(inp)
    assert eng.last_mp_passes == 0 and eng._last_select == "seg"


def _cli(main, argv, text):
    out, err = io.StringIO(), io.StringIO()
    assert main(argv, stdin=io.StringIO(text), stdout=out, stderr=err) == 0
    return out.getvalue(), err.getvalue()


FLAGS = {"extract": ["--select", "extract"], "router": ["--select", "extract"],
         "router_integer": ["--select", "extract"],
         "seg": ["--select", "seg"], "all_wide_k": ["--select", "extract"]}


@pytest.mark.parametrize("debug", [False, True], ids=["checksum", "debug"])
@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_device_full_cmp_equal_to_reference(name, debug):
    text = format_input(CASES[name][0]())
    flags = ["--pallas", "--device-full", *FLAGS[name]] + \
        (["--debug"] if debug else [])
    got, err = _cli(cli.main, ["--device", "cpu", *flags], text)
    want, _ = _cli(ref_cli.main, flags, text)
    assert got == want
    if CASES[name][2]:
        golden, _ = _cli(cli.main, ["--engine", "golden"]
                         + (["--debug"] if debug else []), text)
        assert got == golden
    assert err.startswith("Time taken: ")


def test_cli_device_full_phase_times():
    text = format_input(CASES["router"][0]())
    _, err = _cli(cli.main, ["--device", "cpu", "--pallas", "--device-full",
                             "--select", "extract", "--phase-times"], text)
    lines = err.splitlines()
    assert "repairs: 0" in lines and "rung: fused" in lines
    assert "prune: null" in lines
    assert any(ln.startswith("phase engine.fetch: ") for ln in lines)
