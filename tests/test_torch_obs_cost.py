"""The port's analytic kernel costs (``obs.kernel_cost``) against the
reference's (``dmlp_tpu/obs/kernel_cost.py``), the roofline bound the chip
smoke test prints, and the cost probe (``obs.counters``) after CPU solves:
dispatch counts, FLOPs and the measured extraction term."""

import io

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu.obs import kernel_cost as ref_cost  # noqa: E402
from dmlp_tpu_torch import cli  # noqa: E402
from dmlp_tpu_torch.config import EngineConfig  # noqa: E402
from dmlp_tpu_torch.engine.single import (SingleChipEngine,  # noqa: E402
                                          fold_plan, plan_chunks,
                                          resolve_kcap, round_up)
from dmlp_tpu_torch.io.grammar import parse_input_text  # noqa: E402
from dmlp_tpu_torch.obs import counters as obs_counters  # noqa: E402
from dmlp_tpu_torch.obs import kernel_cost  # noqa: E402
from dmlp_tpu_torch.ops import dist_segmin as ds  # noqa: E402
from dmlp_tpu_torch.ops import extract as ex  # noqa: E402

# (qb, b, a, kc): the main-path shapes of PERF.md §6 and odd ones.
K12_SHAPES = [(10016, 50176, 64, 48), (4384, 50176, 64, 512),
              (1024, 51200, 64, 512), (1024, 204800, 64, 512),
              (2528, 25088, 64, 48), (2016, 25088, 32, 40),
              (32, 43776, 64, 48), (1000, 8192, 7, 24)]
K3_SHAPES = [(5624, 50176, 64), (1024, 50176, 64), (1408, 25088, 64),
             (32, 65536, 64), (13, 1024, 64), (1000, 4736, 100)]


@pytest.mark.parametrize("shape", K12_SHAPES)
def test_k2_flops_equal_the_reference(shape):
    qb, b, a, kc = shape
    assert kernel_cost.extract_topk_cost(qb, b, a, kc)["flops"] == \
        ref_cost.extract_topk_cost(qb, b, a, kc)["flops"]


@pytest.mark.parametrize("shape", K12_SHAPES)
def test_k1_flops_equal_the_reference_past_the_gate(shape):
    """K1's deterministic term is K2's; each package adds its gate per
    cell of its own grid, so the two agree once that term is taken out."""
    qb, b, a, kc = shape
    port = kernel_cost.fused_topk_cost(qb, b, a, kc)
    ref = ref_cost.fused_topk_cost(qb, b, a, kc)
    ref_gate = ref["flops"] - ref_cost._streaming_cost(
        qb, b, a, kc, kernel="fused")["flops"]
    assert port["flops"] - port["gate_flops"] == ref["flops"] - ref_gate
    assert port["gate_flops"] == -(-qb // 32) * (b // 256) * (3 * 256
                                                            + 8 * 32)


@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_flops_equal_the_reference(shape):
    qb, b, a = shape
    assert kernel_cost.fused_dist_segmin_cost(qb, b, a)["flops"] == \
        ref_cost.fused_dist_segmin_cost(qb, b, a)["flops"]


def test_prune_score_cost_is_the_reference_model():
    for qb, nb, a in ((32, 6, 64), (1024, 4, 64), (7, 1, 3)):
        got = kernel_cost.summaries_score_cost(qb, nb, a)
        want = ref_cost.summaries_score_cost(qb, nb, a)
        assert got["flops"] == want["flops"]
        assert got["bytes_min"] == want["bytes_accessed"]


H100 = obs_counters.PEAKS["NVIDIA H100 80GB HBM3"]


def _old_bound(nbytes, ops, precision):
    """The chip smoke test's bound before obs.kernel_cost held it."""
    peak = {"f32": 67e12, "bf16": 989e12}[precision]
    t_bytes, t_ops = nbytes / 3.35e12, ops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@pytest.mark.parametrize("shape", K12_SHAPES[:6])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("gate", [False, True])
def test_k12_bytes_min_and_bound_are_the_smoke_tests(shape, carried, gate):
    """``bytes_min`` is the chip smoke test's former formula (operands
    read once, lists written once, ``iters`` out), and the bound it prints
    is unchanged: with the gate, the products of the processed cells."""
    qb, b, a, kc = shape
    ntile, nblk = -(-qb // 32), b // 256
    iters = (ntile * nblk * 3) // 5
    nbytes = 4 * (qb * a + b * a) + 8 * qb * kc * (2 if carried else 1) \
        + 4 * ntile * nblk
    ops = 2.0 * a * (32 * 256 * iters if gate else qb * b)
    fn = kernel_cost.fused_topk_cost if gate \
        else kernel_cost.extract_topk_cost
    for prec in ("f32", "bf16"):
        cost = fn(qb, b, a, kc, iters, prec, carried=carried)
        assert cost["bytes_min"] == nbytes
        assert kernel_cost.bound_ms(cost, H100) == _old_bound(nbytes, ops,
                                                              prec)


@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_bytes_min_and_bound_are_the_smoke_tests(shape):
    qb, b, a = shape
    nbytes = 4 * (qb * a + b * a + b + qb * b + qb * (b // 128))
    for prec in ("f32", "bf16"):
        cost = kernel_cost.fused_dist_segmin_cost(qb, b, a, prec)
        assert cost["bytes_min"] == nbytes
        assert kernel_cost.bound_ms(cost, H100) == _old_bound(
            nbytes, 2.0 * qb * b * a, prec)


@pytest.mark.parametrize("qb,splits,kc", [(1024, 4, 512), (4384, 3, 512),
                                          (32, 154, 48), (10016, 4, 48)])
def test_merge_bytes_and_bound_are_the_smoke_tests(qb, splits, kc):
    for carried in (False, True):
        nbytes = 8 * qb * kc * (splits + carried + 1)
        cost = kernel_cost.extract_merge_cost(qb, kc, splits, carried)
        assert cost["bytes_min"] == nbytes
        assert kernel_cost.bound_ms(cost, H100) == _old_bound(nbytes, 0.0,
                                                              "f32")


def test_bytes_accessed_streams_at_the_launch_knob():
    """The sweep re-reads the data per query tile and the queries per
    split (K1/K2), and the queries per segment group (K3): more splits or
    groups stream more, and never less than ``bytes_min``."""
    qb, b, a, kc = 10016, 50176, 64, 48
    s1 = kernel_cost.extract_topk_cost(qb, b, a, kc, splits=1)
    s4 = kernel_cost.extract_topk_cost(qb, b, a, kc, splits=4)
    assert s1["bytes_min"] <= s1["bytes_accessed"] < s4["bytes_accessed"]
    g1 = kernel_cost.fused_dist_segmin_cost(1024, 50176, 64, group=1)
    g12 = kernel_cost.fused_dist_segmin_cost(1024, 50176, 64, group=12)
    assert g12["bytes_min"] <= g12["bytes_accessed"] < g1["bytes_accessed"]


def _counting(monkeypatch):
    """Count the plain versions' calls (the CPU's launches), by kernel."""
    calls = {"fused_topk": 0, "extract_topk": 0, "extract_merge": 0,
             "fused_dist_segmin": 0}
    split_plain = ex.split_partials_plain
    merge_plain = ex.merge_partials_plain
    seg_plain = ds.fused_dist_segmin_plain

    def split(*a, mxu_gate=False, **k):
        calls["fused_topk" if mxu_gate else "extract_topk"] += 1
        return split_plain(*a, mxu_gate=mxu_gate, **k)

    def merge(*a, **k):
        calls["extract_merge"] += 1
        return merge_plain(*a, **k)

    def seg(*a, **k):
        calls["fused_dist_segmin"] += 1
        return seg_plain(*a, **k)
    monkeypatch.setattr(ex, "split_partials_plain", split)
    monkeypatch.setattr(ex, "merge_partials_plain", merge)
    monkeypatch.setattr(ds, "fused_dist_segmin_plain", seg)
    return calls


def test_probe_counts_equal_the_launches_and_flops_the_model(monkeypatch):
    """A CPU solve under a probe, on the extract path over 3 chunks: the
    recorded dispatches per kernel equal the plain versions' calls (what
    the card would launch) and the plan's chunk count; the FLOPs equal
    obs.kernel_cost's sum over those launches with the measured
    ``iters``, which are read back and marked measured."""
    calls = _counting(monkeypatch)
    text = generate_input_text(7000, 40, 6, 0.0, 50.0, 1, 16, 5, seed=13)
    inp = parse_input_text(text)
    cfg = EngineConfig(use_pallas=True, select="extract", data_block=2560,
                       device="cpu")
    monkeypatch.setenv("DMLP_TPU_PRUNE", "0")
    probe = obs_counters.install()
    try:
        SingleChipEngine(cfg).run(inp)
    finally:
        obs_counters.uninstall()
    got = probe.collect()
    per = got["per_kernel"]
    _, nchunks, rows = plan_chunks(7000, 256, 2560)
    assert {k: v["dispatches"] for k, v in per.items()} == \
        {k: n for k, n in calls.items() if n} == {"fused_topk": nchunks}
    qb = round_up(40, 32)
    kc = resolve_kcap(cfg, int(inp.ks.max()), "extract", nchunks * rows)
    iters = per["fused_topk"]["extract_iters_total"]
    assert 0 < iters <= nchunks * (qb // 32) * (rows // 256)
    want = sum(kernel_cost.fused_topk_cost(qb, rows, 6, kc,
                                           carried=i > 0)["flops"]
               for i in range(nchunks)) \
        + kernel_cost.extract_loop_cost(qb, rows, 6, kc, iters)
    assert per["fused_topk"]["flops"] == pytest.approx(want, rel=1e-12)
    assert got["extraction_term"] == "measured"
    assert got["flops"] == per["fused_topk"]["flops"]
    assert "device_ms" not in per["fused_topk"]    # no events on the CPU


def test_probe_records_the_split_merge_and_k3(monkeypatch):
    """The merge of an explicit S = 3 launch and K3's seg fold, on the
    CPU: one record per plain call."""
    calls = _counting(monkeypatch)
    g = torch.Generator().manual_seed(3)
    q = torch.rand(40, 5, generator=g)
    d = torch.rand(1024, 5, generator=g)
    probe = obs_counters.install()
    try:
        ex.extract_topk(q, d, n_real=1000, kc=16, splits=3, mxu_gate=True)
        ds.fused_dist_segmin(q, d, torch.arange(1024, dtype=torch.int32))
    finally:
        obs_counters.uninstall()
    per = probe.collect()["per_kernel"]
    assert calls == {"fused_topk": 1, "extract_topk": 0,
                     "extract_merge": 1, "fused_dist_segmin": 1}
    assert {k: v["dispatches"] for k, v in per.items()} == \
        {k: n for k, n in calls.items() if n}
    assert per["extract_merge"]["flops"] == \
        kernel_cost.extract_merge_cost(40, 16, 3)["flops"]
    assert per["fused_dist_segmin"]["bytes_min"] == \
        kernel_cost.fused_dist_segmin_cost(40, 1024, 5)["bytes_min"]


def test_counters_on_the_topk_fold_and_unavailable_when_empty():
    """The "topk" fold's plain product is recorded as
    ``distance_product``; a probe that saw nothing says so explicitly."""
    assert obs_counters.CostProbe().collect() == {
        "counters_unavailable": True, "dispatches_recorded": 0}
    text = generate_input_text(9000, 24, 6, 0.0, 50.0, 1, 16, 5, seed=2)
    probe = obs_counters.install()
    try:
        cli.main(["--device", "cpu", "--select", "topk"],
                 stdin=io.StringIO(text), stdout=io.StringIO(),
                 stderr=io.StringIO())
    finally:
        obs_counters.uninstall()
    per = probe.collect()["per_kernel"]
    qsb, nqb, nchunks, rows = fold_plan(
        EngineConfig(select="topk", device="cpu"), 9000, 24, "topk")
    assert set(per) == {"distance_product"}
    assert per["distance_product"]["dispatches"] == nqb * nchunks
    assert per["distance_product"]["flops"] == nqb * nchunks \
        * kernel_cost.distance_product_cost(qsb, rows, 6)["flops"]


def test_roofline_needs_the_cards_peaks():
    """On the CPU (or a card the peak table lacks) the roofline omits the
    utilization rather than guess."""
    rl = obs_counters.roofline(1e9, 1e8, 0.5, device="cpu")
    assert rl["achieved_flops_per_s"] == 2e9
    assert "utilization_vs_peak" not in rl
    assert np.isclose(rl["arithmetic_intensity"], 10.0)
    assert obs_counters.device_peaks("cpu") is None
