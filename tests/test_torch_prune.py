"""The port's pruned two-stage solve against the reference's.

Stage 0 and 1 (``ops.summaries``: the summaries, the bounds, the k-th
thresholds and the survivor masks) must be equal to the reference's with a
tolerance of 0, and the stats dicts equal, for float32 and bfloat16 staging,
an f32 and a bf16 first pass, empty blocks and k greater than n. At the
engine level the same numpy-seeded instances go through both packages (the
reference's kernels in Pallas interpret mode, the port's on their plain
versions): stdout must equal the reference's and the golden model's, and
``last_prune`` must equal the reference's, on the "topk", "seg --pallas",
extract (``DMLP_TPU_FUSED`` x ``DMLP_TPU_PRUNE``) and router paths. Last, the
cases of ROADMAP queue C through both CLIs: a bf16 first pass and bf16
staging with pruning on, n = 1, no queries, k = n and one attribute.
"""

import io

import numpy as np
import pytest

pytest.importorskip("jax")

from dmlp_tpu import cli as ref_cli  # noqa: E402
from dmlp_tpu.config import EngineConfig as RefConfig  # noqa: E402
from dmlp_tpu.engine.single import SingleChipEngine as RefEngine  # noqa: E402
from dmlp_tpu.golden.reference import knn_golden  # noqa: E402
from dmlp_tpu.io.datagen import generate_input_text  # noqa: E402
from dmlp_tpu.io.grammar import KNNInput, Params, format_input  # noqa: E402
from dmlp_tpu.io.report import format_results  # noqa: E402
from dmlp_tpu.ops import summaries as ref_sum  # noqa: E402
from dmlp_tpu_torch import cli  # noqa: E402
from dmlp_tpu_torch.engine.single import SingleChipEngine  # noqa: E402
from dmlp_tpu_torch.io.convert import (config_from_reference,  # noqa: E402
                                       from_reference)
from dmlp_tpu_torch.io.report import format_results as port_format  # noqa: E402
from dmlp_tpu_torch.ops import summaries as osum  # noqa: E402


def _case(seed: int, n=2048, nq=12, na=5, kmax=16, block=256,
          banded=False, dup_boundaries=False):
    """tests/test_prune.py's corpus: optional norm bands per block, optional
    duplicate rows straddling every block boundary."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, 5, (n, na))
    if banded:
        for b in range(n // block):
            data[b * block:(b + 1) * block] += 40.0 * b
    if dup_boundaries:
        for b in range(1, n // block):
            edge = b * block
            data[edge] = data[edge - 1]
            if edge + 1 < n:
                data[edge + 1] = data[edge - 2]
    labels = rng.integers(0, 6, n).astype(np.int32)
    ks = rng.integers(1, kmax + 1, nq).astype(np.int32)
    q = rng.uniform(0, 5, (nq, na))
    if banded:
        q[-1] = data[n - block // 2] + rng.uniform(-0.5, 0.5, na)
    return KNNInput(Params(n, nq, na), labels, data, ks, q)


# -- stages 0 and 1 ----------------------------------------------------------

def _summary_case(name):
    """(queries, ks, data, ranges) of one summary case."""
    if name == "uniform":
        inp, block = _case(61, n=2048, nq=16, na=6), 256
    elif name == "banded":
        inp, block = _case(12, n=2048, nq=10, banded=True), 256
    elif name == "banded_dups":
        inp, block = _case(13, n=2048, nq=10, banded=True,
                           dup_boundaries=True), 256
    elif name == "ragged_tail":      # a short last block
        inp, block = _case(14, n=1900, nq=9, banded=True), 256
    elif name == "empty_blocks":     # ranges past the data end count 0
        inp, block = _case(5, n=64, nq=4, block=32), 32
        return inp.query_attrs, inp.ks, inp.data_attrs, \
            [(0, 32), (32, 64), (64, 96), (96, 128)]
    else:                            # "k_gt_n": every k above n
        inp, block = _case(5, n=64, nq=4, block=32), 32
        return inp.query_attrs, np.array([64, 65, 100, 1], np.int32), \
            inp.data_attrs, [(0, 32), (32, 64)]
    n = inp.params.num_data
    ranges = [(lo, min(lo + block, n)) for lo in range(0, n, block)]
    return inp.query_attrs, inp.ks, inp.data_attrs, ranges


SUMMARY_CASES = ("uniform", "banded", "banded_dups", "ragged_tail",
                 "empty_blocks", "k_gt_n")
SUMMARY_FIELDS = ("counts", "nmin", "nmax", "lo", "hi", "pcounts", "pnmin",
                  "pnmax", "plo", "phi", "nq50", "nq50_cnt")


@pytest.mark.parametrize("pieces", [2, 1])
@pytest.mark.parametrize("name", SUMMARY_CASES)
def test_summaries_and_bounds_equal_reference(name, pieces):
    q, ks, data, ranges = _summary_case(name)
    got = osum.build_summaries(data, ranges, pieces=pieces)
    want = ref_sum.build_summaries(data, ranges, pieces=pieces)
    assert got.ranges == want.ranges and got.nbytes == want.nbytes
    for f in SUMMARY_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), f
    lb, ub = osum.block_bounds(q, got)
    rlb, rub = ref_sum.block_bounds(q, want)
    assert np.array_equal(lb, rlb) and np.array_equal(ub, rub)
    assert np.array_equal(osum.kth_thresholds(ub, got.counts, ks),
                          ref_sum.kth_thresholds(rub, want.counts, ks))
    if pieces > 1:
        plb, pub = osum.piece_bounds(q, got)
        rplb, rpub = ref_sum.piece_bounds(q, want)
        assert np.array_equal(plb, rplb) and np.array_equal(pub, rpub)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("staging", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SUMMARY_CASES)
def test_prune_mask_equal_reference(name, staging, precision):
    q, ks, data, ranges = _summary_case(name)
    keep, stats = osum.prune_mask(q, ks, osum.build_summaries(data, ranges),
                                  staging=staging, precision=precision)
    rkeep, rstats = ref_sum.prune_mask(
        q, ks, ref_sum.build_summaries(data, ranges), staging=staging,
        precision=precision)
    assert keep.dtype == rkeep.dtype and np.array_equal(keep, rkeep)
    assert stats == rstats
    if name == "banded" and staging == "float32" and precision == "f32":
        assert stats["blocks_pruned"] > 0     # the case is not vacuous
    if name == "empty_blocks":
        assert not keep[2] and not keep[3]    # an empty block never survives


def test_kill_switch_and_note_scan(monkeypatch):
    monkeypatch.setenv("DMLP_TPU_PRUNE", "0")
    assert not osum.prune_enabled() and not ref_sum.prune_enabled()
    monkeypatch.setenv("DMLP_TPU_PRUNE", "1")
    assert osum.prune_enabled()

    class Rec:
        last_prune = None

    a, b = Rec(), Rec()
    for rec, mod in ((a, osum), (b, ref_sum)):
        mod.note_scan(rec, scanned_bytes=10, dense_bytes=40,
                      blocks_total=4, blocks_pruned=3)
    assert a.last_prune == b.last_prune
    assert a.last_prune["pruned_fraction"] == 0.75


# -- the engine ---------------------------------------------------------------

def _both(monkeypatch, inp, env=(), **kw):
    """Solve ``inp`` with both engines under one configuration and the
    environment ``env``; stdout, golden, ``last_prune`` and the rung must
    agree. Returns the port's engine."""
    for k, v in env:
        monkeypatch.setenv(k, v)
    cfg = RefConfig(**kw)
    ref = RefEngine(cfg)
    want = format_results(ref.run(inp))
    port = SingleChipEngine(config_from_reference(cfg, device="cpu"))
    got = port_format(port.run(from_reference(inp)))
    assert got == want
    assert got == format_results(knn_golden(inp))
    assert port.last_prune == ref.last_prune
    assert port.last_degrade_rung == ref.last_degrade_rung == "lowp"
    assert (port._last_select, port.last_extract_impl, port.last_hetk,
            port.last_repairs) == (ref._last_select, ref.last_extract_impl,
                                   ref.last_hetk, ref.last_repairs)
    assert "prune" in port.last_phase_ms
    return port


@pytest.mark.parametrize("prune", ["1", "0"])
@pytest.mark.parametrize("seed,banded", [(21, True), (22, False),
                                         (23, True)])
def test_topk_streaming_prune(monkeypatch, seed, banded, prune):
    inp = _case(seed, banded=banded, dup_boundaries=True)
    port = _both(monkeypatch, inp, [("DMLP_TPU_PRUNE", prune)],
                 select="topk", data_block=256)
    if prune == "0" or not banded:
        assert port.last_prune["blocks_pruned"] == 0
    else:
        assert port.last_prune["blocks_pruned"] > 0


@pytest.mark.parametrize("prune", ["1", "0"])
@pytest.mark.parametrize("banded", [True, False])
def test_seg_pallas_prune(monkeypatch, banded, prune):
    """--select seg --pallas: K3's plain version feeds the fold, over
    chunks of 1,024 rows (the seg granule)."""
    inp = _case(24, n=4096, nq=10, block=1024, banded=banded,
                dup_boundaries=True)
    port = _both(monkeypatch, inp, [("DMLP_TPU_PRUNE", prune)],
                 select="seg", use_pallas=True, data_block=1024)
    assert port._last_select == "seg"
    assert port.last_prune["blocks_total"] == 4
    assert (port.last_prune["blocks_pruned"] > 0) == \
        (banded and prune == "1")


def _far_band_input(seed=71, ks=None):
    """tests/test_prune.py's far-band input (its mesh case): 25,600 rows,
    the far band in the second half, a duplicate pair inside it. At
    --data-block 12800 both packages plan the same 2 chunks of 12,800 rows
    (their extraction granules differ: 12,800 rows and 256)."""
    rng = np.random.default_rng(seed)
    n, nq, na = 25600, 8, 3
    data = rng.uniform(0, 1, (n, na))
    data[12800:] += 200.0
    data[12900] = data[12901]
    ks = rng.integers(1, 6, nq).astype(np.int32) if ks is None \
        else np.asarray(ks, np.int32)
    return KNNInput(Params(n, len(ks), na),
                    rng.integers(0, 4, n).astype(np.int32), data, ks,
                    rng.uniform(0, 1, (len(ks), na)))


@pytest.mark.parametrize("fused,prune", [("1", "1"), ("1", "0"), ("0", "1"),
                                         ("0", "0")])
def test_extract_prune_fused_matrix(monkeypatch, fused, prune):
    port = _both(monkeypatch, _far_band_input(),
                 [("DMLP_TPU_FUSED", fused), ("DMLP_TPU_PRUNE", prune)],
                 select="extract", use_pallas=True, data_block=12800)
    assert port.last_extract_impl == ("fused" if fused == "1" else "extract")
    assert port.last_prune["blocks_pruned"] == (1 if prune == "1" else 0)
    assert port.last_prune["scanned_bytes"] < \
        port.last_prune["dense_bytes"] or prune == "0"


@pytest.mark.parametrize("prune", ["1", "0"])
def test_router_one_schedule_for_bulk_and_outliers(monkeypatch, prune):
    """The heterogeneous-k router: the bulk on the extraction kernel and
    the wide-k outliers through the seg fold share one pruned sweep."""
    port = _both(monkeypatch, _far_band_input(ks=[3, 700, 1, 5, 900, 2, 4, 1]),
                 [("DMLP_TPU_PRUNE", prune)], select="extract",
                 use_pallas=True, data_block=12800)
    assert port.last_hetk == (6, 2)
    assert port.last_prune["blocks_pruned"] == (1 if prune == "1" else 0)


def test_uniform_extract_prunes_nothing(monkeypatch):
    inp = _far_band_input()
    inp.data_attrs[12800:] -= 200.0       # one band: nothing to prune
    port = _both(monkeypatch, inp, select="extract", use_pallas=True,
                 data_block=12800)
    assert port.last_prune["blocks_pruned"] == 0
    assert port.last_prune["scanned_bytes"] == \
        port.last_prune["dense_bytes"]


def test_nonvacuity_banded_corpus_prunes_most_blocks(monkeypatch):
    rng = np.random.default_rng(41)
    n, nq, na, block = 4096, 8, 6, 256
    data = rng.uniform(0, 2, (n, na))
    for b in range(n // block):
        data[b * block:(b + 1) * block] += 30.0 * b
    inp = KNNInput(Params(n, nq, na),
                   rng.integers(0, 5, n).astype(np.int32), data,
                   rng.integers(1, 9, nq).astype(np.int32),
                   rng.uniform(0, 2, (nq, na)))
    port = _both(monkeypatch, inp, select="topk", data_block=block)
    assert port.last_prune["pruned_fraction"] > 0.5
    assert port.last_prune["scanned_bytes"] < \
        0.5 * port.last_prune["dense_bytes"]


def test_candidates_stay_dense(monkeypatch):
    """candidates() has no f64-repair backstop behind its ordering: it
    never takes the pruned path, in either package."""
    monkeypatch.setenv("DMLP_TPU_PRUNE", "1")
    inp = _case(51, banded=True)
    cfg = RefConfig(select="topk", data_block=256)
    ref = RefEngine(cfg)
    port = SingleChipEngine(config_from_reference(cfg, device="cpu"))
    rd, rl, ri = ref.candidates(inp)
    pd, pl, pi = port.candidates(from_reference(inp))
    assert np.array_equal(pi, ri) and np.array_equal(pl, rl)
    assert port.last_prune == ref.last_prune
    assert port.last_prune["blocks_pruned"] == 0
    assert port._degrade_rung == "fused"


# -- ROADMAP queue C: the uncovered cases, through both CLIs -------------------

def _banded_text(n, nq, na, kmin, kmax, band_rows, seed=7):
    """A norm-banded input: uniform [0, 50) data plus 1,000 per band of
    ``band_rows`` rows, uniform [0, 50) queries near band 0."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, 50, (n, na)) + 1000.0 * (np.arange(n) //
                                                   band_rows)[:, None]
    return format_input(KNNInput(
        Params(n, nq, na), rng.integers(0, 5, n).astype(np.int32), data,
        rng.integers(kmin, kmax + 1, nq).astype(np.int32),
        rng.uniform(0, 50, (nq, na))))


PATHS = {   # path -> (input text builder, CLI flags)
    "extract": (lambda: _banded_text(9000, 24, 6, 1, 16, 4608),
                ["--pallas", "--data-block", "4608"]),
    "router": (lambda: _banded_text(9000, 24, 6, 1, 900, 4608),
               ["--pallas", "--data-block", "4608"]),
    "multipass": (lambda: _banded_text(9000, 6, 4, 600, 700, 4608),
                  ["--pallas", "--data-block", "4608"]),
    "topk": (lambda: _banded_text(9000, 24, 6, 1, 16, 4608),
             ["--data-block", "4608"]),
    "sort": (lambda: _banded_text(3000, 24, 6, 1, 16, 1500), []),
    "seg": (lambda: _banded_text(9000, 24, 6, 1, 16, 4608),
            ["--select", "seg", "--pallas", "--data-block", "4608"]),
}
EDGE = {    # case -> (input text builder, CLI flags)
    "n1": (lambda: generate_input_text(1, 5, 4, 0, 10, 1, 3, 3, seed=5),
           []),
    "n1_pallas": (lambda: generate_input_text(1, 5, 4, 0, 10, 1, 3, 3,
                                              seed=5), ["--pallas"]),
    "no_queries": (lambda: generate_input_text(9000, 0, 4, 0, 10, 1, 3, 3,
                                               seed=6), []),
    "no_queries_pallas": (lambda: generate_input_text(
        9000, 0, 4, 0, 10, 1, 3, 3, seed=6), ["--pallas"]),
    "k_eq_n": (lambda: generate_input_text(300, 6, 4, 0, 10, 300, 300, 3,
                                           seed=8), []),
    "k_eq_n_pallas": (lambda: generate_input_text(
        9000, 3, 4, 0, 10, 9000, 9000, 3, seed=8), ["--pallas"]),
    "na1": (lambda: generate_input_text(9000, 12, 1, 0, 10, 1, 16, 3,
                                        seed=9), []),
    "na1_pallas": (lambda: generate_input_text(9000, 12, 1, 0, 10, 1, 16, 3,
                                               seed=9), ["--pallas"]),
}
QUEUE_C = [pytest.param(p, "precision", id=f"{p}-bf16_precision")
           for p in PATHS] + \
    [pytest.param(p, "dtype", id=f"{p}-bf16_dtype") for p in PATHS] + \
    [pytest.param(c, None, id=c) for c in EDGE]


def _cli(main, argv, text):
    out, err = io.StringIO(), io.StringIO()
    assert main(argv, stdin=io.StringIO(text), stdout=out, stderr=err) == 0
    return out.getvalue()


@pytest.mark.parametrize("case,bf16", QUEUE_C)
def test_queue_c_stdout_matches_reference_and_golden(monkeypatch, case,
                                                     bf16):
    build, flags = PATHS[case] if case in PATHS else EDGE[case]
    text = build()
    monkeypatch.delenv("DMLP_TPU_PRECISION", raising=False)
    if bf16 == "precision":
        monkeypatch.setenv("DMLP_TPU_PRECISION", "bf16")
    elif bf16 == "dtype":
        flags = [*flags, "--dtype", "bfloat16"]
    got = _cli(cli.main, ["--device", "cpu", *flags], text)
    want = _cli(ref_cli.main, flags, text)
    monkeypatch.delenv("DMLP_TPU_PRECISION", raising=False)
    golden = _cli(cli.main, ["--engine", "golden"], text)
    assert got == want
    assert got == golden
