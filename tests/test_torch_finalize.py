"""The port's own copies of the host-side modules against the reference's:
engine.finalize, golden.reference, golden.fast, io.grammar, io.checksum,
io.report, io.datagen and io.convert — equal results on datagen fuzz and
duplicate-row grids."""

import dataclasses
import io

import numpy as np
import pytest

from dmlp_tpu.config import EngineConfig as RefConfig
from dmlp_tpu.engine import finalize as rfin
from dmlp_tpu.golden import fast as rfast
from dmlp_tpu.golden import reference as rref
from dmlp_tpu.io import checksum as rck
from dmlp_tpu.io import datagen as rgen
from dmlp_tpu.io import grammar as rgram
from dmlp_tpu.io import report as rrep
from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.engine import finalize as tfin
from dmlp_tpu_torch.golden import fast as tfast
from dmlp_tpu_torch.golden import reference as tref
from dmlp_tpu_torch.io import checksum as tck
from dmlp_tpu_torch.io import datagen as tgen
from dmlp_tpu_torch.io import grammar as tgram
from dmlp_tpu_torch.io import report as trep
from dmlp_tpu_torch.io.convert import config_from_reference, from_reference


def _fuzz_text(seed):
    return rgen.generate_input_text(600, 40, 6, -5, 5, 1, 20, 4, seed=seed)


def _dup_grid(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 3, (400, 3)).astype(np.float64)
    q = rng.integers(0, 3, (30, 3)).astype(np.float64)
    labels = rng.integers(0, 4, 400).astype(np.int32)
    ks = rng.integers(1, 30, 30).astype(np.int32)
    return (rgram.KNNInput(rgram.Params(400, 30, 3), labels, data, ks, q),
            tgram.KNNInput(tgram.Params(400, 30, 3), labels, data, ks, q))


def _pair(kind, seed):
    if kind == "fuzz":
        text = _fuzz_text(seed)
        return rgram.parse_input_text(text), tgram.parse_input_text(text)
    return _dup_grid(seed)


def _same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.query_id, x.k, x.predicted_label) == \
            (y.query_id, y.k, y.predicted_label)
        assert np.array_equal(x.neighbor_ids, y.neighbor_ids)
        assert np.array_equal(x.neighbor_dists, y.neighbor_dists)


@pytest.mark.parametrize("kind,seed", [("fuzz", 1), ("fuzz", 2),
                                       ("dup", 3), ("dup", 4)])
def test_oracles_match_reference(kind, seed):
    rinp, tinp = _pair(kind, seed)
    _same_results(tref.knn_golden(tinp), rref.knn_golden(rinp))
    rs, ts = {}, {}
    _same_results(tfast.knn_golden_fast(tinp, margin=2, stats=ts),
                  rfast.knn_golden_fast(rinp, margin=2, stats=rs))
    assert ts == rs
    assert trep.format_results(tref.knn_golden(tinp), debug=True) == \
        rrep.format_results(rref.knn_golden(rinp), debug=True)


@pytest.mark.parametrize("kind,seed", [("fuzz", 5), ("dup", 6)])
@pytest.mark.parametrize("exact", [True, False])
def test_finalize_functions_match_reference(kind, seed, exact):
    rinp, tinp = _pair(kind, seed)
    rng = np.random.default_rng(seed)
    nq, nd = tinp.params.num_queries, tinp.params.num_data
    kcap = int(tinp.ks.max()) + 8
    ids = np.stack([rng.permutation(nd)[:kcap] for _ in range(nq)])
    ids[:, -2:] = -1
    labels = np.where(ids >= 0, tinp.labels[np.clip(ids, 0, None)], -1)
    dists = rfin.rescore_f64(ids, tinp.query_attrs, tinp.data_attrs)
    assert np.array_equal(
        tfin.rescore_f64(ids, tinp.query_attrs, tinp.data_attrs), dists)
    _same_results(
        tfin.finalize_host(dists, labels, ids, tinp.ks, tinp.query_attrs,
                           tinp.data_attrs, exact=exact),
        rfin.finalize_host(dists, labels, ids, rinp.ks, rinp.query_attrs,
                           rinp.data_attrs, exact=exact))
    qn = (tinp.query_attrs ** 2).sum(1)
    dn_max = float((tinp.data_attrs ** 2).sum(1).max())
    srt = np.sort(dists, 1)
    for staging in ("float32", "bfloat16"):
        assert np.array_equal(
            tfin.staging_eps(srt[:, -1], qn, dn_max, staging, 3),
            rfin.staging_eps(srt[:, -1], qn, dn_max, staging, 3))
    for prec in ("f32", "bf16"):
        assert np.array_equal(tfin.lowp_eps(prec, qn, dn_max),
                              rfin.lowp_eps(prec, qn, dn_max))
    eps = rfin.staging_eps(srt[:, -1], qn, dn_max, "float32", 3)
    flags = tfin.boundary_overflow(srt, tinp.ks, eps)
    assert np.array_equal(flags, rfin.boundary_overflow(srt, rinp.ks, eps))
    assert np.array_equal(
        tfin.boundary_hazard(srt[:, 0], srt[:, -1], eps),
        rfin.boundary_hazard(srt[:, 0], srt[:, -1], eps))
    # The repair recomputes the flagged queries through each package's
    # own oracle; both must land on the same results.
    sus = np.arange(0, nq, 3)
    tres = tfin.finalize_host(dists, labels, ids, tinp.ks, tinp.query_attrs,
                              tinp.data_attrs)
    rres = rfin.finalize_host(dists, labels, ids, rinp.ks, rinp.query_attrs,
                              rinp.data_attrs)
    tfin.repair_boundary_overflow(tres, sus, tinp)
    rfin.repair_boundary_overflow(rres, sus, rinp)
    _same_results(tres, rres)


def test_eps_constants_match_reference():
    for name in ("EPS_REL_BF16", "EPS_REL_F32", "EPS_CANCEL_COEF",
                 "LOWP_COEF"):
        assert getattr(tfin, name) == getattr(rfin, name)


@pytest.mark.parametrize("seed", [7, 8])
def test_io_copies_match_reference(seed):
    args = (300, 25, 5, -3.0, 3.0, 1, 12, 6)
    text = tgen.generate_input_text(*args, seed=seed)
    assert text == rgen.generate_input_text(*args, seed=seed)
    a, b = tgram.parse_input_text(text), rgram.parse_input_text(text)
    assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
    for f in ("labels", "data_attrs", "ks", "query_attrs"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert tgram.format_input(a) == rgram.format_input(b)
    assert tgram.parse_input(io.BytesIO(text.encode())).params == a.params
    idx = np.array([3, 0, 7])
    sa, sb = tgram.subset_queries(a, idx), rgram.subset_queries(b, idx)
    assert np.array_equal(sa.query_attrs, sb.query_attrs)
    conv = from_reference(b)
    for f in ("labels", "data_attrs", "ks", "query_attrs"):
        assert np.array_equal(getattr(conv, f), getattr(a, f))
    assert conv.params == a.params


def test_checksum_and_report_match_reference():
    rng = np.random.default_rng(9)
    for _ in range(20):
        ids = rng.integers(-1, 10**6, rng.integers(1, 40))
        label = int(rng.integers(-1, 10))
        assert tck.fnv1a_checksum(label, ids) == rck.fnv1a_checksum(label, ids)
    ids = rng.integers(-1, 1000, (5, 8))
    assert list(tck.fnv1a_checksum_batch([1, 2, 3, 4, 5], ids, [8] * 5)) == \
        list(rck.fnv1a_checksum_batch([1, 2, 3, 4, 5], ids, [8] * 5))
    res = [trep.QueryResult(i, 3, 1, np.array([5, 2, -1]),
                            np.array([0.5, 1.25, np.inf])) for i in range(3)]
    ref = [rrep.QueryResult(i, 3, 1, np.array([5, 2, -1]),
                            np.array([0.5, 1.25, np.inf])) for i in range(3)]
    for debug in (False, True):
        assert trep.format_results(res, debug) == \
            rrep.format_results(ref, debug)


def test_grammar_errors_match_reference():
    for bad in ("2 1 2\n0 1 2\n\nQ 1 1 1\n", "1 1 2\n0 1 2\nX 1 1 1\n",
                "1 1 2\n0 1\nQ 1 1 1\n", "1 1 2\n0 1_0 2\nQ 1 1 1\n"):
        with pytest.raises(rgram.ParseError) as r:
            rgram.parse_input_text(bad)
        with pytest.raises(tgram.ParseError) as t:
            tgram.parse_input_text(bad)
        assert str(t.value) == str(r.value)


def test_config_rules_match_reference(monkeypatch):
    """resolve_select/_streaming_select/_data_block/_precision agree with
    the reference over a grid of rows x flags x env; the granule of
    "extract" is the port kernel's own block."""
    from dmlp_tpu_torch.ops.extract import BLOCK_ROWS
    for env in (None, "f32", "bf16", "int8"):
        if env is None:
            monkeypatch.delenv("DMLP_TPU_PRECISION", raising=False)
        else:
            monkeypatch.setenv("DMLP_TPU_PRECISION", env)
        for pallas in (False, True):
            for select in ("auto", "sort", "topk", "extract"):
                for exact in (True, False):
                    for precision in ("auto", "f32", "bf16"):
                        kw = dict(use_pallas=pallas, select=select,
                                  exact=exact, precision=precision)
                        r, t = RefConfig(**kw), EngineConfig(device="cpu",
                                                             **kw)
                        assert t.resolve_precision() == r.resolve_precision()
                        for rows in (8, 8192, 8200, 204800):
                            assert t.resolve_select(rows) == \
                                r.resolve_select(rows)
                            assert t.resolve_streaming_select(rows) == \
                                r.resolve_streaming_select(rows)
                        for s in ("sort", "topk", "seg", "extract"):
                            assert t.resolve_data_block(s) == \
                                r.resolve_data_block(s)
                            if s != "extract":
                                assert t.resolve_granule(s) == \
                                    r.resolve_granule(s)
                        assert t.resolve_granule("extract") == BLOCK_ROWS
                        assert t.resolve_dtype() == "float32"
    assert config_from_reference(RefConfig(margin=3, select="topk"),
                                 device="cpu") == \
        EngineConfig(margin=3, select="topk", device="cpu")
    with pytest.raises(ValueError):
        EngineConfig(device="tpu")
