"""The port's serving engine (dmlp_tpu_torch.serve) against the reference's.

The same numpy-seeded corpora and micro-batches go through
``dmlp_tpu.serve.engine.ResidentEngine`` (Pallas in interpret mode, as
``tests/test_serve.py`` runs it) and the port's ``ResidentEngine`` on the
CPU (the kernels' plain versions). Tolerances:

- responses (ids, labels, checksums): equal, and equal to the float64
  oracle;
- candidate lists: integer-valued attributes make every f32 distance
  exact, so distances are equal with tolerance 0, and ids are equal but
  for the members of each row's last tie group (the two kernels may evict
  different members of a tie group at the boundary; the boundary test
  flags those rows for the float64 repair);
- ``last_prune``, the fold order and ``summary_rebuilds``: equal. The
  engines' chunk plans agree only where the rows fill whole chunks of
  both (the port's extraction granule is 256 rows, the reference's
  12,800); ``data_block=25600`` with a capacity of 51,200 or 76,800 rows
  gives both two or three chunks of 25,600 rows (at ``data_block=12800``
  that takes about 210,000 rows, too many for the interpret mode here);
- ``score_blocks`` survivor masks: equal bit for bit; a block whose f32
  reduction order could make it differ must have its lower bound within
  one f32 ulp of the widened threshold (the stated tolerance; none occurs
  on these inputs);
- block summaries after ``update_block`` and the corpus signature: equal
  bit for bit.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dmlp_tpu.config import EngineConfig as RefConfig  # noqa: E402
from dmlp_tpu.io.grammar import KNNInput as RefInput  # noqa: E402
from dmlp_tpu.io.grammar import Params as RefParams  # noqa: E402
from dmlp_tpu.io.report import format_results as ref_format  # noqa: E402
from dmlp_tpu.ops import pallas_extract as ref_extract  # noqa: E402
from dmlp_tpu.ops import summaries as ref_sum  # noqa: E402
from dmlp_tpu.serve import protocol as ref_protocol  # noqa: E402
from dmlp_tpu.serve.engine import ResidentEngine as RefResident  # noqa: E402
from dmlp_tpu_torch.config import EngineConfig  # noqa: E402
from dmlp_tpu_torch.fleet import consistency as ccs  # noqa: E402
from dmlp_tpu_torch.golden.fast import knn_golden_fast  # noqa: E402
from dmlp_tpu_torch.io.convert import (config_from_reference,  # noqa: E402
                                       from_reference)
from dmlp_tpu_torch.io.grammar import KNNInput, Params  # noqa: E402
from dmlp_tpu_torch.io.report import format_results  # noqa: E402
from dmlp_tpu_torch.ops import extract as ex  # noqa: E402
from dmlp_tpu_torch.ops import summaries as osum  # noqa: E402
from dmlp_tpu_torch.resilience import inject as rs_inject  # noqa: E402
from dmlp_tpu_torch.resilience import stats as rs_stats  # noqa: E402
from dmlp_tpu_torch.serve import protocol  # noqa: E402
from dmlp_tpu_torch.serve.admission import AdmissionController  # noqa: E402
from dmlp_tpu_torch.serve.batching import MicroBatcher, Request  # noqa: E402
from dmlp_tpu_torch.serve.engine import (CapacityError,  # noqa: E402
                                         RequestShapeError, ResidentEngine,
                                         k_bucket, query_bucket)

CHUNK = 25600
EXTRACT = dict(select="extract", use_pallas=True, data_block=CHUNK)


def _banded(n, na, seed, band=400.0):
    """Integer attributes in [0, 16), every 25,600-row chunk shifted by
    ``band`` on attribute 0: queries near one band prune the others."""
    rng = np.random.default_rng(seed)
    attrs = rng.integers(0, 16, (n, na)).astype(np.float64)
    attrs[:, 0] += band * (np.arange(n) // CHUNK)
    labels = rng.integers(0, 5, n).astype(np.int32)
    return RefInput(RefParams(n, 0, na), labels, attrs,
                    np.zeros(0, np.int32), np.zeros((0, na)))


def _queries(rng, nq, na, bands, band=400.0):
    q = rng.integers(0, 16, (nq, na)).astype(np.float64)
    q[:, 0] += band * np.asarray(bands)[rng.integers(0, len(bands), nq)]
    return q


def _engines(ref_corpus, cfg: dict, capacity, gate_carry=True):
    ref = RefResident(ref_corpus, RefConfig(**cfg), capacity=capacity,
                      gate_carry=gate_carry)
    port = ResidentEngine(from_reference(ref_corpus),
                          config_from_reference(RefConfig(**cfg), "cpu"),
                          capacity=capacity, gate_carry=gate_carry)
    return ref, port


def _golden(corpus: KNNInput, q, ks) -> str:
    inp = KNNInput(Params(corpus.params.num_data, len(ks),
                          corpus.params.num_attrs),
                   corpus.labels, corpus.data_attrs,
                   np.asarray(ks, np.int32), np.asarray(q, np.float64))
    return format_results(knn_golden_fast(inp))


def _recording(*engines):
    """Wrap each engine's ``_solve`` so a solve_batch leaves its device
    candidates (the last TopK) in ``engine.recorded``."""
    for e in engines:
        def rec(inp, _solve=e._solve, _e=e):
            out = _solve(inp)
            _e.recorded = out[0]
            return out
        e._solve = rec


def _assert_candidates_equal(ref, port, nq):
    rd = np.asarray(ref.recorded.dists)[:nq]
    ri = np.asarray(ref.recorded.ids)[:nq]
    pd = port.recorded.dists.numpy()[:nq]
    pi = port.recorded.ids.numpy()[:nq]
    assert np.array_equal(pd, rd)
    inner = rd < rd[:, -1:]
    assert np.array_equal(pi[inner], ri[inner])


# -- the engine against the reference: extract, multi-pass, stream ---------

# name: (corpus rows, capacity, config, [(nq, kmax, bands)])
SOLVE_CASES = {
    # Three chunks; the queries sit in bands 2 and 0, so chunk 1 prunes
    # and the hot-first order folds chunk 2 first: K1 then folds chunk 0
    # with a carry whose ids lie above it.
    "extract": (56000, 76800, EXTRACT,
                [(9, 8, [2, 2, 0]), (40, 16, [2, 2, 2, 0]), (1, 1, [2])]),
    # K3's fold ("seg" under the hand kernels) over the resident rows.
    "stream": (6000, 8192, dict(select="seg", use_pallas=True),
               [(9, 8, [0]), (33, 20, [0])]),
}


def _serve_both(ref, ports, corpus, batches, seed=21):
    """Each batch through the reference and every port engine: the
    candidates, the fold order, the bytes (against the oracle too) and
    last_prune equal."""
    _recording(ref, *ports)
    rng = np.random.default_rng(seed)
    for nq, kmax, bands in batches:
        q = _queries(rng, nq, 4, bands)
        ks = rng.integers(max(1, kmax // 2), kmax + 1, nq).astype(np.int32)
        want = ref_format(ref.solve_batch(q, ks))
        assert want == _golden(from_reference(corpus), q, ks)
        for port in ports:
            got = format_results(port.solve_batch(q, ks))
            assert got == want
            _assert_candidates_equal(ref, port, nq)
            assert port.last_prune == ref.last_prune
            assert port.last_degrade_rung == "lowp"
            assert port._chunk_order() == [int(c)
                                           for c in ref._chunk_order()]


@pytest.mark.parametrize("carry", [True, False], ids=["carry", "natural"])
@pytest.mark.parametrize("name", list(SOLVE_CASES))
def test_solve_batch_matches_reference(name, carry):
    n, cap, cfg, batches = SOLVE_CASES[name]
    corpus = _banded(n, 4, seed=11)
    ref, port = _engines(corpus, cfg, cap, gate_carry=carry)
    _serve_both(ref, [port], corpus, batches)
    paths = set(port.bucket_stats()["paths"].values())
    assert paths == {name} == set(ref.bucket_stats()["paths"].values())
    if name == "extract":
        # The middle band pruned, the hot chunk first from batch 2 on.
        assert port.last_prune["blocks_pruned"] >= 1
        assert int(np.argmax(port._block_hits)) == (2 if carry else 0)
        assert port._chunk_order()[0] == (2 if carry else 0)
        assert port.last_gated_fraction is not None


def test_multipass_bucket_matches_reference():
    """kmax in (256, 512]: k-bucket 512, kcap 576 > 512, so two passes over
    the resident rows; the port with gate carry on and off (the multi-pass
    fold does not read the winner histogram) against one reference
    engine."""
    corpus = _banded(20000, 4, seed=11)
    ref, port = _engines(corpus, EXTRACT, CHUNK)
    port_off = ResidentEngine(from_reference(corpus),
                              EngineConfig(**EXTRACT, device="cpu"),
                              capacity=CHUNK, gate_carry=False)
    _serve_both(ref, [port, port_off], corpus, [(5, 400, [0])])
    for p in (port, port_off):
        assert p.bucket_stats()["paths"] == {"q32k512": "multipass"}
        assert p.last_mp_passes == ref.last_mp_passes == 2


def test_ingest_across_a_chunk_boundary_matches_reference():
    """Rows appended across the boundary of chunks 0 and 1 and into chunk
    2 rebuild exactly the touched blocks' summaries (as many as the
    reference rebuilds), keep the max norm growing, and serve the grown
    corpus with the reference's and the oracle's bytes; an idempotent
    overwrite changes nothing, the corpus signature included."""
    corpus = _banded(25000, 4, seed=12)
    ref, port = _engines(corpus, EXTRACT, 76800)
    rng = np.random.default_rng(3)
    q = _queries(rng, 8, 4, [0, 1])
    ks = np.full(8, 6, np.int32)
    assert format_results(port.solve_batch(q, ks)) == \
        ref_format(ref.solve_batch(q, ks))
    # 26,800 rows from row 25,000 (across both chunk boundaries), then
    # 200 rows inside chunk 2.
    grown = from_reference(corpus)
    for m, band in ((26800, 1), (200, 2)):
        newa = rng.integers(0, 16, (m, 4)).astype(np.float64)
        newa[:, 0] += 400.0 * band
        newl = rng.integers(0, 5, m).astype(np.int32)
        assert port.ingest(newl, newa) == ref.ingest(newl, newa)
        grown = KNNInput(Params(grown.params.num_data + m, 0, 4),
                         np.concatenate([grown.labels, newl]),
                         np.vstack([grown.data_attrs, newa]),
                         np.zeros(0, np.int32), np.zeros((0, 4)))
        assert port.summary_rebuilds == ref.summary_rebuilds
        assert port._dn_max_cache == ref._dn_max_cache
        for bands in ([band], [0, band]):
            q = _queries(rng, 8, 4, bands)
            got = format_results(port.solve_batch(q, ks))
            assert got == ref_format(ref.solve_batch(q, ks))
            assert got == _golden(grown, q, ks)
            assert port.last_prune == ref.last_prune
    assert port.summary_rebuilds == 4          # chunks 0, 1, 2, then 2
    assert port.corpus_state() == ref.corpus_state()
    state = port.corpus_state()
    port.ingest(grown.labels[100:300], grown.data_attrs[100:300], start=100)
    assert port.corpus_state() == {**state, "epoch": state["epoch"] + 1}
    assert port.corpus_state()["checksum"] == ccs.corpus_fold(
        grown.labels, grown.data_attrs)


def test_ingest_into_a_new_chunk_capacity_and_k_cap():
    corpus = _banded(12800, 4, seed=13)
    port = ResidentEngine(from_reference(corpus),
                          EngineConfig(**EXTRACT, device="cpu"),
                          capacity=51200)
    rng = np.random.default_rng(6)
    q = _queries(rng, 5, 4, [0])
    ks = np.full(5, 6, np.int32)
    port.solve_batch(q, ks)
    newa = rng.integers(0, 16, (26000, 4)).astype(np.float64)
    newl = rng.integers(0, 5, 26000).astype(np.int32)
    assert port.ingest(newl, newa) == 38800
    grown = KNNInput(Params(38800, 0, 4),
                     np.concatenate([corpus.labels, newl]),
                     np.vstack([corpus.data_attrs, newa]),
                     np.zeros(0, np.int32), np.zeros((0, 4)))
    assert format_results(port.solve_batch(q, ks)) == _golden(grown, q, ks)
    assert port.bucket_stats()["compile_count"] == 1   # no new bucket
    with pytest.raises(CapacityError):
        port.ingest(np.zeros(20000, np.int32), np.zeros((20000, 4)))
    with pytest.raises(ValueError):
        port.ingest(np.zeros(1, np.int32), np.zeros((1, 4)), start=40000)
    with pytest.raises(RequestShapeError):
        port.solve_batch(q[:1], np.array([51201], np.int32))
    bf = ResidentEngine(from_reference(corpus),
                        EngineConfig(dtype="bfloat16", device="cpu"))
    assert bf.max_k == 512
    with pytest.raises(RequestShapeError):
        bf.solve_batch(q[:1], np.array([513], np.int32))


def test_buckets_and_builds_match_reference_keys():
    assert [query_bucket(v) for v in (1, 7, 8, 9, 17)] == [8, 8, 8, 16, 32]
    assert query_bucket(3, granule=32) == 32
    assert [k_bucket(v) for v in (1, 2, 3, 8, 9, 17)] == [1, 2, 4, 8, 16, 32]
    corpus = from_reference(_banded(3000, 4, seed=14))
    port = ResidentEngine(corpus, EngineConfig(device="cpu"))
    per = port.warmup([(1, 1), (7, 3), (8, 4), (9, 5)])
    assert sorted(per) == ["q16k8", "q8k1", "q8k4"]
    assert port.compile_count == 3 and port.cold_start_compile_ms > 0
    rng = np.random.default_rng(1)
    for nq, k in ((2, 1), (8, 3), (12, 7)):
        q = _queries(rng, nq, 4, [0])
        ks = np.full(nq, k, np.int32)
        assert format_results(port.solve_batch(q, ks)) == \
            _golden(corpus, q, ks)
    assert port.compile_count == 3
    st = port.bucket_stats()
    assert st["hlo_schedule"] == {} and st["kernel_loads"] == 0


def test_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    corpus = from_reference(_banded(100, 4, seed=15))
    with pytest.raises(RuntimeError, match="cuda"):
        ResidentEngine(corpus, EngineConfig())


# -- ops.summaries: score_blocks, update_block -------------------------------

@pytest.mark.parametrize("staging,precision",
                         [("float32", "f32"), ("bfloat16", "bf16")])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_blocks_masks_match_reference(seed, staging, precision):
    rng = np.random.default_rng(seed)
    nb, rows, na = 12, 200, 6
    attrs = rng.uniform(-5, 5, (nb * rows, na))
    attrs += 20.0 * (np.arange(nb * rows) // rows)[:, None] / nb
    ranges = [(b * rows, (b + 1) * rows) for b in range(nb)]
    ranges[5] = (5 * rows, 5 * rows)            # an empty block
    summ = ref_sum.build_summaries(attrs, ranges)
    psumm = osum.build_summaries(attrs, ranges)
    dev = ref_sum.stage_summaries(summ)
    pdev = osum.stage_summaries(psumm, "cpu")
    for key in dev:
        assert np.array_equal(np.asarray(dev[key]), pdev[key].numpy()), key
    from dmlp_tpu_torch.engine.finalize import (EPS_CANCEL_COEF,
                                                EPS_REL_BF16, EPS_REL_F32,
                                                LOWP_COEF)
    eps_rel = np.float32(EPS_REL_BF16 if staging == "bfloat16"
                         else EPS_REL_F32)
    eps_cancel = np.float32(EPS_CANCEL_COEF * (na + 2)
                            + LOWP_COEF[precision])
    for qpad, nq, kmax in ((32, 9, 5), (64, 40, 300), (8, 1, 1)):
        q = np.zeros((qpad, na), np.float32)
        q[:nq] = rng.uniform(-5, 25, (nq, na))
        if staging == "bfloat16":
            q = torch.from_numpy(q).bfloat16().float().numpy()
        ks = np.ones(qpad, np.int32)
        ks[:nq] = rng.integers(1, kmax + 1, nq)
        qvalid = np.arange(qpad) < nq
        want = np.asarray(ref_sum.score_blocks(
            q, qvalid, ks, dev["counts"], dev["nmin"], dev["nmax"],
            dev["lo"], dev["hi"], dev["dn_max"], eps_rel, eps_cancel))
        t = torch.from_numpy
        lb, thr, eps, got = osum.score_terms(
            t(q), t(qvalid), t(ks), pdev["counts"], pdev["nmin"],
            pdev["nmax"], pdev["lo"], pdev["hi"], pdev["dn_max"],
            t(np.asarray(eps_rel)), t(np.asarray(eps_cancel)))
        diff = got.numpy() != want
        # The stated tolerance: a differing block's bound lies within one
        # f32 ulp of some valid query's widened threshold.
        edge = (thr + eps)[:, None]
        ulp = torch.abs(torch.nextafter(edge, torch.tensor(np.inf)) - edge)
        near = ((lb - edge).abs() <= ulp) & t(qvalid)[:, None]
        assert not diff.any() or bool(near.any(0)[t(diff)].all())
        assert torch.equal(osum.score_blocks(
            t(q), t(qvalid), t(ks), pdev["counts"], pdev["nmin"],
            pdev["nmax"], pdev["lo"], pdev["hi"], pdev["dn_max"],
            t(np.asarray(eps_rel)), t(np.asarray(eps_cancel))), got)
        assert int(diff.sum()) == 0


def test_update_block_matches_reference_bit_for_bit():
    rng = np.random.default_rng(4)
    attrs = rng.uniform(-3, 3, (1000, 5))
    ranges = [(0, 300), (300, 600), (600, 600), (600, 1000)]
    ref, port = (m.build_summaries(attrs, ranges) for m in (ref_sum, osum))
    grown = np.vstack([attrs, rng.uniform(-9, 9, (150, 5))])
    for b, lo, hi in ((2, 600, 600), (3, 600, 1150), (0, 0, 300)):
        rows = grown[lo:hi]
        ref_sum.update_block(ref, b, rows, lo_hi=(lo, hi))
        osum.update_block(port, b, rows, lo_hi=(lo, hi))
    for f in ("counts", "nmin", "nmax", "lo", "hi", "pcounts", "pnmin",
              "pnmax", "plo", "phi", "nq50", "nq50_cnt"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    assert port.ranges == ref.ranges


def test_corpus_signature_matches_reference():
    corpus = _banded(700, 3, seed=16)
    ref, port = _engines(corpus, {}, 2048)
    assert port.corpus_state() == ref.corpus_state()
    rng = np.random.default_rng(2)
    newa = rng.uniform(-1, 1, (40, 3))
    newl = rng.integers(0, 5, 40).astype(np.int32)
    for eng in (ref, port):
        eng.ingest(newl, newa)
        eng.ingest(newl[:10], newa[:10], start=700)   # idempotent rewrite
        eng.ingest(newl[:5], newa[5:10], start=20)    # a real overwrite
    assert port.corpus_state() == ref.corpus_state()
    assert port.corpus_state()["epoch"] == 3
    lab, att = port.corpus_slice(15, 10)
    rlab, ratt = ref.corpus_slice(15, 10)
    assert np.array_equal(lab, rlab) and np.array_equal(att, ratt)


# -- K1 with a carry folded from a later chunk (the hot-first order) --------

def _tie_chain(seed, order, splits=None, fn=None, lo=0, hi=5, kc=40,
               rows=512, qb=16, na=4):
    rng = np.random.default_rng(seed)
    q = rng.integers(lo, hi, (qb, na)).astype(np.float32)
    chunks = [rng.integers(lo, hi, (rows, na)).astype(np.float32)
              for _ in range(3)]
    od = oi = None
    for c in order:
        if fn is None:
            od, oi, _ = ex.extract_topk(
                torch.from_numpy(q), torch.from_numpy(chunks[c]), od, oi,
                n_real=rows, id_base=c * rows, kc=kc, splits=splits,
                tile_n=64)
        else:
            od, oi, _ = fn(q, chunks[c], od, oi, n_real=rows,
                           id_base=c * rows, kc=kc, interpret=True)
    return q, chunks, np.asarray(od), np.asarray(oi)


def _lexsorted(od, oi):
    od, oi = torch.as_tensor(od), torch.as_tensor(oi)
    order = torch.argsort(oi, dim=1, stable=True)
    order = torch.gather(order, 1, torch.argsort(
        torch.gather(od, 1, order), dim=1, stable=True))
    return torch.gather(od, 1, order), torch.gather(oi, 1, order)


@pytest.mark.parametrize("order", [(2, 0, 1), (2, 1, 0), (1, 2, 0)])
@pytest.mark.parametrize("seed", [12, 13])
def test_carry_above_the_chunk_lists_do_not_depend_on_splits(seed, order):
    """An integer tie grid folded hot-chunk-first: at S = 2 and 3 the
    lists equal S = 1's as sets. (Before the merge kept the carry's own
    order on ties, seed 12 in order (2, 0, 1) differed from query 0 on:
    ROADMAP queue C.)"""
    one = _lexsorted(*_tie_chain(seed, order, splits=1)[2:])
    for s in (2, 3):
        got = _lexsorted(*_tie_chain(seed, order, splits=s)[2:])
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


@pytest.mark.parametrize("order", [(2, 0, 1), (1, 2, 0)])
def test_carry_above_the_chunk_plain_matches_pallas(order):
    """The same chain through the plain version and the Pallas kernel in
    interpret mode, held under ops.extract.compare_lists' tolerance."""
    q, chunks, pd, pi = _tie_chain(12, order, splits=1)
    _, _, rd, ri = _tie_chain(12, order, fn=ref_extract.extract_topk)
    qn = torch.from_numpy((q.astype(np.float64) ** 2).sum(1))
    dn_max = max(float((c.astype(np.float64) ** 2).sum(1).max())
                 for c in chunks)
    cmp = ex.compare_lists(torch.from_numpy(pd), torch.from_numpy(pi),
                           torch.from_numpy(np.array(rd)),
                           torch.from_numpy(np.array(ri)),
                           ex.list_tolerance(qn, dn_max, q.shape[1]))
    assert cmp["ok"], cmp
    assert cmp["max_abs_err"] == 0.0


def test_merge_keeps_the_carry_order_on_ties():
    """(distance asc, carry first in slot order, then id asc): a carry
    whose tied entries' ids descend keeps its slot order."""
    inf = float("inf")
    cd = torch.tensor([[1.0, 1.0, 1.0]])
    ci = torch.tensor([[90, 70, 80]], dtype=torch.int32)
    pd = torch.tensor([[[0.5, 1.0, inf]], [[1.0, inf, inf]]])
    pi = torch.tensor([[[3, 1, -1]], [[2, -1, -1]]], dtype=torch.int32)
    od, oi = ex.merge_partials(cd, ci, pd, pi)
    assert od.tolist() == [[0.5, 1.0, 1.0]]
    assert oi.tolist() == [[3, 90, 70]]


# -- admission ----------------------------------------------------------------

def _small_engine(n=600, na=5, cap=None):
    rng = np.random.default_rng(3)
    corpus = KNNInput(Params(n, 0, na),
                      rng.integers(0, 4, n).astype(np.int32),
                      rng.uniform(-10, 10, (n, na)),
                      np.zeros(0, np.int32), np.zeros((0, na)))
    return ResidentEngine(corpus, EngineConfig(device="cpu"),
                          capacity=cap), corpus


def test_admission_budget_and_the_coalesced_batch():
    eng, _ = _small_engine()
    assert AdmissionController(eng).budget_bytes is None   # the CPU
    floor = eng.resident_model_bytes()
    assert floor == eng.mem_model()["total_bytes"]
    assert set(eng.mem_model(8, 4)["terms"]) == {
        "resident_corpus", "labels_ids", "query_blocks", "topk_carries"}
    one = AdmissionController(eng).batch_bytes(1, 4)
    adm = AdmissionController(eng, budget_bytes=floor + one * 2,
                              batch_queries_cap=64)
    assert adm.decide(1, 4, 0)["verdict"] == "accept"
    # 63 queued queries coalesce with this one into a 64-query batch,
    # which the budget cannot hold.
    d = adm.decide(1, 4, 63, queued_kmax=4)
    assert d["verdict"] == "reject" and d["reason"] == "memory"
    snap = adm.snapshot()
    assert snap["memory_shedding"] and snap["rejected"] == {"memory": 1}
    assert adm.decide(2000, 4, 0)["reason"] == "shape"
    assert adm.decide(1, eng.max_k + 1, 0)["reason"] == "k_too_large"
    assert adm.decide(600, 4, 3600)["reason"] == "queue_full"
    adm.draining = True
    assert adm.decide(1, 4, 0)["reason"] == "draining"


def test_admission_injected_squeeze_sheds_without_the_ladder():
    eng, _ = _small_engine()
    adm = AdmissionController(eng)
    rs_stats.reset()
    rs_inject.install(rs_inject.FaultSchedule.from_dict(
        {"schema": 1, "faults": [{"site": "serve.admit", "kind": "oom"}]}))
    try:
        assert adm.decide(1, 4, 0)["reason"] == "injected_squeeze"
        assert adm.decide(1, 4, 0)["verdict"] == "accept"
    finally:
        rs_inject.uninstall()
    assert rs_stats.snapshot()["degradations"] == []


# -- the batcher --------------------------------------------------------------

def test_batcher_coalesces_slices_and_drains():
    eng, corpus = _small_engine()
    adm = AdmissionController(eng)
    mb = MicroBatcher(eng, adm, max_batch_queries=64, tick_s=0.05)
    rng = np.random.default_rng(8)
    reqs = []
    for i in range(6):
        nq = 1 + i % 3
        reqs.append(Request(kind="query", req_id=str(i),
                            query_attrs=rng.uniform(-10, 10, (nq, 5)),
                            ks=np.full(nq, 1 + i, np.int32)))
    for r in reqs:                    # queued before the consumer starts
        assert mb.submit(r)["verdict"] == "accept"
    mb.start()
    for r in reqs:
        assert r.done.wait(60) and r.error is None
        assert format_results(r.results) == _golden(corpus, r.query_attrs,
                                                    r.ks)
    assert mb.batches == 1                     # one coalesced micro-batch
    late = Request(kind="query", query_attrs=rng.uniform(-10, 10, (2, 5)),
                   ks=np.full(2, 3, np.int32))
    mb.submit(late)
    mb.stop(drain=True)
    assert late.done.is_set() and late.error is None
    adm.draining = True
    shed = Request(kind="query", query_attrs=np.zeros((1, 5)),
                   ks=np.ones(1, np.int32))
    assert mb.submit(shed)["reason"] == "draining"
    assert shed.error == "rejected: draining"


# -- the wire protocol --------------------------------------------------------

LINES = [
    '{"op": "query", "id": "a", "k": 3, "queries": [[1, 2, 3, 4, 5]]}',
    '{"op": "query", "id": "b", "ks": [1, 2], "rid": "r7", "debug": true,'
    ' "queries": [[0, 0, 0, 0, 0], [9, 9, 9, 9, 9]]}',
    '{"op": "ingest", "labels": [1], "rows": [[1, 1, 1, 1, 1]]}',
    '{"op": "ingest", "labels": [1], "rows": [[1, 1, 1, 1, 1]], "start": 3}',
    '{"op": "corpus", "start": 2, "count": 3, "rid": "c"}',
    '{"op": "stats"}', '{"op": "drain"}',
    '{"op": "query", "k": true, "queries": [[1, 2, 3, 4, 5]]}',
    '{"op": "query", "ks": [1], "queries": [[1, 2, 3, 4, 5], [1, 1, 1, 1,'
    ' 1]]}',
    '{"op": "ingest", "rows": [[1, 2, 3, 4, 5]]}', 'not json', '[1]',
    '{"op": "wat"}', '{"op": "corpus", "start": -1}',
]


def _drive(mod, line, eng, ref_results=None):
    """One request line through a protocol module, completed by the
    engine (query: its results; ingest/corpus: a fixed outcome)."""
    try:
        req = mod.parse_request(line, 5)
    except mod.ProtocolError as e:
        return {"error": str(e)}
    if isinstance(req, dict):
        return req
    if req.kind == "query":
        req.complete(results=eng.solve_batch(req.query_attrs, req.ks))
        out = mod.query_response(req)
    elif req.kind == "ingest":
        req.complete(corpus_rows=601)
        out = mod.ingest_response(req)
    else:
        req.payload = {"start": req.start, "count": req.count}
        req.complete()
        out = mod.corpus_response(req)
    out.pop("latency_ms", None)
    return json.loads(mod.encode(out))


@pytest.fixture(scope="module")
def protocol_engines():
    eng, corpus = _small_engine()
    ref = RefResident(RefInput(RefParams(600, 0, 5), corpus.labels,
                               corpus.data_attrs, np.zeros(0, np.int32),
                               np.zeros((0, 5))), RefConfig())
    return eng, ref


@pytest.mark.parametrize("line", LINES)
def test_protocol_lines_give_the_reference_responses(line,
                                                      protocol_engines):
    eng, ref = protocol_engines
    assert _drive(protocol, line, eng) == _drive(ref_protocol, line, ref)
    if line.startswith('{"op": "query", "k": true'):
        with pytest.raises(protocol.ProtocolError):
            protocol.parse_request(line, 5)
