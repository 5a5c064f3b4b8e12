"""The port's selection (ops.topk, ops.distance) against dmlp_tpu.ops.topk.

Tie grids use small integer values so both frameworks compute identical
float32 distances: ids, labels and order must then match exactly,
including the lowest-position tie rule of the "topk" step.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmlp_tpu.ops import topk as jtopk  # noqa: E402
from dmlp_tpu.ops.distance import masked_pairwise_sq_l2 as jax_dist  # noqa: E402
from dmlp_tpu_torch.ops import topk as ttopk  # noqa: E402
from dmlp_tpu_torch.ops.distance import masked_pairwise_sq_l2  # noqa: E402


def _tie_grid(seed, q=24, n=96, a=4, hi=3):
    rng = np.random.default_rng(seed)
    qa = rng.integers(0, hi, (q, a)).astype(np.float32)
    da = rng.integers(0, hi, (n, a)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    ids = rng.permutation(n).astype(np.int32)
    ids[rng.random(n) < 0.1] = -1          # sentinel rows
    return qa, da, labels, ids


def _np(topk):
    return [np.asarray(x) for x in topk]


def _assert_same(got, want):
    for g, w in zip(_np(got), _np(want)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("k", [1, 7, 40, 120])
@pytest.mark.parametrize("seed", [0, 1])
def test_select_and_merge_match_reference(seed, k):
    qa, da, labels, ids = _tie_grid(seed)
    d = np.array(jax_dist(jnp.asarray(qa), jnp.asarray(da),
                            jnp.asarray(ids)))
    got = ttopk.select_topk(torch.from_numpy(d), torch.from_numpy(labels),
                            torch.from_numpy(ids), k)
    want = jtopk.select_topk(jnp.asarray(d), jnp.asarray(labels),
                             jnp.asarray(ids), k)
    _assert_same(got, want)
    half = d.shape[1] // 2
    parts = [(d[:, :half], labels[:half], ids[:half]),
             (d[:, half:], labels[half:], ids[half:])]
    tsel = [ttopk.select_topk(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in p), k) for p in parts]
    jsel = [jtopk.select_topk(*(jnp.asarray(x) for x in p), k)
            for p in parts]
    _assert_same(ttopk.merge_topk(*tsel, k), jtopk.merge_topk(*jsel, k))


def test_distance_matches_reference_exactly_on_integers():
    qa, da, _, ids = _tie_grid(3)
    got = masked_pairwise_sq_l2(torch.from_numpy(qa), torch.from_numpy(da),
                                torch.from_numpy(ids)).numpy()
    want = np.asarray(jax_dist(jnp.asarray(qa), jnp.asarray(da),
                               jnp.asarray(ids)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("select", ["sort", "topk"])
@pytest.mark.parametrize("k", [5, 24])
def test_block_steps_match_reference(select, k):
    """Two folds from an empty carry: the "topk" step must keep the lowest
    position on ties (carry first), exactly as lax.top_k does."""
    qa, da, labels, ids = _tie_grid(4, n=64)
    tstep = ttopk.make_block_step(select, k)
    jstep = jtopk.make_block_step(select, k)
    tc = ttopk.init_topk(qa.shape[0], k, torch.device("cpu"))
    jc = jtopk.init_topk(qa.shape[0], k)
    for lo in (0, 32):
        blk = (da[lo:lo + 32], labels[lo:lo + 32], ids[lo:lo + 32])
        tc = tstep(tc, torch.from_numpy(qa),
                   *(torch.from_numpy(np.ascontiguousarray(x)) for x in blk))
        jc = jstep(jc, jnp.asarray(qa), *(jnp.asarray(x) for x in blk))
    _assert_same(tc, jc)


def test_streaming_topk_matches_reference():
    qa, da, labels, ids = _tie_grid(5, n=128)
    got = ttopk.streaming_topk(torch.from_numpy(qa), torch.from_numpy(da),
                               torch.from_numpy(labels),
                               torch.from_numpy(ids), 16, 32)
    want = jtopk.streaming_topk(jnp.asarray(qa), jnp.asarray(da),
                                jnp.asarray(labels), jnp.asarray(ids), 16,
                                32)
    _assert_same(got, want)


def _seg_hazard(qa, da, ids, k):
    """Whether the reference's seg step takes its full branch on this
    block: S < nseg and some row's S-th smallest segment min ties T."""
    d = np.asarray(jax_dist(jnp.asarray(qa), jnp.asarray(da),
                            jnp.asarray(ids)))
    segmin = np.sort(d.reshape(d.shape[0], -1, 128).min(-1), 1)
    s = min(segmin.shape[1], k + 16)
    last, t = segmin[:, s - 1], segmin[:, min(k, s) - 1]
    tie = np.isfinite(last) & (last <= t)
    return s < segmin.shape[1] and bool(tie.any())


# name: (attribute range, segments per block, k)
SEG_CASES = {"seg": (60, 40, 8),        # nseg > k + 16, no tie at T
             "hazard": (3, 40, 8),      # duplicate grid: ties at T -> full
             "s_eq_nseg": (60, 16, 40)}  # S == nseg -> full, no decision


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_step_matches_reference(case, use_pallas):
    """Two folds of the seg step from an empty carry (the second carries
    in), against the reference step (its K3 in interpret mode): ids,
    labels and distances exactly, on integer grids."""
    hi, nseg, k = SEG_CASES[case]
    assert (nseg <= k + 16) == (case == "s_eq_nseg")
    qa, da, labels, ids = _tie_grid(6, q=24, n=2 * 128 * nseg, a=4, hi=hi)
    b = 128 * nseg
    tstep = ttopk.make_block_step("seg", k, use_pallas)
    jstep = jtopk.make_block_step("seg", k, use_pallas)
    tc = ttopk.init_topk(qa.shape[0], k, torch.device("cpu"))
    jc = jtopk.init_topk(qa.shape[0], k)
    for lo in (0, b):
        blk = (da[lo:lo + b], labels[lo:lo + b], ids[lo:lo + b])
        assert _seg_hazard(qa, blk[0], blk[2], k) == (case == "hazard")
        tc = tstep(tc, torch.from_numpy(qa),
                   *(torch.from_numpy(np.ascontiguousarray(x)) for x in blk))
        jc = jstep(jc, jnp.asarray(qa), *(jnp.asarray(x) for x in blk))
    _assert_same(tc, jc)


@pytest.mark.parametrize("select,data_block", [("extract", 256),
                                               ("seg", 128)])
def test_streaming_topk_remaps_like_reference(select, data_block):
    """"extract" takes the array-ids fallback ("seg" with the hand
    kernels); "seg" on blocks of fewer than two whole segments takes
    "topk" — both as the reference does."""
    qa, da, labels, ids = _tie_grid(7, n=1024, hi=8)
    got = ttopk.streaming_topk(torch.from_numpy(qa), torch.from_numpy(da),
                               torch.from_numpy(labels),
                               torch.from_numpy(ids), 24, data_block,
                               select, use_pallas=True)
    want = jtopk.streaming_topk(jnp.asarray(qa), jnp.asarray(da),
                                jnp.asarray(labels), jnp.asarray(ids), 24,
                                data_block, select=select, use_pallas=True)
    _assert_same(got, want)
    assert ttopk.streaming_fallback(True) == jtopk.streaming_fallback(True)
    assert ttopk.streaming_fallback(False) == jtopk.streaming_fallback(False)


def test_init_topk_padding():
    t = ttopk.init_topk(3, 4, torch.device("cpu"))
    j = jtopk.init_topk(3, 4)
    _assert_same(t, j)
    assert t.labels.dtype == torch.int32 and t.ids.dtype == torch.int32
