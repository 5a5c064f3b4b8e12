"""K1/K2's split merge (``extract_merge_kernel``) modelled on tensors.

The merge kernel takes the exact top-kc of carry ++ partials without
sorting them: it relies on each partial list being already in the merge's
key order, checks that order per list, sorts a list that is out of
order, then merges pairs of lists in a truncated tree whose threads find
their output runs by merge-path binary searches. These tests hold (a) the
precondition, on the plain split kernel's partials, and (b) a model of the
kernel, step for step at its own launch geometry, against
``merge_partials_plain`` entry for entry.

On the card ``chip_smoke.py`` holds the kernel itself against the plain
version (``merge_case``).
"""

import numpy as np
import pytest
import torch

from dmlp_tpu_torch.ops import extract as ex
from tests.test_torch_extract import MODEL_CASES, _data, _model_inputs

SPLITS = [2, 3, 5]
# The merge launcher's geometry (dmlp_extract_merge in extract_topk.cu).
MERGE_KEYS = 2048
MERGE_NT_MAX = 1024
_BIAS = 1 << 31


def merge_launch(qb, kc, nl):
    """(rows a CTA, threads a CTA) as the launcher picks them."""
    rows = max(1, min(MERGE_KEYS // (nl * kc), qb))
    keys = rows * nl * kc
    return rows, min(MERGE_NT_MAX, max(128, (keys // 8 + 31) // 32 * 32))


def float_key(v: torch.Tensor) -> torch.Tensor:
    """The kernel's order-keeping unsigned of each f32 (-0.0 folded to
    +0.0), as int64 in [0, 2**32)."""
    u = (v.float() + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= _BIAS, u ^ 0xFFFFFFFF, u | _BIAS)


def key_float(hi: torch.Tensor) -> torch.Tensor:
    """float_key's inverse."""
    u = torch.where(hi >= _BIAS, hi & 0x7FFFFFFF, hi ^ 0xFFFFFFFF)
    u = torch.where(u >= _BIAS, u - (1 << 32), u)      # as a signed i32
    return u.to(torch.int32).view(torch.float32)


def merge_keys(dist, flag, low):
    """The 64-bit merge key (float_key << 32 | flag << 31 | low) shifted
    by 2**63 into int64, which keeps its order."""
    return ((float_key(dist) - _BIAS) << 32) | (int(flag) << 31) \
        | low.to(torch.int64)


def row_keys(cd, ci, pd, pi):
    """(Qb, 1 + S, kc) keys: the carry's (slot as low) first, then the
    partials' (id + 1 as low, flag set)."""
    nsplit, qb, kc = pd.shape
    lists = [merge_keys(pd[s], 1, pi[s].to(torch.int64) + 1)
             for s in range(nsplit)]
    if cd is not None:
        slots = torch.arange(kc).expand(qb, kc)
        lists.insert(0, merge_keys(cd, 0, slots))
    return torch.stack(lists, 1)


def _take(x, idx):
    return torch.gather(x, 1, idx[:, None])[:, 0]


def bitonic_sort(x):
    """The kernel's in-place sort of (F, kc) lists out of order: a bitonic
    network over npad = the next power of two (at least 2), the first step
    at each size pairing mirrored entries, every comparator putting the
    smaller key low, and comparators that reach past kc skipped (the
    positions there are +inf padding they could not move)."""
    kc = x.shape[1]
    npad = 2
    while npad < kc:
        npad *= 2
    i = torch.arange(npad // 2)
    x = x.clone()
    size = 2
    while size <= npad:
        stride = size // 2
        while stride > 0:
            if stride == size // 2:
                blk, j = i // stride, i % stride
                lo, hi = blk * size + j, blk * size + size - 1 - j
            else:
                lo = 2 * i - (i & (stride - 1))
                hi = lo + stride
            keep = hi < kc
            lo, hi = lo[keep], hi[keep]
            a, b = x[:, lo], x[:, hi]
            x[:, lo], x[:, hi] = torch.minimum(a, b), torch.maximum(a, b)
            stride //= 2
        size *= 2
    return x


def merge_model(cd, ci, pd, pi, geometry=None):
    """The merge kernel on tensors, CTA by CTA at the launcher's geometry
    (or ``geometry`` = (rows, threads)): load, the order check and the
    sort of a list out of order, the truncated merge tree with each
    thread's run located by the merge-path search (A first on equal keys)
    and merged sequentially, and the last round's writes. Asserts that
    every output position is written once and that every index the kernel
    reads stays inside its list."""
    nsplit, qb, kc = pd.shape
    keys = row_keys(cd, ci, pd, pi)
    nl = keys.shape[1]
    rows, nth = geometry or merge_launch(qb, kc, nl)
    od = torch.empty((qb, kc), dtype=torch.float32)
    oi = torch.empty((qb, kc), dtype=torch.int32)
    for row0 in range(0, qb, rows):
        src = keys[row0:row0 + rows].reshape(-1, kc).clone()
        nrows = src.shape[0] // nl
        bad = (src[:, 1:] < src[:, :-1]).any(1)
        if bad.any():
            src[bad] = bitonic_sort(src[bad])
        # Each round's lists packed: list p of row r at r * lists + p.
        lists = nl
        while True:
            outl, odd = (lists + 1) // 2, lists % 2
            lg = 0      # runs = 2**lg runs of `run` outputs per list
            while 2 << lg <= kc and (nrows * outl) << (lg + 1) <= nth:
                lg += 1
            run = -(-kc // (1 << lg))
            t = torch.arange((nrows * outl) << lg)
            rp = t >> lg
            o0 = (t & ((1 << lg) - 1)) * run
            cnt = torch.clamp_max(kc - o0, run)
            keep = cnt > 0
            rp, o0, cnt = rp[keep], o0[keep], cnt[keep]
            r, p = rp // outl, rp % outl
            dst = torch.zeros((nrows * outl, kc), dtype=torch.int64)
            seen = torch.zeros((nrows * outl, kc), dtype=torch.int64)
            ia = 2 * rp - r * odd
            pair = ~((odd == 1) & (p == outl - 1))
            assert bool((ia // lists == r).all())
            A = src[ia]
            B = src[torch.where(pair, ia + 1, ia)]
            lo, hi = torch.zeros_like(o0), o0.clone()
            while bool((lo < hi).any()):
                act = lo < hi
                mid = (lo + hi) // 2
                bi = torch.clamp_min(o0 - 1 - mid, 0)
                assert bool((mid[act] < kc).all() and (bi[act] < kc).all())
                ok = _take(A, torch.clamp_max(mid, kc - 1)) <= _take(B, bi)
                lo = torch.where(act & ok, mid + 1, lo)
                hi = torch.where(act & ~ok, mid, hi)
            a, b = lo, o0 - lo
            for k in range(run):
                live = k < cnt
                assert bool((a[live] < kc).all() and (b[live] < kc).all())
                va = _take(A, torch.clamp_max(a, kc - 1))
                vb = _take(B, torch.clamp_max(b, kc - 1))
                ta = (va <= vb) | ~pair
                x = torch.where(pair, torch.where(ta, va, vb),
                                _take(A, torch.clamp_max(o0 + k, kc - 1)))
                at = (rp[live], (o0 + k)[live])
                dst[at] = x[live]
                seen[at] += 1
                a = a + (live & ta & pair)
                b = b + (live & ~ta & pair)
            assert bool((seen == 1).all())
            src, lists = dst, outl
            if outl == 1:
                break
        k = src
        low = k & 0x7FFFFFFF
        part = ((k >> 31) & 1).bool()
        hi_word = (k >> 32) + _BIAS
        od[row0:row0 + nrows] = key_float(hi_word)
        ids = low - 1
        if cd is not None:
            carry_ids = torch.gather(ci[row0:row0 + nrows].to(torch.int64),
                                     1, torch.where(part, 0, low))
            ids = torch.where(part, ids, carry_ids)
        oi[row0:row0 + nrows] = ids.to(torch.int32)
    return od, oi


def assert_same_bits(got, want):
    gd, gi = got
    wd, wi = want
    assert torch.equal(gd.view(torch.int32), wd.float().view(torch.int32))
    assert torch.equal(gi, wi.to(torch.int32))


def _splits_inputs(name, splits, carried):
    """A MODEL_CASES input, with its carry or a carry folded from its first
    block (or with none), at a tile that gives at least ``splits``
    blocks."""
    q, d, cd, ci, kw = _model_inputs(name)
    if carried and cd is None:
        tn = kw["tile_n"]
        cd, ci, _ = ex.extract_topk_plain(
            q, d[:tn], n_real=min(kw["n_real"], tn), kc=kw["kc"],
            tile_n=tn)
    if not carried:
        cd = ci = None
    tn = kw["tile_n"]
    while d.shape[0] // tn < splits:
        tn //= 2
    return q, d, cd, ci, {**kw, "tile_n": tn}


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carry"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", MODEL_CASES)
def test_plain_partials_are_sorted_in_the_merge_key(name, splits, carried):
    """The precondition the merge's fast path rests on: every partial list
    of the split sweep is non-decreasing in the merge's 64-bit key, row by
    row (distance, then id; the seeds, id -1, ahead of real entries at
    their distance)."""
    q, d, cd, ci, kw = _splits_inputs(name, splits, carried)
    pd, pi, _ = ex.split_partials_plain(q, d, cd, ci, splits=splits, **kw)
    keys = row_keys(None, None, pd, pi)
    assert bool((keys[:, :, 1:] >= keys[:, :, :-1]).all())


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carry"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", MODEL_CASES)
def test_merge_model_is_the_plain_merge(name, splits, carried):
    """The kernel's model on the split sweep's partials (with the case's
    unsorted carry where it has one) equals merge_partials_plain entry for
    entry, and S = 1's lists as sets."""
    q, d, cd, ci, kw = _splits_inputs(name, splits, carried)
    pd, pi, _ = ex.split_partials_plain(q, d, cd, ci, splits=splits, **kw)
    want = ex.merge_partials_plain(cd, ci, pd, pi)
    assert_same_bits(merge_model(cd, ci, pd, pi), want)


@pytest.mark.parametrize("geometry", [(1, 32), (1, 128), (3, 256),
                                      (8, 1024), (40, 96)])
def test_merge_model_holds_at_any_geometry(geometry):
    """Rows a CTA and threads a CTA change only who merges what: an
    unsorted carry and unsorted partials at 1 + S = 5, kc 24."""
    q, d, cd, ci, kw = _splits_inputs("ties_unsorted_carry", 4, True)
    pd, pi, _ = ex.split_partials_plain(q, d, cd, ci, splits=4, **kw)
    g = torch.Generator().manual_seed(5)
    perm = torch.argsort(torch.rand(pd.shape[1:], generator=g), 1)
    pd, pi = pd.clone(), pi.clone()
    pd[2], pi[2] = torch.gather(pd[2], 1, perm), torch.gather(pi[2], 1, perm)
    want = ex.merge_partials_plain(cd, ci, pd, pi)
    assert_same_bits(merge_model(cd, ci, pd, pi, geometry), want)


def test_merge_model_tie_rule_and_padding():
    """test_merge_plain_tie_rule_and_padding's lists: an unsorted partial
    with -0.0, a carry out of order, ties between carry and partials."""
    inf = float("inf")
    cd = torch.tensor([[2.0, 1.0, inf]])
    ci = torch.tensor([[9, 8, -1]], dtype=torch.int32)
    pd = torch.tensor([[[1.0, -0.0, inf]], [[1.0, 2.0, inf]]])
    pi = torch.tensor([[[3, 12, -1]], [[1, 5, -1]]], dtype=torch.int32)
    got = merge_model(cd, ci, pd, pi)
    assert_same_bits(got, ex.merge_partials_plain(cd, ci, pd, pi))
    assert got[1].tolist() == [[12, 8, 1]]
    got = merge_model(None, None, pd[:, :, 2:], pi[:, :, 2:])
    assert got[0].tolist() == [[inf]] and got[1].tolist() == [[-1]]


def _synthetic(rng, qb, nsplit, kc, carried):
    """Sorted partial lists with ties: integer distances in [0, 6), a
    carry-maximum seed repeated at the head of its distance group in
    every partial, -0.0 entries, all-+inf lists and +inf padding."""
    pd = np.sort(rng.integers(0, 6, (nsplit, qb, kc)), 2).astype(np.float32)
    pi = np.zeros((nsplit, qb, kc), np.int32)
    for s in range(nsplit):
        pi[s] = 1000 * s + np.arange(kc)[None, :]
    seed = 3.0
    for s in range(nsplit):
        nseed = (s % 3) + 1        # seeds precede real entries at 3.0
        first = (pd[s] >= seed).argmax(1)
        for r in range(qb):
            lo = first[r]
            pd[s, r, lo:lo + nseed] = seed
            pi[s, r, lo:lo + nseed] = -1
    pd[pd == 0.0] = -0.0
    pd[1] = np.inf                 # an all-+inf partial
    pi[1] = -1
    pd[:, :, kc - 2:] = np.inf     # padding
    pi[:, :, kc - 2:] = -1
    cd = ci = None
    if carried:
        cd = rng.integers(0, 6, (qb, kc)).astype(np.float32)
        cd[:, 0] = -0.0
        ci = rng.permutation(qb * kc).reshape(qb, kc).astype(np.int32) + 50
        cd, ci = torch.from_numpy(cd), torch.from_numpy(ci)
    return cd, ci, torch.from_numpy(pd), torch.from_numpy(pi)


@pytest.mark.parametrize("nsplit,carried", [(2, True), (4, True), (3, False),
                                            (5, False), (4, False)],
                         ids=["lists3", "lists5", "lists3_fresh",
                              "lists5_fresh", "lists4_fresh"])
@pytest.mark.parametrize("kc", [20, 96])
def test_merge_model_ties_seeds_neg_zero_inf(nsplit, carried, kc):
    """Odd and even list counts over exact ties, seeds repeated across the
    partials, -0.0, an all-+inf list and padding; the carry (unsorted:
    random integer distances) is sorted by the model's network."""
    rng = np.random.default_rng(100 + nsplit + 10 * carried)
    cd, ci, pd, pi = _synthetic(rng, 12, nsplit, kc, carried)
    want = ex.merge_partials_plain(cd, ci, pd, pi)
    got = merge_model(cd, ci, pd, pi)
    assert_same_bits(got, want)
    assert not torch.signbit(got[0]).any()


def test_merge_model_at_the_serving_shape():
    """The 32-query resident chunk at full width: 43,776 rows x 64
    attributes at kc 48, split 154 ways (1 + S = 155 lists), carried from
    another chunk; and again with the carry and partial 77 out of order
    (every row permuted)."""
    rng = np.random.default_rng(7)
    t = torch.from_numpy
    q = t(_data(rng, (32, 64), "float") + 10)
    d, near = t(_data(rng, (43776, 64), "float")), \
        t(_data(rng, (2048, 64), "float"))
    kw = dict(n_real=43776, id_base=0, kc=48)
    cd, ci, _ = ex.extract_topk_plain(q, near, n_real=2048, id_base=43776,
                                      kc=48)
    assert ex.choose_splits(32, 43776, 48, 132) == 154
    pd, pi, _ = ex.split_partials_plain(q, d, cd, ci, splits=154, **kw)
    assert merge_launch(32, 48, 155) == (1, 960)
    assert_same_bits(merge_model(cd, ci, pd, pi),
                     ex.merge_partials_plain(cd, ci, pd, pi))
    perm = t(np.argsort(rng.random((32, 48)), 1))
    cd, ci = torch.gather(cd, 1, perm), torch.gather(ci, 1, perm)
    pd, pi = pd.clone(), pi.clone()
    pd[77], pi[77] = torch.gather(pd[77], 1, perm), \
        torch.gather(pi[77], 1, perm)
    assert_same_bits(merge_model(cd, ci, pd, pi),
                     ex.merge_partials_plain(cd, ci, pd, pi))


def test_the_kernels_magic_division_is_exact_where_it_is_used():
    """merge_div(x, merge_magic(d)) = x // d for every divisor the kernel
    takes (list lengths and list counts up to MERGE_MAX) and every index
    it divides (below 2 * MERGE_MAX, the loads' overshoot included)."""
    x = np.arange(2 * ex.MERGE_MAX, dtype=np.uint64)
    for d0 in range(1, ex.MERGE_MAX + 1, 512):
        d = np.arange(d0, min(d0 + 512, ex.MERGE_MAX + 1),
                      dtype=np.uint64)[:, None]
        m = ((np.uint64(1) << np.uint64(32)) + d - np.uint64(1)) // d
        got = (x[None, :] * m) >> np.uint64(32)
        assert np.array_equal(got, x[None, :] // d)
