"""The port's extraction (ops.extract / ops.fused) against the reference's.

On the CPU the port's ``extract_topk`` runs its plain PyTorch version; the
reference's ``extract_topk`` / ``fused_topk`` run in Pallas interpret mode,
as the reference's own tests run them. Both get the same numpy inputs.
Lists are compared under ``ops.extract.compare_lists``' stated tolerance:
sorted distances within EPS_CANCEL_COEF*(na+2)*(qn+dn_max) (+ LOWP_COEF
for bf16), and every id below kth - 2*tol present on both sides.
"""

import functools
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmlp_tpu.ops.pallas_extract import extract_topk as jax_extract  # noqa: E402
from dmlp_tpu.ops.pallas_fused import fused_topk as jax_fused  # noqa: E402
from dmlp_tpu_torch.engine.finalize import (EPS_CANCEL_COEF,  # noqa: E402
                                            EPS_REL_F32, LOWP_COEF)
from dmlp_tpu_torch.ops import extract as ex  # noqa: E402
from dmlp_tpu_torch.ops.fused import fused_topk  # noqa: E402


def _data(rng, shape, kind):
    if kind == "ties":      # duplicate-row grid: few distinct values
        return rng.integers(0, 3, shape).astype(np.float32)
    if kind == "int":       # exact f32 arithmetic
        return rng.integers(0, 20, shape).astype(np.float32)
    return rng.uniform(-10, 10, shape).astype(np.float32)


# name, qb, chunk rows, a, kc, per-chunk n_real, first id_base, data kind,
# precision, floor
CASES = [
    ("id_base_ragged", 64, [512, 1024], 8, 8, [512, 700], 5000, "float",
     "f32", False),
    ("n_real_lt_kc", 16, [512, 512], 4, 24, [10, 12], 0, "int", "f32",
     False),
    ("floor_finite", 24, [512, 512], 8, 16, [512, 512], 0, "int", "f32",
     True),
    ("ties_kc64", 40, [1024], 16, 64, [1000], 0, "ties", "f32", False),
    ("ties_carry", 16, [512, 512], 8, 32, [512, 512], 7, "ties", "f32",
     False),
    ("bf16_carry", 32, [512, 1024], 16, 32, [512, 1024], 0, "float", "bf16",
     False),
]


def _run_chain(fn, q, chunks, n_reals, id_base, kc, floor, precision, *,
               to_dev, to_np):
    od = oi = None
    base = id_base
    for d, nr in zip(chunks, n_reals):
        od, oi, _ = fn(to_dev(q), to_dev(d), od, oi, n_real=nr,
                       id_base=base, kc=kc, precision=precision,
                       floor=None if floor is None else to_dev(floor))
        base += nr
    return to_np(od), to_np(oi)


def _port(fn, *a, **kw):
    return _run_chain(fn, *a, to_dev=torch.from_numpy,
                      to_np=lambda t: t.numpy(), **kw)


def _ref(fn, *a, **kw):
    def call(q, d, od, oi, **k):
        return fn(q, d, od, oi, interpret=True, **k)
    return _run_chain(call, *a, to_dev=jnp.asarray, to_np=np.array, **kw)


def _case_inputs(case):
    name, qb, rows, a, kc, n_reals, base, kind, prec, with_floor = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = _data(rng, (qb, a), kind)
    chunks = [_data(rng, (r, a), kind) for r in rows]
    floor = None
    if with_floor:
        # Integer data: every distance is an integer, so a floor at x.5
        # sits strictly between distances in both implementations.
        floor = (rng.integers(0, 40, (qb, 1)) + 0.5).astype(np.float32)
    return q, chunks, n_reals, base, kc, floor, prec


def _tolerance(q, chunks, n_reals, precision):
    qn = torch.from_numpy((q.astype(np.float64) ** 2).sum(1))
    dn_max = max(float((c[:nr].astype(np.float64) ** 2).sum(1).max())
                 for c, nr in zip(chunks, n_reals) if nr)
    return ex.list_tolerance(qn, dn_max, q.shape[1], precision)


@pytest.mark.parametrize("gate", [False, True], ids=["extract", "fused"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_reference_kernel(case, gate):
    q, chunks, n_reals, base, kc, floor, prec = _case_inputs(case)
    args = (q, chunks, n_reals, base, kc, floor, prec)
    got = _port(fused_topk if gate else ex.extract_topk, *args)
    want = _ref(jax_fused if gate else jax_extract, *args)
    cmp = ex.compare_lists(torch.from_numpy(got[0]), torch.from_numpy(got[1]),
                           torch.from_numpy(want[0]),
                           torch.from_numpy(want[1]),
                           _tolerance(q, chunks, n_reals, prec))
    assert cmp["ok"], cmp
    # ids reproduce their distances and are -1 exactly on +inf padding
    assert np.array_equal(got[1] >= 0, np.isfinite(got[0]))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gate_on_off_identical(case):
    q, chunks, n_reals, base, kc, floor, prec = _case_inputs(case)
    args = (q, chunks, n_reals, base, kc, floor, prec)
    on = _port(fused_topk, *args)
    off = _port(ex.extract_topk, *args)
    assert np.array_equal(on[0], off[0]) and np.array_equal(on[1], off[1])


def _expected_iters(q, d, n_real, kc, tile_q, tile_n, gate, skip, splits=1,
                    carry=None):
    """The kernel's iters from its two predicates, recomputed in float64
    on integer data (exact distances): per (query tile, block), the norm
    gate against each row's threshold, then the block-min prefilter; the
    running lists are the exact top-kc so far. At S = 1 the lists start
    from the carry distances and the threshold is their k-th best; at
    S > 1 split s sweeps blocks [s*nblk/S, (s+1)*nblk/S) from empty lists
    with the threshold min(its k-th best, the carry's row maximum)."""
    qd, dd = q.astype(np.float64), d.astype(np.float64)
    qn, dn = (qd ** 2).sum(1), (dd ** 2).sum(1)
    full = ((qd[:, None, :] - dd[None]) ** 2).sum(-1)
    full[:, n_real:] = np.inf
    qb, b = full.shape
    nt, nblk = -(-qb // tile_q), b // tile_n
    iters = np.zeros((nt, nblk), np.int32)
    coef = EPS_CANCEL_COEF * (q.shape[1] + 2) + LOWP_COEF["f32"]
    cmax = np.full(qb, np.inf)
    if carry is not None and splits > 1:
        cmax = carry.max(1)
    sq = np.sqrt(qn)
    for sp in range(splits):
        seen = np.full((qb, kc), np.inf)
        if carry is not None and splits == 1:
            seen = carry.astype(np.float64)
        for j in range(sp * nblk // splits, (sp + 1) * nblk // splits):
            cols = slice(j * tile_n, (j + 1) * tile_n)
            t = np.minimum(seen.max(1), cmax)
            real = np.arange(j * tile_n, (j + 1) * tile_n) < n_real
            ok_gate = np.ones(qb, bool)
            if gate:
                sdn = np.sqrt(dn[cols])
                mn = sdn[real].min() if real.any() else np.inf
                mx = sdn[real].max() if real.any() else -np.inf
                hi = dn[cols][real].max() if real.any() else 0.0
                with np.errstate(invalid="ignore"):
                    gap = np.maximum(np.maximum(mn - sq, sq - mx), 0.0)
                    lb = gap * gap
                    scale = qn + hi
                    lbs = lb - (EPS_REL_F32 * np.sqrt(lb * scale)
                                + coef * scale)
                    ok_gate = ~np.isnan(lbs) & (np.maximum(lbs, 0) < t)
            ok_skip = full[:, cols].min(1) < t if skip else np.ones(qb, bool)
            pad = nt * tile_q - qb
            g = np.pad(ok_gate, (0, pad)).reshape(nt, tile_q).any(1)
            s = np.pad(ok_skip, (0, pad)).reshape(nt, tile_q).any(1)
            go = g & s
            iters[:, j] = go
            rows = np.repeat(go, tile_q)[:qb]
            merged = np.sort(np.concatenate([seen, full[:, cols]], 1),
                             1)[:, :kc]
            seen[rows] = merged[rows]
    return iters


@pytest.mark.parametrize("gate,skip", [(True, True), (True, False),
                                       (False, True)])
def test_iters_zero_exactly_where_predicates_say(gate, skip):
    """A norm-banded corpus (block j sits at radius ~20*j) so that both
    predicates skip some tiles and process others."""
    rng = np.random.default_rng(11)
    tq, tn, kc = 8, 256, 8
    q = rng.integers(0, 6, (40, 8)).astype(np.float32)
    d = rng.integers(0, 6, (1024, 8)).astype(np.float32)
    d += 20 * (np.arange(1024) // tn)[:, None] * np.array(
        [1, -1, 0, 0, 1, 0, 0, 0], np.float32)[None]
    d[300:310] = q[:10] + 1   # a late near block: tile 0 processes block 1
    n_real = 1000
    _, _, it = ex.extract_topk(torch.from_numpy(q), torch.from_numpy(d),
                               n_real=n_real, kc=kc, tile_q=tq, tile_n=tn,
                               mxu_gate=gate, block_skip=skip)
    want = _expected_iters(q, d, n_real, kc, tq, tn, gate, skip)
    assert np.array_equal(it.numpy(), want)
    assert 0 < want.sum() < want.size     # both predicates had work to do


def test_all_sentinel_block_is_skipped_by_the_gate():
    """inf - inf = NaN in the gate must skip, not process, a block with no
    real row (the NaN trap the CUDA kernel tests with isnan)."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.uniform(0, 1, (32, 4)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(0, 1, (512, 4)).astype(np.float32))
    od, oi, it = fused_topk(q, d, n_real=200, kc=8)
    assert it[:, 1].tolist() == [0]
    od2, oi2, it2 = ex.extract_topk(q, d, n_real=200, kc=8, block_skip=False)
    assert it2[:, 1].tolist() == [1]
    assert torch.equal(od, od2) and torch.equal(oi, oi2)


def test_supports_and_wrapper_guards():
    assert ex.supports(10016, 50176, 64, 48)
    assert ex.supports(7, 256, 3, 512)          # ragged query tile is fine
    assert not ex.supports(64, 1000, 8, 16)     # whole 256-row blocks only
    assert not ex.supports(64, 1024, 8, 513)    # kc cap
    assert ex.smem_bytes(512) <= ex.SMEM_BUDGET
    q, d = torch.zeros(8, 4), torch.zeros(256, 4)
    with pytest.raises(ValueError):
        ex.extract_topk(q, d, n_real=256, kc=8, precision="int8")
    with pytest.raises(ValueError):
        ex.extract_topk(q.to("meta"), d.to("meta"), n_real=256, kc=8)
    # the plain version never counts as a kernel launch
    before = dict(ex.LAUNCHES)
    ex.extract_topk(q, d, n_real=256, kc=8)
    assert ex.LAUNCHES == before


# The data-axis split. The CASES' chunks hold 2-4 blocks of the kernel's
# 256 columns, so the split tests run the plain version at tile_n = 64
# (8-16 blocks a chunk) to reach S = 5.
SPLITS = [2, 3, 5]
SPLIT_TILE_N = 64


def _split_fn(gate, splits):
    return functools.partial(ex.extract_topk, mxu_gate=gate, splits=splits,
                             tile_n=SPLIT_TILE_N)


@functools.lru_cache(maxsize=None)
def _cached_ref(name, gate):
    case = next(c for c in CASES if c[0] == name)
    q, chunks, n_reals, base, kc, floor, prec = _case_inputs(case)
    return _ref(jax_fused if gate else jax_extract, q, chunks, n_reals, base,
                kc, floor, prec)


def _lexsorted(od, oi):
    """Lists sorted by (distance, id), for comparing as sets."""
    od, oi = torch.as_tensor(od), torch.as_tensor(oi)
    order = torch.argsort(oi, dim=1, stable=True)
    order = torch.gather(order, 1, torch.argsort(
        torch.gather(od, 1, order), dim=1, stable=True))
    return torch.gather(od, 1, order), torch.gather(oi, 1, order)


@pytest.mark.parametrize("gate", [False, True], ids=["extract", "fused"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_plain_matches_reference_kernel(case, splits, gate):
    """Carry chains at S > 1 (the carry folded by the merge, ragged
    n_real, non-zero id_base, floor, ties with a carry, bf16) against the
    Pallas kernel in interpret mode."""
    q, chunks, n_reals, base, kc, floor, prec = _case_inputs(case)
    got = _port(_split_fn(gate, splits), q, chunks, n_reals, base, kc, floor,
                prec)
    want = _cached_ref(case[0], gate)
    cmp = ex.compare_lists(torch.from_numpy(got[0]), torch.from_numpy(got[1]),
                           torch.from_numpy(want[0]),
                           torch.from_numpy(want[1]),
                           _tolerance(q, chunks, n_reals, prec))
    assert cmp["ok"], cmp
    assert np.array_equal(got[1] >= 0, np.isfinite(got[0]))
    assert np.all(got[0][:, 1:] >= got[0][:, :-1])  # the merge sorts


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_lists_identical_to_one_split(case, splits):
    """S > 1 gives S = 1's lists bit for bit once both are sorted by
    (distance, id), and gate on and gate off stay identical at S > 1."""
    q, chunks, n_reals, base, kc, floor, prec = _case_inputs(case)
    args = (q, chunks, n_reals, base, kc, floor, prec)
    one = _port(_split_fn(False, 1), *args)
    off = _port(_split_fn(False, splits), *args)
    on = _port(_split_fn(True, splits), *args)
    for a, b in zip(_lexsorted(*one), _lexsorted(*off)):
        assert torch.equal(a, b)
    assert np.array_equal(on[0], off[0]) and np.array_equal(on[1], off[1])


def test_merge_plain_tie_rule_and_padding():
    """(distance asc, carry first, id asc), sorted; -0.0 folds to +0.0;
    (+inf, -1) padding stays -1 exactly on +inf."""
    inf = float("inf")
    cd = torch.tensor([[2.0, 1.0, inf]])
    ci = torch.tensor([[9, 8, -1]], dtype=torch.int32)
    pd = torch.tensor([[[1.0, -0.0, inf]], [[1.0, 2.0, inf]]])
    pi = torch.tensor([[[3, 12, -1]], [[1, 5, -1]]], dtype=torch.int32)
    od, oi = ex.merge_partials(cd, ci, pd, pi)
    assert od.tolist() == [[0.0, 1.0, 1.0]]
    assert not torch.signbit(od[0, 0])
    assert oi.tolist() == [[12, 8, 1]]
    od, oi = ex.merge_partials(None, None, pd[:, :, 2:], pi[:, :, 2:])
    assert od.tolist() == [[inf]] and oi.tolist() == [[-1]]
    with pytest.raises(ValueError):
        ex.merge_partials(None, None, torch.zeros(16, 1, 512),
                          torch.zeros(16, 1, 512, dtype=torch.int32))


def _banded(rng):
    """A norm-banded corpus of 16 blocks of 128 rows, block j at radius
    ~20*(j % 4), so that inside every split both predicates skip some
    tiles and process others."""
    q = rng.integers(0, 6, (40, 8)).astype(np.float32)
    d = rng.integers(0, 6, (2048, 8)).astype(np.float32)
    d += 20 * ((np.arange(2048) // 128) % 4)[:, None] * np.array(
        [1, -1, 0, 0, 1, 0, 0, 0], np.float32)[None]
    d[300:310] = q[:10] + 1   # near rows in a far block
    return q, d


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carry"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("gate,skip", [(True, True), (True, False),
                                       (False, True)])
def test_split_iters_match_predicates(gate, skip, splits, carried):
    """iters at S > 1 from the split predicates recomputed in float64:
    fresh lists per split, thresholds min(split's k-th best, carry's row
    maximum). The carry is a plain fold of a nearer chunk."""
    rng = np.random.default_rng(12)
    tq, tn, kc, n_real = 8, 128, 8, 2000
    q, d = _banded(rng)
    carry = None
    if carried:
        near = rng.integers(0, 6, (256, 8)).astype(np.float32) + 2
        cd, ci, _ = ex.extract_topk(torch.from_numpy(q),
                                    torch.from_numpy(near), n_real=256,
                                    kc=kc, tile_q=tq)
        carry = (cd, ci)
    _, _, it = ex.extract_topk(torch.from_numpy(q), torch.from_numpy(d),
                               *(carry or ()), n_real=n_real, kc=kc,
                               id_base=256, tile_q=tq, tile_n=tn,
                               mxu_gate=gate, block_skip=skip, splits=splits)
    want = _expected_iters(q, d, n_real, kc, tq, tn, gate, skip, splits,
                           None if carry is None else carry[0].numpy())
    assert np.array_equal(it.numpy(), want)
    assert 0 < want.sum() < want.size     # both predicates had work to do


def test_choose_splits_is_pure_and_within_limits(monkeypatch):
    def no_device(*a, **k):
        raise AssertionError("choose_splits asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    for qb in (1, 31, 32, 1000, 1024, 4384, 10016, 100000):
        for b in (256, 512, 50176, 204800):
            for kc in (1, 8, 48, 100, 512):
                for sm in (1, 8, 132):
                    got = ex.choose_splits(qb, b, kc, sm)
                    assert got == ex.choose_splits(qb, b, kc, sm)
                    assert 1 <= got <= b // ex.BLOCK_ROWS
                    assert got == 1 or (1 + got) * kc <= ex.MERGE_MAX
                    assert ex.check_splits(got, b, kc) == got


def test_choose_splits_splits_the_multipass_shapes():
    """32 query tiles of kc 512 (one CTA per SM) leave 100 of 132 SMs
    idle at S = 1: the multi-pass resident pass and first pass (204,800
    rows in 4 chunks of 51,200)."""
    assert ex.ctas_per_sm(512) == 1 and ex.ctas_per_sm(48) == 2
    for b in (204800, 51200):
        assert ex.choose_splits(1024, b, 512, 132) > 1
    assert ex.choose_splits(1024, 204800, 512, 32) == 1   # already full


def test_smem_layout_of_the_sorted_list_kernel():
    """One CTA's dynamic shared memory as the kernel lays it out: 8 warps'
    256 candidate keys (16 KB), the 32 x 256 distance tile (32 KB), two
    buffers of 16 staged attributes (q 32 wide, d 256 + 4 wide), three
    per-row vectors and the 32 x kc lists; kc 512 fits the opt-in budget
    with one CTA per SM, kc 48 leaves room for two."""
    fixed = 8 * 8 * 256 + 4 * (32 * 256 + 2 * 16 * 32 + 2 * 16 * 260
                               + 3 * 32)
    for kc in (1, 48, 100, 512):
        assert ex.smem_bytes(kc) == fixed + 8 * 32 * kc
    assert ex.smem_bytes(512) == 217984 <= ex.SMEM_BUDGET
    assert [ex.ctas_per_sm(kc) for kc in (1, 48, 100, 512)] == [2, 2, 2, 1]


def test_choose_splits_after_the_fill_refit(monkeypatch):
    """The sorted lists fill in a few blocks, so the fill no longer caps
    the split: the wide-k bulk (137 query tiles of kc 512, two waves on
    132 SMs at S = 1) splits where the old fill of half a block per slot
    kept it whole, config 4's chunk (313 tiles, two CTAs per SM) splits
    further, and a grid that already fills the card stays at S = 1."""
    assert ex.SPLIT_FILL < 0.1
    new = [ex.choose_splits(4384, 50176, 512, 132),
           ex.choose_splits(10016, 50176, 48, 132)]
    assert ex.choose_splits(1024, 204800, 512, 132) == 4
    assert ex.choose_splits(1024, 204800, 512, 32) == 1
    monkeypatch.setattr(ex, "SPLIT_FILL", 0.5)
    old = [ex.choose_splits(4384, 50176, 512, 132),
           ex.choose_splits(10016, 50176, 48, 132)]
    assert old[0] == 1 < new[0] and new[1] > old[1] > 1


def test_fused_topk_passes_splits_through():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.uniform(0, 1, (16, 4)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(0, 1, (1024, 4)).astype(np.float32))
    got = fused_topk(q, d, n_real=1000, kc=8, splits=3)
    want = ex.extract_topk(q, d, n_real=1000, kc=8, mxu_gate=True, splits=3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):       # 4 blocks cannot split 5 ways
        fused_topk(q, d, n_real=1000, kc=8, splits=5)


def test_cpu_default_is_one_split(monkeypatch):
    def no_choice(*a, **k):
        raise AssertionError("the CPU path chose S")

    monkeypatch.setattr(ex, "choose_splits", no_choice)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.uniform(0, 1, (16, 4)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(0, 1, (1024, 4)).astype(np.float32))
    got = ex.extract_topk(q, d, n_real=1000, kc=8)
    want = ex.extract_topk(q, d, n_real=1000, kc=8, splits=1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bad in (0, 5):                    # 4 blocks: 1 <= S <= 4
        with pytest.raises(ValueError):
            ex.extract_topk(q, d, n_real=1000, kc=8, splits=bad)


# The CUDA kernel's per-block step, modelled on tensors. Each row's list
# stays sorted ascending (a carry is first sorted stably by (distance,
# slot)), so its threshold T is the last entry; per block the candidates
# are the tile values strictly below T (the warp's ballots), sorted by
# (distance, position) as 64-bit keys, and merged into the list by rank:
# a list entry j moves to j + #(candidates < it), candidate i to
# i + #(list entries <= it), ranks past kc drop. That must be exactly the
# plain version's stable sort of list ++ block.

def _kernel_model(q, d, carry_d, carry_i, *, n_real, id_base, kc,
                  floor=None, tile_n=256, splits=1):
    qb, b = q.shape[0], d.shape[0]
    nblk = b // tile_n
    qn, dn = (q * q).sum(-1), (d * d).sum(-1)
    parts = []
    for sp in range(splits):
        if carry_d is not None and splits == 1:
            cd = carry_d.float() + 0.0          # -0.0 folds to +0.0
            order = torch.argsort(cd, dim=1, stable=True)
            ld = torch.gather(cd, 1, order)
            li = torch.gather(carry_i.to(torch.int32), 1, order)
        else:
            seed = torch.full((qb, 1), torch.inf)
            if carry_d is not None:
                seed = carry_d.float().max(1, keepdim=True).values + 0.0
            ld = seed.expand(qb, kc).clone()
            li = torch.full((qb, kc), -1, dtype=torch.int32)
        for j in range(sp * nblk // splits, (sp + 1) * nblk // splits):
            lo, hi = j * tile_n, (j + 1) * tile_n
            dist = torch.clamp_min(qn[:, None] + dn[None, lo:hi]
                                   - 2.0 * (q @ d[lo:hi].T), 0.0)
            if floor is not None:
                dist = torch.where(dist < floor.reshape(qb, 1), torch.inf,
                                   dist)
            dist = torch.where(torch.arange(lo, hi)[None, :] < n_real, dist,
                               torch.inf)
            for r in range(qb):
                v = dist[r] + 0.0
                sel = v < ld[r, -1]
                n = int(sel.sum())
                if n == 0:
                    continue
                pos = torch.nonzero(sel).flatten()
                keys = (v[pos].view(torch.int32).to(torch.int64) << 32) | pos
                order = torch.argsort(keys)
                cv, cp = v[pos][order], pos[order]
                L, ids = ld[r].clone(), li[r].clone()
                lnew = torch.arange(kc) + torch.searchsorted(cv, L)
                p = torch.searchsorted(L, cv, right=True)
                cnew = torch.arange(n) + p
                # The kernel's register path for n <= 32: a list entry j
                # moves by #(i : p_i <= j), p_i = #(list entries <= c_i).
                assert torch.equal(lnew, torch.arange(kc) + (
                    p[None, :] <= torch.arange(kc)[:, None]).sum(1))
                keep = lnew < kc
                ld[r, lnew[keep]] = L[keep]
                li[r, lnew[keep]] = ids[keep]
                keep = cnew < kc
                ld[r, cnew[keep]] = cv[keep]
                li[r, cnew[keep]] = (id_base + lo + cp[keep]).to(torch.int32)
            assert torch.all(ld[:, 1:] >= ld[:, :-1])   # stays sorted
        parts.append((ld, li))
    return parts


def _model_inputs(name):
    """(q, d, carry_d, carry_i, kw) of one model case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    t = torch.from_numpy
    kw = dict(n_real=1000, id_base=0, kc=24, tile_n=64)
    if name == "all_inf_full_tile":
        # Fresh lists of kc > 256: the first block's 256 real columns all
        # go in by one merge.
        q, d = _data(rng, (8, 4), "float"), _data(rng, (512, 4), "float")
        return t(q), t(d), None, None, dict(n_real=280, id_base=0, kc=300,
                                            tile_n=256)
    if name == "ties_fresh":
        q, d = _data(rng, (40, 8), "ties"), _data(rng, (1024, 8), "ties")
        return t(q), t(d), None, None, kw
    q, d = _data(rng, (40, 8), "ties"), _data(rng, (1024, 8), "ties")
    near = _data(rng, (256, 8), "ties")
    cd, ci, _ = ex.extract_topk_plain(t(q), t(near), n_real=256, kc=24,
                                      tile_n=64)
    # Not sorted: each row's entries permuted, ties among them kept.
    perm = torch.from_numpy(np.argsort(rng.random((40, 24)), 1))
    cd, ci = torch.gather(cd, 1, perm), torch.gather(ci, 1, perm)
    kw = {**kw, "id_base": 256}
    if name == "neg_zero":
        # Exact zero distances in the block (data rows equal to queries)
        # and -0.0 in the carry.
        d[64:104] = q
        cd = torch.where(cd == 0.0, -0.0, cd)
        cd[:, 3] = -0.0
    if name == "floor":
        q, d = _data(rng, (40, 8), "int"), _data(rng, (1024, 8), "int")
        floor = (rng.integers(0, 40, (40, 1)) + 0.5).astype(np.float32)
        return t(q), t(d), None, None, {**kw, "floor": t(floor)}
    return t(q), t(d), cd, ci, kw


MODEL_CASES = ["ties_fresh", "ties_unsorted_carry", "all_inf_full_tile",
               "neg_zero", "floor"]


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("name", MODEL_CASES)
def test_rank_merge_model_is_the_stable_sort(name, splits):
    """Many exact ties inside the list, inside the block and between the
    two; an all-+inf list; -0.0; a floor; an unsorted carry: the model's
    lists equal the plain version's, stably sorted by distance, entry for
    entry (the plain version leaves a carry row that no block changed
    unsorted)."""
    q, d, cd, ci, kw = _model_inputs(name)
    if kw["kc"] * (1 + splits) > ex.MERGE_MAX or splits > d.shape[0] // \
            kw["tile_n"]:
        splits = 1
    part_d, part_i, _ = ex.split_partials_plain(q, d, cd, ci, splits=splits,
                                                **kw)
    model = _kernel_model(q, d, cd, ci, splits=splits, **kw)
    for s, (md, mi) in enumerate(model):
        order = torch.argsort(part_d[s], dim=1, stable=True)
        assert torch.equal(md, torch.gather(part_d[s], 1, order))
        assert torch.equal(mi, torch.gather(part_i[s], 1, order))
    if name == "all_inf_full_tile":
        assert torch.isfinite(model[0][0][:, :280]).all()
        assert torch.isinf(model[0][0][:, 280:]).all()
    if name == "neg_zero":
        assert (model[0][0] == 0).any()
        assert not torch.signbit(model[0][0]).any()


# The integer route: uint8 queries and data take the integer kernel (on the
# CPU its plain version), whose arithmetic is exact integers rounded once to
# f32. On 0..255 values with na * 255^2 < 2^24 the float route's f32 sums
# are exact too, so the two give the same lists, ids and iters, bit for
# bit. name, qb, chunk rows, a, kc, per-chunk n_real, first id_base, data
# ("uniform" 0..255, "ties" 0..2, "extreme" all 255 against rows of 0 and
# 255), floor
U8_CASES = [
    ("fresh_then_carried", 40, [2048, 2048], 128, 16, [2048, 1500], 77,
     "uniform", None),
    ("floor", 40, [2048, 2048], 128, 16, [2048, 2048], 0, "uniform",
     1.35e6),
    ("extreme_255", 33, [2048], 128, 24, [2000], 5, "extreme", None),
    ("tie_grid", 64, [2048, 2048], 32, 48, [2048, 1800], 0, "ties", None),
]


def _u8_inputs(case):
    name, qb, rows, a, kc, n_reals, base, kind, floor = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    hi = {"uniform": 256, "ties": 3, "extreme": 256}[kind]
    q = rng.integers(0, hi, (qb, a)).astype(np.uint8)
    chunks = [rng.integers(0, hi, (r, a)).astype(np.uint8) for r in rows]
    if kind == "extreme":
        q[:] = 255
        for c in chunks:
            c[:] = 255
            c[::3] = 0
    fl = None if floor is None else torch.full((qb, 1), floor)
    return q, chunks, n_reals, base, kc, fl


@pytest.mark.parametrize("gate", [False, True], ids=["extract", "fused"])
@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("case", U8_CASES, ids=[c[0] for c in U8_CASES])
def test_integer_route_equals_the_float_route_bit_for_bit(case, splits,
                                                          gate):
    q, chunks, n_reals, base, kc, fl = _u8_inputs(case)
    q8 = torch.from_numpy(q)
    assert ex.integer_route(q8, torch.from_numpy(chunks[0]), kc)
    runs = []
    for cast in (False, True):
        od = oi = None
        outs, b = [], base
        for d, nr in zip(chunks, n_reals):
            qx, dx = q8, torch.from_numpy(d)
            if cast:
                qx, dx = qx.float(), dx.float()
            od, oi, it = ex.extract_topk(qx, dx, od, oi, n_real=nr,
                                         id_base=b, kc=kc, floor=fl,
                                         mxu_gate=gate, splits=splits)
            outs.append((od, oi, it))
            b += nr
        runs.append(outs)
    for (d8, i8, it8), (df, i_f, itf) in zip(*runs):
        assert d8.dtype == torch.float32 and i8.dtype == torch.int32
        assert torch.equal(d8, df) and torch.equal(i8, i_f)
        assert torch.equal(it8, itf)


def test_dtypes_and_shapes_alone_pick_the_integer_route():
    from dmlp_tpu_torch.obs import counters as obs_counters
    rng = np.random.default_rng(26)
    q8 = torch.from_numpy(rng.integers(0, 256, (16, 32)).astype(np.uint8))
    d8 = torch.from_numpy(rng.integers(0, 256, (512, 32)).astype(np.uint8))
    q24 = q8[:, :24].contiguous()
    d24 = d8[:, :24].contiguous()
    calls = [((q8, d8), True, "fused_topk_u8"),
             ((q8, d8), False, "extract_topk_u8"),
             ((q8.float(), d8), True, "fused_topk"),
             ((q8, d8.float()), False, "extract_topk"),
             ((q8.double(), d8.double()), True, "fused_topk"),
             # 24 attributes: not whole 16-byte rows, the float route
             ((q24, d24), True, "fused_topk")]
    for (q, d), gate, name in calls:
        assert ex.integer_route(q, d, 8) == name.endswith("_u8")
        probe = obs_counters.install(obs_counters.CostProbe())
        try:
            got = ex.extract_topk(q, d, n_real=500, kc=8, mxu_gate=gate)
        finally:
            obs_counters.uninstall()
        assert list(probe.collect()["per_kernel"]) == [name]
        want = ex.extract_topk(q.float(), d.float(), n_real=500, kc=8,
                               mxu_gate=gate)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not ex.supports_u8(16, 512, 24, 8)
    assert not ex.supports_u8(16, 512, ex.U8_NA_MAX + 16, 8)
    assert ex.supports_u8(1024, 51200, 128, 512)


def test_smem_layout_and_splits_of_the_integer_kernel():
    """The integer kernel's CTA: 8 warps' candidate keys (16 KB), two
    stages of 256 rows x 144 bytes (the distance tile is written into
    one), the query tile's bytes in 128-byte chunks plus 16, the block's
    and the tile's norms, three per-row vectors and the lists. At
    BIGANN's 128 attributes and kc 32 two CTAs share an SM, and S 8 puts
    1,024 queries over 51,200 rows (32 tiles x 8) in one wave of 132 SMs."""
    fixed = 8 * 8 * 256 + 2 * 256 * 144 + 4 * (256 + 3 * 32)
    for kc, na in ((32, 128), (512, 128), (10, 784)):
        assert ex.smem_bytes_u8(kc, na) == \
            fixed + 32 * (-(-na // 128) * 128 + 16) + 8 * 32 * kc
    assert ex.smem_bytes_u8(512, 128) <= ex.SMEM_BUDGET
    assert ex.ctas_per_sm(32, 128) == 2 and ex.ctas_per_sm(512, 128) == 1
    assert ex.choose_splits(1024, 51200, 32, 132, 128) == 8
