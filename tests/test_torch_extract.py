"""The port's extraction (ops.extract / ops.fused) against the reference's.

On the CPU the port's ``extract_topk`` runs its plain PyTorch version; the
reference's ``extract_topk`` / ``fused_topk`` run in Pallas interpret mode,
as the reference's own tests run them. Both get the same numpy inputs.
Lists are compared under ``ops.extract.compare_lists``' stated tolerance:
sorted distances within EPS_CANCEL_COEF*(na+2)*(qn+dn_max) (+ LOWP_COEF
for bf16), and every id below kth - 2*tol present on both sides.
"""

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


def _expected_iters(q, d, n_real, kc, tile_q, tile_n, gate, skip):
    """The kernel's iters from its two predicates, recomputed in float64
    on integer data (exact distances): per (query tile, block), the norm
    gate against each row's current k-th best, then the block-min
    prefilter; the running lists are the exact top-kc so far."""
    qd, dd = q.astype(np.float64), d.astype(np.float64)
    qn, dn = (qd ** 2).sum(1), (dd ** 2).sum(1)
    full = ((qd[:, None, :] - dd[None]) ** 2).sum(-1)
    full[:, n_real:] = np.inf
    qb, b = full.shape
    nt = -(-qb // tile_q)
    seen = np.full((qb, kc), np.inf)
    iters = np.zeros((nt, b // tile_n), np.int32)
    coef = EPS_CANCEL_COEF * (q.shape[1] + 2) + LOWP_COEF["f32"]
    for j in range(b // tile_n):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        t = seen.max(1)
        real = np.arange(j * tile_n, (j + 1) * tile_n) < n_real
        ok_gate = np.ones(qb, bool)
        if gate:
            sdn = np.sqrt(dn[cols])
            mn = sdn[real].min() if real.any() else np.inf
            mx = sdn[real].max() if real.any() else -np.inf
            hi = dn[cols][real].max() if real.any() else 0.0
            sq = np.sqrt(qn)
            with np.errstate(invalid="ignore"):
                gap = np.maximum(np.maximum(mn - sq, sq - mx), 0.0)
                lb = gap * gap
                scale = qn + hi
                lbs = lb - (EPS_REL_F32 * np.sqrt(lb * scale) + coef * scale)
                ok_gate = ~np.isnan(lbs) & (np.maximum(lbs, 0) < t)
        ok_skip = full[:, cols].min(1) < t if skip else np.ones(qb, bool)
        pad = nt * tile_q - qb
        g = np.pad(ok_gate, (0, pad)).reshape(nt, tile_q).any(1)
        s = np.pad(ok_skip, (0, pad)).reshape(nt, tile_q).any(1)
        go = g & s
        iters[:, j] = go
        rows = np.repeat(go, tile_q)[:qb]
        merged = np.sort(np.concatenate([seen, full[:, cols]], 1), 1)[:, :kc]
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
