"""The port's K3 (ops.dist_segmin) on the CPU against dmlp_tpu's
fused_dist_segmin in Pallas interpret mode.

Tolerance, per row: ``ops.extract.list_tolerance`` —
EPS_CANCEL_COEF * (na + 2) * (qn + dn_max), plus LOWP_COEF * (qn + dn_max)
for bf16 operands: the f32 cancellation error of the norm expansion that
two summation orders of the cross term can each commit. +inf must fall
exactly where ids < 0, and the port's segmin must be its own tile's
segment minimum exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmlp_tpu.ops.pallas_distance import \
    fused_dist_segmin as jax_segmin  # noqa: E402
from dmlp_tpu_torch.ops import dist_segmin as ds  # noqa: E402
from dmlp_tpu_torch.ops.extract import list_tolerance  # noqa: E402


def _inputs(qb, b, a, seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-5, 5, (qb, a)).astype(np.float32)
    d = rng.uniform(-5, 5, (b, a)).astype(np.float32)
    ids = np.where(rng.random(b) < 0.1, -1, np.arange(b)).astype(np.int32)
    ids[ds.SEG:2 * ds.SEG] = -1      # one all-sentinel segment
    return q, d, ids


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("qb,b,a", [(8, 256, 16), (16, 512, 64),
                                    (256, 1024, 8), (24, 640, 5),
                                    (136, 1280, 100)])
def test_matches_reference_kernel(qb, b, a, precision):
    q, d, ids = _inputs(qb, b, a, qb + b)
    dist, segmin = ds.fused_dist_segmin(torch.from_numpy(q),
                                        torch.from_numpy(d),
                                        torch.from_numpy(ids), precision)
    jd, js = jax_segmin(jnp.asarray(q), jnp.asarray(d), jnp.asarray(ids),
                        interpret=True, precision=precision)
    jd, js = np.asarray(jd), np.asarray(js)
    assert dist.shape == (qb, b) and segmin.shape == (qb, b // ds.SEG)
    dist, segmin = dist.numpy(), segmin.numpy()

    sentinel = np.broadcast_to(ids[None, :] < 0, dist.shape)
    assert np.array_equal(np.isinf(dist), sentinel)
    assert np.array_equal(np.isinf(jd), sentinel)
    assert np.isinf(segmin[:, 1]).all()
    assert np.array_equal(
        segmin, dist.reshape(qb, b // ds.SEG, ds.SEG).min(-1))

    qn = torch.from_numpy((q.astype(np.float64) ** 2).sum(1))
    tol = list_tolerance(qn, float((d.astype(np.float64) ** 2).sum(1).max()),
                         a, precision).numpy()[:, None]
    fin = ~sentinel
    assert (np.abs(dist[fin] - jd[fin])
            <= np.broadcast_to(tol, dist.shape)[fin]).all()
    sfin = np.isfinite(js)
    assert np.array_equal(np.isfinite(segmin), sfin)
    assert (np.abs(segmin[sfin] - js[sfin])
            <= np.broadcast_to(tol, js.shape)[sfin]).all()


def test_plain_version_is_the_masked_distance_tile():
    q, d, ids = _inputs(13, 384, 5, 9)
    from dmlp_tpu_torch.ops.distance import masked_pairwise_sq_l2
    dist, _ = ds.fused_dist_segmin_plain(torch.from_numpy(q),
                                         torch.from_numpy(d),
                                         torch.from_numpy(ids))
    want = masked_pairwise_sq_l2(torch.from_numpy(q), torch.from_numpy(d),
                                 torch.from_numpy(ids))
    assert torch.equal(dist, want)


def test_supports_is_the_ports_own_rule():
    """Any qb >= 1 (the kernel masks a ragged query tile; the reference
    needs multiples of 8), whole 128-column segments, any attribute
    count."""
    from dmlp_tpu.ops.pallas_distance import supports as jax_supports
    assert ds.supports(13, 1024, 64) and not jax_supports(13, 1024, 64)
    assert ds.supports(5624, 50176, 64)
    assert ds.supports(1024, 8192, 4096)
    assert not ds.supports(1024, 8000, 64)
    assert not ds.supports(0, 1024, 64)
    with pytest.raises(ValueError, match="untileable"):
        ds.fused_dist_segmin(torch.zeros(8, 4), torch.zeros(200, 4),
                             torch.zeros(200, dtype=torch.int32))
    with pytest.raises(ValueError, match="precision"):
        ds.fused_dist_segmin(torch.zeros(8, 4), torch.zeros(256, 4),
                             torch.zeros(256, dtype=torch.int32), "int8")


def test_supports_takes_the_grid_limit_at_the_new_tile():
    """One CTA per (128-row tile, segment) at most, so the grid limit
    falls at ceil(qb / 128) * nseg = 2^31; the shapes the card cases use
    (na 5 and 100, a ragged row tile, a segment count that G does not
    divide) all tile."""
    nseg = 2 ** 20
    assert ds.QUERY_TILE == 128
    assert ds.supports(128 * 2047, ds.SEG * nseg, 64)
    assert not ds.supports(128 * 2047 + 1, ds.SEG * nseg, 64)
    for qb, b, a in [(256, 4096, 5), (1000, 37 * ds.SEG, 100),
                     (5624, 50176, 64), (1024, 50176, 64), (13, 1024, 64)]:
        assert ds.supports(qb, b, a)
    assert 1000 % ds.QUERY_TILE and 37 % 5


@pytest.mark.parametrize("qb,b", [(5624, 50176), (1024, 50176)])
def test_choose_group_fills_whole_waves_at_the_main_path_shapes(qb, b):
    """The wide-k mix's outliers and config 2's seg step: on the H100's
    132 SMs the grid is exactly one wave of CTAS_PER_SM CTAs per SM, on
    66 SMs whole waves too, and on 114 SMs over 95% of its last wave."""
    for sms, waves in ((132, 1.0), (66, None), (114, None)):
        g = ds.choose_group(qb, b, sms)
        assert g == ds.choose_group(qb, b, sms)
        ctas = -(-qb // ds.QUERY_TILE) * len(
            ds.segment_groups(b // ds.SEG, g))
        filled = ctas / (sms * ds.CTAS_PER_SM)
        assert filled == waves if waves else filled / -(-filled // 1) > 0.95


@pytest.mark.parametrize("seed", range(4))
def test_choose_group_covers_every_segment_once(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        qb = int(rng.integers(1, 20000))
        nseg = int(rng.integers(1, 600))
        sms = int(rng.integers(1, 200))
        g = ds.choose_group(qb, nseg * ds.SEG, sms)
        assert 1 <= g <= nseg
        groups = ds.segment_groups(nseg, g)
        assert len(groups) == -(-nseg // g)
        assert all(1 <= len(r) <= g for r in groups)
        assert sorted(s for r in groups for s in r) == list(range(nseg))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("qb,b,a", [(13, 256, 5), (128, 384, 64),
                                    (200, 128, 100)])
def test_prepare_operands(qb, b, a, precision):
    """Attribute-major operands, qT padded with zeros to whole 128-row
    tiles, rounded to bf16 once for a bf16 product; the norms are those
    of the unrounded f32 rows."""
    q, d, _ = _inputs(qb, b, a, qb * b)
    qt, dt = torch.from_numpy(q), torch.from_numpy(d)
    qT, dT, qn, dn = ds.prepare_operands(qt, dt, precision)
    ldq = -(-qb // ds.QUERY_TILE) * ds.QUERY_TILE
    assert qT.shape == (a, ldq) and qT.is_contiguous()
    assert dT.shape == (a, b) and dT.is_contiguous()
    rq, rd = (qt, dt) if precision == "f32" else \
        (qt.to(torch.bfloat16).float(), dt.to(torch.bfloat16).float())
    assert torch.equal(qT[:, :qb], rq.T) and torch.equal(dT, rd.T)
    assert not qT[:, qb:].any()
    assert torch.equal(qn, (qt * qt).sum(-1))
    assert torch.equal(dn, (dt * dt).sum(-1))
    if precision == "bf16":
        assert not torch.equal(qT[:, :qb], qt.T)


def test_kernel_lib_refuses_other_tiles(monkeypatch):
    """The wrapper checks the library's tile constants before it binds
    the launcher: a library built with other tiles raises."""
    from dmlp_tpu_torch import kernels

    class FakeLib:
        pass

    def const(v):
        def f():
            return v
        return f

    for tiles in [(128, 64, 2), (128, 128, 1), (256, 128, 2)]:
        lib = FakeLib()
        lib.dmlp_segmin_seg, lib.dmlp_segmin_tile_q, \
            lib.dmlp_segmin_ctas_per_sm = map(const, tiles)
        lib.dmlp_segmin_occupancy = const(2)
        monkeypatch.setattr(kernels, "load", lambda name, lib=lib: lib)
        with pytest.raises(RuntimeError, match="tiles"):
            ds._kernel_lib()
