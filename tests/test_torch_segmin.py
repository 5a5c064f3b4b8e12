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
                                    (256, 1024, 8)])
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
