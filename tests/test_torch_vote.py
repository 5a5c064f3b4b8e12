"""The port's ``ops.vote`` against ``dmlp_tpu.ops.vote``, bit for bit, on
(Q, K) cases made by numpy from a seed: label ties (the larger label
wins), distance ties (the larger id first), padding past each query's k,
sentinel entries and rows with no valid candidate."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dmlp_tpu.ops import vote as ref_vote  # noqa: E402
from dmlp_tpu.ops.topk import TopK as RefTopK  # noqa: E402
from dmlp_tpu_torch.ops import vote  # noqa: E402
from dmlp_tpu_torch.ops.topk import TopK  # noqa: E402


def _case(seed, q=40, k=24, num_labels=5):
    """Selection-ordered-looking lists with heavy ties: distances from a
    few integer values, labels from ``num_labels``, some -1 sentinels
    (label -1, id -1, +inf) at the ends of rows, ks in 0..k."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.integers(0, 4, (q, k)).astype(np.float32), axis=1)
    ids = rng.integers(0, 1000, (q, k)).astype(np.int32)
    labels = rng.integers(0, num_labels, (q, k)).astype(np.int32)
    pad = rng.integers(0, k + 1, q)
    for i in range(q):
        if pad[i] < k:
            d[i, pad[i]:] = np.inf
            ids[i, pad[i]:] = -1
            labels[i, pad[i]:] = -1
    ks = rng.integers(0, k + 1, q).astype(np.int32)
    ks[0] = 0                                  # no valid candidate
    ids[1], labels[1], d[1] = -1, -1, np.inf   # a row of sentinels only
    ks[1] = k
    # Exact label ties: two labels with equal counts in the first k.
    labels[2, :4] = [1, 3, 1, 3]
    ids[2, :4] = [10, 11, 12, 13]
    d[2, :4] = [0.0, 0.0, 1.0, 1.0]
    ks[2] = 4
    return d, labels, ids, ks, num_labels


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_majority_vote_equals_reference(seed):
    d, labels, ids, ks, nl = _case(seed)
    valid = (np.arange(d.shape[1])[None, :] < ks[:, None]) & (ids >= 0)
    want = np.asarray(ref_vote.majority_vote(jnp.asarray(labels),
                                             jnp.asarray(valid), nl))
    got = vote.majority_vote(torch.from_numpy(labels),
                             torch.from_numpy(valid), nl).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[0] == -1 and got[1] == -1 and got[2] == 3


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_report_order_equals_reference(seed):
    d, labels, ids, ks, _ = _case(seed)
    want = ref_vote.report_order(
        RefTopK(jnp.asarray(d), jnp.asarray(labels), jnp.asarray(ids)),
        jnp.asarray(ks))
    got = vote.report_order(
        TopK(torch.from_numpy(d), torch.from_numpy(labels),
             torch.from_numpy(ids)), torch.from_numpy(ks))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_label_outside_range_counts_for_nothing():
    labels = torch.tensor([[7, 7, 1]], dtype=torch.int32)
    valid = torch.ones_like(labels, dtype=torch.bool)
    assert vote.majority_vote(labels, valid, 5).tolist() == [1]
    want = ref_vote.majority_vote(jnp.asarray(labels.numpy()),
                                  jnp.asarray(valid.numpy()), 5)
    assert np.asarray(want).tolist() == [1]
