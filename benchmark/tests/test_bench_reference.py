"""The plain reference against a direct float64 brute force."""

import numpy as np
import pytest
import torch

from benchmark.reference import knn as ref


def brute(q, x, k):
    """Every distance in the difference form, then (dist asc, id desc)."""
    out_d, out_i = [], []
    for row in q:
        d = ((x - row) ** 2).sum(1)
        order = sorted(range(len(x)), key=lambda i: (d[i], -i))[:k]
        out_i.append(order + [-1] * (k - len(order)))
        out_d.append([d[i] for i in order] + [np.inf] * (k - len(order)))
    return np.array(out_d), np.array(out_i)


def fnv(label, ids):
    c = 1469598103934665603
    c = ((c ^ (label & (2**64 - 1))) * 1099511628211) % 2**64
    for i in ids:
        c = ((c ^ ((i + 1) & (2**64 - 1))) * 1099511628211) % 2**64
    return c


@pytest.mark.parametrize("n,a,k", [(40, 3, 5), (300, 4, 17), (7, 2, 10)])
def test_exact_knn_breaks_ties_to_the_larger_id(n, a, k):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 3, (n, a)).astype(np.float64)   # many exact ties
    q = rng.integers(0, 3, (25, a)).astype(np.float64)
    d, i = ref.knn(torch.from_numpy(q), torch.from_numpy(x), k,
                   query_block=7)
    bd, bi = brute(q, x, k)
    assert np.array_equal(i.numpy(), bi)
    assert np.array_equal(d.numpy(), bd)


def test_lower_precisions_differ_from_float64_only_in_rounding():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((2000, 32)) * 255)
    q = torch.from_numpy(rng.random((50, 32)) * 255)
    d64, _ = ref.knn(q, x, 10)
    for prec, tol in (("float32", 1e-5), ("tf32", 5e-3)):
        d, i = ref.knn(q, x, 10, precision=prec)
        exact = ref.exact_dists(q, x, i)
        assert float(((d - exact).abs() / exact).max()) < tol
        assert float(((exact - d64) / d64).max()) < tol


def test_vote_takes_the_larger_label_on_ties_and_skips_padding():
    labels = torch.tensor([0, 1, 1, 0, 2, 2])
    ids = torch.tensor([[0, 1, 3, 2], [4, 5, 0, -1], [-1, -1, -1, -1]])
    assert ref.vote(labels, ids, 3).tolist() == [1, 2, -1]


def test_checksums_fold_label_then_ids_plus_one():
    pred = np.array([3, -1, 0])
    ids = np.array([[5, 0, -1], [1, 2, 3], [0, 0, 0]])
    got = ref.checksums(pred, ids)
    assert [int(c) for c in got] == [fnv(int(p), [int(i) for i in r])
                                     for p, r in zip(pred, ids)]
