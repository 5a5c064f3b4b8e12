"""Seeded inputs and traffic repeat exactly."""

import numpy as np
import torch

from benchmark import datagen
from benchmark.loadgen import window_seed

CFG = {"num_data": 500, "num_queries": 20, "num_attrs": 8,
       "num_labels": 10, "data": {"low": 0.0, "high": 255.0}}


def test_same_seed_same_inputs_other_seed_other_inputs():
    dev = torch.device("cpu")
    big = 2**31 + 12345
    a1, l1 = datagen.corpus(CFG, big, dev)
    a2, l2 = datagen.corpus(CFG, big, dev)
    assert torch.equal(a1, a2) and torch.equal(l1, l2)
    a3, _ = datagen.corpus(CFG, big + 1, dev)
    assert not torch.equal(a1, a3)
    assert float(a1.min()) >= 0.0 and float(a1.max()) < 255.0
    assert torch.equal(datagen.batch_queries(CFG, big, dev),
                       datagen.batch_queries(CFG, big, dev))
    q1 = datagen.request_queries(CFG, big, 30)
    assert np.array_equal(q1, datagen.request_queries(CFG, big, 30))
    assert np.array_equal(q1.astype(np.float32).astype(np.float64), q1)


def test_every_seed_offers_the_same_gaps_in_its_own_order():
    a = datagen.arrival_offsets(420, 20, 7)
    b = datagen.arrival_offsets(420, 20, 7)
    c = datagen.arrival_offsets(420, 20, 2**33 + 5)
    assert np.array_equal(a, b)
    assert len(a) == len(c) == 8400
    assert not np.array_equal(a, c)
    ga, gc = np.diff(a), np.diff(c)
    assert np.all(ga >= 0) and a[0] == 0.0
    # the same multiset of gaps (one of them is the first, dropped)
    assert abs(np.sort(ga).sum() - np.sort(gc).sum()) < 0.1
    assert abs(a[-1] - 20) < 0.5


def test_a_generators_first_window_uses_the_runs_seed():
    assert window_seed(99, 0) == 99
    assert window_seed(99, 1) != 99
