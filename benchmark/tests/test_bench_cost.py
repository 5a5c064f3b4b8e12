"""The frozen work counts and the peaks."""

import pytest

from benchmark.cost import peaks, work
from benchmark.spec import Spec


@pytest.mark.parametrize("cell,flops,nbytes", [
    ("sift1m.batch", 2.56e12, 4 * (1_000_000 * 128 + 10_000 * 128)
     + 8 * 10_000 * 100),
    ("fashion_mnist.batch", 9.408e11, 4 * (60_000 * 784 + 10_000 * 784)
     + 8 * 10_000 * 10),
])
def test_dense_counts_of_the_batch_cells(cell, flops, nbytes):
    c = Spec.load().cell(cell).config
    q, n, a, k = c["num_queries"], c["num_data"], c["num_attrs"], c["k"]
    assert work.dense_flops(q, n, a) == pytest.approx(flops, rel=1e-12)
    assert work.min_bytes(q, n, a, k) == nbytes


def test_least_time_is_the_larger_bound():
    p = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    assert p == {"dense_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
    assert work.least_seconds(989e12, 1.0, p) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 3.35e12, p) == pytest.approx(1.0)
    assert peaks.peaks_for("some other card") is None
