"""One run of a cell through the harness on the CPU: the result line's
keys, the cell's metrics by ``--trace``, the checks last."""

import pytest
import torch

from benchmark import harness
from benchmark.spec import Spec
from benchmark.tests.conftest import small_cell


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_of_a_batch_cell(monkeypatch, trace):
    monkeypatch.setattr(Spec, "cell", lambda self, name: small_cell(name))
    import time
    res = harness.run_cell(Spec.load(), "fashion_mnist.batch", 2**31 + 99,
                           1.0, trace, torch.device("cpu"),
                           time.perf_counter())
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0
    names = set(res["metrics"])
    if trace:
        # no device on the CPU: the device's readers find nothing to read
        assert names == {"batch.enqueue_ms", "batch.fetch_ms"}
    else:
        assert names == {"queries_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert res["checks"]["answer_err"]["value"] <= \
        res["checks"]["answer_err"]["limit"]
