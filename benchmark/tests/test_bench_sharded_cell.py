"""``bigann1b.batch_sharded`` through the harness on the CPU at a test's
size: four gloo ranks, the held-shard solve, the window, the judge over
the compact table, and the result line's metrics by ``--trace``."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.spec import Spec
from benchmark.tests.test_bench_sharded import small_cell


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_of_the_sharded_cell(monkeypatch, trace):
    monkeypatch.setattr(Spec, "cell", lambda self, name: small_cell())
    res = harness.run_cell(Spec.load(), "bigann1b.batch_sharded",
                           2**33 + 17, 1.0, trace, torch.device("cpu"),
                           time.perf_counter())
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert res["correct"] is True and res["attempted"] % 64 == 0
    assert res["checks"]["answer_err"] == {"value": 0.0, "limit": 0.0}
    names = set(res["metrics"])
    if trace:
        # no device on the CPU: the device's readers find nothing to read
        assert names == {"sharded.fold_ms", "sharded.merge_ms",
                         "batch.fetch_ms", "batch.finalize_ms"}
    else:
        assert names == {"queries_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
