"""The span readers and ``benchmark.spans``: the batch engine's split of
a solve read from ``last_phase_ms``, a root span's self time less its
child spans, the device's idle time put down to the innermost program
span, and the two profiled stretches on the CPU at a test size."""

import pytest

from benchmark import spans
from benchmark.harness import reader
from benchmark.tests.conftest import cpu_run

SPLIT_READERS = {"batch.copy_ms": "copy", "batch.pin_ms": "pin",
                 "batch.launch_ms": "launch",
                 "batch.chunk_wait_ms": "chunk_wait",
                 "batch.finalize_ms": "finalize"}


@pytest.mark.parametrize("name", sorted(SPLIT_READERS))
def test_split_readers_are_means_over_the_window(name):
    key = SPLIT_READERS[name]
    obs = {"phase_ms": [{key: 10.0, "enqueue": 50.0}, {key: 20.0},
                        {"enqueue": 40.0}]}
    assert reader(name)(obs) == 15.0


@pytest.mark.parametrize("name", sorted(set(SPLIT_READERS)
                                        - {"batch.finalize_ms"}))
def test_split_readers_report_nothing_from_a_program_without_the_split(
        name):
    """The parent program's phases: enqueue, fetch, finalize alone."""
    obs = {"phase_ms": [{"prune": 0.0, "enqueue": 470.0, "fetch": 2.0,
                         "finalize": 120.0}]}
    assert reader(name)(obs) is None


def _x(name, sid, parent, ts, dur, **args):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": 1,
            "tid": 0, "args": {"id": sid, "parent": parent, **args}}


def _solve(base, first_id):
    i = first_id
    return [
        _x("single.run_device_full", i, None, base, 1000.0, h2d_bytes=96),
        _x("single.host_copy", i + 1, i, base + 10, 200.0, bytes=64),
        _x("single.pin", i + 2, i, base + 210, 100.0, bytes=64),
        _x("single.enqueue_extract", i + 3, i, base + 320, 500.0,
           h2d_bytes=64),
        _x("single.chunk_wait", i + 4, i + 3, base + 400, 150.0),
        _x("single.chunk_wait", i + 5, i + 3, base + 600, 150.0),
        _x("single.fetch", i + 6, i, base + 830, 40.0),
        _x("single.finalize", i + 7, i, base + 870, 100.0),
    ]


def test_split_subtracts_child_spans_from_self_time():
    events = _solve(5000.0, 20) + _solve(0.0, 1) + [
        {"name": "spans.clock_sync", "ph": "i", "ts": 0.0, "args": {}}]
    rows = spans.roots(events)
    assert len(rows) == 2
    r = rows[0]
    assert r["solve_ms"] == 1.0 and r["h2d_bytes"] == 96
    # root 1,000 us; children cover 200+100+500+40+100 = 940 us
    assert r["self_pct"] == pytest.approx(6.0)
    assert rows == [dict(r)] * 2
    # The chunk loop: 500 us less its two 150 us waits.
    ev = _solve(0.0, 1)
    kids = spans._children(ev)
    assert spans.self_us(ev[3], kids) == pytest.approx(200.0)
    assert spans.self_us(ev[4], kids) == 150.0


def test_split_reads_nothing_without_a_root():
    assert spans.roots([_x("single.fetch", 1, None, 0.0, 5.0)]) == []
    assert spans.roots([]) == []


def test_the_innermost_span_covering_most_of_a_gap_wins():
    # Device busy [0, 10] and [40, 50]; the gap [10, 40] lies under the
    # root [0, 60], its child a [5, 35] and a's child b [20, 30]: a is
    # innermost over 15 of its 30, b over 10, the root over 5. The gap
    # [50, 70] is half under the root, half under no span: a tie the
    # span takes.
    busy = [(0.0, 10.0), (40.0, 50.0)]
    host = [(0.0, 60.0, "root"), (5.0, 35.0, "a"), (20.0, 30.0, "b")]
    by_name, named = spans.idle_by_span(busy, host, 0.0, 70.0)
    assert by_name == {"a": 15.0, "b": 10.0, "root": 15.0,
                       spans.NO_SPAN: 10.0}
    assert named == [["a", 30.0], ["root", 20.0]]
    assert sum(by_name.values()) == 70.0 - 20.0


def test_idle_outside_every_span_is_unnamed():
    by_name, named = spans.idle_by_span([(2.0, 3.0)], [], 0.0, 5.0)
    assert by_name == {spans.NO_SPAN: 4.0}
    assert named == [[spans.NO_SPAN, 2.0], [spans.NO_SPAN, 2.0]]
    by_name, _ = spans.idle_by_span([(0.0, 5.0)], [(0.0, 5.0, "r")],
                                    0.0, 5.0)
    assert by_name == {}


def test_both_stretches_on_the_cpu():
    from dmlp_tpu_torch.obs import trace as obs_trace
    out = spans.measure(cpu_run("fashion_mnist.batch"), 2)
    assert obs_trace.active() is None
    assert len(out["solve_s_untraced"]) == len(out["solve_s_traced"]) == 2
    rows = out["per_solve"]
    assert len(rows) == 2
    for row in rows:
        assert row["h2d_bytes"] == rows[0]["h2d_bytes"] > 0
        assert 0 <= row["self_pct"] < 100
        ph = row["phase_ms"]
        assert ph["copy"] > 0 and ph["launch"] > 0
        assert {"copy", "launch", "enqueue"} <= set(ph)
    assert out["untraced"]["window_s"] > 0
    idle = out["idle"]
    assert idle["idle_s"] > 0 and 0 <= idle["idle_named_pct"] <= 100
    assert "single.enqueue_extract" in idle["idle_s_by_span"]
    assert len(out["clock"]["tracer_residual_us"]) == 2
