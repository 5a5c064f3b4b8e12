"""The metric readers: tails over every request, nothing read from
nothing."""

import pytest

from benchmark.drivers.open_loop import latencies
from benchmark.harness import reader
from benchmark.spec import BENCH_DIR, Spec

PEAKS = {"dense_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def test_p95_is_the_nearest_rank_over_every_request_due():
    recs = [[i / 100, float(i), "ok", [1], [2]] for i in range(95)]
    recs += [[0.96, None, "no response", None, None],
             [0.97, 3.0, "rejected: queue full", None, None]]
    recs += [[0.98 + i / 1000, 1.0, "ok", [1], [2]] for i in range(3)]
    recs += [[5.0, 1.0, "ok", [1], [2]]]     # due after the window
    lat = latencies(recs, 1.0, 60000.0)
    assert len(lat) == 100
    assert reader("p95_ms")({"latencies_ms": lat}) == 91.0
    lat[-8:] = [60000.0] * 8
    assert reader("p95_ms")({"latencies_ms": lat}) == 60000.0


def test_rates_and_shares():
    obs = {"queries_done": 300000, "window_s": 20.0, "solves": 30,
           "work": {"dense_flops": 2.56e12, "min_bytes": 5.2e8},
           "peaks": PEAKS,
           "trace": {"solves": 3, "busy_s": 0.6, "window_s": 2.0,
                     "kernel_s": {"void extract_topk_kernel<1>(x)": 0.5,
                                  "void extract_merge_kernel<1>(y)": 0.1,
                                  "other": 9.0}}}
    assert reader("queries_per_s")(obs) == 15000.0
    assert reader("device_idle_pct.batch")(obs) == pytest.approx(70.0)
    least = 2.56e12 / 989e12
    assert reader("extract_roofline_pct.batch")(obs) == \
        pytest.approx(100 * least * 3 / 0.6)
    assert reader("solve_peak_pct.batch")(obs) == \
        pytest.approx(100 * 30 * 2.56e12 / (20 * 989e12))


READERS = sorted(p.stem for p in (BENCH_DIR / "metrics").glob("*.py"))


def test_every_metric_of_the_benchmark_has_a_reader():
    spec = Spec.load()
    assert {m.name for m in spec.end_to_end + spec.per_layer} <= set(READERS)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_with_nothing_to_read_reports_nothing(name):
    assert reader(name)({}) is None
    assert reader(name)({"trace": {"window_s": 1.0, "kernel_s": {}},
                         "peaks": PEAKS, "work": {"dense_flops": 1.0,
                                                  "min_bytes": 1.0},
                         "phase_ms": [], "batch_log": [],
                         "latencies_ms": []}) is None
