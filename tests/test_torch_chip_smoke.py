"""The on-card smoke script's own rules, on the CPU: its phases' time
budgets, the kernel paths every full run must hold, and the deadline that
bounds every wait on a process it starts. The script itself needs a CUDA
card; these tests import it without one."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()

# The runs each kernel was launched by in a full run on the card (the
# kernels line's launches_by_path), by count.
HELD_SIZES = {"fused_topk": 22, "extract_topk": 6, "fused_topk_u8": 1,
              "extract_topk_u8": 1, "extract_merge": 30,
              "fused_dist_segmin": 13}


def _rows(paths=None):
    paths = cs.HELD_PATHS if paths is None else paths
    return [{"name": k, "launches_by_path": {p: 4 for p in paths[k]}}
            for k in cs.KERNELS]


def test_phase_budgets_name_every_phase_and_sum_to_at_most_700():
    assert list(cs.PHASE_BUDGET_S) == list(cs.PHASES)
    assert all(v > 0 for v in cs.PHASE_BUDGET_S.values())
    assert sum(cs.PHASE_BUDGET_S.values()) <= 700


def test_the_deadline_ends_the_run_before_its_limit():
    assert sum(cs.PHASE_BUDGET_S.values()) < cs.DEADLINE_S <= 1150


@pytest.mark.parametrize("kernel", sorted(HELD_SIZES))
def test_held_paths_cover_every_kernel(kernel):
    assert set(cs.HELD_PATHS) == set(cs.KERNELS) == set(HELD_SIZES)
    paths = cs.HELD_PATHS[kernel]
    assert len(paths) == HELD_SIZES[kernel]
    assert all(isinstance(p, str) and p for p in paths)


def test_every_merge_path_launches_k1_or_k2():
    """The merge follows every K1/K2 launch that splits: each of its paths
    is a path of K1 or K2, the FMA kernel's or the integer one's."""
    k12 = cs.HELD_PATHS["fused_topk"] | cs.HELD_PATHS["extract_topk"] \
        | cs.HELD_PATHS["fused_topk_u8"] | cs.HELD_PATHS["extract_topk_u8"]
    assert cs.HELD_PATHS["extract_merge"] <= k12


def test_a_full_kernels_line_misses_no_held_path():
    assert cs.held_paths_missed(_rows()) == {}


@pytest.mark.parametrize("kernel", sorted(HELD_SIZES))
def test_a_path_with_no_launch_is_missed(kernel):
    rows = _rows()
    row = next(r for r in rows if r["name"] == kernel)
    lost = sorted(row["launches_by_path"])[0]
    row["launches_by_path"][lost] = 0
    assert cs.held_paths_missed(rows) == {kernel: [lost]}
    del row["launches_by_path"][lost]
    assert cs.held_paths_missed(rows) == {kernel: [lost]}


def test_a_kernel_missing_from_the_line_misses_every_path():
    rows = [r for r in _rows() if r["name"] != "fused_dist_segmin"]
    assert cs.held_paths_missed(rows) == {
        "fused_dist_segmin": sorted(cs.HELD_PATHS["fused_dist_segmin"])}


@pytest.mark.parametrize("requested", [0.5, 30, 300, 600, 900, 1e9])
@pytest.mark.parametrize("elapsed", [0.0, 8.0, 500.0, 1000.0, 1149.0,
                                     1149.999])
def test_deadline_timeout_never_exceeds_the_time_left(requested, elapsed):
    got = cs.deadline_timeout(requested, elapsed)
    left = cs.DEADLINE_S - elapsed
    assert 0 < got <= left + 1e-9
    assert got <= requested
    assert got == min(requested, left)


@pytest.mark.parametrize("elapsed", [1150.0, 1150.001, 1200.0, 5000.0])
def test_deadline_timeout_raises_once_spent(elapsed):
    with pytest.raises(TimeoutError, match="1150 s deadline"):
        cs.deadline_timeout(30, elapsed)


def test_deadline_timeout_takes_its_deadline():
    assert cs.deadline_timeout(100, 10, deadline=60) == 50
    with pytest.raises(TimeoutError):
        cs.deadline_timeout(100, 60, deadline=60)


def test_left_fails_the_run_naming_the_phase(monkeypatch):
    monkeypatch.setattr(cs, "T0", cs.time.perf_counter() - 2000.0)
    monkeypatch.setattr(cs, "PHASE", ["fleet"])
    with pytest.raises(SystemExit, match="phase fleet: .*deadline"):
        cs.left(60)


def test_left_is_the_request_early_in_the_run(monkeypatch):
    monkeypatch.setattr(cs, "T0", cs.time.perf_counter())
    assert cs.left(60) == 60


def test_a_background_failure_is_raised_by_its_result():
    def fails():
        cs.check(False, "the probe broke")
    result = cs.in_background(fails)
    with pytest.raises(SystemExit, match="the probe broke"):
        result()
    assert cs.in_background(lambda a, b: a + b, 2, 3)() == 5


def test_pending_host_checks_run_in_order_and_fail_the_run():
    seen = []
    cs._PENDING[:] = [lambda: seen.append(1), lambda: cs.check(False, "x"),
                      lambda: seen.append(3)]
    with pytest.raises(SystemExit, match="FAILED: x"):
        cs.settle_host()
    assert seen == [1]
    cs.settle_host()
    assert seen == [1, 3] and cs._PENDING == []


def test_importing_the_script_imports_neither_torch_nor_the_reference():
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "import json; print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'dmlp_tpu', "
            "'dmlp_tpu_torch'))))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert json.loads(out) == []


def test_without_a_card_it_exits_nonzero_and_prints_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and out == ""
