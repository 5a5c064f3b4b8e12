"""The comparison that decides ``correct`` fails its control and every
fault a cell can have, and passes the program: small sizes on the CPU,
the cells' own driver code with the program broken underneath."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import datagen
from benchmark.drivers import batch, open_loop
from benchmark.tests.conftest import cpu_run

BATCH_CELLS = ["sift1m.batch", "fashion_mnist.batch"]


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_batch_program_is_correct_and_its_tf32_control_is_not(cell):
    out = batch.run(cpu_run(cell))
    assert out.correct and out.attempted > 0
    value, limit = out.checks["answer_err"]
    assert value <= limit
    ctl = batch.control(cpu_run(cell))["tf32"]
    assert ctl["answer_err"] > 3 * limit


def _near_twins(cfg, seed, device):
    """A corpus of pairs of rows a few float32 rounding steps apart, so
    float32 orders some of them wrongly where float64 does not."""
    attrs, labels = ORIG_CORPUS(cfg, seed, device)
    n = attrs.shape[0]
    half = attrs[: n // 2]
    twin = half * (1 + 3e-7)
    return torch.cat([half, twin]), labels


ORIG_CORPUS = datagen.corpus


def test_serve_float32_control_gets_answers_wrong(monkeypatch):
    monkeypatch.setattr(datagen, "corpus", _near_twins)
    ctl = open_loop.control(cpu_run("sift1m.serve", seconds=2.0))
    assert ctl["float32"]["wrong"] > 0


def test_serve_program_is_exact():
    out = open_loop.run(cpu_run("sift1m.serve", seconds=1.0))
    assert out.correct and out.checks["wrong"] == (0, 0)
    assert out.attempted > 0 and out.failed == 0


# -- faults planted in the program, one per kind the cells can have -------

def _half_left_out(results):
    """Half of the batch left out: its answers are the other half's."""
    h = len(results) // 2
    return results[:h] + results[:len(results) - h]


def _answer_altered(results):
    """Each answer altered where it is produced: the vote moves."""
    return [dataclasses.replace(r, predicted_label=r.predicted_label + 1)
            for r in results]


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_batch_faults_read_not_correct(monkeypatch, cell, fault):
    from dmlp_tpu_torch.engine.single import SingleChipEngine
    real = SingleChipEngine.run_device_full
    monkeypatch.setattr(SingleChipEngine, "run_device_full",
                        lambda self, inp: fault(real(self, inp)))
    out = batch.run(cpu_run(cell))
    assert not out.correct
    assert out.checks["answer_err"][0] == 1.0


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
def test_serve_faults_read_not_correct(monkeypatch, fault):
    from dmlp_tpu_torch.serve.engine import ResidentEngine
    real = ResidentEngine.solve_batch
    state = {"on": False}

    def broken(self, query_attrs, ks):
        res = real(self, query_attrs, ks)
        return fault(res) if state["on"] else res

    monkeypatch.setattr(ResidentEngine, "solve_batch", broken)
    real_drive = open_loop.drive

    def drive(*a, **kw):
        state["on"] = True
        return real_drive(*a, **kw)
    monkeypatch.setattr(open_loop, "drive", drive)
    out = open_loop.run(cpu_run("sift1m.serve", seconds=1.5,
                                traffic={"rate_per_s": 80}))
    assert not out.correct and out.checks["wrong"][0] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_controls_fail_on_the_card(cuda, cell):
    """The same controls with the card's own TF32 unit."""
    import time
    from benchmark.drivers.common import Run
    from benchmark.tests.conftest import small_cell
    r = Run(cell=small_cell(cell), seed=3, seconds=1.0, trace=False,
            device=cuda, t0=time.perf_counter())
    limit = r.cell.traffic["limits"]["answer_err"]
    assert batch.control(r)["tf32"]["answer_err"] > 3 * limit
    assert np.isfinite(limit)
