"""Shared pieces of the benchmark's own tests: small cells that run on
the CPU, and the ``card`` marker for the tests that need a CUDA card,
decided inside a fixture."""

from __future__ import annotations

import time

import pytest

from benchmark.drivers.common import Run
from benchmark.spec import Cell, file_cell

#: test sizes: the extraction path needs more than 8,192 padded rows
SMALL = {
    "sift1m.batch": {"config": {"num_data": 9000, "num_queries": 48,
                                "num_attrs": 16, "k": 10}},
    "fashion_mnist.batch": {"config": {"num_data": 9000, "num_queries": 48,
                                       "num_attrs": 32}},
    "sift1m.serve": {"config": {"num_data": 9000, "num_attrs": 16},
                     "traffic": {"rate_per_s": 40, "max_batch_queries": 64,
                                 "connections": 8, "trace_s": 0.3}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)


#: (configuration, mix) of each cell the tests run
FILES = {"sift1m.batch": ("sift1m", "batch_full"),
         "fashion_mnist.batch": ("fashion_mnist", "batch_full"),
         "sift1m.serve": ("sift1m", "open_single")}


def small_cell(name: str, **over) -> Cell:
    c = file_cell(name, *FILES[name])
    size = SMALL[name]
    cfg = {**c.config, **size.get("config", {}), **over.get("config", {})}
    tr = {**c.traffic, **size.get("traffic", {}), **over.get("traffic", {})}
    return Cell(c.name, c.config_name, c.traffic_name, c.chips, cfg, tr)


def cpu_run(name: str, seed: int = 2**31 + 11, seconds: float = 1.0,
            trace: bool = False, **over) -> Run:
    import torch
    return Run(cell=small_cell(name, **over), seed=seed, seconds=seconds,
               trace=trace, device=torch.device("cpu"),
               t0=time.perf_counter())
