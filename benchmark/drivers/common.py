"""What every driver shares: the run's parameters and its outcome."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Any, Dict

from benchmark.spec import Cell


@dataclasses.dataclass
class Run:
    """One run of one cell: ``t0`` is the process's start on the host
    clock (``time.perf_counter``), from which ``setup_s`` is counted."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float

    def log(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the observations for the metric
    readers, the counts, the compared numbers {name: (value, limit)} and
    the device's peak."""

    obs: Dict[str, Any]
    attempted: int
    failed: int
    checks: Dict[str, tuple]
    memory_peak_bytes: int
    correct: bool = False


def free_device(device) -> None:
    """Release what the program left on the card before the reference
    runs there."""
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated(device))


def reset_peak(device) -> None:
    """Start the peak at the program's set-up: the benchmark's own input
    tensors are freed by then."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def now() -> float:
    return time.perf_counter()
