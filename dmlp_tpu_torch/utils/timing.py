"""Timing: the stderr metrics contract + per-phase timers.

The reference's only observability is rank 0 bracketing ``Engine::KNN`` with
steady_clock and printing ``Time taken: <ms> ms`` to stderr
(common.cpp:122-131); run_bench.sh greps that line (run_bench.sh:40-41).
The same contract line is kept byte-identical here, and per-phase timers
(device-fenced by the caller) are added on top — the survey §5.1 gap.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


def format_time_taken(elapsed_ms: float) -> str:
    """The exact stderr line of common.cpp:130 (integer milliseconds)."""
    return f"Time taken: {int(elapsed_ms)} ms\n"


class EngineTimer:
    """Wall-clock + named-phase timer.

    Phases are fenced by the caller (``torch.cuda.synchronize`` or a
    result fetch before closing a phase) so asynchronous device work is
    not misattributed.
    """

    def __init__(self) -> None:
        self._start: float | None = None
        self._elapsed_ms: float = 0.0
        self.phase_ms: Dict[str, float] = {}

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        assert self._start is not None, "timer not started"
        self._elapsed_ms = (time.perf_counter() - self._start) * 1e3
        return self._elapsed_ms

    @property
    def elapsed_ms(self) -> float:
        return self._elapsed_ms

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_ms[name] = self.phase_ms.get(name, 0.0) + \
                (time.perf_counter() - t0) * 1e3

    def stderr_line(self) -> str:
        return format_time_taken(self._elapsed_ms)
