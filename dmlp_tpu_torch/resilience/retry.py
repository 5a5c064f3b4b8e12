"""Bounded retry with exponential backoff, deterministic jitter, and
transient / oom / fatal error classification — port of
``dmlp_tpu/resilience/retry.py``.

Staging, solve launches and readback are functions of host arrays already
in memory, so re-running them cannot change an answer. :func:`classify`
sorts an error three ways: ``transient`` (injected transients,
connection and timeout errors, the UNAVAILABLE / DEADLINE_EXCEEDED /
ABORTED markers) is retried here; ``oom`` (a simulated RESOURCE_EXHAUSTED
or ``torch.cuda.OutOfMemoryError``) is left to the degradation ladder;
everything else is ``fatal``. A kernel that failed to build or to launch
is always fatal: the ladder must never walk past it.

``$DMLP_TPU_RESILIENCE=0`` turns the layer off (the wrappers become direct
calls). A fault that ends the retries (fatal, or transient past the
attempts) dumps the telemetry session's flight recorder
(``obs.telemetry.flight_fault``) before it propagates.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Callable, Optional

import torch

from dmlp_tpu_torch.kernels import KernelBuildError, KernelLaunchError
from dmlp_tpu_torch.resilience import stats
from dmlp_tpu_torch.resilience.inject import (InjectedTransientError,
                                              SimulatedResourceExhausted)

#: substrings of runtime-error text classified transient
TRANSIENT_MARKERS = ("DEADLINE_EXCEEDED", "UNAVAILABLE", "ABORTED",
                     "injected transient")

#: substrings classified as out-of-memory (ladder recovery, not retry)
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


def resilience_enabled() -> bool:
    """The layer-wide kill switch ($DMLP_TPU_RESILIENCE=0 disables),
    checked per call."""
    return os.environ.get("DMLP_TPU_RESILIENCE", "1") != "0"


def classify(exc: BaseException) -> str:
    """"transient" | "oom" | "fatal" for an exception."""
    if isinstance(exc, (KernelBuildError, KernelLaunchError)):
        return "fatal"
    if isinstance(exc, (SimulatedResourceExhausted,
                        torch.cuda.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, (InjectedTransientError, ConnectionError,
                        TimeoutError, InterruptedError, OperationTimeout)):
        return "transient"
    msg = str(exc)
    if any(m in msg for m in OOM_MARKERS):
        return "oom"
    if any(m in msg for m in TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: attempt n (0-based) sleeps
    ``min(base_ms * multiplier**n, cap_ms) * (1 + jitter * h)``, with
    ``h`` the deterministic per-(seed, site, attempt) hash fraction."""

    attempts: int = 3
    base_ms: float = 25.0
    cap_ms: float = 2000.0
    multiplier: float = 2.0
    jitter: float = 0.25
    seed: int = 0


DEFAULT_POLICY = RetryPolicy()


def backoff_ms(policy: RetryPolicy, site: str, attempt: int) -> float:
    raw = min(policy.base_ms * policy.multiplier ** attempt, policy.cap_ms)
    digest = hashlib.sha256(
        f"{policy.seed}:{site}:{attempt}".encode()).digest()
    frac = int.from_bytes(digest[:8], "big") / 2 ** 64
    return raw * (1.0 + policy.jitter * frac)


def call_with_retry(op: Callable, site: str,
                    policy: Optional[RetryPolicy] = None,
                    classify_fn: Callable = classify,
                    sleep: Callable = time.sleep):
    """Run ``op()`` with bounded transient retries; fatal and oom errors
    propagate at once (oom belongs to the degradation ladder). Every
    retry bumps the stats counters and records a ``resilience.retry``
    span; a fault that ends the retries goes to the flight recorder."""
    if not resilience_enabled():
        return op()
    policy = policy or DEFAULT_POLICY
    attempt = 0
    while True:
        try:
            return op()
        except Exception as e:
            clc = classify_fn(e)
            if clc != "transient" or attempt + 1 >= policy.attempts:
                # Post-mortem evidence before the raise unwinds: a fatal
                # (or retries-exhausted) fault dumps the flight recorder
                # while the last events are still in its ring (no-op
                # without a telemetry session); an oom goes to the
                # ladder, which is recovery: an event, no dump.
                from dmlp_tpu_torch.obs import telemetry
                telemetry.flight_fault(
                    site=site, classification=clc,
                    error=type(e).__name__,
                    dump=clc == "fatal" or (clc == "transient"
                                            and attempt + 1
                                            >= policy.attempts))
                raise
            delay = backoff_ms(policy, site, attempt)
            stats.record_retry(site)
            from dmlp_tpu_torch.obs.trace import span as obs_span
            with obs_span("resilience.retry", site=site,
                          attempt=attempt + 1,
                          backoff_ms=round(delay, 2),
                          error=type(e).__name__):
                sleep(delay / 1e3)
            attempt += 1


class OperationTimeout(RuntimeError):
    """An operation exceeded its deadline (see call_with_timeout)."""


def call_with_timeout(op: Callable, timeout_s: float, site: str = "",
                      clock: Callable = time.monotonic):
    """Run ``op`` on a worker thread and join with a deadline; raises
    :class:`OperationTimeout` (classified transient) when it passes.
    Python cannot kill the worker, so a hung ``op`` leaks its daemon
    thread: this guards operations whose hangs resolve (slow readbacks),
    not hung processes."""
    result: list = []
    error: list = []

    def _worker():
        try:
            result.append(op())
        except BaseException as e:  # check: no-retry — relayed to the caller below
            error.append(e)

    t = threading.Thread(target=_worker, daemon=True,
                         name=f"resilience-timeout:{site}")
    t0 = clock()
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        stats.record_timeout(site)
        raise OperationTimeout(
            f"operation at {site or '<unnamed>'} exceeded "
            f"{timeout_s:.3g}s (waited {clock() - t0:.3g}s; worker "
            "thread abandoned)")
    if error:
        raise error[0]
    return result[0]
