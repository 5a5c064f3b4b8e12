"""Process-wide resilience accounting — port of
``dmlp_tpu/resilience/stats.py``.

The counters live in the one process-wide metrics registry
(:data:`dmlp_tpu_torch.obs.telemetry.REGISTRY`), as the reference's do:
the live scrape (``--telemetry``), the flight recorder and the end-of-run
``resilience`` block read the same numbers. The ordered degradation list
is what the ladder's tests assert step by step; :func:`snapshot` keeps the
reference's shape.
"""

from __future__ import annotations

import threading
from typing import List

from dmlp_tpu_torch.obs.telemetry import REGISTRY

_lock = threading.Lock()
_degradations: List[str] = []   # ordered transitions (counts mirror the
#                                 resilience.degradations counter labels)
_NAMES = ("retries", "rollbacks", "restarts", "timeouts", "faults_injected",
          "degradations")


def _counters() -> dict:
    """The resilience counter set, registered once per name (literal
    snake_case dotted names — check rule R6)."""
    return {
        "retries": REGISTRY.counter("resilience.retries"),
        "rollbacks": REGISTRY.counter("resilience.rollbacks"),
        "restarts": REGISTRY.counter("resilience.restarts"),
        "timeouts": REGISTRY.counter("resilience.timeouts"),
        "faults_injected": REGISTRY.counter("resilience.faults_injected"),
        "degradations": REGISTRY.counter("resilience.degradations"),
    }


def reset() -> None:
    with _lock:
        _degradations.clear()
    REGISTRY.reset(prefix="resilience")


def record_retry(site: str) -> None:
    REGISTRY.counter("resilience.retries").inc(label=site)


def record_degradation(frm: str, to: str) -> None:
    with _lock:
        _degradations.append(f"{frm}->{to}")
    REGISTRY.counter("resilience.degradations").inc(label=f"{frm}->{to}")


def record_fault(site: str, kind: str) -> None:
    REGISTRY.counter("resilience.faults_injected").inc(label=kind)


def record_rollback() -> None:
    REGISTRY.counter("resilience.rollbacks").inc()


def record_restart() -> None:
    REGISTRY.counter("resilience.restarts").inc()


def record_timeout(site: str) -> None:
    REGISTRY.counter("resilience.timeouts").inc(label=site)


def any_activity() -> bool:
    c = _counters()
    return any(c[name].total() for name in _NAMES)


def snapshot() -> dict:
    """A JSON-ready copy of the counters, every field present (zeros
    included), in the reference's shape, read from the registry."""
    c = _counters()
    with _lock:
        degr = list(_degradations)
    return {
        "retries": int(c["retries"].total()),
        "rollbacks": int(c["rollbacks"].total()),
        "restarts": int(c["restarts"].total()),
        "timeouts": int(c["timeouts"].total()),
        "faults_injected": int(c["faults_injected"].total()),
        "degradations": degr,
        "retry_sites": {k: int(v)
                        for k, v in c["retries"].by_label().items()},
    }
