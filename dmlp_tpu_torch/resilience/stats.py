"""Process-wide resilience accounting — port of
``dmlp_tpu/resilience/stats.py``.

The same record hooks and the same :func:`snapshot` shape as the
reference, on plain counters under one lock (the reference keeps them in
its telemetry registry, which comes with ROADMAP A13). The ordered
degradation list is what the ladder's tests assert step by step.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, List

_lock = threading.Lock()
_NAMES = ("retries", "rollbacks", "restarts", "timeouts", "faults_injected",
          "degradations")
# name -> label -> count ("" is the unlabelled count)
_counts: Dict[str, Counter] = {name: Counter() for name in _NAMES}
_degradations: List[str] = []


def _inc(name: str, label: str = "") -> None:
    with _lock:
        _counts[name][label] += 1


def reset() -> None:
    with _lock:
        _degradations.clear()
        for c in _counts.values():
            c.clear()


def record_retry(site: str) -> None:
    _inc("retries", site)


def record_degradation(frm: str, to: str) -> None:
    with _lock:
        _degradations.append(f"{frm}->{to}")
        _counts["degradations"][f"{frm}->{to}"] += 1


def record_fault(site: str, kind: str) -> None:
    _inc("faults_injected", kind)


def record_rollback() -> None:
    _inc("rollbacks")


def record_restart() -> None:
    _inc("restarts")


def record_timeout(site: str) -> None:
    _inc("timeouts", site)


def any_activity() -> bool:
    with _lock:
        return any(sum(c.values()) for c in _counts.values())


def snapshot() -> dict:
    """A JSON-ready copy of the counters, every field present (zeros
    included), in the reference's shape."""
    with _lock:
        totals = {name: int(sum(c.values())) for name, c in _counts.items()}
        return {
            "retries": totals["retries"],
            "rollbacks": totals["rollbacks"],
            "restarts": totals["restarts"],
            "timeouts": totals["timeouts"],
            "faults_injected": totals["faults_injected"],
            "degradations": list(_degradations),
            "retry_sites": {k: int(v)
                            for k, v in _counts["retries"].items()},
        }
