"""Resilience: deterministic fault injection, retry with backoff, and the
degradation ladder — port of ``dmlp_tpu/resilience``.

The contract is byte-identical recovery: a retry re-runs an operation on
host arrays already in memory, and every rung of the ladder prints the
same bytes, its last rung being the float64 oracle itself.

Layout: :mod:`.inject` (seeded fault schedules and the named injection
sites), :mod:`.retry` (bounded backoff and error classification),
:mod:`.degrade` (the OOM ladder), :mod:`.stats` (the counters),
:mod:`.supervise` (heartbeats, bounded cluster relaunch and the
single-process fallback of ``dmlp_tpu_torch.distributed``).
"""

from dmlp_tpu_torch.resilience.inject import (FaultSchedule, InjectedFault,
                                              InjectedTransientError,
                                              SimulatedResourceExhausted)
from dmlp_tpu_torch.resilience.retry import (DEFAULT_POLICY,
                                             OperationTimeout, RetryPolicy,
                                             call_with_retry,
                                             call_with_timeout, classify,
                                             resilience_enabled)

__all__ = [
    "FaultSchedule", "InjectedFault", "InjectedTransientError",
    "SimulatedResourceExhausted", "RetryPolicy", "DEFAULT_POLICY",
    "OperationTimeout", "call_with_retry", "call_with_timeout",
    "classify", "resilience_enabled",
]
