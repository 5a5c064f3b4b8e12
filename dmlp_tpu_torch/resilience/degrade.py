"""The degradation ladder of the single-device solve — port of
``dmlp_tpu/resilience/degrade.py``.

On device memory exhaustion (an injected RESOURCE_EXHAUSTED or a real
``torch.cuda.OutOfMemoryError``; resilience.retry.classify treats them
alike) the solve steps down a rung instead of failing, and every rung
prints the same bytes:

1. ``lowp``      — the pruned two-stage solve (ops.summaries) with the
                   low-precision first pass when the precision resolves to
                   "bf16"; with "f32" it is exactly the pruned solve;
2. ``prune``     — the pruned solve at f32 (``DMLP_TPU_PRUNE=0`` makes it
                   the dense solve);
3. ``fused``     — the dense scan on the gated kernel K1
                   (``DMLP_TPU_FUSED=0`` makes it K2);
4. ``tuned``     — the ungated extraction kernel K2;
5. ``heuristic`` — K2 again, with the tune cache suppressed
                   (``tune.cache.suppressed``): every launch knob and the
                   scoring chunk fall back to their heuristics;
6. ``streaming`` — the chunk fold
                   (``engine.single._solve_pipelined``), no running-list
                   kernel;
7. ``host``      — the float64 oracle on the host (``golden.fast``), no
                   device memory at all. Only an engine on the CPU takes
                   it: on a CUDA card an OOM on the ``streaming`` rung
                   propagates, so a solve on the card never reports a
                   host result as its own.

Each step appends to ``stats.snapshot()["degradations"]``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

from dmlp_tpu_torch.resilience import stats
from dmlp_tpu_torch.resilience.retry import classify, resilience_enabled

RUNGS = ("lowp", "prune", "fused", "tuned", "heuristic", "streaming",
         "host")


@contextlib.contextmanager
def _rung_context(engine, rung: str):
    """Set the engine's ``_degrade_rung`` for one attempt, and restore it
    after. engine.single reads it (``streaming`` skips every extract-kernel
    path; ``lowp``/``prune`` may prune; only ``lowp`` may run the bf16
    first pass) and so does ops.fused.resolve_topk_kernel (``lowp``,
    ``prune`` and ``fused`` may launch K1); ``heuristic`` suppresses the
    tune cache's lookups for the duration."""
    prev = getattr(engine, "_degrade_rung", "fused")
    engine._degrade_rung = rung
    # The live rung gauge: the ladder position (0 = lowp ... 6 = host),
    # so a scrape mid-incident sees where the solve sits.
    from dmlp_tpu_torch.obs import telemetry
    telemetry.registry().gauge("resilience.degrade_rung").set(
        RUNGS.index(rung))
    try:
        if rung == "heuristic":
            from dmlp_tpu_torch.tune import cache as tune_cache
            with tune_cache.suppressed():
                yield
        else:
            yield
    finally:
        engine._degrade_rung = prev


def _host_fallback(inp) -> List:
    """The last rung: the float64 host oracle, exact by construction."""
    from dmlp_tpu_torch.golden.fast import knn_golden_fast
    from dmlp_tpu_torch.obs.trace import span as obs_span
    with obs_span("resilience.host_fallback",
                  nq=inp.params.num_queries, n=inp.params.num_data):
        return knn_golden_fast(inp)


def run_ladder(engine, inp, solve: Callable):
    """Run ``solve(inp)`` (normally ``engine._run``), stepping down a rung
    on each OOM-class failure; other errors propagate unchanged.

    ``DMLP_TPU_RESILIENCE=0`` turns off the ladder (no step-downs), not the
    top rung: the solve still runs at RUNGS[0], and pruning and the
    low-precision pass keep their own kill switches. The ``host`` rung is
    taken only when ``engine.device`` is the CPU; on a card the OOM of the
    ``streaming`` rung is raised. A failed attempt's exception is dropped
    when the next rung starts, so nothing holds its tensors there."""
    if not resilience_enabled():
        engine.last_degrade_rung = RUNGS[0]
        with _rung_context(engine, RUNGS[0]):
            return solve(inp)
    engine.last_degrade_rung = RUNGS[0]
    for i, rung in enumerate(RUNGS):
        try:
            engine.last_degrade_rung = rung
            if rung == "host":
                return _host_fallback(inp)
            with _rung_context(engine, rung):
                return solve(inp)
        except Exception as e:
            if (classify(e) != "oom" or i + 1 >= len(RUNGS)
                    or (RUNGS[i + 1] == "host"
                        and engine.device.type != "cpu")):
                raise
            stats.record_degradation(rung, RUNGS[i + 1])
            # The instant also lands in the flight recorder while a
            # telemetry session is active.
            from dmlp_tpu_torch.obs import trace as obs_trace
            obs_trace.instant("resilience.degrade", frm=rung,
                              to=RUNGS[i + 1], error=str(e)[:200])
    raise AssertionError("unreachable: the host rung returns or raises")
