"""Observability of the port: span traces, per-launch cost counters with
the card's roofline, collective-traffic and memory accounting, live
telemetry and SLOs — port of ``dmlp_tpu/obs``.

The contract channels (checksums on stdout, ``Time taken`` on stderr)
stay byte-identical with every flag on; everything here is extra stderr
lines after the contract line, files and a localhost endpoint:

- :mod:`.trace` — the span tracer (Chrome-trace / Perfetto JSON), with an
  optional bridge to ``torch.profiler.record_function``;
- :mod:`.dist_trace` — per-rank tracers (rank = Perfetto pid) writing
  ``trace-rank<NN>.json`` with barrier-stamped clock-sync markers;
- :mod:`.counters` — the cost probe: each kernel launch recorded by its
  wrapper, timed with CUDA events on the card, resolved through
  :mod:`.kernel_cost`'s analytic FLOPs and bytes against the card's peak
  table;
- :mod:`.comms` — analytic collective traffic of the mesh engines;
- :mod:`.memwatch` — resident-set models of the engines and their
  reconciliation against ``torch.cuda.max_memory_allocated``;
- :mod:`.telemetry` — the metrics registry, the device-memory sampler,
  OpenMetrics export and the crash flight recorder;
- :mod:`.slo` — declarative objectives with burn rates and trends;
- :mod:`.run` — the versioned :class:`RunRecord` artifact.

Off means off: with no flag, no tracer, probe or session is installed and
each hook in the engines and the kernels' wrappers is one module-global
read. No module here imports torch at import time except where it reads a
device.
"""

from dmlp_tpu_torch.obs.run import SCHEMA_VERSION, RunRecord  # noqa: F401
