"""Online serving layer — port of ``dmlp_tpu/serve``.

The persistent daemon (``python -m dmlp_tpu_torch.serve``) pays parse,
staging and kernel builds once and then serves query streams:

- :mod:`.engine` — :class:`ResidentEngine`: the corpus staged once into a
  capacity-padded resident device buffer behind a row-count mask
  (ingestion writes rows in place), each request shape bucketed to a
  power-of-two (qpad, k) bucket built once, and K1, K2 and K3 launched on
  the resident rows;
- :mod:`.batching` — continuous micro-batching on one batcher thread,
  which owns every device launch;
- :mod:`.admission` — memory and shape admission before the solve;
- :mod:`.daemon` / :mod:`.protocol` — the line-JSON TCP daemon and its
  graceful SIGTERM drain;
- :mod:`.client` — the replay client and the recorded-trace format.

Responses are byte-identical to the float64 golden oracle on every path:
the resident solves reuse the engine's candidates -> host float64
finalize -> boundary repair pipeline unchanged.
"""

# `python -m dmlp_tpu_torch.serve` executes this __init__ first, so this is
# the earliest point where DMLP_TPU_RACECHECK=1 can wrap the lock factories
# and have EVERY serving-surface lock tracked (telemetry's import-time
# globals are retrofitted by install either way).
import torch  # noqa: F401  (before the install: torch's locks stay native)

from dmlp_tpu_torch.check import racecheck as _racecheck  # noqa: E402

_racecheck.install_from_env()

from dmlp_tpu_torch.serve.admission import AdmissionController  # noqa: F401
from dmlp_tpu_torch.serve.batching import MicroBatcher, Request  # noqa: F401
from dmlp_tpu_torch.serve.engine import (CapacityError,  # noqa: F401
                                         ResidentEngine, k_bucket,
                                         query_bucket)
