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
finalize -> boundary repair pipeline unchanged. The reference's race
sanitizer hook (ROADMAP A15) is not here.
"""

from dmlp_tpu_torch.serve.admission import AdmissionController  # noqa: F401
from dmlp_tpu_torch.serve.batching import MicroBatcher, Request  # noqa: F401
from dmlp_tpu_torch.serve.engine import (CapacityError,  # noqa: F401
                                         ResidentEngine, k_bucket,
                                         query_bucket)
