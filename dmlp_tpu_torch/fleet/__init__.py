"""Serving fleet — port of ``dmlp_tpu/fleet/``: both axes of scale on top
of the serving daemon (``dmlp_tpu_torch.serve``).

- :mod:`~dmlp_tpu_torch.fleet.mesh_engine` — :class:`MeshResidentEngine`,
  the resident serving engine over a (data, query) mesh of
  ``torch.distributed`` ranks: every rank stages its shard's resident
  chunks once, folds them with K1 per micro-batch, and the candidates
  merge across the data axis (all-gather or ring) before rank 0's float64
  finalize. The daemon's ``--mesh RxC`` serves with it.
- :mod:`~dmlp_tpu_torch.fleet.router` — the line-JSON front end over N
  daemon replicas: health and drain awareness, bounded retry of queries on
  a replica failure, ingest fan-out, the aggregated OpenMetrics view.
- :mod:`~dmlp_tpu_torch.fleet.scrape` — the OpenMetrics merge.
- :mod:`~dmlp_tpu_torch.fleet.loadgen` — the open-loop load levels and the
  SLO ramp.
- :mod:`~dmlp_tpu_torch.fleet.autoscale` — the supervisor: crash and hang
  detection, bounded relaunch, scaling, the re-split trigger.
- :mod:`~dmlp_tpu_torch.fleet.reshard` — the staged capacity re-split.
- :mod:`~dmlp_tpu_torch.fleet.consistency` — corpus signatures, divergence
  diagnosis and the checksum-driven repair.
- :mod:`~dmlp_tpu_torch.fleet.harness` — spawn, await and drain replicas
  and the router as subprocesses.

``python -m dmlp_tpu_torch.fleet`` runs the router, static over existing
replicas or supervised (``--spawn-corpus``).
"""

# Same early racecheck hook as dmlp_tpu_torch.serve: `python -m
# dmlp_tpu_torch.fleet` executes this __init__ before the router/engine
# imports create any serving locks, so DMLP_TPU_RACECHECK=1 tracks the full
# fleet surface.
import torch  # noqa: F401  (before the install: torch's locks stay native)

from dmlp_tpu_torch.check import racecheck as _racecheck  # noqa: E402

_racecheck.install_from_env()

