"""Carry a problem instance and a configuration across from the reference.

In this system the "weights" are the problem instance itself. These helpers
let a caller that holds ``dmlp_tpu`` objects solve the identical instance
with the port. They read attributes only and never import ``dmlp_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dmlp_tpu_torch.config import EngineConfig
from dmlp_tpu_torch.io.grammar import KNNInput, Params


def from_reference(obj) -> KNNInput:
    """The port's KNNInput for any object with the reference KNNInput's
    fields (``params.num_data/num_queries/num_attrs``, ``labels``,
    ``data_attrs``, ``ks``, ``query_attrs``), with the same dtypes."""
    p = obj.params
    return KNNInput(
        Params(int(p.num_data), int(p.num_queries), int(p.num_attrs)),
        np.asarray(obj.labels, np.int32),
        np.asarray(obj.data_attrs, np.float64),
        np.asarray(obj.ks, np.int32),
        np.asarray(obj.query_attrs, np.float64))


def config_from_reference(cfg, device: str = "cuda") -> EngineConfig:
    """The port's EngineConfig with every field the reference config
    shares, plus ``device``."""
    names = [f.name for f in dataclasses.fields(EngineConfig)
             if f.name != "device"]
    return EngineConfig(**{n: getattr(cfg, n) for n in names},
                        device=device)
