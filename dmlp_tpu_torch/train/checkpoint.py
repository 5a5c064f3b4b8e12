"""Checkpoint and resume on ``torch.distributed.checkpoint`` — port of
``dmlp_tpu/train/checkpoint.py``.

The reference saves its TrainState pytree with orbax under
``directory/step_<n>``. Here the same directory names hold a
``torch.distributed.checkpoint`` (DCP) of the state's parameters (the
model's state dict, ``layer{i}.w`` / ``layer{i}.b``), optimizer moments
and step. A restore loads in place into a template state, so every leaf
keeps the template's placement: a device tensor, a pinned host buffer of
an offload level, or a tensor-parallel DTensor's local shard (every rank
of the group saves and loads together). Without a process group it runs
in one process. Orbax files are not read: that needs orbax and
tensorstore; tests carry states across as numpy arrays instead.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Dict, Optional

import torch

from dmlp_tpu_torch.train.step import settle


def _payload(state: Dict[str, Any], step: int) -> Dict[str, Any]:
    return {"params": state["params"].state_dict(), "opt": state["opt"],
            "step": torch.tensor(step, dtype=torch.int64)}


def _no_dist() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized()


@contextlib.contextmanager
def _quiet():
    """DCP's two notices of what is asked for here: one process without
    a group, and a step saved again (the end-of-run save may land on a
    periodic one's step)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        warnings.filterwarnings("ignore", message="Detected an existing "
                                "checkpoint")
        yield


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def save_checkpoint(directory: str, state: Dict[str, Any],
                    step: Optional[int] = None) -> str:
    """Write ``state`` under directory/step_<n> (collective over the
    process group, if any); returns the path."""
    import torch.distributed.checkpoint as dcp
    if step is None:
        step = int(state["step"])
    settle(state)
    path = _path(directory, step)
    with _quiet():
        dcp.save(_payload(state, step), no_dist=_no_dist(),
                 storage_writer=dcp.FileSystemWriter(path, overwrite=True))
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(name[5:]) for name in os.listdir(directory)
             if name.startswith("step_") and name[5:].isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, target: Dict[str, Any],
                       step: Optional[int] = None) -> Dict[str, Any]:
    """Restore the given (or latest) step into ``target`` in place (its
    leaves keep their placement) and return it."""
    import torch.distributed.checkpoint as dcp
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    settle(target)
    payload = _payload(target, 0)
    with _quiet():
        dcp.load(payload, checkpoint_id=_path(directory, step),
                 no_dist=_no_dist())
    target["params"].load_state_dict(payload["params"])
    target["step"] = int(payload["step"])
    return target
