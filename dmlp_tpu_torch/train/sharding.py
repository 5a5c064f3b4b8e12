"""The (dp, tp) mesh and the Megatron plan of the train extension — port of
``dmlp_tpu/train/sharding.py``.

A 2D ``DeviceMesh`` with the dimension names ("dp", "tp") over the
initialized process group, row-major as the reference's
``Mesh(devices.reshape(dp, tp))``: batches split over "dp" (each dp index
takes its contiguous block of rows, the tp ranks of it the same block),
weights over "tp", Megatron-style: even layers column-parallel (``w``
split on its output dim, ``b`` with it), odd layers row-parallel (``w``
split on its input dim, ``b`` replicated), so a column/row pair needs one
all-reduce of the activations. The plan goes through
``parallelize_module`` on ``mesh["tp"]`` with ``ColwiseParallel`` and
``RowwiseParallel``; since those place ``nn.Linear``'s (dout, din)
weight, the plan's subclasses place the reference's (din, dout) ``w``
with the same input and output layouts. Every rank draws the same
initial parameters, so each takes its shard of its own copy
(``src_data_rank=None``: no broadcast).

When the last layer is column-parallel (an odd layer count, as in the
default 4-entry ``--dims``) its output comes back replicated before the
loss. ``output_layouts=Replicate()`` would all-gather it through the
functional collectives, and their ``all_gather_tensor`` crashes on CUDA
tensors under gloo (a segmentation fault in the card's PyTorch, while
their all-reduce, DTensor's redistributions and the c10d calls work), so
:func:`gather_cols` replicates it with one all-reduce of the zero-padded
column blocks instead: the same values bit for bit (x + 0 = x), on every
backend. :func:`full_tensor` gathers a parameter the same way.

The dp gradient sync is not declared here: ``train.step.allreduce_grads``
runs it over ``mesh["dp"]``'s group. gloo has no ``reduce_scatter``, so
the plan never asks for a Partial -> Shard redistribution (no sequence
parallelism). A mesh of one rank is ``None``: no process group, no
DTensor.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_module, distribute_tensor)
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               RowwiseParallel,
                                               parallelize_module)

DP_AXIS = "dp"
TP_AXIS = "tp"


def make_train_mesh(shape: Optional[Tuple[int, int]] = None,
                    device_type: Optional[str] = None):
    """The (dp, tp) ``DeviceMesh`` over the initialized process group
    (``shape=None``: every rank on dp), or None for one rank without a
    group. A shape of fewer ranks than the group takes the first dp * tp,
    as the reference's takes the first devices; every rank of the group
    calls this, and the others are outside the mesh
    (:func:`in_mesh`). ``device_type`` is where DTensor's collectives take
    their tensors: the compute device's type (gloo carries CUDA
    tensors)."""
    if not dist.is_initialized():
        if shape is not None and shape[0] * shape[1] > 1:
            raise RuntimeError(
                f"a {shape[0]} x {shape[1]} train mesh needs a process "
                "group: call dmlp_tpu_torch.parallel.distributed."
                "initialize() first (the loop CLI starts the ranks)")
        return None
    world = dist.get_world_size()
    dp, tp = shape if shape is not None else (world, 1)
    if dp * tp > world:
        raise ValueError(f"mesh shape {(dp, tp)} needs {dp * tp} ranks, "
                         f"have {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if dp * tp == world:
        return init_device_mesh(device_type, (dp, tp),
                                mesh_dim_names=(DP_AXIS, TP_AXIS))
    return DeviceMesh(device_type, torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=(DP_AXIS, TP_AXIS))


def in_mesh(mesh) -> bool:
    """Whether this rank holds a cell of ``mesh`` (always, for one
    rank)."""
    return mesh is None or mesh.get_coordinate() is not None


def mesh_dims(mesh) -> Tuple[int, int]:
    """(dp, tp) of ``mesh``; (1, 1) for one rank."""
    return (1, 1) if mesh is None else tuple(mesh.shape)


def dp_group(mesh):
    """The "dp" dimension's process group (the gradient all-reduce's), or
    None on one rank."""
    return None if mesh is None else mesh.get_group(DP_AXIS)


def dp_coord(mesh) -> Tuple[int, int]:
    """(this rank's dp index, dp size)."""
    if mesh is None:
        return 0, 1
    return int(mesh.get_local_rank(DP_AXIS)), int(mesh.shape[0])


def _partition(placements, _name, module, mesh):
    """Each parameter of ``module`` as a DTensor of its placement, cut
    from this rank's own copy (no broadcast)."""
    for name, param in list(module.named_parameters(recurse=False)):
        module.register_parameter(name, nn.Parameter(
            distribute_tensor(param.detach(), mesh, [placements[name]],
                              src_data_rank=None),
            requires_grad=param.requires_grad))


class Colwise(ColwiseParallel):
    """``ColwiseParallel`` for a (din, dout) ``w``: ``w`` Shard(1), ``b``
    Shard(0); the output sharded on its last dim."""

    def _output_fn(self):
        return partial(self._prepare_output_fn, self.output_layouts,
                       self.use_local_output)

    def _apply(self, module, device_mesh):
        return distribute_module(
            module, device_mesh,
            partial(_partition, {"w": Shard(1), "b": Shard(0)}),
            partial(self._prepare_input_fn, self.input_layouts,
                    self.desired_input_layouts),
            self._output_fn())


class ColwiseReplicated(Colwise):
    """``Colwise`` whose output comes back replicated
    (:func:`gather_cols`)."""

    def _output_fn(self):
        return lambda mod, out, mesh: gather_cols(
            out.to_local(), mesh.get_group(), out.shape[-1])


class Rowwise(RowwiseParallel):
    """``RowwiseParallel`` for a (din, dout) ``w``: ``w`` Shard(0), ``b``
    replicated; the input sharded on its last dim, the output
    replicated."""

    def _apply(self, module, device_mesh):
        self.desired_input_layouts = (Shard(-1),)
        return distribute_module(
            module, device_mesh,
            partial(_partition, {"w": Shard(0), "b": Replicate()}),
            partial(self._prepare_input_fn, self.input_layouts,
                    self.desired_input_layouts),
            partial(self._prepare_output_fn, self.output_layouts,
                    self.use_local_output))


class GatherDim(torch.autograd.Function):
    """:func:`gather_dim`: forward one all-reduce of the zero-padded
    blocks; backward this rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, local, group, total, dim):
        g = dist.get_world_size(group)
        start = min(dist.get_rank(group) * -(-total // g), total)
        shape = list(local.shape)
        shape[dim] = total
        full = local.new_zeros(shape)
        full.narrow(dim, start, local.shape[dim]).copy_(local)
        # check: no-traffic (the Megatron gather as an all-reduce of
        # zero-padded blocks: a tp collective, unmodelled as in the
        # reference)
        dist.all_reduce(full, group=group)
        ctx.block = (dim, start, local.shape[dim])
        return full

    @staticmethod
    def backward(ctx, grad):
        dim, start, n = ctx.block
        return grad.narrow(dim, start, n).contiguous(), None, None, None


def gather_dim(local, group, total: int, dim: int):
    """The replicated tensor of one sharded on ``dim`` over ``group``:
    this rank's block (DTensor's ``Shard`` chunking: ceil(total / size)
    a rank) at its offset in zeros, summed over the group."""
    return GatherDim.apply(local, group, total, dim % max(local.dim(), 1))


def gather_cols(local, group, total: int):
    """The replicated (..., total) tensor of a column-sharded one."""
    return gather_dim(local, group, total, -1)


def full_tensor(t):
    """The whole of a DTensor, or ``t`` itself: gathered over each mesh
    dimension that shards it, in turn (collective over those dimensions'
    groups)."""
    if not isinstance(t, DTensor):
        return t
    out = t.to_local()
    for i, placement in enumerate(t.placements):
        if placement.is_shard():
            out = gather_dim(out, t.device_mesh.get_group(i),
                             t.shape[placement.dim], placement.dim)
    return out


def tp_plan(n_layers: int):
    """``parallelize_module``'s plan: even layers column-parallel, odd
    layers row-parallel; a column-parallel last layer gives its output
    back replicated."""
    plan = {}
    for i in range(n_layers):
        if i % 2:
            plan[f"layer{i}"] = Rowwise()
        elif i == n_layers - 1:
            plan[f"layer{i}"] = ColwiseReplicated()
        else:
            plan[f"layer{i}"] = Colwise()
    return plan


def apply_tp(model, mesh):
    """Shard ``model``'s layers over ``mesh["tp"]`` in place (nothing at
    tp = 1); returns the model."""
    if mesh is None or mesh.shape[1] == 1:
        return model
    return parallelize_module(model, mesh[TP_AXIS],
                              tp_plan(len(model.layers())))


def batch_slice(x: np.ndarray, y: np.ndarray, mesh):
    """This rank's dp block of a global batch's rows (replicated over
    tp)."""
    r, dp = dp_coord(mesh)
    n = x.shape[0]
    if n % dp:
        raise ValueError(f"batch {n} does not split over dp = {dp}")
    rows = slice(r * n // dp, (r + 1) * n // dp)
    return x[rows], y[rows]


def local_param_bytes(model) -> int:
    """Bytes of this rank's parameter shards (a DTensor counts its local
    shard)."""
    total = 0
    for p in model.parameters():
        t = p.to_local() if isinstance(p, DTensor) else p
        total += t.numel() * t.element_size()
    return total


__all__ = ["DP_AXIS", "TP_AXIS", "make_train_mesh", "in_mesh", "mesh_dims",
           "dp_group", "dp_coord", "tp_plan", "apply_tp", "gather_dim",
           "gather_cols", "full_tensor", "batch_slice", "local_param_bytes"]
