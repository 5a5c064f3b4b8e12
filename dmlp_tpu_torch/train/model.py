"""The MLP classifier of the train extension — port of
``dmlp_tpu/train/model.py``.

The model consumes the record shape the KNN engine does: a float attribute
vector per example and an integer label. Its parameters keep the
reference's names and layout: ``layer{i}.w`` of shape (din, dout) and
``layer{i}.b`` of shape (dout,), so a reference checkpoint's arrays load
as they are (:func:`params_from_jax`).

Compute dtype. The reference computes ``dot_general(bf16, bf16,
preferred_element_type=f32)``: the product is accumulated and returned in
f32, the bias is added in f32, and the activation goes back to bf16 after
the relu. A plain ``h_bf16 @ w_bf16`` returns bf16, a different result, so
:func:`matmul_f32` computes bf16 products with f32 accumulation through
:class:`Bf16MatMul`, forward and backward as the reference's transposes
do: the incoming f32 gradient is not rounded (the transpose is the mixed
product ``dot_general(g_f32, w_bf16)``, f32 out), the activation's
gradient is rounded to bf16, and the weight's is rounded after the dp
sum (:func:`round_weight_grads`), since the reference sums its f32
partial sums over "dp" before the cast's transpose rounds them.
:func:`mm_acc_f32` forms the products: on a CUDA tensor ``torch.mm(a, b,
out_dtype=torch.float32)`` (the CUDA-only ``aten::mm.dtype``; an f32
operand is split into three bf16 parts that sum to it exactly, and one
product three times as long covers them), on a CPU tensor, where that op
does not exist, the product of the operands upcast to f32: the same exact
products, accumulated in f32 in another order. A hidden layer's output
gradient holds bf16 values (its output is recast to bf16 after the relu),
so its backward rounds it to bf16 losslessly and takes plain products;
only the last layer's take the split.
Under tensor parallelism the same function runs on each rank's shards: the
local products, and a column-parallel layer's input gradient summed over
"tp" in f32 before it is rounded. f32 products are IEEE f32:
``allow_tf32`` stays off, as in the rest of the port. The products stay
``torch.mm``, as the reference's stay outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def split_bf16(t: torch.Tensor):
    """Three bf16 tensors whose sum is the f32 ``t`` exactly: each takes
    the next 8 bits of the significand."""
    hi = t.to(torch.bfloat16)
    rest = t - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def mm_acc_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32 (no autograd): two bf16
    matrices, or one bf16 and one f32, the reference's mixed product (the
    exact products of the f32 values)."""
    if a.device.type != "cuda":
        return torch.mm(a.float(), b.float())
    if a.dtype == b.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    if a.dtype == torch.float32:
        # [hi | mid | lo] against b three times over: one product, 3K long.
        return torch.mm(torch.cat(split_bf16(a), dim=1),
                        torch.cat([b] * 3, dim=0), out_dtype=torch.float32)
    # a against [hi | mid | lo]: one product, its three column blocks summed.
    n = b.shape[1]
    out = torch.mm(a, torch.cat(split_bf16(b), dim=1),
                   out_dtype=torch.float32)
    return out[:, :n] + out[:, n:2 * n] + out[:, 2 * n:]


def _local(t: torch.Tensor, placement) -> torch.Tensor:
    """The local shard of the DTensor ``t`` redistributed to
    ``placement``."""
    if t.placements != (placement,):
        t = t.redistribute(placements=[placement])
    return t.to_local()


class Bf16MatMul(torch.autograd.Function):
    """bf16 products with f32 accumulation, forward and backward, of a
    bf16 activation ``h`` and the stored weight ``w``, cast to bf16 here;
    ``grad_bf16``: the output's gradient holds bf16 values.

    The weight's gradient comes back in ``w``'s storage dtype, not yet
    rounded to bf16: the reference sums the product's f32 partial sums
    over "dp" before its cast's transpose rounds them, so the step rounds
    after the dp all-reduce (:func:`round_weight_grads`).

    With DTensors (the Megatron plan of ``train.sharding``) each rank
    multiplies its shards: a column-parallel ``w`` (Shard(1), ``h``
    replicated) gives the output's column block, a row-parallel one
    (Shard(0), ``h`` sharded on its last dim) the partial sums of the
    whole output (Partial, reduced by the plan's output layout)."""

    @staticmethod
    def forward(ctx, h, w, grad_bf16):
        wb = w.to(h.dtype)
        ctx.save_for_backward(h, wb)
        ctx.grad_bf16 = grad_bf16
        ctx.w_dtype = w.dtype
        if not isinstance(w, DTensor):
            return mm_acc_f32(h, wb)
        out = mm_acc_f32(h.to_local(), wb.to_local())
        col = w.placements[0] == Shard(1)
        return DTensor.from_local(
            out, w.device_mesh, [Shard(1) if col else Partial()],
            shape=torch.Size((h.shape[0], w.shape[1])),
            stride=(w.shape[1], 1))

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        if isinstance(w, DTensor):
            return Bf16MatMul._backward_tp(ctx, g, h, w) + (None,)
        need_h, need_w = ctx.needs_input_grad[:2]
        if ctx.grad_bf16:
            g = g.to(h.dtype)   # lossless
        gh = mm_acc_f32(g, w.t()).to(h.dtype) if need_h else None
        gw = mm_acc_f32(h.t(), g).to(ctx.w_dtype) if need_w else None
        return gh, gw, None

    @staticmethod
    def _backward_tp(ctx, g, h, w):
        need_h, need_w = ctx.needs_input_grad[:2]
        mesh = w.device_mesh
        col = w.placements[0] == Shard(1)
        gl = _local(g, Shard(1) if col else Replicate())
        if ctx.grad_bf16:
            gl = gl.to(h.dtype)   # lossless
        hl, wl = h.to_local(), w.to_local()
        gh = gw = None
        if need_h:
            ghl = mm_acc_f32(gl, wl.t())
            if col:   # partial sums of the replicated input's gradient
                # check: no-traffic (a tp collective: the reference
                # models none of them, and neither does obs.comms)
                dist.all_reduce(ghl, group=mesh.get_group())
            gh = DTensor.from_local(ghl.to(h.dtype), mesh, h.placements,
                                    shape=h.shape, stride=h.stride())
        if need_w:
            gw = DTensor.from_local(
                mm_acc_f32(hl.t(), gl).to(ctx.w_dtype), mesh, w.placements,
                shape=w.shape, stride=w.stride())
        return gh, gw


def round_weight_grads(names: Sequence[str], grads: Sequence[torch.Tensor],
                       compute_dtype: Optional[torch.dtype]) -> None:
    """The weights' gradients rounded to ``compute_dtype`` in place: the
    transpose of the reference's cast of the stored weights (the bias is
    added in f32 and keeps its f32 gradient). The step calls it after the
    dp all-reduce (see :class:`Bf16MatMul`)."""
    if compute_dtype is None:
        return
    with torch.no_grad():
        for name, g in zip(names, grads):
            if name.endswith(".w"):
                g = g.to_local() if isinstance(g, DTensor) else g
                g.copy_(g.to(compute_dtype))


def matmul_f32(h: torch.Tensor, w: torch.Tensor,
               grad_bf16: bool = False) -> torch.Tensor:
    """``h @ w`` accumulated and returned in f32: f32 operands, or a bf16
    ``h`` and a stored weight ``w`` multiplied in bf16 (:class:`Bf16MatMul`,
    whose weight gradient :func:`round_weight_grads` finishes);
    ``grad_bf16``: the output's gradient holds bf16 values (a hidden
    layer's)."""
    if h.dtype == torch.float32:
        return torch.mm(h, w.to(h.dtype))
    return Bf16MatMul.apply(h, w, grad_bf16)


def dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          grad_bf16: bool = False) -> torch.Tensor:
    """One layer, ``h @ w + b``, in the activation's dtype with an f32
    result; ``w`` is used in ``h``'s dtype (the reference casts the stored
    weights to the compute dtype)."""
    return matmul_f32(h, w, grad_bf16) + b


class Dense(nn.Module):
    """One layer with the reference's (din, dout) weight ``w`` and bias
    ``b``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)
        #: its output is recast to the compute dtype after the relu (every
        #: layer but the last: :class:`MLP` sets it)
        self.recast = False

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return dense(h, self.w, self.b, self.recast)


class MLP(nn.Module):
    """The layers ``layer0 .. layer{n-1}``; ``forward(x, compute_dtype)``
    is :func:`mlp_apply`."""

    def __init__(self, layers: Sequence[Dense]):
        super().__init__()
        for i, layer in enumerate(layers):
            layer.recast = i < len(layers) - 1
            self.add_module(f"layer{i}", layer)

    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(len(self._modules))]

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return mlp_apply(self, x, compute_dtype)


def resolve_device(device) -> torch.device:
    """This rank's compute device: the CPU, or its card (raises without
    one; ``parallel.distributed.rank_device``)."""
    from dmlp_tpu_torch.parallel.distributed import rank_device
    return rank_device(str(torch.device(device).type))


def init_mlp(generator: torch.Generator, layer_dims: Sequence[int],
             dtype: torch.dtype = torch.float32, device="cuda") -> MLP:
    """He-initialized MLP for dims [in, h1, ..., num_classes], drawn on the
    host from ``generator`` (so every rank draws the same parameters) and
    moved to ``device`` (this rank's card unless "cpu" is given; raises
    without one)."""
    device = resolve_device(device)
    layers = []
    for din, dout in zip(layer_dims[:-1], layer_dims[1:]):
        w = torch.randn((din, dout), generator=generator, dtype=dtype) \
            * torch.tensor(math.sqrt(2.0 / din), dtype=dtype)
        layers.append(Dense(w.to(device), torch.zeros(dout, dtype=dtype,
                                                      device=device)))
    return MLP(layers)


def mlp_apply(model: MLP, x: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Forward pass -> f32 logits (batch, num_classes). With
    ``compute_dtype=torch.bfloat16`` the products take bf16 operands with
    f32 accumulation; parameters keep their storage dtype."""
    layers = model.layers()
    h = x if compute_dtype is None else x.to(compute_dtype)
    for i, layer in enumerate(layers):
        h = layer(h)
        if i < len(layers) - 1:
            h = torch.relu(h)
            if compute_dtype is not None:
                h = h.to(compute_dtype)
    return h


def _numel(a) -> int:
    return int(np.prod(tuple(a.shape)))


def num_matmul_params(params: Any) -> int:
    """Total weight-matrix elements (for the 6*N*B FLOP estimate).

    Takes an :class:`MLP` (the dp x tp family; a tensor-parallel one
    counts its global shapes), a module of the reference's names (the
    pipeline and MoE families' ``ParamTable``, global shapes) or, as the
    reference's, a dict: the dict-of-layers with "w", the pipeline
    families (stacked "pp_w" or "wc"/"wr") and the MoE family ("up"/"down"
    expert stacks and the router), whose count covers every expert."""
    if isinstance(params, MLP):
        return sum(_numel(p) for name, p in params.named_parameters()
                   if name.endswith(".w"))
    if isinstance(params, nn.Module):   # the pipeline and MoE families
        params = dict(params.named_parameters())
    if "pp_w" in params:
        return _numel(params["in_w"]) + _numel(params["pp_w"]) \
            + _numel(params["out_w"])
    if "wc" in params:
        return _numel(params["in_w"]) + _numel(params["wc"]) \
            + _numel(params["wr"]) + _numel(params["out_w"])
    if "up" in params:
        return _numel(params["in_w"]) + _numel(params["router"]) \
            + _numel(params["up"]) + _numel(params["down"]) \
            + _numel(params["out_w"])
    return sum(_numel(v["w"]) for v in params.values())


def params_from_jax(np_params: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """The reference's params as numpy arrays, as the port's: the MLP's
    ``{"layer0": {"w": array, "b": array}, ...}`` as an :class:`MLP` state
    dict (``model.load_state_dict``); the pipeline and MoE families'
    stacked dicts (``pp_w`` (S, P, H, H), ``wc``/``bc``/``wr``/``br``,
    ``up`` (E, H, F), ``down``, ``router``, ``in_*``, ``out_*``) under
    their own names, whole, for their ``build_*_state(..., params=)``,
    where each rank takes its stage's, tp shard's or experts' slice."""
    out = {}
    for name, v in np_params.items():
        if isinstance(v, Mapping):
            out.update({f"{name}.{leaf}": torch.from_numpy(
                np.array(arr, copy=True)) for leaf, arr in v.items()})
        else:
            out[name] = torch.from_numpy(np.array(v, copy=True))
    return out
