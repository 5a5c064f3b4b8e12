"""Pipeline-parallel training over a ("dp", "pp") or ("dp", "tp", "pp")
mesh — port of ``dmlp_tpu/train/pipeline.py``.

The reference runs one jitted ``shard_map`` program per step; here every
rank runs its cell of the same schedule eagerly:

- the layer stack is split into S contiguous stages, stacked into uniform
  (S, P, H, H) arrays and held as DTensors placed ``Shard(0)`` on the
  "pp" mesh dimension (:data:`PP_PSPECS`): each rank computes on its
  stage's local slice;
- a loop over M + S - 1 ticks runs the GPipe schedule tick by tick as the
  reference's ``lax.scan`` does: at tick t, stage s runs microbatch
  t - s and hands its activation to stage s + 1 through
  ``train.collectives.PPermute``, in every tick, bubbles included (they
  compute on what they hold and are masked at collection);
- the loss is a per-cell partial, nonzero only on each dp row's last
  stage (:func:`_partials_train_step`); autograd's backward issues the
  reverse-schedule hand-offs, and each parameter's gradient is then summed
  over the mesh axes it is replicated on (``train.collectives.
  reduce_grads``) with the reference's 1 / n_dp folded into the backward's
  seed.

The interleaved schedule (V chunks a cell, cell s owning chunks s, s + S,
..., the ring hand-off with the S - 1 -> 0 link) and the 3-D composition
(Megatron column/row pairs inside each stage, one tp all-reduce a pair)
follow the reference's ``_ppi_body`` and ``_pp3_body``. The flat oracles
(:func:`flatten_pipeline`, :func:`flat_forward`,
:func:`flatten_interleaved`, :func:`pp3_reference_forward`) are plain
torch.

Everything runs in IEEE f32 (no TF32, no offload): the reference's rule
for these families.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from dmlp_tpu_torch.train.collectives import (HandOff, group_size, psum,
                                              reduce_grads)
from dmlp_tpu_torch.train.model import resolve_device
from dmlp_tpu_torch.train.step import MOMENT_NAMES, init_state

DP_AXIS = "dp"
PP_AXIS = "pp"
TP_AXIS = "tp"
WORLD = "world"

PipeParams = Dict[str, torch.Tensor]
Spec = Tuple[Optional[str], ...]


# -- meshes -------------------------------------------------------------------

def make_axes_mesh(axes: Mapping[str, int],
                   device_type: Optional[str] = None
                   ) -> Optional[DeviceMesh]:
    """A ``DeviceMesh`` over the first prod(axes) ranks of the initialized
    group, row-major, with the axes' names — the one mesh constructor the
    pp/pp3/ep entry points share — or None for one cell without a group.

    Besides the per-axis groups, every rank builds here, in the same
    order, one group per set of two or more axes (a parameter replicated
    on several axes sums its gradient over them): :func:`axis_group` reads
    them. Ranks outside the mesh take part and hold no cell."""
    axes = dict(axes)
    if any(v < 1 for v in axes.values()):
        raise ValueError(f"mesh axes must be >= 1, got {axes}")
    total = int(np.prod(list(axes.values())))
    if not dist.is_initialized():
        if total > 1:
            raise RuntimeError(
                f"a {axes} mesh needs a process group: call dmlp_tpu_torch."
                "parallel.distributed.initialize() first (the loop CLI "
                "starts the ranks)")
        return None
    world = dist.get_world_size()
    if total > world:
        raise ValueError(f"need {total} ranks, have {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names = tuple(axes)
    layout = torch.arange(total).reshape(*axes.values())
    mesh = DeviceMesh(device_type, layout, mesh_dim_names=names)
    groups = {}
    me = dist.get_rank()
    for k in range(2, len(names) + 1):
        for subset in itertools.combinations(range(len(names)), k):
            rest = [i for i in range(len(names)) if i not in subset]
            label = WORLD if k == len(names) else \
                ",".join(names[i] for i in subset)
            moved = layout.permute(*rest, *subset).reshape(
                -1, int(np.prod([layout.shape[i] for i in subset])))
            for row in moved.tolist():
                g = dist.new_group(row)
                if me in row:
                    groups[label] = g
    mesh.axis_groups = groups
    return mesh


def make_pp_mesh(dp: int, pp: int, device_type: Optional[str] = None):
    return make_axes_mesh({DP_AXIS: dp, PP_AXIS: pp}, device_type)


def make_pp3_mesh(dp: int, tp: int, pp: int,
                  device_type: Optional[str] = None):
    return make_axes_mesh({DP_AXIS: dp, TP_AXIS: tp, PP_AXIS: pp},
                          device_type)


def axis_size(mesh, name: str) -> int:
    return 1 if mesh is None else int(mesh.size(mesh.mesh_dim_names.index(
        name)))


def axis_index(mesh, name: str) -> int:
    return 0 if mesh is None else int(mesh.get_local_rank(name))


def axis_group(mesh, axes: Sequence[str]):
    """The process group over ``axes`` of ``mesh`` through this rank (one
    axis: the mesh's own; several: :func:`make_axes_mesh`'s; all:
    "world"), or None when it holds one rank or there is no mesh."""
    if mesh is None or not axes:
        return None
    if len(axes) == 1:
        g = mesh.get_group(axes[0])
    else:
        label = WORLD if len(axes) == len(mesh.mesh_dim_names) else \
            ",".join(axes)
        g = mesh.axis_groups[label]
    return g if group_size(g) > 1 else None


def mesh_axes(mesh) -> Dict[str, object]:
    """Every named group of ``mesh`` (axes and axis sets), for the
    collective record's axis names."""
    if mesh is None:
        return {}
    out = {n: mesh.get_group(n) for n in mesh.mesh_dim_names}
    out.update(getattr(mesh, "axis_groups", {}))
    return out


def world_group(mesh):
    return axis_group(mesh, tuple(mesh.mesh_dim_names)) if mesh is not None \
        else None


# -- parameters and placement -------------------------------------------------

class ParamTable(nn.Module):
    """Parameters under the reference's names (``in_w``, ``pp_w``, ...),
    each a DTensor of its placement on the mesh (a plain tensor without
    one). The step computes on their local shards and updates them in
    place, so they carry no autograd state."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of a partition spec (tensor dim -> mesh
    axis or None) on ``mesh``: Shard on the dims it names, Replicate
    elsewhere."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if a == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def replica_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The mesh axes a parameter of ``spec`` is replicated on."""
    return tuple(n for n in mesh.mesh_dim_names if n not in spec)


def local_slice(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (DTensor's ``Shard``
    chunking; every sharded size must divide)."""
    out = full
    for d, name in enumerate(spec):
        if name is None:
            continue
        n = axis_size(mesh, name)
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of size {full.shape[d]} does not "
                             f"split over {name} = {n}")
        size = full.shape[d] // n
        out = out.narrow(d, axis_index(mesh, name) * size, size)
    return out.contiguous()


def place_params(full: Mapping[str, torch.Tensor], mesh,
                 specs: Mapping[str, Spec], device) -> ParamTable:
    """The full parameters (the same on every rank) as a
    :class:`ParamTable` of each rank's slices on ``device``, DTensors of
    ``specs``' placements on ``mesh``."""
    tensors = {}
    for name, spec in specs.items():
        t = torch.as_tensor(full[name], dtype=torch.float32)
        if mesh is None:
            tensors[name] = t.to(device).contiguous()
            continue
        local = local_slice(t, spec, mesh).to(device)
        tensors[name] = DTensor.from_local(
            local, mesh, placements(spec, mesh), run_check=False,
            shape=t.shape, stride=t.contiguous().stride())
    return ParamTable(tensors)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _he(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)


def init_pipeline(gen: torch.Generator, d_in: int, hidden: int,
                  n_classes: int, stages: int, layers_per_stage: int
                  ) -> PipeParams:
    """Uniform pipeline body: stages x layers_per_stage (H, H) layers plus
    the replicated input projection and readout, drawn on the host from
    ``gen`` (every rank draws the same), stacked so the stage axis shards
    with ``("pp", ...)``."""
    s, p, h = stages, layers_per_stage, hidden
    return {"in_w": _he(gen, (d_in, h), d_in), "in_b": torch.zeros(h),
            "pp_w": _he(gen, (s, p, h, h), h),
            "pp_b": torch.zeros(s, p, h),
            "out_w": _he(gen, (h, n_classes), h),
            "out_b": torch.zeros(n_classes)}


#: partition specs: the placement and the gradient sums derive from them
PP_PSPECS: Dict[str, Spec] = {
    "in_w": (None, None), "in_b": (None,),
    "pp_w": (PP_AXIS, None, None, None), "pp_b": (PP_AXIS, None, None),
    "out_w": (None, None), "out_b": (None,),
}


# -- the shared step ----------------------------------------------------------

class PartialsStep:
    """(state, x, y) -> (state, metrics) over a partial-loss body: the
    state updated in place. ``body(leaves, x, y)`` gives this cell's loss
    and accuracy partials, the tensors whose cotangent is zero (the
    schedule's last hand-off, whose mirrored backward the reference runs
    too) and further metrics of this cell (the a2a dispatch's dropped
    tokens); the partials sum over the mesh to ``divisor(x)`` times the batch
    loss, so the backward is seeded with 1 / divisor, as the reference's
    ``loss_p.sum() / n_dp`` seeds each partial. Each gradient is then
    summed over its replica axes (``reduce_grads``) and the optimizer
    updates the local shards."""

    def __init__(self, mesh, optimizer, specs: Mapping[str, Spec],
                 body: Callable, divisor: Callable[[torch.Tensor], float]):
        self.mesh, self.optimizer, self.body = mesh, optimizer, body
        self.divisor = divisor
        self.groups = {n: None if mesh is None
                       else axis_group(mesh, replica_axes(spec, mesh))
                       for n, spec in specs.items()}
        self.world = world_group(mesh)

    def __call__(self, state, x: torch.Tensor, y: torch.Tensor):
        model = state["params"]
        names = [n for n, _ in model.named_parameters()]
        with torch.no_grad():
            local = {n: _local(p) for n, p in model.named_parameters()}
        leaves = {n: t.detach().requires_grad_(True)
                  for n, t in local.items()}
        loss_p, acc_p, tails, extra = self.body(leaves, x, y)
        div = float(self.divisor(x))
        grads = torch.autograd.grad(
            [loss_p, *tails], [leaves[n] for n in names],
            [torch.full_like(loss_p, 1.0 / div),
             *[torch.zeros_like(t) for t in tails]], allow_unused=True)
        grads = [torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(names, grads)]
        reduce_grads(grads, [self.groups[n] for n in names])
        state["step"] += 1
        opt = state["opt"]
        self.optimizer.update(
            [local[n] for n in names], grads,
            [[_local(opt[m][n]) for n in names]
             for m in MOMENT_NAMES[self.optimizer.name]], state["step"])
        return state, {"loss": loss_p.detach(), "accuracy": acc_p.detach(),
                       "divisor": div, **extra}

    def global_metrics(self, metrics) -> Dict[str, float]:
        """The step's loss and accuracy over the global batch: the
        partials summed over the mesh, over the divisor."""
        t = torch.stack([metrics["loss"].float(),
                         metrics["accuracy"].float()])
        if self.world is not None:
            # check: no-traffic (two floats, the host's loss readout)
            dist.all_reduce(t, group=self.world)
        loss, acc = (t / metrics["divisor"]).tolist()
        return {"loss": loss, "accuracy": acc}


def _partials_train_step(mesh, optimizer, specs, body, n_dp: int
                         ) -> PartialsStep:
    """The step over a body whose partials (one nonzero cell per dp row)
    sum to n_dp times the batch loss. Shared by the 2D and 3D pipeline
    steps and the dense MoE step."""
    return PartialsStep(mesh, optimizer, specs, body, lambda x: n_dp)


def place_state(params: Mapping[str, torch.Tensor], mesh, specs, optimizer,
                device):
    """The parameters placed per ``specs`` on ``device``, and the
    optimizer moments on the placed parameters (so they inherit the
    placement). Shared by the pipeline and MoE ``build_*_state``."""
    return init_state(place_params(params, mesh, specs, device), optimizer)


def _loss_acc(logits: torch.Tensor, y: torch.Tensor):
    loss = F.cross_entropy(logits, y.long())
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc


def _micro(h0: torch.Tensor, n_micro: int) -> torch.Tensor:
    if h0.shape[0] % n_micro:
        raise ValueError(f"local batch {h0.shape[0]} does not split into "
                         f"{n_micro} microbatches")
    return h0.reshape(n_micro, h0.shape[0] // n_micro, -1)


# -- GPipe ---------------------------------------------------------------------

def _stage_block(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor):
    """One stage's layers_per_stage dense+relu layers. w: (P, H, H)."""
    for i in range(w.shape[0]):
        h = torch.relu(h @ w[i] + b[i])
    return h


def _collect(ys, like: torch.Tensor, n_micro: int) -> torch.Tensor:
    """The collected microbatches (zeros where none was taken)."""
    if all(y is None for y in ys):
        return torch.zeros((n_micro, *like.shape), dtype=like.dtype,
                           device=like.device)
    return torch.stack(ys)


def _readout(p, ys, h0, y, mine: bool):
    logits = ys.reshape(h0.shape) @ p["out_w"] + p["out_b"]
    loss, acc = _loss_acc(logits, y)
    w = 1.0 if mine else 0.0
    return loss * w, acc * w


def _pp_body(p, x, y, *, s_idx: int, n_stages: int, n_micro: int,
             hand: HandOff):
    """This (dp, pp) cell's pipelined loss partial. ``p["pp_w"]`` is its
    (1, P, H, H) stage slice; x/y its dp slice of the batch."""
    w_s, b_s = p["pp_w"][0], p["pp_b"][0]
    h0 = x.float() @ p["in_w"] + p["in_b"]
    h_mb = _micro(h0, n_micro)
    first = torch.tensor(s_idx == 0, device=h0.device)
    act = torch.zeros_like(h_mb[0])
    ys = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        m = t - s_idx    # this stage's microbatch at this tick
        # Stage 0 pulls fresh microbatches, later stages the activation
        # handed over at the previous tick (kept on the autograd chain so
        # its backward runs here too).
        inp = torch.where(first, h_mb[min(max(t, 0), n_micro - 1)], act)
        out = _stage_block(w_s, b_s, inp)
        if s_idx == n_stages - 1 and 0 <= m < n_micro:
            ys[m] = out
        act = hand(out)
    last = s_idx == n_stages - 1
    loss, acc = _readout(p, _collect(ys, act, n_micro), h0, y, last)
    return loss, acc, [act], {}


def make_pp_train_step(mesh, optimizer, *, n_micro: int, n_classes: int
                       ) -> PartialsStep:
    """(state, x, y) -> (state, {loss, accuracy}) over the ("dp", "pp")
    mesh; ``x``/``y`` are this rank's dp slice; ``state`` from
    :func:`build_pp_state`."""
    n_dp, n_stages = axis_size(mesh, DP_AXIS), axis_size(mesh, PP_AXIS)
    s_idx = axis_index(mesh, PP_AXIS)
    hand = HandOff(axis_group(mesh, (PP_AXIS,)), ring=False)

    def body(p, x, y):
        assert p["out_w"].shape[1] == n_classes, (p["out_w"].shape,
                                                  n_classes)
        return _pp_body(p, x, y, s_idx=s_idx, n_stages=n_stages,
                        n_micro=n_micro, hand=hand)
    return _partials_train_step(mesh, optimizer, PP_PSPECS, body, n_dp)


def build_pp_state(mesh, optimizer, d_in: int, hidden: int, n_classes: int,
                   layers_per_stage: int, seed: int = 0, device="cuda",
                   params: Optional[Mapping[str, torch.Tensor]] = None):
    """Draw (or take, ``params``: e.g. ``model.params_from_jax``'s) the
    pipeline's parameters and place each rank's stage slice on ``device``
    (this rank's card unless "cpu" is given)."""
    device = resolve_device(device)
    if params is None:
        params = init_pipeline(torch.Generator().manual_seed(seed), d_in,
                               hidden, n_classes, axis_size(mesh, PP_AXIS),
                               layers_per_stage)
    return place_state(params, mesh, PP_PSPECS, optimizer, device)


def flatten_pipeline(params: Mapping[str, torch.Tensor]) -> Tuple:
    """The equivalent single-device stack: in -> S*P dense+relu (H, H)
    layers -> readout (full tensors)."""
    s, p, h, _ = params["pp_w"].shape
    return (params["in_w"], params["in_b"],
            params["pp_w"].reshape(s * p, h, h),
            params["pp_b"].reshape(s * p, h), params["out_w"],
            params["out_b"])


def flat_forward(flat, x: torch.Tensor) -> torch.Tensor:
    """The plain forward of :func:`flatten_pipeline`'s stack."""
    in_w, in_b, ws, bs, out_w, out_b = flat
    h = x.to(in_w.dtype) @ in_w + in_b
    for wi, bi in zip(ws, bs):
        h = torch.relu(h @ wi + bi)
    return h @ out_w + out_b


# -- interleaved ---------------------------------------------------------------
#
# Cell s holds V chunks (s, s + S, ..., s + (V - 1) S of the V*S-chunk layer
# sequence); chunk c of microbatch m runs at tick m + c, and activations ride
# a +1 ring (the S - 1 -> 0 link carries the level-up hop). One active chunk
# per cell per tick needs n_micro <= n_stages.

def init_pipeline_interleaved(gen: torch.Generator, d_in: int, hidden: int,
                              n_classes: int, stages: int, n_virtual: int,
                              layers_per_chunk: int) -> PipeParams:
    """V*S chunk layer stack: pp_w (V, S, P, H, H); chunk (l, s) holds
    layers [(l*S + s) * P, ...) of the flat sequence."""
    v, s, p, h = n_virtual, stages, layers_per_chunk, hidden
    return {"in_w": _he(gen, (d_in, h), d_in), "in_b": torch.zeros(h),
            "pp_w": _he(gen, (v, s, p, h, h), h),
            "pp_b": torch.zeros(v, s, p, h),
            "out_w": _he(gen, (h, n_classes), h),
            "out_b": torch.zeros(n_classes)}


PPI_PSPECS: Dict[str, Spec] = {
    "in_w": (None, None), "in_b": (None,),
    "pp_w": (None, PP_AXIS, None, None, None),
    "pp_b": (None, PP_AXIS, None, None),
    "out_w": (None, None), "out_b": (None,),
}


def _ppi_body(p, x, y, *, s_idx: int, n_stages: int, n_micro: int,
              n_virtual: int, hand: HandOff):
    """This cell's interleaved loss partial: at tick t its chunk is (l,
    s_idx) with r = t - s_idx, l = r // S, m = r % S."""
    w_v, b_v = p["pp_w"][:, 0], p["pp_b"][:, 0]   # (V, P, H, H)
    h0 = x.float() @ p["in_w"] + p["in_b"]
    h_mb = _micro(h0, n_micro)
    act = torch.zeros_like(h_mb[0])
    ys = [None] * n_micro
    for t in range(n_micro - 1 + n_virtual * n_stages):
        r = t - s_idx
        lvl = r // n_stages if r >= 0 else 0
        m = r % n_stages if r >= 0 else 0
        active = r >= 0 and lvl < n_virtual and m < n_micro
        li = min(max(lvl, 0), n_virtual - 1)
        fresh = torch.tensor(s_idx == 0 and lvl == 0, device=h0.device)
        inp = torch.where(fresh, h_mb[min(max(m, 0), n_micro - 1)], act)
        out = _stage_block(w_v[li], b_v[li], inp)
        if active and s_idx == n_stages - 1 and lvl == n_virtual - 1:
            ys[m] = out
        act = hand(out)
    last = s_idx == n_stages - 1
    loss, acc = _readout(p, _collect(ys, act, n_micro), h0, y, last)
    return loss, acc, [act], {}


def make_ppi_train_step(mesh, optimizer, *, n_micro: int, n_virtual: int,
                        n_classes: int) -> PartialsStep:
    """The interleaved-schedule step over ("dp", "pp"). Requires n_micro
    <= n_stages (one active chunk per cell per tick)."""
    n_dp, n_stages = axis_size(mesh, DP_AXIS), axis_size(mesh, PP_AXIS)
    if n_micro > n_stages:
        raise ValueError(
            f"interleaved schedule needs n_micro <= n_stages "
            f"({n_micro} > {n_stages}); use the gpipe schedule there")
    s_idx = axis_index(mesh, PP_AXIS)
    hand = HandOff(axis_group(mesh, (PP_AXIS,)), ring=True)

    def body(p, x, y):
        assert p["out_w"].shape[1] == n_classes
        return _ppi_body(p, x, y, s_idx=s_idx, n_stages=n_stages,
                         n_micro=n_micro, n_virtual=n_virtual, hand=hand)
    return _partials_train_step(mesh, optimizer, PPI_PSPECS, body, n_dp)


def build_ppi_state(mesh, optimizer, d_in: int, hidden: int, n_classes: int,
                    n_virtual: int, layers_per_chunk: int, seed: int = 0,
                    device="cuda", params=None):
    device = resolve_device(device)
    if params is None:
        params = init_pipeline_interleaved(
            torch.Generator().manual_seed(seed), d_in, hidden, n_classes,
            axis_size(mesh, PP_AXIS), n_virtual, layers_per_chunk)
    return place_state(params, mesh, PPI_PSPECS, optimizer, device)


def flatten_interleaved(params: Mapping[str, torch.Tensor]) -> Tuple:
    """The flat stack of the interleaved layout (chunk order (level,
    stage) is the model's layer order)."""
    v, s, p, h, _ = params["pp_w"].shape
    return (params["in_w"], params["in_b"],
            params["pp_w"].reshape(v * s * p, h, h),
            params["pp_b"].reshape(v * s * p, h), params["out_w"],
            params["out_b"])


def schedule_ticks(schedule: str, n_micro: int, n_stages: int,
                   n_virtual: int = 1) -> int:
    """Tick count of each schedule: each tick costs about one stage chunk
    of compute (a full stage for gpipe, a 1/V slice for interleaved)."""
    if schedule == "gpipe":
        return n_micro + n_stages - 1
    if schedule == "interleaved":
        return n_micro - 1 + n_virtual * n_stages
    raise ValueError(f"unknown schedule {schedule!r}")


def bubble_fraction(schedule: str, n_micro: int, n_stages: int,
                    n_virtual: int = 1) -> float:
    """Idle fraction of one cell's pipeline span in stage-work units: the
    useful work is M units; gpipe's span is M + S - 1 ticks of 1 unit,
    interleaved's M - 1 + V*S ticks of 1/V unit, so interleaving divides
    the (S - 1)-shaped fill/drain term by V."""
    span = (schedule_ticks(schedule, n_micro, n_stages, n_virtual)
            / (n_virtual if schedule == "interleaved" else 1))
    return 1.0 - n_micro / span


# -- dp x tp x pp --------------------------------------------------------------
#
# Stage layers come in Megatron column/row pairs: the column-split product
# shards its output dim over "tp", the row-split one its input dim, so each
# pair needs one tp all-reduce; the pp schedule and the dp batch split are
# the 2D form's.

PP3_PSPECS: Dict[str, Spec] = {
    "in_w": (None, None), "in_b": (None,),
    # column-parallel: output dim tp-sharded (bias follows its output)
    "wc": (PP_AXIS, None, None, TP_AXIS),
    "bc": (PP_AXIS, None, TP_AXIS),
    # row-parallel: input dim tp-sharded; bias replicated (added after psum)
    "wr": (PP_AXIS, None, TP_AXIS, None),
    "br": (PP_AXIS, None, None),
    "out_w": (None, None), "out_b": (None,),
}


def init_pipeline3(gen: torch.Generator, d_in: int, hidden: int,
                   n_classes: int, stages: int, pairs_per_stage: int
                   ) -> PipeParams:
    """Col/row layer pairs per stage: h -> relu(h@Wc + bc) -> @Wr (+psum)
    -> relu(+br)."""
    s, p2, h = stages, pairs_per_stage, hidden
    return {"in_w": _he(gen, (d_in, h), d_in), "in_b": torch.zeros(h),
            "wc": _he(gen, (s, p2, h, h), h), "bc": torch.zeros(s, p2, h),
            "wr": _he(gen, (s, p2, h, h), h), "br": torch.zeros(s, p2, h),
            "out_w": _he(gen, (h, n_classes), h),
            "out_b": torch.zeros(n_classes)}


def _stage_block3(wc, bc, wr, br, h, tp_group):
    """One stage's col/row pairs on this tp cell's shard: wc (P2, H, Hl),
    wr (P2, Hl, H); one tp all-reduce a pair."""
    for i in range(wc.shape[0]):
        u = torch.relu(h @ wc[i] + bc[i])
        v = psum(u @ wr[i], tp_group)
        h = torch.relu(v + br[i])
    return h


def _pp3_body(p, x, y, *, s_idx: int, t_idx: int, n_stages: int,
              n_micro: int, hand: HandOff, tp_group):
    """This (dp, tp, pp) cell's pipelined loss partial."""
    wc, bc, wr, br = p["wc"][0], p["bc"][0], p["wr"][0], p["br"][0]
    h0 = x.float() @ p["in_w"] + p["in_b"]
    h_mb = _micro(h0, n_micro)
    first = torch.tensor(s_idx == 0, device=h0.device)
    act = torch.zeros_like(h_mb[0])
    ys = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        m = t - s_idx
        inp = torch.where(first, h_mb[min(max(t, 0), n_micro - 1)], act)
        out = _stage_block3(wc, bc, wr, br, inp, tp_group)
        if s_idx == n_stages - 1 and 0 <= m < n_micro:
            ys[m] = out
        act = hand(out)
    # Nonzero on exactly one (tp, pp) cell per dp row: every tp cell of the
    # last stage holds the same post-psum activations; only tp 0 reports.
    mine = s_idx == n_stages - 1 and t_idx == 0
    loss, acc = _readout(p, _collect(ys, act, n_micro), h0, y, mine)
    return loss, acc, [act], {}


def make_pp3_train_step(mesh, optimizer, *, n_micro: int, n_classes: int
                        ) -> PartialsStep:
    """The step over ("dp", "tp", "pp")."""
    n_dp, n_stages = axis_size(mesh, DP_AXIS), axis_size(mesh, PP_AXIS)
    s_idx, t_idx = axis_index(mesh, PP_AXIS), axis_index(mesh, TP_AXIS)
    hand = HandOff(axis_group(mesh, (PP_AXIS,)), ring=False)
    tp_group = axis_group(mesh, (TP_AXIS,))

    def body(p, x, y):
        assert p["out_w"].shape[1] == n_classes
        return _pp3_body(p, x, y, s_idx=s_idx, t_idx=t_idx,
                         n_stages=n_stages, n_micro=n_micro, hand=hand,
                         tp_group=tp_group)
    return _partials_train_step(mesh, optimizer, PP3_PSPECS, body, n_dp)


def build_pp3_state(mesh, optimizer, d_in: int, hidden: int, n_classes: int,
                    pairs_per_stage: int, seed: int = 0, device="cuda",
                    params=None):
    device = resolve_device(device)
    if params is None:
        params = init_pipeline3(torch.Generator().manual_seed(seed), d_in,
                                hidden, n_classes, axis_size(mesh, PP_AXIS),
                                pairs_per_stage)
    return place_state(params, mesh, PP3_PSPECS, optimizer, device)


def pp3_reference_forward(params: Mapping[str, torch.Tensor],
                          x: torch.Tensor) -> torch.Tensor:
    """The unsharded, unpipelined forward of the 3D step (its oracle)."""
    h = x.to(params["in_w"].dtype) @ params["in_w"] + params["in_b"]
    s, p2 = params["wc"].shape[:2]
    wc = params["wc"].reshape(s * p2, *params["wc"].shape[2:])
    bc = params["bc"].reshape(s * p2, -1)
    wr = params["wr"].reshape(s * p2, *params["wr"].shape[2:])
    br = params["br"].reshape(s * p2, -1)
    for i in range(s * p2):
        u = torch.relu(h @ wc[i] + bc[i])
        h = torch.relu(u @ wr[i] + br[i])
    return h @ params["out_w"] + params["out_b"]


__all__ = [
    "DP_AXIS", "PP_AXIS", "TP_AXIS", "make_axes_mesh", "make_pp_mesh",
    "make_pp3_mesh", "axis_size", "axis_index", "axis_group", "mesh_axes",
    "ParamTable", "place_params", "init_pipeline", "PP_PSPECS",
    "PartialsStep", "place_state", "make_pp_train_step", "build_pp_state",
    "flatten_pipeline", "flat_forward", "init_pipeline_interleaved",
    "PPI_PSPECS", "make_ppi_train_step", "build_ppi_state",
    "flatten_interleaved", "schedule_ticks", "bubble_fraction",
    "PP3_PSPECS", "init_pipeline3", "make_pp3_train_step", "build_pp3_state",
    "pp3_reference_forward",
]
