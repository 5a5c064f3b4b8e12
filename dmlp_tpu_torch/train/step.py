"""The train step: forward, backward, the dp gradient all-reduce and the
optimizer update — port of ``dmlp_tpu/train/step.py``.

The reference jits a pure step over a ``TrainState`` pytree and lets XLA
insert the dp all-reduce from the parameters' placement. Here the step is
eager and updates the state in place (the reference donates it): the
gradients come from ``torch.autograd.grad``, and the dp sync is the north
star's ``MPI_Allreduce`` made explicit — one ``all_reduce`` (SUM, then a
divide: gloo has no AVG) of each gradient's local shard over the mesh's
"dp" group (:func:`allreduce_grads`). With bf16 compute the weights'
gradients are rounded to bf16 after that sum, as the reference rounds
them (``model.round_weight_grads``). Tensor parallelism lives in the
parameters (``train.sharding``): the tp collectives run inside the
forward and backward.

Metrics. The step returns this rank's loss and accuracy as 0-d tensors,
the means over its dp slice of the batch; :func:`global_metrics` reads
them as the reference's global-batch means (one all-reduce over "dp" when
the host reads them, outside the step).

Optimizers. ``sgd`` is ``torch.optim.SGD(momentum=0.9, dampening=0,
nesterov=False)``, which equals ``optax.sgd(lr, momentum=0.9)`` (the first
step's buffer is the gradient); ``adam`` is ``torch.optim.Adam``'s
update, whose bias corrections are ordered differently from optax's. Both
are written out over the state's own moment tensors, so the moments can
live in pinned host memory (the offload levels) and move with the
parameters.

Host offload (the bench_4 analog, :class:`OffloadStep`): the host-resident
leaves live in pinned host memory; each step copies every layer's leaves
to the card on a side stream ahead of that layer's use (a forward
pre-hook per layer waits for its copy), runs the resident step's own
function on the working copies (bound into the model with
``torch.func.functional_call``), and writes the updated values back into
the pinned buffers on the side stream. The state's ``fence`` is that
write-back's event: whoever reads the host leaves waits on it
(:func:`settle`). On a CPU device the same code runs with host-to-host
copies.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.func import functional_call

from dmlp_tpu_torch.check.sanitize import fenced
from dmlp_tpu_torch.train.model import round_weight_grads

TrainState = Dict[str, Any]  # {"params": MLP, "opt": {...}, "step": int}

MOMENT_NAMES = {"sgd": ("trace",), "adam": ("mu", "nu")}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """SGD with momentum or Adam, updating tensors in place."""

    name: str
    lr: float
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, model) -> Dict[str, Dict[str, torch.Tensor]]:
        """Zero moments, one per parameter and moment name, placed as the
        parameter (a DTensor's moments are DTensors of its placement)."""
        return {m: {name: torch.zeros_like(p.detach())
                    for name, p in model.named_parameters()}
                for m in MOMENT_NAMES[self.name]}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               moments: List[List[torch.Tensor]], count: int) -> None:
        """One step over ``params`` (in place); ``moments[j]`` is the list
        of moment j; ``count`` is the 1-based update number."""
        if self.name == "sgd":
            (trace,) = moments
            for p, g, t in zip(params, grads, trace):
                t.mul_(self.momentum).add_(g)
                p.add_(t, alpha=-self.lr)
            return
        mu, nu = moments
        bc1 = 1 - self.b1 ** count
        bc2_sqrt = math.sqrt(1 - self.b2 ** count)
        for p, g, m, v in zip(params, grads, mu, nu):
            m.lerp_(g, 1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v.sqrt() / bc2_sqrt).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / bc1)


def make_optimizer(name: str = "sgd", lr: float = 1e-2,
                   momentum: float = 0.9) -> Optimizer:
    if name not in MOMENT_NAMES:
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(name, lr, momentum)


def init_state(model, optimizer: Optimizer) -> TrainState:
    """The train state over already-placed parameters, so the moments
    inherit their placement."""
    return {"params": model, "opt": optimizer.init(model), "step": 0,
            "fence": None}


def settle(state: TrainState) -> None:
    """Wait for the state's pending host write-back, if any, before the
    host reads its leaves."""
    fence = state.get("fence")
    if fence is not None:
        with fenced("train.offload_fence"):
            fence.synchronize()
        state["fence"] = None


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def allreduce_grads(grads, group) -> None:
    """The dp gradient sync: each gradient's local shard summed over
    ``group`` and divided by its size, in place; nothing for a group of
    one rank or none."""
    if group is None:
        return
    size = dist.get_world_size(group)
    if size == 1:
        return
    for g in grads:
        local = _local(g)
        # check: comms-model=psum_traffic
        dist.all_reduce(local, op=dist.ReduceOp.SUM, group=group)
        local.div_(size)


def global_metrics(metrics: Dict[str, torch.Tensor],
                   group=None) -> Dict[str, float]:
    """The step's loss and accuracy as the means over the global batch:
    this rank's means averaged over the dp ``group`` (the dp slices are of
    one size)."""
    t = torch.stack([metrics["loss"].float(), metrics["accuracy"].float()])
    if group is not None and dist.get_world_size(group) > 1:
        # check: no-traffic (two floats, the host's loss readout)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t = t / dist.get_world_size(group)
    loss, acc = t.tolist()
    return {"loss": loss, "accuracy": acc}


def _loss_acc(logits: torch.Tensor, y: torch.Tensor):
    loss = F.cross_entropy(logits, y.long())
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc


def make_train_step(optimizer: Optimizer,
                    compute_dtype: Optional[torch.dtype] = None,
                    dp_group=None) -> Callable[..., Tuple[TrainState, Dict]]:
    """(state, x, y) -> (state, {loss, accuracy}): the state updated in
    place. ``x`` and ``y`` are this rank's dp slice of the batch;
    ``dp_group`` is the mesh's "dp" group (None on one rank).

    The offload step calls the same function on working copies:
    ``params`` and ``moments`` (by parameter name, as the state's) are
    the tensors the step computes with and updates in place instead of
    the state's own, and ``before_update`` runs before the update."""

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             params: Optional[Dict[str, torch.Tensor]] = None,
             moments: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
             before_update: Optional[Callable[[], None]] = None):
        model = state["params"]
        names = [n for n, _ in model.named_parameters()]
        if params is None:
            params = dict(model.named_parameters())
            logits = model(x, compute_dtype)
        else:
            logits = functional_call(model, params, (x, compute_dtype))
        moments = state["opt"] if moments is None else moments
        leaves = [params[n] for n in names]
        loss, acc = _loss_acc(logits, y)
        grads = torch.autograd.grad(loss, leaves)
        allreduce_grads(grads, dp_group)
        round_weight_grads(names, grads, compute_dtype)
        if before_update is not None:
            before_update()
        state["step"] += 1
        optimizer.update(leaves, list(grads),
                         [[moments[m][n] for n in names]
                          for m in MOMENT_NAMES[optimizer.name]],
                         state["step"])
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step


class OffloadStep:
    """The host-offload step over a state whose host-resident leaves live
    in (pinned) host memory — the parameters, and the moments too at level
    "all" — computing on the batch's device (see the module docstring):
    the fetch ahead of each layer and the write-back around the resident
    step's own function, so the two agree bit for bit."""

    def __init__(self, optimizer: Optimizer, compute_dtype=None,
                 dp_group=None):
        self.step = make_train_step(optimizer, compute_dtype, dp_group)
        self.device = self.side = None
        self.cuda = False

    def _bind(self, device: torch.device) -> None:
        """The compute device is the batch's (and its side stream)."""
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.side = torch.cuda.Stream(device)

    def _fetch(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Working copies of ``host`` on the device, allocated on the
        compute stream and filled on the side stream."""
        work = {n: torch.empty_like(t, device=self.device)
                for n, t in host.items()}
        with torch.cuda.stream(self.side) if self.cuda \
                else contextlib.nullcontext():
            for n, t in host.items():
                work[n].copy_(t, non_blocking=self.cuda)
        return work

    def _ready(self) -> Optional[torch.cuda.Event]:
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.side)
        return ev

    def _wait(self, ev) -> None:
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    def __call__(self, state: TrainState, x: torch.Tensor, y: torch.Tensor):
        if self.device != x.device:
            self._bind(x.device)
        model = state["params"]
        layers = model.layers()
        host_m = state["opt"]
        moments_on_host = any(t.device != self.device
                              for ms in host_m.values() for t in ms.values())
        if self.cuda:
            # The copies below overwrite memory the compute stream may
            # have used last, and read what the last write-back wrote
            # (issued on the side stream itself).
            self.side.wait_stream(torch.cuda.current_stream(self.device))
        # Layer by layer ahead of use: w and b of layer i, then its event,
        # which the layer's forward pre-hook waits on.
        work, hooks = {}, []
        with torch.no_grad():
            for i, layer in enumerate(layers):
                work.update(self._fetch(
                    {f"layer{i}.{n}": p.detach()
                     for n, p in layer.named_parameters()}))
                ev = self._ready()
                hooks.append(layer.register_forward_pre_hook(
                    lambda _mod, _args, ev=ev: self._wait(ev)))
            work_m = {m: self._fetch(ms) for m, ms in host_m.items()} \
                if moments_on_host else host_m
            moments_ready = self._ready() if moments_on_host else None
        for w in work.values():
            w.requires_grad_(True)
        try:
            state, metrics = self.step(
                state, x, y, params=work, moments=work_m,
                before_update=lambda: self._wait(moments_ready))
        finally:
            for h in hooks:
                h.remove()

        # Write back: the updated working copies into the host buffers.
        with torch.no_grad():
            host_p = dict(model.named_parameters())
            backs = [(host_p, work)]
            if moments_on_host:
                backs += [(host_m[m], work_m[m]) for m in host_m]
            if self.cuda:
                self.side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self.side):
                    for dst, src in backs:
                        for n, s in src.items():
                            dst[n].copy_(s, non_blocking=True)
                            # Freed on the compute stream, read here.
                            s.record_stream(self.side)
                state["fence"] = self._ready()
            else:
                for dst, src in backs:
                    for n, s in src.items():
                        dst[n].copy_(s)
        return state, metrics


def make_offload_train_step(optimizer: Optimizer, compute_dtype=None,
                            dp_group=None) -> OffloadStep:
    """The host-offload step, for a state built by
    ``train.loop.build_sharded_state`` with an offload level. The
    reference also takes the state, for its shardings; here each call's
    state and batch say where the leaves live and where to compute."""
    return OffloadStep(optimizer, compute_dtype, dp_group)
