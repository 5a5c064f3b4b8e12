"""Training-loop CLI — port of ``dmlp_tpu/train/loop.py``.

Runs a sharded train step with JSON metrics (samples/s/chip and MFU), DCP
checkpoints and resume, the NaN guard, spans, fault sites, telemetry and a
RunRecord, under the reference's flag and event names. ``--parallelism``
picks the mesh family: the dp x tp MLP (default; offload levels and the
compute dtype), the dp x pp / dp x tp x pp pipelined stack
(``train.pipeline``), or the dp x ep MoE (``train.experts``)::

    python -m dmlp_tpu_torch.train.loop --steps 200 --batch 4096 \\
        --dims 64,512,512,10 [--mesh DP,TP] [--optimizer sgd|adam]
        [--compute-dtype bfloat16] [--offload [none|params|all]]
        [--checkpoint-dir ckpt --ckpt-every 100] [--resume] [--nan-guard]
        [--metrics-file metrics.jsonl] [--record FILE] [--trace FILE]
        [--telemetry FILE] [--faults FILE] [--device cuda|cpu]
        [--backend nccl|gloo]
    python -m dmlp_tpu_torch.train.loop --parallelism dp_pp --mesh 2,4 \\
        --dims 64,256,10 --microbatches 8 [--pp-schedule interleaved]
    python -m dmlp_tpu_torch.train.loop --parallelism dp_pp3 --mesh 1,2,4 \\
        --dims 64,256,10
    python -m dmlp_tpu_torch.train.loop --parallelism dp_ep --mesh 2,4 \\
        --dims 64,256,512,10 --experts 8 \\
        [--moe-dispatch dense|a2a] [--capacity-factor 1.0]

With more than one rank, ``--mesh`` starts them on this host through
``parallel.distributed.local_cluster`` (this process is rank 0; under
torchrun's environment the process joins as its ``RANK``), as ``python
-m dmlp_tpu_torch --mode sharded`` does. Every rank trains its dp slice
of each batch; rank 0 logs, records and prints ``final: {...}``. NCCL
takes one card per rank; ``--backend gloo`` runs several ranks on one
card (gloo carries the CUDA tensors). The device is ``cuda`` unless
``--device cpu`` is given; without a card the run raises.

The pipeline and MoE families run in f32 without offload, as in the
reference; their flags raise where they do not apply. ``--compile-cache
DIR`` builds and loads the native libraries in DIR (``utils.
compile_cache``), shared with the ranks ``--mesh`` starts. ``--sanitize``
(or ``$DMLP_TPU_SANITIZE=1``) runs every step under
``check.sanitize.sanitized(train=True)``: an implicit host readback
raises, on the card also a synchronizing CUDA operation, and a backward
that produces a NaN raises at the op (``detect_anomaly``).
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.resilience import inject as rs_inject
from dmlp_tpu_torch.resilience import retry as rs_retry
from dmlp_tpu_torch.resilience import stats as rs_stats
from dmlp_tpu_torch.train import checkpoint as ckpt_lib
from dmlp_tpu_torch.train.data import prefetch_to_device, teacher_batches
from dmlp_tpu_torch.train.metrics import throughput_metrics
from dmlp_tpu_torch.train.model import init_mlp, resolve_device
from dmlp_tpu_torch.train.sharding import (apply_tp, dp_group,
                                           make_train_mesh, mesh_dims)
from dmlp_tpu_torch.train.step import (global_metrics, init_state,
                                       make_offload_train_step,
                                       make_optimizer, make_train_step,
                                       settle)
from dmlp_tpu_torch.utils.metrics_log import MetricsLogger

def resolve_offload_level(offload) -> str:
    """Normalize the offload policy: "none" | "params" | "all".

    Bools stay accepted ("all"/"none"), and the env-var style "0"/"1".
    The step streams exactly the host-resident leaves:

    - "none":   everything on the card — fastest, most device memory.
    - "params": parameters in pinned host memory, optimizer moments on the
      card — half the stream bytes of "all".
    - "all":    parameters and moments in pinned host memory — the bench_4
      "host-DRAM param offload" analog, bound by the host link.
    """
    if isinstance(offload, bool) or offload is None:
        return "all" if offload else "none"
    if offload in ("0", "1"):
        return "all" if offload == "1" else "none"
    if offload not in ("none", "params", "all"):
        raise ValueError(f"unknown offload level {offload!r}")
    return offload


def _compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    if compute_dtype in (None, "float32"):
        return None
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unknown compute dtype {compute_dtype!r}")


def build_sharded_state(mesh, dims, optimizer, seed: int = 0,
                        offload=False, device="cuda", params=None):
    """Draw the parameters on the host from ``seed`` (the same on every
    rank) or take them from ``params`` (a state dict such as
    ``model.params_from_jax`` gives), place them (the tp plan over
    ``mesh``, the compute device: this rank's card unless "cpu" is given,
    raising without one), and build the optimizer moments on the placed
    parameters. ``offload`` (:func:`resolve_offload_level`) keeps the
    parameters ("params") or the parameters and moments ("all") in host
    memory, pinned when the device is a card."""
    level = resolve_offload_level(offload)
    device = resolve_device(device)
    if level != "none" and mesh_dims(mesh)[1] > 1:
        raise ValueError("--offload with tp > 1 is not ported: the offload "
                         "step streams whole tensors, not DTensor shards")
    host = level != "none"
    pin = host and device.type == "cuda"
    model = init_mlp(torch.Generator().manual_seed(seed), dims,
                     device="cpu")
    if params is not None:
        model.load_state_dict(params)
    model = apply_tp(model.to("cpu" if host else device), mesh)
    if pin:
        for p in model.parameters():
            p.data = p.data.pin_memory()
    state = init_state(model, optimizer)
    if level == "params":
        state["opt"] = {m: {n: t.to(device) for n, t in ms.items()}
                        for m, ms in state["opt"].items()}
    elif pin:
        state["opt"] = {m: {n: t.pin_memory() for n, t in ms.items()}
                        for m, ms in state["opt"].items()}
    return state


def _ranks() -> int:
    """The ranks of the initialized group (the reference's devices), or
    1 without one."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _build_parallel(parallelism: str, mesh_shape_arg, dims, optimizer,
                    compute_dtype, offload, seed: int, device,
                    n_micro: int = 4, n_experts: int = 8, batch: int = 0,
                    moe_dispatch: str = "dense",
                    capacity_factor: float = 1.0,
                    pp_schedule: str = "gpipe", n_virtual: int = 2):
    """(mesh, state, step_fn, (d_in, n_classes), slicer) for the chosen
    family, after the reference's flag checks. "dp_tp" is the full
    featured default (offload levels, compute dtype); "dp_pp" / "dp_pp3" /
    "dp_ep" run the pipeline and MoE steps: their mesh comes from
    ``--mesh`` (DP,PP / DP,TP,PP / DP,EP; by default every rank on pp or
    ep, (1, 2, ranks / 2) for dp_pp3), their dims are (in, hidden,
    classes) for the pipelines (2 layers, or pairs, per stage) and (in,
    hidden, ffn, classes) for the MoE. ``slicer`` cuts a rank's block out
    of a global batch (None: its dp block)."""
    if moe_dispatch != "dense" and parallelism != "dp_ep":
        raise ValueError(f"--moe-dispatch applies to dp_ep only, "
                         f"not {parallelism}")
    if capacity_factor != 1.0 and not (parallelism == "dp_ep"
                                       and moe_dispatch == "a2a"):
        raise ValueError("--capacity-factor applies to the dp_ep a2a "
                         "dispatch only (dense is capacity-free)")
    if pp_schedule != "gpipe" and parallelism != "dp_pp":
        raise ValueError(f"--pp-schedule applies to dp_pp only, "
                         f"not {parallelism}")
    if n_virtual != 2 and pp_schedule != "interleaved":
        raise ValueError("--virtual-stages applies to the interleaved "
                         "dp_pp schedule only")
    if parallelism == "dp_tp":
        mesh = make_train_mesh(mesh_shape_arg, device_type=device.type)
        state = build_sharded_state(mesh, dims, optimizer, seed,
                                    offload=offload, device=device)
        cdtype = _compute_dtype(compute_dtype)
        if resolve_offload_level(offload) != "none":
            step_fn = make_offload_train_step(optimizer, cdtype,
                                              dp_group(mesh))
        else:
            step_fn = make_train_step(optimizer, cdtype, dp_group(mesh))
        return mesh, state, step_fn, (dims[0], dims[-1]), None

    # The pipeline and MoE families run in f32 without host offload; a
    # flag silently ignored would misattribute a benchmark's numbers.
    if compute_dtype is not None:
        raise ValueError(f"--compute-dtype applies to dp_tp only, "
                         f"not {parallelism}")
    if resolve_offload_level(offload) != "none":
        raise ValueError(f"--offload applies to dp_tp only, "
                         f"not {parallelism}")

    if parallelism in ("dp_pp", "dp_pp3"):
        from dmlp_tpu_torch.train import pipeline as pl
        if len(dims) != 3:
            raise ValueError(f"{parallelism} wants --dims in,hidden,classes")
        d_in, hidden, n_classes = dims
        if parallelism == "dp_pp":
            dp, pp = mesh_shape_arg or (1, _ranks())
            mesh = pl.make_pp_mesh(dp, pp, device.type)
            if pp_schedule == "interleaved":
                # The gpipe branch's model (2 layers a stage): V chunks of
                # 2 / V layers; a V that does not divide 2 would change the
                # depth and make a schedule A/B compare two models.
                lps = 2
                if lps % n_virtual:
                    raise ValueError(
                        f"--virtual-stages must divide the dp_pp model's "
                        f"{lps} layers per stage (got {n_virtual}); deeper "
                        "chunking is a library-API choice "
                        "(pipeline.build_ppi_state)")
                state = pl.build_ppi_state(mesh, optimizer, d_in, hidden,
                                           n_classes, n_virtual=n_virtual,
                                           layers_per_chunk=lps // n_virtual,
                                           seed=seed, device=device)
                step_fn = pl.make_ppi_train_step(mesh, optimizer,
                                                 n_micro=n_micro,
                                                 n_virtual=n_virtual,
                                                 n_classes=n_classes)
                return mesh, state, step_fn, (d_in, n_classes), None
            state = pl.build_pp_state(mesh, optimizer, d_in, hidden,
                                      n_classes, 2, seed=seed, device=device)
            step_fn = pl.make_pp_train_step(mesh, optimizer, n_micro=n_micro,
                                            n_classes=n_classes)
        else:
            dp, tp, pp = mesh_shape_arg or (1, 2, _ranks() // 2)
            mesh = pl.make_pp3_mesh(dp, tp, pp, device.type)
            state = pl.build_pp3_state(mesh, optimizer, d_in, hidden,
                                       n_classes, 2, seed=seed, device=device)
            step_fn = pl.make_pp3_train_step(mesh, optimizer,
                                             n_micro=n_micro,
                                             n_classes=n_classes)
        return mesh, state, step_fn, (d_in, n_classes), None

    if parallelism == "dp_ep":
        from dmlp_tpu_torch.train import experts as ex
        if len(dims) != 4:
            raise ValueError("dp_ep wants --dims in,hidden,ffn,classes")
        d_in, hidden, ffn, n_classes = dims
        dp, ep = mesh_shape_arg or (1, _ranks())
        mesh = ex.make_ep_mesh(dp, ep, device.type)
        state = ex.build_moe_state(mesh, optimizer, d_in, hidden, ffn,
                                   n_classes, n_experts, seed=seed,
                                   device=device)
        if moe_dispatch == "a2a":
            capacity = ex.a2a_capacity(batch, dp, ep, capacity_factor)
            step_fn = ex.make_moe_a2a_train_step(mesh, optimizer,
                                                 n_experts=n_experts,
                                                 n_classes=n_classes,
                                                 capacity=capacity)
            return mesh, state, step_fn, (d_in, n_classes), \
                ex.a2a_batch_slice
        step_fn = ex.make_moe_train_step(mesh, optimizer,
                                         n_experts=n_experts,
                                         n_classes=n_classes)
        return mesh, state, step_fn, (d_in, n_classes), None

    raise ValueError(f"unknown parallelism {parallelism!r}")


def train(steps: int = 100, batch: int = 1024,
          dims: Sequence[int] = (64, 256, 256, 10),
          mesh_shape=None, optimizer_name: str = "sgd", lr: float = 1e-2,
          compute_dtype: Optional[str] = None, seed: int = 0,
          checkpoint_dir: Optional[str] = None, ckpt_every: int = 100,
          resume: bool = False, metrics: Optional[MetricsLogger] = None,
          log_every: int = 10, offload=False, parallelism: str = "dp_tp",
          n_micro: int = 4, n_experts: int = 8,
          moe_dispatch: str = "dense", capacity_factor: float = 1.0,
          pp_schedule: str = "gpipe", n_virtual: int = 2,
          sanitize: bool = False, nan_guard: bool = False,
          lr_backoff: float = 0.5, max_rollbacks: int = 3,
          device="cuda"):
    """Train ``steps`` steps on every rank of the process group (one rank
    without one); returns (state, last log window's metrics). Under a
    group every rank calls it with the same arguments; ``metrics`` given
    on every rank also records the first step's collectives (each rank
    takes part), and rank 0's logger is the one to read."""
    device = resolve_device(device)
    optimizer = make_optimizer(optimizer_name, lr)
    mesh, state, step_fn, (d_in, n_classes), slicer = _build_parallel(
        parallelism, mesh_shape, tuple(dims), optimizer, compute_dtype,
        offload, seed, device, n_micro=n_micro, n_experts=n_experts,
        batch=batch, moe_dispatch=moe_dispatch,
        capacity_factor=capacity_factor, pp_schedule=pp_schedule,
        n_virtual=n_virtual)
    shape = mesh_dims(mesh)
    n_chips = int(np.prod(shape))
    dpg = dp_group(mesh)

    def read_metrics(m):
        """The step's global loss and accuracy (collective on a mesh)."""
        if hasattr(step_fn, "global_metrics"):   # the pipeline/MoE steps
            return step_fn.global_metrics(m)
        return global_metrics(m, dpg)
    start_step = 0
    if resume and checkpoint_dir \
            and ckpt_lib.latest_step(checkpoint_dir) is not None:
        state = ckpt_lib.restore_checkpoint(checkpoint_dir, state)
        start_step = state["step"]

    def make_data(skip: int):
        """The seed-keyed batch stream positioned ``skip`` batches past
        this run's start: a rollback re-creates it so the replayed steps
        consume exactly the batches the first pass did."""
        it = teacher_batches(d_in, n_classes, batch, seed=seed + 1)
        for _ in range(skip):
            next(it)
        return prefetch_to_device(it, device, mesh=mesh, slicer=slicer)

    data = make_data(0)

    # LR backoff rebuilds the step with a decayed LR when the same step
    # gives a non-finite loss twice; the moments carry over. dp_tp only:
    # the pipeline and MoE steps are not rebuilt (a rollback still works
    # there; the escalation raises), as in the reference.
    def rebuild_step(new_lr: float):
        if parallelism != "dp_tp":
            raise RuntimeError(
                f"step {i + 1} diverged twice and LR backoff is "
                f"unsupported for parallelism={parallelism} (dp_tp only)")
        opt2 = make_optimizer(optimizer_name, new_lr)
        cdtype = _compute_dtype(compute_dtype)
        if resolve_offload_level(offload) != "none":
            return make_offload_train_step(opt2, cdtype, dpg)
        return make_train_step(opt2, cdtype, dpg)

    if metrics is not None:
        comms = _train_comms(state, shape, steps, parallelism, dims, batch,
                             moe_dispatch, capacity_factor, n_micro,
                             pp_schedule, n_virtual)
        if comms is not None:
            metrics.log(event="comms", **comms)

    # Every step must be recoverable: seed the directory with the start
    # state when the guard is on and it holds nothing. Every rank looks
    # before any rank writes (the save is collective: a rank that saw the
    # first rank's files would skip it and deadlock the others).
    # Sanitized training: each step under sanitized(train=True); the
    # loop's readbacks (the NaN guard's loss, the log windows) stay
    # outside it, as in the reference.
    from dmlp_tpu_torch.check.sanitize import maybe_sanitized

    def san():  # fresh context per step: @contextmanager cms are one-shot
        return maybe_sanitized(train=True, force=sanitize)

    if nan_guard and checkpoint_dir:
        empty = ckpt_lib.latest_step(checkpoint_dir) is None
        if _ranks() > 1:
            import torch.distributed as dist
            dist.barrier()
        if empty:
            ckpt_lib.save_checkpoint(checkpoint_dir, state, step=start_step)

    last = {}
    hlo_report = None   # the first step's record of its collectives
    t_window = time.perf_counter()
    window_steps = 0
    cur_lr = lr
    total_rollbacks = 0
    rollbacks_at: dict = {}
    end = start_step + steps
    i = start_step
    while i < end:
        xd, yd = next(data)
        record = contextlib.nullcontext()
        if hlo_report is None and metrics is not None:
            # The counterpart of the reference's one-shot lowering: the
            # c10d collectives the first step issues (its time lies in
            # the first log window, as the reference's compile does).
            from dmlp_tpu_torch.obs import hlo as obs_hlo
            from dmlp_tpu_torch.train.pipeline import mesh_axes
            record = obs_hlo.recording(mesh=mesh, device=device,
                                       label="train.step",
                                       axes=mesh_axes(mesh))

        def _step_op():
            # The fire rides inside the retried op: a transient fault is
            # consumed on attempt 1 and the retry's re-run lands. The
            # fault is raised before the step touches the state.
            acts = rs_inject.fire("train.step", step=i) or ()
            with obs_span("train.step"), san():
                s2, m2 = step_fn(state, xd, yd)
            return acts, s2, m2

        with record as recorder:
            actions, state, m = rs_retry.call_with_retry(
                _step_op, "train.step")
        if recorder is not None:
            hlo_report = recorder.report

        if nan_guard:
            # A per-step loss read; an injected "nan" poisons the
            # detector input (every rank runs the same schedule).
            loss_val = (float("nan") if "nan" in actions
                        else read_metrics(m)["loss"])
            if not math.isfinite(loss_val):
                if not checkpoint_dir:
                    raise RuntimeError(
                        f"non-finite loss at step {i + 1} and nowhere "
                        "to roll back to — the NaN guard needs "
                        "checkpoint_dir/--checkpoint-dir")
                total_rollbacks += 1
                rs_stats.record_rollback()
                if total_rollbacks > max_rollbacks:
                    raise RuntimeError(
                        f"non-finite loss persisted through "
                        f"{max_rollbacks} rollback(s) — giving up at "
                        f"step {i + 1}")
                seen = rollbacks_at.get(i, 0)
                rollbacks_at[i] = seen + 1
                if seen >= 1:
                    # Same step diverged twice: replay alone cannot fix a
                    # deterministic divergence — decay the LR.
                    cur_lr *= lr_backoff
                    step_fn = rebuild_step(cur_lr)
                faulted_at = i
                state = ckpt_lib.restore_checkpoint(checkpoint_dir, state)
                i = state["step"]
                if i > faulted_at:
                    raise RuntimeError(
                        f"latest checkpoint is step {i}, AHEAD of the "
                        f"faulted step {faulted_at} — rolling back would "
                        f"jump forward (stale checkpoint_dir "
                        f"{checkpoint_dir!r} from an earlier run?)")
                if i < start_step:
                    raise RuntimeError(
                        f"checkpoint step {i} precedes this run's data "
                        f"stream start {start_step} — cannot replay")
                from dmlp_tpu_torch.obs import trace as obs_trace
                obs_trace.instant("resilience.rollback", to_step=i,
                                  lr=cur_lr)
                data = make_data(i - start_step)
                t_window = time.perf_counter()
                window_steps = 0
                continue

        window_steps += 1
        if (i + 1) % log_every == 0 or i + 1 == end:
            with obs_span("train.log_window", step=i + 1):
                g = read_metrics(m)   # waits for the step
            dt = (time.perf_counter() - t_window) / window_steps
            t_window = time.perf_counter()
            window_steps = 0
            last = {"step": i + 1, "loss": g["loss"],
                    "accuracy": g["accuracy"],
                    **throughput_metrics(state["params"], batch, dt,
                                         n_chips, device=device)}
            if metrics is not None:
                metrics.log(**last)
        if checkpoint_dir and (i + 1) % ckpt_every == 0:
            with obs_span("train.checkpoint", step=i + 1):
                ckpt_lib.save_checkpoint(checkpoint_dir, state, step=i + 1)
        i += 1
    if checkpoint_dir:
        ckpt_lib.save_checkpoint(checkpoint_dir, state, step=end)
    settle(state)
    if metrics is not None and hlo_report is not None:
        metrics.log(**hlo_event(hlo_report))
    return state, last


def hlo_event(report) -> dict:
    """The ``event="hlo"`` line of a step's record: per kind the bytes
    moved and the call count (the reference's keys), per kind and mesh
    axis the bytes (``by_axis``), and the device peak where there is
    one."""
    ev = {"event": "hlo", "fingerprint": report.fingerprint}
    if not report.collectives:
        ev["no_collectives"] = True
    for kind, agg in sorted(report.totals.items()):
        key = kind.replace("-", "_")
        ev[f"{key}_bytes"] = agg["bytes_moved"]
        ev[f"{key}_count"] = agg["count"]
    by_axis: dict = {}
    for op in report.collectives:
        k = f"{op['kind']}@{op['axis']}"
        by_axis[k] = by_axis.get(k, 0) + op["bytes_moved"]
    ev["by_axis"] = by_axis
    if "peak_bytes" in report.memory:
        ev["hlo_peak_bytes"] = report.memory["peak_bytes"]
    return ev


def param_bytes(model) -> int:
    """Global parameter bytes (a DTensor counts its global shape)."""
    return int(sum(p.numel() * p.element_size() for p in model.parameters()))


def _train_comms(state, shape, steps: int, parallelism: str = "dp_tp",
                 dims=(), batch: int = 0, moe_dispatch: str = "dense",
                 capacity_factor: float = 1.0, n_micro: int = 4,
                 pp_schedule: str = "gpipe", n_virtual: int = 1
                 ) -> Optional[dict]:
    """``obs.comms`` summary of this run's collective paths from the real
    mesh and parameter shapes (the reference's terms): the dp gradient
    all-reduce, the MoE all-to-all or the dense ep combine, the
    pipeline's hand-off and the dp_pp3 stages' tp all-reduce; None when
    the run issues none."""
    from dmlp_tpu_torch.obs import comms as obs_comms
    moe = moe_dense = pipeline = None
    if parallelism == "dp_ep" and moe_dispatch == "a2a":
        from dmlp_tpu_torch.train.experts import a2a_capacity
        dp, ep = shape
        moe = {"ep": ep, "hidden": dims[1],
               "capacity": a2a_capacity(batch, dp, ep, capacity_factor)}
    elif parallelism == "dp_ep":
        # The dense dispatch's combine: one ep all-reduce of the (dp-local
        # tokens, hidden) partials a step.
        dp, ep = shape
        moe_dense = {"ep": ep, "hidden": dims[1],
                     "tokens": max(batch // dp, 1)}
    if parallelism in ("dp_pp", "dp_pp3"):
        # The hand-off as the step issues it: each dp cell's (micro_rows,
        # hidden) f32 blocks, independently per (dp[, tp]) cell group.
        dp, pp = shape[0], shape[-1]
        sched = pp_schedule if parallelism == "dp_pp" else "gpipe"
        pipeline = {"pp": pp, "n_micro": n_micro,
                    "micro_rows": max(batch // dp // max(n_micro, 1), 1),
                    "hidden": dims[1], "schedule": sched,
                    "n_virtual": n_virtual if sched == "interleaved" else 1,
                    "n_groups": int(np.prod(shape[:-1]))}
        if parallelism == "dp_pp3":
            # One tp all-reduce per col/row pair, 2 pairs a stage.
            pipeline["tp"] = shape[1]
            pipeline["n_pairs"] = 2
    traffic = obs_comms.train_step_comms(param_bytes(state["params"]),
                                         shape, steps=steps, moe=moe,
                                         pipeline=pipeline,
                                         moe_dense=moe_dense)
    return obs_comms.summarize(traffic) if traffic else None


def _params_checksum(state) -> str:
    """sha256 over the parameter leaves in the reference's order (its
    pytree's sorted keys: layer names, then "b", "w"; the stacked
    families' names), each as its shape's ``str``, its numpy dtype's
    ``str`` and its bytes, so the same parameters hash equal in both
    packages. Collective for a sharded state (every rank gathers each
    full leaf)."""
    import hashlib

    from dmlp_tpu_torch.train.sharding import full_tensor

    settle(state)
    leaves = dict(state["params"].named_parameters())
    h = hashlib.sha256()
    for name in sorted(leaves, key=lambda n: tuple(n.split("."))):
        with torch.no_grad():
            t = full_tensor(leaves[name].detach())
        a = np.ascontiguousarray(t.cpu().numpy())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


#: ``--mesh``'s form per family
MESH_FORMS = {"dp_tp": "DP,TP", "dp_pp": "DP,PP", "dp_pp3": "DP,TP,PP",
              "dp_ep": "DP,EP"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dmlp_tpu_torch.train.loop",
                                description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--dims", type=str, default="64,256,256,10",
                   help="comma-separated layer dims: in,hidden...,classes "
                        "(dp_pp/dp_pp3: in,hidden,classes; dp_ep: "
                        "in,hidden,ffn,classes)")
    p.add_argument("--mesh", type=str, default=None,
                   help="DP,TP (dp_tp) / DP,PP (dp_pp) / DP,TP,PP "
                        "(dp_pp3) / DP,EP (dp_ep): the product of the "
                        "dims is the ranks started on this host")
    p.add_argument("--parallelism", default="dp_tp",
                   choices=["dp_tp", "dp_pp", "dp_pp3", "dp_ep"],
                   help="mesh-parallelism family: dp x tp MLP (default; "
                        "full feature set), dp x pp / dp x tp x pp "
                        "pipelined stack, dp x ep MoE")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches per step (dp_pp/dp_pp3)")
    p.add_argument("--pp-schedule", default="gpipe",
                   choices=["gpipe", "interleaved"],
                   help="dp_pp schedule: gpipe, or interleaved virtual "
                        "stages (bubble / V, needs microbatches <= PP)")
    p.add_argument("--virtual-stages", type=int, default=2,
                   help="interleaved schedule: stage chunks per pp cell")
    p.add_argument("--experts", type=int, default=8,
                   help="MoE expert count (dp_ep; divisible by EP)")
    p.add_argument("--moe-dispatch", default="dense",
                   choices=["dense", "a2a"],
                   help="dp_ep dispatch: dense one-hot (capacity-free, "
                        "masked compute) or capacity + all-to-all (tokens "
                        "routed to the expert-owning ranks, overflow to "
                        "the residual path)")
    p.add_argument("--capacity-factor", type=float, default=1.0,
                   help="a2a capacity factor: per-(source, destination) "
                        "slots = ceil(cf * local_tokens / EP); cf >= EP "
                        "guarantees zero drops")
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--compute-dtype", default=None,
                   choices=[None, "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--metrics-file", default=None)
    p.add_argument("--record", metavar="FILE", default=None,
                   help="write one RunRecord (obs.run) summarizing the run")
    p.add_argument("--trace", metavar="FILE", default=None,
                   help="write a Chrome-trace JSON of the run's spans")
    p.add_argument("--telemetry", metavar="FILE", default=None,
                   help="live telemetry: periodic OpenMetrics snapshot of "
                        "FILE and the crash flight recorder")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--sanitize", action="store_true",
                   help="run every step under check.sanitize (implicit "
                        "host readbacks and NaN-producing backwards "
                        "raise); $DMLP_TPU_SANITIZE=1 enables it too")
    p.add_argument("--nan-guard", action="store_true",
                   help="per-step non-finite-loss guard: restore the "
                        "latest checkpoint, replay the stream step for "
                        "step, decay the LR (x0.5) if the same step "
                        "diverges twice (needs --checkpoint-dir)")
    p.add_argument("--faults", metavar="FILE", default=None,
                   help="fault-injection schedule (JSON; "
                        "resilience.inject); $DMLP_TPU_FAULTS sets it too")
    p.add_argument("--offload", nargs="?", const="all", default="none",
                   choices=["none", "params", "all"],
                   help="host-memory offload level ('params': moments on "
                        "the card; bare --offload means 'all')")
    p.add_argument("--compile-cache", metavar="DIR", default=None,
                   help="build directory of the native libraries "
                        "(utils.compile_cache; raises when unusable); "
                        "$DMLP_TPU_COMPILE_CACHE is the ambient form")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (default cuda; raises without a "
                        "card)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="collective backend of a multi-rank --mesh "
                        "(default: nccl on cuda, gloo on cpu)")
    return p


def main(argv=None) -> int:
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    from dmlp_tpu_torch.utils.compile_cache import enable_from_flag
    enable_from_flag(args.compile_cache)
    mesh_shape_arg = None
    if args.mesh:
        mesh_shape_arg = tuple(int(d) for d in args.mesh.split(","))
        want = 3 if args.parallelism == "dp_pp3" else 2
        if len(mesh_shape_arg) != want:
            raise ValueError(
                f"--mesh wants {MESH_FORMS[args.parallelism]} for "
                f"{args.parallelism}, got {args.mesh!r}")
    from dmlp_tpu_torch.parallel import distributed as pd
    world = 1 if mesh_shape_arg is None else int(np.prod(mesh_shape_arg))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        group = pd.process_group(auto=True, device=args.device,
                                 backend=args.backend)
    elif world > 1:
        pd.resolve_backend(args.device, args.backend, world)
        group = pd.local_cluster(
            world, ["-m", "dmlp_tpu_torch.train.loop", *argv],
            device=args.device, backend=args.backend)
    else:
        resolve_device(args.device)     # no card: raise before anything
        group = contextlib.nullcontext()
    with group:
        return _run(args, mesh_shape_arg)


def _run(args, mesh_shape_arg) -> int:
    """Every rank: the run under the group; rank 0 writes and prints."""
    root = os.environ.get("RANK", "0") == "0"
    dims = [int(d) for d in args.dims.split(",")]
    rs_stats.reset()
    tracer = session = None
    if root and args.device == "cuda":
        # The record's memory leg reads this run's peak.
        torch.cuda.reset_peak_memory_stats()
    if root and args.telemetry:
        from dmlp_tpu_torch.obs import telemetry
        session = telemetry.start(path=args.telemetry, device=args.device)
    if root and args.trace:
        from dmlp_tpu_torch.obs import trace as obs_trace
        tracer = obs_trace.install(obs_trace.Tracer())
    schedule = rs_inject.install_from_env(args.faults)
    final_state = None
    try:
        with contextlib.ExitStack() as stack:
            if not root:
                metrics = MetricsLogger(
                    stream=stack.enter_context(open(os.devnull, "w")))
            elif args.metrics_file:
                metrics = stack.enter_context(
                    MetricsLogger(path=args.metrics_file))
            else:
                metrics = MetricsLogger()
            final_state, last = train(
                steps=args.steps, batch=args.batch, dims=tuple(dims),
                mesh_shape=mesh_shape_arg, optimizer_name=args.optimizer,
                lr=args.lr, compute_dtype=args.compute_dtype,
                seed=args.seed, checkpoint_dir=args.checkpoint_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                metrics=metrics, log_every=args.log_every,
                offload=args.offload, parallelism=args.parallelism,
                n_micro=args.microbatches, n_experts=args.experts,
                moe_dispatch=args.moe_dispatch,
                capacity_factor=args.capacity_factor,
                pp_schedule=args.pp_schedule,
                n_virtual=args.virtual_stages, nan_guard=args.nan_guard,
                device=args.device)
        checksum = _params_checksum(final_state)   # every rank takes part
        ranks = _rank_report(final_state) if args.record else None
    except Exception:
        # A usage error's SystemExit is not a crash.
        if session is not None:
            from dmlp_tpu_torch.obs import telemetry
            telemetry.dump_on_crash("crash")
        raise
    finally:
        if schedule is not None:
            rs_inject.write_log_if_requested()
            rs_inject.uninstall()
        if tracer is not None:
            from dmlp_tpu_torch.obs import trace as obs_trace
            tracer.write(args.trace)
            obs_trace.uninstall()
        if session is not None:
            session.close()
    if not root:
        return 0
    if args.record:
        _write_record(args, dims, mesh_shape_arg, last, checksum, ranks,
                      session, schedule)
    print(f"final: {last}", flush=True)
    return 0


def _rank_report(state):
    """Every rank's parameter device, local parameter bytes and custom
    kernel launches (this process's counts), gathered to rank 0
    (collective under a group)."""
    import torch.distributed as dist

    from dmlp_tpu_torch import kernels
    from dmlp_tpu_torch.parallel.collectives import gather_objects
    from dmlp_tpu_torch.train.sharding import local_param_bytes
    mine = {"rank": int(os.environ.get("RANK", "0")),
            "device": str(next(state["params"].parameters()).device),
            "local_param_bytes": local_param_bytes(state["params"]),
            "kernel_launches": dict(kernels.LAUNCHES)}
    return gather_objects(mine) if dist.is_initialized() else [mine]


def _write_record(args, dims, mesh_shape_arg, last, checksum, ranks,
                  session, schedule) -> None:
    from dmlp_tpu_torch.obs import memwatch
    from dmlp_tpu_torch.obs.run import (RunRecord, current_device,
                                        round_from_name)
    artifacts = {}
    if args.trace:
        artifacts["trace"] = args.trace
    if args.metrics_file:
        artifacts["metrics"] = args.metrics_file
    rec_metrics = dict(last)
    # The analytic per-rank peak of the step (obs.memwatch) against the
    # allocator's peak, with the explicit marker on the CPU.
    model = memwatch.train_step_model(
        dims, args.batch, optimizer=args.optimizer,
        mesh_shape=mesh_shape_arg, compute_dtype=args.compute_dtype)
    measured = (session.sampler.measured_peak() if session is not None
                else memwatch.peak_watermark(args.device))
    rec_metrics["mem"] = memwatch.reconcile(model, measured)
    # The bitwise state fingerprint: a NaN-faulted run that resumed step
    # for step prints the fault-free run's.
    rec_metrics["params_checksum"] = checksum
    rec_metrics["ranks"] = ranks
    if rs_stats.any_activity() or schedule is not None:
        rec_metrics["resilience"] = rs_stats.snapshot()
    RunRecord(
        kind="train", tool="dmlp_tpu_torch.train",
        config={"parallelism": args.parallelism, "dims": dims,
                "batch": args.batch, "steps": args.steps,
                "mesh": mesh_shape_arg and list(mesh_shape_arg),
                "optimizer": args.optimizer,
                "compute_dtype": args.compute_dtype,
                "offload": args.offload,
                "moe_dispatch": args.moe_dispatch,
                "pp_schedule": args.pp_schedule,
                "nan_guard": args.nan_guard, "device": args.device,
                "backend": args.backend},
        metrics=rec_metrics, artifacts=artifacts,
        device=current_device(args.device),
        round=round_from_name(args.record)).write(args.record)


if __name__ == "__main__":
    import sys
    sys.exit(main())
