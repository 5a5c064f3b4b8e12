"""Training benchmark: measured samples/s/chip and MFU — port of
``dmlp_tpu/train/bench.py``.

``train_bench()`` runs the dp x tp train step at a matmul-heavy shape and
returns the measured throughput as one JSON-able dict, with the
reference's keys and the card's name as ``device_kind``. Batches come
from a small device-resident pool cycled over the steps: the benchmark
times the step (forward, backward, update and the dp gradient sync), not
the host link. The step is timed between ``torch.cuda.synchronize()``
fences after 3 warm-up steps.

Env knobs (the reference's): TRAIN_DIMS ("1024,8192,8192,1024"),
TRAIN_BATCH (8192; 32768 with offload), TRAIN_STEPS (30), TRAIN_POOL (4),
TRAIN_DTYPE ("bfloat16" | "float32"), TRAIN_MESH ("DP,TP": needs a
process group of that many ranks), TRAIN_OFFLOAD ("none" | "params" |
"all" | "0" | "1")::

    python -m dmlp_tpu_torch.train.bench [--device cuda|cpu]
"""

from __future__ import annotations

import os
import time

import torch


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_bench(device="cuda") -> dict:
    from dmlp_tpu_torch.train.data import teacher_batches
    from dmlp_tpu_torch.train.loop import (build_sharded_state,
                                           resolve_device,
                                           resolve_offload_level)
    from dmlp_tpu_torch.train.metrics import (peak_flops_per_chip,
                                              throughput_metrics)
    from dmlp_tpu_torch.train.sharding import (batch_slice, dp_group,
                                               make_train_mesh, mesh_dims)
    from dmlp_tpu_torch.train.step import (global_metrics,
                                           make_offload_train_step,
                                           make_optimizer, make_train_step,
                                           settle)

    device = resolve_device(device)
    offload = resolve_offload_level(os.environ.get("TRAIN_OFFLOAD", "0"))
    dims = tuple(int(d) for d in os.environ.get(
        "TRAIN_DIMS", "1024,8192,8192,1024").split(","))
    # Offload streams the f32 parameters (and at "all" the moments) each
    # way every step; 4x the batch gives the step enough products to
    # cover the streams (the reference's choice).
    batch = _env_int("TRAIN_BATCH", 32768 if offload != "none" else 8192)
    steps = _env_int("TRAIN_STEPS", 30)
    pool = _env_int("TRAIN_POOL", 4)
    dtype = os.environ.get("TRAIN_DTYPE", "bfloat16")
    mesh_shape = None
    if os.environ.get("TRAIN_MESH"):
        dp, tp = os.environ["TRAIN_MESH"].split(",")
        mesh_shape = (int(dp), int(tp))

    mesh = make_train_mesh(mesh_shape, device_type=device.type)
    shape = mesh_dims(mesh)
    n_chips = shape[0] * shape[1]
    optimizer = make_optimizer("sgd", 1e-2)
    state = build_sharded_state(mesh, dims, optimizer, offload=offload,
                                device=device)
    cdtype = torch.bfloat16 if dtype == "bfloat16" else None
    if offload != "none":
        step_fn = make_offload_train_step(optimizer, cdtype, dp_group(mesh))
    else:
        step_fn = make_train_step(optimizer, cdtype, dp_group(mesh))

    data = teacher_batches(dims[0], dims[-1], batch, seed=1)
    batches = []
    for _ in range(pool):
        x, y = batch_slice(*next(data), mesh)
        batches.append((torch.from_numpy(x).to(device),
                        torch.from_numpy(y).to(device)))

    for i in range(3):   # warm-up: cuBLAS handles, the allocator's pools
        state, m = step_fn(state, *batches[i % pool])
        if i == 0:
            first_loss = global_metrics(m, dp_group(mesh))["loss"]
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = step_fn(state, *batches[i % pool])
    _sync(device)
    dt = (time.perf_counter() - t0) / steps
    settle(state)
    loss = global_metrics(m, dp_group(mesh))["loss"]

    tm = throughput_metrics(state["params"], batch, dt, n_chips,
                            device=device)
    peak = peak_flops_per_chip(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    out = {
        "metric": "train_samples_per_sec_per_chip",
        "value": round(tm["samples_per_sec_per_chip"], 1),
        "unit": "samples/s/chip",
        # No measured reference baseline exists for training; progress
        # against the north star's >= 40% MFU target instead.
        "vs_baseline": round(tm["mfu"] / 0.40, 3),
        "mfu": round(tm["mfu"], 4),
        "step_time_ms": round(tm["step_time_ms"], 2),
        "model_tflops_per_step": round(tm["model_flops_per_step"] / 1e12, 3),
        "peak_tflops_per_chip": round(peak / 1e12, 1),
        "final_loss": round(loss, 4),
        "first_loss": round(first_loss, 4),
        "shape": {"dims": list(dims), "batch": batch, "steps": steps,
                  "dtype": dtype, "n_chips": int(n_chips),
                  "offload": offload, "device_kind": kind,
                  "mode": "train"},
    }
    if device.type == "cuda":
        out["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return out


def main(argv=None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(prog="dmlp_tpu_torch.train.bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    print(json.dumps(train_bench(args.device)))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
