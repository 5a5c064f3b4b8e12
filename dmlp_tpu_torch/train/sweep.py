"""Weak-scaling sweep: per-rank training throughput against the mesh size
— port of ``dmlp_tpu/train/sweep.py``.

The same per-rank workload runs on growing dp meshes (the first n ranks
of the group, tp = 1): the global batch grows with the dp degree
(``batch_per_chip`` stays fixed), so the dp gradient all-reduce is the
only cost each rung adds, and samples/s/chip flat across the rungs is
perfect weak scaling. samples/s/chip counts ranks: where several ranks
share one card (gloo ranks on one H100), the rungs share its compute and
the record says so (``ranks_share_a_card``), so the decomposition then
describes the port's step and transport, not a multi-card fabric::

    python -m dmlp_tpu_torch.train.sweep --mesh-sizes 1,2,4,8 --steps 20 \\
        --batch-per-chip 256 --dims 64,256,256,10 [--out sweep.jsonl] \\
        [--offload] [--dtype bfloat16|float32] [--device cuda|cpu] \\
        [--backend nccl|gloo]

The CLI starts max(mesh sizes) ranks on this host
(``parallel.distributed.local_cluster``; this process is rank 0, which
writes the JSONL); every rank runs every rung, the ranks past a rung's
size making its mesh with the others and sitting its steps out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch


def sweep_point(n_chips: int, dims: Sequence[int], batch_per_chip: int,
                steps: int, dtype: Optional[str] = "bfloat16",
                offload: bool = False, pool: int = 2,
                device="cuda") -> Optional[dict]:
    """One rung: a dp = n_chips mesh over the first n_chips ranks, global
    batch batch_per_chip * n_chips. Every rank of the group calls it;
    the mesh's ranks return the rung's record, the others None."""
    import torch.distributed as dist

    from dmlp_tpu_torch.train.data import teacher_batches
    from dmlp_tpu_torch.train.loop import (_compute_dtype,
                                           build_sharded_state)
    from dmlp_tpu_torch.train.metrics import throughput_metrics
    from dmlp_tpu_torch.train.model import resolve_device
    from dmlp_tpu_torch.train.sharding import (batch_slice, dp_group,
                                               in_mesh, make_train_mesh)
    from dmlp_tpu_torch.train.step import (global_metrics,
                                           make_offload_train_step,
                                           make_optimizer, make_train_step)

    device = resolve_device(device)
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    if n_chips > ranks:
        raise ValueError(f"need {n_chips} ranks, have {ranks}")
    mesh = make_train_mesh((n_chips, 1), device_type=device.type)
    if not in_mesh(mesh):
        return None
    group = dp_group(mesh)
    batch = batch_per_chip * n_chips
    optimizer = make_optimizer("sgd", 1e-2)
    level = "all" if offload else "none"
    state = build_sharded_state(mesh, dims, optimizer, offload=level,
                                device=device)
    cdtype = _compute_dtype(dtype)
    step_fn = (make_offload_train_step if offload else make_train_step)(
        optimizer, cdtype, group)

    data = teacher_batches(dims[0], dims[-1], batch, seed=1)
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in batch_slice(*next(data), mesh))
               for _ in range(pool)]
    for i in range(2):                       # warm-up
        state, m = step_fn(state, *batches[i % pool])
    global_metrics(m, group)                 # fence
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = step_fn(state, *batches[i % pool])
    global_metrics(m, group)                 # fence
    dt = (time.perf_counter() - t0) / steps

    tm = throughput_metrics(state["params"], batch, dt, n_chips,
                            device=device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    return {
        "n_chips": n_chips,
        "global_batch": batch,
        "samples_per_sec_per_chip": round(tm["samples_per_sec_per_chip"], 1),
        "step_time_ms": round(tm["step_time_ms"], 2),
        "mfu": round(tm["mfu"], 4),
        "dims": list(dims),
        "offload": offload,
        "dtype": dtype or "float32",
        "device": str(device),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "ranks_share_a_card": device.type == "cuda" and n_chips > cards,
    }


def decompose(points: list) -> Optional[dict]:
    """Fitted communication-overhead decomposition across the rungs.

    Weak scaling keeps the per-rank workload constant, so the 1-rank rung
    is the compute-only floor and any step-time growth is collective
    overhead; the dp all-reduce's ring cost scales as 2(n-1)/n * bytes /
    bw, so the model is

        step_ms(n) = t_compute + t_allreduce_full * (n - 1) / n

    fitted by least squares over the rungs; each point gets its raw
    overhead over rung 1. Where the ranks share one card or the CPU, the
    overhead term absorbs their contention as well as the collectives:
    the decomposition then describes the sweep's plumbing, not a
    fabric's scaling."""
    if len(points) < 2:
        return None
    n = np.array([p["n_chips"] for p in points], float)
    t = np.array([p["step_time_ms"] for p in points], float)
    x = (n - 1.0) / n
    a = np.vstack([np.ones_like(x), x]).T
    (t_compute, t_ar), *_ = np.linalg.lstsq(a, t, rcond=None)
    resid = t - a @ np.array([t_compute, t_ar])
    # The compute-only floor: the measured 1-rank rung when present (its
    # comm term is exactly zero), else the fitted intercept.
    ones = [p["step_time_ms"] for p in points if p["n_chips"] == 1]
    base = float(ones[0]) if ones else float(t_compute)
    for p in points:
        p["comm_overhead_ms"] = round(p["step_time_ms"] - base, 2)
        p["comm_fraction"] = round(
            max(p["step_time_ms"] - base, 0.0) / p["step_time_ms"], 4)
    return {"model": "step_ms = t_compute + t_allreduce_full * (n-1)/n",
            "t_compute_ms": round(float(t_compute), 2),
            "t_allreduce_full_ms": round(float(t_ar), 2),
            "max_abs_resid_ms": round(float(np.abs(resid).max()), 2)}


def run_sweep(mesh_sizes: Sequence[int], dims: Sequence[int],
              batch_per_chip: int, steps: int,
              dtype: Optional[str] = "bfloat16", offload: bool = False,
              out=None, device="cuda") -> list:
    """Every rung in turn on every rank; rank 0 streams each rung's line
    to ``out`` as it lands (the largest mesh is where a crash would
    happen, and the earlier rungs must survive it), then the summary."""
    results = []
    for n in mesh_sizes:
        point = sweep_point(n, dims, batch_per_chip, steps, dtype, offload,
                            device=device)
        if point is None:
            continue
        results.append(point)
        if out is not None:
            out.write(json.dumps(point) + "\n")
            out.flush()
    fit = decompose(results)
    if out is not None and fit is not None:
        shared = any(p["ranks_share_a_card"] for p in results)
        cpu = all(p["device"] == "cpu" for p in results)
        out.write(json.dumps({
            "summary": fit,
            "per_rung_comm": [
                {"n_chips": p["n_chips"],
                 "comm_overhead_ms": p["comm_overhead_ms"],
                 "comm_fraction": p["comm_fraction"]}
                for p in results],
            "scope": ("plumbing-only: the ranks share "
                      + ("the host's cores" if cpu else "one card")
                      + ", so samples/s/chip counts ranks and the "
                      "overhead term absorbs their contention as well as "
                      "the collectives; hardware scaling needs one card "
                      "a rank" if shared or cpu else "hardware"),
        }) + "\n")
        out.flush()
    return results


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="dmlp_tpu_torch.train.sweep",
                                description=__doc__.split("\n")[0])
    p.add_argument("--mesh-sizes", default="1,2,4,8")
    p.add_argument("--dims", default="64,256,256,10")
    p.add_argument("--batch-per-chip", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--offload", action="store_true")
    p.add_argument("--out", default=None, help="JSONL output path "
                   "(default: stdout)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (default cuda; raises without a "
                        "card)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="collective backend of the ranks (default: nccl "
                        "on cuda, gloo on cpu)")
    args = p.parse_args(argv)

    import contextlib

    from dmlp_tpu_torch.parallel import distributed as pd
    from dmlp_tpu_torch.train.model import resolve_device

    sizes = [int(s) for s in args.mesh_sizes.split(",")]
    dims = tuple(int(d) for d in args.dims.split(","))
    world = max(sizes)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        group = pd.process_group(auto=True, device=args.device,
                                 backend=args.backend)
    elif world > 1:
        pd.resolve_backend(args.device, args.backend, world)
        group = pd.local_cluster(
            world, ["-m", "dmlp_tpu_torch.train.sweep", *argv],
            device=args.device, backend=args.backend)
    else:
        resolve_device(args.device)      # no card: raise before anything
        group = contextlib.nullcontext()
    root = os.environ.get("RANK", "0") == "0"
    with group, contextlib.ExitStack() as stack:
        out = None
        if root:
            out = stack.enter_context(open(args.out, "w")) if args.out \
                else sys.stdout
        run_sweep(sizes, dims, args.batch_per_chip, args.steps,
                  None if args.dtype == "float32" else args.dtype,
                  args.offload, out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
