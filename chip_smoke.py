#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``dmlp_tpu_torch``).

Run from the root of the repository on a machine with one CUDA card::

    python3 chip_smoke.py

It imports nothing of JAX or ``dmlp_tpu`` and catches no phase's failure:
any failed build, launch or check ends it with a non-zero exit code and no
final result line. Standard output:

1. the card's name and power limit, as ``nvidia-smi --query-gpu=name,
   power.limit --format=csv,noheader`` prints them;
2. one JSON line per phase —
   ``build``: every kernel of the path built from the sources in the
   checkout (one nvcc per source, all started together), with its time;
   ``kernel_case``: the CUDA kernel held against its plain PyTorch version
   on the card (lists under ``ops.extract.compare_lists``' tolerance,
   ``iters`` exactly, gate on against gate off bit for bit), with CUDA-event
   times (median of several launches after a warm-up) at the shapes the
   main path gives it;
   ``main_path``: bench config 4 (200,000 x 10,000 x 64, k in 1..32,
   10 labels, seed 42) generated by the port's datagen and solved through
   ``dmlp_tpu_torch.cli.main(["--pallas"])`` twice — with
   ``DMLP_TPU_FUSED=0`` (the ungated kernel, K2; this run is also the
   warm-up) and as shipped (the gated kernel, K1) — each with the launch
   counts set to 0 just before it and read just after; both outputs must
   hold 10,000 checksum lines, agree, and match the port's float64 oracle
   (``golden.fast``) on a seeded subset of 1,000 queries byte for byte;
   ``profile``: the shipped solve's timed region once more under
   torch.profiler — device time by kernel, device busy time, idle share;
3. one ``{"kernels": [...]}`` line: per kernel its route, source, the TPU
   kernel it replaces, main-path launches, max error, time, plain time,
   the bound (bytes over 3.35 TB/s or operations over the peak for their
   type, whichever is larger) and the library time (none: no single
   PyTorch call computes this function);
4. ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--phases`` and ``--reps`` narrow a run while developing; the default runs
everything.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth,
# float32 on the CUDA cores, bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}

CONFIG4 = dict(num_data=200_000, num_queries=10_000, num_attrs=64,
               attr_min=0.0, attr_max=100.0, min_k=1, max_k=32,
               num_labels=10, seed=42)
REPLACES = {"fused_topk": "dmlp_tpu/ops/pallas_fused.py:108",
            "extract_topk": "dmlp_tpu/ops/pallas_extract.py:390"}
SOURCE = "dmlp_tpu_torch/kernels/extract_topk.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int):
    """Median CUDA-event time of ``fn()`` over ``reps`` launches after one
    warm-up; returns (ms, last result)."""
    import torch
    out = fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], out


def phase_build():
    from dmlp_tpu_torch import kernels
    t0 = time.perf_counter()
    info = kernels.build_all()
    ms = (time.perf_counter() - t0) * 1e3
    libs = {}
    for name, rec in info.items():
        ptxas = [ln.strip() for ln in rec["log"].splitlines()
                 if "Used" in ln or "spill" in ln]
        libs[name] = {"built": rec["built"], "ptxas": ptxas[:16]}
        kernels.load(name)
    emit({"phase": "build", "ms": ms, "libraries": libs})


def kernel_cases(reps: int):
    """Hold K1/K2 against the plain version; returns per-kernel records
    for the summary line (taken from the main path's carried f32 case)."""
    import torch
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine import single
    from dmlp_tpu_torch.ops import extract as ex

    dev = torch.device("cuda")
    cfg = EngineConfig(use_pallas=True)
    na = CONFIG4["num_attrs"]
    _, _, chunk_rows = single.plan_chunks(
        CONFIG4["num_data"], cfg.resolve_granule("extract"), None)
    qb = single.round_up(CONFIG4["num_queries"], ex.QUERY_TILE)
    kc = single.resolve_kcap(cfg, CONFIG4["max_k"], "extract", 1 << 30)
    gen = torch.Generator(device=dev)

    def uniform(shape, seed, hi=100.0, integer=False):
        gen.manual_seed(seed)
        if integer:
            return torch.randint(0, int(hi), shape, generator=gen,
                                 device=dev).float()
        return torch.rand(shape, generator=gen, device=dev) * hi

    summary = {}

    def run_case(name, q, d, *, n_real, id_base, kc, carry=None,
                 precision="f32", d_prev=None, main=False):
        cd, ci = carry if carry is not None else (None, None)
        kw = dict(n_real=n_real, id_base=id_base, kc=kc,
                  precision=precision)
        qn = (q * q).sum(-1)
        dn_all = (d * d).sum(-1) if d_prev is None else \
            torch.cat([(d * d).sum(-1), (d_prev * d_prev).sum(-1)])
        tol = ex.list_tolerance(qn, float(dn_all.max()), q.shape[1],
                                precision)
        outs = {}
        for gate in (True, False):
            kname = "fused_topk" if gate else "extract_topk"
            ms, (od, oi, it) = time_ms(lambda: ex.extract_topk(
                q, d, cd, ci, mxu_gate=gate, **kw), reps)
            plain_ms, (pd, pi, pit) = time_ms(lambda: ex.extract_topk_plain(
                q, d, cd, ci, mxu_gate=gate, **kw), max(1, reps // 2))
            torch.cuda.synchronize()
            cmp = ex.compare_lists(od, oi, pd, pi, tol)
            iters_equal = bool(torch.equal(it, pit))
            outs[gate] = (od, oi, it)
            rec = {"phase": "kernel_case", "case": name, "kernel": kname,
                   "shape": [q.shape[0], d.shape[0], q.shape[1], kc],
                   "precision": precision, "carry": carry is not None,
                   "n_real": n_real, "id_base": id_base, "ms": ms,
                   "plain_ms": plain_ms, "max_abs_err": cmp["max_abs_err"],
                   "bad_dist_rows": cmp["bad_dist_rows"],
                   "bad_id_rows": cmp["bad_id_rows"],
                   "iters_equal": iters_equal,
                   "tiles_processed": int(it.sum()),
                   "tiles": it.numel()}
            emit(rec)
            check(cmp["ok"], f"{name}/{kname}: kernel disagrees with the "
                             f"plain version {cmp}")
            check(iters_equal, f"{name}/{kname}: iters differ from the "
                               "plain version's")
            s = summary.setdefault(kname, {"max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], cmp["max_abs_err"])
            if main:
                s.update(ms=ms, plain_ms=plain_ms,
                         bound=bound(q, d, kc, it, gate, carry is not None,
                                     precision))
        same = torch.equal(outs[True][0], outs[False][0]) \
            and torch.equal(outs[True][1], outs[False][1])
        emit({"phase": "kernel_gate_identity", "case": name,
              "identical": bool(same)})
        check(same, f"{name}: gate on and gate off lists differ")
        return outs[True]

    # Config-4 chunk shape, as the main path launches it.
    q = uniform((qb, na), 1)
    q[CONFIG4["num_queries"]:] = 0.0      # the engine's zero query padding
    d0, d1 = uniform((chunk_rows, na), 2), uniform((chunk_rows, na), 3)
    for prec in ("f32", "bf16"):
        first = run_case(f"config4_fresh_{prec}", q, d0, n_real=chunk_rows,
                         id_base=0, kc=kc, precision=prec)
        run_case(f"config4_carried_{prec}", q, d1, n_real=chunk_rows,
                 id_base=chunk_rows, kc=kc, carry=first[:2],
                 precision=prec, d_prev=d0, main=prec == "f32")
    # The widest list the kernel takes.
    run_case("kc512", q[:2048].contiguous(), d0, n_real=chunk_rows,
             id_base=0, kc=512)
    # Duplicate-heavy tie grid: integer attrs in [0, 3), exact f32 sums.
    qt, dt = uniform((1024, na), 4, 3, True), uniform((8192, na), 5, 3, True)
    run_case("tie_grid", qt, dt, n_real=8192, id_base=0, kc=kc)
    # A ragged final chunk with a non-zero id base and a carry.
    qr, dr0, dr1 = (uniform((1000, na), 6), uniform((8192, na), 7),
                    uniform((8192, na), 8))
    first = ex.extract_topk_plain(qr, dr0, n_real=8192, id_base=0, kc=kc)
    run_case("ragged_id_base", qr, dr1, n_real=5000, id_base=123456,
             kc=kc, carry=first[:2], d_prev=dr0)
    emit({"phase": "kernels", "kernels_held": sorted(summary)})
    return summary


def bound(q, d, kc, iters, gate, carried, precision):
    """Least time for this launch's work: the larger of the bytes over
    HBM bandwidth (inputs read once, outputs written once) and the
    products this data needs over the peak for their type (with the gate
    on, only the tiles the gate let through)."""
    from dmlp_tpu_torch.ops import extract as ex
    qb, na = q.shape
    b = d.shape[0]
    nbytes = 4 * (qb * na + b * na) + 8 * qb * kc * (2 if carried else 1) \
        + 4 * iters.numel()
    ops = 2.0 * na * (ex.QUERY_TILE * ex.BLOCK_ROWS * int(iters.sum())
                      if gate else qb * b)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[precision]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main_path():
    """Config 4 through the CLI, K2 (warm-up) then K1; returns launches."""
    import numpy as np
    import torch
    from dmlp_tpu_torch import cli
    from dmlp_tpu_torch.golden.fast import knn_golden_fast
    from dmlp_tpu_torch.io.grammar import parse_input_text, subset_queries
    from dmlp_tpu_torch.io.report import format_results
    from dmlp_tpu_torch.ops import extract as ex

    t0 = time.perf_counter()
    c = CONFIG4
    text = config4_text()
    gen_ms = (time.perf_counter() - t0) * 1e3

    runs = {}
    for label, fused in (("K2_warmup", "0"), ("K1_timed", "1")):
        os.environ["DMLP_TPU_FUSED"] = fused
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        ex.reset_launch_counts()
        rc = cli.main(["--pallas", "--phase-times"], stdin=io.StringIO(text),
                      stdout=out, stderr=err)
        launches = dict(ex.LAUNCHES)
        check(rc == 0, f"{label}: cli.main returned {rc}")
        lines = err.getvalue().splitlines()
        m = re.fullmatch(r"Time taken: (\d+) ms", lines[0])
        check(m is not None, f"{label}: stderr line {lines[0]!r}")
        phases = {ln.split(":")[0][len("phase "):]: float(
            ln.split(":")[1].split()[0]) for ln in lines[1:]
            if ln.startswith("phase ")}
        repairs = [int(ln.split()[1]) for ln in lines
                   if ln.startswith("repairs: ")]
        runs[label] = (out.getvalue(), launches)
        emit({"phase": "main_path", "run": label,
              "DMLP_TPU_FUSED": fused, "time_taken_ms": int(m.group(1)),
              "phases_ms": phases, "repairs": repairs[0],
              "launches": launches,
              "stdout_lines": out.getvalue().count("\n")})
    os.environ.pop("DMLP_TPU_FUSED")

    k2_out, k2_launch = runs["K2_warmup"]
    k1_out, k1_launch = runs["K1_timed"]
    check(k1_launch["fused_topk"] > 0 and k1_launch["extract_topk"] == 0,
          f"the shipped path did not run the gated kernel: {k1_launch}")
    check(k2_launch["extract_topk"] > 0 and k2_launch["fused_topk"] == 0,
          f"DMLP_TPU_FUSED=0 did not run the ungated kernel: {k2_launch}")
    lines = k1_out.splitlines()
    check(len(lines) == c["num_queries"] and all(
        re.fullmatch(r"Query \d+ checksum: \d+", ln) for ln in lines),
        "stdout is not 10,000 checksum lines")
    check(k1_out == k2_out, "gated and ungated solves print different "
                            "results")

    t0 = time.perf_counter()
    inp = parse_input_text(text)
    idx = np.sort(np.random.default_rng(c["seed"]).choice(
        c["num_queries"], 1000, replace=False))
    ref = knn_golden_fast(subset_queries(inp, idx))
    for j, r in enumerate(ref):
        r.query_id = int(idx[j])
    want = format_results(ref)
    got = "".join(lines[i] + "\n" for i in idx)
    golden_ok = want == got
    emit({"phase": "golden_subset", "queries": len(idx), "match": golden_ok,
          "oracle_ms": (time.perf_counter() - t0) * 1e3,
          "datagen_ms": gen_ms})
    check(golden_ok, "the subset differs from the float64 oracle")
    return {"fused_topk": k1_launch["fused_topk"],
            "extract_topk": k2_launch["extract_topk"]}


def config4_text() -> str:
    from dmlp_tpu_torch.io.datagen import generate_input_text
    c = CONFIG4
    return generate_input_text(c["num_data"], c["num_queries"],
                               c["num_attrs"], c["attr_min"], c["attr_max"],
                               c["min_k"], c["max_k"], c["num_labels"],
                               seed=c["seed"])


def profile_main_path():
    """The shipped config-4 solve's timed region (engine.run + result
    formatting, parsing excluded) once more, after a warm run, under
    torch.profiler: device time by kernel name, the device's busy time
    (union of its kernel and copy intervals) and its idle share of the
    window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import SingleChipEngine
    from dmlp_tpu_torch.io.grammar import parse_input_text
    from dmlp_tpu_torch.io.report import format_results

    inp = parse_input_text(config4_text())
    engine = SingleChipEngine(EngineConfig(use_pallas=True))
    format_results(engine.run(inp))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        format_results(engine.run(inp))
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(dev) > 0, "the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy_us += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy_us += cur_e - cur_s
    by_name = {}
    for e in dev:
        k = e.name[:60]
        by_name[k] = by_name.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "wall_ms": wall_ms,
          "engine_phases_ms": engine.last_phase_ms,
          "repairs": engine.last_repairs,
          "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
          "device_ms_by_name": dict(top)})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="build,kernels,main,profile",
                        help="comma-separated subset of the default")
    parser.add_argument("--reps", type=int, default=5,
                        help="timed launches per kernel case")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dmlp_tpu_torch  # noqa: F401  (fails outside the repository)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the plain versions need IEEE float32")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t_start = time.perf_counter()
    phase_build()
    summary = kernel_cases(args.reps) if "kernels" in phases else {}
    launches = main_path() if "main" in phases else {}
    if "profile" in phases:
        profile_main_path()
    if summary:
        rows = []
        for name in ("fused_topk", "extract_topk"):
            s = summary[name]
            rows.append({"name": name, "route": "cuda", "source": SOURCE,
                         "replaces": REPLACES[name],
                         "launches": launches.get(name),
                         "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                         "plain_ms": s["plain_ms"],
                         "bound_ms": s["bound"]["bound_ms"],
                         "bound_by": s["bound"]["bound_by"],
                         "library_ms": None})
        print(json.dumps({"kernels": rows}), flush=True)
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    check(phases >= {"build", "kernels", "main", "profile"},
          "a partial run (--phases) prints no result line")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
