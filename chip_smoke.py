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
   ``build``: every kernel library built from the sources in the checkout
   (one nvcc per source, all started together), with its time and the
   ptxas register / spill lines;
   ``kernel_case``: each CUDA kernel held against its plain PyTorch
   version on the card, with CUDA-event times (median of several launches
   after a warm-up) at the shapes the main paths give it — K1/K2 (lists
   under ``ops.extract.compare_lists``' tolerance, ``iters`` exactly, gate
   on against gate off bit for bit), also with a multi-pass ``floor``; K3
   (``dist`` and ``segmin`` under ``ops.extract.list_tolerance``, +inf
   exactly where ids < 0, ``segmin`` bit for bit against the kernel's own
   tile);
   ``main_path``: five solves through ``dmlp_tpu_torch.cli.main`` on the
   card, each with the launch counts set to 0 just before it, read just
   after and checked against the counts its plan implies, and its peak
   device memory: bench config 4 (200,000 x 10,000 x 64, k in 1..32) with
   ``DMLP_TPU_FUSED=0`` (K2; also the warm-up) and as shipped (K1); the
   wide-k mix (config 4's data, k in 1..1024: the heterogeneous-k router,
   K1 for the bulk and K3 for the outliers); the wide-k multi-pass
   (204,800 x 1,024 x 64, k = 4,096: K1 in 9 passes); bench config 2
   (100,000 x 5,000 x 64, k in 1..32) with ``--select seg`` (K3). Each
   output holds one checksum line per query and matches the port's
   float64 oracle (``golden.fast``) on a seeded subset byte for byte;
   ``profile``: the timed regions of config 4, the wide-k mix, the wide-k
   multi-pass and config 2's seg solve once more under torch.profiler —
   device time by kernel, device busy time, idle share, and the host's
   blocking reads;
3. one ``{"kernels": [...]}`` line: per kernel its route, source, the TPU
   kernel it replaces, main-path launches (in all and per path), max
   error, time, plain time, the bound (bytes over 3.35 TB/s or operations
   over the peak for their type, whichever is larger) and the library time
   (none: no single PyTorch call computes these functions);
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

# Generator arguments of the solved inputs (dmlp_tpu_torch.io.datagen):
# bench configs 4 and 2 (dmlp_tpu/bench/configs.py), config 4's data with
# k in 1..1024, and the 204,800 x 1,024 x 64, k = 4,096 multi-pass shape.
CONFIGS = {
    "config4": dict(num_data=200_000, num_queries=10_000, num_attrs=64,
                    attr_min=0.0, attr_max=100.0, min_k=1, max_k=32,
                    num_labels=10, seed=42),
    "widek_mix": dict(num_data=200_000, num_queries=10_000, num_attrs=64,
                      attr_min=0.0, attr_max=100.0, min_k=1, max_k=1024,
                      num_labels=10, seed=42),
    "widek_mp": dict(num_data=204_800, num_queries=1_024, num_attrs=64,
                     attr_min=0.0, attr_max=100.0, min_k=4096, max_k=4096,
                     num_labels=10, seed=42),
    "config2": dict(num_data=100_000, num_queries=5_000, num_attrs=64,
                    attr_min=0.0, attr_max=100.0, min_k=1, max_k=32,
                    num_labels=10, seed=42),
}
CONFIG4 = CONFIGS["config4"]
KERNELS = ("fused_topk", "extract_topk", "fused_dist_segmin")
REPLACES = {"fused_topk": "dmlp_tpu/ops/pallas_fused.py:108",
            "extract_topk": "dmlp_tpu/ops/pallas_extract.py:390",
            "fused_dist_segmin": "dmlp_tpu/ops/pallas_distance.py:93"}
SOURCES = {"fused_topk": "dmlp_tpu_torch/kernels/extract_topk.cu",
           "extract_topk": "dmlp_tpu_torch/kernels/extract_topk.cu",
           "fused_dist_segmin": "dmlp_tpu_torch/kernels/dist_segmin.cu"}
# (run, config, CLI flags, DMLP_TPU_FUSED, launches the plan implies,
# golden subset size). Config 4: 4 chunks of 50,176 rows. The mix: 4,376
# bulk queries on K1 and 5,624 outliers through K3, over the same 4
# chunks. The multi-pass: kcap 4,608 = 9 passes of 512, pass 1 over 4
# chunks and 8 more over the resident dataset. Config 2 with seg: 2 chunks
# x 5 query blocks of 1,024.
MAIN_RUNS = (
    ("config4_K2_warmup", "config4", ["--pallas"], "0",
     {"fused_topk": 0, "extract_topk": 4, "fused_dist_segmin": 0}, 0),
    ("config4_K1", "config4", ["--pallas"], "1",
     {"fused_topk": 4, "extract_topk": 0, "fused_dist_segmin": 0}, 1000),
    ("widek_mix", "widek_mix", ["--pallas"], "1",
     {"fused_topk": 4, "extract_topk": 0, "fused_dist_segmin": 4}, 1000),
    ("widek_multipass", "widek_mp", ["--pallas"], "1",
     {"fused_topk": 12, "extract_topk": 0, "fused_dist_segmin": 0}, 100),
    ("config2_seg", "config2", ["--select", "seg", "--pallas"], "1",
     {"fused_topk": 0, "extract_topk": 0, "fused_dist_segmin": 10}, 1000),
)
_TEXTS: dict = {}
_INPUTS: dict = {}


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
    """Hold K1/K2 and K3 against their plain versions; returns per-kernel
    records for the summary line (K1/K2 from config 4's carried f32 case,
    K3 from the wide-k mix's outlier f32 case)."""
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
                 precision="f32", d_prev=None, floor=None, main=False):
        cd, ci = carry if carry is not None else (None, None)
        kw = dict(n_real=n_real, id_base=id_base, kc=kc,
                  precision=precision, floor=floor)
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
                   "floor": floor is not None, "n_real": n_real,
                   "id_base": id_base, "ms": ms,
                   "plain_ms": plain_ms, "max_abs_err": cmp["max_abs_err"],
                   "bad_dist_rows": cmp["bad_dist_rows"],
                   "bad_id_rows": cmp["bad_id_rows"],
                   "iters_equal": iters_equal,
                   "tiles_processed": int(it.sum()),
                   "tiles": it.numel(),
                   **bound(q, d, kc, it, gate, carry is not None,
                           precision)}
            emit(rec)
            check(cmp["ok"], f"{name}/{kname}: kernel disagrees with the "
                             f"plain version {cmp}")
            check(iters_equal, f"{name}/{kname}: iters differ from the "
                               "plain version's")
            s = summary.setdefault(kname, {"max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], cmp["max_abs_err"])
            if main:
                s.update(ms=ms, plain_ms=plain_ms, bound=rec)
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
    # A resident pass of the multi-pass driver (204,800 x 1,024 x 64,
    # kc 512): the floor comes from a first pass through _mp_floor.
    mp = CONFIGS["widek_mp"]
    qm = uniform((mp["num_queries"], na), 9)
    dm = uniform((mp["num_data"], na), 10)
    od, _, _ = ex.extract_topk(qm, dm, n_real=mp["num_data"], kc=512)
    floor, _ = single._mp_floor(
        od, (qm * qm).sum(-1), (dm * dm).sum(-1).max(), staging="float32",
        na=na)
    run_case("multipass_floor", qm, dm, n_real=mp["num_data"], id_base=0,
             kc=512, floor=floor)
    segmin_cases(summary, uniform, reps)
    emit({"phase": "kernels", "kernels_held": sorted(summary)})
    return summary


def segmin_cases(summary, uniform, reps):
    """Hold K3 against its plain version: dist and segmin under
    ``list_tolerance``, +inf exactly where ids < 0, and segmin bit for bit
    against the kernel's own dist reshape-min."""
    import torch
    from dmlp_tpu_torch.engine import single
    from dmlp_tpu_torch.ops import dist_segmin as ds
    from dmlp_tpu_torch.ops import extract as ex

    dev = torch.device("cuda")
    c4, na = CONFIG4, CONFIG4["num_attrs"]
    _, nchunks, chunk_rows = single.plan_chunks(c4["num_data"], 256, None)
    n_out = 5624     # the wide-k mix's outliers (qo_pad)
    lo = (nchunks - 1) * chunk_rows   # the last chunk: 704 sentinel rows
    ri = torch.arange(lo, lo + chunk_rows, dtype=torch.int32, device=dev)
    last_ids = torch.where(ri < c4["num_data"], ri, -1)
    ragged_ids = torch.arange(1024, dtype=torch.int32, device=dev)
    ragged_ids[1024 - 300:] = -1      # segments 6..7 hold only sentinels

    def case(name, q, d, ids, precision="f32", main=False):
        ms, (dist, segmin) = time_ms(
            lambda: ds.fused_dist_segmin(q, d, ids, precision), reps)
        plain_ms, (pd, psm) = time_ms(
            lambda: ds.fused_dist_segmin_plain(q, d, ids, precision),
            max(1, reps // 2))
        torch.cuda.synchronize()
        qb, b = dist.shape
        tol = ex.list_tolerance((q * q).sum(-1),
                                float((d * d).sum(-1).max()), q.shape[1],
                                precision).to(dev)[:, None]
        inf_ok = bool(torch.equal(torch.isinf(dist),
                                  (ids[None, :] < 0).expand(qb, b)))
        fin = torch.isfinite(pd)
        err = torch.where(fin, (dist.double() - pd.double()).abs(), 0.0)
        sfin = torch.isfinite(psm)
        serr = torch.where(sfin, (segmin.double() - psm.double()).abs(), 0.0)
        own = torch.equal(segmin, dist.view(qb, -1, ds.SEG).min(-1).values)
        rec = {"phase": "kernel_case", "case": name,
               "kernel": "fused_dist_segmin", "shape": [qb, b, q.shape[1]],
               "precision": precision, "ms": ms, "plain_ms": plain_ms,
               "max_abs_err": float(err.max()),
               "segmin_max_abs_err": float(serr.max()),
               "bad_dist": int((err > tol).sum()),
               "bad_segmin": int((serr > tol).sum()),
               "inf_where_sentinel": inf_ok, "segmin_is_own_min": own,
               "sentinel_segments": int(torch.isinf(segmin[0]).sum()),
               **segmin_bound(qb, b, q.shape[1], precision)}
        emit(rec)
        check(inf_ok and bool(torch.equal(torch.isinf(psm),
                                          torch.isinf(segmin))),
              f"{name}: +inf not exactly where ids < 0")
        check(own, f"{name}: segmin is not the kernel's own tile minimum")
        check(rec["bad_dist"] == 0 and rec["bad_segmin"] == 0,
              f"{name}: kernel disagrees with the plain version {rec}")
        s = summary.setdefault("fused_dist_segmin", {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"],
                               rec["segmin_max_abs_err"])
        if main:
            s.update(ms=ms, plain_ms=plain_ms, bound=rec)

    qo = uniform((n_out, na), 11)
    d_last = uniform((chunk_rows, na), 12)
    for prec in ("f32", "bf16"):
        case(f"outlier_{prec}", qo, d_last, last_ids, prec,
             main=prec == "f32")
    case("streaming_seg", uniform((1024, na), 13), uniform((50176, na), 14),
         torch.arange(50176, dtype=torch.int32, device=dev))
    case("ragged", uniform((13, na), 15), uniform((1024, na), 16),
         ragged_ids)


def segmin_bound(qb, b, a, precision):
    """Least time for one K3 launch: inputs (q, d, ids) read once and
    outputs (dist, segmin) written once over HBM bandwidth, against the
    product's operations over the peak for their type."""
    nbytes = 4 * (qb * a + b * a + b + qb * b + qb * (b // 128))
    ops = 2.0 * qb * b * a
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[precision]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def config_text(name: str) -> str:
    from dmlp_tpu_torch.io.datagen import generate_input_text
    if name not in _TEXTS:
        c = CONFIGS[name]
        _TEXTS[name] = generate_input_text(
            c["num_data"], c["num_queries"], c["num_attrs"], c["attr_min"],
            c["attr_max"], c["min_k"], c["max_k"], c["num_labels"],
            seed=c["seed"])
    return _TEXTS[name]


def config_input(name: str):
    from dmlp_tpu_torch.io.grammar import parse_input_text
    if name not in _INPUTS:
        _INPUTS[name] = parse_input_text(config_text(name))
    return _INPUTS[name]


def main_path():
    """Every MAIN_RUNS solve through the CLI on the card; returns the
    launches per run."""
    import torch
    from dmlp_tpu_torch import cli, kernels

    outputs, launches = {}, {}
    for label, name, flags, fused, want, subset in MAIN_RUNS:
        c = CONFIGS[name]
        t0 = time.perf_counter()
        text = config_text(name)
        gen_ms = (time.perf_counter() - t0) * 1e3
        os.environ["DMLP_TPU_FUSED"] = fused
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        rc = cli.main([*flags, "--phase-times"], stdin=io.StringIO(text),
                      stdout=out, stderr=err)
        got = dict(kernels.LAUNCHES)
        os.environ.pop("DMLP_TPU_FUSED")
        check(rc == 0, f"{label}: cli.main returned {rc}")
        lines = err.getvalue().splitlines()
        m = re.fullmatch(r"Time taken: (\d+) ms", lines[0])
        check(m is not None, f"{label}: stderr line {lines[0]!r}")
        phases = {ln.split(":")[0][len("phase "):]: float(
            ln.split(":")[1].split()[0]) for ln in lines[1:]
            if ln.startswith("phase ")}
        repairs = [int(ln.split()[1]) for ln in lines
                   if ln.startswith("repairs: ")]
        text_out = out.getvalue()
        emit({"phase": "main_path", "run": label, "flags": flags,
              "DMLP_TPU_FUSED": fused, "time_taken_ms": int(m.group(1)),
              "phases_ms": phases, "repairs": repairs[0],
              "launches": got, "launches_expected": want,
              "peak_device_mb": torch.cuda.max_memory_allocated() / 2**20,
              "stdout_lines": text_out.count("\n"), "datagen_ms": gen_ms})
        check(got == want, f"{label}: launches {got} != the plan's {want}")
        out_lines = text_out.splitlines()
        check(len(out_lines) == c["num_queries"] and all(
            re.fullmatch(r"Query \d+ checksum: \d+", ln)
            for ln in out_lines),
            f"{label}: stdout is not {c['num_queries']} checksum lines")
        outputs[label], launches[label] = text_out, got
        if subset:
            golden_subset(label, name, out_lines, subset)
    check(outputs["config4_K1"] == outputs["config4_K2_warmup"],
          "gated and ungated config-4 solves print different results")
    return launches


def golden_subset(label, name, lines, size):
    """``size`` seeded queries of the run's output against golden.fast,
    byte for byte."""
    import numpy as np
    from dmlp_tpu_torch.golden.fast import knn_golden_fast
    from dmlp_tpu_torch.io.grammar import subset_queries
    from dmlp_tpu_torch.io.report import format_results

    c = CONFIGS[name]
    t0 = time.perf_counter()
    inp = config_input(name)
    idx = np.sort(np.random.default_rng(c["seed"]).choice(
        c["num_queries"], size, replace=False))
    ref = knn_golden_fast(subset_queries(inp, idx))
    for j, r in enumerate(ref):
        r.query_id = int(idx[j])
    ok = format_results(ref) == "".join(lines[i] + "\n" for i in idx)
    emit({"phase": "golden_subset", "run": label, "queries": size,
          "match": ok, "oracle_ms": (time.perf_counter() - t0) * 1e3})
    check(ok, f"{label}: the subset differs from the float64 oracle")


def profile_main_path():
    """The shipped timed region (engine.run + result formatting, parsing
    excluded) of config 4, the wide-k mix, the wide-k multi-pass and
    config 2's seg solve once more, each after a warm run, under
    torch.profiler: device time by kernel name, the device's busy time
    (union of its kernel and copy intervals), its idle share of the
    window, and the host's blocking scalar reads (the seg step's hazard
    flag)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import SingleChipEngine
    from dmlp_tpu_torch.io.report import format_results

    for label, name, select in (("config4_K1", "config4", "auto"),
                                ("widek_mix", "widek_mix", "auto"),
                                ("widek_multipass", "widek_mp", "auto"),
                                ("config2_seg", "config2", "seg")):
        inp = config_input(name)
        engine = SingleChipEngine(EngineConfig(use_pallas=True,
                                               select=select))
        format_results(engine.run(inp))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            format_results(engine.run(inp))
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
        check(len(dev) > 0, f"{label}: the profiler recorded no device "
                            "activity")
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
        syncs = [e for e in events if e.name == "aten::_local_scalar_dense"]
        emit({"phase": "profile", "run": label, "wall_ms": wall_ms,
              "engine_phases_ms": engine.last_phase_ms,
              "repairs": engine.last_repairs,
              "device_busy_ms": busy_us / 1e3,
              "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
              "host_scalar_reads": len(syncs),
              "host_scalar_read_ms": sum(
                  e.time_range.elapsed_us() for e in syncs) / 1e3,
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
        for name in KERNELS:
            s = summary[name]
            per_path = {run: n[name] for run, n in launches.items()
                        if n[name]}
            rows.append({"name": name, "route": "cuda",
                         "source": SOURCES[name],
                         "replaces": REPLACES[name],
                         "launches": sum(per_path.values()),
                         "launches_by_path": per_path,
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
