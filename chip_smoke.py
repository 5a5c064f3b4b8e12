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
   ptxas register / spill lines (K3 must not spill), and K3's resident
   CTAs per SM as the card reports them; beside them the native parser
   (``io/fastparse.cpp``, g++) built with its time;
   ``kernel_case``: each CUDA kernel held against its plain PyTorch
   version on the card, with CUDA-event times (median of several launches
   after a warm-up) at the shapes the main paths give it — K1/K2 at the
   data-axis split ``choose_splits`` picks for the card and at S = 1 in
   the same run (lists under ``ops.extract.compare_lists``' tolerance
   against the plain version at the same S, ``iters`` exactly, the two
   splits' sorted lists bit for bit, gate on against gate off bit for
   bit), also with a multi-pass ``floor``, at the wide-k bulk and at the
   multi-pass first pass; on the integer ``tie_grid`` (exact f32 sums) the
   sorted (distance, id) pairs equal the plain version's with
   ``torch.equal`` at both S; at each main-path shape the per-block time
   ``block_us`` (a full S = 1 launch against a one-block one, over the
   blocks a CTA sweeps after its first and the waves of the grid) and
   ``tile_block_us`` (K2 at S = 1 from a carry of zeros, which no distance
   passes: the tile and its ballots without a merge); the merge of the
   split lists (bit for bit against its plain version);
   ``kernel_case`` of the ``segmin`` phase: K3 (``dist`` and ``segmin``
   under ``ops.extract.list_tolerance``, +inf exactly where ids < 0,
   ``segmin`` bit for bit against the kernel's own tile) at its two
   main-path shapes (the wide-k mix's outliers in f32 and bf16, config
   2's seg step) and at edge shapes (13 rows with all-sentinel segments;
   5 attributes; 100 attributes with a ragged row tile and a segment
   count that G does not divide), every G a case names bit for bit equal,
   and at each main-path shape ``kernel_ms`` (the kernel alone: operands
   prepared once, launches back to back), ``bound_share`` (bound over
   ``ms``, and over ``kernel_ms``) and ``sgemm_ms`` (``torch.mm`` of the
   same operands in IEEE f32: the same FMAs and output bytes without the
   epilogue, a yardstick the port never calls);
   the ``tune`` phase (``dmlp_tpu_torch.tune.sweep``), on the kernels
   and segmin phases' inputs — ``split_sweep``: K1 at its seven main-path
   cases (four launch keys: the config-4 chunk, the wide-k bulk, the
   multi-pass first pass, each fresh and carried, and the multi-pass
   resident pass) and K2 at the config-4 chunk, for S = 1..15, each
   sorted list bit for bit against the heuristic S's; ``split_fill_fit``:
   for each ``SPLIT_FILL`` of a grid, the weighted ms of the S that
   ``choose_splits`` would pick at those cases over the sweep's least
   (the value of least excess is what ``ops.extract`` ships); ``g_sweep``: K3
   alone at its two main-path shapes for a range of G, each output bit for
   bit against the heuristic G's; ``prune_score_sweep``: the host prune
   scoring at config 4 over block chunks, each survivor mask bit for bit
   against the default's; then one ``tune`` line with every winner, its
   time beside the heuristic's, written to a cache file in a temporary
   directory;
   ``parse``: config 4's payload through the Python parser and the
   native one, with their times, the arrays bit for bit equal;
   ``main_path``: fourteen solves through ``dmlp_tpu_torch.cli.main`` on
   the card, each with the launch counts set to 0 just before it, read
   just after and checked against the counts its plan implies (a merge
   for every K1/K2 launch whose shape splits), with its parse time and
   parser (the native one must serve every solve), its degradation rung,
   its degradations, its scan accounting (``last_prune``: chunks pruned
   of the total), its ``engine.prune`` scoring time and its peak device
   memory: bench config 4 (200,000 x 10,000 x 64, k in 1..32) with
   ``DMLP_TPU_FUSED=0`` (K2; also the warm-up) and as shipped (K1); the
   wide-k mix (config 4's data, k in 1..1024: the heterogeneous-k router,
   K1 for the bulk and K3 for the outliers); the wide-k multi-pass
   (204,800 x 1,024 x 64, k = 4,096: K1 in 9 passes); bench config 2
   (100,000 x 5,000 x 64, k in 1..32) with ``--select seg`` (K3); config
   4's sizes on a banded corpus (attribute 0 moved by 1,000 a chunk,
   queries in the third chunk's band), which prunes 3 chunks of 4 (K1
   once, on chunk 2) and prints what the same input prints with
   ``DMLP_TPU_PRUNE=0`` (K1 4 times); config 2's sizes banded the same
   way with ``--select seg`` (queries in chunk 1's band; 1 chunk of 2
   pruned: K3 5 times); and
   config 4 under ``--faults`` with ``oom`` x 3 (the ``tuned`` rung: K2)
   and x 5 (the ``streaming`` rung: the seg fold, K3 40 times) at
   ``single.extract_solve``, each printing config 4's fault-free bytes;
   config 4 with the tune phase's cache (``tuned_config4``: config 4's
   bytes, K1 launched 4 times at the cache's S), and under ``oom`` x 4
   with that cache present (``ladder_heuristic``: the ``heuristic`` rung,
   K2 4 times, no cache lookup, config 4's bytes); config 4 and the wide-k
   mix with ``--device-full`` (the vote and the report order on the card,
   f32, dense: K1 4 times, and K3 4 times for the mix's outliers), each
   held per query against the exact ``run()`` of the same input through
   the engine API — equal ids and label, or every position where the two
   reports differ holding ids whose float64 distances lie within twice
   ``ops.extract.list_tolerance`` of each other (near ties of the f32
   ordering, counted) — and printed beside the exact solve's ``Time
   taken`` and phases. Every other fault-free solve ends on the ``lowp``
   rung with no degradation, and the uniform ones prune nothing. No run
   sends more than 1% of its queries to the host's boundary repair. Each
   output holds one checksum line per query and the exact ones match the
   port's float64 oracle (``golden.fast``) on a seeded subset byte for
   byte;
   ``real_oom``: an allocation of four times the card's memory, outside
   the engine, raises an error that ``resilience.retry.classify`` calls
   "oom";
   ``profile``: the timed regions of config 4, the wide-k mix, the wide-k
   multi-pass and config 2's seg solve once more under torch.profiler —
   device time by kernel (the split kernel, the merge and K3 by name),
   device busy time, idle share, and the host's blocking reads;
3. one ``{"kernels": [...]}`` line: per kernel its route, source, the TPU
   kernel it replaces, main-path launches (in all and per path), max
   error, time and the shape it is from, plain time, the bound (bytes
   over 3.35 TB/s or operations over the peak for their type, whichever
   is larger) and the library time (none: no single PyTorch call computes
   these functions); K1's row also has its time at S = 1 and at the
   chosen S at each main-path shape, K3's its times, bound shares and
   ``sgemm_ms`` at each main-path shape;
4. ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--phases`` and ``--reps`` narrow a run while developing (``--phases
build,segmin`` holds and times K3 alone; ``tune`` needs ``kernels`` and
``segmin``); the default runs everything.
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
    # Config 4's and config 2's sizes on a banded corpus: uniform
    # [0, 100) plus 1,000 x (row // chunk_rows - qband) on attribute 0,
    # with chunk_rows from plan_chunks at the select's granule, so that
    # each band is one chunk; uniform [0, 100) queries, in band qband.
    # The survivor is a chunk past the first (its ids start past 0), and
    # only one attribute moves, so the largest row norm, and with it the
    # boundary test's eps (engine.finalize.staging_eps), stays small
    # beside the gaps between neighbours: the device's lists decide.
    "banded_config4": dict(num_data=200_000, num_queries=10_000,
                           num_attrs=64, min_k=1, max_k=32, num_labels=10,
                           seed=42, banded="extract", qband=2),
    "banded_config2": dict(num_data=100_000, num_queries=5_000,
                           num_attrs=64, min_k=1, max_k=32, num_labels=10,
                           seed=42, banded="seg", qband=1),
}
CONFIG4 = CONFIGS["config4"]
KERNELS = ("fused_topk", "extract_topk", "extract_merge",
           "fused_dist_segmin")
# The merge stands in for the sequential grid axis of the Pallas kernel,
# along which its (tq, kc) lists are carried from block to block.
REPLACES = {"fused_topk": "dmlp_tpu/ops/pallas_fused.py:108",
            "extract_topk": "dmlp_tpu/ops/pallas_extract.py:390",
            "extract_merge": "dmlp_tpu/ops/pallas_extract.py:499",
            "fused_dist_segmin": "dmlp_tpu/ops/pallas_distance.py:93"}
SOURCES = {"fused_topk": "dmlp_tpu_torch/kernels/extract_topk.cu",
           "extract_topk": "dmlp_tpu_torch/kernels/extract_topk.cu",
           "extract_merge": "dmlp_tpu_torch/kernels/extract_topk.cu",
           "fused_dist_segmin": "dmlp_tpu_torch/kernels/dist_segmin.cu"}
# (run, config, CLI flags, DMLP_TPU_FUSED, launches the plan implies,
# K1/K2 launches as (count, qb, b, kc), golden subset size, and what else
# the run must show: "env" (more environment), "faults" (a --faults
# schedule), "rung" (default "lowp"), "pruned" (chunks pruned, default 0),
# "same_as" (a run whose stdout it must equal)). Config 4: 4 chunks of
# 50,176 rows. The mix: 4,376 bulk queries (qpad 4,384) on K1 and 5,624
# outliers through K3, over the same 4 chunks. The multi-pass: kcap 4,608
# = 9 passes of 512, pass 1 over 4 chunks of 51,200 rows and 8 more over
# the resident 204,800. Config 2 with seg: 2 chunks x 5 query blocks of
# 1,024. The banded runs stage only the surviving chunk(s). The
# streaming rung folds config 4's 4 chunks (granule 1,024: 50,176 rows)
# into 10 query blocks of 1,024 through K3. Each K1/K2 launch whose shape
# splits adds one merge. More in the last field: "tuned" (the tune phase's
# cache file is present), "exact" (a --device-full run: the exact run it
# is held against); a --device-full run stays on the engine's own "fused"
# rung, with no degradation and no prune plan.
MAIN_RUNS = (
    ("config4_K2_warmup", "config4", ["--pallas"], "0",
     {"fused_topk": 0, "extract_topk": 4, "fused_dist_segmin": 0},
     [(4, 10016, 50176, 48)], 0),
    ("config4_K1", "config4", ["--pallas"], "1",
     {"fused_topk": 4, "extract_topk": 0, "fused_dist_segmin": 0},
     [(4, 10016, 50176, 48)], 1000),
    ("widek_mix", "widek_mix", ["--pallas"], "1",
     {"fused_topk": 4, "extract_topk": 0, "fused_dist_segmin": 4},
     [(4, 4384, 50176, 512)], 1000),
    ("widek_multipass", "widek_mp", ["--pallas"], "1",
     {"fused_topk": 12, "extract_topk": 0, "fused_dist_segmin": 0},
     [(4, 1024, 51200, 512), (8, 1024, 204800, 512)], 100),
    ("config2_seg", "config2", ["--select", "seg", "--pallas"], "1",
     {"fused_topk": 0, "extract_topk": 0, "fused_dist_segmin": 10}, [],
     1000),
    ("banded_config4", "banded_config4", ["--pallas"], "1",
     {"fused_topk": 1, "extract_topk": 0, "fused_dist_segmin": 0},
     [(1, 10016, 50176, 48)], 1000, {"pruned": 3}),
    ("banded_config4_dense", "banded_config4", ["--pallas"], "1",
     {"fused_topk": 4, "extract_topk": 0, "fused_dist_segmin": 0},
     [(4, 10016, 50176, 48)], 0,
     {"env": {"DMLP_TPU_PRUNE": "0"}, "same_as": "banded_config4"}),
    ("banded_config2_seg", "banded_config2", ["--select", "seg", "--pallas"],
     "1", {"fused_topk": 0, "extract_topk": 0, "fused_dist_segmin": 5}, [],
     1000, {"pruned": 1}),
    ("ladder_tuned", "config4", ["--pallas"], "1",
     {"fused_topk": 0, "extract_topk": 4, "fused_dist_segmin": 0},
     [(4, 10016, 50176, 48)], 1000,
     {"faults": [{"site": "single.extract_solve", "kind": "oom",
                  "times": 3}], "rung": "tuned", "same_as": "config4_K1"}),
    ("ladder_streaming", "config4", ["--pallas"], "1",
     {"fused_topk": 0, "extract_topk": 0, "fused_dist_segmin": 40}, [],
     1000, {"faults": [{"site": "single.extract_solve", "kind": "oom",
                        "times": 5}], "rung": "streaming",
            "same_as": "config4_K1"}),
    ("tuned_config4", "config4", ["--pallas"], "1",
     {"fused_topk": 4, "extract_topk": 0, "fused_dist_segmin": 0},
     [(4, 10016, 50176, 48)], 0, {"tuned": True, "same_as": "config4_K1"}),
    ("ladder_heuristic", "config4", ["--pallas"], "1",
     {"fused_topk": 0, "extract_topk": 4, "fused_dist_segmin": 0},
     [(4, 10016, 50176, 48)], 0,
     {"tuned": True, "faults": [{"site": "single.extract_solve",
                                 "kind": "oom", "times": 4}],
      "rung": "heuristic", "same_as": "config4_K1"}),
    ("device_full_config4", "config4", ["--pallas", "--device-full"], "1",
     {"fused_topk": 4, "extract_topk": 0, "fused_dist_segmin": 0},
     [(4, 10016, 50176, 48)], 0, {"exact": "config4_K1"}),
    ("device_full_widek_mix", "widek_mix", ["--pallas", "--device-full"],
     "1", {"fused_topk": 4, "extract_topk": 0, "fused_dist_segmin": 4},
     [(4, 4384, 50176, 512)], 0, {"exact": "widek_mix"}),
)
# The tune phase's launch keys: per kernel, lists of (kernel case, how
# many times a solve launches it) sharing (qb, b, a, kc).
TUNE_SPLIT_KEYS = {
    True: ([("config4_fresh_f32", 1), ("config4_carried_f32", 3)],
           [("widek_bulk_fresh", 1), ("widek_bulk_carried", 3)],
           [("multipass_first", 1), ("multipass_first_carried", 3)],
           [("multipass_floor", 8)]),
    False: ([("config4_fresh_f32", 1), ("config4_carried_f32", 3)],)}
TUNE_GROUP_CASES = ("outlier_f32", "streaming_seg")
# K1's main-path shapes: kernel case -> the label of its row in PERF.md.
MAIN_SHAPES = {"multipass_floor": "multi-pass resident pass",
               "multipass_first": "multi-pass first pass, fresh",
               "multipass_first_carried": "multi-pass first pass, carried",
               "widek_bulk_fresh": "wide-k bulk, fresh",
               "widek_bulk_carried": "wide-k bulk, carried",
               "config4_fresh_f32": "config-4 chunk, fresh",
               "config4_carried_f32": "config-4 chunk, carried"}
# At most this share of a run's queries may go to the float64 host oracle
# (the boundary repair): the rest must come from the device's lists.
MAX_REPAIR_SHARE = 0.01
PHASES = ("build", "kernels", "segmin", "tune", "main", "real_oom",
          "profile")
_TEXTS: dict = {}
_INPUTS: dict = {}
_ORACLE: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int):
    """Median CUDA-event time of ``fn()`` over ``reps`` launches after one
    warm-up; returns (ms, last result)."""
    from dmlp_tpu_torch.tune.sweep import time_ms as timed
    return timed(fn, reps, "cuda")


def back_to_back_ms(fn) -> float:
    """Median CUDA-event time per call of ``fn()`` called back to back:
    the device's time when the host enqueues ahead of it."""
    from dmlp_tpu_torch.tune.sweep import back_to_back_ms as timed
    return timed(fn, "cuda")


def phase_build():
    from dmlp_tpu_torch import kernels
    from dmlp_tpu_torch.io import native
    from dmlp_tpu_torch.ops import dist_segmin as ds
    t0 = time.perf_counter()
    info = kernels.build_all()
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    parser = native.build()
    parser["ms"] = (time.perf_counter() - t0) * 1e3
    check(parser["ok"], f"the native parser did not build: {parser}")
    libs = {}
    for name, rec in info.items():
        ptxas = [ln.strip() for ln in rec["log"].splitlines()
                 if "Used" in ln or "spill" in ln]
        libs[name] = {"built": rec["built"], "ptxas": ptxas[:16]}
        kernels.load(name)
        if name == "dist_segmin" and rec["built"]:
            check(bool(ptxas) and all(
                "0 bytes spill stores, 0 bytes spill loads" in ln
                for ln in ptxas if "spill" in ln),
                f"dist_segmin.cu spills registers: {ptxas}")
    occupancy = ds._kernel_lib().dmlp_segmin_occupancy()
    emit({"phase": "build", "ms": ms, "libraries": libs,
          "segmin_ctas_per_sm": occupancy, "native_parser": parser})
    check(occupancy == ds.CTAS_PER_SM,
          f"K3 runs {occupancy} CTAs per SM, not {ds.CTAS_PER_SM}")


def seeded_uniform(dev):
    """uniform(shape, seed, hi=100, integer=False): values in [0, hi)
    from a torch.Generator on ``dev`` seeded with ``seed``."""
    import torch
    gen = torch.Generator(device=dev)

    def uniform(shape, seed, hi=100.0, integer=False):
        gen.manual_seed(seed)
        if integer:
            return torch.randint(0, int(hi), shape, generator=gen,
                                 device=dev).float()
        return torch.rand(shape, generator=gen, device=dev) * hi
    return uniform


def kernel_cases(reps: int):
    """Hold K1/K2 and their merge against their plain versions; returns
    per-kernel records for the summary line (K1/K2 from config 4's
    carried f32 case, the merge from the multi-pass resident pass) with
    K1's times at the main-path shapes, and the main-path cases' inputs
    for the tune phase."""
    import torch
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine import single
    from dmlp_tpu_torch.ops import extract as ex
    from dmlp_tpu_torch.tune.sweep import sorted_lists

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = EngineConfig(use_pallas=True)
    na = CONFIG4["num_attrs"]
    _, _, chunk_rows = single.plan_chunks(
        CONFIG4["num_data"], cfg.resolve_granule("extract"), None)
    qb = single.round_up(CONFIG4["num_queries"], ex.QUERY_TILE)
    kc = single.resolve_kcap(cfg, CONFIG4["max_k"], "extract", 1 << 30)
    uniform = seeded_uniform(dev)
    summary, by_shape, sweep_inputs = {}, {}, {}

    def run_case(name, q, d, *, n_real, id_base, kc, carry=None,
                 precision="f32", d_prev=None, floor=None, main=False,
                 exact=False):
        cd, ci = carry if carry is not None else (None, None)
        kw = dict(n_real=n_real, id_base=id_base, kc=kc,
                  precision=precision, floor=floor)
        qn = (q * q).sum(-1)
        dn_all = (d * d).sum(-1) if d_prev is None else \
            torch.cat([(d * d).sum(-1), (d_prev * d_prev).sum(-1)])
        tol = ex.list_tolerance(qn, float(dn_all.max()), q.shape[1],
                                precision)
        chosen = ex.choose_splits(q.shape[0], d.shape[0], kc, sm_count)
        if name in MAIN_SHAPES:
            sweep_inputs[name] = (q, d, cd, ci, kw)

        def plain(gate, splits):
            pd, pi, it = ex.split_partials_plain(q, d, cd, ci, mxu_gate=gate,
                                                 splits=splits, **kw)
            if splits == 1:
                return pd[0], pi[0], it, None
            return (*ex.merge_partials_plain(cd, ci, pd, pi), it, (pd, pi))

        # The tile alone: K2 at S = 1 from a carry of zeros, which no
        # distance passes (m < 0), so every block computes its tile and
        # ballots and merges nothing.
        tile_us = None
        if name in MAIN_SHAPES:
            zc = torch.zeros((q.shape[0], kc), device=dev)
            zi = torch.full_like(zc, -1, dtype=torch.int32)
            ms_tile, _ = time_ms(lambda: ex.extract_topk(
                q, d, zc, zi, mxu_gate=False, splits=1, **kw), reps)
            waves = -(-(-(-q.shape[0] // ex.QUERY_TILE))
                      // (sm_count * ex.ctas_per_sm(kc)))
            tile_us = 1e3 * ms_tile / (waves * (d.shape[0] // ex.BLOCK_ROWS))
            del zc, zi
        outs = {}
        for gate in (True, False):
            kname = "fused_topk" if gate else "extract_topk"
            res, plain_out = {}, {}
            for splits in dict.fromkeys((chosen, 1)):
                ms, out = time_ms(lambda: ex.extract_topk(
                    q, d, cd, ci, mxu_gate=gate, splits=splits, **kw), reps)
                plain_ms, (pd, pi, pit, parts) = time_ms(
                    lambda: plain(gate, splits), max(1, reps // 2))
                torch.cuda.synchronize()
                plain_out[splits] = (pd, pi)
                cmp = ex.compare_lists(out[0], out[1], pd, pi, tol)
                cmp["iters_equal"] = bool(torch.equal(out[2], pit))
                res[splits] = (ms, plain_ms, out, cmp)
                if gate and parts is not None:
                    merge_case(summary, name, cd, ci, *parts, reps,
                               main=name == "multipass_floor")
            ms, plain_ms, (od, oi, it), cmp = res[chosen]
            ms1, plain_ms1, (od1, oi1, it1), cmp1 = res[1]
            same = all(torch.equal(a, b) for a, b in zip(
                sorted_lists(od, oi), sorted_lists(od1, oi1)))
            outs[gate] = (od, oi, it)
            # Exact f32 inputs: the sorted (distance, id) pairs equal the
            # plain version's at every S.
            exact_equal = {s: all(torch.equal(a, b) for a, b in zip(
                sorted_lists(*r[2][:2]), sorted_lists(*plain_out[s])))
                for s, r in res.items()} if exact else None
            # The per-block time: a full launch at S = 1 against one of its
            # first block, over the blocks each CTA sweeps after the first.
            ms_one = block_us = None
            if name in MAIN_SHAPES:
                ms_one, _ = time_ms(lambda: ex.extract_topk(
                    q, d[:ex.BLOCK_ROWS], cd, ci, mxu_gate=gate, splits=1,
                    **{**kw, "n_real": min(n_real, ex.BLOCK_ROWS)}), reps)
                waves = -(-it1.shape[0] // (sm_count * ex.ctas_per_sm(kc)))
                block_us = 1e3 * (ms1 - ms_one) / (
                    waves * (d.shape[0] // ex.BLOCK_ROWS - 1))
            rec = {"phase": "kernel_case", "case": name, "kernel": kname,
                   "shape": [q.shape[0], d.shape[0], q.shape[1], kc],
                   "precision": precision, "carry": carry is not None,
                   "floor": floor is not None, "n_real": n_real,
                   "id_base": id_base, "splits": chosen, "ms": ms,
                   "ms_s1": ms1, "plain_ms": plain_ms,
                   "plain_ms_s1": plain_ms1,
                   "max_abs_err": max(cmp["max_abs_err"],
                                      cmp1["max_abs_err"]),
                   "bad_dist_rows": cmp["bad_dist_rows"]
                   + cmp1["bad_dist_rows"],
                   "bad_id_rows": cmp["bad_id_rows"] + cmp1["bad_id_rows"],
                   "iters_equal": cmp["iters_equal"]
                   and cmp1["iters_equal"], "splits_identical": same,
                   "tiles_processed": int(it.sum()),
                   "tiles_processed_s1": int(it1.sum()),
                   "tiles": it.numel(), "ms_one_block": ms_one,
                   "block_us": block_us, "tile_block_us": tile_us,
                   "exact_equal": exact_equal,
                   **bound(q, d, kc, it1, gate, carry is not None,
                           precision)}
            emit(rec)
            for splits, (_, _, _, c) in res.items():
                check(c["ok"], f"{name}/{kname}/S={splits}: kernel "
                               f"disagrees with the plain version {c}")
                check(c["iters_equal"], f"{name}/{kname}/S={splits}: iters "
                                        "differ from the plain version's")
            check(same, f"{name}/{kname}: S={chosen} and S=1 sorted lists "
                        "differ")
            check(not exact or all(exact_equal.values()),
                  f"{name}/{kname}: sorted lists differ from the plain "
                  f"version's on exact inputs {exact_equal}")
            s = summary.setdefault(kname, {"max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"])
            if main:
                s.update(ms=ms, plain_ms=plain_ms, bound=rec,
                         shape=f"{name} {rec['shape']} S={chosen}")
            if gate and name in MAIN_SHAPES:
                by_shape[MAIN_SHAPES[name]] = {
                    "shape": rec["shape"], "splits": chosen,
                    "ctas": it.shape[0] * chosen, "ms": ms, "ms_s1": ms1,
                    "block_us": block_us, "tile_block_us": tile_us,
                    "bound_ms": rec["bound_ms"]}
        same = torch.equal(outs[True][0], outs[False][0]) \
            and torch.equal(outs[True][1], outs[False][1])
        emit({"phase": "kernel_gate_identity", "case": name,
              "splits": chosen, "identical": bool(same)})
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
    # The wide-k mix's bulk: 4,376 queries (qpad 4,384) at kb 512 over a
    # config-4 chunk, carried.
    qw = q[:4384].clone()
    qw[4376:] = 0.0
    first = run_case("widek_bulk_fresh", qw, d0, n_real=chunk_rows,
                     id_base=0, kc=512)
    run_case("widek_bulk_carried", qw, d1, n_real=chunk_rows,
             id_base=chunk_rows, kc=512, carry=first[:2], d_prev=d0)
    # The widest list the kernel takes.
    run_case("kc512", q[:2048].contiguous(), d0, n_real=chunk_rows,
             id_base=0, kc=512)
    # Duplicate-heavy tie grid: integer attrs in [0, 3), exact f32 sums.
    qt, dt = uniform((1024, na), 4, 3, True), uniform((8192, na), 5, 3, True)
    run_case("tie_grid", qt, dt, n_real=8192, id_base=0, kc=kc, exact=True)
    # A ragged final chunk with a non-zero id base and a carry.
    qr, dr0, dr1 = (uniform((1000, na), 6), uniform((8192, na), 7),
                    uniform((8192, na), 8))
    first = ex.extract_topk_plain(qr, dr0, n_real=8192, id_base=0, kc=kc)
    run_case("ragged_id_base", qr, dr1, n_real=5000, id_base=123456,
             kc=kc, carry=first[:2], d_prev=dr0)
    # The multi-pass driver (204,800 x 1,024 x 64, kc 512): the first pass
    # over a 51,200-row chunk, then a resident pass whose floor comes from
    # a first pass through _mp_floor.
    mp = CONFIGS["widek_mp"]
    qm = uniform((mp["num_queries"], na), 9)
    dm = uniform((mp["num_data"], na), 10)
    rows = mp["num_data"] // 4
    first = run_case("multipass_first", qm, dm[:rows].contiguous(),
                     n_real=rows, id_base=0, kc=512)
    run_case("multipass_first_carried", qm, dm[rows:2 * rows].contiguous(),
             n_real=rows, id_base=rows, kc=512, carry=first[:2],
             d_prev=dm[:rows])
    od, _, _ = ex.extract_topk(qm, dm, n_real=mp["num_data"], kc=512)
    floor, _ = single._mp_floor(
        od, (qm * qm).sum(-1), (dm * dm).sum(-1).max(), staging="float32",
        na=na)
    run_case("multipass_floor", qm, dm, n_real=mp["num_data"], id_base=0,
             kc=512, floor=floor)
    emit({"phase": "kernels", "kernels_held": sorted(summary)})
    # choose_splits takes the smallest S within SPLIT_TOL of its model's
    # least time, so a chosen S may tie with S = 1 within that tolerance.
    for label, r in by_shape.items():
        check(r["splits"] == 1 or r["ms"] <= (1 + ex.SPLIT_TOL) * r["ms_s1"],
              f"{label}: S={r['splits']} measured slower than S=1 {r}")
    for label in ("multi-pass resident pass", "multi-pass first pass, fresh",
                  "multi-pass first pass, carried"):
        r = by_shape[label]
        check(r["splits"] > 1 and r["ms"] < r["ms_s1"],
              f"{label}: the split does not pay {r}")
    summary["fused_topk"]["ms_by_shape"] = by_shape
    return summary, sweep_inputs


def merge_case(summary, name, cd, ci, part_d, part_i, reps, main=False):
    """Hold the merge kernel against its plain version on the plain
    version's partial lists: both are exact, so bit for bit."""
    import torch
    from dmlp_tpu_torch.ops import extract as ex
    ms, (od, oi) = time_ms(lambda: ex.merge_partials(cd, ci, part_d, part_i),
                           reps)
    plain_ms, (pd, pi) = time_ms(
        lambda: ex.merge_partials_plain(cd, ci, part_d, part_i), reps)
    torch.cuda.synchronize()
    same = torch.equal(od, pd) and torch.equal(oi, pi)
    nsplit, qb, kc = part_d.shape
    nbytes = 8 * qb * kc * (nsplit + (cd is not None) + 1)
    rec = {"phase": "kernel_case", "case": name, "kernel": "extract_merge",
           "shape": [qb, nsplit, kc], "carry": cd is not None, "ms": ms,
           "plain_ms": plain_ms, "identical": bool(same),
           "max_abs_err": float((od.double() - pd.double()).abs().nan_to_num(
               0.0).max()),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit(rec)
    check(same, f"{name}: the merge kernel differs from its plain version")
    s = summary.setdefault("extract_merge", {"max_abs_err": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"])
    if main or "ms" not in s:
        s.update(ms=ms, plain_ms=plain_ms, bound=rec,
                 shape=f"{name} {rec['shape']}")


def segmin_cases(summary, reps):
    """Hold K3 against its plain version: dist and segmin under
    ``list_tolerance``, +inf exactly where ids < 0, and segmin bit for bit
    against the kernel's own dist reshape-min; every G a case names gives
    the same output bit for bit. The two main-path shapes also get their
    bound share and the ``torch.mm`` yardstick; returns their inputs for
    the tune phase's ``g_sweep``."""
    import torch
    from dmlp_tpu_torch.engine import single
    from dmlp_tpu_torch.ops import dist_segmin as ds
    from dmlp_tpu_torch.ops import extract as ex

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    uniform = seeded_uniform(dev)
    c4, na = CONFIG4, CONFIG4["num_attrs"]
    _, nchunks, chunk_rows = single.plan_chunks(c4["num_data"], 256, None)
    n_out = 5624     # the wide-k mix's outliers (qo_pad)
    lo = (nchunks - 1) * chunk_rows   # the last chunk: 704 sentinel rows
    ri = torch.arange(lo, lo + chunk_rows, dtype=torch.int32, device=dev)
    last_ids = torch.where(ri < c4["num_data"], ri, -1)
    ragged_ids = torch.arange(1024, dtype=torch.int32, device=dev)
    ragged_ids[1024 - 300:] = -1      # segments 6..7 hold only sentinels
    by_shape, g_inputs = {}, {}

    def case(name, q, d, ids, precision="f32", groups=(), main=None):
        qb, b = q.shape[0], d.shape[0]
        chosen = ds.choose_group(qb, b, sm_count)
        ms, (dist, segmin) = time_ms(
            lambda: ds.fused_dist_segmin(q, d, ids, precision), reps)
        plain_ms, (pd, psm) = time_ms(
            lambda: ds.fused_dist_segmin_plain(q, d, ids, precision),
            max(1, reps // 2))
        torch.cuda.synchronize()
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
        inf_same = bool(torch.equal(torch.isinf(psm), torch.isinf(segmin)))
        del pd, psm, fin, sfin
        ops = ds.launch_operands(q, d, ids, precision)
        gd, gs = torch.empty_like(dist), torch.empty_like(segmin)
        same_g = {}
        for g in groups:
            ds._launch(*ops, gd, gs, g)
            same_g[g] = bool(torch.equal(gd, dist) and torch.equal(gs, segmin))
        del gd, gs
        rec = {"phase": "kernel_case", "case": name,
               "kernel": "fused_dist_segmin", "shape": [qb, b, q.shape[1]],
               "precision": precision, "group": chosen,
               "ctas": -(-qb // ds.QUERY_TILE) * len(
                   ds.segment_groups(b // ds.SEG, chosen)),
               "ms": ms, "plain_ms": plain_ms,
               "max_abs_err": float(err.max()),
               "segmin_max_abs_err": float(serr.max()),
               "bad_dist": int((err > tol).sum()),
               "bad_segmin": int((serr > tol).sum()),
               "inf_where_sentinel": inf_ok, "segmin_is_own_min": own,
               "sentinel_segments": int(torch.isinf(segmin[0]).sum()),
               "same_at_group": same_g,
               **segmin_bound(qb, b, q.shape[1], precision)}
        del err, serr
        rec["bound_share"] = rec["bound_ms"] / ms
        if main:
            rec["sgemm_ms"], _ = time_ms(lambda: torch.mm(q, d.T), reps)
            rec["kernel_ms"] = back_to_back_ms(lambda: ds._launch(
                *ops, dist, segmin, chosen))
            rec["kernel_bound_share"] = rec["bound_ms"] / rec["kernel_ms"]
        del ops
        emit(rec)
        check(inf_ok and inf_same, f"{name}: +inf not exactly where ids < 0")
        check(own, f"{name}: segmin is not the kernel's own tile minimum")
        check(rec["bad_dist"] == 0 and rec["bad_segmin"] == 0,
              f"{name}: kernel disagrees with the plain version {rec}")
        check(all(same_g.values()), f"{name}: the output depends on G "
                                    f"{same_g}")
        s = summary.setdefault("fused_dist_segmin", {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"],
                               rec["segmin_max_abs_err"])
        if main:
            by_shape[main] = {k: rec[k] for k in (
                "shape", "group", "ctas", "ms", "kernel_ms", "plain_ms",
                "bound_ms", "bound_by", "bound_share", "kernel_bound_share",
                "sgemm_ms")}
            if "ms" not in s:
                s.update(ms=ms, plain_ms=plain_ms, bound=rec,
                         shape=f"{name} {rec['shape']}")
            g_inputs[name] = (q, d, ids)

    qo = uniform((n_out, na), 11)
    d_last = uniform((chunk_rows, na), 12)
    case("outlier_f32", qo, d_last, last_ids, main="outliers")
    case("outlier_bf16", qo, d_last, last_ids, "bf16")
    case("streaming_seg", uniform((1024, na), 13), uniform((50176, na), 14),
         torch.arange(50176, dtype=torch.int32, device=dev),
         main="config 2 seg step")
    case("ragged", uniform((13, na), 15), uniform((1024, na), 16),
         ragged_ids, groups=(1, 3, 8))
    case("na5", uniform((256, 5), 17), uniform((4096, 5), 18),
         torch.arange(4096, dtype=torch.int32, device=dev), groups=(1, 32))
    # 1,000 rows (a ragged row tile), 100 attributes (not whole chunks), 37
    # segments (no G > 1 of these divides them).
    ids37 = torch.arange(37 * 128, dtype=torch.int32, device=dev)
    ids37[-200:] = -1
    case("na100_ragged", uniform((1000, 100), 19),
         uniform((37 * 128, 100), 20), ids37, groups=(1, 5, 36))
    summary["fused_dist_segmin"]["ms_by_shape"] = by_shape
    emit({"phase": "segmin", "kernels_held": ["fused_dist_segmin"]})
    return g_inputs


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
        _TEXTS[name] = banded_text(c) if "banded" in c else \
            generate_input_text(
                c["num_data"], c["num_queries"], c["num_attrs"],
                c["attr_min"], c["attr_max"], c["min_k"], c["max_k"],
                c["num_labels"], seed=c["seed"])
    return _TEXTS[name]


def banded_text(c) -> str:
    """The norm-banded corpus of ``c`` (see CONFIGS), from numpy seeded
    with ``c["seed"]``, in the input grammar."""
    import numpy as np
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import plan_chunks
    from dmlp_tpu_torch.io.grammar import KNNInput, Params, format_input
    n, nq, na = c["num_data"], c["num_queries"], c["num_attrs"]
    granule = EngineConfig(use_pallas=True).resolve_granule(c["banded"])
    _, _, chunk_rows = plan_chunks(n, granule, None)
    rng = np.random.default_rng(c["seed"])
    data = rng.uniform(0.0, 100.0, (n, na))
    data[:, 0] += 1000.0 * (np.arange(n) // chunk_rows - c["qband"])
    labels = rng.integers(0, c["num_labels"], n).astype(np.int32)
    ks = rng.integers(c["min_k"], c["max_k"] + 1, nq).astype(np.int32)
    queries = rng.uniform(0.0, 100.0, (nq, na))
    return format_input(KNNInput(Params(n, nq, na), labels, data, ks,
                                 queries))


def config_input(name: str):
    """The parsed input of ``name`` (the native parser)."""
    from dmlp_tpu_torch.io.grammar import parse_input
    if name not in _INPUTS:
        _INPUTS[name] = parse_input(io.StringIO(config_text(name)))
    return _INPUTS[name]


def phase_tune(sweep_inputs, g_inputs, tmp_dir):
    """The measured sweeps of ``dmlp_tpu_torch.tune.sweep`` on the kernels
    and segmin phases' main-path inputs — S of K1 at its four launch keys
    and of K2 at config 4's, G of K3 at its two shapes, every output bit
    for bit against the heuristic's — and the prune scoring's chunk at
    config 4; the winners go to a cache file in ``tmp_dir``, whose path is
    returned."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import plan_chunks
    from dmlp_tpu_torch.ops.summaries import build_summaries
    from dmlp_tpu_torch.tune import sweep
    from dmlp_tpu_torch.tune.cache import device_kind

    t0 = time.perf_counter()
    winners, lines = [], []

    def keep(line):
        lines.append(line)
        emit(line)
    for gate, keys in TUNE_SPLIT_KEYS.items():
        for key in keys:
            winners.append(sweep.sweep_splits(
                [sweep.SplitCase(name, *sweep_inputs[name], weight)
                 for name, weight in key], gate=gate, reps=3, emit=keep))
    split_fill_fit(lines)
    for name in TUNE_GROUP_CASES:
        winners.append(sweep.sweep_groups(name, *g_inputs[name], emit=emit))
    for w in winners:
        check(not w["changed"], f"{w['kernel']} {w['cases']}: the "
                                f"variants {w['changed']} change a result")
    c4 = CONFIGS["config4"]
    inp = config_input("config4")
    _, nchunks, chunk_rows = plan_chunks(
        c4["num_data"], EngineConfig(use_pallas=True).resolve_granule(
            "extract"), None)
    summ = build_summaries(inp.data_attrs, [
        (i * chunk_rows, min((i + 1) * chunk_rows, c4["num_data"]))
        for i in range(nchunks)])
    winners.append(sweep.sweep_prune_score(inp.query_attrs, inp.ks, summ,
                                           emit=emit))
    path = sweep.save_winners(winners, os.path.join(tmp_dir,
                                                    "variants.json"),
                              device_kind("cuda"))
    emit({"phase": "tune", "cache": path,
          "ms": (time.perf_counter() - t0) * 1e3,
          "winners": [{k: w[k] for k in (
              "kernel", "cases", "qb", "b", "a", "kc", "variant",
              "measured_ms", "heuristic", "heuristic_ms", "swept",
              "changed")} for w in winners]})
    return path


def split_fill_fit(lines):
    """``choose_splits``' fill constant against this run's ``split_sweep``
    lines: for each SPLIT_FILL of a grid, the S it picks at each case and
    the weighted sum of the measured ms there over the weighted sum of
    each case's least ms (1 is the best any rule could do). Emits one
    ``split_fill_fit`` line; changes nothing."""
    import torch
    from dmlp_tpu_torch.ops import extract as ex
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    shipped, by_fill = ex.SPLIT_FILL, {}
    best = sum(ln["weight"] * min(ln["ms_by_splits"].values())
               for ln in lines)
    try:
        for fill in (0.0, 0.005, 0.01, 0.02, 0.03, 0.05, 0.075, 0.1, 0.15,
                     0.2, 0.3, 0.5):
            ex.SPLIT_FILL = fill
            picks = [(ln, ex.choose_splits(*ln["shape"][:2], ln["shape"][3],
                                           sm_count)) for ln in lines]
            if all(s in ln["ms_by_splits"] for ln, s in picks):
                by_fill[fill] = {"excess": sum(
                    ln["weight"] * ln["ms_by_splits"][s]
                    for ln, s in picks) / best,
                    "splits": [s for _, s in picks]}
    finally:
        ex.SPLIT_FILL = shipped
    emit({"phase": "split_fill_fit", "shipped": shipped,
          "cases": [f"{ln['kernel']}/{ln['case']}" for ln in lines],
          "best_splits": [min(ln["ms_by_splits"], key=ln["ms_by_splits"].get)
                          for ln in lines],
          "by_fill": by_fill,
          "best_fill": min(by_fill, key=lambda f: by_fill[f]["excess"])
          if by_fill else None})


def compare_device_full(label, name, exact_record):
    """The device-full solve of ``name`` against the exact run() of the
    same input, both through the engine API: per query equal ids and
    label, or a near tie — every position where the reports differ holds
    ids whose float64 distances lie within twice ``list_tolerance`` of each
    other (the f32 ordering's error bound). Emits the count of near ties
    beside the exact CLI run's ``Time taken`` and phases."""
    import numpy as np
    import torch
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import SingleChipEngine
    from dmlp_tpu_torch.ops.extract import list_tolerance

    inp = config_input(name)
    eng = SingleChipEngine(EngineConfig(use_pallas=True))
    t0 = time.perf_counter()
    full = eng.run_device_full(inp)
    full_ms = (time.perf_counter() - t0) * 1e3
    full_path = (eng._last_select, eng.last_hetk, eng.last_mp_passes)
    t0 = time.perf_counter()
    exact = SingleChipEngine(EngineConfig(use_pallas=True)).run(inp)
    exact_ms = (time.perf_counter() - t0) * 1e3
    qn = np.einsum("qa,qa->q", inp.query_attrs, inp.query_attrs)
    dn_max = float(np.einsum("na,na->n", inp.data_attrs,
                             inp.data_attrs).max())
    tol = 2 * list_tolerance(torch.from_numpy(qn), dn_max,
                             inp.params.num_attrs).numpy()
    near, bad, labels_differ = 0, [], 0
    for q, (f, e) in enumerate(zip(full, exact)):
        same_ids = np.array_equal(f.neighbor_ids, e.neighbor_ids)
        if same_ids and f.predicted_label == e.predicted_label:
            continue
        pos = np.nonzero(f.neighbor_ids != e.neighbor_ids)[0]
        a, b = f.neighbor_ids[pos], e.neighbor_ids[pos]
        x = inp.query_attrs[q]

        def d64(ids):
            diff = inp.data_attrs[np.clip(ids, 0, None)] - x
            return np.where(ids >= 0, np.einsum("ia,ia->i", diff, diff),
                            np.inf)
        ok = not same_ids and bool(np.all(np.abs(d64(a) - d64(b))
                                          <= tol[q]))
        labels_differ += f.predicted_label != e.predicted_label
        if ok:
            near += 1
        else:
            bad.append(q)
    emit({"phase": "device_full_vs_exact", "run": label,
          "queries": len(full), "near_tie_queries": near,
          "label_differs": int(labels_differ), "failed_queries": bad[:20],
          "path": full_path, "device_full_api_ms": full_ms,
          "exact_api_ms": exact_ms,
          "exact_run": exact_record["run"],
          "exact_time_taken_ms": exact_record["time_taken_ms"],
          "exact_phases_ms": exact_record["phases_ms"]})
    check(not bad, f"{label}: {len(bad)} queries differ from the exact "
                   f"run beyond the f32 tolerance, first {bad[:5]}")
    return full_path


def main_path(tune_path):
    """Every MAIN_RUNS solve through the CLI on the card (the runs with
    the tune cache only when the tune phase ran); returns the launches per
    run."""
    import tempfile

    import numpy as np
    import torch
    from dmlp_tpu_torch import cli, kernels
    from dmlp_tpu_torch.io import grammar
    from dmlp_tpu_torch.ops.extract import check_splits, heuristic_splits
    from dmlp_tpu_torch.resilience import degrade, stats
    from dmlp_tpu_torch.tune import cache as tune_cache

    # Config 4's payload through both parsers on this host: the same
    # arrays, bit for bit.
    text = config_text("config4")
    t0 = time.perf_counter()
    py = grammar.parse_input_text(text)
    py_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    nat = grammar.parse_input(io.StringIO(text))
    nat_ms = (time.perf_counter() - t0) * 1e3
    same = all(np.array_equal(getattr(py, f), getattr(nat, f)) for f in (
        "labels", "data_attrs", "ks", "query_attrs"))
    emit({"phase": "parse", "config": "config4", "bytes": len(text),
          "python_ms": py_ms, "native_ms": nat_ms,
          "parser": grammar.last_parser, "identical": same})
    check(same and grammar.last_parser == "native",
          f"config 4: the native parse ({grammar.last_parser}) differs "
          "from the Python parser's")
    del py, nat

    outputs, launches, records = {}, {}, {}
    tmp = tempfile.TemporaryDirectory()
    # Every run but the tuned ones sees no cache file.
    absent = os.path.join(tmp.name, "absent.json")

    def planned_splits(qb, b, kc, gate, cached):
        """S of a K1/K2 launch: the cache's, else the heuristic."""
        v = cached and tune_cache.lookup_variant(
            "fused_topk" if gate else "extract_topk", qb=qb, b=b, a=64,
            kc=kc, device="cuda", path=tune_path)
        return check_splits(v["splits"], b, kc) if v else \
            heuristic_splits(qb, b, kc, "cuda")

    for label, name, flags, fused, want, shapes, subset, *more in MAIN_RUNS:
        extra = more[0] if more else {}
        if extra.get("tuned") and tune_path is None:
            continue
        c = CONFIGS[name]
        rung = extra.get("rung", "lowp")
        device_full = "--device-full" in flags
        gate = bool(want["fused_topk"])
        variants = {}
        for n, qb, b, kc in shapes:
            s = planned_splits(qb, b, kc, gate, extra.get("tuned") and
                               rung != "heuristic")
            per = variants.setdefault(
                "fused_topk" if gate else "extract_topk", {})
            per[s] = per.get(s, 0) + n
        want = {**want, "extract_merge": sum(
            n for per in variants.values() for s, n in per.items()
            if s > 1)}
        t0 = time.perf_counter()
        text = config_text(name)
        gen_ms = (time.perf_counter() - t0) * 1e3
        argv = [*flags, "--phase-times"]
        if "faults" in extra:
            path = os.path.join(tmp.name, f"{label}.json")
            with open(path, "w") as f:
                json.dump({"schema": 1, "seed": 0,
                           "faults": extra["faults"]}, f)
            argv += ["--faults", path]
        env = {"DMLP_TPU_FUSED": fused, "DMLP_TPU_TUNE_CACHE":
               tune_path if extra.get("tuned") else absent,
               **extra.get("env", {})}
        os.environ.update(env)
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        tune_cache.reset_stats()
        grammar.last_parser = None
        rc = cli.main(argv, stdin=io.StringIO(text), stdout=out, stderr=err)
        got = dict(kernels.LAUNCHES)
        got_variants = {k: dict(v) for k, v in
                        kernels.LAUNCH_VARIANTS.items() if k in variants}
        lookups = dict(tune_cache.STATS)
        degradations = stats.snapshot()["degradations"]
        for k in env:
            os.environ.pop(k)
        check(rc == 0, f"{label}: cli.main returned {rc}")
        lines = err.getvalue().splitlines()
        m = re.fullmatch(r"Time taken: (\d+) ms", lines[0])
        check(m is not None, f"{label}: stderr line {lines[0]!r}")
        phases = {ln.split(":")[0][len("phase "):]: float(
            ln.split(":")[1].split()[0]) for ln in lines[1:]
            if ln.startswith("phase ")}
        repairs = [int(ln.split()[1]) for ln in lines
                   if ln.startswith("repairs: ")]
        got_rung = [ln.split()[1] for ln in lines if ln.startswith("rung: ")]
        prune = [json.loads(ln[len("prune: "):]) for ln in lines
                 if ln.startswith("prune: ")]
        text_out = out.getvalue()
        records[label] = {
            "phase": "main_path", "run": label, "flags": flags,
            "env": env, "faults": extra.get("faults"),
            "time_taken_ms": int(m.group(1)), "phases_ms": phases,
            "parse_ms": phases.get("parse"), "parser": grammar.last_parser,
            "repairs": repairs[0], "rung": got_rung[0],
            "degradations": degradations, "last_prune": prune[0],
            "launches": got, "launches_expected": want,
            "launch_variants": got_variants,
            "launch_variants_expected": variants, "tune_cache": lookups,
            "peak_device_mb": torch.cuda.max_memory_allocated() / 2**20,
            "stdout_lines": text_out.count("\n"), "datagen_ms": gen_ms}
        emit(records[label])
        check(got == want, f"{label}: launches {got} != the plan's {want}")
        check(got_variants == variants, f"{label}: launches by S "
                                        f"{got_variants} != {variants}")
        check(grammar.last_parser == "native",
              f"{label}: parsed by the {grammar.last_parser} parser")
        if device_full:     # the engine's own rung, not the ladder's
            rung, steps = "fused", ()
        else:
            steps = degrade.RUNGS[:degrade.RUNGS.index(rung) + 1]
        check(got_rung == [rung] and degradations == [
            f"{a}->{b}" for a, b in zip(steps, steps[1:])],
            f"{label}: rung {got_rung}, degradations {degradations}; "
            f"want {rung}")
        check(repairs[0] <= MAX_REPAIR_SHARE * c["num_queries"],
              f"{label}: {repairs[0]} of {c['num_queries']} queries "
              "repaired on the host")
        check("engine.prune" in phases,
              f"{label}: no engine.prune phase in {phases}")
        if device_full:
            check(prune[0] is None and repairs[0] == 0,
                  f"{label}: prune {prune[0]}, repairs {repairs[0]}; a "
                  "device-full solve has neither")
        else:
            check(prune[0] is not None and prune[0]["blocks_pruned"]
                  == extra.get("pruned", 0),
                  f"{label}: last_prune {prune[0]}, want "
                  f"{extra.get('pruned', 0)} chunks pruned")
        if extra.get("tuned"):
            want_hits = 0 if rung == "heuristic" else 5   # K1 x 4, scoring
            check(lookups == {"lookups": want_hits, "hits": want_hits},
                  f"{label}: tune cache lookups {lookups}, want "
                  f"{want_hits} lookups, all hits")
        out_lines = text_out.splitlines()
        check(len(out_lines) == c["num_queries"] and all(
            re.fullmatch(r"Query \d+ checksum: \d+", ln)
            for ln in out_lines),
            f"{label}: stdout is not {c['num_queries']} checksum lines")
        if "same_as" in extra:
            check(text_out == outputs[extra["same_as"]],
                  f"{label}: stdout differs from {extra['same_as']}'s")
        outputs[label], launches[label] = text_out, got
        if subset:
            golden_subset(label, name, out_lines, subset)
        if "exact" in extra:
            path = compare_device_full(label, name, records[extra["exact"]])
            check(path[0] == "extract", f"{label}: solved on {path}")
    tmp.cleanup()
    check(outputs["config4_K1"] == outputs["config4_K2_warmup"],
          "gated and ungated config-4 solves print different results")
    return launches


def real_oom():
    """An allocation of four times the card's memory, outside the engine:
    what it raises must classify as "oom", the class on which the
    degradation ladder steps down."""
    import torch
    from dmlp_tpu_torch.resilience.retry import classify
    total = torch.cuda.get_device_properties(0).total_memory
    err = None
    try:
        torch.empty(4 * total, dtype=torch.uint8, device="cuda")
    except Exception as e:   # the error under test, classified below
        err = (type(e).__name__, str(e)[:200], classify(e))
    torch.cuda.empty_cache()
    emit({"phase": "real_oom", "bytes": 4 * total,
          "error": None if err is None else err[0],
          "message": None if err is None else err[1],
          "classified": None if err is None else err[2]})
    check(err is not None and err[2] == "oom",
          f"an allocation of {4 * total} bytes gave {err}, not an oom")


def golden_subset(label, name, lines, size):
    """``size`` seeded queries of the run's output against golden.fast,
    byte for byte (the oracle's text is computed once per configuration
    and size)."""
    import numpy as np
    from dmlp_tpu_torch.golden.fast import knn_golden_fast
    from dmlp_tpu_torch.io.grammar import subset_queries
    from dmlp_tpu_torch.io.report import format_results

    c = CONFIGS[name]
    t0 = time.perf_counter()
    idx = np.sort(np.random.default_rng(c["seed"]).choice(
        c["num_queries"], size, replace=False))
    if (name, size) not in _ORACLE:
        ref = knn_golden_fast(subset_queries(config_input(name), idx))
        for j, r in enumerate(ref):
            r.query_id = int(idx[j])
        _ORACLE[name, size] = format_results(ref)
    ok = _ORACLE[name, size] == "".join(lines[i] + "\n" for i in idx)
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
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
        top = sorted(((k[:60], v) for k, v in by_name.items()),
                     key=lambda kv: -kv[1])[:8]
        kernel_ms = {k: sum(v for n, v in by_name.items() if k in n)
                     for k in ("extract_topk_kernel", "extract_merge_kernel",
                               "dist_segmin_kernel")}
        syncs = [e for e in events if e.name == "aten::_local_scalar_dense"]
        emit({"phase": "profile", "run": label, "wall_ms": wall_ms,
              "engine_phases_ms": engine.last_phase_ms,
              "repairs": engine.last_repairs,
              "device_busy_ms": busy_us / 1e3,
              "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
              "host_scalar_reads": len(syncs),
              "host_scalar_read_ms": sum(
                  e.time_range.elapsed_us() for e in syncs) / 1e3,
              "kernel_device_ms": kernel_ms,
              "device_ms_by_name": dict(top)})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
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
    import tempfile

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
    summary, sweep_inputs, g_inputs = {}, None, None
    if "kernels" in phases:
        summary, sweep_inputs = kernel_cases(args.reps)
    if "segmin" in phases:
        g_inputs = segmin_cases(summary, args.reps)
    tmp = tempfile.TemporaryDirectory()
    tune_path = None
    if "tune" in phases:
        check(sweep_inputs is not None and g_inputs is not None,
              "the tune phase needs the kernels and segmin phases")
        tune_path = phase_tune(sweep_inputs, g_inputs, tmp.name)
        del sweep_inputs, g_inputs
    launches = main_path(tune_path) if "main" in phases else {}
    if "real_oom" in phases:
        real_oom()
    if "profile" in phases:
        profile_main_path()
    if summary:
        rows = []
        for name in (n for n in KERNELS if n in summary):
            s = summary[name]
            per_path = {run: n[name] for run, n in launches.items()
                        if n[name]}
            rows.append({"name": name, "route": "cuda",
                         "source": SOURCES[name],
                         "replaces": REPLACES[name],
                         "launches": sum(per_path.values()),
                         "launches_by_path": per_path,
                         "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                         "ms_shape": s["shape"],
                         "plain_ms": s["plain_ms"],
                         "bound_ms": s["bound"]["bound_ms"],
                         "bound_by": s["bound"]["bound_by"],
                         "library_ms": None,
                         **({"ms_by_shape": s["ms_by_shape"]}
                            if "ms_by_shape" in s else {})})
        print(json.dumps({"kernels": rows}), flush=True)
    tmp.cleanup()
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    check(phases >= set(PHASES),
          "a partial run (--phases) prints no result line")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
