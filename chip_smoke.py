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
   multi-pass first pass, and at the mesh path's per-rank shapes (config
   3's shard fresh and carried, the wide-k bulk on the (4, 2) mesh, config
   5's 32-attribute shard); on the integer ``tie_grid`` (exact f32 sums) the
   sorted (distance, id) pairs equal the plain version's with
   ``torch.equal`` at both S; at each main-path shape the per-block time
   ``block_us`` (a full S = 1 launch against a one-block one, over the
   blocks a CTA sweeps after its first and the waves of the grid) and
   ``tile_block_us`` (K2 at S = 1 from a carry of zeros, which no distance
   passes: the tile and its ballots without a merge); the merge of the
   split lists (bit for bit against its plain version, with ``ms``
   through the wrapper and ``kernel_ms``, the kernel alone launched back
   to back), and at four main-path cases (``MERGE_VARIANTS``) also with
   the carry and the first partial list out of order, which the kernel
   sorts itself, and with one partial list fewer where that makes the
   list count odd;
   ``kernel_case`` of the ``segmin`` phase: K3 (``dist`` and ``segmin``
   under ``ops.extract.list_tolerance``, +inf exactly where ids < 0,
   ``segmin`` bit for bit against the kernel's own tile) at its two
   main-path shapes (the wide-k mix's outliers in f32 and bf16, config
   2's seg step), at a rank's outlier fold on the (4, 2) mesh, and at
   edge shapes (13 rows with all-sentinel segments;
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
   ``obs``: observability (``dmlp_tpu_torch.obs``) on the card — config 4
   (K1 and its merge) and config 2 with ``--select seg`` (K3) through
   ``cli.main`` with ``--warmup --trace --metrics --counters --telemetry
   --telemetry-port 0``: stdout equal to the flag-free solve's, the trace
   and metrics passing ``tools/check_trace.py``, a ``GET /metrics``
   scrape taken while the session is open passing
   ``validate_openmetrics``, each kernel's recorded launches equal to the
   timed solve's share of ``LAUNCHES`` and to its plan, K1's and the
   merge's FLOPs equal to ``obs.kernel_cost``'s sum over the launches
   (K1's with the measured ``iters``), and each kernel's bound share (the
   least time of its modeled bytes and products over its CUDA-event
   device time) at most 1.05; one ``obs`` line with each kernel's
   achieved FLOP/s, its share of the peak and its bound share, and config
   4's ``Time taken`` with every flag on and with none (3 runs each,
   interleaved);
   ``mesh``: whether NCCL takes two ranks of one communicator on one card
   (two processes, recorded, not checked); the CLI refusing 8 NCCL ranks
   on one card without ``--backend gloo``; then the mesh engines through
   ``cli.main`` on the card (this process is rank 0): bench config 4 on a
   (1, 1) mesh on NCCL, sharded and ring, each printing the single-device
   config-4 solve's bytes; bench config 3 (config 2's data on a (4, 2)
   mesh, 8 ranks on cuda:0 with gloo), sharded and ring, and sharded with
   ``DMLP_TPU_FUSED=0`` (K2 in the chunk fold), and config 2's
   data with k in 1..1024 (the router's wide-k outliers through K3 in each
   rank's outlier fold), sharded, each printing the bytes of the
   single-device solve of the same input; each run solves once untimed
   first (``--warmup``: every rank's first launches and allocations stay
   out of ``Time taken``), and its line holds ``Time
   taken``, rank 0's phases and every rank's (``stage_enqueue``, ``fold``,
   ``merge``, ``gather``, ...), the backend, the rank -> device map,
   ``last_hetk``, ``last_prune``, the repairs and each rank's kernel
   launches, which must be the plan's (K1 once per chunk of its shard, a
   merge where S > 1, K3 per chunk for the outliers; twice, for the
   warm-up) and at a shape the kernels and segmin phases held; then bench
   config 5 (50,000 x 2,000 x 32, k in 1..24) through ``python -m
   dmlp_tpu_torch.distributed --supervise 2 --backend gloo``, whose rank
   0 stdout must equal the float64 oracle's in full, with no relaunch, K1
   launched by both ranks at a held shape, and the queries the ranks
   rescore exactly (summed over ranks) counted. Every mesh run holds a
   1,000-query subset against the oracle and repairs at most 1% of its
   queries; config 3's sharded run also writes ``--metrics``, whose
   ``comms`` block (every rank's record, equal on every rank) must equal
   ``obs.comms``' analytic bytes for the (4, 2) mesh;
   ``serve`` (before it, the kernels phase holds K1/K2 at every resident
   chunk shape of every warmed (qpad, kcap), the multi-pass first and
   resident passes at every qpad, and a carry folded from a later chunk,
   uniform and on an exact tie grid chained over three chunks; the segmin
   phase K3 at the stream bucket): ``python -m dmlp_tpu_torch.serve
   --pallas`` in a subprocess over bench config 4's corpus at capacity
   262,144 (one resident buffer, 6 chunks of 43,776 rows), every bucket a
   coalesced batch of up to 1,024 queries can take warmed first; a seeded
   40-request trace (queries per request straddling the 32-row buckets, k
   in 1..32, some per-query ks, four k = 1,024 requests on the multi-pass
   bucket) replayed over 4 connections, 1,000 seeded queries of the
   responses against the float64 oracle; the builds and kernel library
   loads unchanged by the warmed replay; every micro-batch's launches
   (from the daemon's ``batch_log``) equal to its plan (K1 per non-empty
   chunk the prune kept, the multi-pass passes, a merge per launch at S >
   1) and at shapes the kernels phase held; at most 1% of queries
   repaired; two wire ingests of 12,000 rows (the second across a chunk
   boundary) and a second replay over the grown corpus with no new build
   and the touched chunks' summaries rebuilt; an ``oom`` fault at
   ``serve.admit`` that sheds exactly one request with the ladder
   untouched; a second daemon whose ``--faults`` schedule lands one batch
   on ``tuned`` (K2) and one on ``streaming`` (K3 over the resident
   buffer), both golden; each daemon drained by SIGTERM with exit code 0;
   the first daemon runs with ``--telemetry --telemetry-port 0`` and one
   ``--slo`` objective: after the replay its ``GET /metrics`` validates,
   the request latency histogram counts every request served, ``stats``
   carries the SLO block, and every micro-batch's launches recorded by
   the session's cost probe equal its logged launches;
   one ``serve`` line with the cold start, the buckets and paths,
   requests/s, latency quantiles, phase times per path, the gate and
   prune stats, launches by kernel and peak memory beside the model;
   ``real_oom``: an allocation of four times the card's memory, outside
   the engine, raises an error that ``resilience.retry.classify`` calls
   "oom";
   ``profile``: the timed regions of config 4 and config 2's seg solve
   once more under torch.profiler —
   device time by kernel (the split kernel, the merge and K3 by name),
   device busy time, idle share, and the host's blocking reads;
3. one ``{"kernels": [...]}`` line: per kernel its route, source, the TPU
   kernel it replaces, main-path launches (in all and per path, the serve
   replays' and the ladder daemon's included, and the bench phase's: one
   timed solve per run from the runs' own counters, the driver's device
   solves), max
   error, time and the shape it is from, plain time, the bound
   (``obs.kernel_cost``'s bytes over 3.35 TB/s or its operations over the
   peak for their type, whichever is larger, from ``obs.counters``' H100
   row) and the library time (the merge's: one stable ``torch.sort`` of
   the carry and the partial lists side by side and the first kc columns
   gathered, equal to the kernel's lists bit for bit on lists in the
   merge's key order and in distances on lists out of order, where it
   breaks ties by position; timed at every merge case, with each case's
   ``ms_over_library_ms`` in ``library_ms_by_case``; a yardstick the port
   never calls; no single PyTorch call
   computes K1/K2's or K3's function); K1's row also has its time at
   S = 1 and at the chosen S at each main-path shape and its times,
   plain time and bound at each mesh shape, K3's its times, bound shares
   and ``sgemm_ms`` at each main-path shape, the mesh's outlier fold and
   the auto engine's folds (the auto phase's runs are among
   ``launches_by_path``);
4. ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The ``fleet`` phase (after ``serve``; ``--phases
build,kernels,segmin,fleet`` runs it with the shapes it needs held, and
the segmin phase also holds K3 at the mesh replica's stream blocks,
qpad x 65,536 x 64 for every qpad 32..1,024): config 4's corpus at
capacity 262,144 in (1) a plain replica (``--pallas``) and a
mesh-resident replica (``--mesh 2x1 --backend gloo --pallas``: 2 ranks on
cuda:0, 3 chunks of 43,776 rows each), started together and every bucket
warmed, behind ``python -m dmlp_tpu_torch.fleet`` (each one's cold start
and time to ready printed); (2) the serve trace replayed through the
router closed-loop over 4 connections, 1,000 seeded queries against the
oracle, both replicas serving, every micro-batch's launches the plan's
(on the mesh replica every rank's: K1 per non-empty piece of its shard
the live mask kept and a merge per launch at S > 1, or K3 per block and
query block on the stream path) at held shapes, builds and kernel loads
flat after ready; (3) the same trace paced at 50 ms a request, replayed
open-loop at x1 and x2 (``fleet.loadgen`` RunRecords: p50/p95/p99,
requests/s), then 16 paced requests with rids under a client tracer; (4)
24,000 rows ingested through the router, both replicas' corpus
signatures equal to the fold of the grown corpus, a replay against the
grown oracle; (5) the router's ``GET /metrics`` valid, its request
latency count the replicas' summed served requests, its latency buckets
the bucket-wise merge of the replicas' scrapes; (8) one in-band drain:
every process exits 0, no flight dump; (6) ``tools/merge_traces.py
--fleet`` and ``tools/check_trace.py --fleet`` (subprocesses) pass on the
router's, replicas' and client's traces with the median residual within
the tool's 75 ms; (7) a supervised fleet of 2 plain replicas, one
SIGKILLed during a 30-request wave (every response the oracle's, a crash
and a relaunch counted, the revived fleet golden, the drain exit 0), a
static fleet whose second replica drops an ingest under a seeded
``serve.ingest`` fault (reported to the client, repaired by the prober,
signatures equal, golden, drain exit 0) and a mesh replica whose worker
rank is SIGKILLed (its daemon exits non-zero within the 30 s group
timeout), all three started together. The capacity re-split is left to
the CPU tests (it would replay about 224,000 rows over the wire).

The ``auto`` phase (after ``fleet``; ``--phases build,kernels,segmin,auto``
runs it with the shapes it needs held, and the segmin phase also holds K3
at the auto engine's folds, 2,504 x 25,600 x 64 and 10,000 x 50,176 x 64):
the compiler-sharded engine (``--mode auto``: the shards placed as
DTensors, each rank's fold through the "seg" select, K3, and the merge a
DTensor redistribution) on bench config 3 at (4, 2) (8 gloo ranks on
cuda:0) and bench config 4 at (1, 1) on NCCL, each with ``--warmup``,
stdout equal to the single-device solve's and to the mesh phase's sharded
run and the oracle's on a subset, every rank's K3 launches the plan's
(``engine.auto.plan_auto``: 1 a rank at config 3, 4 at config 4, twice
with the warm-up) at a held shape; ``--hlo-report`` on config 3 at (4, 2)
for sharded, ring and auto: the record of the collectives every rank
issued (``obs.hlo``) within the reconcile's bounds of ``obs.comms``, the
merge's kind at ratio 1, the auto engine's all-gather bytes, all on the
data axis, equal to the all-gather model's of its plan (config 3's runs,
sharded and ring with K1 too, are the bench phase's ``bench 3
--auto-ab`` arms, each held there as here); then ``python -m
dmlp_tpu_torch.serve --mesh 2x1
--mesh-merge auto --backend gloo --pallas`` over config 4's corpus (the
fleet phase's capacity and layout), its warmed buckets and the serve
trace's first 15 requests each rank's launches the plan's at held shapes,
every response the oracle's (1,000 seeded queries), drained with exit 0.

The ``train`` phase (after ``auto``; ``--phases build,train`` runs it
alone, about 60 s after the build) drives the train extension
(``dmlp_tpu_torch.train``), which launches no hand-written kernel (every
run's launch counts are checked to stay 0): ``train.bench`` at the
reference's benchmark width (1024, 8192, 8192, 1024; batch 8,192) in
bf16 and f32, with its step time, samples/s, MFU against the bf16 peak
and the allocator's peak against ``obs.memwatch.train_step_model``, the
loss finite and falling; 3 steps at (64, 512, 512, 10), batch 4,096,
on the card and on the CPU from the same parameters and batches, in f32
(losses within rtol 1e-5: a TF32 product would fail) and in bf16 (losses
within rtol 1e-5, each parameter's change within 1e-3 of its norm of the
CPU run's: only the f32 accumulation order differs); the offload levels
"params" and "all" at batch 32,768 beside the resident step, the
parameters bit for bit after 3 steps, ``memory_allocated`` between steps
lower by exactly the offloaded (pinned) bytes, each step's peak, the
bench's step times and the host link's copy rates; the loop CLI
(``train.loop.main``) for 200 steps, ``--resume`` for 50 (step 250), and
a ``nan`` fault at step 5 under ``--nan-guard`` whose ``params_checksum``
equals the fault-free run's; the loop on a (2, 2) mesh of 4 gloo ranks on
cuda:0 in f32 and in bf16 (each rank's local bf16 products; one spawn of
4 ranks runs both), its losses
the (1, 1) run's within rtol 2e-5, the second step's time beside the
(1, 1) run's, every rank's parameters on the card, the collective
record's dp all-reduce bytes ``obs.comms``' model plus the replicated row
biases (2,048 bytes), and the tp all-reduces listed as unmodelled.

The ``train_parallel`` phase (after ``train``; ``--phases
build,train_parallel`` runs it alone, about 190 s after the build) drives
the pipeline and MoE families (``dmlp_tpu_torch.train.pipeline`` and
``.experts``), which launch no hand-written kernel either: first a probe
of gloo's send/recv and all-to-all on CUDA tensors between two ranks on
cuda:0 (what raises, crashes or works; the port stages both through host
memory under gloo regardless); then one spawn of 8 gloo ranks sharing
cuda:0 for the rest: the loop CLI's main at the reference's benchmark
widths, 3 steps each: GPipe and
interleaved (V = 2) dp_pp at (2, 4) and dp_pp3 at (2, 2, 2), dims 64,
2048, 16, batch 512, M = 4; the dense and the a2a (cf 1.25) dp_ep at (2,
4), dims 64, 512, 2048, 16, 8 experts, batch 4,096 — losses finite and
falling, the later steps' ``step_time_ms``, ``schedule_ticks`` and
``bubble_fraction``, every rank's parameters on cuda:0 with 0 launches,
and the first step's collective record equal to ``obs.comms.
train_step_comms`` for what it prices, the backward it leaves out stated
beside it; each family at a small width on the card and on the CPU from
the same parameters and batches (losses within rtol 1e-5) and
``train.dryrun.dryrun_train`` on the card; the weak-scaling sweep at 1,
2, 4 and 8 ranks.

The ``bench`` phase (after ``train_parallel``; ``--phases build,bench``
runs it alone, about 400 s after the build) drives the port's tooling
through its entry points, each a subprocess, into a temporary directory
(never the repository's root): ``python -m dmlp_tpu_torch.bench 4 --reps
3 --counters --fused-ab`` (checksums PASS on every run against the
bench's own float64 oracle, ``Time taken`` median and range, K1's
launches per timed solve from the counters, 4, and K2's in the
``DMLP_TPU_FUSED=0`` arm, 4, each with 4 merges); ``bench 4 --reps 3``
again, and ``python -m dmlp_tpu_torch.perf_gate`` over both rounds:
``harness/config4/engine_ms`` qualified (3 trials a side, one device), its
verdict printed, not required; ``bench 3 --auto-ab`` (8 gloo ranks on
cuda:0: auto, sharded and ring byte-equal to the oracle, each rank's K3
launches in the auto arm the plan's at a held shape, K1's in the others,
each arm's ``--hlo-report`` record reconciled); ``bench serve`` over
``inputs/serve_trace1.jsonl`` with ``--pallas`` (every response golden,
both gate-carry arms); ``python -m dmlp_tpu_torch.bench.driver`` at its
defaults (``device_solve_ms_extract``: K1 over the padded dataset,
``_seg``: the seg fold through K3, with their launches); ``python -m
dmlp_tpu_torch.report --min-coverage 1.0`` over the records, each naming
this card. The script sets ``$DMLP_TPU_COMPILE_CACHE`` to a fresh
temporary directory before the build phase: every later process loads the
libraries from it, which must not change after the build, and the
package's own ``_build/`` must stay as it was.

The ``check`` phase (after ``main``; ``--phases build,check`` runs it
alone, solving its plain twins itself) starts the static checker,
``python -m dmlp_tpu_torch.check --json --no-cache``, over the tree the
build phase compiled, and beside it the same over a copy of the tree
with two teeth (R802 on ``extract_topk.cu`` without its ``lowp-eps``
annotations, R101 on the mesh engine's data group moved to an
undeclared axis); both run on the host's spare cores while the phase's
card work goes on, and its ``check_static`` line (the families, files,
findings and seconds) comes last: exit 0 and 0 findings required, the
``.cu`` bytes R8 scanned those whose ``kernels.source_hash`` names the
loaded libraries, and both teeth biting. The card work drives the
checker's runtime half: a ``sync_probe`` line (which of
``torch.cuda.synchronize``,
``Event.synchronize``, ``Stream.synchronize``, ``.cpu()``, ``.item()``,
``nonzero``, an unpinned and a pinned ``.to("cuda")`` the card's
``torch.cuda.set_sync_debug_mode("error")`` flags); the sanitizer's teeth
(a seeded ``.item()`` and a seeded ``torch.nonzero`` of CUDA tensors inside
``check.sanitize.sanitized()`` must raise, the explicit ``readback``
must not); config 4 ``--pallas --sanitize`` (K1) and config 2 ``--select
seg --pallas --sanitize`` (K3) through ``cli.main``, each ``cmp``-equal to
the main phase's plain stdout of the same input with the same launch
counts, ``Time taken`` sanitized beside plain, and the deliberate syncs
each took by site; a sanitized 3-step train run against its plain twin
(resident and with parameter offload, losses within 1e-6 relative);
and ``python -m dmlp_tpu_torch.check.race_stress --device cuda --pallas``
(a 2,000-row daemon, K1 over its resident chunks,
under the race sanitizer: every response the oracle's, 0 inversions, 0
blocking calls under a lock).

``--phases`` and ``--reps`` narrow a run while developing (``--phases
build,segmin`` holds and times K3 alone; ``--phases build,mesh`` solves
the single-device references itself; ``tune`` needs ``kernels`` and
``segmin``; ``serve`` checks its launch shapes against what ``kernels``
held, so ``--phases build,kernels,segmin,serve``); the default runs
everything.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import zlib

# The H100's row of the port's peak table (dmlp_tpu_torch.obs.counters:
# the published SXM data-sheet rates, dense): every bound below is this
# card's, whatever card the run lands on (the run prints the card's name).
H100 = "NVIDIA H100 80GB HBM3"

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
    # Config 2's sizes with k in 1..1024 (the wide-k mix's rule), and
    # bench config 5 (configs.py:69): the mesh phase's inputs.
    "widek_config2": dict(num_data=100_000, num_queries=5_000, num_attrs=64,
                          attr_min=0.0, attr_max=100.0, min_k=1,
                          max_k=1024, num_labels=10, seed=42),
    "config5": dict(num_data=50_000, num_queries=2_000, num_attrs=32,
                    attr_min=0.0, attr_max=100.0, min_k=1, max_k=24,
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
# Main-path merge cases also held with lists out of order and, where
# their list count is even, with one partial list fewer (merge_variants).
MERGE_VARIANTS = ("config4_carried_f32", "widek_bulk_carried",
                  "multipass_first_carried", "serve_carry_above")
# K1's and K3's per-rank shapes on the mesh path: kernel case -> the label
# of its row in PERF.md. The mesh phase checks that every mesh run launches
# at a shape the kernels and segmin phases held.
# K3's per-rank shapes on the auto engine's path (engine.auto.plan_auto):
# kernel case -> the label of its row in PERF.md. The auto phase checks
# that every auto run launches K3 at a shape the segmin phase held.
AUTO_SHAPES = {"auto_config3_rank": "auto, config 3 at (4, 2), a rank's "
                                    "block",
               "auto_config4_block": "auto, config 4 at (1, 1), a block"}
MESH_SHAPES = {"mesh_config3_fresh": "config 3, a rank's shard",
               "mesh_config3_carried": "config 3, carried",
               "mesh_widek_bulk": "wide-k bulk on the (4, 2) mesh",
               "mesh_config5": "config 5, a rank's shard",
               "mesh_outlier_f32": "wide-k outliers on the (4, 2) mesh"}
# The serve phase's replay: request sizes that straddle the port's query
# buckets (granule 32), k in 1..32 (some requests with per-query ks), and
# four k = 1,024 requests for the wide-k bucket; the daemon warms every
# (qpad, k-bucket) a coalesced batch of up to 1,024 queries can take.
SERVE_NQ = (1, 7, 8, 9, 31, 32, 33, 127, 128, 129, 500, 1024)
SERVE_WIDE_NQ = (32, 64, 128, 256)
SERVE_QPADS = (32, 64, 128, 256, 512, 1024)
SERVE_KBS = (1, 2, 4, 8, 16, 32, 1024)
SERVE_GOLDEN_QUERIES = 1000
# The fleet phase's mesh replica: (data, query) shape, 2 ranks on cuda:0,
# and the flags of every replica it starts.
FLEET_MESH = (2, 1)
FLEET_FLAGS = ("--pallas",)
# (qb, b, na, kc) of every K1/K2 case and (qb, b, na) of every K3 case held
# against its plain version in this run.
HELD = {"k1": set(), "k3": set()}
# At most this share of a run's queries may go to the float64 host oracle
# (the boundary repair): the rest must come from the device's lists.
MAX_REPAIR_SHARE = 0.01
# Timed calls of a K1/K2 case's plain version (after its warm-up call).
PLAIN_REPS = 1
PHASES = ("build", "kernels", "segmin", "tune", "main", "check", "obs",
          "mesh", "serve", "fleet", "auto", "train", "train_parallel",
          "bench", "real_oom", "profile")
_TEXTS: dict = {}
# stdout of the single-device solves, by run (the main and mesh phases)
OUTPUTS: dict = {}
# the main phase's Time taken ms and launches, by run
MAIN_TIMES: dict = {}
MAIN_LAUNCHES: dict = {}
_INPUTS: dict = {}
_ORACLE: dict = {}


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, stamped with the script's seconds so far."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


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
    summary, by_shape, mesh_by_shape, sweep_inputs = {}, {}, {}, {}

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
        HELD["k1"].add((q.shape[0], d.shape[0], q.shape[1], kc))
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
                # One timed call after the warm-up: the plain version's
                # time is a yardstick, and at the multi-pass shapes one
                # call takes about a second.
                plain_ms, (pd, pi, pit, parts) = time_ms(
                    lambda: plain(gate, splits), PLAIN_REPS)
                torch.cuda.synchronize()
                plain_out[splits] = (pd, pi)
                cmp = ex.compare_lists(out[0], out[1], pd, pi, tol)
                cmp["iters_equal"] = bool(torch.equal(out[2], pit))
                res[splits] = (ms, plain_ms, out, cmp)
                if gate and parts is not None:
                    merge_case(summary, name, cd, ci, *parts, reps,
                               main=name == "multipass_floor")
                    if name in MERGE_VARIANTS:
                        merge_variants(summary, name, cd, ci, *parts, reps)
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
            if gate and name in MESH_SHAPES:
                mesh_by_shape[MESH_SHAPES[name]] = {
                    "shape": rec["shape"], "splits": chosen,
                    "carry": carry is not None, "ms": ms, "ms_s1": ms1,
                    "plain_ms": plain_ms, "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"]}
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
    # The mesh path, per rank: a 25,000-row shard in one chunk of 25,088
    # rows (88 sentinel rows), rank 1's ids (from 25,000); zero query
    # padding. Config 3 on (4, 2): 2,500 queries (qloc 2,528) at config
    # 2's kc, and carried as a second chunk would be; the wide-k mix on
    # (4, 2): 1,098 bulk queries (qloc 1,120) at kc 512; config 5 on (2, 1):
    # 2,000 queries (2,016) over 32 attributes at its kc.
    c2, c5 = CONFIGS["config2"], CONFIGS["config5"]
    shard = c2["num_data"] // 4
    rows3 = single.round_up(shard, cfg.resolve_granule("extract"))
    q3 = uniform((single.round_up(c2["num_queries"] // 2, ex.QUERY_TILE),
                  na), 21)
    q3[c2["num_queries"] // 2:] = 0.0
    d3, d3b = uniform((rows3, na), 22), uniform((rows3, na), 23)
    kc3 = single.resolve_kcap(cfg, c2["max_k"], "extract", 1 << 30)
    first = run_case("mesh_config3_fresh", q3, d3, n_real=shard,
                     id_base=shard, kc=kc3)
    run_case("mesh_config3_carried", q3, d3b, n_real=shard,
             id_base=2 * shard, kc=kc3, carry=first[:2], d_prev=d3)
    qwm = q3[:1120].clone()
    qwm[1098:] = 0.0
    run_case("mesh_widek_bulk", qwm, d3, n_real=shard, id_base=shard,
             kc=512)
    del q3, d3, d3b, qwm
    shard5 = c5["num_data"] // 2
    q5 = uniform((single.round_up(c5["num_queries"], ex.QUERY_TILE),
                  c5["num_attrs"]), 24)
    q5[c5["num_queries"]:] = 0.0
    d5 = uniform((single.round_up(shard5, cfg.resolve_granule("extract")),
                  c5["num_attrs"]), 25)
    run_case("mesh_config5", q5, d5, n_real=shard5, id_base=shard5,
             kc=single.resolve_kcap(cfg, c5["max_k"], "extract", 1 << 30))
    del q5, d5
    serve_kernel_cases(run_case, uniform, reps)
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
    summary["fused_topk"]["ms_by_mesh_shape"] = mesh_by_shape
    return summary, sweep_inputs


def serve_geometry():
    """The serving engine's resident layout for config 4's corpus at the
    default capacity (shape_bucket(200,000) = 262,144 rows), computed with
    the engine's own planning functions: the extraction chunks, the
    streaming blocks, and each k-bucket's candidate width."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine import single
    from dmlp_tpu_torch.tune.cache import shape_bucket
    cfg = EngineConfig(use_pallas=True)
    cap = shape_bucket(CONFIG4["num_data"])
    select = cfg.resolve_streaming_select(single.round_up(cap, 8))
    block = single.fit_blocks(cap, cfg.resolve_data_block(select),
                              granule=cfg.resolve_granule(select))
    rows = single.round_up(cap, block)
    _, nchunks, chunk_rows = single.plan_chunks(
        rows, cfg.resolve_granule("extract"), None)
    return {"capacity_rows": rows, "data_block": block,
            "nchunks": nchunks, "chunk_rows": chunk_rows,
            "ex_rows": nchunks * chunk_rows,
            "kcap": {kb: single.resolve_kcap(cfg, kb, select, rows)
                     for kb in SERVE_KBS}}


def fleet_mesh_geometry():
    """The mesh replica's per-rank layout for config 4's corpus at the
    default capacity over R = 2 data shards, from the engine's own
    planning functions: each shard's extraction chunks and its stream
    path's blocks."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine import single
    from dmlp_tpu_torch.tune.cache import shape_bucket
    cfg = EngineConfig(use_pallas=True)
    per_shard = -(-shape_bucket(CONFIG4["num_data"]) // FLEET_MESH[0])
    shard_rows, nchunks, chunk_rows = single.plan_chunks(
        per_shard, cfg.resolve_granule("extract"), None)
    select = cfg.resolve_streaming_select(single.round_up(shard_rows, 8))
    block = single.fit_blocks(shard_rows, cfg.resolve_data_block(select),
                              granule=cfg.resolve_granule(select))
    return {"shard_rows": shard_rows, "nchunks": nchunks,
            "chunk_rows": chunk_rows, "data_block": block,
            "stream_rows": single.round_up(shard_rows, block),
            "query_block": cfg.query_block,
            "kcap": {kb: single.resolve_kcap(cfg, kb, "extract",
                                             FLEET_MESH[0] * shard_rows)
                     for kb in SERVE_KBS}}


def serve_kernel_cases(run_case, uniform, reps):
    """K1/K2 at the serving engine's resident shapes: every chunk shape at
    every warmed (qpad, kcap) and the multi-pass first pass and resident
    pass (with its floor, over all the chunks' rows) at every qpad, held
    against the plain version at the chosen S and at S = 1; the carry
    folded from a later chunk (hot-chunks-first order) timed in full, on
    uniform data and on an exact integer tie grid chained over three
    chunks."""
    import torch
    from dmlp_tpu_torch.engine import single
    from dmlp_tpu_torch.ops import extract as ex
    from dmlp_tpu_torch.serve.engine import query_bucket
    from dmlp_tpu_torch.tune.sweep import sorted_lists

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = serve_geometry()
    na, cr, full = CONFIG4["num_attrs"], geo["chunk_rows"], geo["ex_rows"]
    n = CONFIG4["num_data"]

    def hold(name, q, d, *, n_real, id_base, kc, gate=True, floor=None):
        """The kernel against the plain version at the chosen S and at
        S = 1 (lists under compare_lists' tolerance, iters exactly), the
        two S's sorted lists bit for bit; its time at the chosen S."""
        kw = dict(n_real=n_real, id_base=id_base, kc=kc, floor=floor,
                  mxu_gate=gate)
        tol = ex.list_tolerance((q * q).sum(-1),
                                float((d * d).sum(-1).max()), na)
        chosen = ex.choose_splits(q.shape[0], d.shape[0], kc, sm_count)
        outs, cmps = {}, {}
        for splits in dict.fromkeys((chosen, 1)):
            outs[splits] = ex.extract_topk(q, d, splits=splits, **kw)
            t0 = time.perf_counter()
            pd, pi, pit = ex.extract_topk_plain(q, d, splits=splits, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            cmps[splits] = ex.compare_lists(*outs[splits][:2], pd, pi, tol)
            cmps[splits]["iters_equal"] = bool(torch.equal(
                outs[splits][2], pit))
        same = all(torch.equal(a, b) for a, b in zip(
            sorted_lists(*outs[chosen][:2]), sorted_lists(*outs[1][:2])))
        ms, _ = time_ms(lambda: ex.extract_topk(q, d, splits=chosen, **kw),
                        max(1, reps // 2))
        HELD["k1"].add((q.shape[0], d.shape[0], na, kc))
        rec = {"phase": "kernel_case", "case": name,
               "kernel": "fused_topk" if gate else "extract_topk",
               "shape": [q.shape[0], d.shape[0], na, kc], "splits": chosen,
               "floor": floor is not None, "ms": ms, "plain_ms_s1": plain_ms,
               "max_abs_err": max(c["max_abs_err"] for c in cmps.values()),
               "splits_identical": same,
               **bound(q, d, kc, outs[1][2], gate, False, "f32")}
        emit(rec)
        for splits, c in cmps.items():
            check(c["ok"] and c["iters_equal"],
                  f"{name}/S={splits}: kernel disagrees with the plain "
                  f"version {c}")
        check(same, f"{name}: S={chosen} and S=1 sorted lists differ")
        return outs[chosen]

    d = [uniform((cr, na), 40 + c) for c in range(3)]
    # The warm-up's bucket for the corpus file's own 10,000 queries.
    qfile = query_bucket(CONFIG4["num_queries"], ex.QUERY_TILE)
    hold(f"serve_chunk_q{qfile}_kc{geo['kcap'][32]}",
         uniform((qfile, na), 38), d[0], n_real=cr, id_base=0,
         kc=geo["kcap"][32])
    qmax = uniform((max(SERVE_QPADS), na), 39)
    for qpad in SERVE_QPADS:
        q = qmax[:qpad].contiguous()
        for kc in sorted(set(geo["kcap"][kb] for kb in SERVE_KBS
                             if geo["kcap"][kb] <= ex.KC_MAX)):
            for gate in ((True, False) if qpad == SERVE_QPADS[0]
                         else (True,)):
                hold(f"serve_chunk_q{qpad}_kc{kc}", q, d[0], n_real=cr,
                     id_base=0, kc=kc, gate=gate)
    # The carry from a later chunk, timed in full (both gates, both S):
    # chunk 2 fresh, then chunk 0 with its lists, as the hot-first order
    # folds them.
    q = qmax[:SERVE_QPADS[0]].contiguous()
    kc = geo["kcap"][32]
    first = run_case("serve_fresh_chunk2", q, d[2], n_real=cr,
                     id_base=2 * cr, kc=kc)
    run_case("serve_carry_above", q, d[0], n_real=cr, id_base=0, kc=kc,
             carry=first[:2], d_prev=d[2])
    # The exact tie grid chained chunk 2 -> 0 -> 1: the third launch's
    # carry holds tie groups whose ids do not ascend in slot order.
    qt = uniform((SERVE_QPADS[0], na), 46, 3, True)
    dt = [uniform((cr, na), 47 + c, 3, True) for c in range(3)]
    first = run_case("serve_tie_chunk2", qt, dt[2], n_real=cr,
                     id_base=2 * cr, kc=kc, exact=True)
    second = run_case("serve_tie_carry_above", qt, dt[0], n_real=cr,
                      id_base=0, kc=kc, carry=first[:2], d_prev=dt[2],
                      exact=True)
    run_case("serve_tie_carry_mixed", qt, dt[1], n_real=cr, id_base=cr,
             kc=kc, carry=second[:2], d_prev=dt[0], exact=True)
    del qt, dt
    # The multi-pass bucket (k-bucket 1,024): the first pass per chunk and
    # the resident pass over all the chunks' rows with a floor from
    # _mp_floor, at every qpad.
    dfull = torch.cat([d[0], d[1], d[2], uniform((full - 3 * cr, na), 45)])
    for qpad in SERVE_QPADS:
        q = qmax[:qpad].contiguous()
        od, _, _ = hold(f"serve_mp_first_q{qpad}", q, d[0], n_real=cr,
                        id_base=0, kc=ex.KC_MAX)
        floor, _ = single._mp_floor(od, (q * q).sum(-1),
                                    (dfull * dfull).sum(-1).max(),
                                    staging="float32", na=na)
        hold(f"serve_mp_resident_q{qpad}", q, dfull, n_real=n, id_base=0,
             kc=ex.KC_MAX, floor=floor)
    del d, dfull, qmax


def merge_case(summary, name, cd, ci, part_d, part_i, reps, main=False,
               in_order=True):
    """Hold the merge kernel against its plain version on the plain
    version's partial lists: both are exact, so bit for bit. The yardstick
    (one stable ``torch.sort``) is the same function where every list is
    in the merge's key order, as the split kernel writes them, and is then
    held bit for bit too; on lists out of order (``in_order=False``) it
    breaks ties by position and the merge by id, so only its distances
    are held. Beside the wrapper's ``ms``, ``kernel_ms`` is the kernel
    alone (outputs allocated once, launches back to back)."""
    import torch
    from dmlp_tpu_torch.ops import extract as ex
    ms, (od, oi) = time_ms(lambda: ex.merge_partials(cd, ci, part_d, part_i),
                           reps)
    plain_ms, (pd, pi) = time_ms(
        lambda: ex.merge_partials_plain(cd, ci, part_d, part_i), reps)
    library_ms, (ld, li) = time_ms(
        lambda: merge_library(cd, ci, part_d, part_i), reps)
    torch.cuda.synchronize()
    same = torch.equal(od.view(torch.int32), pd.view(torch.int32)) \
        and torch.equal(oi, pi)
    library_same = torch.equal(od, ld) and (
        torch.equal(oi, li) or not in_order)
    from dmlp_tpu_torch.obs import counters, kernel_cost
    nsplit, qb, kc = part_d.shape
    lib = ex._kernel_lib()
    kd, ki = torch.empty_like(od), torch.empty_like(oi)
    args = (ex._ptr(cd), ex._ptr(ci), part_d.data_ptr(), part_i.data_ptr(),
            kd.data_ptr(), ki.data_ptr(), qb, kc, nsplit,
            ex._stream(part_d.device))
    kernel_ms = back_to_back_ms(lambda: lib.dmlp_extract_merge(*args))
    torch.cuda.synchronize()
    same = same and torch.equal(kd, od) and torch.equal(ki, oi)
    rec = {"phase": "kernel_case", "case": name, "kernel": "extract_merge",
           "shape": [qb, nsplit, kc], "carry": cd is not None,
           "lists_in_order": in_order, "ms": ms, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "identical": bool(same),
           "library_ms": library_ms, "library_identical": bool(library_same),
           "library_ids_identical": bool(torch.equal(oi, li)),
           "ms_over_library_ms": ms / library_ms,
           "max_abs_err": float((od.double() - pd.double()).abs().nan_to_num(
               0.0).max()),
           **kernel_cost.bound_ms(kernel_cost.extract_merge_cost(
               qb, kc, nsplit, cd is not None), counters.PEAKS[H100])}
    emit(rec)
    check(same, f"{name}: the merge kernel differs from its plain version")
    check(library_same, f"{name}: the torch.sort yardstick differs from "
                        "the merge kernel")
    s = summary.setdefault("extract_merge", {"max_abs_err": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"])
    s.setdefault("library_ms_by_case", {})[name] = {
        "shape": rec["shape"], "carry": rec["carry"],
        "lists_in_order": in_order, "ms": ms, "kernel_ms": kernel_ms,
        "library_ms": library_ms, "ms_over_library_ms": ms / library_ms,
        "bound_ms": rec["bound_ms"]}
    if main or "ms" not in s:
        s.update(ms=ms, plain_ms=plain_ms, bound=rec, library_ms=library_ms,
                 shape=f"{name} {rec['shape']}")


def merge_variants(summary, name, cd, ci, part_d, part_i, reps):
    """The merge's own sort path and an odd list count on a main-path
    partial set: ``_out_of_order`` permutes each row of the carry (if any)
    and of the first partial list, which the kernel must sort; ``_odd``
    drops the last partial list where 1 + S (or S without a carry) is
    even."""
    import torch
    nsplit, qb, kc = part_d.shape
    gen = torch.Generator(device=part_d.device)
    gen.manual_seed(zlib.crc32(name.encode()))
    perm = torch.argsort(torch.rand((qb, kc), generator=gen,
                                    device=part_d.device), 1)
    pd, pi = part_d.clone(), part_i.clone()
    pd[0], pi[0] = torch.gather(pd[0], 1, perm), torch.gather(pi[0], 1, perm)
    cdp = cip = None
    if cd is not None:
        cdp, cip = torch.gather(cd, 1, perm), torch.gather(ci, 1, perm)
    merge_case(summary, f"{name}_out_of_order", cdp, cip, pd, pi, reps,
               in_order=False)
    del pd, pi, cdp, cip
    if ((cd is not None) + nsplit) % 2 == 0 and nsplit > 1:
        merge_case(summary, f"{name}_odd", cd, ci,
                   part_d[:-1].contiguous(), part_i[:-1].contiguous(), reps)


def merge_library(cd, ci, part_d, part_i):
    """The merge as one library call, a yardstick the port never runs:
    one stable ``torch.sort`` of the carry and the S partial lists side
    by side (the carry first, the splits in order, so ties keep the
    merge's rule: carry slots first, then ids ascending), then the first
    kc columns and their ids gathered; -0.0 folds to +0.0 as the kernel's
    keys fold it."""
    import torch
    nsplit, qb, kc = part_d.shape
    ds_ = list(part_d.unbind(0))
    is_ = list(part_i.unbind(0))
    if cd is not None:
        ds_.insert(0, cd)
        is_.insert(0, ci.to(torch.int32))
    vals, idx = torch.sort(torch.cat(ds_, 1) + 0.0, dim=1, stable=True)
    return vals[:, :kc], torch.gather(torch.cat(is_, 1), 1, idx[:, :kc])


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
        HELD["k3"].add((qb, b, q.shape[1]))
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
    # A rank's outlier fold on the (4, 2) mesh: 1,402 of the wide-k mix's
    # outliers (qloc 1,408) against rank 1's chunk of 25,088 rows, ids
    # from 25,000 and 88 sentinels.
    qom = uniform((1408, na), 26)
    qom[1402:] = 0.0
    iota = torch.arange(25088, dtype=torch.int32, device=dev)
    case("mesh_outlier_f32", qom, uniform((25088, na), 27),
         torch.where(iota < 25000, 25000 + iota, -1),
         main=MESH_SHAPES["mesh_outlier_f32"])
    # The auto engine's folds (engine.auto.plan_auto): config 3 at (4, 2),
    # rank 1's 2,504-query shard (2,500 real) against its one block of
    # 25,600 rows (ids from 25,000, 600 sentinels); config 4 at (1, 1),
    # 10,000 queries against the last of its four 50,176-row blocks (ids
    # from 150,528, sentinels past 200,000).
    qa = uniform((2504, na), 32)
    qa[2500:] = 0.0
    iota = torch.arange(25600, dtype=torch.int32, device=dev)
    case("auto_config3_rank", qa, uniform((25600, na), 33),
         torch.where(iota < 25000, 25000 + iota, -1),
         main=AUTO_SHAPES["auto_config3_rank"])
    del qa
    rows4 = torch.arange(3 * 50176, 4 * 50176, dtype=torch.int32,
                         device=dev)
    case("auto_config4_block", uniform((10000, na), 34),
         uniform((50176, na), 35),
         torch.where(rows4 < c4["num_data"], rows4, -1),
         main=AUTO_SHAPES["auto_config4_block"])
    # The serving engine's stream fold (the "streaming" rung of a resident
    # batch): a 32-query bucket against the last 65,536-row block of the
    # resident buffer, real rows to 200,000 and sentinels past them.
    geo = serve_geometry()
    blk = geo["data_block"]
    rows = torch.arange(geo["capacity_rows"] - blk, geo["capacity_rows"],
                        dtype=torch.int32, device=dev)
    case("serve_stream", uniform((SERVE_QPADS[0], na), 28),
         uniform((blk, na), 29),
         torch.where(rows < c4["num_data"], rows, -1),
         main="serve stream bucket")
    # The mesh replica's stream path (its wide-k buckets, kcap > 512): one
    # query block of every warmed qpad against a rank's last block, shard
    # 1's rows to 200,000 real and sentinels past them.
    mgeo = fleet_mesh_geometry()
    mblk = mgeo["data_block"]
    lo = 2 * mgeo["shard_rows"] - mblk
    mrows = torch.arange(lo, lo + mblk, dtype=torch.int32, device=dev)
    dm = uniform((mblk, na), 30)
    qm = uniform((max(SERVE_QPADS), na), 31)
    for qb in SERVE_QPADS:
        case(f"fleet_mesh_stream_q{qb}", qm[:qb].contiguous(), dm,
             torch.where(mrows < c4["num_data"], mrows, -1))
    del dm, qm
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
    """Least time for one K3 launch (obs.kernel_cost's model): inputs (q,
    d, ids) read once and outputs (dist, segmin) written once over HBM
    bandwidth, against the product's operations over the peak for their
    type."""
    from dmlp_tpu_torch.obs import counters, kernel_cost
    return kernel_cost.bound_ms(kernel_cost.fused_dist_segmin_cost(
        qb, b, a, precision), counters.PEAKS[H100])


def bound(q, d, kc, iters, gate, carried, precision):
    """Least time for this launch's work (obs.kernel_cost's model): the
    larger of the bytes over HBM bandwidth (inputs read once, outputs
    written once) and the products this data needs over the peak for
    their type (with the gate on, only the tiles the gate let through,
    from ``iters``)."""
    from dmlp_tpu_torch.obs import counters, kernel_cost
    qb, na = q.shape
    cost = (kernel_cost.fused_topk_cost if gate
            else kernel_cost.extract_topk_cost)(
        qb, d.shape[0], na, kc, int(iters.sum()), precision,
        carried=carried)
    return kernel_cost.bound_ms(cost, counters.PEAKS[H100])


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
        OUTPUTS[label] = text_out
        MAIN_TIMES[label], MAIN_LAUNCHES[label] = int(m.group(1)), got
        if subset:
            golden_subset(label, name, out_lines, subset)
        if "exact" in extra:
            path = compare_device_full(label, name, records[extra["exact"]])
            check(path[0] == "extract", f"{label}: solved on {path}")
    tmp.cleanup()
    check(outputs["config4_K1"] == outputs["config4_K2_warmup"],
          "gated and ungated config-4 solves print different results")
    return launches


# The check phase's sanitized solves: (run of MAIN_RUNS, its flags).
CHECK_RUNS = (("config4_K1", ["--pallas"]),
              ("config2_seg", ["--select", "seg", "--pallas"]))


def sync_probe():
    """Which syncs the card's ``set_sync_debug_mode("error")`` flags."""
    import torch
    x = torch.arange(1024.0, device="cuda")
    host = torch.ones(1024)
    pinned = host.pin_memory()
    ops = {
        "torch.cuda.synchronize": torch.cuda.synchronize,
        "Event.synchronize": lambda: _event_sync(torch),
        "Stream.synchronize":
            lambda: torch.cuda.current_stream().synchronize(),
        ".cpu()": lambda: x.cpu(),
        ".item()": lambda: x[3].item(),
        "nonzero": lambda: torch.nonzero(x > 10),
        "unpinned .to(cuda)": lambda: host.to("cuda"),
        "pinned .to(cuda, non_blocking)":
            lambda: pinned.to("cuda", non_blocking=True),
    }
    flags = {}
    for name, op in ops.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            op()
            flags[name] = False
        except RuntimeError as e:
            check("synchroniz" in str(e), f"sync probe {name}: {e}")
            flags[name] = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit({"phase": "sync_probe", "torch": torch.__version__,
          "flagged": flags})
    return flags


def _event_sync(torch):
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()


def _sanitizer_teeth():
    """A seeded implicit readback and a seeded sync inside sanitized()
    on CUDA tensors must raise; the explicit readback must not."""
    import torch
    from dmlp_tpu_torch.check.sanitize import (ImplicitSyncError, readback,
                                               sanitized)
    x = torch.arange(64.0, device="cuda")
    caught = {}
    with sanitized():
        try:
            x[5].item()
            caught["item"] = None
        except ImplicitSyncError as e:
            caught["item"] = type(e).__name__
        try:
            torch.nonzero(x > 10)
            caught["nonzero"] = None
        except RuntimeError as e:
            caught["nonzero"] = "synchronizing" if "synchroniz" in str(e) \
                else str(e)[:120]
        got = readback(x[:4], "chip_smoke.teeth")  # check: allow-host-sync
    mode = torch.cuda.get_sync_debug_mode()
    emit({"phase": "check_teeth", "caught": caught,
          "readback": got.tolist(), "sync_debug_mode_after": mode})
    check(caught == {"item": "ImplicitSyncError",
                     "nonzero": "synchronizing"},
          f"the sanitizer missed a seeded sync on the card: {caught}")
    check(got.tolist() == [0.0, 1.0, 2.0, 3.0] and mode == 0,
          f"readback {got}, sync debug mode {mode} after the region")


def _cli_run(label, name, flags, tmp_dir, fused="1"):
    """One cli.main solve on the card as the main phase runs it (no tune
    cache file): (stdout, Time taken ms, launches, stderr lines)."""
    import torch
    from dmlp_tpu_torch import cli, kernels
    env = {"DMLP_TPU_FUSED": fused,
           "DMLP_TPU_TUNE_CACHE": os.path.join(tmp_dir, "absent.json")}
    os.environ.update(env)
    try:
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rc = cli.main([*flags, "--phase-times"],
                      stdin=io.StringIO(config_text(name)), stdout=out,
                      stderr=err)
        got = dict(kernels.LAUNCHES)
    finally:
        for k in env:
            os.environ.pop(k)
    check(rc == 0, f"{label}: cli.main returned {rc}")
    lines = err.getvalue().splitlines()
    m = re.fullmatch(r"Time taken: (\d+) ms", lines[0])
    check(m is not None, f"{label}: stderr line {lines[0]!r}")
    return out.getvalue(), int(m.group(1)), got, lines


def _sanitized_train():
    """A sanitized 3-step train run on the card against its plain twin,
    resident and with the parameters offloaded."""
    from dmlp_tpu_torch.check import sanitize
    from dmlp_tpu_torch.train.loop import train
    for label, kw in (("check_train", {}),
                      ("check_train_offload", {"offload": "params"})):
        sanitize.reset_fences()
        t0 = time.perf_counter()
        _, san = train(steps=3, batch=4096, dims=(64, 512, 512, 10),
                       log_every=1, sanitize=True, device="cuda", **kw)
        san_s = time.perf_counter() - t0
        fences = dict(sanitize.FENCED)
        _, plain = train(steps=3, batch=4096, dims=(64, 512, 512, 10),
                         log_every=1, device="cuda", **kw)
        rel = abs(san["loss"] - plain["loss"]) / abs(plain["loss"])
        emit({"phase": "check_train", "run": label, "steps": san["step"],
              "loss_sanitized": san["loss"], "loss_plain": plain["loss"],
              "rel_diff": rel, "wall_s_sanitized": san_s,
              "fenced": fences})
        check(san["step"] == 3 and rel <= 1e-6,
              f"{label}: sanitized loss {san['loss']} vs {plain['loss']}")


def _race_stress(tmp_dir):
    """``race_stress --device cuda --pallas`` (K1 over the resident
    chunks) in its own interpreter (the race sanitizer patches the lock
    factories process-wide)."""
    out = os.path.join(tmp_dir, "race")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "dmlp_tpu_torch.check.race_stress",
         "--device", "cuda", "--pallas", "--json", "--out", out],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"race_stress: {p.stderr[-3000:]}")
    v = json.loads(p.stdout)
    rc = v["racecheck"]
    emit({"phase": "check_race", "device": v["device"],
          "pallas": v["pallas"], "requests": v["requests"],
          "ingests": v["ingests"], "stats_ops": v["stats_ops"],
          "scrapes": v["scrapes"], "stress_wall_ms": v["wall_ms"],
          "locks_created": rc["locks_created"], "edges": rc["edges"],
          "inversions": rc["inversions"],
          "blocking_under_lock": rc["blocking_under_lock"],
          "engine_launches": v["engine_launches"], "wall_s": wall})
    check(v["ok"] and v["device"] == "cuda" and rc["ok"]
          and rc["inversions"] == 0 and rc["blocking_under_lock"] == 0,
          f"race_stress: {rc['violations'][:3]}")
    check(v["engine_launches"].get("fused_topk", 0) > 0,
          f"race_stress: the daemon launched {v['engine_launches']}")
    return {k: int(v["engine_launches"].get(k, 0)) for k in KERNELS}


def _start_checker(args, cwd, out_path):
    """Start ``python -m dmlp_tpu_torch.check --json --no-cache *args``
    in ``cwd`` (the package there is the one analyzed), its verdict to
    ``out_path``: (process, start time, the files)."""
    out = open(out_path, "w")
    err = open(out_path + ".err", "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "dmlp_tpu_torch.check", "--json",
         "--no-cache", *args], stdout=out, stderr=err, cwd=cwd)
    return p, time.perf_counter(), (out, err, out_path)


def _finish_checker(run):
    """(exit code, the JSON verdict, seconds) of a started checker."""
    p, t0, (out, err, path) = run
    try:
        rc = p.wait(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()
        err.close()
    secs = time.perf_counter() - t0
    with open(path + ".err") as f:
        tail = f.read()[-3000:]
    check(rc in (0, 1), f"the checker failed ({rc}): {tail}")
    with open(path) as f:
        return rc, json.load(f), secs


def _start_check_static(tmp_dir):
    """Start the static checker over the tree the build phase compiled,
    and over a copy of it with two teeth (``extract_topk.cu`` stripped
    of its ``lowp-eps`` annotations: R802; a mesh engine's data group
    moved to an undeclared axis: R101). Both run on the host's spare
    cores while the check phase's card work goes on."""
    import shutil
    root = os.path.dirname(os.path.abspath(__file__))
    copy = os.path.join(tmp_dir, "check_teeth")
    shutil.copytree(os.path.join(root, "dmlp_tpu_torch"),
                    os.path.join(copy, "dmlp_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    edits = (("kernels/extract_topk.cu", "// check: lowp-eps=lowp_eps", ""),
             ("engine/sharded.py", "self.mesh.get_group(DATA_AXIS)",
              'self.mesh.get_group("rows")'))
    for rel, old, new in edits:
        path = os.path.join(copy, "dmlp_tpu_torch", rel)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        check(old in text, f"check_static: {rel} lost {old!r}")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text.replace(old, new))
    return (_start_checker([], root, os.path.join(tmp_dir, "check.json")),
            _start_checker(["--families", "R1,R8"], copy,
                           os.path.join(tmp_dir, "check_teeth.json")))


def _finish_check_static(started):
    """The static checker's verdicts: the default families exit 0 with 0
    findings, R8 scanned the very bytes of the ``.cu`` sources whose
    ``kernels.source_hash`` names the loaded libraries, and both teeth
    bite."""
    import hashlib
    from dmlp_tpu_torch import kernels
    rc, v, secs = _finish_checker(started[0])
    trc, tv, tsecs = _finish_checker(started[1])
    check(rc == 0 and v["ok"] and v["findings"] == [],
          f"check_static: {len(v['findings'])} finding(s): "
          f"{[f['rule'] + ' ' + f['path'] for f in v['findings']][:5]}")
    hashes = {}
    for name in kernels.SOURCES:
        rel = f"dmlp_tpu_torch/kernels/{name}.cu"
        raw = kernels.source_path(name).read_bytes()
        check(v["cuda_sources"].get(rel) == hashlib.sha256(raw).hexdigest(),
              f"check_static: R8 scanned other bytes of {rel} than the "
              f"source on disk")
        want = hashlib.sha256(
            raw + " ".join(kernels.NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = kernels.load(name)
        check(kernels.source_hash(name) == want
              and os.path.basename(lib._name) == f"{name}-{want}.so",
              f"check_static: the loaded {lib._name} is not the build of "
              f"the scanned {rel} ({want})")
        hashes[name] = want
    teeth = {}
    for f in tv["findings"]:
        teeth[f["rule"]] = teeth.get(f["rule"], 0) + 1
    emit({"phase": "check_static", "families": v["families"],
          "files": v["files"], "findings": len(v["findings"]),
          "seconds": secs, "cuda_sources": v["cuda_sources"],
          "source_hash": hashes, "teeth": teeth, "teeth_exit": trc,
          "teeth_seconds": tsecs})
    check(trc == 1 and teeth.get("R802", 0) >= 3
          and teeth.get("R101", 0) >= 1,
          f"check_static: the teeth did not bite: {teeth}")


def check_phase(tmp_dir):
    """The checker on the card (module docstring): the sync probe, the
    sanitizer's teeth, the sanitized K1 and K3 solves against their
    plain twins, a sanitized train run, the race stress, and beside them
    on the host the static checker over the built tree with its teeth.
    Returns the launches per run."""
    import torch
    from dmlp_tpu_torch.check import sanitize
    static = _start_check_static(tmp_dir)
    try:
        sync_probe()
        _sanitizer_teeth()
        launches = {}
        for run, flags in CHECK_RUNS:
            name = next(r[1] for r in MAIN_RUNS if r[0] == run)
            want = next(r[4] for r in MAIN_RUNS if r[0] == run)
            if run not in OUTPUTS:       # the main phase did not run
                out, ms, got, _ = _cli_run(run, name, flags, tmp_dir)
                check(all(got[k] == v for k, v in want.items()),
                      f"{run}: launches {got} != the plan's {want}")
                OUTPUTS[run], MAIN_TIMES[run], MAIN_LAUNCHES[run] = \
                    out, ms, got
            label = f"check_{run}_sanitized"
            sanitize.reset_fences()
            out, ms, got, lines = _cli_run(
                label, name, [*flags, "--sanitize"], tmp_dir)
            rung = [ln.split()[1] for ln in lines
                    if ln.startswith("rung: ")]
            emit({"phase": "check_solve", "run": label,
                  "time_taken_ms_sanitized": ms,
                  "time_taken_ms_plain": MAIN_TIMES[run],
                  "launches": got, "launches_plain": MAIN_LAUNCHES[run],
                  "identical": out == OUTPUTS[run], "rung": rung,
                  "fenced": dict(sanitize.FENCED),
                  "sync_debug_mode_after": torch.cuda.get_sync_debug_mode()})
            check(out == OUTPUTS[run],
                  f"{label}: stdout differs from the plain solve's")
            check(got == MAIN_LAUNCHES[run],
                  f"{label}: launches {got} != plain {MAIN_LAUNCHES[run]}")
            check(rung == ["lowp"]
                  and torch.cuda.get_sync_debug_mode() == 0,
                  f"{label}: rung {rung}")
            launches[label] = got
        _sanitized_train()
        launches["check_race_stress"] = _race_stress(tmp_dir)
        _finish_check_static(static)
    finally:
        for p, _t0, _files in static:     # stopped on any failure
            if p.poll() is None:
                p.kill()
                p.wait()
    return launches


def _scrape_while(fn):
    """Run ``fn()`` while a thread scrapes the telemetry session's
    ``GET /metrics`` every 50 ms; returns (fn's result, the last text
    scraped while the session was open, or None)."""
    import threading
    import urllib.request
    from dmlp_tpu_torch.obs import telemetry
    got, stop = [], threading.Event()

    def scrape():
        while not stop.wait(0.05):
            sess = telemetry.session()
            if sess is None or sess.http_port is None:
                continue
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{sess.http_port}/metrics",
                        timeout=5) as r:
                    got.append(r.read().decode())
            except OSError:
                pass       # the session closed between the read and GET
    t = threading.Thread(target=scrape, daemon=True)
    t.start()
    try:
        out = fn()
    finally:
        stop.set()
        t.join(timeout=10)
    return out, (got[-1] if got else None)


def obs_solve(name, flags, tmp_dir, label, check_files=True):
    """One ``cli.main`` solve with every obs flag on (a trace, a metrics
    file, ``--counters``, a telemetry file and an ephemeral scrape port;
    ``--warmup`` where ``check_files``), the launch counts set to 0 before
    it: returns (stdout, Time taken, the summary record, the last scrape,
    launches, stderr lines), with ``tools/check_trace.py`` passing the
    trace and the metrics where ``check_files``."""
    from dmlp_tpu_torch import cli, kernels
    paths = {k: os.path.join(tmp_dir, f"{label}.{k}")
             for k in ("trace", "metrics", "telemetry")}
    argv = [*flags, "--trace", paths["trace"], "--metrics",
            paths["metrics"], "--counters", "--telemetry",
            paths["telemetry"], "--telemetry-port", "0"] \
        + (["--warmup"] if check_files else [])
    out, err = io.StringIO(), io.StringIO()
    kernels.reset_launch_counts()
    rc, text = _scrape_while(lambda: cli.main(
        argv, stdin=io.StringIO(config_text(name)), stdout=out, stderr=err))
    launches = dict(kernels.LAUNCHES)
    check(rc == 0, f"{label}: cli.main returned {rc}")
    lines = err.getvalue().splitlines()
    m = re.fullmatch(r"Time taken: (\d+) ms", lines[0])
    check(m is not None and lines[1].startswith("counters: ")
          and lines[2].startswith("roofline: "),
          f"{label}: stderr {lines[:3]}")
    if not check_files:
        return out.getvalue(), int(m.group(1)), None, text, launches, lines
    here = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run([sys.executable, "tools/check_trace.py",
                        paths["trace"], paths["metrics"]],
                       capture_output=True, text=True, cwd=here, timeout=120)
    check(p.returncode == 0, f"{label}: check_trace: {p.stdout}{p.stderr}")
    with open(paths["metrics"]) as f:
        summary = json.loads(f.read().splitlines()[-1])
    return out.getvalue(), int(m.group(1)), summary, text, launches, lines


def obs_kernel_checks(label, counters, launches, want):
    """The counters of one obs solve against the launches: each kernel's
    recorded launches are the timed solve's (half the run's, which has a
    warm-up) and the plan's ``want``, and no kernel's device time beats
    the least time its modeled bytes and products need (bound share at
    most 1.05). Returns each kernel's achieved rate and shares."""
    from dmlp_tpu_torch.obs.counters import PEAKS
    per = counters["per_kernel"]
    rows = {}
    for k in KERNELS:
        n = per.get(k, {}).get("dispatches", 0)
        check(2 * n == launches[k] and n == want.get(k, 0),
              f"{label}: {k} recorded {n} launches, LAUNCHES {launches[k]} "
              f"(warm-up included), the plan {want.get(k, 0)}")
        if not n:
            continue
        agg = per[k]
        check(agg.get("timed_launches") == n and agg["device_ms"] > 0,
              f"{label}: {k}: {agg.get('timed_launches')} of {n} launches "
              "timed")
        share = agg["bound_ms"] / agg["device_ms"]
        rate = agg["flops"] / agg["device_ms"] * 1e3
        rows[k] = {"launches": n, "device_ms": agg["device_ms"],
                   "flops": agg["flops"], "bytes_min": agg["bytes_min"],
                   "bytes_accessed": agg["bytes_accessed"],
                   "achieved_flops_per_s": rate,
                   "peak_share": rate / PEAKS[H100][agg["precision"]],
                   "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
                   "bound_share": share}
        check(share <= 1.05, f"{label}: {k} bound share {share:.3f}: its "
                             "device time is below the least time its "
                             "work needs")
    return rows


def obs_phase(tmp_dir):
    """Observability on the card (``dmlp_tpu_torch.obs``): config 4 (K1
    and its merge) and config 2 with ``--select seg`` (K3) through
    ``cli.main`` with every obs flag on. Each prints the bytes of the
    flag-free solve; its trace and metrics pass ``tools/check_trace.py``;
    its ``GET /metrics`` scrape, taken while the session is open, passes
    ``validate_openmetrics``; each kernel's recorded launches are the
    plan's and LAUNCHES'; K1's and the merge's FLOPs equal
    obs.kernel_cost's sum over the launches, K1's with the measured
    ``iters``; no kernel reads below its roofline bound. Then config 4's
    ``Time taken`` with every flag on and with none, 3 runs each,
    interleaved, after those solves warmed the process: for information.
    The phase opens no ``torch.profiler`` session: a second profiler user
    in one process read wrong device times in the profile phase."""
    t_phase = time.perf_counter()
    # No tune cache: every launch knob takes its heuristic, as the plan
    # below computes it.
    os.environ["DMLP_TPU_TUNE_CACHE"] = os.path.join(tmp_dir, "absent.json")
    try:
        _obs_runs(tmp_dir, t_phase)
    finally:
        os.environ.pop("DMLP_TPU_TUNE_CACHE")


def _obs_runs(tmp_dir, t_phase):
    from dmlp_tpu_torch import cli
    from dmlp_tpu_torch.obs import kernel_cost
    from dmlp_tpu_torch.obs.telemetry import validate_openmetrics
    from dmlp_tpu_torch.ops.extract import heuristic_splits

    for label, (name, flags) in (("config4_K1", ("config4", ["--pallas"])),
                                 ("config2_seg", ("config2", [
                                     "--select", "seg", "--pallas"]))):
        if label not in OUTPUTS:
            out = io.StringIO()
            check(cli.main(flags, stdin=io.StringIO(config_text(name)),
                           stdout=out, stderr=io.StringIO()) == 0,
                  f"obs: the {label} reference solve failed")
            OUTPUTS[label] = out.getvalue()
    records = {}
    # Config 4: K1 over 4 chunks of 50,176 rows at kc 48, the first fresh,
    # a merge per launch where the launch splits.
    (n4, qb, b, kc), = MAIN_RUNS[1][5]
    s4 = heuristic_splits(qb, b, kc, "cuda")
    text, _taken, rec, scrape, launches, lines = obs_solve(
        "config4", ["--pallas"], tmp_dir, "obs_config4")
    check(text == OUTPUTS["config4_K1"],
          "obs_config4: stdout with every obs flag differs from config 4's")
    check(scrape is not None and validate_openmetrics(scrape) == [],
          f"obs_config4: GET /metrics: "
          f"{scrape and validate_openmetrics(scrape)}")
    c = rec["counters"]
    want = {"fused_topk": n4, "extract_merge": n4 if s4 > 1 else 0}
    rows = obs_kernel_checks("obs_config4", c, launches, want)
    iters = c["per_kernel"]["fused_topk"]["extract_iters_total"]
    k1 = sum(kernel_cost.fused_topk_cost(
        qb, b, 64, kc, carried=i > 0, splits=s4)["flops"]
        for i in range(n4)) + kernel_cost.extract_loop_cost(qb, b, 64, kc,
                                                            iters)
    got = c["per_kernel"]["fused_topk"]["flops"]
    check(c["per_kernel"]["fused_topk"]["extraction_term"] == "measured"
          and abs(got - k1) <= 1e-9 * k1,
          f"obs_config4: K1 flops {got} != kernel_cost's {k1}")
    if s4 > 1:
        mg = sum(kernel_cost.extract_merge_cost(qb, kc, s4, i > 0)["flops"]
                 for i in range(n4))
        got = c["per_kernel"]["extract_merge"]["flops"]
        check(abs(got - mg) <= 1e-9 * mg,
              f"obs_config4: merge flops {got} != kernel_cost's {mg}")
    records["config4"] = {"stderr": lines[1:3], "kernels": rows,
                          "mem": rec.get("mem"), "splits": s4,
                          "kernels_idle_share": c.get("kernels_idle_share"),
                          "extract_iters_total": iters,
                          "scrape_lines": len(scrape.splitlines())}
    # Config 2 with --select seg: K3 10 times (2 chunks x 5 query blocks).
    text, _taken, rec, scrape, launches, lines = obs_solve(
        "config2", ["--select", "seg", "--pallas"], tmp_dir, "obs_config2")
    check(text == OUTPUTS["config2_seg"],
          "obs_config2: stdout with every obs flag differs from config 2's")
    check(scrape is not None and validate_openmetrics(scrape) == [],
          "obs_config2: GET /metrics does not validate")
    records["config2_seg"] = {
        "stderr": lines[1:3],
        "kernels": obs_kernel_checks("obs_config2", rec["counters"],
                                     launches, MAIN_RUNS[4][4]),
        "mem": rec.get("mem"),
        "kernels_idle_share": rec["counters"].get("kernels_idle_share")}
    # Time taken, config 4, every flag on against none, 3 runs each,
    # interleaved, after the solves above warmed this process.
    taken_on, taken_off = [], []
    for i in range(3):
        out, err = io.StringIO(), io.StringIO()
        check(cli.main(["--pallas"], stdin=io.StringIO(
            config_text("config4")), stdout=out, stderr=err) == 0,
            "obs: the flag-free config-4 solve failed")
        taken_off.append(int(err.getvalue().split()[2]))
        taken_on.append(obs_solve("config4", ["--pallas"], tmp_dir,
                                  f"obs_config4_{i}", check_files=False)[1])
    emit({"phase": "obs", "records": records,
          "time_taken_on_ms": taken_on, "time_taken_off_ms": taken_off,
          "time_taken_on_median_ms": sorted(taken_on)[1],
          "time_taken_off_median_ms": sorted(taken_off)[1],
          "phase_s": time.perf_counter() - t_phase})


# The mesh phase's solves through the port's entry points on the card:
# (run, config, flags, world, backend, the single-device run whose stdout
# it must equal, DMLP_TPU_FUSED). Config 3 (configs.py:64) is config 2's
# data on a (4, 2) mesh; the (4, 2) runs put 8 ranks on one card with gloo
# collectives. With DMLP_TPU_FUSED=0 the chunk fold runs K2.
MESH_RUNS = (
    ("mesh_1x1_config4", "config4",
     ["--mode", "sharded", "--mesh", "1,1", "--pallas"], 1, "nccl",
     "config4_K1", "1"),
    ("mesh_1x1_config4_ring", "config4",
     ["--mode", "ring", "--mesh", "1,1", "--pallas"], 1, "nccl",
     "config4_K1", "1"),
    # Config 3 sharded and ring with K1 are the bench phase's `bench 3
    # --auto-ab` arms (bench_auto_config3_checks).
    ("mesh_4x2_config3_K2", "config2",
     ["--mode", "sharded", "--mesh", "4,2", "--pallas", "--backend",
      "gloo"], 8, "gloo", "config2_seg", "0"),
    ("mesh_4x2_widek", "widek_config2",
     ["--mode", "sharded", "--mesh", "4,2", "--pallas", "--backend",
      "gloo"], 8, "gloo", "widek_config2_single", "1"),
)
# A single-device solve the mesh phase makes itself when the main phase
# did not (or never) solve it: (run, config, flags).
MESH_SINGLE = {"config4_K1": ("config4", ["--pallas"]),
               "config2_seg": ("config2", ["--select", "seg", "--pallas"]),
               "widek_config2_single": ("widek_config2", ["--pallas"])}


def mesh_k1_plan(name, r, c):
    """What a rank of an (r, c) mesh launches K1 at under the mesh chunk
    fold for the config ``name``: (launches per rank, qloc, chunk rows,
    kc), and the outliers' qloc where the router splits them off (K3 folds
    them), else None."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import (hetk_split, plan_chunks,
                                              resolve_kcap, round_up)
    from dmlp_tpu_torch.ops.extract import QUERY_TILE
    cfg = EngineConfig(use_pallas=True)
    inp = config_input(name)
    n, nq = inp.params.num_data, inp.params.num_queries
    split = hetk_split(cfg, "float32", inp.ks, n,
                       round_up(-(-n // r), 8))
    idx = split[0] if split is not None else range(nq)
    shard_rows, nchunks, chunk_rows = plan_chunks(
        -(-n // r), cfg.resolve_granule("extract"), None)
    qloc = round_up(-(-len(idx) // c), QUERY_TILE)
    kc = resolve_kcap(cfg, int(inp.ks[list(idx)].max()), "extract",
                      r * shard_rows)
    oqloc = None if split is None else round_up(-(-len(split[1]) // c), 8)
    return nchunks, qloc, chunk_rows, kc, oqloc


def _phase_lines(err: str):
    """(Time taken ms, phases, the other --phase-times records) of a mesh
    run's stderr (where the transport's own warnings may stand too)."""
    lines = err.splitlines()
    m = next((re.fullmatch(r"Time taken: (\d+) ms", ln) for ln in lines
              if ln.startswith("Time taken: ")), None)
    check(m is not None, f"mesh: no Time taken line in {lines[-5:]}")
    phases = {ln.split(":")[0][len("phase "):]: float(
        ln.split(":")[1].split()[0]) for ln in lines if
        ln.startswith("phase ")}
    recs = {}
    for key in ("repairs", "prune", "hetk", "mesh"):
        got = [ln[len(key) + 2:] for ln in lines
               if ln.startswith(key + ": ")]
        recs[key] = json.loads(got[0]) if got else None
    return int(m.group(1)), phases, recs


def nccl_two_ranks_one_card():
    """Whether NCCL takes two ranks of one communicator on one card: two
    processes init NCCL on cuda:0 and all-reduce (60 s deadline). Emits
    the outcome; checks nothing (the port refuses such a group itself)."""
    import tempfile

    from dmlp_tpu_torch.parallel.distributed import free_port
    script = (
        "import datetime, sys, torch, torch.distributed as dist\n"
        "rank = int(sys.argv[1])\n"
        "torch.cuda.set_device(0)\n"
        "dist.init_process_group('nccl', init_method=sys.argv[2],"
        " world_size=2, rank=rank,"
        " timeout=datetime.timedelta(seconds=30))\n"
        "t = torch.ones(4, device='cuda')\n"
        "dist.all_reduce(t)\n"
        "torch.cuda.synchronize()\n"
        "print('all_reduce', t.tolist())\n"
        "dist.destroy_process_group()\n")
    url = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, "-c", script, str(r), url],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, cwd=tmp)
                 for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate())
    errs = [[ln for ln in e.splitlines() if "rror" in ln or "uplicate"
             in ln][-3:] for _o, e in outs]
    emit({"phase": "nccl_two_ranks_one_card",
          "returncodes": [p.returncode for p in procs],
          "stdout": [o.strip()[-200:] for o, _e in outs], "errors": errs})


def mesh_comms_check(label, name, shape, metrics):
    """The mesh run's metrics record: its ``comms`` block (every rank's
    traffic record, gathered to rank 0 and equal on every rank) equals
    obs.comms' analytic bytes for this mesh and plan — the root's scatters
    of the row and query shards, the all-gather merge over the data axis,
    row 0's gather over the query axis."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import plan_chunks
    from dmlp_tpu_torch.obs import comms
    with open(metrics) as f:
        rec = json.loads(f.read().splitlines()[-1])
    nchunks, qloc, chunk_rows, kc, oqloc = mesh_k1_plan(name, *shape)
    check(oqloc is None, f"{label}: the comms check expects no outliers")
    inp = config_input(name)
    shard_rows = plan_chunks(-(-inp.params.num_data // shape[0]),
                             EngineConfig(use_pallas=True).resolve_granule(
                                 "extract"), None)[0]
    want = comms.summarize(
        comms.scatter_comms(shape, shard_rows, inp.params.num_attrs,
                            [qloc])
        + comms.engine_comms("allgather", shape, qloc, kc)
        + comms.gather_comms(shape, qloc, kc))
    got = rec["comms"]
    emit({"phase": "mesh_comms", "run": label, "comms": got,
          "counters_dispatches": rec["counters"].get(
              "dispatches_recorded")})
    check(got["ranks_agree"] and got["bytes_total"] == want["bytes_total"]
          and got["collectives"] == want["collectives"],
          f"{label}: comms {got['bytes_total']} B != the analytic "
          f"{want['bytes_total']} B")


def mesh_phase(tmp_dir):
    """The mesh engines through ``cli.main`` on the card (rank 0 in this
    process; the (4, 2) runs start 7 more ranks on cuda:0 with gloo), and
    bench config 5 through ``python -m dmlp_tpu_torch.distributed
    --supervise 2`` (gloo): each stdout equal to the single-device solve
    of the same input and to the float64 oracle on a subset, K1 (K2 under
    ``DMLP_TPU_FUSED=0``) launched by every rank of the mesh path (K3 too
    for the routed outliers) at a shape the kernels phase held, at most 1%
    of the queries repaired. Returns the launches per run (summed over
    ranks)."""
    import tempfile

    import torch
    from dmlp_tpu_torch import cli, kernels
    from dmlp_tpu_torch.ops.extract import heuristic_splits

    nccl_two_ranks_one_card()
    # NCCL is never swapped for gloo behind the caller's back: 8 ranks on
    # one card without --backend gloo raise before any rank starts.
    refused = None
    try:
        cli.main(["--mode", "sharded", "--mesh", "4,2", "--pallas"],
                 stdin=io.StringIO(config_text("config2")),
                 stdout=io.StringIO(), stderr=io.StringIO())
    except RuntimeError as e:
        refused = str(e)
    emit({"phase": "mesh_nccl_refused", "error": refused})
    check(refused is not None and "--backend gloo" in refused,
          f"8 NCCL ranks on one card were not refused: {refused}")
    launches = {}
    for label, (name, flags) in MESH_SINGLE.items():
        if label in OUTPUTS:
            continue
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        check(cli.main(flags + ["--phase-times"], stdin=io.StringIO(
            config_text(name)), stdout=out, stderr=err) == 0,
            f"{label}: cli.main failed")
        OUTPUTS[label] = out.getvalue()
        taken, phases, recs = _phase_lines(err.getvalue())
        emit({"phase": "mesh_reference", "run": label, "flags": flags,
              "time_taken_ms": taken, "phases_ms": phases,
              "repairs": recs["repairs"],
              "wall_ms": (time.perf_counter() - t0) * 1e3})
    for label, name, flags, world, backend, same_as, fused in MESH_RUNS:
        c = CONFIGS[name]
        r, cc = (int(x) for x in flags[flags.index("--mesh") + 1].split(","))
        nchunks, qloc, chunk_rows, kc, oqloc = mesh_k1_plan(name, r, cc)
        routed = oqloc is not None
        s = heuristic_splits(qloc, chunk_rows, kc, "cuda")
        k12 = ("fused_topk", "extract_topk")[fused == "0"]
        # Per rank, for the warm-up solve and the timed one.
        want_rank = {"fused_topk": 0, "extract_topk": 0, k12: 2 * nchunks,
                     "extract_merge": 2 * nchunks if s > 1 else 0,
                     "fused_dist_segmin": 2 * nchunks if routed else 0}
        check(not HELD["k1"] or (qloc, chunk_rows, c["num_attrs"], kc)
              in HELD["k1"], f"{label}: K1/K2 at {qloc} x {chunk_rows} x "
                             f"{c['num_attrs']}, kc {kc}: no kernels case")
        check(not routed or not HELD["k3"] or (oqloc, chunk_rows,
                                               c["num_attrs"]) in HELD["k3"],
              f"{label}: K3 at {oqloc} x {chunk_rows}: no segmin case")
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        # The ranks this process starts inherit its environment.
        os.environ["DMLP_TPU_FUSED"] = fused
        t0 = time.perf_counter()
        # One run also writes the metrics record: its comms block is held
        # against obs.comms' analytic bytes for this mesh.
        metrics = os.path.join(tmp_dir, f"{label}.metrics") \
            if label == "mesh_4x2_config3_K2" else None
        # --warmup: each rank's first solve (its kernels' load, its CUDA
        # context's first allocations) stays out of the timed one.
        try:
            rc = cli.main(flags + ["--warmup", "--phase-times"]
                          + (["--metrics", metrics] if metrics else []),
                          stdin=io.StringIO(config_text(name)), stdout=out,
                          stderr=err)
        finally:
            os.environ.pop("DMLP_TPU_FUSED")
        wall_ms = (time.perf_counter() - t0) * 1e3
        check(rc == 0, f"{label}: cli.main returned {rc}")
        taken, phases, recs = _phase_lines(err.getvalue())
        mesh = recs["mesh"]
        ranks = mesh["ranks"]
        total = {k: sum(rk["launches"][k] for rk in ranks)
                 for k in KERNELS}
        launches[label] = total
        merge_ms = [rk["phases_ms"].get("merge", 0.0) for rk in ranks]
        text = out.getvalue()
        emit({"phase": "mesh", "run": label, "flags": flags,
              "time_taken_ms": taken, "phases_ms": phases,
              "wall_ms": wall_ms, "backend": mesh["backend"],
              "shape": mesh["shape"],
              "rank_devices": {rk["rank"]: rk["device"] for rk in ranks},
              "rank_coords": {rk["rank"]: rk["coords"] for rk in ranks},
              "last_hetk": recs["hetk"], "last_prune": recs["prune"],
              "repairs": recs["repairs"],
              "launches_by_rank": {rk["rank"]: rk["launches"]
                                   for rk in ranks},
              "launches_per_rank_expected": want_rank,
              "DMLP_TPU_FUSED": fused,
              "k1_shape": [qloc, chunk_rows, c["num_attrs"], kc, s],
              "k3_shape": None if not routed else [oqloc, chunk_rows,
                                                   c["num_attrs"]],
              "merge_ms_by_rank": merge_ms,
              "rank_phases_ms": {rk["rank"]: rk["phases_ms"]
                                 for rk in ranks},
              "same_as": same_as, "stdout_lines": text.count("\n")})
        check(mesh["backend"] == backend and len(ranks) == world
              and all(rk["device"] == "cuda:0" for rk in ranks),
              f"{label}: backend {mesh['backend']}, ranks {ranks}")
        for rk in ranks:
            check(rk["launches"] == want_rank,
                  f"{label}: rank {rk['rank']} launched {rk['launches']}, "
                  f"want {want_rank}")
        check(recs["repairs"] <= MAX_REPAIR_SHARE * c["num_queries"],
              f"{label}: {recs['repairs']} of {c['num_queries']} queries "
              "repaired on the host")
        check((recs["hetk"] is not None) == routed,
              f"{label}: last_hetk {recs['hetk']}, routed {routed}")
        check(text == OUTPUTS[same_as],
              f"{label}: stdout differs from {same_as}'s")
        OUTPUTS[label] = text
        golden_subset(label, name, text.splitlines(), 1000)
        if metrics:
            mesh_comms_check(label, name, (r, cc), metrics)

    # Bench config 5: 2 processes through the supervised launcher.
    c = CONFIGS["config5"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config5.in")
        with open(path, "w") as f:
            f.write(config_text("config5"))
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "dmlp_tpu_torch.distributed",
             "--supervise", "2", "--input", path, "--pallas", "--backend",
             "gloo", "--warmup", "--phase-times", "--supervise-timeout",
             "300",
             "--supervise-dir", os.path.join(tmp, "sup")],
            capture_output=True, text=True, timeout=420,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(p.returncode == 0, f"distributed_config5: exit {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    taken, _phases, recs = _phase_lines(p.stderr)
    ranks = recs["mesh"]["ranks"]
    # Each rank's one K1 launch: its shard (25,088 rows) against every
    # query (one query column).
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import resolve_kcap, round_up
    from dmlp_tpu_torch.ops.extract import QUERY_TILE
    cfg = EngineConfig(use_pallas=True)
    rows5 = round_up(-(-c["num_data"] // 2), cfg.resolve_granule("extract"))
    k1_5 = (round_up(c["num_queries"], QUERY_TILE), rows5, c["num_attrs"],
            resolve_kcap(cfg, int(config_input("config5").ks.max()),
                         "extract", rows5))
    check(not HELD["k1"] or k1_5 in HELD["k1"],
          f"distributed_config5: K1 at {k1_5}: no kernels case")
    launches["distributed_config5"] = {
        k: sum(rk["launches"][k] for rk in ranks) for k in KERNELS}
    from dmlp_tpu_torch.golden.fast import knn_golden_fast
    from dmlp_tpu_torch.io.report import format_results
    t1 = time.perf_counter()
    golden = format_results(knn_golden_fast(config_input("config5")))
    emit({"phase": "mesh", "run": "distributed_config5",
          "time_taken_ms": taken, "wall_ms": wall_ms,
          "backend": recs["mesh"]["backend"],
          "shape": recs["mesh"]["shape"],
          "rank_devices": {rk["rank"]: rk["device"] for rk in ranks},
          "launches_by_rank": {rk["rank"]: rk["launches"] for rk in ranks},
          "k1_shape": list(k1_5), "repairs": recs["repairs"],
          "repairs_by_rank": {rk["rank"]: rk["repairs"] for rk in ranks},
          "relaunched": "supervise:" in p.stderr,
          "golden_ms": (time.perf_counter() - t1) * 1e3,
          "stdout_lines": p.stdout.count("\n"),
          "golden_match": p.stdout == golden})
    check("supervise:" not in p.stderr,
          f"distributed_config5: {p.stderr[-1000:]}")
    check(all(rk["launches"]["fused_topk"] >= 1 for rk in ranks)
          and len(ranks) == 2, f"distributed_config5: launches {ranks}")
    check(recs["repairs"] is not None and recs["repairs"]
          <= MAX_REPAIR_SHARE * c["num_queries"],
          f"distributed_config5: {recs['repairs']} of {c['num_queries']} "
          "queries rescored exactly on the ranks")
    check(p.stdout == golden, "distributed_config5: stdout is not golden's")
    return launches


def serve_trace():
    """The serve phase's seeded trace over config 4's corpus (see
    SERVE_NQ): a serve_trace_schema header and its request lines."""
    import numpy as np
    c = CONFIG4
    header = {"serve_trace_schema": 1, "corpus": {
        "num_data": c["num_data"], "num_queries": c["num_queries"],
        "num_attrs": c["num_attrs"], "min_attr": c["attr_min"],
        "max_attr": c["attr_max"], "min_k": c["min_k"],
        "max_k": c["max_k"], "num_labels": c["num_labels"],
        "seed": c["seed"]}}
    rng = np.random.default_rng(10)
    reqs = []
    for i in range(3 * len(SERVE_NQ)):
        nq = SERVE_NQ[i % len(SERVE_NQ)]
        r = {"nq": nq, "seed": 1000 + i}
        if i % 3 == 2:
            r["ks"] = [int(v) for v in rng.integers(1, c["max_k"] + 1, nq)]
        else:
            r["k"] = int(rng.integers(1, c["max_k"] + 1))
        reqs.append(r)
    for j, nq in enumerate(SERVE_WIDE_NQ):
        reqs.insert(4 + 9 * j, {"nq": nq, "k": 1024, "seed": 2000 + j})
    return header, reqs


def serve_golden(label, corpus, header, reqs, responses):
    """At least SERVE_GOLDEN_QUERIES seeded queries of the responses
    against golden.fast over ``corpus``, byte for byte (all of them where
    the replay holds fewer)."""
    import numpy as np
    from dmlp_tpu_torch.golden.fast import knn_golden_fast
    from dmlp_tpu_torch.io.grammar import KNNInput, Params
    from dmlp_tpu_torch.serve import client as sc

    pairs = [(i, j) for i, r in enumerate(reqs) for j in range(r["nq"])]
    rng = np.random.default_rng(11)
    pick = sorted(rng.choice(len(pairs), min(SERVE_GOLDEN_QUERIES,
                                             len(pairs)), replace=False))
    q = {i: sc.materialize_queries(r, header) for i, r in enumerate(reqs)}
    ks = {i: sc.request_ks(r) for i, r in enumerate(reqs)}
    sel = [pairs[p] for p in pick]
    t0 = time.perf_counter()
    inp = KNNInput(Params(corpus.params.num_data, len(sel),
                          corpus.params.num_attrs), corpus.labels,
                   corpus.data_attrs,
                   np.array([ks[i][j] for i, j in sel], np.int32),
                   np.array([q[i][j] for i, j in sel]))
    want = [int(r.checksum()) for r in knn_golden_fast(inp)]
    got = [responses[i]["checksums"][j] for i, j in sel]
    emit({"phase": "serve_golden", "run": label, "queries": len(sel),
          "of": len(pairs), "match": got == want,
          "oracle_ms": (time.perf_counter() - t0) * 1e3})
    check(got == want, f"{label}: responses differ from the float64 oracle")


def serve_batch_plan(geo, b, n_real):
    """The kernel launches one logged micro-batch must have made: K1 once
    per non-empty resident chunk the prune kept (plus a pass per further
    multi-pass sweep), K2 in its place on the tuned/heuristic rungs, K3
    once per streaming block and query block on the streaming rung, and a
    merge for every K1/K2 launch at S > 1."""
    nonempty = min(geo["nchunks"], -(-n_real // geo["chunk_rows"]))
    want = {k: 0 for k in KERNELS}
    rung = b["rung"]
    if rung == "streaming" or b["path"] == "stream":
        qb = min(1 << max(min(1024, b["qpad"]).bit_length() - 1, 3),
                 b["qpad"])
        want["fused_dist_segmin"] = (geo["capacity_rows"]
                                     // geo["data_block"]) * (b["qpad"] // qb)
        return want
    k = "fused_topk" if rung in ("lowp", "prune", "fused") \
        else "extract_topk"
    if b["path"] == "multipass":
        want[k] = nonempty + b["mp_passes"] - 1
    else:
        want[k] = nonempty - (b["blocks_pruned"] or 0)
    want["extract_merge"] = sum(
        n for kern in ("fused_topk", "extract_topk")
        for s, n in b["launch_variants"].get(kern, {}).items()
        if int(s) > 1)
    return want


def serve_check_batches(label, geo, stats, seen, launches):
    """Hold every micro-batch the daemon logged since ``seen`` against its
    launch plan and its shapes against the ones the kernels phase held;
    add its launches to ``launches``. Returns the last sequence number."""
    log = stats["engine"]["batch_log"]
    new = [b for b in log if b["seq"] > seen]
    check(not new or new[0]["seq"] == seen + 1,
          f"{label}: the batch log lost batches after {seen}")
    for b in new:
        want = serve_batch_plan(geo, b, b["n_real"])
        check(b["launches"] == want,
              f"{label}: batch {b['seq']} ({b['bucket']}, {b['path']}, "
              f"{b['rung']}) launched {b['launches']}, its plan {want}")
        # With the telemetry session's probe: the launches it recorded.
        check("dispatches" not in b or all(
            b["dispatches"].get(k, 0) == n for k, n in
            b["launches"].items()),
            f"{label}: batch {b['seq']} recorded {b.get('dispatches')}, "
            f"launched {b['launches']}")
        qpad, kb = b["qpad"], int(b["bucket"].split("k")[1])
        if b["rung"] != "streaming" and b["path"] == "extract":
            shapes = [(qpad, geo["chunk_rows"], 64, geo["kcap"][kb])]
        elif b["rung"] != "streaming" and b["path"] == "multipass":
            shapes = [(qpad, geo["chunk_rows"], 64, 512),
                      (qpad, geo["ex_rows"], 64, 512)]
        else:
            shapes = []
        check(all(sh in HELD["k1"] for sh in shapes),
              f"{label}: batch {b['seq']} launched K1/K2 at {shapes}, not "
              "all held by the kernels phase")
        for k, v in b["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return new[-1]["seq"] if new else seen


def serve_phase(tmp_dir):
    """The resident daemon on the card over config 4's corpus: warm-up,
    a 4-connection replay, ingest across a chunk boundary and a second
    replay, the admission squeeze, a second daemon under a fault schedule
    for the tuned and streaming rungs, and the SIGTERM drains. Returns the
    launches of the replays and the ladder batches."""
    import numpy as np
    from dmlp_tpu_torch.io.grammar import KNNInput, Params
    from dmlp_tpu_torch.serve import client as sc
    from dmlp_tpu_torch.serve.daemon import default_warm_buckets
    from dmlp_tpu_torch.serve.engine import k_bucket, query_bucket

    geo = serve_geometry()
    header, reqs = serve_trace()
    corpus_path = os.path.join(tmp_dir, "serve_corpus.txt")
    with open(corpus_path, "w") as f:
        f.write(config_text("config4"))
    corpus = config_input("config4")
    warm = sc.warm_buckets_for_trace(reqs, 1024)
    second = reqs[:14]
    admitted_before = len(reqs) + len(second)

    def start(label, faults, warm_spec, obs_flags=()):
        fpath = os.path.join(tmp_dir, f"{label}_faults.json")
        with open(fpath, "w") as f:
            json.dump({"schema": 1, "seed": 0, "faults": faults}, f)
        ready = os.path.join(tmp_dir, f"{label}_ready.json")
        err = os.path.join(tmp_dir, f"{label}_stderr.txt")
        ef = open(err, "w")
        t0 = time.perf_counter()
        # No tune cache: every launch knob takes its heuristic, as the
        # kernels phase held it.
        env = {**os.environ, "DMLP_TPU_TUNE_CACHE": os.path.join(
            tmp_dir, "absent.json")}
        proc = subprocess.Popen(
            [sys.executable, "-m", "dmlp_tpu_torch.serve", "--corpus",
             corpus_path, "--pallas", "--port", "0", "--ready-file", ready,
             "--warm-buckets", warm_spec, "--faults", fpath, *obs_flags],
            stdout=subprocess.DEVNULL, stderr=ef, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        ef.close()
        try:
            doc = sc.await_ready(proc, ready, timeout_s=300, errlog=err)
        except BaseException:
            proc.kill()
            proc.wait(timeout=60)
            raise
        doc["ready_wall_ms"] = (time.perf_counter() - t0) * 1e3
        return proc, doc, err

    def stop(proc, err):
        try:
            sc.sigterm_drain(proc, timeout_s=120, errlog=err)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)

    launches = {"serve_replay": {}, "serve_ladder": {}}
    # -- the daemon: warm-up, replay, ingest, replay, squeeze, drain -------
    spec = ",".join(f"{nq}x{k}" for nq, k in warm)
    # The first daemon runs the telemetry session (the scrape port, the
    # probe behind each batch's recorded launches) and one SLO objective.
    proc, ready, err = start(
        "serve", [{"site": "serve.admit", "kind": "oom",
                   "after": admitted_before}], spec,
        ["--telemetry", os.path.join(tmp_dir, "serve_telemetry.om"),
         "--telemetry-port", "0", "--slo",
         "serve.request_latency_ms p99 < 60000 over 5m"])
    try:
        cli = sc.ServeClient(ready["port"])
        st0 = cli.stats()["stats"]
        warm_seq = seq = serve_check_batches("serve warm-up", geo, st0, 0,
                                             {})
        t0 = time.perf_counter()
        res = sc.replay(ready["port"], header, reqs, connections=4)
        replay_s = time.perf_counter() - t0
        check(all(r["ok"] for r in res), f"serve replay: a request failed "
              f"{[r for r in res if not r['ok']][:1]}")
        st1 = cli.stats()["stats"]
        eng1 = st1["engine"]
        seq = serve_check_batches("serve replay", geo, st1, seq,
                                  launches["serve_replay"])
        scrape = serve_scrape(ready, st1)
        check(eng1["compile_count"] == ready["compile_count"]
              and eng1["kernel_loads"] == ready["kernel_loads"]
              and eng1["buckets"] == ready["buckets"],
              f"serve replay: builds {eng1['compile_count']} / loads "
              f"{eng1['kernel_loads']} after a warmed replay, "
              f"{ready['compile_count']} / {ready['kernel_loads']} at ready")
        replay_batches = [b for b in eng1["batch_log"]
                          if b["seq"] > warm_seq]
        nq_all = sum(b["nq"] for b in replay_batches)
        repairs = sum(b["repairs"] for b in replay_batches)
        check(repairs <= MAX_REPAIR_SHARE * nq_all,
              f"serve replay: {repairs} of {nq_all} queries repaired")
        serve_golden("serve_replay", corpus, header, reqs, res)
        # Ingest: 12,000 rows inside chunk 4, then 12,000 more across its
        # boundary into chunk 5 (empty until then).
        rng = np.random.default_rng(12)
        rows = rng.uniform(0.0, 100.0, (24000, CONFIG4["num_attrs"]))
        labels = rng.integers(0, CONFIG4["num_labels"], 24000)
        for part in (slice(0, 12000), slice(12000, 24000)):
            r = cli.ingest(labels[part], rows[part])
            check(r["ok"], f"serve ingest: {r}")
        grown = KNNInput(Params(CONFIG4["num_data"] + 24000, 0,
                                CONFIG4["num_attrs"]),
                         np.concatenate([corpus.labels,
                                         labels.astype(np.int32)]),
                         np.vstack([corpus.data_attrs, rows]),
                         np.zeros(0, np.int32),
                         np.zeros((0, CONFIG4["num_attrs"])))
        cr = geo["chunk_rows"]
        touched = len(range(CONFIG4["num_data"] // cr,
                            -(-(CONFIG4["num_data"] + 12000) // cr))) \
            + len(range((CONFIG4["num_data"] + 12000) // cr,
                        -(-(CONFIG4["num_data"] + 24000) // cr)))
        res2 = sc.replay(ready["port"], header, second, connections=4)
        check(all(r["ok"] for r in res2), "serve replay 2: a request failed")
        st2 = cli.stats()["stats"]
        eng2 = st2["engine"]
        seq = serve_check_batches("serve replay 2", geo, st2, seq,
                                  launches["serve_replay"])
        check(eng2["compile_count"] == ready["compile_count"]
              and eng2["summary_rebuilds"] == touched
              and st2["corpus"]["rows"] == grown.params.num_data,
              f"serve ingest: builds {eng2['compile_count']}, summary "
              f"rebuilds {eng2['summary_rebuilds']} (want {touched}), rows "
              f"{st2['corpus']['rows']}")
        serve_golden("serve_replay_grown", grown, header, second, res2)
        # The admission squeeze: the next request is shed, the one after
        # served, and the ladder untouched.
        q = sc.materialize_queries({"nq": 8, "seed": 3000}, header)
        shed = cli.query(q, k=5)
        served = cli.query(q, k=5)
        st3 = cli.stats()["stats"]
        seq = serve_check_batches("serve squeeze", geo, st3, seq, {})
        check(not shed["ok"] and shed["error"] == "rejected: "
              "injected_squeeze" and served["ok"]
              and st3["admission"]["rejected"] == {"injected_squeeze": 1}
              and all(b["rung"] == "lowp"
                      for b in st3["engine"]["batch_log"]),
              f"serve squeeze: shed {shed}, served {served.get('ok')}, "
              f"rejected {st3['admission']['rejected']}")
        cli.close()
    finally:
        stop(proc, err)
    by_path = {}
    for b in st3["engine"]["batch_log"]:
        if b["seq"] > warm_seq:
            by_path.setdefault(b["path"], b)
    # -- the ladder daemon: one batch on tuned (K2), one on streaming (K3)
    lwarm = default_warm_buckets(corpus) + [(32, 32)]
    w = len({(query_bucket(nq, 32), k_bucket(min(k, geo["capacity_rows"])))
             for nq, k in lwarm})
    # Listed first, the streaming entry counts every stage_put hit; the
    # tuned one skips the warm-up's w hits and fires on the next three.
    faults = [{"site": "single.stage_put", "kind": "oom", "times": 5,
               "after": w + 4},
              {"site": "single.stage_put", "kind": "oom", "times": 3,
               "after": w}]
    proc, lready, lerr = start("serve_ladder", faults, "32x32")
    try:
        check(len(lready["buckets"]) == w,
              f"serve ladder: {lready['buckets']} warmed, want {w}")
        lreqs = [{"nq": 32, "k": 20, "seed": 3001},
                 {"nq": 32, "k": 20, "seed": 3002}]
        lres = [sc.replay(lready["port"], header, [r], connections=1)[0]
                for r in lreqs]
        cli = sc.ServeClient(lready["port"])
        lst = cli.stats()["stats"]
        cli.close()
        rungs = [b["rung"] for b in lst["engine"]["batch_log"][-2:]]
        check(rungs == ["tuned", "streaming"] and all(
            r["ok"] for r in lres),
            f"serve ladder: batches on {rungs}")
        serve_check_batches("serve ladder", geo, lst, w,
                            launches["serve_ladder"])
        serve_golden("serve_ladder", corpus, header, lreqs, lres)
        for b in lst["engine"]["batch_log"][-2:]:
            by_path.setdefault(b["rung"], b)
    finally:
        stop(proc, lerr)
    emit({"phase": "serve", "corpus_rows": CONFIG4["num_data"],
          "capacity_rows": geo["capacity_rows"],
          "chunks": [geo["nchunks"], geo["chunk_rows"]],
          "cold_start_ms": ready["cold_start_compile_ms"],
          "ready_wall_ms": ready["ready_wall_ms"],
          "buckets": ready["paths"], "compile_count": ready["compile_count"],
          "kernel_loads": ready["kernel_loads"],
          "requests": len(reqs), "queries": sum(r["nq"] for r in reqs),
          "replay_s": replay_s, "client_requests_per_s": len(reqs) / replay_s,
          "client_ms": sorted(r["client_ms"] for r in res),
          "requests_per_sec": st1["requests_per_sec"],
          "request_latency_ms": st3.get("request_latency_ms"),
          "batches": len(replay_batches),
          "phase_ms_by_path": {p: {"bucket": b["bucket"], "nq": b["nq"],
                                   "phase_ms": b["phase_ms"]}
                               for p, b in by_path.items()},
          "last_gated_fraction": eng2["last_gated_fraction"],
          "last_prune": eng2["last_prune"], "repairs": repairs,
          "summary_rebuilds": eng2["summary_rebuilds"],
          "launches": launches,
          "device_memory": st3.get("device_memory"),
          "ladder_rungs": rungs, "ladder_cold_start_ms":
          lready["cold_start_compile_ms"], "scrape": scrape,
          "slo": st3.get("slo")})
    return launches


def serve_scrape(ready, stats):
    """``GET /metrics`` of the daemon's telemetry session after the
    replay: it validates, its request-latency histogram counts every
    request served, and the stats op carries the SLO block."""
    import urllib.request
    from dmlp_tpu_torch.obs.telemetry import validate_openmetrics
    with urllib.request.urlopen(
            f"http://127.0.0.1:{ready['telemetry_port']}/metrics",
            timeout=30) as r:
        text = r.read().decode()
    problems = validate_openmetrics(text)
    count = [int(ln.split()[1]) for ln in text.splitlines()
             if ln.startswith("serve_request_latency_ms_count ")]
    check(not problems, f"serve: GET /metrics: {problems[:3]}")
    check(count == [stats["requests_completed"]],
          f"serve: request latency count {count}, served "
          f"{stats['requests_completed']}")
    check("slo" in stats and stats["slo"]["objectives"],
          f"serve: no SLO block in stats: {stats.get('slo')}")
    return {"lines": len(text.splitlines()), "request_count": count[0]}


def _children(pid):
    """Process ids whose parent is ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


def fleet_mesh_batch_plan(mgeo, b):
    """The launches each rank of the mesh replica must have made for one
    logged micro-batch: on the extract path K1 once per non-empty piece of
    its shard the live mask kept, and a merge per launch at S > 1; on the
    stream path K3 once per block of its shard and query block."""
    r, c = FLEET_MESH
    sr, cr = mgeo["shard_rows"], mgeo["chunk_rows"]
    plans = []
    for rank in range(r * c):
        rr = rank // c
        want = {k: 0 for k in KERNELS}
        if b["path"] == "extract":
            for t in range(mgeo["nchunks"]):
                lo = rr * sr + t * cr
                hi = min(lo + cr, (rr + 1) * sr, b["n_real"])
                if hi > lo and (b["live"] is None or b["live"][rr][t]):
                    want["fused_topk"] += 1
            want["extract_merge"] = sum(
                n for s, n in b["launch_variants_by_rank"][rank].get(
                    "fused_topk", {}).items() if int(s) > 1)
        else:
            qb = min(1 << max(min(mgeo["query_block"], b["qloc"])
                              .bit_length() - 1, 3), b["qloc"])
            want["fused_dist_segmin"] = (
                mgeo["stream_rows"] // mgeo["data_block"]) * (b["qloc"] // qb)
        plans.append(want)
    return plans


def fleet_check_mesh_batches(label, mgeo, stats, seen, launches):
    """Hold every micro-batch the mesh replica logged since ``seen``
    against each rank's launch plan and its shapes against the ones the
    kernels and segmin phases held; add the launches (summed over ranks)
    to ``launches``. Returns the last sequence number."""
    log = stats["engine"]["batch_log"]
    new = [b for b in log if b["seq"] > seen]
    check(not new or new[0]["seq"] == seen + 1,
          f"{label}: the batch log lost batches after {seen}")
    for b in new:
        want = fleet_mesh_batch_plan(mgeo, b)
        check(b["launches_by_rank"] == want,
              f"{label}: batch {b['seq']} ({b['bucket']}, {b['path']}) "
              f"launched {b['launches_by_rank']} by rank, its plan {want}")
        if b["path"] == "extract":
            shape = (b["qloc"], mgeo["chunk_rows"], 64, b["kcap"])
            check(shape in HELD["k1"], f"{label}: batch {b['seq']} "
                  f"launched K1 at {shape}, not held by the kernels phase")
        else:
            qb = min(1 << max(min(mgeo["query_block"], b["qloc"])
                              .bit_length() - 1, 3), b["qloc"])
            shape = (qb, mgeo["data_block"], 64)
            check(shape in HELD["k3"], f"{label}: batch {b['seq']} "
                  f"launched K3 at {shape}, not held by the segmin phase")
        for k, v in b["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return new[-1]["seq"] if new else seen


def _replica_stats(fp):
    from dmlp_tpu_torch.serve import client as sc
    cli = sc.ServeClient(fp.ready["port"])
    try:
        return cli.stats()["stats"]
    finally:
        cli.close()


def _signature(port):
    from dmlp_tpu_torch.serve import client as sc
    cli = sc.ServeClient(port)
    try:
        doc = cli.call({"op": "corpus", "start": 0, "count": 0})
    finally:
        cli.close()
    return doc["corpus_rows"], doc["checksum"]


def _await_stats(port, pred, what, timeout_s):
    """Poll a router's stats until ``pred`` holds (fails after the
    timeout)."""
    from dmlp_tpu_torch.serve import client as sc
    deadline = time.monotonic() + timeout_s
    while True:
        cli = sc.ServeClient(port)
        try:
            st = cli.stats()["stats"]
        finally:
            cli.close()
        if pred(st):
            return st
        check(time.monotonic() < deadline, f"fleet: {what} did not happen "
              f"within {timeout_s} s: {json.dumps(st)[:2000]}")
        time.sleep(0.25)


def _scrape(port):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        return r.read().decode()


def _flight_dumps(directory):
    return sorted(p for p in os.listdir(directory)
                  if p.startswith("FLIGHT_"))


def _mesh_phase_ms(log, path):
    """Median per-batch phase times of the mesh replica's batches on
    ``path`` (rank 0's view: plan, broadcast, stage, fold, merge, gather,
    fetch, finalize) and each rank's fold."""
    import numpy as np
    bs = [b for b in log if b["path"] == path]
    if not bs:
        return None
    keys = sorted({k for b in bs for k in b["phase_ms"]})
    out = {k: float(np.median([b["phase_ms"].get(k, 0.0) for b in bs]))
           for k in keys}
    out["fold_by_rank"] = [float(np.median([b["phase_ms_by_rank"][r].get(
        "fold", 0.0) for b in bs])) for r in range(len(bs[0][
            "phase_ms_by_rank"]))]
    out["batches"] = len(bs)
    return out


def fleet_phase(tmp_dir):
    """The serving fleet on the card over config 4's corpus: a plain and
    a mesh-resident replica behind the router (checks 1-6 and 8 of the
    module docstring), then the self-healing campaigns on a supervised
    fleet, a fault-injected static fleet and a mesh replica whose worker
    rank dies (check 7). Returns the replicas' replay launches."""
    import numpy as np
    from dmlp_tpu_torch.fleet import consistency as ccs
    from dmlp_tpu_torch.fleet import harness as fh
    from dmlp_tpu_torch.fleet import loadgen
    from dmlp_tpu_torch.fleet import scrape as fscrape
    from dmlp_tpu_torch.io.grammar import KNNInput, Params
    from dmlp_tpu_torch.obs import trace as obs_trace
    from dmlp_tpu_torch.obs.telemetry import validate_openmetrics
    from dmlp_tpu_torch.serve import client as sc

    t_phase = time.perf_counter()
    out = os.path.join(tmp_dir, "fleet")
    traces = os.path.join(out, "traces")
    os.makedirs(traces)
    corpus_path = os.path.join(out, "corpus.txt")
    with open(corpus_path, "w") as f:
        f.write(config_text("config4"))
    corpus = config_input("config4")
    geo, mgeo = serve_geometry(), fleet_mesh_geometry()
    header, reqs = serve_trace()
    second = reqs[:14]
    spec = ",".join(f"{nq}x{k}" for nq, k in
                    sc.warm_buckets_for_trace(reqs, 1024))
    # No tune cache: every launch knob takes its heuristic, as the kernels
    # phase held it.
    env = {"DMLP_TPU_TUNE_CACHE": os.path.join(tmp_dir, "absent.json")}
    mesh_flags = ["--mesh", f"{FLEET_MESH[0]}x{FLEET_MESH[1]}",
                  "--backend", "gloo"]
    launches = {"fleet_plain_replica": {k: 0 for k in KERNELS},
                "fleet_mesh_replica": {k: 0 for k in KERNELS}}
    rec = {"phase": "fleet", "corpus_rows": CONFIG4["num_data"],
           "capacity_rows": geo["capacity_rows"], "mesh": list(FLEET_MESH),
           "mesh_chunks": [mgeo["nchunks"], mgeo["chunk_rows"]],
           "resplit_on_card": "not run: held by the CPU tests "
                              "(tests/test_torch_fleet_selfheal.py)"}

    # -- 1. the fleet comes up: both replicas started together -------------
    t0 = time.perf_counter()
    reps = [fh.spawn_replica(
        corpus_path, out, f"replica{i:02d}", spec, batch_cap=1024,
        flags=[*FLEET_FLAGS, "--trace",
               os.path.join(traces, f"trace-replica{i:02d}.json"), *extra],
        env_extra=env) for i, extra in enumerate(([], mesh_flags))]
    plain, mesh = reps
    procs = list(reps)
    try:
        ready_ms = {}
        for fp in reps:
            fh.await_replica(fp, timeout_s=600)
            ready_ms[fp.name] = (time.perf_counter() - t0) * 1e3
        router = fh.spawn_router(out, reps, flags=[
            "--trace", os.path.join(traces, "trace-router.json"),
            "--health-interval-s", "0.5"])
        procs.append(router)
        rport = router.ready["port"]
        check(mesh.ready.get("mesh") == list(FLEET_MESH)
              and mesh.ready.get("backend") == "gloo",
              f"fleet: the mesh replica's ready file {mesh.ready}")
        rec["replicas"] = {fp.name: {
            "cold_start_ms": fp.ready["cold_start_compile_ms"],
            "ready_wall_ms": ready_ms[fp.name],
            "buckets": len(fp.ready["buckets"]),
            "compile_count": fp.ready["compile_count"],
            "kernel_loads": fp.ready["kernel_loads"]} for fp in reps}
        emit({"phase": "fleet_up", **rec["replicas"]})
        sp, sm = _replica_stats(plain), _replica_stats(mesh)
        pseq = serve_check_batches("fleet plain warm-up", geo, sp, 0, {})
        mseq = fleet_check_mesh_batches("fleet mesh warm-up", mgeo, sm, 0,
                                        {})
        mesh_loads = sm["engine"]["batch_log"][-1]["kernel_loads_by_rank"]

        # -- 2. routed byte identity, closed loop ---------------------------
        t0 = time.perf_counter()
        res = sc.replay(rport, header, reqs, connections=4)
        rec["replay_s"] = time.perf_counter() - t0
        check(all(r["ok"] for r in res), f"fleet replay: a request failed "
              f"{[r for r in res if not r['ok']][:1]}")
        serve_golden("fleet_replay", corpus, header, reqs, res)
        rst = _await_stats(rport, lambda s: True, "stats", 30)
        served = {r["replica"]: r["requests"] for r in rst["replicas"]}
        check(len(served) == 2 and all(v > 0 for v in served.values()),
              f"fleet replay: not every replica served traffic {served}")
        rec["served_by_replica"] = served
        rec["client_ms"] = sorted(r["client_ms"] for r in res)
        sp, sm = _replica_stats(plain), _replica_stats(mesh)
        pseq = serve_check_batches("fleet plain replay", geo, sp, pseq,
                                   launches["fleet_plain_replica"])
        mseq = fleet_check_mesh_batches("fleet mesh replay", mgeo, sm,
                                        mseq,
                                        launches["fleet_mesh_replica"])
        for fp, st in ((plain, sp), (mesh, sm)):
            eng = st["engine"]
            check(eng["compile_count"] == fp.ready["compile_count"]
                  and eng["kernel_loads"] == fp.ready["kernel_loads"]
                  and eng["buckets"] == fp.ready["buckets"],
                  f"fleet replay: {fp.name} built {eng['compile_count']} / "
                  f"loaded {eng['kernel_loads']} after a warmed replay, "
                  f"{fp.ready['compile_count']} / {fp.ready['kernel_loads']}"
                  " at ready")
        check(sm["engine"]["batch_log"][-1]["kernel_loads_by_rank"]
              == mesh_loads, "fleet replay: a mesh rank loaded a kernel "
              "library after ready")
        rec["mesh_phase_ms"] = {
            p: _mesh_phase_ms([b for b in sm["engine"]["batch_log"]
                               if b["seq"] > len(mesh.ready["buckets"])], p)
            for p in ("extract", "stream")}

        # -- 3. the open-loop curve -----------------------------------------
        paced = [dict(r, t_ms=50 * i) for i, r in enumerate(reqs)]
        levels = loadgen.run_levels(rport, header, paced, speeds=[1.0, 2.0],
                                    reps=1, replicas=2, trace="serve_trace",
                                    tool="chip_smoke")
        rec["open_loop"] = []
        for lv in levels:
            m = lv.metrics
            rec["open_loop"].append({"level": lv.config["level"], **{
                k: m.get(k) for k in ("offered_qps", "achieved_qps",
                                      "p50_ms", "p95_ms", "p99_ms",
                                      "max_ms", "lag_p95_ms", "errors",
                                      "rejected", "requests")},
                # achieved_qps counts queries over the level's span
                # (first scheduled fire to last completion).
                "requests_per_s": m["requests"] * m["achieved_qps"]
                / sum(r["nq"] for r in paced)})
            check(m["errors"] == 0 and m["rejected"] == 0,
                  f"fleet open loop {lv.config['level']}: {m}")
        emit({"phase": "fleet_open_loop", "levels": rec["open_loop"]})

        # The traced replay (check 6's client side): rids and client spans.
        tracer = obs_trace.install(obs_trace.Tracer())
        tracer.sync_instant("fleet.clock_sync")
        try:
            tres = sc.replay_open_loop(rport, header, paced[:16],
                                       rid_prefix="fleet-", level=1.0)
            tracer.write(os.path.join(traces, "trace-client.json"),
                         process_name="client")
        finally:
            obs_trace.uninstall()
        check(all(r.get("ok") for r in tres), "fleet traced replay: a "
              "request failed")
        serve_golden("fleet_traced", corpus, header, paced[:16], tres)

        # -- 4. ingest fan-out ----------------------------------------------
        rng = np.random.default_rng(12)
        rows = rng.uniform(0.0, 100.0, (24000, CONFIG4["num_attrs"]))
        labels = rng.integers(0, CONFIG4["num_labels"], 24000)
        cli = sc.ServeClient(rport)
        for part in (slice(0, 12000), slice(12000, 24000)):
            r = cli.ingest(labels[part], rows[part])
            check(r["ok"], f"fleet ingest: {r}")
        cli.close()
        grown = KNNInput(Params(CONFIG4["num_data"] + 24000, 0,
                                CONFIG4["num_attrs"]),
                         np.concatenate([corpus.labels,
                                         labels.astype(np.int32)]),
                         np.vstack([corpus.data_attrs, rows]),
                         np.zeros(0, np.int32),
                         np.zeros((0, CONFIG4["num_attrs"])))
        sigs = [_signature(fp.ready["port"]) for fp in reps]
        want_sig = (grown.params.num_data,
                    ccs.corpus_fold(grown.labels, grown.data_attrs))
        check(sigs[0] == sigs[1] == want_sig,
              f"fleet ingest: signatures {sigs}, want {want_sig}")
        res2 = sc.replay(rport, header, second, connections=4)
        check(all(r["ok"] for r in res2), "fleet replay 2: a request failed")
        serve_golden("fleet_replay_grown", grown, header, second, res2)
        sp, sm = _replica_stats(plain), _replica_stats(mesh)
        serve_check_batches("fleet plain replay 2", geo, sp, pseq,
                            launches["fleet_plain_replica"])
        fleet_check_mesh_batches("fleet mesh replay 2", mgeo, sm, mseq,
                                 launches["fleet_mesh_replica"])

        # -- 5. the aggregated scrape -----------------------------------------
        text = _scrape(router.scrape_port)
        check(not validate_openmetrics(text),
              f"fleet: GET /metrics: {validate_openmetrics(text)[:3]}")
        served_total = sum(_replica_stats(fp)["requests_completed"]
                           for fp in reps)
        count = [int(float(ln.split()[1])) for ln in text.splitlines()
                 if ln.startswith("serve_request_latency_ms_count ")]
        check(count == [served_total], f"fleet scrape: latency count "
              f"{count}, served {served_total}")
        own, _ = fscrape.merge_expositions(
            [_scrape(fp.scrape_port) for fp in reps])

        def buckets(t):
            return [ln for ln in t.splitlines()
                    if ln.startswith("serve_request_latency_ms_bucket")]
        check(buckets(text) == buckets(own) and buckets(text),
              "fleet scrape: the router's latency buckets are not the "
              "bucket-wise merge of the replicas'")
        rec["scrape"] = {"lines": len(text.splitlines()),
                         "request_count": count[0],
                         "bucket_lines": len(buckets(text))}
        rec["router_stats"] = {k: rst.get(k) for k in (
            "requests", "retries", "rejected", "request_latency_ms")}

        # -- 8. drain: every process exits 0, no flight dump ----------------
        fh.drain_fleet(router, reps, timeout_s=120)
        check(not _flight_dumps(out),
              f"fleet drain left flight dumps {_flight_dumps(out)}")
    finally:
        fh.kill_all(procs)

    # -- 6. the fleet trace through the reference's tools ---------------------
    merged = os.path.join(out, "trace-fleet-merged.json")
    root = os.path.dirname(os.path.abspath(__file__))
    m = subprocess.run([sys.executable, "tools/merge_traces.py", "--fleet",
                        traces, "-o", merged], cwd=root,
                       capture_output=True, text=True, timeout=300)
    check(m.returncode == 0, f"merge_traces --fleet: {m.stderr[-2000:]}")
    c = subprocess.run([sys.executable, "tools/check_trace.py", "--fleet",
                        merged], cwd=root, capture_output=True, text=True,
                       timeout=300)
    check(c.returncode == 0, f"check_trace --fleet: "
          f"{(c.stdout + c.stderr)[-2000:]}")
    with open(merged) as f:
        recon = json.load(f)["fleet"]["reconcile"]
    check(recon.get("reconcile_residual_ms", 1e9) <= recon["tol_abs_ms"],
          f"fleet trace: median residual beyond {recon['tol_abs_ms']} ms "
          f"{recon}")
    rec["trace"] = {k: recon.get(k) for k in (
        "n_requests", "n_reconciled", "fraction", "reconcile_residual_ms",
        "residual_budget_ms", "tol_abs_ms")}
    emit({"phase": "fleet_trace", **rec["trace"]})

    # -- 7. self-healing ------------------------------------------------------
    rec["selfheal"] = fleet_selfheal(out, corpus_path, corpus, header, reqs,
                                     env)
    rec["wall_s"] = time.perf_counter() - t_phase
    emit(rec)
    return launches


def fleet_selfheal(out, corpus_path, corpus, header, reqs, env):
    """Check 7: a supervised fleet (two plain replicas) with one replica
    SIGKILLed during a replay wave, a static fleet whose second replica
    drops an ingest under a seeded fault, and a mesh replica whose worker
    rank is killed, all started together."""
    import numpy as np
    from dmlp_tpu_torch.fleet import harness as fh
    from dmlp_tpu_torch.fleet.mesh_engine import GROUP_TIMEOUT_S
    from dmlp_tpu_torch.io.grammar import KNNInput, Params
    from dmlp_tpu_torch.serve import client as sc

    res: dict = {}
    small = [r for r in reqs if r["nq"] <= 33 and r.get("k", 0) <= 32][:10]
    warm = ",".join(f"{nq}x{k}" for nq, k in
                    sc.warm_buckets_for_trace(small, 1024))
    sup_dir = os.path.join(out, "supervised")
    div_dir = os.path.join(out, "divergence")
    kill_dir = os.path.join(out, "mesh_kill")
    for d in (sup_dir, div_dir, kill_dir):
        os.makedirs(d)
    sched = os.path.join(div_dir, "faults.json")
    with open(sched, "w") as f:
        json.dump({"schema": 1, "seed": 7, "faults": [
            {"site": "serve.ingest", "kind": "transient", "times": 1,
             "message": "seeded dropped ingest"}]}, f)
    sup_ready = os.path.join(sup_dir, "router_ready.json")
    sup_err = os.path.join(sup_dir, "router.err")
    t0 = time.perf_counter()
    with open(sup_err, "w") as ef:
        sup = subprocess.Popen(
            [sys.executable, "-m", "dmlp_tpu_torch.fleet", "--spawn-corpus",
             corpus_path, "--spawn-replicas", "2", "--max-replicas", "2",
             "--out-dir", sup_dir, "--spawn-warm", warm,
             "--spawn-batch-cap", "1024",
             "--spawn-flags=" + " ".join(FLEET_FLAGS),
             "--relaunch-budget", "2", "--reshard-threshold", "0",
             "--poll-s", "0.25", "--health-interval-s", "0.25",
             "--port", "0", "--ready-file", sup_ready,
             "--telemetry-port", "0"], stdout=subprocess.DEVNULL,
            stderr=ef, env=fh._repo_env(env), cwd=sup_dir)
    div = [fh.spawn_replica(corpus_path, div_dir, f"replica{i:02d}", warm,
                            batch_cap=1024, flags=list(FLEET_FLAGS),
                            env_extra=dict(env, **(
                                {"DMLP_TPU_FAULTS": sched} if i else {})))
           for i in range(2)]
    timeout_s = GROUP_TIMEOUT_S
    killp = fh.spawn_replica(corpus_path, kill_dir, "replica_mesh", "32x8",
                             flags=[*FLEET_FLAGS, "--mesh", "2x1",
                                    "--backend", "gloo"], env_extra=env)
    procs = div + [killp]
    sup_fp = fh.FleetProc("supervised_router", sup, sup_ready, sup_err)
    try:
        sup_fp.ready = sc.await_ready(sup, sup_ready, timeout_s=600,
                                      errlog=sup_err)
        procs.append(sup_fp)
        sport = sup_fp.ready["port"]
        res["supervised_ready_wall_ms"] = (time.perf_counter() - t0) * 1e3
        fh.await_all(div + [killp], timeout_s=600)

        # Crash and relaunch: one managed replica SIGKILLed mid-wave.
        st = _await_stats(sport, lambda s: s["healthy_replicas"] == 2,
                          "two healthy supervised replicas", 60)
        victim = st["supervisor"]["managed"][0]
        wave = small * 3
        out_wave: dict = {}

        def run_wave():
            out_wave["res"] = sc.replay(sport, header, wave, connections=2)

        th = threading.Thread(target=run_wave)
        t_kill = time.perf_counter()
        th.start()
        time.sleep(0.3)
        os.kill(victim["pid"], signal.SIGKILL)
        th.join(timeout=300)
        check("res" in out_wave, "fleet crash: the replay wave hung")
        wres = out_wave["res"]
        check(all(r["ok"] for r in wres), f"fleet crash: a request of the "
              f"wave failed {[r for r in wres if not r['ok']][:1]}")
        serve_golden("fleet_crash_wave", corpus, header, wave, wres)
        st = _await_stats(
            sport, lambda s: (s["scale"]["crashes"] >= 1
                              and s["scale"]["relaunches"] >= 1
                              and s["healthy_replicas"] == 2),
            "the crash's detection and relaunch", 300)
        res["crash"] = {"victim": victim["name"],
                        "relaunch_s": time.perf_counter() - t_kill,
                        "scale": st["scale"], "wave": len(wres),
                        "hops": sum(1 for r in wres if r.get("hops"))}
        rev = sc.replay(sport, header, small, connections=2)
        check(all(r["ok"] for r in rev), "fleet revived: a request failed")
        serve_golden("fleet_revived", corpus, header, small, rev)
        cli = sc.ServeClient(sport)
        cli.drain()
        cli.close()
        check(sup.wait(timeout=180) == 0, f"fleet: the supervised router "
              f"exited non-zero; see {sup_err}")

        # Divergence and repair: the faulted replica drops the ingest.
        rports = [fp.ready["port"] for fp in div]
        router = fh.spawn_router(div_dir, div, flags=[
            "--repair", "on", "--revive-probes", "2",
            "--health-interval-s", "0.2"])
        procs.append(router)
        rng = np.random.default_rng(11)
        newl = rng.integers(0, CONFIG4["num_labels"], 6)
        newa = rng.uniform(0.0, 100.0, (6, CONFIG4["num_attrs"]))
        cli = sc.ServeClient(router.ready["port"])
        r = cli.ingest(newl, newa)
        cli.close()
        check(not r.get("ok") and "diverged" in str(r.get("error", "")),
              f"fleet divergence: the dropped ingest was not reported {r}")
        t_rep = time.perf_counter()
        st = _await_stats(
            router.ready["port"],
            lambda s: (s["consistency"]["divergences"] >= 1
                       and s["consistency"]["repairs"] >= 1),
            "the divergence's detection and repair", 120)
        sigs = [_signature(p) for p in rports]
        check(sigs[0] == sigs[1] and sigs[0][0] == CONFIG4["num_data"] + 6,
              f"fleet divergence: signatures after the repair {sigs}")
        grown = KNNInput(Params(CONFIG4["num_data"] + 6, 0,
                                CONFIG4["num_attrs"]),
                         np.concatenate([corpus.labels,
                                         newl.astype(np.int32)]),
                         np.vstack([corpus.data_attrs, newa]),
                         np.zeros(0, np.int32),
                         np.zeros((0, CONFIG4["num_attrs"])))
        rep = sc.replay(router.ready["port"], header, small, connections=2)
        check(all(x["ok"] for x in rep), "fleet repaired: a request failed")
        serve_golden("fleet_repaired", grown, header, small, rep)
        res["divergence"] = {"repair_ms": (time.perf_counter() - t_rep)
                             * 1e3, "consistency": st["consistency"]}
        fh.drain_fleet(router, div, timeout_s=120)
        check(not _flight_dumps(div_dir), f"fleet divergence drain left "
              f"flight dumps {_flight_dumps(div_dir)}")

        # A mesh replica's worker rank dies: its daemon exits non-zero
        # within the group's timeout.
        kids = _children(killp.proc.pid)
        check(len(kids) == 1, f"fleet mesh kill: worker ranks {kids}")
        t_k = time.perf_counter()
        os.kill(kids[0], signal.SIGKILL)
        try:
            rc = killp.proc.wait(timeout=timeout_s + 30)
        except subprocess.TimeoutExpired:
            rc = None
        exit_s = time.perf_counter() - t_k
        check(rc not in (None, 0) and exit_s <= timeout_s,
              f"fleet mesh kill: daemon rc {rc} after {exit_s:.1f} s "
              f"(group timeout {timeout_s} s)")
        res["mesh_worker_kill"] = {"rc": rc, "exit_s": exit_s,
                                   "timeout_s": timeout_s}
    finally:
        fh.kill_all(procs)
        for pid in _children(sup.pid) if sup.poll() is None else ():
            os.kill(pid, signal.SIGKILL)
        if sup.poll() is None:
            sup.kill()
            sup.wait(timeout=60)
    emit({"phase": "fleet_selfheal", **res})
    return res


# The auto phase's solves: (run, config, CLI flags, ranks, backend, the
# single-device run and the sharded run whose stdout it must print, and
# whether it also writes --hlo-report). Bench config 3 is config 2's data
# on a (4, 2) mesh: each rank folds one 25,600-row block of its shard
# through K3 for its 2,504-query shard; config 4 on (1, 1) folds four
# 50,176-row blocks for its 10,000 queries.
# Config 3 at (4, 2) in auto, sharded and ring, each with --hlo-report,
# is the bench phase's `bench 3 --auto-ab` (bench_auto_config3_checks).
AUTO_RUNS = (
    ("auto_1x1_config4", "config4",
     ["--mode", "auto", "--mesh", "1,1", "--pallas"], 1, "nccl",
     "config4_K1", "mesh_1x1_config4", False),
)
# The --hlo-report merges of config 3 at (4, 2) by arm: (mode, the
# merge's collective kind).
AUTO_HLO_MERGES = (("auto", "all-gather"), ("sharded", "all-gather"),
                   ("ring", "collective-permute"))
# Requests of the serve trace the --mesh-merge auto daemon replays.
AUTO_DAEMON_REQUESTS = 15


def _mesh_cli(label, name, flags, tmp_dir, warmup=True, hlo=False):
    """One mesh solve through ``cli.main`` (this process rank 0, the launch
    counts set to 0 just before it): its stdout, Time taken, phases, the
    ``--phase-times`` records, wall time and the ``--hlo-report`` record
    (None without it)."""
    import torch
    from dmlp_tpu_torch import cli, kernels
    path = os.path.join(tmp_dir, f"{label}.hlo.jsonl")
    argv = (flags + ["--phase-times"] + (["--warmup"] if warmup else [])
            + (["--hlo-report", path] if hlo else []))
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv, stdin=io.StringIO(config_text(name)), stdout=out,
                  stderr=err)
    wall_ms = (time.perf_counter() - t0) * 1e3
    check(rc == 0, f"{label}: cli.main returned {rc}")
    taken, phases, recs = _phase_lines(err.getvalue())
    rec = None
    if hlo:
        with open(path) as f:
            lines = f.read().splitlines()
        check(len(lines) == 1, f"{label}: {len(lines)} hlo records")
        rec = json.loads(lines[0])
    return out.getvalue(), taken, phases, recs, rec, wall_ms


def hlo_check(label, rec, merge, twin_bytes=None):
    """A ``--hlo-report`` record: the comms reconcile within bounds, the
    merge's kind at ratio 1 against its model, and (the auto engine) its
    all-gather bytes, all on the data axis, equal to the all-gather
    model's of the same plan."""
    doc = rec["comms"]
    leg = doc["reconcile"]["comms_model"]
    emit({"phase": "hlo", "run": label, "mode": rec["config"]["mode"],
          "device": rec.get("device"),
          "bytes_by_kind_axis": doc["bytes_by_kind_axis"],
          "collective_totals": doc["collective_totals"],
          "kinds": leg["kinds"], "unmodelled": leg["unmodelled"],
          "memory": doc["reconcile"]["memory"],
          "fingerprint": doc["executables"][0]["fingerprint"],
          "allgather_model_bytes": twin_bytes})
    check(leg["within_bounds"], f"{label}: the record is out of the "
                                f"models' bounds: {leg}")
    check(leg["kinds"].get(merge, {}).get("ratio") == 1.0,
          f"{label}: {merge} does not reconcile exactly: {leg}")
    if twin_bytes is not None:
        check(doc["bytes_by_kind_axis"].get("all-gather")
              == {"data": twin_bytes},
              f"{label}: all-gather {doc['bytes_by_kind_axis']} != the "
              f"all-gather model's {twin_bytes} B on the data axis")


def auto_phase(tmp_dir):
    """The compiler-sharded engine (``--mode auto``: DTensor placements,
    K3 in every rank's fold, the merge a DTensor redistribution) on the
    card: config 4 at (1, 1) on NCCL with ``--warmup``, stdout equal to
    the single-device solve's and the sharded engine's and golden on a
    subset, every rank's K3 launches the plan's (``engine.auto.
    plan_auto``) at a shape the segmin phase held (config 3 at (4, 2),
    with ``--hlo-report`` for sharded, ring and auto, is the bench
    phase's ``--auto-ab``: :func:`bench_auto_config3_checks`); then a
    ``--mesh 2x1 --mesh-merge auto`` daemon over config 4's corpus
    replaying the serve trace's first requests, golden, every rank's
    launches the plan's, drained with exit code 0. Returns the launches
    per run (summed over ranks)."""
    from dmlp_tpu_torch import cli
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.auto import plan_auto
    from dmlp_tpu_torch.fleet import harness as fh
    from dmlp_tpu_torch.obs import comms
    from dmlp_tpu_torch.serve import client as sc

    t_phase = time.perf_counter()
    launches = {}
    for label in ("config4_K1", "config2_seg"):
        if label not in OUTPUTS:
            name, flags = MESH_SINGLE[label]
            out = io.StringIO()
            check(cli.main(flags, stdin=io.StringIO(config_text(name)),
                           stdout=out, stderr=io.StringIO()) == 0,
                  f"{label}: cli.main failed")
            OUTPUTS[label] = out.getvalue()
    for label, name, flags, world, backend, same_as, sharded, hlo in \
            AUTO_RUNS:
        c = CONFIGS[name]
        r, cc = (int(x) for x in flags[flags.index("--mesh") + 1].split(","))
        plan = plan_auto(EngineConfig(use_pallas=True), c["num_data"],
                         c["num_queries"], int(config_input(name).ks.max()),
                         (r, cc))
        k3 = (plan["qloc"], plan["data_block"], c["num_attrs"])
        check(plan["select"] == "seg", f"{label}: plan {plan}")
        check(not HELD["k3"] or k3 in HELD["k3"],
              f"{label}: K3 at {k3}: no segmin case")
        # Per rank, for the warm-up solve and the timed one.
        want_rank = dict({k: 0 for k in KERNELS},
                         fused_dist_segmin=2 * plan["nblocks"])
        text, taken, phases, recs, hrec, wall_ms = _mesh_cli(
            label, name, flags, tmp_dir, hlo=hlo)
        mesh = recs["mesh"]
        ranks = mesh["ranks"]
        launches[label] = {k: sum(rk["launches"][k] for rk in ranks)
                           for k in KERNELS}
        emit({"phase": "auto", "run": label, "flags": flags,
              "time_taken_ms": taken, "phases_ms": phases,
              "wall_ms": wall_ms, "backend": mesh["backend"],
              "shape": mesh["shape"], "plan": plan,
              "rank_devices": {rk["rank"]: rk["device"] for rk in ranks},
              "launches_by_rank": {rk["rank"]: rk["launches"]
                                   for rk in ranks},
              "launches_per_rank_expected": want_rank, "k3_shape": k3,
              "rank_phases_ms": {rk["rank"]: rk["phases_ms"]
                                 for rk in ranks},
              "last_prune": recs["prune"], "repairs": recs["repairs"],
              "same_as": [same_as, sharded], "sharded_in_run":
              sharded in OUTPUTS, "stdout_lines": text.count("\n")})
        check(mesh["mode"] == "auto" and mesh["backend"] == backend
              and len(ranks) == world
              and all(rk["device"] == "cuda:0" for rk in ranks),
              f"{label}: mesh {mesh['mode']}, {mesh['backend']}, {ranks}")
        for rk in ranks:
            check(rk["launches"] == want_rank,
                  f"{label}: rank {rk['rank']} launched {rk['launches']}, "
                  f"want {want_rank}")
        check(recs["repairs"] <= MAX_REPAIR_SHARE * c["num_queries"],
              f"{label}: {recs['repairs']} of {c['num_queries']} queries "
              "repaired on the host")
        check(text == OUTPUTS[same_as],
              f"{label}: stdout differs from {same_as}'s")
        check(sharded not in OUTPUTS or text == OUTPUTS[sharded],
              f"{label}: stdout differs from {sharded}'s")
        golden_subset(label, name, text.splitlines(), 1000)
        if hrec is not None:
            check(hrec["config"]["plan"]["qloc"] == plan["qloc"]
                  and hrec["config"]["plan"]["k"] == plan["k"],
                  f"{label}: recorded plan {hrec['config']['plan']}")
            hlo_check(label, hrec, "all-gather", sum(
                t.bytes_total for t in comms.engine_comms(
                    "allgather", (r, cc), plan["qloc"], plan["k"])))
    # The --mesh-merge auto daemon over config 4's corpus.
    out = os.path.join(tmp_dir, "auto_daemon")
    os.makedirs(out)
    corpus_path = os.path.join(out, "corpus.txt")
    with open(corpus_path, "w") as f:
        f.write(config_text("config4"))
    header, reqs = serve_trace()
    reqs = reqs[:AUTO_DAEMON_REQUESTS]
    spec = ",".join(f"{nq}x{k}" for nq, k in
                    sc.warm_buckets_for_trace(reqs, 1024))
    mgeo = fleet_mesh_geometry()
    dl = {k: 0 for k in KERNELS}
    t0 = time.perf_counter()
    fp = fh.spawn_replica(
        corpus_path, out, "auto_replica", spec, batch_cap=1024,
        flags=[*FLEET_FLAGS, "--mesh", f"{FLEET_MESH[0]}x{FLEET_MESH[1]}",
               "--backend", "gloo", "--mesh-merge", "auto"],
        env_extra={"DMLP_TPU_TUNE_CACHE": os.path.join(tmp_dir,
                                                       "absent.json")})
    try:
        ready = fh.await_replica(fp, timeout_s=600)
        ready_ms = (time.perf_counter() - t0) * 1e3
        check(ready.get("merge") == "gspmd"
              and ready.get("mesh") == list(FLEET_MESH),
              f"auto daemon: ready file {ready}")
        seq = fleet_check_mesh_batches("auto daemon warm-up", mgeo,
                                       _replica_stats(fp), 0, {})
        t0 = time.perf_counter()
        res = sc.replay(ready["port"], header, reqs, connections=4)
        replay_s = time.perf_counter() - t0
        check(all(r["ok"] for r in res), f"auto daemon: a request failed "
              f"{[r for r in res if not r['ok']][:1]}")
        serve_golden("auto_daemon_replay", config_input("config4"), header,
                     reqs, res)
        st = _replica_stats(fp)
        fleet_check_mesh_batches("auto daemon replay", mgeo, st, seq, dl)
        emit({"phase": "auto_daemon", "merge": ready["merge"],
              "requests": len(reqs), "queries": sum(r["nq"] for r in reqs),
              "ready_wall_ms": ready_ms,
              "cold_start_ms": ready["cold_start_compile_ms"],
              "buckets": len(ready["buckets"]), "replay_s": replay_s,
              "client_ms": sorted(r["client_ms"] for r in res),
              "mesh_phase_ms": {p: _mesh_phase_ms(
                  [b for b in st["engine"]["batch_log"]
                   if b["seq"] > len(ready["buckets"])], p)
                  for p in ("extract", "stream")},
              "launches": dl})
        cli_ = sc.ServeClient(ready["port"])
        cli_.drain()
        cli_.close()
        check(fp.proc.wait(timeout=120) == 0,
              "auto daemon: the drain did not exit 0")
    finally:
        fh.kill_all([fp])
    launches["auto_mesh_daemon"] = dl
    emit({"phase": "auto_done",
          "wall_s": time.perf_counter() - t_phase})
    return launches


# The train phase (dmlp_tpu_torch.train): the benchmark model at the
# reference's width (train/bench.py), the small model of the loop's and
# the card-against-CPU runs, and the mesh's.
TRAIN_FULL = (1024, 8192, 8192, 1024)
TRAIN_SMALL = (64, 512, 512, 10)
TRAIN_MESH_DIMS = (64, 256, 256, 10)
TRAIN_OFFLOAD_BATCH = 32768


def _with_env(env, fn):
    """``fn()`` with ``env`` set in this process's environment, then the
    old values back."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _link_rates(nbytes: int = 1 << 28):
    """Pinned host-to-card and card-to-host copy rates (bytes/s), CUDA
    events over one copy of ``nbytes`` (median of 5 after a warm-up)."""
    import torch
    host = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    h2d, _ = time_ms(lambda: dev.copy_(host, non_blocking=True), 5)
    d2h, _ = time_ms(lambda: host.copy_(dev, non_blocking=True), 5)
    return nbytes / (h2d / 1e3), nbytes / (d2h / 1e3)


def _loop_main(argv):
    """``python -m dmlp_tpu_torch.train.loop argv`` in this process:
    (exit code, its ``final:`` line)."""
    import contextlib as _cl

    from dmlp_tpu_torch.train import loop
    out = io.StringIO()
    with _cl.redirect_stdout(out):
        rc = loop.main(argv)
    final = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("final: ")]
    return rc, final[-1] if final else None


def _jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def train_phase(tmp_dir):
    """The train extension on the card (``dmlp_tpu_torch.train``):
    ``train.bench`` at the reference's full width in bf16 and f32 (step
    time, samples/s, MFU against the bf16 peak, the allocator's peak
    against ``obs.memwatch.train_step_model``, the loss finite and
    falling); 3 steps of the same parameters and batches on the card and
    through the port on the CPU, in f32 (losses within rtol 1e-5: a TF32
    product would fail) and in bf16 (losses within rtol 1e-5, parameter
    changes within 1e-3); the offload levels "params" and "all" at batch
    32,768 beside the resident step (parameters bit for bit after 3
    steps, ``memory_allocated`` between steps lower by the offloaded bytes
    exactly, each step's peak, the bench's step times and the host link's
    rates in the same run); the loop CLI for 200 steps, a resume for 50,
    and a ``nan`` fault at step 5 under ``--nan-guard`` ending on the
    fault-free run's ``params_checksum``; the loop on a (2, 2) mesh of 4
    gloo ranks on cuda:0 in f32 and bf16 (its losses the (1, 1) run's
    within rtol 2e-5, its second step's time beside theirs,
    every rank's parameters on the card, the dp all-reduce bytes of the
    collective record those of ``obs.comms`` plus the replicated row
    biases, DTensor's tp collectives listed as unmodelled). No run
    launches a hand-written kernel. Returns the launches per run."""
    import gc

    import numpy as np
    import torch

    from dmlp_tpu_torch import kernels
    from dmlp_tpu_torch.obs import comms, memwatch
    from dmlp_tpu_torch.train import bench, loop
    from dmlp_tpu_torch.train import step as S
    from dmlp_tpu_torch.train.data import teacher_batches

    t_phase = time.perf_counter()
    launches = {}

    def counted(label, fn):
        kernels.reset_launch_counts()
        out = fn()
        launches[label] = {k: kernels.LAUNCHES[k] for k in KERNELS}
        check(not any(launches[label].values()),
              f"{label}: the train path launched {launches[label]}")
        return out

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    full = ",".join(map(str, TRAIN_FULL))
    for dtype, label in (("bfloat16", "train_bench_bf16"),
                         ("float32", "train_bench_f32")):
        res = counted(label, lambda: _with_env(
            {"TRAIN_DIMS": full, "TRAIN_BATCH": "8192", "TRAIN_STEPS": "30",
             "TRAIN_DTYPE": dtype, "TRAIN_OFFLOAD": "none"},
            bench.train_bench))
        model = memwatch.train_step_model(
            list(TRAIN_FULL), 8192, "sgd", None,
            dtype if dtype == "bfloat16" else None)
        mem = memwatch.reconcile(model, {"bytes": res["peak_memory_bytes"],
                                         "basis": "max_memory_allocated"})
        emit({"phase": "train", "run": label, **res, "mem_model": mem})
        check(np.isfinite(res["first_loss"]) and np.isfinite(
            res["final_loss"]) and res["final_loss"] < res["first_loss"],
              f"{label}: loss {res['first_loss']} -> {res['final_loss']}")
        free()

    # The card against the CPU: 3 steps in f32 and in bf16, same
    # parameters and batches.
    opt = S.make_optimizer("sgd", 1e-2)
    it = teacher_batches(TRAIN_SMALL[0], TRAIN_SMALL[-1], 4096, seed=1)
    small = [next(it) for _ in range(3)]
    for cdtype, label in ((None, "train_card_vs_cpu"),
                          (torch.bfloat16, "train_card_vs_cpu_bf16")):
        got = {}
        for dev in ("cuda", "cpu"):
            def run(dev=dev):
                st = loop.build_sharded_state(None, TRAIN_SMALL, opt,
                                              seed=0, device=dev)
                init = [p.detach().cpu().clone() for p in
                        st["params"].parameters()]
                fn = S.make_train_step(opt, cdtype)
                losses = []
                for x, y in small:
                    st, m = fn(st, torch.from_numpy(x).to(dev),
                               torch.from_numpy(y).to(dev))
                    losses.append(S.global_metrics(m)["loss"])
                return losses, init, [p.detach().cpu() for p in
                                      st["params"].parameters()]
            got[dev] = counted(f"{label}_{dev}", run)
        (lc, _, pc), (lh, p0, ph) = got["cuda"], got["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        # The parameter change's distance from the CPU run's, relative to
        # its norm, per leaf.
        change = [float((a - b).norm() / (b - c).norm())
                  for a, b, c in zip(pc, ph, p0)]
        emit({"phase": "train", "run": label, "dims": list(TRAIN_SMALL),
              "batch": 4096, "compute_dtype": str(cdtype),
              "losses_cuda": lc, "losses_cpu": lh, "max_loss_rel_err": rel,
              "max_param_abs_err": max(float((a - b).abs().max())
                                       for a, b in zip(pc, ph)),
              "param_change_rel_err": change,
              "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
        # f32: IEEE products on both sides (a TF32 product would fail).
        # bf16: the same exact bf16 products, accumulated in f32 in
        # another order, whose flipped bf16 roundings move the parameter
        # change by about 2e-4 of its norm (measured on the CPU against
        # float64 accumulation); a gradient rounded to bf16 before its
        # products or weight gradients left unrounded move it by 1.3e-3
        # or more.
        check(np.allclose(lc, lh, rtol=1e-5, atol=0)
              and (cdtype is None or max(change) < 1e-3),
              f"{label}: losses {lc} against {lh}, parameter change "
              f"errors {change}")

    # The offload levels beside the resident step, at batch 32,768.
    it = teacher_batches(TRAIN_FULL[0], TRAIN_FULL[-1], TRAIN_OFFLOAD_BATCH,
                         seed=1)
    big = [tuple(torch.from_numpy(a).cuda() for a in next(it))
           for _ in range(3)]
    resident, rows = None, {}
    for level in ("none", "params", "all"):
        def run(level=level):
            st = loop.build_sharded_state(None, TRAIN_FULL, opt, seed=0,
                                          offload=level, device="cuda")
            fn = S.make_train_step(opt, torch.bfloat16) if level == "none" \
                else S.make_offload_train_step(opt, torch.bfloat16)
            between, peaks = [], []
            for x, y in big:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                st, m = fn(st, x, y)
                S.settle(st)
                torch.cuda.synchronize()
                between.append(torch.cuda.memory_allocated())
                peaks.append(torch.cuda.max_memory_allocated())
            host = [t for t in list(st["params"].parameters())
                    + [v for ms in st["opt"].values() for v in ms.values()]
                    if t.device.type == "cpu"]
            row = {"between_steps_bytes": between, "step_peak_bytes": peaks,
                   "host_bytes": sum(t.numel() * t.element_size()
                                     for t in host),
                   "host_pinned": all(t.is_pinned() for t in host),
                   "loss": S.global_metrics(m)["loss"]}
            return row, [p.detach().cpu() for p in st["params"].parameters()]
        row, params = counted(f"train_offload_{level}_steps", run)
        if level == "none":
            resident = params
        else:
            row["params_equal_resident"] = all(
                torch.equal(a, b) for a, b in zip(params, resident))
        rows[level] = row
        del params
        free()
    del big
    free()
    h2d, d2h = _link_rates()
    pbytes = sum(a * b + b
                 for a, b in zip(TRAIN_FULL[:-1], TRAIN_FULL[1:])) * 4
    for level in ("none", "params", "all"):
        res = counted(f"train_offload_{level}", lambda level=level: _with_env(
            {"TRAIN_DIMS": full, "TRAIN_BATCH": str(TRAIN_OFFLOAD_BATCH),
             "TRAIN_STEPS": "10", "TRAIN_DTYPE": "bfloat16",
             "TRAIN_OFFLOAD": level}, bench.train_bench))
        rows[level]["bench"] = res
        free()
    for level in ("params", "all"):
        row = rows[level]
        stream = pbytes * (2 if level == "all" else 1)   # each way
        row["offloaded_bytes"] = stream
        row["stream_ms_at_link"] = (stream / h2d + stream / d2h) * 1e3
        row["resident_step_ms"] = rows["none"]["bench"]["step_time_ms"]
        row["resident_between_steps_bytes"] = \
            rows["none"]["between_steps_bytes"]
        row["resident_step_peak_bytes"] = rows["none"]["step_peak_bytes"]
        emit({"phase": "train", "run": f"train_offload_{level}",
              "batch": TRAIN_OFFLOAD_BATCH, "h2d_bytes_per_s": h2d,
              "d2h_bytes_per_s": d2h, **row})
        check(row["params_equal_resident"],
              f"train_offload_{level}: parameters differ from the "
              "resident step's after 3 steps")
        check(row["host_bytes"] == stream and row["host_pinned"],
              f"train_offload_{level}: {row['host_bytes']} bytes on the "
              f"host (pinned: {row['host_pinned']}), want {stream}")
        lower = [a - b for a, b in zip(rows["none"]["between_steps_bytes"],
                                       row["between_steps_bytes"])]
        check(all(d == stream for d in lower),
              f"train_offload_{level}: memory_allocated lower by {lower} "
              f"between steps, want {stream}")

    # The loop CLI: 200 steps, a resume for 50, a nan fault at step 5.
    common = ["--dims", ",".join(map(str, TRAIN_SMALL)), "--batch", "4096",
              "--log-every", "50", "--ckpt-every", "100", "--nan-guard"]
    sched = os.path.join(tmp_dir, "train_nan.json")
    with open(sched, "w") as f:
        json.dump({"schema": 1, "seed": 0, "faults": [
            {"site": "train.step", "kind": "nan", "when": {"step": 5}}]}, f)
    recs, finals, walls = {}, {}, {}
    for label, extra in (
            ("train_loop", ["--steps", "200"]),
            ("train_loop_resume", ["--steps", "50", "--resume"]),
            ("train_loop_nan", ["--steps", "200", "--faults", sched,
                                "--trace", os.path.join(tmp_dir,
                                                        "train_trace.json")])):
        ck = os.path.join(tmp_dir, "train_ck_nan" if label.endswith("nan")
                          else "train_ck")
        rec = os.path.join(tmp_dir, f"{label}.json")
        mfile = os.path.join(tmp_dir, f"{label}.jsonl")
        t0 = time.perf_counter()
        rc, final = counted(label, lambda extra=extra, ck=ck, rec=rec,
                            mfile=mfile: _loop_main(
            common + extra + ["--checkpoint-dir", ck, "--record", rec,
                              "--metrics-file", mfile]))
        walls[label] = time.perf_counter() - t0
        check(rc == 0 and final is not None, f"{label}: exit {rc}")
        with open(rec) as f:
            recs[label] = json.load(f)["metrics"]
        finals[label] = final
        windows = [r for r in _jsonl(mfile) if "step" in r]
        emit({"phase": "train", "run": label, "wall_s": walls[label],
              "final": final, "windows": [
                  {k: r[k] for k in ("step", "loss", "accuracy",
                                     "step_time_ms", "mfu")}
                  for r in windows],
              "params_checksum": recs[label]["params_checksum"],
              "resilience": recs[label].get("resilience"),
              "ranks": recs[label]["ranks"]})
        check(all(np.isfinite(r["loss"]) for r in windows),
              f"{label}: a non-finite loss")
    a, b, c = (recs[k] for k in ("train_loop", "train_loop_resume",
                                 "train_loop_nan"))
    check(a["step"] == 200 and b["step"] == 250 and c["step"] == 200,
          f"train_loop: steps {a['step']}, {b['step']}, {c['step']}")
    check(c["params_checksum"] == a["params_checksum"]
          and c["resilience"]["rollbacks"] == 1,
          f"train_loop_nan: checksum {c['params_checksum']} against "
          f"{a['params_checksum']}, resilience {c.get('resilience')}")
    check(a["ranks"][0]["device"] == "cuda:0",
          f"train_loop: parameters on {a['ranks']}")

    # The loop on a (2, 2) mesh: 4 gloo ranks on cuda:0, against (1, 1),
    # in f32 and in bf16 (each rank's local bf16 products).
    mesh_common = ["--dims", ",".join(map(str, TRAIN_MESH_DIMS)), "--batch",
                   "1024", "--steps", "2", "--log-every", "1"]
    out = {}
    runs = {"train_mesh_1x1": [],
            "train_mesh_2x2": ["--mesh", "2,2", "--backend", "gloo"],
            "train_mesh_1x1_bf16": ["--compute-dtype", "bfloat16"],
            "train_mesh_2x2_bf16": ["--mesh", "2,2", "--backend", "gloo",
                                    "--compute-dtype", "bfloat16"]}
    argvs = {label: mesh_common + extra + [
        "--record", os.path.join(tmp_dir, f"{label}.json"),
        "--metrics-file", os.path.join(tmp_dir, f"{label}.jsonl")]
        for label, extra in runs.items()}
    # The (2, 2) runs: one spawn of 4 gloo ranks on cuda:0 for both.
    work = os.path.join(tmp_dir, "train_mesh")
    os.makedirs(work)
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump({"rows": [[label, argvs[label]] for label in runs
                            if "2x2" in label]}, f)
    got = spawn_par_script("train_mesh", work, 4, "cuda")
    for label in runs:
        rec, mfile = argvs[label][-3], argvs[label][-1]
        if "2x2" in label:
            check(all(g["rows"][label]["rc"] == 0 for g in got),
                  f"{label}: exits {[g['rows'][label] for g in got]}")
            wall = got[0]["rows"][label]["wall_s"]
        else:
            t0 = time.perf_counter()
            rc, _final = counted(label, lambda label=label: _loop_main(
                argvs[label]))
            check(rc == 0, f"{label}: exit {rc}")
            wall = time.perf_counter() - t0
        lines = _jsonl(mfile)
        windows = [r for r in lines if "step" in r]
        with open(rec) as f:
            out[label] = {"wall_s": wall,
                          "losses": [r["loss"] for r in windows],
                          # the second step's: the first holds the set-up
                          "step_time_ms": windows[-1]["step_time_ms"],
                          "comms": [r for r in lines
                                    if r.get("event") == "comms"],
                          "hlo": [r for r in lines
                                  if r.get("event") == "hlo"][0],
                          "ranks": json.load(f)["metrics"]["ranks"]}
        if "2x2" in label:
            launches[label] = {k: sum(r["kernel_launches"].get(k, 0)
                                      for r in out[label]["ranks"])
                               for k in KERNELS}
            check(not any(launches[label].values()),
                  f"{label}: the train path launched {launches[label]}")
    pbytes = sum(a * b + b for a, b in zip(TRAIN_MESH_DIMS[:-1],
                                            TRAIN_MESH_DIMS[1:])) * 4
    (psum,) = comms.train_step_comms(pbytes, (2, 2), steps=1)
    row_bias = sum(TRAIN_MESH_DIMS[i + 1]
                   for i in range(1, len(TRAIN_MESH_DIMS) - 1, 2)) * 4
    excess = 4 * round(2 * (2 - 1) * (row_bias - row_bias // 2) / 2)
    for suffix in ("", "_bf16"):
        one = out["train_mesh_1x1" + suffix]
        mesh = out["train_mesh_2x2" + suffix]
        label = "train_mesh_2x2" + suffix
        by_axis = mesh["hlo"]["by_axis"]
        emit({"phase": "train", "run": label, "backend": "gloo",
              "dims": list(TRAIN_MESH_DIMS), "batch": 1024,
              "compute_dtype": "bfloat16" if suffix else "float32",
              "losses": mesh["losses"], "losses_1x1": one["losses"],
              "step_time_ms": mesh["step_time_ms"],
              "step_time_ms_1x1": one["step_time_ms"],
              "wall_s": mesh["wall_s"], "ranks": mesh["ranks"],
              "dp_allreduce_bytes": by_axis.get("all-reduce@dp"),
              "dp_model_bytes": psum.bytes_total,
              "replicated_row_bias_excess_bytes": excess,
              "unmodelled": {k: v for k, v in by_axis.items()
                             if not k.endswith("@dp")},
              "comms_event": mesh["comms"], "hlo_event": mesh["hlo"]})
        check(len(mesh["losses"]) == 2 and np.allclose(
            mesh["losses"], one["losses"], rtol=2e-5, atol=0),
              f"{label}: losses {mesh['losses']} against "
              f"{one['losses']}")
        check(len(mesh["ranks"]) == 4 and all(
            r["device"] == "cuda:0" for r in mesh["ranks"]),
              f"{label}: parameters on {mesh['ranks']}")
        check(by_axis.get("all-reduce@dp") == psum.bytes_total + excess,
              f"{label}: dp all-reduce {by_axis.get('all-reduce@dp')} "
              f"bytes, want {psum.bytes_total} + {excess}")
    emit({"phase": "train_done", "wall_s": time.perf_counter() - t_phase})
    return launches


# The train_parallel phase (dmlp_tpu_torch.train.pipeline / .experts): the
# pipeline and MoE families at the reference's own benchmark widths
# (PIPEBENCH_r05.json "hidden_2048", tools/pipebench.py:77-93;
# TRAINBENCH_r05_moe.json, tools/trainbench_moe.py:34-41) through the loop
# CLI on 8 gloo ranks sharing cuda:0, each beside the model of its
# collectives.
PAR_FLAGS = ("--backend", "gloo")
PAR_DEVICE = "cuda"
PAR_PP_DIMS = (64, 2048, 16)
PAR_EP_DIMS = (64, 512, 2048, 16)
# SGD with the loop's momentum 0.9: the 8-layer pipelines at lr 1e-3 (at
# 1e-2 and 5e-2 their loss rises over the first steps), the MoE at the
# loop's default 1e-2.
PAR_RUNS = (
    ("par_dp_pp_gpipe", ["--parallelism", "dp_pp", "--mesh", "2,4",
                         "--batch", "512", "--microbatches", "4",
                         "--lr", "0.001"]),
    ("par_dp_pp_interleaved", ["--parallelism", "dp_pp", "--mesh", "2,4",
                               "--batch", "512", "--microbatches", "4",
                               "--pp-schedule", "interleaved",
                               "--virtual-stages", "2", "--lr", "0.001"]),
    ("par_dp_pp3", ["--parallelism", "dp_pp3", "--mesh", "2,2,2",
                    "--batch", "512", "--microbatches", "4",
                    "--lr", "0.001"]),
    ("par_dp_ep_dense", ["--parallelism", "dp_ep", "--mesh", "2,4",
                         "--batch", "4096", "--experts", "8"]),
    ("par_dp_ep_a2a", ["--parallelism", "dp_ep", "--mesh", "2,4",
                       "--batch", "4096", "--experts", "8",
                       "--moe-dispatch", "a2a", "--capacity-factor",
                       "1.25"]),
)
# the card against the CPU, each family at a small width on the same mesh
PAR_SMALL_PP_DIMS = (64, 256, 10)
PAR_SMALL_EP_DIMS = (64, 128, 256, 10)
PAR_SMALL_BATCH = 256

GLOO_PROBE = r"""
import json, sys
import torch, torch.distributed as dist
rank, port, what = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
import datetime
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=30))
x = torch.full((4, 8), float(rank + 1), device="cuda")
try:
    if what == "send_recv":
        buf = torch.empty_like(x)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - rank),
                dist.P2POp(dist.irecv, buf, 1 - rank)]):
            req.wait()
        ok = bool((buf == 2 - rank).all())
    else:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        want = torch.cat([torch.full((2, 8), 1.0), torch.full((2, 8), 2.0)])
        ok = bool((out.cpu() == want).all())
    print(json.dumps({"rank": rank, "result": "works" if ok
                      else "wrong values"}), flush=True)
except Exception as e:
    print(json.dumps({"rank": rank, "result": "raises",
                      "error": f"{type(e).__name__}: {e}"[:300]}),
          flush=True)
dist.destroy_process_group()
"""


def gloo_probe():
    """Two gloo ranks on cuda:0, each collective of this phase that
    PyTorch's backend table does not list for CUDA under gloo tried on
    CUDA tensors: what raises, crashes, hangs or works. The port stages
    both through host memory under gloo whatever this finds."""
    from dmlp_tpu_torch.parallel.distributed import free_port
    procs = {}
    for what in ("send_recv", "all_to_all_single"):
        port = free_port()
        procs[what] = [subprocess.Popen(
            [sys.executable, "-c", GLOO_PROBE, str(r), str(port), what],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
    out = {}
    for what, ps in procs.items():
        rows = []
        for p in ps:
            try:
                so, se = p.communicate(timeout=90)
                hung = False
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
                hung = True
            lines = [ln for ln in so.splitlines() if ln.startswith("{")]
            rows.append({"rc": p.returncode, "hung": hung,
                         **(json.loads(lines[-1]) if lines else
                            {"result": "crashed" if p.returncode
                             else "no output"}),
                         "stderr_tail": se.strip().splitlines()[-1:]})
        out[what] = rows
    return out


# The train phases' multi-rank runs, one spawn of gloo ranks for a phase
# (each rank runs this script with torchrun's environment): cfg["rows"]
# through the loop CLI's main (which joins the group this script made);
# with cfg["pp_dims"], each pipeline and MoE family at a small width on
# the card and on the CPU, and the dry run; with cfg["sweep"], the
# weak-scaling sweep.
PAR_SCRIPT = r"""
import contextlib, io, json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from dmlp_tpu_torch import kernels
from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
from dmlp_tpu_torch.train import dryrun, experts as ex, loop
from dmlp_tpu_torch.train import pipeline as pl, sweep
from dmlp_tpu_torch.train import step as S
from dmlp_tpu_torch.train.data import teacher_batches
from dmlp_tpu_torch.train.sharding import batch_slice

work, device = sys.argv[1], sys.argv[2]
cfg = json.load(open(work + "/cfg.json"))
initialize(auto=True, device=device, backend="gloo", timeout_s=120)
rank = dist.get_rank()
out = {"rows": {}}
for label, argv in cfg["rows"]:
    dist.barrier()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = loop.main(argv)
    dist.barrier()
    out["rows"][label] = {"rc": rc, "wall_s": time.perf_counter() - t0}
opt = S.make_optimizer("sgd", 1e-2)
pp_dims, ep_dims, batch = cfg.get("pp_dims"), cfg.get("ep_dims"), \
    cfg.get("batch")
for fam in ("gpipe", "interleaved", "pp3", "dense", "a2a") if pp_dims \
        else ():
    ep = fam in ("dense", "a2a")
    dims = ep_dims if ep else pp_dims
    it = teacher_batches(dims[0], dims[-1], batch, seed=1)
    batches = [next(it) for _ in range(3)]
    out[fam] = {}
    for dev in ("cuda", "cpu") if device == "cuda" else ("cpu",):
        if fam == "pp3":
            mesh = pl.make_pp3_mesh(2, 2, 2, dev)
            st = pl.build_pp3_state(mesh, opt, *dims, 2, device=dev)
            fn = pl.make_pp3_train_step(mesh, opt, n_micro=4,
                                        n_classes=dims[-1])
        elif ep:
            mesh = ex.make_ep_mesh(2, 4, dev)
            st = ex.build_moe_state(mesh, opt, *dims, 8, device=dev)
            fn = (ex.make_moe_a2a_train_step(
                mesh, opt, n_experts=8, n_classes=dims[-1],
                capacity=ex.a2a_capacity(batch, 2, 4, 1.25))
                if fam == "a2a" else
                ex.make_moe_train_step(mesh, opt, n_experts=8,
                                       n_classes=dims[-1]))
        else:
            mesh = pl.make_pp_mesh(2, 4, dev)
            if fam == "gpipe":
                st = pl.build_pp_state(mesh, opt, *dims, 2, device=dev)
                fn = pl.make_pp_train_step(mesh, opt, n_micro=4,
                                           n_classes=dims[-1])
            else:
                st = pl.build_ppi_state(mesh, opt, *dims, 2, 1, device=dev)
                fn = pl.make_ppi_train_step(mesh, opt, n_micro=4,
                                            n_virtual=2, n_classes=dims[-1])
        cut = ex.a2a_batch_slice if fam == "a2a" else batch_slice
        losses = []
        kernels.reset_launch_counts()
        for x, y in batches:
            xs, ys = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in cut(x, y, mesh))
            st, m = fn(st, xs, ys)
            losses.append(fn.global_metrics(m)["loss"])
        out[fam][dev] = {"losses": losses,
                         "param_device": str(st["params"].in_w.device),
                         "launches": dict(kernels.LAUNCHES)}
        dist.barrier()
if pp_dims:
    kernels.reset_launch_counts()
    out["dryrun"] = dryrun.dryrun_train(device=device)
    out["dryrun_launches"] = dict(kernels.LAUNCHES)
if cfg.get("sweep"):
    dist.barrier()
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        out["sweep"] = {"rc": sweep.main(cfg["sweep"]),
                        "wall_s": time.perf_counter() - t0,
                        "launches": dict(kernels.LAUNCHES)}
with open(f"{work}/card_cpu{rank}.json", "w") as f:
    json.dump(out, f)
shutdown()
"""


def spawn_par_script(label, work, world, device):
    """Run PAR_SCRIPT on ``world`` gloo ranks (``work``/cfg.json says
    what) and return each rank's JSON result."""
    from dmlp_tpu_torch.parallel.distributed import free_port
    # The ranks' CPU halves share the host's cores: one thread a rank.
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", PAR_SCRIPT, work, device],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=900)[1])
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"{label} spawn: exits {[p.returncode for p in procs]}: "
          f"{[e[-1500:] for e in errs if e]}")
    return [json.load(open(os.path.join(work, f"card_cpu{r}.json")))
            for r in range(world)]


def _par_model(label, argv, dims):
    """The reference's terms of ``obs.comms.train_step_comms`` for one
    step of ``argv``'s family: {record key: (model bytes, unpriced
    bytes)}: what the model prices and what the step also moves beside
    it (the mirrored backward it leaves out)."""
    from dmlp_tpu_torch.obs import comms
    from dmlp_tpu_torch.train import experts as ex

    a = dict(zip(argv[::2], argv[1::2]))
    shape = tuple(int(d) for d in a["--mesh"].split(","))
    batch = int(a["--batch"])
    if a["--parallelism"] == "dp_ep":
        dp, ep = shape
        if a.get("--moe-dispatch") == "a2a":
            cap = ex.a2a_capacity(batch, dp, ep,
                                  float(a["--capacity-factor"]))
            (t,) = [t for t in comms.train_step_comms(
                0, shape, moe={"ep": ep, "capacity": cap,
                               "hidden": dims[1]})
                if t.collective == "moe_all_to_all"]
            back = dp * ep * round(2 * ep * cap * dims[1] * 4 * (ep - 1)
                                   / ep)
            return {"all-to-all@ep": (t.bytes_total, back)}
        (t,) = [t for t in comms.train_step_comms(
            0, shape, moe_dense={"ep": ep, "tokens": batch // dp,
                                 "hidden": dims[1]})
            if t.collective == "psum_ep_combine"]
        return {"all-reduce@ep": (t.bytes_total, t.bytes_total)}
    n_micro = int(a["--microbatches"])
    sched = a.get("--pp-schedule", "gpipe")
    dp, pp = shape[0], shape[-1]
    pipe = {"pp": pp, "n_micro": n_micro,
            "micro_rows": batch // dp // n_micro, "hidden": dims[1],
            "schedule": sched,
            "n_virtual": int(a.get("--virtual-stages", 1))
            if sched == "interleaved" else 1,
            "n_groups": int(shape[0] * (shape[1] if len(shape) == 3
                                        else 1))}
    if len(shape) == 3:
        pipe.update(tp=shape[1], n_pairs=2)
    got = {t.collective: t.bytes_total for t in comms.train_step_comms(
        0, shape, pipeline=pipe)}
    out = {"collective-permute@pp": (got["ppermute_pipeline"], 0)}
    if len(shape) == 3:
        out["all-reduce@tp"] = (got["psum_tp_activations"], 0)
    return out


def train_parallel_phase(tmp_dir):
    """The pipeline and MoE train families on the card
    (``dmlp_tpu_torch.train.pipeline`` / ``.experts``): first the gloo
    probe (send/recv and all-to-all on CUDA tensors between two gloo ranks
    on cuda:0); then one spawn of 8 gloo ranks sharing cuda:0
    (``PAR_SCRIPT``) for the rest: each full-width row through the loop
    CLI's main (3 steps, each logged): GPipe and interleaved (V
    = 2) dp_pp at (2, 4), dp_pp3 at (2, 2, 2), dims 64, 2048, 16, batch
    512, M = 4; the dense and the a2a (cf 1.25, capacity 160) dp_ep at (2,
    4), dims 64, 512, 2048, 16, 8 experts, batch 4,096 — the losses
    finite and falling, the second and third steps' ``step_time_ms``, the
    wall time, ``schedule_ticks`` and ``bubble_fraction``, every rank's
    parameters on cuda:0 with 0 kernel launches, and the first step's
    collective record against ``obs.comms.train_step_comms``: equal for
    what the model prices, the backward it leaves out stated beside it;
    each family at a small width on the card and on the CPU from the same
    parameters and batches (losses within rtol 1e-5: a TF32 product would
    fail), and ``dryrun_train`` on the card; the weak-scaling sweep at 1,
    2, 4 and 8 ranks. No run launches a hand-written kernel (every rank's
    counts). Returns the launches per run."""
    import numpy as np

    from dmlp_tpu_torch.train import pipeline as pl

    t_phase = time.perf_counter()
    launches = {}
    probe = gloo_probe()
    emit({"phase": "train_parallel", "run": "gloo_probe", **probe})

    # Every 8-rank run in one spawn of 8 gloo ranks on cuda:0 (PAR_SCRIPT).
    work = os.path.join(tmp_dir, "card_cpu")
    os.makedirs(work, exist_ok=True)
    rows, paths = [], {}
    for label, argv in PAR_RUNS:
        dims = PAR_EP_DIMS if "dp_ep" in argv else PAR_PP_DIMS
        paths[label] = (os.path.join(work, f"{label}.json"),
                        os.path.join(work, f"{label}.jsonl"))
        rows.append([label, argv + [
            "--dims", ",".join(map(str, dims)), "--steps", "3",
            "--log-every", "1", "--device", PAR_DEVICE, *PAR_FLAGS,
            "--record", paths[label][0], "--metrics-file", paths[label][1]]])
    sweep_out = os.path.join(work, "sweep.jsonl")
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump({"pp_dims": list(PAR_SMALL_PP_DIMS),
                   "ep_dims": list(PAR_SMALL_EP_DIMS),
                   "batch": PAR_SMALL_BATCH, "rows": rows,
                   "sweep": ["--mesh-sizes", "1,2,4,8", "--device",
                             PAR_DEVICE, *PAR_FLAGS, "--out", sweep_out]},
                  f)
    t0 = time.perf_counter()
    got = spawn_par_script("train_parallel", work, 8, PAR_DEVICE)
    emit({"phase": "train_parallel", "run": "spawn",
          "wall_s": time.perf_counter() - t0})

    for label, argv in PAR_RUNS:
        ep = "dp_ep" in argv
        dims = PAR_EP_DIMS if ep else PAR_PP_DIMS
        rec, mfile = paths[label]
        check(all(g["rows"][label]["rc"] == 0 for g in got),
              f"{label}: exits {[g['rows'][label]['rc'] for g in got]}")
        lines = _jsonl(mfile)
        windows = [r for r in lines if "step" in r]
        hlo = [r for r in lines if r.get("event") == "hlo"][0]
        with open(rec) as f:
            ranks = json.load(f)["metrics"]["ranks"]
        launches[label] = {k: sum(r["kernel_launches"].get(k, 0)
                                  for r in ranks) for k in KERNELS}
        losses = [r["loss"] for r in windows]
        row = {"phase": "train_parallel", "run": label,
               "argv": rows[[r[0] for r in rows].index(label)][1][:-4],
               "dims": list(dims),
               "wall_s": got[0]["rows"][label]["wall_s"],
               "losses": losses,
               "step_time_ms": [r["step_time_ms"] for r in windows[1:]],
               "samples_per_sec_per_chip": [
                   r["samples_per_sec_per_chip"] for r in windows[1:]],
               "ranks": [{k: r[k] for k in ("rank", "device",
                                            "local_param_bytes")}
                         for r in ranks],
               "rank_kernel_launches": sum(sum(r["kernel_launches"].values())
                                           for r in ranks),
               "by_axis": hlo["by_axis"]}
        if not ep:
            a = dict(zip(argv[::2], argv[1::2]))
            sched = a.get("--pp-schedule", "gpipe")
            v = int(a.get("--virtual-stages", 1)) \
                if sched == "interleaved" else 1
            pp = int(a["--mesh"].split(",")[-1])
            row["schedule_ticks"] = pl.schedule_ticks(sched, 4, pp, v)
            row["bubble_fraction"] = pl.bubble_fraction(sched, 4, pp, v)
        model = _par_model(label, argv, dims)
        row["comms"] = {k: {"record_bytes": hlo["by_axis"].get(k, 0),
                            "model_bytes": m, "unpriced_bytes": u}
                        for k, (m, u) in model.items()}
        emit(row)
        check(len(losses) == 3 and np.isfinite(losses).all()
              and losses[-1] < losses[0], f"{label}: losses {losses}")
        check(len(ranks) == 8 and all(r["device"] == "cuda:0"
                                      for r in ranks)
              and row["rank_kernel_launches"] == 0,
              f"{label}: ranks {ranks}")
        for k, (m, u) in model.items():
            check(hlo["by_axis"].get(k, 0) == m + u,
                  f"{label}: {k} recorded {hlo['by_axis'].get(k)} bytes, "
                  f"the model {m} + unpriced {u}")

    # The card against the CPU, and the dry run.
    fams = {}
    for fam in ("gpipe", "interleaved", "pp3", "dense", "a2a"):
        runs = got[0][fam]
        devs = list(runs)
        lc = runs[devs[0]]["losses"]
        lh = runs[devs[-1]]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        fams[fam] = {"losses_card": lc, "losses_cpu": lh,
                     "max_loss_rel_err": rel,
                     "param_devices": sorted({g[fam][d]["param_device"]
                                              for g in got for d in devs})}
        launched = sum(sum(g[fam][d]["launches"].values())
                       for g in got for d in devs)
        check(np.allclose(lc, lh, rtol=1e-5, atol=0) and launched == 0,
              f"card_cpu {fam}: losses {lc} against {lh}, launches "
              f"{launched}")
    dry = got[0]["dryrun"]
    check(all(g["dryrun"] == dry for g in got)
          and not any(sum(g["dryrun_launches"].values()) for g in got),
          f"dryrun: ranks disagree or launched: {[g['dryrun'] for g in got]}")
    emit({"phase": "train_parallel", "run": "card_vs_cpu_and_dryrun",
          "dims_pp": list(PAR_SMALL_PP_DIMS),
          "dims_ep": list(PAR_SMALL_EP_DIMS), "batch": PAR_SMALL_BATCH,
          "families": fams, "dryrun": dry})

    # The weak-scaling sweep on the first 1, 2, 4 and 8 ranks.
    lines = _jsonl(sweep_out)
    launches["par_sweep"] = {k: sum(g["sweep"]["launches"].get(k, 0)
                                    for g in got) for k in KERNELS}
    emit({"phase": "train_parallel", "run": "sweep",
          "wall_s": got[0]["sweep"]["wall_s"], "lines": lines})
    check(all(g["sweep"]["rc"] == 0 for g in got)
          and not any(launches["par_sweep"].values())
          and [p.get("n_chips") for p in lines[:4]] == [1, 2, 4, 8]
          and "summary" in lines[4]
          and all(p["samples_per_sec_per_chip"] > 0 for p in lines[:4]),
          f"sweep: {lines}")
    emit({"phase": "train_parallel_done",
          "wall_s": time.perf_counter() - t_phase})
    return launches


def _cache_files(directory):
    """{name: (size, mtime_ns)} of the files in ``directory`` (empty when
    it does not exist): the compile cache's state, and the package's
    default build directory's."""
    if not os.path.isdir(directory):
        return {}
    return {e.name: (e.stat().st_size, e.stat().st_mtime_ns)
            for e in os.scandir(directory) if e.is_file()}


def _bench_call(label, argv, timeout=900, env=None):
    """One bench entry point (``python -m dmlp_tpu_torch.bench...`` or
    ``.report`` / ``.perf_gate``) in a subprocess from the repository's
    root; returns (returncode, stdout, stderr, wall seconds)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    e = dict(os.environ if env is None else env, PYTHONPATH=repo)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                       text=True, cwd=repo, env=e, timeout=timeout)
    wall = time.perf_counter() - t0
    if p.returncode not in (0, 1) or "Traceback" in p.stderr:
        raise SystemExit(f"chip_smoke: FAILED: {label}: exit "
                         f"{p.returncode}: {p.stderr[-3000:]}")
    return p.returncode, p.stdout, p.stderr, wall


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _spread(reps):
    """The median and range of a list of ``Time taken`` values."""
    s = sorted(reps)
    mid = len(s) // 2
    med = s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2
    return {"median": med, "min": s[0], "max": s[-1], "reps": reps}


def bench_auto_config3_checks(base, am):
    """What the auto phase held of config 3 at (4, 2), on the bench's
    ``--auto-ab`` arms (each run with ``--warmup``; stdout already equal
    to the oracle's in full): the auto arm's per-rank K3 launches the
    plan's (``engine.auto.plan_auto``) at a shape the segmin phase held,
    the sharded and ring arms' K1 once per chunk of a rank's shard, each
    arm's repairs within MAX_REPAIR_SHARE, and each arm's ``--hlo-report``
    record reconciled (the auto engine's all-gather bytes equal to the
    all-gather model's of its plan)."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.auto import plan_auto
    from dmlp_tpu_torch.obs import comms
    c = CONFIGS["config2"]
    plan = plan_auto(EngineConfig(use_pallas=True), c["num_data"],
                     c["num_queries"], int(config_input("config2").ks.max()),
                     (4, 2))
    k3 = (plan["qloc"], plan["data_block"], c["num_attrs"])
    check(plan["select"] == "seg", f"bench_config3_auto: plan {plan}")
    check(not HELD["k3"] or k3 in HELD["k3"],
          f"bench_config3_auto: K3 at {k3}: no segmin case")
    # Per rank, for the warm-up solve and the timed one.
    want = dict({k: 0 for k in KERNELS},
                fused_dist_segmin=2 * plan["nblocks"])
    for r, rk in enumerate(am["auto_ab_launches"]["auto"]):
        got = {k: rk.get(k, 0) for k in KERNELS}
        check(got == want, f"bench_config3_auto: rank {r} launched {got}, "
                           f"want {want}")
    # The sharded and ring arms: K1 once per chunk of a rank's shard (and
    # a merge each where S > 1), as the mesh phase holds its K2 twin.
    from dmlp_tpu_torch.ops.extract import heuristic_splits
    nchunks, qloc, chunk_rows, kc, oqloc = mesh_k1_plan("config2", 4, 2)
    s = heuristic_splits(qloc, chunk_rows, kc, "cuda")
    check(oqloc is None and (not HELD["k1"] or (
        qloc, chunk_rows, c["num_attrs"], kc) in HELD["k1"]),
        f"bench_config3: K1 at {qloc} x {chunk_rows}, kc {kc}: no kernels "
        "case")
    want_k1 = {"fused_topk": 2 * nchunks, "extract_topk": 0,
               "extract_merge": 2 * nchunks if s > 1 else 0,
               "fused_dist_segmin": 0}
    for arm in ("sharded", "ring"):
        for r, rk in enumerate(am["auto_ab_launches"][arm]):
            got = {k: rk.get(k, 0) for k in KERNELS}
            check(got == want_k1, f"bench_config3_{arm}: rank {r} "
                                  f"launched {got}, want {want_k1}")
    for arm, n in am["auto_ab_repairs"].items():
        check(n <= MAX_REPAIR_SHARE * c["num_queries"],
              f"bench_config3_{arm}: {n} of {c['num_queries']} queries "
              "repaired on the host")
    for arm, merge in AUTO_HLO_MERGES:
        with open(os.path.join(base, "outputs",
                               f"hlo_auto_ab_{arm}_config3.jsonl")) as f:
            hrec = json.loads(f.read().splitlines()[-1])
        twin = None
        if arm == "auto":
            check(hrec["config"]["plan"]["qloc"] == plan["qloc"]
                  and hrec["config"]["plan"]["k"] == plan["k"],
                  f"bench_config3_auto: recorded plan "
                  f"{hrec['config']['plan']}")
            twin = sum(t.bytes_total for t in comms.engine_comms(
                "allgather", (4, 2), plan["qloc"], plan["k"]))
        hlo_check(f"bench_config3_{arm}", hrec, merge, twin)
    return plan, k3


def hold_driver_shapes(reps):
    """The bench driver's device-solve launches at its defaults, held
    against their plain versions on the same inputs as the kernels and
    segmin phases hold theirs: K1 over the whole padded dataset (10,016 x
    200,192 x 64, kc 40, at the heuristic S) and K3 over the seg fold's one
    chunk (10,240 x 200,704 x 64). Returns (K1's, K3's) records."""
    import torch
    from dmlp_tpu_torch.bench import driver
    from dmlp_tpu_torch.engine.single import round_up
    from dmlp_tpu_torch.ops import dist_segmin as ds
    from dmlp_tpu_torch.ops import extract as ex
    from dmlp_tpu_torch.ops.fused import fused_topk

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    inp = driver.make_workload(200_000, 10_000, 64, 32)
    n, a = inp.data_attrs.shape
    kc = round_up(32 + 8, 8)
    q, d, _lab, npad, qpad = driver.stage_extract_inputs(inp, dev)
    s = ex.heuristic_splits(qpad, npad, kc, "cuda")
    tol = ex.list_tolerance((q * q).sum(-1), float((d * d).sum(-1).max()),
                            a, "f32")
    ms, (od, oi, it) = time_ms(
        lambda: fused_topk(q, d, n_real=n, kc=kc, splits=s), reps)
    plain_ms, (pd, pi, pit) = time_ms(lambda: ex.extract_topk_plain(
        q, d, n_real=n, kc=kc, mxu_gate=True, splits=s), PLAIN_REPS)
    cmp = ex.compare_lists(od, oi, pd, pi, tol)
    HELD["k1"].add((qpad, npad, a, kc))
    k1 = {"phase": "kernel_case", "case": "driver_extract",
          "kernel": "fused_topk", "shape": [qpad, npad, a, kc],
          "splits": s, "ms": ms, "plain_ms": plain_ms,
          "iters_equal": bool(torch.equal(it, pit)), **cmp,
          **bound(q, d, kc, it, True, False, "f32")}
    emit(k1)
    check(cmp["ok"] and k1["iters_equal"],
          f"driver_extract: K1 disagrees with the plain version {k1}")
    del q, d, od, oi, pd, pi
    # The seg fold's chunk: the driver's own arithmetic for it.
    nq = inp.params.num_queries
    qpad, npad = round_up(nq, 1024), round_up(n, 1024)
    b = driver._fold_tile(npad, min(npad, max((9 << 30) // (qpad * 4),
                                               1024)), 1024)
    q = torch.zeros((qpad, a), device=dev)
    q[:nq] = torch.from_numpy(inp.query_attrs.astype("float32"))
    d = torch.zeros((b, a), device=dev)
    d[:min(n, b)] = torch.from_numpy(inp.data_attrs[:b].astype("float32"))
    ar = torch.arange(b, dtype=torch.int32, device=dev)
    ids = torch.where(ar < n, ar, -1)
    tol = ex.list_tolerance((q * q).sum(-1), float((d * d).sum(-1).max()),
                            a, "f32")
    ms, (dist, segmin) = time_ms(lambda: ds.fused_dist_segmin(q, d, ids),
                                 reps)
    plain_ms, (pdist, pseg) = time_ms(
        lambda: ds.fused_dist_segmin_plain(q, d, ids), PLAIN_REPS)
    err, inf_same, seg_own = 0.0, True, True
    for lo in range(0, qpad, 1024):      # row blocks: bounded temporaries
        x, y = dist[lo:lo + 1024], pdist[lo:lo + 1024]
        fin = torch.isfinite(x) & torch.isfinite(y)
        e = torch.where(fin, (x - y).abs(), 0.0).max(1).values
        err = max(err, float(e.max()))
        inf_same &= bool(torch.equal(torch.isinf(x), torch.isinf(y)))
        inf_same &= bool(torch.isinf(x[:, ids < 0]).all())
        ok_rows = bool((e <= tol[lo:lo + 1024]).all())
        seg_own &= ok_rows and bool(torch.equal(
            segmin[lo:lo + 1024], x.view(x.shape[0], -1, ds.SEG).min(-1)
            .values))
    HELD["k3"].add((qpad, b, a))
    k3 = {"phase": "kernel_case", "case": "driver_seg",
          "kernel": "fused_dist_segmin", "shape": [qpad, b, a], "ms": ms,
          "plain_ms": plain_ms, "max_abs_err": err,
          "inf_where_sentinel": inf_same,
          "within_tolerance_and_segmin_own": seg_own,
          **segmin_bound(qpad, b, a, "f32")}
    emit(k3)
    check(inf_same and seg_own,
          f"driver_seg: K3 disagrees with the plain version {k3}")
    del q, d, dist, segmin, pdist, pseg
    torch.cuda.empty_cache()
    return k1, k3


def bench_phase(tmp_dir, card, reps):
    """The bench (``python -m dmlp_tpu_torch.bench``), its driver, the
    ledger's report and the perf gate on the card, every engine a
    subprocess of the harness loading the kernel libraries from the
    compile cache the build phase filled. Returns the launches per run
    (one timed solve each, from the runs' own counters)."""
    from dmlp_tpu_torch.bench.configs import BENCH_CONFIGS
    from dmlp_tpu_torch.utils.compile_cache import ENV_VAR

    t_phase = time.perf_counter()
    base = os.path.join(tmp_dir, "bench")
    recs_dir = os.path.join(base, "records")
    os.makedirs(os.path.join(base, "inputs"), exist_ok=True)
    os.makedirs(recs_dir, exist_ok=True)
    cache = os.environ[ENV_VAR]
    cache_before = _cache_files(cache)
    # The bench's inputs are CONFIGS' own generator runs (the same
    # arguments and seed, so the same bytes): written once from the texts
    # the earlier phases generated instead of generated again.
    for cid, name in ((4, "config4"), (3, "config2")):
        b, c = BENCH_CONFIGS[cid], CONFIGS[name]
        check((b.num_data, b.num_queries, b.num_attrs, b.min_attr,
               b.max_attr, b.min_k, b.max_k, b.num_labels, b.seed) == (
            c["num_data"], c["num_queries"], c["num_attrs"], c["attr_min"],
            c["attr_max"], c["min_k"], c["max_k"], c["num_labels"],
            c["seed"]), f"bench config {cid} is not {name}")
        with open(os.path.join(base, "inputs", b.input_name), "w") as f:
            f.write(config_text(name))
    rec = {r: os.path.join(recs_dir, f"bench_r{i}.jsonl")
           for i, r in enumerate(("config4_ab", "config4", "config3_auto",
                                  "serve"), 1)}
    bench = ["dmlp_tpu_torch.bench", "--base-dir", base]
    launches, runs = {}, {}

    def row(d):
        return {k: int(d.get(k, 0)) for k in KERNELS}

    def done(run):
        emit({"phase": "bench_run", "run": run, **runs[run]})

    # 1. Config 4, 3 reps, counters, and the K1 / K2 A/B.
    rc, out, err, wall = _bench_call("bench 4 --fused-ab", bench + [
        "4", "--reps", "3", "--counters", "--fused-ab", "--record",
        rec["config4_ab"]])
    check(rc == 0 and "Config 4: checksums PASS" in out,
          f"bench 4 --fused-ab: {out[-2000:]}")
    (r1,) = _records(rec["config4_ab"])
    m = r1["metrics"]
    check(m.get("fused_ab_identical") is True
          and m.get("fused_ab_impls") == {"fused": ["fused"],
                                          "two_pass": ["extract"]},
          f"bench 4: fused A/B {m.get('fused_ab_unavailable')}")
    k1, k2 = m["fused_ab_launches"]["fused"], \
        m["fused_ab_launches"]["two_pass"]
    check(k1.get("fused_topk") == 4 and not k1.get("extract_topk"),
          f"bench 4: the fused arm's solve launched {k1}")
    check(k2.get("extract_topk") == 4 and not k2.get("fused_topk"),
          f"bench 4: the DMLP_TPU_FUSED=0 arm's solve launched {k2}")
    check(m.get("counters_dispatches") == sum(k1.values()),
          f"bench 4: --counters read {m.get('counters_dispatches')} "
          f"launches, the fused arm's solve {k1}")
    launches["bench_config4_K1"] = row(k1)
    launches["bench_config4_K2"] = row(k2)
    runs["config4_ab"] = {
        "time_taken_ms": _spread(m["engine_ms_reps"]),
        "fused": _spread(m["engine_ms_fused_reps"]),
        "two_pass": _spread(m["engine_ms_two_pass_reps"]),
        "fused_ab_pct": m.get("fused_ab_pct"),
        "k1_launches_per_solve": k1, "k2_launches_per_solve": k2,
        "counters_dispatches": m["counters_dispatches"],
        "oracle_ms": m["oracle_ms"], "wall_s": wall}
    done("config4_ab")
    # 2. Config 4 again, 3 reps: the gate's second round.
    rc, out, err, wall = _bench_call("bench 4", bench + [
        "4", "--reps", "3", "--record", rec["config4"]])
    check(rc == 0 and "Config 4: checksums PASS" in out,
          f"bench 4: {out[-2000:]}")
    (r2,) = _records(rec["config4"])
    runs["config4"] = {"time_taken_ms": _spread(
        r2["metrics"]["engine_ms_reps"]), "wall_s": wall}
    done("config4")
    rc, gate_out, err, _ = _bench_call(
        "perf_gate", ["dmlp_tpu_torch.perf_gate", "--root", recs_dir,
                      "--json"])
    # --json prints the verdict document, then the summary line.
    gate, _ = json.JSONDecoder().raw_decode(gate_out)
    cmps = [c for k in ("regressions", "improvements", "unqualified",
                        "within_noise") for c in gate[k]
            if c["series"] == "harness/config4/engine_ms"]
    check(len(cmps) == 1 and "marker" not in cmps[0]
          and (cmps[0]["prev_round"], cmps[0]["cur_round"]) == (1, 2),
          f"perf gate: harness/config4/engine_ms not qualified: {cmps}")
    verdict = ("regressed" if cmps[0]["regressed"] else "improved"
               if cmps[0]["improved"] else "within noise")
    runs["gate"] = {"rc": rc, "verdict": verdict,
                    **{k: cmps[0][k] for k in ("median_prev", "median_cur",
                                               "noise_band", "delta_pct")}}
    done("gate")
    # 3. Config 3 (config 2's input on 8 gloo ranks of cuda:0): auto,
    # sharded and ring.
    rc, out, err, wall = _bench_call("bench 3 --auto-ab", bench + [
        "3", "--auto-ab", "--record", rec["config3_auto"]])
    check(rc == 0 and "Config 3: checksums PASS" in out,
          f"bench 3: {out[-2000:]}")
    auto = [r for r in _records(rec["config3_auto"]) if r["kind"] == "auto"]
    check(len(auto) == 1 and auto[0]["metrics"].get("auto_ab_identical"),
          f"bench 3 --auto-ab: {auto and auto[0]['metrics']}")
    am = auto[0]["metrics"]
    for arm in ("auto", "sharded", "ring"):
        ranks = am["auto_ab_launches"][arm]
        check(len(ranks) == 8, f"bench 3: the {arm} arm's ranks {ranks}")
        launches[f"bench_config3_{arm}"] = row(
            {k: sum(r.get(k, 0) for r in ranks) for k in KERNELS})
    plan, k3 = bench_auto_config3_checks(base, am)
    runs["config3_auto"] = {
        **{f"{a}_ms": am[f"engine_ms_{a}"] for a in ("auto", "sharded",
                                                     "ring")},
        **{f"warmup_ms_{a}": am.get(f"warmup_ms_{a}")
           for a in ("auto", "sharded", "ring")},
        **{f"hlo_bytes_{a}": am.get(f"auto_hlo_bytes_{a}")
           for a in ("auto", "sharded", "ring")},
        "k3_per_rank_auto": [r.get("fused_dist_segmin", 0)
                             for r in am["auto_ab_launches"]["auto"]],
        "k3_shape": k3, "repairs": am["auto_ab_repairs"], "wall_s": wall}
    done("config3_auto")
    # 4. The serve bench: the recorded trace against the daemon.
    repo = os.path.dirname(os.path.abspath(__file__))
    rc, out, err, wall = _bench_call("bench serve", bench + [
        "serve", "--serve-trace", os.path.join(repo, "inputs",
                                               "serve_trace1.jsonl"),
        "--reps", "1", "--record",
        rec["serve"]])
    check(rc == 0 and "byte-identical to the golden oracle" in out,
          f"bench serve: {out[-2000:]} {err[-2000:]}")
    (sv,) = _records(rec["serve"])
    runs["serve"] = {k: sv["metrics"][k] for k in (
        "requests_per_sec_carry_on", "requests_per_sec_carry_off",
        "request_latency_p50_ms_carry_on", "request_latency_p95_ms_carry_on",
        "cold_start_compile_ms")}
    runs["serve"]["wall_s"] = wall
    done("serve")
    # 5. The driver at its defaults (200,000 x 10,000 x 64, k 32), its
    # kernels first held at its launch shapes.
    held = hold_driver_shapes(reps)
    rc, out, err, wall = _bench_call("bench.driver",
                                     ["dmlp_tpu_torch.bench.driver"])
    check(rc == 0, f"bench.driver: {err[-2000:]}")
    drv = json.loads(out.splitlines()[-1])
    ph, dl = drv["path"]["phases_ms"], drv["path"]["device_solve_launches"]
    check("device_solve_ms_extract" in ph and "device_solve_ms_seg" in ph,
          f"bench.driver: no device solve: {drv['path']}")
    check(dl["extract"]["fused_topk"] >= 1
          and dl["seg"]["fused_dist_segmin"] >= 1,
          f"bench.driver: device-solve launches {dl}")
    launches["bench_driver_extract"] = row(dl["extract"])
    launches["bench_driver_seg"] = row(dl["seg"])
    runs["driver"] = {k: drv.get(k) for k in (
        "value", "vs_baseline", "baseline_ms_est", "qd_pairs_per_sec",
        "device_solve_ms", "vs_reference_binary")}
    runs["driver"].update({k: v for k, v in ph.items()
                           if k.startswith("device_solve_ms_")},
                          launches=dl, wall_s=wall,
                          held={r["case"]: r["shape"] for r in held})
    done("driver")
    # 6. The report over the records: every record parsed, each naming
    # this card.
    rc, out, err, _ = _bench_call("report", [
        "dmlp_tpu_torch.report", "--root", recs_dir, "--min-coverage",
        "1.0", "--out", os.path.join(base, "LEDGER.json")])
    check(rc == 0, f"report --min-coverage 1.0: {err[-2000:]}")
    with open(os.path.join(base, "LEDGER.json")) as f:
        led = json.load(f)
    devices = {r.get("device") for p in rec.values() for r in _records(p)}
    check(devices == {card}, f"records name {devices}, not {card!r}")
    check(led["coverage"]["files"] == len(rec)
          and led["coverage"]["fraction"] == 1.0,
          f"report: coverage {led['coverage']}")
    # The compile cache: every subprocess loaded the build phase's
    # libraries; nothing was built again, here or in the package.
    check(_cache_files(cache) == cache_before,
          f"the compile cache changed: {cache_before} -> "
          f"{_cache_files(cache)}")
    emit({"phase": "bench", "devices": sorted(devices),
          "ledger_series": len(led["series"]),
          "compile_cache_files": sorted(cache_before),
          "wall_s": time.perf_counter() - t_phase})
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


def profile_main_path(warm: bool = True):
    """The shipped timed region (engine.run + result formatting, parsing
    excluded) of config 4 and config 2's seg solve once more under
    torch.profiler, each after a warm run unless ``warm`` is false (the
    main phase solved each in this process already): device time by
    kernel name, the device's busy time (union of its kernel and copy
    intervals), its idle share of the window, and the host's blocking
    scalar reads. The wide-k mix and the multi-pass are no longer
    profiled here: their seconds went to the check phase (their idle
    shares are in PERF.md)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import SingleChipEngine
    from dmlp_tpu_torch.io.report import format_results
    from dmlp_tpu_torch.obs.counters import busy_ms

    for label, name, select in (("config4_K1", "config4", "auto"),
                                ("config2_seg", "config2", "seg")):
        inp = config_input(name)
        engine = SingleChipEngine(EngineConfig(use_pallas=True,
                                               select=select))
        if warm:
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
        busy = busy_ms((e.time_range.start, e.time_range.end) for e in dev)
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
              "device_busy_ms": busy,
              "device_idle_share": 1 - busy / wall_ms,
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
    # The compile cache: a fresh directory that the build phase fills and
    # every later process (mesh ranks, daemons, fleet replicas, the
    # bench's engines) loads from; the package's own build directory
    # must stay as it was.
    from dmlp_tpu_torch import kernels
    from dmlp_tpu_torch.utils.compile_cache import ENV_VAR, enable_from_flag
    cache_dir = tempfile.TemporaryDirectory(prefix="dmlp-compile-cache-")
    enable_from_flag(cache_dir.name)
    default_build = _cache_files(str(kernels.BUILD_DIR))
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        got = fn(*a)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        emit({"phase": "phase_time", "name": name, "s": phase_s[name]})
        return got

    timed("build", phase_build)
    check(os.environ[ENV_VAR] == cache_dir.name and {
        kernels.library_path(n).name for n in kernels.SOURCES}
        <= set(_cache_files(cache_dir.name)),
        "the build phase did not build into the compile cache")
    summary, sweep_inputs, g_inputs = {}, None, None
    if "kernels" in phases:
        summary, sweep_inputs = timed("kernels", kernel_cases, args.reps)
    if "segmin" in phases:
        g_inputs = timed("segmin", segmin_cases, summary, args.reps)
    tmp = tempfile.TemporaryDirectory()
    tune_path = None
    if "tune" in phases:
        check(sweep_inputs is not None and g_inputs is not None,
              "the tune phase needs the kernels and segmin phases")
        tune_path = timed("tune", phase_tune, sweep_inputs, g_inputs,
                          tmp.name)
        del sweep_inputs, g_inputs
    launches = timed("main", main_path, tune_path) \
        if "main" in phases else {}
    if "check" in phases:
        launches.update(timed("check", check_phase, tmp.name))
    if "obs" in phases:
        timed("obs", obs_phase, tmp.name)
    for name, fn in (("mesh", mesh_phase), ("serve", serve_phase),
                     ("fleet", fleet_phase), ("auto", auto_phase),
                     ("train", train_phase),
                     ("train_parallel", train_parallel_phase)):
        if name in phases:
            launches.update(timed(name, fn, tmp.name))
    if "bench" in phases:
        launches.update(timed("bench", bench_phase, tmp.name,
                              torch.cuda.get_device_name(0), args.reps))
    if "real_oom" in phases:
        timed("real_oom", real_oom)
    if "profile" in phases:
        timed("profile", profile_main_path, "main" not in phases)
    check(_cache_files(str(kernels.BUILD_DIR)) == default_build,
          f"{kernels.BUILD_DIR} changed: the compile cache was bypassed")
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
                         "library_ms": s.get("library_ms"),
                         **{k: s[k] for k in ("ms_by_shape",
                                              "ms_by_mesh_shape",
                                              "library_ms_by_case")
                            if k in s}})
        print(json.dumps({"kernels": rows}), flush=True)
    tmp.cleanup()
    cache_dir.cleanup()
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start,
          "phase_s": phase_s})
    check(phases >= set(PHASES),
          "a partial run (--phases) prints no result line")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
