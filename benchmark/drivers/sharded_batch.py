"""Batch solves over a corpus held on several cards: one rank a card.

The harness's process is rank 0 on the first card. It first asks the
program for its held-shard entry (``ShardedEngine.hold_shard`` and
``io.grammar.QueryBatch``) and fails at once without it. It then starts
ranks 1 .. R - 1 on the next cards (``python -m
benchmark.drivers.sharded_batch --worker ...`` with torchrun's environment,
as ``parallel.distributed.local_cluster`` does) and joins them in one
process group (NCCL on the card, gloo on the CPU) with the mix's short
``group_timeout_s``; a thread polls the other ranks, and one that exits
non-zero ends the run at once, and each of them ends itself when rank 0
is gone.

Set-up, every rank in step: the mesh engine of the mix's
``engine_config``; the rank's own shard drawn on its card block by block
(``benchmark.shardgen``) and handed to the engine once; ``warm_solves``
solves. The window: whole solves of the configuration's
``queries_per_solve`` queries, taken in turn from the query set, back to
back until ``--seconds`` have passed; before each further solve rank 0
tells the others whether to go on. It ends with the last solve, so every
query counted was answered inside it. With ``--trace 1`` rank 0 profiles
``trace_solves`` more solves on its card.

Judged after the window, against the blocked float64 reference
(``reference/sharded.py``): a reservoir, drawn from the seed, of
``check_solves`` of the window's solves, every answer of each. The engine
and the shards are freed; every rank draws its shard's blocks again from
their seeds, takes each block's nearest rows for the kept solves' queries
and picks out the rows and labels of the ids the kept answers name. The
lists merge over the ranks, the rows gather to rank 0, and rank 0 judges
each kept solve over that compact table (``benchmark.compact``). The
other ranks also report the modules they loaded: none may be of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from benchmark import compact, guard, judge, shardgen
from benchmark.cost import work
from benchmark.drivers.common import (Outcome, Run, free_device,
                                      memory_peak, now, reset_peak)
from benchmark.profiling import Stretch
from benchmark.reference import sharded as ref_sharded
from benchmark.spec import ROOT, Cell

#: seconds between the watchdog's polls of the other ranks
POLL_S = 0.5


def probe():
    """The program's held-shard entry, or RuntimeError: a program without
    it cannot run this mix, and says so before any rank starts."""
    from dmlp_tpu_torch.engine.sharded import ShardedEngine
    from dmlp_tpu_torch.io import grammar
    if not hasattr(ShardedEngine, "hold_shard") \
            or not hasattr(grammar, "QueryBatch"):
        raise RuntimeError("the program has no held-shard entry "
                           "(ShardedEngine.hold_shard, io.grammar."
                           "QueryBatch): it cannot run a sharded batch cell")
    return ShardedEngine, grammar.QueryBatch


def _mesh(cell: Cell):
    ec = dict(cell.traffic["engine_config"])
    shape = tuple(int(v) for v in ec.pop("mesh_shape"))
    return shape, ec


def _bcast(obj, src: int = 0):
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


@contextlib.contextmanager
def _cluster(r: Run, world: int, role: str = "solve"):
    """This process as rank 0 of ``world`` ranks, the others started here
    (each to run ``role``: the cell, or its controls) and watched until
    the body ends; the group torn down after it."""
    from dmlp_tpu_torch.parallel.distributed import (free_port, initialize,
                                                     shutdown)
    timeout = float(r.cell.traffic["group_timeout_s"])
    port = free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    if r.device.type == "cpu":
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // world))
    cell = json.dumps({"name": r.cell.name, "config": r.cell.config,
                       "traffic": r.cell.traffic})
    argv = [sys.executable, "-m", "benchmark.drivers.sharded_batch",
            "--worker", role, "--cell", cell, "--seed", str(r.seed),
            "--seconds", str(r.seconds), "--trace", str(int(r.trace)),
            "--device", r.device.type]
    procs = [subprocess.Popen(argv, cwd=ROOT, stdin=subprocess.DEVNULL,
                              stdout=sys.stderr.fileno(),
                              env=dict(env, RANK=str(k), LOCAL_RANK=str(k)))
             for k in range(1, world)]
    done = threading.Event()

    def watch():
        while not done.wait(POLL_S):
            for k, p in enumerate(procs, start=1):
                rc = p.poll()
                if rc not in (None, 0):
                    r.log(f"rank {k} exited with {rc}: ending the run")
                    for q in procs:
                        if q.poll() is None:
                            q.kill()
                    os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    ok = False
    try:
        initialize(device=r.device.type, coordinator=f"localhost:{port}",
                   num_processes=world, process_id=0, timeout_s=timeout)
        yield
        ok = True
    finally:
        if ok:
            shutdown()
        done.set()
        bad = []
        for k, p in enumerate(procs, start=1):
            if not ok and p.poll() is None:
                p.kill()
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            if rc != 0:
                bad.append((k, rc))
        if ok and bad:
            raise RuntimeError(f"rank(s) exited non-zero: {bad}")


def run(r: Run) -> Outcome:
    probe()
    shape, _ = _mesh(r.cell)
    with _cluster(r, shape[0] * shape[1]):
        return _spmd(r, 0)


def _batch(qall: Optional[np.ndarray], i: int, qps: int, k: int):
    """Solve ``i``'s queries, the (i mod slices)-th run of ``qps`` rows of
    the query set; None on the ranks other than 0."""
    from dmlp_tpu_torch.io.grammar import QueryBatch
    if qall is None:
        return None
    s = i % (qall.shape[0] // qps)
    return QueryBatch(ks=np.full(qps, k, np.int32),
                      query_attrs=qall[s * qps:(s + 1) * qps])


def _spmd(r: Run, rank: int) -> Optional[Outcome]:
    """Every rank: set-up, the window, the traced stretch and the judging.
    Rank 0 returns the outcome, the others None."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.sharded import ShardedEngine

    cfg, tr = r.cell.config, r.cell.traffic
    shape, ec = _mesh(r.cell)
    root = rank == 0
    n, a, k = int(cfg["num_data"]), int(cfg["num_attrs"]), int(cfg["k"])
    qps = int(cfg["queries_per_solve"])
    block_rows = int(tr["block_rows"])
    engine = ShardedEngine(EngineConfig(device=r.device.type,
                                        mesh_shape=shape, **ec))
    rr, ranks = engine.coords[0], shape[0]
    attrs, labels = shardgen.draw_shard(cfg, r.seed, rr, ranks, block_rows,
                                        r.device)
    reset_peak(r.device)
    engine.hold_shard(attrs, labels, n)
    del attrs, labels
    qall = shardgen.queries(cfg, r.seed) if root else None
    solve = getattr(engine, tr["entry"])
    i = 0
    for _ in range(int(tr["warm_solves"])):
        solve(_batch(qall, i, qps, k))
        i += 1
    setup_s = now() - r.t0
    if root:
        r.log(f"set-up {setup_s:.3f} s; window of {r.seconds} s")

    keep_n = int(tr["check_solves"])
    rng = np.random.default_rng(shardgen.stream_seed(r.seed, "check"))
    kept: List[tuple] = []
    phase_ms: List[dict] = []
    solve_s: List[float] = []
    solves = 0
    t_start = t_end = now()
    go = True
    while go:
        t = now()
        res = solve(_batch(qall, i, qps, k))
        t_end = now()
        if root:
            solve_s.append(t_end - t)
            phase_ms.append(dict(engine.last_phase_ms))
            entry = (i % (qall.shape[0] // qps), res)
            if solves < keep_n:
                kept.append(entry)
            else:
                j = int(rng.integers(0, solves + 1))
                if j < keep_n:
                    kept[j] = entry
        i += 1
        solves += 1
        del res
        go = _bcast(t_end - t_start < r.seconds if root else None)
    window_s = t_end - t_start

    trace = None
    if r.trace:
        m = int(tr["trace_solves"])
        stretch = Stretch(r.device) if root else None
        if root:
            stretch.start()
        for _ in range(m):
            solve(_batch(qall, i, qps, k))
            i += 1
        if root:
            stretch.stop()
            trace = dict(stretch.summary(), solves=m)
    peak = memory_peak(r.device)
    shard = engine.held.shard_rows
    del engine, solve
    free_device(r.device)

    numbers = _judge(r, rank, ranks, rr, kept)
    banned = _gather([] if root else guard.banned_modules())
    if not root:
        return None
    found = [(k_, names) for k_, names in enumerate(banned) if names]
    if found:
        raise RuntimeError(f"ranks loaded modules the port must not load: "
                           f"{found}")
    ss = sorted(solve_s)
    r.log(f"window {window_s:.3f} s, {solves} solves, a solve min "
          f"{ss[0]:.4f} median {ss[len(ss) // 2]:.4f} max {ss[-1]:.4f} s")
    worst = max(numbers, key=lambda x: x["answer_err"])
    limit = float(tr["limits"]["answer_err"])
    obs: Dict[str, Any] = {
        "setup_s": setup_s, "window_s": window_s, "solves": solves,
        "queries_done": solves * qps, "phase_ms": phase_ms,
        # rank 0's share: its shard's rows against the solve's queries
        "work": {"dense_flops": work.dense_flops(qps, shard, a),
                 "min_bytes": work.min_bytes(qps, shard, a, k)}}
    if trace is not None:
        obs["trace"] = trace
    return Outcome(obs=obs, attempted=solves * qps, failed=0,
                   checks={"answer_err": (worst["answer_err"], limit)},
                   memory_peak_bytes=peak,
                   correct=bool(kept) and worst["answer_err"] <= limit)


def _gather(obj) -> Optional[list]:
    """Every rank's ``obj`` on rank 0 (rank order); None elsewhere."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def _reference(r: Run, rr: int, ranks: int, q64, ids: np.ndarray,
               k: int, precision: str = "float64"):
    """Every rank: the reference lists of ``q64`` merged over the ranks
    (None for both without queries) and this rank's (ids, rows, labels)
    of the wanted ``ids`` its shard holds, every block drawn again from
    its seed."""
    import torch
    cfg = r.cell.config
    lo_g, hi_g = shardgen.shard_span(cfg, ranks, rr)
    picked = []

    def blocks():
        for b, lo, hi in shardgen.blocks(hi_g - lo_g,
                                         int(r.cell.traffic["block_rows"])):
            a8, lab = shardgen.draw_block(cfg, r.seed, rr, b, hi - lo,
                                          r.device)
            base = lo_g + lo
            sel = ids[(ids >= base) & (ids < base + hi - lo)]
            if sel.size:
                at = torch.from_numpy(sel - base).to(r.device)
                picked.append((sel, a8[at].cpu().numpy(),
                               lab[at].cpu().numpy()))
            yield base, a8

    if q64 is None:
        for _ in blocks():
            pass
        return None, None, picked
    d, i = ref_sharded.shard_knn(q64, blocks(), k, precision)
    d, i = ref_sharded.merge_ranks(d, i, k)
    return d, i, picked


def _table(parts, device):
    """Rank 0: the compact table from every rank's picked rows."""
    import torch
    got = [p for rank_parts in parts for p in rank_parts]
    ids = np.concatenate([g[0] for g in got]) if got else \
        np.zeros(0, np.int64)
    order = np.argsort(ids)
    rows = np.concatenate([g[1] for g in got]) if got else \
        np.zeros((0, 0), np.uint8)
    labels = np.concatenate([g[2] for g in got]) if got else \
        np.zeros(0, np.int32)
    return (ids[order], torch.from_numpy(rows[order]).double().to(device),
            torch.from_numpy(labels[order]).to(device))


def _judge(r: Run, rank: int, ranks: int, rr: int,
           kept: List[tuple]) -> Optional[List[dict]]:
    """Every rank: the reference of the kept solves' queries and the
    compact table; rank 0 returns the judge's numbers of each kept solve."""
    import torch
    cfg = r.cell.config
    n, k = int(cfg["num_data"]), int(cfg["k"])
    qps = int(cfg["queries_per_solve"])
    t0 = now()
    plan = _bcast(None if rank else {
        "slices": sorted({s for s, _ in kept}),
        "ids": compact.wanted_ids([res for _, res in kept], n, k)})
    qall = shardgen.queries(cfg, r.seed)
    q64 = torch.from_numpy(np.concatenate(
        [qall[s * qps:(s + 1) * qps] for s in plan["slices"]])).double() \
        .to(r.device)
    ref_d, _, picked = _reference(r, rr, ranks, q64, plan["ids"], k)
    parts = _gather(picked)
    if rank:
        return None
    ids, rows, labels = _table(parts, r.device)
    out = []
    for s, res in kept:
        j = plan["slices"].index(s) * qps
        out.append(compact.compact_answer_err(
            res, q64[j:j + qps], ids, rows, labels, n, k,
            int(cfg["num_labels"]), ref_d[j:j + qps]))
    worst = max(out, key=lambda x: x["answer_err"])
    r.log(f"reference and judge {now() - t0:.3f} s over {len(kept)} "
          f"solves: " + ", ".join(f"{key} {val}"
                                  for key, val in worst.items()))
    return out


def control(r: Run) -> dict:
    """The controls of the cell on one seed: the reference computed in
    TF32 products and with its distances held in bfloat16, each put in
    the program's place for the first solve's queries and judged as a
    window's solve is."""
    probe()
    shape, _ = _mesh(r.cell)
    with _cluster(r, shape[0] * shape[1], "control"):
        return _control(r, 0)


def _control(r: Run, rank: int) -> Optional[dict]:
    import torch
    cfg = r.cell.config
    shape, _ = _mesh(r.cell)
    n, k, qps = (int(cfg["num_data"]), int(cfg["k"]),
                 int(cfg["queries_per_solve"]))
    rr, ranks = rank // shape[1], shape[0]
    q64 = torch.from_numpy(shardgen.queries(cfg, r.seed)[:qps]).double() \
        .to(r.device)
    ref_d, _, _ = _reference(r, rr, ranks, q64, np.zeros(0, np.int64), k)
    out = {}
    for prec in ("tf32", "bfloat16"):
        d, i, _ = _reference(r, rr, ranks, q64, np.zeros(0, np.int64), k,
                             prec)
        ids = _bcast(None if rank else np.unique(i.cpu().numpy()))
        _, _, picked = _reference(r, rr, ranks, None, ids, k)
        parts = _gather(picked)
        if rank:
            continue
        tids, rows, labels = _table(parts, r.device)
        pred = ref_sharded.ref.vote(
            labels, torch.from_numpy(np.searchsorted(tids, i.cpu().numpy()))
            .to(r.device), int(cfg["num_labels"]))
        out[prec] = compact.compact_answer_err(
            judge.answers(i.cpu().numpy(), d.cpu().numpy(),
                          pred.cpu().numpy()),
            q64, tids, rows, labels, n, k, int(cfg["num_labels"]), ref_d)
    return out if rank == 0 else None


def worker(argv=None) -> int:
    """A rank other than 0: the same steps as rank 0, in step with it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", choices=("solve", "control"),
                    required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    parent = os.getppid()

    def orphaned():
        # rank 0 gone: nothing is left to answer this rank's collectives
        while True:
            threading.Event().wait(POLL_S)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    import torch
    from dmlp_tpu_torch.parallel.distributed import initialize, shutdown
    c = json.loads(args.cell)
    cell = Cell(name=c["name"], config_name=c["name"].split(".")[0],
                traffic_name=c["name"].split(".")[-1], chips=1,
                config=c["config"], traffic=c["traffic"])
    rank = int(os.environ["RANK"])
    device = torch.device("cuda", rank) if args.device == "cuda" \
        else torch.device("cpu")
    initialize(device=args.device, auto=True,
               timeout_s=float(cell.traffic["group_timeout_s"]))
    r = Run(cell=cell, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device=device, t0=now())
    (_control if args.worker == "control" else _spmd)(r, rank)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(worker())
