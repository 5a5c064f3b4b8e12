"""Batch solves: the whole query set solved again and again.

Set-up draws the corpus and the queries from the seed on the device,
hands them to the program as its ``KNNInput`` (float64 host arrays),
builds the one-device engine and solves once, which loads the kernels and
warms every shape the window uses. The window then runs whole solves
through the traffic's ``entry`` back to back until ``--seconds`` have
passed; it ends with the last of them, so every query counted was
answered inside it. With ``--trace 1`` a profiled stretch of a few more
solves follows the window.

What the window produced is judged after it, against the float64
reference: a reservoir, drawn from the seed, of ``check_solves`` of the
window's solves, every answer of each (``judge.batch_answer_err``).
"""

from __future__ import annotations

import numpy as np

from benchmark import datagen, judge
from benchmark.cost import work
from benchmark.drivers.common import (Outcome, Run, free_device,
                                      memory_peak, now, reset_peak)
from benchmark.profiling import Stretch
from benchmark.reference import knn as ref


def make_input(r: Run):
    """The program's ``KNNInput`` of the cell, drawn from the seed."""
    from dmlp_tpu_torch.io.grammar import KNNInput, Params

    cfg = r.cell.config
    n, a, q = (int(cfg["num_data"]), int(cfg["num_attrs"]),
               int(cfg["num_queries"]))
    k = int(cfg["k"])
    attrs, labels = datagen.corpus(cfg, r.seed, r.device)
    queries = datagen.batch_queries(cfg, r.seed, r.device)
    return KNNInput(Params(n, q, a), labels.cpu().numpy(),
                    attrs.cpu().numpy().astype(np.float64),
                    np.full(q, k, np.int32),
                    queries.cpu().numpy().astype(np.float64))


def _reference(r: Run, inp, k: int):
    import torch
    dev = r.device
    data64 = torch.from_numpy(inp.data_attrs).to(dev)
    q64 = torch.from_numpy(inp.query_attrs).to(dev)
    lab = torch.from_numpy(inp.labels).to(dev)
    ref_d, _ = ref.knn(q64, data64, k)
    return data64, q64, lab, ref_d


def run(r: Run) -> Outcome:
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import SingleChipEngine

    cfg, tr = r.cell.config, r.cell.traffic
    n, a, q = (int(cfg["num_data"]), int(cfg["num_attrs"]),
               int(cfg["num_queries"]))
    k = int(cfg["k"])
    inp = make_input(r)
    reset_peak(r.device)

    engine = SingleChipEngine(EngineConfig(device=r.device.type,
                                           **tr["engine_config"]))
    solve = getattr(engine, tr["entry"])
    for _ in range(int(tr["warm_solves"])):
        solve(inp)
    setup_s = now() - r.t0
    r.log(f"set-up {setup_s:.3f} s; window of {r.seconds} s")

    keep_n = int(tr["check_solves"])
    rng = np.random.default_rng(datagen.stream_seed(r.seed, "check"))
    kept: list = []
    phase_ms: list = []
    solves = 0
    t_start = now()
    solve_s = []
    while True:
        t = now()
        res = solve(inp)
        solve_s.append(now() - t)
        phase_ms.append(dict(engine.last_phase_ms))
        if solves < keep_n:
            kept.append(res)
        else:
            j = int(rng.integers(0, solves + 1))
            if j < keep_n:
                kept[j] = res
        solves += 1
        del res
        if now() - t_start >= r.seconds:
            break
    window_s = now() - t_start
    ss = sorted(solve_s)
    r.log(f"window {window_s:.3f} s, {solves} solves, a solve min "
          f"{ss[0]:.4f} median {ss[len(ss) // 2]:.4f} max {ss[-1]:.4f} s")

    obs = {"setup_s": setup_s, "window_s": window_s, "solves": solves,
           "queries_done": solves * q, "phase_ms": phase_ms,
           "work": {"dense_flops": work.dense_flops(q, n, a),
                    "min_bytes": work.min_bytes(q, n, a, k)}}
    if r.trace:
        stretch = Stretch(r.device)
        m = int(tr["trace_solves"])
        stretch.start()
        for _ in range(m):
            solve(inp)
        stretch.stop()
        obs["trace"] = dict(stretch.summary(), solves=m)
    peak = memory_peak(r.device)
    del engine, solve
    free_device(r.device)

    t_ref = now()
    data64, q64, lab, ref_d = _reference(r, inp, k)
    numbers = [judge.batch_answer_err(res, q64, data64, lab, k,
                                      int(cfg["num_labels"]), ref_d)
               for res in kept]
    worst = max(numbers, key=lambda x: x["answer_err"])
    r.log(f"reference and judge {now() - t_ref:.3f} s over "
          f"{len(kept)} solves: " + ", ".join(
              f"{key} {val}" for key, val in worst.items()))
    limit = float(tr["limits"]["answer_err"])
    checks = {"answer_err": (worst["answer_err"], limit)}
    return Outcome(obs=obs, attempted=solves * q, failed=0, checks=checks,
                   memory_peak_bytes=peak,
                   correct=bool(kept) and worst["answer_err"] <= limit)


def control(r: Run, program_bf16: bool = False) -> dict:
    """The control of a batch cell on one seed: the reference with its
    product in TF32 (the precision just below the float32, TF32-off
    arithmetic the configuration states) put in the program's place,
    judged as a window's solve is. With ``program_bf16`` also the
    program's own lower-precision path, bfloat16 staging, judged alike."""
    cfg, tr = r.cell.config, r.cell.traffic
    k = int(cfg["k"])
    inp = make_input(r)
    out = {}
    if program_bf16:
        from dmlp_tpu_torch.config import EngineConfig
        from dmlp_tpu_torch.engine.single import SingleChipEngine
        engine = SingleChipEngine(EngineConfig(
            device=r.device.type, dtype="bfloat16", **tr["engine_config"]))
        res = getattr(engine, tr["entry"])(inp)
        del engine
        free_device(r.device)
    data64, q64, lab, ref_d = _reference(r, inp, k)
    ctl_d, ctl_i = ref.knn(q64, data64, k, precision="tf32")
    pred = ref.vote(lab, ctl_i, int(cfg["num_labels"]))
    out["tf32"] = judge.batch_answer_err(
        judge.answers(ctl_i.cpu().numpy(), ctl_d.cpu().numpy(),
                      pred.cpu().numpy()),
        q64, data64, lab, k, int(cfg["num_labels"]), ref_d)
    if program_bf16:
        out["program_bf16"] = judge.batch_answer_err(
            res, q64, data64, lab, k, int(cfg["num_labels"]), ref_d)
    return out
