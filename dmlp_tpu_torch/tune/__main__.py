"""CLI of the measured launch-knob tuner.

Regenerate the variant cache on the current card::

    python -m dmlp_tpu_torch.tune [--n 204800 --q 10240 --a 64 --k 32]
                                  [--kc 48 ...] [--kernel both]
                                  [--precision f32] [--reps 3]
                                  [--out PATH] [--device cuda|cpu]

It builds a seeded uniform workload of that size, plans it as the engine
does (``engine.single.plan_chunks`` on the extraction kernel's granule,
``fold_plan`` for the seg fold), sweeps the requested knobs
(:mod:`dmlp_tpu_torch.tune.sweep`) and merges the winners into the cache
file (``$DMLP_TPU_TUNE_CACHE``, else ``~/.cache/dmlp_tpu_torch/
variants.json``), keeping other keys. ``--kernel``:

- ``fused`` / ``extract`` / ``both`` — S of K1 / K2 at the chunk shape (a
  fresh launch and a carried one, weighted 1 and chunks - 1) and, for a
  kc past 512, at the multi-pass's resident shape (kc 512, weighted
  passes - 1, without the floor);
- ``segmin`` — G of K3 at the seg fold's first (query block, chunk);
- ``prune_score`` — the host prune scoring's block chunk over the
  extraction chunks, every query at the largest k;
- ``all`` — every one of them.

``--smoke`` runs a tiny sweep of every knob on the CPU (the plain
versions, timed by the host's clock): it proves measure, pick, persist and
reload. ``--validate PATH`` checks a cache file and exits. The reference's
``--compile-cache`` (an XLA cache: tooling, ROADMAP A15) and ``--record``
(a RunRecord of the sweep: tooling, A15) are not ported.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dmlp_tpu_torch.tune",
                                 description=__doc__)
    ap.add_argument("--n", type=int, default=204800)
    ap.add_argument("--q", type=int, default=10240)
    ap.add_argument("--a", type=int, default=64)
    ap.add_argument("--k", type=int, action="append", default=None,
                    help="workload k (repeatable); kc derives through "
                         "resolve_kcap with float32 staging")
    ap.add_argument("--kc", type=int, action="append", default=None,
                    help="candidate-list width to tune directly "
                         "(repeatable; overrides --k)")
    ap.add_argument("--kernel", default="both",
                    choices=("fused", "extract", "both", "segmin",
                             "prune_score", "all"))
    ap.add_argument("--precision", default="f32",
                    choices=("f32", "bf16", "both"),
                    help="first-pass precision(s) of the device sweeps "
                         "(prune_score is host float64 and ignores it)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the kernels run (default: the card; no "
                         "fallback when there is none)")
    ap.add_argument("--out", default=None,
                    help="cache file (default: the lookup path)")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny sweep of every knob on the CPU")
    ap.add_argument("--validate", metavar="PATH", default=None,
                    help="check an existing cache file and exit")
    return ap


def _validate(path: str) -> int:
    from dmlp_tpu_torch.tune.cache import VariantCache
    try:
        with open(path) as f:
            doc = json.load(f)
        VariantCache.validate_doc(doc)
    except (OSError, ValueError) as e:
        print(f"tune: INVALID cache {path}: {e}", file=sys.stderr)
        return 1
    print(f"tune: cache ok — {len(doc['entries'])} entries ({path})")
    return 0


def _workload(n, nq, a, seed, device):
    """Seeded uniform [0, 100) data (n, a) and queries (nq, a)."""
    import torch
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 100.0, (n, a)).astype(np.float32)
    queries = rng.uniform(0.0, 100.0, (nq, a)).astype(np.float32)
    return (data, queries, torch.from_numpy(data).to(device),
            torch.from_numpy(queries).to(device))


def split_case_groups(data, queries, kc, *, gate, precision, chunk_target):
    """The K1/K2 launch keys of the workload, each a list of SplitCases:
    the chunk shape (fresh, and carried when there are chunks to carry
    through) and, for kc past 512, the multi-pass's resident shape."""
    import torch

    from dmlp_tpu_torch.engine.single import plan_chunks, round_up
    from dmlp_tpu_torch.ops import extract as ex
    from dmlp_tpu_torch.tune.sweep import SplitCase

    n, a = data.shape
    nq = queries.shape[0]
    dev = data.device
    qpad = round_up(nq, ex.QUERY_TILE)
    q = torch.zeros((qpad, a), device=dev)
    q[:nq] = queries
    _, nchunks, chunk_rows = plan_chunks(n, ex.BLOCK_ROWS, chunk_target)
    rows = torch.zeros((nchunks * chunk_rows, a), device=dev)
    rows[:n] = data
    kw = dict(kc=min(kc, ex.KC_MAX), precision=precision)
    c0, c1 = rows[:chunk_rows], rows[chunk_rows:2 * chunk_rows]
    groups = [[SplitCase("chunk_fresh", q, c0, None, None,
                         {**kw, "n_real": min(n, chunk_rows),
                          "id_base": 0})]]
    if nchunks > 1:
        od, oi, _ = ex.extract_topk(q, c0, mxu_gate=gate, n_real=min(
            n, chunk_rows), id_base=0, splits=1, **kw)
        groups[0].append(SplitCase(
            "chunk_carried", q, c1, od, oi,
            {**kw, "n_real": min(n - chunk_rows, chunk_rows),
             "id_base": chunk_rows}, nchunks - 1))
    if kc > ex.KC_MAX:
        n_staged = min(nchunks, -(-n // chunk_rows))
        groups.append([SplitCase(
            "resident", q, rows[:n_staged * chunk_rows], None, None,
            {**kw, "n_real": n, "id_base": 0}, -(-kc // ex.KC_MAX) - 1)])
    return groups


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.validate:
        return _validate(args.validate)

    import torch

    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import (fold_plan, plan_chunks,
                                              resolve_kcap)
    from dmlp_tpu_torch.ops import extract as ex
    from dmlp_tpu_torch.ops.summaries import build_summaries
    from dmlp_tpu_torch.tune import sweep
    from dmlp_tpu_torch.tune.cache import cache_path, device_kind

    if args.smoke:
        n, nq, a, ks, kcs, reps = 1024, 16, 8, [8], None, 1
        device, chunk_target, kernels = "cpu", 512, "all"
    else:
        n, nq, a, ks, kcs, reps = (args.n, args.q, args.a, args.k or [32],
                                   args.kc, args.reps)
        device, chunk_target, kernels = args.device, None, args.kernel
    cfg = EngineConfig(use_pallas=True, device=device)
    dev = cfg.torch_device()
    if not kcs:
        kcs = [resolve_kcap(cfg, k, "extract", 1 << 30) for k in ks]
    kcs = sorted(set(kcs))
    gates = {"fused": (True,), "extract": (False,), "both": (True, False),
             "all": (True, False)}.get(kernels, ())
    precisions = ("f32", "bf16") if args.precision == "both" \
        else (args.precision,)
    out_path = args.out or cache_path()
    data, queries, d_dev, q_dev = _workload(n, nq, a, args.seed, dev)
    print(f"tune: sweeping {kernels} at n={n} q={nq} a={a} kcs={kcs} "
          f"reps={reps} on {dev} -> {out_path}", flush=True)

    def emit(line):
        print(json.dumps(line), flush=True)

    winners = []
    for gate in gates:
        for prec in precisions:
            for kc in kcs:
                for cases in split_case_groups(
                        d_dev, q_dev, kc, gate=gate, precision=prec,
                        chunk_target=chunk_target):
                    winners.append(sweep.sweep_splits(
                        cases, gate=gate, reps=reps, emit=emit))
    if kernels in ("segmin", "all"):
        seg = EngineConfig(use_pallas=True, select="seg", device=device,
                           data_block=chunk_target)
        qsb, _, _, chunk_rows = fold_plan(seg, n, nq, "seg")
        q = torch.zeros((qsb, a), device=dev)
        q[:min(qsb, nq)] = q_dev[:qsb]
        d = torch.zeros((chunk_rows, a), device=dev)
        d[:min(n, chunk_rows)] = d_dev[:chunk_rows]
        ids = torch.arange(chunk_rows, dtype=torch.int32, device=dev)
        ids = torch.where(ids < n, ids, -1)
        for prec in precisions:
            winners.append(sweep.sweep_groups(
                "seg_fold", q, d, ids, precision=prec, reps=reps,
                emit=emit))
    if kernels in ("prune_score", "all"):
        _, nchunks, chunk_rows = plan_chunks(n, ex.BLOCK_ROWS, chunk_target)
        summ = build_summaries(data, [(c * chunk_rows,
                                       min((c + 1) * chunk_rows, n))
                                      for c in range(nchunks)])
        winners.append(sweep.sweep_prune_score(
            queries.astype(np.float64), np.full(nq, max(ks), np.int32),
            summ, reps=reps, emit=emit))
    if not winners:
        print("tune: FAIL — nothing swept", file=sys.stderr)
        return 1
    kind = device_kind(dev)
    sweep.save_winners(winners, out_path, kind)
    print(json.dumps({"device_kind": kind, "cache": out_path,
                      "winners": [{k: w[k] for k in (
                          "kernel", "qb", "b", "a", "kc", "precision",
                          "variant", "heuristic", "measured_ms",
                          "heuristic_ms", "swept")} for w in winners]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
