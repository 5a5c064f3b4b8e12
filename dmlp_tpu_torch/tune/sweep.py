"""Measured sweeps of the port's launch knobs.

Port of ``dmlp_tpu/tune/sweep.py``. The reference sweeps the Pallas tile
space; the port's kernels have fixed tiles, and what a launch chooses is:

- S, the data-axis split of K1/K2 (:func:`sweep_splits`): every legal S
  at each case of one launch key (a fresh launch, a carried one, a
  resident pass with its floor), each case weighted by how often the
  engine launches it, so the winner is the S of the least time over the
  chain the engine runs;
- G, the segments one K3 CTA walks (:func:`sweep_groups`): the kernel
  alone, operands prepared once and launches back to back;
- the host prune scoring's block chunk (:func:`sweep_prune_score`).

Every variant's output is held bit for bit against the heuristic's —
K1/K2's lists sorted by (distance, id), K3's ``dist`` and ``segmin``,
the scoring's survivor mask — and a variant that changes a result is
never the winner. A winner records its time (``measured_ms``), the
heuristic's (``heuristic_ms``) and how many variants were swept;
:func:`save_winners` merges them into the cache file.

On CUDA tensors the times are CUDA-event medians. On CPU tensors the same
code times the plain versions with the host's clock: meaningless as a
speed, but it runs measure, pick, persist and reload.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dmlp_tpu_torch.ops import dist_segmin as ds
from dmlp_tpu_torch.ops import extract as ex
from dmlp_tpu_torch.ops.summaries import (_SCORE_BLOCK_CHUNK, BlockSummaries,
                                          prune_mask)
from dmlp_tpu_torch.tune.cache import dtype_key

SWEEP_SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 15)
SWEEP_GROUPS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 33, 49, 66, 98, 131, 196)

Emit = Optional[Callable[[dict], None]]


def _run_ms(fn, device, n: int = 1):
    """(ms, last result) of ``n`` calls of ``fn()`` back to back: CUDA
    events around them on a CUDA device, the host's clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    if cuda:
        b.record()
        b.synchronize()
        return a.elapsed_time(b), out
    return (time.perf_counter() - t0) * 1e3, out


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def time_ms(fn, reps: int, device):
    """Median time of one ``fn()`` over ``reps`` calls after a warm-up,
    and the last result."""
    out = fn()
    times = []
    for _ in range(reps):
        ms, out = _run_ms(fn, device)
        times.append(ms)
    return _median(times), out


def back_to_back_ms(fn, device, n: int = 10, reps: int = 5) -> float:
    """Median time per call over ``reps`` runs of ``n`` calls of ``fn()``
    back to back, after a warm-up: the device's time when the host
    enqueues ahead of it."""
    fn()
    return _median([_run_ms(fn, device, n)[0] / n for _ in range(reps)])


def sorted_lists(od: torch.Tensor, oi: torch.Tensor):
    """(dists, ids) sorted by (distance, id) per row: two splits' lists
    compared as sets."""
    order = torch.argsort(oi, dim=1, stable=True)
    order = torch.gather(order, 1, torch.argsort(
        torch.gather(od, 1, order), dim=1, stable=True))
    return torch.gather(od, 1, order), torch.gather(oi, 1, order)


class SplitCase(NamedTuple):
    """One K1/K2 launch of a key: its inputs, its keyword arguments
    (n_real, id_base, kc, floor, precision) and how many times the engine
    launches it per solve."""

    name: str
    q: torch.Tensor
    d: torch.Tensor
    carry_d: Optional[torch.Tensor]
    carry_i: Optional[torch.Tensor]
    kw: dict
    weight: int = 1


def _pick(ms: Dict[int, float], changed: set) -> int:
    return min((v for v in ms if v not in changed), key=ms.get)


def sweep_splits(cases: Sequence[SplitCase], *, gate: bool,
                 splits: Sequence[int] = SWEEP_SPLITS, reps: int = 3,
                 emit: Emit = None) -> Dict:
    """S for one launch key (every case shares qb, b, a, kc, precision):
    each case timed at every S the launch takes (``splits`` up to
    ``ops.extract.max_splits``, and the heuristic's), its sorted lists bit
    for bit against the heuristic S's; one ``split_sweep`` line per case.
    Returns the winner record."""
    c0 = cases[0]
    qb, a = c0.q.shape
    b, kc = c0.d.shape[0], c0.kw["kc"]
    dev = c0.q.device
    heur = ex.heuristic_splits(qb, b, kc, dev)
    choices = sorted({s for s in splits if s <= ex.max_splits(b, kc)}
                     | {heur})
    kernel = "fused_topk" if gate else "extract_topk"
    total = dict.fromkeys(choices, 0.0)
    changed: set = set()
    for c in cases:
        def run(s, c=c):
            return ex.extract_topk(c.q, c.d, c.carry_d, c.carry_i,
                                   mxu_gate=gate, splits=s, **c.kw)
        ref = sorted_lists(*run(heur)[:2])
        ms, bad = {}, []
        for s in choices:
            ms[s], out = time_ms(lambda: run(s), reps, dev)
            total[s] += c.weight * ms[s]
            if not all(torch.equal(x, y) for x, y in
                       zip(sorted_lists(*out[:2]), ref)):
                bad.append(s)
        changed.update(bad)
        if emit:
            emit({"phase": "split_sweep", "kernel": kernel, "case": c.name,
                  "shape": [qb, b, a, kc], "weight": c.weight,
                  "chosen": heur, "ms_by_splits": ms, "changed": bad})
    win = _pick(total, changed)
    return {"kernel": kernel, "qb": qb, "b": b, "a": a, "kc": kc,
            "dtype": dtype_key(c0.d),
            "precision": c0.kw.get("precision", "f32"),
            "variant": {"splits": win}, "heuristic": {"splits": heur},
            "measured_ms": total[win], "heuristic_ms": total[heur],
            "swept": len(choices), "changed": sorted(changed),
            "cases": {c.name: c.weight for c in cases}}


def sweep_groups(name: str, q: torch.Tensor, d: torch.Tensor,
                 ids: torch.Tensor, *, precision: str = "f32",
                 groups: Sequence[int] = SWEEP_GROUPS, reps: int = 5,
                 emit: Emit = None) -> Dict:
    """G for one K3 launch shape: the kernel alone (operands prepared
    once, launches back to back; the plain version per group on the CPU)
    at every G of ``groups`` the shape takes and the heuristic's, ``dist``
    and ``segmin`` bit for bit against the heuristic G's; one ``g_sweep``
    line. Returns the winner record."""
    qb, a = q.shape
    b = d.shape[0]
    dev = q.device
    heur = ds.heuristic_group(qb, b, dev)
    choices = sorted({g for g in groups if g <= b // ds.SEG} | {heur})
    ms, changed = {}, []
    if dev.type == "cuda":
        ops = ds.launch_operands(q, d, ids, precision)
        ref = (torch.empty((qb, b), device=dev),
               torch.empty((qb, b // ds.SEG), device=dev))
        ds._launch(*ops, *ref, heur)
        out = tuple(torch.empty_like(t) for t in ref)
        for g in choices:
            ms[g] = back_to_back_ms(lambda: ds._launch(*ops, *out, g), dev,
                                    reps=reps)
            if not all(torch.equal(x, y) for x, y in zip(out, ref)):
                changed.append(g)
    else:
        ref = ds.fused_dist_segmin_plain(q, d, ids, precision, heur)
        for g in choices:
            ms[g], out = time_ms(lambda: ds.fused_dist_segmin_plain(
                q, d, ids, precision, g), reps, dev)
            if not all(torch.equal(x, y) for x, y in zip(out, ref)):
                changed.append(g)
    if emit:
        emit({"phase": "g_sweep", "case": name, "shape": [qb, b, a],
              "chosen": heur, "kernel_ms_by_group": ms, "changed": changed})
    win = _pick(ms, set(changed))
    return {"kernel": "fused_dist_segmin", "qb": qb, "b": b, "a": a,
            "kc": 0, "dtype": dtype_key(d), "precision": precision,
            "variant": {"group": win}, "heuristic": {"group": heur},
            "measured_ms": ms[win], "heuristic_ms": ms[heur],
            "swept": len(choices), "changed": changed, "cases": {name: 1}}


def sweep_prune_score(queries: np.ndarray, ks: np.ndarray,
                      summ: BlockSummaries, *, staging: str = "float32",
                      reps: int = 3, emit: Emit = None) -> Dict:
    """The host prune scoring's block chunk: ``prune_mask`` timed at
    chunks 1, 2, 4, ... up to the first that covers the blocks and their
    pieces in one slab, and at the default; each survivor mask bit for bit
    against the default's. One ``prune_score_sweep`` line; returns the
    winner record (qb = the query count, b = the blocks)."""
    nq, a = queries.shape
    nb = summ.n_blocks
    choices = {_SCORE_BLOCK_CHUNK}
    c = 1
    while True:
        choices.add(c)
        if c >= 2 * nb:
            break
        c *= 2
    choices = sorted(choices)
    ref, _ = prune_mask(queries, ks, summ, staging=staging,
                        block_chunk=_SCORE_BLOCK_CHUNK)
    ms, changed = {}, []
    for c in choices:
        ms[c], (mask, _) = time_ms(lambda: prune_mask(
            queries, ks, summ, staging=staging, block_chunk=c), reps, "cpu")
        if not np.array_equal(mask, ref):
            changed.append(c)
    if emit:
        emit({"phase": "prune_score_sweep", "shape": [nq, nb, a],
              "chosen": _SCORE_BLOCK_CHUNK, "ms_by_chunk": ms,
              "changed": changed})
    win = _pick(ms, set(changed))
    return {"kernel": "prune_score", "qb": nq, "b": nb, "a": a, "kc": 0,
            "dtype": "float64", "precision": "f32",
            "variant": {"tile_q": win},
            "heuristic": {"tile_q": _SCORE_BLOCK_CHUNK},
            "measured_ms": ms[win], "heuristic_ms": ms[_SCORE_BLOCK_CHUNK],
            "swept": len(choices), "changed": changed,
            "cases": {"prune_mask": 1}}


def save_winners(winners: List[Dict], path: str, device_kind: str) -> str:
    """Merge ``winners`` into the cache file at ``path`` (a file that does
    not load is rebuilt), keyed under ``device_kind``; the process then
    reads its own winners. Returns the path."""
    import os

    from dmlp_tpu_torch.tune.cache import VariantCache, clear_lookup_memo
    try:
        cache = VariantCache.load(path) if os.path.exists(path) \
            else VariantCache()
    except (OSError, ValueError):
        cache = VariantCache()
    for w in winners:
        cache.put(w["kernel"], device_kind, w["variant"], qb=w["qb"],
                  b=w["b"], a=w["a"], kc=w["kc"], dtype=w["dtype"],
                  precision=w["precision"],
                  measured_ms=round(float(w["measured_ms"]), 4),
                  heuristic_ms=round(float(w["heuristic_ms"]), 4),
                  heuristic=w["heuristic"], swept=w["swept"],
                  shape=[w["qb"], w["b"], w["a"], w["kc"]])
    cache.save(path)
    clear_lookup_memo()
    VariantCache.validate_doc(cache.to_dict())
    return path
