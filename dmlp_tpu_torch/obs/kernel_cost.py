"""Analytic FLOPs and bytes of the port's hand-written kernels — port of
``dmlp_tpu/obs/kernel_cost.py``.

No profiler counts the work of a CUDA kernel launched through ``ctypes``,
but each kernel's work is a closed-form function of its launch shape, so
this module models every kernel of the port and :mod:`dmlp_tpu_torch.obs.
counters` resolves each recorded launch through :func:`analytic_cost`.

Per kernel (K1 ``fused_topk``, K2 ``extract_topk``, their split merge
``extract_merge``, K3 ``fused_dist_segmin``, the serving engine's prune
score ``summaries_score`` and the plain ``torch.mm`` distance product of
the "sort"/"topk" folds, ``distance_product``):

- **flops** keep the reference's convention: ``2*Q*B*A`` for the product
  (the dot convention, whatever the precision), ``2*(Q+B)*A`` for the norm
  reductions and ``5*Q*B`` for the epilogue (expansion, clamp, masks and
  the block-skip prefilter). That deterministic term does not depend on
  tiling, so for the same ``(qb, b, a, kc)`` it equals the reference's for
  K2 and K3. K1 adds its norm gate per (tile, block) cell of its own grid,
  32 query rows by 256 data columns (the reference counts it per cell of
  its Pallas tiles, so only this term differs). The extraction loop is
  data-dependent: K1/K2 report ``iters`` (1 where a query tile processed
  a data block), and a caller that reads them back adds the MEASURED term
  of :func:`extract_loop_cost` (``extraction_term: "measured"``, else
  ``"modeled_lower_bound"``).
- **bytes_min** count each operand read once and each output written once
  (what a roofline bound counts): q, d, the carry read and the lists
  written, and ``iters`` for K1/K2; q, d, ids and the distance tile and
  segment minima for K3; the partial lists in and the lists out for the
  merge.
- **bytes_accessed** count what the CUDA kernel's sweep streams at its
  launch knob: every query tile re-reads the data (and its norms), every
  split re-reads its query tile, at S > 1 the (S, Qb, kc) partials are
  written; K3 re-reads the data per row tile and the queries per group of
  G segments.
- **bound_ops** count the products the launch's data needs: with the norm
  gate on and ``iters`` read back, only the (tile, block) cells the gate
  let through; the merge does no product.

``precision`` ("f32" | "bf16") is reported with each cost; the peak of its
type comes from :mod:`dmlp_tpu_torch.obs.counters`' table.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

__all__ = ["fused_topk_cost", "extract_topk_cost", "extract_loop_cost",
           "gate_flops", "extract_merge_cost", "fused_dist_segmin_cost",
           "summaries_score_cost", "distance_product_cost",
           "analytic_cost", "bound_ms"]


def _tiles():
    """K1/K2's compile-time tiles (32 query rows, 256 data columns) and
    K3's (128 rows, 128-column segments)."""
    from dmlp_tpu_torch.ops import dist_segmin, extract
    return (extract.QUERY_TILE, extract.BLOCK_ROWS, dist_segmin.QUERY_TILE,
            dist_segmin.SEG)


def _deterministic_flops(qb: int, b: int, a: int) -> float:
    """The reference's convention: product, norm reductions, epilogue."""
    return (2.0 * qb * b * a          # the cross-term product
            + 2.0 * (qb + b) * a      # |q|^2 / |d|^2 norm reductions
            + 4.0 * qb * b            # expansion + clamp + floor/sentinel
            + 1.0 * qb * b)           # block-skip prefilter, one pass


def extract_loop_cost(qb: int, b: int, a: int, kc: int,
                      iters_total: int) -> float:
    """MEASURED extraction FLOPs for ``iters_total`` processed (tile,
    block) cells (summed over K1/K2's ``iters`` outputs, possibly across
    many launches at one shape). The port's loop, per processed cell of
    32 rows by 256 columns: a ballot per row and block (one compare of
    every tile value against the row's threshold) and a merge by rank for
    each row that takes candidates, counted as if every row took some
    (each of the row's kc list entries counts the candidates below it and
    moves). ``a`` does not enter the loop; it is in the signature so that
    one shape key serves the deterministic and the measured term."""
    del a
    tq, tn, _, _ = _tiles()
    return float(iters_total) * (tq * tn + 2.0 * tq * kc)


def _streaming_cost(qb: int, b: int, a: int, kc: int, *, carried: bool,
                    splits: int, floor: bool) -> Dict[str, float]:
    """The shared model of one K1/K2 launch (the (qb, b) distance tile
    lives only in shared memory)."""
    tq, tn, _, _ = _tiles()
    ntile, nblk = -(-qb // tq), b // tn
    s = max(int(splits), 1)
    bytes_min = 4.0 * (qb * a + b * a) \
        + 8.0 * qb * kc * (2 if carried else 1) + 4.0 * ntile * nblk
    streamed = 4.0 * (s * qb * a         # each split reads its query tile
                      + ntile * b * a    # each query tile reads the data
                      + ntile * b        # ... and its norms
                      + s * qb           # the query norms, per split
                      + (s * qb if floor else 0)
                      + ntile * nblk) \
        + 8.0 * qb * kc * (s * (1 if carried else 0) + s)
    return {"flops": _deterministic_flops(qb, b, a),
            "bytes_min": bytes_min, "bytes_accessed": streamed,
            "ntile": ntile, "nblk": nblk}


def extract_topk_cost(qb: int, b: int, a: int, kc: int,
                      iters_total: Optional[int] = None,
                      precision: str = "f32", *, carried: bool = False,
                      splits: int = 1, floor: bool = False
                      ) -> Dict[str, float]:
    """Cost of one K2 launch (``ops.extract.extract_topk``, gate off) at
    (queries (qb, a), data (b, a), list width kc). Without
    ``iters_total`` the data-dependent loop is left out (the deterministic
    lower bound); with it the measured term is added and the dict says
    so. The products every cell needs: ``2*qb*b*a``."""
    base = _streaming_cost(qb, b, a, kc, carried=carried, splits=splits,
                           floor=floor)
    out = {"flops": base["flops"], "bytes_min": base["bytes_min"],
           "bytes_accessed": base["bytes_accessed"],
           "bound_ops": 2.0 * qb * b * a,
           "extraction_term": "modeled_lower_bound",
           "precision": precision}
    if iters_total is not None:
        out["flops"] += extract_loop_cost(qb, b, a, kc, iters_total)
        out["extraction_term"] = "measured"
        out["extract_iters_total"] = int(iters_total)
    return out


def gate_flops(qb: int, b: int) -> float:
    """K1's norm gate per (tile, block) cell of its 32 x 256 grid: about
    three block reductions over the block's norms and eight scalar
    operations per query row for the deflated (|q| - |d|)^2 bound."""
    tq, tn, _, _ = _tiles()
    return -(-qb // tq) * (b // tn) * (3.0 * tn + 8.0 * tq)


def fused_topk_cost(qb: int, b: int, a: int, kc: int,
                    iters_total: Optional[int] = None,
                    precision: str = "f32", *, carried: bool = False,
                    splits: int = 1, floor: bool = False
                    ) -> Dict[str, float]:
    """Cost of one K1 launch (``ops.fused.fused_topk``: K2 with the norm
    gate on): K2's model plus :func:`gate_flops`. With ``iters_total``
    the products the data needs are only the cells the gate let through
    (``2*a*32*256`` each); without it, every cell's."""
    tq, tn, _, _ = _tiles()
    out = extract_topk_cost(qb, b, a, kc, iters_total, precision,
                            carried=carried, splits=splits, floor=floor)
    out["gate_flops"] = gate_flops(qb, b)
    out["flops"] += out["gate_flops"]
    if iters_total is not None:
        out["bound_ops"] = 2.0 * a * tq * tn * int(iters_total)
    return out


def extract_merge_cost(qb: int, kc: int, splits: int,
                       carried: bool = False) -> Dict[str, float]:
    """Cost of one launch of the split merge (``extract_merge_kernel``),
    which has no counterpart kernel in the reference: there the merge is
    the sequential grid axis of one ``pallas_call``. Its operations are
    key comparisons, per row: the order check of each of the L = S +
    carry lists (kc - 1 each), then a truncated merge tree of
    ceil(log2(L)) rounds in which each pair of lists yields kc outputs at
    one comparison each (a list without a partner passes through). The
    merge-path searches that place each thread's run (about log2(kc) per
    run) and the sort of a list handed in out of order are left out:
    both depend on the launch or the data, not on the shape. It moves
    (S + carry + 1) * qb * kc * 8 bytes and is bound by them."""
    lists = int(splits) + (1 if carried else 0)
    comps = lists * (kc - 1)
    while lists > 1:
        comps += (lists // 2) * kc
        lists = (lists + 1) // 2
    nbytes = 8.0 * qb * kc * (int(splits) + (1 if carried else 0) + 1)
    return {"flops": float(qb * comps),
            "bytes_min": nbytes, "bytes_accessed": nbytes,
            "bound_ops": 0.0, "precision": "f32"}


def fused_dist_segmin_cost(qb: int, b: int, a: int, precision: str = "f32",
                           group: Optional[int] = None) -> Dict[str, float]:
    """Cost of one K3 launch (``ops.dist_segmin.fused_dist_segmin``): the
    distance tile is written out (unlike K1/K2) with the minimum of every
    128-column segment. ``bytes_accessed`` is the sweep at G segments per
    CTA (None: one group per row tile)."""
    _, _, tq, seg = _tiles()
    nseg = b // seg
    ntq = -(-qb // tq)
    g = nseg if group is None else max(min(int(group), nseg), 1)
    ngroups = -(-nseg // g)
    out_bytes = 4.0 * (qb * b + qb * nseg)
    return {"flops": _deterministic_flops(qb, b, a),
            "bytes_min": 4.0 * (qb * a + b * a + b) + out_bytes,
            "bytes_accessed": 4.0 * (ngroups * ntq * tq * a  # qT per group
                                     + ntq * b * a           # dT per tile
                                     + ntq * 2 * b           # dn + ids
                                     + ngroups * qb)         # qn
            + out_bytes,
            "bound_ops": 2.0 * qb * b * a, "precision": precision}


def summaries_score_cost(qb: int, nblocks: int, a: int
                         ) -> Dict[str, float]:
    """Cost of one ``ops.summaries.score_blocks`` launch (the serving
    engine's per-batch prune score over the resident block summaries, in
    torch f32): per (query, block) the norm-band bound (~6 ops), the box
    gap and farthest-corner reductions (~6*a) and the threshold
    accumulation's sort and cumsum (~log2(B) per entry), the reference's
    model. Bytes: the summaries and queries in, the (B,) mask out."""
    logb = max(math.ceil(math.log2(max(nblocks, 2))), 1)
    flops = (2.0 * qb * a
             + qb * nblocks * (6.0 * a + 6.0)
             + qb * nblocks * (logb + 4.0))
    nbytes = 4.0 * (qb * a + nblocks * (2.0 * a + 3.0)
                    + 3.0 * qb * nblocks + nblocks)
    return {"flops": flops, "bytes_min": nbytes, "bytes_accessed": nbytes,
            "bound_ops": 0.0, "precision": "f32"}


def distance_product_cost(qb: int, b: int, a: int,
                          precision: str = "f32") -> Dict[str, float]:
    """The "sort"/"topk" folds' distance tile (``ops.distance.
    masked_pairwise_sq_l2``): a plain ``torch.matmul`` with the
    norm-expansion epilogue, modeled as ``2*Q*B*A`` for the product plus
    the reference's norm and epilogue terms; the (qb, b) tile is
    written."""
    nbytes = 4.0 * (qb * a + b * a + b + qb * b)
    return {"flops": _deterministic_flops(qb, b, a), "bytes_min": nbytes,
            "bytes_accessed": nbytes, "bound_ops": 2.0 * qb * b * a,
            "precision": precision}


_MODELS = {
    "fused_topk": lambda s: fused_topk_cost(
        s["qb"], s["b"], s["a"], s["kc"], precision=s.get("precision",
                                                          "f32"),
        carried=s.get("carried", False), splits=s.get("splits", 1),
        floor=s.get("floor", False)),
    "extract_topk": lambda s: extract_topk_cost(
        s["qb"], s["b"], s["a"], s["kc"], precision=s.get("precision",
                                                          "f32"),
        carried=s.get("carried", False), splits=s.get("splits", 1),
        floor=s.get("floor", False)),
    "extract_merge": lambda s: extract_merge_cost(
        s["qb"], s["kc"], s["splits"], carried=s.get("carried", False)),
    "fused_dist_segmin": lambda s: fused_dist_segmin_cost(
        s["qb"], s["b"], s["a"], s.get("precision", "f32"),
        s.get("group")),
    "summaries_score": lambda s: summaries_score_cost(
        s["qb"], s["nblocks"], s["a"]),
    "distance_product": lambda s: distance_product_cost(
        s["qb"], s["b"], s["a"], s.get("precision", "f32")),
}


def analytic_cost(kernel, shape: dict) -> Optional[Dict[str, float]]:
    """The model of one launch of ``kernel`` (a kernel name as
    ``kernels.LAUNCHES`` counts it, ``"summaries_score"``,
    ``"distance_product"``, or the wrapper function of one of them) at
    ``shape``; None for anything without a model."""
    name = kernel if isinstance(kernel, str) else getattr(
        kernel, "__name__", "")
    model = _MODELS.get(name)
    return None if model is None else model(dict(shape))


def bound_ms(cost: Dict[str, float], peaks: Dict[str, float]) -> Dict:
    """The least time of the modeled work on a card with ``peaks``
    (:func:`dmlp_tpu_torch.obs.counters.device_peaks`): the larger of
    ``bytes_min`` over the memory rate and ``bound_ops`` over the peak of
    the operations' type, and which of the two bounds it."""
    t_bytes = cost["bytes_min"] / peaks["hbm_bytes_per_s"]
    t_ops = cost.get("bound_ops", 0.0) / peaks[cost.get("precision", "f32")]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
