"""Analytic collective-traffic accounting of the mesh engines — port of
``dmlp_tpu/obs/comms.py``.

Bytes in and out per rank and per mesh axis for each collective the port's
mesh engines issue (``parallel.collectives``), computed from the same
shape parameters the solve uses, so tests can hold the engines' records
(``engine.last_comms``) against hand-computed byte counts:

- the sharded engine's all-gather merge over the "data" axis: every rank
  of a column gathers the other R - 1 ranks' (qloc, K) candidate lists;
- the ring engine's merge: R - 1 point-to-point hops of the O(K)
  accumulator, the same bytes per rank as the all-gather;
- the root's scatter of the row shards and the query shards over the
  whole group (``scatter_from_root``, the ``Scatterv`` analog), which the
  reference's single-process mesh has no counterpart for;
- row 0's gather of the merged lists over the "query" axis to rank 0
  (``gather_topk``);
- the multi-process contract run's candidate all-gather
  (``host_allgather_candidates_traffic``).

The lists travel packed as (3, Q, K) int32 — the distances' float32 bits,
labels, ids: 12 bytes a candidate, the reference's TopK triple. The plan
broadcast (a small pickled dict) is not counted.

The train extension's models are the reference's, whole (pure arithmetic
over the run's shapes): the dp gradient all-reduce (:func:`psum_traffic`,
the one the dp x tp step issues), the MoE all-to-all and the ep combine,
the tensor-parallel activation psum of the pipelined stages and the
pipeline hand-off, folded per run by :func:`train_step_comms`. As in the
reference, the dp x tp family's tensor-parallel collectives are not
modelled, and the per-group gradient payload is the parameter bytes over
the product of the non-dp axes (``obs.hlo``'s record of a tp > 1 step
carries the replicated row-parallel biases above it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

#: arrays in a TopK triple (dists, labels, ids) and their element sizes
_TOPK_ITEMSIZES = (4, 4, 4)


@dataclasses.dataclass(frozen=True)
class CollectiveTraffic:
    """Byte accounting for one collective pattern on one mesh axis.

    ``bytes_out_per_device``/``bytes_in_per_device`` are what ONE sending
    rank sends and one receiving rank receives over the axis for ONE
    launch; ``n_groups`` is how many independent groups run it (one per
    query-axis column for the merges); ``count`` is the launch
    multiplicity. ``senders`` is how many ranks of a group send (0: all
    ``axis_size``): a rooted collective (scatter, gather) has one sender
    or all but the root. ``bytes_total`` covers every group, sender and
    launch."""

    collective: str
    axis: str
    axis_size: int
    bytes_out_per_device: int
    bytes_in_per_device: int
    n_groups: int = 1
    count: int = 1
    note: str = ""
    senders: int = 0

    @property
    def bytes_total(self) -> int:
        return (self.bytes_out_per_device * (self.senders or self.axis_size)
                * self.n_groups * self.count)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["bytes_total"] = self.bytes_total
        return d


def allgather_topk_traffic(axis_size: int, q_local: int, k: int,
                           axis: str = "data", n_groups: int = 1,
                           count: int = 1) -> CollectiveTraffic:
    """The all-gather merge: each rank contributes its (q_local, k) list
    triple and receives the other axis_size - 1 ranks' triples."""
    payload = q_local * k * sum(_TOPK_ITEMSIZES)
    peer = (axis_size - 1) * payload
    return CollectiveTraffic("all_gather_merge_topk", axis, axis_size,
                             peer, peer, n_groups=n_groups, count=count,
                             note=f"payload {payload} B/rank "
                                  f"(q_local={q_local}, k={k}, 12 B/cand)")


def ring_topk_traffic(axis_size: int, q_local: int, k: int,
                      axis: str = "data", n_groups: int = 1,
                      count: int = 1) -> CollectiveTraffic:
    """The ring merge: axis_size - 1 hops of the (q_local, k) accumulator
    to the next rank. The same bytes per rank as the all-gather; the gain
    is O(k) memory, not wire bytes."""
    payload = q_local * k * sum(_TOPK_ITEMSIZES)
    hops = max(axis_size - 1, 0)
    return CollectiveTraffic("ring_allreduce_topk", axis, axis_size,
                             hops * payload, hops * payload,
                             n_groups=n_groups, count=count,
                             note=f"{hops} send/recv hops x {payload} B")


def scatter_traffic(world: int, payload: int, what: str,
                    count: int = 1) -> CollectiveTraffic:
    """The root's scatter over the whole group (``scatter_from_root``):
    rank 0 sends ``payload`` bytes to each of the other world - 1 ranks
    and keeps its own part."""
    return CollectiveTraffic(
        "scatter_from_root", "world", world, (world - 1) * payload,
        payload, count=count, senders=1,
        note=f"{what}: {payload} B to each of {world - 1} ranks")


def gather_topk_traffic(axis_size: int, q_local: int, k: int,
                        axis: str = "query",
                        count: int = 1) -> CollectiveTraffic:
    """Row 0's gather of the merged (q_local, k) lists over the query axis
    to rank 0 (``gather_topk``): every other rank of the row sends its
    triple once; rank 0 receives axis_size - 1 of them."""
    payload = q_local * k * sum(_TOPK_ITEMSIZES)
    return CollectiveTraffic(
        "gather_topk", axis, axis_size, payload,
        (axis_size - 1) * payload, count=count,
        senders=max(axis_size - 1, 0),
        note=f"{axis_size - 1} ranks x {payload} B to rank 0")


def psum_traffic(nbytes: int, axis_size: int, axis: str = "dp",
                 n_groups: int = 1, count: int = 1) -> CollectiveTraffic:
    """The gradient all-reduce as a ring: reduce-scatter + all-gather
    moves 2*(D-1)/D of the payload per rank (the ring bound)."""
    per_dev = 0 if axis_size <= 1 else round(2 * (axis_size - 1)
                                             * nbytes / axis_size)
    return CollectiveTraffic("psum_grads", axis, axis_size, per_dev,
                             per_dev, n_groups=n_groups, count=count,
                             note=f"ring all-reduce of {nbytes} B grads")


def moe_a2a_traffic(ep: int, capacity: int, hidden: int,
                    itemsize: int = 4, n_groups: int = 1,
                    count: int = 1) -> CollectiveTraffic:
    """The capacity-based MoE dispatch: three all-to-alls per step (token
    send buffer (ep, capacity, hidden), slot metadata (ep, capacity) int32,
    and the token return), each keeping 1/ep of its buffer local and
    moving (ep-1)/ep off the rank."""
    send = ep * capacity * hidden * itemsize
    meta = ep * capacity * 4
    total_buf = 2 * send + meta  # tokens out + tokens back + metadata
    frac = 0.0 if ep <= 0 else (ep - 1) / ep
    per_dev = round(total_buf * frac)
    return CollectiveTraffic("moe_all_to_all", "ep", ep, per_dev, per_dev,
                             n_groups=n_groups, count=count,
                             note=f"3 a2a/step: 2x{send} B tokens "
                                  f"+ {meta} B meta, (ep-1)/ep off-device")


def tp_psum_activation_traffic(tp: int, rows: int, hidden: int,
                               n_pairs: int = 1, ticks: int = 1,
                               itemsize: int = 4, n_groups: int = 1,
                               count: int = 1) -> CollectiveTraffic:
    """The pipelined stages' tensor-parallel activation psum: each col/row
    layer pair ends in one all-reduce of the (rows, hidden) f32 block over
    tp (the ring bound, 2*(tp-1)/tp of the block); ``n_pairs`` pairs per
    schedule tick, ``ticks`` ticks per step; the backward's transposed
    psums mirror the forward (fold them via ``count``)."""
    nbytes = rows * hidden * itemsize
    per = 0 if tp <= 1 else round(2 * (tp - 1) * nbytes / tp)
    per_dev = per * n_pairs * ticks
    return CollectiveTraffic("psum_tp_activations", "tp", tp, per_dev,
                             per_dev, n_groups=n_groups, count=count,
                             note=f"{ticks} ticks x {n_pairs} pairs x "
                                  f"ring all-reduce of {nbytes} B "
                                  f"activations")


def ep_psum_combine_traffic(ep: int, tokens: int, hidden: int,
                            itemsize: int = 4, n_groups: int = 1,
                            count: int = 1) -> CollectiveTraffic:
    """The dense (capacity-free) MoE combine: one all-reduce over ep of
    the (tokens, hidden) expert-output partials per step (the ring
    bound)."""
    nbytes = tokens * hidden * itemsize
    per_dev = 0 if ep <= 1 else round(2 * (ep - 1) * nbytes / ep)
    return CollectiveTraffic("psum_ep_combine", "ep", ep, per_dev,
                             per_dev, n_groups=n_groups, count=count,
                             note=f"ring all-reduce of {nbytes} B "
                                  f"expert-output partials")


def pipeline_ppermute_traffic(pp: int, n_micro: int, micro_rows: int,
                              hidden: int, schedule: str = "gpipe",
                              n_virtual: int = 1, itemsize: int = 4,
                              n_groups: int = 1, count: int = 1,
                              ) -> CollectiveTraffic:
    """The pipeline's activation hand-off: every schedule tick sends one
    (micro_rows, hidden) activation block per sending link of the pp axis.
    gpipe runs M + S - 1 ticks over an (S-1)-link chain; interleaved runs
    M - 1 + V*S ticks over the S-link ring (none for one stage). Bubble
    ticks move the block too, so ticks, not useful microbatches, is the
    multiplier; the forward count is reported (``count`` absorbs the
    mirrored backward)."""
    if schedule == "gpipe":
        ticks, links = n_micro + pp - 1, max(pp - 1, 0)
    elif schedule == "interleaved":
        ticks, links = n_micro - 1 + n_virtual * pp, pp if pp > 1 else 0
    else:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    payload = micro_rows * hidden * itemsize
    total = ticks * links * payload      # one dispatch, all links
    per_dev = 0 if pp <= 0 else round(total / pp)
    return CollectiveTraffic("ppermute_pipeline", "pp", pp, per_dev,
                             per_dev, n_groups=n_groups, count=count,
                             note=f"{schedule}: {ticks} ticks x {links} "
                                  f"links x {payload} B activation")


def host_allgather_candidates_traffic(num_ranks: int, r_shards: int,
                                      qpad: int, kcap: int,
                                      itemsizes=(8, 4, 4),
                                      count: int = 1) -> CollectiveTraffic:
    """The contract run's candidate all-gather
    (``parallel.distributed``, ``all_gather_arrays`` of each rank's
    rescored (qloc, K) cell — f64 dists, i32 labels, i32 ids): every rank
    contributes its cell once and receives the other num_ranks - 1. The
    trace span ``dist.allgather_candidates`` carries the real payload
    (``nbytes``) beside these shape args, and tools/merge_traces.py holds
    the two against each other per rank."""
    payload = r_shards * qpad * kcap * sum(itemsizes)
    return CollectiveTraffic(
        "host_allgather_candidates", "process", num_ranks, payload,
        max(num_ranks - 1, 0) * payload, count=count,
        note=f"all_gather of (R={r_shards}, Qpad={qpad}, K={kcap}) x "
             f"{sum(itemsizes)} B/cand")


def engine_comms(merge_strategy: str, mesh_shape, q_local: int,
                 k: int) -> List[CollectiveTraffic]:
    """The data-axis merge of one mesh solve: one merge per query-axis
    column over groups of r ranks, each holding a (q_local, k) list
    triple. One rank on the axis merges nothing: an empty list. The
    "gspmd" strategy (``engine.auto``, the fleet's ``merge="auto"``) is an
    explicit empty list too, as in the reference: DTensor chooses its
    collective, so no analytic model claims it; ``obs.hlo`` records what
    it issued."""
    r, c = mesh_shape
    if r <= 1 or merge_strategy == "gspmd":
        return []
    fn = ring_topk_traffic if merge_strategy == "ring" \
        else allgather_topk_traffic
    return [fn(r, q_local, k, axis="data", n_groups=c)]


def scatter_comms(mesh_shape, shard_rows: int, na: int, qlocs,
                  with_ids: bool = False) -> List[CollectiveTraffic]:
    """The root's scatters of one mesh solve: the row shards' float32
    attributes and int32 labels (and int32 ids on the merged path), and
    one query shard of (qloc, na) float32 per query segment in
    ``qlocs``. A group of one rank scatters nothing."""
    r, c = mesh_shape
    world = r * c
    if world <= 1:
        return []
    out = [scatter_traffic(world, shard_rows * na * 4, "row attributes"),
           scatter_traffic(world, shard_rows * 4, "row labels")]
    if with_ids:
        out.append(scatter_traffic(world, shard_rows * 4, "row ids"))
    out += [scatter_traffic(world, qloc * na * 4, "query shard")
            for qloc in qlocs]
    return out


def gather_comms(mesh_shape, q_local: int, k: int
                 ) -> List[CollectiveTraffic]:
    """Row 0's gather of one segment's merged lists over the query axis;
    empty with one column."""
    c = mesh_shape[1]
    if c <= 1:
        return []
    return [gather_topk_traffic(c, q_local, k)]


def summarize(traffics: List[CollectiveTraffic]) -> Dict[str, object]:
    """Fold traffic records into the RunRecord-embeddable summary: total
    bytes, per-axis totals, and the individual records."""
    per_axis: Dict[str, int] = {}
    for t in traffics:
        per_axis[t.axis] = per_axis.get(t.axis, 0) + t.bytes_total
    return {"bytes_total": sum(t.bytes_total for t in traffics),
            "bytes_by_axis": per_axis,
            "collectives": [t.to_dict() for t in traffics]}


def train_step_comms(param_bytes: int, mesh_shape, steps: int = 1,
                     moe: Optional[dict] = None,
                     pipeline: Optional[dict] = None,
                     moe_dense: Optional[dict] = None,
                     ) -> List[CollectiveTraffic]:
    """Per-run traffic of the train loop's collective paths: the gradient
    all-reduce over dp, plus the MoE all-to-all when the a2a dispatch runs
    (``moe`` = {"ep", "capacity", "hidden"}), the dense MoE's ep combine
    (``moe_dense`` = {"ep", "tokens", "hidden"}), and the pipeline's
    activation hand-off (``pipeline`` = {"pp", "n_micro", "micro_rows",
    "hidden"} [+ "schedule", "n_virtual", "tp", "n_pairs", "n_groups"]; a
    "tp" > 1 adds the dp_pp3 stages' activation psum over tp; forward and
    the mirrored backward, 2x per step).

    ``param_bytes`` is the global parameter footprint; every non-dp axis
    shards the parameters, so each dp group's payload is param_bytes over
    the product of those axes."""
    out: List[CollectiveTraffic] = []
    dp = mesh_shape[0] if mesh_shape else 1
    shard_groups = 1
    if mesh_shape and len(mesh_shape) > 1:
        for ax in mesh_shape[1:]:
            shard_groups *= ax
    if dp > 1:
        out.append(psum_traffic(param_bytes // max(shard_groups, 1), dp,
                                axis="dp", n_groups=shard_groups,
                                count=steps))
    if moe:
        out.append(moe_a2a_traffic(moe["ep"], moe["capacity"],
                                   moe["hidden"], n_groups=dp,
                                   count=steps))
    if moe_dense:
        out.append(ep_psum_combine_traffic(
            moe_dense["ep"], moe_dense["tokens"], moe_dense["hidden"],
            n_groups=dp, count=steps))
    if pipeline:
        out.append(pipeline_ppermute_traffic(
            pipeline["pp"], pipeline["n_micro"], pipeline["micro_rows"],
            pipeline["hidden"], schedule=pipeline.get("schedule", "gpipe"),
            n_virtual=pipeline.get("n_virtual", 1),
            n_groups=pipeline.get("n_groups", dp),
            count=2 * steps))  # forward + reverse-schedule backward
        tp = pipeline.get("tp", 1)
        if tp > 1:
            pp, n_micro = pipeline["pp"], pipeline["n_micro"]
            out.append(tp_psum_activation_traffic(
                tp, pipeline["micro_rows"], pipeline["hidden"],
                n_pairs=pipeline.get("n_pairs", 2),
                ticks=n_micro + pp - 1,
                n_groups=dp * pp, count=2 * steps))
    return out
