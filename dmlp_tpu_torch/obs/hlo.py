"""The record of the collectives a solve issued — the port's analog of
``dmlp_tpu/obs/hlo.py``.

The reference reads the collective schedule out of the compiled HLO text
of a ``jit`` program. The port compiles no whole program: its collectives
are the c10d calls the mesh engines make (``parallel.collectives``) and
the ones DTensor issues for a ``redistribute`` (``engine.auto``). So the
source here is a record of those calls, taken while they run:
:class:`CollectiveRecorder` is a ``TorchDispatchMode`` that notes every op
of the ``c10d``, ``c10d_functional`` and ``_c10d_functional`` namespaces
(``torch.distributed.tensor.debug.CommDebugMode`` works the same way but
counts without bytes), each with

- its kind, normalised onto the reference's: ``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all`` and
  ``collective-permute`` (a ``send`` of a send/recv pair; the ``recv`` half
  is not counted again); the root's ``broadcast``, ``scatter`` and
  ``gather`` under their own names;
- its operand bytes, its group's size and the mesh axis of the group
  ("data", "query", "world" — compared by group name with the mesh's own
  groups — else "unknown");
- the bytes this rank moved (the byte convention below).

:func:`recording` enters the mode on every rank around one solve, then
all-gathers the ranks' records (outside the mode) into one
:class:`HloReport` on every rank. The mode is entered only when asked for
(the CLI's ``--hlo-report``); without it no dispatch mode is active.

**Byte convention** — the reference's ``bytes_moved`` (per-device wire
bytes under the ring-algorithm bound, summed over every device, group and
launch), which ``obs.comms``' models price too, so the two reconcile
without fudge factors: a rank's all-gather moves (g - 1) x its operand,
an all-reduce 2(g - 1)/g x its buffer, a reduce-scatter or all-to-all
(g - 1)/g x its buffer, a send its operand; the root of a broadcast moves
(g - 1) x the buffer and the root of a scatter every part but its own,
the other ranks nothing; each non-root rank of a gather its operand.

:func:`reconcile_comms` holds the record against ``obs.comms``' records
per kind within :data:`COMMS_RATIO_BOUNDS` for the kinds those models
name; kinds no model names (the plan broadcasts) are reported apart under
``unmodelled`` and never fail it. The memory leg holds the ranks' largest
``max_memory_allocated`` over the recorded solve (the peak is reset as
the recording starts) against ``obs.memwatch``'s model, with the
explicit ``hlo_memory_unavailable`` marker on the CPU. A 1 x 1 mesh
issues no collective: its record says ``no_collectives``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

#: bump on any backward-incompatible HloReport field change
SCHEMA_VERSION = 1

#: the reference's collective kinds, and the root's kinds the port issues
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "collective-permute", "all-to-all")
ROOTED_KINDS = ("broadcast", "scatter", "gather")

#: obs.comms model *function* -> the collective kind its formula prices.
#: This is the reconcile table of the source annotations: every ``#
#: check: comms-model=`` annotation must name a key here (check family
#: R10), so a renamed model cannot leave a dangling annotation that
#: reconciles nothing. The reference's eight, and the root's scatter,
#: gather and (the held-shard solve's queries) broadcast, which the port
#: issues.
MODEL_COLLECTIVE_KINDS: Dict[str, str] = {
    "allgather_topk_traffic": "all-gather",
    "host_allgather_candidates_traffic": "all-gather",
    "ring_topk_traffic": "collective-permute",
    "pipeline_ppermute_traffic": "collective-permute",
    "psum_traffic": "all-reduce",
    "tp_psum_activation_traffic": "all-reduce",
    "ep_psum_combine_traffic": "all-reduce",
    "moe_a2a_traffic": "all-to-all",
    "scatter_traffic": "scatter",
    "gather_topk_traffic": "gather",
    "broadcast_traffic": "broadcast",
}

#: CollectiveTraffic.collective record name -> collective kind: the
#: models the reconcile holds the record against
TRAFFIC_COLLECTIVE_KINDS: Dict[str, str] = {
    "all_gather_merge_topk": "all-gather",
    "host_allgather_candidates": "all-gather",
    "ring_allreduce_topk": "collective-permute",
    "scatter_from_root": "scatter",
    "gather_topk": "gather",
    "broadcast_from_root": "broadcast",
    # gspmd_* records come from a record (traffic_from_report): identity
    **{f"gspmd_{k}": k for k in COLLECTIVE_KINDS + ROOTED_KINDS},
}

#: the model-vs-record tolerance, as bounds on record/model bytes (the
#: reference's): within them the record corroborates the model
COMMS_RATIO_BOUNDS: Tuple[float, float] = (0.5, 2.0)

#: peak-memory-vs-model bounds (the reference's; an order-of-magnitude
#: corroboration, not an equality check)
MEMORY_RATIO_BOUNDS: Tuple[float, float] = (0.02, 16.0)

# op name (either functional namespace or c10d) -> kind; None: not counted
_OP_KINDS: Dict[str, Optional[str]] = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
    "scatter_": "scatter", "gather_": "gather", "reduce_": "reduce",
    # the receiving half of a pair, waits and barriers move nothing new
    "recv_": None, "recv_any_source_": None, "wait_tensor": None,
    "_wrap_tensor_autograd": None, "barrier": None,
    "monitored_barrier_": None,
}
_NAMESPACES = ("c10d", "c10d_functional", "_c10d_functional")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _first_dtype(x) -> Optional[str]:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    if isinstance(x, (list, tuple)):
        for v in x:
            d = _first_dtype(v)
            if d:
                return d
    return None


def bytes_moved(kind: str, operand_bytes: int, group_size: int,
                root: Optional[bool] = None) -> int:
    """The bytes one rank moved for one op under the module's convention;
    ``root`` says whether this rank is the root of a rooted kind."""
    g = max(group_size, 1)
    if kind == "all-gather":
        return (g - 1) * operand_bytes
    if kind == "all-reduce":
        return round(2 * (g - 1) * operand_bytes / g)
    if kind in ("reduce-scatter", "all-to-all"):
        return round((g - 1) * operand_bytes / g)
    if kind == "collective-permute":
        return operand_bytes
    if kind == "broadcast":
        return (g - 1) * operand_bytes if root else 0
    if kind == "scatter":   # the root's operand: every rank's part
        return operand_bytes * (g - 1) // g if root else 0
    if kind in ("gather", "reduce"):
        return 0 if root else operand_bytes
    return operand_bytes


class CollectiveRecorder(TorchDispatchMode):
    """Notes every c10d op dispatched while the mode is on (this rank)."""

    def __init__(self, mesh=None, axes: Optional[Dict[str, Any]] = None):
        super().__init__()
        import torch.distributed as dist
        self.ops: List[Dict[str, Any]] = []
        # group name -> (axis, group)
        self._groups: Dict[str, Tuple[str, Any]] = {}
        groups = dict(axes or {})
        if mesh is not None:
            for name in mesh.mesh_dim_names or ():
                groups[name] = mesh.get_group(name)
        if dist.is_initialized():
            groups.setdefault("world", dist.group.WORLD)
        for axis, g in groups.items():
            self._groups.setdefault(g.group_name, (axis, g))

    def _group(self, args) -> Tuple[Optional[str], Optional[int],
                                    Optional[int]]:
        """(group name, size, this rank's rank in it) of the op's group:
        an unboxed ProcessGroup argument, or a group-name string."""
        import torch.distributed as dist
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = dist.ProcessGroup.unbox(a)
                except (RuntimeError, TypeError):   # a Work, not a group
                    continue
                return pg.group_name, pg.size(), pg.rank()
        for a in reversed(args):
            if isinstance(a, str):
                hit = self._groups.get(a)
                if hit is None:
                    return a, None, None
                g = hit[1]
                return a, dist.get_world_size(g), dist.get_rank(g)
        return None, None, None

    def _note(self, func, args) -> None:
        name = func._opname
        kind = _OP_KINDS.get(name, name)
        if kind is None:
            return
        gname, gsize, grank = self._group(args)
        ints = [a for a in args[1:] if isinstance(a, int)
                and not isinstance(a, bool)]
        root = None
        if name in ("allgather_", "allgather_coalesced_"):
            # (outputs [[one per rank]], inputs, group, ...)
            operand, gsize = _nbytes(args[1]), len(args[0][0])
        elif name in ("reduce_scatter_", "gather_"):
            operand = _nbytes(args[1])          # the inputs
        elif name == "scatter_":
            # The root's inputs hold every rank's part; the others' none.
            operand = _nbytes(args[0]) * (gsize or 1)
        else:
            operand = _nbytes(args[0])
        if kind in ROOTED_KINDS + ("reduce",):
            root = grank == ints[0]
        elif name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            gsize = gsize or ints[0]
        axis = self._groups.get(gname, ("unknown",))[0]
        self.ops.append({
            "kind": kind, "op": str(func), "axis": axis, "group": gname,
            "group_size": gsize or 0, "operand_bytes": operand,
            "dtype": _first_dtype(args[0]) or _first_dtype(args),
            "bytes_moved": bytes_moved(kind, operand, gsize or 1, root)})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # A mode runs before a tensor subclass: let DTensor lower the
            # op first, so the collectives it issues come back through
            # here on plain tensors (CommDebugMode does the same).
            return NotImplemented
        if func.namespace in _NAMESPACES:
            self._note(func, tuple(args) + tuple((kwargs or {}).values()))
        return func(*args, **(kwargs or {}))


_ACTIVE: Optional[CollectiveRecorder] = None


def active() -> Optional[CollectiveRecorder]:
    """The recorder of the recording in progress on this rank, else
    None."""
    return _ACTIVE


@dataclasses.dataclass
class HloReport:
    """One solve's record of its collectives, over every rank. The name is
    the reference's; the source is the recorded calls, not HLO text."""

    label: str
    fingerprint: str
    collectives: List[Dict[str, Any]]
    totals: Dict[str, Dict[str, int]]
    memory: Dict[str, Any]
    cost: Dict[str, Any]
    platform: Optional[str] = None
    schema: int = SCHEMA_VERSION

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


def collective_totals(collectives: List[Dict[str, Any]],
                      dispatch_count: int = 1) -> Dict[str, Dict[str, int]]:
    """Per-kind {ops, count, bytes_moved}; ``dispatch_count`` scales a
    record of a solve run N times."""
    out: Dict[str, Dict[str, int]] = {}
    for op in collectives:
        agg = out.setdefault(op["kind"],
                             {"ops": 0, "count": 0, "bytes_moved": 0})
        agg["ops"] += 1
        agg["count"] += op["count"] * dispatch_count
        agg["bytes_moved"] += op["bytes_moved"] * dispatch_count
    return out


def normalise(per_rank: List[List[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """The ranks' op lists as one record: ops of one signature (kind, op,
    axis, group size, operand bytes, dtype) folded into one entry with
    ``count`` (issues over all ranks), ``ranks`` (ranks that issued it),
    ``senders`` (ranks that moved bytes), ``n_groups`` (distinct groups)
    and the summed ``bytes_moved``; sorted, so the record is the same
    whatever order the ranks' calls interleaved in."""
    folded: Dict[tuple, Dict[str, Any]] = {}
    for rank, ops in enumerate(per_rank):
        for op in ops:
            key = (op["kind"], op["op"], op["axis"], op["group_size"],
                   op["operand_bytes"], op["dtype"])
            ent = folded.setdefault(key, {
                "kind": op["kind"], "op": op["op"], "axis": op["axis"],
                "group_size": op["group_size"],
                "operand_bytes": op["operand_bytes"], "dtype": op["dtype"],
                "count": 0, "bytes_moved": 0, "_ranks": set(),
                "_senders": set(), "_groups": set()})
            ent["count"] += 1
            ent["bytes_moved"] += op["bytes_moved"]
            ent["_ranks"].add(rank)
            ent["_groups"].add(op["group"])
            if op["bytes_moved"]:
                ent["_senders"].add(rank)
    out = []
    for key in sorted(folded, key=lambda k: tuple(str(x) for x in k)):
        ent = folded[key]
        ent["ranks"] = len(ent.pop("_ranks"))
        ent["senders"] = len(ent.pop("_senders"))
        ent["n_groups"] = len(ent.pop("_groups"))
        out.append(ent)
    return out


def fingerprint(collectives: List[Dict[str, Any]]) -> str:
    """sha-256 of the normalised record (16 hex chars)."""
    text = json.dumps(collectives, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def build_report(per_rank: List[List[Dict[str, Any]]],
                 peaks: List[Optional[int]], label: str = "solve",
                 platform: Optional[str] = None) -> HloReport:
    """The :class:`HloReport` of every rank's op list and allocator peak
    (None on the CPU)."""
    coll = normalise(per_rank)
    known = [p for p in peaks if p is not None]
    memory = ({"peak_bytes": max(known), "basis": "max_memory_allocated",
               "ranks": len(known)} if known else
              {"hlo_memory_unavailable":
               "no device allocator on the CPU (torch.cuda."
               "max_memory_allocated)"})
    return HloReport(label=label, fingerprint=fingerprint(coll),
                     collectives=coll, totals=collective_totals(coll),
                     memory=memory,
                     cost={"cost_unavailable":
                           "the record carries no cost; obs.counters "
                           "prices the kernels"},
                     platform=platform)


@contextlib.contextmanager
def recording(engine=None, mesh=None, device=None, label: str = "solve",
              axes: Optional[Dict[str, Any]] = None):
    """Every rank, around one solve: record this rank's collectives, then
    (outside the mode) all-gather the ranks' records into one
    :class:`HloReport`, set as ``recorder.report`` and, when an engine is
    given, as the engine's ``_last_record`` (``comms_from_hlo`` reads it).
    ``axes`` names further groups (axis name -> group) beside the mesh's
    dimensions, such as the train meshes' groups over several axes.
    """
    import torch.distributed as dist
    global _ACTIVE
    if engine is not None:
        mesh = mesh if mesh is not None else getattr(engine, "mesh", None)
        device = device if device is not None else engine.device
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        # The memory leg prices this solve: its peak, not the process's.
        torch.cuda.reset_peak_memory_stats(dev)
    rec = CollectiveRecorder(mesh, axes)
    _ACTIVE = rec
    try:
        with rec:
            yield rec
    finally:
        _ACTIVE = None
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev is not None and dev.type == "cuda" else None
    mine = {"ops": rec.ops, "peak": peak}
    if dist.is_initialized() and dist.get_world_size() > 1:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    rec.report = build_report([e["ops"] for e in every],
                              [e["peak"] for e in every], label=label,
                              platform=None if dev is None else dev.type)
    if engine is not None:
        engine._last_record = rec.report


def traffic_from_report(report: HloReport) -> List[Any]:
    """The record as ``obs.comms.CollectiveTraffic`` records named
    ``gspmd_<kind>``, one per (kind, axis), whose ``bytes_total`` is the
    record's bytes: the senders' per-rank bytes over ``senders`` ranks of
    ``n_groups`` groups (or the whole sum from one sender where the
    senders' bytes differ)."""
    from dmlp_tpu_torch.obs.comms import CollectiveTraffic
    agg: Dict[Tuple[str, str], Dict[str, int]] = {}
    for op in report.collectives:
        a = agg.setdefault((op["kind"], op["axis"]), {
            "bytes": 0, "g": 0, "groups": 1, "senders": 0, "ops": 0})
        a["bytes"] += op["bytes_moved"]
        a["g"] = max(a["g"], op["group_size"])
        a["groups"] = max(a["groups"], op["n_groups"])
        a["senders"] = max(a["senders"], op["senders"])
        a["ops"] += op["count"]
    out = []
    for (kind, axis), a in sorted(agg.items()):
        senders, groups = max(a["senders"], 1), a["groups"]
        if senders % groups:
            groups = 1
        per = a["bytes"] // senders
        if per * senders != a["bytes"]:
            per, senders, groups = a["bytes"], 1, 1
        out.append(CollectiveTraffic(
            f"gspmd_{kind}", axis, a["g"], per, per, n_groups=groups,
            senders=senders // groups,
            note=f"recorded: {a['ops']} call(s) over every rank, "
                 f"fingerprint {report.fingerprint}"))
    return out


def _record_bytes(reports) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for rep, count, _site in reports:
        for kind, agg in rep.totals.items():
            out[kind] = out.get(kind, 0) + agg["bytes_moved"] * count
    return out


def reconcile_comms(reports: List[Tuple[HloReport, int, str]],
                    traffics) -> Dict[str, Any]:
    """The record's bytes per kind against the ``obs.comms`` records', for
    the kinds those models name: both totals, their ratio and the
    :data:`COMMS_RATIO_BOUNDS` verdict, or ``model_only`` where the model
    prices a kind the solve never issued. Kinds only the record has go
    under ``unmodelled`` and do not count against ``within_bounds``."""
    rec = _record_bytes(reports)
    model: Dict[str, int] = {}
    names: Dict[str, List[str]] = {}
    for t in traffics or []:
        d = t.to_dict() if hasattr(t, "to_dict") else dict(t)
        kind = TRAFFIC_COLLECTIVE_KINDS.get(d.get("collective", ""),
                                            "unknown")
        model[kind] = model.get(kind, 0) + int(d["bytes_total"])
        names.setdefault(kind, []).append(d.get("collective", "?"))
    kinds: Dict[str, Any] = {}
    ok = True
    for kind in sorted(model):
        h, mdl = rec.get(kind, 0), model[kind]
        ent: Dict[str, Any] = {"hlo_bytes": h, "model_bytes": mdl,
                               "models": sorted(set(names[kind]))}
        if h and mdl:
            lo, hi = COMMS_RATIO_BOUNDS
            ratio = h / mdl
            ent.update(ratio=round(ratio, 6), ratio_bounds=[lo, hi],
                       within_tolerance=bool(lo <= ratio <= hi))
            ok = ok and ent["within_tolerance"]
        elif mdl:
            ent["model_only"] = True
            ok = False
        kinds[kind] = ent
    out: Dict[str, Any] = {"kinds": kinds, "within_bounds": ok,
                           "unmodelled": {k: v for k, v in sorted(
                               rec.items()) if k not in model}}
    if not kinds and not any(rec.values()):
        out["no_collectives"] = True
    return out


def reconcile_memory(reports: List[Tuple[HloReport, int, str]],
                     mem_block: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The ranks' largest ``max_memory_allocated`` against the memwatch
    model (``mem_block["model_bytes"]``, per device), within
    :data:`MEMORY_RATIO_BOUNDS`; either side missing gives its marker."""
    peaks = [rep.memory["peak_bytes"] for rep, _c, _s in reports
             if "peak_bytes" in rep.memory]
    if not peaks:
        why = next((rep.memory["hlo_memory_unavailable"]
                    for rep, _c, _s in reports
                    if "hlo_memory_unavailable" in rep.memory),
                   "no record reported memory")
        return {"hlo_memory_unavailable": why}
    out: Dict[str, Any] = {"hlo_peak_bytes": max(peaks)}
    if not mem_block or "model_bytes" not in mem_block:
        out["mem_model_unavailable"] = \
            "no memwatch mem block to reconcile against"
        return out
    model = int(mem_block["model_bytes"])
    lo, hi = MEMORY_RATIO_BOUNDS
    ratio = out["hlo_peak_bytes"] / max(model, 1)
    out.update(model_bytes_per_device=model, ratio=round(ratio, 3),
               ratio_bounds=[lo, hi],
               within_tolerance=bool(lo <= ratio <= hi))
    return out


def build_report_doc(reports: List[Tuple[HloReport, int, str]],
                     traffics=None,
                     mem_block: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """One run's document (what ``--hlo-report`` writes): every record
    with its multiplicity, per-kind totals, bytes by axis and by kind and
    axis, and the comms and memory reconciles."""
    totals: Dict[str, Dict[str, int]] = {}
    by_axis: Dict[str, int] = {}
    by_kind_axis: Dict[str, Dict[str, int]] = {}
    for rep, count, _site in reports:
        for kind, agg in rep.totals.items():
            t = totals.setdefault(kind, {"ops": 0, "count": 0,
                                         "bytes_moved": 0})
            t["ops"] += agg["ops"]
            t["count"] += agg["count"] * count
            t["bytes_moved"] += agg["bytes_moved"] * count
        for op in rep.collectives:
            b = op["bytes_moved"] * count
            by_axis[op["axis"]] = by_axis.get(op["axis"], 0) + b
            ka = by_kind_axis.setdefault(op["kind"], {})
            ka[op["axis"]] = ka.get(op["axis"], 0) + b
    doc: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "executables": [dict(rep.to_dict(), dispatch_count=count,
                             site=site) for rep, count, site in reports],
        "collective_totals": totals,
        "collective_bytes_total": sum(t["bytes_moved"]
                                      for t in totals.values()),
        "bytes_by_axis": by_axis,
        "bytes_by_kind_axis": by_kind_axis,
        "reconcile": {"comms_model": reconcile_comms(reports, traffics),
                      "memory": reconcile_memory(reports, mem_block)},
    }
    if not reports:
        doc["hlo_unavailable"] = "no solve was recorded"
    return doc


def flat_metrics(doc: Dict[str, Any]) -> Dict[str, Any]:
    """The ledger-facing scalars of a report doc: collective bytes and
    counts per kind, and the peak memory against the model."""
    out: Dict[str, Any] = {
        "collective_bytes_total": doc.get("collective_bytes_total", 0),
        "executables_introspected": len(doc.get("executables", ())),
    }
    for kind, agg in (doc.get("collective_totals") or {}).items():
        key = kind.replace("-", "_")
        out[f"{key}_bytes"] = agg["bytes_moved"]
        out[f"{key}_count"] = agg["count"]
    mem = (doc.get("reconcile") or {}).get("memory") or {}
    if "hlo_peak_bytes" in mem:
        out["hlo_peak_bytes"] = mem["hlo_peak_bytes"]
    if "ratio" in mem:
        out["mem_ratio_vs_model"] = mem["ratio"]
    return out


__all__ = [
    "SCHEMA_VERSION", "COLLECTIVE_KINDS", "ROOTED_KINDS",
    "MODEL_COLLECTIVE_KINDS", "TRAFFIC_COLLECTIVE_KINDS",
    "COMMS_RATIO_BOUNDS", "MEMORY_RATIO_BOUNDS",
    "bytes_moved", "CollectiveRecorder", "active", "HloReport",
    "collective_totals", "normalise", "fingerprint", "build_report",
    "recording", "traffic_from_report", "reconcile_comms",
    "reconcile_memory", "build_report_doc", "flat_metrics",
]
