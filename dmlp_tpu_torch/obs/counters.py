"""Per-launch cost counters with the card's roofline — port of
``dmlp_tpu/obs/counters.py``.

The reference resolves its dispatches through XLA's cost analysis and its
Pallas kernels through analytic models. The port has no compiler to ask:
every launch resolves through :mod:`dmlp_tpu_torch.obs.kernel_cost`. The
kernels' wrappers record each launch into an installed :class:`CostProbe`
(the kernel's name and its shape, nothing that keeps a tensor alive); on a
CUDA device a pair of CUDA events brackets the launch on its stream, so
:meth:`CostProbe.collect` gives each kernel's device time beside its
modeled FLOPs and bytes. On the CPU the plain versions record their calls
under the kernel's name, with no events. Engines that read K1/K2's
``iters`` back after the solve's fetch add the measured extraction term
(:meth:`CostProbe.record_measured_iters`).

With no probe installed, :func:`record_dispatch` returns None and a
wrapper does nothing more: no event, no synchronization, no device
allocation.

:func:`device_peaks` is the card's peak table (published data sheet
rates), keyed by ``torch.cuda.get_device_name``; on any other device the
roofline omits ``utilization_vs_peak`` rather than guess.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = ["CostProbe", "PEAKS", "device_peaks", "roofline", "install",
           "uninstall", "active", "record_dispatch",
           "record_measured_iters", "merge_collected", "busy_ms",
           "profile_block"]

#: Published peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W):
#: float32 on the CUDA cores, bf16 on the tensor cores, HBM bandwidth.
#: A card set below 700 W runs slower under load; the chip runs record
#: ``nvidia-smi``'s power limit beside every number.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"f32": 67e12, "bf16": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device=None) -> Optional[Dict[str, float]]:
    """The peak table's row for ``device`` (a CUDA device, default the
    current card), or None for the CPU and for a card the table does not
    hold."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return PEAKS.get(torch.cuda.get_device_name(device))


class _Launch:
    """One timed launch: the event pair bracketing it on its stream."""

    __slots__ = ("probe", "kernel", "start")

    def __init__(self, probe: "CostProbe", kernel: str, start):
        self.probe, self.kernel, self.start = probe, kernel, start

    def done(self) -> None:
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.probe._events.append((self.kernel, self.start, end))


class CostProbe:
    """Launch records keyed by (kernel, shape); ``collect()`` resolves
    them into summed counters, per kernel and in all."""

    def __init__(self) -> None:
        # (kernel, shape items) -> [kernel, shape, count]
        self._entries: Dict[Tuple, list] = {}
        # (kernel, (qb, b, a, kc)) -> iters_total read back after fences
        self._measured_iters: Dict[Tuple, int] = {}
        self._events: List[tuple] = []       # (kernel, start, end)
        self._device_ms: Dict[str, float] = {}
        self._timed: Dict[str, int] = {}
        self._device = None

    def reset(self) -> None:
        """Drop every record: callers bracket untimed work (a warm-up
        solve) so the counters match the timed region only."""
        self._entries.clear()
        self._measured_iters.clear()
        self._events.clear()
        self._device_ms.clear()
        self._timed.clear()

    def record(self, kernel: str, shape: Dict[str, Any],
               device=None) -> Optional[_Launch]:
        """Note one launch of ``kernel`` at ``shape``. On a CUDA
        ``device`` the start event is recorded now on the current stream
        and the returned handle's ``done()`` records the end event right
        after the launch; on the CPU nothing is timed (None)."""
        key = (kernel, tuple(sorted(shape.items())))
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = [kernel, dict(shape), 1]
        else:
            entry[2] += 1
        if device is None or getattr(device, "type", device) != "cuda":
            return None
        import torch
        self._device = device
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return _Launch(self, kernel, start)

    def record_measured_iters(self, kernel: str, iters_total: int,
                              shape: Tuple[int, int, int, int]) -> None:
        """Add MEASURED K1/K2 loop iterations (the summed ``iters`` of
        ``kernel``'s launches at the per-launch (qb, b, a, kc) ``shape``)."""
        key = (kernel, tuple(int(v) for v in shape))
        self._measured_iters[key] = \
            self._measured_iters.get(key, 0) + int(iters_total)

    def dispatch_counts(self) -> Dict[str, int]:
        """Launches recorded so far, per kernel."""
        out: Dict[str, int] = {}
        for kernel, _shape, count in self._entries.values():
            out[kernel] = out.get(kernel, 0) + count
        return out

    def drain_events(self) -> Dict[str, float]:
        """Fold the finished launches' event pairs into the per-kernel
        device time (each end event is waited for: call after the work's
        fetch, when it has finished). Returns this drain's ms per
        kernel."""
        from dmlp_tpu_torch.check.sanitize import fenced
        got: Dict[str, float] = {}
        events, self._events = self._events, []
        for kernel, start, end in events:
            with fenced("counters.drain_events"):
                end.synchronize()
            ms = start.elapsed_time(end)
            got[kernel] = got.get(kernel, 0.0) + ms
            self._device_ms[kernel] = self._device_ms.get(kernel, 0.0) + ms
            self._timed[kernel] = self._timed.get(kernel, 0) + 1
        return got

    def collect(self) -> Dict[str, Any]:
        """Summed ``flops`` / ``bytes_accessed`` / ``bytes_min`` in all
        and per kernel, with each kernel's launches, device ms (CUDA) and
        the least time its modeled work needs on this card; or
        ``{"counters_unavailable": True}`` when nothing was recorded."""
        from dmlp_tpu_torch.obs import kernel_cost
        self.drain_events()
        if not self._entries:
            return {"counters_unavailable": True, "dispatches_recorded": 0}
        peaks = device_peaks(self._device) if self._device is not None \
            else None
        per: Dict[str, Dict[str, Any]] = {}
        groups: Dict[Tuple, list] = {}
        for kernel, shape, count in self._entries.values():
            cost = kernel_cost.analytic_cost(kernel, shape)
            agg = per.setdefault(kernel, {
                "dispatches": 0, "flops": 0.0, "bytes_accessed": 0.0,
                "bytes_min": 0.0, "bound_ops": 0.0,
                "precision": cost["precision"]})
            agg["dispatches"] += count
            for k in ("flops", "bytes_accessed", "bytes_min", "bound_ops"):
                agg[k] += cost[k] * count
            if "qb" in shape and "kc" in shape and "b" in shape:
                groups.setdefault((kernel, (shape["qb"], shape["b"],
                                            shape["a"], shape["kc"])),
                                  []).append((cost, count))
        iters_all = 0
        for (kernel, shp), iters in self._measured_iters.items():
            agg = per.get(kernel)
            if agg is None:
                continue
            qb, b, a, kc = shp
            agg["flops"] += kernel_cost.extract_loop_cost(qb, b, a, kc,
                                                          iters)
            agg["extraction_term"] = "measured"
            agg["extract_iters_total"] = \
                agg.get("extract_iters_total", 0) + iters
            iters_all += iters
            if kernel == "fused_topk":
                # The gate lets through only the measured cells: the
                # products this data needs are theirs, not every cell's.
                full = sum(c["bound_ops"] * n
                           for c, n in groups.get((kernel, shp), []))
                agg["bound_ops"] += kernel_cost.fused_topk_cost(
                    qb, b, a, kc, iters)["bound_ops"] - full
        out: Dict[str, Any] = {
            "flops": sum(p["flops"] for p in per.values()),
            "bytes_accessed": sum(p["bytes_accessed"] for p in per.values()),
            "bytes_min": sum(p["bytes_min"] for p in per.values()),
            "dispatches_recorded": sum(p["dispatches"] for p in per.values()),
        }
        out["dispatches_analyzed"] = out["dispatches_recorded"]
        out["dispatches_analytic_model"] = out["dispatches_recorded"]
        if iters_all:
            out["extract_iters_total"] = iters_all
            out["extraction_term"] = "measured"
        for kernel, agg in per.items():
            if kernel in self._device_ms:
                agg["device_ms"] = self._device_ms[kernel]
                agg["timed_launches"] = self._timed[kernel]
            if peaks is not None:
                agg["peak_flops"] = peaks[agg["precision"]]
                agg.update(kernel_cost.bound_ms(agg, peaks))
                if agg.get("device_ms"):
                    s = agg["device_ms"] / 1e3
                    agg["achieved_flops_per_s"] = agg["flops"] / s
                    agg["utilization_vs_peak"] = \
                        agg["flops"] / s / peaks[agg["precision"]]
                    agg["bound_share"] = agg["bound_ms"] / agg["device_ms"]
        out["per_kernel"] = per
        if self._device is not None:
            from dmlp_tpu_torch.obs.run import current_device
            out["device"] = current_device(self._device)
        return out


def busy_ms(intervals) -> float:
    """The device's busy time: the length of the union of (start, end)
    intervals in microseconds (a profiler's device events), in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile_block(prof, wall_ms: float) -> Dict[str, Any]:
    """The device's busy time and idle share over a ``torch.profiler``
    window of ``wall_ms``: the union of its CUDA activity (kernels,
    copies), or the explicit marker when it recorded none (a CPU run)."""
    import torch
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"wall_ms": wall_ms,
                "device_idle_unavailable": "no CUDA activity recorded"}
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in dev)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms}


def merge_collected(parts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One counters block from several ranks' :meth:`CostProbe.collect`
    results (the mesh CLI gathers them to rank 0): totals and per-kernel
    figures summed, device shares recomputed from the sums, and each
    rank's own block under ``per_rank``."""
    got = [p for p in parts if not p.get("counters_unavailable")]
    if not got:
        return {"counters_unavailable": True, "dispatches_recorded": 0,
                "per_rank": parts}
    out: Dict[str, Any] = {}
    for key in ("flops", "bytes_accessed", "bytes_min",
                "dispatches_recorded", "dispatches_analyzed",
                "dispatches_analytic_model", "extract_iters_total"):
        if any(key in p for p in got):
            out[key] = sum(p.get(key, 0) for p in got)
    if "extract_iters_total" in out:
        out["extraction_term"] = "measured"
    per: Dict[str, Dict[str, Any]] = {}
    for p in got:
        for kernel, agg in p["per_kernel"].items():
            tgt = per.setdefault(kernel, {"precision": agg["precision"]})
            for k, v in agg.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool) \
                        and k not in ("achieved_flops_per_s",
                                      "utilization_vs_peak", "bound_share"):
                    tgt[k] = tgt.get(k, 0) + v
                elif k in ("extraction_term", "bound_by"):
                    tgt[k] = v
    for agg in per.values():
        if agg.get("device_ms") and "bound_ms" in agg:
            agg["bound_share"] = agg["bound_ms"] / agg["device_ms"]
    out["per_kernel"] = per
    out["per_rank"] = parts
    devices = {p.get("device") for p in got if p.get("device")}
    if devices:
        out["device"] = ",".join(sorted(devices))
    return out


def roofline(flops: float, bytes_accessed: float, elapsed_s: float,
             device=None, precision: str = "f32") -> Dict[str, float]:
    """Achieved-vs-peak summary for a solve that took ``elapsed_s``.
    ``peak_flops_per_chip`` and ``utilization_vs_peak`` only on a card the
    peak table holds (:func:`device_peaks`), at ``precision``'s peak."""
    out = {"flops": flops, "bytes_accessed": bytes_accessed,
           "elapsed_s": elapsed_s}
    if elapsed_s > 0:
        out["achieved_flops_per_s"] = flops / elapsed_s
        out["achieved_bytes_per_s"] = bytes_accessed / elapsed_s
    if bytes_accessed > 0:
        out["arithmetic_intensity"] = flops / bytes_accessed
    peaks = device_peaks(device) if device is not None else None
    if peaks is not None:
        out["peak_flops_per_chip"] = peaks[precision]
        if elapsed_s > 0:
            out["utilization_vs_peak"] = flops / (elapsed_s
                                                  * peaks[precision])
    return out


# -- process-wide hook (mirrors obs.trace) -----------------------------------
_active: Optional[CostProbe] = None


def install(probe: Optional[CostProbe] = None) -> CostProbe:
    global _active
    _active = probe if probe is not None else CostProbe()
    return _active


def uninstall() -> None:
    global _active
    _active = None


def active() -> Optional[CostProbe]:
    """The installed probe, or None: the wrappers' one module-global
    read."""
    return _active


def record_dispatch(kernel: str, shape: Dict[str, Any], device=None
                    ) -> Optional[_Launch]:
    """The wrappers' hook at every launch: records into the installed
    probe (see :meth:`CostProbe.record`; call the returned handle's
    ``done()`` right after the launch), None without a probe."""
    p = _active
    if p is None:
        return None
    return p.record(kernel, shape, device)


def record_measured_iters(kernel: str, iters_total: int,
                          shape: Tuple[int, int, int, int]) -> None:
    """Post-fetch hook (see CostProbe.record_measured_iters); no-op
    without a probe."""
    p = _active
    if p is not None:
        p.record_measured_iters(kernel, iters_total, shape)
