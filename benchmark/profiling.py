"""A traced stretch: ``torch.profiler`` over a few steady solves or
batches, reduced to the device's busy time, kernel time by name and the
longest idle gaps.

``busy_s`` is the length of the union of the device's activity intervals
(kernels, copies, sets), ``window_s`` the host clock over the stretch,
which begins and ends on a synchronised device. Each idle gap between
device intervals is named by the host-side operation that overlapped it
most (the shorter one on a tie): what the host was doing while the card
waited.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _activities(device):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _times_us(e) -> Tuple[float, float]:
    if hasattr(e, "start_ns"):
        return e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3
    return e.start_us(), e.start_us() + e.duration_us()


class Stretch:
    """Start, stop and reduce one profiled stretch on ``device``.

    The host's operations are recorded on the thread that starts the
    stretch only, so a stretch starts on the thread that launches the
    work; :meth:`prepare` on the main thread first, where that is another
    thread (the profiler registers itself with the thread of its first
    use)."""

    def __init__(self, device):
        self.device = device
        self._prof = None
        self._t0 = 0.0
        self.window_s = 0.0

    def prepare(self) -> None:
        from torch.profiler import profile
        with profile(activities=_activities(self.device)):
            pass

    def start(self) -> None:
        import torch
        from torch.profiler import profile
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=_activities(self.device))
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    def summary(self) -> Dict[str, Any]:
        """{"busy_s", "window_s", "kernel_s": {name: s}, "breakdown"}; a
        stretch with no device activity has no ``busy_s``."""
        import torch
        dev_type = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            a, b = _times_us(e)
            (dev if e.device_type() == dev_type else host).append(
                (a, b, e.name()))
        out: Dict[str, Any] = {"window_s": self.window_s, "kernel_s": {}}
        if not dev:
            return out
        by_name: Dict[str, float] = {}
        for a, b, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        merged = _union([(a, b) for a, b, _ in dev])
        out["busy_s"] = sum(b - a for a, b in merged) / 1e6
        out["kernel_s"] = by_name
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        lo = min([a for a, _, _ in host] + [merged[0][0]])
        hi = max([b for _, b, _ in host] + [merged[-1][1]])
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        gaps = sorted(((edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]),
                      key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for g0, g1 in gaps:
            best, best_key = "host: no operation recorded", None
            for a, b, name in host:
                ov = min(b, g1) - max(a, g0)
                if ov <= 0:
                    continue
                key = (ov, -(b - a))
                if best_key is None or key > best_key:
                    best, best_key = name, key
            named.append([best, (g1 - g0) / 1e6])
        out["breakdown"] = {"device_ops": [[n, s] for n, s in ops],
                            "idle_gaps": named}
        return out
