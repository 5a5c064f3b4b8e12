"""Per-rank tracing for the multi-process runs — port of
``dmlp_tpu/obs/dist_trace.py``.

Each rank of ``python -m dmlp_tpu_torch.distributed --trace DIR`` installs
a :class:`DistTracer` whose Perfetto ``pid`` is its rank and writes its own
``DIR/trace-rank<NN>.json``. Rank identity, the process count and the
rank's (data, query) mesh coordinates ride as Chrome ``M`` metadata events
and as a top-level ``dist`` block. Ranks have independent clock epochs,
so each rank stamps a clock-sync instant right after a
``torch.distributed`` barrier returns (:func:`clock_sync`): the barrier
releases every rank within a round trip of the same instant, and
``tools/merge_traces.py`` aligns the rank files on those instants.

Import-light, and every hook is a no-op when no tracer is installed.
"""

from __future__ import annotations

import os
from typing import Optional

from dmlp_tpu_torch.obs import trace as obs_trace

#: the instant-event name the merge and its checker key on; one per rank,
#: stamped at the contract barrier
CLOCK_SYNC_EVENT = "dist.clock_sync"


def rank_trace_path(trace_dir: str, rank: int) -> str:
    """The per-rank trace file: ``DIR/trace-rank<NN>.json``."""
    return os.path.join(trace_dir, f"trace-rank{rank:02d}.json")


class DistTracer(obs_trace.Tracer):
    """A Tracer whose Perfetto pid is the rank. ``mark_clock_sync()``
    stamps the barrier-aligned instant; ``write()`` adds the rank
    metadata events and the ``dist`` block the merge tool reads."""

    def __init__(self, rank: int, num_ranks: int, annotate: bool = False):
        super().__init__(annotate=annotate)
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self._pid = self.rank          # Perfetto process track = rank
        self._os_pid = os.getpid()
        self._clock_sync_ts_us: Optional[float] = None
        self.mesh_coords = None        # set via record_mesh

    def mark_clock_sync(self) -> None:
        """Stamp the barrier-aligned instant (call right after a barrier
        returns). The first stamp is the rank's sync point; one clock read
        serves both the ``dist`` block and the event."""
        ts = (obs_trace._clock() - self._epoch) * 1e6
        if self._clock_sync_ts_us is None:
            self._clock_sync_ts_us = ts
        self.instant(CLOCK_SYNC_EVENT, ts=ts, rank=self.rank)

    def record_mesh(self, mesh) -> None:
        """Record this rank's place on the ``DeviceMesh``: the axis sizes
        and the rank's coordinate on each axis (the reference's
        ``local_span``, one coordinate wide: one rank per cell)."""
        try:
            from dmlp_tpu_torch.parallel.mesh import mesh_coords
            names = mesh.mesh_dim_names
            shape = dict(zip(names, (int(v) for v in mesh.shape)))
            coords = mesh_coords(mesh)
            span = {ax: [int(v), int(v)] for ax, v in zip(names, coords)}
        except Exception:  # metadata is best effort; tracing never raises
            return
        self.mesh_coords = {"mesh_shape": shape, "local_span": span}
        self.instant("dist.mesh", rank=self.rank, **self.mesh_coords)

    def to_dict(self, process_name: str = "dmlp_tpu_torch") -> dict:
        label = f"{process_name} rank {self.rank:02d}/{self.num_ranks}"
        doc = super().to_dict(process_name=label)
        meta = [
            {"name": "process_sort_index", "ph": "M", "pid": self._pid,
             "args": {"sort_index": self.rank}},
            {"name": "process_labels", "ph": "M", "pid": self._pid,
             "args": {"labels": f"rank={self.rank} os_pid={self._os_pid}"}},
        ]
        doc["traceEvents"] = doc["traceEvents"][:1] + meta \
            + doc["traceEvents"][1:]
        doc["dist"] = {
            "rank": self.rank,
            "num_ranks": self.num_ranks,
            "os_pid": self._os_pid,
            "clock_sync_ts_us": self._clock_sync_ts_us,
            # The rank file's own domain is still per-process monotonic;
            # the merge stamps the merged doc "synced" once aligned.
            "clock_source": self.clock_source,
        }
        if self.mesh_coords:
            doc["dist"]["mesh"] = self.mesh_coords
        return doc

    def write_rank_file(self, trace_dir: str) -> str:
        os.makedirs(trace_dir, exist_ok=True)
        path = rank_trace_path(trace_dir, self.rank)
        self.write(path)
        return path


def install(trace_dir: str, rank: int, num_ranks: int,
            annotate: bool = False) -> DistTracer:
    """Create a rank's DistTracer and install it as the process-wide
    collector, so every span site reports into the rank's timeline."""
    del trace_dir  # the file name is fixed by the rank; the directory is
    # named at the call site where the file will land
    tracer = DistTracer(rank, num_ranks, annotate=annotate)
    obs_trace.install(tracer)
    return tracer


def clock_sync() -> None:
    """Hook form of :meth:`DistTracer.mark_clock_sync`: stamps the
    installed tracer if it is rank-aware, no-op otherwise."""
    t = obs_trace.active()
    if isinstance(t, DistTracer):
        t.mark_clock_sync()
