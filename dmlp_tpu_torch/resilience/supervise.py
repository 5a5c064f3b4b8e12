"""Cluster supervision: heartbeat and deadline detection of dead or hung
ranks, bounded relaunch, and the degraded single-process fallback — port
of ``dmlp_tpu/resilience/supervise.py``.

The reference's only hang protection is ``mpirun --timeout``: kill
everything and report nothing. Here:

- every rank process writes a **heartbeat file** (``hb-rank<NN>``, its
  mtime refreshed by a daemon thread started when ``$DMLP_TPU_HEARTBEAT``
  names the file — ``dmlp_tpu_torch.distributed`` does this itself);
- the supervisor polls the ranks' liveness and heartbeats under one
  **cluster deadline**: a rank that exits non-zero, a heartbeat gone stale
  (a crashed or frozen interpreter), or a blown deadline (a livelocked
  collective, which heartbeat threads beat through) fails the launch;
- a failed launch kills the whole cluster and **relaunches** it (bounded;
  each restart is recorded in ``resilience.stats``);
- when the launches are spent, the caller's **degraded single-process
  solve** runs instead — the same checksums, no mesh — and the
  degradation is recorded, never silent.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from typing import Callable, List, Optional, Tuple

from dmlp_tpu_torch.resilience import stats

#: env var naming the heartbeat file a rank process must keep fresh
HEARTBEAT_ENV = "DMLP_TPU_HEARTBEAT"


def heartbeat_file(directory: str, rank: int) -> str:
    return os.path.join(directory, f"hb-rank{rank:02d}")


def start_heartbeat(path: str, interval_s: float = 0.5) -> threading.Event:
    """Start the daemon heartbeat thread; returns its stop event. It
    detects a crashed or frozen interpreter; a livelocked collective
    releases the GIL and beats on, which the cluster deadline covers."""
    stop = threading.Event()

    def _beat():
        while not stop.is_set():
            try:
                with open(path, "a"):
                    os.utime(path, None)
            except OSError:
                pass  # a missed beat only ages the file
            stop.wait(interval_s)

    threading.Thread(target=_beat, daemon=True,
                     name="resilience-heartbeat").start()
    return stop


def maybe_start_heartbeat_from_env() -> Optional[threading.Event]:
    """Start the heartbeat when the supervisor asked for one
    (``$DMLP_TPU_HEARTBEAT``); rank entry points call it."""
    path = os.environ.get(HEARTBEAT_ENV)
    return start_heartbeat(path) if path else None


class ClusterFailure(RuntimeError):
    """Every supervised launch failed and no fallback was given."""

    def __init__(self, report: dict):
        super().__init__(f"supervised cluster failed: {report}")
        self.report = report


def _kill_all(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass  # killed already; nothing is left to do


def _watch(procs: List[subprocess.Popen], hb_dir: str, deadline: float,
           cluster_timeout_s: float, hb_stale_s: float, poll_s: float,
           clock: Callable) -> str:
    """Poll one launch until it ends: "" when every rank exited 0, else
    why it failed."""
    while True:
        rcs = [p.poll() for p in procs]
        if all(rc is not None for rc in rcs):
            bad = [i for i, rc in enumerate(rcs) if rc != 0]
            return f"rank(s) {bad} exited nonzero {rcs}" if bad else ""
        dead = [i for i, rc in enumerate(rcs) if rc is not None and rc != 0]
        if dead:
            return f"rank(s) {dead} died mid-run (rc {rcs})"
        if clock() > deadline:
            return (f"cluster deadline {cluster_timeout_s:.3g}s exceeded "
                    "(hung rank or livelocked collective)")
        now = time.time()
        stale = []
        for i, rc in enumerate(rcs):
            if rc is not None:
                continue
            try:   # one stat: the file may vanish between two
                mtime = os.path.getmtime(heartbeat_file(hb_dir, i))
            except OSError:
                continue    # no beat yet: the deadline covers it
            if now - mtime > hb_stale_s:
                stale.append(i)
        if stale:
            return f"heartbeat stale (> {hb_stale_s:.3g}s) for rank(s) {stale}"
        time.sleep(poll_s)


def run_supervised(make_cluster: Callable[[int], List[List[str]]],
                   workdir: str, *, env: Optional[dict] = None,
                   cluster_timeout_s: float = 300.0,
                   hb_stale_s: float = 15.0, poll_s: float = 0.1,
                   max_launches: int = 2,
                   fallback: Optional[Callable[[], Tuple[bytes, bytes]]]
                   = None,
                   clock: Callable = time.monotonic,
                   ) -> Tuple[bytes, bytes, dict]:
    """The launch-and-watch loop. ``make_cluster(attempt)`` returns one
    argv per rank (a fresh coordinator port per attempt); the ranks' output
    files land under ``workdir``. Returns (rank 0's stdout bytes, rank 0's
    stderr bytes, report). When every launch failed, runs ``fallback()``
    — the degraded single-process solve — or raises
    :class:`ClusterFailure`."""
    os.makedirs(workdir, exist_ok=True)
    report: dict = {"launches": [], "fallback": False}
    base_env = dict(env if env is not None else os.environ)

    for attempt in range(max(max_launches, 1)):
        argvs = make_cluster(attempt)
        hb_dir = os.path.join(workdir, f"hb-attempt{attempt}")
        os.makedirs(hb_dir, exist_ok=True)
        files, procs = [], []
        try:
            for rank, argv in enumerate(argvs):
                out_f = open(os.path.join(
                    workdir, f"rank{rank}.a{attempt}.out"), "wb")
                err_f = open(os.path.join(
                    workdir, f"rank{rank}.a{attempt}.err"), "wb")
                files += [out_f, err_f]
                procs.append(subprocess.Popen(
                    argv, stdout=out_f, stderr=err_f, stdin=subprocess.DEVNULL,
                    env=dict(base_env, **{HEARTBEAT_ENV: heartbeat_file(
                        hb_dir, rank)})))
            failure = _watch(procs, hb_dir, clock() + cluster_timeout_s,
                             cluster_timeout_s, hb_stale_s, poll_s, clock)
        finally:
            _kill_all(procs)
            for f in files:
                f.close()
        report["launches"].append({"attempt": attempt, "ok": failure == "",
                                   **({"failure": failure} if failure
                                      else {})})
        if failure == "":
            with open(os.path.join(workdir, f"rank0.a{attempt}.out"),
                      "rb") as f:
                out_b = f.read()
            with open(os.path.join(workdir, f"rank0.a{attempt}.err"),
                      "rb") as f:
                err_b = f.read()
            return out_b, err_b, report
        if attempt + 1 < max_launches:
            stats.record_restart()

    if fallback is None:
        raise ClusterFailure(report)
    stats.record_degradation("cluster", "single-process")
    report["fallback"] = True
    out_b, err_b = fallback()
    return out_b, err_b, report
