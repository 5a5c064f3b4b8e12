"""Fleet process harness: spawn, await and drain replicas and the router.

Port of ``dmlp_tpu/fleet/harness.py``. Every subprocess gets its own
stderr log, readiness is file-based, the per-replica telemetry HTTP port
is read back from the snapshot gauge, and teardown is the in-band drain
with the exit-code-0 contract (a kill only on a timeout). Every replica is
a new interpreter started through ``subprocess`` (never a fork of a
process that may have started CUDA), running ``python -m
dmlp_tpu_torch.serve``; it runs on the card unless its flags say
``--device cpu``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from dmlp_tpu_torch.serve import client as sc


class FleetProc:
    """One spawned fleet process and its artifacts."""

    def __init__(self, name: str, proc, ready_path: str, errlog: str,
                 telemetry_path: Optional[str] = None):
        self.name = name
        self.proc = proc
        self.ready_path = ready_path
        self.errlog = errlog
        self.telemetry_path = telemetry_path
        self.ready: Dict = {}
        self.scrape_port: Optional[int] = None


def _repo_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update(extra or {})
    return env


def spawn_replica(corpus_path: str, out_dir: str, name: str,
                  warm_spec: str, batch_cap: int = 32,
                  flags: Optional[List[str]] = None,
                  env_extra: Optional[Dict[str, str]] = None,
                  record: Optional[str] = None,
                  compile_cache: Optional[str] = None) -> FleetProc:
    """Start one replica daemon (not waited on: :func:`await_replica`).
    ``compile_cache`` is the daemon's ``--compile-cache``: the replica
    builds and loads its libraries there (``$DMLP_TPU_COMPILE_CACHE``
    also rides the inherited environment)."""
    ready = os.path.join(out_dir, f"{name}_ready.json")
    telem = os.path.join(out_dir, f"{name}_telemetry.prom")
    errlog = os.path.join(out_dir, f"{name}.err")
    for stale in (ready, telem):
        if os.path.exists(stale):
            os.remove(stale)
    cmd = [sys.executable, "-m", "dmlp_tpu_torch.serve",
           "--corpus", corpus_path, "--port", "0",
           "--ready-file", ready, "--warm-buckets", warm_spec,
           "--max-batch-queries", str(batch_cap),
           "--telemetry", telem, "--telemetry-port", "0",
           "--tick-ms", "2"] + (flags or [])
    if record:
        cmd += ["--record", record]
    if compile_cache:
        cmd += ["--compile-cache", compile_cache]
    with open(errlog, "w") as ef:
        proc = subprocess.Popen(cmd, stderr=ef,
                                stdout=subprocess.DEVNULL,
                                stdin=subprocess.DEVNULL,
                                env=_repo_env(env_extra), cwd=out_dir)
    return FleetProc(name, proc, ready, errlog, telemetry_path=telem)


def await_replica(fp: FleetProc, timeout_s: float = 600.0) -> Dict:
    """Block until the replica is ready and its telemetry HTTP port is
    announced in the snapshot gauge (the router's scrape source)."""
    fp.ready = sc.await_ready(fp.proc, fp.ready_path,
                              timeout_s=timeout_s, errlog=fp.errlog)
    deadline = time.monotonic() + 60
    while fp.scrape_port is None:
        if os.path.exists(fp.telemetry_path):
            for ln in open(fp.telemetry_path).read().splitlines():
                if ln.startswith("telemetry_http_port"):
                    fp.scrape_port = int(float(ln.split()[-1]))
        if fp.scrape_port is None:
            if fp.proc.poll() is not None:
                raise RuntimeError(f"replica {fp.name} died before its "
                                   f"scrape port; see {fp.errlog}")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"replica {fp.name}: no telemetry_http_port in "
                    f"{fp.telemetry_path}")
            time.sleep(0.1)
    return fp.ready


def await_all(fps: List[FleetProc], timeout_s: float = 600.0) -> None:
    """:func:`await_replica` for replicas started together (each start
    overlaps the others'); on a failure every process is killed."""
    try:
        for fp in fps:
            await_replica(fp, timeout_s=timeout_s)
    except BaseException:
        kill_all(fps)
        raise


def spawn_router(out_dir: str, replicas: List[FleetProc],
                 record: Optional[str] = None,
                 flags: Optional[List[str]] = None) -> FleetProc:
    """Start ``python -m dmlp_tpu_torch.fleet`` over ready replicas and
    wait for its ready file."""
    ready = os.path.join(out_dir, "router_ready.json")
    errlog = os.path.join(out_dir, "router.err")
    if os.path.exists(ready):
        os.remove(ready)
    endpoints = ",".join(f"127.0.0.1:{fp.ready['port']}"
                         for fp in replicas)
    scrapes = ",".join(str(fp.scrape_port) if fp.scrape_port else "-"
                       for fp in replicas)
    cmd = [sys.executable, "-m", "dmlp_tpu_torch.fleet",
           "--replicas", endpoints, "--scrape-ports", scrapes,
           "--port", "0", "--ready-file", ready,
           "--telemetry-port", "0"] + (flags or [])
    if record:
        cmd += ["--record", record]
    with open(errlog, "w") as ef:
        proc = subprocess.Popen(cmd, stderr=ef,
                                stdout=subprocess.DEVNULL,
                                stdin=subprocess.DEVNULL,
                                env=_repo_env(), cwd=out_dir)
    fp = FleetProc("router", proc, ready, errlog)
    try:
        fp.ready = sc.await_ready(proc, ready, timeout_s=120,
                                  errlog=errlog)
    except BaseException:
        kill_all([fp])
        raise
    fp.scrape_port = fp.ready.get("telemetry_port")
    return fp


def drain_fleet(router: FleetProc, replicas: List[FleetProc],
                timeout_s: float = 120.0) -> None:
    """The orderly fleet shutdown: one in-band ``drain`` to the router
    propagates to every replica; every process must exit 0."""
    cli = sc.ServeClient(router.ready["port"])
    try:
        cli.drain()
    finally:
        cli.close()
    for fp in replicas + [router]:
        rc = fp.proc.wait(timeout=timeout_s)
        if rc != 0:
            raise RuntimeError(
                f"{fp.name} drain exited {rc}; see {fp.errlog}")


def kill_all(procs: List[FleetProc]) -> None:
    for fp in procs:
        if fp.proc.poll() is None:
            fp.proc.kill()
            fp.proc.wait(timeout=30)
