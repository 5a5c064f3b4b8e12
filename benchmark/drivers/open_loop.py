"""A served corpus under open-loop load.

Set-up draws the corpus from the seed on the device, starts the program's
serving daemon (``ServeDaemon``) in this process on an ephemeral
localhost port with the corpus resident, and warms the mix's buckets: k
at every power-of-two batch from one request to ``max_batch_queries``.
Then it starts the load generator (``benchmark.loadgen``) in a process of
its own, which opens its connections and sends one warm-up request on
each. The window opens when the generator is told to go: it sends every
request at its due time for ``--seconds`` and times each from then to its
response. With ``--trace 1`` a profiled stretch of ``trace_s`` seconds
sits in the middle of the window, and the engine keeps every batch's log
entry.

After the window the daemon is drained and freed, and every answered
request is judged against the float64 reference
(``judge.serve_wrong``).
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import threading
from typing import Any, Dict, List

import numpy as np

from benchmark import datagen, judge
from benchmark.drivers.common import (Outcome, Run, free_device,
                                      memory_peak, now, reset_peak)
from benchmark.profiling import Stretch
from benchmark.reference import knn as ref
from benchmark.spec import ROOT


def warm_buckets(tr: Dict[str, Any]) -> List[tuple]:
    k = int(tr["k"])
    out, q = [], 1
    while q <= int(tr["max_batch_queries"]):
        out.append((q, k))
        q *= 2
    return out


def make_corpus(r: Run):
    """The served corpus of the cell, drawn from the seed: the program's
    ``KNNInput`` with no queries."""
    from dmlp_tpu_torch.io.grammar import KNNInput, Params
    cfg = r.cell.config
    n, a = int(cfg["num_data"]), int(cfg["num_attrs"])
    attrs, labels = datagen.corpus(cfg, r.seed, r.device)
    return KNNInput(Params(n, 0, a), labels.cpu().numpy(),
                    attrs.cpu().numpy().astype(np.float64),
                    np.zeros(0, np.int32), np.zeros((0, a)))


def start_daemon(r: Run):
    """The daemon over the seeded corpus, warmed; returns (daemon,
    corpus)."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.serve.daemon import ServeDaemon

    tr = r.cell.traffic
    corpus = make_corpus(r)
    reset_peak(r.device)
    daemon = ServeDaemon(
        corpus, EngineConfig(device=r.device.type, **tr["engine_config"]),
        port=0, max_batch_queries=int(tr["max_batch_queries"]),
        warm_buckets=warm_buckets(tr))
    daemon.start()
    return daemon, corpus


class LoadGen:
    """The generator process: started with its pool open and warm, then
    one window per :meth:`window` call."""

    def __init__(self, r: Run, port: int, connections: int):
        tr = r.cell.traffic
        spec = {"port": port, "config": r.cell.config, "seed": r.seed,
                "k": int(tr["k"]), "connections": connections,
                "drain_timeout_s": float(tr["drain_timeout_s"])}
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        self.drain_timeout_s = float(tr["drain_timeout_s"])
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.loadgen"], cwd=str(ROOT),
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        self._send(json.dumps(spec))
        line = self._read(600)
        ready = json.loads(line) if line else {}
        if not ready.get("ready"):
            self.close()
            raise RuntimeError(f"load generator did not get ready: {line!r}")
        self.ready = ready

    def _send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def _read(self, timeout_s: float) -> str:
        box: Dict[str, Any] = {}

        def _get():
            box["line"] = self.proc.stdout.readline()
        t = threading.Thread(target=_get, daemon=True)
        t.start()
        t.join(timeout_s)
        return box.get("line") or ""

    def go(self, rate_per_s: float, seconds: float) -> float:
        """Open a window; returns the host clock at its opening."""
        t = now()
        self._send(json.dumps({"rate_per_s": rate_per_s,
                               "seconds": seconds}))
        return t

    def result(self, seconds: float) -> Dict[str, Any]:
        line = self._read(seconds + self.drain_timeout_s + 60)
        if not line:
            self.close()
            raise RuntimeError("load generator gave no result")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self._send("quit")
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
        self.proc.wait(timeout=30)


def drive(daemon, gen: LoadGen, rate_per_s: float, seconds: float,
          stretch: Stretch = None, trace_s: float = 0.0) -> Dict[str, Any]:
    """One open-loop window; returns the generator's result with
    ``t_go``, the host clock when the window opened. With a stretch, the
    middle ``trace_s`` seconds of the window are profiled."""
    t_go = gen.go(rate_per_s, seconds)
    if stretch is not None:
        # The stretch starts and stops on the batcher thread, which
        # launches every kernel and reads every result.
        threading.Event().wait(max(0.0, seconds / 2 - trace_s / 2))
        daemon.batcher.call(stretch.start)
        threading.Event().wait(trace_s)
        daemon.batcher.call(stretch.stop)
    out = gen.result(seconds)
    out["t_go"] = t_go
    return out


def latencies(records, seconds: float, fail_ms: float) -> List[float]:
    """Latency of every request due in the window; a request refused,
    failed or never answered counts as ``fail_ms``, past any limit."""
    return [rec[1] if rec[2] == "ok" and rec[1] is not None else fail_ms
            for rec in records if rec[0] <= seconds]


def reference_answers(r: Run, corpus, count: int,
                      precision: str = "float64"):
    """(labels, checksums) of the first ``count`` requests of the run's
    window, by the reference at ``precision``."""
    import torch
    cfg, tr = r.cell.config, r.cell.traffic
    dev = r.device
    queries = datagen.request_queries(cfg, r.seed, count)
    data64 = torch.from_numpy(corpus.data_attrs).to(dev)
    lab = torch.from_numpy(corpus.labels).to(dev)
    q64 = torch.from_numpy(queries).to(dev)
    _, ids = ref.knn(q64, data64, int(tr["k"]), precision=precision)
    pred = ref.vote(lab, ids, int(cfg["num_labels"]))
    pred_h = pred.cpu().numpy()
    return pred_h, ref.checksums(pred_h, ids.cpu().numpy())


def control(r: Run) -> dict:
    """The control of a served cell on one seed: the reference in float32
    (the precision just below the float64 the exact path states) put in
    the program's place for the requests a window of ``r.seconds`` at the
    mix's rate sends, judged as the daemon's responses are."""
    tr = r.cell.traffic
    corpus = make_corpus(r)
    count = len(datagen.arrival_offsets(float(tr["rate_per_s"]), r.seconds,
                                        r.seed))
    ref_pred, ref_sums = reference_answers(r, corpus, count)
    c_pred, c_sums = reference_answers(r, corpus, count, "float32")
    responses = [{"ok": True, "labels": [int(c_pred[i])],
                  "checksums": [int(c_sums[i])]} for i in range(count)]
    return {"float32": judge.serve_wrong(responses, ref_pred, ref_sums)}


def run(r: Run) -> Outcome:
    cfg, tr = r.cell.config, r.cell.traffic
    daemon, corpus = start_daemon(r)
    engine = daemon.engine
    seq0 = engine.batches_solved
    stretch = None
    if r.trace:
        # Every batch's log entry, not the last BATCH_LOG of them.
        engine.batch_log = collections.deque(engine.batch_log)
        stretch = Stretch(r.device)
        stretch.prepare()
    try:
        gen = LoadGen(r, daemon.port, int(tr["connections"]))
        try:
            out = drive(daemon, gen, float(tr["rate_per_s"]), r.seconds,
                        stretch, float(tr["trace_s"]))
        finally:
            gen.close()
        batches = [e for e in engine.batch_log if e["seq"] > seq0]
        if batches:
            med = sorted(batches, key=lambda e: e["phase_ms"].get("fetch", 0))
            r.log(f"last {len(batches)} micro-batches: median fetch "
                  f"{med[len(med) // 2]['phase_ms'].get('fetch')} ms, mean "
                  f"{sum(e['nq'] for e in batches) / len(batches):.1f} "
                  f"queries")
        stats = daemon.stats()
        peak = memory_peak(r.device)
    finally:
        daemon.drain()
    setup_s = out["t_go"] - r.t0
    del daemon, engine
    free_device(r.device)

    records = out["records"]
    fail_ms = float(tr["drain_timeout_s"]) * 1e3
    lats = latencies(records, r.seconds, fail_ms)
    failed = sum(1 for rec in records if rec[2] != "ok")
    r.log(f"set-up {setup_s:.3f} s (loadgen connects "
          f"{gen.ready['connect_s']:.3f} s, warm-up {gen.ready['warm_s']:.3f}"
          f" s); {len(records)} requests at "
          f"{tr['rate_per_s']}/s; loadgen lateness ms "
          f"{out['lateness_ms']}, connections opened in the window "
          f"{out['connections_opened_in_window']}, failed {failed}")
    obs = {"setup_s": setup_s, "window_s": r.seconds, "latencies_ms": lats,
           "batch_log": batches, "daemon_stats": stats,
           "lateness_ms": out["lateness_ms"]}
    if stretch is not None:
        obs["trace"] = stretch.summary()

    t_ref = now()
    responses = [None if rec[2] is None or rec[2] == "no response" else
                 {"ok": rec[2] == "ok", "labels": rec[3],
                  "checksums": rec[4]} for rec in records]
    ref_pred, ref_sums = reference_answers(r, corpus, len(records))
    verdict = judge.serve_wrong(responses, ref_pred, ref_sums)
    r.log(f"reference and judge {now() - t_ref:.3f} s: {verdict}")
    limit = int(tr["limits"]["wrong"])
    checks = {"wrong": (verdict["wrong"], limit)}
    return Outcome(obs=obs, attempted=len(records), failed=failed,
                   checks=checks, memory_peak_bytes=peak,
                   correct=verdict["wrong"] <= limit
                   and verdict["judged"] > 0)
