"""Race-stress harness: hammer a live serving daemon under the runtime
race sanitizer and prove byte-identity survives concurrency — port of
``tools/race_stress.py``.

Phases; every failure exits nonzero with the reason named:

1. **Sanitizer teeth** — a seeded lock-order inversion and a seeded
   sleep-under-lock on scratch locks MUST be caught by
   :mod:`dmlp_tpu_torch.check.racecheck` before anything else runs: a
   sanitizer that can't see a planted bug proves nothing about a clean
   run.
2. **Concurrent stress** — an in-process :class:`ServeDaemon` on
   ``--device`` (telemetry session live: Sampler + export + scrape HTTP
   threads running, fault schedule installed) is hammered simultaneously
   by query workers, an ingest worker, a stats-op worker, and an
   OpenMetrics scrape worker over real sockets. Every lock in the
   serving/telemetry surface was created after install, so the
   sanitizer watches every acquisition order and every blocking call.
3. **Byte-identity under stress** — every stressed query response must
   equal the float64 golden oracle byte-for-byte. Concurrent ingests
   append rows FAR outside the query envelope (distance-dominated, can
   never enter a top-k), so the oracle over the original corpus stays
   exact whatever the interleaving; a post-stress replay then verifies
   the grown corpus against its own oracle, proving the ingests landed.
4. **Squeeze + drain** — the scheduled ``serve.admit`` oom fault sheds
   a sacrificial request (visible rejection), the daemon drains
   cleanly, and the sanitizer report over the whole stressed run must
   be EMPTY: zero inversions, zero blocking-under-lock.

``--json`` keeps stdout pure JSON (narration on stderr). ``--pallas``
serves with K1 over the resident chunks (the extract selection; on the
CPU its plain version). torch is imported before the sanitizer is installed: its own
module locks are not the serving surface's discipline.

Usage::

    python -m dmlp_tpu_torch.check.race_stress [--device cuda|cpu]
        [--pallas] [--out DIR] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch  # noqa: F401  (before install: torch's locks stay native)

# Install the sanitizer BEFORE any serving/telemetry import constructs a
# lock — everything created afterwards is tracked.
from dmlp_tpu_torch.check import racecheck  # noqa: E402

racecheck.install()

from dmlp_tpu_torch import kernels                                # noqa: E402
from dmlp_tpu_torch.config import EngineConfig                   # noqa: E402
from dmlp_tpu_torch.io.grammar import (KNNInput, Params,         # noqa: E402
                                       parse_input_text)
from dmlp_tpu_torch.obs.telemetry import validate_openmetrics    # noqa: E402
from dmlp_tpu_torch.resilience import inject as rs_inject        # noqa: E402
from dmlp_tpu_torch.serve import client as sc                    # noqa: E402
from dmlp_tpu_torch.serve.daemon import ServeDaemon              # noqa: E402

CORPUS = dict(num_data=2000, num_queries=4, num_attrs=5, min_attr=0.0,
              max_attr=60.0, min_k=1, max_k=8, num_labels=4, seed=93)
HEADER = {"serve_trace_schema": 1, "corpus": CORPUS}
N_QUERY_WORKERS = 3
REQS_PER_WORKER = 12
N_INGESTS = 6
INGEST_ROWS = 5
#: ingested rows live FAR outside the query envelope: with k <= 8 and
#: 2000 near rows they can never enter a top-k, so the original-corpus
#: oracle stays byte-exact under any query/ingest interleaving
FAR_OFFSET = 1.0e6

_narr = sys.stdout


def fail(msg: str):
    print(f"race_stress: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"race_stress: {msg}", file=_narr, flush=True)


def stress_requests():
    """(worker, idx) -> request dict; deterministic shapes + seeds."""
    out = []
    for w in range(N_QUERY_WORKERS):
        for i in range(REQS_PER_WORKER):
            out.append({"nq": 1 + (w * 7 + i) % 8,
                        "k": 1 + (w * 5 + i) % 8,
                        "seed": 50_000 + w * 1000 + i})
    return out


def prove_sanitizer_teeth() -> None:
    """Seeded inversion + seeded sleep-under-lock must be caught."""
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:  # check: allow-concurrency=R701 — half of the planted bug
            pass
    with b:
        with a:  # check: allow-concurrency=R701 — the planted inversion
            pass
    with a:
        time.sleep(0.001)  # check: allow-concurrency=R703 — planted
    r = racecheck.report()
    if r["inversions"] != 1:
        fail(f"sanitizer missed the seeded inversion: {r}")
    if r["blocking_under_lock"] != 1:
        fail(f"sanitizer missed the seeded sleep-under-lock: {r}")
    racecheck.reset()
    say("sanitizer teeth OK: seeded inversion and sleep-under-lock "
        "both caught, state reset")


def _far_rows():
    """The ingest worker's rows, regenerated from its seed."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(N_INGESTS):
        labels = rng.integers(0, CORPUS["num_labels"], INGEST_ROWS)
        rows = FAR_OFFSET + rng.uniform(
            0.0, 1.0, (INGEST_ROWS, CORPUS["num_attrs"]))
        out.append((labels, rows))
    return out


def main(argv=None) -> int:
    global _narr
    ap = argparse.ArgumentParser(
        prog="dmlp_tpu_torch.check.race_stress", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the daemon's engine runs (default: the "
                         "card; raises without one)")
    ap.add_argument("--pallas", action="store_true",
                    help="serve K1 over the resident chunks (the extract "
                         "selection, which auto leaves to large corpora)")
    ap.add_argument("--out", default=None,
                    help="directory of RACE_STRESS.json and the telemetry "
                         "snapshot (default: a fresh temporary directory)")
    ap.add_argument("--json", action="store_true",
                    help="pure-JSON verdict on stdout, narration on "
                         "stderr")
    args = ap.parse_args(argv)
    if args.json:
        _narr = sys.stderr
    out = os.path.abspath(args.out or tempfile.mkdtemp(prefix="race-"))
    os.makedirs(out, exist_ok=True)

    prove_sanitizer_teeth()

    corpus = parse_input_text(sc.corpus_text(HEADER))
    reqs = stress_requests()
    golden = sc.golden_reference(corpus, HEADER, reqs)

    # One oom fault at serve.admit AFTER every stress request admitted:
    # the sacrificial post-stress request is the squeeze probe.
    schedule = rs_inject.FaultSchedule.from_dict(
        {"schema": 1, "seed": 3, "faults": [
            {"site": "serve.admit", "kind": "oom", "times": 1,
             "after": len(reqs)}]})
    rs_inject.install(schedule)

    launches0 = dict(kernels.LAUNCHES)
    warm = sc.warm_buckets_for_trace(reqs, batch_queries_cap=32)
    telem_path = os.path.join(out, "race_telemetry.prom")
    select = "extract" if args.pallas else "auto"
    config = EngineConfig(device=args.device, use_pallas=args.pallas,
                          select=select)
    daemon = ServeDaemon(
        corpus, config, port=0, max_batch_queries=32, tick_s=0.001,
        telemetry_path=telem_path, telemetry_port=0, warm_buckets=warm)
    daemon.start()
    say(f"daemon up: device={args.device} pallas={args.pallas} "
        f"select={select} "
        f"port={daemon.port} "
        f"warm_buckets={len(daemon.engine.bucket_stats()['buckets'])} "
        f"locks_tracked={racecheck.report()['locks_created']}")
    http_port = daemon.session.http_port
    errors: list = []
    results: dict = {}
    stop_aux = threading.Event()
    stats_calls = [0]
    scrapes = [0]

    def query_worker(w: int):
        try:
            cli = sc.ServeClient(daemon.port)
            try:
                for i in range(REQS_PER_WORKER):
                    idx = w * REQS_PER_WORKER + i
                    req = reqs[idx]
                    q = sc.materialize_queries(req, HEADER)
                    ks = sc.request_ks(req)
                    resp = cli.query(q, ks=[int(v) for v in ks],
                                     req_id=str(idx))
                    if not resp.get("ok"):
                        errors.append(f"query {idx}: {resp}")
                        return
                    results[idx] = resp["checksums"]
            finally:
                cli.close()
        except Exception as e:  # check: no-retry — the verdict names it
            errors.append(f"query worker {w}: {type(e).__name__}: {e}")

    def ingest_worker():
        try:
            cli = sc.ServeClient(daemon.port)
            try:
                for labels, rows in _far_rows():
                    r = cli.ingest([int(v) for v in labels], rows)
                    if not r.get("ok"):
                        errors.append(f"ingest: {r}")
                        return
            finally:
                cli.close()
        except Exception as e:  # check: no-retry — the verdict names it
            errors.append(f"ingest worker: {type(e).__name__}: {e}")

    def stats_worker():
        try:
            cli = sc.ServeClient(daemon.port)
            try:
                while not stop_aux.is_set():
                    r = cli.stats()
                    if not r.get("ok"):
                        errors.append(f"stats: {r}")
                        return
                    stats_calls[0] += 1
            finally:
                cli.close()
        except Exception as e:  # check: no-retry — the verdict names it
            errors.append(f"stats worker: {type(e).__name__}: {e}")

    def scrape_worker():
        try:
            while not stop_aux.is_set():
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{http_port}/metrics",
                        timeout=10) as r:
                    text = r.read().decode()
                if not text.rstrip().endswith("# EOF"):
                    errors.append("scrape: truncated exposition")
                    return
                scrapes[0] += 1
        except Exception as e:  # check: no-retry — the verdict names it
            errors.append(f"scrape worker: {type(e).__name__}: {e}")

    workers = [threading.Thread(target=query_worker, args=(w,),
                                daemon=True)
               for w in range(N_QUERY_WORKERS)]
    workers.append(threading.Thread(target=ingest_worker, daemon=True))
    aux = [threading.Thread(target=stats_worker, daemon=True),
           threading.Thread(target=scrape_worker, daemon=True)]
    t0 = time.perf_counter()
    for t in workers + aux:
        t.start()
    for t in workers:
        t.join(timeout=600)
    stop_aux.set()
    for t in aux:
        t.join(timeout=60)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if any(t.is_alive() for t in workers + aux):
        fail("stress worker hung")
    if errors:
        fail(f"{len(errors)} stress error(s): {errors[0]}")
    say(f"stress OK: {len(reqs)} queries x {N_QUERY_WORKERS} workers, "
        f"{N_INGESTS} concurrent ingests, {stats_calls[0]} stats ops, "
        f"{scrapes[0]} scrapes in {wall_ms:.0f} ms")

    # byte-identity of every stressed response vs the golden oracle
    got = [results.get(i) for i in range(len(reqs))]
    if any(g is None for g in got):
        fail("a stressed request produced no checksums")
    if sc.contract_text(got) != sc.contract_text(golden):
        bad = [i for i, (g, w) in enumerate(zip(got, golden)) if g != w]
        fail(f"stressed responses diverge from the golden oracle at "
             f"request(s) {bad[:5]}")
    say("byte-identity OK: every stressed response equals the golden "
        "oracle")

    # the scheduled squeeze sheds the sacrificial request FIRST: it is
    # eligible hit len(reqs)+1 at serve.admit, so it must run before
    # the grown-corpus replay adds admission hits of its own
    cli = sc.ServeClient(daemon.port)
    q = sc.materialize_queries({"nq": 2, "seed": 991}, HEADER)
    r = cli.query(q, k=3, req_id="squeezed")
    if r.get("ok") or "injected_squeeze" not in r.get("error", ""):
        fail(f"squeezed request was not shed: {r}")
    r = cli.query(q, k=3, req_id="after-squeeze")
    if not r.get("ok"):
        fail(f"request after the squeeze failed: {r}")
    say("squeeze OK: injected admission oom shed exactly one request")

    # the ingests actually landed: grown-corpus replay vs its own oracle
    grown_rows = N_INGESTS * INGEST_ROWS
    st = cli.stats()["stats"]
    if st["engine"]["corpus_rows"] != CORPUS["num_data"] + grown_rows:
        fail(f"expected {CORPUS['num_data'] + grown_rows} corpus rows "
             f"after ingest, daemon reports "
             f"{st['engine']['corpus_rows']}")
    far = _far_rows()
    grown = KNNInput(
        Params(CORPUS["num_data"] + grown_rows, 0, CORPUS["num_attrs"]),
        np.concatenate([corpus.labels] + [lab.astype(np.int32)
                                          for lab, _ in far]),
        np.vstack([corpus.data_attrs] + [rows for _, rows in far]),
        np.zeros(0, np.int32), np.zeros((0, CORPUS["num_attrs"])))
    post = sc.replay(daemon.port, HEADER, reqs[:4], connections=2)
    if [r.get("checksums") for r in post] != \
            sc.golden_reference(grown, HEADER, reqs[:4]):
        fail("post-stress replay diverges from the grown-corpus oracle")
    say("ingest parity OK: grown-corpus replay matches its own oracle")
    cli.close()

    daemon.drain()
    rs_inject.uninstall()
    # Every kernel launch of the daemon's life (warm-up included).
    launches = {k: v - launches0.get(k, 0)
                for k, v in kernels.LAUNCHES.items()
                if v - launches0.get(k, 0)}
    with open(telem_path) as f:
        problems = validate_openmetrics(f.read())
    if problems:
        fail(f"final telemetry snapshot invalid: {problems[:3]}")

    rep = racecheck.report()
    report_path = os.path.join(out, "RACE_STRESS.json")
    doc = {
        "race_stress_schema": 1, "device": args.device,
        "pallas": args.pallas, "select": select,
        "requests": len(reqs), "ingests": N_INGESTS,
        "stats_ops": stats_calls[0], "scrapes": scrapes[0],
        "wall_ms": round(wall_ms, 1), "engine_launches": launches,
        "racecheck": rep,
    }
    with open(report_path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    if not rep["ok"]:
        fail(f"sanitizer caught {len(rep['violations'])} violation(s) "
             f"in the real system: {rep['violations'][:3]} "
             f"(full report: {report_path})")
    say(f"sanitizer clean: {rep['locks_created']} locks tracked, "
        f"{rep['edges']} acquisition-order edges, 0 violations "
        f"({report_path})")
    if args.json:
        json.dump({"ok": True, **doc}, sys.stdout, indent=2)
        sys.stdout.write("\n")
    say("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
