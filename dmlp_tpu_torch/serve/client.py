"""Replay client and recorded query-trace format — port of
``dmlp_tpu/serve/client.py``.

A serve trace is a JSONL file: one header line, then one request line
per wire request. Query attribute values are NOT embedded — each line
carries a seed, and both the client and the verifier materialize the
same rows from it (``numpy.random.default_rng``), so a committed trace
stays a few hundred bytes while the replay is bit-deterministic::

    {"serve_trace_schema": 1,
     "corpus": {"num_data": ..., "num_queries": ..., "num_attrs": ...,
                "min_attr": ..., "max_attr": ..., "min_k": ...,
                "max_k": ..., "num_labels": ..., "seed": ...},
     "note": "..."}
    {"t_ms": 0, "nq": 3, "k": 5, "seed": 101}
    {"t_ms": 4, "nq": 1, "ks": [9], "seed": 102}
    ...

The ``corpus`` block is :func:`dmlp_tpu_torch.io.datagen.generate_input_text`
kwargs — the daemon host regenerates the exact corpus file from it.
``replay`` drives the requests over N concurrent connections (the
micro-batcher coalesces across them) and returns per-request client
latencies + responses; :func:`golden_reference` computes the oracle
checksums every response must match byte-for-byte.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dmlp_tpu_torch.io.grammar import KNNInput, Params
from dmlp_tpu_torch.obs import trace as obs_trace

TRACE_SCHEMA = 1


class ServeClient:
    """One line-JSON connection to the daemon."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout_s: float = 600.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._rfile = self._sock.makefile("rb")

    def call(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        self._sock.sendall((json.dumps(obj) + "\n").encode())
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("daemon closed the connection")
        return json.loads(line)

    def query(self, queries, k=None, ks=None, req_id: str = "",
              debug: bool = False) -> Dict[str, Any]:
        obj: Dict[str, Any] = {"op": "query", "id": req_id,
                               "queries": np.asarray(queries).tolist()}
        if ks is not None:
            obj["ks"] = [int(v) for v in ks]
        else:
            obj["k"] = int(k)
        if debug:
            obj["debug"] = True
        return self.call(obj)

    def ingest(self, labels, rows) -> Dict[str, Any]:
        return self.call({"op": "ingest",
                          "labels": [int(v) for v in labels],
                          "rows": np.asarray(rows).tolist()})

    def stats(self) -> Dict[str, Any]:
        return self.call({"op": "stats"})

    def drain(self) -> Dict[str, Any]:
        return self.call({"op": "drain"})

    def close(self) -> None:
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass


# -- trace format --------------------------------------------------------------

def validate_trace(header: Dict[str, Any],
                   requests: List[Dict[str, Any]]) -> List[str]:
    """Structural validation of a loaded serve trace; returns a list
    of problems (empty = valid). Beyond the per-line field checks, the
    ``t_ms`` offsets must be non-negative and MONOTONIC non-decreasing
    in file order: paced open-loop replay fires requests at their
    offsets, and a trace whose offsets run backwards would silently
    reorder the offered-load schedule it claims to encode."""
    problems: List[str] = []
    if not isinstance(header, dict):
        return [f"header must be a JSON object, got "
                f"{type(header).__name__}"]
    if header.get("serve_trace_schema") != TRACE_SCHEMA:
        problems.append(
            f"header is not serve_trace_schema={TRACE_SCHEMA}")
    corpus = header.get("corpus")
    if not isinstance(corpus, dict):
        problems.append("header carries no corpus block")
    else:
        for key in ("num_data", "num_attrs", "min_attr", "max_attr",
                    "num_labels"):
            if key not in corpus:
                problems.append(f"corpus block missing {key!r}")
    prev_t = None
    for i, r in enumerate(requests, 1):
        if not isinstance(r, dict):
            problems.append(f"request line {i} must be a JSON object")
            continue
        if "nq" not in r or "seed" not in r \
                or ("k" not in r and "ks" not in r):
            problems.append(f"request line {i} needs nq, seed, and k|ks")
            continue
        if not isinstance(r["nq"], int) or r["nq"] < 1:
            problems.append(f"request line {i}: nq must be a positive "
                            "int")
        ks = r.get("ks", [r.get("k")])
        if not isinstance(ks, list):
            problems.append(f"request line {i}: 'ks' must be a list")
        elif not all(isinstance(v, int) and not isinstance(v, bool)
                     and v >= 1 for v in ks):
            problems.append(f"request line {i}: k|ks must be positive "
                            "ints")
        t = r.get("t_ms")
        if t is not None:
            if not isinstance(t, (int, float)) or t < 0:
                problems.append(f"request line {i}: t_ms must be a "
                                "non-negative number")
            elif prev_t is not None and t < prev_t:
                problems.append(
                    f"request line {i}: t_ms {t} < previous {prev_t} — "
                    "offsets must be monotonic non-decreasing")
            else:
                prev_t = t
    return problems


def load_trace(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if not lines or not isinstance(lines[0], dict) \
            or lines[0].get("serve_trace_schema") != TRACE_SCHEMA:
        raise ValueError(f"{path}: not a serve_trace_schema="
                         f"{TRACE_SCHEMA} file")
    header, reqs = lines[0], lines[1:]
    problems = validate_trace(header, reqs)
    if problems:
        raise ValueError(f"{path}: {problems[0]}"
                         + (f" (+{len(problems) - 1} more)"
                            if len(problems) > 1 else ""))
    return header, reqs


def materialize_queries(req: Dict[str, Any],
                        header: Dict[str, Any]) -> np.ndarray:
    """The request line's deterministic query rows (client and
    verifier call this with the same line -> same bytes)."""
    c = header["corpus"]
    rng = np.random.default_rng(int(req["seed"]))
    return rng.uniform(c["min_attr"], c["max_attr"],
                       (int(req["nq"]), int(c["num_attrs"])))


def request_ks(req: Dict[str, Any]) -> np.ndarray:
    if "ks" in req:
        return np.asarray(req["ks"], np.int32)
    return np.full(int(req["nq"]), int(req["k"]), np.int32)


def corpus_text(header: Dict[str, Any]) -> str:
    """Regenerate the trace's corpus file content (the daemon input)."""
    from dmlp_tpu_torch.io.datagen import generate_input_text
    c = dict(header["corpus"])
    return generate_input_text(
        c["num_data"], c.get("num_queries", 8), c["num_attrs"],
        c["min_attr"], c["max_attr"], c.get("min_k", 1),
        c.get("max_k", 8), c["num_labels"], seed=c.get("seed", 42))


# -- replay --------------------------------------------------------------------

def replay(port: int, header: Dict[str, Any],
           requests: List[Dict[str, Any]], connections: int = 4,
           pace: bool = False) -> List[Dict[str, Any]]:
    """Replay the trace over ``connections`` concurrent connections
    (round-robin assignment, per-connection order preserved). Returns
    one dict per request IN TRACE ORDER: the wire response plus the
    client-measured ``client_ms`` latency. ``pace=True`` honors the
    trace's ``t_ms`` offsets; the default replays as fast as the
    daemon admits (the sustained-throughput measurement)."""
    out: List[Optional[Dict[str, Any]]] = [None] * len(requests)
    lanes: List[List[int]] = [[] for _ in range(max(connections, 1))]
    for i in range(len(requests)):
        lanes[i % len(lanes)].append(i)
    t0 = time.monotonic()

    def lane_worker(lane: List[int]) -> None:
        cli = ServeClient(port)
        try:
            for i in lane:
                req = requests[i]
                if pace and "t_ms" in req:
                    delay = req["t_ms"] / 1e3 - (time.monotonic() - t0)
                    if delay > 0:
                        time.sleep(delay)
                q = materialize_queries(req, header)
                ks = request_ks(req)
                t = time.perf_counter()
                resp = cli.query(q, ks=[int(v) for v in ks],
                                 req_id=str(i))
                resp["client_ms"] = round(
                    (time.perf_counter() - t) * 1e3, 3)
                out[i] = resp
        finally:
            cli.close()

    threads = [threading.Thread(target=lane_worker, args=(lane,),
                                daemon=True)
               for lane in lanes if lane]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [r if r is not None else {"ok": False, "error": "no response"}
            for r in out]


def replay_open_loop(port: int, header: Dict[str, Any],
                     requests: List[Dict[str, Any]], speed: float = 1.0,
                     host: str = "127.0.0.1",
                     timeout_s: float = 600.0,
                     rid_prefix: Optional[str] = None,
                     level: Optional[float] = None
                     ) -> List[Dict[str, Any]]:
    """Paced OPEN-LOOP replay: every request fires AT its trace
    ``t_ms`` offset (divided by ``speed`` — ``speed=2`` offers 2× the
    trace's load) on its own connection, REGARDLESS of completions —
    the closed-loop replay's lanes throttle the client to the daemon's
    pace, which silently caps offered load at achieved load and hides
    queueing. Here latency is measured from the SCHEDULED fire time,
    so queue delay (daemon-side and client-side dispatch lag, reported
    separately as ``lag_ms``) lands in ``client_ms`` — the number a
    p99-under-offered-load claim is actually about.

    Query payloads are pre-materialized and pre-encoded before the
    clock starts so the fire loop does no per-request numeric work.
    Returns one dict per request in trace order: the wire response (or
    an ``ok: false`` error for connection failures) plus ``client_ms``
    and ``lag_ms``.

    ``rid_prefix`` stamps every payload with ``rid = f"{rid_prefix}{i}"``
    and a ``trace`` context taken at fire time (the pre-encoded body is
    held open, so the fire loop appends the stamped tail without
    re-encoding the query rows); the daemon echoes the rid. While a trace
    sink is active, each response also records a ``client.request`` span
    (scheduled fire -> response parsed, i.e. exactly ``client_ms``),
    rid-tagged, with ``level`` attached when given."""
    traced = bool(rid_prefix)
    payloads = []
    for i, req in enumerate(requests):
        q = materialize_queries(req, header)
        ks = request_ks(req)
        obj = {"op": "query", "id": str(i), "queries": q.tolist(),
               "ks": [int(v) for v in ks]}
        if traced:
            obj["rid"] = f"{rid_prefix}{i}"
            # sans closing brace: the fire-time trace tail completes it
            payloads.append(json.dumps(obj)[:-1].encode())
        else:
            payloads.append((json.dumps(obj) + "\n").encode())
    out: List[Optional[Dict[str, Any]]] = [None] * len(requests)
    t0 = time.monotonic() + 0.05    # small runway so request 0 is paced
    t0_wall = time.time() + (t0 - time.monotonic())

    def worker(i: int) -> None:
        off_s = float(requests[i].get("t_ms", 0)) / 1e3 \
            / max(speed, 1e-9)
        sched = t0 + off_s
        delay = sched - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        lag_ms = (time.monotonic() - sched) * 1e3
        data = payloads[i]
        if traced:
            data += (',"trace":{"sched_unix_ms":%.3f,"lag_ms":%.3f}}\n'
                     % ((t0_wall + off_s) * 1e3, lag_ms)).encode()
        try:
            with socket.create_connection((host, port),
                                          timeout=timeout_s) as sock:
                sock.sendall(data)
                with sock.makefile("rb") as rf:
                    line = rf.readline()
            if not line:
                raise ConnectionError("daemon closed the connection")
            resp = json.loads(line)
        except (OSError, ValueError) as e:
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        resp["client_ms"] = round((time.monotonic() - sched) * 1e3, 3)
        resp["lag_ms"] = round(lag_ms, 3)
        if traced and obs_trace.sinks_active():
            # The scheduled fire instant in the tracer's perf_counter
            # domain: the span is client_ms, queue lag included.
            t1p = time.perf_counter()
            t0p = t1p - (time.monotonic() - sched)
            args = {"rid": f"{rid_prefix}{i}", "lag_ms": round(lag_ms, 3),
                    "ok": bool(resp.get("ok")),
                    "hops": int(resp.get("hops", 1))}
            if level is not None:
                args["level"] = level
            obs_trace.complete_at("client.request", t0p, t1p, **args)
        out[i] = resp

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [r if r is not None
            else {"ok": False, "error": "no response"} for r in out]


def warm_buckets_for_trace(requests: List[Dict[str, Any]],
                           batch_queries_cap: int
                           ) -> List[Tuple[int, int]]:
    """The (nq, k) warm set covering every shape bucket a replay of
    ``requests`` can hit: a coalesced micro-batch buckets by its
    COMBINED query count, so this is the cross product of qpad buckets
    up to the batch cap with the trace's k buckets. The compile-once
    assertion (counter flat between ready and drain) is only
    meaningful against this set — both the bench harness and the
    smoke derive it here."""
    from dmlp_tpu_torch.serve.engine import k_bucket, query_bucket
    kbs = sorted({k_bucket(int(max(r["ks"]) if "ks" in r else r["k"]))
                  for r in requests})
    qpads, qp = [], 8
    while qp <= query_bucket(batch_queries_cap):
        qpads.append(qp)
        qp *= 2
    return [(qp, kb) for qp in qpads for kb in kbs]


# -- daemon lifecycle (shared by the bench harness and the smoke) --------------

def await_ready(proc, ready_path: str, timeout_s: float = 300.0,
                errlog: str = "") -> Dict[str, Any]:
    """Block until the daemon subprocess writes its ready file; raise
    (naming the stderr log) if it dies or times out first."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(ready_path):
        if proc.poll() is not None:
            raise RuntimeError(
                "serve daemon died before ready"
                + (f"; see {errlog}" if errlog else ""))
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"serve daemon not ready after {timeout_s}s")
        time.sleep(0.05)
    with open(ready_path) as f:
        return json.load(f)


def sigterm_drain(proc, timeout_s: float = 60.0,
                  errlog: str = "") -> None:
    """SIGTERM the daemon and require the orderly-drain contract:
    exit code 0 within the timeout."""
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=timeout_s)
    if rc != 0:
        raise RuntimeError(
            f"serve daemon drain exited {rc}"
            + (f"; see {errlog}" if errlog else ""))


# -- verification --------------------------------------------------------------

def golden_reference(corpus: KNNInput, header: Dict[str, Any],
                     requests: List[Dict[str, Any]]
                     ) -> List[List[int]]:
    """Per-request golden checksum lists for the trace against
    ``corpus`` (``golden.fast``, the port's float64 oracle): the
    byte-identity oracle for every replay."""
    from dmlp_tpu_torch.golden.fast import knn_golden_fast
    out: List[List[int]] = []
    for req in requests:
        q = materialize_queries(req, header)
        ks = request_ks(req)
        inp = KNNInput(Params(corpus.params.num_data, len(ks),
                              corpus.params.num_attrs),
                       corpus.labels, corpus.data_attrs, ks, q)
        out.append([int(r.checksum()) for r in knn_golden_fast(inp)])
    return out


def contract_text(checksum_lists: List[List[int]]) -> str:
    """Flatten per-request checksums into the engines' contract stdout
    form (global query ids in trace order) — the thing two replay arms
    and the golden oracle must agree on byte-for-byte."""
    lines = []
    gid = 0
    for cs in checksum_lists:
        for c in cs:
            lines.append(f"Query {gid} checksum: {c}")
            gid += 1
    return "\n".join(lines) + ("\n" if lines else "")
