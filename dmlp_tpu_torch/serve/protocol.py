"""The daemon's wire protocol: newline-delimited JSON over TCP — port of
``dmlp_tpu/serve/protocol.py``.

One request object per line, one response object per line, strictly in
per-connection order (concurrency comes from multiple connections —
the micro-batcher coalesces across all of them). Shapes:

- ``{"op": "query", "id"?, "k": K | "ks": [...], "queries": [[...]]}``
  -> ``{"id", "ok": true, "labels": [...], "checksums": [...],
  "latency_ms"}`` (+ ``"neighbors"``/``"dists"`` with ``"debug": true``).
  ``checksums`` are the engines' contract FNV-1a values — the replay
  client reassembles the exact contract stdout (``Query N checksum:
  C``) and byte-compares it against the golden oracle.
- ``{"op": "ingest", "labels": [...], "rows": [[...]], "start"?: S}``
  -> ``{"ok": true, "corpus_rows": N}``; capacity overflow is a clean
  ``ok: false`` with the reason. ``start`` makes the write an
  IDEMPOTENT row-write keyed by global row id (``start <= corpus
  rows``; re-delivering the same rows at the same positions is a
  no-op) — the fleet's consistency repair and re-shard replay speak
  this form; plain appends omit it.
- ``{"op": "corpus", "start": S, "count": C}`` -> ``{"ok": true,
  "start": S, "labels": [...], "rows": [[...]], "corpus_rows": N,
  "checksum": H, "epoch": E}`` — the consistency/replay read side:
  host rows ``[S, S+C)`` (clamped; ``count`` capped at
  ``CORPUS_FETCH_MAX`` per line) plus the live corpus signature.
  ``count: 0`` is the cheap signature probe.
- ``{"op": "stats"}`` -> engine/admission/registry snapshot (now
  including the ``corpus`` signature block the fleet prober compares
  across replicas).
- ``{"op": "drain"}`` -> acknowledges and initiates the graceful
  drain (the in-band SIGTERM).

Rejections and errors are ``{"ok": false, "error": "..."}`` — the
connection stays usable.

Request ids: every request may carry ``"rid"`` (an opaque string the
client stamps) and ``"trace"`` (client-side context). A non-empty ``rid``
is echoed back in the response; responses without one keep the exact
key set. While the daemon traces, the rid tags its request-phase spans.

The wire format is the reference's, byte for byte: the same request line
gives the same response object through both packages, ``latency_ms``
aside.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from dmlp_tpu_torch.serve.batching import Request

#: protocol schema version, echoed in hello/stats
PROTOCOL_VERSION = 1

#: request-line size cap. The daemon's connection handler enforces it
#: AT THE READ (``readline(cap + 1)``) so an oversized line never
#: buffers past the cap; the re-check in parse_request covers
#: non-socket callers.
MAX_LINE_BYTES = 64 << 20

#: per-request row cap of the ``corpus`` read op (bounds one response
#: line; replay loops page through larger ranges)
CORPUS_FETCH_MAX = 65536


class ProtocolError(ValueError):
    """A malformed request line (the response names the defect)."""


def _is_int(v) -> bool:
    """A real JSON integer — bool is an int subclass in Python, and
    ``{"k": true}`` silently served as k=1 is not the ProtocolError
    the parser promises for malformed requests."""
    return isinstance(v, int) and not isinstance(v, bool)


def parse_request(line: str, num_attrs: int) -> Request:
    """One wire line -> a validated :class:`Request` (op "query" |
    "ingest") or a control dict for "stats"/"drain". Raises
    :class:`ProtocolError` with a client-presentable message."""
    if len(line) > MAX_LINE_BYTES:
        raise ProtocolError("request line exceeds the size cap")
    try:
        obj = json.loads(line)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"bad JSON: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError("request must be a JSON object")
    op = obj.get("op", "query")
    if op in ("stats", "drain"):
        return obj
    req_id = str(obj.get("id", ""))
    rid = str(obj.get("rid", "") or "")
    if op == "query":
        queries = obj.get("queries")
        if not isinstance(queries, list) or not queries:
            raise ProtocolError("query op needs a non-empty 'queries' "
                                "list of attribute rows")
        try:
            q = np.asarray(queries, np.float64)
        except (TypeError, ValueError):
            raise ProtocolError("'queries' rows must be numeric and "
                                "rectangular") from None
        if q.ndim != 2 or q.shape[1] != num_attrs:
            raise ProtocolError(
                f"'queries' must be (nq, {num_attrs}), got {q.shape}")
        ks = obj.get("ks")
        if ks is None:
            k = obj.get("k")
            if not _is_int(k) or k < 1:
                raise ProtocolError("need 'k' (positive int) or 'ks'")
            ks_arr = np.full(len(q), k, np.int32)
        else:
            if (not isinstance(ks, list) or len(ks) != len(q)
                    or not all(_is_int(v) and v >= 1 for v in ks)):
                raise ProtocolError("'ks' must list one positive int "
                                    "per query row")
            ks_arr = np.asarray(ks, np.int32)
        return Request(kind="query", req_id=req_id, rid=rid,
                       query_attrs=q, ks=ks_arr,
                       debug=bool(obj.get("debug")))
    if op == "ingest":
        rows = obj.get("rows")
        labels = obj.get("labels")
        if not isinstance(rows, list) or not rows:
            raise ProtocolError("ingest op needs a non-empty 'rows' list")
        try:
            attrs = np.asarray(rows, np.float64)
        except (TypeError, ValueError):
            raise ProtocolError("'rows' must be numeric and "
                                "rectangular") from None
        if attrs.ndim != 2 or attrs.shape[1] != num_attrs:
            raise ProtocolError(
                f"'rows' must be (m, {num_attrs}), got {attrs.shape}")
        if (not isinstance(labels, list) or len(labels) != len(rows)
                or not all(_is_int(v) for v in labels)):
            raise ProtocolError("'labels' must list one int per row")
        start = obj.get("start")
        if start is not None and (not _is_int(start) or start < 0):
            raise ProtocolError("'start' must be a non-negative int "
                                "(the global row id of the first row)")
        return Request(kind="ingest", req_id=req_id, rid=rid,
                       labels=np.asarray(labels, np.int32), attrs=attrs,
                       start=start)
    if op == "corpus":
        start = obj.get("start", 0)
        count = obj.get("count", 0)
        if not _is_int(start) or start < 0:
            raise ProtocolError("corpus op 'start' must be a "
                                "non-negative int")
        if not _is_int(count) or count < 0:
            raise ProtocolError("corpus op 'count' must be a "
                                "non-negative int")
        return Request(kind="corpus", req_id=req_id, rid=rid,
                       start=start, count=min(count, CORPUS_FETCH_MAX))
    raise ProtocolError(f"unknown op {op!r}")


def _rid_echo(req: Request, out: Dict[str, Any]) -> Dict[str, Any]:
    """Echo a non-empty rid; rid-less responses keep the exact key
    set."""
    if req.rid:
        out["rid"] = req.rid
    return out


def query_response(req: Request, debug: bool = False) -> Dict[str, Any]:
    """The completed query Request -> its wire response."""
    if req.error is not None:
        return _rid_echo(req, {"id": req.req_id, "ok": False,
                               "error": req.error})
    out: Dict[str, Any] = {
        "id": req.req_id, "ok": True,
        "labels": [int(r.predicted_label) for r in req.results],
        "checksums": [int(r.checksum()) for r in req.results],
        "latency_ms": round(req.latency_ms, 3),
    }
    if debug or req.debug:
        out["neighbors"] = [[int(i) for i in r.neighbor_ids]
                            for r in req.results]
        out["dists"] = [[float(d) for d in r.neighbor_dists]
                        for r in req.results]
    return _rid_echo(req, out)


def ingest_response(req: Request) -> Dict[str, Any]:
    if req.error is not None:
        return _rid_echo(req, {"id": req.req_id, "ok": False,
                               "error": req.error})
    return _rid_echo(req, {"id": req.req_id, "ok": True,
                           "corpus_rows": int(req.corpus_rows)})


def corpus_response(req: Request) -> Dict[str, Any]:
    """The completed ``corpus`` read -> its wire response (payload is
    assembled on the batcher thread, so the rows and the signature are
    one consistent snapshot — never torn by a concurrent ingest)."""
    if req.error is not None:
        return _rid_echo(req, {"id": req.req_id, "ok": False,
                               "error": req.error})
    return _rid_echo(req, {"id": req.req_id, "ok": True,
                           **(req.payload or {})})


def encode(obj: Dict[str, Any]) -> bytes:
    return (json.dumps(obj, separators=(",", ":"),
                       sort_keys=True) + "\n").encode()
