"""The open-loop load generator: a process of its own, started by the
``open_loop`` driver as ``python -m benchmark.loadgen``.

It reads one JSON line on standard input (the port, the mix, the seed,
the size of its connection pool), opens the pool, sends one warm-up request on every connection, all at once,
and prints ``{"ready": true, ...}``. Then it runs one window for each
JSON line ``{"rate_per_s": R, "seconds": S}`` it reads, until a line
``quit``: it draws the window's arrivals and query rows from the seed
and the window's index, encodes every request before the clock starts,
sends each at its due time on an idle connection (when none is idle, a
new one that the request's own task opens, counted), so it never waits on
a reply or a connect, and times each request
from its due time to its response. When every response is in, or
``drain_timeout_s`` after the last send, it prints one JSON line: per
request its due offset, latency (null when no response came), status,
label and checksum, and its own lateness.

It imports neither torch nor anything of the program.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from typing import Any, Dict, List

import numpy as np

from benchmark import datagen

HOST = "127.0.0.1"


def window_seed(seed: int, index: int) -> int:
    """The seed of a generator's ``index``-th window: the run's own seed
    for the first, so a cell's requests depend on ``--seed`` alone."""
    return int(seed) if index == 0 else datagen.stream_seed(seed,
                                                            f"w{index}")


def payloads(k: int, queries: np.ndarray, prefix: str) -> List[bytes]:
    return [(json.dumps({"op": "query", "id": f"{prefix}{i}", "k": k,
                         "queries": [row.tolist()]},
                        separators=(",", ":")) + "\n").encode()
            for i, row in enumerate(queries)]


async def _ask(conn, data: bytes) -> bytes:
    reader, writer = conn
    writer.write(data)
    await writer.drain()
    return await reader.readline()


async def open_pool(port: int, count: int) -> List:
    """``count`` connections, opened one after another, each confirmed by
    a round trip (the cheap corpus-signature read) before the next: the
    daemon accepts with a listen backlog of 5, and a connect beyond it
    stalls for a SYN retransmission of a second or more."""
    probe = (json.dumps({"op": "corpus", "start": 0, "count": 0}) +
             "\n").encode()
    pool = []
    for _ in range(count):
        conn = await asyncio.open_connection(HOST, port)
        await _ask(conn, probe)
        pool.append(conn)
    return pool


async def window(spec: Dict[str, Any], pool: List, rate_per_s: float,
                 seconds: float, index: int) -> Dict[str, Any]:
    loop = asyncio.get_running_loop()
    seed = window_seed(spec["seed"], index)
    offsets = datagen.arrival_offsets(rate_per_s, seconds, seed)
    bodies = payloads(int(spec["k"]), datagen.request_queries(
        spec["config"], seed, len(offsets)), f"q{index}.")
    n = len(bodies)
    lat: List[Any] = [None] * n
    status: List[Any] = [None] * n
    labels: List[Any] = [None] * n
    sums: List[Any] = [None] * n
    lag = np.zeros(n)
    opened = 0

    async def one(i: int, due: float, conn) -> None:
        try:
            if conn is None:
                conn = await asyncio.open_connection(HOST, int(spec["port"]))
            line = await _ask(conn, bodies[i])
            t = loop.time()
            resp = json.loads(line) if line else None
        except (OSError, ValueError):
            resp, t = None, loop.time()
        if resp is None:
            status[i] = "no response"
            return
        lat[i] = (t - due) * 1e3
        if resp.get("ok"):
            status[i] = "ok"
            labels[i] = resp.get("labels")
            sums[i] = resp.get("checksums")
        else:
            status[i] = str(resp.get("error", "error"))[:80]
        pool.append(conn)

    tasks = []
    t0 = loop.time() + 0.05
    for i in range(n):
        due = t0 + float(offsets[i])
        delay = due - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        conn = pool.pop() if pool else None
        opened += conn is None
        lag[i] = (loop.time() - due) * 1e3
        tasks.append(asyncio.ensure_future(one(i, due, conn)))
    _, pending = await asyncio.wait(tasks,
                                    timeout=float(spec["drain_timeout_s"]))
    for t in pending:
        t.cancel()
    return {"records": [[float(offsets[i]), lat[i], status[i], labels[i],
                         sums[i]] for i in range(n)],
            "lateness_ms": {"p50": float(np.percentile(lag, 50)),
                            "p99": float(np.percentile(lag, 99)),
                            "max": float(lag.max())},
            "connections_opened_in_window": opened,
            "unfinished": len(pending)}


async def drive(spec: Dict[str, Any]) -> None:
    loop = asyncio.get_running_loop()
    t = time.perf_counter()
    pool = await open_pool(int(spec["port"]), int(spec["connections"]))
    connect_s = time.perf_counter() - t
    warm = payloads(int(spec["k"]), datagen.request_queries(
        spec["config"], spec["seed"], len(pool), stream="warm_queries"),
        "w")
    t = time.perf_counter()
    # One warm-up request on every connection, all at once: the daemon
    # coalesces them as it will coalesce the window's requests.
    await asyncio.gather(*(_ask(c, b) for c, b in zip(pool, warm)))
    print(json.dumps({"ready": True, "connect_s": connect_s,
                      "warm_s": time.perf_counter() - t}), flush=True)
    index = 0
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line or line.strip() == "quit":
            break
        cmd = json.loads(line)
        out = await window(spec, pool, float(cmd["rate_per_s"]),
                           float(cmd["seconds"]), index)
        print(json.dumps(out), flush=True)
        index += 1
    for _, writer in pool:
        writer.close()


def main() -> int:
    asyncio.run(drive(json.loads(sys.stdin.readline())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
