"""Multi-process runtime: process bring-up, the local launcher, and the
per-rank sharded file feed — port of ``dmlp_tpu/parallel/distributed.py``.

The reference's multi-node story is ``mpirun`` starting ranks that each
own one cell of the 2D grid, with rank 0 reading the whole input and
scattering it. Here:

- :func:`initialize` is the ``MPI_Init`` analog: ``torch.distributed.
  init_process_group`` over TCP, from explicit coordinator / process count
  / process id, or from torchrun's environment (``auto``). Every group gets
  a finite timeout (``timeout_s``, default 300 s): a hung collective
  fails. The backend is the caller's choice: NCCL by default on
  the card, gloo on the CPU, and gloo on the card only when asked — NCCL
  takes one card per rank, so more ranks than cards under NCCL raise
  before the group starts, naming the flag that picks gloo.
- :func:`local_cluster` is the ``mpirun -np`` analog: this process is rank
  0 and starts the other ranks on this host.
- :func:`shard_bounds` and :func:`read_data_shard` let every rank parse
  only its own balanced slice of the input file (one newline scan, then
  the parser on the local byte range), preserving global ids by line
  order; the reference's global-array constructors have no counterpart here,
  because each rank already holds its own shard tensor.
- :func:`distributed_contract_run` is ``mpirun ./engine < input`` end to
  end: sharded read, per-shard top-k, the float64 rescore on the rank that
  owns the shard, a host all-gather of the small candidate lists, and rank
  0 printing the checksums and ``Time taken``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import subprocess
import sys
from typing import Optional, Sequence, Tuple

import numpy as np

from dmlp_tpu_torch.engine.finalize import boundary_hazard, staging_eps
from dmlp_tpu_torch.parallel.mesh import mesh_coords
from dmlp_tpu_torch.resilience import inject as rs_inject
from dmlp_tpu_torch.resilience import retry as rs_retry

# Every process group's timeout: a hung collective fails, never stalls.
DEFAULT_TIMEOUT_S = 300.0


def free_port() -> int:
    """A free TCP port on localhost (probe-then-rebind: a port lost in
    between surfaces as a failed rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def resolve_backend(device: str, backend: Optional[str],
                    local_ranks: int = 1) -> str:
    """The collective backend: ``backend`` when given, else "nccl" for
    ``device="cuda"`` and "gloo" for "cpu". NCCL needs the card and one
    card per rank on a host: ``local_ranks`` above the visible card count
    raises here, before any group starts."""
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (want nccl or gloo)")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend runs on device 'cuda' only")
        import torch
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise RuntimeError(
                f"nccl needs one card per rank: {local_ranks} ranks on "
                f"this host, {cards} card(s) visible; pass --backend gloo "
                "to run the ranks on shared cards with gloo collectives")
    return backend


def rank_device(device: str, local_rank: Optional[int] = None):
    """This rank's compute device: the CPU, or ``cuda:(local_rank %
    device_count)`` (``$LOCAL_RANK``, else the global rank), made current.
    Raises when "cuda" is asked for and no card is visible."""
    import torch
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run the ranks on the CPU")
    if local_rank is None:
        env = os.environ.get("LOCAL_RANK")
        if env is not None:
            local_rank = int(env)
        else:
            import torch.distributed as dist
            local_rank = dist.get_rank() if dist.is_initialized() else 0
    idx = local_rank % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def initialize(*, device: str = "cuda", backend: Optional[str] = None,
               coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, auto: bool = False,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Bring up the process group (the ``MPI_Init`` analog). Returns True
    when this call created it (the caller then owns :func:`shutdown`),
    False when one already exists.

    Explicit form: ``coordinator`` ("HOST:PORT" of rank 0), the process
    count and this process's id, as ``mpirun`` passes rank and size; a
    single process needs none of them. ``auto=True`` reads torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    if auto:
        env = os.environ
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
        coordinator = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                       f"{env['MASTER_PORT']}")
    num_processes = num_processes or 1
    process_id = process_id or 0
    if coordinator is None:
        if num_processes > 1:
            raise ValueError(f"{num_processes} processes need a coordinator "
                             "(HOST:PORT of process 0)")
        coordinator = f"localhost:{free_port()}"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    backend = resolve_backend(device, backend, local)
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", process_id)))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return True


def shutdown(barrier: bool = True) -> None:
    """Destroy the process group, if there is one (``MPI_Finalize``).
    With ``barrier`` every rank first waits for the others: a rank that
    exits while its peers still hold their gloo connections can abort them
    at their own exit."""
    import torch.distributed as dist
    if dist.is_initialized():
        if barrier:
            dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(**kwargs):
    """:func:`initialize` for the body, and :func:`shutdown` after it when
    this call created the group (without the barrier when the body
    raised)."""
    created = initialize(**kwargs)
    ok = False
    try:
        yield
        ok = True
    finally:
        if created:
            shutdown(barrier=ok)


@contextlib.contextmanager
def local_cluster(world: int, argv: Sequence[str], *, device: str,
                  backend: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S):
    """This process as rank 0 of a ``world``-rank cluster on this host (the
    ``mpirun -np`` analog): ranks 1 .. world - 1 start as ``python argv``
    with torchrun's environment (stdin and stdout closed: rank 0 alone
    reads and prints), then the group is initialized here as rank 0. On
    exit the group is destroyed and the ranks reaped; a rank that exited
    non-zero raises. If the body raised, the other ranks are killed."""
    backend = resolve_backend(device, backend, world)
    port = free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    if device == "cpu":
        # The ranks share this host's cores.
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // world))
    procs = []
    ok = False
    try:
        for r in range(1, world):
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
        initialize(device=device, backend=backend,
                   coordinator=f"localhost:{port}", num_processes=world,
                   process_id=0, timeout_s=timeout_s)
        yield
        ok = True
    finally:
        shutdown(barrier=ok)
        bad = []
        for r, p in enumerate(procs, start=1):
            if not ok and p.poll() is None:
                p.kill()
            try:
                rc = p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            if rc != 0:
                bad.append((r, rc))
        if ok and bad:
            raise RuntimeError(f"rank(s) exited non-zero: {bad}")


# -- the per-rank sharded feed -----------------------------------------------

def shard_bounds(n: int, num_shards: int, shard: int) -> Tuple[int, int]:
    """[start, stop) of ``shard``'s block of a length-n axis (the
    remainder spread over the leading shards — balanced, unlike the
    reference's all-remainder-to-rank-0 choice)."""
    base, rem = divmod(n, num_shards)
    start = shard * base + min(shard, rem)
    return start, start + base + (1 if shard < rem else 0)


def line_offsets(data) -> np.ndarray:
    """Byte offset of every line start (one vectorized newline scan)."""
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == ord("\n"))
    return np.concatenate([[0], nl + 1]).astype(np.int64)


def read_row_range(path: str, start: int, stop: int):
    """Parse data rows [start, stop) plus every query line of the input
    file: one newline scan over an mmap, then the parser (native past its
    threshold) on just the local byte range. Returns (params, labels,
    attrs, ks, query_attrs); the queries are replicated, since every rank
    needs them to build its query shard and to finalize."""
    import io
    import mmap

    from dmlp_tpu_torch.io.grammar import parse_input, parse_params

    with open(path, "rb") as f:
        raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    try:
        offs = line_offsets(raw)
        params = parse_params(raw[offs[0]:offs[1]].decode("ascii"))
        nd = params.num_data
        stop = min(stop, nd)
        start = min(start, stop)
        local = (f"{stop - start} {params.num_queries} {params.num_attrs}\n"
                 .encode("ascii")
                 + raw[offs[1 + start]:offs[1 + stop]]
                 + raw[offs[1 + nd]:])
    finally:
        raw.close()
    sub = parse_input(io.BytesIO(local))
    return params, sub.labels, sub.data_attrs, sub.ks, sub.query_attrs


def read_data_shard(path: str, num_shards: int, shard: int):
    """Parse only this shard's (balanced, :func:`shard_bounds`) data lines
    plus all query lines. Returns (params, labels, attrs, start, ks,
    query_attrs)."""
    from dmlp_tpu_torch.io.grammar import parse_params
    with open(path, "rb") as f:
        nd = parse_params(f.readline().decode("ascii")).num_data
    start, stop = shard_bounds(nd, num_shards, shard)
    params, labels, attrs, ks, q_attrs = read_row_range(path, start, stop)
    return params, labels, attrs, start, ks, q_attrs


def padded_shard(labels: np.ndarray, attrs: np.ndarray, start: int,
                 uniform_rows: int):
    """One rank's data rows padded to ``uniform_rows`` with sentinel rows
    (label = id = -1). Global ids come from ``start``."""
    n, na = attrs.shape
    if n > uniform_rows:
        raise ValueError(f"{n} rows do not fit a {uniform_rows}-row shard")
    out_attrs = np.zeros((uniform_rows, na), np.float32)
    out_attrs[:n] = attrs
    out_labels = np.full(uniform_rows, -1, np.int32)
    out_labels[:n] = labels
    out_ids = np.full(uniform_rows, -1, np.int32)
    out_ids[:n] = np.arange(start, start + n, dtype=np.int32)
    return out_attrs, out_labels, out_ids


def plan_shapes(engine, n: int, nq: int, qgran: Optional[int] = None):
    """(padded rows over all shards, rows per shard, padded queries over
    all columns) of the per-rank feed — the same on every rank (a function
    of the header and the engine's configuration and mesh). Shards pad to
    whole extraction blocks and query shards to whole query tiles where
    the per-shard solve will pick the extraction kernel, else to the
    streaming select's granule and 8; ``qgran`` overrides the query
    granule (the router's outlier segment)."""
    from dmlp_tpu_torch.engine.single import round_up

    cfg = engine.config
    r, c = engine.mesh.shape
    rows_est = round_up(max(-(-n // r), 1), 8)
    if cfg.data_block is None and cfg.resolve_select(rows_est) == "extract":
        from dmlp_tpu_torch.ops.extract import QUERY_TILE
        granule, q_g = cfg.resolve_granule("extract"), QUERY_TILE
    else:
        granule = cfg.resolve_granule(cfg.resolve_streaming_select(rows_est))
        q_g = 8
    shard_rows = round_up(max(-(-n // r), 1), granule)
    qpad = c * round_up(max(-(-nq // c), 1), qgran or q_g)
    return r * shard_rows, shard_rows, qpad


def read_local_inputs(path: str, engine) -> dict:
    """This rank's sharded file read (host parse only, no device work):
    data rows :func:`shard_bounds` (n, R, r) of its mesh row, every query
    line. Split from the solve so that the contract timer starts after
    parsing, as the reference's does."""
    r, _c = engine.mesh.shape
    rr, _cc = mesh_coords(engine.mesh)
    params, labels, attrs, start, ks, q_attrs = read_data_shard(path, r, rr)
    return {"params": params, "ks": ks, "labels": labels, "attrs": attrs,
            "start": start, "query_attrs": q_attrs}


def _exact_shard_topk(q64: np.ndarray, d64: np.ndarray, labels: np.ndarray,
                      ids: np.ndarray, k: int):
    """Exact float64 top-k of one query over one shard by the selection
    order (dist asc, id desc): the per-query repair of a shard's f32
    tie-boundary hazard, from the owning rank's rows only."""
    diff = d64 - q64[None, :]
    dist = np.einsum("na,na->n", diff, diff)
    order = np.lexsort((-ids, dist))[:k]
    out_d = np.full(k, np.inf)
    out_l = np.full(k, -1, np.int32)
    out_i = np.full(k, -1, np.int32)
    m = len(order)
    out_d[:m] = dist[order]
    out_l[:m] = labels[order]
    out_i[:m] = ids[order]
    return out_d, out_l, out_i


def rescore_local_shards(top, local: dict, ks: np.ndarray, q0: int,
                         staging: str = "float32"):
    """The float64 rescore of this rank's cell: its (qloc, K) selection-
    ordered candidate lists ``top`` (numpy dists, labels, ids) over its own
    rows ``local`` ("attrs", "labels", "start") for the queries ``q0`` ..
    ``q0 + qloc`` of ``local["query_attrs"]``. A query whose f32 boundary
    may have truncated a tie group (``engine.finalize.boundary_hazard``
    with the staging eps, the shard's own largest row norm bounding the
    missed point's) is solved exactly over the shard instead. Returns
    (float64 dists, labels, ids), each (qloc, K), and the number of
    queries so repaired."""
    f32, labels, ids = (np.array(a) for a in top)
    qloc, kcap = ids.shape
    attrs64 = np.asarray(local["attrs"], np.float64)
    labels_loc = np.asarray(local["labels"])
    offset = local["start"]
    q64 = np.asarray(local["query_attrs"], np.float64)
    nq = q64.shape[0]
    nreal = attrs64.shape[0]
    if nreal == 0 or nq == 0:
        # An all-padding shard or no queries: only sentinels.
        return (np.full((qloc, kcap), np.inf), np.full_like(labels, -1),
                np.full_like(ids, -1)), 0
    qrows = np.arange(q0, q0 + qloc)
    safe = np.clip(ids - offset, 0, nreal - 1)
    qv = q64[np.minimum(qrows, nq - 1)]
    diff = attrs64[safe] - qv[:, None, :]
    d64 = np.einsum("qka,qka->qk", diff, diff)
    d64[ids < 0] = np.inf

    ks_blk = np.minimum(np.asarray(ks)[np.minimum(qrows, nq - 1)], kcap)
    kth = f32[np.arange(qloc), np.clip(ks_blk - 1, 0, kcap - 1)]
    qn = np.einsum("qa,qa->q", qv, qv)
    dn_max = float(np.einsum("na,na->n", attrs64, attrs64).max())
    last = np.asarray(f32[:, -1], np.float64)
    eps = staging_eps(last, qn, dn_max, staging, attrs64.shape[1])
    hazard = boundary_hazard(kth, last, eps) & (qrows < nq) \
        & (kcap < nreal)
    if hazard.any():
        base_ids = np.arange(offset, offset + nreal, dtype=np.int32)
        for j in np.nonzero(hazard)[0]:
            d64[j], labels[j], ids[j] = _exact_shard_topk(
                q64[qrows[j]], attrs64, labels_loc, base_ids, kcap)
    return (d64, labels, ids), int(hazard.sum())


def distributed_contract_run(path: str, engine, out=None, err=None,
                             warmup: bool = False):
    """The end-to-end multi-process contract run — ``mpirun ./engine <
    input``. Per rank: sharded file read (no rank-0 ingest) -> per-shard
    top-k on the card (no f32 cross-shard merge) -> the float64 rescore
    and tie repair on the rank that owns the shard -> a host all-gather of
    the small candidate lists -> every rank merges and finalizes; rank 0
    prints the checksums in query order and ``Time taken``. Sets
    ``engine.last_repairs`` to the queries this rank rescored exactly in
    the timed solve. Returns the results (on every rank)."""
    import time

    import torch.distributed as dist

    from dmlp_tpu_torch.engine.finalize import finalize_host
    from dmlp_tpu_torch.engine.single import hetk_split, round_up
    from dmlp_tpu_torch.io.report import format_results
    from dmlp_tpu_torch.ops.extract import QUERY_TILE
    from dmlp_tpu_torch.parallel.collectives import all_gather_arrays

    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    rank = dist.get_rank()
    r, c = engine.mesh.shape
    rr, cc = mesh_coords(engine.mesh)
    # Parsing stays outside the timed region, as in the reference.
    local = read_local_inputs(path, engine)
    params, ks = local["params"], local["ks"]
    n, nq = params.num_data, params.num_queries
    _, shard_rows, _ = plan_shapes(engine, n, nq)
    p_attrs, p_labels, p_ids = padded_shard(local["labels"], local["attrs"],
                                            local["start"], shard_rows)

    def solve_segment(idx, qgran):
        """Per-shard solve, float64 rescore, all-gather and finalize of
        one query segment (every query when ``idx`` is None)."""
        q64 = local["query_attrs"] if idx is None \
            else local["query_attrs"][idx]
        ks_seg = ks if idx is None else ks[idx]
        nqs = len(ks_seg)
        qpad = plan_shapes(engine, n, nqs, qgran)[2]
        qloc = qpad // c
        q_local = np.zeros((qloc, params.num_attrs), np.float32)
        src = q64[cc * qloc:min((cc + 1) * qloc, nqs)]
        q_local[:len(src)] = src
        kmax = int(ks_seg.max()) if nqs else 1

        def _solve_op():
            rs_inject.fire("dist.rank_solve", rank=rank)
            return engine.solve_local_shards(p_attrs, p_labels, p_ids,
                                             q_local, kmax)

        top = rs_retry.call_with_retry(_solve_op, "dist.rank_solve")
        cell, repaired = rescore_local_shards(
            top, dict(local, query_attrs=q64), ks_seg, cc * qloc,
            staging=engine._staging)
        engine.last_repairs += repaired

        def _gather_op():
            rs_inject.fire("dist.allgather", rank=rank)
            return all_gather_arrays(cell)

        cells = rs_retry.call_with_retry(_gather_op, "dist.allgather")
        # [rank] -> (qpad, R * K): per query column, every data shard's
        # candidates in shard order (rank = r * C + c).
        cols = [[np.concatenate([cells[i * c + j][a] for i in range(r)], 1)
                 for j in range(c)] for a in range(3)]
        d, lab, ids = (np.concatenate(col, 0)[:nqs] for col in cols)
        return finalize_host(d, lab, ids, ks_seg, q64, None, exact=False,
                             query_ids=idx)

    def solve():
        engine.last_repairs = 0
        split = hetk_split(engine.config, engine._staging, ks, n,
                           round_up(max(-(-n // r), 1), 8))
        if split is None:
            return solve_segment(None, None)
        # The router, multi-process form: the bulk on the per-shard
        # extraction kernel, the wide-k outliers on the streaming select.
        merged = [None] * nq
        for idx, qgran in zip(split, (QUERY_TILE, 8)):
            for res in solve_segment(idx, qgran):
                merged[res.query_id] = res
        return merged

    if warmup:
        solve()
    dist.barrier()
    t0 = time.perf_counter()
    results = solve()
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    if rank == 0:
        out.write(format_results(results, debug=engine.config.debug))
        err.write(f"Time taken: {int(round(elapsed_ms))} ms\n")
    return results
