"""What every chunked solve shares, below the engines that run one:
the one chunk loop (:func:`fold_chunks`), the router's outlier side step
on it (:class:`OutlierFold`), the chunk window (:class:`ChunkThrottle`),
the K1/K2 ``iters`` probe (:class:`MeasuredIters`), the staging and
readback chokepoints (:func:`stage`, :func:`put`, :func:`resilient_get`)
and the device-full epilogue (:func:`device_full_results`).
``engine.single`` stages each chunk from pinned host memory;
``engine.sharded`` folds the pieces of a rank's row shard, on the host or
held on the card."""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from dmlp_tpu_torch.check.sanitize import fenced, readback
from dmlp_tpu_torch.io.report import QueryResult
from dmlp_tpu_torch.obs import counters as obs_counters
from dmlp_tpu_torch.obs import telemetry
from dmlp_tpu_torch.obs import trace as obs_trace
from dmlp_tpu_torch.obs.trace import span as obs_span
from dmlp_tpu_torch.ops.topk import TopK, init_topk, make_block_step
from dmlp_tpu_torch.ops.vote import majority_vote, report_order
from dmlp_tpu_torch.parallel.collectives import move
from dmlp_tpu_torch.resilience import inject as rs_inject
from dmlp_tpu_torch.resilience import retry as rs_retry

# Max staged-but-unfolded chunks in flight (the reference's window).
_CHUNK_WINDOW = 8


class ChunkThrottle:
    """Sliding-window backpressure for chunked staging: ``tick()`` after
    each chunk's fold records a CUDA event on the current stream and waits
    on the one from ``window`` chunks back, so at most that many staged
    chunks are in flight on the card. Each host wait is the span
    ``single.chunk_wait``; ``take_wait_s()`` hands over their sum since
    the last call. On the CPU every step is already synchronous and
    ``tick`` does nothing."""

    def __init__(self, device: torch.device, window: int = _CHUNK_WINDOW):
        self._cuda = device.type == "cuda"
        self._window = window
        self._pending: list = []
        self._wait_s = 0.0

    def tick(self) -> None:
        if not self._cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self._pending.append(ev)
        if len(self._pending) > self._window:
            t0 = time.perf_counter()
            # The backpressure fence is a deliberate host wait.
            with obs_span("single.chunk_wait"), \
                    fenced("single.chunk_throttle"):
                self._pending.pop(0).synchronize()
            self._wait_s += time.perf_counter() - t0

    def take_wait_s(self) -> float:
        """Seconds the host waited since the last call."""
        s, self._wait_s = self._wait_s, 0.0
        return s


class MeasuredIters:
    """Per launch shape, the sum of K1/K2's ``iters`` outputs on the
    device while a cost probe is installed (one tiny reduction per launch,
    none without a probe); ``done()`` queues it on the engine for
    :func:`flush_measured_iters` after the solve's fetch."""

    def __init__(self, engine, impl: str, shape: Tuple[int, int, int, int],
                 integer: bool = False):
        self._on = obs_counters.active() is not None
        self._engine = engine
        if integer:     # the integer kernel's launches (uint8 operands)
            self._kernel = "fused_topk_u8" if impl == "fused" \
                else "extract_topk_u8"
        else:
            self._kernel = "fused_topk" if impl == "fused" \
                else "extract_topk"
        self._shape = tuple(int(v) for v in shape)
        self._sum = None

    def add(self, iters: torch.Tensor) -> None:
        if self._on:
            s = iters.sum()
            self._sum = s if self._sum is None else self._sum + s

    def done(self) -> None:
        if self._sum is not None:
            self._engine._pending_iters.append(
                (self._kernel, self._sum, self._shape))


def flush_measured_iters(engine) -> None:
    """Read back the engine's queued ``iters`` sums (the solve's results
    are fetched already, so this waits on nothing) and hand them to the
    installed probe: the measured extraction term of obs.kernel_cost."""
    pend = getattr(engine, "_pending_iters", [])
    engine._pending_iters = []
    for kernel, total, shape in pend:
        total = int(readback(  # check: allow-host-sync
            total, "single.measured_iters"))
        obs_counters.record_measured_iters(kernel, total, shape)


def staging_dtype(staging: str) -> torch.dtype:
    return torch.bfloat16 if staging == "bfloat16" else torch.float32


def pinned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` pinned when the copy goes to the card (so the host-to-device
    copy can run asynchronously), traced as ``single.pin``; ``t`` itself
    for the CPU."""
    if device.type != "cuda":
        return t
    with obs_span("single.pin", bytes=t.nbytes):
        return t.pin_memory()


def host_block(shape: Tuple[int, int], dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """A fresh, uninitialised host tensor, pinned when the copy goes to
    the card, traced as ``single.pin``. Pinned blocks come from PyTorch's
    caching host allocator, which keeps them from one solve to the next
    and hands a block out again only once the event of every asynchronous
    copy from it has completed. On the CPU every call is a new tensor:
    ``stage`` hands the host tensor itself on there, so a staged chunk
    never shares memory with a later one."""
    if device.type != "cuda":
        return torch.empty(shape, dtype=dtype)
    with obs_span("single.pin",
                  bytes=shape[0] * shape[1] * dtype.itemsize):
        return torch.empty(shape, dtype=dtype, pin_memory=True)


def host_staging(arr: np.ndarray, device: torch.device,
                 staging: str = "float32") -> torch.Tensor:
    """A host tensor in the staging dtype, pinned when the copy goes to
    the card."""
    return pinned(torch.from_numpy(np.ascontiguousarray(arr)).to(
        staging_dtype(staging)), device)


def put(arr: np.ndarray, device: torch.device,
        site: str = "single.put") -> torch.Tensor:
    """A small host array on ``device`` by a blocking copy: explicit
    staging, the port's ``jax.device_put``, fenced as ``site`` for the
    sanitizer (a pageable host-to-device copy synchronizes)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    with fenced(site):
        out = t.to(device)
    obs_trace.count("h2d_bytes", t.nbytes)
    return out


def stage(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host-to-device copy, asynchronous from pinned memory: the staging
    chokepoint of every solve path, so it is the ``single.stage_put``
    injection site, and a transient failure retries the copy (copying the
    same host tensor again is idempotent). The bytes handed over count
    once, as ``h2d_bytes``, however many attempts it took."""
    def _op():
        rs_inject.fire("single.stage_put")
        return host.to(device, non_blocking=True)

    out = rs_retry.call_with_retry(_op, "single.stage_put")
    obs_trace.count("h2d_bytes", host.nbytes)
    return out


def resilient_get(values: List[torch.Tensor], site: str = "single.fetch"
                  ) -> List[np.ndarray]:
    """Readback of device tensors to numpy (the fetch is the solve's
    fence), at the ``single.fetch`` injection site with the transient
    retry: reading values already computed again is idempotent.
    ``$DMLP_TPU_OP_TIMEOUT_S`` (off by default) bounds each attempt with a
    worker-thread deadline whose ``OperationTimeout`` retries; with
    ``DMLP_TPU_RESILIENCE=0`` the read is a direct call."""
    deadline = float(os.environ.get("DMLP_TPU_OP_TIMEOUT_S", "0") or 0)

    def _get():
        rs_inject.fire(site)
        # The solve's fence, inside the timeout's worker thread when
        # there is one (the sanitizer's CUDA layer is process-wide).
        return readback(list(values), site)  # check: allow-host-sync

    def _op():
        if deadline > 0 and rs_retry.resilience_enabled():
            return rs_retry.call_with_timeout(_get, deadline, site=site)
        return _get()

    return rs_retry.call_with_retry(_op, site)


def add_phase(phase_ms: dict, name: str, t0: float) -> float:
    """Add the milliseconds since ``t0`` to ``phase_ms[name]``; returns
    the clock."""
    now = time.perf_counter()
    phase_ms[name] = phase_ms.get(name, 0.0) + (now - t0) * 1e3
    return now


def fold_chunks(chunks: Iterable[Tuple[torch.Tensor, int, int, int]],
                fold: Callable[[torch.Tensor, int, int, int], None],
                device: torch.device, *, row_bytes: int = 0,
                phase_ms: Optional[dict] = None,
                throttle: Optional[ChunkThrottle] = None) -> int:
    """The chunk loop of every chunked solve. ``chunks`` yields (the
    chunk on the device, its first row, that row's global id, its real
    rows), staging or handing the chunk over as the loop asks for it;
    ``fold`` takes the same four and does the solve's work. After each
    fold the chunk window ticks (``throttle``, else a fresh one) and the
    memory watermark is sampled while the chunk is referenced. With
    ``phase_ms`` the loop's host time adds to it: the window's waits as
    ``chunk_wait``, the rest less what the loop added to ``copy`` and
    ``pin`` (the casts) as ``launch``. Returns ``row_bytes`` per real
    row: the bytes scanned."""
    throttle = throttle if throttle is not None else ChunkThrottle(device)
    if phase_ms is not None:
        t0 = time.perf_counter()
        host0 = phase_ms.get("copy", 0.0) + phase_ms.get("pin", 0.0)
    scanned = 0
    for da, toff, id_base, n_real in chunks:
        fold(da, toff, id_base, n_real)
        scanned += n_real * row_bytes
        throttle.tick()
        telemetry.sample_memory_now()
    if phase_ms is not None:
        wait = throttle.take_wait_s() * 1e3
        host = phase_ms.get("copy", 0.0) + phase_ms.get("pin", 0.0) - host0
        phase_ms["chunk_wait"] = phase_ms.get("chunk_wait", 0.0) + wait
        phase_ms["launch"] = phase_ms.get("launch", 0.0) \
            + (time.perf_counter() - t0) * 1e3 - wait - host
    return scanned


class OutlierFold:
    """The heterogeneous-k router's side step, a ``fold`` beside the
    kernel's: the wide-k outlier queries ``q`` fold each chunk the bulk
    takes into their running top-k ``carry`` through ``select``, with the
    chunk's labels sliced from ``labels`` at its row and its ids affine
    from its first id, -1 past its real rows: no host-to-device traffic
    of their own."""

    def __init__(self, q: torch.Tensor, labels: torch.Tensor, k: int,
                 select: str, use_pallas: bool):
        self.q, self.labels, self.select = q, labels, select
        self.step = make_block_step(select, k, use_pallas)
        self.carry = init_topk(q.shape[0], k, q.device)

    def __call__(self, da: torch.Tensor, toff: int, id_base: int,
                 n_real: int) -> None:
        rows = da.shape[0]
        iota = torch.arange(rows, dtype=torch.int32, device=da.device)
        bids = torch.where(iota < n_real, id_base + iota, -1)
        self.carry = self.step(self.carry, self.q, da,
                               self.labels[toff:toff + rows], bids)


def device_epilogue(top: TopK, ks: torch.Tensor, *, num_labels: int):
    """Vote and report order on the device over (Q, K) selection-ordered
    lists, the reference's result post-processing (engine.cpp:314-347):
    (predicted (Q,), report ids (Q, K), report f32 distances (Q, K))."""
    rd, rids, in_k = report_order(top, ks)
    valid = in_k & (top.ids >= 0)
    return majority_vote(top.labels, valid, num_labels), rids, rd


def device_full_results(segments, ks: np.ndarray, num_labels: int,
                        device: torch.device, phase_ms: dict, prefix: str,
                        *, own_epilogue: bool = False,
                        put_site: str = "single.put",
                        fetch_site: str = "single.fetch"
                        ) -> List[QueryResult]:
    """The device-full epilogue over a solve's segments, (lists, qpad,
    query indices or None for all, select) each: :func:`device_epilogue`
    over the lists with the segment's ks padded to qpad (staged at
    ``put_site``), one readback at ``fetch_site``, and a ``QueryResult``
    for each query by its index in ``ks``. Spans ``{prefix}.fetch`` and
    ``{prefix}.finalize``, added up into ``phase_ms`` as ``fetch`` and
    ``finalize``. The epilogue's launch is part of the fetch, whose span
    then names the segment's ``select`` and ``kcap``; with
    ``own_epilogue`` it is its own span and phase, ``epilogue``, that
    first moves the lists onto ``device``."""
    merged: List[QueryResult] = [None] * len(ks)
    for top, qpad, idx, select in segments:
        qids = np.arange(len(ks)) if idx is None else idx
        ks_pad = np.zeros(qpad, np.int32)
        ks_pad[:len(qids)] = ks[qids]

        def launch(lists):
            return device_epilogue(lists, put(ks_pad, device, put_site),
                                   num_labels=num_labels)

        t0 = time.perf_counter()
        out = None
        if own_epilogue:
            with obs_span(f"{prefix}.epilogue"):
                out = launch(TopK(*(move(t, device, put_site)
                                    for t in top)))
            t0 = add_phase(phase_ms, "epilogue", t0)
        args = {} if own_epilogue else {"select": select,
                                        "kcap": top.dists.shape[1]}
        with obs_span(f"{prefix}.fetch", **args):
            pred, rids, rd = resilient_get(list(out or launch(top)),
                                           site=fetch_site)
        t0 = add_phase(phase_ms, "fetch", t0)
        with obs_span(f"{prefix}.finalize"):
            rd = rd.astype(np.float64)
            for i, q in enumerate(qids):
                k = int(ks[q])
                merged[int(q)] = QueryResult(
                    int(q), k, int(pred[i]), rids[i, :k].astype(np.int64),
                    rd[i, :k])
        add_phase(phase_ms, "finalize", t0)
    return merged
