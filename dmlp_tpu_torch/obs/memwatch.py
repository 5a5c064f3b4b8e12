"""Device-memory watermarks: the analytic resident-set models of the
port's engines and their reconciliation against the caching allocator —
port of ``dmlp_tpu/obs/memwatch.py``.

- :func:`single_engine_model`, :func:`mesh_engine_model` and
  :func:`serve_engine_model` are the analytic peak resident-set models of
  :class:`~dmlp_tpu_torch.engine.single.SingleChipEngine`, the mesh
  engines (per rank) and the serving engine, computed from the same plan
  functions the solves use (``plan_chunks``, ``fold_plan``,
  ``resolve_kcap``). They count what the port allocates, which differs
  from the reference's model: the chunk window of staged chunks, the
  split's ``S x Qb x kc`` partial lists and the merge's output on the
  extraction path, the distance tile the ``topk``/``seg`` folds
  materialize, and the serving engine's one resident buffer (no
  ``extract_chunks`` and no ``multipass_resident`` term).
- :func:`device_memory_stats` and :func:`measured_watermark` read the
  caching allocator of a CUDA device (``torch.cuda.mem_get_info`` for the
  card's total memory, ``memory_allocated`` / ``max_memory_allocated`` /
  ``memory_reserved``). On the CPU they report nothing, so admission's
  memory shedding is off there, as in the reference.
- :func:`reconcile` holds a model against a measured peak under the
  documented ratio bounds of its basis (:data:`RATIO_BOUNDS`), with the
  explicit ``mem_stats_unavailable`` marker where the device reports
  nothing, never a silent pass.

- :func:`fleet_engine_model` is the mesh-resident serving engine's, per
  rank.
- :func:`train_step_model` is the reference's dp x tp train-step model,
  term for term.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

#: documented model-vs-measured tolerance, per basis, as ratio bounds on
#: measured/model: the allocator's peak carries the launches' transient
#: operand copies and the caching allocator's rounding above the resident
#: set the model counts
RATIO_BOUNDS: Dict[str, tuple] = {
    "max_memory_allocated": (0.5, 3.0),
}

#: byte widths of one candidate slot (TopK triple = f32 + i32 + i32)
_TOPK_ITEMSIZE = 12
#: one extraction-kernel list slot (dists f32 + ids i32)
_EXTRACT_ITEMSIZE = 8


def _staging_itemsize(staging: str) -> int:
    return 2 if staging == "bfloat16" else 4


def _finish(terms: Dict[str, int], **meta) -> Dict[str, Any]:
    out: Dict[str, Any] = {"model_schema": 1,
                           "terms": {k: int(v) for k, v in terms.items()},
                           "total_bytes": int(sum(terms.values()))}
    out.update(meta)
    return out


# -- analytic models ----------------------------------------------------------

def _extract_terms(qpad: int, chunk_rows: int, window: int, na: int,
                   kc: int, item: int, splits: int) -> Dict[str, int]:
    """The extraction path's device terms at one launch shape: the staged
    chunk window, the double-buffered (od, oi) lists, the split's partial
    lists (S > 1 writes (S, qpad, kc) before the merge) and the ``iters``
    outputs of the chunks in flight."""
    from dmlp_tpu_torch.ops.extract import BLOCK_ROWS, QUERY_TILE
    terms = {"staged_corpus": window * chunk_rows * na * item,
             "topk_carries": 2 * qpad * kc * _EXTRACT_ITEMSIZE,
             "query_blocks": qpad * na * item,
             "kernel_scratch": window * 4 * (-(-qpad // QUERY_TILE))
             * (chunk_rows // BLOCK_ROWS)}
    if splits > 1:
        terms["split_partials"] = splits * qpad * kc * _EXTRACT_ITEMSIZE
    return terms


def single_engine_model(n: int, nq: int, na: int, kmax: int, config=None,
                        staging: Optional[str] = None, splits: int = 1
                        ) -> Dict[str, Any]:
    """Peak resident device bytes of one SingleChipEngine solve at
    (num_data n, num_queries nq, num_attrs na, max-k kmax), from the
    engine's own plan:

    - "sort" stages the whole padded dataset, its labels and ids, the
      query blocks and the output lists, and each step's (qb, data_block)
      distance tile;
    - "extract" holds at most the ``_CHUNK_WINDOW + 1`` staged chunks in
      flight, the lists, the split's partials at ``splits`` S and the
      global label vector; a candidate width past 512 is the multi-pass
      plan, which keeps every chunk resident and briefly twice during
      the concatenation, with one (qpad, 512) slab per pass;
    - "topk"/"seg" hold the chunk window, the padded labels and ids of
      the whole corpus, the query blocks, the double-buffered carries and
      the (query block, chunk) distance tile (K3 also writes its
      segment minima).

    Every term is reported; ``total_bytes`` is their sum."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import (_CHUNK_WINDOW, fit_blocks,
                                              fold_plan, plan_chunks,
                                              resolve_kcap, round_up)
    from dmlp_tpu_torch.ops.extract import KC_MAX, QUERY_TILE

    cfg = config or EngineConfig()
    staging = staging or cfg.resolve_dtype()
    item = _staging_itemsize(staging)
    n, nq = max(n, 1), max(nq, 1)
    select = cfg.resolve_select(round_up(n, 8))
    terms: Dict[str, int] = {}

    if select == "sort":
        sel = cfg.resolve_streaming_select(round_up(n, 8))
        data_block = (min(cfg.data_block, round_up(n, 8))
                      if cfg.data_block is not None
                      else fit_blocks(n, cfg.resolve_data_block(sel),
                                      granule=cfg.resolve_granule(sel)))
        npad = round_up(n, data_block)
        kc = resolve_kcap(cfg, kmax, sel, npad, staging=staging)
        qb = min(cfg.query_block, round_up(nq, 8))
        qpad = round_up(nq, qb)
        terms["staged_corpus"] = npad * na * item
        terms["labels_ids"] = npad * 8
        terms["query_blocks"] = qpad * na * item
        terms["topk_out"] = qpad * kc * _TOPK_ITEMSIZE
        terms["distance_tile"] = qb * data_block * 4
        return _finish(terms, select=select, kcap=kc, npad=npad,
                       qpad=qpad, staging=staging)

    if select == "extract":
        npad, nchunks, chunk_rows = plan_chunks(
            n, cfg.resolve_granule("extract"), cfg.data_block)
        qpad = round_up(nq, QUERY_TILE)
        kc = resolve_kcap(cfg, kmax, "extract", nchunks * chunk_rows,
                          staging=staging)
        multipass = kc > KC_MAX
        if multipass:
            npasses = -(-kc // KC_MAX)
            staged = min(nchunks, -(-n // chunk_rows))
            terms = _extract_terms(qpad, chunk_rows, staged, na, KC_MAX,
                                   item, splits)
            terms["staged_corpus"] *= 2     # chunks + their concatenation
            terms["topk_carries"] = (npasses + 1) * qpad * KC_MAX \
                * _EXTRACT_ITEMSIZE
        else:
            window = min(nchunks, _CHUNK_WINDOW + 1)
            terms = _extract_terms(qpad, chunk_rows, window, na, kc, item,
                                   splits)
        terms["labels"] = n * 4          # the global labels, staged once
        return _finish(terms, select=select, kcap=kc, npad=npad,
                       qpad=qpad, staging=staging, multipass=multipass,
                       splits=splits)

    qsb, nqb, nchunks, chunk_rows = fold_plan(cfg, n, nq, select)
    qpad = nqb * qsb
    kc = resolve_kcap(cfg, kmax, select, nchunks * chunk_rows,
                      staging=staging)
    window = min(nchunks, _CHUNK_WINDOW + 1)
    terms["staged_corpus"] = window * chunk_rows * na * item
    terms["labels_ids"] = nchunks * chunk_rows * 8
    terms["query_blocks"] = qpad * na * item
    terms["topk_carries"] = 2 * qpad * kc * _TOPK_ITEMSIZE
    terms["distance_tile"] = qsb * chunk_rows * 4
    if select == "seg":
        terms["segmin_tile"] = qsb * (chunk_rows // 128) * 4
    return _finish(terms, select=select, kcap=kc, npad=nchunks * chunk_rows,
                   qpad=qpad, staging=staging)


def mesh_engine_model(n: int, nq: int, na: int, kmax: int, mesh_shape,
                      mode: str = "sharded", config=None,
                      staging: Optional[str] = None, splits: int = 1
                      ) -> Dict[str, Any]:
    """Peak resident device bytes of one rank of the mesh engines: on the
    chunked extraction path its window of staged chunks of its row shard,
    its shard's labels, its query shard, its (qloc, kc) lists with the
    split's partials; on the merged path the whole row shard with labels
    and ids and the streaming fold's (qloc, block) distance tile (and
    K3's segment minima under "seg"). The merge buffer differs by
    strategy: the all-gather holds all R cells' (qloc, kc) triples, the
    ring two (its accumulator and the incoming one). ``mode="auto"``
    (``engine.auto``) always takes the merged path (its fold streams) and
    prices the all-gather's buffer, the worst case of a schedule DTensor
    chooses."""
    from dmlp_tpu_torch.config import EngineConfig
    from dmlp_tpu_torch.engine.single import (_CHUNK_WINDOW, fit_blocks,
                                              plan_chunks, resolve_kcap,
                                              round_up)
    from dmlp_tpu_torch.ops.extract import KC_MAX, QUERY_TILE

    cfg = config or EngineConfig(mode=mode)
    staging = staging or cfg.resolve_dtype()
    item = _staging_itemsize(staging)
    r, c = mesh_shape
    n, nq = max(n, 1), max(nq, 1)
    rows = max(-(-n // r), 1)
    chunked = mode != "auto" \
        and cfg.resolve_select(round_up(rows, 8)) == "extract"
    if chunked:
        shard_rows, nchunks, chunk_rows = plan_chunks(
            rows, cfg.resolve_granule("extract"), cfg.data_block)
        qloc = round_up(max(-(-nq // c), 1), QUERY_TILE)
        kc = resolve_kcap(cfg, kmax, "extract", r * shard_rows,
                          staging=staging)
        chunked = kc <= KC_MAX
    if chunked:
        terms = _extract_terms(qloc, chunk_rows, min(nchunks,
                                                     _CHUNK_WINDOW + 1),
                               na, kc, item, splits)
        terms["labels_shard"] = nchunks * chunk_rows * 4
    else:
        select = cfg.resolve_streaming_select(round_up(rows, 8))
        block = (min(cfg.data_block, round_up(rows, 8))
                 if cfg.data_block is not None
                 else fit_blocks(rows, cfg.resolve_data_block(select),
                                 granule=cfg.resolve_granule(select)))
        shard_rows = round_up(rows, block)
        qloc = round_up(max(-(-nq // c), 1), 8)
        kc = resolve_kcap(cfg, kmax, select, r * shard_rows,
                          staging=staging)
        terms = {"corpus_shard": shard_rows * na * item,
                 "labels_ids_shard": shard_rows * 8,
                 "query_blocks": qloc * na * item,
                 "local_topk": qloc * kc * _TOPK_ITEMSIZE,
                 # the streaming fold's (qloc, block) distance tile
                 "distance_tile": qloc * block * 4}
        if select == "seg":
            terms["segmin_tile"] = qloc * (block // 128) * 4
    terms["merge_buffer"] = (2 if mode == "ring" else r) * qloc * kc \
        * _TOPK_ITEMSIZE
    return _finish(terms, mode=mode, mesh=[r, c], kcap=kc,
                   shard_rows=shard_rows, q_local=qloc, staging=staging,
                   per_device=True, n_devices=r * c,
                   path="chunked" if chunked else "merged")


def serve_engine_model(resident_rows: int, na: int,
                       staging: str = "float32", qpad: int = 0,
                       kcap: int = 0, summary_blocks: int = 0
                       ) -> Dict[str, Any]:
    """Peak resident device bytes of the serving engine: the one resident
    buffer of ``resident_rows`` rows in the staging dtype with its label
    and id vectors, the device copies of the block summaries, and, when a
    micro-batch bucket (qpad, kcap) is given, that batch's terms (the
    padded query block and the double-buffered candidate lists). The
    admission controller reads the corpus terms as the floor and prices
    each bucket's marginal bytes on top."""
    item = _staging_itemsize(staging)
    terms: Dict[str, int] = {
        "resident_corpus": resident_rows * na * item,
        "labels_ids": resident_rows * 8,
    }
    if summary_blocks:
        # ops.summaries.stage_summaries: two (B, A) f32 boxes, two (B,)
        # f32 norm bands and one (B,) i32 count vector.
        terms["resident_summaries"] = summary_blocks * (8 * na + 12)
    if qpad:
        terms["query_blocks"] = qpad * na * item
        terms["topk_carries"] = 2 * qpad * kcap * _TOPK_ITEMSIZE
    return _finish(terms, kind="serve", resident_rows=resident_rows,
                   staging=staging)


def fleet_engine_model(mesh_shape, shard_rows: int, na: int,
                       staging: str = "float32", resident_rows: int = 0,
                       qloc: int = 0, kcap: int = 0,
                       merge: str = "allgather") -> Dict[str, Any]:
    """Peak resident device bytes per rank of the mesh-resident serving
    engine (``fleet.mesh_engine.MeshResidentEngine``): the rank's one
    resident shard buffer of ``resident_rows`` rows (default
    ``shard_rows``; its chunks and the stream path's layout are views of
    it) with its label and id vectors, and, when a micro-batch bucket
    (qloc, kcap) is given, that batch's terms: the query shard, the local
    candidate lists and the merge buffer (all R shards' lists for the
    all-gather merge and the "gspmd" one, whose schedule DTensor
    chooses, the O(k) accumulator for the ring). The block summaries live
    on rank 0's host and cost the card nothing."""
    item = _staging_itemsize(staging)
    r, c = mesh_shape
    rows = resident_rows or shard_rows
    terms: Dict[str, int] = {
        "resident_shard": rows * na * item,
        "labels_ids_shard": rows * 8,
    }
    if qloc:
        terms["query_shard"] = qloc * na * item
        terms["local_topk"] = qloc * kcap * _TOPK_ITEMSIZE
        terms["merge_buffer"] = (2 if merge == "ring" else r) \
            * qloc * kcap * _TOPK_ITEMSIZE
    return _finish(terms, kind="fleet", mesh=[r, c],
                   shard_rows=shard_rows, staging=staging,
                   per_device=True, n_devices=r * c)


def train_step_model(dims, batch: int, optimizer: str = "sgd",
                     mesh_shape=None, compute_dtype: Optional[str] = None
                     ) -> Dict[str, Any]:
    """Peak resident bytes per rank of one dp x tp train step: params,
    grads, optimizer moments (adam: 2x params), the local batch, and the
    forward activations kept for the backward (one (batch_local, width)
    block per layer boundary, bf16 under ``compute_dtype="bfloat16"``).
    tp shards the widths, dp the batch."""
    dims = list(dims)
    dp, tp = (mesh_shape or (1, 1))[:2]
    param_count = sum(dims[i] * dims[i + 1] + dims[i + 1]
                      for i in range(len(dims) - 1))
    pbytes = param_count * 4 // max(tp, 1)
    moments = {"sgd": 0, "adam": 2}.get(optimizer, 0)
    b_local = max(batch // max(dp, 1), 1)
    act_item = 2 if compute_dtype == "bfloat16" else 4
    acts = b_local * sum(dims[1:]) * act_item // max(tp, 1)
    terms = {
        "params": pbytes,
        "grads": pbytes,
        "opt_moments": moments * pbytes,
        "batch": b_local * (dims[0] + 1) * 4,
        "activations": acts,
    }
    return _finish(terms, kind="train", dims=dims, batch=batch,
                   optimizer=optimizer, per_device=True,
                   n_devices=max(dp, 1) * max(tp, 1))


def resident_bytes_model(kind: str, **params) -> Dict[str, Any]:
    """Dispatch on workload kind: "single" | "sharded" | "ring" | "auto"
    | "serve" | "fleet" | "train"."""
    if kind == "single":
        return single_engine_model(**params)
    if kind in ("sharded", "ring", "auto"):
        return mesh_engine_model(mode=kind, **params)
    if kind == "serve":
        return serve_engine_model(**params)
    if kind == "fleet":
        return fleet_engine_model(**params)
    if kind == "train":
        return train_step_model(**params)
    raise ValueError(f"unknown workload kind {kind!r}")


def _engine_splits(engine, qb: int, b: int, na: int, kc: int) -> int:
    """The S a launch at (qb, b, kc) takes on the engine's device without
    a tune-cache entry (a pure function of the card's SM count; 1 on the
    CPU and for shapes the kernel does not tile)."""
    from dmlp_tpu_torch.ops import extract as ex
    if not ex.supports(qb, b, na, kc):
        return 1
    return ex.heuristic_splits(qb, b, kc, engine.device)


def model_for_engine(engine, inp) -> Dict[str, Any]:
    """The analytic model for a live engine and a parsed input, read from
    the engine's own config and staging."""
    from dmlp_tpu_torch.engine.single import plan_chunks, resolve_kcap, \
        round_up
    from dmlp_tpu_torch.ops.extract import QUERY_TILE
    p = inp.params
    kmax = int(inp.ks.max()) if p.num_queries else 1
    if hasattr(engine, "mem_model"):
        return engine.mem_model(p.num_queries, kmax)
    cfg = engine.config
    mesh = getattr(engine, "mesh", None)
    r, c = tuple(mesh.shape) if mesh is not None else (1, 1)
    rows = max(-(-p.num_data // r), 1)
    _, nchunks, chunk_rows = plan_chunks(
        rows, cfg.resolve_granule("extract"), cfg.data_block)
    qb = round_up(max(-(-p.num_queries // c), 1), QUERY_TILE)
    kc = resolve_kcap(cfg, kmax, "extract", r * nchunks * chunk_rows,
                      staging=engine._staging)
    splits = _engine_splits(engine, qb, chunk_rows, p.num_attrs, kc)
    if mesh is None:
        return single_engine_model(p.num_data, p.num_queries, p.num_attrs,
                                   kmax, config=cfg,
                                   staging=engine._staging, splits=splits)
    mode = {"ring": "ring", "gspmd": "auto"}.get(engine._merge_strategy,
                                                 "sharded")
    return mesh_engine_model(p.num_data, p.num_queries, p.num_attrs, kmax,
                             (r, c), mode=mode, config=cfg,
                             staging=engine._staging, splits=splits)


def note_engine_model(engine, inp) -> Optional[Dict[str, Any]]:
    """Engine hook: compute the model and publish it (the
    ``mem.model.resident_bytes`` gauge and ``engine.last_mem_model``)
    while a telemetry session is active; otherwise one module-global
    read."""
    from dmlp_tpu_torch.obs import telemetry
    if not telemetry.enabled():
        engine.last_mem_model = None
        return None
    try:
        model = model_for_engine(engine, inp)
        engine.last_mem_model = model
        telemetry.registry().gauge("mem.model.resident_bytes").set(
            model["total_bytes"])
        return model
    except Exception:  # observability never fails a solve
        engine.last_mem_model = None
        return None


# -- measured bases -----------------------------------------------------------

_limits: Dict[int, int] = {}


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The allocator's view of one CUDA device: ``index``,
    ``bytes_limit`` (the card's total memory, read once per card),
    ``bytes_in_use`` (``memory_allocated``), ``peak_bytes_in_use``
    (``max_memory_allocated``) and ``bytes_reserved``
    (``memory_reserved``). None for a CPU device or none given: a CPU
    reports no budget."""
    import torch
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _limits:
        _limits[idx] = int(torch.cuda.mem_get_info(idx)[1])
    return {"index": idx, "bytes_limit": _limits[idx],
            "bytes_in_use": int(torch.cuda.memory_allocated(idx)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(idx)),
            "bytes_reserved": int(torch.cuda.memory_reserved(idx))}


def measured_watermark(device=None) -> Dict[str, Any]:
    """The live allocated bytes of ``device`` (a read of the caching
    allocator's counters on the host: no CUDA call, so a request handler
    thread may take it), or an explicit marker where the device reports
    nothing."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        return {"unavailable": "the device reports no allocator stats"}
    return {"bytes": int(torch.cuda.memory_allocated(device)),
            "basis": "memory_allocated"}


def peak_watermark(device=None) -> Dict[str, Any]:
    """The allocator's peak on ``device`` (``max_memory_allocated``,
    basis ``max_memory_allocated``) or the explicit marker on the
    CPU."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        return {"unavailable": "the device reports no allocator stats"}
    return {"bytes": int(torch.cuda.max_memory_allocated(device)),
            "basis": "max_memory_allocated"}


# -- reconciliation -----------------------------------------------------------

def reconcile(model: Dict[str, Any],
              measured: Dict[str, Any]) -> Dict[str, Any]:
    """Model vs measured watermark (:func:`peak_watermark`, or a
    sampler's ``measured_peak()``). Each rank of the port reads its own
    device in its own process, so a per-device model compares as it is.
    An unavailable basis yields the explicit ``mem_stats_unavailable``
    marker; otherwise the verdict is ``within_tolerance`` against the
    basis's :data:`RATIO_BOUNDS`."""
    out: Dict[str, Any] = {"model_bytes": int(model["total_bytes"])}
    if "unavailable" in measured or not measured.get("bytes"):
        out["mem_stats_unavailable"] = measured.get(
            "unavailable", "measured watermark is zero")
        return out
    basis = measured.get("basis", "max_memory_allocated")
    lo, hi = RATIO_BOUNDS.get(basis, RATIO_BOUNDS["max_memory_allocated"])
    mbytes = int(measured["bytes"])
    ratio = mbytes / max(out["model_bytes"], 1)
    out.update(measured_bytes=mbytes, basis=basis,
               ratio=round(ratio, 3), ratio_bounds=[lo, hi],
               delta_pct=round((mbytes - out["model_bytes"])
                               / out["model_bytes"] * 100.0, 2)
               if out["model_bytes"] else None,
               within_tolerance=bool(lo <= ratio <= hi))
    return out


__all__ = [
    "RATIO_BOUNDS", "device_memory_stats", "measured_watermark",
    "peak_watermark", "single_engine_model", "mesh_engine_model",
    "serve_engine_model", "train_step_model", "resident_bytes_model",
    "model_for_engine",
    "note_engine_model", "reconcile",
]
