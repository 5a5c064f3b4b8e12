"""Device-memory model and watermark of the serving engine — the serving
part of ``dmlp_tpu/obs/memwatch.py``.

- :func:`serve_engine_model` is the analytic resident-set model of
  :class:`dmlp_tpu_torch.serve.engine.ResidentEngine`. It counts what the
  port allocates, which is less than the reference's model counts: the
  port holds the corpus once, in one device buffer whose row views are the
  extraction chunks and the multi-pass sweep, where the reference keeps the
  streaming buffer, a copy per extraction chunk and, once a wide-k bucket
  runs, their concatenation. So the model has no ``extract_chunks`` and no
  ``multipass_resident`` term.
- :func:`device_memory_stats` and :func:`measured_watermark` read the
  caching allocator of a CUDA device (``torch.cuda.mem_get_info`` for the
  card's total memory, ``torch.cuda.memory_allocated`` /
  ``max_memory_allocated`` for the live and peak bytes). On the CPU, or
  when no device is given, they report nothing, so admission's memory
  shedding is off there, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

#: byte widths of one candidate slot (TopK triple = f32 + i32 + i32)
_TOPK_ITEMSIZE = 12


def _staging_itemsize(staging: str) -> int:
    return 2 if staging == "bfloat16" else 4


def _finish(terms: Dict[str, int], **meta) -> Dict[str, Any]:
    out: Dict[str, Any] = {"model_schema": 1,
                           "terms": {k: int(v) for k, v in terms.items()},
                           "total_bytes": int(sum(terms.values()))}
    out.update(meta)
    return out


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


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The allocator's view of one CUDA device: ``bytes_limit`` (the
    card's total memory), ``bytes_in_use`` and ``peak_bytes_in_use``
    (PyTorch's caching allocator). None for a CPU device or none given:
    a CPU reports no budget."""
    import torch
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return {"bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
            "bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(
                device))}


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
