"""Throughput and MFU accounting — port of ``dmlp_tpu/train/metrics.py``.

samples/s/chip and model FLOPs utilization with the standard 6 * batch *
matmul-params estimate of a forward and backward step's FLOPs (2 forward
and 4 backward per weight element per example). The peak is the card's
bf16 rate from ``obs.counters.PEAKS`` by ``torch.cuda.get_device_name``,
as the reference takes its chips' bf16 peaks; an unknown card or the CPU
gets the reference's deliberately low fallback, so MFU is never
overstated.
"""

from __future__ import annotations

from typing import Optional

from dmlp_tpu_torch.train.model import num_matmul_params

FALLBACK_PEAK_FLOPS = 100e12


def peak_flops_per_chip(device=None) -> float:
    """The bf16 peak of ``device`` (default: the current card, when there
    is one), else :data:`FALLBACK_PEAK_FLOPS`."""
    import torch
    from dmlp_tpu_torch.obs.counters import PEAKS
    if device is not None and torch.device(device).type != "cuda":
        return FALLBACK_PEAK_FLOPS
    if not torch.cuda.is_available():
        return FALLBACK_PEAK_FLOPS
    row = PEAKS.get(torch.cuda.get_device_name(device))
    return row["bf16"] if row else FALLBACK_PEAK_FLOPS


def train_step_flops(params, batch_size: int) -> float:
    """~FLOPs of one fwd+bwd step (6 per weight element per example)."""
    return 6.0 * batch_size * num_matmul_params(params)


def throughput_metrics(params, batch_size: int, step_time_s: float,
                       n_chips: int, peak_per_chip: Optional[float] = None,
                       device=None) -> dict:
    samples_per_sec = batch_size / step_time_s
    flops = train_step_flops(params, batch_size)
    peak = peak_per_chip if peak_per_chip is not None \
        else peak_flops_per_chip(device)
    return {
        "samples_per_sec": samples_per_sec,
        "samples_per_sec_per_chip": samples_per_sec / n_chips,
        "step_time_ms": step_time_s * 1e3,
        "model_flops_per_step": flops,
        "mfu": flops / (step_time_s * n_chips * peak),
    }
