"""Published peaks of the cards the benchmark knows, by
``torch.cuda.get_device_name()``.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W: 989 TFLOP/s is its highest dense rate of any precision short of
fp8 and int8 (bf16 and fp16 on the tensor cores; float32 outside them is
67 TFLOP/s), and 3.35 TB/s of HBM3. A share of 989 TFLOP/s can then not
pass 100% for any rewrite that keeps 16 bits or more. A card that is not
listed has no peak, and the readers of a share of it report nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"dense_flops_per_s": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: Optional[str]) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name or "")
