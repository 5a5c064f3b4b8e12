"""Engine configuration — the port's copy of ``dmlp_tpu.config``.

Every field and resolution rule of the reference ``EngineConfig`` is kept
so that one configuration means the same solve in both packages; the port
adds ``device``. The device is what the caller asks for: ``"cuda"`` (the
default) runs on the card and raises when there is none, ``"cpu"`` runs the
plain PyTorch versions of the kernels. Nothing here falls back from one to
the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Configuration for the KNN engine.

    Attributes (as in the reference package unless noted):
      mode: "single" | "sharded" | "ring" | "auto". "single" is
        ``engine.single``, "sharded" and "ring" the mesh engines of
        ``engine.sharded``; "auto" (the compiler-sharded engine) is
        ROADMAP item A10, not ported yet.
      mesh_shape: (data_axis_size, query_axis_size) for the mesh engines.
      data_block: data rows per staged chunk / inner step. None = per
        select strategy (2048 for "sort", 65536 for the chunked paths).
      query_block: queries per outer step.
      dtype: staging dtype ("auto", "float32" or "bfloat16"). "auto" is
        float32 on both the CPU and the card.
      exact: rescore the top-(k + margin) candidates on the host in
        float64 and re-select (checksum parity with the golden model).
      margin: extra candidates (beyond max-k) carried to the rescore.
      select: "auto" | "sort" | "topk" | "seg" | "extract".
      debug: human-readable output instead of checksums.
      use_pallas: run the hand-written kernels (the name is the
        reference's flag; here it selects the CUDA kernels: extraction,
        and the distance/segment-min tile of the "seg" fold).
      precision: first-pass dot precision of the extraction kernel
        ("auto" | "f32" | "bf16"); ``$DMLP_TPU_PRECISION`` overrides.
      device: "cuda" (default) or "cpu" — port only.
    """

    AUTO_SELECT_THRESHOLD = 8192

    mode: str = "single"
    mesh_shape: Optional[Tuple[int, int]] = None
    data_block: Optional[int] = None
    query_block: int = 1024
    dtype: str = "auto"
    exact: bool = True
    margin: int = 16
    select: str = "auto"
    debug: bool = False
    use_pallas: bool = False
    precision: str = "auto"
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.mode not in ("single", "sharded", "ring", "auto"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.precision not in ("auto", "f32", "bf16"):
            raise ValueError(
                f"unsupported first-pass precision {self.precision!r} "
                "(int8 is the gated follow-on — see ROADMAP)")
        if self.select not in ("auto", "sort", "topk", "seg", "extract"):
            raise ValueError(f"unknown select {self.select!r}")
        if (self.data_block is not None and self.data_block <= 0) \
                or self.query_block <= 0:
            raise ValueError("block sizes must be positive")
        if self.margin < 0:
            raise ValueError("margin must be >= 0")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r} "
                             "(want 'cuda' or 'cpu')")

    def torch_device(self):
        """The ``torch.device`` this run uses. Raises when "cuda" is asked
        for and no card is visible — never a silent CPU fallback."""
        import torch
        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run the "
                "plain PyTorch path on the CPU")
        return torch.device(self.device)

    def resolve_dtype(self) -> str:
        """Concrete staging dtype: an explicit choice, else float32 (the
        port stages float32 on both the CPU and the card)."""
        return "float32" if self.dtype == "auto" else self.dtype

    def resolve_precision(self) -> str:
        """Concrete first-pass precision ("f32" | "bf16"):
        ``$DMLP_TPU_PRECISION`` wins when set to a legal value, else the
        configured value with "auto" -> "f32". Fast mode always runs
        "f32" (the low-precision pass is only sound with the f64 rescore
        and boundary repair behind it)."""
        if not self.exact:
            return "f32"
        env = os.environ.get("DMLP_TPU_PRECISION")
        if env in ("f32", "bf16"):
            return env
        return "f32" if self.precision == "auto" else self.precision

    def resolve_select(self, padded_rows: int) -> str:
        """Concrete selection strategy for a dataset of ``padded_rows``."""
        if self.select != "auto":
            return self.select
        if padded_rows <= self.AUTO_SELECT_THRESHOLD:
            return "sort"
        return "extract" if self.use_pallas else "topk"

    def resolve_streaming_select(self, padded_rows: int) -> str:
        """Like resolve_select, for paths that fold blocks with arbitrary
        id arrays: "extract" maps to the array-ids strategy ("seg" with
        the hand kernels, "topk" without)."""
        select = self.resolve_select(padded_rows)
        if select == "extract":
            from dmlp_tpu_torch.ops.topk import streaming_fallback
            return streaming_fallback(self.use_pallas)
        return select

    def resolve_granule(self, select: str) -> int:
        """data_block granularity: whole 1024-column tiles for the fused
        seg producer, whole 128-column segments for plain seg, whole
        extraction-kernel data blocks (ops.extract.BLOCK_ROWS — the CUDA
        kernel's own sub-block width) for "extract", 8 rows otherwise."""
        if select == "seg":
            return 1024 if self.use_pallas else 128
        if select == "extract":
            from dmlp_tpu_torch.ops.extract import BLOCK_ROWS
            return BLOCK_ROWS
        return 8

    def resolve_data_block(self, select: str) -> int:
        if self.data_block is not None:
            return self.data_block
        return 65536 if select in ("topk", "seg", "extract") else 2048
