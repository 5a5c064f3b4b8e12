"""Measured launch-knob tuning — port of ``dmlp_tpu/tune``.

- :mod:`dmlp_tpu_torch.tune.sweep` times every legal S (K1/K2's data-axis
  split), G (K3's segments per CTA) and prune-scoring chunk, holds each
  against the heuristic's output bit for bit, and picks the fastest;
- :mod:`dmlp_tpu_torch.tune.cache` persists the winners in a small
  versioned JSON file and serves :func:`lookup_variant` to the launch
  paths, which fall back to the deterministic heuristics when there is no
  entry: an absent cache keeps today's behaviour bit for bit.

Regenerate on new hardware with ``python -m dmlp_tpu_torch.tune``.
"""

from __future__ import annotations

from dmlp_tpu_torch.tune.cache import (CACHE_SCHEMA, VariantCache,
                                       cache_path, clear_lookup_memo,
                                       lookup_variant, shape_bucket,
                                       suppressed)

__all__ = ["CACHE_SCHEMA", "VariantCache", "cache_path",
           "clear_lookup_memo", "lookup_variant", "shape_bucket",
           "suppressed"]
