"""Ring-streaming engine — the CLI registry home of ``RingEngine``, as in
``dmlp_tpu/engine/ring.py``. The implementation lives in
``engine.sharded``, which both mesh engines share: they differ only in the
cross-shard merge (an all-gather against a merge-top-k ring all-reduce of
the O(k) accumulator over the "data" axis)."""

from dmlp_tpu_torch.engine.sharded import RingEngine  # noqa: F401
