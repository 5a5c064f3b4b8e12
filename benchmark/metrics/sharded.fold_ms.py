"""sharded.fold_ms: rank 0's fold of its held shard per solve, its chunk
casts and K1 launches up to the card's end (the span
``sharded.enqueue_chunked`` under ``sharded.held_device_full``), the mean
of ``last_phase_ms["fold"]`` over the window's solves."""


def read(obs):
    v = [p["fold"] for p in obs.get("phase_ms") or () if "fold" in p]
    return sum(v) / len(v) if v else None
