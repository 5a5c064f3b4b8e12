"""batch.launch_ms: the chunk loop's own host time per solve, its stage
calls and K1 launches (the self time of ``single.enqueue_extract`` less
its ``single.chunk_wait`` children), the mean of
``last_phase_ms["launch"]`` over the window's solves."""


def read(obs):
    v = [p["launch"] for p in obs.get("phase_ms") or () if "launch" in p]
    return sum(v) / len(v) if v else None
