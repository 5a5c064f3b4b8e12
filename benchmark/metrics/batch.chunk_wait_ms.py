"""batch.chunk_wait_ms: the host's waits on the chunk window per solve,
while the card runs the launches queued ahead (the spans
``single.chunk_wait``), the mean of ``last_phase_ms["chunk_wait"]`` over
the window's solves."""


def read(obs):
    v = [p["chunk_wait"] for p in obs.get("phase_ms") or ()
         if "chunk_wait" in p]
    return sum(v) / len(v) if v else None
