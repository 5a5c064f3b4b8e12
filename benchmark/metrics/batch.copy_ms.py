"""batch.copy_ms: the batch engine's padded float32 host copies of the
corpus and the queries per solve (the spans ``single.host_copy``), the
mean of ``last_phase_ms["copy"]`` over the window's solves."""


def read(obs):
    v = [p["copy"] for p in obs.get("phase_ms") or () if "copy" in p]
    return sum(v) / len(v) if v else None
