"""batch.enqueue_ms: the batch engine's staging and launches per solve,
the mean of ``last_phase_ms["enqueue"]`` over the window's solves."""


def read(obs):
    v = [p["enqueue"] for p in obs.get("phase_ms") or () if "enqueue" in p]
    return sum(v) / len(v) if v else None
