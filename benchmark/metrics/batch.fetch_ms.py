"""batch.fetch_ms: the batch engine's device wait, on-device vote and
readback per solve, the mean of ``last_phase_ms["fetch"]`` over the
window's solves."""


def read(obs):
    v = [p["fetch"] for p in obs.get("phase_ms") or () if "fetch" in p]
    return sum(v) / len(v) if v else None
