"""batch.pin_ms: the batch engine's pinning of those host copies per
solve (the spans ``single.pin``), the mean of ``last_phase_ms["pin"]``
over the window's solves."""


def read(obs):
    v = [p["pin"] for p in obs.get("phase_ms") or () if "pin" in p]
    return sum(v) / len(v) if v else None
