"""serve.fetch_ms: the resident engine's device wait and readback per
micro-batch, the mean of ``batch_log[].phase_ms["fetch"]`` over the
window."""


def read(obs):
    v = [e["phase_ms"]["fetch"] for e in obs.get("batch_log") or ()
         if "fetch" in e.get("phase_ms", {})]
    return sum(v) / len(v) if v else None
