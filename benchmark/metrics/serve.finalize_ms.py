"""serve.finalize_ms: the resident engine's host float64 finalize and
repair per micro-batch, the mean of ``batch_log[].phase_ms["finalize"]``
over the window."""


def read(obs):
    v = [e["phase_ms"]["finalize"] for e in obs.get("batch_log") or ()
         if "finalize" in e.get("phase_ms", {})]
    return sum(v) / len(v) if v else None
