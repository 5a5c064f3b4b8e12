"""serve.batch_queries: queries per micro-batch, the mean ``nq`` of the
resident engine's ``batch_log`` entries over the window."""


def read(obs):
    v = [e["nq"] for e in obs.get("batch_log") or ()]
    return sum(v) / len(v) if v else None
