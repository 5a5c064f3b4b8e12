"""queries_per_s: every query answered in the window over the window's
length (host clock); the window ends with its last whole solve."""


def read(obs):
    if obs.get("queries_done") is None or not obs.get("window_s"):
        return None
    return obs["queries_done"] / obs["window_s"]
