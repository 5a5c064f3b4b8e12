"""device_idle_pct.serve: the share of the traced stretch of serving in
which no operation ran on the device (profiler device time, union of
intervals, over the stretch's host-clock length)."""


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
