"""solve_peak_pct.batch: the dense k-NN operations of every solve in the
window (``cost.work``) over the window's length times the card's peak
rate: the whole solve's share of the card."""


def read(obs):
    peaks, work = obs.get("peaks"), obs.get("work")
    if not peaks or not work or not obs.get("solves") \
            or not obs.get("window_s"):
        return None
    return 100.0 * obs["solves"] * work["dense_flops"] / (
        obs["window_s"] * peaks["dense_flops_per_s"])
