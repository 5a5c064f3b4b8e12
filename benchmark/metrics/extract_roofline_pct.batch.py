"""extract_roofline_pct.batch: the least time of the traced solves' dense
k-NN work (``cost.work``; the larger of its operations over the card's
peak rate and its bytes over its bandwidth) as a share of the device time
the profiler gave the kernels built from ``extract_topk.cu`` (the split
kernel and the merge)."""

from benchmark.cost.work import least_seconds

KERNELS = ("extract_topk_kernel", "extract_merge_kernel")


def read(obs):
    tr, peaks, work = obs.get("trace"), obs.get("peaks"), obs.get("work")
    if not tr or not peaks or not work or not tr.get("solves"):
        return None
    ksec = sum(s for name, s in tr["kernel_s"].items()
               if any(k in name for k in KERNELS))
    if ksec <= 0:
        return None
    least = least_seconds(work["dense_flops"], work["min_bytes"], peaks)
    return 100.0 * least * tr["solves"] / ksec
