"""sharded.merge_ms: the data-axis merge of the folded lists per solve on
rank 0, the all-gather over NCCL and the re-select, with the wait for the
slowest rank's fold (the span ``sharded.merge``), the mean of
``last_phase_ms["merge"]`` over the window's solves."""


def read(obs):
    v = [p["merge"] for p in obs.get("phase_ms") or () if "merge" in p]
    return sum(v) / len(v) if v else None
