"""batch.finalize_ms: the device-full solve's result loop per solve, one
``QueryResult`` per query (the span ``single.finalize`` under
``single.run_device_full``), the mean of ``last_phase_ms["finalize"]``
over the window's solves."""


def read(obs):
    v = [p["finalize"] for p in obs.get("phase_ms") or ()
         if "finalize" in p]
    return sum(v) / len(v) if v else None
