"""One run of one cell: the driver the mix names, the readers of the
cell's metrics, and the result line.

Every metric is read by its own reader, ``metrics/<name>.py``, a module
with ``read(obs) -> float | None`` over the observations the driver
returned. A reader that finds nothing to read returns None and the
metric is left out of the line.
"""

from __future__ import annotations

import importlib
import importlib.util
import subprocess
from typing import Any, Dict, Optional

from benchmark.cost.peaks import peaks_for
from benchmark.drivers.common import Outcome, Run
from benchmark.spec import BENCH_DIR, Spec


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader {path}")
    mod_name = "benchmark.metrics._" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


def device_block(r: Run, out: Outcome) -> Dict[str, Any]:
    import torch
    if r.device.type == "cuda":
        kind = torch.cuda.get_device_name(r.device)
        block = {"platform": "gpu", "kind": kind,
                 "count": r.cell.chips,
                 "memory_peak_bytes": out.memory_peak_bytes,
                 "power_limit": power_limit()}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0}
    tr = out.obs.get("trace")
    if r.trace and tr and tr.get("busy_s"):
        block["busy_s"] = tr["busy_s"]
        block["window_s"] = tr["window_s"]
    return block


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float) -> Dict[str, Any]:
    """Run cell ``name`` once and return its result object (without the
    import guard, which the caller applies last)."""
    cell = spec.cell(name)
    r = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
            device=device, t0=t0)
    out = driver(cell.traffic["driver"]).run(r)
    obs = out.obs
    if device.type == "cuda":
        import torch
        obs["peaks"] = peaks_for(torch.cuda.get_device_name(device))
    metrics = {}
    for m in spec.metrics_for(name, trace):
        v = reader(m.name)(obs)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    result: Dict[str, Any] = {
        "correct": bool(out.correct), "attempted": int(out.attempted),
        "failed": int(out.failed), "metrics": metrics,
        "device": device_block(r, out)}
    tr = obs.get("trace")
    if trace and tr and "breakdown" in tr:
        result["breakdown"] = tr["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return result
