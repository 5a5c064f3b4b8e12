"""Perf ledger: every run artifact, one queryable series store — port of
``dmlp_tpu/obs/ledger.py``, unchanged in behaviour: over the same
directory it builds the same ledger document as the reference's. The one
addition is the port's bench harness, whose RunRecords (tool
``dmlp_tpu_torch.bench``) continue the ``harness/configN/...`` series as
the reference harness's do; every such record names its device (the
card's name, or "cpu"), so it is never compared with a TPU-era round of
the same series (``device_mismatch``).

Five measurement rounds of the reference left ~40 root-level ``BENCH_*/SWEEP_*/
TRAINBENCH_*/...`` artifacts in a dozen private shapes, plus the
schema RunRecords the obs-era emitters write. Nothing could answer
"did config 2 get faster between r04 and r05, beyond link noise?"
without a human opening JSON files. This module is the consolidation
layer:

- :func:`build_ledger` scans a directory for perf artifacts, parses
  each through a family parser (schema RunRecords first, then the
  grandfathered legacy shapes, then a generic numeric walker), and
  returns one versioned ledger document. Files that match the artifact
  patterns but defeat every parser become explicit ``unparseable``
  entries — a ledger that silently drops an artifact would hide exactly
  the regressions it exists to catch.
- Each parsed artifact contributes :class:`SeriesPoint` rows keyed by
  (series name, round, device, dtype): the series name encodes
  workload + config ("harness/config2/engine_ms"), the round comes
  from the envelope (schema-2 RunRecords) or the ``_rNN`` filename
  convention, and per-trial samples ride along when the artifact
  recorded them (``engine_ms_reps``, ``times_ms`` — the raw material
  for noise-aware comparison).
- :func:`compare_points` computes the noise-aware A/B delta between
  two rounds of one series: median-vs-median with a MAD-derived noise
  band when both sides carry >= :data:`MIN_TRIALS` trials, and HONEST
  markers otherwise — ``insufficient_trials`` when either side is a
  single-shot number (the delta is still reported, flagged as
  unqualified), ``device_mismatch`` when the rounds ran on different
  hardware (a v5e-vs-CPU "regression" is not a regression).

``python -m dmlp_tpu_torch.report`` renders the ledger as markdown/JSON;
``python -m dmlp_tpu_torch.perf_gate`` turns the comparisons into a CI
gate.

Import-light and side-effect-free: pure JSON reading.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from dmlp_tpu_torch.obs.run import RunRecord, round_from_name

#: bump on any backward-incompatible ledger-document change
LEDGER_SCHEMA = 1

#: fewest per-trial samples a side needs before a delta is qualified
#: against a noise band instead of marked ``insufficient_trials``
MIN_TRIALS = 3

#: noise band = max(Z * 1.4826 * MAD / sqrt(n), REL_FLOOR * median) —
#: the MAD term models trial scatter, the floor absorbs ms-quantized
#: timers whose 3-trial MAD can collapse to ~0 and declare a 2 ms
#: wobble "significant"
NOISE_Z = 2.0
NOISE_REL_FLOOR = 0.02

#: root-level filename patterns the ledger claims (glob syntax);
#: everything matching one of these MUST end up as an entry — parsed
#: or explicitly unparseable, never silently absent. The ``*_r[0-9]*``
#: catch-alls claim ANY file following the round-suffix convention —
#: the README tells emitters "drop an _rNN-named RunRecord at the
#: root and the ledger picks it up", so an unknown prefix must not be
#: silently invisible.
ARTIFACT_PATTERNS = (
    "BENCH_*.json", "BENCH_*.jsonl", "SWEEP_*.jsonl", "SWEEP_*.json",
    "TRAINBENCH_*.json", "TRAINBENCH_*.jsonl", "TRAIN_CURVE_*.jsonl",
    "ROOFLINE_*.json", "PIPEBENCH_*.json", "HARNESS_*.json",
    "CAPACITY_*.json", "MULTICHIP_*.json", "SCALE_*.json",
    "PROFILE_*.json", "MESH_OVERHEAD_*.json", "OFFLOAD_DECOMP_*.json",
    "WIDEK_MP_*.json", "FUZZ_*.json", "TIE_SEMANTICS_*.json",
    "REPAIR_SWEEP_*.json", "BASELINE.json", "TUNE_*.json",
    "*_r[0-9]*.json", "*_r[0-9]*.jsonl",
)

#: series units whose LOWER values are better (everything timing);
#: key-name suffix heuristics — see _better_direction
_LOWER_BETTER_HINTS = ("_ms", "_s", "_us", "_sec", "ms", "elapsed",
                      "time", "wall", "overhead_pct", "peak_hbm",
                      "breach", "burn")
# NOTE: no bare "pairs" hint — it would substring-match "repairs"
# (a repair COUNT, where more is worse) and invert the gate's verdict;
# qd_pairs_per_sec is already covered by "per_sec".
_HIGHER_BETTER_HINTS = ("per_sec", "per_chip", "mfu",
                       "tflops", "pct_of_roof", "samples", "speedup",
                       "efficiency", "qps")


#: emitters whose per-config records continue ``harness/configN/...``
BENCH_TOOLS = ("dmlp_tpu.bench", "dmlp_tpu_torch.bench")


def _better_direction(metric: str) -> str:
    """"lower" | "higher" | "info" for a metric name — gates only act
    on series with a known direction."""
    low = metric.lower()
    for h in _HIGHER_BETTER_HINTS:
        if h in low:
            return "higher"
    for h in _LOWER_BETTER_HINTS:
        if low.endswith(h) or h in low.split("/")[-1]:
            return "lower"
    return "info"


@dataclasses.dataclass
class SeriesPoint:
    """One measured value of one tracked series in one round."""

    series: str                      # round-independent series key
    value: float
    round: Optional[int] = None
    trials: Optional[List[float]] = None   # raw per-trial samples
    device: str = "unspecified"
    dtype: str = "unspecified"
    source: str = ""                 # artifact file the point came from
    better: str = "lower"            # lower | higher | info
    unit: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items()
                if v not in (None, "", "unspecified") or k == "value"}


def _point(series: str, value, round_: Optional[int], source: str,
           trials=None, device=None, dtype=None,
           unit: str = "") -> Optional[SeriesPoint]:
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(v):
        return None
    tr = None
    if trials:
        tr = [float(t) for t in trials
              if isinstance(t, (int, float)) and math.isfinite(t)]
        tr = tr or None
    return SeriesPoint(series=series, value=v, round=round_, trials=tr,
                       device=str(device or "unspecified"),
                       dtype=str(dtype or "unspecified"), source=source,
                       better=_better_direction(series), unit=unit)


# -- family parsers ----------------------------------------------------------
# Each takes (path, round, docs) where docs is the list of parsed JSON
# values (one per line for .jsonl, one element for .json) and returns a
# list of SeriesPoints; raising or returning None marks the file
# unparseable. Registered in _FAMILIES below, first match wins.

def _is_runrecord(doc) -> bool:
    return (isinstance(doc, dict) and isinstance(doc.get("schema"), int)
            and "kind" in doc and "tool" in doc)


_TRIAL_KEYS = ("engine_ms_reps", "times_ms", "rep_ms", "samples_ms")

# Generic walker caps — announced per entry, never silent.
_GENERIC_MAX_POINTS = 48
_GENERIC_MAX_DEPTH = 5
_SKIP_KEYS = {"schema", "created_unix", "seed", "rc", "n", "np",
              "num_data", "num_queries", "num_attrs", "k", "kc", "kmax",
              "n_chips", "n_devices", "batch", "steps", "config",
              "config_id", "round", "port", "pid",
              # config/shape subtrees: inputs, not measurements
              "shape", "dims", "mesh", "tiles", "variant", "kcap",
              "nq", "na", "dblock", "host"}


def _walk_numeric(doc, prefix: str, out: List[Tuple[str, float]],
                  depth: int = 0) -> int:
    """Collect (path, value) numeric leaves; returns count of leaves
    DROPPED by the caps (the entry records it)."""
    dropped = 0
    if depth > _GENERIC_MAX_DEPTH:
        return 1
    if isinstance(doc, dict):
        for key, v in doc.items():
            if key in _SKIP_KEYS or key.startswith("note"):
                continue
            sub = f"{prefix}/{key}" if prefix else str(key)
            dropped += _walk_numeric(v, sub, out, depth + 1)
    elif isinstance(doc, list):
        # Lists of scalars are trial samples, not separate series;
        # lists of dicts index by position (ladder levels, sweep rows).
        if doc and all(isinstance(x, (int, float)) for x in doc):
            return 0
        for i, v in enumerate(doc[:16]):
            dropped += _walk_numeric(v, f"{prefix}[{i}]", out, depth + 1)
        dropped += max(len(doc) - 16, 0)
    elif isinstance(doc, bool):
        return 0
    elif isinstance(doc, (int, float)):
        if len(out) < _GENERIC_MAX_POINTS:
            out.append((prefix, float(doc)))
        else:
            dropped += 1
    return dropped


def _doc_device(doc) -> Optional[str]:
    if not isinstance(doc, dict):
        return None
    for key in ("device", "device_kind", "platform"):
        v = doc.get(key)
        if isinstance(v, str) and v:
            return v
    shape = doc.get("shape")
    if isinstance(shape, dict):
        v = shape.get("device_kind")
        if isinstance(v, str) and v:
            return v
    return None


def _doc_dtype(doc) -> Optional[str]:
    if not isinstance(doc, dict):
        return None
    v = doc.get("dtype")
    if isinstance(v, str):
        return v
    shape = doc.get("shape")
    if isinstance(shape, dict) and isinstance(shape.get("dtype"), str):
        return shape["dtype"]
    return None


def _trials_for_metric(key: str, metrics: Dict[str, Any]):
    """The per-trial sample list belonging to scalar metric ``key``,
    by the emitters' naming conventions: ``X -> X_reps`` (engine_ms ->
    engine_ms_reps), ``X_median_ms -> X_times_ms`` (the migrated A/B
    tools' per-arm lists: a2a_median_ms -> a2a_times_ms), and the bare
    ``times_ms`` for a bare ``median_ms``/``engine_ms``. Without this,
    an emitter could record 7 honest trials and the gate would still
    mark its series insufficient_trials forever."""
    candidates = [f"{key}_reps"]
    if key.endswith("_median_ms"):
        candidates.append(key[: -len("_median_ms")] + "_times_ms")
    if key in ("median_ms", "engine_ms"):
        candidates.append("times_ms")
    for ck in candidates:
        v = metrics.get(ck)
        if isinstance(v, list) and v:
            return v
    return None


def _runrecord_series_name(rec: RunRecord, key: str) -> str:
    """Series key for one RunRecord metric — LEGACY-COMPATIBLE for the
    emitters that replaced a grandfathered artifact family, so the
    round-over-round trajectory survives the migration (a series that
    changes name at the migration round has no previous round, and the
    gate would pass vacuously right when coverage matters):

    - dmlp_tpu.bench and dmlp_tpu_torch.bench per-config records
      continue the ``HARNESS_rNN`` series (``harness/configN/<metric>``);
    - telemetry snapshot/smoke records (kind "telemetry": the live
      registry serialized as a RunRecord, and tools/telemetry_smoke.py's
      overhead + peak-HBM reconcile) key ``telemetry/<metric>`` — ONE
      family for both emitters so the peak-HBM watermark,
      model-vs-measured delta, and telemetry-overhead series stay
      round-comparable regardless of which tool wrote the round;
    - serving records (kind "serve": the daemon's periodic/final
      snapshot_record and the bench harness's trace-replay A/B) key
      ``serve/<metric>`` — one family for both emitters so sustained
      QPS, latency quantiles, and cold-start compile time stay
      round-comparable (gated by tools/perf_gate.py);
    - tools.trainbench_moe continues ``trainbench/moe/<arm>/<metric>``
      (``a2a_median_ms`` -> ``trainbench/moe/a2a/median_ms``);
    - tools.bench_offload_ladder continues
      ``trainbench/ladder/<level>/<metric>``.

    Everything else keys ``{kind}:{tool}[/configN]/{metric}``."""
    cid = rec.config.get("config_id") if isinstance(rec.config, dict) \
        else None
    if rec.kind == "prune":
        # Pruned-vs-dense A/B records (bench --prune-ab, the prune
        # smoke/capacity tools): one ``prune/`` family regardless of
        # emitter so scanned-bytes and per-arm engine times stay
        # round-comparable (gated by tools/perf_gate.py).
        cfg_tag = f"/config{cid}" if cid is not None else ""
        return f"prune{cfg_tag}/{key}"
    if rec.kind == "precision":
        # bf16-vs-f32 first-pass A/B records (bench --precision-ab,
        # tools/precision_smoke.py): one ``precision/`` family
        # regardless of emitter so the per-arm engine times and the
        # window-inflation meters stay round-comparable (gated by
        # tools/perf_gate.py).
        cfg_tag = f"/config{cid}" if cid is not None else ""
        return f"precision{cfg_tag}/{key}"
    if rec.kind == "auto":
        # Compiler-sharded vs hand-rolled A/B records (bench --auto-ab,
        # make auto-smoke): one ``auto/`` family regardless of emitter
        # so the per-arm engine times and warmup-compile splits stay
        # round-comparable (gated by tools/perf_gate.py).
        cfg_tag = f"/config{cid}" if cid is not None else ""
        return f"auto{cfg_tag}/{key}"
    if rec.kind == "hlo":
        # Compiled-program introspection records (CLI --hlo-report,
        # obs.hlo): one ``hlo/<mode>/<metric>`` series per engine mode
        # so the partitioner-chosen collective-bytes trajectory gates
        # per engine in tools/perf_gate.py — a GSPMD upgrade that
        # silently doubles all-gather traffic on the auto engine can't
        # hide behind the hand-rolled engines' unchanged schedules.
        mode = rec.config.get("mode") if isinstance(rec.config, dict) \
            else None
        tag = (f"/{mode}" if mode
               else (f"/config{cid}" if cid is not None else ""))
        return f"hlo{tag}/{key}"
    if rec.tool in BENCH_TOOLS and cid is not None:
        return f"harness/config{cid}/{key}"
    if rec.kind == "telemetry":
        cfg_tag = f"/config{cid}" if cid is not None else ""
        return f"telemetry{cfg_tag}/{key}"
    if rec.kind == "serve":
        return f"serve/{key}"
    if rec.kind == "tailattrib":
        # Tail-latency attribution (tools/tail_attrib.py over a merged
        # fleet trace): ``fleet/<level>/phase/<metric>`` so the
        # per-phase p99 contribution at each offered-load level gates
        # alongside the end-to-end fleet/<level>/ SLO series it
        # decomposes.
        lvl = rec.config.get("level") if isinstance(rec.config, dict) \
            else None
        tag = f"/{lvl}" if lvl else ""
        return f"fleet{tag}/phase/{key}"
    if rec.kind == "slo":
        # SLO ramp A/B records (fleet.loadgen.ramp_record): one
        # ``slo/<arm>/<metric>`` series per autoscale arm (config
        # "arm" = "predictive" / "reactive"), so the breach count and
        # peak-p99 of each arm gate independently — the predictive
        # arm's zero-breach contract can't hide behind the reactive
        # arm's expected firing.
        arm = rec.config.get("arm") if isinstance(rec.config, dict) \
            else None
        tag = (f"/{arm}" if arm
               else (f"/config{cid}" if cid is not None else ""))
        return f"slo{tag}/{key}"
    if rec.kind == "fleet":
        # Open-loop SLO records (fleet.loadgen) + the router snapshot:
        # one ``fleet/<level>/<metric>`` series per offered-load level
        # (config "level" = "x1", "x2", ... or "router"), so the
        # p99-under-offered-load curve gates level-by-level in
        # tools/perf_gate.py — a regression at x4 can't hide behind an
        # improvement at x1.
        lvl = rec.config.get("level") if isinstance(rec.config, dict) \
            else None
        tag = (f"/{lvl}" if lvl
               else (f"/config{cid}" if cid is not None else ""))
        return f"fleet{tag}/{key}"
    if rec.tool == "tools.trainbench_moe":
        m = re.match(r"(dense|a2a)_(.+)$", key)
        if m:
            return f"trainbench/moe/{m.group(1)}/{m.group(2)}"
        return f"trainbench/moe/{key}"
    if rec.tool == "tools.bench_offload_ladder":
        m = re.match(r"(none|params|all)_(.+)$", key)
        if m:
            return f"trainbench/ladder/{m.group(1)}/{m.group(2)}"
        return f"trainbench/ladder/{key}"
    cfg_tag = f"/config{cid}" if cid is not None else ""
    return f"{rec.kind}:{rec.tool}{cfg_tag}/{key}"


def _parse_runrecord_docs(path: str, round_: Optional[int],
                          docs: List[Any]) -> List[SeriesPoint]:
    """Schema RunRecords (single or JSONL): the by-construction path."""
    points: List[SeriesPoint] = []
    for doc in docs:
        rec = RunRecord.from_dict(doc)     # raises on a newer schema
        r = rec.round if rec.round is not None else round_
        device = rec.device or _doc_device(rec.config) \
            or _doc_device(rec.metrics)
        dtype = _doc_dtype(rec.config) or _doc_dtype(rec.metrics)
        metrics = rec.metrics if isinstance(rec.metrics, dict) else {}
        for key, v in metrics.items():
            if key in _TRIAL_KEYS or key in _SKIP_KEYS \
                    or isinstance(v, bool):
                # identifier/envelope echoes (config id, counts) are
                # inputs, not measurements — same rule as the generic
                # walker's _SKIP_KEYS
                continue
            if isinstance(v, (int, float)):
                pt = _point(_runrecord_series_name(rec, key), v, r, path,
                            trials=_trials_for_metric(key, metrics),
                            device=device, dtype=dtype)
                if pt is not None:
                    points.append(pt)
        # A record with no scalar metrics (e.g. an *_unavailable marker
        # record) still yields a parsed entry with zero series — the
        # caller records it as covered, not dropped.
    return points


def _parse_bench(path: str, round_: Optional[int],
                 docs: List[Any]) -> List[SeriesPoint]:
    """Legacy ``BENCH_rNN.json``: bench.py's {parsed: {metric, value,
    shape}} envelope."""
    (doc,) = docs
    parsed = doc["parsed"]
    shape = parsed.get("shape", {})
    tag = (f"n{shape.get('num_data', '?')}_q{shape.get('num_queries', '?')}"
           f"_a{shape.get('num_attrs', '?')}_k{shape.get('k', '?')}"
           f"_{shape.get('mode', '?')}")
    pts = []
    pt = _point(f"bench/{parsed['metric']}/{tag}", parsed["value"], round_,
                path, device=_doc_device(parsed),
                dtype=(parsed.get("path") or {}).get("dtype"),
                unit=parsed.get("unit", "ms"))
    if pt is None:
        raise ValueError("bench parsed.value not numeric")
    pts.append(pt)
    for extra in ("device_solve_ms", "qd_pairs_per_sec",
                  "vs_reference_binary"):
        p = _point(f"bench/{extra}/{tag}", parsed.get(extra), round_, path)
        if p is not None:
            pts.append(p)
    return pts


def _parse_harness(path: str, round_: Optional[int],
                   docs: List[Any]) -> List[SeriesPoint]:
    """``HARNESS_rNN.json``: the per-config benchmark suite — the
    primary gated series (engine_ms with per-rep trials from r04 on)."""
    (doc,) = docs
    pts = []
    for cfg in doc["configs"]:
        cid = cfg["config"]
        pt = _point(f"harness/config{cid}/engine_ms", cfg.get("engine_ms"),
                    round_, path, trials=cfg.get("engine_ms_reps"),
                    device=_doc_device(cfg), unit="ms")
        if pt is not None:
            pts.append(pt)
        p2 = _point(f"harness/config{cid}/vs_reference_binary",
                    cfg.get("vs_reference_binary"), round_, path)
        if p2 is not None:
            pts.append(p2)
    if not pts:
        raise ValueError("harness file with no usable configs")
    return pts


def _parse_sweep_jsonl(path: str, round_: Optional[int],
                       docs: List[Any]) -> List[SeriesPoint]:
    """``SWEEP_rNN_{cpu,tpu}.jsonl`` (chip-scaling train sweeps) and
    ``SWEEP_WIDEK_*.jsonl`` (kernel-variant sweeps)."""
    base = os.path.basename(path)
    plat = "tpu" if "_tpu" in base else ("cpu" if "_cpu" in base else "")
    widek = "WIDEK" in base.upper()
    pts: List[SeriesPoint] = []
    best_by_kc: Dict[int, float] = {}
    for doc in docs:
        if not isinstance(doc, dict) or "summary" in doc:
            continue
        if widek and "kc" in doc and "ms" in doc:
            kc = int(doc["kc"])
            best_by_kc[kc] = min(best_by_kc.get(kc, float("inf")),
                                 float(doc["ms"]))
            continue
        if "n_chips" in doc and "step_time_ms" in doc:
            tag = f"chips{doc['n_chips']}"
            dev = plat or _doc_device(doc)
            p = _point(f"sweep/step_time_ms/{tag}", doc["step_time_ms"],
                       round_, path, device=dev, dtype=_doc_dtype(doc),
                       unit="ms")
            if p is not None:
                pts.append(p)
            p2 = _point(f"sweep/samples_per_sec_per_chip/{tag}",
                        doc.get("samples_per_sec_per_chip"), round_, path,
                        device=dev, dtype=_doc_dtype(doc))
            if p2 is not None:
                pts.append(p2)
    for kc, ms in sorted(best_by_kc.items()):
        p = _point(f"sweep_widek/best_ms/kc{kc}", ms, round_, path,
                   unit="ms")
        if p is not None:
            pts.append(p)
    if not pts:
        raise ValueError("sweep jsonl with no recognizable rows")
    return pts


def _parse_roofline(path: str, round_: Optional[int],
                    docs: List[Any]) -> List[SeriesPoint]:
    """Legacy ``ROOFLINE_rNN.json`` (r06+ are RunRecords and resolve
    through the RunRecord parser first)."""
    (doc,) = docs
    cor = doc["corrected"]
    dev = _doc_device(doc)
    pts = []
    for key in ("kernel_ms", "extraction_term_ms", "mxu_floor_ms",
                "pct_of_roof"):
        p = _point(f"roofline/{key}", cor.get(key), round_, path,
                   device=dev)
        if p is not None:
            pts.append(p)
    if not pts:
        raise ValueError("roofline file with no corrected block values")
    return pts


def _parse_trainbench(path: str, round_: Optional[int],
                      docs: List[Any]) -> List[SeriesPoint]:
    """``TRAINBENCH_*`` legacy shapes: metric/value (r02/r03/b64k),
    offload ladder (levels list), MoE dispatch A/B."""
    (doc,) = docs
    base = os.path.basename(path)
    tag = re.sub(r"^TRAINBENCH_r\d+_?|\.json$", "", base) or "mlp"
    dev = _doc_device(doc)
    dt = _doc_dtype(doc)
    pts: List[SeriesPoint] = []
    if "levels" in doc:                       # offload ladder
        for lvl in doc["levels"]:
            name = lvl.get("offload", "?")
            for key in ("step_time_ms", "mfu"):
                p = _point(f"trainbench/{tag}/{name}/{key}", lvl.get(key),
                           round_, path, device=dev, dtype=dt)
                if p is not None:
                    pts.append(p)
    elif "dispatch" in doc:                   # MoE dense-vs-a2a
        for name, cell in doc["dispatch"].items():
            p = _point(f"trainbench/moe/{name}/median_ms",
                       cell.get("median_ms"), round_, path, device=dev,
                       dtype=dt, unit="ms")
            if p is not None:
                pts.append(p)
    elif "metric" in doc and "value" in doc:  # metric/value envelope
        pts_extra = [("value", doc["metric"]), ("mfu", "mfu"),
                     ("step_time_ms", "step_time_ms")]
        for key, name in pts_extra:
            p = _point(f"trainbench/{tag}/{name}", doc.get(key), round_,
                       path, device=dev, dtype=dt,
                       unit=doc.get("unit", "") if key == "value" else "")
            if p is not None:
                pts.append(p)
    if not pts:
        raise ValueError("unrecognized TRAINBENCH shape")
    return pts


def _parse_pipebench(path: str, round_: Optional[int],
                     docs: List[Any]) -> List[SeriesPoint]:
    (doc,) = docs
    dev = _doc_device(doc)
    pts = []
    for sweep_name, rows in doc["sweeps"].items():
        for row in rows:
            tag = (f"{sweep_name}/m{row.get('n_micro', '?')}"
                   f"s{row.get('stages', '?')}v{row.get('virtual', '?')}")
            for sched in ("gpipe", "interleaved"):
                cell = row.get(sched)
                if isinstance(cell, dict):
                    p = _point(f"pipebench/{tag}/{sched}/median_ms",
                               cell.get("median_ms"), round_, path,
                               device=dev, unit="ms")
                    if p is not None:
                        pts.append(p)
    if not pts:
        raise ValueError("pipebench file with no sweep rows")
    return pts


def _parse_bf16_legacy(path: str, round_: Optional[int],
                       docs: List[Any]) -> List[SeriesPoint]:
    """Grandfathered ``BENCH_BF16_r04``-era shape, emitted under the
    MIGRATED emitter's series names (``bench:tools.bench_bf16_staging/
    {arm}_median_ms``) so the r04 trajectory continues through the
    RunRecord rounds instead of restarting at the migration."""
    (doc,) = docs
    dev = _doc_device(doc)
    pts = []
    for run in doc["runs"]:
        arm = run.get("staging", "?")
        for key in ("median_ms", "min_ms"):
            p = _point(f"bench:tools.bench_bf16_staging/{arm}_{key}",
                       run.get(key), round_, path,
                       trials=run.get("times_ms") if key == "median_ms"
                       else None, device=dev, unit="ms")
            if p is not None:
                pts.append(p)
    if not pts:
        raise ValueError("BENCH_BF16 file with no runs")
    return pts


def _parse_capacity_legacy(path: str, round_: Optional[int],
                           docs: List[Any]) -> List[SeriesPoint]:
    """Grandfathered ``CAPACITY_BEYOND_HBM_r04``-era shape, emitted
    under the migrated emitter's series names (same continuity
    rationale as the bf16 parser)."""
    (doc,) = docs
    dev = _doc_device(doc)
    pts = []
    for key in ("solve_wall_s", "gen_s", "qd_pairs_per_sec_wall",
                "dataset_vs_hbm", "repairs", "validate_mismatches"):
        p = _point(f"capacity:tools.capacity_beyond_hbm/{key}",
                   doc.get(key), round_, path, device=dev)
        if p is not None:
            pts.append(p)
    if not pts:
        raise ValueError("capacity file with no known metrics")
    return pts


def _parse_generic(path: str, round_: Optional[int],
                   docs: List[Any]) -> List[SeriesPoint]:
    """Last-resort family: walk numeric leaves into series named by
    their JSON path. Keeps single-shape one-off artifacts (PROFILE,
    MESH_OVERHEAD, FUZZ, ...) queryable without a bespoke parser; the
    walker's caps are recorded on the entry by build_ledger."""
    base = os.path.basename(path)
    family = re.sub(r"_r\d+.*$|\.jsonl?$", "", base).lower() or "artifact"
    pts: List[SeriesPoint] = []
    dropped = 0
    for li, doc in enumerate(docs[:32]):
        leaves: List[Tuple[str, float]] = []
        dropped += _walk_numeric(doc, "", leaves)
        prefix = f"{family}" if len(docs) == 1 else f"{family}/line{li}"
        dev = _doc_device(doc)
        dt = _doc_dtype(doc)
        for key, v in leaves:
            p = _point(f"{prefix}/{key}", v, round_, path, device=dev,
                       dtype=dt)
            if p is not None:
                pts.append(p)
    dropped += max(len(docs) - 32, 0)
    if not pts:
        # Valid JSON with no numeric perf content (pass/fail status
        # records like MULTICHIP_*, prose anchors like BASELINE.json):
        # a legitimately series-free artifact — parsed, zero series.
        # Truly unreadable files never reach here (ingest_file catches
        # the JSON decode error first).
        return []
    # Smuggle the drop count to build_ledger via an attribute-free
    # channel: a sentinel info point (explicit, filterable).
    if dropped:
        pts.append(SeriesPoint(series=f"{family}/_generic_leaves_dropped",
                               value=float(dropped), round=round_,
                               source=path, better="info"))
    return pts


#: ordered (predicate, family name, parser); first predicate match wins
_FAMILIES: List[Tuple[Callable[[str, List[Any]], bool], str,
                      Callable[[str, Optional[int], List[Any]],
                               List[SeriesPoint]]]] = [
    (lambda p, docs: all(_is_runrecord(d) for d in docs),
     "runrecord", _parse_runrecord_docs),
    (lambda p, docs: (os.path.basename(p).startswith("BENCH_r")
                      and len(docs) == 1 and isinstance(docs[0], dict)
                      and "parsed" in docs[0]),
     "bench", _parse_bench),
    (lambda p, docs: (os.path.basename(p).startswith("HARNESS")
                      and len(docs) == 1 and isinstance(docs[0], dict)
                      and "configs" in docs[0]),
     "harness", _parse_harness),
    (lambda p, docs: os.path.basename(p).startswith("SWEEP"),
     "sweep", _parse_sweep_jsonl),
    (lambda p, docs: (os.path.basename(p).startswith("ROOFLINE")
                      and len(docs) == 1 and isinstance(docs[0], dict)
                      and "corrected" in docs[0]),
     "roofline", _parse_roofline),
    (lambda p, docs: (os.path.basename(p).startswith("TRAINBENCH")
                      and len(docs) == 1),
     "trainbench", _parse_trainbench),
    (lambda p, docs: (os.path.basename(p).startswith("PIPEBENCH")
                      and len(docs) == 1 and isinstance(docs[0], dict)
                      and "sweeps" in docs[0]),
     "pipebench", _parse_pipebench),
    (lambda p, docs: (os.path.basename(p).startswith("BENCH_BF16")
                      and len(docs) == 1 and isinstance(docs[0], dict)
                      and "runs" in docs[0]),
     "bench_bf16", _parse_bf16_legacy),
    (lambda p, docs: (os.path.basename(p).startswith("CAPACITY_BEYOND")
                      and len(docs) == 1 and isinstance(docs[0], dict)
                      and "solve_wall_s" in docs[0]),
     "capacity", _parse_capacity_legacy),
    (lambda p, docs: True, "generic", _parse_generic),
]


def _load_docs(path: str) -> List[Any]:
    with open(path) as f:
        text = f.read()
    if path.endswith(".jsonl"):
        return [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    return [json.loads(text)]


def ingest_file(path: str) -> Dict[str, Any]:
    """Parse one artifact into an entry dict:
    ``{source, family, round, status, points | error}``."""
    round_ = round_from_name(path)
    entry: Dict[str, Any] = {"source": os.path.basename(path),
                             "round": round_}
    try:
        docs = _load_docs(path)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        entry.update(family="unknown", status="unparseable",
                     error=f"unreadable: {e}")
        return entry
    for pred, family, parser in _FAMILIES:
        try:
            if not pred(path, docs):
                continue
        except Exception:
            continue
        try:
            points = parser(path, round_, docs)
        except Exception as e:
            if family == "generic":
                entry.update(family=family, status="unparseable",
                             error=f"{type(e).__name__}: {e}")
                return entry
            continue  # next family (generic is the terminal fallback)
        dropped = [p for p in points
                   if p.series.endswith("/_generic_leaves_dropped")]
        points = [p for p in points
                  if not p.series.endswith("/_generic_leaves_dropped")]
        entry.update(family=family, status="parsed",
                     points=[p.to_dict() for p in points])
        if dropped:
            entry["generic_leaves_dropped"] = int(dropped[0].value)
        return entry
    entry.update(family="unknown", status="unparseable",
                 error="no family parser accepted the document")
    return entry


def discover_artifacts(root: str) -> List[str]:
    seen = {}
    for pattern in ARTIFACT_PATTERNS:
        for p in glob.glob(os.path.join(root, pattern)):
            if os.path.isfile(p):
                seen[os.path.abspath(p)] = p
    return sorted(seen.values())


def build_ledger(root: str = ".",
                 paths: Optional[List[str]] = None) -> Dict[str, Any]:
    """Ingest every perf artifact under ``root`` (or the explicit
    ``paths``) into one ledger document. Every discovered file becomes
    exactly one entry; coverage is reported explicitly."""
    files = paths if paths is not None else discover_artifacts(root)
    entries = [ingest_file(p) for p in files]
    series: Dict[str, List[Dict[str, Any]]] = {}
    for entry in entries:
        for pd in entry.get("points", []):
            series.setdefault(pd["series"], []).append(pd)
    for pts in series.values():
        pts.sort(key=lambda p: (p.get("round") is None,
                                p.get("round") or 0, p.get("source", "")))
    parsed = sum(1 for e in entries if e["status"] == "parsed")
    return {
        "ledger_schema": LEDGER_SCHEMA,
        "root": os.path.abspath(root),
        "entries": entries,
        "series": series,
        "coverage": {
            "files": len(entries),
            "parsed": parsed,
            "unparseable": len(entries) - parsed,
            "fraction": (parsed / len(entries)) if entries else 1.0,
            "unparseable_sources": [e["source"] for e in entries
                                    if e["status"] != "parsed"],
        },
    }


# -- noise-aware comparison --------------------------------------------------

def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def noise_band(trials: List[float]) -> float:
    """Half-width of the noise band around the trials' median:
    ``max(Z * 1.4826 * MAD / sqrt(n), REL_FLOOR * |median|)``."""
    med = _median(trials)
    mad = _median([abs(t - med) for t in trials])
    sigma = 1.4826 * mad
    return max(NOISE_Z * sigma / math.sqrt(len(trials)),
               NOISE_REL_FLOOR * abs(med))


def compare_points(prev: Dict[str, Any],
                   cur: Dict[str, Any]) -> Dict[str, Any]:
    """Noise-aware delta of ``cur`` vs ``prev`` (two rounds of one
    series, as ledger point dicts). Never silently compares
    incomparables: the result either qualifies the delta against a
    noise band or carries an explicit marker."""
    out: Dict[str, Any] = {
        "series": cur.get("series"),
        "prev_round": prev.get("round"), "cur_round": cur.get("round"),
        "prev": prev.get("value"), "cur": cur.get("value"),
    }
    dev_a = prev.get("device", "unspecified")
    dev_b = cur.get("device", "unspecified")
    if dev_a != dev_b:
        out["marker"] = "device_mismatch"
        out["devices"] = [dev_a, dev_b]
        return out
    pv, cv = float(prev["value"]), float(cur["value"])
    if pv != 0:
        out["delta_pct"] = round((cv - pv) / abs(pv) * 100.0, 2)
    ta, tb = prev.get("trials"), cur.get("trials")
    if not ta or not tb or len(ta) < MIN_TRIALS or len(tb) < MIN_TRIALS:
        out["marker"] = "insufficient_trials"
        out["trials"] = [len(ta or []), len(tb or [])]
        return out
    med_a, med_b = _median(ta), _median(tb)
    band = noise_band(ta) + noise_band(tb)
    out["median_prev"], out["median_cur"] = med_a, med_b
    out["noise_band"] = round(band, 3)
    out["significant"] = abs(med_b - med_a) > band
    better = cur.get("better", "lower")
    if out["significant"] and better in ("lower", "higher"):
        worse = med_b > med_a if better == "lower" else med_b < med_a
        out["regressed"] = worse
        out["improved"] = not worse
    else:
        out["regressed"] = False
        out["improved"] = False
    return out


def _latest_same_device_pair(by_round: Dict[int, Dict[str, Any]],
                             rounds: List[int]):
    """The newest (prev, cur) round pair measured on the SAME device,
    or None. Scans newest-first so the freshest comparable evidence
    wins."""
    for i in range(len(rounds) - 1, 0, -1):
        cur_dev = by_round[rounds[i]].get("device", "unspecified")
        for j in range(i - 1, -1, -1):
            if by_round[rounds[j]].get("device",
                                       "unspecified") == cur_dev:
                return rounds[j], rounds[i]
    return None


def series_deltas(ledger: Dict[str, Any],
                  min_rounds: int = 2) -> List[Dict[str, Any]]:
    """Round-over-round comparisons for every series with at least
    ``min_rounds`` distinct rounds. Points within a round are reduced
    to the LAST one (files sort deterministically).

    Emits the adjacent newest pair (which may carry a
    ``device_mismatch`` marker), AND — when that pair is not the
    newest same-device pair — the newest comparison between rounds on
    one device. Without the second comparison, landing one
    foreign-device round at the root (a CPU-container artifact after a
    TPU series) would silently un-gate the still-comparable earlier
    pair, disabling regression detection exactly by adding data."""
    out = []
    for name, pts in sorted(ledger.get("series", {}).items()):
        by_round: Dict[int, Dict[str, Any]] = {}
        for p in pts:
            r = p.get("round")
            if r is not None:
                by_round[int(r)] = p
        if len(by_round) < min_rounds:
            continue
        rounds = sorted(by_round)
        pairs = [(rounds[-2], rounds[-1])]
        same_dev = _latest_same_device_pair(by_round, rounds)
        if same_dev is not None and same_dev not in pairs:
            pairs.append(same_dev)
        for prev_r, cur_r in pairs:
            cmp = compare_points(by_round[prev_r], by_round[cur_r])
            cmp["series"] = name
            cmp["rounds"] = rounds
            out.append(cmp)
    return out
