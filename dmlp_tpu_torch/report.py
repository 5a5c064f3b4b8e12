"""Perf trajectory report: render the ledger (obs.ledger) for humans + CI.

Port of ``dmlp_tpu/report.py``: the same document and the same markdown
over the same directory. ``python -m dmlp_tpu_torch.report`` ingests every perf artifact at the repo
root — schema RunRecords and the grandfathered legacy ``BENCH_*/
SWEEP_*/TRAINBENCH_*/...`` shapes — into one versioned ledger and
renders it:

- a coverage block (how many artifacts parsed; the unparseable ones
  NAMED — never silently dropped);
- per-series round-over-round trajectories for every multi-round
  series, with noise-aware deltas (MAD bands over per-trial samples;
  explicit ``insufficient_trials`` / ``device_mismatch`` markers where
  an honest comparison is impossible);
- a roofline section summarizing the counters-era records
  (%-of-roof, extraction term provenance, obs overhead).

Usage::

    python -m dmlp_tpu_torch.report [--root .] [--out LEDGER.json]
        [--md REPORT.md] [--json] [--min-coverage 0.9]

With no output flags the markdown report prints to stdout. ``--out``
writes the full ledger JSON (the machine-readable artifact
``python -m dmlp_tpu_torch.perf_gate --ledger`` and future rounds
consume); ``--min-coverage`` exits nonzero when the parsed fraction drops
below the floor — the ledger-build smoke.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List

from dmlp_tpu_torch.obs.ledger import (LEDGER_SCHEMA, build_ledger,
                                       series_deltas)


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:,.4g}" if abs(v) < 1e6 else f"{v:,.3e}"
    return str(v)


def _delta_cell(cmp: Dict[str, Any]) -> str:
    marker = cmp.get("marker")
    pct = cmp.get("delta_pct")
    pct_s = f"{pct:+.1f}%" if pct is not None else "n/a"
    if marker:
        return f"{pct_s} ({marker})"
    if cmp.get("regressed"):
        return f"**{pct_s} REGRESSED** (band ±{cmp['noise_band']:.3g})"
    if cmp.get("improved"):
        return f"{pct_s} improved (band ±{cmp['noise_band']:.3g})"
    return f"{pct_s} within noise (band ±{cmp['noise_band']:.3g})"


def _roofline_rows(ledger: Dict[str, Any]) -> List[str]:
    """Roofline/counters summary lines pulled from roofline-family
    series and RunRecord counters blocks."""
    rows = []
    for name, pts in sorted(ledger.get("series", {}).items()):
        if name.startswith("roofline/") or "pct_of_roof" in name \
                or "obs_overhead_pct" in name:
            for p in pts:
                rows.append(
                    f"- `{name}` r{p.get('round', '?')}: "
                    f"{_fmt(p['value'])}"
                    + (f" ({p['device']})"
                       if p.get("device") not in (None, "unspecified")
                       else ""))
    return rows


def _memory_rows(ledger: Dict[str, Any]) -> List[str]:
    """Memory section: the telemetry-era peak-HBM watermark series —
    analytic model, measured watermark (basis-labeled), the
    model-vs-measured delta, and the telemetry overhead A/B. Explicit
    ``mem_stats_unavailable`` marker series render as markers, never
    vanish."""
    rows = []
    for name, pts in sorted(ledger.get("series", {}).items()):
        low = name.lower()
        if not (low.startswith("telemetry/") and (
                "peak_hbm" in low or "mem_" in low
                or "overhead" in low or "watermark" in low)):
            continue
        for p in pts:
            val = p["value"]
            unit = ""
            if "bytes" in low and isinstance(val, (int, float)) \
                    and val > 1 << 20:
                unit = f" ({val / (1 << 20):.1f} MiB)"
            rows.append(
                f"- `{name}` r{p.get('round', '?')}: {_fmt(val)}{unit}"
                + (f" ({p['device']})"
                   if p.get("device") not in (None, "unspecified")
                   else ""))
    return rows


def _slo_rows(ledger: Dict[str, Any]) -> List[str]:
    """SLO section: the ``slo/<arm>/...`` ramp A/B series
    (fleet.loadgen.ramp_record) — per-arm breach cycles, worst burn
    rates, and peak-level latency, so the predictive-vs-reactive
    verdict reads off the report round-over-round."""
    rows = []
    for name, pts in sorted(ledger.get("series", {}).items()):
        if not name.startswith("slo/"):
            continue
        for p in pts:
            rows.append(
                f"- `{name}` r{p.get('round', '?')}: {_fmt(p['value'])}"
                + (f" ({p['device']})"
                   if p.get("device") not in (None, "unspecified")
                   else ""))
    return rows


def render_markdown(ledger: Dict[str, Any]) -> str:
    cov = ledger["coverage"]
    lines = ["# dmlp_tpu perf ledger", ""]
    lines.append(f"Ledger schema {LEDGER_SCHEMA} — {cov['files']} "
                 f"artifacts, {cov['parsed']} parsed "
                 f"({cov['fraction'] * 100:.0f}% coverage), "
                 f"{cov['unparseable']} unparseable.")
    if cov["unparseable_sources"]:
        lines.append("")
        lines.append("Unparseable (explicit, not dropped): "
                     + ", ".join(f"`{s}`"
                                 for s in cov["unparseable_sources"]))
    fams: Dict[str, int] = {}
    for e in ledger["entries"]:
        fams[e.get("family", "?")] = fams.get(e.get("family", "?"), 0) + 1
    lines += ["", "| family | artifacts |", "|---|---|"]
    lines += [f"| {f} | {n} |" for f, n in sorted(fams.items())]

    deltas = series_deltas(ledger)
    lines += ["", "## Round-over-round trajectories", ""]
    if deltas:
        lines += ["| series | rounds | prev → cur | delta |", "|---|---|---|---|"]
        for cmp in deltas:
            rounds = "→".join(f"r{r:02d}" for r in cmp["rounds"][-4:])
            lines.append(
                f"| `{cmp['series']}` | {rounds} "
                f"| {_fmt(cmp['prev'])} → {_fmt(cmp['cur'])} "
                f"| {_delta_cell(cmp)} |")
    else:
        lines.append("(no series spans more than one round yet)")
    single = sum(1 for pts in ledger["series"].values()
                 if len({p.get('round') for p in pts}) < 2)
    lines.append("")
    lines.append(f"{len(ledger['series'])} series total; {single} are "
                 "single-round (tracked, not yet comparable).")

    roof = _roofline_rows(ledger)
    if roof:
        lines += ["", "## Roofline & observability-cost records", ""]
        lines += roof

    slo = _slo_rows(ledger)
    if slo:
        lines += ["", "## SLO", "",
                  "Ramp A/B (fleet.loadgen --ramp): per-arm breach "
                  "cycles and burn rates under escalating offered "
                  "load — the predictive arm's contract is zero "
                  "breach cycles at levels where the reactive arm "
                  "fires.", ""]
        lines += slo

    mem = _memory_rows(ledger)
    if mem:
        lines += ["", "## Memory", "",
                  "Peak-HBM watermarks: analytic model (obs.memwatch) "
                  "vs measured basis, plus the telemetry overhead A/B "
                  "(tools/telemetry_smoke.py).", ""]
        lines += mem
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dmlp_tpu_torch.report",
                                 description=__doc__)
    ap.add_argument("--root", default=".",
                    help="directory scanned for perf artifacts")
    ap.add_argument("--out", default=None, metavar="LEDGER.json",
                    help="write the full ledger JSON here")
    ap.add_argument("--md", default=None, metavar="REPORT.md",
                    help="write the markdown report here (default: "
                         "stdout when --out/--json are absent)")
    ap.add_argument("--json", action="store_true",
                    help="print the ledger JSON to stdout")
    ap.add_argument("--min-coverage", type=float, default=None,
                    help="exit 1 if the parsed fraction is below this "
                         "floor (the ledger-build smoke)")
    args = ap.parse_args(argv)

    # With --json, stdout carries ONLY the ledger document (consumers
    # json.loads it); all narration goes to stderr — same contract as
    # check_trace.py --dist --json.
    def say(msg: str) -> None:
        print(msg, file=sys.stderr if args.json else sys.stdout)

    ledger = build_ledger(args.root)
    md = render_markdown(ledger)
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(ledger, f, indent=1, sort_keys=True)
        os.replace(tmp, args.out)
        cov = ledger["coverage"]
        say(f"report: ledger -> {args.out} ({cov['parsed']}/"
            f"{cov['files']} artifacts parsed, "
            f"{len(ledger['series'])} series)")
    if args.md:
        tmp = args.md + ".tmp"
        with open(tmp, "w") as f:
            f.write(md)
        os.replace(tmp, args.md)
        say(f"report: markdown -> {args.md}")
    if args.json:
        print(json.dumps(ledger, indent=1, sort_keys=True))
    if not (args.out or args.md or args.json):
        print(md)
    if args.min_coverage is not None:
        frac = ledger["coverage"]["fraction"]
        if frac < args.min_coverage:
            print(f"report: FAIL: ledger coverage {frac:.2f} < "
                  f"--min-coverage {args.min_coverage} "
                  f"(unparseable: "
                  f"{ledger['coverage']['unparseable_sources']})",
                  file=sys.stderr)
            return 1
        say(f"report: coverage {frac:.2f} >= {args.min_coverage} ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
