"""Regression sentinel: fail CI when a tracked perf series regresses.

The analog of the reference's ``tools/perf_gate.py`` inside the port's
package, over the port's ledger (``dmlp_tpu_torch.obs.ledger``), with the
same gated prefixes and the same output. Builds the perf ledger over a
directory and compares, for every GATED series, the latest round against
the previous one:

- a series gates only when the comparison is QUALIFIED: both rounds on
  the same device, both carrying >= MIN_TRIALS per-trial samples (the
  noise band needs raw trials — a single-shot number measures the
  host's state as much as the engine);
- a qualified regression beyond the noise band
  (``compare_points(...)["regressed"]``) FAILS the gate, naming the
  series, rounds, medians, and band;
- unqualified comparisons (``insufficient_trials``,
  ``device_mismatch``) and improvements are REPORTED, never failed —
  honest markers instead of silent skips or false alarms.

Gated series are the timing series with per-trial evidence: the
harness suite (``harness/config*/engine_ms``, which the port's bench
continues on its own device) and any RunRecord series whose points carry
trials.

Usage: python -m dmlp_tpu_torch.perf_gate [--root .] [--json]
       [--min-rounds 2] [--ledger LEDGER.json]
Exit 0 = no qualified regression; 1 = at least one; 2 = usage.
"""

from __future__ import annotations

import argparse
import json
import sys

from dmlp_tpu_torch.obs.ledger import build_ledger, series_deltas

#: series-name prefixes the gate acts on (timing series with trials);
#: everything else in the ledger is report-only. Legacy families
#: (harness/, bench/, trainbench/) double as the CONTINUED names of the
#: migrated RunRecord emitters (obs.ledger._runrecord_series_name); the
#: "{kind}:" prefixes catch RunRecord series with no legacy ancestor.
GATED_PREFIXES = ("harness/", "bench:", "bench/", "trainbench/", "serve/",
                  "fleet/", "slo/",
                  "train:", "engine:", "roofline:", "capacity:",
                  "telemetry/", "prune/", "precision/", "auto/", "hlo/")


def gated(series: str, better: str = "lower") -> bool:
    return (series.startswith(GATED_PREFIXES)
            and better in ("lower", "higher"))


def run_gate(root: str = ".", min_rounds: int = 2,
             ledger: dict = None) -> dict:
    """-> {"regressions": [...], "improvements": [...], "unqualified":
    [...], "checked": N} over every multi-round series. Pass a
    pre-built ``ledger`` (e.g. the LEDGER.json ``dmlp_tpu_torch.report
    --out`` wrote) to skip re-parsing every artifact."""
    if ledger is None:
        ledger = build_ledger(root)
    out = {"regressions": [], "improvements": [], "unqualified": [],
           "within_noise": [], "checked": 0,
           "coverage": ledger["coverage"]}
    for cmp in series_deltas(ledger, min_rounds=min_rounds):
        pts = ledger["series"].get(cmp["series"], [])
        better = pts[-1].get("better", "lower") if pts else "lower"
        if not gated(cmp["series"], better):
            continue
        out["checked"] += 1
        if cmp.get("marker"):
            out["unqualified"].append(cmp)
        elif cmp.get("regressed"):
            out["regressions"].append(cmp)
        elif cmp.get("improved"):
            out["improvements"].append(cmp)
        else:
            out["within_noise"].append(cmp)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dmlp_tpu_torch.perf_gate",
                                 description=__doc__)
    ap.add_argument("--root", default=".",
                    help="directory scanned for perf artifacts")
    ap.add_argument("--ledger", default=None, metavar="LEDGER.json",
                    help="gate a pre-built ledger document "
                         "(dmlp_tpu_torch.report --out) instead of "
                         "re-parsing the artifacts")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable verdict on stdout")
    ap.add_argument("--min-rounds", type=int, default=2)
    args = ap.parse_args(argv)

    ledger = None
    if args.ledger:
        with open(args.ledger) as f:
            ledger = json.load(f)
    res = run_gate(args.root, min_rounds=args.min_rounds, ledger=ledger)
    if args.json:
        print(json.dumps(res, indent=1, sort_keys=True))
    else:
        for cmp in res["unqualified"]:
            print(f"perf_gate: note — {cmp['series']} "
                  f"r{cmp['prev_round']}→r{cmp['cur_round']}: "
                  f"{cmp.get('delta_pct', 'n/a')}% ({cmp['marker']})")
        for cmp in res["improvements"]:
            print(f"perf_gate: improved — {cmp['series']} "
                  f"r{cmp['prev_round']}→r{cmp['cur_round']}: "
                  f"{cmp['delta_pct']:+.1f}% beyond ±{cmp['noise_band']}")
        for cmp in res["within_noise"]:
            print(f"perf_gate: ok — {cmp['series']} "
                  f"r{cmp['prev_round']}→r{cmp['cur_round']}: "
                  f"{cmp.get('delta_pct', 0):+.1f}% within "
                  f"±{cmp['noise_band']}")
    if res["regressions"]:
        for cmp in res["regressions"]:
            print(f"perf_gate: FAIL: {cmp['series']} regressed "
                  f"r{cmp['prev_round']}→r{cmp['cur_round']}: median "
                  f"{cmp['median_prev']} → {cmp['median_cur']} "
                  f"({cmp['delta_pct']:+.1f}%), beyond the noise band "
                  f"±{cmp['noise_band']}", file=sys.stderr)
        return 1
    print(f"perf_gate: {res['checked']} gated series checked — "
          f"{len(res['regressions'])} regressions, "
          f"{len(res['improvements'])} improvements, "
          f"{len(res['unqualified'])} unqualified "
          "(insufficient trials / device mismatch)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
