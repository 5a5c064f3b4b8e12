"""``python -m dmlp_tpu_torch.check`` — run the static analysis suite.

Exit codes: 0 = clean (or every finding baselined), 1 = new findings,
2 = usage error. ``--json`` keeps stdout pure JSON (narration goes to
stderr), matching the ``check_trace --json`` convention so CI can pipe
the verdict.

Usage::

    python -m dmlp_tpu_torch.check                # R0,R1,R3,R5-R10, the port
    python -m dmlp_tpu_torch.check --families R0  # hygiene only
    python -m dmlp_tpu_torch.check --json         # machine output
    python -m dmlp_tpu_torch.check --write-baseline   # accept findings
    python -m dmlp_tpu_torch.check --stale-allows # dead allow-directives
    python -m dmlp_tpu_torch.check --no-cache ... # bypass ~/.cache
    python -m dmlp_tpu_torch.check path/to/file.py ...  # explicit targets

The port runs every family of the JAX package's checker but two:
``--families R2`` and ``R4`` raise, having no torch analog. The
analyzed sources are the Python modules and the CUDA kernels
(``kernels/*.cu``, read by R8); ``--json`` lists every analyzed CUDA
source with the sha256 of the bytes it read. The default
baseline is ``dmlp_tpu_torch/check/check_baseline.json``, and
``--write-baseline`` without ``--baseline`` writes there (never the
repository root's, which is the JAX package's).

Analysis results are cached per file content hash under
``~/.cache/dmlp_tpu_torch/check`` ($DMLP_TPU_CHECK_CACHE overrides) so
re-runs only re-analyze changed files; ``--no-cache`` opts out.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from dmlp_tpu_torch.check.analyzer import (ALL_FAMILIES, DEFAULT_FAMILIES,
                                           PORTED_FAMILIES,
                                           analyze_paths,
                                           analyze_paths_tracking,
                                           UnportedFamilyError,
                                           check_families, iter_sources,
                                           package_root, relpath,
                                           repo_root,
                                           stale_allow_directives)
from dmlp_tpu_torch.check.baseline import (default_path, diff_baseline,
                                           load_baseline, save_baseline)
from dmlp_tpu_torch.check.cache import CheckCache, content_sha
from dmlp_tpu_torch.check.common import is_cuda_path
from dmlp_tpu_torch.check.findings import RULES


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="dmlp_tpu_torch.check",
                                description=__doc__)
    p.add_argument("paths", nargs="*",
                   help="files/dirs to analyze (default: the "
                        "dmlp_tpu_torch package)")
    p.add_argument("--families", default=None, metavar="R1,R2,...",
                   help=f"rule families to run (default "
                        f"{','.join(DEFAULT_FAMILIES)}; all: "
                        f"{','.join(ALL_FAMILIES)})")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline file (default "
                        "dmlp_tpu_torch/check/check_baseline.json when "
                        "analyzing the package)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: every finding is new")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings as the new baseline "
                        "and exit 0")
    p.add_argument("--json", action="store_true",
                   help="pure-JSON verdict on stdout, narration on "
                        "stderr")
    p.add_argument("--no-cache", action="store_true",
                   help="bypass the per-file fingerprint cache")
    p.add_argument("--stale-allows", action="store_true",
                   help="report `# check: allow-*`/no-retry/"
                        "no-traffic directives that no longer "
                        "suppress any finding (exit 1 if any)")
    p.add_argument("--list-rules", action="store_true")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    families = None
    if args.families:
        families = [f.strip() for f in args.families.split(",") if f.strip()]
        bad = [f for f in families if f not in ALL_FAMILIES]
        if bad:
            p.error(f"unknown families {bad}; valid: "
                    f"{','.join(ALL_FAMILIES)}")
        try:
            check_families(families)
        except UnportedFamilyError as e:
            p.error(str(e))

    import os
    paths = args.paths or [package_root()]
    baseline_path = args.baseline
    if baseline_path is None and not args.paths:
        cand = default_path()
        if os.path.exists(cand):
            baseline_path = cand

    if args.stale_allows:
        # Stale detection needs directive-use tracking from an actual
        # rule run over EVERY family (cached verdicts carry no use
        # info), so this mode always analyzes fresh.
        _findings, modules = analyze_paths_tracking(
            paths, list(PORTED_FAMILIES))
        stale_dirs = stale_allow_directives(modules)
        if args.json:
            json.dump({"check_schema": 1, "mode": "stale-allows",
                       "paths": paths,
                       "stale_allows": [
                           {"path": pa, "line": ln, "directive": d}
                           for pa, ln, d in stale_dirs],
                       "ok": not stale_dirs}, sys.stdout, indent=2)
            sys.stdout.write("\n")
            out = sys.stderr
        else:
            out = sys.stdout
        for pa, ln, d in stale_dirs:
            print(f"STALE-ALLOW {pa}:{ln}: `# check: {d}` no longer "
                  f"suppresses any finding — remove it", file=out)
        print(f"dmlp_tpu_torch.check --stale-allows: {len(stale_dirs)} stale "
              f"directive(s)", file=out)
        return 1 if stale_dirs else 0

    cache = CheckCache(enabled=not args.no_cache)
    findings = analyze_paths(paths, families, cache=cache)

    if args.write_baseline:
        out = args.baseline or default_path()
        save_baseline(out, findings)
        print(f"wrote {len(findings)} finding(s) to {out}",
              file=sys.stderr)
        return 0

    baseline = load_baseline(baseline_path) \
        if baseline_path and not args.no_baseline else {}
    new, matched, stale = diff_baseline(findings, baseline)

    err = sys.stderr
    if args.json:
        sources = list(iter_sources(paths))
        cuda_sources = {}
        for path in sources:
            if is_cuda_path(path):
                with open(path, "rb") as f:
                    cuda_sources[relpath(path, repo_root())] = \
                        content_sha(f.read())
        verdict = {
            "check_schema": 1,
            "families": list(families or DEFAULT_FAMILIES),
            "paths": paths,
            "baseline": baseline_path,
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in new],
            "baselined": len(matched),
            "stale_baseline": [
                {"rule": r, "path": pa, "scope": s, "key": k, "count": n}
                for (r, pa, s, k), n in sorted(stale.items())],
            "cache": {"enabled": cache.enabled, "hits": cache.hits,
                      "misses": cache.misses},
            "files": len(sources),
            "cuda_sources": cuda_sources,
            "ok": not new,
        }
        json.dump(verdict, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        err = sys.stdout
    for f in new:
        print(f"NEW  {f.render()}", file=err)
    for f in matched:
        print(f"BASE {f.render()}", file=err)
    for (r, pa, s, k), n in sorted(stale.items()):
        print(f"STALE baseline entry {r} {pa} [{s}] {k} x{n} — fixed? "
              f"prune it", file=err)
    print(f"dmlp_tpu_torch.check: {len(findings)} finding(s): {len(new)} new, "
          f"{len(matched)} baselined, {len(stale)} stale baseline "
          f"entr{'y' if len(stale) == 1 else 'ies'}", file=err)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
