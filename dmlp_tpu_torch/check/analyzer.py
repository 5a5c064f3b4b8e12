"""Analysis driver: walk sources, build cross-module facts, run rules.

Cross-module context (metric registrations, the package lock graph, the
declared axes, the comms and kernel-cost models, the eps bounds, the
reconcile table) is needed by several families, so analysis is phased:
reduce every file — the Python modules and the CUDA sources — to its
cacheable *facts* (:mod:`.facts`), merge them into one
:class:`~dmlp_tpu_torch.check.facts.PackageFacts`, then run each family over
each module. Unparseable files become a synthetic ``R000`` finding
rather than a crash — a syntax error in the tree is a finding, not an
excuse to skip the gate.

With a :class:`~dmlp_tpu_torch.check.cache.CheckCache` (the CLI default),
both phases key off content hashes: unchanged files load facts without
re-parsing, and files whose (content, merged-facts digest, families)
triple is cached skip rule execution entirely — checker re-runs
only re-analyze what changed.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple

from dmlp_tpu_torch.check.cache import CheckCache, content_sha
from dmlp_tpu_torch.check.common import (CUDA_SUFFIXES, CudaModule,
                                         ModuleInfo, is_cuda_path)
from dmlp_tpu_torch.check.facts import PackageFacts, module_facts
from dmlp_tpu_torch.check.findings import Finding

#: every family name of the JAX package's checker; :func:`build_rules`
#: runs the ported ones and raises, with the reason, for the others
ALL_FAMILIES = ("R0", "R1", "R2", "R3", "R4", "R5", "R6", "R7", "R8",
                "R9", "R10")
#: the families this package runs
PORTED_FAMILIES = ("R0", "R1", "R3", "R5", "R6", "R7", "R8", "R9", "R10")
#: families with no torch analog
NO_ANALOG = {
    "R2": "jit recompilation hazards: eager PyTorch traces nothing",
    "R4": "jax API drift behind utils/compat.py: the port has no compat"
          " shims",
}
#: the default run: every ported family (R0 included — the package has
#: no separate lint gate)
DEFAULT_FAMILIES = PORTED_FAMILIES


class UnportedFamilyError(ValueError):
    """A family this package does not run: one with no torch analog, or
    an unknown name. Never skipped silently."""


def check_families(families: Optional[Sequence[str]]) -> None:
    """Raise :class:`UnportedFamilyError` for a requested family this
    package does not run, naming why."""
    for fam in families or ():
        if fam in NO_ANALOG:
            raise UnportedFamilyError(
                f"family {fam} has no analog in the torch port "
                f"({NO_ANALOG[fam]})")
        if fam not in PORTED_FAMILIES:
            raise UnportedFamilyError(
                f"unknown family {fam}; valid: {','.join(ALL_FAMILIES)}")


def package_root() -> str:
    """Absolute path of the ``dmlp_tpu_torch`` package directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(here)


def repo_root() -> str:
    return os.path.dirname(package_root())


_SOURCE_SUFFIXES = (".py",) + CUDA_SUFFIXES


def iter_sources(paths: Sequence[str]) -> Iterable[str]:
    """Every Python and CUDA source under ``paths``."""
    for p in paths:
        if os.path.isfile(p) and p.endswith(_SOURCE_SUFFIXES):
            yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__"
                                     and not d.startswith("."))
                for fn in sorted(filenames):
                    if fn.endswith(_SOURCE_SUFFIXES):
                        yield os.path.join(dirpath, fn)


def relpath(path: str, root: str) -> str:
    ap = os.path.abspath(path)
    root = os.path.abspath(root)
    if ap.startswith(root + os.sep):
        return os.path.relpath(ap, root).replace(os.sep, "/")
    return os.path.basename(ap)


def load_modules(paths: Sequence[str], root: Optional[str] = None
                 ) -> tuple:
    """(modules, parse_findings) for every source under ``paths``: a
    :class:`ModuleInfo` per Python file, a :class:`CudaModule` per CUDA
    file."""
    root = root or repo_root()
    modules: List[ModuleInfo] = []
    findings: List[Finding] = []
    for path in iter_sources(paths):
        rel = relpath(path, root)
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            cls = CudaModule if is_cuda_path(path) else ModuleInfo
            modules.append(cls(path, rel, source))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            findings.append(Finding(
                "R000", rel, getattr(e, "lineno", 0) or 0, 0, "",
                "unparseable", f"cannot analyze: {e}"))
    return modules, findings


def build_rules(facts: PackageFacts,
                families: Optional[Sequence[str]] = None) -> list:
    from dmlp_tpu_torch.check.autoshard import AutoShardRule
    from dmlp_tpu_torch.check.collectives import CollectiveRule
    from dmlp_tpu_torch.check.concurrency import ConcurrencyRule
    from dmlp_tpu_torch.check.dispatchcost import DispatchCostRule
    from dmlp_tpu_torch.check.hlointro import HloIntroRule
    from dmlp_tpu_torch.check.hostsync import HostSyncRule
    from dmlp_tpu_torch.check.hygiene import HygieneRule
    from dmlp_tpu_torch.check.lowprec import LowPrecRule
    from dmlp_tpu_torch.check.metricnames import MetricNameRule
    from dmlp_tpu_torch.check.resilient import ResilientRule

    check_families(families)
    fams = set(families or DEFAULT_FAMILIES)
    rules = []
    if "R0" in fams:
        rules.append(HygieneRule())
    if "R1" in fams:
        rules.append(CollectiveRule(facts))
        rules.append(DispatchCostRule(facts))
    if "R3" in fams:
        rules.append(HostSyncRule())
    if "R5" in fams:
        rules.append(ResilientRule())
    if "R6" in fams:
        rules.append(MetricNameRule(facts))
    if "R7" in fams:
        rules.append(ConcurrencyRule(facts.concurrency))
    if "R8" in fams:
        rules.append(LowPrecRule(facts))
    if "R9" in fams:
        rules.append(AutoShardRule(facts))
    if "R10" in fams:
        rules.append(HloIntroRule(facts))
    return rules


def run_rules(rules: list, mod, add) -> None:
    """Run ``rules`` over one module: every rule over a Python module,
    only the rules that read CUDA (``cuda = True``) over a CUDA one."""
    cuda = isinstance(mod, CudaModule)
    for rule in rules:
        if not cuda or getattr(rule, "cuda", False):
            rule.run(mod, add)


def analyze_modules(modules: List[ModuleInfo],
                    families: Optional[Sequence[str]] = None,
                    facts: Optional[PackageFacts] = None
                    ) -> List[Finding]:
    if facts is None:
        facts = PackageFacts([(m.relpath, module_facts(m))
                              for m in modules])
    rules = build_rules(facts, families)
    findings: List[Finding] = []
    add = findings.append
    for mod in modules:
        run_rules(rules, mod, add)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_paths(paths: Sequence[str],
                  families: Optional[Sequence[str]] = None,
                  root: Optional[str] = None,
                  cache: Optional[CheckCache] = None) -> List[Finding]:
    check_families(families)
    if cache is not None and cache.enabled:
        findings, _mods = _analyze_cached(paths, families, root, cache)
        return findings
    modules, parse_findings = load_modules(paths, root=root)
    return parse_findings + analyze_modules(modules, families)


def analyze_paths_tracking(paths: Sequence[str],
                           families: Optional[Sequence[str]] = None,
                           root: Optional[str] = None
                           ) -> Tuple[List[Finding], List[ModuleInfo]]:
    """Uncached analysis that also returns the analyzed modules (their
    ``used_allows`` sets feed ``--stale-allows``)."""
    check_families(families)
    modules, parse_findings = load_modules(paths, root=root)
    return parse_findings + analyze_modules(modules, families), modules


def _analyze_cached(paths, families, root, cache: CheckCache):
    """The fingerprint-cached driver (see module docstring)."""
    root = root or repo_root()
    files: List[Tuple[str, str, bytes]] = []   # (path, rel, raw)
    parse_findings: List[Finding] = []
    for path in iter_sources(paths):
        rel = relpath(path, root)
        try:
            with open(path, "rb") as f:
                files.append((path, rel, f.read()))
        except OSError as e:
            parse_findings.append(Finding(
                "R000", rel, 0, 0, "", "unparseable",
                f"cannot analyze: {e}"))
    shas = {rel: content_sha(raw) for _p, rel, raw in files}
    modules: dict = {}
    fact_pairs: List[Tuple[str, dict]] = []
    for path, rel, raw in files:
        facts = cache.get_facts(shas[rel])
        if facts is None:
            mod = _parse(path, rel, raw, parse_findings)
            if mod is None:
                continue
            modules[rel] = mod
            facts = module_facts(mod)
            cache.put_facts(shas[rel], facts)
        fact_pairs.append((rel, facts))
    merged = PackageFacts(fact_pairs)
    ctx = merged.digest()
    fam_key = ",".join(families or DEFAULT_FAMILIES)
    rules = None
    findings: List[Finding] = list(parse_findings)
    for path, rel, raw in files:
        if rel not in shas or not any(r == rel for r, _f in fact_pairs):
            continue                       # unparseable: R000 already out
        key = CheckCache.findings_key(rel, ctx, fam_key)
        cached = cache.get_findings(shas[rel], key)
        if cached is not None:
            findings.extend(Finding(**{k: e[k] for k in (
                "rule", "path", "line", "col", "scope", "key",
                "message")}) for e in cached)
            continue
        mod = modules.get(rel) or _parse(path, rel, raw, parse_findings)
        if mod is None:
            continue
        if rules is None:
            rules = build_rules(merged, families)
        mod_findings: List[Finding] = []
        run_rules(rules, mod, mod_findings.append)
        cache.put_findings(shas[rel], key,
                           [f.to_dict() for f in mod_findings])
        findings.extend(mod_findings)
    cache.flush()
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, modules


def _parse(path, rel, raw, parse_findings):
    cls = CudaModule if is_cuda_path(path) else ModuleInfo
    try:
        return cls(path, rel, raw.decode("utf-8"))
    except (SyntaxError, UnicodeDecodeError) as e:
        parse_findings.append(Finding(
            "R000", rel, getattr(e, "lineno", 0) or 0, 0, "",
            "unparseable", f"cannot analyze: {e}"))
        return None


def analyze_package(families: Optional[Sequence[str]] = None
                    ) -> List[Finding]:
    """Analyze the whole ``dmlp_tpu_torch`` package."""
    return analyze_paths([package_root()], families)


def stale_allow_directives(modules: List[ModuleInfo]
                           ) -> List[Tuple[str, int, str]]:
    """``(relpath, line, directive)`` for every suppression directive
    that silenced nothing in the run that analyzed ``modules`` (run ALL
    families first, or live directives for unrun families report
    stale)."""
    import re
    from dmlp_tpu_torch.check.findings import is_suppression_directive
    # Prose in docstrings/messages mentions directives ("annotate
    # `# check: no-retry`") and parse_directives deliberately picks
    # those up (extra allows are harmless for suppression). For STALE
    # reporting they would be noise, so only well-formed bare tokens
    # count — the backticks/punctuation prose drags along fail this.
    token_re = re.compile(r"^[a-z][a-z-]*(=[A-Za-z0-9]+)?$")
    out: List[Tuple[str, int, str]] = []
    for mod in modules:
        for line, directives in sorted(mod.directives.items()):
            for d in sorted(directives):
                if not token_re.match(d) \
                        or not is_suppression_directive(d):
                    continue
                if (line, d) not in mod.used_allows:
                    out.append((mod.relpath, line, d))
    return out
