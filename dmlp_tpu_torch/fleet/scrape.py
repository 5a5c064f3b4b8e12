"""Fleet OpenMetrics aggregation: N replica scrapes -> one exposition.

Port of ``dmlp_tpu/fleet/scrape.py`` (standard library only). Every
daemon replica exposes its registry on ``--telemetry-port`` (or in its
snapshot file). The fleet view merges them by metric semantics:

- **counters** sum: the fleet served the sum of what its replicas served
  (labeled totals sum per label);
- **histograms** merge bucket-wise: every replica shares the registry's
  fixed log-spaced bounds, so per-``le`` cumulative counts convert to
  per-bucket deltas, sum across replicas over the union of emitted
  bounds, and re-emit cumulative (``_sum``/``_count`` sum), so fleet
  quantiles keep a single replica's error bound;
- **gauges** stay per replica, labeled ``{replica="..."}``: an average of
  a corpus-rows or headroom gauge is a number no process reports.

The merged exposition passes ``obs.telemetry.validate_openmetrics``. The
router's ``--telemetry-port`` serves the same merge live through a
:class:`ScrapeCache`: a replica whose live scrape fails keeps its
last-good counters in the fleet totals, and the reuse is stamped per
replica (``fleet_replica_scrape_age_s`` / ``fleet_replica_scrape_stale``).
"""

from __future__ import annotations

import math
import re
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|histogram)$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{(?P<labels>[^{}]*)\})? (?P<value>\S+)$")


class ParsedExposition:
    """One scrape, decomposed by metric base name."""

    def __init__(self):
        self.kinds: Dict[str, str] = {}
        self.help: Dict[str, str] = {}
        # counters/gauges: base -> {label_body ("" = unlabeled): value}
        self.samples: Dict[str, Dict[str, float]] = {}
        # histograms: base -> {"buckets": [(le, cum)], "sum": x,
        #                      "count": n}
        self.hists: Dict[str, Dict[str, object]] = {}
        self.problems: List[str] = []


def parse_exposition(text: str) -> ParsedExposition:
    """Parse an OpenMetrics text exposition into merge-ready structure
    (tolerant: malformed lines are recorded as problems, not raised —
    a half-written snapshot must not take down the fleet view)."""
    out = ParsedExposition()
    for i, line in enumerate(text.splitlines(), 1):
        if not line or line == "# EOF":
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                out.kinds[m.group(1)] = m.group(2)
            elif line.startswith("# HELP "):
                parts = line.split(" ", 3)
                if len(parts) == 4:
                    out.help[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            out.problems.append(f"line {i}: malformed sample {line!r}")
            continue
        name, labels = m.group("name"), m.group("labels") or ""
        try:
            value = float(m.group("value"))
        except ValueError:
            out.problems.append(f"line {i}: non-numeric {line!r}")
            continue
        # A declared name wins over suffix stripping: a GAUGE legally
        # named ..._count must not be misfiled under a stripped base.
        if name in out.kinds:
            base, kind = name, out.kinds[name]
        else:
            base = re.sub(r"(_total|_bucket|_sum|_count)$", "", name)
            kind = out.kinds.get(base)
        if kind == "histogram":
            h = out.hists.setdefault(
                base, {"buckets": [], "sum": 0.0, "count": 0})
            if name.endswith("_bucket"):
                le = math.inf
                lm = re.search(r'le="([^"]*)"', labels)
                if lm and lm.group(1) != "+Inf":
                    le = float(lm.group(1))
                h["buckets"].append((le, int(value)))
            elif name.endswith("_sum"):
                h["sum"] = value
            elif name.endswith("_count"):
                h["count"] = int(value)
            continue
        tgt = name if kind is None else base
        out.samples.setdefault(tgt, {})[labels] = value
        if kind is None:
            out.problems.append(f"line {i}: sample {name!r} has no "
                                "preceding # TYPE")
    return out


def _bucket_deltas(buckets: List[Tuple[float, int]]
                   ) -> Dict[float, int]:
    """(le, cumulative) pairs (sparse render) -> per-bucket deltas."""
    deltas: Dict[float, int] = {}
    prev = 0
    for le, cum in sorted(buckets, key=lambda b: b[0]):
        deltas[le] = cum - prev
        prev = cum
    return deltas


def _om_num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def merge_expositions(texts: List[str],
                      replica_names: Optional[List[str]] = None
                      ) -> Tuple[str, List[str]]:
    """Merge N scrapes into one fleet exposition; returns (text,
    problems). Kind conflicts across replicas (impossible with one
    codebase, detected anyway) keep the first registration and report."""
    names = replica_names or [f"r{i}" for i in range(len(texts))]
    parsed = [parse_exposition(t) for t in texts]
    problems: List[str] = []
    for name, p in zip(names, parsed):
        problems.extend(f"{name}: {x}" for x in p.problems)

    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for p in parsed:
        for base, kind in p.kinds.items():
            if base in kinds and kinds[base] != kind:
                problems.append(
                    f"kind conflict for {base}: {kinds[base]} vs {kind}")
                continue
            kinds.setdefault(base, kind)
            if base in p.help:
                helps.setdefault(base, p.help[base])

    lines: List[str] = []
    for base in sorted(kinds):
        kind = kinds[base]
        lines.append(f"# TYPE {base} {kind}")
        if base in helps:
            lines.append(f"# HELP {base} {helps[base]}")
        if kind == "counter":
            totals: Dict[str, float] = {}
            for p in parsed:
                for labels, v in p.samples.get(base, {}).items():
                    totals[labels] = totals.get(labels, 0.0) + v
            for labels in sorted(totals):
                lab = f"{{{labels}}}" if labels else ""
                lines.append(
                    f"{base}_total{lab} {_om_num(totals[labels])}")
        elif kind == "gauge":
            for rname, p in zip(names, parsed):
                for labels, v in sorted(p.samples.get(base, {}).items()):
                    lab = (f'{{{labels},replica="{rname}"}}' if labels
                           else f'{{replica="{rname}"}}')
                    lines.append(f"{base}{lab} {_om_num(v)}")
        else:                                           # histogram
            deltas: Dict[float, int] = {}
            total_sum = 0.0
            total_count = 0
            for p in parsed:
                h = p.hists.get(base)
                if not h:
                    continue
                for le, d in _bucket_deltas(h["buckets"]).items():
                    deltas[le] = deltas.get(le, 0) + d
                total_sum += float(h["sum"])
                total_count += int(h["count"])
            deltas.setdefault(math.inf, 0)
            cum = 0
            for le in sorted(deltas):
                cum += deltas[le]
                le_s = "+Inf" if le == math.inf else _om_num(le)
                lines.append(f'{base}_bucket{{le="{le_s}"}} {cum}')
            lines.append(f"{base}_sum {_om_num(total_sum)}")
            lines.append(f"{base}_count {total_count}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n", problems


def counter_total(parsed: ParsedExposition, name: str) -> float:
    """Sum of one counter family's samples across its labels — the
    merged-scrape read path the router's fleet-level availability
    objective samples from (``obs.slo``). Accepts the registry's
    dotted name or the OpenMetrics underscore name."""
    return sum(parsed.samples.get(name.replace(".", "_"), {}).values())


def scrape_url(url: str, timeout_s: float = 10.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return r.read().decode()


class ScrapeCache:
    """Last-good scrape per replica + its monotonic stamp — the
    staleness fix: when a replica's live scrape fails, the merged
    fleet view REUSES the cached exposition (so fleet counter totals
    don't collapse the moment one replica blips) but the reuse is
    STAMPED, never silent — the router publishes
    ``fleet_replica_scrape_age_s`` (seconds since the last good
    scrape, 0 when live) and ``fleet_replica_scrape_stale`` (1 when
    the merge is running on a cached exposition) gauges per replica.
    A replica never scraped contributes nothing (no data to go stale).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 fetch: Callable[[str], str] = scrape_url):
        self._clock = clock
        self._fetch = fetch
        self._lock = threading.Lock()      # leaf: guards the dict only
        self._cache: Dict[str, Tuple[str, float]] = {}

    def fetch(self, name: str, url: str
              ) -> Tuple[Optional[str], float, bool]:
        """-> (exposition text | None, age_s, stale?). The network
        call runs outside the lock."""
        try:
            text = self._fetch(url)
        except OSError:
            with self._lock:
                cached = self._cache.get(name)
            if cached is None:
                return None, 0.0, True
            text, stamp = cached
            return text, max(self._clock() - stamp, 0.0), True
        with self._lock:
            self._cache[name] = (text, self._clock())
        return text, 0.0, False

    def forget(self, name: str) -> None:
        """Drop a retired replica's cache (its counters must not haunt
        the merge after the routing table drops it)."""
        with self._lock:
            self._cache.pop(name, None)


def fleet_view(sources: List[str],
               replica_names: Optional[List[str]] = None,
               timeout_s: float = 10.0) -> Tuple[str, List[str]]:
    """One aggregated exposition from per-replica sources (``http://``
    URLs are scraped, anything else reads as a snapshot file path);
    unreachable replicas become problems, never exceptions — the fleet
    view must degrade, not vanish, when one replica is down."""
    texts: List[str] = []
    names: List[str] = []
    problems: List[str] = []
    wanted = replica_names or [f"r{i}" for i in range(len(sources))]
    for name, src in zip(wanted, sources):
        try:
            if src.startswith(("http://", "https://")):
                texts.append(scrape_url(src, timeout_s=timeout_s))
            else:
                with open(src) as f:
                    texts.append(f.read())
            names.append(name)
        except OSError as e:
            problems.append(f"{name}: unreachable ({e})")
    merged, merge_problems = merge_expositions(texts, names)
    return merged, problems + merge_problems
