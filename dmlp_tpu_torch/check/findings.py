"""Finding records and their baseline fingerprints.

A finding's *fingerprint* deliberately excludes line/column numbers:
baselined findings must survive unrelated edits above them in the file,
so the stable identity is (rule, path, enclosing scope, detail key) —
the same convention ruff/mypy baselines use. Two identical violations in
the same scope share a fingerprint; the baseline stores multiplicity.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

#: rule id -> one-line description, the ``--list-rules`` catalog. Only
#: the families this package runs are listed (all but R2 and R4).
RULES = {
    # R0 — generic hygiene (the conservative ruff subset)
    "R001": "unused import (ruff F401)",
    "R002": "bare `except:` swallows everything (ruff E722)",
    "R003": "mutable default argument (ruff B006)",
    "R004": "f-string without placeholders (ruff F541)",
    # R1 — collective-axis contract (torch.distributed)
    "R101": "collective's process group names a mesh axis no *_AXIS"
            " constant declares",
    "R102": "collective's axis is not a dim of the mesh its module builds",
    "R103": "collective call site has no analytic comms-model annotation",
    "R104": "comms-model annotation names a function obs/comms.py lacks",
    "R105": "engine top-k kernel call lacks a MeasuredIters/"
            "_queue_iters probe (extraction term degrades to modeled)",
    "R106": "recorded or counted kernel has no obs/kernel_cost _MODELS"
            " entry, or a counted launch records no dispatch",
    # R3 — host-sync hazards (engine/, ops/, parallel/, serve/, fleet/)
    "R301": ".item()/.tolist()/.cpu()/.numpy() forces a device sync",
    "R302": "explicit readback (sanitize.readback) — annotate fenced"
            " sites with `# check: allow-host-sync`",
    "R303": "float()/int()/bool() on a device-producing expression",
    "R304": "np.asarray/np.array on a device-producing expression"
            " (implicit readback; use sanitize.readback)",
    "R305": "Python branch on a device tensor (an implicit __bool__"
            " readback)",
    # R5 — resilience-path silent swallowing
    "R501": "broad `except Exception` in a resilience-wrapped path"
            " without re-raise or `# check: no-retry` annotation",
    # R6 — telemetry metric-name contract (obs.telemetry registry)
    "R601": "registry metric name is not a literal snake_case dotted"
            " string (dynamic names fork unbounded series)",
    "R602": "metric name registered with conflicting kinds"
            " (counter vs gauge vs histogram)",
    # R7 — concurrency discipline (threaded serving/telemetry surface)
    "R701": "lock-order inversion: two locks acquired in opposite"
            " orders across the package (potential deadlock)",
    "R702": "guarded field accessed outside its lock (or a guarded"
            " mutable escapes by reference)",
    "R703": "blocking call (sleep, socket/subprocess wait, CUDA fence,"
            " device readback, collective, thread join) while holding"
            " a lock",
    "R704": "thread started without a join/stop path or a daemon"
            " declaration",
    # R8 — low-precision contract (kernels/*.cu, ops wrappers, TF32)
    "R801": "low-precision accumulator (half/bf16 accumulation in CUDA,"
            " a product on sub-f32 operands, or TF32 turned on)",
    "R802": "sub-f32 cast without a `check: lowp-eps=<fn>` annotation"
            " naming its analytic error bound",
    "R803": "lowp-eps annotation names a function engine/finalize.py"
            " does not define",
    # R9 — DTensor placement contract
    "R901": "mesh dim not a declared axis, or a placements list whose"
            " entry count differs from its mesh's dims",
    "R902": "DTensor placement call in engine/auto.py without explicit"
            " placements",
    "R903": "placements list held in a variable resolves to an entry"
            " count that differs from its mesh's dims",
    # R10 — the collective-record reconcile contract (obs/hlo.py)
    "R1001": "comms-model annotation names a model the obs/hlo.py"
             " reconcile table (MODEL_COLLECTIVE_KINDS) does not map —"
             " the model-vs-record reconcile silently skips the site",
}

#: rule family -> allowlist directive that silences it at a call site.
ALLOW_DIRECTIVES = {
    "R0": "allow-hygiene",
    "R1": "allow-collective",
    "R3": "allow-host-sync",
    "R5": "no-retry",
    "R6": "allow-metric-name",
    "R7": "allow-concurrency",
    "R8": "allow-lowprec",
    "R9": "allow-auto-shard",
    "R10": "allow-hlo-model",
}

#: every directive that SUPPRESSES a finding (for ``--stale-allows``):
#: the family allowlists plus the R1 traffic waiver. A directive of one
#: of these kinds that no longer silences anything is stale and should
#: be pruned. (``noqa`` and the annotations ``comms-model=``/
#: ``lowp-eps=`` are declarations, not suppressions — never reported
#: stale here.) ``allow-concurrency`` also matches its rule-scoped form
#: ``allow-concurrency=R70x``.
SUPPRESSION_DIRECTIVES = tuple(sorted(
    set(ALLOW_DIRECTIVES.values()) | {"no-traffic"}))


def is_suppression_directive(directive: str) -> bool:
    base = directive.split("=", 1)[0]
    return base in SUPPRESSION_DIRECTIVES


def family(rule: str) -> str:
    """"R103" -> "R1"; "R1001" -> "R10". Every rule id is its family
    plus a 2-digit index, so the family is the id minus the last two
    digits (``[:2]`` would misfile R10xx under R1)."""
    return rule[:-2]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site.

    ``key`` is the stable detail used for fingerprinting (no line
    numbers — see module docstring); ``message`` is the human line.
    """

    rule: str
    path: str       # repo-relative, '/'-separated
    line: int
    col: int
    scope: str      # dotted enclosing def/class qualname ('' = module)
    key: str
    message: str

    @property
    def family(self) -> str:
        return family(self.rule)

    def fingerprint(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.scope, self.key)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["family"] = self.family
        return d

    def render(self) -> str:
        where = f"{self.path}:{self.line}:{self.col}"
        scope = f" [{self.scope}]" if self.scope else ""
        return f"{where}: {self.rule}{scope}: {self.message}"
