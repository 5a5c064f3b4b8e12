"""Versioned run-artifact records — port of ``dmlp_tpu/obs/run.py``.

:class:`RunRecord` is the small versioned envelope (schema, tool, kind,
host context, round, device) around free-form ``config``/``metrics``
payloads plus the structured observability blocks (``counters`` from
obs.counters, ``comms`` from obs.comms, ``artifacts``). The schema and
the field names are the reference's, so the reference's readers load the
port's records. ``write`` emits one record per file, ``append_jsonl`` one
record per line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import re
import time
from typing import Any, Dict, Optional

#: bump on any backward-incompatible field change; consumers key on this
SCHEMA_VERSION = 2


def round_from_name(path: str) -> Optional[int]:
    """The measurement round encoded in an artifact filename (the
    ``_rNN`` convention: BENCH_r05.json -> 5), or None."""
    m = re.search(r"_r(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else None


def current_device(device=None) -> str:
    """The device kind for the envelope's ``device`` field:
    ``torch.cuda.get_device_name`` of ``device`` (default: the current
    card) when it is a CUDA device and a card is present, else "cpu". A
    CPU engine on a machine with a card says "cpu"."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def _host_context() -> Dict[str, Any]:
    ctx: Dict[str, Any] = {"python": platform.python_version()}
    try:
        import torch
        ctx["torch"] = torch.__version__
        if torch.version.cuda:
            ctx["cuda"] = torch.version.cuda
    except ImportError:
        pass
    return ctx


@dataclasses.dataclass
class RunRecord:
    """One run's artifact: envelope + payload.

    ``kind`` names the workload family ("engine", "serve", "telemetry",
    ...); ``tool`` names the emitter (e.g. "dmlp_tpu_torch.serve")."""

    kind: str
    tool: str
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    counters: Optional[Dict[str, Any]] = None
    comms: Optional[Dict[str, Any]] = None
    artifacts: Dict[str, str] = dataclasses.field(default_factory=dict)
    round: Optional[int] = None      # schema 2: measurement round (_rNN)
    device: Optional[str] = None     # schema 2: device kind measured on
    schema: int = SCHEMA_VERSION
    created_unix: float = dataclasses.field(default_factory=time.time)
    host: Dict[str, Any] = dataclasses.field(default_factory=_host_context)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v not in (None, {})}

    def to_json(self) -> str:
        try:
            return json.dumps(self.to_dict(), sort_keys=True)
        except TypeError as e:
            raise TypeError(
                f"RunRecord for tool={self.tool!r} contains a "
                f"non-JSON-serializable value: {e}") from None

    def write(self, path: str) -> str:
        """One record per file (atomic rename)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json() + "\n")
        os.replace(tmp, path)
        return path

    def append_jsonl(self, path: str) -> str:
        """One record per line, appended."""
        line = self.to_json()
        with open(path, "a") as f:
            f.write(line + "\n")
        return path

    @staticmethod
    def load(path: str) -> "RunRecord":
        with open(path) as f:
            return RunRecord.from_dict(json.loads(f.readline()))

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RunRecord":
        known = {f.name for f in dataclasses.fields(RunRecord)}
        schema = d.get("schema")
        if schema is not None and schema > SCHEMA_VERSION:
            raise ValueError(f"RunRecord schema {schema} is newer than "
                             f"this reader ({SCHEMA_VERSION})")
        return RunRecord(**{k: v for k, v in d.items() if k in known})
