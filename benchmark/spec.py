"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file of its own (``configs/<name>.json``,
``traffic/<name>.json``), and the mix names its driver
(``drivers/<kind>.py``). The metrics a cell reports are the end-to-end
metrics with ``--trace 0`` and the per-layer metrics with ``--trace 1``,
each listed for the cell by its ``workloads`` key, or, without one, for
every cell that reports the metric it ``moves``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
SPEC_PATH = ROOT / "BENCHMARK.json"


class SpecError(ValueError):
    """A cell, configuration, mix or metric that the files do not hold."""


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    bound: float | None = None
    layer: str | None = None
    moves: str | None = None
    workloads: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]


def _metric(obj: Dict[str, Any]) -> Metric:
    w = obj.get("workloads")
    return Metric(name=obj["name"], unit=obj["unit"], better=obj["better"],
                  source=obj["source"], bound=obj.get("bound"),
                  layer=obj.get("layer"), moves=obj.get("moves"),
                  workloads=tuple(w) if w is not None else None)


class Spec:
    """The parsed ``BENCHMARK.json``."""

    def __init__(self, doc: Dict[str, Any], root: Path = ROOT):
        self.doc = doc
        self.root = Path(root)
        self.end_to_end = [_metric(m) for m in doc["end_to_end"]]
        self.per_layer = [_metric(m) for m in doc["per_layer"]]
        self._configs = {c["name"]: c for c in doc["configs"]}
        self._cells = {w["name"]: w for w in doc["workloads"]}

    @classmethod
    def load(cls, path: Path = SPEC_PATH) -> "Spec":
        path = Path(path)
        with open(path) as f:
            return cls(json.load(f), root=path.parent)

    @property
    def cell_names(self) -> List[str]:
        return list(self._cells)

    def cell(self, name: str) -> Cell:
        w = self._cells.get(name)
        if w is None:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                            f"(have: {', '.join(self._cells)})")
        return file_cell(name, w["config"], w["traffic"], int(w["chips"]),
                         self.root / self._configs[w["config"]]["file"])

    def end_to_end_for(self, cell: str) -> List[Metric]:
        return [m for m in self.end_to_end
                if m.workloads is None or cell in m.workloads]

    def per_layer_for(self, cell: str) -> List[Metric]:
        e2e = {m.name for m in self.end_to_end_for(cell)}
        return [m for m in self.per_layer
                if (cell in m.workloads if m.workloads is not None
                    else m.moves in e2e)]

    def metrics_for(self, cell: str, trace: bool) -> List[Metric]:
        return self.per_layer_for(cell) if trace else \
            self.end_to_end_for(cell)


def load_json(path: Path) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing benchmark file {path}") from None


def file_cell(name: str, config: str, traffic: str, chips: int = 1,
              config_path: Path = None) -> Cell:
    """A cell from its configuration's and mix's files alone: how the
    sweep and the controls reach a cell before ``BENCHMARK.json`` lists
    it."""
    path = config_path or BENCH_DIR / "configs" / f"{config}.json"
    return Cell(name=name, config_name=config, traffic_name=traffic,
                chips=chips, config=load_json(path),
                traffic=load_json(BENCH_DIR / "traffic" / f"{traffic}.json"))


def cli_cell(args) -> Cell:
    """The cell a tool names: ``--workload`` from ``BENCHMARK.json``, or
    ``--config`` and ``--traffic`` from their files."""
    if args.workload:
        return Spec.load().cell(args.workload)
    if not (args.config and args.traffic):
        raise SpecError("name --workload, or --config and --traffic")
    return file_cell(f"{args.config}.{args.traffic}", args.config,
                     args.traffic)


def add_cell_args(ap) -> None:
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
