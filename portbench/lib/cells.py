"""Resolution of a cell by name: everything about it is data in
`BENCHMARK.json` and in files found by the names it gives.

- the configuration: the `file` of its `configs` entry;
- the traffic mix: `portbench/traffic/<traffic>.json`;
- the step kind and its judge: `portbench/steps/<step>.py` and
  `portbench/judges/<step>.py`, `step` named by the mix;
- the scene generator: `portbench/inputs/<generator>.py`, named by the
  configuration's `scene`;
- each end-to-end metric's reader: `portbench/e2e/<name>.py`; each
  per-layer metric's: `portbench/metrics/<name>.py`;
- the limits of the numbers compared: `portbench/limits/<cell>.json`.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                   # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"


def load_module(kind: str, name: str):
    """`portbench/<kind>/<name>.py` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]

    @property
    def step_kind(self) -> str:
        return self.traffic["step"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: dict = None, overrides: dict = None) -> Cell:
    """The cell `name` of `bench` (BENCHMARK.json by default);
    `overrides` ({"config": {...}, "traffic": {...}}, merged a level deep)
    shrink it for tests on the CPU."""
    bench = read_json(BENCHMARK) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(ROOT / cfg_entry["file"])
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    for key, part in ((overrides or {}).items()):
        target = config if key == "config" else traffic
        for k, v in part.items():
            if isinstance(v, dict) and isinstance(target.get(k), dict):
                target[k] = {**copy.deepcopy(target[k]), **v}
            else:
                target[k] = v
    limits_path = HERE / "limits" / f"{name}.json"
    limits = read_json(limits_path) if limits_path.is_file() else {}
    return Cell(name=name, workload=w, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
                limits=limits)
