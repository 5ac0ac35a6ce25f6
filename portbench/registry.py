"""Find everything by name: the cell in `BENCHMARK.json`, its
configuration file, its traffic mix under `portbench/traffic/`, the
limits of its comparison under `portbench/limits/`, the driver its mix
names under `portbench/drivers/`, and one reader a per-layer metric
under `portbench/metrics/`. A cell, a configuration, a mix or a metric
is added as new files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    return Cell(name, w, config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str) -> ModuleType:
    """The driver module of a traffic kind: `drivers/<kind>.py`."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(metric: str, here: Path = HERE) -> ModuleType:
    """A per-layer metric's reader, `metrics/<metric name>.py` (names
    may hold dots, so it is loaded by path)."""
    path = here / "metrics" / f"{metric}.py"
    return _load(path, "portbench.metrics." + metric.replace(".", "_"))


def reference(name: str) -> ModuleType:
    """A configuration's plain reference, `reference/<name>.py`."""
    return importlib.import_module(f"portbench.reference.{name}")
