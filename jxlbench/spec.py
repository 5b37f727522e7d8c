"""What a run reads from files: BENCHMARK.json at the checkout's root, and
the benchmark's own files, each found by the name that BENCHMARK.json
gives it:

    jxlbench/configs/<config>.json     sizes, encoder options, limits
    jxlbench/configs/<config>.py       its stream and its plain reference
    jxlbench/workloads/<cell>.json     entry, traffic, corpus, why
    jxlbench/entries/<entry>.py        the call into the program
    jxlbench/images/<kind>.py          the image generator
    jxlbench/metrics/<metric>.py       a metric's reader

A new configuration, cell or metric is new files and new entries in
BENCHMARK.json; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import threading
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
_LOAD_LOCK = threading.RLock()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str | None = None):
    """Import a file by path (names may hold dots, so not by import), once a
    process; threads that ask meanwhile wait for the first."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = name or "jxlbench_file_" + re.sub(r"\W", "_", path.relative_to(PKG).as_posix())
    with _LOAD_LOCK:
        if name in sys.modules:
            return sys.modules[name]
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
        return mod


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    entry: dict
    reader: object = None

    def applies(self, cell: str) -> bool:
        return "workloads" not in self.entry or cell in self.entry["workloads"]


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    workload: dict
    codec: object
    metrics: list = field(default_factory=list)

    @property
    def height(self) -> int:
        return self.workload["image"]["height"]

    @property
    def width(self) -> int:
        return self.workload["image"]["width"]


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: the benchmark's description is missing")
    return load_json(path)


def cell_files(name: str, overrides: dict | None = None) -> Cell:
    """The cell `name` from its own files alone (no metrics): its workload
    file, with `overrides` replacing top-level keys (the tests' small
    sizes), and the configuration that file names."""
    workload = load_json(PKG / "workloads" / f"{name}.json")
    workload.update(overrides or {})
    cfg = workload["config"]
    return Cell(name, cfg, name.split(".", 1)[1], 1, load_json(PKG / "configs" / f"{cfg}.json"),
                workload, load_module(PKG / "configs" / f"{cfg}.py"))


def load_cell(bench: dict, name: str, root: Path = ROOT, overrides: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files and metrics loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cell = cell_files(name, overrides)
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    if cell.config_name != w["config"] or root / cfg_file != PKG / "configs" / f"{w['config']}.json":
        raise ValueError(f"{name}: BENCHMARK.json and the workload file name other configurations")
    cell.chips = w["chips"]
    for kind, e2e in (("end_to_end", True), ("per_layer", False)):
        for m in bench[kind]:
            metric = Metric(m["name"], m["unit"], m["better"], m["source"], e2e, m)
            if metric.applies(name):
                metric.reader = load_module(PKG / "metrics" / f"{m['name']}.py")
                cell.metrics.append(metric)
    return cell
