"""Every file the benchmark names loads, and BENCHMARK.json keeps to the
contract's shapes: names, units, keys, bounds, and which cells report
which metrics."""

import json
import re

import pytest

from jxlbench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["jxlbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    c = spec.load_cell(BENCH, cell)
    assert NAME.match(c.name) and NAME.match(c.traffic_name) and NAME.match(c.config_name)
    assert c.chips == 1
    assert len(c.workload["why"]) <= 200 and "\n" not in c.workload["why"]
    for entry in BENCH["workloads"]:
        if entry["name"] == cell:
            assert entry["why"] == c.workload["why"]
            assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    names = {m.name for m in c.metrics}
    e2e = {m.name for m in c.metrics if m.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(not m.end_to_end for m in c.metrics)
    for m in c.metrics:
        assert callable(m.reader.read), m.name
        if not m.end_to_end:
            assert m.entry["moves"] in e2e, (m.name, m.entry["moves"])
    assert (spec.PKG / "entries" / f"{c.workload['entry']}.py").is_file()
    assert names


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = spec.load_json(spec.ROOT / cfg["file"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] == []
    assert (spec.PKG / "images" / f"{data['image']}.py").is_file()
    mod = spec.load_module(spec.PKG / "configs" / f"{cfg['name']}.py")
    for fn in ("encode", "reference", "control", "compare"):
        assert callable(getattr(mod, fn))
    assert data["limits"]
    assert any(c["config"] == cfg["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (spec.PKG / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_paths_are_named_from_names():
    for f in spec.PKG.rglob("*"):
        if ".cache" in f.parts or "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(spec.ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel
