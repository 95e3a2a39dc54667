"""The benchmark's files: every name in BENCHMARK.json has its file, found
by name; names, units and keys keep to the benchmark's rules; and a new
configuration, cell and per-layer metric are added as files alone."""
from __future__ import annotations

import json
import re

import pytest
from bench_fixtures import ROOT

from benchmark import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert all((ROOT / w).is_file() for w in BENCH["command"][1:2])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["reduced"] == []
    assert 1 <= len(cfg["source"]) <= 200 and 1 <= len(cfg["why"]) <= 200
    assert harness.find("configs", cfg["name"]) == ROOT / cfg["file"]
    loaded = harness.load_json("configs", cfg["name"])
    assert loaded["precision"] in ("bf16", "int8")
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200
    spec = harness.load_json("workloads", cell["name"])
    harness.load_json("traffic", cell["traffic"])
    harness.find("entries", spec["entry"])
    assert spec["checks"], "every cell compares its outputs"
    reported = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert reported, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
    assert callable(harness.load_module("metrics", metric["name"]).read)


def test_setup_metric_and_names_unique():
    e2e = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in e2e
    names = e2e + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_a_new_cell_and_metric_are_files_alone(tiny_root):
    """A configuration, traffic mix, cell and per-layer metric that exist
    only as new files are found by name and run."""
    root, bench = tiny_root
    (root / "metrics" / "frames_traced.py").write_text(
        "def read(t):\n    return t.trace.frames or None\n")
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "test", "moves": "fps"})
    result, numbers, _ = harness.run_cell(bench, "tiny-bf16-clip", 12345, 0.2, 1, "cpu",
                                          (root, harness.HERE))
    assert result["metrics"]["frames_traced"]["value"] == 3
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
