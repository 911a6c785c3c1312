"""BENCHMARK.json keeps the benchmark's format, and every name in it has
its files: a cell's workload, configuration and traffic files, a
per-layer metric's reader with the same unit, layer and moved metric."""

from __future__ import annotations

import json
import re

import pytest

from port_bench import harness, trace

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert NAME.match(cell["name"]) and len(cell["why"]) <= 200
    spec = harness.load_json("workloads", f"{cell['name']}.json")
    for key in ("config", "traffic", "chips"):
        assert spec[key] == cell[key]
    harness.load_json("configs", f"{cell['config']}.json")
    harness.load_json("traffic", f"{cell['traffic']}.json")
    harness.driver(spec["driver"])
    for fam in spec.get("slice", {}).get("families", {}):
        assert trace.family(fam)["per_call"] > 0
    assert spec["check"]["limits"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((harness.CHECKOUT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert config["reduced"] == []


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers(metric):
    reader = harness.metric_reader(metric["name"])
    assert reader.UNIT == metric["unit"] and reader.LAYER == metric["layer"]
    assert reader.MOVES == metric["moves"]
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    assert set(metric["workloads"]) <= set(moved["workloads"])


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
