"""Every file the benchmark finds by name loads, and BENCHMARK.json
keeps to the names, units and links the harness relies on."""

import json
import re

import pytest

from smibench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["smibench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(spec.BENCHMARK.read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_workload_file_loads_and_matches(cell):
    entry = spec.cell_entry(BENCH, cell)
    workload = spec.workload(cell)
    assert workload["name"] == cell
    assert workload["config"] == entry["config"]
    assert workload["chips"] == entry["chips"] == 1
    assert workload["why"] == entry["why"]
    assert 1 <= len(entry["why"]) <= 200 and "\t" not in entry["why"]
    assert int(workload["trace_solves"]) >= 1
    assert workload["limits"]


@pytest.mark.parametrize("config", CONFIGS)
def test_config_file_driver_and_reference_load(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"smibench/configs/{config}.json"
    assert spec.config(config)["name"] == config
    assert entry["reduced"] == []
    assert hasattr(spec.load_module("drivers", config), "Cell")
    spec.load_module("references", config)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads(metric):
    assert callable(spec.load_module("metrics", metric).read)


@pytest.mark.parametrize("name", CELLS + CONFIGS
                         + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names_use_allowed_characters(name):
    assert spec.NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_fields(metric):
    assert spec.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_end_to_end_bounds_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    # every cell, those that later PRs add too, reports the set-up time
    assert "workloads" not in BENCH["end_to_end"][names.index("setup_s")]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in spec.metrics_for(BENCH, cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(BENCH, cell, True)


def test_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", CELLS)) <= set(moved.get("workloads", CELLS))
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_roofline_and_share_units():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "idle_pct" in m["name"]:
            assert m["unit"] == "%"


def test_command_names_nothing_outside_paths():
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert BENCH["command"][-2:] == ["-m", "smibench"]


def test_workload_files_are_json_data():
    for path in (spec.HERE / "workloads").iterdir():
        json.loads(path.read_text())
        assert re.fullmatch(r"[A-Za-z0-9_.\-]+\.json", path.name)
