"""Every file the benchmark finds by name loads, and BENCHMARK.json
keeps to the names, units and links the harness relies on."""

import json
import re

import pytest

from smibench import spec
from smibench.tests.conftest import reduced_faults

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
    assert reduced_faults(entry, spec.config(config)) == []
    assert hasattr(spec.load_module("drivers", config), "Cell")
    spec.load_module("references", config)


#: a configuration cut to one chip's share: experts held and a vocabulary
#: slice, each with the source's value and the deployment stated
CUT = {"name": "cut", "num_experts": 8, "vocab_size": 25024,
       "published": {"num_experts": 128, "vocab_size": 200192},
       "deployment": "each MoE layer's experts over 16 chips, 8 a chip; "
                     "the vocabulary in eighths"}


@pytest.mark.parametrize("change, fault", [
    ({}, None),
    ({"reduced": ["num_experts", "num_layers"]}, "'num_layers' is not a key"),
    ({"published": {"num_experts": 128}}, "'vocab_size' has no published"),
    ({"published": None}, "no published object"),
    ({"deployment": None}, "no deployment"),
    ({"deployment": " "}, "no deployment"),
], ids=["sound", "key_not_in_file", "published_value_missing",
        "published_missing", "deployment_missing", "deployment_blank"])
def test_reduced_rule(change, fault):
    entry = {"name": "cut",
             "reduced": change.get("reduced", ["num_experts", "vocab_size"])}
    config = {k: v for k, v in {**CUT, **change}.items()
              if k != "reduced" and v is not None}
    faults = reduced_faults(entry, config)
    if fault is None:
        assert faults == []
    else:
        assert any(fault in f for f in faults), faults


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads(metric):
    assert callable(spec.load_module("metrics", metric).read)


@pytest.mark.parametrize("name", CELLS + CONFIGS
                         + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in BENCH["workloads"]]
                         + [k for c in BENCH["configs"] for k in c["reduced"]])
def test_names_use_allowed_characters(name):
    assert spec.NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_fields(metric):
    assert spec.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_end_to_end_bounds_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"]]
    # every cell, those that later PRs add too, reports the set-up time
    # and the tail of a solve's wall
    for name in ("setup_s", "solve_ms_p95"):
        assert "workloads" not in BENCH["end_to_end"][names.index(name)]
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
