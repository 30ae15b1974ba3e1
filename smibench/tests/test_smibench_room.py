"""Room for a configuration that is not a stencil. A fixture's
configuration, cell and per-layer metric (its files under ``fixture/``,
its entries added to ``BENCHMARK.json``'s in the test alone) run through
the harness on the CPU: its solve is a few matmuls with the work in
flops, its ``reduced`` is not empty, and it reports the end-to-end
metrics every cell reports and nothing of the stencil's.

The fixture's limit of ``out_max_abs_err``, 1e-4, lies between the
float32 stage's widest gap to the float64 reference, 1.78e-06 over 40
seeds, and the bfloat16 control's narrowest, 0.0228."""

import json
from pathlib import Path

import pytest

from smibench import harness, spec
from smibench.tests.conftest import reduced_faults

FIXTURE = Path(__file__).resolve().parent / "fixture"
CELL, CONFIG = "mlp-tiny", "mlp_fixture"
SEED = 2**31 + 29


@pytest.fixture
def bench(monkeypatch, tmp_path):
    """The benchmark with the fixture's entries, found by ``spec`` ahead
    of the benchmark's own files."""
    bench = spec.benchmark()
    for key, entries in spec.load_json(FIXTURE / "entries.json").items():
        bench[key] = bench[key] + entries
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "BENCHMARK", path)
    monkeypatch.setattr(spec, "DIRS", (FIXTURE,) + spec.DIRS)
    return bench


def test_fixture_cell_reports_what_every_cell_reports(bench):
    e2e = [m["name"] for m in spec.metrics_for(bench, CELL, False)]
    assert sorted(e2e) == ["setup_s", "solve_ms_p95"]
    layers = spec.metrics_for(bench, CELL, True)
    assert [m["name"] for m in layers] == ["mlp_flop_per_s"]
    assert all(m["moves"] in e2e for m in layers)


def test_fixture_configuration_keeps_the_cut_rule(bench):
    entry = spec.cell_entry(bench, CELL)
    assert spec.workload(CELL)["config"] == entry["config"] == CONFIG
    config_entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert config_entry["reduced"]
    assert reduced_faults(config_entry, spec.config(CONFIG)) == []


def test_fixture_cell_runs_through_the_harness(bench):
    result = harness.run_cell(CELL, SEED, 0.05, False, "cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "solve_ms_p95"}
    assert result["metrics"]["solve_ms_p95"]["unit"] == "ms"
    assert result["metrics"]["solve_ms_p95"]["value"] > 0


def test_fixture_traced_run_reads_its_layer(bench):
    result = harness.run_cell(CELL, SEED, 0.05, True, "cpu")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"mlp_flop_per_s"}


def test_fixture_control_is_not_correct(bench):
    result = harness.run_cell(CELL, SEED, 0.0, False, "cpu",
                              program="control")
    assert not result["correct"], result["checks"]
