"""The last line's schema, untraced and traced, from whole runs on the
CPU at a tiny size."""

import json

import pytest

from smibench import harness, spec
from smibench.tests.conftest import TINY

SEED = 2**31 + 7


def _check_schema(result, cell, trace):
    assert list(result)[:5] == ["correct", "attempted", "failed",
                                "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    assert result["attempted"] >= 1 and result["failed"] == 0
    device = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(device)
    names = {m["name"]: m["unit"]
             for m in spec.metrics_for(spec.benchmark(), cell, trace)}
    for name, metric in result["metrics"].items():
        assert metric["unit"] == names[name]
        assert isinstance(metric["value"], float)
    for name, check in result["checks"].items():
        assert set(check) == {"value", "limit"}
    json.loads(json.dumps(result))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_untraced_line_reports_the_end_to_end_metrics(cell):
    result = harness.run_cell(cell, SEED, 0.05, False, "cpu",
                              overrides=TINY[cell])
    _check_schema(result, cell, False)
    e2e = {m["name"] for m in spec.metrics_for(spec.benchmark(), cell,
                                               False)}
    assert set(result["metrics"]) == e2e
    assert "breakdown" not in result and "busy_s" not in result["device"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_line_has_the_trace_window_and_breakdown(cell):
    result = harness.run_cell(cell, SEED, 0.05, True, "cpu",
                              overrides=TINY[cell])
    _check_schema(result, cell, True)
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for entries in result["breakdown"].values():
        assert len(entries) <= 10
        for name, seconds in entries:
            assert isinstance(name, str) and seconds >= 0
    # on the CPU the trace holds no device operation and the kernels'
    # plain versions count no launch: every reader finds nothing
    assert result["metrics"] == {}



def test_traced_solves_are_not_kept_for_the_check(monkeypatch):
    """While a traced solve runs the harness holds no earlier output, and
    when the profiler stops only the newest, so that the trace shows no
    allocation of its own; the solve it judges beside the last is drawn
    from those after the traced ones."""
    import gc
    import weakref

    from smibench import trace as tracing

    cell = "stencil-1x1"
    driver = spec.load_module("drivers", spec.workload(cell)["config"])
    solve, compare = driver.Cell.solve, driver.Cell.compare
    stop = tracing.Profiler.stop
    outputs, judged, held, held_during = {}, [], [], {}

    class Numbered(list):
        pass

    def numbered_solve(self):
        held_during[len(outputs) + 1] = [
            n for n, ref in outputs.items() if ref() is not None]
        out = Numbered(solve(self))
        out.n = len(outputs) + 1
        outputs[out.n] = weakref.ref(out)
        return out

    def recorded_compare(self, kept):
        judged.extend(o.n for o in kept)
        return compare(self, kept)

    def stop_and_look(self):
        stop(self)
        gc.collect()
        held.extend(n for n, ref in outputs.items() if ref() is not None)

    monkeypatch.setattr(driver.Cell, "solve", numbered_solve)
    monkeypatch.setattr(driver.Cell, "compare", recorded_compare)
    monkeypatch.setattr(tracing.Profiler, "stop", stop_and_look)
    result = harness.run_cell(cell, SEED, 0.3, True, "cpu",
                              overrides=TINY[cell])
    assert result["correct"], result["checks"]
    warm, traced = 2, spec.workload(cell)["trace_solves"]
    assert result["attempted"] > traced
    assert held == [warm + traced]   # the newest output alone
    for n in range(1, warm + traced + 1):
        assert held_during[n] == [], n
    assert judged[-1] == warm + result["attempted"]   # the last solve
    assert len(judged) in (1, 2) and judged[0] > warm + traced
