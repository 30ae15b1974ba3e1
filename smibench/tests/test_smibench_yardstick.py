"""The frozen arithmetic and the metric readers, on hand-computed values
and synthetic profiler events."""

import pytest

from smibench import spec, yardstick
from smibench.harness import Run
from smibench.trace import SOLVE_SPAN, Trace, parse_chrome_trace


def test_ksweep_bytes_8192_square_k16():
    # 2*h*w + 2k(w+2k) + 2hk = 134217728 + 263168 + 262144 cells of 4 B
    assert yardstick.ksweep_halo_cells(8192, 8192, 16) == 525_312
    t, by = yardstick.ksweep_pass_bound_s(8192, 8192, 16)
    assert by == "bytes"
    assert t == pytest.approx(538_972_160 / 3.35e12, rel=1e-15)


def test_ksweep_bytes_4096_by_2048_k16():
    # 2*4096*2048 + 2*16*2080 + 2*4096*16 = 16777216 + 66560 + 131072
    assert yardstick.ksweep_halo_cells(4096, 2048, 16) == 197_632
    t, by = yardstick.ksweep_pass_bound_s(4096, 2048, 16)
    assert by == "bytes"
    assert t == pytest.approx(67_899_392 / 3.35e12, rel=1e-15)


def test_ksweep_bound_turns_to_operations_when_deep():
    # 4 ops a cell and sweep at 67 TFLOP/s pass 8 B a cell at 3.35 TB/s
    # beyond k = 40
    _, by = yardstick.ksweep_pass_bound_s(1024, 1024, 64)
    assert by == "operations"


def test_work_per_solve():
    assert yardstick.stencil_cell_updates(8192, 8192, 259) == 17_381_195_776


def test_interval_union_merges_overlaps_and_gaps():
    assert yardstick.union_seconds([]) == 0.0
    assert yardstick.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert yardstick.union_seconds([(3, 4), (0, 10)]) == 10.0


def test_idle_gaps():
    assert yardstick.idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [
        (0, 1), (3, 5), (6, 7)]
    assert yardstick.idle_gaps([], 0, 1) == [(0, 1)]
    assert yardstick.idle_gaps([(0, 2)], 0, 1) == []


def test_p95_over_every_solve():
    walls = list(range(1, 101))   # 1..100
    assert yardstick.percentile(walls, 95) == pytest.approx(95.05)
    assert yardstick.percentile([7.0], 95) == 7.0


def _trace(device_ops, host_ops=(), window=(0.0, 1.0)):
    return Trace(list(device_ops), list(host_ops), window)


def _run(trace=None, work=None, walls=(0.5, 0.5), counters=None,
         facts=None):
    return Run({}, {}, facts or {}, work or {}, 3.0, list(walls),
               sum(walls), counters or {}, trace)


def test_chrome_trace_parsing():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": SOLVE_SPAN,
         "ts": 500_000, "dur": 500_000},
        {"ph": "X", "cat": "kernel", "name": "void k<1>(int)",
         "ts": 600_000, "dur": 300_000},
        {"ph": "X", "cat": "user_annotation", "name": SOLVE_SPAN,
         "ts": 1_000_000, "dur": 500_000},
        {"ph": "X", "cat": "user_annotation", "name": SOLVE_SPAN,
         "ts": 1_500_000, "dur": 500_000},
        {"ph": "X", "cat": "kernel", "name": "void k<1>(int)",
         "ts": 1_100_000, "dur": 200_000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD",
         "ts": 1_200_000, "dur": 200_000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 1_400_000, "dur": 500_000},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "not work",
         "ts": 1_000_000, "dur": 1_000_000},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    t = parse_chrome_trace(events)
    # the window opens at the second span: the first holds the
    # profiler's start-up
    assert t.window == pytest.approx((1.0, 2.0))
    assert t.busy_s == pytest.approx(0.3)
    assert t.idle_pct() == pytest.approx(70.0)
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[0][1] == pytest.approx(0.6)
    assert gaps[1][0] == "Python" and gaps[1][1] == pytest.approx(0.1)


def test_trace_without_solve_span_is_refused():
    with pytest.raises(ValueError):
        parse_chrome_trace([])


def test_trace_of_one_solve_spans_that_solve():
    events = [{"ph": "X", "cat": "user_annotation", "name": SOLVE_SPAN,
               "ts": 2_000_000, "dur": 250_000}]
    assert parse_chrome_trace(events).window == pytest.approx(
        (2.0, 2.25))


def test_breakdown_lists_at_most_ten_of_each():
    ops = [(f"k{i}", i, i + 0.5) for i in range(20)]
    b = _trace(ops, window=(0, 20)).breakdown()
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) == 10
    assert b["device_ops"][0][1] == 0.5


def test_readers_idle():
    t = _trace([("a", 0.0, 0.2), ("b", 0.1, 0.3), ("c", 0.5, 0.6)])
    idle = spec.load_module("metrics", "device_idle_pct.stencil")
    assert idle.read(_run(t, work={"cells": 10})) == pytest.approx(60.0)
    assert idle.read(_run(t, work={"rows": 10})) is None
    assert idle.read(_run(None, work={"cells": 1})) is None
    assert idle.read(_run(_trace([]), work={"cells": 1})) is None


def test_roofline_reader():
    bound, _ = yardstick.ksweep_pass_bound_s(8192, 8192, 16)
    name = "void (anonymous namespace)::temporal_kernel<16>(Args)"
    ops = [(name, 0.0, 4 * bound), (name, 1.0, 1.0 + 4 * bound),
           ("(anonymous namespace)::sweep_kernel(float*)", 2.0, 3.0)]
    roof = spec.load_module("metrics", "ksweep_roofline")
    run = _run(_trace(ops, window=(0, 3)), work={"cells": 1},
               facts={"block": [8192, 8192], "depth": 16})
    assert roof.read(run) == pytest.approx(25.0)
    no_kernel = _run(_trace(ops[2:], window=(0, 3)), work={"cells": 1},
                     facts={"block": [8192, 8192], "depth": 16})
    assert roof.read(no_kernel) is None


def test_end_to_end_readers():
    walls = [0.01] * 95 + [0.02] * 5
    run = _run(work={"cells": 1e9}, walls=walls)
    rate = spec.load_module("metrics", "stencil_cells_per_s")
    p95 = spec.load_module("metrics", "solve_ms_p95")
    assert rate.read(run) == pytest.approx(1e11 / sum(walls))
    assert p95.read(run) == pytest.approx(
        yardstick.percentile(walls, 95) * 1e3)
    # the tail of a solve's wall reads whatever the unit of work; the
    # stencil's rate reads only where the work is in cells
    other = _run(work={"rows": 1e9}, walls=walls)
    assert rate.read(other) is None
    assert p95.read(other) == p95.read(run)
    assert p95.read(_run(work={"rows": 1e9}, walls=())) is None
    assert spec.load_module("metrics", "setup_s").read(run) == 3.0


def test_launch_reader():
    launches = spec.load_module("metrics", "stencil_launches_per_solve")
    run = _run(counters={"stencil_temporal": 32, "stencil_sweep": 6},
               walls=(1, 1))
    assert launches.read(run) == 19.0
    assert launches.read(_run(counters={})) is None
