"""The readers of the program's spans, on hand-made traces: the exact
value of each, and nothing to read where the program opened no solve
span (a program without spans) or the trace shows no device work."""

import pytest

from smibench import spec
from smibench.harness import Run
from smibench.trace import SOLVE_SPAN, Trace

READERS = ("stencil_issue_ms_per_solve", "halo_host_ms_per_solve",
           "device_idle_in_program_pct.stencil")

#: the window runs from the second harness solve to the last: 1.0-3.0 s
HARNESS = [(SOLVE_SPAN, 0.0, 1.0), (SOLVE_SPAN, 1.0, 2.0),
           (SOLVE_SPAN, 2.0, 3.0)]
PROGRAM = [
    ("smi.stencil.solve", 0.1, 0.5),      # before the window: not read
    ("smi.halo.phase1", 0.2, 0.3),        # before the window: not read
    ("smi.stencil.solve", 1.1, 1.3),
    ("smi.halo.phase1", 1.15, 1.17),
    ("smi.halo.finish", 1.2, 1.21),
    ("smi.world.rank", 1.95, 2.05),       # another thread's span
    ("smi.stencil.solve", 2.1, 2.5),
    ("smi.halo.phase2", 2.2, 2.25),
    ("smi.host.gc.gen2", 2.92, 2.98),     # the interpreter's, not the port's
    ("aten::slice", 2.93, 2.94),
]
DEVICE = [("k", 1.25, 1.9), ("k", 2.3, 2.9)]


def _run(device=DEVICE, host=HARNESS + PROGRAM, trace=True):
    t = Trace(list(device), list(host), (1.0, 3.0)) if trace else None
    return Run({}, {}, {}, {"cells": 1.0}, 3.0, [1.0, 1.0], 2.0, {}, t)


def _read(name, run):
    return spec.load_module("metrics", name).read(run)


def test_issue_time_is_the_median_solve_span():
    # the window's solve spans last 0.2 and 0.4 s
    assert _read("stencil_issue_ms_per_solve", _run()) == pytest.approx(300.0)


def test_halo_time_is_the_sum_of_halo_spans_over_the_solves():
    # 0.02 + 0.01 + 0.05 s over two solves
    assert _read("halo_host_ms_per_solve", _run()) == pytest.approx(40.0)


def test_idle_in_program_is_idle_under_a_program_span():
    # idle 1.0-1.25, 1.9-2.3 and 2.9-3.0; under program spans 1.1-1.25,
    # 1.95-2.05 and 2.1-2.3 (the collector's span does not count): 0.45
    # of the 2.0 s window
    assert _read("device_idle_in_program_pct.stencil",
                 _run()) == pytest.approx(22.5)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_program_spans(name):
    assert _read(name, _run(host=HARNESS)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_device_work(name):
    assert _read(name, _run(device=[])) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_untraced(name):
    assert _read(name, _run(trace=False)) is None


def test_breakdown_names_the_program_span_a_gap_falls_in():
    gaps = dict((round(s, 6), n)
                for n, s in _run().trace.breakdown()["idle_gaps"])
    assert gaps[0.25] == "smi.stencil.solve"            # 1.0-1.25
    assert gaps[0.4] == "Python after smi.world.rank"   # 1.9-2.3
    assert gaps[0.1] == "smi.host.gc.gen2"              # 2.9-3.0
