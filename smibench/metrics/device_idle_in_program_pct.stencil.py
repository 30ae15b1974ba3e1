"""The share of the traced sub-window of the stencil cells in which no
operation ran on the card while one of the program's ``smi.*`` spans
was open on some thread, in %: the part of ``device_idle_pct.stencil``
that the program's own host code leaves; the rest is the harness's and
the interpreter's. Nothing to read without solve spans or without
device work."""

from smibench import spans, yardstick


def read(run):
    trace = run.trace
    if not spans.solves(trace) or trace.window_s <= 0:
        return None
    gaps = yardstick.idle_gaps(trace.device_intervals(), *trace.window)
    program = spans.program_intervals(trace)
    idle = sum(max(0.0, min(ge, pe) - max(gs, ps))
               for gs, ge in gaps for ps, pe in program)
    return 100.0 * idle / trace.window_s
