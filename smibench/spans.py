"""The program's own spans in the traced sub-window: what the port's
``smi.*`` annotations (``smi_tpu_torch.utils.tracing.annotate``) show.

A program without them, or a trace without device work (a run on the
CPU, where a solve's span holds its whole compute), gives nothing to
read: :func:`solves` is then empty.
"""

from __future__ import annotations

from typing import List, Tuple

#: the span around one call of a stencil function
SOLVE = "smi.stencil.solve"

#: every span of the program starts so; ``smi.host.`` spans are the
#: interpreter's (garbage collection), not the program's
PROGRAM = "smi."
HOST = "smi.host."


def inside(trace, prefix: str) -> List[Tuple[str, float, float]]:
    """Host spans named ``prefix...`` that lie wholly in the window."""
    lo, hi = trace.window
    return [op for op in trace.host_ops
            if op[0].startswith(prefix) and lo <= op[1] and op[2] <= hi]


def solves(trace) -> List[Tuple[str, float, float]]:
    """The stencil solve spans in the window; none when the trace holds
    no device operation."""
    if trace is None or not trace.device_ops:
        return []
    return [op for op in inside(trace, SOLVE) if op[0] == SOLVE]


def program_intervals(trace) -> List[Tuple[float, float]]:
    """The union of the program's spans, on any thread, clipped to the
    window: disjoint intervals in order."""
    lo, hi = trace.window
    merged: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi))
                       for name, s, e in trace.host_ops
                       if name.startswith(PROGRAM)
                       and not name.startswith(HOST) and e > lo and s < hi):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]
