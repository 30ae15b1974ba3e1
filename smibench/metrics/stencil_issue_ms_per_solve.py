"""The host's time to issue one stencil solve: the median length of the
program's ``smi.stencil.solve`` spans in the traced sub-window, in ms.
The span closes when the stencil function returns, before the harness
synchronises the card: it holds the launches' enqueue and the halo
work's, not the device's time. Nothing to read without such spans or
without device work."""

import statistics

from smibench import spans


def read(run):
    solves = spans.solves(run.trace)
    if not solves:
        return None
    return 1e3 * statistics.median(e - s for _, s, e in solves)
