"""The host's time in the halo exchange a stencil solve: the summed
length of the program's ``smi.halo.*`` spans in the traced sub-window
(siblings, never nested) over its ``smi.stencil.solve`` spans, in ms.
Nothing to read without solve spans or without device work."""

from smibench import spans


def read(run):
    solves = spans.solves(run.trace)
    if not solves:
        return None
    halo = spans.inside(run.trace, "smi.halo.")
    return 1e3 * sum(e - s for _, s, e in halo) / len(solves)
