"""The share of the traced sub-window of the stencil cells in which no
operation ran on the card (1 - the union of device intervals over the
sub-window), in %."""


def read(run):
    if run.trace is None or run.total("cells") is None:
        return None
    return run.trace.idle_pct()
