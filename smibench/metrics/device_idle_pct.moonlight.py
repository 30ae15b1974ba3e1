"""The share of the traced window of the ``deepseek_v3`` training cells
in which no operation ran on the card (1 - the union of device intervals
over the window), in %, where the window holds training-step spans."""

from smibench import mla


def read(run):
    if not mla.train_steps(run.trace):
        return None
    return run.trace.idle_pct()
