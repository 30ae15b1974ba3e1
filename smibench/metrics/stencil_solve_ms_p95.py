"""The 95th percentile of every stencil solve's wall in the window, in
ms (host clock; a solve ends with a synchronise of the card)."""

from smibench import yardstick


def read(run):
    if run.total("cells") is None:
        return None
    return yardstick.percentile(run.walls, 95) * 1e3
