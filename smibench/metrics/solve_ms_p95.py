"""The 95th percentile of every timed solve's wall in the window, in ms
(host clock; a solve ends with a synchronise of the card), whatever the
configuration's unit of work. Nothing to read in an empty window."""

from smibench import yardstick


def read(run):
    if not run.walls:
        return None
    return yardstick.percentile(run.walls, 95) * 1e3
