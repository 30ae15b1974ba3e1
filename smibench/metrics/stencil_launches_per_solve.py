"""Launches of the k-sweep and single-sweep stencil kernels a solve,
over the whole window (the program's launch counters, reset when the
window opens). Nothing to read when no stencil kernel launched."""

KERNELS = ("stencil_temporal", "stencil_sweep")


def read(run):
    launches = sum(run.counters.get(k, 0) for k in KERNELS)
    return launches / run.solves if launches else None
