"""The k-sweep kernel's share of its roofline: the least time its
passes in the traced sub-window could take (each a pass over the cell's
block at its depth, :func:`smibench.yardstick.ksweep_pass_bound_s`)
over the time the trace gives them. Nothing to read when the trace holds
no launch of it."""

from smibench import yardstick

#: the kernel's name in the trace (``temporal_kernel<K>``)
KERNEL = "temporal_kernel"


def read(run):
    if run.trace is None or not run.facts.get("depth"):
        return None
    ops = run.trace.ops_named(KERNEL)
    if not ops:
        return None
    h, w = run.facts["block"]
    bound_s, _ = yardstick.ksweep_pass_bound_s(h, w, run.facts["depth"])
    spent = sum(e - s for _, s, e in ops)
    return 100.0 * bound_s * len(ops) / spent
