"""The host's time in the expert layer a training step: the summed
length of the program's ``smi.moe.*`` spans (route, dispatch, experts,
combine: siblings, never nested; a checkpointed layer's recompute
included) in the traced window over its ``smi.train.step`` spans, in
ms. Nothing to read without step spans or without device work."""

from smibench import afmoe, spans


def read(run):
    steps = afmoe.train_steps(run.trace)
    if not steps:
        return None
    moe = spans.inside(run.trace, "smi.moe.")
    return 1e3 * sum(e - s for _, s, e in moe) / len(steps)
