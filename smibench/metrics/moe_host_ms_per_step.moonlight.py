"""The host's time in the expert layer a training step of the
``deepseek_v3`` training cells: the summed length of the program's
``smi.moe.*`` spans (route, dispatch, experts, combine: siblings, never
nested; a checkpointed layer's recompute included) in the traced window
over its ``smi.train.step`` spans, in ms. Nothing to read without step
spans."""

from smibench import mla, spans


def read(run):
    steps = mla.train_steps(run.trace)
    if not steps:
        return None
    moe = spans.inside(run.trace, "smi.moe.")
    return 1e3 * sum(e - s for _, s, e in moe) / len(steps)
