"""The host's time in the latent attention's glue a training step: the
summed length of the program's ``smi.mla.*`` spans (the latent's
products and norm, the rotations and the assembly of q and k: siblings,
never nested; a checkpointed layer's recompute included) in the traced
window over its ``smi.train.step`` spans, in ms. Nothing to read without
step spans, without device work or without such spans."""

from smibench import mla, spans


def read(run):
    steps = mla.train_steps(run.trace)
    if not steps:
        return None
    glue = spans.inside(run.trace, "smi.mla.")
    if not glue:
        return None
    return 1e3 * sum(e - s for _, s, e in glue) / len(steps)
