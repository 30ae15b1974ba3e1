"""The bf16 flash kernels' share of their roofline in the afmoe cells:
the least time their traced launches could take at the card's bf16 peak
(each launch of ``flash_bf16_kernel``, ``flash_dq_bf16_kernel`` and
``flash_dkdv_bf16_kernel`` at 4, 6 and 8 operations a live pair, head
and head dim, over the layers' mean live pairs:
:func:`smibench.afmoe.flash_launch_ops`) over the device time the trace
gives them, in %. A forward recomputed under checkpointing counts as
launches of its own. Nothing to read when the trace holds no launch of
them."""

from smibench import afmoe


def read(run):
    if run.trace is None or "mean_live_pairs" not in run.facts:
        return None
    ops = spent = 0.0
    for kernel in afmoe.FLASH_OPS_PER_PAIR:
        launches = run.trace.ops_named(kernel)
        ops += len(launches) * afmoe.flash_launch_ops(kernel, run.facts)
        spent += sum(e - s for _, s, e in launches)
    if spent <= 0:
        return None
    return 100.0 * ops / afmoe.BF16_FLOPS / spent
