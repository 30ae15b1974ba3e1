"""The flash kernels' share of their roofline in the ``deepseek_v3``
cells, at their split form (queries and keys 192 wide, values 128): the
least time the traced launches of that form of ``flash_bf16_kernel``,
``flash_dq_bf16_kernel`` and ``flash_dkdv_bf16_kernel`` could take at
the card's bf16 peak (each at 2 (d_qk + d_v), 4 d_qk + 2 d_v and 4 d_qk
+ 4 d_v operations a live pair and head, over one layer's live pairs:
:func:`smibench.mla.flash_launch_ops`) over the device time the trace
gives them, in %. A forward recomputed under checkpointing counts as a
launch of its own. Nothing to read when the trace holds no launch of
that form."""

from smibench import mla


def read(run):
    if run.trace is None or "qk_head_dim" not in run.facts:
        return None
    ops = spent = 0.0
    for kernel in mla.FLASH_KERNELS:
        launches = mla.split_form_launches(run.trace, kernel,
                                           run.facts["qk_head_dim"],
                                           run.facts["v_head_dim"])
        ops += len(launches) * mla.flash_launch_ops(kernel, run.facts)
        spent += sum(e - s for _, s, e in launches)
    if spent <= 0:
        return None
    return 100.0 * ops / mla.BF16_FLOPS / spent
