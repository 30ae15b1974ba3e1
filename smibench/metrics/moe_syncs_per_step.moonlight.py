"""Device->host reads of the expert layer a training step of the
``deepseek_v3`` training cells, over the whole window (the program's
counter ``moe_host_reads``, reset when the window opens). Nothing to
read from a program without the counter."""


def read(run):
    reads = run.counters.get("moe_host_reads")
    return None if reads is None else reads / run.solves
