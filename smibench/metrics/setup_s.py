"""Set-up time: process start to the first timed solve, the kernels'
build included on a checkout's first run (host clock)."""


def read(run):
    return run.setup_s
