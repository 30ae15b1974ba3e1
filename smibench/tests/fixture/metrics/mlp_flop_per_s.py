"""The fixture stage's operations over the window's wall (host clock)."""


def read(run):
    flops = run.total("flops")
    return None if flops is None else flops / run.window_s
