"""Cell updates of every solve in the window over the window's wall
(host clock)."""


def read(run):
    cells = run.total("cells")
    return None if cells is None else cells / run.window_s
