"""The benchmark's frozen arithmetic: work a solve does, the byte and
operation bounds of a kernel pass, the card's peaks and the statistics.

Nothing here asks the program: every function takes shapes and counts
that the harness knows from the configuration and the cell's traffic.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

#: bytes of one float32 cell
F32_BYTES = 4

#: operations of one 4-point Jacobi update: three additions, one product
OPS_PER_CELL_SWEEP = 4


def stencil_cell_updates(gh: int, gw: int, sweeps: int) -> int:
    """Cell updates of one solve: every cell of the ``gh x gw`` grid
    once a sweep, boundary included (as the SMI stencil counts them)."""
    return gh * gw * sweeps


def ksweep_halo_cells(h: int, w: int, k: int) -> int:
    """Halo cells one ``k``-sweep pass over an ``(h, w)`` block reads:
    the corner-complete top and bottom slabs ``(k, w + 2k)`` and the
    side slabs ``(h, k)``."""
    return 2 * k * (w + 2 * k) + 2 * h * k


def ksweep_pass_bound_s(h: int, w: int, k: int) -> Tuple[float, str]:
    """The least time one ``k``-sweep pass over an ``(h, w)`` f32 block
    can take on the card, and what bounds it (``"bytes"`` or
    ``"operations"``): each input byte read once, each output byte
    written once, 4 operations a cell and sweep."""
    nbytes = F32_BYTES * (2 * h * w + ksweep_halo_cells(h, w, k))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_CELL_SWEEP * h * w * k / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def percentile(values: Sequence[float], pct: int) -> float:
    """The ``pct``-th percentile of all ``values`` (inclusive method of
    :func:`statistics.quantiles`, at 1 % steps)."""
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total = 0.0
    end = None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        elif e > end:
            end = e
    if end is not None:
        total += end - start
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps = []
    cursor = lo
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(s, e) for s, e in gaps if e > s]

