"""Temporally-blocked Jacobi: k sweeps per memory pass.

PyTorch counterpart of :mod:`smi_tpu.kernels.stencil_temporal`. The
single-sweep kernel reads and writes the whole block every sweep (8 B per
cell); this tier exchanges ``k``-deep corner-complete halos once, then
``csrc/stencil_temporal.cu`` streams each column band of the block down a
row wavefront (``csrc/stencil_wavefront.cuh``): every cell is read once,
goes through the ``k`` sweeps on chip and is written once — ``k`` sweeps
for one read and one write of the block. At each register depth a block
splits the levels among level groups of warps (:data:`FORMS`), so a
thread keeps fewer of them and an SM holds more warps. The Dirichlet mask
is re-applied at every sweep from global coordinates, so the result is
bit-identical to ``k`` serial sweeps.

One CUDA kernel serves both of the JAX package's dispatch shapes (the
column-tiled ``_tiled_kernel`` and the full-width ``_temporal_kernel``):
its blocks are independent, so the TPU planner's choice between them has
no counterpart. :func:`_plan` cuts the block into bands and stripes for
the card instead.

:func:`temporal_sweeps` launches the kernel for a CUDA tensor and calls
:func:`temporal_sweeps_plain`, the same function in PyTorch ops, only for
a CPU tensor.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import stencil as kstencil
from smi_tpu_torch.kernels.stencil import block_origin, global_boundary_mask
from smi_tpu_torch.parallel.halo import (
    halo_exchange_2d_corners_finish,
    halo_exchange_2d_corners_start,
)
from smi_tpu_torch.parallel.mesh import Communicator
from smi_tpu_torch.utils.tracing import annotate

KERNEL = "stencil_temporal"


class Form(NamedTuple):
    """The shape of the temporal kernel at one depth (``Form`` in
    ``csrc/stencil_temporal.cu``): ``groups`` level groups of warps, each
    carrying ``depth / groups`` of the levels across the whole window,
    ``columns`` a thread, and its launch bound (``max_threads`` a block at
    most, ``min_blocks`` an SM at least, which caps the registers)."""

    groups: int
    columns: int
    max_threads: int
    min_blocks: int


#: the temporal kernel's form at the depths whose levels it keeps in
#: registers; any other depth runs the generic loop (:data:`GENERIC`)
FORMS = {8: Form(1, 4, 128, 4), 16: Form(2, 4, 256, 2),
         32: Form(4, 4, 512, 1)}

#: the generic loop: one column a thread, every level in shared memory
GENERIC = Form(1, 1, 256, 1)

#: the widest window the planner gives a block at the register depths:
#: wide enough for a 1.2x apron at k=32, narrow enough that an SM holds
#: several blocks
MAX_WIDTH = 512

#: input rows in flight a block (the cp.async ring)
PREFETCH_ROWS = 4

#: registers a thread of each temporal instance uses (``-Xptxas -v``,
#: phase 2 of ``chip_smoke.py``; None: the generic loop), which set the
#: blocks an SM holds at once
REGISTERS = {8: 119, 16: 125, 32: 128, None: 48}

#: the shortest stripe, in depths: its row apron (2k rows) costs at most
#: twice the stripe
MIN_STRIPE_DEPTHS = 2

#: the plan's model of a pass on the card: blocks run in waves of
#: ``_build.SMS`` x blocks_per_sm; a wave counts as full past this share
#: of it, and the last wave costs this many waves more (its blocks'
#: spread in time).
#: Fitted to the stripe sweeps at the main shapes (PERF.md, PR 24)
WAVE_FILL = 0.98
TAIL_WAVES = 0.3


def form(depth: int) -> Form:
    """The temporal kernel's form at ``depth``."""
    return FORMS.get(depth, GENERIC)


def window_threads(band: int, depth: int, cols: int) -> int:
    """Threads that cover a window of ``band`` output columns plus a
    ``depth``-column apron each side, ``cols`` columns a thread, a warp
    at a time: one level group."""
    return -(-(band + 2 * depth) // (32 * cols)) * 32


def threads(band: int, depth: int) -> int:
    """Threads of a temporal block: its level groups, each covering the
    window."""
    f = form(depth)
    return f.groups * window_threads(band, depth, f.columns)


def window_width(band: int, depth: int) -> int:
    """Window columns a temporal block sweeps (a warp of columns at a
    time)."""
    f = form(depth)
    return window_threads(band, depth, f.columns) * f.columns


def scratch_floats(band: int, depth: int, groups: int, cols: int) -> int:
    """Shared memory the sweeps use beside the input, in floats: each
    level group's edge slabs (two parities, a slab a warp and one each
    side of the window) and the hand-off rows between groups (two
    parities a seam), or the generic loop's three rows of every level."""
    n = window_threads(band, depth, cols)
    width = n * cols
    if depth in FORMS:
        return 2 * (n // 32 + 2) * 2 * depth + 2 * (groups - 1) * width
    return 3 * depth * (n + 2)


def window_bytes(band: int, depth: int) -> int:
    """Shared memory of one temporal block: the input ring and the
    sweeps' scratch. The CUDA launcher computes the same."""
    f = form(depth)
    return 4 * (PREFETCH_ROWS * window_width(band, depth)
                + scratch_floats(band, depth, f.groups, f.columns))


def blocks_per_sm(band: int, depth: int) -> int:
    """Blocks of this shape an H100 SM holds at once:
    :func:`_build.blocks_per_sm` of its registers, threads and shared
    memory."""
    regs = REGISTERS[depth if depth in FORMS else None]
    return _build.blocks_per_sm(regs, threads(band, depth),
                                window_bytes(band, depth))


def runtime_blocks_per_sm(band: int, depth: int) -> int:
    """The runtime's count of blocks of this shape an SM holds at once
    (the C entry's occupancy query); needs a card."""
    return _build.runtime_blocks_per_sm(KERNEL, depth, band)


def even_bands(w: int, widest: int, unit: int = 8) -> Tuple[int, int]:
    """``(count, band)``: ``w`` cut into the fewest bands of at most
    ``widest`` columns, as even as whole ``unit``s allow."""
    count = -(-w // widest)
    band = -(-w // count)
    rounded = -(-band // unit) * unit
    return count, rounded if rounded <= widest else band


@functools.lru_cache(maxsize=256)
def _plan(h: int, w: int, depth: int) -> Optional[Tuple[int, int]]:
    """``(stripe, band)`` for an ``(h, w)`` block at ``depth`` sweeps, or
    None. A block sweeps ``band`` output columns of ``stripe`` rows.

    The band is the even split of ``w`` that sweeps the fewest window
    columns (output plus apron, a warp of columns at a time, at most
    :data:`MAX_WIDTH`) and fits shared memory; on a tie, the fewer bands.
    The stripes are ``h`` evenly cut in the count that the card runs
    soonest: :func:`waves` of ``_build.SMS`` x :func:`blocks_per_sm` blocks
    times a block's row steps, none shorter than
    :data:`MIN_STRIPE_DEPTHS` depths (nor than the block); on a tie, the
    fewer stripes.
    """
    k = depth
    if not 1 <= k <= min(h, w):
        return None
    f = form(k)
    best = None
    for n in range(32, min(f.max_threads // f.groups,
                           MAX_WIDTH // f.columns) + 1, 32):
        widest = n * f.columns - 2 * k
        if widest < 1:
            continue
        count, band = even_bands(w, widest)
        if window_bytes(band, k) > _build.SMEM_BYTES_LIMIT:
            continue
        key = (count * threads(band, k), count)
        if best is None or key < best[0]:
            best = (key, count, band)
    if best is None:
        return None
    _, count, band = best
    shortest = min(h, MIN_STRIPE_DEPTHS * k)
    slots = _build.SMS * blocks_per_sm(band, k)
    apron = 2 * k + f.groups - 1   # a block's row steps past its stripe
    stripes = {-(-h // n) for n in range(1, h // shortest + 1)}
    stripe = min(stripes, key=lambda s: (
        waves(count * -(-h // s), slots) * (s + apron), -s))
    return stripe, band


def waves(blocks: int, slots: int) -> float:
    """Waves of the card that ``blocks`` take, ``slots`` at a time, in the
    plan's model: a wave counts full past :data:`WAVE_FILL` of it, and the
    last costs :data:`TAIL_WAVES` more."""
    return math.ceil(blocks / (WAVE_FILL * slots)) + TAIL_WAVES


def swept_ratio(h: int, w: int, depth: int) -> float:
    """Window cells a pass sweeps per output cell under :func:`_plan`:
    every band's full window (a warp of columns at a time) over every
    stripe's rows plus its 2k-row apron."""
    stripe, band = _plan(h, w, depth)
    width = window_width(band, depth)
    bands, stripes = -(-w // band), -(-h // stripe)
    return bands * width * (h + stripes * 2 * depth) / (h * w)


def temporal_supported(h: int, w: int, dtype, depth: int = 8) -> bool:
    """Whether the k-sweep kernel takes an ``(h, w)`` block: f32, a
    depth no deeper than the block (a neighbour's k-deep halo comes from
    its own block), and a window that fits a block."""
    return (
        dtype == torch.float32
        and 1 <= depth <= min(h, w)
        and _plan(h, w, depth) is not None
    )


def pick_temporal_depth(h: int, w: int, dtype, iterations: int):
    """Deepest supported sweeps-per-pass, trying 16 then 8, or None.

    The order is the benchmark's (its cells run depth 16). On the H100
    (``chip_smoke.py`` phase 6; NVIDIA H100 80GB HBM3, 700 W) a pass at
    8192x8192 costs 0.0310 ms a sweep at k=16, 0.0300 at k=8 and 0.0353
    at k=32; at the 4096x2048 block 0.0071 at k=16 and 0.0073 at k=8.
    Whether 8 should lead at 8192x8192 is an open question (PERF.md).
    """
    return next(
        (
            d for d in (16, 8)
            if d <= iterations and temporal_supported(h, w, dtype, d)
        ),
        None,
    )


def temporal_sweeps_plain(block, top, bottom, left, right, row0: int,
                          col0: int, gh: int, gw: int,
                          depth: int) -> torch.Tensor:
    """``depth`` sweeps in PyTorch ops over the halo-padded block: the
    kernel's plain version. The outer ring of the padded array is never
    written; sweep s leaves every cell at least s+1 rings deep exact, so
    after ``depth`` sweeps the block is."""
    k = depth
    h, w = block.shape
    a = torch.cat([top, torch.cat([left, block, right], dim=1), bottom],
                  dim=0)
    boundary = global_boundary_mask((h + 2 * k - 2, w + 2 * k - 2),
                                    row0 - k + 1, col0 - k + 1, gh, gw,
                                    block.device)
    for _ in range(k):
        avg = 0.25 * (a[:-2, 1:-1] + a[2:, 1:-1] + a[1:-1, :-2]
                      + a[1:-1, 2:])
        nxt = a.clone()
        nxt[1:-1, 1:-1] = torch.where(boundary, a[1:-1, 1:-1], avg)
        a = nxt
    return a[k:k + h, k:k + w].contiguous()


def temporal_sweeps(block, top, bottom, left, right, row0: int, col0: int,
                    gh: int, gw: int, depth: int) -> torch.Tensor:
    """``depth`` fused sweeps over a block given its corner-complete
    halos: ``top``/``bottom`` ``(k, W+2k)``, ``left``/``right``
    ``(H, k)``. Launches the CUDA kernel for a CUDA block."""
    k = depth
    h, w = block.shape if block.dim() == 2 else (0, 0)
    kstencil.check_operands(
        block,
        (("top", top), ("bottom", bottom), ("left", left), ("right", right)),
        ((k, w + 2 * k), (k, w + 2 * k), (h, k), (h, k)),
        "temporal_sweeps",
    )
    if not temporal_supported(h, w, block.dtype, k):
        raise ValueError(
            f"temporal_sweeps: depth {k} is not supported for a block of "
            f"shape {(h, w)}"
        )
    if block.device.type == "cpu":
        return temporal_sweeps_plain(block, top, bottom, left, right, row0,
                                     col0, gh, gw, k)
    if block.device.type != "cuda":
        raise ValueError(f"temporal_sweeps: no kernel for {block.device}")
    stripe, band = _plan(h, w, k)
    out = torch.empty_like(block)
    with annotate("smi.stencil.launch"):
        _build.launch(KERNEL, block.device, block.data_ptr(), top.data_ptr(),
                      bottom.data_ptr(), left.data_ptr(), right.data_ptr(),
                      out.data_ptr(), h, w, row0, col0, gh, gw, k, stripe,
                      band)
    return out


def temporal_pass(block: torch.Tensor, comm: Communicator, gh: int, gw: int,
                  depth: int = 8) -> torch.Tensor:
    """``depth`` fused sweeps over this rank's block (one memory pass):
    the corner-complete halo exchange, then one kernel launch."""
    with annotate("smi.stencil.pass"):
        exchange = halo_exchange_2d_corners_start(block, comm, depth=depth)
        halos = halo_exchange_2d_corners_finish(exchange)
        row0, col0, _, _ = block_origin(block, comm)
        return temporal_sweeps(block, halos.top, halos.bottom, halos.left,
                               halos.right, row0, col0, gh, gw, depth)


def make_temporal_stencil_fn(comm: Communicator, iterations: int, gh: int,
                             gw: int, depth: int = 8):
    """``fn(block)``: ``iterations`` sweeps at ``depth`` sweeps per memory
    pass on this rank's block. The remainder of ``iterations`` runs on
    the single-sweep fused kernel."""
    full, rem = divmod(iterations, depth)

    def fn(block: torch.Tensor) -> torch.Tensor:
        with annotate("smi.stencil.solve"):
            for _ in range(full):
                block = temporal_pass(block, comm, gh, gw, depth)
            for _ in range(rem):
                with annotate("smi.stencil.sweep"):
                    block = kstencil.jacobi_step_block_fused(block, comm,
                                                             gh, gw)
            return block

    return fn
