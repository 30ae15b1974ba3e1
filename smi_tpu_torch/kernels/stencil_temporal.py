"""Temporally-blocked Jacobi: k sweeps per memory pass.

PyTorch counterpart of :mod:`smi_tpu.kernels.stencil_temporal`. The
single-sweep kernel reads and writes the whole block every sweep (8 B per
cell); this tier exchanges ``k``-deep corner-complete halos once, then
``csrc/stencil_temporal.cu`` loads each tile's ``(TH+2k) x (TW+2k)``
window into shared memory once, sweeps it ``k`` times and writes the tile
back — ``k`` sweeps for one read and one write of the block. The
Dirichlet mask is re-applied at every sweep from global coordinates, so
the result is bit-identical to ``k`` serial sweeps.

One CUDA kernel serves both of the JAX package's dispatch shapes (the
column-tiled ``_tiled_kernel`` and the full-width ``_temporal_kernel``):
its tiles are independent, so the TPU planner's choice between them has
no counterpart. :func:`_plan` sizes the tile to shared memory instead.

:func:`temporal_sweeps` launches the kernel for a CUDA tensor and calls
:func:`temporal_sweeps_plain`, the same function in PyTorch ops, only for
a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import stencil as kstencil
from smi_tpu_torch.models.stencil import block_origin, global_boundary_mask
from smi_tpu_torch.parallel.halo import (
    halo_exchange_2d_corners_finish,
    halo_exchange_2d_corners_start,
)
from smi_tpu_torch.parallel.mesh import Communicator

KERNEL = "stencil_temporal"

#: dynamic shared memory one H100 block may use (227 KB)
SMEM_BYTES_LIMIT = 232_448

#: tile edges tried in order: 64x64 at k=16 keeps a 74 KB window, three
#: blocks per SM; smaller tiles only where the window would not fit
TILE_EDGES = (64, 32, 16, 8)


def window_bytes(th: int, tw: int, depth: int) -> int:
    """Shared memory of one block: two f32 buffers of the window."""
    return 2 * 4 * (th + 2 * depth) * (tw + 2 * depth)


def _plan(h: int, w: int, depth: int) -> Optional[Tuple[int, int]]:
    """``(tile_h, tile_w)`` for an ``(h, w)`` block at ``depth`` sweeps:
    the largest square edge of :data:`TILE_EDGES` (cut to the block)
    whose window fits shared memory, or None."""
    for edge in TILE_EDGES:
        th, tw = min(edge, h), min(edge, w)
        if window_bytes(th, tw, depth) <= SMEM_BYTES_LIMIT:
            return th, tw
    return None


def temporal_supported(h: int, w: int, dtype, depth: int = 8) -> bool:
    """Whether the k-sweep kernel takes an ``(h, w)`` block: f32, a
    depth no deeper than the block (a neighbour's k-deep halo comes from
    its own block), and a window that fits shared memory."""
    return (
        dtype == torch.float32
        and 1 <= depth <= min(h, w)
        and _plan(h, w, depth) is not None
    )


def pick_temporal_depth(h: int, w: int, dtype, iterations: int):
    """Deepest supported sweeps-per-pass, trying 16 then 8, or None.

    16 is the JAX package's v5e measurement; on the H100 the best depth
    has not been measured and is an open question (PERF.md).
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
    th, tw = _plan(h, w, k)
    out = torch.empty_like(block)
    with torch.cuda.device(block.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.entry(KERNEL)(
            block.data_ptr(), top.data_ptr(), bottom.data_ptr(),
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            h, w, row0, col0, gh, gw, k, th, tw, stream,
        )
    _build.check(KERNEL, status)
    _build.count_launch(KERNEL)
    return out


def temporal_pass(block: torch.Tensor, comm: Communicator, gh: int, gw: int,
                  depth: int = 8) -> torch.Tensor:
    """``depth`` fused sweeps over this rank's block (one memory pass):
    the corner-complete halo exchange, then one kernel launch."""
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
        for _ in range(full):
            block = temporal_pass(block, comm, gh, gw, depth)
        for _ in range(rem):
            block = kstencil.jacobi_step_block_fused(block, comm, gh, gw)
        return block

    return fn
