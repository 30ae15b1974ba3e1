"""The stencil's state carried between the host and the rank grid.

The stencil has no weights: its state is the grid. These two functions
are how a caller (and the parity tests) hands the same global float32
grid to this package and reads it back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from smi_tpu_torch.parallel.mesh import Communicator


def block_from_numpy(global_grid: np.ndarray,
                     comm: Communicator) -> torch.Tensor:
    """This rank's ``(H/px, W/py)`` block of a global float32 grid, as a
    contiguous float32 tensor on ``comm.device``."""
    grid = np.asarray(global_grid)
    if grid.dtype != np.float32:
        raise TypeError(
            f"the grid must be float32, got {grid.dtype}: build the "
            f"state as float32 so every package sees the same values"
        )
    if grid.ndim != 2:
        raise ValueError(f"the grid must be 2-D, got shape {grid.shape}")
    px, py = comm.axis_sizes
    x, y = grid.shape
    if x % px or y % py:
        raise ValueError(
            f"grid {grid.shape} not divisible by process grid {(px, py)}"
        )
    h, w = x // px, y // py
    rx, cy = comm.coords
    block = np.ascontiguousarray(grid[rx * h:(rx + 1) * h,
                                      cy * w:(cy + 1) * w])
    return torch.from_numpy(block).to(comm.device)


def grid_to_numpy(block: torch.Tensor, comm: Communicator) -> np.ndarray:
    """Gather every rank's block into the global grid, on every rank."""
    px, py = comm.axis_sizes
    if comm.size == 1:
        return block.detach().cpu().numpy()
    block = block.contiguous()
    parts = [torch.empty_like(block) for _ in range(comm.size)]
    dist.all_gather(parts, block)
    rows = [torch.cat(parts[r * py:(r + 1) * py], dim=1) for r in range(px)]
    return torch.cat(rows, dim=0).cpu().numpy()
