"""Plain reference of the SMI stencil: the inputs of a cell, made from
the seed, and serial 4-point Jacobi sweeps with a Dirichlet boundary.

Plain PyTorch on any device; it imports nothing of the program. The
update is ``0.25 * (((up + down) + left) + right)`` in the precision
asked for, each sum rounded on its own, as SMI's ``stencil_smi.cpp``
reference does it.
"""

from __future__ import annotations

import torch


def make_grid(gh: int, gw: int, seed: int, device) -> torch.Tensor:
    """The cell's input grid: an interior uniform on [0, 1) from the
    seed; the boundary as the classic set-up holds it (the top row at
    1.0, the last column at 2.0, the rest of the edge at 0.0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    grid = torch.rand((gh, gw), generator=gen, device=device,
                      dtype=torch.float32)
    grid[0, :] = 1.0
    grid[-1, :] = 0.0
    grid[:, 0] = 0.0
    grid[0, 0] = 1.0
    grid[:, -1] = 2.0
    return grid


def jacobi(grid: torch.Tensor, sweeps: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``sweeps`` serial Jacobi sweeps of ``grid`` computed in ``dtype``;
    the boundary holds its values. Returns float32."""
    g = grid.to(dtype=dtype, copy=True)
    for _ in range(sweeps):
        avg = 0.25 * (((g[:-2, 1:-1] + g[2:, 1:-1]) + g[1:-1, :-2])
                      + g[1:-1, 2:])
        g[1:-1, 1:-1] = avg
    return g.to(torch.float32)


def max_abs_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap between a grid and the reference; infinite when
    the shapes differ."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("inf")
    return float((out.to(ref.device, torch.float32) - ref).abs().max())
