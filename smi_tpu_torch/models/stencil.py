"""Distributed 4-point Jacobi stencil — the flagship application.

PyTorch counterpart of :mod:`smi_tpu.models.stencil`: an X×Y float grid
split over a PX×PY rank grid, each rank iterating
``new[i,j] = 0.25*(up+down+left+right)`` with a one-deep halo exchange
between grid neighbours every sweep and Dirichlet boundaries, verified
against a serial reference.

The functions here are the plain sweep in PyTorch ops. They run on
whatever device the block lies on, and on the card they are the
reference that the hand-written kernels (:mod:`smi_tpu_torch.kernels`)
are held against. Every function takes and returns this rank's block;
:func:`run_stencil` takes and returns the global grid.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# the kernels' global coordinates, under this module's names too
from smi_tpu_torch.kernels.stencil import block_origin, global_boundary_mask
from smi_tpu_torch.parallel.halo import (
    halo_exchange_2d,
    halo_exchange_finish,
    halo_exchange_start,
    pad_with_halos,
)
from smi_tpu_torch.parallel.mesh import Communicator, make_communicator


def _dirichlet_mask(block: torch.Tensor, comm: Communicator) -> torch.Tensor:
    """True where the cell sits on the *global* grid boundary."""
    row0, col0, gh, gw = block_origin(block, comm)
    return global_boundary_mask(block.shape, row0, col0, gh, gw,
                                block.device)


def jacobi_step_block(block: torch.Tensor, comm: Communicator,
                      backend: str = "xla") -> torch.Tensor:
    """One Jacobi sweep on this rank's tile, halos included.

    Global boundary cells are Dirichlet: held at their current values.
    The naive schedule: the whole sweep reads the padded tile, so it
    waits for all four halo transfers before computing anything.
    """
    halos = halo_exchange_2d(block, comm, depth=1, backend=backend)
    padded = pad_with_halos(block, halos, depth=1)
    avg = 0.25 * (
        padded[:-2, 1:-1]     # up
        + padded[2:, 1:-1]    # down
        + padded[1:-1, :-2]   # left
        + padded[1:-1, 2:]    # right
    )
    return torch.where(_dirichlet_mask(block, comm), block, avg)


def jacobi_step_block_overlapped(block: torch.Tensor, comm: Communicator,
                                 backend: str = "xla") -> torch.Tensor:
    """One Jacobi sweep with communication/compute overlap.

    The four halo transfers are started first; the halo-independent
    interior computes while they fly; the rim waits for them. Bit-identical
    to :func:`jacobi_step_block`: every cell's four operands and their
    association order (up + down + left + right, then ×0.25) are unchanged.
    """
    h, w = block.shape
    if h < 2 or w < 2:
        # a 1-wide tile has no halo-independent interior to overlap
        return jacobi_step_block(block, comm, backend=backend)
    exchange = halo_exchange_start(block, comm, depth=1, backend=backend)

    interior = 0.25 * (
        block[:-2, 1:-1]     # up
        + block[2:, 1:-1]    # down
        + block[1:-1, :-2]   # left
        + block[1:-1, 2:]    # right
    )

    halos = halo_exchange_finish(exchange)
    top = 0.25 * (
        halos.top[0]
        + block[1, :]
        + torch.cat([halos.left[0], block[0, :-1]])
        + torch.cat([block[0, 1:], halos.right[0]])
    )
    bottom = 0.25 * (
        block[h - 2, :]
        + halos.bottom[0]
        + torch.cat([halos.left[h - 1], block[h - 1, :-1]])
        + torch.cat([block[h - 1, 1:], halos.right[h - 1]])
    )
    left_col = 0.25 * (
        torch.cat([halos.top[:1, 0], block[:-1, 0]])
        + torch.cat([block[1:, 0], halos.bottom[:1, 0]])
        + halos.left[:, 0]
        + block[:, 1]
    )
    right_col = 0.25 * (
        torch.cat([halos.top[:1, w - 1], block[:-1, w - 1]])
        + torch.cat([block[1:, w - 1], halos.bottom[:1, w - 1]])
        + block[:, w - 2]
        + halos.right[:, 0]
    )
    avg = torch.empty_like(block)
    avg[1:-1, 1:-1] = interior
    avg[0, :] = top
    avg[h - 1, :] = bottom
    avg[:, 0] = left_col
    avg[:, w - 1] = right_col
    return torch.where(_dirichlet_mask(block, comm), block, avg)


def make_stencil_fn(comm: Communicator, iterations: int,
                    backend: str = "xla", overlap: bool = False):
    """The distributed stencil on this rank's block: ``fn(block)`` runs
    ``iterations`` sweeps and returns the new block. ``overlap=True``
    sweeps with :func:`jacobi_step_block_overlapped` (bit-identical)."""
    step = jacobi_step_block_overlapped if overlap else jacobi_step_block

    def fn(block: torch.Tensor) -> torch.Tensor:
        for _ in range(iterations):
            block = step(block, comm, backend=backend)
        return block

    return fn


def run_stencil(
    grid,
    iterations: int,
    px: int = 2,
    py: int = 4,
    comm: Optional[Communicator] = None,
    device=None,
) -> torch.Tensor:
    """Run the distributed stencil over a ``px*py``-rank grid: global grid
    in (a float32 numpy array or tensor), global grid out, as a tensor on
    the communicator's device on every rank."""
    from smi_tpu_torch.convert import block_from_numpy, grid_to_numpy

    if comm is None:
        comm = make_communicator(shape=(px, py), axis_names=("sx", "sy"),
                                 device=device)
    px, py = comm.axis_sizes  # the communicator's real process grid
    grid = np.asarray(grid.cpu() if torch.is_tensor(grid) else grid)
    x, y = grid.shape
    if x % px or y % py:
        raise ValueError(
            f"grid {grid.shape} not divisible by process grid {(px, py)}"
        )
    block = make_stencil_fn(comm, iterations)(block_from_numpy(grid, comm))
    return torch.from_numpy(grid_to_numpy(block, comm)).to(comm.device)


def reference_stencil(grid: np.ndarray, iterations: int) -> np.ndarray:
    """Serial CPU reference (``stencil_smi.cpp:33-46`` equivalent)."""
    g = np.array(grid, dtype=grid.dtype)
    for _ in range(iterations):
        avg = 0.25 * (
            g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:]
        )
        g[1:-1, 1:-1] = avg
    return g


def initial_grid(x: int, y: int, dtype=np.float32) -> np.ndarray:
    """Hot-top-edge initial condition (the classic Jacobi setup)."""
    g = np.zeros((x, y), dtype=dtype)
    g[0, :] = 1.0
    return g
