"""Fused Jacobi sweep: one kernel launch per iteration.

PyTorch counterpart of :mod:`smi_tpu.kernels.stencil`. The stencil
model's plain sweep (``models/stencil.py``) assembles a padded tile and
makes several passes over memory per iteration; the hand-written CUDA
kernel ``csrc/stencil_sweep.cu`` does the whole sweep in one read and one
write of the block, with the 1-deep halo slabs patched in at the block's
edges and the Dirichlet mask computed from global coordinates
(:func:`global_boundary_mask`, which the model reads from here).

:func:`fused_sweep` launches that kernel for a CUDA tensor and calls
:func:`fused_sweep_plain`, the same function in PyTorch ops, only for a
CPU tensor. Halo exchange stays outside the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from smi_tpu_torch.kernels import _build
from smi_tpu_torch.parallel.halo import halo_exchange_2d
from smi_tpu_torch.parallel.mesh import Communicator
from smi_tpu_torch.utils.tracing import annotate

KERNEL = "stencil_sweep"


def global_boundary_mask(shape: Tuple[int, int], row0: int, col0: int,
                         gh: int, gw: int, device) -> torch.Tensor:
    """True where a cell of the ``shape`` window whose top-left cell is
    global ``(row0, col0)`` lies on the global ``(gh, gw)`` boundary."""
    h, w = shape
    gi = torch.arange(row0, row0 + h, device=device).unsqueeze(1)
    gj = torch.arange(col0, col0 + w, device=device).unsqueeze(0)
    return (gi == 0) | (gi == gh - 1) | (gj == 0) | (gj == gw - 1)


def block_origin(block: torch.Tensor, comm: Communicator):
    """``(row0, col0, gh, gw)``: this block's global offset and the
    global grid's extent."""
    h, w = block.shape
    rx, cy = comm.coords
    nrow, ncol = comm.axis_sizes
    return rx * h, cy * w, nrow * h, ncol * w


def check_operands(block: torch.Tensor, slabs, shapes, what: str) -> None:
    """Raise unless ``block`` and every slab are contiguous f32 tensors
    on one device, each slab of its expected shape."""
    for name, t in (("block", block), *slabs):
        if not torch.is_tensor(t):
            raise TypeError(f"{what}: {name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != block.device:
            raise ValueError(
                f"{what}: {name} is on {t.device}, the block on "
                f"{block.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if block.dim() != 2 or block.shape[0] < 1 or block.shape[1] < 1:
        raise ValueError(f"{what}: block must be a non-empty 2-D tensor, "
                         f"got shape {tuple(block.shape)}")
    for (name, t), shape in zip(slabs, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")


def fused_sweep_plain(block, top, bottom, left, right, row0: int, col0: int,
                      gh: int, gw: int) -> torch.Tensor:
    """One sweep in PyTorch ops: the kernel's plain version."""
    up = torch.cat([top, block[:-1]], dim=0)
    down = torch.cat([block[1:], bottom], dim=0)
    lefts = torch.cat([left, block[:, :-1]], dim=1)
    rights = torch.cat([block[:, 1:], right], dim=1)
    avg = 0.25 * (up + down + lefts + rights)
    boundary = global_boundary_mask(block.shape, row0, col0, gh, gw,
                                    block.device)
    return torch.where(boundary, block, avg)


def fused_sweep(block, top, bottom, left, right, row0: int, col0: int,
                gh: int, gw: int) -> torch.Tensor:
    """One fused Jacobi sweep over a block given its exchanged halos:
    ``top``/``bottom`` ``(1, W)``, ``left``/``right`` ``(H, 1)``; the
    block's top-left cell is global ``(row0, col0)`` of a ``(gh, gw)``
    grid. Launches the CUDA kernel for a CUDA block."""
    h, w = block.shape if block.dim() == 2 else (0, 0)
    check_operands(
        block,
        (("top", top), ("bottom", bottom), ("left", left), ("right", right)),
        ((1, w), (1, w), (h, 1), (h, 1)),
        "fused_sweep",
    )
    if block.device.type == "cpu":
        return fused_sweep_plain(block, top, bottom, left, right, row0, col0,
                                 gh, gw)
    if block.device.type != "cuda":
        raise ValueError(f"fused_sweep: no kernel for {block.device}")
    out = torch.empty_like(block)
    with annotate("smi.stencil.launch"):
        _build.launch(KERNEL, block.device, block.data_ptr(), top.data_ptr(),
                      bottom.data_ptr(), left.data_ptr(), right.data_ptr(),
                      out.data_ptr(), h, w, row0, col0, gh, gw)
    return out


def jacobi_step_block_fused(block: torch.Tensor, comm: Communicator,
                            gh: int, gw: int) -> torch.Tensor:
    """Distributed fused sweep: halo exchange + one kernel launch."""
    halos = halo_exchange_2d(block, comm, depth=1)
    row0, col0, _, _ = block_origin(block, comm)
    return fused_sweep(block, halos.top, halos.bottom, halos.left,
                       halos.right, row0, col0, gh, gw)


def make_fused_stencil_fn(comm: Communicator, iterations: int, gh: int,
                          gw: int):
    """``fn(block)``: ``iterations`` fused sweeps on this rank's block.
    The kernel takes any non-empty f32 block (the JAX package's
    ``pallas_supported`` has no counterpart); :func:`fused_sweep` raises
    on anything else."""

    def fn(block: torch.Tensor) -> torch.Tensor:
        for _ in range(iterations):
            block = jacobi_step_block_fused(block, comm, gh, gw)
        return block

    return fn
