"""Roll chains: ``length`` dependent whole-array steps on each of a few
independent f32 arrays, the single-card surface's probe of the stencil's
neighbour access.

PyTorch counterpart of the kernel inside
:func:`smi_tpu.benchmarks.surface.roll_chain_points`. A step is one of

- ``lane``: ``torch.roll(v, 1, dims=1)``,
- ``sublane``: ``torch.roll(v, 1, dims=0)``,
- ``add``: ``v + 1.0`` in f32 (the harness floor),

so ``length`` lane steps equal ``torch.roll(v, length, dims=1)``, the
direction of ``pltpu.roll(v, 1, axis)`` chained. The hand-written CUDA
kernel ``csrc/roll_chain.cu`` runs the whole chain in shared memory, one
block per tile in which the rolled axis is whole; :func:`roll_chain`
launches it for CUDA tensors and calls :func:`roll_chain_plain`, the same
loop in PyTorch ops, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from smi_tpu_torch.kernels import _build

KERNEL = "roll_chain"
BODIES = {"lane": 0, "sublane": 1, "add": 2}
MAX_CHAINS = 4
#: elements a thread owns at most (``kPer`` in the source)
PER_THREAD = 16
#: elements one block's tile may hold (``kPer * kMaxThreads``): two f32
#: buffers of 64 KiB each
MAX_TILE_ELEMS = PER_THREAD * 1024
#: elements a block is planned to hold: 128 blocks cover 512x2048
TARGET_TILE_ELEMS = 8192


def _step(v: torch.Tensor, body: str) -> torch.Tensor:
    if body == "lane":
        return torch.roll(v, 1, dims=1)
    if body == "sublane":
        return torch.roll(v, 1, dims=0)
    return v + 1.0


def roll_chain_plain(xs: Sequence[torch.Tensor], length: int,
                     body: str) -> Tuple[torch.Tensor, ...]:
    """``length`` steps of ``body`` on each array, in PyTorch ops: the
    kernel's plain version."""
    out = []
    for v in xs:
        for _ in range(length):
            v = _step(v, body)
        out.append(v)
    return tuple(out)


def plan(rows: int, cols: int, chains: int, body: str) -> dict:
    """The kernel's tiling of ``chains`` ``(rows, cols)`` arrays: each
    block's tile holds the rolled axis whole (``lane`` and ``add`` whole
    rows, ``sublane`` a band of whole columns) and about
    ``TARGET_TILE_ELEMS`` elements over all chains. Raises when the axis
    times the chains does not fit one block."""
    axis, other = (rows, cols) if body == "sublane" else (cols, rows)
    if chains * axis > MAX_TILE_ELEMS:
        raise ValueError(
            f"roll_chain: {chains} chain(s) x {axis} elements along the "
            f"{body} axis do not fit one block; the kernel holds at most "
            f"{MAX_TILE_ELEMS} elements a block ({MAX_TILE_ELEMS * 8 // 1024}"
            f" KiB of shared memory in two f32 buffers)"
        )
    lines = max(1, min(other, TARGET_TILE_ELEMS // (chains * axis)))
    tile = (rows, lines) if body == "sublane" else (lines, cols)
    elems = chains * tile[0] * tile[1]
    return {"tile": tile, "blocks": -(-other // lines),
            "threads": (-(-elems // PER_THREAD) + 31) // 32 * 32,
            "smem_bytes": 2 * 4 * elems}


def _check(xs, length, body) -> None:
    if body not in BODIES:
        raise ValueError(f"roll_chain: body must be one of {sorted(BODIES)}, "
                         f"got {body!r}")
    if not 1 <= len(xs) <= MAX_CHAINS:
        raise ValueError(f"roll_chain: takes 1 to {MAX_CHAINS} chains, got "
                         f"{len(xs)}")
    if int(length) != length or length < 0:
        raise ValueError(f"roll_chain: length must be an int >= 0, got "
                         f"{length!r}")
    first = xs[0]
    for i, t in enumerate(xs):
        if not torch.is_tensor(t):
            raise TypeError(f"roll_chain: chain {i} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"roll_chain: chain {i} must be float32, got "
                            f"{t.dtype}")
        if t.dim() != 2 or t.numel() == 0:
            raise ValueError(f"roll_chain: chain {i} must be a non-empty 2-D "
                             f"tensor, got shape {tuple(t.shape)}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(
                f"roll_chain: every chain must have one shape and device; "
                f"chain {i} is {tuple(t.shape)} on {t.device}, chain 0 "
                f"{tuple(first.shape)} on {first.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"roll_chain: chain {i} must be contiguous")


def roll_chain(xs: Sequence[torch.Tensor], length: int,
               body: str) -> Tuple[torch.Tensor, ...]:
    """``length`` dependent steps of ``body`` on each of the ``xs``
    (contiguous f32 arrays of one 2-D shape): new tensors, one per chain.
    Launches the CUDA kernel for CUDA tensors."""
    xs = tuple(xs)
    _check(xs, length, body)
    if xs[0].device.type == "cpu":
        return roll_chain_plain(xs, length, body)
    if xs[0].device.type != "cuda":
        raise ValueError(f"roll_chain: no kernel for {xs[0].device}")
    rows, cols = xs[0].shape
    p = plan(rows, cols, len(xs), body)
    outs = tuple(torch.empty_like(x) for x in xs)
    ins = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    outp = (ctypes.c_void_p * len(xs))(*(o.data_ptr() for o in outs))
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.entry(KERNEL)(
            ins, outp, len(xs), rows, cols, int(length), BODIES[body],
            p["tile"][0], p["tile"][1], stream,
        )
    _build.check(KERNEL, status)
    _build.count_launch(KERNEL)
    return outs
