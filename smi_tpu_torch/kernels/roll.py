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
kernel ``csrc/roll_chain.cu`` runs the whole chain in registers: one warp
owns one whole line of a chain (a row for ``lane`` and ``add``, a column
for ``sublane``), lane ``l`` holding element ``32 k + l`` in
register ``k``, and a rotation step moves every element by one warp
shuffle and a select, with no shared memory and no barrier in the step
loop (:func:`plan` names the registers, the warps a block and the
blocks). :func:`roll_chain` launches it for CUDA tensors and calls
:func:`roll_chain_plain`, the same loop in PyTorch ops, only for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from smi_tpu_torch.kernels import _build

KERNEL = "roll_chain"
BODIES = {"lane": 0, "sublane": 1, "add": 2}
MAX_CHAINS = 4
#: registers a line at most (``kMaxRegs`` in the source)
MAX_REGS = 128
#: the longest rolled axis: 32 elements a register
MAX_AXIS = 32 * MAX_REGS
#: warps a block (``kMaxWarps``): 1, 2 and 4 time the same on the card
WARPS = 4


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
    """The kernel's plan for ``chains`` ``(rows, cols)`` arrays: one warp
    a line (a row for ``lane`` and ``add``, a column for ``sublane``) of
    one chain, warp ``w`` taking line ``w % lines`` of chain ``w //
    lines``; element ``e`` of line ``i`` at ``i * line_stride + e *
    elem_stride``, held in ``regs`` registers (the least power of two
    whose 32 elements a register hold the rolled axis); ``warps`` warps
    a block. ``args`` are the plan's two arguments of the C entry.
    Raises when the rolled axis is longer than ``MAX_AXIS``."""
    n, lines = (rows, cols) if body == "sublane" else (cols, rows)
    if n > MAX_AXIS:
        raise ValueError(
            f"roll_chain: {n} elements along the {body} axis exceed the "
            f"kernel's limit of {MAX_AXIS} elements: a warp holds a line "
            f"in registers, 32 elements a register and at most {MAX_REGS} "
            f"registers a thread"
        )
    regs = 1 << (-(-n // 32) - 1).bit_length()
    strides = (1, cols) if body == "sublane" else (cols, 1)
    return {"axis": n, "lines": lines, "regs": regs, "warps": WARPS,
            "blocks": -(-chains * lines // WARPS),
            "line_stride": strides[0], "elem_stride": strides[1],
            "args": (regs, WARPS)}


#: the plan :func:`roll_chain` launches (``chip_smoke.py`` swaps in an
#: earlier source's plan)
_plan = plan


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
    p = _plan(rows, cols, len(xs), body)
    outs = tuple(torch.empty_like(x) for x in xs)
    ins = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    outp = (ctypes.c_void_p * len(xs))(*(o.data_ptr() for o in outs))
    _build.launch(KERNEL, xs[0].device, ins, outp, len(xs), rows, cols,
                  int(length), BODIES[body], *p["args"])
    return outs
