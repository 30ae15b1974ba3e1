"""Single-device ("on-chip") application baselines.

PyTorch counterpart of :mod:`smi_tpu.models.onchip`, after the
reference's ``examples/kernels/stencil_onchip.cl.in`` and
``gesummv_onchip.cl``: the single-device variants of each application,
the baselines its distributed versions are measured against. Here the
workload runs on one card with no communicator: the Jacobi sweep as
whole-grid tensor ops, GESUMMV as two full-f32 matrix-vector products.
"""

from __future__ import annotations

import numpy as np
import torch

from smi_tpu_torch.parallel.mesh import resolve_device


def _on(t, device: torch.device) -> torch.Tensor:
    """A numpy array (as f32) or a tensor, on ``device``."""
    if not torch.is_tensor(t):
        t = torch.as_tensor(np.asarray(t, np.float32))
    return t.to(device)


def make_stencil_onchip_fn(iterations: int):
    """``fn(grid)``: ``iterations`` Jacobi sweeps on a full f32 grid, on
    the grid's device.

    The update and Dirichlet edges of the distributed stencil, with the
    JAX package's operand order ``0.25 * (((up + down) + left) +
    right)``, so the two agree to float equality on identical inputs.
    """

    def fn(grid: torch.Tensor) -> torch.Tensor:
        for _ in range(iterations):
            avg = 0.25 * (grid[:-2, 1:-1] + grid[2:, 1:-1]
                          + grid[1:-1, :-2] + grid[1:-1, 2:])
            grid = grid.clone()
            grid[1:-1, 1:-1] = avg
        return grid

    return fn


def run_stencil_onchip(grid, iterations: int, device=None) -> torch.Tensor:
    """``iterations`` sweeps of a numpy or tensor grid on ``device``
    (CUDA by default)."""
    return make_stencil_onchip_fn(iterations)(
        _on(grid, resolve_device(device)))


def make_gesummv_onchip_fn(alpha: float = 1.0, beta: float = 1.0):
    """``fn(a, b, x)``: ``y = alpha*A@x + beta*B@x`` in full f32.

    The reference's on-chip variant fuses both matvecs in one kernel;
    here they are two ``torch.matmul`` calls, plain products that the
    JAX package leaves to XLA at ``Precision.HIGHEST``. TF32 would keep
    about three decimal digits, so ``fn`` requires
    ``torch.backends.cuda.matmul.allow_tf32`` to be False (its default)
    and raises otherwise; it leaves the flag as the caller set it.
    """

    def fn(a, b, x):
        if torch.backends.cuda.matmul.allow_tf32:
            raise ValueError("TF32 is on for torch.matmul; GESUMMV's "
                             "products are full float32")
        return alpha * torch.matmul(a, x) + beta * torch.matmul(b, x)

    return fn


def run_gesummv_onchip(a, b, x, alpha: float = 1.0, beta: float = 1.0,
                       device=None) -> torch.Tensor:
    """GESUMMV of numpy or tensor operands on ``device`` (CUDA by
    default)."""
    dev = resolve_device(device)
    return make_gesummv_onchip_fn(alpha, beta)(
        _on(a, dev), _on(b, dev), _on(x, dev))
