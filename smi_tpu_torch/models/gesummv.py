"""Distributed GESUMMV: y = alpha*A@x + beta*B@x across two ranks.

PyTorch counterpart of :mod:`smi_tpu.models.gesummv` — the canonical
MPMD example: rank 1 computes ``beta*B@x`` and streams the result through
P2P port 0; rank 0 computes ``alpha*A@x`` and an axpy consumer pops each
chunk and combines it with its own partial result as it arrives.

One SPMD program over a 2-rank world: each rank's matrix is its shard of
a stacked operand pair (the matvec is a plain ``torch.matmul`` in full
float32 on both ranks), and the streamed combine is the channel's
chunked ``stream()`` with an axpy consumer. With ``backend="ring"`` the
chunks move through the neighbour-stream kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smi_tpu_torch.parallel.channels import P2PChannel
from smi_tpu_torch.parallel.context import smi_kernel


def make_gesummv_fn(world, n: int, alpha: float, beta: float,
                    buffer_size: Optional[int] = 2048,
                    backend: str = "xla"):
    """Build the 2-rank GESUMMV.

    ``fn(ab, x)`` takes the stacked operand ``ab`` of shape ``(2, n, n)``
    (rank 0 gets A, rank 1 gets B) and the replicated vector ``x``, and
    returns ``y`` as rank 0 holds it (the reference's result rank).
    """
    if world.size != 2:
        raise ValueError(f"gesummv runs on exactly 2 ranks, got {world.size}")
    axis = world.axis_names[0]

    @smi_kernel(world, in_specs=(axis, None), out_specs=axis,
                backend=backend)
    def mapped(ctx, ab_local, x):
        mat = ab_local[0]  # this rank's matrix
        scale = alpha if ctx.rank() == 0 else beta
        partial_y = scale * torch.matmul(mat, x)  # matvec on both ranks

        ch = P2PChannel(
            comm=ctx.comm, port=0, src=1, dst=0, count=n,
            dtype="float" if mat.dtype == torch.float32 else "double",
            buffer_size=buffer_size,
        )

        # Streamed axpy: rank 0's consumer folds each arriving chunk of
        # beta*B@x into its own alpha*A@x slice.
        def axpy(carry, chunk):
            y, offset = carry
            y = y.clone()
            y[offset:offset + chunk.shape[0]] += chunk
            return y, offset + chunk.shape[0]

        _received, (y, _) = ch.stream(
            partial_y, consumer=axpy, init_carry=(partial_y, 0),
            backend=ctx.backend,
        )
        # y now holds alpha*A@x + beta*B@x on rank 0; rank 1's copy added
        # only zeros (it received nothing).
        return y[None]

    def fn(ab, x):
        return mapped(ab, x)[0]  # rank 0's row

    return fn


def run_gesummv(a: np.ndarray, b: np.ndarray, x: np.ndarray,
                alpha: float = 1.0, beta: float = 1.0, world=None,
                device=None, backend: str = "xla") -> torch.Tensor:
    if world is None:
        from smi_tpu_torch.parallel.local import LocalWorld

        world = LocalWorld(2, device=device)
    ab = np.stack([np.asarray(a), np.asarray(b)])
    return make_gesummv_fn(world, a.shape[0], alpha, beta,
                           backend=backend)(ab, np.asarray(x))


def reference_gesummv(a, b, x, alpha=1.0, beta=1.0) -> np.ndarray:
    """BLAS-equivalent serial reference."""
    return alpha * (np.asarray(a) @ np.asarray(x)) + beta * (
        np.asarray(b) @ np.asarray(x)
    )
