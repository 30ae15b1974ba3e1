"""Point-to-point moves along a communicator axis.

PyTorch counterpart of :mod:`smi_tpu.parallel.channels`, of which only
:func:`ring_shift` is ported so far: the K/V hop of the ring-attention
schedule. It rides the halo module's wrapping exchange (one
``batch_isend_irecv`` pair on the axis subgroup) and is differentiable,
as ``ppermute`` is in JAX: the gradient makes the opposite hop, so the
plain tier's autograd carries K/V gradients back around the ring. The
channels, streams and tenant ports of the JAX module come with the SMI
API.
"""

from __future__ import annotations

from typing import Optional

import torch

from smi_tpu_torch.parallel.halo import _issue, check_backend
from smi_tpu_torch.parallel.mesh import Communicator


def _shift(x, comm, name, step):
    return _issue(comm, [(x, name, step)], ring=True).wait()[0]


class _RingShift(torch.autograd.Function):
    """The hop under autograd: the gradient of the value rank r received
    from rank r - step goes back from r to r - step."""

    @staticmethod
    def forward(ctx, x, comm, name, step):
        ctx.hop = (comm, name, step)
        return _shift(x, comm, name, step)

    @staticmethod
    def backward(ctx, grad):
        comm, name, step = ctx.hop
        n = comm.shape[comm._axis(name)]
        return _shift(grad, comm, name, n - step), None, None, None


def ring_shift(
    x: torch.Tensor,
    comm: Communicator,
    offset: int = 1,
    axis_name: Optional[str] = None,
    backend: str = "xla",
) -> torch.Tensor:
    """Shift ``x`` to rank ``(r + offset) % size`` along a comm axis:
    rank r receives rank ``(r - offset) % size``'s ``x``. On a one-rank
    axis (or an offset that is a whole number of turns) it returns ``x``.
    ``backend="ring"`` raises until the neighbour-stream kernel is
    ported."""
    check_backend(backend)
    name = axis_name or comm.axis_names[0]
    n = comm.shape[comm._axis(name)]
    step = offset % n
    if step == 0:
        return x
    return _RingShift.apply(x, comm, name, step)
