"""Halo exchange for 2-D domain decomposition.

PyTorch counterpart of :mod:`smi_tpu.parallel.halo`. There each halo is a
non-wrapping masked ``lax.ppermute`` inside ``shard_map``; here each is a
shift through the communicator's transport: a point-to-point send/receive
pair on the axis subgroup, the four directions in flight at once, or the
rendezvous of a ``LocalWorld``. Edge ranks receive zeros, and
``ring=True`` wraps, as in the JAX package. ``backend="ring"`` moves each
slab over the neighbour-stream kernel instead, one flag domain per
direction.

The split ``*_start``/``*_finish`` forms are real overlap windows: start
issues the transfers and keeps the ``Work`` handles, finish waits on
them, and whatever the caller computes in between runs while the slabs
fly. On a 1x1 grid nothing is sent and every non-wrapping slab is zeros,
which matches ``ppermute`` with an empty permutation.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from smi_tpu_torch.parallel.backend import check_backend
from smi_tpu_torch.parallel.mesh import Communicator, Exchange, Shift
from smi_tpu_torch.utils.tracing import annotate

#: in-flight transfers (:func:`halo_exchange_start`)
HaloExchange = Exchange


def _ring_shift_along(x: torch.Tensor, comm: Communicator, axis_name: str,
                      direction: int, ring: bool,
                      stream: int) -> torch.Tensor:
    """One shift over the neighbour-stream kernel: the slab as one flat
    chunk; the kernel's ring wraps, so without ``ring`` the edge rank's
    received slab (its wrapped neighbour's) is zeroed."""
    from smi_tpu_torch.kernels import ring as kring

    got = kring.neighbour_stream(
        x.reshape(1, -1), comm, axis_name, direction=direction,
        stream=stream,
    ).reshape(x.shape)
    if ring:
        return got
    a = comm._axis(axis_name)
    edge = 0 if direction == 1 else comm.shape[a] - 1
    return torch.zeros_like(got) if comm.coords[a] == edge else got


def _issue(comm: Communicator, shifts: Sequence[Shift], ring: bool,
           backend: str = "xla") -> Exchange:
    """Start every shift ``(x, axis_name, direction)``.

    On the collective-library tier all shifts are in flight at once
    (:meth:`Communicator.exchange_start`). On the ring tier shift ``s``
    is one neighbour-stream launch on stream slot ``s`` — the JAX
    package's one flag domain per direction — and has landed when this
    returns; a zero-size slab moves nothing on either tier.
    """
    if check_backend(backend) == "xla":
        return comm.exchange_start(shifts, ring)
    outs = []
    for slot, (x, axis_name, direction) in enumerate(shifts):
        if direction not in (1, -1):
            raise ValueError(f"direction must be +1 or -1, got {direction}")
        if x.numel() == 0:
            outs.append(x.clone())
        else:
            outs.append(_ring_shift_along(x, comm, axis_name, direction,
                                          ring, slot))
    return Exchange([], [], outs)


def shift_along(
    x: torch.Tensor,
    comm: Communicator,
    axis_name: str,
    direction: int,
    ring: bool = False,
    backend: str = "xla",
    stream: int = 0,
) -> torch.Tensor:
    """Move ``x`` to the rank ``direction`` steps up ``axis_name``.

    ``direction=+1`` sends towards higher ranks (rank r receives r-1's
    data); ``-1`` the opposite. Without ``ring`` edge ranks receive
    zeros; with it the shift wraps. ``backend="ring"`` moves the slab
    over the neighbour-stream kernel; ``stream`` selects its flag domain
    (shifts that may run at once must not share one).
    """
    if direction not in (1, -1):
        raise ValueError(f"direction must be +1 or -1, got {direction}")
    if check_backend(backend) == "ring" and x.numel():
        return _ring_shift_along(x, comm, axis_name, direction, ring, stream)
    return comm.exchange_start([(x, axis_name, direction)], ring).wait()[0]


class Halos(NamedTuple):
    """Received halo slabs around a 2-D block (zeros at domain edges).

    From :func:`halo_exchange_2d`, top/bottom are ``(depth, W)``; from
    :func:`halo_exchange_2d_corners`, top/bottom are ``(depth, W+2·depth)``
    with the side-halo columns included. left/right are ``(H, depth)``.
    """

    top: torch.Tensor
    bottom: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor


def _axes(comm: Communicator, what: str) -> Tuple[str, str]:
    if len(comm.axis_names) != 2:
        raise ValueError(
            f"{what} needs a 2-axis communicator, got axes "
            f"{comm.axis_names}"
        )
    return comm.axis_names


def halo_exchange_start(
    block: torch.Tensor,
    comm: Communicator,
    depth: int = 1,
    ring: bool = False,
    backend: str = "xla",
) -> HaloExchange:
    """Issue the four neighbour transfers and return without waiting."""
    row_axis, col_axis = _axes(comm, "halo_exchange_2d")
    d = depth
    with annotate("smi.halo.start"):
        return _issue(comm, [
            (block[-d:, :], row_axis, +1),   # top halo of the rank below
            (block[:d, :], row_axis, -1),    # bottom halo of the rank above
            (block[:, -d:], col_axis, +1),   # left halo of the right rank
            (block[:, :d], col_axis, -1),    # right halo of the left rank
        ], ring, backend)


def halo_exchange_finish(exchange: HaloExchange) -> Halos:
    """Wait for an in-flight exchange; returns the four slabs."""
    with annotate("smi.halo.finish"):
        return Halos(*exchange.wait())


def halo_exchange_2d(
    block: torch.Tensor,
    comm: Communicator,
    depth: int = 1,
    ring: bool = False,
    backend: str = "xla",
) -> Halos:
    """Exchange ``depth``-deep halos with the four grid neighbours.

    ``block`` is this rank's ``(H, W)`` tile; the rank at row coordinate
    ``r`` holds global rows ``[r*H, (r+1)*H)``. ``top`` is the last
    ``depth`` rows of the block above, and so on.
    """
    return halo_exchange_finish(
        halo_exchange_start(block, comm, depth=depth, ring=ring,
                            backend=backend)
    )


class CornerHaloExchange(NamedTuple):
    """In-flight corner-complete exchange: the phase-1 side slabs have
    arrived, the phase-2 vertical transfers are in flight."""

    left: torch.Tensor
    right: torch.Tensor
    pending: HaloExchange


def halo_exchange_2d_corners_start(
    block: torch.Tensor,
    comm: Communicator,
    depth: int = 1,
    ring: bool = False,
    backend: str = "xla",
) -> CornerHaloExchange:
    """Phase 1 moves the side columns and waits for them; phase 2 sends
    the top/bottom rows *including* the just-received side halos (width
    ``W+2·depth``), so diagonal values arrive through the vertical
    neighbour. Phase 2 is left in flight."""
    row_axis, col_axis = _axes(comm, "halo_exchange_2d_corners")
    d = depth
    with annotate("smi.halo.phase1"):
        left, right = _issue(comm, [
            (block[:, -d:], col_axis, +1),
            (block[:, :d], col_axis, -1),
        ], ring, backend).wait()
    with annotate("smi.halo.phase2"):
        ext_top = torch.cat([left[:d], block[:d], right[:d]], dim=1)
        ext_bottom = torch.cat([left[-d:], block[-d:], right[-d:]], dim=1)
        pending = _issue(comm, [
            (ext_bottom, row_axis, +1),
            (ext_top, row_axis, -1),
        ], ring, backend)
    return CornerHaloExchange(left=left, right=right, pending=pending)


def halo_exchange_2d_corners_finish(exchange: CornerHaloExchange) -> Halos:
    """Wait for the vertical transfers; returns the four slabs with
    top/bottom side-extended."""
    with annotate("smi.halo.finish"):
        top, bottom = exchange.pending.wait()
    return Halos(top=top, bottom=bottom, left=exchange.left,
                 right=exchange.right)


def halo_exchange_2d_corners(
    block: torch.Tensor,
    comm: Communicator,
    depth: int = 1,
    ring: bool = False,
    backend: str = "xla",
) -> Halos:
    """Corner-complete ``depth``-deep halo exchange (two phases).

    Returns ``top``/``bottom`` of shape ``(depth, W+2·depth)`` and
    ``left``/``right`` of shape ``(H, depth)``.
    """
    return halo_exchange_2d_corners_finish(
        halo_exchange_2d_corners_start(block, comm, depth=depth, ring=ring,
                                       backend=backend)
    )


def pad_with_halos(block: torch.Tensor, halos: Halos,
                   depth: int = 1) -> torch.Tensor:
    """Assemble the ``(H+2d, W+2d)`` padded tile.

    Corners are zero for :func:`halo_exchange_2d` slabs. Side-extended
    (corner-complete) top/bottom slabs fill their rows edge to edge, as
    the JAX package's clamped ``dynamic_update_slice`` places them.
    """
    h, w = block.shape
    d = depth
    padded = block.new_zeros((h + 2 * d, w + 2 * d))
    padded[d:d + h, d:d + w] = block
    c0 = 0 if halos.top.shape[1] == w + 2 * d else d
    padded[:d, c0:c0 + halos.top.shape[1]] = halos.top
    padded[h + d:, c0:c0 + halos.bottom.shape[1]] = halos.bottom
    padded[d:d + h, :d] = halos.left
    padded[d:d + h, w + d:] = halos.right
    return padded
