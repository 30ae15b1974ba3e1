"""Halo exchange for 2-D domain decomposition.

PyTorch counterpart of :mod:`smi_tpu.parallel.halo`. There each halo is a
non-wrapping masked ``lax.ppermute`` inside ``shard_map``; here each is a
point-to-point send/receive pair on the axis subgroup, issued together
through ``torch.distributed.batch_isend_irecv`` so that the four
directions are in flight at once. Edge ranks receive zeros, and
``ring=True`` wraps, as in the JAX package.

The split ``*_start``/``*_finish`` forms are real overlap windows: start
issues the transfers and keeps the ``Work`` handles, finish waits on
them, and whatever the caller computes in between runs while the slabs
fly. On a 1x1 grid nothing is sent and every non-wrapping slab is zeros,
which matches ``ppermute`` with an empty permutation.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from smi_tpu_torch.parallel.mesh import Communicator

_BACKENDS = ("xla", "ring")


def check_backend(backend: str) -> str:
    """``"xla"`` names the collective-library path (``torch.distributed``
    here), as in the JAX package; the explicit neighbour-RDMA tier is
    not ported yet."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{_BACKENDS}")
    if backend == "ring":
        raise NotImplementedError(
            'backend="ring" needs the neighbour-stream RDMA kernel, '
            "which is not ported yet (ROADMAP.md Queue 2 item 5)"
        )
    return backend


class HaloExchange:
    """In-flight transfers (:func:`halo_exchange_start`): the receive
    buffers plus the ``Work`` handles still writing them."""

    def __init__(self, ops, works, outs: List[torch.Tensor]):
        self._ops = ops  # holds the send buffers until the wait
        self._works = works
        self._outs = outs

    def wait(self) -> List[torch.Tensor]:
        for work in self._works:
            work.wait()
        self._ops = self._works = []
        return self._outs


def _issue(comm: Communicator,
           shifts: Sequence[Tuple[torch.Tensor, str, int]],
           ring: bool) -> HaloExchange:
    """Start every shift ``(x, axis_name, direction)`` at once.

    Shift ``s`` sends ``x`` to the rank ``direction`` steps up its axis
    and receives the matching slab from the rank as far down, with tag
    ``s`` (the JAX package's one stream per direction). Every rank issues
    the shifts in the same order, so sends and receives between a pair
    of ranks match in order as well as by tag. ``direction`` is any
    nonzero step; the halo exchanges use +1 and -1.
    """
    by_axis, outs = {}, []
    for tag, (x, axis_name, direction) in enumerate(shifts):
        if direction == 0:
            raise ValueError("direction must be nonzero")
        dst = comm.neighbour(axis_name, direction, ring)
        src = comm.neighbour(axis_name, -direction, ring)
        if src == comm.rank:  # a wrapping axis of one rank
            outs.append(x.clone(memory_format=torch.contiguous_format))
            continue
        out = torch.zeros_like(x, memory_format=torch.contiguous_format)
        outs.append(out)
        group = comm.groups[axis_name] if comm.groups else None
        ops = by_axis.setdefault(axis_name, [])
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), dst,
                                  group=group, tag=tag))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, src,
                                  group=group, tag=tag))
    # one batch per axis subgroup (a batch may not mix groups), all in
    # flight together
    ops = [op for axis_ops in by_axis.values() for op in axis_ops]
    works = [work for axis_ops in by_axis.values() if axis_ops
             for work in dist.batch_isend_irecv(axis_ops)]
    return HaloExchange(ops, works, outs)


def shift_along(
    x: torch.Tensor,
    comm: Communicator,
    axis_name: str,
    direction: int,
    ring: bool = False,
    backend: str = "xla",
) -> torch.Tensor:
    """Move ``x`` to the rank ``direction`` steps up ``axis_name``.

    ``direction=+1`` sends towards higher ranks (rank r receives r-1's
    data); ``-1`` the opposite. Without ``ring`` edge ranks receive
    zeros; with it the shift wraps.
    """
    check_backend(backend)
    if direction not in (1, -1):
        raise ValueError(f"direction must be +1 or -1, got {direction}")
    return _issue(comm, [(x, axis_name, direction)], ring).wait()[0]


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
    check_backend(backend)
    row_axis, col_axis = _axes(comm, "halo_exchange_2d")
    d = depth
    return _issue(comm, [
        (block[-d:, :], row_axis, +1),   # top halo of the rank below
        (block[:d, :], row_axis, -1),    # bottom halo of the rank above
        (block[:, -d:], col_axis, +1),   # left halo of the right rank
        (block[:, :d], col_axis, -1),    # right halo of the left rank
    ], ring)


def halo_exchange_finish(exchange: HaloExchange) -> Halos:
    """Wait for an in-flight exchange; returns the four slabs."""
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
    check_backend(backend)
    row_axis, col_axis = _axes(comm, "halo_exchange_2d_corners")
    d = depth
    left, right = _issue(comm, [
        (block[:, -d:], col_axis, +1),
        (block[:, :d], col_axis, -1),
    ], ring).wait()
    ext_top = torch.cat([left[:d], block[:d], right[:d]], dim=1)
    ext_bottom = torch.cat([left[-d:], block[-d:], right[-d:]], dim=1)
    pending = _issue(comm, [
        (ext_bottom, row_axis, +1),
        (ext_top, row_axis, -1),
    ], ring)
    return CornerHaloExchange(left=left, right=right, pending=pending)


def halo_exchange_2d_corners_finish(exchange: CornerHaloExchange) -> Halos:
    """Wait for the vertical transfers; returns the four slabs with
    top/bottom side-extended."""
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
