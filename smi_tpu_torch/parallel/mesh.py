"""Communicator = a row-major rank grid over ``torch.distributed``.

PyTorch counterpart of :mod:`smi_tpu.parallel.mesh`. There the
communicator is a ``jax.sharding.Mesh`` and a rank exists only inside
``shard_map``. Here every rank is its own process: the communicator
records the grid ``shape``, its ``axis_names``, this process's ``rank``
and ``coords`` (row-major, first axis slowest, as in the JAX package),
the ``device`` its tensors live on, and one process subgroup per axis.

Backends follow the tensors: gloo for CPU tensors, NCCL for CUDA tensors
with one GPU per rank. A 1x1 grid (the one-card configuration) needs no
process group at all: every halo is an edge zero and nothing is sent.
The caller initialises the default process group for a multi-rank grid
(``torch.distributed.init_process_group`` with its address, world size
and rank); :func:`make_communicator` only carves the per-axis subgroups.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_AXIS = "smi"


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; the default is CUDA, and a
    machine without CUDA raises rather than carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; smi_tpu_torch runs on the GPU "
            'by default — pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class Communicator:
    """An SMI communicator over a rank grid of processes.

    ``axis_names`` are in row-major significance order: the first axis
    is the slowest-varying in the flattened rank, as in
    :class:`smi_tpu.parallel.mesh.Communicator`. ``groups`` maps each
    axis name to the subgroup of the ranks that share this rank's other
    coordinates (None on a single-rank grid).
    """

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    groups: Optional[Dict[str, object]] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    @property
    def size(self) -> int:
        """Total ranks (``SMI_Comm_size``)."""
        return int(math.prod(self.shape))

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(self.shape)

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's per-axis coordinates (row-major unravel)."""
        return _unravel(self.rank, self.shape)

    def neighbour(self, axis_name: str, offset: int,
                  ring: bool = False) -> Optional[int]:
        """Global rank ``offset`` steps along ``axis_name``; None when
        that walks off a non-wrapping edge."""
        a = self._axis(axis_name)
        coords = list(self.coords)
        pos = coords[a] + offset
        if ring:
            pos %= self.shape[a]
        elif not 0 <= pos < self.shape[a]:
            return None
        coords[a] = pos
        return _ravel(coords, self.shape)

    def _axis(self, axis_name: str) -> int:
        try:
            return self.axis_names.index(axis_name)
        except ValueError:
            raise ValueError(
                f"axis {axis_name!r} not in communicator axes "
                f"{self.axis_names}"
            ) from None


def _unravel(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for n in reversed(shape):
        coords.append(rank % n)
        rank //= n
    return tuple(reversed(coords))


def _ravel(coords: Sequence[int], shape: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


def _axis_lines(shape: Sequence[int], axis: int):
    """Every line of ranks along ``axis``: the ranks that differ only in
    that coordinate, in coordinate order."""
    others = [range(n) for i, n in enumerate(shape) if i != axis]
    lines = []
    for rest in itertools.product(*others):
        line = []
        for pos in range(shape[axis]):
            coords = list(rest)
            coords.insert(axis, pos)
            line.append(_ravel(coords, shape))
        lines.append(line)
    return lines


def make_communicator(
    n_devices: Optional[int] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Optional[Sequence[str]] = None,
    device=None,
) -> Communicator:
    """Build a communicator over the ranks of the default process group.

    ``shape``/``axis_names`` give a multi-dimensional grid (e.g.
    ``(2, 4)`` with ``("sx", "sy")`` for the stencil); the default is a
    1-D grid named ``"smi"`` over ``n_devices`` ranks (the world size if
    omitted). Without an initialised process group the world is one
    rank. ``device`` defaults to CUDA; on a CUDA grid each rank takes
    the card ``rank % device_count``.
    """
    dev = resolve_device(device)
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    if shape is None:
        shape = (n_devices if n_devices is not None else world,)
    shape = tuple(int(n) for n in shape)
    if axis_names is None:
        axis_names = (
            (DEFAULT_AXIS,) if len(shape) == 1
            else tuple(f"smi{i}" for i in range(len(shape)))
        )
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(
            f"{len(axis_names)} axis names {axis_names} for a "
            f"{len(shape)}-axis grid {shape}"
        )
    if math.prod(shape) != world:
        raise ValueError(
            f"grid shape {shape} needs {math.prod(shape)} ranks, the "
            f"process group has {world}"
            + ("" if initialised else
               " (no process group is initialised: call "
               "torch.distributed.init_process_group first)")
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    groups = None
    if world > 1:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        groups = {}
        for a, name in enumerate(axis_names):
            mine, _ = dist.new_subgroups_by_enumeration(
                _axis_lines(shape, a), backend=backend
            )
            groups[name] = mine
    return Communicator(shape=shape, axis_names=axis_names, rank=rank,
                        device=dev, groups=groups)
