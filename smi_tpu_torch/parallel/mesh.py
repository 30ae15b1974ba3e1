"""Communicator = a row-major rank grid, and the transport under it.

PyTorch counterpart of :mod:`smi_tpu.parallel.mesh`. There the
communicator is a ``jax.sharding.Mesh`` and a rank exists only inside
``shard_map``. Here every rank is its own process (or, on a
:class:`~smi_tpu_torch.parallel.local.LocalWorld`, its own thread of one
process): the communicator records the grid ``shape``, its
``axis_names``, this rank's ``rank`` and ``coords`` (row-major, first
axis slowest, as in the JAX package), the ``device`` its tensors live on,
and its transport: one process subgroup per axis, or the world.

The collective-library tier (``backend="xla"``) reaches the transport
only through the communicator's few primitives — :meth:`Communicator.
exchange_start` (shifts along axes), :meth:`~Communicator.permute`,
:meth:`~Communicator.all_reduce`, :meth:`~Communicator.all_gather`,
:meth:`~Communicator.reduce_scatter` and :meth:`~Communicator.all_to_all`
— each over one axis or over the whole grid. ``torch.distributed``
implements them here; the world's rendezvous implements them in
:mod:`smi_tpu_torch.parallel.local`.

:func:`make_hybrid_communicator` builds the two-tier grid
``(n_slices, per_slice)`` with axes ``("dcn", "ici")``: the outer axis is
the slow tier, the one the hierarchical collectives cross once with
combined data (on one card a thread world plays it:
``LocalWorld((2, 4), ("dcn", "ici"))``).

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
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from smi_tpu_torch.ops.serialization import Topology
from smi_tpu_torch.ops.types import SmiOp

DEFAULT_AXIS = "smi"

#: a shift of the exchange primitive: ``(x, axis_name, direction)``
Shift = Tuple[torch.Tensor, str, int]


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


class Exchange:
    """In-flight shifts (:meth:`Communicator.exchange_start`): the receive
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


_DIST_OPS = {SmiOp.ADD: "SUM", SmiOp.MAX: "MAX", SmiOp.MIN: "MIN"}


@dataclasses.dataclass(frozen=True)
class Communicator:
    """An SMI communicator over a rank grid of processes or threads.

    ``axis_names`` are in row-major significance order: the first axis
    is the slowest-varying in the flattened rank, as in
    :class:`smi_tpu.parallel.mesh.Communicator`. ``groups`` maps each
    axis name to the subgroup of the ranks that share this rank's other
    coordinates (None on a single-rank grid). ``world`` is the
    :class:`~smi_tpu_torch.parallel.local.LocalWorld` whose thread this
    rank is (None for a rank that is a process).

    ``topology``, when built from a topology file, keeps the parsed link
    list and MPMD program map for the routing layer and
    :meth:`program_of_rank`. ``epoch`` is the membership epoch, bumped by
    every composition change (:meth:`shrink`, :meth:`regrow`) so traffic
    tagged with a superseded epoch is rejectable (:meth:`validate_epoch`);
    like the topology it takes no part in equality. A grid of processes
    made by a membership change names the process rank of each of its
    ranks in ``process_ranks`` (None: rank r is process r).
    """

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    groups: Optional[Dict[str, object]] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    world: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    topology: Optional[Topology] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    epoch: int = dataclasses.field(default=0, compare=False)
    process_ranks: Optional[Tuple[int, ...]] = dataclasses.field(
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

    def line(self, axis_name: Optional[str] = None) -> List[int]:
        """The global ranks this rank does a collective with: the whole
        grid in rank order (``axis_name=None``), or the ranks that
        differ from this one only along ``axis_name``, in coordinate
        order."""
        if axis_name is None:
            return list(range(self.size))
        a = self._axis(axis_name)
        coords = list(self.coords)
        line = []
        for pos in range(self.shape[a]):
            coords[a] = pos
            line.append(_ravel(coords, self.shape))
        return line

    def alltoall_schedule(self) -> List[List[Tuple[int, int]]]:
        """The pairwise all-to-all step schedule over this
        communicator's size: per step, the ``(src, dst)`` rank pairs the
        exchange drives (rank ``g`` sends to ``(g + s) % n`` at step
        ``s``), every ordered pair of distinct ranks once. It follows
        every membership change: a shrunk or regrown communicator's
        schedule is the rotation over its own size."""
        from smi_tpu_torch.parallel.routing import alltoall_pairwise_schedule

        return alltoall_pairwise_schedule(self.size)

    # -- degraded mode (the elastic runtime) ----------------------------

    def shrink(self, excluded_ranks) -> "Communicator":
        """This rank's communicator over the survivors of
        ``excluded_ranks`` (ULFM's ``MPI_Comm_shrink``).

        Survivors keep their relative rank order, and the shrunk grid is
        1-D over the default axis: axis structure cannot survive
        arbitrary holes (:meth:`shrink_pod` keeps whole slices). The
        epoch goes up by one; an empty exclusion returns ``self``. The
        topology is dropped: its rank numbering no longer matches.

        On a :class:`~smi_tpu_torch.parallel.local.LocalWorld` the
        survivors' threads get the ranks of one new world on the same
        device, made once for the exclusion and epoch
        (:meth:`LocalWorld.shrink` returns it, to ``run`` on). On a grid
        of processes the survivors build their process group among
        themselves (a dead rank takes no part) and every peer is mapped
        to its process rank. An excluded rank that asks raises
        ``ValueError``.
        """
        excluded, _ = self._validate_membership_args(
            excluded_ranks, None, "shrink")
        size = self.size
        if len(excluded) >= size:
            raise ValueError(
                f"cannot shrink a {size}-rank communicator by "
                f"{len(excluded)} ranks: no survivors"
            )
        if not excluded:
            return self
        survivors = [r for r in range(size) if r not in excluded]
        return self._member_comm(survivors, (len(survivors),),
                                 (DEFAULT_AXIS,), self.epoch + 1, "shrink")

    def regrow(self, excluded_ranks, readmit_ranks,
               epoch: Optional[int] = None) -> "Communicator":
        """The inverse of :meth:`shrink`: re-admit recovered ranks.

        Called on the ORIGINAL (pre-shrink) communicator — the only
        holder of the full rank order — with the currently excluded set
        and the subset of it to re-admit. Returns this rank's
        communicator in a fresh 1-D grid over the surviving and
        re-admitted ranks in original rank order, under a new epoch:
        ``epoch`` (``shrunk.epoch + 1`` of the live chain) when more
        than one shrink produced the excluded set, else this
        communicator's epoch plus two (one for the shrink, one for this
        regrow), so the shrunk incarnation's epoch never collides with
        the regrown one's. With a ``topology`` the still-dead devices
        become a :class:`~smi_tpu_torch.parallel.routing.FailureSet` and
        every member pair must still route around them, or
        :class:`~smi_tpu_torch.parallel.routing.RouteCutError` names the
        cut; without one no physical check runs.
        """
        excluded, readmit = self._validate_membership_args(
            excluded_ranks, readmit_ranks, "regrow"
        )
        still_dead = excluded - readmit
        self._check_regrow_routes(still_dead)
        alive = [r for r in range(self.size) if r not in still_dead]
        return self._member_comm(
            alive, (len(alive),), (DEFAULT_AXIS,),
            self.epoch + 2 if epoch is None else epoch, "regrow")

    def _validate_membership_args(self, excluded_ranks, readmit_ranks,
                                  what: str):
        """The shared argument check of the shrink/regrow pairs (flat
        and pod): the excluded set in range and, for a regrow, readmit a
        non-empty subset of it. Returns ``(excluded, readmit)`` as sets
        (``readmit`` None for a shrink)."""
        excluded = set(excluded_ranks)
        readmit = None
        if readmit_ranks is not None:
            readmit = set(readmit_ranks)
            stray = sorted(readmit - excluded)
            if stray:
                raise ValueError(
                    f"cannot regrow ranks {stray}: they are not in the "
                    f"excluded set {sorted(excluded)}"
                )
            if not readmit:
                raise ValueError(
                    f"{what}() needs at least one rank to re-admit"
                )
        size = self.size
        bad = sorted(r for r in excluded if not (0 <= r < size))
        if bad:
            raise ValueError(
                f"excluded ranks {bad} out of range for comm size {size}"
            )
        return excluded, readmit

    def _check_regrow_routes(self, still_dead) -> None:
        """The physical leg of a regrow: with a topology, the still-dead
        devices become a FailureSet and every member pair must route
        around them (RouteCutError names the cut). Without one there is
        nothing to check."""
        if self.topology is None:
            return
        from smi_tpu_torch.parallel.routing import (
            FailureSet,
            build_routing_context,
            check_all_pairs_routable,
        )

        topo_devices = self.topology.devices
        cut = FailureSet(devices=frozenset(
            topo_devices[r] for r in sorted(still_dead)
        ))
        ctx = build_routing_context(self.topology, excluded=cut)
        alive = [r for r in range(self.size) if r not in still_dead]
        check_all_pairs_routable(
            ctx, [topo_devices[r] for r in alive]
        )

    def _pod_axes(self, what: str) -> Tuple[int, int]:
        """(slices, per_slice) of a two-axis hybrid communicator; loud
        otherwise."""
        if len(self.axis_names) != 2:
            raise ValueError(
                f"{what}() needs a 2-axis (slices, per_slice) hybrid "
                f"communicator; got axes {self.axis_names} — use "
                f"{what.replace('_pod', '')}() on flat meshes"
            )
        return self.shape[0], self.shape[1]

    def _pod_mesh_without(self, dead_slices, what: str,
                          epoch: int) -> "Communicator":
        """The hybrid grid with whole dead slices dropped from the outer
        axis: the one copy of the row layout :meth:`shrink_pod` and
        :meth:`regrow_pod` share."""
        slices, per_slice = self._pod_axes(what)
        rows = [s for s in range(slices) if s not in dead_slices]
        members = [s * per_slice + i for s in rows for i in range(per_slice)]
        return self._member_comm(members, (len(rows), per_slice),
                                 self.axis_names, epoch, what)

    def shrink_pod(self, excluded_ranks) -> "Communicator":
        """Pod-aware :meth:`shrink` for a hybrid (slices, per_slice)
        communicator.

        Whole dead slices drop out of the OUTER axis with the hybrid
        shape kept, so hierarchical collectives go on over the remaining
        slices. A partial slice cannot keep the shape (unequal slices do
        not tile), so dead ranks fall back to the flat 1-D ring over all
        survivors. The epoch goes up once either way (an empty exclusion
        returns ``self``).
        """
        slices, per_slice = self._pod_axes("shrink_pod")
        excluded, _ = self._validate_membership_args(
            excluded_ranks, None, "shrink_pod"
        )
        size = self.size
        if not excluded:
            return self
        if len(excluded) >= size:
            raise ValueError(
                f"cannot shrink a {size}-rank pod by {len(excluded)} "
                f"ranks: no survivors"
            )
        by_slice: dict = {}
        for r in excluded:
            by_slice.setdefault(r // per_slice, set()).add(r)
        if any(len(dead) < per_slice for dead in by_slice.values()):
            return self.shrink(excluded)  # partial slice: flat ring
        return self._pod_mesh_without(by_slice, "shrink_pod",
                                      epoch=self.epoch + 1)

    def regrow_pod(self, excluded_ranks, readmit_ranks,
                   epoch: Optional[int] = None) -> "Communicator":
        """The inverse of :meth:`shrink_pod`, called on the ORIGINAL pod
        communicator. When the still-dead set is whole slices (usually
        empty) the result keeps the hybrid shape; a still-dead partial
        slice falls back to the flat :meth:`regrow`. Epochs as in
        :meth:`regrow`."""
        slices, per_slice = self._pod_axes("regrow_pod")
        excluded, readmit = self._validate_membership_args(
            excluded_ranks, readmit_ranks, "regrow_pod"
        )
        still_dead = excluded - readmit
        by_slice: dict = {}
        for r in still_dead:
            by_slice.setdefault(r // per_slice, set()).add(r)
        new_epoch = self.epoch + 2 if epoch is None else epoch
        if any(len(dead) < per_slice for dead in by_slice.values()):
            return self.regrow(excluded, readmit, epoch=new_epoch)
        self._check_regrow_routes(still_dead)
        return self._pod_mesh_without(by_slice, "regrow_pod",
                                      epoch=new_epoch)

    def _member_comm(self, members: List[int], shape: Tuple[int, ...],
                     axis_names: Tuple[str, ...], epoch: int,
                     what: str) -> "Communicator":
        """This rank's communicator in the grid ``shape`` over
        ``members`` (ranks of this communicator, in the new rank order)
        at ``epoch``: a rank of the members' new world of threads, or of
        the members' process group."""
        if self.rank not in members:
            raise ValueError(
                f"rank {self.rank} is excluded by this {what}: it has no "
                f"rank among the members {members}"
            )
        if self.world is not None:
            world = self.world._member_world(members, shape, axis_names,
                                             epoch)
            return world.comms[members.index(self.rank)]
        return _process_member_comm(self, members, shape, axis_names, epoch)

    def validate_epoch(self, rank: int, epoch: int,
                       what: str = "message") -> None:
        """Reject traffic tagged with another epoch: the loud stale-epoch
        gate (:class:`~smi_tpu_torch.parallel.membership.
        StaleEpochError`). A *newer* epoch than ours is the mirror
        failure — WE missed a membership change — and is named so."""
        if epoch != self.epoch:
            from smi_tpu_torch.parallel.membership import StaleEpochError

            raise StaleEpochError(rank, epoch, self.epoch, what=what)

    def heirs(self, excluded_ranks) -> dict:
        """excluded rank -> its surviving heir (nearest successor on the
        ring), which inherits its duties: its progress-logged chunks, its
        logged contribution to a restarted reduction
        (:func:`smi_tpu_torch.parallel.recovery.heir_of`). Raises
        ``ValueError`` when nobody survives."""
        from smi_tpu_torch.parallel.recovery import heir_of

        excluded = set(excluded_ranks)
        size = self.size
        bad = sorted(r for r in excluded if not (0 <= r < size))
        if bad:
            raise ValueError(
                f"excluded ranks {bad} out of range for comm size {size}"
            )
        if len(excluded) >= size:
            raise ValueError(
                f"no survivors among {size} ranks to inherit from "
                f"{sorted(excluded)}"
            )
        survivors = [r for r in range(size) if r not in excluded]
        return {r: heir_of(r, survivors, size) for r in excluded}

    def program_of_rank(self, rank: int):
        """The program rank ``rank`` runs under MPMD (None without a
        topology)."""
        if self.topology is None:
            return None
        device = self.topology.mapping.devices[rank]
        return self.topology.mapping.program_for(device)

    # -- the transport seam (the collective-library tier) --------------

    def _group(self, axis_name: Optional[str]):
        """The process group of a collective over ``axis_name`` (None:
        the whole grid's, the default group unless a membership change
        made the grid)."""
        if not self.groups:
            return None
        if axis_name is None:
            return self.groups.get(None)
        self._axis(axis_name)
        return self.groups[axis_name]

    def _process(self, rank: int) -> int:
        """The process rank of this grid's ``rank``: a point-to-point
        peer is named by its rank in the default group."""
        return rank if self.process_ranks is None else self.process_ranks[rank]

    def exchange_start(self, shifts: Sequence[Shift],
                       ring: bool) -> Exchange:
        """Start every shift ``(x, axis_name, direction)`` at once.

        Shift ``s`` sends ``x`` to the rank ``direction`` steps up its
        axis and receives the matching slab from the rank as far down,
        with tag ``s`` (the JAX package's one stream per direction).
        Every rank issues the shifts in the same order, so sends and
        receives between a pair of ranks match in order as well as by
        tag. ``direction`` is any nonzero step. Without ``ring`` a rank
        with no source receives zeros.
        """
        for _, _, direction in shifts:
            if direction == 0:
                raise ValueError("direction must be nonzero")
        if self.world is not None:
            return self.world.exchange(self, shifts, ring)
        by_axis, outs = {}, []
        for tag, (x, axis_name, direction) in enumerate(shifts):
            dst = self.neighbour(axis_name, direction, ring)
            src = self.neighbour(axis_name, -direction, ring)
            if src == self.rank:  # a wrapping axis of one rank
                outs.append(x.clone(memory_format=torch.contiguous_format))
                continue
            out = torch.zeros_like(x, memory_format=torch.contiguous_format)
            outs.append(out)
            group = self._group(axis_name)
            ops = by_axis.setdefault(axis_name, [])
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                      self._process(dst), group=group,
                                      tag=tag))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, out, self._process(src),
                                      group=group, tag=tag))
        # one batch per axis subgroup (a batch may not mix groups), all
        # in flight together
        ops = [op for axis_ops in by_axis.values() for op in axis_ops]
        works = [work for axis_ops in by_axis.values() if axis_ops
                 for work in dist.batch_isend_irecv(axis_ops)]
        return Exchange(ops, works, outs)

    def permute(self, x: torch.Tensor,
                perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``x`` of global rank ``src`` delivered to ``dst`` for every
        ``(src, dst)`` pair; a rank that is no pair's ``dst`` gets zeros
        (``lax.ppermute`` over the flattened grid)."""
        if self.world is not None:
            return self.world.permute(self, x, perm)
        out = torch.zeros_like(x, memory_format=torch.contiguous_format)
        ops = []
        group = self._group(None)
        for tag, (src, dst) in enumerate(perm):
            if src == dst == self.rank:
                out.copy_(x)
            elif src == self.rank:
                ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                      self._process(dst), group=group,
                                      tag=tag))
            elif dst == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, self._process(src),
                                      group=group, tag=tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def all_reduce(self, x: torch.Tensor, op=SmiOp.ADD,
                   axis_name: Optional[str] = None) -> torch.Tensor:
        """ADD/MAX/MIN of every rank's ``x`` over the axis (None: the
        whole grid), on every rank."""
        op = SmiOp.parse(op)
        if len(self.line(axis_name)) == 1:
            return x
        if self.world is not None:
            return self.world.all_reduce(self, x, op, axis_name)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=getattr(dist.ReduceOp, _DIST_OPS[op]),
                        group=self._group(axis_name))
        return out

    def all_gather(self, x: torch.Tensor,
                   axis_name: Optional[str] = None) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the leading dimension in
        rank order (``lax.all_gather(..., tiled=True)``)."""
        n = len(self.line(axis_name))
        if n == 1:
            return x
        if self.world is not None:
            return self.world.all_gather(self, x, axis_name)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group(axis_name))
        return torch.cat(parts, dim=0)

    def reduce_scatter(self, x: torch.Tensor, op=SmiOp.ADD,
                       axis_name: Optional[str] = None) -> torch.Tensor:
        """Block ``r`` of the leading dimension reduced over the axis,
        on the rank at position ``r`` (``lax.psum_scatter(...,
        tiled=True)`` for ADD)."""
        op = SmiOp.parse(op)
        line = self.line(axis_name)
        n = len(line)
        if x.shape[0] % n:
            raise ValueError(
                f"reduce-scatter leading dim {x.shape[0]} not divisible "
                f"by {n} ranks"
            )
        if n == 1:
            return x
        if self.world is not None:
            return self.world.reduce_scatter(self, x, op, axis_name)
        # gloo has no reduce-scatter: reduce everything, keep one block
        count = x.shape[0] // n
        pos = line.index(self.rank)
        full = self.all_reduce(x, op, axis_name)
        return full[pos * count:(pos + 1) * count].clone()

    def all_to_all(self, x: torch.Tensor,
                   axis_name: Optional[str] = None) -> torch.Tensor:
        """Block ``r`` of the leading dimension to the rank at position
        ``r`` of the axis; the blocks received come back in source order
        (``lax.all_to_all(..., split_axis=0, concat_axis=0,
        tiled=True)``)."""
        n = len(self.line(axis_name))
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(
                f"all-to-all leading dim "
                f"{x.shape[0] if x.dim() else '()'} not divisible by "
                f"{n} ranks"
            )
        if n == 1 or x.numel() == 0:
            return x
        if self.world is not None:
            return self.world.all_to_all(self, x, axis_name)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self._group(axis_name))
        return out


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


def grid_axes(n_devices, shape, axis_names, default_size: int):
    """``(shape, axis_names)`` as tuples: a 1-D grid named ``"smi"`` over
    ``n_devices`` ranks (``default_size`` if omitted) unless ``shape``
    says otherwise; unnamed axes of a multi-axis grid are ``smi0``,
    ``smi1``, ..."""
    if shape is None:
        shape = (n_devices if n_devices is not None else default_size,)
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
    return shape, axis_names


def make_communicator(
    n_devices: Optional[int] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Optional[Sequence[str]] = None,
    device=None,
) -> Communicator:
    """Build a communicator over the ranks of the default process group
    (for ranks that are threads on one device, build a
    :class:`~smi_tpu_torch.parallel.local.LocalWorld` instead).

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
    shape, axis_names = grid_axes(n_devices, shape, axis_names, world)
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


def _hybrid_shape(world: int, n_slices: Optional[int],
                  per_slice: Optional[int]) -> Tuple[int, int]:
    """``(n_slices, per_slice)`` of a hybrid grid over ``world`` ranks:
    the ranks split evenly into ``n_slices`` slices in rank order, as the
    JAX package splits a device list that reports no slice."""
    if n_slices is None:
        raise ValueError(
            "single-slice platform: pass n_slices to split the "
            "device list into virtual slices"
        )
    if per_slice is None:
        if world % n_slices:
            raise ValueError(
                f"{world} devices do not split into {n_slices} slices"
            )
        per_slice = world // n_slices
    if n_slices * per_slice > world:
        raise ValueError(
            f"need {n_slices * per_slice} devices, have {world}"
        )
    return n_slices, per_slice


def make_hybrid_communicator(
    n_slices: Optional[int] = None,
    per_slice: Optional[int] = None,
    axis_names: Sequence[str] = ("dcn", "ici"),
    device=None,
) -> Communicator:
    """Two-tier communicator over the default process group: the outer
    axis across slices (the slow tier), the inner one within a slice.

    SMI's network is two-tier (devices grouped per node, intra-node links
    costed 1 and inter-node routes 100), and its router keeps traffic
    inside a node. This builds the ``(n_slices, per_slice)`` grid whose
    collectives over ``axis_names[1]`` stay inside a slice, so that only
    the cross-slice stage of a hierarchical collective crosses the outer
    axis. Processes report no slice, so the ranks split evenly into
    ``n_slices`` groups in rank order, and the grid must cover every rank
    of the group. On one card, build ``LocalWorld((n_slices, per_slice),
    ("dcn", "ici"))`` instead.
    """
    if len(axis_names) != 2:
        raise ValueError(f"need (outer, inner) axis names, got {axis_names}")
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    return make_communicator(shape=_hybrid_shape(world, n_slices, per_slice),
                             axis_names=tuple(axis_names), device=device)


def mesh_from_topology(topology: Topology, device=None) -> Communicator:
    """A communicator whose ranks are the topology file's devices, in the
    file's deterministic ``(node, index)`` order (one rank a device of
    the parsed :class:`~smi_tpu_torch.ops.serialization.Topology`). The
    link list and MPMD program map stay on it (``.topology``) for the
    routing layer, :meth:`Communicator.regrow`'s route check and
    :meth:`Communicator.program_of_rank`."""
    base = make_communicator(n_devices=len(topology.devices), device=device)
    return dataclasses.replace(base, topology=topology)


#: the process groups of each membership the processes formed:
#: ``(process ranks, shape, axis names, epoch) -> groups``, so a second
#: shrink to the same members at the same epoch takes the same groups
#: (the other members create each group once)
_MEMBER_GROUPS: Dict[tuple, Dict[Optional[str], object]] = {}


def _process_member_comm(comm: Communicator, members: List[int],
                         shape: Tuple[int, ...],
                         axis_names: Tuple[str, ...],
                         epoch: int) -> Communicator:
    """``comm``'s process in the grid ``shape`` over the processes of
    ``members``: the members create the grid's group and one group per
    axis line they are on among themselves
    (``use_local_synchronization``), so an excluded process, which may be
    dead, takes no part."""
    procs = tuple(comm._process(r) for r in members)
    me = members.index(comm.rank)
    groups = None
    if len(procs) > 1:
        key = (procs, shape, axis_names, epoch)
        groups = _MEMBER_GROUPS.get(key)
        if groups is None:
            backend = "nccl" if comm.device.type == "cuda" else "gloo"

            def group(ranks):
                return dist.new_group(list(ranks), backend=backend,
                                      use_local_synchronization=True)

            groups = {None: group(procs)}
            for a, name in enumerate(axis_names):
                line = next(line for line in _axis_lines(shape, a)
                            if me in line)
                groups[name] = (groups[None] if len(line) == len(procs)
                                else group(procs[i] for i in line))
            _MEMBER_GROUPS[key] = groups
    return Communicator(shape=shape, axis_names=axis_names, rank=me,
                        device=comm.device, groups=groups, epoch=epoch,
                        process_ranks=procs)
