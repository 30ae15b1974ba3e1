"""An n-rank grid played by n threads of one process on one device.

The port's counterpart of the JAX package's fake mesh under
``shard_map``: :class:`LocalWorld` gives every rank of a grid its own
Python thread and its own :class:`~smi_tpu_torch.parallel.mesh.
Communicator`, all on one device, so that a multi-rank program — and the
ring kernels, whose ranks write into each other's buffers — runs on a
single card (or on the CPU, for the tests). Processes that share a card
are time-sliced against each other, which is no place for kernels that
spin on a neighbour's flags; threads of one process can put all ranks
into one launch.

Everything ranks do together goes through one primitive,
:meth:`LocalWorld.rendezvous`: each rank finishes the work queued on its
own stream, leaves its payload in its slot and waits at a barrier; one
rank (the leader) then does the joint work for all of them on the
world's stream, finishes it, and the barrier releases every rank with
its share. The collective-library tier's primitives (shift, permute,
all-reduce, all-gather, reduce-scatter, all-to-all) are implemented on
it here; the ring kernels' wrappers (:mod:`smi_tpu_torch.kernels.ring`)
bring their own joint work: one launch that plays every rank.

On CUDA each rank thread works on a stream of its own. A rank never
calls ``torch.cuda.synchronize()`` (that would wait for its neighbours'
streams too); it synchronises its own stream before a rendezvous, and
the leader synchronises the world's stream before releasing the others.

A rank meets the others only from a thread that ``run`` is running. That
holds for a backward pass too: autograd runs a CUDA graph's nodes on one
worker thread per card, where the first ring node to reach the barrier
would hold the thread that the other ranks' nodes queue on, so
:meth:`LocalWorld.run` turns autograd's device threads off for its rank
threads (``torch.autograd.set_multithreading_enabled(False)``) and
``.backward()`` called inside ``run`` runs every node on the rank's own
thread. A rendezvous from a thread that no ``run`` is running (autograd's
device thread, or the caller's after ``run`` returned) raises at once.

:meth:`LocalWorld.shrink` and :meth:`LocalWorld.regrow` make the world
of a membership change (the survivors, or the survivors and the ranks
re-admitted): a new world of their threads on the same device, made once
for each membership and epoch, whose ranks every member's
``comm.shrink(...)`` / ``comm.regrow(...)`` returns.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from smi_tpu_torch.ops.types import SmiOp
from smi_tpu_torch.parallel.backend import combine_fn
from smi_tpu_torch.parallel.mesh import (
    Communicator,
    Exchange,
    _axis_lines,
    grid_axes,
    resolve_device,
)
from smi_tpu_torch.utils.tracing import annotate

#: seconds a rank waits for the others at a rendezvous before the world
#: is declared broken
RENDEZVOUS_TIMEOUT_S = 600.0

#: ``depth``: how many ``LocalWorld.run`` calls this thread is running a
#: rank of (a rank thread may drive its rank of another world too)
_RANK_THREAD = threading.local()


class LocalWorld:
    """A rank grid of threads on one device.

    ``shape`` is the grid (an int for a 1-D grid), ``axis_names`` its
    axes (``"smi"`` for 1-D), ``device`` where every rank's tensors live
    (CUDA by default; pass ``device="cpu"`` to run on the CPU).
    ``world.comms[r]`` is rank r's communicator; :meth:`run` runs a
    function on every rank at once. A world made by a membership change
    names the rank of the parent world each of its ranks was in
    ``parent_ranks`` (None for a world built directly).
    """

    def __init__(self, shape, axis_names: Optional[Sequence[str]] = None,
                 device=None):
        if isinstance(shape, int):
            shape = (shape,)
        self.shape, self.axis_names = grid_axes(None, shape, axis_names, 1)
        self.size = int(math.prod(self.shape))
        if self.size < 1:
            raise ValueError(f"a world needs at least one rank, got grid "
                             f"{self.shape}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.comms = [
            Communicator(shape=self.shape, axis_names=self.axis_names,
                         rank=r, device=dev, world=self)
            for r in range(self.size)
        ]
        self._barrier = threading.Barrier(self.size,
                                          timeout=RENDEZVOUS_TIMEOUT_S)
        self._in: List[object] = [None] * self.size
        self._out: List[object] = [None] * self.size
        self._streams = None   # CUDA: the world's stream + one per rank
        #: persistent state of the ring tier (comm slots and flag words),
        #: owned by the world and managed by :mod:`smi_tpu_torch.kernels.ring`
        self.ring_state: dict = {}
        self.parent_ranks: Optional[Tuple[int, ...]] = None
        # the worlds of this world's membership changes, made once each
        self._members: Dict[tuple, "LocalWorld"] = {}
        self._members_lock = threading.Lock()

    @property
    def epoch(self) -> int:
        """The membership epoch of every rank's communicator."""
        return self.comms[0].epoch

    # -- running ranks --------------------------------------------------

    @property
    def stream(self):
        """The world's CUDA stream: joint work is queued here."""
        return self._cuda_streams()[0]

    def _cuda_streams(self):
        if self._streams is None:
            self._streams = [torch.cuda.Stream(self.device)
                             for _ in range(self.size + 1)]
        return self._streams

    def lines(self, axis_name: Optional[str] = None) -> List[List[int]]:
        """Every line of ranks along ``axis_name`` (the one line of all
        ranks for None), each in coordinate order."""
        if axis_name is None:
            return [list(range(self.size))]
        return _axis_lines(self.shape, self.comms[0]._axis(axis_name))

    def run(self, fn: Callable[[Communicator], object]) -> List[object]:
        """``fn(comm)`` on every rank's thread; the results in rank
        order. A failure on any rank aborts the barrier, so no rank
        waits for ever, and is raised here."""
        with annotate("smi.world.run"):
            cuda = self.device.type == "cuda"
            if self._barrier.broken:
                self._barrier.reset()
            if cuda:
                # the ranks' streams do not wait for the default stream
                torch.cuda.synchronize(self.device)
            out, errors = [None] * self.size, []

            def body(r):
                _RANK_THREAD.depth = getattr(_RANK_THREAD, "depth", 0) + 1
                try:
                    with annotate("smi.world.rank"):
                        if cuda:
                            # autograd runs this rank's CUDA nodes on
                            # this thread, not on the card's one worker
                            # thread, so a ring node of a backward meets
                            # the others from its rank
                            with torch.cuda.device(self.device), \
                                    torch.cuda.stream(
                                        self._cuda_streams()[r + 1]), \
                                    torch.autograd.set_multithreading_enabled(
                                        False):
                                out[r] = fn(self.comms[r])
                                torch.cuda.current_stream().synchronize()
                        else:
                            out[r] = fn(self.comms[r])
                except BaseException as exc:  # raised again below
                    errors.append(exc)
                    self._barrier.abort()
                finally:
                    _RANK_THREAD.depth -= 1

            if self.size == 1:
                body(0)
            else:
                threads = [threading.Thread(target=body, args=(r,),
                                            name=f"smi-rank-{r}")
                           for r in range(self.size)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            if errors:
                first = [e for e in errors
                         if not isinstance(e, threading.BrokenBarrierError)]
                raise (first or errors)[0]
            return out

    def rendezvous(self, rank: int, kind, payload,
                   work: Callable[[List[object]], List[object]]):
        """Meet the other ranks: leave ``payload``, let one rank run
        ``work(payloads) -> results`` (one per rank, in rank order) on
        the world's stream, return this rank's result. ``kind`` is a
        tuple whose first item names the call (the span
        ``smi.world.rendezvous.<call>``); ranks that arrive with
        different kinds have diverged, and the world fails. A rank must arrive from a thread that
        :meth:`run` is running: from any other (a backward pass run on
        the outputs after ``run`` returned, say) it would wait for ever,
        so it raises."""
        if self.size > 1 and not getattr(_RANK_THREAD, "depth", 0):
            raise RuntimeError(
                f"rank {rank} of a {self.size}-rank world met the others "
                f"from thread {threading.current_thread().name!r}, which "
                f"no world.run is running: the ranks of a world meet only "
                f"inside world.run. Call .backward() inside the function "
                f"world.run runs, on each rank's loss, e.g. "
                f"world.run(lambda c: fn(c)(q, k, v).sum().backward())"
            )
        with annotate(f"smi.world.rendezvous.{kind[0]}"):
            cuda = self.device.type == "cuda"
            with annotate("smi.world.arrive"):
                if cuda:
                    torch.cuda.current_stream().synchronize()
                self._in[rank] = (kind, payload)
                lead = self._barrier.wait() == 0
            if lead:
                with annotate("smi.world.lead"):
                    try:
                        kinds = [k for k, _ in self._in]
                        if any(k != kinds[0] for k in kinds):
                            raise RuntimeError(
                                f"the ranks of the world diverged: they met "
                                f"with calls {kinds}"
                            )
                        payloads = [p for _, p in self._in]
                        if cuda:
                            with torch.cuda.stream(self.stream):
                                self._out = work(payloads)
                            self.stream.synchronize()
                        else:
                            self._out = work(payloads)
                        self._in = [None] * self.size
                    except BaseException:
                        self._barrier.abort()
                        raise
            with annotate("smi.world.release"):
                self._barrier.wait()
            result = self._out[rank]
            if cuda:
                _record_stream(result, torch.cuda.current_stream())
            return result

    # -- membership changes (the elastic runtime) ------------------------

    def shrink(self, excluded_ranks) -> "LocalWorld":
        """The survivors' world: the world of every surviving rank's
        ``comm.shrink(excluded_ranks)`` (this world for an empty
        exclusion), for a host to :meth:`run` on."""
        return self._change(excluded_ranks, lambda c: c.shrink(excluded_ranks))

    def regrow(self, excluded_ranks, readmit_ranks,
               epoch: Optional[int] = None) -> "LocalWorld":
        """The world of every member's ``comm.regrow(excluded_ranks,
        readmit_ranks, epoch)``, called on the original world."""
        still_dead = set(excluded_ranks) - set(readmit_ranks)
        return self._change(still_dead, lambda c: c.regrow(
            excluded_ranks, readmit_ranks, epoch=epoch))

    def _change(self, excluded, change) -> "LocalWorld":
        """``change(comm)`` on a rank that stays a member (rank 0 when
        none does, to raise the change's own error), as a world."""
        excluded = set(excluded)
        member = next((c for c in self.comms if c.rank not in excluded),
                      self.comms[0])
        return change(member).world

    def _member_world(self, members: Sequence[int], shape, axis_names,
                      epoch: int) -> "LocalWorld":
        """The world over ``members`` (ranks of this world, in the new
        rank order) as the grid ``shape`` at ``epoch``, made the first
        time any member asks and the same world for every member after."""
        key = (tuple(members), tuple(shape), tuple(axis_names), epoch)
        with self._members_lock:
            world = self._members.get(key)
            if world is None:
                world = LocalWorld(shape, axis_names, device=self.device)
                world.comms = [dataclasses.replace(c, epoch=epoch)
                               for c in world.comms]
                world.parent_ranks = tuple(members)
                self._members[key] = world
        return world

    # -- the collective-library tier on the rendezvous ------------------

    def exchange(self, comm: Communicator, shifts, ring: bool) -> Exchange:
        shifts = list(shifts)
        meta = tuple((name, d) for _, name, d in shifts)

        def work(payloads):
            results = []
            for r in range(self.size):
                outs = []
                for tag, (name, direction) in enumerate(meta):
                    src = self.comms[r].neighbour(name, -direction, ring)
                    if src is None:
                        outs.append(torch.zeros_like(
                            payloads[r][tag],
                            memory_format=torch.contiguous_format))
                    else:
                        outs.append(payloads[src][tag].clone(
                            memory_format=torch.contiguous_format))
                results.append(outs)
            return results

        outs = self.rendezvous(comm.rank, ("exchange", meta, ring),
                               [x for x, _, _ in shifts], work)
        return Exchange([], [], outs)

    def permute(self, comm: Communicator, x: torch.Tensor, perm):
        perm = tuple((int(s), int(d)) for s, d in perm)

        def work(xs):
            outs = [None] * self.size
            for src, dst in perm:
                outs[dst] = xs[src].clone(
                    memory_format=torch.contiguous_format)
            return [torch.zeros_like(xs[r]) if o is None else o
                    for r, o in enumerate(outs)]

        return self.rendezvous(comm.rank, ("permute", perm), x, work)

    def _per_line(self, axis_name, per_line):
        """Joint work that runs ``per_line(xs_of_line) -> outs_of_line``
        on every line of the axis."""
        def work(xs):
            results = [None] * self.size
            for line in self.lines(axis_name):
                for r, out in zip(line, per_line([xs[r] for r in line])):
                    results[r] = out
            return results
        return work

    def all_reduce(self, comm: Communicator, x: torch.Tensor, op: SmiOp,
                   axis_name: Optional[str]) -> torch.Tensor:
        combine = combine_fn(op)

        def per_line(xs):
            total = xs[0]
            for x_r in xs[1:]:   # in rank order: one association
                total = combine(total, x_r)
            return [total.clone() for _ in xs]

        return self.rendezvous(comm.rank, ("all_reduce", op, axis_name), x,
                               self._per_line(axis_name, per_line))

    def all_gather(self, comm: Communicator, x: torch.Tensor,
                   axis_name: Optional[str]) -> torch.Tensor:
        def per_line(xs):
            whole = torch.cat(xs, dim=0)
            return [whole.clone() for _ in xs]

        return self.rendezvous(comm.rank, ("all_gather", axis_name), x,
                               self._per_line(axis_name, per_line))

    def reduce_scatter(self, comm: Communicator, x: torch.Tensor,
                       op: SmiOp, axis_name: Optional[str]) -> torch.Tensor:
        combine = combine_fn(op)

        def per_line(xs):
            count = xs[0].shape[0] // len(xs)
            total = xs[0]
            for x_r in xs[1:]:
                total = combine(total, x_r)
            return [total[i * count:(i + 1) * count].clone()
                    for i in range(len(xs))]

        return self.rendezvous(comm.rank, ("reduce_scatter", op, axis_name),
                               x, self._per_line(axis_name, per_line))

    def all_to_all(self, comm: Communicator, x: torch.Tensor,
                   axis_name: Optional[str]) -> torch.Tensor:
        def per_line(xs):
            n = len(xs)
            count = xs[0].shape[0] // n
            return [torch.cat([x_s[pos * count:(pos + 1) * count]
                               for x_s in xs], dim=0)
                    for pos in range(n)]

        return self.rendezvous(comm.rank, ("all_to_all", axis_name), x,
                               self._per_line(axis_name, per_line))

    # -- global arrays <-> per-rank shards ------------------------------

    def _spec_lines(self, spec) -> List[List[int]]:
        """The lines a spec shards over: an axis name, or the tuple of
        all axis names for the whole grid in rank order."""
        if isinstance(spec, str):
            return self.lines(spec)
        if tuple(spec) == self.axis_names:
            return self.lines(None)
        raise ValueError(
            f"a spec is None (replicate), an axis name or the tuple of "
            f"all axis names {self.axis_names}; got {spec!r}"
        )

    def shard(self, x: torch.Tensor, spec) -> List[torch.Tensor]:
        """One tensor per rank from a global one: a copy each for
        ``spec=None``; else the leading dimension cut into one block per
        position along the spec's axis (every line of that axis gets the
        same blocks)."""
        x = x.to(self.device)
        if spec is None:
            return [x.clone() for _ in range(self.size)]
        lines = self._spec_lines(spec)
        n = len(lines[0])
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(
                f"leading dimension of shape {tuple(x.shape)} not "
                f"divisible by the {n} ranks of {spec!r}"
            )
        count = x.shape[0] // n
        shards = [None] * self.size
        for line in lines:
            for pos, r in enumerate(line):
                shards[r] = x[pos * count:(pos + 1) * count].clone()
        return shards

    def assemble(self, shards: Sequence[torch.Tensor], spec) -> torch.Tensor:
        """The global tensor of one output: rank 0's for ``spec=None``,
        else the shards of rank 0's line concatenated in order."""
        if spec is None:
            return shards[0]
        line = self._spec_lines(spec)[0]
        return torch.cat([shards[r] for r in line], dim=0)


def _record_stream(value, stream) -> None:
    """Tell the allocator that ``stream`` uses every tensor in ``value``
    (they were made on the world's stream)."""
    if torch.is_tensor(value):
        if value.is_cuda:
            value.record_stream(stream)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _record_stream(v, stream)
