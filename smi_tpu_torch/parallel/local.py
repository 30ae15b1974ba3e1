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
"""

from __future__ import annotations

import math
import threading
from typing import Callable, List, Optional, Sequence

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

#: seconds a rank waits for the others at a rendezvous before the world
#: is declared broken
RENDEZVOUS_TIMEOUT_S = 600.0


class LocalWorld:
    """A rank grid of threads on one device.

    ``shape`` is the grid (an int for a 1-D grid), ``axis_names`` its
    axes (``"smi"`` for 1-D), ``device`` where every rank's tensors live
    (CUDA by default; pass ``device="cpu"`` to run on the CPU).
    ``world.comms[r]`` is rank r's communicator; :meth:`run` runs a
    function on every rank at once.
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
        cuda = self.device.type == "cuda"
        if self._barrier.broken:
            self._barrier.reset()
        if cuda:
            # the ranks' streams do not wait for the default stream
            torch.cuda.synchronize(self.device)
        out, errors = [None] * self.size, []

        def body(r):
            try:
                if cuda:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(self._cuda_streams()[r + 1]):
                        out[r] = fn(self.comms[r])
                        torch.cuda.current_stream().synchronize()
                else:
                    out[r] = fn(self.comms[r])
            except BaseException as exc:  # raised again below
                errors.append(exc)
                self._barrier.abort()

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
        the world's stream, return this rank's result. ``kind`` names
        the call; ranks that arrive with different kinds have diverged,
        and the world fails."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.current_stream().synchronize()
        self._in[rank] = (kind, payload)
        if self._barrier.wait() == 0:
            try:
                kinds = [k for k, _ in self._in]
                if any(k != kinds[0] for k in kinds):
                    raise RuntimeError(
                        f"the ranks of the world diverged: they met with "
                        f"calls {kinds}"
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
        self._barrier.wait()
        result = self._out[rank]
        if cuda:
            _record_stream(result, torch.cuda.current_stream())
        return result

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
