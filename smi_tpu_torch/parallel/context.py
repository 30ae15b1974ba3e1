"""User-facing kernel context: the counterpart of ``include/smi.h``.

PyTorch counterpart of :mod:`smi_tpu.parallel.context`. A reference SMI
kernel receives an ``SMI_Comm`` and calls the channel API; here a user
function decorated with :func:`smi_kernel` runs once per rank of a
:class:`~smi_tpu_torch.parallel.local.LocalWorld` and receives an
:class:`SmiContext` exposing the same surface: rank/size, open +
push/pop channels, and rooted collectives.

Example (the bandwidth microbenchmark's shape)::

    world = LocalWorld(8)

    @smi_kernel(world, in_specs="smi", out_specs="smi")
    def app(ctx, x):
        ch = ctx.open_channel(port=0, src=0, dst=1, count=N, dtype="float")
        received = ctx.transfer(ch, x)       # Push at src, Pop at dst
        return received if ctx.rank() == 1 else x

MPMD under SPMD: every rank runs the same function; ``ctx.rank()`` is a
Python int, so rank divergence is an ordinary branch — but collectives
and channel transfers are calls every rank must make, so they belong in
the shared code around the branch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from smi_tpu_torch.ops.program import Program
from smi_tpu_torch.ops.types import SmiDtype, SmiOp
from smi_tpu_torch.parallel import collectives as _coll
from smi_tpu_torch.parallel.backend import check_backend
from smi_tpu_torch.parallel.channels import P2PChannel, ring_shift
from smi_tpu_torch.parallel.mesh import Communicator
from smi_tpu_torch.utils.watchdog import Deadline


@dataclasses.dataclass(frozen=True)
class SmiContext:
    """Per-rank handle passed to smi kernels.

    Carries the communicator and optionally the validated program
    metadata (port allocation, rendezvous flag); channel opens consult
    the program when present so tuning knobs declared in program JSON
    apply without repeating them at call sites.
    """

    comm: Communicator
    program: Optional[Program] = None
    #: Default implementation tier: ``"xla"`` (the transport's
    #: collectives) or ``"ring"`` (the explicit credit-controlled ring
    #: kernels, :mod:`smi_tpu_torch.kernels.ring`).
    backend: str = "xla"
    #: Watchdog deadline applied to every channel transfer/stream and
    #: every ring-tier collective dispatched through this context; the
    #: checks are host-side, at dispatch.
    deadline: Optional[Deadline] = None

    # -- communicator ---------------------------------------------------
    def rank(self) -> int:
        return self.comm.rank

    @property
    def size(self) -> int:
        return self.comm.size

    # -- P2P channels ---------------------------------------------------
    def open_channel(
        self,
        port: int,
        src: int,
        dst: int,
        count: int,
        dtype: Union[str, SmiDtype] = "float",
        buffer_size: Optional[int] = None,
    ) -> P2PChannel:
        """Open a transient P2P channel (both endpoints' open in one).
        ``buffer_size`` is the asynchronicity degree in elements."""
        kwargs = {}
        if self.program is not None:
            # program-declared tuning knobs override the dataclass defaults
            kwargs["rendezvous"] = self.program.p2p_rendezvous
            kwargs["consecutive_reads"] = self.program.consecutive_reads
            declared = (self.program.find("push", port)
                        or self.program.find("pop", port))
            if declared is not None and buffer_size is None:
                buffer_size = declared.buffer_size
        return P2PChannel(
            comm=self.comm, port=port, src=src, dst=dst, count=count,
            dtype=dtype, buffer_size=buffer_size, **kwargs,
        )

    def transfer(self, channel: P2PChannel, data,
                 backend: Optional[str] = None) -> torch.Tensor:
        """Fused Push(all elements)+Pop: message at dst, zeros elsewhere."""
        return channel.transfer(data, backend=self._backend(backend),
                                deadline=self.deadline)

    def stream(self, channel: P2PChannel, data,
               consumer: Optional[Callable] = None, init_carry=None,
               backend: Optional[str] = None):
        """Chunked streaming transfer with optional per-chunk consumer."""
        return channel.stream(data, consumer=consumer, init_carry=init_carry,
                              backend=self._backend(backend),
                              deadline=self.deadline)

    def stream_reduce(self, channel: P2PChannel, data, op="add",
                      lanes: Optional[int] = None,
                      backend: Optional[str] = None):
        """Streamed reduction with ``lanes`` partial accumulators
        (``Reduce.accumulation_lanes`` by default)."""
        return channel.stream_reduce(data, op=op, lanes=lanes,
                                     backend=self._backend(backend),
                                     deadline=self.deadline)

    def ring_shift(self, x: torch.Tensor, offset: int = 1,
                   axis_name: Optional[str] = None) -> torch.Tensor:
        return ring_shift(x, self.comm, offset=offset, axis_name=axis_name)

    # -- collectives ----------------------------------------------------
    # ``backend=None`` inherits the context default (``smi_kernel(...,
    # backend=...)``), letting one program switch wholesale between the
    # two tiers. ``chunks`` splits the payload into a pipeline of
    # independent per-chunk collectives (bit-identical reassembly).
    def _backend(self, backend: Optional[str]) -> str:
        return self.backend if backend is None else check_backend(backend)

    def bcast(self, x, root: int = 0, port: Optional[int] = None,
              backend: Optional[str] = None, chunks: Optional[int] = None,
              hierarchical: Optional[bool] = None):
        return _coll.bcast(x, self.comm, root=root, port=port,
                           backend=self._backend(backend),
                           program=self.program, deadline=self.deadline,
                           chunks=chunks, hierarchical=hierarchical)

    def reduce(self, x, op: Union[str, SmiOp] = SmiOp.ADD, root: int = 0,
               port: Optional[int] = None, all_ranks: bool = False,
               backend: Optional[str] = None, chunks: Optional[int] = None,
               hierarchical: Optional[bool] = None):
        return _coll.reduce(x, self.comm, op=op, root=root, port=port,
                            all_ranks=all_ranks,
                            backend=self._backend(backend),
                            program=self.program, deadline=self.deadline,
                            chunks=chunks, hierarchical=hierarchical)

    def allreduce(self, x, op: Union[str, SmiOp] = SmiOp.ADD,
                  backend: Optional[str] = None,
                  chunks: Optional[int] = None,
                  rs_ag: Optional[bool] = None,
                  hierarchical: Optional[bool] = None,
                  precision: Optional[str] = None):
        return _coll.allreduce(x, self.comm, op=op,
                               backend=self._backend(backend),
                               program=self.program,
                               deadline=self.deadline,
                               chunks=chunks, rs_ag=rs_ag,
                               hierarchical=hierarchical,
                               precision=precision)

    def scatter(self, x, root: int = 0, port: Optional[int] = None,
                backend: Optional[str] = None, chunks: Optional[int] = None):
        return _coll.scatter(x, self.comm, root=root, port=port,
                             backend=self._backend(backend),
                             program=self.program, deadline=self.deadline,
                             chunks=chunks)

    def gather(self, x, root: int = 0, port: Optional[int] = None,
               all_ranks: bool = False, backend: Optional[str] = None,
               chunks: Optional[int] = None):
        return _coll.gather(x, self.comm, root=root, port=port,
                            all_ranks=all_ranks,
                            backend=self._backend(backend),
                            program=self.program, deadline=self.deadline,
                            chunks=chunks)

    # ``algorithm`` resolves the env override, then pairwise — see
    # parallel/collectives.all_to_all.
    def all_to_all(self, x, algorithm: Optional[str] = None,
                   port: Optional[int] = None,
                   backend: Optional[str] = None):
        return _coll.all_to_all(x, self.comm, algorithm=algorithm,
                                port=port,
                                backend=self._backend(backend),
                                program=self.program)

    def explain_plan(self, op: str = "all_reduce",
                     dtype: str = "float32") -> str:
        """The plan engine's candidate table for this communicator:
        which knob values a collective dispatched through this context
        would run with, which layer (cache / live / model / heuristic)
        decided each, and the modeled vs measured costs behind the
        choice — the JAX package's text for the same topology, device
        kind and cache. On a hybrid multi-slice grid the allreduce table
        prices all three candidates (flat ring, rs+ag, the two-tier
        form) and names the two-tier gate's deciding layer. The
        ``flash_fwd`` and ``stencil`` tables name the port's own Hopper
        tile plans."""
        from smi_tpu_torch.tuning import cost_model as cm
        from smi_tpu_torch.tuning.engine import get_engine

        topo = cm.topology_from_comm(self.comm)
        return get_engine().explain_text(
            op, n=self.size, dtype=dtype,
            slices=topo.outer if topo.hierarchical_eligible else None,
        )

    # -- degraded mode -------------------------------------------------
    def shrink(self, excluded_ranks) -> "SmiContext":
        """This context over the survivors' communicator
        (:meth:`Communicator.shrink`: survivors keep rank order, the
        shrunk grid is 1-D). The program metadata and backend tier carry
        over; the deadline does not (a recovery phase gets a fresh
        budget)."""
        return dataclasses.replace(
            self, comm=self.comm.shrink(excluded_ranks), deadline=None
        )

    # -- MPMD: per-rank divergent local compute ------------------------
    def select(self, branches, operand):
        """Run ``branches[rank]`` on ``operand`` (rank >= len: the last
        one). Branches must be communication-free: collectives and
        channel transfers are calls every rank must make, so they belong
        in the shared code around the select."""
        return branches[min(self.rank(), len(branches) - 1)](operand)


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _per_arg(specs, n: int, what: str):
    """One spec per argument (or output): a single spec serves them all."""
    if isinstance(specs, list) or (
            isinstance(specs, tuple)
            and not all(isinstance(s, str) for s in specs)):
        specs = list(specs)
        if len(specs) != n:
            raise ValueError(f"{len(specs)} {what} for {n} value(s)")
        return specs
    return [specs] * n


def smi_kernel(
    world,
    in_specs=None,
    out_specs=None,
    program: Optional[Program] = None,
    backend: str = "xla",
    deadline: Optional[Deadline] = None,
):
    """Decorator: run ``fn(ctx, *args)`` on every rank of ``world``.

    The counterpart of ``jax.shard_map`` around an SMI kernel. A spec is
    an axis name (shard the leading dimension over that axis, one block
    per position, rank-major), the tuple of all axis names (shard over
    the whole grid in rank order), or ``None`` (replicate); ``in_specs``
    is one spec for every argument or a list with one per argument (a
    tuple whose entries are not all names is such a list too),
    ``out_specs`` likewise for the outputs. The decorated function takes
    the global arrays (tensors or numpy arrays), shards them onto the
    world's device, runs ``fn`` on every rank's thread, and assembles the
    global outputs: a sharded output is the concatenation of its line's
    shards, a replicated one is rank 0's. ``deadline`` arms the watchdog
    on every channel and ring collective the kernel dispatches.
    """
    from smi_tpu_torch.parallel.local import LocalWorld

    if not isinstance(world, LocalWorld):
        raise TypeError(
            f"smi_kernel runs on a LocalWorld, got {type(world).__name__}; "
            f"a rank that is a process builds SmiContext(comm) itself"
        )
    check_backend(backend)

    def decorator(fn: Callable) -> Callable:
        def run(*args):
            specs = _per_arg(in_specs, len(args), "in_specs")
            shards = [world.shard(_as_tensor(a), s)
                      for a, s in zip(args, specs)]

            def on_rank(comm):
                ctx = SmiContext(comm=comm, program=program,
                                 backend=backend, deadline=deadline)
                return fn(ctx, *(s[comm.rank] for s in shards))

            outs = world.run(on_rank)
            if isinstance(outs[0], (tuple, list)):
                ospecs = _per_arg(out_specs, len(outs[0]), "out_specs")
                return tuple(
                    world.assemble([o[i] for o in outs], s)
                    for i, s in enumerate(ospecs)
                )
            return world.assemble(outs, _per_arg(out_specs, 1,
                                                 "out_specs")[0])

        run.__name__ = getattr(fn, "__name__", "smi_kernel")
        run.__doc__ = fn.__doc__
        return run

    return decorator
