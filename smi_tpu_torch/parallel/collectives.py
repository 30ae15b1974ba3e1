"""Rooted collectives: Bcast, Reduce, Scatter, Gather.

PyTorch counterpart of :mod:`smi_tpu.parallel.collectives`. Reference
semantics kept: every collective takes an arbitrary *root* rank and a
logical *port*; Reduce supports ADD/MAX/MIN; only the root observes
Reduce/Gather results (zeros elsewhere), and rank r receives slice r of
the root's Scatter buffer.

Two implementation tiers per collective (``backend=``):

- ``"xla"`` (default, named as in the JAX package): one collective of
  the communicator's transport — ``torch.distributed``, or the rendezvous
  of a ``LocalWorld``;
- ``"ring"``: the explicit-schedule tier, the hand-written ring kernels
  with credit flow control (:mod:`smi_tpu_torch.kernels.ring`).

Rooted-ness is expressed by masking, as there: a broadcast is an
all-reduce of the value masked to the root (off-root ranks contribute
zeros), a scatter is a reduce-scatter of the masked buffer, and rooted
results are zeroed off-root. ``rank`` is a Python int here, so a mask is
a branch, not a ``where``.

``chunks=`` splits the payload along the leading axis into independent
per-chunk collectives plus a reassembly — pure payload splitting, so the
result is bit-identical to the unchunked call. On the ring tier the
chunks of a scatter or a gather are a sequence of launches on one stream
slot; a chunked ring bcast or reduce needs the chunked all-reduce
kernel, which is not ported yet, and raises. ``chunks=None`` means one
collective: the JAX package's plan engine, its ``precision=`` and
``hierarchical=`` knobs, the reduce-scatter + all-gather gate and
``all_to_all`` are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from smi_tpu_torch.ops.types import SmiOp
from smi_tpu_torch.parallel.backend import check_backend
from smi_tpu_torch.parallel.mesh import Communicator
from smi_tpu_torch.utils.watchdog import Deadline


def _check_deadline(deadline: Optional[Deadline], family: str,
                    comm: Communicator) -> None:
    """Ring-tier watchdog gate: an expired deadline raises
    ``WatchdogTimeout`` before the collective is dispatched."""
    if deadline is not None:
        deadline.check(f"ring {family} over {comm.size} ranks")


def _ring():
    # deferred: only the ring tier needs the kernels' module
    from smi_tpu_torch.kernels import ring

    return ring


def _stream_for(port: Optional[int], program, family: str) -> int:
    """Stream slot of a collective's port — the runtime consumer of the
    program model's port->stream deal (``ops/program.py``): ring
    collectives on distinct streams use distinct flag domains, so they
    cannot disturb each other.

    With a program, a declared stream slot beyond the ring tier's domain
    count is a loud error. Without a program the port wraps modulo the
    domain count (nothing declares which collectives may run at once, so
    ports >= RING_STREAMS may alias; declare a program for the
    guarantee).
    """
    from smi_tpu_torch.kernels.ring import RING_STREAMS
    from smi_tpu_torch.ops.operations import OUT_DATA

    if port is None:
        return 0
    if program is not None:
        op = program.find(family, port)
        if op is not None:
            stream = program.stream_of(op, OUT_DATA)
            if stream >= RING_STREAMS:
                raise ValueError(
                    f"{family} port {port} was dealt to stream {stream}, "
                    f"beyond the ring tier's {RING_STREAMS} flag domains; "
                    f"reduce the program's num_streams or the "
                    f"concurrent-collective count"
                )
            return stream
    return port % RING_STREAMS


def _is_root(comm: Communicator, root: int) -> bool:
    if not (0 <= root < comm.size):
        raise ValueError(
            f"root={root} out of range for comm size {comm.size}"
        )
    return comm.rank == root


def _masked(x: torch.Tensor, keep: bool) -> torch.Tensor:
    return x if keep else torch.zeros_like(x)


def _unsupported(name: str, value, item: str) -> None:
    if value is not None and value is not False:
        raise NotImplementedError(
            f"{name}={value!r} is not ported yet (ROADMAP.md Queue 1 "
            f"item 8: {item})"
        )


# ---------------------------------------------------------------------------
# Chunked software pipelining
# ---------------------------------------------------------------------------


def _check_chunks(chunks: Optional[int]) -> int:
    if chunks is None:
        return 1
    if not isinstance(chunks, int) or isinstance(chunks, bool):
        raise TypeError(f"chunks must be an int, got {chunks!r}")
    if chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    return chunks


def _chunk_bounds(total: int, chunks: int):
    """Balanced contiguous split of ``[0, total)`` into at most
    ``chunks`` non-empty ranges (``np.array_split``'s law: the first
    ``total % k`` chunks get one extra element). ``chunks`` beyond
    ``total`` clamps — a chunk is at least one element."""
    k = max(1, min(chunks, total))
    q, r = divmod(total, k)
    bounds, start = [], 0
    for i in range(k):
        size = q + (1 if i < r else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def _pipelined(x: torch.Tensor, chunks: int, emit) -> torch.Tensor:
    """Emit one collective per leading-axis chunk and reassemble.
    Identity transform for ``chunks=1``, scalars, and 1-row payloads."""
    if chunks <= 1 or x.dim() == 0 or x.shape[0] <= 1:
        return emit(x)
    bounds = _chunk_bounds(x.shape[0], chunks)
    if len(bounds) <= 1:
        return emit(x)
    return torch.cat([emit(x[s:e]) for s, e in bounds], dim=0)


def _reassemble_rank_major(pieces, bounds, size: int) -> torch.Tensor:
    """Rank-major reassembly of per-chunk tiled gathers.

    Each ``pieces[i]`` is a ``(size * n_i, ...)`` gather of chunk ``i``
    (rank-interleaved chunk-major); the unchunked layout wants rank
    ``r``'s full contribution contiguous, i.e. the concatenation of its
    slice of every chunk's gather. Shared by both gather tiers so the
    two epilogues cannot diverge.
    """
    rows = []
    for r in range(size):
        for piece, (s, e) in zip(pieces, bounds):
            ni = e - s
            rows.append(piece[r * ni:(r + 1) * ni])
    return torch.cat(rows, dim=0)


def _chunked_gather(x: torch.Tensor, size: int, chunks: int, gather_one):
    """Tiled all-gather in leading-axis chunks, ``gather_one(piece)``
    each, reassembled rank-major: bit-identical to one gather."""
    total = x.shape[0] if x.dim() else 1
    bounds = (_chunk_bounds(total, chunks)
              if chunks > 1 and x.dim() else [(0, total)])
    if len(bounds) <= 1:
        return gather_one(x)
    pieces = [gather_one(x[s:e]) for s, e in bounds]
    return _reassemble_rank_major(pieces, bounds, size)


def _chunked_scatter(x: torch.Tensor, size: int, chunks: int, scatter_one):
    """Tiled reduce-scatter in chunks of the per-destination block.

    ``x`` is ``(size * count, ...)``; chunking splits the ``count`` dim
    (NOT the raw leading dim — a naive split would misalign the
    rank-interleaved destination blocks) and scatters each column range
    with ``scatter_one``; results concatenate back in block order.
    """
    count = x.shape[0] // size
    bounds = _chunk_bounds(count, chunks) if chunks > 1 else [(0, count)]
    if len(bounds) <= 1:
        return scatter_one(x)
    xu = x.reshape((size, count) + tuple(x.shape[1:]))
    parts = [
        scatter_one(xu[:, s:e].reshape((size * (e - s),)
                                       + tuple(x.shape[1:])))
        for s, e in bounds
    ]
    return torch.cat(parts, dim=0)


def _ring_chunks_refused(chunks: int, family: str) -> None:
    if chunks > 1:
        raise NotImplementedError(
            f"a chunked ring {family} (chunks={chunks}) needs the chunked "
            "ring all-reduce kernel, which is not ported yet (ROADMAP.md "
            "Queue 2 item 8); use chunks=1 or backend='xla'"
        )


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def bcast(x: torch.Tensor, comm: Communicator, root: int = 0,
          port: Optional[int] = None, backend: str = "xla",
          program=None, deadline: Optional[Deadline] = None,
          chunks: Optional[int] = None,
          hierarchical: Optional[bool] = None) -> torch.Tensor:
    """One-to-all: every rank returns the root's ``x``.

    Reference: ``SMI_Bcast``. A single masked all-reduce whose only
    non-zero contribution is the root's value; under ``backend="ring"``
    it circulates around the explicit credit-controlled ring.
    """
    check_backend(backend)
    _unsupported("hierarchical", hierarchical, "hierarchical collectives")
    chunks = _check_chunks(chunks)
    contrib = _masked(x, _is_root(comm, root))
    if backend == "ring":
        _check_deadline(deadline, "broadcast", comm)
        _ring_chunks_refused(chunks, "bcast")
        return _ring().ring_all_reduce(
            contrib, comm, op=SmiOp.ADD,
            stream=_stream_for(port, program, "broadcast"),
        )
    # on this tier the port is metadata only
    return _pipelined(contrib, chunks,
                      lambda piece: comm.all_reduce(piece, SmiOp.ADD))


def reduce(x: torch.Tensor, comm: Communicator,
           op: Union[str, SmiOp] = SmiOp.ADD, root: int = 0,
           port: Optional[int] = None, all_ranks: bool = False,
           backend: str = "xla", program=None,
           deadline: Optional[Deadline] = None,
           chunks: Optional[int] = None,
           hierarchical: Optional[bool] = None) -> torch.Tensor:
    """All-to-one reduction with ADD/MAX/MIN.

    Reference: ``SMI_Reduce``: every rank contributes, only the root
    receives the result (zeros elsewhere here). With ``all_ranks=True``
    behaves as an allreduce (no masking) — the fused Reduce+Bcast idiom
    of kmeans without the second collective. ``backend="ring"`` runs the
    circulating-partial ring kernel.
    """
    check_backend(backend)
    op = SmiOp.parse(op)
    _unsupported("hierarchical", hierarchical, "hierarchical collectives")
    chunks = _check_chunks(chunks)
    root_here = _is_root(comm, root)
    if backend == "ring":
        _check_deadline(deadline, "reduce", comm)
        _ring_chunks_refused(chunks, "reduce")
        out = _ring().ring_all_reduce(
            x, comm, op=op, stream=_stream_for(port, program, "reduce"),
        )
    else:
        out = _pipelined(x, chunks, lambda p: comm.all_reduce(p, op))
    return out if all_ranks else _masked(out, root_here)


def allreduce(x: torch.Tensor, comm: Communicator,
              op: Union[str, SmiOp] = SmiOp.ADD,
              backend: str = "xla", program=None,
              deadline: Optional[Deadline] = None,
              chunks: Optional[int] = None,
              rs_ag: Optional[bool] = None,
              hierarchical: Optional[bool] = None,
              precision: Optional[str] = None) -> torch.Tensor:
    """Reduce + Bcast in one collective.

    ``rs_ag`` and ``hierarchical`` are decompositions of the
    collective-library tier in the JAX package: forcing one on the ring
    tier is an error, as there, and neither is ported yet on this tier;
    nor is ``precision=`` (quantised and sparse wire formats).
    """
    check_backend(backend)
    op = SmiOp.parse(op)
    if backend != "xla":
        # a forced decomposition must never be silently dropped
        if rs_ag:
            raise ValueError(
                "rs_ag=True is an XLA-tier decomposition; the ring tier "
                "runs the circulating-partial kernel — drop rs_ag or use "
                "backend='xla'"
            )
        if hierarchical:
            raise ValueError(
                "hierarchical=True is an XLA-tier composition; the ring "
                "tier runs the circulating-partial kernel — drop "
                "hierarchical or use backend='xla'"
            )
    _unsupported("rs_ag", rs_ag, "the reduce-scatter + all-gather gate")
    _unsupported("hierarchical", hierarchical, "hierarchical collectives")
    _unsupported("precision", precision, "quantised and sparse allreduce")
    return reduce(x, comm, op=op, all_ranks=True, backend=backend,
                  program=program, deadline=deadline, chunks=chunks)


def scatter(x: torch.Tensor, comm: Communicator, root: int = 0,
            port: Optional[int] = None, backend: str = "xla",
            program=None, deadline: Optional[Deadline] = None,
            chunks: Optional[int] = None) -> torch.Tensor:
    """Root distributes contiguous slices; rank r returns slice r.

    Reference: ``SMI_Scatter``. ``x`` must have leading dimension ``size
    * count`` (valid at root). The root's masked buffer goes through one
    reduce-scatter, so each rank receives only its own slice.
    ``backend="ring"`` uses the ring reduce-scatter kernel; its chunks
    are launches in program order on one stream slot.
    """
    check_backend(backend)
    chunks = _check_chunks(chunks)
    size = comm.size
    if x.dim() == 0 or x.shape[0] % size != 0:
        raise ValueError(
            f"scatter buffer leading dim "
            f"{x.shape[0] if x.dim() else '()'} not divisible by comm "
            f"size {size}"
        )
    contrib = _masked(x, _is_root(comm, root))
    if backend == "ring":
        _check_deadline(deadline, "scatter", comm)
        stream = _stream_for(port, program, "scatter")
        return _chunked_scatter(
            contrib, size, chunks,
            lambda piece: _ring().ring_reduce_scatter(
                piece, comm, op=SmiOp.ADD, stream=stream),
        )
    return _chunked_scatter(
        contrib, size, chunks,
        lambda piece: comm.reduce_scatter(piece, SmiOp.ADD),
    )


def gather(x: torch.Tensor, comm: Communicator, root: int = 0,
           port: Optional[int] = None, all_ranks: bool = False,
           backend: str = "xla", program=None,
           deadline: Optional[Deadline] = None,
           chunks: Optional[int] = None) -> torch.Tensor:
    """Root collects contiguous slices; returns ``size * count`` at root.

    Reference: ``SMI_Gather``. One all-gather, masked off-root (or kept
    everywhere with ``all_ranks=True``). ``backend="ring"`` forwards
    chunks neighbour to neighbour around the explicit ring.
    """
    check_backend(backend)
    chunks = _check_chunks(chunks)
    size = comm.size
    root_here = _is_root(comm, root)
    if backend == "ring":
        _check_deadline(deadline, "gather", comm)
        stream = _stream_for(port, program, "gather")
        out = _chunked_gather(
            x, size, chunks,
            lambda piece: _ring().ring_all_gather(piece, comm,
                                                  stream=stream),
        )
    else:
        out = _chunked_gather(x, size, chunks, comm.all_gather)
    return out if all_ranks else _masked(out, root_here)


def all_to_all(x: torch.Tensor, comm: Communicator, **kwargs):
    """Not ported yet (the JAX package's pairwise, Bruck and two-tier
    all-to-all family)."""
    raise NotImplementedError(
        "all_to_all is not ported yet (ROADMAP.md Queue 1 item 8: the "
        "all-to-all family)"
    )
