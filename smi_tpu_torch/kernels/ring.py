"""Ring collectives and neighbour streaming with explicit flow control.

PyTorch counterpart of :mod:`smi_tpu.kernels.ring`: the ``"ring"``
backend of the rooted collectives and the P2P channels. The five
hand-written CUDA kernels of ``csrc/ring.cu`` play the credit protocol of
:mod:`smi_tpu.parallel.credits` between ranks that share one card: each
rank writes its payload into one of two comm slots of its neighbour (one
pair per chunk for the chunked all-reduce), counts the write on the
neighbour's receive flag, and may reuse a slot only after the neighbour
granted it back.

Ranks are the threads of a :class:`~smi_tpu_torch.parallel.local.
LocalWorld`. A wrapper is a rendezvous: every rank leaves its tensor, and
one rank launches **one** grid that plays all of them — every line of the
axis at once — on the world's stream, waits for it, and hands each rank
its output. The comm slots and the flag words are tensors the world owns,
one set per stream slot (:data:`RING_STREAMS`; collectives on different
ports must not share a flag domain), grown only at a rendezvous and
zeroed before each launch, when no kernel is in flight. Every block
leaves its credit record in its flag words; :func:`last_record` reads it
back when asked and :func:`drained` says whether every credit that was
granted was consumed, which the Pallas interpreter checks for the JAX
kernels.

Beside each kernel stands its plain PyTorch version, a function of all
the ring's inputs that replays the schedule step by step — the same
slots, the same fold order — so kernel and plain version agree bit for
bit in every dtype. The wrappers run it for CPU tensors, launch the
kernel for CUDA tensors, and raise on anything else.

Nothing of Mosaic's layout is carried over: any shape streams (the
kernels copy 16 bytes a load where the slice is aligned and finish by
words or bytes), and 8-bit payloads reduce like any other. The flags are
written and read at device scope: every rank of a launch lives on the
one card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from smi_tpu_torch.kernels import _build
from smi_tpu_torch.ops.types import SmiOp
from smi_tpu_torch.parallel.backend import combine_fn
from smi_tpu_torch.parallel.mesh import Communicator
from smi_tpu_torch.utils.tracing import annotate

#: flag domains of the ring tier: the stream slot comes from the program
#: model's port allocation, and rings on distinct slots never share flags
RING_STREAMS = 4

#: element types the kernels take, and their code in ``ring.cu``
DTYPE_CODES = {torch.int32: 0, torch.float32: 1, torch.float64: 2,
               torch.int8: 3, torch.int16: 4, torch.bfloat16: 5}
OP_CODES = {SmiOp.ADD: 0, SmiOp.MAX: 1, SmiOp.MIN: 2}

#: layout of one block's flag words (``ring.cu``)
FLAG_WORDS = 32
_BARRIER, _RECV, _CREDIT, _GRANTED, _CONSUMED = 0, 1, 3, 5, 6

#: a block's slice is at least this many bytes; at most
#: :data:`MAX_BLOCKS_PER_RANK` blocks a rank, and few enough in all to be
#: resident at once (``ring.cu`` holds four blocks an SM; the C entry
#: point checks against the card)
SLICE_BYTES = 16 * 1024
#: the neighbour stream's floor: a chunk costs a flag round trip and the
#: copy of a slice, which one round of loads of a role's copying warps
#: (96 threads, four 16-byte loads each: 6 KiB) moves at once
#: (``chip_smoke.py`` phase 24 times the stream at 2, 4, 8 and 16 KiB)
STREAM_SLICE_BYTES = 4 * 1024
MAX_BLOCKS_PER_RANK = 64
MAX_BLOCKS = 512


# ---------------------------------------------------------------------------
# Plain versions: one ring, all ranks' inputs, the kernels' schedule
# ---------------------------------------------------------------------------


def neighbour_stream_plain(xs: Sequence[torch.Tensor],
                           direction: int = 1) -> List[torch.Tensor]:
    """Every rank streams its ``(chunks, ...)`` rows to ``me+direction``
    through two slots of the receiver; ``out[r]`` is what rank r
    received. Chunk ``c`` lands in slot ``c % 2`` and is copied out
    before chunk ``c + 2`` may overwrite it."""
    n = len(xs)
    chunks = xs[0].shape[0]
    outs = [torch.empty_like(x) for x in xs]
    slots = [[None, None] for _ in range(n)]
    for c in range(chunks):
        slot = c % 2
        for r in range(n):
            slots[(r + direction) % n][slot] = xs[r][c].clone()
        for r in range(n):
            outs[r][c] = slots[r][slot]
    return outs


def ring_all_gather_plain(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each rank forwards the chunk it received last to its right
    neighbour; after ``n-1`` steps ``out[r]`` holds every chunk in rank
    order."""
    n = len(xs)
    c = xs[0].shape[0]
    outs = [x.new_empty((n * c,) + tuple(x.shape[1:])) for x in xs]
    slots = [[x.clone(), None] for x in xs]
    for r in range(n):
        outs[r][r * c:(r + 1) * c] = xs[r]
    for s in range(n - 1):
        slot, nslot = s % 2, (s + 1) % 2
        sent = [slots[r][slot] for r in range(n)]
        for r in range(n):
            slots[(r + 1) % n][nslot] = sent[r].clone()
        for r in range(n):
            src = (r - s - 1) % n
            outs[r][src * c:(src + 1) * c] = slots[r][nslot]
    return outs


def _circulate(first, own, n: int, op) -> List[torch.Tensor]:
    """The circulating-partial schedule: at step 0 every rank writes
    ``first(r)`` into its right neighbour's slot 1; at step s it writes
    ``combine(arrival, own(r, s-1))``, the arrival of step s-1 with its
    own contribution folded in, into the neighbour's other slot; the last
    arrival and ``own(r, n-2)`` fold into the output."""
    combine = combine_fn(op)
    slots = [[None, None] for _ in range(n)]
    for s in range(n - 1):
        slot, nslot = s % 2, (s + 1) % 2
        if s == 0:
            sent = [first(r).clone() for r in range(n)]
        else:
            sent = [combine(slots[r][slot], own(r, s - 1)) for r in range(n)]
        for r in range(n):
            slots[(r + 1) % n][nslot] = sent[r]
    return [combine(slots[r][(n - 1) % 2], own(r, n - 2)) for r in range(n)]


def ring_all_reduce_plain(xs: Sequence[torch.Tensor],
                          op: Union[str, SmiOp] = SmiOp.ADD
                          ) -> List[torch.Tensor]:
    """ADD/MAX/MIN of the ring's inputs on every rank. After step s rank
    r holds ``((x[r-s-1] o x[r-s]) o ...) o x[r]``: a left fold that
    starts at ``x[r+1]`` and ends at ``x[r]``, another association on
    every rank."""
    n = len(xs)
    return _circulate(lambda r: xs[r], lambda r, s: xs[r], n, op)


def check_chunks(chunks: Optional[int]) -> int:
    """``chunks`` as a pipeline depth: None is 1; anything but an int of
    at least 1 raises."""
    if chunks is None:
        return 1
    if not isinstance(chunks, int) or isinstance(chunks, bool):
        raise TypeError(f"chunks must be an int, got {chunks!r}")
    if chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    return chunks


def chunk_rows(x: torch.Tensor, chunks: int) -> torch.Tensor:
    """The chunked kernel's payload: the leading axis of ``x`` split into
    ``chunks`` rows of ``ceil(rows / chunks)``, zero rows padding the
    last (every rank pads alike, and the pad is sliced off, so MAX and
    MIN are safe); a 1-D payload becomes ``(chunks, 1, per)``."""
    rows = x.shape[0]
    per = -(-rows // chunks)
    pad = per * chunks - rows
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    if x.dim() == 1:
        return x.reshape(chunks, 1, per)
    return x.reshape((chunks, per) + tuple(x.shape[1:]))


def unchunk_rows(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`chunk_rows`: the pad dropped, ``like``'s
    shape."""
    return out.reshape((-1,) + tuple(like.shape[1:]))[:like.shape[0]] \
        .reshape(like.shape)


def _all_reduce_rows(xus: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    """The chunked schedule on ``(chunks, ...)`` payloads, as
    ``credits.all_reduce_chunked_rank`` plays it: chunk ``c`` on slots
    ``2c + parity``; a step sends every chunk (the fold of the last
    arrival with the rank's own chunk, as the kernel folds it on the way
    out), then takes every arrival in chunk order."""
    n = len(xus)
    chunks = xus[0].shape[0]
    combine = combine_fn(op)
    slots = [[None] * (2 * chunks) for _ in range(n)]
    for s in range(n - 1):
        slot, nslot = s % 2, (s + 1) % 2
        sent = [[xus[r][c].clone() if s == 0
                 else combine(slots[r][2 * c + slot], xus[r][c])
                 for c in range(chunks)] for r in range(n)]
        for r in range(n):
            for c in range(chunks):
                slots[(r + 1) % n][2 * c + nslot] = sent[r][c]
    last = (n - 1) % 2
    return [torch.stack([combine(slots[r][2 * c + last], xus[r][c])
                         for c in range(chunks)]) for r in range(n)]


def ring_all_reduce_chunked_plain(xs: Sequence[torch.Tensor], chunks: int,
                                  op: Union[str, SmiOp] = SmiOp.ADD
                                  ) -> List[torch.Tensor]:
    """The chunked all-reduce of the ring's inputs, chunk by chunk on
    slot pairs: ``chunks`` clamped to the leading dimension, the rows
    split and padded as :func:`chunk_rows` does. Per element the fold is
    :func:`ring_all_reduce_plain`'s, so the two agree bit for bit."""
    x = xs[0]
    chunks = max(1, min(check_chunks(chunks), x.shape[0] if x.dim() else 1))
    if chunks == 1:
        return ring_all_reduce_plain(xs, op)
    outs = _all_reduce_rows([chunk_rows(t, chunks) for t in xs], op)
    return [unchunk_rows(o, x) for o in outs]


def ring_reduce_scatter_plain(xs: Sequence[torch.Tensor],
                              op: Union[str, SmiOp] = SmiOp.ADD
                              ) -> List[torch.Tensor]:
    """Rank r ends with block r of the leading dimension, reduced: it
    starts from its own block ``(r-1) % n`` and at step s folds its own
    block ``(r-s-2) % n`` into the arriving partial."""
    n = len(xs)
    c = xs[0].shape[0] // n

    def block(r, idx):
        return xs[r][idx * c:(idx + 1) * c]

    return _circulate(lambda r: block(r, (r - 1) % n),
                      lambda r, s: block(r, (r - s - 2) % n), n, op)


# ---------------------------------------------------------------------------
# The world's ring state and the launch
# ---------------------------------------------------------------------------


def _align(nbytes: int, to: int = 256) -> int:
    return -(-nbytes // to) * to


def max_chunks(ranks: int) -> int:
    """The most chunks one launch of the chunked all-reduce takes on a
    world of ``ranks``: every chunk has a block of its own, and a rank
    has at most :data:`MAX_BLOCKS_PER_RANK` blocks, the world
    :data:`MAX_BLOCKS`."""
    return max(1, min(MAX_BLOCKS_PER_RANK, MAX_BLOCKS // ranks))


def launch_plan(unit_bytes: int, ranks: int, chunks: int = 1,
                slice_bytes: int = SLICE_BYTES):
    """The grid of one launch on a world of ``ranks``: ``(blocks a chunk,
    blocks a rank)``. Each of the ``chunks`` units of ``unit_bytes`` is
    cut over blocks of its own, slices of at least ``slice_bytes``, and a
    rank's ``chunks`` x blocks stay within :func:`max_chunks`'s caps;
    block ``x`` of a rank plays chunk ``x // blocks`` on flag row ``x``.
    The neighbour stream's chunks follow each other on the same blocks
    (``chunks`` 1, its unit one chunk, ``slice_bytes``
    :data:`STREAM_SLICE_BYTES`)."""
    cap = max_chunks(ranks)
    if not 1 <= chunks <= cap:
        raise ValueError(f"{chunks} chunks: a launch on {ranks} ranks "
                         f"takes 1 to {cap}")
    blocks = max(1, min(cap // chunks, -(-unit_bytes // slice_bytes)))
    return blocks, chunks * blocks


def _ring_state(world, stream: int, slot_bytes: int, chunks: int,
                rows: int) -> dict:
    """The persistent tensors of one stream slot, grown to hold ``2 *
    chunks`` slots of ``slot_bytes`` and ``rows`` flag rows a rank (one a
    block, :func:`launch_plan`). Called by the leader at a rendezvous: no
    kernel is in flight, so growing may free the old tensors."""
    state = world.ring_state.setdefault(("stream", stream), {})
    n = world.size
    if "table" not in state:
        state["flags"] = torch.zeros((n, 0, FLAG_WORDS), dtype=torch.int32,
                                     device=world.device)
        state["slots"] = torch.empty((n, 0), dtype=torch.uint8,
                                     device=world.device)
        state["table"] = torch.zeros((n, 8), dtype=torch.int64,
                                     device=world.device)
        state["rows"] = None   # what the table on the card holds
    if rows > state["flags"].shape[1]:
        state["flags"] = torch.zeros((n, rows, FLAG_WORDS),
                                     dtype=torch.int32, device=world.device)
    capacity = 2 * chunks * slot_bytes
    if capacity > state["slots"].shape[1]:
        state["slots"] = None   # free before growing
        state["slots"] = torch.empty((n, capacity), dtype=torch.uint8,
                                     device=world.device)
    return state


def _launch(kernel: str, world, axis_name, stream: int, xs, outs,
            unit_elems: int, extra: tuple, flow_control: bool,
            chunks: int = 1) -> None:
    """One launch that plays every rank of the world: every line of the
    axis is a ring. ``unit_elems`` elements circulate on each of
    ``chunks`` slot pairs; ``extra`` are the kernel's own arguments
    between the dtype code and ``flow_control``, and the chunked
    all-reduce takes ``chunks`` after them."""
    n_world = world.size
    lines = world.lines(axis_name)
    n = len(lines[0])
    dtype = xs[0].dtype
    unit_bytes = unit_elems * dtype.itemsize
    stride = _align(unit_bytes)
    slice_bytes = (STREAM_SLICE_BYTES if kernel == "ring_neighbour_stream"
                   else SLICE_BYTES)
    blocks, flag_rows = launch_plan(unit_bytes, n_world, chunks, slice_bytes)
    state = _ring_state(world, stream, stride, chunks, flag_rows)
    flags, slots = state["flags"], state["slots"]
    flags[:, :flag_rows].zero_()
    # rank r's slots and flag rows, by address: indexing the tensors per
    # rank would cost the host more than the rest of the launch
    slot0, slot_step = slots.data_ptr(), slots.stride(0)
    flag0, flag_step = flags.data_ptr(), flags.stride(0) * flags.itemsize
    rows = [None] * n_world
    for line in lines:
        for pos, r in enumerate(line):
            rows[r] = (xs[r].data_ptr(), outs[r].data_ptr(),
                       slot0 + r * slot_step, flag0 + r * flag_step, pos,
                       line[(pos + 1) % n], line[(pos - 1) % n], 0)
    if rows != state["rows"]:   # the allocator hands the same blocks back
        state["table"].copy_(torch.tensor(rows, dtype=torch.int64))
        state["rows"] = rows
    if "events" not in state:
        state["events"] = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
    begin, end = state["events"]
    # the world's device's current stream, asked once: each ask costs the
    # host a few microseconds
    queue = torch.cuda.current_stream(world.device)
    begin.record(queue)
    with annotate("smi.ring.launch"):
        _build.launch(
            kernel, world.device, state["table"].data_ptr(), n_world, n,
            unit_elems, stride, DTYPE_CODES[dtype], *extra,
            *((chunks,) if kernel == "ring_all_reduce_chunked" else ()),
            int(flow_control), blocks, stream=queue.cuda_stream,
        )
    end.record(queue)
    # the rendezvous waits for the world's stream before it releases the
    # ranks: a trapped spin is raised there
    world.ring_state["last_launch"] = {
        "kernel": kernel, "stream": stream, "flow_control": flow_control,
        "ranks": n_world, "ring": n, "blocks": blocks, "chunks": chunks,
    }


def last_record(world) -> Optional[dict]:
    """The credit record of the world's last kernel launch (None before
    one, and on a CPU world), read from the card now — so before the next
    launch on the same stream slot zeroes it: per rank and flag row (a
    block's: ``chunks`` x ``blocks`` of them, chunk-major, ``blocks``
    being the blocks of one chunk), the credits it ``granted``, the
    credits it ``consumed``, the credit signals it received, and its
    barrier word; and ``ms``, the grid's time from launch to completion
    by CUDA events on the world's stream (the host's launch latency
    included when the card was idle)."""
    launch = world.ring_state.get("last_launch")
    if launch is None:
        return None
    state = world.ring_state[("stream", launch["stream"])]
    rows = launch["chunks"] * launch["blocks"]
    record = state["flags"][:, :rows, :7].cpu()
    begin, end = state["events"]
    return dict(
        launch,
        ms=begin.elapsed_time(end),
        granted=record[:, :, _GRANTED],
        consumed=record[:, :, _CONSUMED],
        credits_received=record[:, :, _CREDIT] + record[:, :, _CREDIT + 1],
        barrier=record[:, :, _BARRIER],
    )


def drained(record: dict) -> bool:
    """Whether every credit domain drained: each flag row (a block's)
    consumed exactly the credits it received, as many were consumed as
    granted, and with flow control each live block's barrier saw its two
    neighbours (none without; a block past the end of a small unit holds
    no barrier)."""
    consumed, received = record["consumed"], record["credits_received"]
    if not torch.equal(consumed, received):
        return False
    if int(record["granted"].sum()) != int(consumed.sum()):
        return False
    barrier = record["barrier"]
    if record["flow_control"]:
        return bool(((barrier == 2) | (barrier == 0)).all())
    return not bool(barrier.any())


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def require_world(comm: Communicator):
    """The world whose thread this rank is; the ring tier has no launch
    form yet for a rank that is a process of its own."""
    if comm.world is None:
        raise NotImplementedError(
            'backend="ring" runs on a LocalWorld (smi_tpu_torch.parallel.'
            "local): ranks that are threads of one process on one card. "
            "The launch form for ranks in other processes or on other "
            "cards (CUDA IPC, NVLink peer access) is not built yet "
            "(ROADMAP.md Queue C: the peer launch form, not runnable on "
            "one H100)"
        )
    return comm.world


def _check_stream(stream: int) -> int:
    if not 0 <= stream < RING_STREAMS:
        raise ValueError(
            f"stream must be in [0, {RING_STREAMS}), got {stream}"
        )
    return stream


def _ring_size(comm: Communicator, axis_name) -> int:
    require_world(comm)
    if axis_name is not None and not isinstance(axis_name, str):
        if tuple(axis_name) != comm.axis_names:
            raise ValueError(
                f"a ring spans one axis or all axes {comm.axis_names} in "
                f"order, got {axis_name!r}"
            )
    return len(comm.line(_one_axis(axis_name)))


def _one_axis(axis_name) -> Optional[str]:
    """The transport's axis argument: a name, or None for the whole grid
    flattened in rank order (also spelled as the tuple of all axes)."""
    return axis_name if isinstance(axis_name, str) else None


def _run(kernel: str, x: torch.Tensor, comm: Communicator, axis_name,
         stream: int, flow_control: bool, params: tuple, plain, out_shape,
         unit_elems: int, extra: tuple, chunks: int = 1) -> torch.Tensor:
    """The rendezvous of one ring call: every rank leaves ``x``; the
    leader runs ``plain`` per ring on CPU tensors, or launches ``kernel``
    once for the whole world on CUDA tensors."""
    world = require_world(comm)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(
            f"{kernel}: dtype {x.dtype} is not one of "
            f"{sorted(str(d) for d in DTYPE_CODES)}"
        )
    axis = _one_axis(axis_name)

    def work(xs):
        for r, other in enumerate(xs):
            if (other.shape != xs[0].shape or other.dtype != xs[0].dtype
                    or other.device != xs[0].device):
                raise ValueError(
                    f"{kernel}: rank {r} brought {tuple(other.shape)} "
                    f"{other.dtype} on {other.device}, rank 0 "
                    f"{tuple(xs[0].shape)} {xs[0].dtype} on {xs[0].device}"
                )
        results = [None] * world.size
        if xs[0].device.type == "cpu":
            for line in world.lines(axis):
                for r, out in zip(line, plain([xs[r] for r in line])):
                    results[r] = out
            return results
        outs = [torch.empty(out_shape, dtype=x.dtype, device=x.device)
                for _ in xs]
        _launch(kernel, world, axis, stream, xs, outs, unit_elems, extra,
                flow_control, chunks)
        return outs

    return world.rendezvous(
        comm.rank, (kernel, axis, stream, flow_control) + params,
        x.contiguous(), work)


def neighbour_stream(
    x: torch.Tensor,
    comm: Communicator,
    axis_name=None,
    direction: int = 1,
    flow_control: bool = True,
    stream: int = 0,
) -> torch.Tensor:
    """Stream ``x`` chunk by chunk to the ring neighbour ``me+direction``.

    ``x`` has shape ``(chunks, ...)``, one leading row per chunk; each
    chunk is one bounded in-flight unit. Returns the upstream
    neighbour's ``x``. The ring is the line of ``axis_name`` through
    this rank, or the whole grid in rank order (None). Without flow
    control a message of more than two chunks may be overwritten before
    it is read: that is what the credits are for.
    """
    if direction not in (1, -1):
        raise ValueError(f"direction must be +1 or -1, got {direction}")
    _check_stream(stream)
    n = _ring_size(comm, axis_name)
    if n == 1 or x.numel() == 0:
        return x
    if x.dim() < 1:
        raise ValueError("neighbour_stream needs a (chunks, ...) payload")
    chunks = x.shape[0]
    return _run(
        "ring_neighbour_stream", x, comm, axis_name, stream, flow_control,
        (direction,), lambda xs: neighbour_stream_plain(xs, direction),
        tuple(x.shape), x.numel() // chunks, (chunks, direction),
    )


def ring_all_gather(
    x: torch.Tensor,
    comm: Communicator,
    axis_name=None,
    flow_control: bool = True,
    stream: int = 0,
) -> torch.Tensor:
    """All-gather ``x`` (this rank's chunk) along a ring: the ``(n *
    chunk, ...)`` array on every rank, as ``lax.all_gather(...,
    tiled=True)`` with an explicit neighbour schedule."""
    _check_stream(stream)
    n = _ring_size(comm, axis_name)
    if n == 1:
        return x
    if x.dim() < 1:
        raise ValueError("ring_all_gather needs a (chunk, ...) payload")
    out_shape = (n * x.shape[0],) + tuple(x.shape[1:])
    if x.numel() == 0:
        return x.new_empty(out_shape)
    return _run(
        "ring_all_gather", x, comm, axis_name, stream, flow_control, (),
        ring_all_gather_plain, out_shape, x.numel(), (),
    )


def _planned_ring_chunks(x: torch.Tensor, n: int) -> int:
    """The plan engine's pipeline depth for a ``chunks=None`` ring
    all-reduce: a measured cache entry for this device kind, payload
    bucket, dtype and ring size, else 1 (the unchunked kernel). Never
    raises."""
    try:
        from smi_tpu_torch.tuning.engine import dtype_name, planned_chunks

        payload = x.numel() * x.element_size() if x.dim() else 0
        return check_chunks(planned_chunks("ring_all_reduce", payload, n,
                                           dtype_name(x.dtype)))
    except Exception:
        return 1


def ring_all_reduce(
    x: torch.Tensor,
    comm: Communicator,
    axis_name=None,
    op: Union[str, SmiOp] = SmiOp.ADD,
    flow_control: bool = True,
    stream: int = 0,
    chunks: Optional[int] = None,
) -> torch.Tensor:
    """ADD/MAX/MIN all-reduce along a ring of explicit neighbour writes.

    Each rank's partial makes a full circuit: after ``n-1`` hops every
    rank has folded in all ``n`` contributions, each in its own rotated
    order, so float sums agree across ranks up to reassociation.

    ``chunks > 1`` splits the leading axis into that many pipeline rows
    (:func:`chunk_rows`), each circulating on its own slot pair with its
    own credits and its own blocks, in one launch of the chunked kernel;
    the result is bit for bit the unchunked one. ``chunks`` is clamped to
    the leading dimension and to :func:`max_chunks` of the world; ``None``
    asks the plan engine (:func:`_planned_ring_chunks`: a measured cache
    entry for this device kind, else one unchunked launch).
    """
    _check_stream(stream)
    op = SmiOp.parse(op)
    if chunks is not None:
        chunks = check_chunks(chunks)
    n = _ring_size(comm, axis_name)
    if n == 1 or x.numel() == 0:
        return x
    if chunks is None:
        chunks = _planned_ring_chunks(x, n)
    chunks = min(chunks, x.shape[0] if x.dim() else 1,
                 max_chunks(comm.world.size))
    if chunks > 1:
        xu = chunk_rows(x, chunks)
        out = _run(
            "ring_all_reduce_chunked", xu, comm, axis_name, stream,
            flow_control, (op, chunks), lambda xus: _all_reduce_rows(xus, op),
            tuple(xu.shape), xu[0].numel(), (OP_CODES[op],), chunks=chunks,
        )
        return unchunk_rows(out, x)
    return _run(
        "ring_all_reduce", x, comm, axis_name, stream, flow_control, (op,),
        lambda xs: ring_all_reduce_plain(xs, op), tuple(x.shape),
        x.numel(), (OP_CODES[op],),
    )


def ring_reduce_scatter(
    x: torch.Tensor,
    comm: Communicator,
    axis_name=None,
    op: Union[str, SmiOp] = SmiOp.ADD,
    flow_control: bool = True,
    stream: int = 0,
) -> torch.Tensor:
    """Reduce-scatter along a ring: rank ``r`` returns the reduction of
    every rank's ``r``-th leading block of ``x``, as
    ``lax.psum_scatter(..., tiled=True)`` for ADD with an explicit
    neighbour schedule. ``x.shape[0]`` must be divisible by the ring."""
    _check_stream(stream)
    op = SmiOp.parse(op)
    n = _ring_size(comm, axis_name)
    if x.dim() < 1 or x.shape[0] % n:
        raise ValueError(
            f"reduce-scatter leading dim "
            f"{x.shape[0] if x.dim() else '()'} not divisible by ring "
            f"size {n}"
        )
    if n == 1:
        return x
    out_shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    if x.numel() == 0:
        return x.new_empty(out_shape)
    return _run(
        "ring_reduce_scatter", x, comm, axis_name, stream, flow_control,
        (op,), lambda xs: ring_reduce_scatter_plain(xs, op), out_shape,
        x.numel() // n, (OP_CODES[op],),
    )
