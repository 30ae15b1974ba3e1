"""Transient point-to-point streaming channels (Push/Pop).

PyTorch counterpart of :mod:`smi_tpu.parallel.channels`. A reference
channel is opened per message with ``SMI_Open_{send,receive}_channel``;
``SMI_Push``/``SMI_Pop`` then move one element per call, with a
credit-based rendezvous bounding in-flight packets. As in the JAX
package, the two endpoint loops are one SPMD call that every rank makes:

- opening a channel is metadata only (:class:`P2PChannel`);
- ``transfer()`` moves the message from ``src`` to ``dst``: at ``dst`` it
  returns the message, at every other rank zeros;
- ``stream()`` moves it in chunks of the channel's buffer size (the
  "asynchronicity degree") and applies a consumer per chunk;
  ``consecutive_reads`` (the reference's ``READS_LIMIT``) bounds how many
  chunks move per step before the stream yields;
- ``backend="ring"`` moves the message over the credit-flow-controlled
  neighbour-stream kernel (:mod:`smi_tpu_torch.kernels.ring`), hop by hop
  through intermediate ranks the shorter way round, each hop one launch
  in the port's flag domain; the consumer then runs per chunk.

:func:`ring_shift` is the rank-pipeline move, differentiable as
``ppermute`` is in JAX. :func:`stream_concurrent` moves several
channels' messages in lockstep bursts on either tier.

The verified transport (``transfer_verified``, ``stream_verified``,
``verify_frames``) moves a vector of per-chunk checksums beside the
payload, over the payload's own tier, and turns a chunk that arrived
damaged into a named :class:`~smi_tpu_torch.parallel.errors.
IntegrityError`. Tenant ports (:func:`tenant_stream_port`,
:func:`open_tenant_channel`) derive a transient channel's port from a
tenant's stream identity.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import (Callable, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from smi_tpu_torch.ops.operations import Reduce, pipeline_depth_packets
from smi_tpu_torch.ops.types import (
    SmiDtype,
    SmiOp,
    dtype_to_torch,
    elements_per_packet,
)
from smi_tpu_torch.parallel.backend import (
    check_backend,
    combine_fn,
    identity_for,
    reduction_fn,
)
from smi_tpu_torch.parallel.errors import IntegrityError
from smi_tpu_torch.parallel.mesh import Communicator
from smi_tpu_torch.utils.watchdog import Deadline


class FrameCheck(NamedTuple):
    """What a verified transfer hands the host for its verdict:
    ``expected``, the per-chunk checksums computed at ``src`` and moved
    to ``dst`` over the payload's tier; ``got``, the checksums of the
    delivered message; ``at_dst``, 1 at the rank where the comparison
    means something (the others hold zeros).
    :meth:`P2PChannel.verify_frames` turns a mismatch into a named
    :class:`~smi_tpu_torch.parallel.errors.IntegrityError`."""

    expected: torch.Tensor
    got: torch.Tensor
    at_dst: torch.Tensor


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2**32 into int32's range (two's
    complement wraparound)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class P2PChannel:
    """Descriptor of one transient P2P message channel.

    Mirrors ``SMI_Channel``: message element count, the two endpoint
    ranks (flattened, row-major), the logical port, and the pipelining
    depth.
    """

    comm: Communicator
    port: int
    src: int
    dst: int
    count: int
    dtype: SmiDtype = SmiDtype.FLOAT
    buffer_size: Optional[int] = None  # elements; None = default depth
    rendezvous: bool = True
    #: Chunk-burst bound per pipelining step (reference ``READS_LIMIT``):
    #: a streamed transfer moves at most this many chunks per step
    #: before yielding the stream.
    consecutive_reads: int = 8

    def __post_init__(self):
        object.__setattr__(self, "dtype", SmiDtype.parse(self.dtype))
        size = self.comm.size
        for name, r in (("src", self.src), ("dst", self.dst)):
            if not (0 <= r < size):
                raise ValueError(f"{name}={r} out of range for comm size {size}")
        if self.src == self.dst:
            raise ValueError("src and dst must differ for a P2P channel")
        if self.count <= 0:
            raise ValueError(f"message count must be positive, got {self.count}")
        if self.consecutive_reads < 1:
            raise ValueError(
                f"consecutive_reads must be >= 1, got {self.consecutive_reads}"
            )

    @property
    def torch_dtype(self) -> torch.dtype:
        return dtype_to_torch(self.dtype)

    @property
    def chunk_elements(self) -> int:
        """Elements per in-flight chunk: buffer_size elements → whole
        packets (rounded as the reference rounds) → elements. Never below
        one packet."""
        packets = pipeline_depth_packets(self.buffer_size, self.dtype)
        return packets * elements_per_packet(self.dtype)

    def _ring_stream(self) -> int:
        """Flag domain of this channel's port: distinct ports never share
        one, up to the tier's domain count."""
        from smi_tpu_torch.kernels.ring import RING_STREAMS

        return self.port % RING_STREAMS

    def _data(self, data) -> torch.Tensor:
        data = torch.as_tensor(data, device=self.comm.device)
        data = data.to(self.torch_dtype)
        if data.dim() < 1 or data.shape[0] != self.count:
            raise ValueError(
                f"message length "
                f"{data.shape[0] if data.dim() else '()'} != channel "
                f"count {self.count}"
            )
        return data

    def _hops(self) -> Tuple[int, int]:
        """(direction, hop count) of the shorter way around the ring."""
        n = self.comm.size
        right = (self.dst - self.src) % n
        left = (self.src - self.dst) % n
        return (1, right) if right <= left else (-1, left)

    def burst_schedule(self) -> List[int]:
        """Element counts moved per pipelining step under rendezvous:
        steps of ``consecutive_reads`` whole chunks, then leftover single
        chunks, then the element tail."""
        chunk = min(self.chunk_elements, self.count)
        burst = self.consecutive_reads * chunk
        n_bursts = self.count // burst
        schedule = [burst] * n_bursts
        remaining = self.count - n_bursts * burst
        schedule += [chunk] * (remaining // chunk)
        tail = remaining % chunk
        if tail:
            schedule.append(tail)
        return schedule

    def _ring_payload(self, data: torch.Tensor, chunked: bool) -> torch.Tensor:
        """Masked, zero-padded, ``(n_chunks, chunk, ...)``-shaped payload
        for the ring tier (one row = one in-flight unit)."""
        masked = (data if self.comm.rank == self.src
                  else torch.zeros_like(data))
        if not chunked:
            return masked[None]
        chunk = min(self.chunk_elements, self.count)
        n_chunks = -(-self.count // chunk)
        pad = n_chunks * chunk - self.count
        if pad:
            masked = torch.cat(
                [masked, masked.new_zeros((pad,) + tuple(masked.shape[1:]))]
            )
        return masked.reshape((n_chunks, chunk) + tuple(data.shape[1:]))

    def _deadline(self, deadline: Optional[Deadline],
                  what: str) -> Optional[Deadline]:
        """Attach this channel's protocol mirror to a caller deadline, so
        a timeout dumps the per-rank state of the matching protocol
        (``what`` is a ``faults.FAMILY_PROTOCOL`` key: "transfer" and
        "stream" both mirror the neighbour-stream machine)."""
        if deadline is None:
            return None
        from smi_tpu_torch.parallel.faults import mirror_state_provider

        return deadline.with_provider(
            mirror_state_provider(what, self.comm.size, structured=True)
        )

    def _ring_move(self, chunked_payload: torch.Tensor,
                   deadline: Optional[Deadline] = None) -> torch.Tensor:
        """Drive a ``(rows, ...)`` payload hop by hop to ``dst`` over the
        neighbour-stream kernel (the shorter way around the ring), in
        this channel's flag domain: one launch per hop, the deadline
        checked before each."""
        from smi_tpu_torch.kernels import ring as _ring

        direction, hops = self._hops()
        out = chunked_payload
        for hop in range(hops):
            if deadline is not None:
                deadline.check(
                    f"ring hop {hop + 1}/{hops} of port-{self.port} "
                    f"channel {self.src}->{self.dst}"
                )
            out = _ring.neighbour_stream(
                out, self.comm, direction=direction,
                stream=self._ring_stream(),
            )
        return out

    def _ring_transfer(self, data: torch.Tensor, chunked: bool,
                       deadline: Optional[Deadline] = None) -> torch.Tensor:
        """Move the masked message hop by hop. Intermediate ranks forward
        zeros of their own, so only ``dst`` ends up with the payload."""
        out = self._ring_move(self._ring_payload(data, chunked), deadline)
        return out.reshape((-1,) + tuple(data.shape[1:]))[: self.count]

    def _permute(self, data: torch.Tensor) -> torch.Tensor:
        return self.comm.permute(data, [(self.src, self.dst)])

    def transfer(self, data, backend: str = "xla",
                 deadline: Optional[Deadline] = None) -> torch.Tensor:
        """Fused Push+Pop: send ``data`` (valid at ``src``) to ``dst``.

        Every rank calls this at the same program point; returns the
        message at ``dst`` and zeros elsewhere. ``backend="ring"`` sends
        over the neighbour-stream kernel instead of the transport's
        point-to-point move. ``deadline`` bounds the host-side dispatch.
        """
        data = self._data(data)
        deadline = self._deadline(deadline, "transfer")
        if deadline is not None:
            deadline.check(f"transfer on port-{self.port} channel")
        if check_backend(backend) == "ring":
            return self._ring_transfer(data, chunked=False,
                                       deadline=deadline)
        return self._permute(data)

    def stream(self, data, consumer: Optional[Callable] = None,
               init_carry=None, backend: str = "xla",
               deadline: Optional[Deadline] = None):
        """Streamed transfer: move the message chunk by chunk.

        With no ``consumer`` this behaves like :meth:`transfer` but
        bounds in-flight data to a burst of chunks. With a
        ``consumer(carry, chunk) -> carry``, the consumer is applied to
        each received chunk in order. Each step moves up to
        ``consecutive_reads`` chunks (:meth:`burst_schedule`); the
        consumer still sees individual chunks. Without ``rendezvous``
        (eager) the whole message moves at once and the consumer sees it
        whole. ``backend="ring"`` moves all chunks through the
        neighbour-stream kernel, two in flight under its credits, and
        then applies the consumer per chunk.

        Returns ``(received, carry)``; ``received`` is the reassembled
        message (valid at ``dst``).
        """
        data = self._data(data)
        check_backend(backend)
        deadline = self._deadline(deadline, "stream")
        if deadline is not None:
            deadline.check(f"stream on port-{self.port} channel")
        if not self.rendezvous:
            out = self.transfer(data, backend=backend, deadline=deadline)
            carry = init_carry if consumer is None else consumer(init_carry,
                                                                 out)
            return out, carry

        chunk = min(self.chunk_elements, self.count)

        def consume_chunks(carry, received):
            """Apply the consumer chunk-wise to received rows."""
            if consumer is None:
                return carry
            rows = received.shape[0]
            for i in range(rows // chunk):
                carry = consumer(carry, received[i * chunk:(i + 1) * chunk])
            if rows % chunk:
                carry = consumer(carry, received[rows - rows % chunk:])
            return carry

        if backend == "ring":
            received = self._ring_transfer(data, chunked=True,
                                           deadline=deadline)
            return received, consume_chunks(init_carry, received)

        carry, parts, used = init_carry, [], 0
        for step, size in enumerate(self.burst_schedule()):
            if deadline is not None and step:
                deadline.check(f"stream step on port-{self.port} channel")
            got = self._permute(data[used:used + size])
            carry = consume_chunks(carry, got)
            parts.append(got)
            used += size
        received = parts[0] if len(parts) == 1 else torch.cat(parts)
        return received, carry

    # ------------------------------------------------------------------
    # Verified transport: per-chunk sequence-keyed checksums
    # ------------------------------------------------------------------

    def chunk_checksums(self, data) -> torch.Tensor:
        """Per-chunk int32 checksums of a message.

        Chunk ``k``'s payload words (the dtype's raw bits, sign-extended
        to int32) are summed with int32 wraparound under odd
        pseudo-random position weights (``i * 2654435761 | 1``). An odd
        weight makes every single-bit flip visible, a truncated landing
        changes the sum, and the position dependence catches swapped or
        reordered chunks. The same at both endpoints, so the comparison
        in :meth:`verify_frames` is exact. The arithmetic runs in int64
        and is reduced mod 2**32, which is int32 wraparound without
        relying on overflow.
        """
        x = torch.as_tensor(data, device=self.comm.device).to(
            self.torch_dtype)
        chunk = min(self.chunk_elements, self.count)
        n_chunks = -(-self.count // chunk)
        pad = n_chunks * chunk - self.count
        x = x[: self.count]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        if x.dtype.is_floating_point:
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
            x = x.view(bits[x.element_size()])
        words = x.to(torch.int64).reshape(n_chunks, -1)
        # Knuth's 32-bit golden-ratio multiplier; | 1 keeps every weight
        # odd
        index = torch.arange(words.shape[1], dtype=torch.int64,
                             device=words.device)
        weights = _wrap_int32(index * -1640531527).to(torch.int64) | 1
        terms = (_wrap_int32(words).to(torch.int64) * weights) & 0xFFFFFFFF
        return _wrap_int32(terms.sum(dim=1))

    def _move_checksums(self, sums: torch.Tensor,
                        backend: str) -> torch.Tensor:
        """The src's checksum vector delivered to dst over the payload's
        tier (zeros elsewhere): the frame header riding its own
        message."""
        masked = sums if self.comm.rank == self.src else torch.zeros_like(
            sums)
        if backend == "ring":
            return self._ring_move(masked[None])[0]
        return self._permute(masked)

    def _frame_check(self, data: torch.Tensor, received: torch.Tensor,
                     backend: str) -> FrameCheck:
        return FrameCheck(
            expected=self._move_checksums(self.chunk_checksums(data),
                                          backend),
            got=self.chunk_checksums(received),
            at_dst=torch.tensor(int(self.comm.rank == self.dst),
                                dtype=torch.int32),
        )

    def transfer_verified(self, data, backend: str = "xla",
                          deadline: Optional[Deadline] = None
                          ) -> Tuple[torch.Tensor, FrameCheck]:
        """:meth:`transfer` plus end-to-end integrity evidence: returns
        ``(received, check)``; :meth:`verify_frames` on the check raises
        a named :class:`~smi_tpu_torch.parallel.errors.IntegrityError`
        for a corrupted, truncated or reordered chunk."""
        data = self._data(data)
        received = self.transfer(data, backend=backend, deadline=deadline)
        return received, self._frame_check(data, received, backend)

    def stream_verified(self, data, consumer: Optional[Callable] = None,
                        init_carry=None, backend: str = "xla",
                        deadline: Optional[Deadline] = None):
        """:meth:`stream` plus end-to-end integrity evidence: returns
        ``(received, carry, check)``. The checksums follow the chunking
        the stream moves, so the check names the in-flight unit that was
        damaged."""
        data = self._data(data)
        received, carry = self.stream(
            data, consumer=consumer, init_carry=init_carry,
            backend=backend, deadline=deadline,
        )
        return received, carry, self._frame_check(data, received, backend)

    def verify_frames(self, check: FrameCheck, context: str = "") -> None:
        """Raise on the first chunk whose delivered checksum differs from
        the one computed at the source. A no-op at ranks other than
        ``dst``, whose buffers are zeros by contract."""
        def host(v):
            return (v.detach().cpu().numpy() if torch.is_tensor(v)
                    else np.asarray(v))

        if not bool(np.any(host(check.at_dst))):
            return
        expected = host(check.expected)
        got = host(check.got)
        bad = np.nonzero(expected != got)[0]
        if bad.size == 0:
            return
        k = int(bad[0])
        where = f" during {context}" if context else ""
        raise IntegrityError(
            f"verified transfer on port-{self.port} channel "
            f"{self.src}->{self.dst}{where}: chunk {k} (of "
            f"{expected.size}) arrived corrupted: checksum expected "
            f"{int(expected[k]):#010x}, got {int(got[k]):#010x}"
            + (f"; {bad.size - 1} further chunk(s) also damaged"
               if bad.size > 1 else ""),
            rank=self.dst, src=self.src, seq=k,
            expected=int(expected[k]), got=int(got[k]),
            kind="checksum",
        )

    def stream_reduce(self, data, op: Union[str, SmiOp] = SmiOp.ADD,
                      lanes: Optional[int] = None, backend: str = "xla",
                      deadline: Optional[Deadline] = None):
        """Streamed reduction: pop each arriving chunk and fold it into
        ``lanes`` independent partial accumulators, combined at the end
        (chunk *k* folds into partial ``k % lanes`` — the reference's
        shift register of partial sums). The default comes from the op
        model (:attr:`Reduce.accumulation_lanes`).

        Returns ``(received, total)``: the reassembled message and the
        reduction over all its elements (both valid at ``dst``; the
        reduction of the zero buffer elsewhere).
        """
        op = SmiOp.parse(op)
        if lanes is None:
            lanes = Reduce(self.port, self.dtype).accumulation_lanes
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        data = self._data(data)
        combine = combine_fn(op)
        chunk_reduce = reduction_fn(op)
        partials0 = torch.full(
            (lanes,) + tuple(data.shape[1:]),
            identity_for(op, data.dtype), dtype=data.dtype,
            device=data.device)

        def consumer(carry, chunk_data):
            partials, i = carry
            partials = partials.clone()
            partials[i % lanes] = combine(partials[i % lanes],
                                          chunk_reduce(chunk_data, axis=0))
            return partials, i + 1

        received, (partials, _) = self.stream(
            data, consumer=consumer, init_carry=(partials0, 0),
            backend=backend, deadline=deadline,
        )
        return received, chunk_reduce(partials, axis=0)


#: Port space of transient per-tenant stream channels: their ports are
#: derived, never hand-assigned, and fold onto the ring tier's flag
#: domains (:meth:`P2PChannel._ring_stream`) as static ports do.
TENANT_PORT_SPACE = 1 << 16


def tenant_stream_port(tenant: str, stream_seq: int) -> int:
    """The transient port of one tenant stream: the (tenant, sequence)
    identity hashed into the port space, stable across processes, so
    every rank derives the same port without coordination."""
    if stream_seq < 0:
        raise ValueError(f"stream_seq must be >= 0, got {stream_seq}")
    return zlib.crc32(
        f"tenant-stream:{tenant}:{stream_seq}".encode()
    ) % TENANT_PORT_SPACE


def open_tenant_channel(comm: Communicator, tenant: str, stream_seq: int,
                        src: int, dst: int, count: int,
                        dtype: SmiDtype = SmiDtype.FLOAT,
                        **kwargs) -> P2PChannel:
    """A transient per-tenant P2P channel, metadata only, its port
    derived from the tenant stream (:func:`tenant_stream_port`), so
    concurrent tenants land on distinct ring flag domains (up to the
    tier's domain count) and a tenant's consecutive streams rotate
    domains. The other :class:`P2PChannel` knobs pass through."""
    return P2PChannel(
        comm, port=tenant_stream_port(tenant, stream_seq),
        src=src, dst=dst, count=count, dtype=dtype, **kwargs,
    )


def stream_concurrent(channels: Sequence[P2PChannel], datas,
                      backend: str = "xla") -> Tuple[torch.Tensor, ...]:
    """Move several P2P messages chunk by chunk *in lockstep*.

    The counterpart of the reference's concurrent channels sharing the
    NoC (``bandwidth_0.cl``'s two app kernels pushing at once): every step
    advances each channel by one burst of ``consecutive_reads`` chunks
    (``READS_LIMIT``, the CK loop's fairness bound between sources,
    ``cks.cl:73-81``) before any channel takes its next, then the element
    tail. On the ``"xla"`` tier a burst is one point-to-point move of the
    transport; ``backend="ring"`` interleaves the channels' bursts over
    the neighbour-stream kernel, each channel in the flag domain of its
    own port (:meth:`P2PChannel._ring_stream`).

    All channels must agree on message count, chunk size and burst width
    (the benchmark shape). Returns the received message per channel.
    """
    if len(channels) != len(datas):
        raise ValueError("one data array per channel required")
    if not channels:
        return ()
    counts = {ch.count for ch in channels}
    chunks = {min(ch.chunk_elements, ch.count) for ch in channels}
    reads = {ch.consecutive_reads for ch in channels}
    if len(counts) != 1 or len(chunks) != 1 or len(reads) != 1:
        raise ValueError(
            "concurrent streaming requires equal message/chunk/burst "
            f"sizes; got counts {sorted(counts)}, chunks {sorted(chunks)}, "
            f"consecutive_reads {sorted(reads)}"
        )
    datas = [ch._data(d) for ch, d in zip(channels, datas)]
    count, chunk, reads = counts.pop(), chunks.pop(), reads.pop()
    parts = [[] for _ in channels]
    if check_backend(backend) == "ring":
        per = [ch._ring_payload(d, chunked=True)
               for ch, d in zip(channels, datas)]
        for b0 in range(0, per[0].shape[0], reads):
            for i, ch in enumerate(channels):
                parts[i].append(ch._ring_move(per[i][b0:b0 + reads]))
        return tuple(
            torch.cat(p).reshape((-1,) + tuple(d.shape[1:]))[:count]
            for p, d in zip(parts, datas))
    burst = chunk * reads
    bounds = [(b, b + burst) for b in range(0, count - count % burst, burst)]
    if count % burst:
        bounds.append((count - count % burst, count))
    for lo, hi in bounds:
        for i, (ch, d) in enumerate(zip(channels, datas)):
            parts[i].append(ch._permute(d[lo:hi]))
    return tuple(p[0] if len(p) == 1 else torch.cat(p) for p in parts)


def _shift(x, comm, name, step):
    return comm.exchange_start([(x, name, step)], ring=True).wait()[0]


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
    ``backend="ring"`` makes the same move over the neighbour-stream
    kernel, one hop per offset step (a zero-size payload moves nothing
    on either tier); that path carries no gradient."""
    name = axis_name or comm.axis_names[0]
    n = comm.shape[comm._axis(name)]
    if check_backend(backend) == "ring" and x.numel():
        from smi_tpu_torch.kernels import ring as _ring

        _ring.require_world(comm)
        direction = 1 if offset >= 0 else -1
        out = x[None]
        for _ in range(abs(offset) % n):
            out = _ring.neighbour_stream(out, comm, name,
                                         direction=direction)
        return out[0]
    step = offset % n
    if step == 0:
        return x
    return _RingShift.apply(x, comm, name, step)
