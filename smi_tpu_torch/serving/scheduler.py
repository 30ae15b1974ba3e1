"""Stream scheduler and wire lanes: QoS order, fairness, deadlines.

The port's copy of :mod:`smi_tpu.serving.scheduler`, kept in step
with it line for line: the same requests give the same decisions.

The data plane of the serving front-end, modeled with the same credit
discipline the wire-level simulator proves safe
(:mod:`smi_tpu_torch.parallel.credits`):

- a :class:`WireLane` is one destination rank's inbound wire. It holds
  :data:`WIRE_CREDITS` chunk credits; sending a chunk takes one, and
  the credit returns only when the destination's consumer CONSUMES the
  chunk — not when it lands. A stalled (or dead) consumer therefore
  exhausts the lane within ``WIRE_CREDITS`` chunks and the lane stops
  accepting sends: backpressure, expressed exactly as the rendezvous
  credits express it on the NoC. Chunks land ``TRANSIT_TICKS`` after
  the send, in order (one lane is one FIFO wire).
- the :class:`StreamScheduler` picks which accepted stream sends next
  on each lane: strict class priority
  (:data:`~smi_tpu_torch.serving.qos.CLASS_PRIORITY`) with an **aging
  bound** — a ready stream passed over :data:`MAX_STARVE_ROUNDS`
  times is scheduled next regardless of class, so the interleaving
  gap of any stream behind higher-priority traffic is bounded (the
  serving analog of the CK loop's ``READS_LIMIT`` fairness, and of
  the bounded-gap property the tenant-fairness regression test pins
  on the credits simulator).
- every chunk send runs the stream's propagated
  :class:`~smi_tpu_torch.utils.watchdog.Deadline` check (tick clock,
  serving state dump attached via ``with_provider``): a stream that
  cannot make progress inside its budget surfaces as a named
  ``WatchdogTimeout`` carrying per-stream state — never a silent
  hang, never a silent drop.

Chunks move as verified-transport frames
(:class:`~smi_tpu_torch.parallel.credits.Frame`): CRC per chunk, dense
per-lane sequence numbers, checked at consumption. Damage is a named
``IntegrityError`` and the chunk replays from the front-end's WAL.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from smi_tpu_torch.parallel.credits import (
    Frame,
    IntegrityError,
    frame_crc,
    make_frame,
)
from smi_tpu_torch.serving.qos import CLASS_PRIORITY, Request

#: In-flight + landed-unconsumed chunk bound per destination lane —
#: the wire's credit window (the role of the ring kernels' slot pair).
WIRE_CREDITS = 4

#: Ticks between a chunk's send and its landing at the destination.
TRANSIT_TICKS = 1

#: Chunks a live destination consumes per tick (its service rate).
CONSUME_RATE = 2

#: Aging bound: scheduling decisions a ready stream may be passed
#: over before it is served regardless of class — the starvation
#: bound docs/robustness.md quotes.
MAX_STARVE_ROUNDS = 16


@dataclasses.dataclass
class StreamState:
    """One accepted stream in flight."""

    request: Request
    index: int                      # global stream number (frame src)
    dst: int                        # current destination rank
    deadline: object                # watchdog.Deadline on the tick clock
    wal: object                     # recovery.ProgressLog
    lane_epoch: int = 0             # bumps on failover -> fresh seq lane
    next_to_send: int = 0
    delivered: Dict[int, object] = dataclasses.field(
        default_factory=dict
    )
    skips: int = 0                  # aging counter
    replayed_chunks: int = 0
    sent_total: int = 0
    admitted_at: int = 0
    completed_at: Optional[int] = None

    @property
    def lane_key(self) -> Tuple[int, int]:
        """Sequence-lane identity: fresh per failover epoch, so a
        replay to an heir starts a dense lane of its own and a
        straggler frame from the old route can never alias it."""
        return (self.index, self.lane_epoch)

    @property
    def total_chunks(self) -> int:
        return len(self.request.chunks)

    @property
    def complete(self) -> bool:
        return len(self.delivered) == self.total_chunks


@dataclasses.dataclass
class _InFlight:
    ready_at: int
    stream: StreamState
    seq: int
    frame: Frame
    #: the stream's route incarnation when this chunk was sent — a
    #: mismatch with the stream's CURRENT lane_epoch at consumption
    #: marks the chunk as a pre-failover straggler
    lane_epoch: int = 0
    #: the membership epoch the send happened under (the value the
    #: consume-side stale gate validates against the current view)
    view_epoch: int = 0


class WireLane:
    """One destination rank's inbound wire under credit flow control."""

    def __init__(self, rank: int):
        self.rank = rank
        self.credits = WIRE_CREDITS
        self.in_flight: Deque[_InFlight] = deque()
        self.landed: Deque[_InFlight] = deque()
        #: receiver-side dense sequence expectation per lane_key
        self.next_seq: Dict[Tuple[int, int], int] = {}
        #: consumer stalled until this tick (SlowConsumer fault)
        self.stalled_until: int = 0
        #: membership epoch stamped onto sends (the front-end updates
        #: it every tick before scheduling)
        self.view_epoch: int = 0

    def can_send(self) -> bool:
        return self.credits > 0

    def send(self, stream: StreamState, seq: int, payload,
             now: int) -> None:
        assert self.credits > 0, "send without a wire credit"
        self.credits -= 1
        frame = make_frame(stream.index, seq, payload, wire=True)
        self.in_flight.append(
            _InFlight(now + TRANSIT_TICKS, stream, seq, frame,
                      lane_epoch=stream.lane_epoch,
                      view_epoch=self.view_epoch)
        )
        stream.sent_total += 1

    def land(self, now: int) -> None:
        while self.in_flight and self.in_flight[0].ready_at <= now:
            self.landed.append(self.in_flight.popleft())

    def drop_all(self) -> int:
        """The rank died: everything on or queued for this wire is
        lost (the front-end replays from the WAL)."""
        lost = len(self.in_flight) + len(self.landed)
        self.credits += lost
        self.in_flight.clear()
        self.landed.clear()
        return lost


class StreamScheduler:
    """Class-priority scheduling with a bounded starvation gap.

    ``max_starve_rounds`` defaults to the production
    :data:`MAX_STARVE_ROUNDS`; the control-plane model checker
    (:mod:`smi_tpu_torch.analysis.model`) instantiates the same class with a
    scope-scaled bound so the aging property is reachable inside a
    small exhaustive scope — the bound is structural in the ordering
    rule, not in the constant, so checking it at 3 proves the same
    mechanism that ships at 16.
    """

    def __init__(self, check_deadlines: bool = True,
                 max_starve_rounds: int = MAX_STARVE_ROUNDS):
        if max_starve_rounds < 1:
            raise ValueError(
                f"max_starve_rounds must be >= 1, got {max_starve_rounds}"
            )
        self.check_deadlines = check_deadlines
        self.max_starve_rounds = max_starve_rounds
        #: optional per-chunk observation hook,
        #: ``on_send(stream, seq, lane, now)`` — called after every
        #: issued send (the front-end wires its flight recorder /
        #: metrics here; None = zero overhead). Observation only: the
        #: scheduling decision is already made when it fires.
        self.on_send: Optional[Callable] = None

    def _order(self, eligible: List[StreamState]) -> List[StreamState]:
        """Starved streams first (aging bound), then strict class
        priority, then admission order — deterministic throughout."""
        return sorted(
            eligible,
            key=lambda s: (
                0 if s.skips >= self.max_starve_rounds else 1,
                CLASS_PRIORITY[s.request.qos],
                s.index,
            ),
        )

    def schedule_lane(
        self,
        lane: WireLane,
        streams: List[StreamState],
        now: int,
        state_provider: Optional[Callable] = None,
    ) -> int:
        """Issue sends on one lane until its credits or the ready work
        run out. Returns the number of chunks sent. Every send first
        runs the stream's propagated per-chunk deadline check."""
        sent = 0
        while lane.can_send():
            eligible = [
                s for s in streams
                if s.dst == lane.rank
                and s.next_to_send < s.total_chunks
            ]
            if not eligible:
                break
            ordered = self._order(eligible)
            chosen = ordered[0]
            for other in ordered[1:]:
                other.skips += 1
            chosen.skips = 0
            if self.check_deadlines:
                deadline = chosen.deadline
                if state_provider is not None:
                    deadline = deadline.with_provider(state_provider)
                deadline.check(
                    f"chunk {chosen.next_to_send}/"
                    f"{chosen.total_chunks} of stream "
                    f"{chosen.request.stream_id} "
                    f"({chosen.request.qos}) to rank {lane.rank}"
                )
            seq = chosen.next_to_send
            lane.send(
                chosen, seq, chosen.request.chunks[seq], now
            )
            chosen.next_to_send += 1
            sent += 1
            if self.on_send is not None:
                self.on_send(chosen, seq, lane, now)
        return sent


def verify_chunk(lane: WireLane, item: _InFlight,
                 recorder=None) -> object:
    """Receiver-side verdict on one landed chunk: CRC, then dense
    per-lane sequence — the :func:`credits.verified_steps` discipline
    at the serving tier. Returns the payload; raises
    :class:`~smi_tpu_torch.parallel.credits.IntegrityError` naming the miss
    — carrying the ``recorder``'s bounded event tail
    (``recorder_tail``) when one is wired, so a wire-damage detection
    names the serving history that led to it.
    """
    frame = item.frame
    error = None
    want = frame_crc(frame.src, frame.seq, frame.wire, frame.payload)
    if want != frame.crc:
        error = IntegrityError(
            f"rank {lane.rank}: checksum mismatch on chunk "
            f"seq={frame.seq} of stream {item.stream.request.stream_id}"
            f": frame declares crc={frame.crc:#010x} but payload "
            f"hashes to {want:#010x}",
            rank=lane.rank, src=frame.src, seq=frame.seq,
            expected=frame.crc, got=want, kind="checksum",
        )
    else:
        key = item.stream.lane_key
        expected = lane.next_seq.get(key, 0)
        if frame.seq != expected:
            error = IntegrityError(
                f"rank {lane.rank}: out-of-sequence chunk of stream "
                f"{item.stream.request.stream_id}: expected "
                f"seq={expected}, got seq={frame.seq}",
                rank=lane.rank, src=frame.src, seq=frame.seq,
                expected=expected, got=frame.seq, kind="sequence",
            )
    if error is not None:
        if recorder is not None:
            from smi_tpu_torch.obs.events import attach_tail

            attach_tail(error, recorder)
        raise error
    lane.next_seq[item.stream.lane_key] = frame.seq + 1
    return frame.payload
