"""Fault injection for the credit protocol: plans, verdicts, mirrors.

PyTorch counterpart of :mod:`smi_tpu.parallel.faults`, kept in step with
it line for line (pure Python: the same plan and seed give the same
verdict, state dump and error text in both packages). The ``smi-tpu
chaos`` subcommands named below are the JAX package's CLI.

Reference gap this fills: the SMI emulator validates the NoC only under
*healthy* schedules — strict channel depths make races reproduce
(``CMakeLists.txt:188-191``) but nothing in the reference ever drops a
credit, stalls a rank, or cuts a link. Production collective stacks
treat those as table stakes (ULFM-style shrinking communicators in MPI,
datacenter fabrics routing around failed links), so the executable
protocol spec (:mod:`smi_tpu_torch.parallel.credits`) is extended here with a deterministic, seedable :class:`FaultPlan` and a verdict
harness over all four ring protocols.

Fault classes (the matrix ``tests/test_faults.py`` sweeps):

- **dropped credit grant** — a slot re-grant is lost; the upstream
  writer waits forever → detected as :class:`~credits.DeadlockError`
  with a per-rank state dump.
- **duplicated credit grant** — a surplus credit lets the writer RDMA
  into a slot the receiver may still be consuming → detected as
  :class:`~credits.ClobberError`, or (when the schedule dodges the
  race) as the surplus count at exit, :class:`~credits.CreditLeakError`.
- **delayed DMA completion** — a copy is slow but not lost →
  **tolerated**: the credit protocol is correct under arbitrary landing
  order, delivery stays intact.
- **stalled rank** — crash-stop after N actions; neighbours block on
  its barrier/credits → detected as a deadlock whose dump names the
  stalled rank.
- **down link** — all traffic between two ranks is lost (signals and
  DMAs, both directions) → detected as a deadlock at the first
  wait that needed the dead wire.
- **bit-flipped payload / truncated DMA** — a chunk is damaged in
  flight with the protocol machinery none the wiser → detected by the
  verified-transport framing (:func:`credits.verified_steps`) as
  :class:`~credits.IntegrityError` (checksum mismatch naming rank,
  chunk, expected vs got); on BARE transport the same injection is
  silent corruption, which is the framing's existence proof.
- **reordered chunks** — two consecutive frames from one source swap
  positions on the wire → detected as
  :class:`~credits.IntegrityError` (sequence mismatch). Reordering is
  a framing-level concept (bare payloads carry no sequence number).

The invariant the harness enforces for every cell: the run either
completes with verified delivery (**tolerated**) or raises a *named*
invariant violation carrying enough state to debug it (**detected**) —
never silent corruption. A wrong-output completion is re-raised as
:class:`SilentCorruption` so no test can accidentally bless it.

:func:`mirror_stall_dump` is the runtime watchdogs' "state-machine
mirror": for a hung device collective it reports where each rank of the
matching protocol stands when no remote traffic completes — the
protocol-level picture a timeout error should carry.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, FrozenSet, Optional, Tuple

from smi_tpu_torch.parallel import credits as C

#: The four ring protocols the plan can execute, keyed as the fault
#: matrix names them. Re-exported from the consolidated registry
#: (:func:`credits.all_protocol_registries` — the ONE source of truth
#: every analysis tier enumerates); this module keeps its historical
#: names so the seed-pinned chaos campaign's draw set stays the same
#: object, digest-tested in tests/test_alltoall.py.
PROTOCOLS = C.PROTOCOLS

#: Pipelined variants runnable through :func:`run_under_faults` but NOT
#: part of the default chaos sweep (the seed-pinned campaign counts the
#: four base protocols): ``all_reduce_chunked`` is the chunked
#: double-buffered schedule of ``kernels/ring.py`` — ``chunks`` pipeline
#: rows interleaving per ring step on their own slot pairs.
CHUNKED_PROTOCOLS = C.CHUNKED_PROTOCOLS

#: Fault classes the matrix is exhaustive over. The last three damage
#: payloads *in flight* — faults the credit protocol cannot see at all;
#: only the verified-transport framing (``credits.verified_steps``)
#: turns them into named IntegrityErrors instead of silent corruption.
FAULT_CLASSES = ("dropped_grant", "duplicated_grant", "delayed_dma",
                 "stalled_rank", "down_link", "bit_flip_payload",
                 "reordered_chunks", "truncated_dma")

#: The wire-integrity subset of :data:`FAULT_CLASSES`.
INTEGRITY_FAULT_CLASSES = ("bit_flip_payload", "reordered_chunks",
                           "truncated_dma")

#: Elastic (job-level) fault classes, deliberately NOT in
#: :data:`FAULT_CLASSES`: the seed-pinned base chaos campaign draws
#: from that tuple, so extending it would silently re-roll every
#: pinned cell (the same discipline that keeps CHUNKED_PROTOCOLS out
#: of the base sweep). These classes drive the membership layer
#: (:mod:`smi_tpu_torch.parallel.membership`) across *iterations of a
#: job*, not actions of one collective — ``smi-tpu chaos --elastic`` sweeps
#: them.
ELASTIC_FAULT_CLASSES = ("flapping_rank", "stalled_heartbeat")

#: The two-tier pod protocol runnable through :func:`run_under_faults`
#: but NOT in the seed-pinned base sweep (same discipline as
#: :data:`CHUNKED_PROTOCOLS`): ``allreduce_pod`` is the hierarchical
#: rs(ICI) -> ring(DCN) -> ag(ICI) composition of
#: :func:`credits.allreduce_pod_rank`.
POD_PROTOCOLS = C.POD_PROTOCOLS

#: The all-to-all family (pairwise exchange / Bruck log-step /
#: two-tier pod), runnable through :func:`run_under_faults` but NOT in
#: the seed-pinned base sweep — same discipline as every
#: post-seed registry. The Bruck variant refuses non-power-of-two
#: rank counts loudly.
ALLTOALL_PROTOCOLS = C.ALLTOALL_PROTOCOLS

#: The compressed-wire allreduce family (r19: quantized pod
#: composition + top-k sparse gather), runnable through
#: :func:`run_under_faults` but NOT in the seed-pinned base sweep —
#: same discipline as every post-seed registry. Quantization changes
#: the VALUES by contract, never the framing: a bit flip on a
#: quantized or sparse frame is still a named IntegrityError, and bare
#: transport is still proven SilentCorruption.
QUANTIZED_PROTOCOLS = C.QUANTIZED_PROTOCOLS

#: Serving-level fault classes, deliberately NOT in
#: :data:`FAULT_CLASSES` (same seed-pinning rule as
#: :data:`ELASTIC_FAULT_CLASSES`). They drive the multi-tenant
#: front-end (:mod:`smi_tpu_torch.serving`) across ticks of a serving loop,
#: not actions of one collective: a ``SlowConsumer`` is the
#: *saturated-not-dead* regime — the destination keeps heartbeating
#: while its consumer stalls, so wire credits exhaust and the stall
#: must surface as named admission-edge shedding, never as a
#: membership transition. ``smi-tpu chaos --load`` sweeps them.
SERVING_FAULT_CLASSES = ("slow_consumer",)

#: DCN-tier fault classes, deliberately NOT in :data:`FAULT_CLASSES`
#: (the seed-pinned base chaos campaign would re-roll; same rule as
#: :data:`ELASTIC_FAULT_CLASSES`). They target the pod's slow wire
#: tier specifically: a down DCN link severs two *slices* (every
#: cross-slice wire between them, both directions), a DCN delay is
#: the slow-but-never-lost hold the inter-slice fabric actually
#: exhibits. ``tests/test_multislice.py`` sweeps them against the pod
#: protocol; verified-transport framing composes unchanged (a
#: payload tampered on a DCN wire is the same named IntegrityError
#: an ICI tamper is).
DCN_FAULT_CLASSES = ("dcn_link_down", "dcn_delay")

#: Partition fault classes, deliberately NOT in :data:`FAULT_CLASSES`
#: (same seed-pinning rule as every post-seed registry). Unlike every
#: class above, these are *windowed and directional*: a link is cut
#: for a tick interval and then HEALS, possibly in one direction only
#: (A hears B while B stops hearing A — the asymmetric regime that
#: makes heartbeat evidence diverge between the two sides), or flaps
#: on a seeded duty cycle. Both sides stay alive throughout, which is
#: exactly what crash-stop faults (:class:`StalledRank`,
#: :class:`DownLink`) can never model — each side can declare the
#: other dead and keep actuating, the split-brain hazard quorum
#: fencing (:mod:`smi_tpu_torch.parallel.membership`) exists to close.
#: Consulted by the simulator through the tick-aware
#: ``link_blocked(src, dst, tick)`` hook; ``smi-tpu chaos
#: --partition`` sweeps them.
PARTITION_FAULT_CLASSES = ("partition", "asymmetric_link",
                           "flapping_link")

#: Named invariant violations that count as *detection*. A bare
#: ProtocolError (wrong delivery) is NOT in this set — that is silent
#: corruption and fails the matrix.
DETECTED_ERRORS = (C.ClobberError, C.DeadlockError, C.CreditLeakError,
                   C.IntegrityError)


class SilentCorruption(AssertionError):
    """A faulted run completed but delivered wrong data — the one
    outcome the fault matrix forbids (on hardware it would be
    invisible)."""


@dataclasses.dataclass(frozen=True)
class DroppedGrant:
    """Lose the ``nth`` credit grant signalled by ``rank``."""

    rank: int
    nth: int = 0


@dataclasses.dataclass(frozen=True)
class DuplicatedGrant:
    """Deliver the ``nth`` credit grant signalled by ``rank`` twice."""

    rank: int
    nth: int = 0


@dataclasses.dataclass(frozen=True)
class DelayedDma:
    """Hold the ``nth`` DMA started by ``src`` for ``hold`` scheduler
    events (slow, never lost: it lands once nothing else can run)."""

    src: int
    nth: int = 0
    hold: int = 64


@dataclasses.dataclass(frozen=True)
class StalledRank:
    """Crash-stop ``rank`` after ``after`` executed actions."""

    rank: int
    after: int = 0


@dataclasses.dataclass(frozen=True)
class DownLink:
    """All traffic between ranks ``a`` and ``b`` is lost, both ways."""

    a: int
    b: int


@dataclasses.dataclass(frozen=True)
class BitFlipPayload:
    """Corrupt the payload of the ``nth`` DMA started by ``src`` in
    flight (checksum stays the sender's) — the framing must catch it
    as an ``IntegrityError(kind="checksum")``."""

    src: int
    nth: int = 0


@dataclasses.dataclass(frozen=True)
class ReorderedChunks:
    """Swap the wire sequence numbers of the ``nth`` and ``nth+1``
    frames sent by ``src`` (CRCs recomputed, payloads intact) — a pure
    reordering signature the framing must catch as an
    ``IntegrityError(kind="sequence")``. With only ``nth`` in flight
    (last chunk) it degrades to a lone sequence skip, still detected."""

    src: int
    nth: int = 0


@dataclasses.dataclass(frozen=True)
class TruncatedDma:
    """Truncate the payload of the ``nth`` DMA started by ``src``
    (partial landing; checksum stays the full payload's) — caught as
    an ``IntegrityError(kind="checksum")``."""

    src: int
    nth: int = 0


@dataclasses.dataclass(frozen=True)
class DcnLinkDown:
    """The DCN path between ``slice_a`` and ``slice_b`` of a
    ``per_slice``-wide pod is severed: every cross-slice signal and
    DMA between ranks of the two slices is lost, both directions —
    the inter-slice analog of :class:`DownLink`, at slice granularity
    because DCN connectivity is per slice pair (one host fabric
    route), not per rank pair. In-slice ICI traffic is untouched.
    Detected as a :class:`~credits.DeadlockError` at the first pod
    phase-B wait that needed the dead route.
    """

    slice_a: int
    slice_b: int
    per_slice: int = 2

    def __post_init__(self):
        if self.slice_a == self.slice_b:
            raise ValueError(
                f"a DCN link connects two DISTINCT slices, got "
                f"{self.slice_a} twice (in-slice wires are ICI — use "
                f"DownLink)"
            )
        if self.per_slice < 1:
            raise ValueError(f"per_slice must be >= 1, got {self.per_slice}")

    def severs(self, a: int, b: int) -> bool:
        slice_of = C.pod_slice_of(self.per_slice)
        return {slice_of(a), slice_of(b)} == {self.slice_a, self.slice_b}


@dataclasses.dataclass(frozen=True)
class DcnDelay:
    """Hold the ``nth`` DMA started by ``src`` for ``hold`` scheduler
    events — but only when that DMA actually crosses a slice boundary
    of the ``per_slice``-wide pod (an in-slice copy is ICI business
    and this fault never touches it). The DCN tier's characteristic
    fault: slow, never lost — **tolerated** by the credit protocol
    like :class:`DelayedDma`, which is exactly what the pod protocol
    must prove about its cross-slice phase."""

    src: int
    nth: int = 0
    hold: int = 64
    per_slice: int = 2

    def __post_init__(self):
        if self.per_slice < 1:
            raise ValueError(f"per_slice must be >= 1, got {self.per_slice}")


@dataclasses.dataclass(frozen=True)
class FlappingRank:
    """``rank`` crash-stops at job iteration ``dies_at``, recovers,
    and asks to rejoin at iteration ``rejoins_at``.

    A *job-level* fault (units are iterations of an iterative job, not
    actions of one collective): the phi-accrual detector must confirm
    the death before any watchdog fires, survivors shrink and restore
    from the last checkpoint manifest, and the recovered rank regrows
    under a new epoch — with the dead incarnation's traffic rejected
    as :class:`~smi_tpu_torch.parallel.membership.StaleEpochError`. Inside a
    single simulator run the rank simply runs or is absent (membership
    decides), so the plan's simulator hooks ignore this class.
    """

    rank: int
    dies_at: int = 2
    rejoins_at: int = 8

    def __post_init__(self):
        if self.rejoins_at <= self.dies_at:
            raise ValueError(
                f"FlappingRank must die before it rejoins "
                f"(dies_at={self.dies_at}, rejoins_at={self.rejoins_at})"
            )


@dataclasses.dataclass(frozen=True)
class SlowConsumer:
    """Rank ``rank``'s consumer stalls for ``stall_ticks`` step-clock
    ticks starting at ``from_tick`` — alive, heartbeating, computing
    nothing.

    The serving-level fault the end-to-end credit chain exists for:
    landed chunks stop being consumed, the destination's wire credits
    exhaust within :data:`~smi_tpu_torch.serving.scheduler.WIRE_CREDITS`
    chunks, its accepted streams stop completing, their stream credits
    stay held, and the admission edge must shed NEW work to that
    destination with a named error (``backpressure:rank<r>``) instead
    of growing any queue. The phi-accrual detector must at most
    suspect-and-clear the rank — a membership transition on a merely
    saturated rank is a campaign failure (the dead-vs-saturated
    distinction, exercised from the saturated side).
    """

    rank: int
    from_tick: int = 40
    stall_ticks: int = 60

    def __post_init__(self):
        if self.stall_ticks < 1:
            raise ValueError(
                f"stall_ticks must be >= 1, got {self.stall_ticks}"
            )


@dataclasses.dataclass(frozen=True)
class StalledHeartbeat:
    """``rank`` stays alive and computing but its heartbeats go silent
    for ``silent_for`` step-clock ticks starting at ``from_tick``.

    The fault the two-threshold detector exists for: the rank must be
    *suspected* (phi crosses the suspect threshold) and then cleared
    when heartbeats resume — never confirmed dead, never shrunk. A
    detector that kills it is a false positive the elastic campaign
    counts as a failure. No simulator-hook effect (the data plane is
    healthy).
    """

    rank: int
    from_tick: int = 50
    silent_for: int = 20


@dataclasses.dataclass(frozen=True)
class PartitionFault:
    """Cut every wire between the ``minority`` rank set and the rest
    of the ring, BOTH directions, for ticks ``[from_tick, until_tick)``
    — then heal.

    The clean network partition: both sides stay alive and keep
    heartbeating *within* their side, but no signal, DMA, or heartbeat
    crosses the cut while the window is open. Each side's phi-accrual
    evidence therefore says the other side died — without quorum
    fencing, each side shrinks the other and keeps actuating, and on
    heal the two histories collide silently. The windowed analog of
    :class:`DownLink` (which never heals) at rank-set granularity.
    """

    minority: FrozenSet[int]
    from_tick: int = 40
    until_tick: int = 120

    def __post_init__(self):
        if not self.minority:
            raise ValueError("PartitionFault needs a non-empty minority "
                             "rank set (an empty cut partitions nothing)")
        if self.until_tick <= self.from_tick:
            raise ValueError(
                f"PartitionFault window is empty: from_tick="
                f"{self.from_tick}, until_tick={self.until_tick} "
                f"(must heal strictly after it cuts)"
            )

    def blocks(self, src: int, dst: int, tick: int) -> bool:
        if not (self.from_tick <= tick < self.until_tick):
            return False
        return (src in self.minority) != (dst in self.minority)


@dataclasses.dataclass(frozen=True)
class AsymmetricLinkFault:
    """Traffic FROM ``src`` TO ``dst`` is lost for ticks
    ``[from_tick, until_tick)``; the ``dst``->``src`` direction keeps
    flowing — then heal.

    The asymmetric partition: ``src`` still hears ``dst`` (so from
    ``src``'s side the world looks healthy) while ``dst`` stops
    hearing ``src`` (so ``dst``'s detector watches ``src``'s phi climb
    toward dead). Heartbeat evidence DIVERGES between the two sides —
    the regime where one side confirms a death the other side never
    suspected, which symmetric cuts cannot produce.
    """

    src: int
    dst: int
    from_tick: int = 40
    until_tick: int = 120

    def __post_init__(self):
        if self.src == self.dst:
            raise ValueError(
                f"an asymmetric link connects two DISTINCT ranks, got "
                f"{self.src} twice"
            )
        if self.until_tick <= self.from_tick:
            raise ValueError(
                f"AsymmetricLinkFault window is empty: from_tick="
                f"{self.from_tick}, until_tick={self.until_tick}"
            )

    def blocks(self, src: int, dst: int, tick: int) -> bool:
        if not (self.from_tick <= tick < self.until_tick):
            return False
        return src == self.src and dst == self.dst


@dataclasses.dataclass(frozen=True)
class FlappingLink:
    """The ``a``<->``b`` wire flaps on a seeded duty cycle: within
    each ``period``-tick window of ``[from_tick, until_tick)`` the
    link is down (both directions) for ``down_ticks`` consecutive
    ticks at a seeded offset, up otherwise.

    The fault two-threshold detection exists for, exercised at the
    *link* rather than the rank: beats are lost in bursts but always
    resume within the confirmation grace, so the detector must ride
    suspect/clear cycles WITHOUT ever confirming a death — a
    membership transition (or a park/rejoin oscillation) on a merely
    flapping wire is the failure mode the hysteresis gate counts.
    Deterministic per ``(a, b, seed)``: the same fault always flaps
    the same ticks.
    """

    a: int
    b: int
    from_tick: int = 40
    until_tick: int = 160
    period: int = 8
    down_ticks: int = 3
    seed: int = 0

    def __post_init__(self):
        if self.a == self.b:
            raise ValueError(
                f"a flapping link connects two DISTINCT ranks, got "
                f"{self.a} twice"
            )
        if self.until_tick <= self.from_tick:
            raise ValueError(
                f"FlappingLink window is empty: from_tick="
                f"{self.from_tick}, until_tick={self.until_tick}"
            )
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period}")
        if not (1 <= self.down_ticks <= self.period):
            raise ValueError(
                f"down_ticks must be in 1..period={self.period}, got "
                f"{self.down_ticks} (a full-period outage is a "
                f"PartitionFault, not a flap)"
            )

    def blocks(self, src: int, dst: int, tick: int) -> bool:
        if {src, dst} != {self.a, self.b}:
            return False
        if not (self.from_tick <= tick < self.until_tick):
            return False
        window, offset = divmod(tick - self.from_tick, self.period)
        start = random.Random(
            f"flap:{self.a}:{self.b}:{self.seed}:{window}"
        ).randrange(self.period - self.down_ticks + 1)
        return start <= offset < start + self.down_ticks


def _corrupt_value(inner, truncate: bool):
    """Type-preserving in-flight damage: on hardware a flipped or
    truncated buffer still has the buffer's type — the reduction
    combines it, the consumer consumes it, nothing crashes. The
    simulator's symbolic payloads must behave the same way so bare
    (unframed) transport COMPLETES with wrong data rather than
    erroring, which is exactly the silent-corruption outcome the
    framing exists to prevent."""
    if truncate:
        if isinstance(inner, str):
            return inner[: len(inner) // 2]
        if isinstance(inner, frozenset):
            kept = sorted(inner, key=repr)[: len(inner) // 2]
            return frozenset(kept)
        if isinstance(inner, tuple):
            return inner[: len(inner) // 2]
        return ("truncated", repr(inner)[:4])
    if isinstance(inner, str):
        return inner + "\x01"
    if isinstance(inner, frozenset):
        return inner | {("bitflipped",)}
    if isinstance(inner, tuple):
        return inner + (("bitflipped",),)
    if isinstance(inner, int):
        return inner ^ 1
    return ("bitflipped", inner)


def _damage(payload, truncate: bool = False):
    """Corrupt a payload in flight. Framed: mutate the inner payload,
    KEEP the sender's CRC (the damage the checksum exists to catch).
    Bare: the same mutation, undetectable by anything but the harness's
    final output check."""
    if isinstance(payload, C.Frame):
        return dataclasses.replace(
            payload, payload=_corrupt_value(payload.payload, truncate)
        )
    return _corrupt_value(payload, truncate)


def _shift_seq(payload, delta: int):
    """Move a frame's wire sequence number by ``delta``, CRC recomputed
    — a pure reordering signature. Bare payloads carry no sequence
    number, so reordering is inexpressible there (no-op)."""
    if isinstance(payload, C.Frame):
        return C.make_frame(payload.src, payload.seq + delta,
                            payload.payload, wire=payload.wire)
    return payload


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault schedule for one simulator run.

    Implements the hook interface :class:`credits.RingSimulator`
    consults (``grant_multiplier`` / ``dma_hold`` / ``stall_after`` /
    ``link_down`` / the tick-aware ``link_blocked``). An empty plan is
    behaviourally identical to ``faults=None`` — the healthy fuzzer.
    """

    dropped_grants: Tuple[DroppedGrant, ...] = ()
    duplicated_grants: Tuple[DuplicatedGrant, ...] = ()
    delayed_dmas: Tuple[DelayedDma, ...] = ()
    stalled_ranks: Tuple[StalledRank, ...] = ()
    down_links: FrozenSet[Tuple[int, int]] = frozenset()
    bit_flips: Tuple[BitFlipPayload, ...] = ()
    reorders: Tuple[ReorderedChunks, ...] = ()
    truncations: Tuple[TruncatedDma, ...] = ()
    #: Job-level elastic faults (no simulator-hook effect; consumed by
    #: the membership layer's elastic soak).
    flapping_ranks: Tuple[FlappingRank, ...] = ()
    stalled_heartbeats: Tuple[StalledHeartbeat, ...] = ()
    #: Serving-level faults (no simulator-hook effect; consumed by the
    #: multi-tenant front-end's chaos-under-load cells).
    slow_consumers: Tuple[SlowConsumer, ...] = ()
    #: DCN-tier faults (slice-pair link cuts, cross-slice-only DMA
    #: holds) — consulted through the same hooks, slice-resolved.
    dcn_link_downs: Tuple[DcnLinkDown, ...] = ()
    dcn_delays: Tuple[DcnDelay, ...] = ()
    #: Partition-tier faults: windowed, possibly one-directional,
    #: possibly flapping link cuts that HEAL — consulted through the
    #: tick-aware ``link_blocked(src, dst, tick)`` hook (the simulator
    #: prefers it over plain ``link_down`` when present).
    partitions: Tuple[PartitionFault, ...] = ()
    asymmetric_links: Tuple[AsymmetricLinkFault, ...] = ()
    flapping_links: Tuple[FlappingLink, ...] = ()

    # -- hook interface (credits.RingSimulator) ------------------------
    def grant_multiplier(self, rank: int, nth: int) -> int:
        for f in self.dropped_grants:
            if f.rank == rank and f.nth == nth:
                return 0
        for f in self.duplicated_grants:
            if f.rank == rank and f.nth == nth:
                return 2
        return 1

    def dma_hold(self, src: int, nth: int) -> int:
        for f in self.delayed_dmas:
            if f.src == src and f.nth == nth:
                return f.hold
        return 0

    def dma_hold_to(self, src: int, dst: int, nth: int) -> int:
        """Destination-aware hold (the simulator prefers this hook
        when present): the base per-source holds plus the DCN delays,
        which apply only to a copy that actually crosses slices."""
        held = self.dma_hold(src, nth)
        if held:
            return held
        for f in self.dcn_delays:
            if f.src == src and f.nth == nth:
                slice_of = C.pod_slice_of(f.per_slice)
                if slice_of(src) != slice_of(dst):
                    return f.hold
        return 0

    def stall_after(self, rank: int) -> Optional[int]:
        for f in self.stalled_ranks:
            if f.rank == rank:
                return f.after
        return None

    def link_down(self, a: int, b: int) -> bool:
        if (a, b) in self.down_links or (b, a) in self.down_links:
            return True
        return any(f.severs(a, b) for f in self.dcn_link_downs)

    def link_blocked(self, src: int, dst: int, tick: int) -> bool:
        """Tick-aware, DIRECTIONAL link state — the hook the simulator
        prefers over :meth:`link_down` when present. Subsumes the
        static cuts (a permanently-down link is blocked at every tick)
        and adds the windowed partition classes: a symmetric cut
        blocks both directions across the minority boundary inside its
        window, an asymmetric cut blocks exactly its ``src``->``dst``
        direction, a flapping link blocks its seeded down-ticks.
        Healing is the whole point: past ``until_tick`` the wire
        carries traffic again and the two sides must reconcile.
        """
        if self.link_down(src, dst):
            return True
        for f in self.partitions:
            if f.blocks(src, dst, tick):
                return True
        for f in self.asymmetric_links:
            if f.blocks(src, dst, tick):
                return True
        for f in self.flapping_links:
            if f.blocks(src, dst, tick):
                return True
        return False

    def tamper(self, src: int, nth: int, payload):
        """Damage the ``nth`` DMA payload of ``src`` in flight.

        On a framed payload (``credits.Frame``) the damage is surgical:
        bit flips and truncation mutate the payload while keeping the
        sender's CRC (so only the receiver's checksum can notice);
        reordering swaps the sequence numbers of two consecutive frames
        with CRCs recomputed (so only the sequence check can notice).
        On a BARE payload the same damage lands undetectably — the run
        completes with wrong delivery, which the verdict harness
        re-raises as :class:`SilentCorruption`: the pair of behaviours
        is the framing layer's existence proof. Reordering is a
        framing-level concept (there is no sequence number to swap on a
        bare payload), so it is a no-op on unframed transport.
        """
        for f in self.bit_flips:
            if f.src == src and f.nth == nth:
                return _damage(payload)
        for f in self.truncations:
            if f.src == src and f.nth == nth:
                return _damage(payload, truncate=True)
        for f in self.reorders:
            if f.src == src and nth == f.nth:
                return _shift_seq(payload, +1)
            if f.src == src and nth == f.nth + 1:
                return _shift_seq(payload, -1)
        return payload

    # -- construction ---------------------------------------------------
    @property
    def empty(self) -> bool:
        return not (
            self.dropped_grants or self.duplicated_grants
            or self.delayed_dmas or self.stalled_ranks or self.down_links
            or self.bit_flips or self.reorders or self.truncations
            or self.flapping_ranks or self.stalled_heartbeats
            or self.slow_consumers
            or self.dcn_link_downs or self.dcn_delays
            or self.partitions or self.asymmetric_links
            or self.flapping_links
        )

    def faults(self) -> Tuple:
        """Every individual fault in the plan, deterministically ordered
        — the unit the chaos delta-debugger removes one at a time."""
        return (
            self.dropped_grants + self.duplicated_grants
            + self.delayed_dmas + self.stalled_ranks
            + tuple(DownLink(a, b) for a, b in sorted(self.down_links))
            + self.bit_flips + self.reorders + self.truncations
            + self.flapping_ranks + self.stalled_heartbeats
            + self.slow_consumers
            + self.dcn_link_downs + self.dcn_delays
            + self.partitions + self.asymmetric_links
            + self.flapping_links
        )

    def describe(self) -> List[str]:
        """One human-readable line per fault (the chaos report's and
        the minimal reproducer's rendering)."""
        return [
            f"{type(f).__name__}({', '.join(f'{k}={v}' for k, v in dataclasses.asdict(f).items())})"
            for f in self.faults()
        ]

    @classmethod
    def single(cls, fault) -> "FaultPlan":
        """A plan with exactly one fault."""
        if isinstance(fault, DroppedGrant):
            return cls(dropped_grants=(fault,))
        if isinstance(fault, DuplicatedGrant):
            return cls(duplicated_grants=(fault,))
        if isinstance(fault, DelayedDma):
            return cls(delayed_dmas=(fault,))
        if isinstance(fault, StalledRank):
            return cls(stalled_ranks=(fault,))
        if isinstance(fault, DownLink):
            return cls(down_links=frozenset({(fault.a, fault.b)}))
        if isinstance(fault, BitFlipPayload):
            return cls(bit_flips=(fault,))
        if isinstance(fault, ReorderedChunks):
            return cls(reorders=(fault,))
        if isinstance(fault, TruncatedDma):
            return cls(truncations=(fault,))
        if isinstance(fault, FlappingRank):
            return cls(flapping_ranks=(fault,))
        if isinstance(fault, StalledHeartbeat):
            return cls(stalled_heartbeats=(fault,))
        if isinstance(fault, SlowConsumer):
            return cls(slow_consumers=(fault,))
        if isinstance(fault, DcnLinkDown):
            return cls(dcn_link_downs=(fault,))
        if isinstance(fault, DcnDelay):
            return cls(dcn_delays=(fault,))
        if isinstance(fault, PartitionFault):
            return cls(partitions=(fault,))
        if isinstance(fault, AsymmetricLinkFault):
            return cls(asymmetric_links=(fault,))
        if isinstance(fault, FlappingLink):
            return cls(flapping_links=(fault,))
        raise TypeError(f"unknown fault {fault!r}")

    @classmethod
    def of(cls, faults) -> "FaultPlan":
        """A plan combining an iterable of individual faults — the
        multi-fault schedules the chaos campaign sweeps."""
        plan = cls()
        for fault in faults:
            single = cls.single(fault)
            plan = cls(
                dropped_grants=plan.dropped_grants + single.dropped_grants,
                duplicated_grants=(plan.duplicated_grants
                                   + single.duplicated_grants),
                delayed_dmas=plan.delayed_dmas + single.delayed_dmas,
                stalled_ranks=plan.stalled_ranks + single.stalled_ranks,
                down_links=plan.down_links | single.down_links,
                bit_flips=plan.bit_flips + single.bit_flips,
                reorders=plan.reorders + single.reorders,
                truncations=plan.truncations + single.truncations,
                flapping_ranks=(plan.flapping_ranks
                                + single.flapping_ranks),
                stalled_heartbeats=(plan.stalled_heartbeats
                                    + single.stalled_heartbeats),
                slow_consumers=(plan.slow_consumers
                                + single.slow_consumers),
                dcn_link_downs=(plan.dcn_link_downs
                                + single.dcn_link_downs),
                dcn_delays=plan.dcn_delays + single.dcn_delays,
                partitions=plan.partitions + single.partitions,
                asymmetric_links=(plan.asymmetric_links
                                  + single.asymmetric_links),
                flapping_links=(plan.flapping_links
                                + single.flapping_links),
            )
        return plan

    @classmethod
    def random(cls, fault_class: str, n: int, seed: int) -> "FaultPlan":
        """One deterministic random fault of ``fault_class`` for an
        ``n``-ring — the seeded generator the matrix sweeps. The same
        (class, n, seed) triple always builds the same plan."""
        rng = random.Random(f"{fault_class}:{n}:{seed}")
        rank = rng.randrange(n)
        if fault_class == "dropped_grant":
            return cls.single(DroppedGrant(rank, nth=rng.randrange(3)))
        if fault_class == "duplicated_grant":
            return cls.single(DuplicatedGrant(rank, nth=rng.randrange(3)))
        if fault_class == "delayed_dma":
            return cls.single(DelayedDma(
                rank, nth=rng.randrange(3), hold=rng.randrange(8, 120),
            ))
        if fault_class == "stalled_rank":
            return cls.single(StalledRank(rank, after=rng.randrange(12)))
        if fault_class == "down_link":
            return cls.single(DownLink(rank, (rank + 1) % n))
        if fault_class == "bit_flip_payload":
            return cls.single(BitFlipPayload(rank, nth=rng.randrange(3)))
        if fault_class == "reordered_chunks":
            return cls.single(ReorderedChunks(rank, nth=rng.randrange(3)))
        if fault_class == "truncated_dma":
            return cls.single(TruncatedDma(rank, nth=rng.randrange(3)))
        if fault_class == "flapping_rank":
            # dies after the detector bootstrap, rejoins mid-job so the
            # regrow path always exercises (elastic cells run >= 14
            # iterations)
            dies = 2 + rng.randrange(4)
            return cls.single(FlappingRank(
                rank, dies_at=dies, rejoins_at=dies + 4 + rng.randrange(4),
            ))
        if fault_class == "stalled_heartbeat":
            # silence starts after the soak's ~40-tick bootstrap and is
            # calibrated to the two-threshold band: long enough that
            # suspicion is guaranteed (>= suspect latency ~16 ticks for
            # any window phase), short enough that the resuming beat
            # lands inside the confirmation grace even in the worst
            # phase (window + ~2 periods of schedule phase must stay
            # under suspect latency + CONFIRM_GRACE_TICKS) — suspected,
            # cleared, never killed, for EVERY (from_tick, silent_for)
            # this generator can draw (swept in tests/test_membership)
            return cls.single(StalledHeartbeat(
                rank, from_tick=50 + rng.randrange(40),
                silent_for=16 + rng.randrange(9),
            ))
        if fault_class == "slow_consumer":
            # stall starts after the serving bootstrap has traffic in
            # flight, lasts long enough that backpressure must reach
            # the admission edge (the wire window is WIRE_CREDITS=4
            # chunks; tens of ticks of stall guarantee exhaustion)
            return cls.single(SlowConsumer(
                rank, from_tick=30 + rng.randrange(40),
                stall_ticks=40 + rng.randrange(41),
            ))
        if fault_class in DCN_FAULT_CLASSES:
            # pod shape convention for random draws: 2 slices of n//2
            # (the n-rank ring split in half) — n must be even
            if n < 2 or n % 2:
                raise ValueError(
                    f"DCN fault draws need an even n >= 2 (two slices "
                    f"of n//2), got n={n}"
                )
            per_slice = n // 2
            if fault_class == "dcn_link_down":
                return cls.single(DcnLinkDown(0, 1, per_slice=per_slice))
            return cls.single(DcnDelay(
                rank, nth=rng.randrange(3), hold=rng.randrange(8, 120),
                per_slice=per_slice,
            ))
        if fault_class in PARTITION_FAULT_CLASSES:
            if n < 2:
                raise ValueError(
                    f"partition fault draws need n >= 2 (a one-rank "
                    f"ring has no wire to cut), got n={n}"
                )
            start = 40 + rng.randrange(20)
            if fault_class == "partition":
                # a strict minority: never more than (n-1)//2 ranks on
                # the cut side, so the other side always keeps quorum
                size = 1 + rng.randrange(max(1, (n - 1) // 2))
                ranks = rng.sample(range(n), size)
                return cls.single(PartitionFault(
                    frozenset(ranks), from_tick=start,
                    until_tick=start + 60 + rng.randrange(40),
                ))
            if fault_class == "asymmetric_link":
                return cls.single(AsymmetricLinkFault(
                    rank, (rank + 1) % n, from_tick=start,
                    until_tick=start + 60 + rng.randrange(40),
                ))
            return cls.single(FlappingLink(
                rank, (rank + 1) % n, from_tick=start,
                until_tick=start + 80 + rng.randrange(40),
                period=8, down_ticks=2 + rng.randrange(2), seed=seed,
            ))
        raise ValueError(
            f"unknown fault class {fault_class!r}; "
            f"known: {FAULT_CLASSES + ELASTIC_FAULT_CLASSES + SERVING_FAULT_CLASSES + DCN_FAULT_CLASSES + PARTITION_FAULT_CLASSES}"
        )


# ---------------------------------------------------------------------------
# Verdicts: run one protocol under one plan, classify the outcome
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Outcome of one fault-matrix cell."""

    kind: str  # "tolerated" | "detected"
    error: Optional[C.ProtocolError] = None

    @property
    def tolerated(self) -> bool:
        return self.kind == "tolerated"

    @property
    def detected(self) -> bool:
        return self.kind == "detected"

    @property
    def error_name(self) -> Optional[str]:
        return None if self.error is None else type(self.error).__name__


def _simulate(protocol: str, n: int, strategy: C.Strategy,
              plan: Optional[FaultPlan], chunks: int,
              verified: bool = True, slices: int = 2,
              recorder=None) -> None:
    if protocol == "all_gather":
        C.simulate_all_gather(n, strategy, faults=plan, verified=verified,
                              recorder=recorder)
    elif protocol == "all_reduce":
        C.simulate_all_reduce(n, strategy, faults=plan, verified=verified,
                              recorder=recorder)
    elif protocol == "reduce_scatter":
        C.simulate_reduce_scatter(n, strategy, faults=plan,
                                  verified=verified, recorder=recorder)
    elif protocol == "neighbour_stream":
        C.simulate_neighbour_stream(n, chunks, strategy, faults=plan,
                                    verified=verified,
                                    recorder=recorder)
    elif protocol == "all_reduce_chunked":
        C.simulate_all_reduce_chunked(n, chunks, strategy, faults=plan,
                                      verified=verified,
                                      recorder=recorder)
    elif protocol == "allreduce_pod":
        if n % slices:
            raise ValueError(
                f"allreduce_pod needs n divisible by slices, got "
                f"n={n} slices={slices}"
            )
        C.simulate_allreduce_pod(slices, n // slices, strategy,
                                 faults=plan, verified=verified,
                                 recorder=recorder)
    elif protocol == "all_to_all":
        C.simulate_all_to_all(n, strategy, faults=plan,
                              verified=verified, recorder=recorder)
    elif protocol == "all_to_all_bruck":
        C.simulate_all_to_all(n, strategy, variant="bruck",
                              faults=plan, verified=verified,
                              recorder=recorder)
    elif protocol == "all_to_all_pod":
        if n % slices:
            raise ValueError(
                f"all_to_all_pod needs n divisible by slices, got "
                f"n={n} slices={slices}"
            )
        C.simulate_all_to_all_pod(slices, n // slices, strategy,
                                  faults=plan, verified=verified,
                                  recorder=recorder)
    elif protocol == "all_reduce_quantized":
        if n % slices:
            raise ValueError(
                f"all_reduce_quantized needs n divisible by slices, "
                f"got n={n} slices={slices}"
            )
        C.simulate_all_reduce_quantized(slices, n // slices, strategy,
                                        faults=plan, verified=verified,
                                        recorder=recorder)
    elif protocol == "all_reduce_sparse":
        C.simulate_all_reduce_sparse(n, strategy, faults=plan,
                                     verified=verified,
                                     recorder=recorder)
    else:
        raise ValueError(
            f"unknown protocol {protocol!r}; known: "
            f"{C.registered_protocols()}"
        )


def run_under_faults(
    protocol: str,
    n: int,
    plan: Optional[FaultPlan],
    strategy: Optional[C.Strategy] = None,
    chunks: int = 5,
    verified: bool = True,
    slices: int = 2,
    recorder=None,
) -> Verdict:
    """Execute one ring protocol under a fault plan and classify.

    Returns a *tolerated* verdict only when the run completed AND the
    harness verified delivery; a *detected* verdict for any named
    invariant violation (clobber / deadlock / credit leak / integrity).
    A completed run with wrong payloads raises
    :class:`SilentCorruption` — that outcome must never be classified,
    it must fail the build.

    ``verified`` runs the protocols over the verified-transport framing
    (the default, and behaviourally identical to bare transport under
    every non-tampering fault); ``verified=False`` strips the framing,
    which is how the matrix proves the payload-tampering classes WOULD
    be silent corruption without it.

    ``recorder`` (duck-typed flight recorder,
    :class:`smi_tpu.obs.events.FlightRecorder`) threads through to the
    simulator: a *detected* verdict's error then carries the bounded
    event tail (``recorder_tail``) naming the causal history behind
    the failure — what a campaign cell attaches to its evidence.
    """
    strategy = strategy if strategy is not None else C.Strategy(0)
    try:
        _simulate(protocol, n, strategy, plan, chunks, verified=verified,
                  slices=slices, recorder=recorder)
    except DETECTED_ERRORS as e:
        return Verdict("detected", e)
    except C.ProtocolError as e:
        raise SilentCorruption(
            f"{protocol} n={n} under {plan!r} completed with corrupt "
            f"delivery: {e}"
        ) from e
    return Verdict("tolerated")


# ---------------------------------------------------------------------------
# State-machine mirror for the runtime watchdogs
# ---------------------------------------------------------------------------

#: Maps a runtime collective family to its protocol state machine.
FAMILY_PROTOCOL = {
    "broadcast": "all_reduce",   # bcast rides the masked all-reduce ring
    "reduce": "all_reduce",
    "allreduce": "all_reduce",
    "scatter": "reduce_scatter",
    "gather": "all_gather",
    "stream": "neighbour_stream",
    "transfer": "neighbour_stream",
}


def _protocol_generators(protocol: str, n: int, chunks: int):
    if protocol == "all_gather":
        return [C.all_gather_rank(r, n, f"chunk{r}") for r in range(n)]
    if protocol == "all_reduce":
        return [
            C.all_reduce_rank(r, n, frozenset([r]), lambda a, b: a | b)
            for r in range(n)
        ]
    if protocol == "reduce_scatter":
        return [
            C.reduce_scatter_rank(
                r, n, [frozenset([(r, b)]) for b in range(n)],
                lambda a, b: a | b,
            )
            for r in range(n)
        ]
    if protocol == "neighbour_stream":
        return [
            C.neighbour_stream_rank(r, n, [(r, c) for c in range(chunks)])
            for r in range(n)
        ]
    raise ValueError(f"unknown protocol {protocol!r}; known: {PROTOCOLS}")


def mirror_stall_dump(protocol: str, n: int, chunks: int = 4) -> Dict:
    """Per-rank protocol state when no remote traffic ever completes.

    The watchdogs' state-machine mirror: advance every rank of the
    named protocol as far as it can go without landing a single DMA,
    then dump where each stands — the protocol-level silhouette of an
    indefinite device hang (every rank parked at its first wait that
    needed the wire). Deterministic; pure Python; cheap enough to build
    inside an error path.
    """
    if protocol in FAMILY_PROTOCOL:
        protocol = FAMILY_PROTOCOL[protocol]
    sim = C.RingSimulator(
        _protocol_generators(protocol, n, chunks), C.Strategy(0)
    )
    for _ in range(100_000):
        ranks = [c for c in sim._runnable() if c[0] == "rank"]
        if not ranks:
            break
        sim._execute_rank(ranks[0][1])
    return sim.state_dump()


def mirror_state_provider(family: str, n: int, chunks: int = 4,
                          structured: bool = False):
    """A zero-arg callable producing the formatted mirror dump — the
    ``state_provider`` shape :mod:`smi_tpu_torch.utils.watchdog` consumes.

    With ``structured=True`` the callable returns ``(text, dump)``:
    the watchdog attaches the raw dump dict to
    ``WatchdogTimeout.state`` so programmatic recovery
    (:func:`smi_tpu_torch.parallel.recovery.failed_ranks_of`) can read the
    per-rank states instead of re-parsing the formatted text.
    """

    def provide():
        protocol = FAMILY_PROTOCOL.get(family, family)
        try:
            dump = mirror_stall_dump(protocol, n, chunks)
        except Exception as e:  # the mirror must never mask the timeout
            text = f"(state mirror unavailable: {type(e).__name__}: {e})"
            return (text, None) if structured else text
        text = (
            f"protocol mirror [{protocol}, n={n}] with no remote "
            f"traffic completing:\n" + C.format_state_dump(dump)
        )
        return (text, dump) if structured else text

    return provide
