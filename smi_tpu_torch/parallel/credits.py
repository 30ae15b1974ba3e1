"""Credit flow-control protocol: executable specification + schedule fuzzer.

PyTorch counterpart of :mod:`smi_tpu.parallel.credits`, kept in step with
it line for line: the simulators are pure Python, and the same seed must
give the same schedule, state dump and report in both packages.

Reference parity: the SMI NoC is deadlock- and clobber-free because every
writer holds *credits* for the receiver's buffer space — P2P rendezvous
tokens (``templates/push.cl:21-31``, replenished by ``pop.cl:35-51``) and
the collectives' explicit credit windows (``reduce.cl:13-32``). The
emulator's strict channel-depth model exists to make violations reproduce
(``CMakeLists.txt:188-191``).

The ring kernels (:mod:`smi_tpu_torch.kernels.ring`, ``csrc/ring.cu``) use
the same idea: a rank may only write into a neighbour's buffer slot after
the neighbour granted that slot by raising a flag. This module is the
**protocol specification**, written as per-rank state machines (Python
generators mirroring the kernels' step structure one-yield-per-primitive)
plus a discrete-event simulator that executes them under arbitrary
schedules — random, adversarial, or exhaustive — and checks the protocol
invariants the hardware would punish:

- **no clobber**: a write never lands on a slot holding unconsumed data;
- **no deadlock**: some rank or in-flight write can always make progress;
- **credit balance**: every semaphore drains to zero at exit (a leaked
  count would poison the next collective reusing the semaphore — the
  ring kernels' drained-credit check reads exactly this);
- **correct delivery**: every rank terminates with the right payload.

Fault injection: the simulator optionally executes under a *fault plan*
(:mod:`smi_tpu_torch.parallel.faults`) that drops or duplicates credit
grants, delays DMA completions, crash-stops ranks, and takes links down.
The plan is consulted through a narrow hook interface
(``grant_multiplier`` / ``dma_hold`` / ``stall_after`` / ``link_down``)
so this module never imports the fault layer; with no plan the simulator
behaves bit-identically to the healthy fuzzer. Every deadlock carries a
per-rank protocol-state dump (:meth:`RingSimulator.state_dump`) — the
same dump the runtime watchdogs attach to timeout errors.

Concurrent composites (the 4-direction ring halo exchange, the
burst-interleaved ``stream_concurrent`` schedule) run SEVERAL kernel
instances per rank; :func:`halo_generators` /
:func:`concurrent_stream_generators` model them with scratch
slots/semaphores shared across sequential instances and the barrier
semaphore keyed by the stream's domain — see the section comment below
for what aliases and why.

:class:`ProtocolError` and :class:`IntegrityError` are the classes of
:mod:`smi_tpu_torch.parallel.errors`, which the verified channels raise:
one set of classes, so ``except credits.IntegrityError`` catches what a
channel raises.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import random
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from smi_tpu_torch.parallel.errors import IntegrityError, ProtocolError

# ---------------------------------------------------------------------------
# Primitive actions yielded by protocol generators
# ---------------------------------------------------------------------------
# ("signal", target_rank, sem_name, index, inc)   remote/local semaphore +=
# ("wait", sem_name, index, amount)               block until local sem >=,
#                                                 then decrement
# ("dma", target_rank, slot, payload, send_index, recv_index)
#                                                 start async copy into the
#                                                 target's buffer slot. The
#                                                 payload is snapshotted and
#                                                 send[send_index] signals
#                                                 IMMEDIATELY (hardware only
#                                                 promises the source buffer
#                                                 is reusable — the data may
#                                                 still be in flight); the
#                                                 copy lands when the
#                                                 scheduler picks it, then
#                                                 signals recv[recv_index] at
#                                                 the target. In-flight copies
#                                                 may land in ANY order —
#                                                 the credit protocol, not
#                                                 the wire, must prevent
#                                                 overtaking writes.
# ("read_slot", slot)                             -> payload (marks the slot
#                                                 consumed)
# ("write_slot", slot, payload)                   local slot init
# ("output", key, payload)                        record a result

SEM_SEND = "send"
SEM_RECV = "recv"
SEM_CREDIT = "credit"
SEM_BARRIER = "barrier"

# ---------------------------------------------------------------------------
# Protocol registries — the ONE source of truth
# ---------------------------------------------------------------------------
# Every consumer that enumerates "the registered protocols" — the fault
# matrix (`faults.run_under_faults`), the static verifier
# (`analysis/verifier.py`), the perf decomposer (`analysis/perf.py`),
# and the `route --check --lint` launch gate — reads these tuples (the
# fault layer re-exports them under its historical names). Keeping the
# definitions HERE, next to the state machines they name, means a new
# protocol family registers once and every tier follows; the
# seed-pinned chaos sweep stays byte-stable because PROTOCOLS itself is
# digest-tested (tests/test_alltoall.py) and the newer families live in
# their own tuples, never appended to it.

#: The four base ring protocols — the seed-pinned chaos sweep's draw
#: set. NEVER extend this tuple: a fifth name would silently re-roll
#: every pinned campaign cell (add a new registry tuple instead).
PROTOCOLS = ("all_gather", "all_reduce", "reduce_scatter",
             "neighbour_stream")

#: Pipelined variants runnable through the fault harness but NOT in the
#: seed-pinned base sweep.
CHUNKED_PROTOCOLS = ("all_reduce_chunked",)

#: The two-tier pod composition, same discipline.
POD_PROTOCOLS = ("allreduce_pod",)

#: The all-to-all family (sparse, data-dependent traffic): the pairwise
#: exchange reference, the Bruck-style log-step variant (power-of-two
#: ranks only — a non-power-of-two request fails loudly), and the
#: two-tier ICI x DCN variant. Same seed-pinning discipline: its own
#: tuple, never folded into PROTOCOLS.
ALLTOALL_PROTOCOLS = ("all_to_all", "all_to_all_bruck", "all_to_all_pod")

#: The compressed-wire allreduce family (r19): the quantized two-tier
#: composition (``all_reduce_quantized`` — the pod state machine with a
#: wire codec applied at the boundary; the reduced int8/bf16 byte width
#: lives in the :class:`TierCostModel`'s per-tier message sizing, never
#: in the state machine) and the top-k sparse variant
#: (``all_reduce_sparse`` — opaque (index, value) bundles gathered
#: around the ring and reduced locally). Same seed-pinning discipline:
#: its own tuple, never folded into PROTOCOLS.
QUANTIZED_PROTOCOLS = ("all_reduce_quantized", "all_reduce_sparse")


def all_protocol_registries() -> Dict[str, Tuple[str, ...]]:
    """Every protocol registry, by name, in declaration order — the
    single enumeration the fault layer, the static verifier, the perf
    decomposer, and the launch gate all derive their coverage from.
    Returned fresh per call (a dict, so a consumer cannot mutate the
    shared tuples through it); digest-tested so a registry edit is a
    conscious, test-visible act rather than a silent re-roll of the
    seed-pinned chaos sweep."""
    return {
        "PROTOCOLS": PROTOCOLS,
        "CHUNKED_PROTOCOLS": CHUNKED_PROTOCOLS,
        "POD_PROTOCOLS": POD_PROTOCOLS,
        "ALLTOALL_PROTOCOLS": ALLTOALL_PROTOCOLS,
        "QUANTIZED_PROTOCOLS": QUANTIZED_PROTOCOLS,
    }


def registered_protocols() -> Tuple[str, ...]:
    """The flattened registry: every protocol every analysis tier must
    cover, in registry declaration order."""
    out: Tuple[str, ...] = ()
    for names in all_protocol_registries().values():
        out += names
    return out


class ClobberError(ProtocolError):
    pass


class DeadlockError(ProtocolError):
    """No entity can make progress.

    ``state`` carries the per-rank protocol-state dump taken at the
    moment of the deadlock (:meth:`RingSimulator.state_dump`), so a
    failure names *where* every rank stood — the same dump the runtime
    watchdogs attach to timeout errors."""

    def __init__(self, message: str, state: Optional[dict] = None):
        super().__init__(message)
        self.state = state


class CreditLeakError(ProtocolError):
    pass


def format_state_dump(state: dict) -> str:
    """Render a :meth:`RingSimulator.state_dump` as indented text."""
    lines = []
    for r in sorted(k for k in state if isinstance(k, int)):
        entry = state[r]
        pending = entry.get("pending")
        desc = entry["state"]
        if pending is not None:
            desc += f" at {pending}"
        lines.append(
            f"  rank {r}: {desc} ({entry['outputs']} outputs)"
        )
    if state.get("inflight"):
        lines.append(f"  in-flight DMAs: {state['inflight']}")
    if state.get("undeliverable"):
        lines.append(
            f"  undeliverable DMAs (down links): {state['undeliverable']}"
        )
    if state.get("sems"):
        lines.append(f"  non-zero semaphores: {state['sems']}")
    fr = state.get("flight_recorder")
    if fr and fr.get("events"):
        lines.append(
            f"  flight recorder (last {len(fr['events'])} of "
            f"{fr['total_events']} events, {fr['dropped_events']} "
            f"dropped by the ring bound):"
        )
        for e in fr["events"]:
            who = f" rank {e['rank']}" if "rank" in e else ""
            detail = " ".join(
                f"{k}={v}" for k, v in sorted(e.items())
                if k not in ("seq", "tick", "plane", "kind", "rank")
            )
            lines.append(
                f"    [{e['seq']}@t{e['tick']}]{who} {e['kind']}"
                + (f" {detail}" if detail else "")
            )
    return "\n".join(lines)


@dataclasses.dataclass
class _Slot:
    payload: object = None
    full: bool = False
    consumed: bool = True  # nothing to lose initially


@dataclasses.dataclass
class _Dma:
    src: int
    target: int
    slot: int
    payload: object
    send_index: int
    recv_index: int
    #: wire-time the copy lands (cost model active; 0.0 otherwise)
    ready_at: float = 0.0
    #: (rank, step) of the issuing primitive in the rank's executed
    #: sequence — the same coordinates the static analysis tiers name
    #: events by, so a timing attribution can point back at the exact
    #: ``("dma", ...)`` primitive that started the copy
    origin: Optional[Tuple[int, int]] = None


def _identity(rank: int) -> int:
    return rank


def _barrier_steps(me: int, n: int, to_global: Callable[[int], int] = _identity):
    """Signal both ring neighbours, wait for both — mirrors
    ``ring._neighbour_barrier``. ``to_global`` maps a ring-local rank to
    the global simulator rank, mirroring ``ring._logical_id_fn`` (rings
    over a subset of a mesh's axes must target the right global device;
    the identity is only correct when the ring spans the whole mesh)."""
    yield ("signal", to_global((me - 1) % n), SEM_BARRIER, 0, 1)
    yield ("signal", to_global((me + 1) % n), SEM_BARRIER, 0, 1)
    yield ("wait", SEM_BARRIER, 0, 2)


# ---------------------------------------------------------------------------
# Protocol state machines (mirror the ring kernels' step structure)
# ---------------------------------------------------------------------------


def all_gather_rank(me: int, n: int, chunk, flow_control: bool = True,
                    to_global: Callable[[int], int] = _identity):
    """Mirrors ``_ring_all_gather_kernel``: forward the chunk received
    last step to the right neighbour; slots alternate; slot 1 granted at
    start; per-step re-grant after the onward send except the final step."""
    left, right = to_global((me - 1) % n), to_global((me + 1) % n)
    if flow_control:
        yield from _barrier_steps(me, n, to_global)
    yield ("output", me, chunk)
    yield ("write_slot", 0, chunk)
    if flow_control:
        yield ("signal", left, SEM_CREDIT, 1, 1)
    for s in range(n - 1):
        slot, nslot = s % 2, (s + 1) % 2
        if flow_control:
            yield ("wait", SEM_CREDIT, nslot, 1)
        payload = yield ("read_slot", slot)
        yield ("dma", right, nslot, payload, slot, nslot)
        yield ("wait", SEM_SEND, slot, 1)
        yield ("wait", SEM_RECV, nslot, 1)
        if flow_control and s < n - 2:
            yield ("signal", left, SEM_CREDIT, slot, 1)
        arrived = yield ("read_slot", nslot)
        yield ("output", (me - s - 1) % n, arrived)


def all_reduce_rank(me: int, n: int, value, combine: Callable,
                    flow_control: bool = True,
                    to_global: Callable[[int], int] = _identity):
    """Mirrors ``_ring_all_reduce_kernel``: circulate the running partial
    rightward, folding the local contribution into each arrival."""
    left, right = to_global((me - 1) % n), to_global((me + 1) % n)
    if flow_control:
        yield from _barrier_steps(me, n, to_global)
    yield ("write_slot", 0, value)
    if flow_control:
        yield ("signal", left, SEM_CREDIT, 1, 1)
    for s in range(n - 1):
        slot, nslot = s % 2, (s + 1) % 2
        if flow_control:
            yield ("wait", SEM_CREDIT, nslot, 1)
        payload = yield ("read_slot", slot)
        yield ("dma", right, nslot, payload, slot, nslot)
        yield ("wait", SEM_SEND, slot, 1)
        yield ("wait", SEM_RECV, nslot, 1)
        if flow_control and s < n - 2:
            yield ("signal", left, SEM_CREDIT, slot, 1)
        arrived = yield ("read_slot", nslot)
        yield ("write_slot", nslot, combine(arrived, value))
    final = yield ("read_slot", (n - 1) % 2)
    yield ("output", 0, final)


def all_reduce_chunked_rank(me: int, n: int, values: Sequence,
                            combine: Callable, flow_control: bool = True,
                            to_global: Callable[[int], int] = _identity):
    """Mirrors ``_ring_all_reduce_chunked_kernel``: the payload split
    into ``len(values)`` pipeline chunks, each circulating on its own
    double-buffered slot pair (flat layout ``2*c + parity``). Per ring
    step, phase A starts EVERY chunk's DMA (after its credit), phase B
    combines each arrival — chunk ``c`` folds while chunks ``c+1..``
    are still in flight — and phase C re-grants each slot once its
    onward send completed. Per chunk the credit discipline is identical
    to :func:`all_reduce_rank`; the phases interleave the chunks, which
    is exactly what the verified-transport framing must survive (wire
    sequence numbers advance across the chunk interleave in send order,
    and the receiver consumes in the same order)."""
    left, right = to_global((me - 1) % n), to_global((me + 1) % n)
    k = len(values)
    if flow_control:
        yield from _barrier_steps(me, n, to_global)
    for c in range(k):
        yield ("write_slot", 2 * c, values[c])
        if flow_control:
            yield ("signal", left, SEM_CREDIT, 2 * c + 1, 1)
    for s in range(n - 1):
        slot, nslot = s % 2, (s + 1) % 2
        for c in range(k):  # phase A: start all chunk RDMAs
            if flow_control:
                yield ("wait", SEM_CREDIT, 2 * c + nslot, 1)
            payload = yield ("read_slot", 2 * c + slot)
            yield ("dma", right, 2 * c + nslot, payload,
                   2 * c + slot, 2 * c + nslot)
        for c in range(k):  # phase B: combine arrivals in chunk order
            yield ("wait", SEM_RECV, 2 * c + nslot, 1)
            arrived = yield ("read_slot", 2 * c + nslot)
            yield ("write_slot", 2 * c + nslot,
                   combine(arrived, values[c]))
        for c in range(k):  # phase C: sends drained -> re-grant slots
            yield ("wait", SEM_SEND, 2 * c + slot, 1)
            if flow_control and s < n - 2:
                yield ("signal", left, SEM_CREDIT, 2 * c + slot, 1)
    final_slot = (n - 1) % 2
    for c in range(k):
        final = yield ("read_slot", 2 * c + final_slot)
        yield ("output", c, final)


def reduce_scatter_rank(me: int, n: int, blocks: Sequence, combine: Callable,
                        flow_control: bool = True,
                        to_global: Callable[[int], int] = _identity):
    """Mirrors ``_ring_reduce_scatter_kernel``: at step ``s`` send the
    partial of block ``(me - s - 1) % n``, fold the local share into the
    arriving partial of block ``(me - s - 2) % n``."""
    left, right = to_global((me - 1) % n), to_global((me + 1) % n)
    if flow_control:
        yield from _barrier_steps(me, n, to_global)
    yield ("write_slot", 0, blocks[(me - 1) % n])
    if flow_control:
        yield ("signal", left, SEM_CREDIT, 1, 1)
    for s in range(n - 1):
        slot, nslot = s % 2, (s + 1) % 2
        if flow_control:
            yield ("wait", SEM_CREDIT, nslot, 1)
        payload = yield ("read_slot", slot)
        yield ("dma", right, nslot, payload, slot, nslot)
        yield ("wait", SEM_SEND, slot, 1)
        yield ("wait", SEM_RECV, nslot, 1)
        if flow_control and s < n - 2:
            yield ("signal", left, SEM_CREDIT, slot, 1)
        arrived = yield ("read_slot", nslot)
        yield ("write_slot", nslot, combine(arrived, blocks[(me - s - 2) % n]))
    final = yield ("read_slot", (n - 1) % 2)
    yield ("output", me, final)


def neighbour_stream_rank(me: int, n: int, chunks: Sequence,
                          direction: int = 1, flow_control: bool = True,
                          to_global: Callable[[int], int] = _identity):
    """Mirrors ``_neighbour_stream_kernel``: stream own chunks one hop
    downstream while consuming the upstream's; both slots start granted,
    waits begin at chunk 2, grants stop when nobody would consume them."""
    dst = to_global((me + direction) % n)
    upstream = to_global((me - direction) % n)
    if flow_control:
        yield from _barrier_steps(me, n, to_global)
    total = len(chunks)
    for c, chunk in enumerate(chunks):
        slot = c % 2
        if flow_control and c >= 2:
            yield ("wait", SEM_CREDIT, slot, 1)
        yield ("dma", dst, slot, chunk, slot, slot)
        yield ("wait", SEM_RECV, slot, 1)
        arrived = yield ("read_slot", slot)
        yield ("output", c, arrived)
        if flow_control and c + 2 < total:
            yield ("signal", upstream, SEM_CREDIT, slot, 1)
        yield ("wait", SEM_SEND, slot, 1)


# ---------------------------------------------------------------------------
# Two-tier pod protocol (ICI x DCN)
# ---------------------------------------------------------------------------
# A pod is (slices x ranks_per_slice): fast ICI wires inside a slice,
# slow DCN wires between slices — the reference's intra-node cost-1 /
# inter-node QSFP cost-100 split (codegen/program.py:7-8) at datacenter
# scale. The hierarchical allreduce crosses the slow tier exactly once,
# with already-combined shards:
#
#   phase A  reduce-scatter within the slice ring (ICI): slice-local
#            rank i ends holding the slice-partial of block i;
#   phase B  ring allreduce of that shard across slices (DCN), over
#            the cross ring {s*k + i : s} of same-index ranks — each
#            DCN wire carries 1/k of the payload;
#   phase C  all-gather of the k global blocks back around the slice
#            ring (ICI).
#
# Each phase runs on its OWN slot pair (rs: 0/1, xs: 2/3, ag: 4/5 —
# distinct scratch addresses, so phases can never alias each other's
# buffers), its own credit indices (= the slot indices), and its own
# barrier-semaphore domain (("rs"|"xs"|"ag"), the pod analog of the
# per-stream collective_id): a fast rank racing into phase C cannot
# satisfy a neighbour's phase-A barrier or clobber phase-B scratch.
# The per-phase credit discipline is byte-identical to the base ring
# protocols, which is what lets the verified-transport framing ride
# the composition unchanged (wire sequence numbers simply keep
# advancing across phases).

#: slot base per pod phase — distinct scratch, distinct credit indices
POD_PHASE_SLOTS = {"rs": 0, "xs": 2, "ag": 4}


def pod_slice_of(per_slice: int) -> Callable[[int], int]:
    """Global rank -> slice id for a (slices, per_slice) pod in
    row-major rank order (slice s owns ranks [s*k, (s+1)*k))."""
    if per_slice < 1:
        raise ValueError(f"per_slice must be >= 1, got {per_slice}")
    return lambda g: g // per_slice


def _pod_barrier(me: int, n: int, to_global, domain: str):
    """Per-phase neighbour barrier on the phase's own semaphore domain
    (mirrors :func:`_barrier_steps` with a namespaced index)."""
    yield ("signal", to_global((me - 1) % n), SEM_BARRIER, (domain, 0), 1)
    yield ("signal", to_global((me + 1) % n), SEM_BARRIER, (domain, 0), 1)
    yield ("wait", SEM_BARRIER, (domain, 0), 2)


def _pod_ring_lap(idx: int, n: int, to_global, domain: str, seed,
                  arrival, flow_control: bool, prologue=(),
                  final_read: bool = True):
    """One double-buffered ring lap on a pod phase's own slot pair and
    barrier domain — the base ring credit discipline (write, credit
    signal, dma, send/recv waits, re-credit) shared by all three pod
    phases, with the per-step payload policy injected. ``arrival(st,
    nslot, arrived)`` returns the single step to emit after each
    arrival; ``prologue`` steps run between the barrier and the seed
    write; ``final_read`` returns the last slot's payload (the
    reduction phases) or skips it (the all-gather, which has already
    delivered every block). Keeping one copy here is what makes the
    per-phase credit discipline identical by construction."""
    left, right = to_global((idx - 1) % n), to_global((idx + 1) % n)
    base = POD_PHASE_SLOTS[domain]
    if flow_control:
        yield from _pod_barrier(idx, n, to_global, domain)
    for step in prologue:
        yield step
    yield ("write_slot", base + 0, seed)
    if flow_control:
        yield ("signal", left, SEM_CREDIT, base + 1, 1)
    for st in range(n - 1):
        slot = base + st % 2
        nslot = base + (st + 1) % 2
        if flow_control:
            yield ("wait", SEM_CREDIT, nslot, 1)
        payload = yield ("read_slot", slot)
        yield ("dma", right, nslot, payload, slot, nslot)
        yield ("wait", SEM_SEND, slot, 1)
        yield ("wait", SEM_RECV, nslot, 1)
        if flow_control and st < n - 2:
            yield ("signal", left, SEM_CREDIT, slot, 1)
        arrived = yield ("read_slot", nslot)
        yield arrival(st, nslot, arrived)
    if final_read:
        return (yield ("read_slot", base + (n - 1) % 2))
    return None


def allreduce_pod_rank(g: int, slices: int, per_slice: int,
                       blocks: Sequence, combine: Callable,
                       flow_control: bool = True):
    """One rank's two-tier hierarchical allreduce over a pod.

    ``blocks`` is this rank's contribution split into ``per_slice``
    pipeline blocks (the reduce-scatter granularity). Degenerate tiers
    collapse exactly: ``per_slice == 1`` skips phases A/C (a slice of
    one has nothing to scatter), ``slices == 1`` skips phase B (no DCN
    tier) — so the 1x1 pod is a no-op delivery of the local blocks.
    Delivery: one ``("output", c, payload)`` per block ``c`` holding
    the full reduction, on every rank — bit-identical to what the flat
    ring delivers for the same contributions.
    """
    k = per_slice
    if len(blocks) != k:
        raise ValueError(
            f"rank {g} got {len(blocks)} blocks for per_slice={k}"
        )
    if slices < 1 or k < 1:
        raise ValueError(f"pod must be >= 1x1, got {slices}x{k}")
    s, i = divmod(g, k)

    def in_slice(r: int) -> int:
        return s * k + r

    def x_slice(t: int) -> int:
        return t * k + i

    # -- phase A: reduce-scatter within the slice (ICI) ----------------
    if k > 1:
        shard = yield from _pod_ring_lap(
            i, k, in_slice, "rs", blocks[(i - 1) % k],
            lambda st, nslot, arrived: (
                "write_slot", nslot,
                combine(arrived, blocks[(i - st - 2) % k])),
            flow_control)
    else:
        shard = blocks[0]

    # -- phase B: circulate the shard across slices (DCN) --------------
    if slices > 1:
        block = yield from _pod_ring_lap(
            s, slices, x_slice, "xs", shard,
            lambda st, nslot, arrived: (
                "write_slot", nslot, combine(arrived, shard)),
            flow_control)
    else:
        block = shard

    # -- phase C: all-gather the global blocks within the slice (ICI) --
    if k > 1:
        yield from _pod_ring_lap(
            i, k, in_slice, "ag", block,
            lambda st, nslot, arrived: (
                "output", (i - st - 1) % k, arrived),
            flow_control, prologue=(("output", i, block),),
            final_read=False)
    else:
        yield ("output", 0, block)


# ---------------------------------------------------------------------------
# Compressed-wire allreduce family (r19)
# ---------------------------------------------------------------------------
# Hockney says a large-payload collective is pure bytes/beta, and no
# protocol before r19 ever shrank the bytes. Two state machines attack
# the term. ``all_reduce_quantized_rank`` is the two-tier pod
# composition with an explicit wire codec at the boundary: the rank
# encodes its OWN blocks before the first hop, circulates and combines
# in wire (quantized) space, and decodes only at delivery — arrivals
# are still never observed by control flow (encode/decode/combine are
# caller policy applied to opaque values), so the symbolic replay stays
# exact and all four static checks carry over from ``allreduce_pod``
# unchanged. The byte-width claim itself lives where PR 12 put message
# sizing: the :class:`TierCostModel`'s per-tier ``ici_bytes`` /
# ``dcn_bytes``, scaled by :data:`PRECISION_WIRE_RATIO`.
# ``all_reduce_sparse_rank`` ships top-k (index, value) bundles: no
# in-flight combine is possible without opening a bundle (the indices
# decide alignment), so the honest wire shape is a ring all-gather of
# the n opaque bundles with the reduction applied LOCALLY at the end —
# (n-1) hops of k pairs instead of (n-1) hops of the dense payload.

#: Wire bytes per element relative to f32 — the beta ratios the
#: quantized family exists for (f32 4 B, bf16 2 B, int8 1 B / element).
PRECISION_WIRE_RATIO = {"f32": 1.0, "bf16": 0.5, "int8": 0.25}

#: The sparse variant's default density (top-k keeps 1/16 of the
#: elements) and per-kept-element overhead (a 4 B index rides along
#: with each 4 B value), the pricing convention ``_costs_for`` and the
#: plan engine share.
SPARSE_TOPK_DENSITY = 1.0 / 16.0
SPARSE_INDEX_OVERHEAD = 2.0


def _identity_codec(v):
    return v


def all_reduce_quantized_rank(g: int, slices: int, per_slice: int,
                              blocks: Sequence, combine: Callable,
                              encode: Optional[Callable] = None,
                              decode: Optional[Callable] = None,
                              flow_control: bool = True):
    """One rank's two-tier allreduce in quantized wire form.

    Identical phase/slot/credit structure to :func:`allreduce_pod_rank`
    (rs over ICI, shard ring over DCN, ag over ICI — which is why the
    static safety checks and the verified-transport framing carry over
    byte-for-byte); the difference is the codec boundary: ``encode`` is
    applied to this rank's own ``blocks`` before the first hop,
    ``combine`` operates on wire-space values, and ``decode`` runs only
    at the ``("output", ...)`` edge. Numeric quantization (scale,
    rounding, error feedback) is the collective layer's job; here the codec is
    symbolic and the wire-width claim is the cost model's per-tier
    bytes. Delivery: one output per block holding the decoded full
    reduction, on every rank."""
    enc = encode or _identity_codec
    dec = decode or _identity_codec
    k = per_slice
    if len(blocks) != k:
        raise ValueError(
            f"rank {g} got {len(blocks)} blocks for per_slice={k}"
        )
    if slices < 1 or k < 1:
        raise ValueError(f"pod must be >= 1x1, got {slices}x{k}")
    s, i = divmod(g, k)
    wire = [enc(b) for b in blocks]

    def in_slice(r: int) -> int:
        return s * k + r

    def x_slice(t: int) -> int:
        return t * k + i

    # -- phase A: reduce-scatter the encoded blocks in-slice (ICI) -----
    if k > 1:
        shard = yield from _pod_ring_lap(
            i, k, in_slice, "rs", wire[(i - 1) % k],
            lambda st, nslot, arrived: (
                "write_slot", nslot,
                combine(arrived, wire[(i - st - 2) % k])),
            flow_control)
    else:
        shard = wire[0]

    # -- phase B: circulate the encoded shard across slices (DCN) ------
    if slices > 1:
        block = yield from _pod_ring_lap(
            s, slices, x_slice, "xs", shard,
            lambda st, nslot, arrived: (
                "write_slot", nslot, combine(arrived, shard)),
            flow_control)
    else:
        block = shard

    # -- phase C: all-gather, decoding at the delivery edge (ICI) ------
    if k > 1:
        yield from _pod_ring_lap(
            i, k, in_slice, "ag", block,
            lambda st, nslot, arrived: (
                "output", (i - st - 1) % k, dec(arrived)),
            flow_control, prologue=(("output", i, dec(block)),),
            final_read=False)
    else:
        yield ("output", 0, dec(block))


def all_reduce_sparse_rank(me: int, n: int, bundle, combine: Callable,
                           flow_control: bool = True,
                           to_global: Callable[[int], int] = _identity):
    """One rank's top-k sparse allreduce: ring all-gather of opaque
    (index, value) bundles, reduced locally.

    The wire discipline is :func:`all_gather_rank`'s (alternating
    slots, slot-1 credit at start, per-step re-grant except the final
    step), but arrivals are ASSEMBLED by ring position instead of
    delivered per source — the protocol never opens a bundle, it only
    knows which source each hop's arrival came from. Delivery: one
    ``("output", 0, combine(bundles))`` where ``bundles`` is the
    n-tuple of every rank's bundle in source order and ``combine`` is
    the caller's local densify-and-reduce policy."""
    left, right = to_global((me - 1) % n), to_global((me + 1) % n)
    if flow_control:
        yield from _barrier_steps(me, n, to_global)
    gathered: list = [None] * n
    gathered[me] = bundle
    yield ("write_slot", 0, bundle)
    if flow_control:
        yield ("signal", left, SEM_CREDIT, 1, 1)
    for s in range(n - 1):
        slot, nslot = s % 2, (s + 1) % 2
        if flow_control:
            yield ("wait", SEM_CREDIT, nslot, 1)
        payload = yield ("read_slot", slot)
        yield ("dma", right, nslot, payload, slot, nslot)
        yield ("wait", SEM_SEND, slot, 1)
        yield ("wait", SEM_RECV, nslot, 1)
        if flow_control and s < n - 2:
            yield ("signal", left, SEM_CREDIT, slot, 1)
        arrived = yield ("read_slot", nslot)
        gathered[(me - s - 1) % n] = arrived
    yield ("output", 0, combine(tuple(gathered)))


# ---------------------------------------------------------------------------
# All-to-all protocol family
# ---------------------------------------------------------------------------
# The first protocol family whose traffic matrix is not a ring or a
# tree: every rank holds one block per destination (MoE expert routing,
# distributed shuffle, K-means reassignment). Three variants, one
# delivery contract each, all one-yield-per-primitive and
# schedule-independent (no generator ever observes a received payload —
# receipts are forwarded or delivered opaquely, which is what keeps the
# static verifier's symbolic replay exact):
#
# - ``all_to_all_rank`` — the pairwise-exchange reference: step ``s``
#   sends to ``(me + s) % n`` and receives from ``(me - s) % n``,
#   double-buffered slots (``s % 2``), one credit per step granted by
#   the receiver two steps ahead. Per-STEP semaphore indices keep every
#   credit/send/recv domain single-producer (the shape the verifier's
#   happens-before matching is exact for); the verified-transport
#   framing rides unchanged because ``verified_steps`` already numbers
#   wire sequences PER DESTINATION — all-to-all is the protocol that
#   finally exercises more than one lane per sender.
# - ``all_to_all_bruck_rank`` — the Bruck-style log-step variant:
#   ``log2(n)`` rounds, round ``k`` forwarding every buffer index with
#   bit ``k`` set to rank ``me + 2^k``. Aggregation is modeled by
#   pricing (the harness prices each round's messages at the
#   ``n/2``-block aggregate the real kernel would coalesce into one
#   send); n must be a power of two — anything else is a loud
#   ValueError, never a silent fallback.
# - ``all_to_all_pod_rank`` — the two-tier ICI x DCN variant: phase A
#   exchanges per-destination items within the slice over ICI (routing
#   each block to the slice-mate whose COLUMN matches the block's
#   destination position), phase B crosses DCN exactly once per
#   destination slice with a k-block bundle, and the local redistribute
#   delivers per-source-slice bundles. DCN alphas drop from
#   ``(n - per_slice)`` per rank (flat pairwise) to ``slices - 1``.


def all_to_all_rank(me: int, n: int, blocks: Sequence,
                    flow_control: bool = True,
                    to_global: Callable[[int], int] = _identity):
    """Pairwise-exchange all-to-all: ``blocks[d]`` is this rank's block
    for destination ``d``; delivery is one ``("output", src, block)``
    per source rank (own block delivered locally).

    Credit discipline: step ``s`` lands in slot ``s % 2`` at the
    receiver; the receiver grants step ``s``'s credit (semaphore index
    ``s`` — single-producer, single-consumer) to that step's sender
    after consuming the slot's previous tenant at step ``s - 2`` (the
    first two steps are granted upfront — both slots start free). A
    duplicate grant admits a clobber, a dropped one deadlocks: the
    same failure surface as the ring protocols, on a rotating-partner
    schedule.
    """
    if n < 1:
        raise ValueError(f"all_to_all needs n >= 1, got {n}")
    if len(blocks) != n:
        raise ValueError(
            f"rank {me} got {len(blocks)} blocks for n={n}"
        )
    if flow_control and n > 1:
        yield from _barrier_steps(me, n, to_global)
    yield ("output", me, blocks[me])
    if flow_control:
        for s in range(1, min(3, n)):
            # both slots start free: grant the first tenant of each
            yield ("signal", to_global((me - s) % n), SEM_CREDIT, s, 1)
    for s in range(1, n):
        dst = to_global((me + s) % n)
        src = (me - s) % n
        if flow_control:
            yield ("wait", SEM_CREDIT, s, 1)
        yield ("dma", dst, s % 2, blocks[(me + s) % n], s, s)
        yield ("wait", SEM_SEND, s, 1)
        yield ("wait", SEM_RECV, s, 1)
        arrived = yield ("read_slot", s % 2)
        yield ("output", src, arrived)
        if flow_control and s + 2 < n:
            # slot s % 2 is consumed: its next tenant may come
            yield ("signal", to_global((me - (s + 2)) % n),
                   SEM_CREDIT, s + 2, 1)


def all_to_all_bruck_rank(me: int, n: int, blocks: Sequence,
                          flow_control: bool = True,
                          to_global: Callable[[int], int] = _identity):
    """Bruck-style log-step all-to-all (power-of-two ``n`` ONLY — a
    non-power-of-two rank count raises, it is never silently padded or
    rerouted).

    Round ``k`` forwards every buffer index ``i`` with bit ``k`` set to
    rank ``me + 2^k`` and refills the same indices from ``me - 2^k``;
    after ``log2(n)`` rounds buffer index ``i`` holds the block from
    rank ``(me - i) % n``, delivered per source. Received values are
    forwarded OPAQUELY (buffer entries, never inspected), so the
    sequence is schedule-independent and the verified-transport
    framing re-frames each hop on the forwarder's own destination
    lane. Each round's ``n/2`` copies start together and the harness
    prices them at the aggregate message size — the coalesced send a
    real Bruck kernel performs.

    Per-round-per-index semaphore domains (``("c"|"s"|"r", k, i)``)
    keep every lane single-producer; slot ``i`` is reused across the
    rounds whose bit is set in ``i``, protected by the per-round
    credit granted only after the previous tenant was read.
    """
    if n < 1 or (n & (n - 1)):
        raise ValueError(
            f"all_to_all_bruck needs a power-of-two rank count, got "
            f"n={n} — use the pairwise variant (or a padded shape) "
            f"for non-power-of-two rings"
        )
    if len(blocks) != n:
        raise ValueError(
            f"rank {me} got {len(blocks)} blocks for n={n}"
        )
    if flow_control and n > 1:
        yield from _barrier_steps(me, n, to_global)
    yield ("output", me, blocks[me])
    # local rotation: buf[i] = the block destined (me + i) % n
    buf = {i: blocks[(me + i) % n] for i in range(1, n)}
    rounds = n.bit_length() - 1
    for k in range(rounds):
        hop = 1 << k
        dst = to_global((me + hop) % n)
        src = to_global((me - hop) % n)
        idxs = [i for i in range(1, n) if i & hop]
        if flow_control:
            for i in idxs:
                # slot i's previous tenant (if any) was read in the
                # last round whose bit is below k — program order
                # makes this grant safe
                yield ("signal", src, SEM_CREDIT, ("c", k, i), 1)
        for i in idxs:  # phase A: start every copy of the round
            if flow_control:
                yield ("wait", SEM_CREDIT, ("c", k, i), 1)
            yield ("dma", dst, i, buf[i], ("s", k, i), ("r", k, i))
        for i in idxs:  # phase B: drain sends, refill the buffer
            yield ("wait", SEM_SEND, ("s", k, i), 1)
            yield ("wait", SEM_RECV, ("r", k, i), 1)
            buf[i] = yield ("read_slot", i)
    for i in range(1, n):
        yield ("output", (me - i) % n, buf[i])


def all_to_all_pod_rank(g: int, slices: int, per_slice: int,
                        blocks: Sequence, flow_control: bool = True):
    """One rank's two-tier ICI x DCN all-to-all over a pod.

    ``blocks[d]`` is this rank's block for global destination ``d``
    (row-major pod order, ``credits.pod_slice_of``). Routing: the
    block from ``(s, i)`` to ``(t, j)`` hops ICI to the in-slice
    COLUMN owner ``(s, j)`` (phase A), then crosses DCN once inside
    the ``(t, j)`` column as part of a ``per_slice``-block bundle
    (phase B). Delivery: one ``("output", ("slice", t), bundle)`` per
    source slice ``t``, where ``bundle[j]`` is the block from rank
    ``(t, j)`` — the concatenation over slices and positions is the
    flat variants' per-source delivery, re-grouped by slice (bundles
    stay opaque end to end, so the protocol never indexes a received
    payload and the symbolic replay stays exact).

    Degenerate tiers collapse exactly: ``per_slice == 1`` skips phase
    A, ``slices == 1`` skips phase B, and the 1x1 pod is a local
    delivery. Phase A/B run on disjoint slot spaces (``("Ad"|"At",
    ...)`` vs ``("B", ...)``, each written once per run) with
    per-phase neighbour barriers on their own semaphore domains.
    """
    m, k = slices, per_slice
    if m < 1 or k < 1:
        raise ValueError(f"pod must be >= 1x1, got {m}x{k}")
    n = m * k
    if len(blocks) != n:
        raise ValueError(
            f"rank {g} got {len(blocks)} blocks for a {m}x{k} pod"
        )
    s, i = divmod(g, k)

    def in_slice(r: int) -> int:
        return s * k + r

    def x_slice(t: int) -> int:
        return t * k + i

    # -- phase A: per-destination-position exchange in the slice (ICI)
    direct: Dict[int, object] = {}       # slice-mate pos -> block to me
    transit: Dict[Tuple[int, int], object] = {}  # (dst slice, src pos)
    if k > 1:
        if flow_control:
            yield from _pod_barrier(i, k, in_slice, "a2a_ici")
        for o in range(1, k):
            j = (i + o) % k
            yield ("dma", in_slice(j), ("Ad", i), blocks[s * k + j],
                   ("Ads", j), ("Ad", i))
            for u in range(1, m):
                t = (s + u) % m
                yield ("dma", in_slice(j), ("At", i, t),
                       blocks[t * k + j], ("Ats", j, t), ("At", i, t))
        for o in range(1, k):
            j = (i + o) % k
            yield ("wait", SEM_SEND, ("Ads", j), 1)
            for u in range(1, m):
                t = (s + u) % m
                yield ("wait", SEM_SEND, ("Ats", j, t), 1)
        for o in range(1, k):
            p = (i - o) % k
            yield ("wait", SEM_RECV, ("Ad", p), 1)
            direct[p] = yield ("read_slot", ("Ad", p))
            for u in range(1, m):
                t = (s + u) % m
                yield ("wait", SEM_RECV, ("At", p, t), 1)
                transit[(t, p)] = yield ("read_slot", ("At", p, t))
    own_bundle = tuple(
        blocks[s * k + i] if p == i else direct[p] for p in range(k)
    )
    yield ("output", ("slice", s), own_bundle)

    # -- phase B: one bundle per destination slice across DCN ----------
    if m > 1:
        if flow_control:
            yield from _pod_barrier(s, m, x_slice, "a2a_dcn")
        for u in range(1, m):
            t = (s + u) % m
            bundle = tuple(
                blocks[t * k + i] if p == i else transit[(t, p)]
                for p in range(k)
            )
            yield ("dma", x_slice(t), ("B", s), bundle, ("Bs", t),
                   ("B", s))
        for u in range(1, m):
            t = (s + u) % m
            yield ("wait", SEM_SEND, ("Bs", t), 1)
        for u in range(1, m):
            src_slice = (s - u) % m
            yield ("wait", SEM_RECV, ("B", src_slice), 1)
            bundle = yield ("read_slot", ("B", src_slice))
            yield ("output", ("slice", src_slice), bundle)


# ---------------------------------------------------------------------------
# Verified-transport framing
# ---------------------------------------------------------------------------
# The credit protocol guarantees ORDERING and FLOW CONTROL, but it
# trusts the wire: a payload corrupted in flight lands as cleanly as a
# healthy one and becomes silently wrong delivery — the one outcome the
# fault matrix forbids, and the one the simulator alone cannot catch at
# the point of damage. The framing layer closes that hole the way every
# production collective transport does: each chunk moves as a Frame
# carrying (src, per-source sequence number, CRC over src+seq+payload),
# and the receiver verifies both on consumption. Corruption or
# truncation → checksum mismatch; reordering or loss-then-replay →
# sequence mismatch; either raises a named IntegrityError instead of
# propagating bad data into a reduction.
#
# Framing is an adapter around a rank's protocol generator
# (:func:`verified_steps`), exactly like :func:`instance_steps`: the
# protocol state machines stay byte-identical, and with no tampering
# the framed run is behaviourally identical to the bare one. Local
# slot writes are framed too (a rank's own scratch re-reads verify on
# a separate per-rank "local" lane), so every read_slot in the system
# is covered.


@dataclasses.dataclass(frozen=True)
class Frame:
    """One verified-transport chunk: payload + integrity envelope.

    ``wire`` separates the two sequence lanes a rank emits on: True for
    RDMA'd chunks (the receiver checks them against the sender's wire
    lane), False for the rank's own local slot writes (checked against
    its local lane) — the lanes interleave arbitrarily in slot usage
    but are each strictly ordered.
    """

    src: int
    seq: int
    wire: bool
    payload: object
    crc: int


def frame_crc(src: int, seq: int, wire: bool, payload) -> int:
    """Deterministic checksum over the frame's identity and payload.

    ``repr`` keys the CRC: the simulator's payloads are plain Python
    values (strings, ints, frozensets, tuples of those) whose repr is
    stable within a run — and across runs for everything the harnesses
    use. Sorting frozensets would be needed for cross-process
    stability; within one campaign process this is exact.
    """
    return zlib.crc32(
        repr((src, seq, wire, payload)).encode()
    ) & 0xFFFFFFFF


def make_frame(src: int, seq: int, payload, wire: bool = True) -> Frame:
    return Frame(src, seq, wire, payload,
                 frame_crc(src, seq, wire, payload))


def _verify_frame(me: int, frame, next_seq: Dict,
                  accepted: Dict) -> object:
    """Receiver-side check: CRC then per-source sequence. Returns the
    unwrapped payload; raises :class:`IntegrityError` naming the miss.

    A re-read of the exact frame last accepted on a lane is legal (the
    all-gather kernel reads a slot once to deliver and once to forward);
    only a DIFFERENT frame with a non-successor sequence number is a
    reordering violation.
    """
    if not isinstance(frame, Frame):
        raise IntegrityError(
            f"rank {me} consumed an unframed payload {frame!r} on the "
            f"verified transport",
            rank=me, kind="unframed", got=frame,
        )
    want = frame_crc(frame.src, frame.seq, frame.wire, frame.payload)
    if want != frame.crc:
        raise IntegrityError(
            f"rank {me}: checksum mismatch on chunk seq={frame.seq} "
            f"from rank {frame.src}: frame declares crc={frame.crc:#010x}"
            f" but payload hashes to {want:#010x} (payload corrupted or"
            f" truncated in flight)",
            rank=me, src=frame.src, seq=frame.seq,
            expected=frame.crc, got=want, kind="checksum",
        )
    lane = (frame.src, frame.wire)
    if frame == accepted.get(lane):
        return frame.payload  # verified re-read of the same chunk
    expected = next_seq.get(lane, 0)
    if frame.seq != expected:
        raise IntegrityError(
            f"rank {me}: out-of-sequence chunk from rank {frame.src}: "
            f"expected seq={expected}, got seq={frame.seq} (chunks "
            f"reordered or lost in flight)",
            rank=me, src=frame.src, seq=frame.seq,
            expected=expected, got=frame.seq, kind="sequence",
        )
    next_seq[lane] = expected + 1
    accepted[lane] = frame
    return frame.payload


def verified_steps(gen, me: int):
    """Verified-transport framing around one rank's protocol generator.

    Outgoing ``dma`` payloads are framed on the rank's wire lane,
    local ``write_slot`` payloads on its local lane; every ``read_slot``
    result is CRC- and sequence-checked, then unwrapped before the
    inner generator sees it. All other actions pass through untouched,
    so a framed healthy run is behaviourally identical to a bare one —
    only tampering (:class:`smi_tpu_torch.parallel.faults.FaultPlan`'s
    ``tamper`` hook) can make the checks fire.

    Sequence checking relies on the credit protocol's own ordering
    guarantee: within one (src, lane) the ring protocols consume
    chunks in send order, so a regression is genuine reordering. The
    sender numbers its wire lane PER DESTINATION (a receiver's lane
    sees a dense sequence even when the sender also serves other
    rings) — identical to a single global counter for every
    single-destination protocol, and what lets the two-tier pod
    composition (in-slice ring + cross-slice ring per rank) ride the
    framing unchanged. The composite multi-instance programs re-use
    scratch across instances with their own ordering rules; frame
    those per instance, not across a whole composite.
    """
    wire_seqs: Dict[int, int] = {}
    local_seq = 0
    next_seq: Dict = {}
    accepted: Dict = {}
    value = None
    while True:
        try:
            action = gen.send(value)
        except StopIteration:
            return
        kind = action[0]
        if kind == "dma":
            _, target, slot, payload, send_index, recv_index = action
            wire_seq = wire_seqs.get(target, 0)
            frame = make_frame(me, wire_seq, payload, wire=True)
            wire_seqs[target] = wire_seq + 1
            value = yield ("dma", target, slot, frame, send_index,
                           recv_index)
        elif kind == "write_slot":
            _, slot, payload = action
            frame = make_frame(me, local_seq, payload, wire=False)
            local_seq += 1
            value = yield ("write_slot", slot, frame)
        elif kind == "read_slot":
            frame = yield action
            value = _verify_frame(me, frame, next_seq, accepted)
        else:
            value = yield action


# ---------------------------------------------------------------------------
# Concurrent multi-stream composition
# ---------------------------------------------------------------------------
# A composite program (the 4-direction ring halo exchange, concurrent
# P2P streams) runs SEVERAL kernel instances per rank in program order.
# The hardware resources they touch alias in two different ways, and the
# model must reproduce both:
#
# - comm-buffer slots and the send/recv/credit semaphores are
#   kernel-local *scratch*: sequential same-shaped instances reuse the
#   same VMEM/semaphore addresses. They are therefore NOT namespaced —
#   instance k+1's RDMAs physically land on the addresses instance k
#   used, and only protocol ordering keeps that safe.
# - the cross-device BARRIER semaphore is keyed by ``collective_id``
#   (the stream's semaphore domain, ``ring.ring_collective_id``). It is
#   namespaced by the instance's declared *domain*: instances on
#   distinct streams own distinct barriers; instances SHARING a domain
#   share one — which lets a fast rank satisfy its barrier wait with
#   signals meant for a neighbour's *other* instance, enter early, and
#   clobber scratch the neighbour is still consuming. That is exactly
#   the cross-stream hazard distinct domains exist to prevent, and
#   :func:`simulate_halo_exchange` + the mutation tests fuzz it.


def instance_steps(gen, domain, instance):
    """Run one kernel-instance generator inside a composite program.

    Namespaces the BARRIER semaphore by ``domain`` (collective_id) and
    the output keys by ``instance`` (so verification can tell instances
    apart); leaves slots and send/recv/credit semaphore indices alone —
    they are scratch addresses shared across sequential instances.
    """
    value = None
    while True:
        try:
            action = gen.send(value)
        except StopIteration:
            return
        kind = action[0]
        if kind == "signal" and action[2] == SEM_BARRIER:
            _, target, name, index, inc = action
            value = yield ("signal", target, name, (domain, index), inc)
        elif kind == "wait" and action[1] == SEM_BARRIER:
            _, name, index, amount = action
            value = yield ("wait", name, (domain, index), amount)
        elif kind == "output":
            _, key, payload = action
            value = yield ("output", (instance, key), payload)
        else:
            value = yield action


def chain_programs(*gens):
    """One rank's composite program: kernel instances in program order
    (one rank launches them sequentially), ``send``-transparent."""
    for gen in gens:
        value = None
        while True:
            try:
                action = gen.send(value)
            except StopIteration:
                break
            value = yield action


def halo_generators(
    nrow: int,
    ncol: int,
    chunks: int = 1,
    domains: Sequence[int] = (0, 1, 2, 3),
    flow_control: bool = True,
    wrong_ids: bool = False,
):
    """Per-rank composite programs of the 4-direction ring halo exchange.

    Mirrors ``halo.halo_exchange_2d(backend="ring")`` on an
    ``nrow x ncol`` mesh: per rank, four neighbour-stream instances in
    program order — up/down along the row axis (one ring per column),
    left/right along the column axis (one ring per row) — with stream
    ``s`` on barrier domain ``domains[s]`` (the per-direction semaphore
    domains, ``halo.py``). Rings span a SUBSET of the mesh axes, so
    ring-local ranks resolve through ``to_global`` exactly as the
    kernels' ``_logical_id_fn`` does; ``wrong_ids=True`` reinstates the
    pre-fix identity mapping (the round-3 subset-axis bug) so tests can
    prove the harness catches it.
    """
    programs = []
    for g in range(nrow * ncol):
        r, c = divmod(g, ncol)
        subs = []
        for stream, (axis, direction) in enumerate(
            (("row", 1), ("row", -1), ("col", 1), ("col", -1))
        ):
            if axis == "row":
                ring_n, ring_me = nrow, r
                to_global = (lambda rr, c=c: rr * ncol + c)
            else:
                ring_n, ring_me = ncol, c
                to_global = (lambda cc, r=r: r * ncol + cc)
            if wrong_ids:
                to_global = _identity
            labels = [((g, stream), k) for k in range(chunks)]
            subs.append(
                instance_steps(
                    neighbour_stream_rank(
                        ring_me, ring_n, labels, direction=direction,
                        flow_control=flow_control, to_global=to_global,
                    ),
                    domain=domains[stream], instance=stream,
                )
            )
        programs.append(chain_programs(*subs))
    return programs


def simulate_halo_exchange(
    nrow: int,
    ncol: int,
    strategy: Strategy,
    chunks: int = 1,
    domains: Sequence[int] = (0, 1, 2, 3),
    flow_control: bool = True,
    wrong_ids: bool = False,
) -> None:
    """Fuzz one schedule of the 4-direction halo composite and verify
    per-stream delivery: stream ``s`` at rank ``g`` must receive its
    ring-upstream's labels for that stream."""
    outputs = RingSimulator(
        halo_generators(nrow, ncol, chunks, domains, flow_control,
                        wrong_ids),
        strategy,
    ).run()
    for g in range(nrow * ncol):
        r, c = divmod(g, ncol)
        want = {}
        for stream, (axis, direction) in enumerate(
            (("row", 1), ("row", -1), ("col", 1), ("col", -1))
        ):
            if axis == "row":
                up = ((r - direction) % nrow) * ncol + c
            else:
                up = r * ncol + (c - direction) % ncol
            for k in range(chunks):
                want[(stream, k)] = ((up, stream), k)
        if outputs[g] != want:
            raise ProtocolError(
                f"rank {g} received {outputs[g]}, wanted {want}"
            )


def concurrent_stream_generators(
    n: int,
    channels: Sequence[Tuple[int, int]],
    bursts: int = 2,
    chunks_per_burst: int = 4,
    domains: Optional[Sequence[int]] = None,
    flow_control: bool = True,
    swap_order_rank: Optional[int] = None,
    chunk_counts: Optional[Sequence[int]] = None,
):
    """Per-rank composite programs of burst-interleaved concurrent P2P
    streams over one ``n``-ring.

    Mirrors ``channels._stream_concurrent_ring``: each round moves one
    burst of every channel (in channel order) before any channel
    advances — each burst a fresh neighbour-stream kernel instance (one
    ``_ring_move`` hop) in the channel's port stream domain. Every rank
    runs every hop (SPMD), so a channel is just ``(port, direction)``;
    ``domains`` overrides the per-channel barrier domains (defaults to
    the ports — pass duplicates to model the shared-domain mutation).

    ``swap_order_rank`` makes ONE rank run each burst's channels in
    reversed order — the divergent-MPMD ordering bug the collective
    schedule must never contain. With distinct domains that rank
    deadlocks loudly at the misordered barrier; with a shared domain
    the barrier lets it through and the fuzzer sees the resulting
    scratch clobber instead — both detectable, which is the point.

    ``chunk_counts`` (per-channel TOTAL chunks) models UNEQUAL tenant
    streams sharing the wire: round ``b`` moves channel ``i``'s chunks
    ``[b*cpb, (b+1)*cpb)`` while any remain, exhausted channels simply
    stop contributing instances — the ``READS_LIMIT`` fairness bound
    between unequal sources, where a small stream must finish within
    its own rounds instead of queueing behind a large one. Overrides
    ``bursts``; chunk labels carry the channel-absolute index.
    """
    if domains is None:
        domains = [port for port, _ in channels]
    if chunk_counts is not None:
        if len(chunk_counts) != len(channels):
            raise ValueError(
                f"need one chunk count per channel, got "
                f"{len(chunk_counts)} for {len(channels)}"
            )
        if any(c < 1 for c in chunk_counts):
            raise ValueError(f"chunk counts must be >= 1: {chunk_counts}")
        bursts = max(
            -(-total // chunks_per_burst) for total in chunk_counts
        )
    programs = []
    for g in range(n):
        subs = []
        for b in range(bursts):
            order = list(enumerate(channels))
            if g == swap_order_rank:
                order = order[::-1]
            for i, (port, direction) in order:
                if chunk_counts is None:
                    ks = range(chunks_per_burst)
                else:
                    ks = range(
                        b * chunks_per_burst,
                        min((b + 1) * chunks_per_burst, chunk_counts[i]),
                    )
                    if not ks:
                        continue  # this stream already drained
                labels = [((g, i, b), k) for k in ks]
                subs.append(
                    instance_steps(
                        neighbour_stream_rank(
                            g, n, labels, direction=direction,
                            flow_control=flow_control,
                        ),
                        domain=domains[i], instance=(i, b),
                    )
                )
        programs.append(chain_programs(*subs))
    return programs


def simulate_stream_concurrent(
    n: int,
    strategy: Strategy,
    bursts: int = 2,
    chunks_per_burst: int = 4,
    domains: Optional[Sequence[int]] = None,
    flow_control: bool = True,
    swap_order_rank: Optional[int] = None,
) -> None:
    """Fuzz one schedule of two burst-interleaved concurrent streams
    (the ``stream_concurrent(backend="ring")`` shape: distinct ports,
    opposite directions) and verify per-instance delivery."""
    channels = [(0, 1), (1, -1)]
    outputs = RingSimulator(
        concurrent_stream_generators(
            n, channels, bursts, chunks_per_burst, domains, flow_control,
            swap_order_rank,
        ),
        strategy,
    ).run()
    for g in range(n):
        want = {}
        for b in range(bursts):
            for i, (_, direction) in enumerate(channels):
                up = (g - direction) % n
                for k in range(chunks_per_burst):
                    want[((i, b), k)] = ((up, i, b), k)
        if outputs[g] != want:
            raise ProtocolError(
                f"rank {g} received {outputs[g]}, wanted {want}"
            )


def simulate_tenant_streams(
    n: int,
    strategy: Strategy,
    chunk_counts: Sequence[int],
    chunks_per_burst: int = 2,
    flow_control: bool = True,
) -> List[Dict]:
    """Fuzz one schedule of UNEQUAL concurrent tenant streams on one
    wire (every channel direction +1 around the same ring, distinct
    port domains) and verify per-stream delivery. Returns the per-rank
    output dicts — their insertion order IS each rank's consumption
    order, which is what the fairness regression measures
    (:func:`fairness_gap`)."""
    channels = [(i, 1) for i in range(len(chunk_counts))]
    outputs = RingSimulator(
        concurrent_stream_generators(
            n, channels, chunks_per_burst=chunks_per_burst,
            flow_control=flow_control, chunk_counts=chunk_counts,
        ),
        strategy,
    ).run()
    for g in range(n):
        up = (g - 1) % n
        want = {}
        for i, total in enumerate(chunk_counts):
            for k in range(total):
                b, c = divmod(k, chunks_per_burst)
                # output keys are burst-relative positions (the
                # kernel's chunk loop index); payloads carry the
                # channel-absolute chunk label
                want[((i, b), c)] = ((up, i, b), k)
        if outputs[g] != want:
            raise ProtocolError(
                f"rank {g} received {outputs[g]}, wanted {want}"
            )
    return outputs


def fairness_gap(rank_outputs: Dict, stream: int) -> int:
    """Largest number of OTHER streams' chunks consumed between two
    consecutive chunks of ``stream`` (including before its first) in
    one rank's delivery order — the interleaving-gap metric of the
    starvation regression: the burst-interleaved schedule must bound
    it by ``(streams - 1) * chunks_per_burst`` no matter how adversarial
    the schedule, because the credit discipline admits at most one
    burst of each other stream between a live stream's bursts."""
    gap = 0
    run = 0
    for (instance, _k) in rank_outputs:
        if instance[0] == stream:
            gap = max(gap, run)
            run = 0
        else:
            run += 1
    return gap


# ---------------------------------------------------------------------------
# Discrete-event simulator
# ---------------------------------------------------------------------------


class Strategy:
    """Picks the next runnable entity. Subclass for adversarial orders."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def pick(self, choices: List):  # choices: ("rank", r) | ("dma", i)
        return self.rng.choice(choices)


class DelayDmaStrategy(Strategy):
    """Adversarial: let ranks run as far ahead as possible before any DMA
    lands — maximizes the window for clobbers."""

    def pick(self, choices):
        ranks = [c for c in choices if c[0] == "rank"]
        return self.rng.choice(ranks) if ranks else self.rng.choice(choices)


class FavourRankStrategy(Strategy):
    """Adversarial: one rank races ahead, the others lag."""

    def __init__(self, favourite: int, seed: int = 0):
        super().__init__(seed)
        self.favourite = favourite

    def pick(self, choices):
        favoured = [
            c for c in choices
            if c == ("rank", self.favourite)
        ]
        if favoured and self.rng.random() < 0.85:
            return favoured[0]
        return self.rng.choice(choices)


class FavourSetStrategy(Strategy):
    """Adversarial: a GROUP of ranks races ahead together.

    A single favoured rank cannot get a whole kernel instance ahead of
    its neighbours in a composite program — barrier counting holds it
    back — but a contiguous *plateau* of favoured ranks can carry its
    interior a full instance ahead of the trailing ranks, which is the
    schedule shape that turns a shared barrier domain into a clobber
    (see the shared-domain mutation tests)."""

    def __init__(self, favoured, seed: int = 0, bias: float = 0.9):
        super().__init__(seed)
        self.favoured = set(favoured)
        self.bias = bias

    def pick(self, choices):
        favoured = [
            c for c in choices
            if c[0] == "rank" and c[1] in self.favoured
        ]
        if favoured and self.rng.random() < self.bias:
            return self.rng.choice(favoured)
        return self.rng.choice(choices)


# ---------------------------------------------------------------------------
# Wire-tier cost model (simulated wall-clock)
# ---------------------------------------------------------------------------
# The simulator's schedule space proves SAFETY; the cost model prices
# PERFORMANCE on the same runs. Every wire event — a DMA landing, a
# cross-rank semaphore signal — carries a logical timestamp priced by
# the Hockney alpha-beta model of its tier (ICI within a slice, DCN
# between slices), and each rank's clock advances to the latest
# timestamp it consumed at a wait. The makespan (max rank clock at
# exit) is deterministic per (protocol, strategy, cost model) and
# schedule-shape-faithful: it is how the two-tier protocol's
# cross-the-slow-wire-once claim becomes an asserted number instead of
# prose. Fault plans perturb *ordering* only; the model prices the
# healthy wire (a held DMA still lands at start + transit).


@dataclasses.dataclass(frozen=True)
class LinkCost:
    """Hockney alpha-beta price of one wire tier."""

    alpha_s: float
    beta_bytes_per_s: float

    def dma_seconds(self, payload_bytes: float) -> float:
        return self.alpha_s + payload_bytes / self.beta_bytes_per_s


@dataclasses.dataclass(frozen=True)
class TierCostModel:
    """Per-tier event prices for one simulator run.

    ``bytes_per_message`` is the payload size of every DMA in the run
    (the simulator's payloads are symbolic; the harness knows the
    protocol's message granularity — the full payload for the flat
    circulating ring, ``payload / per_slice`` for every phase of the
    pod protocol). ``per_slice == 0`` means single-tier: every wire is
    ICI, which keeps all pre-pod harnesses pricable unchanged.

    ``ici_bytes`` / ``dcn_bytes`` optionally override the message size
    PER TIER — the two-tier all-to-all moves per-destination blocks on
    ICI but ``per_slice``-block bundles across DCN, so one global
    granularity cannot price both wire populations. ``None`` (the
    default) keeps the single ``bytes_per_message``, so every existing
    harness prices identically.
    """

    bytes_per_message: float
    ici: LinkCost
    dcn: LinkCost
    per_slice: int = 0
    ici_bytes: Optional[float] = None
    dcn_bytes: Optional[float] = None

    def crosses_dcn(self, a: int, b: int) -> bool:
        return bool(
            self.per_slice
            and a // self.per_slice != b // self.per_slice
        )

    def link(self, a: int, b: int) -> LinkCost:
        return self.dcn if self.crosses_dcn(a, b) else self.ici

    def tier_bytes(self, src: int, dst: int) -> float:
        """The message size this (src, dst) wire carries: the tier's
        override when set, else the run-wide granularity."""
        if self.crosses_dcn(src, dst):
            if self.dcn_bytes is not None:
                return self.dcn_bytes
        elif self.ici_bytes is not None:
            return self.ici_bytes
        return self.bytes_per_message

    def dma_seconds(self, src: int, dst: int) -> float:
        return self.link(src, dst).dma_seconds(
            self.tier_bytes(src, dst)
        )

    def signal_seconds(self, src: int, dst: int) -> float:
        """A bare semaphore signal pays its tier's latency (no payload)."""
        if src == dst:
            return 0.0
        return self.link(src, dst).alpha_s


def default_tier_costs(bytes_per_message: float, per_slice: int = 0,
                       ici: Optional[LinkCost] = None,
                       dcn: Optional[LinkCost] = None,
                       ici_bytes: Optional[float] = None,
                       dcn_bytes: Optional[float] = None) -> TierCostModel:
    """Tier costs at the cost model's published rates: v5e ICI for the
    fast tier, the DCN alpha/beta (env-overridable beta,
    ``$SMI_TPU_DCN_BETA``) for the slow one. Deferred import — credits
    stays importable without the tuning package. ``ici_bytes`` /
    ``dcn_bytes`` pass through the per-tier message-size overrides
    (the two-tier all-to-all's mixed granularities)."""
    from smi_tpu_torch.tuning import cost_model as cm

    return TierCostModel(
        bytes_per_message=bytes_per_message,
        ici=ici if ici is not None else LinkCost(
            cm.DEFAULT_ALPHA_S, cm.V5E_ICI_BETA_BYTES_PER_S
        ),
        dcn=dcn if dcn is not None else LinkCost(
            cm.DCN_ALPHA_S, cm.dcn_beta_bytes_per_s()
        ),
        per_slice=per_slice,
        ici_bytes=ici_bytes,
        dcn_bytes=dcn_bytes,
    )


class RingSimulator:
    """Execute per-rank protocol generators under one schedule.

    ``coarse=True`` makes a scheduled rank run atomically until a
    *communication boundary*: a DMA start (which creates a new schedulable
    landing) or a wait it cannot yet satisfy. This is a partial-order
    reduction — local actions and counting-semaphore signals commute with
    other ranks' actions, so only the DMA-landing / rank-progress
    interleavings carry nondeterminism. It shrinks the schedule space
    enough for :func:`explore_all_schedules` to cover tiny configurations
    completely without losing any detectable race.

    ``faults`` is an optional fault plan (duck-typed; the canonical
    implementation is :class:`smi_tpu_torch.parallel.faults.FaultPlan`)
    providing four hooks:

    - ``grant_multiplier(rank, nth) -> int`` — 0 drops / 2 duplicates
      the ``nth`` credit grant signalled by ``rank`` (1 = healthy);
    - ``dma_hold(src, nth) -> int`` — scheduler events for which the
      ``nth`` DMA started by ``src`` may not land (delay, never loss:
      a held DMA becomes landable when nothing else can run); a plan
      may instead provide ``dma_hold_to(src, dst, nth)`` (preferred
      when present) to make the hold destination-aware — how the DCN
      tier's cross-slice-only delays are expressed;
    - ``stall_after(rank) -> Optional[int]`` — crash-stop ``rank``
      after that many executed actions (None = healthy);
    - ``link_down(a, b) -> bool`` — all traffic between global ranks
      ``a`` and ``b`` (signals and DMAs, both directions) is lost; a
      plan may instead provide ``link_blocked(src, dst, tick)``
      (preferred when present) — tick-aware and DIRECTIONAL, which is
      how windowed partitions, asymmetric cuts (A hears B while B
      stops hearing A), and seeded flapping links are expressed;
      the tick is the scheduler's ``sim_tick`` logical clock;
    - ``tamper(src, nth, payload) -> payload`` (optional) — damage the
      ``nth`` DMA payload started by ``src`` in flight (bit flip,
      truncation, sequence swap). The simulator applies it blindly;
      detection is the verified-transport framing's job
      (:func:`verified_steps`).

    ``recorder`` is an optional flight recorder (duck-typed — the
    canonical implementation is
    :class:`smi_tpu.obs.events.FlightRecorder` in the JAX package;
    this module never imports the obs layer, the fault-plan
    discipline): every credit
    grant/wait, barrier, and DMA start/landing emits a structured
    event stamped with the scheduler's logical tick, and every
    :class:`ProtocolError` leaving :meth:`run` (and every
    :meth:`state_dump`) carries the recorder's bounded tail — a
    deadlock names its causal history, not just its final state. With
    no recorder the hot path is untouched (one ``is None`` test per
    primitive).
    """

    def __init__(self, generators: Sequence[Iterator], strategy: Strategy,
                 coarse: bool = False, faults=None,
                 costs: Optional[TierCostModel] = None,
                 recorder=None):
        self.gens = list(generators)
        self.n = len(self.gens)
        self.strategy = strategy
        self.coarse = coarse
        self.faults = faults
        # structured-event hook (None = zero overhead); sim_tick is
        # the scheduler's executed-event count — the logical clock
        # every emitted event is stamped with
        self.recorder = recorder
        self.sim_tick = 0
        # wire-tier cost model: logical timestamps on every semaphore
        # increment + per-rank clocks -> simulated wall-clock
        self.costs = costs
        self.clock: List[float] = [0.0] * self.n
        self.sem_times: Dict[Tuple[int, str, object], List[float]] = {}
        self.sems: Dict[Tuple[int, str, int], int] = {}
        self.slots: Dict[Tuple[int, int], _Slot] = {}
        self.inflight: List[Optional[_Dma]] = []
        self.outputs: List[Dict] = [dict() for _ in range(self.n)]
        # fault bookkeeping: per-rank executed actions / issued credit
        # grants / started DMAs, per-DMA remaining hold, lost DMAs
        self.actions_done: List[int] = [0] * self.n
        self.grants_done: List[int] = [0] * self.n
        self.dmas_started: List[int] = [0] * self.n
        self.dma_holds: Dict[int, int] = {}
        self.undeliverable: List[_Dma] = []
        # (pending_action, value_to_send) per rank; None action = finished
        self.state: List[Optional[Tuple]] = []
        for gen in self.gens:
            try:
                action = next(gen)
                self.state.append((action, None))
            except StopIteration:
                self.state.append(None)

    # -- helpers --
    def _sem(self, rank: int, name: str, index: int) -> int:
        return self.sems.get((rank, name, index), 0)

    def _add(self, rank: int, name: str, index: int, inc: int) -> None:
        key = (rank, name, index)
        self.sems[key] = self.sems.get(key, 0) + inc

    def _slot(self, rank: int, index: int) -> _Slot:
        return self.slots.setdefault((rank, index), _Slot())

    # -- wire-time accounting (cost model active only) --
    def _push_time(self, key, at: float, times: int = 1) -> None:
        lane = self.sem_times.setdefault(key, [])
        for _ in range(times):
            bisect.insort(lane, at)

    def _pop_times(self, key, amount: int) -> float:
        """Availability time of the ``amount`` earliest increments a
        wait consumed (FIFO-by-time pairing)."""
        lane = self.sem_times.get(key, [])
        take = min(amount, len(lane))
        if take == 0:
            return 0.0
        popped = lane[:take]
        del lane[:take]
        return popped[-1]

    def elapsed_seconds(self) -> float:
        """Simulated wall-clock of the run (0.0 without a cost model):
        the slowest rank's clock — deterministic per (protocol,
        strategy, cost model)."""
        if self.costs is None or not self.clock:
            return 0.0
        return max(self.clock)

    # -- fault hooks --
    def _stalled(self, r: int) -> bool:
        if self.faults is None:
            return False
        after = self.faults.stall_after(r)
        return after is not None and self.actions_done[r] >= after

    def _link_down(self, a: int, b: int) -> bool:
        if self.faults is None:
            return False
        # tick-aware directional hook preferred when the plan has one
        # (windowed partitions / asymmetric cuts / flapping links heal
        # mid-run, so the answer depends on WHEN and WHICH WAY); plans
        # without it keep the static symmetric semantics bit-for-bit
        blocked = getattr(self.faults, "link_blocked", None)
        if blocked is not None:
            return blocked(a, b, self.sim_tick)
        return self.faults.link_down(a, b)

    # -- flight-recorder hooks (no-ops without a recorder) --
    @staticmethod
    def _obs_scalar(value):
        """Semaphore indexes / slots may be tuples (phase domains,
        per-round lanes); events carry JSON scalars."""
        return value if isinstance(value, (int, float, str)) else str(value)

    def _attach_recorder_tail(self, error: BaseException) -> None:
        """Bounded causal history onto an escaping error — on the
        ``recorder_tail`` attribute, and inside the structured
        ``state`` dict when the error carries one. Never raises (the
        tail must not mask the error it annotates)."""
        if self.recorder is None:
            return
        try:
            tail = self.recorder.tail()
            error.recorder_tail = tail
            state = getattr(error, "state", None)
            if isinstance(state, dict):
                state.setdefault("flight_recorder", tail)
        except Exception:
            pass

    # -- execution --
    def _runnable(self) -> List:
        out = []
        for r, st in enumerate(self.state):
            if st is None or self._stalled(r):
                continue
            action, _ = st
            if action[0] == "wait":
                _, name, index, amount = action
                if self._sem(r, name, index) >= amount:
                    out.append(("rank", r))
            else:
                out.append(("rank", r))
        held = []
        for i, dma in enumerate(self.inflight):
            if dma is not None:
                if self.dma_holds.get(i, 0) > 0:
                    held.append(("dma", i))
                else:
                    out.append(("dma", i))
        if not out and held:
            # a delayed DMA is slow, never lost: once nothing else can
            # run, the oldest held copy completes rather than deadlock
            return held[:1]
        return out

    def _advance(self, r: int, value=None) -> None:
        try:
            action = self.gens[r].send(value)
            self.state[r] = (action, None)
        except StopIteration:
            self.state[r] = None

    def _execute_rank(self, r: int) -> None:
        while True:
            kind = self.state[r][0][0]
            self._execute_one(r)
            if not self.coarse or kind == "dma":
                return  # dma start is a boundary: its landing must be
                        # schedulable before this rank continues
            st = self.state[r]
            if st is None or self._stalled(r):
                return
            nxt = st[0]
            if nxt[0] == "wait":
                _, name, index, amount = nxt
                if self._sem(r, name, index) < amount:
                    return  # blocked

    def _execute_one(self, r: int) -> None:
        action, _ = self.state[r]
        kind = action[0]
        self.actions_done[r] += 1
        self.sim_tick += 1
        if kind == "wait":
            _, name, index, amount = action
            if self.recorder is not None:
                if name == SEM_CREDIT:
                    self.recorder.emit(
                        "credit.wait", self.sim_tick, rank=r,
                        index=self._obs_scalar(index),
                    )
                elif name == SEM_BARRIER:
                    self.recorder.emit("barrier.wait", self.sim_tick,
                                       rank=r)
            self._add(r, name, index, -amount)
            if self.costs is not None:
                self.clock[r] = max(
                    self.clock[r],
                    self._pop_times((r, name, index), amount),
                )
            self._advance(r)
        elif kind == "signal":
            _, target, name, index, inc = action
            mult = 1
            if self.faults is not None:
                if target != r and self._link_down(r, target):
                    mult = 0  # lost on the dead wire
                elif name == SEM_CREDIT:
                    mult = self.faults.grant_multiplier(
                        r, self.grants_done[r]
                    )
            if name == SEM_CREDIT:
                self.grants_done[r] += 1
            if self.recorder is not None:
                if name == SEM_CREDIT:
                    extra = {} if mult == 1 else {"mult": mult}
                    self.recorder.emit(
                        "credit.grant", self.sim_tick, rank=r,
                        src=r, dst=target,
                        index=self._obs_scalar(index), **extra,
                    )
                elif name == SEM_BARRIER:
                    self.recorder.emit("barrier.signal", self.sim_tick,
                                       rank=r, src=r, dst=target)
            if mult:
                self._add(target, name, index, inc * mult)
                if self.costs is not None:
                    self._push_time(
                        (target, name, index),
                        self.clock[r]
                        + self.costs.signal_seconds(r, target),
                        times=inc * mult,
                    )
            self._advance(r)
        elif kind == "dma":
            _, target, slot, payload, send_index, recv_index = action
            nth = self.dmas_started[r]
            self.dmas_started[r] += 1
            if self.faults is not None:
                # in-flight payload tampering (bit flips, truncation,
                # reordering): the wire damages the snapshot, the
                # protocol machinery never notices — only the framing
                # layer (verified_steps) can turn this into a named
                # IntegrityError instead of silent corruption
                tamper = getattr(self.faults, "tamper", None)
                if tamper is not None:
                    payload = tamper(r, nth, payload)
            if self.recorder is not None:
                self.recorder.emit(
                    "dma.start", self.sim_tick, rank=r,
                    src=r, dst=target, slot=self._obs_scalar(slot),
                )
            dma = _Dma(src=r, target=target, slot=slot, payload=payload,
                       send_index=send_index, recv_index=recv_index,
                       origin=(r, self.actions_done[r] - 1))
            if self.costs is not None:
                dma.ready_at = (
                    self.clock[r] + self.costs.dma_seconds(r, target)
                )
            if target != r and self._link_down(r, target):
                # the wire is dead: neither the remote landing nor the
                # local send completion ever fires — the writer's
                # wait(SEM_SEND) is where the loss becomes visible
                self.undeliverable.append(dma)
                self._advance(r)
                return
            self.inflight.append(dma)
            if self.faults is not None:
                # destination-aware holds (the DCN tier's cross-slice
                # delays) when the plan provides them, else the
                # original per-source hook
                hold_to = getattr(self.faults, "dma_hold_to", None)
                hold = (hold_to(r, target, nth) if hold_to is not None
                        else self.faults.dma_hold(r, nth))
                if hold:
                    self.dma_holds[len(self.inflight) - 1] = hold
            # send completion = source buffer reusable; worst case this is
            # immediate, long before the remote landing
            self._add(r, SEM_SEND, send_index, 1)
            if self.costs is not None:
                self._push_time((r, SEM_SEND, send_index), self.clock[r])
            self._advance(r)
        elif kind == "write_slot":
            _, slot, payload = action
            s = self._slot(r, slot)
            s.payload, s.full, s.consumed = payload, True, False
            self._advance(r)
        elif kind == "read_slot":
            _, slot = action
            s = self._slot(r, slot)
            if not s.full:
                raise ProtocolError(
                    f"rank {r} read empty slot {slot}"
                )
            s.consumed = True
            self._advance(r, s.payload)
        elif kind == "output":
            _, key, payload = action
            self.outputs[r][key] = payload
            self._advance(r)
        else:  # pragma: no cover
            raise ValueError(f"unknown action {action!r}")

    def _land_dma(self, i: int) -> None:
        dma = self.inflight[i]
        self.inflight[i] = None
        self.sim_tick += 1
        if self.recorder is not None:
            self.recorder.emit(
                "dma.land", self.sim_tick, rank=dma.target,
                src=dma.src, dst=dma.target,
                slot=self._obs_scalar(dma.slot),
            )
        s = self._slot(dma.target, dma.slot)
        if s.full and not s.consumed:
            raise ClobberError(
                f"DMA from rank {dma.src} landed on rank {dma.target} "
                f"slot {dma.slot} holding unconsumed data"
            )
        s.payload, s.full, s.consumed = dma.payload, True, False
        self._add(dma.target, SEM_RECV, dma.recv_index, 1)
        if self.costs is not None:
            self._push_time(
                (dma.target, SEM_RECV, dma.recv_index), dma.ready_at
            )

    def run(self, max_steps: int = 1_000_000) -> List[Dict]:
        try:
            return self._run(max_steps)
        except ProtocolError as e:
            # a deadlock / clobber / integrity failure leaves with the
            # recorder's bounded causal history attached (the dump in
            # a DeadlockError.state already carries it via state_dump)
            self._attach_recorder_tail(e)
            raise

    def _run(self, max_steps: int) -> List[Dict]:
        for _ in range(max_steps):
            if all(st is None for st in self.state) and not any(
                d is not None for d in self.inflight
            ):
                self._check_drained()
                return self.outputs
            choices = self._runnable()
            if not choices:
                state = self.state_dump()
                raise DeadlockError(
                    "no runnable entity; per-rank protocol state:\n"
                    + format_state_dump(state),
                    state=state,
                )
            if self.dma_holds:
                # delayed DMAs age one scheduler event per iteration
                self.dma_holds = {
                    i: h - 1 for i, h in self.dma_holds.items() if h > 1
                }
            kind, idx = self.strategy.pick(choices)
            if kind == "rank":
                self._execute_rank(idx)
            else:
                self._land_dma(idx)
        raise ProtocolError("simulation did not terminate")

    def state_dump(self) -> Dict:
        """Per-rank protocol state: what each rank is doing (finished /
        stalled / blocked-at-wait / runnable), its output count, plus
        in-flight and lost DMAs and non-zero semaphores. Attached to
        every :class:`DeadlockError` and surfaced by the runtime
        watchdogs (:mod:`smi_tpu_torch.utils.watchdog`)."""
        dump: Dict = {}
        for r, st in enumerate(self.state):
            if st is None:
                dump[r] = {"state": "finished", "pending": None,
                           "outputs": len(self.outputs[r])}
                continue
            action = st[0]
            if self._stalled(r):
                state = "stalled"
            elif action[0] == "wait":
                _, name, index, amount = action
                state = (
                    "blocked"
                    if self._sem(r, name, index) < amount else "runnable"
                )
            else:
                state = "runnable"
            dump[r] = {"state": state, "pending": action,
                       "outputs": len(self.outputs[r])}
        dump["inflight"] = [
            (d.src, d.target, d.slot)
            for d in self.inflight if d is not None
        ]
        dump["undeliverable"] = [
            (d.src, d.target, d.slot) for d in self.undeliverable
        ]
        dump["sems"] = {k: v for k, v in self.sems.items() if v != 0}
        if self.recorder is not None:
            # the causal history behind the final state: bounded,
            # dropped-event-counted (never silently truncated)
            try:
                dump["flight_recorder"] = self.recorder.tail()
            except Exception:
                pass
        return dump

    def _check_drained(self) -> None:
        leaked = {k: v for k, v in self.sems.items() if v != 0}
        if leaked:
            raise CreditLeakError(
                f"semaphores non-zero at exit: {leaked}"
            )


# ---------------------------------------------------------------------------
# Exhaustive exploration (tiny configurations)
# ---------------------------------------------------------------------------


class ScheduleCount(int):
    """The count :func:`explore_all_schedules` returns, with coverage.

    Behaves as the plain ``int`` it always was (``explored`` complete
    schedules), plus the no-silent-caps bookkeeping:

    - ``explored`` — complete schedules verified (== ``int(self)``);
    - ``truncated`` — True when the budget stopped the DFS before the
      space was exhausted;
    - ``frontier`` — unexplored branch prefixes remaining at the stop
      (each leads to >= 1 further schedule);
    - ``estimated_total`` — the space size this run can attest:
      exactly ``explored`` when the DFS completed, else the LOWER BOUND
      ``explored + frontier`` (the true total is usually far larger —
      the bound is what one truncated run can honestly claim).
    """

    explored: int
    truncated: bool
    frontier: int
    estimated_total: int

    def __new__(cls, explored: int, truncated: bool = False,
                frontier: int = 0):
        self = super().__new__(cls, explored)
        self.explored = explored
        self.truncated = truncated
        self.frontier = frontier
        self.estimated_total = explored + frontier
        return self

    def to_json(self) -> dict:
        """Machine-readable coverage (the JAX CLI's ``smi-tpu lint --json``
        field shape): a truncating budget is never a warning-only
        event — report consumers see explored/estimated_total/
        truncated explicitly."""
        return {
            "explored": self.explored,
            "truncated": self.truncated,
            "frontier": self.frontier,
            "estimated_total": self.estimated_total,
        }


def explore_all_schedules(make_generators: Callable[[], Sequence[Iterator]],
                          max_schedules: int = 200_000,
                          allow_budget: bool = False) -> "ScheduleCount":
    """Depth-first over *every* scheduler choice for a tiny configuration.

    Re-instantiates the generators per path (generators are single-shot),
    replaying a prefix of choices then branching. Returns the number of
    complete schedules explored — a :class:`ScheduleCount`, an ``int``
    subclass carrying explored/estimated-total coverage — and raises on
    any invariant violation.

    ``allow_budget=True`` turns budget exhaustion from an error into a
    clean return of the count: the caller asserts "the first
    ``max_schedules`` schedules in deterministic DFS order all hold"
    — the honest claim for composites whose full space is beyond
    exhaustive reach (the 4-rank two-tier pod, the 2x2 halo), where
    exceeding the budget is the expected outcome, not a test bug. A
    truncating budget is never silent: the returned count has
    ``truncated=True`` and a ``RuntimeWarning`` states how much of the
    space the run actually covered.
    """

    class _Replay(Strategy):
        def __init__(self, prefix: List):
            self.prefix = list(prefix)
            self.trace: List = []
            self.branch_points: List[Tuple[int, List]] = []

        def pick(self, choices):
            choices = sorted(choices)
            i = len(self.trace)
            if i < len(self.prefix):
                choice = self.prefix[i]
                if choice not in choices:
                    raise ProtocolError(
                        "schedule replay diverged; simulator is "
                        "nondeterministic beyond scheduler choice"
                    )
            else:
                choice = choices[0]
                if len(choices) > 1:
                    self.branch_points.append((i, choices[1:]))
            self.trace.append(choice)
            return choice

    stack: List[List] = [[]]
    explored = 0
    while stack:
        prefix = stack.pop()
        strategy = _Replay(prefix)
        RingSimulator(make_generators(), strategy, coarse=True).run()
        explored += 1
        if explored >= max_schedules:
            if allow_budget:
                # "no silent caps": the pending frontier bounds what
                # was NOT covered — say so loudly instead of letting a
                # capped DFS read as full coverage
                frontier = len(stack) + sum(
                    len(alts) for i, alts in strategy.branch_points
                    if i >= len(prefix)
                )
                if frontier:
                    import warnings

                    warnings.warn(
                        f"explore_all_schedules: budget of "
                        f"{max_schedules} truncated the space after "
                        f"{explored} schedules; >= "
                        f"{explored + frontier} exist ({frontier} "
                        f"unexplored branch prefixes remain) — the "
                        f"verified claim is 'the first {explored} "
                        f"schedules in DFS order hold', NOT full "
                        f"coverage",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                return ScheduleCount(explored, truncated=bool(frontier),
                                     frontier=frontier)
            raise ProtocolError(
                f"exploration budget exceeded ({max_schedules} schedules)"
            )
        for i, alternatives in strategy.branch_points:
            if i >= len(prefix):  # only branch beyond the replayed prefix
                for alt in alternatives:
                    stack.append(strategy.trace[:i] + [alt])
    return ScheduleCount(explored)


# ---------------------------------------------------------------------------
# Convenience harnesses
# ---------------------------------------------------------------------------


def _maybe_verified(gens: Sequence[Iterator], verified: bool):
    """Wrap each rank in the verified-transport framing when asked —
    the harness knob that decides whether payload tampering surfaces
    as a named IntegrityError (framed) or as silently wrong delivery
    (bare transport, caught only by the harness's output check)."""
    if not verified:
        return list(gens)
    return [verified_steps(gen, r) for r, gen in enumerate(gens)]


def simulate_all_gather(n: int, strategy: Strategy,
                        flow_control: bool = True, faults=None,
                        verified: bool = False, recorder=None) -> None:
    gens = [
        all_gather_rank(r, n, f"chunk{r}", flow_control=flow_control)
        for r in range(n)
    ]
    outputs = RingSimulator(
        _maybe_verified(gens, verified), strategy, faults=faults,
        recorder=recorder,
    ).run()
    expected = {i: f"chunk{i}" for i in range(n)}
    for r in range(n):
        if outputs[r] != expected:
            raise ProtocolError(
                f"rank {r} gathered {outputs[r]}, wanted {expected}"
            )


def simulate_all_reduce(n: int, strategy: Strategy,
                        flow_control: bool = True, faults=None,
                        verified: bool = False,
                        costs: Optional[TierCostModel] = None,
                        recorder=None) -> float:
    gens = [
        all_reduce_rank(r, n, frozenset([r]), lambda a, b: a | b,
                        flow_control=flow_control)
        for r in range(n)
    ]
    sim = RingSimulator(
        _maybe_verified(gens, verified), strategy, faults=faults,
        costs=costs, recorder=recorder,
    )
    outputs = sim.run()
    want = frozenset(range(n))
    for r in range(n):
        if outputs[r] != {0: want}:
            raise ProtocolError(f"rank {r} reduced {outputs[r]}, wanted {want}")
    return sim.elapsed_seconds()


def simulate_all_reduce_chunked(n: int, chunks: int, strategy: Strategy,
                                flow_control: bool = True, faults=None,
                                verified: bool = False,
                                recorder=None) -> None:
    """Chunked pipelined all-reduce harness: rank ``r`` contributes
    ``frozenset({(r, c)})`` per chunk ``c``; every rank must finish
    holding the full per-chunk union — wrong delivery in ANY pipeline
    chunk is a :class:`ProtocolError`."""
    gens = [
        all_reduce_chunked_rank(
            r, n, [frozenset([(r, c)]) for c in range(chunks)],
            lambda a, b: a | b, flow_control=flow_control,
        )
        for r in range(n)
    ]
    outputs = RingSimulator(
        _maybe_verified(gens, verified), strategy, faults=faults,
        recorder=recorder,
    ).run()
    want = {
        c: frozenset((src, c) for src in range(n)) for c in range(chunks)
    }
    for r in range(n):
        if outputs[r] != want:
            raise ProtocolError(
                f"rank {r} reduced {outputs[r]}, wanted {want}"
            )


def simulate_reduce_scatter(n: int, strategy: Strategy,
                            flow_control: bool = True,
                            faults=None, verified: bool = False,
                            recorder=None) -> None:
    gens = [
        reduce_scatter_rank(
            r, n, [frozenset([(r, b)]) for b in range(n)],
            lambda a, b: a | b, flow_control=flow_control,
        )
        for r in range(n)
    ]
    outputs = RingSimulator(
        _maybe_verified(gens, verified), strategy, faults=faults,
        recorder=recorder,
    ).run()
    for r in range(n):
        want = frozenset((src, r) for src in range(n))
        if outputs[r] != {r: want}:
            raise ProtocolError(
                f"rank {r} got {outputs[r]}, wanted {want}"
            )


def allreduce_pod_generators(slices: int, per_slice: int,
                             flow_control: bool = True):
    """Per-rank two-tier allreduce programs with the standard symbolic
    contributions: rank ``g`` contributes ``frozenset({(g, c)})`` per
    block ``c``."""
    n = slices * per_slice
    return [
        allreduce_pod_rank(
            g, slices, per_slice,
            [frozenset([(g, c)]) for c in range(per_slice)],
            lambda a, b: a | b, flow_control=flow_control,
        )
        for g in range(n)
    ]


def simulate_allreduce_pod(slices: int, per_slice: int, strategy: Strategy,
                           flow_control: bool = True, faults=None,
                           verified: bool = False,
                           costs: Optional[TierCostModel] = None,
                           recorder=None) -> float:
    """Fuzz one schedule of the two-tier pod allreduce and verify that
    every rank holds the full per-block reduction — wrong delivery in
    ANY block of ANY phase is a :class:`ProtocolError`. Returns the
    simulated wall-clock (0.0 without a cost model)."""
    n = slices * per_slice
    sim = RingSimulator(
        _maybe_verified(
            allreduce_pod_generators(slices, per_slice, flow_control),
            verified,
        ),
        strategy, faults=faults, costs=costs, recorder=recorder,
    )
    outputs = sim.run()
    want = {
        c: frozenset((g, c) for g in range(n))
        for c in range(per_slice)
    }
    for g in range(n):
        if outputs[g] != want:
            raise ProtocolError(
                f"rank {g} reduced {outputs[g]}, wanted {want}"
            )
    return sim.elapsed_seconds()


def pod_wallclock_comparison(slices: int, per_slice: int,
                             payload_bytes: float, seed: int = 0,
                             ici: Optional[LinkCost] = None,
                             dcn: Optional[LinkCost] = None) -> Dict:
    """Same allreduce payload, flat ring vs two-tier pod protocol, on
    the same deterministic schedule seed and wire rates.

    The flat circulating ring moves the FULL payload per message and
    its rank order makes two wires per lap cross slices (between slice
    boundaries and on the wrap); the pod protocol's every message is a
    ``payload / per_slice`` shard and only phase B touches DCN. Both
    runs must deliver the identical reduction — the bit-identity half
    of the claim — and the returned dict carries the two makespans for
    the perf half. Deterministic per (shape, payload, seed, rates).
    """
    n = slices * per_slice
    flat_costs = default_tier_costs(payload_bytes, per_slice,
                                    ici=ici, dcn=dcn)
    hier_costs = default_tier_costs(payload_bytes / per_slice, per_slice,
                                    ici=ici, dcn=dcn)
    # flat: every rank contributes ALL its blocks in one payload
    flat_gens = [
        all_reduce_rank(
            g, n, frozenset((g, c) for c in range(per_slice)),
            lambda a, b: a | b,
        )
        for g in range(n)
    ]
    flat_sim = RingSimulator(flat_gens, Strategy(seed), costs=flat_costs)
    flat_out = flat_sim.run()
    want = frozenset(
        (g, c) for g in range(n) for c in range(per_slice)
    )
    for g in range(n):
        if flat_out[g] != {0: want}:
            raise ProtocolError(
                f"flat rank {g} reduced {flat_out[g]}, wanted {want}"
            )
    hier_sim = RingSimulator(
        allreduce_pod_generators(slices, per_slice),
        Strategy(seed), costs=hier_costs,
    )
    hier_out = hier_sim.run()
    want_blocks = {
        c: frozenset((g, c) for g in range(n))
        for c in range(per_slice)
    }
    for g in range(n):
        if hier_out[g] != want_blocks:
            raise ProtocolError(
                f"pod rank {g} reduced {hier_out[g]}, "
                f"wanted {want_blocks}"
            )
    return {
        "slices": slices,
        "per_slice": per_slice,
        "payload_bytes": payload_bytes,
        "flat_s": flat_sim.elapsed_seconds(),
        "hierarchical_s": hier_sim.elapsed_seconds(),
    }


def _q_encode(v):
    """The harness wire codec: tag every element — content-addressed,
    so the delivery check proves the codec round-tripped through every
    hop (wrong bits OR a skipped decode both fail)."""
    return frozenset(("q8", e) for e in v)


def _q_decode(w):
    """Inverse of :func:`_q_encode`, type-preserving under in-flight
    damage: an element that is not a recognized tag (a bitflipped
    marker, a truncated pair) decodes to itself, so bare-transport
    corruption COMPLETES with wrong delivery — the silent-corruption
    outcome the framing exists to catch — instead of crashing."""
    return frozenset(
        e[1] if isinstance(e, tuple) and len(e) == 2 and e[0] == "q8"
        else e
        for e in w
    )


def all_reduce_quantized_generators(slices: int, per_slice: int,
                                    flow_control: bool = True):
    """Per-rank quantized two-tier allreduce programs with the standard
    symbolic contributions under the tagging wire codec."""
    n = slices * per_slice
    return [
        all_reduce_quantized_rank(
            g, slices, per_slice,
            [frozenset([(g, c)]) for c in range(per_slice)],
            lambda a, b: a | b, _q_encode, _q_decode,
            flow_control=flow_control,
        )
        for g in range(n)
    ]


def simulate_all_reduce_quantized(slices: int, per_slice: int,
                                  strategy: Strategy,
                                  flow_control: bool = True, faults=None,
                                  verified: bool = False,
                                  costs: Optional[TierCostModel] = None,
                                  recorder=None) -> float:
    """Fuzz one schedule of the quantized pod allreduce and verify that
    every rank's DECODED outputs hold the full per-block reduction —
    wrong delivery in any block, or a codec that failed to round-trip,
    is a :class:`ProtocolError`. Returns the simulated wall-clock."""
    n = slices * per_slice
    sim = RingSimulator(
        _maybe_verified(
            all_reduce_quantized_generators(slices, per_slice,
                                            flow_control),
            verified,
        ),
        strategy, faults=faults, costs=costs, recorder=recorder,
    )
    outputs = sim.run()
    want = {
        c: frozenset((g, c) for g in range(n))
        for c in range(per_slice)
    }
    for g in range(n):
        if outputs[g] != want:
            raise ProtocolError(
                f"rank {g} reduced {outputs[g]}, wanted {want}"
            )
    return sim.elapsed_seconds()


def _sparse_bundle(src: int):
    """The standard symbolic sparse contribution: one opaque
    (index, value) bundle, content-addressed per source."""
    return (("idx", src), ("val", src))


def all_reduce_sparse_generators(n: int, flow_control: bool = True):
    """Per-rank sparse allreduce programs with the standard bundles.
    The local ``combine`` is the identity on the gathered tuple — the
    harness's delivery check addresses every bundle by content, so
    wrong routing and wrong bits both fail."""
    return [
        all_reduce_sparse_rank(r, n, _sparse_bundle(r), lambda bs: bs,
                               flow_control=flow_control)
        for r in range(n)
    ]


def simulate_all_reduce_sparse(n: int, strategy: Strategy,
                               flow_control: bool = True, faults=None,
                               verified: bool = False,
                               costs: Optional[TierCostModel] = None,
                               recorder=None) -> float:
    """Fuzz one schedule of the sparse allreduce and verify that every
    rank gathered every source's bundle in source order — a missing,
    damaged, or misrouted bundle is a :class:`ProtocolError`. Returns
    the simulated wall-clock."""
    sim = RingSimulator(
        _maybe_verified(
            all_reduce_sparse_generators(n, flow_control), verified
        ),
        strategy, faults=faults, costs=costs, recorder=recorder,
    )
    outputs = sim.run()
    want = {0: tuple(_sparse_bundle(src) for src in range(n))}
    for r in range(n):
        if outputs[r] != want:
            raise ProtocolError(
                f"rank {r} reduced {outputs[r]}, wanted {want}"
            )
    return sim.elapsed_seconds()


def quantized_wallclock_comparison(slices: int, per_slice: int,
                                   payload_bytes: float,
                                   precision: str = "int8",
                                   seed: int = 0,
                                   ici: Optional[LinkCost] = None,
                                   dcn: Optional[LinkCost] = None) -> Dict:
    """Same two-tier allreduce, f32 wire vs quantized wire, on the same
    deterministic schedule seed and rates — the r19 A/B vector.

    Both runs are the pod composition at ``payload/per_slice`` shard
    granularity; the quantized run's every wire message is scaled by
    :data:`PRECISION_WIRE_RATIO` through the per-tier ``ici_bytes`` /
    ``dcn_bytes`` (the PR-12 sizing), and its protocol is
    ``all_reduce_quantized`` — codec applied, delivery verified
    per-block against the identical reduction the f32 run must also
    deliver. The dict carries the two makespans plus each run's
    analytic DCN-phase wall-clock ((slices-1) crossings of the shard
    at the tier's alpha-beta) — the phase the beta attack targets.
    Deterministic per (shape, payload, precision, seed, rates)."""
    if precision not in PRECISION_WIRE_RATIO:
        raise ValueError(
            f"unknown precision {precision!r}; known: "
            f"{sorted(PRECISION_WIRE_RATIO)}"
        )
    ratio = PRECISION_WIRE_RATIO[precision]
    shard = payload_bytes / per_slice
    f32_costs = default_tier_costs(shard, per_slice, ici=ici, dcn=dcn)
    q_costs = default_tier_costs(
        shard * ratio, per_slice, ici=ici, dcn=dcn,
        ici_bytes=shard * ratio, dcn_bytes=shard * ratio,
    )
    n = slices * per_slice
    want = {
        c: frozenset((g, c) for g in range(n))
        for c in range(per_slice)
    }
    f32_sim = RingSimulator(
        allreduce_pod_generators(slices, per_slice),
        Strategy(seed), costs=f32_costs,
    )
    f32_out = f32_sim.run()
    for g in range(n):
        if f32_out[g] != want:
            raise ProtocolError(
                f"f32 rank {g} reduced {f32_out[g]}, wanted {want}"
            )
    q_sim = RingSimulator(
        all_reduce_quantized_generators(slices, per_slice),
        Strategy(seed), costs=q_costs,
    )
    q_out = q_sim.run()
    for g in range(n):
        if q_out[g] != want:
            raise ProtocolError(
                f"quantized rank {g} reduced {q_out[g]}, wanted {want}"
            )

    def dcn_phase(costs: TierCostModel) -> float:
        if slices < 2:
            return 0.0
        # one rank's phase-B lap: (slices - 1) steps, each one DCN
        # crossing of the shard at the slow tier's alpha + bytes/beta
        return (slices - 1) * costs.dma_seconds(0, per_slice)

    return {
        "slices": slices,
        "per_slice": per_slice,
        "payload_bytes": payload_bytes,
        "precision": precision,
        "f32_s": f32_sim.elapsed_seconds(),
        "quantized_s": q_sim.elapsed_seconds(),
        "f32_dcn_s": dcn_phase(f32_costs),
        "quantized_dcn_s": dcn_phase(q_costs),
    }


def _alltoall_block(src: int, dst: int) -> str:
    """The standard symbolic all-to-all payload: content-addressed per
    (source, destination), so wrong routing OR wrong bits both fail
    the delivery check."""
    return f"b{src}->{dst}"


def all_to_all_generators(n: int, variant: str = "pairwise",
                          flow_control: bool = True):
    """Per-rank flat all-to-all programs with the standard blocks."""
    if variant == "pairwise":
        rank_fn = all_to_all_rank
    elif variant == "bruck":
        if n < 1 or (n & (n - 1)):
            # eager (factory-time) refusal: generators raise lazily,
            # and a non-power-of-two Bruck request must fail before a
            # harness starts consuming rank sequences
            raise ValueError(
                f"all_to_all_bruck needs a power-of-two rank count, "
                f"got n={n}"
            )
        rank_fn = all_to_all_bruck_rank
    else:
        raise ValueError(
            f"unknown all_to_all variant {variant!r}; known: "
            f"pairwise, bruck (the pod variant builds through "
            f"all_to_all_pod_generators)"
        )
    return [
        rank_fn(r, n, [_alltoall_block(r, d) for d in range(n)],
                flow_control=flow_control)
        for r in range(n)
    ]


def simulate_all_to_all(n: int, strategy: Strategy,
                        variant: str = "pairwise",
                        flow_control: bool = True, faults=None,
                        verified: bool = False,
                        costs: Optional[TierCostModel] = None,
                        recorder=None) -> float:
    """Fuzz one schedule of a flat all-to-all variant and verify that
    every rank received exactly its per-source blocks — wrong delivery
    from ANY source is a :class:`ProtocolError`. Returns the simulated
    wall-clock (0.0 without a cost model)."""
    sim = RingSimulator(
        _maybe_verified(
            all_to_all_generators(n, variant, flow_control), verified
        ),
        strategy, faults=faults, costs=costs, recorder=recorder,
    )
    outputs = sim.run()
    for r in range(n):
        want = {src: _alltoall_block(src, r) for src in range(n)}
        if outputs[r] != want:
            raise ProtocolError(
                f"rank {r} received {outputs[r]}, wanted {want}"
            )
    return sim.elapsed_seconds()


def all_to_all_pod_generators(slices: int, per_slice: int,
                              flow_control: bool = True):
    """Per-rank two-tier all-to-all programs with the standard blocks."""
    n = slices * per_slice
    return [
        all_to_all_pod_rank(
            g, slices, per_slice,
            [_alltoall_block(g, d) for d in range(n)],
            flow_control=flow_control,
        )
        for g in range(n)
    ]


def simulate_all_to_all_pod(slices: int, per_slice: int,
                            strategy: Strategy,
                            flow_control: bool = True, faults=None,
                            verified: bool = False,
                            costs: Optional[TierCostModel] = None,
                            recorder=None) -> float:
    """Fuzz one schedule of the two-tier pod all-to-all and verify
    delivery: every rank must hold, per source slice, the bundle of
    that slice's blocks for it (the bundles' concatenation IS the flat
    per-source delivery). Returns the simulated wall-clock."""
    n = slices * per_slice
    sim = RingSimulator(
        _maybe_verified(
            all_to_all_pod_generators(slices, per_slice, flow_control),
            verified,
        ),
        strategy, faults=faults, costs=costs, recorder=recorder,
    )
    outputs = sim.run()
    for g in range(n):
        want = {
            ("slice", t): tuple(
                _alltoall_block(t * per_slice + j, g)
                for j in range(per_slice)
            )
            for t in range(slices)
        }
        if outputs[g] != want:
            raise ProtocolError(
                f"rank {g} received {outputs[g]}, wanted {want}"
            )
    return sim.elapsed_seconds()


def alltoall_wallclock_comparison(slices: int, per_slice: int,
                                  block_bytes: float, seed: int = 0,
                                  ici: Optional[LinkCost] = None,
                                  dcn: Optional[LinkCost] = None) -> Dict:
    """Same all-to-all traffic, flat pairwise vs the two-tier pod
    variant, on the same deterministic schedule seed and wire rates.

    The flat pairwise exchange sends one ``block_bytes`` message per
    (source, destination) pair — ``per_slice * (slices - 1)`` of a
    rank's ``n - 1`` messages cross DCN, each paying the DCN alpha.
    The pod variant's ICI messages stay at block granularity but its
    DCN crossings are ``slices - 1`` bundles of ``per_slice`` blocks —
    the alpha amortization the hierarchy exists for. Both runs must
    deliver the identical routing (each against its own delivery
    contract — the bundles' concatenation is the flat delivery); the
    returned dict carries the two makespans. Deterministic per
    (shape, block size, seed, rates)."""
    n = slices * per_slice
    flat_costs = default_tier_costs(block_bytes, per_slice,
                                    ici=ici, dcn=dcn)
    flat_s = simulate_all_to_all(n, Strategy(seed), costs=flat_costs)
    pod_costs = default_tier_costs(
        block_bytes, per_slice, ici=ici, dcn=dcn,
        ici_bytes=block_bytes, dcn_bytes=per_slice * block_bytes,
    )
    pod_s = simulate_all_to_all_pod(slices, per_slice, Strategy(seed),
                                    costs=pod_costs)
    return {
        "slices": slices,
        "per_slice": per_slice,
        "block_bytes": block_bytes,
        "pairwise_s": flat_s,
        "hierarchical_s": pod_s,
    }


def alltoall_variant_wallclocks(n: int, block_bytes: float,
                                seed: int = 0,
                                ici: Optional[LinkCost] = None) -> Dict:
    """Pairwise vs Bruck on one single-tier ring at one block size.

    Pairwise pays ``n - 1`` message alphas at block granularity; Bruck
    pays ``log2(n)`` round alphas at ``n/2``-block aggregate
    granularity (each round's copies are priced at the coalesced
    message a real kernel sends). Small blocks are alpha-bound — Bruck
    wins; large blocks are volume-bound — pairwise's ``(n-1) * b``
    total beats Bruck's ``log2(n) * n/2 * b``. Deterministic per
    (n, block size, seed, rates); ``n`` must be a power of two."""
    pair_costs = default_tier_costs(block_bytes, 0, ici=ici)
    pairwise_s = simulate_all_to_all(n, Strategy(seed),
                                     costs=pair_costs)
    bruck_costs = default_tier_costs(n * block_bytes / 2.0, 0, ici=ici)
    bruck_s = simulate_all_to_all(n, Strategy(seed), variant="bruck",
                                  costs=bruck_costs)
    return {
        "n": n,
        "block_bytes": block_bytes,
        "pairwise_s": pairwise_s,
        "bruck_s": bruck_s,
    }


def simulate_neighbour_stream(n: int, chunks: int, strategy: Strategy,
                              direction: int = 1,
                              flow_control: bool = True,
                              faults=None,
                              verified: bool = False,
                              recorder=None) -> None:
    gens = [
        neighbour_stream_rank(
            r, n, [(r, c) for c in range(chunks)],
            direction=direction, flow_control=flow_control,
        )
        for r in range(n)
    ]
    outputs = RingSimulator(
        _maybe_verified(gens, verified), strategy, faults=faults,
        recorder=recorder,
    ).run()
    for r in range(n):
        upstream = (r - direction) % n
        want = {c: (upstream, c) for c in range(chunks)}
        if outputs[r] != want:
            raise ProtocolError(
                f"rank {r} received {outputs[r]}, wanted {want}"
            )
