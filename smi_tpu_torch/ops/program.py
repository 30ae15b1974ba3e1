"""Per-rank program metadata: validation and stream allocation.

Reference parity: ``codegen/program.py``. A *program* is the set of
communication operations one rank executes. The reference validates port
uniqueness, then round-robins each op's hardware ports across the FPGA's 4
physical QSFP channels per usage class (``codegen/program.py:53-80``,
``codegen/notes.txt``). Here one card (or NVLink) is the physical substrate and nothing is
routed by hand, but the allocation layer survives with a new
meaning: logical ports are assigned to a small number of *streams* —
independent communication contexts that the runtime may overlap (concurrent
collectives on distinct ports land on distinct streams, mirroring
``multi_collectives.cl``'s overlap guarantee).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from smi_tpu_torch.ops.operations import (
    ALL_STREAM_KEYS,
    COLLECTIVE_FAMILIES,
    IN_CTRL,
    IN_DATA,
    OUT_CTRL,
    OUT_DATA,
    P2P_FAMILIES,
    SmiOperation,
)

#: Streams per device. The reference has 4 physical QSFP channels per FPGA
#: (``codegen/program.py:9``); 4 keeps the allocation semantics aligned
#: with the reference test suite, and is the number of flag domains the
#: ring kernels own (``kernels/ring.py::RING_STREAMS``).
STREAMS_PER_DEVICE = 4


def round_robin(values: Sequence, index: int, size: int) -> List:
    """``values[index::size]`` — reference ``codegen/utils.py:5-10``."""
    return list(values[index::size])


class PortConflict(ValueError):
    """Two operations of one family claim the same logical port."""


@dataclasses.dataclass(frozen=True, order=True)
class Device:
    """A physical device slot: host node + index on that node.

    Reference ``FPGA`` (``codegen/program.py``), addressed "node:index"
    (e.g. ``fpga-0015:1``). Here node = host, index = local card index.
    """

    node: str
    index: int

    @property
    def key(self) -> Tuple[str, int]:
        return (self.node, self.index)

    def __str__(self) -> str:
        return f"{self.node}:{self.index}"

    @classmethod
    def parse(cls, text: str) -> "Device":
        """Parse ``node:index``. The index component may be a bare integer
        (``host-a:1``) or carry a device-name prefix as in the reference's
        topology files (``fpga-0001:acl1`` → index 1)."""
        node, _, idx = text.rpartition(":")
        if not node:
            raise ValueError(f"device must be 'node:index', got {text!r}")
        digits = "".join(ch for ch in idx if ch.isdigit())
        if not digits:
            raise ValueError(f"device index must contain digits, got {text!r}")
        return cls(node=node, index=int(digits))


class Program:
    """A validated set of operations plus communication tuning flags.

    Flags mirror the reference codegen CLI (``codegen/main.py:40-43``):

    - ``consecutive_reads``: reference CK fairness bound (``READS_LIMIT``,
      ``templates/device.cl:13-14``); here it bounds how many chunks a
      streamed transfer may burst before yielding the stream.
    - ``max_ranks``: upper bound on communicator size the program is
      compiled for (sizes buffers in the reference; sizes masks here).
    - ``p2p_rendezvous``: reference credit-based rendezvous vs eager
      protocol (``templates/push.cl:21-31``); here, True bounds in-flight
      chunks of a streamed P2P transfer to the channel's pipeline depth
      (back-pressure), False streams eagerly.
    """

    def __init__(
        self,
        operations: Sequence[SmiOperation],
        consecutive_reads: int = 8,
        max_ranks: int = 8,
        p2p_rendezvous: bool = True,
        num_streams: int = STREAMS_PER_DEVICE,
    ):
        # Canonical port order for the exposed tuple (the reference sorts at
        # init, codegen/program.py:103). allocate_ports owns the deal-order
        # invariant and re-sorts defensively for direct callers; on this
        # already-sorted input that re-sort is O(n).
        self.operations: Tuple[SmiOperation, ...] = tuple(
            sorted(operations, key=lambda op: op.port)
        )
        self.consecutive_reads = consecutive_reads
        self.max_ranks = max_ranks
        self.p2p_rendezvous = p2p_rendezvous
        self.num_streams = num_streams
        self._validate()
        self._allocation = allocate_ports(
            self.operations, num_streams=num_streams,
            p2p_rendezvous=p2p_rendezvous,
        )

    def _validate(self) -> None:
        """Port-uniqueness per stream class (``codegen/program.py:37-50``).

        Two ops may not claim the same logical port within one stream
        class: Push(0)+Push(0) conflict on out-data, and Push(0)+
        Broadcast(0) conflict too (the broadcast also sends on port 0) —
        while Push(0)+Pop(0), two ends of one channel, touch disjoint
        classes and are fine.
        """
        for key in ALL_STREAM_KEYS:
            seen: Dict[int, SmiOperation] = {}
            for op in self.operations:
                if key not in op.streams(self.p2p_rendezvous):
                    continue
                if op.port in seen:
                    raise PortConflict(
                        f"port {op.port} claimed twice on stream class "
                        f"{key!r}: {seen[op.port]} vs {op}"
                    )
                seen[op.port] = op

    @property
    def logical_port_count(self) -> int:
        """Number of logical ports (sizes routing tables); minimum 1 as in
        the reference (``codegen/program.py:107`` ``max(..., default=0)+1``)
        so even idle MPMD ranks get non-empty tables the bootstrap accepts.
        """
        return max((op.port for op in self.operations), default=0) + 1

    def operations_of_family(self, *families: str) -> List[SmiOperation]:
        fams = families or (P2P_FAMILIES + COLLECTIVE_FAMILIES)
        return [op for op in self.operations if op.family in fams]

    def find(self, family: str, port: int) -> Optional[SmiOperation]:
        for op in self.operations:
            if op.family == family and op.port == port:
                return op
        return None

    def stream_of(self, op: SmiOperation, stream_key: str) -> int:
        """Which stream this op's ``stream_key`` usage was assigned to."""
        return self._allocation.stream_of[(op.family, op.port, stream_key)]

    @property
    def allocation(self) -> Dict[Tuple[str, int, str], int]:
        return dict(self._allocation.stream_of)

    def stream_allocations(self, stream: int) -> List[Tuple[str, int, str]]:
        """Ordered (family, port, key) usages dealt to one stream — the
        reference's ``get_channel_allocations`` (``program.py:113-114``).
        Order is load-bearing: ingress tables number local op slots by it.
        """
        return list(self._allocation.per_stream.get(stream, ()))


@dataclasses.dataclass
class Allocation:
    """Result of dealing stream-usages onto streams."""

    stream_of: Dict[Tuple[str, int, str], int]
    per_stream: Dict[int, List[Tuple[str, int, str]]]


#: Combined deal order per direction (``codegen/notes.txt`` "Data and
#: control hardware ports are combined (in this order) and then
#: distributed"; ``codegen/program.py:58-80``).
OUT_KEYS = (OUT_DATA, OUT_CTRL)
IN_KEYS = (IN_DATA, IN_CTRL)


def allocate_ports(
    operations: Sequence[SmiOperation],
    num_streams: int = STREAMS_PER_DEVICE,
    p2p_rendezvous: bool = True,
) -> Allocation:
    """Deal op stream-usages onto ``num_streams`` streams, reference-style.

    Per direction (out/in), the data usages of all ops (in port order) are
    concatenated with the control usages, and that combined list is dealt
    round-robin: usage *i* lands on stream ``i % num_streams``. This exactly
    reproduces the reference's channel distribution
    (``codegen/program.py:53-80``) so stream indices — and therefore the
    routing tables derived from them — match bit-for-bit.
    """
    ops_sorted = sorted(operations, key=lambda op: op.port)
    stream_of: Dict[Tuple[str, int, str], int] = {}
    per_stream: Dict[int, List[Tuple[str, int, str]]] = {
        s: [] for s in range(num_streams)
    }
    for direction in (OUT_KEYS, IN_KEYS):
        combined = [
            (op.family, op.port, key)
            for key in direction
            for op in ops_sorted
            if key in op.streams(p2p_rendezvous)
        ]
        for i, usage in enumerate(combined):
            stream = i % num_streams
            stream_of[usage] = stream
            per_stream[stream].append(usage)
    return Allocation(stream_of=stream_of, per_stream=per_stream)


def combined_program(mapping: "ProgramMapping") -> Program:
    """Union of every rank's program, for one SPMD trace.

    The reference runs genuinely different bitstreams per rank (MPMD via
    the routing file's program map, ``bandwidth.json``) and its ``route``
    step loads *all* program metadata together to build consistent
    tables (``codegen/main.py:107-133``). Under SPMD one program is
    traced for all ranks, so the equivalent is the union of the per-rank
    operation sets: complementary endpoints (rank 0's ``Push(0)``, rank
    1's ``Pop(0)``) combine into one valid program, while genuine
    conflicts (two ranks both claiming ``Push(0)`` with different
    dtypes) fail the joint validation exactly as the reference's
    routing-table generator would reject them.

    Tuning flags must agree on ``p2p_rendezvous`` (it changes the wire
    protocol); ``consecutive_reads``/``max_ranks`` take the maximum.
    """
    programs = [p for p in mapping.programs if p is not None]
    if not programs:
        raise ValueError("mapping contains no programs")
    rendezvous = {p.p2p_rendezvous for p in programs}
    if len(rendezvous) > 1:
        raise ValueError(
            "MPMD programs disagree on p2p_rendezvous; the protocol must "
            "be uniform across ranks"
        )
    # dedup by the full operation value (frozen dataclass): identical
    # declarations merge (SPMD), while ops differing in ANY field — dtype,
    # buffer size, reduce operator — both reach the joint validation
    seen = dict.fromkeys(
        op for program in programs for op in program.operations
    )
    return Program(
        list(seen),
        consecutive_reads=max(p.consecutive_reads for p in programs),
        max_ranks=max(p.max_ranks for p in programs),
        p2p_rendezvous=rendezvous.pop(),
    )


@dataclasses.dataclass
class ProgramMapping:
    """Which program each device runs (SPMD: all the same; MPMD: differ).

    Reference: the routing file's ``"fpgas"`` program map
    (``codegen/serialization.py:65-109``), which lets e.g. the bandwidth
    benchmark run a sender program on rank 0 and a receiver program on
    rank 1 (``microbenchmarks/kernels/bandwidth.json``).
    """

    programs: List[Program]
    device_to_program: Dict[Device, Program]

    def program_for(self, device: Device) -> Program:
        return self.device_to_program[device]

    @property
    def devices(self) -> List[Device]:
        """Deterministic rank order: sorted by (node, index).

        Reference: ``codegen/routing.py:61-69`` sorts by the same key so
        rank numbering is reproducible across runs.
        """
        return sorted(self.device_to_program, key=lambda d: d.key)

    def rank_of(self, device: Device) -> int:
        return self.devices.index(device)
