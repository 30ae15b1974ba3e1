"""Routing layer: topology graph, egress/ingress tables, load balancing.

PyTorch counterpart of :mod:`smi_tpu.parallel.routing`, table for table.
The reference (``codegen/routing.py`` + ``codegen/routing_table.py``)
compiles, per device and per physical channel, two lookup tables that
drive its packet-switched NoC:

- the CKS (egress) table maps ``(dst_rank, port)`` to {0 = out the wire,
  1 = deliver locally, 2+k = hand to the k-th sibling channel}, built from
  all-pairs shortest paths and then *balanced* so equal-cost routes spread
  across the links by occupancy (``routing_table.py:150-202``);
- the CKR (ingress) table maps ``(port, data|control)`` to {0 = bounce to
  egress, 1+k = sibling ingress, N+j = j-th local op slot}
  (``routing_table.py:205-234``).

On a card the transport routes (NVLink, or the rendezvous of a thread
world) and none of this is needed for correctness. The layer is kept at
full fidelity because its binary artifacts are the reference's (the
same program, topology and failure set give the same
:func:`serialize_table` bytes as the JAX package), and because degraded
routing around a :class:`FailureSet` is what a regrow with a topology
checks (:meth:`~smi_tpu_torch.parallel.mesh.Communicator.regrow`).

The graph is solved by ``networkx``, which is imported inside the
functions that build it: the error classes and :class:`FailureSet` load
with the package, and the rest is a CPU tool for a host that has
``networkx``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple

from smi_tpu_torch.ops.operations import IN_CTRL, IN_DATA, OUT_CTRL, OUT_DATA
from smi_tpu_torch.ops.program import Device, Program
from smi_tpu_torch.ops.serialization import Topology

#: Edge weights (``codegen/program.py:7-8``): hopping between devices is
#: two orders costlier than moving between links inside one device.
COST_INTER_DEVICE = 100
COST_INTRA_DEVICE = 1

#: Links (physical channels) per device (``CHANNELS_PER_FPGA = 4``).
LINKS_PER_DEVICE = 4

#: Egress table target codes (``routing_table.py:9-10,125-140``).
EGRESS_WIRE = 0    # leave the device through this link's physical wire
EGRESS_LOCAL = 1   # deliver to this link's ingress side (same device)
# 2 + sibling_index(...)  = forward to a sibling link's egress


class NoRouteFound(Exception):
    """No path exists between two devices in the topology graph."""


class RouteCutError(NoRouteFound):
    """A route exists in the healthy topology but the excluded
    links/devices cut it. ``cut`` names the exclusion set responsible —
    the reference's static tables have no answer to this (a compiled
    CKS entry points at a dead wire forever); this layer recomputes
    around the failure and names the cut when it cannot."""

    def __init__(self, message: str, cut: "FailureSet"):
        super().__init__(message)
        self.cut = cut


@dataclasses.dataclass(frozen=True)
class FailureSet:
    """Failed hardware to route around.

    ``links`` are wire *endpoints* ``(device, link_index)`` — excluding
    either endpoint takes the whole physical wire down (both directions;
    a dead link is dead both ways). ``devices`` are whole
    devices: their wires go down and nothing may transit them, but they
    KEEP their rank slot — table shape and rank numbering must stay
    stable so healthy ranks' tables remain valid (shrinking the rank
    space itself is :meth:`Communicator.shrink`'s job).
    """

    links: frozenset = frozenset()    # of (Device, link_index)
    devices: frozenset = frozenset()  # of Device

    def __post_init__(self):
        object.__setattr__(self, "links", frozenset(self.links))
        object.__setattr__(self, "devices", frozenset(self.devices))

    @property
    def empty(self) -> bool:
        return not self.links and not self.devices

    def wire_down(self, a: Link, b: Link) -> bool:
        """Is the physical wire between endpoints ``a`` and ``b`` down?"""
        for end in (a, b):
            if end.device in self.devices:
                return True
            if (end.device, end.index) in self.links:
                return True
        return False

    def __str__(self) -> str:
        parts = []
        if self.links:
            parts.append(
                "links {"
                + ", ".join(
                    sorted(f"{d}:ch{i}" for d, i in self.links)
                )
                + "}"
            )
        if self.devices:
            parts.append(
                "devices {" + ", ".join(sorted(map(str, self.devices))) + "}"
            )
        return " + ".join(parts) if parts else "(none)"


@dataclasses.dataclass(frozen=True, order=True)
class Link:
    """One physical link endpoint of a device."""

    device: Device
    index: int

    def __str__(self) -> str:
        return f"{self.device}:ch{self.index}"


def sibling_index(source: int, target: int) -> int:
    """Index of ``target`` among a device's links with ``source`` skipped.

    The inter-link forwarding convention (``codegen/program.py:163-169``):
    a link never addresses itself, so sibling numbering omits it.
    """
    if source == target:
        raise ValueError("a link has no sibling index for itself")
    return target if target < source else target - 1


@dataclasses.dataclass
class RoutingContext:
    """Topology graph + all-pairs shortest paths + ranked devices.

    Reference: ``codegen/common.py`` ``RoutingContext{graph, routes,
    fpgas}`` built by ``create_routing_context`` (``routing.py:18-24``).
    """

    graph: object   # a networkx.Graph of Link nodes
    paths: Dict[Link, Dict[Link, List[Link]]]
    devices: List[Device]
    links_per_device: int = LINKS_PER_DEVICE
    topology: Optional[Topology] = None
    #: Failure set this context was built around (None = healthy).
    excluded: Optional["FailureSet"] = None

    def rank_of(self, device: Device) -> int:
        return self.devices.index(device)

    def links(self, device: Device) -> List[Link]:
        return [Link(device, i) for i in range(self.links_per_device)]


#: Memo for :func:`build_routing_context`, keyed by topology IDENTITY
#: (topologies hold dicts, so they are not hashable; the cached entry
#: pins the topology object, which keeps its ``id`` from being reused
#: while the entry lives). Bounded: oldest entry evicted past the cap.
_CONTEXT_CACHE: "Dict[Tuple[int, int, Optional[FailureSet]], Tuple[Topology, RoutingContext]]" = {}
_CONTEXT_CACHE_MAX = 16
#: build counter (cache misses), asserted on by the retrace-cache test.
_context_builds = 0


def build_routing_context(
    topology: Topology,
    links_per_device: int = LINKS_PER_DEVICE,
    excluded: Optional[FailureSet] = None,
) -> RoutingContext:
    """Build the weighted link graph and solve all-pairs shortest paths.

    Inter-device edges come from the topology's connection list; every
    device's links are additionally fully meshed at intra-device cost
    (``routing.py:49-54``) — the analog of the CK interconnect.

    ``excluded`` (a :class:`FailureSet`) builds the *degraded* context:
    down wires are omitted, down devices lose all edges (no transit) but
    keep their rank slot so table shapes and rank numbering stay stable.

    Memoized per ``(topology identity, links, failure set)``: the
    all-pairs Dijkstra is the expensive step and used to rerun on
    every call — ``egress_link_toward`` per traced program point, and
    the :class:`RouteCutError` classifier's healthy-topology rebuild
    per unroutable pair. Contexts are immutable in practice (callers
    only read), so one instance serves all of them.
    """
    global _context_builds
    key = (id(topology), links_per_device, excluded)
    hit = _CONTEXT_CACHE.get(key)
    if hit is not None and hit[0] is topology:
        return hit[1]
    ctx = _build_routing_context(topology, links_per_device, excluded)
    if len(_CONTEXT_CACHE) >= _CONTEXT_CACHE_MAX:
        _CONTEXT_CACHE.pop(next(iter(_CONTEXT_CACHE)))
    _CONTEXT_CACHE[key] = (topology, ctx)
    _context_builds += 1
    return ctx


def _build_routing_context(
    topology: Topology,
    links_per_device: int,
    excluded: Optional[FailureSet],
) -> RoutingContext:
    import networkx

    graph = networkx.Graph()
    devices = topology.devices
    known = set(devices)
    for device in devices:
        for link in (Link(device, i) for i in range(links_per_device)):
            graph.add_node(link)
    for (src_dev, src_l), (dst_dev, dst_l) in topology.connections.items():
        for dev in (src_dev, dst_dev):
            # fail loudly on pass-through devices absent from the program
            # map, as the reference does (codegen/routing.py:38 KeyError)
            if dev not in known:
                raise KeyError(
                    f"device {dev} appears in connections but has no "
                    f"program mapping"
                )
        if excluded is not None and excluded.wire_down(
            Link(src_dev, src_l), Link(dst_dev, dst_l)
        ):
            continue
        graph.add_edge(
            Link(src_dev, src_l), Link(dst_dev, dst_l), weight=COST_INTER_DEVICE
        )
    for device in devices:
        if excluded is not None and device in excluded.devices:
            continue  # a dead device forwards nothing, not even internally
        for a in range(links_per_device):
            for b in range(a + 1, links_per_device):
                graph.add_edge(
                    Link(device, a), Link(device, b), weight=COST_INTRA_DEVICE
                )
    paths = dict(networkx.all_pairs_dijkstra_path(graph, weight="weight"))
    return RoutingContext(
        graph=graph, paths=paths, devices=devices,
        links_per_device=links_per_device, topology=topology,
        excluded=excluded,
    )


def degraded_context(
    ctx: RoutingContext, excluded: FailureSet
) -> RoutingContext:
    """Rebuild a routing context with a failure set applied.

    Requires the context to carry its topology (contexts built by
    :func:`build_routing_context` from a parsed topology file do).
    """
    if ctx.topology is None:
        raise ValueError(
            "degraded routing needs the context's topology; build the "
            "context with build_routing_context(topology)"
        )
    return build_routing_context(
        ctx.topology, ctx.links_per_device, excluded=excluded
    )


def _check_stream_count(ctx: RoutingContext, program: Program) -> None:
    """Stream indices double as link indices in the tables; a mismatch
    would silently alias forward codes with local-slot codes."""
    if program.num_streams != ctx.links_per_device:
        raise ValueError(
            f"program allocated over {program.num_streams} streams but the "
            f"routing context has {ctx.links_per_device} links per device; "
            f"they must match"
        )


# ---------------------------------------------------------------------------
# Egress (CKS-equivalent) tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EgressTable:
    """``(dst_rank, port) -> target code`` for one link."""

    n_ranks: int
    n_ports: int
    data: List[List[int]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.data:
            self.data = [
                [EGRESS_WIRE] * self.n_ports for _ in range(self.n_ranks)
            ]

    def __getitem__(self, key: Tuple[int, int]) -> int:
        rank, port = key
        return self.data[rank][port]

    def __setitem__(self, key: Tuple[int, int], value: int) -> None:
        rank, port = key
        self.data[rank][port] = value

    def flat(self) -> List[int]:
        return [v for row in self.data for v in row]


def _paths_to_device(
    ctx: RoutingContext, link: Link, dst: Device
) -> List[List[Link]]:
    """All shortest full paths (source link included) from ``link`` to the
    links of ``dst``, deterministically ordered (``routing_table.py:108-122``
    analog; the source stays on the path so device-hop counting matches the
    reference's ``path_fpga_length``).

    In a degraded context (``ctx.excluded``) a missing route is
    classified: if the *healthy* topology routes the pair, the failure
    set is the cause and a :class:`RouteCutError` names it; only a
    topology that never routed the pair raises plain
    :class:`NoRouteFound`.
    """
    routes = ctx.paths.get(link, {})
    found = [
        path
        for target, path in routes.items()
        if target.device == dst and len(path) > 1
    ]
    if not found:
        if ctx.excluded is not None and ctx.topology is not None:
            healthy = build_routing_context(
                ctx.topology, ctx.links_per_device
            )
            try:
                _paths_to_device(healthy, link, dst)
            except NoRouteFound:
                pass  # never routable: not the cut's fault
            else:
                raise RouteCutError(
                    f"no route from {link} to {dst}: the failure set "
                    f"[{ctx.excluded}] cuts every path",
                    cut=ctx.excluded,
                )
        raise NoRouteFound(f"no route from {link} to {dst}")
    found.sort(key=lambda p: (len(p), [(l.device.key, l.index) for l in p]))
    return found


def _devices_on_path(path: Sequence[Link]) -> int:
    return len({l.device for l in path})


def _first_hop_code(link: Link, path: Sequence[Link]) -> int:
    """Encode a full path's first hop as an egress target code."""
    hop = path[1]
    if hop.device != link.device:
        return EGRESS_WIRE
    return 2 + sibling_index(link.index, hop.index)


def _exit_link(link: Link, path: Sequence[Link]) -> Link:
    """The local link through which this full path leaves the device."""
    hop = path[1]
    return link if hop.device != link.device else hop


def egress_tables(
    device: Device, ctx: RoutingContext, program: Program,
    excluded: Optional[FailureSet] = None,
) -> Dict[Link, EgressTable]:
    """Build the per-link egress tables for one device, two-pass.

    Pass 1 (``routing_table.py:186-191``): route every (dst, port) along
    the plain shortest path (inter-link hops included in the cost).

    Pass 2 (``routing_table.py:193-202``): for the ports actually
    allocated to each link's outgoing streams, re-decide among all routes
    that are equally short in *device* hops, picking the least-occupied
    exit link — spreading traffic across the device's wires.

    ``excluded`` computes *degraded-mode* tables: routes avoid the
    failed links/devices when a path exists, and a destination the
    failure set cuts off raises :class:`RouteCutError` naming the cut
    (the reference's compiled static tables cannot reroute at all).
    """
    if excluded is not None and not excluded.empty:
        ctx = degraded_context(ctx, excluded)
    _check_stream_count(ctx, program)
    n_ranks = len(ctx.devices)
    n_ports = program.logical_port_count
    links = ctx.links(device)
    tables = {link: EgressTable(n_ranks, n_ports) for link in links}
    occupancy = {link: 0 for link in links}

    for dst in ctx.devices:
        for link in links:
            if dst == device:
                code = EGRESS_LOCAL
            else:
                best = _paths_to_device(ctx, link, dst)[0]  # shortest, det.
                code = _first_hop_code(link, best)
            rank = ctx.rank_of(dst)
            for port in range(n_ports):
                tables[link][rank, port] = code

    for dst in ctx.devices:
        if dst == device:
            continue
        rank = ctx.rank_of(dst)
        for link in links:
            usages = _outgoing_allocations(program, link.index)
            if not usages:
                continue
            # candidate grouping depends only on (link, dst): hoist it out
            # of the per-usage loop (only occupancy changes inside)
            candidates = _paths_to_device(ctx, link, dst)
            fewest_devs = min(_devices_on_path(p) for p in candidates)
            by_exit: Dict[Link, int] = {}  # exit link -> min hop count
            for p in candidates:
                if _devices_on_path(p) != fewest_devs:
                    continue
                e = _exit_link(link, p)
                by_exit[e] = min(by_exit.get(e, len(p)), len(p))
            for family, port, key in usages:
                # pick least occupied (tie: shortest, then lowest link
                # index — routing_table.py:166-168)
                exit_link = min(
                    by_exit,
                    key=lambda e: (occupancy[e], by_exit[e], e.index),
                )
                if exit_link == link:
                    code = EGRESS_WIRE
                else:
                    code = 2 + sibling_index(link.index, exit_link.index)
                tables[link][rank, port] = code
                occupancy[exit_link] += 1
    return tables


def _outgoing_allocations(
    program: Program, link_index: int
) -> List[Tuple[str, int, str]]:
    """(family, port, key) triples whose outgoing stream is this link, in
    deal order (``program.py:116-117`` ``get_channel_allocations_with_prefix``)."""
    return [
        usage
        for usage in program.stream_allocations(link_index)
        if usage[2] in (OUT_DATA, OUT_CTRL)
    ]


# ---------------------------------------------------------------------------
# Ingress (CKR-equivalent) tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IngressTable:
    """``(port, data|control) -> target code`` for one link, flattened as
    ``[port0_data, port0_ctrl, port1_data, ...]`` (``ckr.cl:54``)."""

    data: List[int]

    def flat(self) -> List[int]:
        return list(self.data)


def ingress_table(
    link: Link, ctx: RoutingContext, program: Program,
    excluded: Optional[FailureSet] = None,
) -> IngressTable:
    """Build one link's ingress table.

    Codes (``routing_table.py:205-225``): 0 = hand back to the egress side
    (packet not consumed here — used both for foreign packets and ports
    with no local consumer); 1 + sibling = forward to a sibling link's
    ingress; ``links_per_device + j`` = deliver to the j-th local op slot
    served by this link.

    Ingress delivery is intra-device (the CK interconnect, not a
    physical wire), so a failure set cannot change the entries — but a
    table for a link or device the set declares dead is a contradiction
    the caller should hear about, not a silently valid artifact.
    """
    if excluded is not None and (
        link.device in excluded.devices
        or (link.device, link.index) in excluded.links
    ):
        raise RouteCutError(
            f"ingress table requested for {link}, which the failure set "
            f"[{excluded}] declares down",
            cut=excluded,
        )
    _check_stream_count(ctx, program)
    n = ctx.links_per_device
    consumers: Dict[Tuple[int, str], int] = {}
    for (family, port, key), stream in program.allocation.items():
        if key in (IN_DATA, IN_CTRL):
            consumers[(port, key)] = stream

    # slot numbering follows the deal order of this link's allocations
    # (routing_table.py:223-225 uses the channel allocation list order)
    local_slots = [
        (port, key)
        for (family, port, key) in program.stream_allocations(link.index)
        if key in (IN_DATA, IN_CTRL)
    ]

    table: List[int] = []
    for port in range(program.logical_port_count):
        for key in (IN_DATA, IN_CTRL):
            stream = consumers.get((port, key))
            if stream is None:
                table.append(0)
            elif stream != link.index:
                table.append(1 + sibling_index(link.index, stream))
            else:
                table.append(n + local_slots.index((port, key)))
    return IngressTable(table)


# ---------------------------------------------------------------------------
# Serialization + neighbour queries
# ---------------------------------------------------------------------------


def serialize_table(flat: Sequence[int], width: int = 1) -> bytes:
    """Little-endian fixed-width bytes (``routing_table.py:57-63``)."""
    fmt = {1: "<B", 2: "<H", 4: "<I"}[width]
    return b"".join(struct.pack(fmt, v) for v in flat)


def deserialize_table(raw: bytes, width: int = 1) -> List[int]:
    fmt = {1: "<B", 2: "<H", 4: "<I"}[width]
    size = struct.calcsize(fmt)
    return [
        struct.unpack(fmt, raw[i : i + size])[0]
        for i in range(0, len(raw), size)
    ]


def write_routing_tables(
    directory, topology: Topology, ctx: Optional[RoutingContext] = None
) -> None:
    """Emit the binary table files for every device and link.

    File naming matches the reference host loader
    (``include/utils/smi_utils.hpp:24-39``): ``cks-rank{r}-channel{c}``
    for egress, ``ckr-rank{r}-channel{c}`` for ingress.
    """
    import os

    if ctx is None:
        ctx = build_routing_context(topology)
    os.makedirs(directory, exist_ok=True)
    for device in ctx.devices:
        program = topology.mapping.program_for(device)
        rank = ctx.rank_of(device)
        etables = egress_tables(device, ctx, program)
        for link in ctx.links(device):
            with open(
                os.path.join(directory, f"cks-rank{rank}-channel{link.index}"),
                "wb",
            ) as f:
                f.write(serialize_table(etables[link].flat()))
            with open(
                os.path.join(directory, f"ckr-rank{rank}-channel{link.index}"),
                "wb",
            ) as f:
                f.write(
                    serialize_table(ingress_table(link, ctx, program).flat())
                )


def check_all_pairs_routable(
    ctx: RoutingContext, devices: Optional[Sequence[Device]] = None
) -> None:
    """Assert every (src link, dst) pair among ``devices`` routes.

    The same granularity table building demands: every link of every
    source must reach every destination. Raises :class:`RouteCutError`
    (naming the cut) when the context's failure set severs a pair, or
    plain :class:`NoRouteFound` when the topology never routed it —
    the check behind the JAX CLI's ``route --check``.
    ``devices`` defaults to all of the context's devices; pass the
    healthy subset to validate a degraded context whose down devices
    are expected to be unreachable.
    """
    devices = ctx.devices if devices is None else list(devices)
    for src in devices:
        for dst in devices:
            if src == dst:
                continue
            for link in ctx.links(src):
                _paths_to_device(ctx, link, dst)


def grid_topology(
    nrow: int,
    ncol: int,
    wrap: bool = True,
    program: Optional[Program] = None,
) -> Topology:
    """Build an ``nrow x ncol`` grid/torus topology (1-D ring when
    ``nrow == 1``).

    Link convention per device: 0 = east, 1 = west, 2 = south,
    3 = north — each physical endpoint used exactly once, matching the
    topology-file invariant. ``wrap`` closes each row/column into a
    ring, the torus shape the degraded-routing property tests cut
    links out of. All devices run ``program`` (default: a minimal
    Push/Pop pair), mirroring the SPMD common case.
    """
    from smi_tpu_torch.ops.operations import Pop, Push
    from smi_tpu_torch.ops.program import ProgramMapping

    if nrow < 1 or ncol < 1:
        raise ValueError(f"grid must be >= 1x1, got {nrow}x{ncol}")
    if program is None:
        program = Program([Push(0), Pop(0)])
    devices = {
        (r, c): Device(node=f"node-{r}-{c}", index=0)
        for r in range(nrow)
        for c in range(ncol)
    }
    connections: Dict[Tuple[Device, int], Tuple[Device, int]] = {}

    def wire(a: Device, la: int, b: Device, lb: int) -> None:
        connections[(a, la)] = (b, lb)
        connections[(b, lb)] = (a, la)

    for r in range(nrow):
        for c in range(ncol):
            if ncol > 1:
                if c + 1 < ncol:
                    wire(devices[(r, c)], 0, devices[(r, c + 1)], 1)
                elif wrap:
                    wire(devices[(r, c)], 0, devices[(r, 0)], 1)
            if nrow > 1:
                if r + 1 < nrow:
                    wire(devices[(r, c)], 2, devices[(r + 1, c)], 3)
                elif wrap:
                    wire(devices[(r, c)], 2, devices[(0, c)], 3)
    mapping = ProgramMapping(
        programs=[program],
        device_to_program={d: program for d in devices.values()},
    )
    return Topology(connections=connections, mapping=mapping)


#: The link indices that carry CROSS-SLICE (DCN) wires in a pod
#: topology: :func:`pod_topology` routes slice rings over east/west
#: (0/1) and the inter-slice columns over south/north (2/3), so a
#: failure set naming a (device, 2|3) endpoint cuts DCN capacity while
#: (device, 0|1) cuts the in-slice tier — the two tiers are physically
#: distinct wire populations.
POD_DCN_LINK_INDICES = (2, 3)


def pod_topology(
    n_slices: int,
    per_slice: int,
    program: Optional[Program] = None,
) -> Topology:
    """A ``(slices, ranks_per_slice)`` pod-of-slices topology.

    Row ``s`` is slice ``s``: a ring of ``per_slice`` devices over the
    east/west wires (the in-slice tier). Same-index ranks across slices
    ring up over the south/north wires (the DCN tier) — one cross
    ring per in-slice position, which is exactly the wire population
    the two-tier allreduce's cross-slice stage uses. Structurally this IS the wrap grid of
    :func:`grid_topology` with rows = slices — the pod is the torus
    read tier-wise — so every existing degraded-routing property
    (FailureSet cuts, RouteCutError naming, all-pairs checks) applies
    to pods unchanged. Rank order is row-major: slice ``s`` owns
    ranks ``[s*per_slice, (s+1)*per_slice)``, matching
    ``mesh.make_hybrid_communicator``.
    """
    if n_slices < 1 or per_slice < 1:
        raise ValueError(
            f"pod must be >= 1x1, got {n_slices}x{per_slice}"
        )
    return grid_topology(n_slices, per_slice, wrap=True, program=program)


def pod_slice_partition(topology: Topology, n_slices: int):
    """Contiguous rank groups of a pod topology: slice ``s`` = the
    ``s``-th equal block of the topology's rank order. Loud on a
    device count the slice count does not divide — a launcher asking
    for 3 slices of an 8-device pod is a config error, not a guess."""
    devices = topology.devices
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if len(devices) % n_slices:
        raise ValueError(
            f"{len(devices)} devices do not split into {n_slices} "
            f"equal slices"
        )
    k = len(devices) // n_slices
    return [devices[s * k:(s + 1) * k] for s in range(n_slices)]


def alltoall_pairwise_schedule(n: int) -> List[List[Tuple[int, int]]]:
    """The pairwise-exchange step schedule as data: step ``s`` (1-based
    in protocol terms, list index ``s - 1`` here) pairs every rank
    ``g`` with destination ``(g + s) % n`` — the exact rotation
    the JAX package's ``credits.all_to_all_rank`` executes, exposed so
    launchers and the membership layer can reason about which wires each
    step drives.

    Invariants (property-tested): every ordered (src, dst) pair with
    ``src != dst`` appears exactly once across the ``n - 1`` steps,
    and within one step the send set is a permutation (each rank sends
    once and receives once) — the schedule shape that lets a step's
    exchanges share the fabric without head-of-line blocking. ``n``
    follows the CURRENT communicator size, which is what makes the
    schedule shrink/regrow-compatible: after a membership change the
    surviving ranks' schedule is simply the smaller ``n``'s (see
    :meth:`smi_tpu_torch.parallel.mesh.Communicator.alltoall_schedule`).
    """
    if n < 1:
        raise ValueError(f"need n >= 1 ranks, got {n}")
    return [
        [(g, (g + s) % n) for g in range(n)]
        for s in range(1, n)
    ]


def egress_link_toward(
    src: Device,
    dst: Device,
    ctx: RoutingContext,
    program: Optional[Program] = None,
    port: int = 0,
    stream_key: str = OUT_DATA,
    tables: Optional[Dict[Link, EgressTable]] = None,
) -> Tuple[int, Device]:
    """Which local wire leaves ``src`` toward ``dst``, and the neighbouring
    device on its far end.

    With a ``program``, the answer follows the *balanced* egress tables for
    the given logical port: the port's packets enter the link its
    ``stream_key`` usage was dealt to, then forward codes are chased from
    link to link until a wire exit — exactly the journey a packet takes
    through the reference's CK_S chain (``cks.cl:55-71``): a logical
    port's preferred direction is the neighbour its balanced route exits
    through.

    Without a ``program`` the plain shortest-path exit is returned. Pass
    precomputed ``tables`` (from :func:`egress_tables`) when querying many
    ports of one device — rebuilding them per call is O(devices² · ports).
    """
    if program is not None:
        if tables is None:
            tables = egress_tables(src, ctx, program)
        rank = ctx.rank_of(dst)
        usage = next(
            (
                (family, p, key)
                for (family, p, key) in program.allocation
                if p == port and key == stream_key
            ),
            None,
        )
        if usage is None:
            raise ValueError(
                f"port {port} has no {stream_key} usage in the program"
            )
        link = Link(src, program.allocation[usage])
        seen = set()
        while True:
            if link in seen:
                raise NoRouteFound(
                    f"forwarding cycle at {link} routing to {dst}"
                )
            seen.add(link)
            code = tables[link][rank, port]
            if code == EGRESS_WIRE:
                break
            if code == EGRESS_LOCAL:
                raise ValueError(f"{dst} is the local device")
            sib = code - 2
            nxt = sib if sib < link.index else sib + 1
            link = Link(src, nxt)
        if ctx.topology is None or (src, link.index) not in ctx.topology.connections:
            raise NoRouteFound(
                f"link {link} has no physical wire in the topology"
            )
        peer_dev, _peer_link = ctx.topology.connections[(src, link.index)]
        return link.index, peer_dev

    best: Optional[List[Link]] = None
    best_link: Optional[Link] = None
    for link in ctx.links(src):
        try:
            path = _paths_to_device(ctx, link, dst)[0]
        except NoRouteFound:
            continue
        if best is None or len(path) < len(best):
            best, best_link = path, _exit_link(link, path)
    if best is None or best_link is None:
        raise NoRouteFound(f"no route from {src} to {dst}")
    remote = next(l for l in best if l.device != src)
    return best_link.index, remote.device
