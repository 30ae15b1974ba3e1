"""Request-level causal span trees + tail-latency blame.

The port's copy of :mod:`smi_tpu.obs.spans`, kept in step with it
line for line.

PR 13 gave every serving run one causally-ordered event stream; this
module *interprets* it: a deterministic pass over that stream (live,
via the front-end's flight recorder, or from a recorded snapshot)
assembles, for every request, a **span tree** — where did this
request's time go — as a derived fact of the happens-before record
rather than a guess (Lamport, PAPERS.md, one layer up).

The component taxonomy (docs/observability.md renders this table,
drift-guarded):

- ``admit.wait``   — arrival → admission (the gate's pending wait);
  pre-acceptance, so OUTSIDE the delivery exactness sum below;
- ``queue``        — admitted, waiting for a wire credit / the class
  scheduler on the destination lane;
- ``credit.stall`` — the sub-portion of queue time where the
  destination lane had ZERO credits with work waiting (carved out of
  ``queue`` tick-exactly from the ``serve.stall`` record);
- ``wire.transit`` — on the wire (``TRANSIT_TICKS`` per hop);
- ``consume.wait`` — landed, waiting for the destination's consumer
  (its service-rate budget, or a stalled consumer);
- ``failover``     — progress stopped at a dying destination: the
  detection blackout between the last pre-kill progress and the
  failover replay being issued;
- ``replay``       — from a WAL replay's issuance to the resent
  chunk's wire entry (integrity and failover replays both).

**Exactness contract** (the PR-11/PR-13 discipline applied to
serving, asserted by the campaign cells): the six delivery components
partition ``[admitted, completed]`` tick-exactly by construction, and
:func:`exactness_problems` additionally compares every request's
component sum against the front-end's OWN measured
admission-to-delivery latency (``completed_at - admitted_at``) —
bit-identical, or the cell fails with a named problem. Two
independent derivations of the same number, one from the event
stream, one from the serving loop's bookkeeping.

**Blame**: for the slowest decile per (tenant, qos),
:func:`blame_report` decomposes the tail into the named components
and convicts the **binding resource** — a hot wire lane
(``wire:rank<r>``), a stalled consumer (``consumer:rank<r>``), a
browned-out class (``brownout:<qos>``), a failover replay
(``failover:rank<r>``) — validated against the seeded campaign cells
where the injected fault is ground truth.

The builder REFUSES a truncated stream by default: a flight recorder
whose ring wrapped (``dropped_events > 0``) lost the early life of
long streams, and a span tree built from half a history would claim
an exactness it cannot have. Raise ``$SMI_TPU_OBS_RING`` (the r15
env knob) or pass a larger recorder; ``allow_partial=True`` opts into
best-effort trees for the retained window only.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from smi_tpu_torch.obs.events import Event, FlightRecorder, OBS_RING_ENV

#: Span components, in canonical (and tie-breaking) order.
COMPONENTS = (
    "admit.wait", "queue", "credit.stall", "wire.transit",
    "consume.wait", "failover", "replay",
)

#: The components that partition the admitted→delivered window — the
#: exactness sum. ``admit.wait`` is pre-acceptance and sits outside.
DELIVERY_COMPONENTS = (
    "queue", "credit.stall", "wire.transit", "consume.wait",
    "failover", "replay",
)

#: Slowest fraction per (tenant, qos) the blame decomposition covers.
BLAME_DECILE = 0.1


class SpanError(ValueError):
    """A span tree could not be assembled honestly — truncated event
    stream, or a request whose causal record is internally
    inconsistent (named in the message)."""


@dataclasses.dataclass
class Span:
    """One node of a request's span tree. ``kind`` is ``component``
    (part of the exact time partition) or ``annotation`` (overlapping
    context — parks, sheds, retune-quiesce windows — never counted in
    the exactness sum)."""

    component: str
    t0: int
    t1: int
    kind: str = "component"
    detail: Tuple[Tuple[str, object], ...] = ()

    @property
    def duration(self) -> int:
        return self.t1 - self.t0

    def to_json(self) -> dict:
        out = {
            "component": self.component, "t0": self.t0, "t1": self.t1,
            "kind": self.kind,
        }
        out.update(self.detail)
        return out


@dataclasses.dataclass
class RequestTree:
    """One request's assembled span tree."""

    tenant: str
    seq: int
    qos: str
    arrived: int
    admitted: Optional[int] = None
    completed: Optional[int] = None
    shed_reason: Optional[str] = None
    shed_at: Optional[int] = None
    spans: List[Span] = dataclasses.field(default_factory=list)
    components: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {c: 0 for c in COMPONENTS}
    )
    #: (component, dst) -> ticks — the blame layer's resource index
    by_dst: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=dict
    )
    parks: int = 0
    replays: int = 0
    dst_history: List[int] = dataclasses.field(default_factory=list)

    @property
    def key(self) -> Tuple[str, int]:
        return (self.tenant, self.seq)

    @property
    def outcome(self) -> str:
        if self.completed is not None:
            return "delivered"
        if self.shed_reason is not None:
            return f"shed:{self.shed_reason}"
        return "in-flight"

    @property
    def latency(self) -> Optional[int]:
        """Admission-to-delivery ticks (the front-end's own measure)."""
        if self.completed is None or self.admitted is None:
            return None
        return self.completed - self.admitted

    @property
    def end_to_end(self) -> Optional[int]:
        """Arrival-to-delivery ticks (admit.wait included)."""
        if self.completed is None:
            return None
        return self.completed - self.arrived

    def delivery_sum(self) -> int:
        """Sum of the delivery components — asserted bit-identical to
        :attr:`latency` (the exactness contract)."""
        return sum(self.components[c] for c in DELIVERY_COMPONENTS)

    def _charge(self, component: str, ticks: int,
                dst: Optional[int]) -> None:
        self.components[component] += ticks
        if dst is not None and ticks:
            key = (component, dst)
            self.by_dst[key] = self.by_dst.get(key, 0) + ticks

    def to_json(self) -> dict:
        return {
            "tenant": self.tenant,
            "seq": self.seq,
            "qos": self.qos,
            "arrived": self.arrived,
            "admitted": self.admitted,
            "completed": self.completed,
            "outcome": self.outcome,
            "latency": self.latency,
            "end_to_end": self.end_to_end,
            "components": {
                c: self.components[c] for c in COMPONENTS
                if self.components[c]
            },
            "parks": self.parks,
            "replays": self.replays,
            "dst_history": list(self.dst_history),
            "spans": [s.to_json() for s in self.spans],
        }


class SpanReport:
    """Every request's span tree from one run's event stream."""

    def __init__(self, requests: Dict[Tuple[str, int], RequestTree],
                 total_events: int, dropped_events: int,
                 confirmed: Optional[List[Tuple[int, int]]] = None):
        self.requests = requests
        self.total_events = total_events
        self.dropped_events = dropped_events
        #: (tick, rank) per ctl.confirm in the stream — the ground
        #: truth the blame layer's failover precedence leans on
        self.confirmed = list(confirmed or ())

    def delivered(self) -> List[RequestTree]:
        return [t for t in self.requests.values()
                if t.completed is not None]

    def digest(self) -> dict:
        """The bounded JSON summary campaign reports carry (per-
        request trees stay in memory / the full export — a report must
        not grow with the traffic)."""
        trees = list(self.requests.values())
        components = {c: 0 for c in COMPONENTS}
        for t in trees:
            for c in COMPONENTS:
                components[c] += t.components[c]
        outcomes: Dict[str, int] = {}
        for t in trees:
            head = t.outcome.split(":")[0]
            outcomes[head] = outcomes.get(head, 0) + 1
        return {
            "requests": len(trees),
            "outcomes": dict(sorted(outcomes.items())),
            "components_ticks": {
                c: components[c] for c in COMPONENTS if components[c]
            },
            "total_events": self.total_events,
            "dropped_events": self.dropped_events,
        }


def _normalize(source) -> Tuple[List[dict], int, int]:
    """(events-as-dicts, total_events, dropped_events) from a
    FlightRecorder, a snapshot dict, or an iterable of events."""
    if isinstance(source, FlightRecorder):
        return ([e.to_json() for e in source.events()],
                source.total_events, source.dropped_events)
    if isinstance(source, dict):
        events = source.get("events")
        if events is None:
            raise SpanError(
                "snapshot dict has no 'events' — pass a "
                "FlightRecorder.snapshot() payload"
            )
        return (list(events), int(source.get("total_events",
                                             len(events))),
                int(source.get("dropped_events", 0)))
    events = [e.to_json() if isinstance(e, Event) else dict(e)
              for e in source]
    return events, len(events), 0


def build_spans(source, allow_partial: bool = False) -> SpanReport:
    """Assemble every request's span tree from an event stream.

    ``source``: a live :class:`FlightRecorder`, its ``snapshot()``
    dict (the recorded-run path), or an iterable of events. Loud
    :class:`SpanError` on a truncated stream unless ``allow_partial``.
    """
    from smi_tpu_torch.serving.scheduler import TRANSIT_TICKS

    events, total, dropped = _normalize(source)
    if dropped and not allow_partial:
        raise SpanError(
            f"event stream is truncated: {dropped} of {total} events "
            f"were evicted by the flight-recorder ring — a span tree "
            f"built from half a history cannot claim exactness. "
            f"Raise ${OBS_RING_ENV} (or pass a larger recorder), or "
            f"opt into best-effort trees with allow_partial=True"
        )

    requests: Dict[Tuple[str, int], RequestTree] = {}
    # per request: raw lifecycle records for the component walk;
    # "replays" holds the blackout boundaries — serve.replay AND
    # serve.reroute records, as (tick, btype, reason, old_rank)
    sends: Dict[Tuple[str, int], Dict[Tuple[int, int], List[int]]] = {}
    consumes: Dict[Tuple[str, int], List[Tuple[int, int, int]]] = {}
    replays: Dict[Tuple[str, int],
                  List[Tuple[int, str, str, int]]] = {}
    stalls: Dict[int, List[int]] = {}
    confirmed: List[Tuple[int, int]] = []
    # retune-quiesce windows: (op, bucket) -> (tenant, t0); closed
    # into (tenant, t0, t1) on the matching swap/rollback
    open_quiesce: Dict[Tuple[str, object], Tuple[object, int]] = {}
    quiesce_windows: List[Tuple[object, int, int]] = []
    last_tick = 0

    def tree_of(e: dict) -> Optional[RequestTree]:
        seq = e.get("stream_seq")
        tenant = e.get("tenant")
        if seq is None or tenant is None:
            return None  # pre-r15 stream or model-checker synthetic
        key = (tenant, int(seq))
        tree = requests.get(key)
        if tree is None:
            tree = requests[key] = RequestTree(
                tenant=tenant, seq=int(seq),
                qos=e.get("qos", "batch"), arrived=e["tick"],
            )
        return tree

    for e in events:
        kind = e.get("kind")
        tick = int(e.get("tick", 0))
        last_tick = max(last_tick, tick)
        if kind == "serve.admit":
            tree = tree_of(e)
            if tree is None:
                continue
            waited = int(e.get("waited", 0))
            tree.arrived = tick - waited
            tree.admitted = tick
            tree.qos = e.get("qos", tree.qos)
            if waited:
                tree.spans.append(Span(
                    "admit.wait", tick - waited, tick,
                    detail=(("parked", tree.parks),),
                ))
            tree._charge("admit.wait", waited, None)
        elif kind == "serve.park":
            tree = tree_of(e)
            if tree is None:
                continue
            tree.arrived = min(tree.arrived, tick)
            tree.parks += 1
            tree.spans.append(Span("admission.park", tick, tick,
                                   kind="annotation"))
        elif kind == "serve.shed":
            tree = tree_of(e)
            if tree is None:
                continue
            tree.shed_reason = e.get("reason", "unknown")
            tree.shed_at = tick
            tree.spans.append(Span(
                "shed", tick, tick, kind="annotation",
                detail=(("reason", tree.shed_reason),),
            ))
        elif kind == "serve.send":
            tree = tree_of(e)
            if tree is None:
                continue
            chunk, dst = int(e["chunk"]), int(e["dst"])
            sends.setdefault(tree.key, {}).setdefault(
                (chunk, dst), []
            ).append(tick)
            if not tree.dst_history or tree.dst_history[-1] != dst:
                tree.dst_history.append(dst)
        elif kind == "serve.consume":
            tree = tree_of(e)
            if tree is None:
                continue
            consumes.setdefault(tree.key, []).append(
                (tick, int(e["chunk"]), int(e["dst"]))
            )
        elif kind == "serve.replay":
            tree = tree_of(e)
            if tree is None:
                continue
            tree.replays += 1
            reason = e.get("reason", "unknown")
            replays.setdefault(tree.key, []).append(
                (tick, "replay", reason, int(e.get("rank", -1)))
            )
        elif kind == "serve.reroute":
            tree = tree_of(e)
            if tree is None:
                continue
            # a failover moved this stream off a dead destination:
            # the wait BEFORE this tick belongs to the rank that
            # died, not to the heir the stream lands on afterwards
            replays.setdefault(tree.key, []).append(
                (tick, "reroute", "failover", int(e.get("src", -1)))
            )
        elif kind == "ctl.confirm":
            if e.get("rank") is not None:
                confirmed.append((tick, int(e["rank"])))
        elif kind == "serve.complete":
            tree = tree_of(e)
            if tree is None:
                continue
            tree.completed = tick
        elif kind == "serve.stall":
            stalls.setdefault(int(e["dst"]), []).append(tick)
        elif kind == "tune.propose":
            okey = (e.get("op"), e.get("bucket"))
            open_quiesce[okey] = (e.get("tenant"), tick)
        elif kind in ("tune.swap", "tune.rollback"):
            okey = (e.get("op"), e.get("bucket"))
            opened = open_quiesce.pop(okey, None)
            if opened is not None:
                quiesce_windows.append(
                    (opened[0], opened[1], tick)
                )
    for (tenant, t0) in open_quiesce.values():
        quiesce_windows.append((tenant, t0, last_tick))

    # -- the component walk, per delivered/in-flight request ------------
    for key, tree in requests.items():
        if tree.admitted is None:
            continue
        cons = consumes.get(key, ())
        send_map = sends.get(key, {})
        replay_list = replays.get(key, [])
        cursor = tree.admitted
        for (t, chunk, dst) in cons:
            ticks_list = send_map.get((chunk, dst))
            s = None
            if ticks_list:
                # the matching transmission: the LAST send of this
                # chunk to this destination that could have landed by
                # the consume tick
                i = bisect.bisect_right(ticks_list, t - TRANSIT_TICKS)
                if i:
                    s = ticks_list[i - 1]
            if s is None:
                raise SpanError(
                    f"request {key}: chunk {chunk} consumed at rank "
                    f"{dst} tick {t} has no matching send in the "
                    f"stream — the causal record is incomplete"
                )
            # queue-ish portion [cursor, qend]
            qend = max(cursor, min(s, t))
            if qend > cursor:
                window = [b for b in replay_list
                          if cursor < b[0] <= qend]
                boundary = None
                if window:
                    first_tick = min(b[0] for b in window)
                    at_first = [b for b in window
                                if b[0] == first_tick]
                    # a failover emits reroute AND replay at the same
                    # tick for a stream with chunks in flight — the
                    # replay record wins (its remainder is resend
                    # wait, not plain queueing)
                    boundary = next(
                        (b for b in at_first if b[1] == "replay"),
                        at_first[0],
                    )
                if boundary is not None:
                    r_tick, btype, r_reason, r_rank = boundary
                    blackout = ("failover" if r_reason == "failover"
                                else "replay")
                    if r_tick > cursor:
                        tree.spans.append(Span(
                            blackout, cursor, r_tick,
                            detail=(("reason", r_reason),
                                    ("rank", r_rank)),
                        ))
                        tree._charge(blackout, r_tick - cursor,
                                     r_rank if r_rank >= 0 else None)
                    if qend > r_tick:
                        if btype == "replay":
                            tree.spans.append(Span(
                                "replay", r_tick, qend,
                                detail=(("reason", r_reason),
                                        ("rank", r_rank)),
                            ))
                            tree._charge(
                                "replay", qend - r_tick,
                                r_rank if r_rank >= 0 else None,
                            )
                        else:
                            # a bare reroute: the remainder is
                            # ordinary queueing on the NEW route
                            _queue_spans(tree, r_tick, qend, dst,
                                         stalls.get(dst, ()))
                else:
                    _queue_spans(tree, cursor, qend, dst,
                                 stalls.get(dst, ()))
            # wire transit [qend, tend]
            tend = max(qend, min(s + TRANSIT_TICKS, t))
            if tend > qend:
                tree.spans.append(Span(
                    "wire.transit", qend, tend,
                    detail=(("chunk", chunk), ("dst", dst)),
                ))
                tree._charge("wire.transit", tend - qend, dst)
            # landed, waiting for the consumer [tend, t]
            if t > tend:
                tree.spans.append(Span(
                    "consume.wait", tend, t,
                    detail=(("chunk", chunk), ("dst", dst)),
                ))
                tree._charge("consume.wait", t - tend, dst)
            cursor = t
        if tree.completed is not None and cursor != tree.completed:
            raise SpanError(
                f"request {key}: span walk ends at tick {cursor} but "
                f"serve.complete says {tree.completed} — the event "
                f"stream and the walk disagree about the same run"
            )
        # retune-quiesce annotation: the request overlapped a window
        # in which its tenant's plan was draining toward a hot-swap
        end = tree.completed if tree.completed is not None else cursor
        for (q_tenant, q0, q1) in quiesce_windows:
            if q_tenant is not None and q_tenant != tree.tenant:
                continue
            lo, hi = max(tree.admitted, q0), min(end, q1)
            if hi >= lo:
                tree.spans.append(Span(
                    "retune.quiesce", lo, hi, kind="annotation",
                ))
    return SpanReport(requests, total, dropped, confirmed=confirmed)


def _queue_spans(tree: RequestTree, q0: int, q1: int, dst: int,
                 stall_ticks) -> None:
    """Split a plain queue portion into alternating ``queue`` /
    ``credit.stall`` spans (a stall record at tick k covers
    ``(k-1, k]``), keeping the partition tick-exact."""
    lo = bisect.bisect_right(stall_ticks, q0)
    hi = bisect.bisect_right(stall_ticks, q1)
    stalled = set(stall_ticks[lo:hi])
    run_component = None
    run_start = q0
    for k in range(q0 + 1, q1 + 1):
        comp = "credit.stall" if k in stalled else "queue"
        if comp != run_component:
            if run_component is not None:
                tree.spans.append(Span(
                    run_component, run_start, k - 1,
                    detail=(("dst", dst),),
                ))
                tree._charge(run_component, k - 1 - run_start, dst)
            run_component = comp
            run_start = k - 1
    tree.spans.append(Span(
        run_component, run_start, q1, detail=(("dst", dst),),
    ))
    tree._charge(run_component, q1 - run_start, dst)


# ---------------------------------------------------------------------------
# Exactness against the front-end's own bookkeeping
# ---------------------------------------------------------------------------


def frontend_spans(fe, allow_partial: bool = False) -> SpanReport:
    """Span trees straight off a front-end's live flight recorder."""
    return build_spans(fe.recorder, allow_partial=allow_partial)


def exactness_problems(report: SpanReport, fe) -> List[str]:
    """The bit-identity check: every completed stream's span-component
    sum must equal the front-end's measured admission-to-delivery
    latency — two independent derivations, compared exactly. Returns
    named problems (empty = exact)."""
    problems: List[str] = []
    seen = set()
    for st in fe.completed:
        key = st.request.stream_id
        seen.add(key)
        tree = report.requests.get(key)
        if tree is None:
            problems.append(
                f"span exactness: completed stream {key} has no span "
                f"tree in the event stream"
            )
            continue
        measured = st.completed_at - st.admitted_at
        if tree.latency != measured:
            problems.append(
                f"span exactness: stream {key} span walk says "
                f"{tree.latency} ticks but the front-end measured "
                f"{measured}"
            )
        elif tree.delivery_sum() != measured:
            problems.append(
                f"span exactness: stream {key} components sum to "
                f"{tree.delivery_sum()} ticks but the front-end "
                f"measured {measured}"
            )
    for tree in report.delivered():
        if tree.key not in seen:
            problems.append(
                f"span exactness: event stream delivered {tree.key} "
                f"but the front-end never completed it"
            )
    return problems


# ---------------------------------------------------------------------------
# Tail-latency blame
# ---------------------------------------------------------------------------


def _binding(components: Dict[str, int],
             by_dst: Dict[Tuple[str, int], int],
             replay_ranks: Dict[int, int]) -> Tuple[str, str, float]:
    """(component, resource, share) for one decile's summed DELIVERY
    components (admission pressure is convicted separately, from the
    shed record). Resource naming is the blame vocabulary the
    campaign tests pin: the component says WHAT bound, the resource
    says WHERE."""
    total = sum(components.values())
    if not total:
        return ("none", "none", 0.0)
    component = max(
        DELIVERY_COMPONENTS,
        key=lambda c: (components.get(c, 0),
                       -DELIVERY_COMPONENTS.index(c)),
    )
    share = components.get(component, 0) / total

    def hot_rank(*comps: str) -> Optional[int]:
        sums: Dict[int, int] = {}
        for (c, dst), ticks in by_dst.items():
            if c in comps:
                sums[dst] = sums.get(dst, 0) + ticks
        if not sums:
            return None
        return max(sorted(sums), key=lambda d: sums[d])

    if component in ("queue", "credit.stall", "wire.transit"):
        r = hot_rank("queue", "credit.stall", "wire.transit")
        resource = f"wire:rank{r}" if r is not None else "wire"
    elif component == "consume.wait":
        r = hot_rank("consume.wait")
        resource = f"consumer:rank{r}" if r is not None else "consumer"
    else:  # failover / replay
        if replay_ranks:
            r = max(sorted(replay_ranks),
                    key=lambda k: replay_ranks[k])
            resource = f"failover:rank{r}" if r >= 0 else "replay"
        else:
            resource = "replay"
    return (component, resource, round(share, 4))


def blame_report(report: SpanReport,
                 decile: float = BLAME_DECILE) -> dict:
    """Decompose the slow tail: per (tenant, qos) and per qos, the
    slowest ``decile`` of delivered requests' admission-to-delivery
    latency (the exactness-backed measure) split into the six
    delivery components, with the binding (component, resource)
    named. Admission pressure — the brownout story — is its own
    section: a shed request has no delivery latency to decompose, so
    the browned-out class is convicted from the shed record, not the
    latency tail. ``binding`` is the cell-level verdict — the
    decomposition of the class tail that burned the most delivery
    ticks."""
    if not 0.0 < decile <= 1.0:
        raise ValueError(f"decile must be in (0, 1], got {decile}")
    delivered = report.delivered()

    def decompose(trees: List[RequestTree]):
        if not trees:
            return None
        ordered = sorted(
            trees, key=lambda t: (-t.latency, t.tenant, t.seq)
        )
        take = max(1, math.ceil(decile * len(ordered)))
        tail = ordered[:take]
        components = {c: 0 for c in DELIVERY_COMPONENTS}
        by_dst: Dict[Tuple[str, int], int] = {}
        replay_ranks: Dict[int, int] = {}
        admit_wait = 0
        for t in tail:
            admit_wait += t.components["admit.wait"]
            for c in DELIVERY_COMPONENTS:
                components[c] += t.components[c]
            for k, v in t.by_dst.items():
                by_dst[k] = by_dst.get(k, 0) + v
                if k[0] in ("failover", "replay"):
                    replay_ranks[k[1]] = (
                        replay_ranks.get(k[1], 0) + v
                    )
        component, resource, share = _binding(
            components, by_dst, replay_ranks
        )
        latencies = sorted(t.latency for t in trees)
        total = sum(components.values())
        row = {
            "count": len(trees),
            "decile_count": take,
            "p50": latencies[max(0, math.ceil(0.50 * len(latencies))
                                 - 1)],
            "p99": latencies[max(0, math.ceil(0.99 * len(latencies))
                                 - 1)],
            "slowest": latencies[-1],
            "components_ticks": {
                c: components[c] for c in DELIVERY_COMPONENTS
                if components[c]
            },
            "admit_wait_ticks": admit_wait,
            "shares": {
                c: round(components[c] / total, 4)
                for c in DELIVERY_COMPONENTS
                if components[c] and total
            },
            "binding": component,
            "resource": resource,
            "share": share,
        }
        return row, by_dst, replay_ranks

    groups: Dict[str, dict] = {}
    by_pair: Dict[Tuple[str, str], List[RequestTree]] = {}
    by_qos: Dict[str, List[RequestTree]] = {}
    for t in delivered:
        by_pair.setdefault((t.tenant, t.qos), []).append(t)
        by_qos.setdefault(t.qos, []).append(t)
    for (tenant, qos) in sorted(by_pair):
        out = decompose(by_pair[(tenant, qos)])
        groups[f"{tenant}/{qos}"] = out[0] if out else None
    qos_rows: Dict[str, Optional[dict]] = {}
    union_by_dst: Dict[Tuple[str, int], int] = {}
    union_replay_ranks: Dict[int, int] = {}
    union_components = {c: 0 for c in DELIVERY_COMPONENTS}
    for qos, trees in sorted(by_qos.items()):
        out = decompose(trees)
        if out is None:
            qos_rows[qos] = None
            continue
        row, by_dst, replay_ranks = out
        qos_rows[qos] = row
        for c, v in row["components_ticks"].items():
            union_components[c] += v
        for k, v in by_dst.items():
            union_by_dst[k] = union_by_dst.get(k, 0) + v
        for r, v in replay_ranks.items():
            union_replay_ranks[r] = union_replay_ranks.get(r, 0) + v
    # the cell verdict, over the UNION of the class deciles. Failover
    # takes precedence: a confirmed death is a discrete upstream
    # cause — the heir contention it induces must not out-vote it.
    union_total = sum(union_components.values())
    failover_ticks = (union_components["failover"]
                      + union_components["replay"])
    binding = {"component": "none", "resource": "none", "share": 0.0}
    if report.confirmed and failover_ticks:
        if union_replay_ranks:
            rank = max(sorted(union_replay_ranks),
                       key=lambda r: union_replay_ranks[r])
        else:
            rank = report.confirmed[0][1]
        binding = {
            "component": "failover",
            "resource": (f"failover:rank{rank}" if rank >= 0
                         else "failover"),
            "share": round(failover_ticks / union_total, 4)
            if union_total else 0.0,
        }
    elif union_by_dst:
        # contention verdict: the DESTINATION where the tail's time
        # concentrated is the binding resource (a stalled consumer
        # shows up as consume.wait + credit.stall on ONE rank — the
        # per-destination total is what separates it from diffuse
        # background contention); the dominant component there says
        # how it bound
        per_dst: Dict[int, int] = {}
        for (c, d), v in union_by_dst.items():
            per_dst[d] = per_dst.get(d, 0) + v
        dst = max(sorted(per_dst), key=lambda d: per_dst[d])
        component = max(
            sorted(c for (c, d) in union_by_dst if d == dst),
            key=lambda c: union_by_dst[(c, dst)],
        )
        if component == "consume.wait":
            resource = f"consumer:rank{dst}"
        elif component in ("failover", "replay"):
            resource = (f"failover:rank{dst}" if dst >= 0
                        else "replay")
        else:
            resource = f"wire:rank{dst}"
        binding = {
            "component": component,
            "resource": resource,
            "share": round(per_dst[dst] / union_total, 4)
            if union_total else 0.0,
        }
    # admission pressure: the brownout story, from the shed record
    admission_sheds: Dict[str, Dict[str, int]] = {}
    for t in report.requests.values():
        if t.shed_reason is None:
            continue
        head = t.shed_reason.split(":")[0]
        per = admission_sheds.setdefault(t.qos, {})
        per[head] = per.get(head, 0) + 1
    brownout_class = None
    worst_sheds = 0
    for qos in sorted(admission_sheds):
        pressure = (admission_sheds[qos].get("brownout", 0)
                    + admission_sheds[qos].get("admission-timeout", 0))
        if pressure > worst_sheds:
            worst_sheds = pressure
            brownout_class = qos
    return {
        "decile": decile,
        "delivered": len(delivered),
        "groups": groups,
        "by_qos": qos_rows,
        "binding": binding,
        "admission": {
            "sheds": {q: dict(sorted(v.items()))
                      for q, v in sorted(admission_sheds.items())},
            "brownout_class": brownout_class,
            "brownout_sheds": worst_sheds,
        },
    }


# ---------------------------------------------------------------------------
# Campaign integration
# ---------------------------------------------------------------------------


def campaign_fields(fe) -> Tuple[dict, List[str]]:
    """The span/blame payload a campaign cell report carries, plus the
    exactness problems (gate failures when non-empty). Never raises —
    a truncated ring surfaces as a named problem, not a crash."""
    try:
        spans = frontend_spans(fe)
    except SpanError as e:
        return ({"spans": {"error": str(e)}, "blame": None,
                 "span_exact": False}, [f"span build failed: {e}"])
    problems = exactness_problems(spans, fe)
    return ({
        "spans": spans.digest(),
        "blame": blame_report(spans),
        "span_exact": not problems,
    }, problems)


#: The blame resource *kinds* — the head of every resource string the
#: binding vocabulary produces (``wire:rank3`` → ``wire``). ``replay``
#: and ``none`` never carry a rank; the other three may.
BLAME_KINDS = ("none", "wire", "consumer", "failover", "replay")

#: Kinds that may name a binding rank (``<kind>:rank<r>``).
_RANKED_BLAME_KINDS = ("wire", "consumer", "failover")


@dataclasses.dataclass(frozen=True)
class BlameVerdict:
    """A structured tail-latency blame verdict.

    The machine-consumable form of a binding's ``resource`` string:
    ``kind`` is the resource family (:data:`BLAME_KINDS`), ``rank`` the
    binding rank when the verdict names one (else ``None``),
    ``component`` the dominant delivery component that bound, and
    ``share`` its fraction of the tail. Campaign code and the
    elasticity controller consume THIS — pattern-matching the rendered
    ``"wire:rank<r>"`` string was the r15 shape and is now a bug:
    a vocabulary change would silently stop matching.
    """

    kind: str
    rank: Optional[int]
    component: str = "none"
    share: float = 0.0

    @property
    def resource(self) -> str:
        """The rendered resource string (round-trips through
        :func:`parse_blame_resource`)."""
        if self.rank is None:
            return self.kind
        return f"{self.kind}:rank{self.rank}"

    def __str__(self) -> str:
        return (f"{self.component} -> {self.resource} "
                f"({self.share:.0%} of the tail)")


def parse_blame_resource(resource: str, component: str = "none",
                         share: float = 0.0) -> BlameVerdict:
    """Parse a binding ``resource`` string into a :class:`BlameVerdict`.

    A malformed string is a LOUD ``ValueError`` naming the string: the
    verdict vocabulary is an API (campaign gates and the elasticity
    controller act on it), and a silent ``None`` on a typo would turn
    a migration trigger into a no-op without a trace.
    """
    if not isinstance(resource, str):
        raise ValueError(
            f"blame resource must be a string, got "
            f"{type(resource).__name__}: {resource!r}"
        )
    kind, sep, tail = resource.partition(":")
    if kind not in BLAME_KINDS:
        raise ValueError(
            f"malformed blame resource {resource!r}: kind {kind!r} is "
            f"not one of {BLAME_KINDS}"
        )
    rank: Optional[int] = None
    if sep:
        if kind not in _RANKED_BLAME_KINDS:
            raise ValueError(
                f"malformed blame resource {resource!r}: {kind!r} "
                f"never names a rank"
            )
        if not tail.startswith("rank"):
            raise ValueError(
                f"malformed blame resource {resource!r}: expected "
                f"{kind}:rank<r>"
            )
        try:
            rank = int(tail[len("rank"):])
        except ValueError:
            raise ValueError(
                f"malformed blame resource {resource!r}: "
                f"{tail[len('rank'):]!r} is not a rank"
            ) from None
        if rank < 0:
            raise ValueError(
                f"malformed blame resource {resource!r}: rank must be "
                f">= 0"
            )
    return BlameVerdict(kind=kind, rank=rank, component=component,
                        share=share)


def blame_verdict(blame: dict) -> BlameVerdict:
    """The :class:`BlameVerdict` of a blame report (or of one of its
    rows). Accepts the :func:`blame_report` dict itself (reads its
    cell-level ``binding``), the binding dict, or a per-class row —
    anything carrying a ``resource`` string. Malformed input is loud.
    """
    if not isinstance(blame, dict):
        raise ValueError(
            f"blame verdict needs a blame dict, got "
            f"{type(blame).__name__}"
        )
    node = blame
    if isinstance(node.get("binding"), dict):
        node = node["binding"]  # the full blame_report was passed
    if "resource" not in node:
        raise ValueError(
            f"blame verdict: no 'resource' in {sorted(node)!r} — pass "
            f"a blame report, its binding, or a per-class row"
        )
    component = node.get("component")
    if component is None:
        # per-class rows carry the component under "binding"
        component = node.get("binding", "none")
    if not isinstance(component, str):
        raise ValueError(
            f"blame verdict: component must be a string, got "
            f"{component!r}"
        )
    return parse_blame_resource(
        node["resource"], component=component,
        share=float(node.get("share", 0.0)),
    )


def format_blame(blame: Optional[dict]) -> List[str]:
    """Render a blame report as text lines (the ``smi-tpu health``
    surface)."""
    if not blame:
        return ["  (no blame report)"]
    binding = blame["binding"]
    lines = [
        f"tail blame (slowest {blame['decile']:.0%} per class, "
        f"{blame['delivered']} delivered): binding "
        f"{binding['component']} -> {binding['resource']} "
        f"({binding['share']:.0%} of the tail)"
    ]
    for qos, row in blame["by_qos"].items():
        if row is None:
            continue
        shares = ", ".join(
            f"{c}={row['shares'][c]:.0%}"
            for c in COMPONENTS if c in row.get("shares", {})
        )
        lines.append(
            f"  {qos:<12} p99 {row['p99']} ticks (slowest "
            f"{row['slowest']}): {row['binding']} -> "
            f"{row['resource']} [{shares}]"
        )
    admission = blame.get("admission") or {}
    if admission.get("brownout_class"):
        lines.append(
            f"  admission     brownout class "
            f"{admission['brownout_class']} "
            f"({admission['brownout_sheds']} policy shed(s))"
        )
    return lines
