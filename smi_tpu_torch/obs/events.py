"""Structured events + the flight recorder: one schema, every plane.

The port's copy of :mod:`smi_tpu.obs.events`, kept in step with it
line for line: the same run records the same event stream.

Observability discipline (ROADMAP item 3's prerequisite): the only
trustworthy ordering in a distributed run is happens-before (Lamport,
PAPERS.md), and the step-clock machines here already ARE logical
clocks — the credits simulator's scheduler event count, the serving
front-end's :class:`~smi_tpu_torch.parallel.membership.StepClock`, the
membership epoch counter. This module gives every one of those
machines the same event vocabulary:

- **sim plane** — the credits simulator's primitives: credit grants
  and waits, DMA starts and landings, barriers — the wire-level
  history a deadlock dump needs to explain itself;
- **serving plane** — the request lifecycle: admit / park / shed /
  send / consume / replay / complete, each carrying tenant + QoS +
  reason — the admission story the campaigns gate on;
- **control plane** — membership transitions: suspect / clear /
  confirm / shrink / regrow / epoch bump — the transitions the PR 10
  model checker proves safe, now visible in a live run;
- **tuning plane** — the online retuner's lifecycle
  (:mod:`smi_tpu_torch.tuning.online`): sample ingested / swap proposed /
  plan hot-swapped / swap rolled back, each carrying the op, the
  payload bucket, and the evidence thresholds — the live-retuning
  story the r14 campaign cells gate on.

An :class:`Event` is causally ordered by ``seq`` (the recorder's
monotone emission counter — emission order IS program order on the one
thread every step-clock machine runs on) and stamped with the
emitting machine's logical ``tick``. Everything is deterministic: same
seed, same event stream, byte for byte (no wall time anywhere).

The :class:`FlightRecorder` is the always-on consumer: a bounded ring
buffer whose tail is attached to ``DeadlockError`` /
``WatchdogTimeout`` / ``IntegrityError`` / ``AdmissionRejected`` state
dumps, so a hang or a shed names its causal history instead of just
its final state. Overflow is counted, never silent: ``dropped_events``
rides every snapshot (the ScheduleCount no-silent-caps discipline).
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Dict, List, Optional, Tuple

#: Default flight-recorder capacity (events). Small enough that the
#: always-on recorder costs a bounded deque append per event; large
#: enough that a hang's tail spans several serving ticks or simulator
#: laps. docs/observability.md quotes this (drift-guarded).
DEFAULT_RECORDER_CAPACITY = 512

#: Environment knob: override the default flight-recorder capacity.
#: A long serving campaign emits far more than 512 events — without
#: the override the ring wraps and the early life of long streams is
#: gone from every tail and span build. Unset/empty keeps the 512
#: default; a malformed or non-positive value is a LOUD ValueError
#: naming knob and value (the ``$SMI_WATCHDOG_SECS`` discipline — a
#: typo must never silently shrink the operator's history).
OBS_RING_ENV = "SMI_TPU_OBS_RING"


def ring_capacity(default: int = DEFAULT_RECORDER_CAPACITY) -> int:
    """Resolve the flight-recorder capacity: ``$SMI_TPU_OBS_RING``
    when set (the operator's word — outranks any caller default),
    else ``default``. Loud on malformed/non-positive values."""
    raw = os.environ.get(OBS_RING_ENV, "").strip()
    if not raw:
        return default
    try:
        capacity = int(raw)
    except ValueError:
        raise ValueError(
            f"${OBS_RING_ENV} must be an integer event capacity "
            f"(flight-recorder ring bound), got {raw!r}"
        ) from None
    if capacity < 1:
        raise ValueError(
            f"${OBS_RING_ENV} must be >= 1 (the recorder is "
            f"always-on; unset the variable for the "
            f"{DEFAULT_RECORDER_CAPACITY}-event default), got {raw!r}"
        )
    return capacity

#: How many tail events an error dump attaches
#: (:func:`FlightRecorder.tail`'s default) — bounded so a state dump
#: stays readable. docs/observability.md quotes this too.
DEFAULT_TAIL_EVENTS = 32

#: The ONE event schema: kind -> (plane, required field names). Every
#: emission validates against this table — an unknown kind or a
#: missing field is a loud ValueError at the emission site, never a
#: malformed event in the stream. The planes:
#:
#: - ``sim``     — credits-simulator primitives (logical tick = the
#:                 scheduler's executed-action count);
#: - ``serving`` — request lifecycle on the front-end's StepClock;
#: - ``control`` — membership/epoch transitions on the same clock;
#: - ``tuning``  — the online retuner's sample/propose/swap/rollback
#:                 lifecycle (same clock when front-end-hosted);
#: - ``slo``     — the burn-rate health engine's transitions (warn /
#:                 breach / recover), evaluated once per step tick.
#:
#: docs/observability.md renders this table verbatim (drift-guarded by
#: tests/test_perf_docs.py); extend it there and here together.
EVENT_KINDS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    # -- sim plane ------------------------------------------------------
    "credit.grant": ("sim", ("src", "dst", "index")),
    "credit.wait": ("sim", ("index",)),
    "dma.start": ("sim", ("src", "dst", "slot")),
    "dma.land": ("sim", ("src", "dst", "slot")),
    "barrier.signal": ("sim", ("src", "dst")),
    "barrier.wait": ("sim", ()),
    # -- serving plane --------------------------------------------------
    "serve.admit": ("serving", ("tenant", "qos", "waited")),
    "serve.park": ("serving", ("tenant", "qos")),
    "serve.shed": ("serving", ("tenant", "qos", "reason")),
    "serve.send": ("serving", ("tenant", "qos", "chunk", "dst")),
    "serve.consume": ("serving", ("tenant", "qos", "chunk", "dst")),
    "serve.replay": ("serving", ("tenant", "qos", "chunks", "reason")),
    "serve.complete": ("serving", ("tenant", "qos", "dst")),
    "serve.stall": ("serving", ("dst",)),
    "serve.reroute": ("serving", ("tenant", "qos", "src", "dst")),
    # -- control plane --------------------------------------------------
    "ctl.suspect": ("control", ("reason",)),
    "ctl.clear": ("control", ()),
    "ctl.confirm": ("control", ()),
    "ctl.shrink": ("control", ("epoch",)),
    "ctl.regrow": ("control", ("epoch",)),
    "ctl.recover": ("control", ("protocol", "reason")),
    "ctl.scale": ("control", ("epoch", "direction")),
    "ctl.migrate": ("control", ("src", "dst", "state")),
    "ctl.quorum": ("control", ("epoch", "quorum", "verdict")),
    # -- tuning plane (the online retuner's lifecycle) ------------------
    "tune.sample": ("tuning", ("op", "bucket")),
    "tune.propose": ("tuning", ("op", "bucket", "from_algo",
                                "to_algo", "samples", "margin")),
    "tune.swap": ("tuning", ("op", "bucket", "to_algo", "plan_epoch",
                             "revision")),
    "tune.rollback": ("tuning", ("op", "bucket", "reason")),
    # -- slo plane (the burn-rate health engine, r15) --------------------
    "slo.burn": ("slo", ("qos", "window", "rate")),
    "slo.breach": ("slo", ("qos", "window", "rate", "budget")),
    "slo.recover": ("slo", ("qos", "breached_ticks")),
}

#: Envelope keys every event owns; a schema field may not shadow them
#: (the chunk sequence number is ``chunk``, never ``seq`` — ``seq`` is
#: the causal emission counter and overwriting it in ``to_json`` would
#: destroy the one ordering this layer exists to provide).
RESERVED_FIELDS = frozenset(("seq", "tick", "plane", "kind", "rank"))


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured observation.

    ``seq`` is the emitting recorder's monotone counter (the causal
    order — emission order is program order); ``tick`` the emitting
    machine's logical clock (scheduler events for the simulator, step
    ticks for serving/control); ``rank`` the subject rank when one
    exists; ``fields`` the kind's schema fields (plain JSON scalars).
    """

    seq: int
    tick: int
    plane: str
    kind: str
    rank: Optional[int]
    fields: Tuple[Tuple[str, object], ...]

    def to_json(self) -> dict:
        out = {
            "seq": self.seq,
            "tick": self.tick,
            "plane": self.plane,
            "kind": self.kind,
        }
        if self.rank is not None:
            out["rank"] = self.rank
        out.update(self.fields)
        return out

    def __str__(self) -> str:
        who = f" rank {self.rank}" if self.rank is not None else ""
        detail = " ".join(f"{k}={v}" for k, v in self.fields)
        return (f"[{self.seq}@t{self.tick}]{who} {self.kind}"
                + (f" {detail}" if detail else ""))


class FlightRecorder:
    """Always-on bounded ring buffer of :class:`Event`\\ s.

    Appending is O(1) and allocation-bounded (a ``deque(maxlen=)``);
    overflow evicts the oldest event and **counts it** —
    ``dropped_events`` is in every snapshot and every attached tail,
    so a truncated history can never read as a complete one. One
    recorder serves one logical machine (a simulator run, a serving
    front-end); cross-machine merging is a consumer concern.
    """

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            # $SMI_TPU_OBS_RING outranks the 512 default (loud on
            # malformed); an explicit capacity= is the caller's word
            capacity = ring_capacity()
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0
        #: per-kind emission counts (full history, never evicted) —
        #: the cheap aggregate the bench `obs` field and campaign
        #: reports quote even after the ring wrapped
        self.counts: Dict[str, int] = {}

    # -- emission -------------------------------------------------------

    def emit(self, kind: str, tick: int, rank: Optional[int] = None,
             **fields) -> Event:
        """Record one event; validates ``kind`` and its required
        fields against :data:`EVENT_KINDS` (loud on mismatch)."""
        spec = EVENT_KINDS.get(kind)
        if spec is None:
            raise ValueError(
                f"unknown event kind {kind!r}; known: "
                f"{sorted(EVENT_KINDS)}"
            )
        plane, required = spec
        missing = [f for f in required if f not in fields]
        if missing:
            raise ValueError(
                f"event {kind!r} missing required field(s) {missing}; "
                f"schema requires {list(required)}"
            )
        shadowed = RESERVED_FIELDS.intersection(fields)
        if shadowed:
            raise ValueError(
                f"event {kind!r} field(s) {sorted(shadowed)} shadow "
                f"reserved envelope keys {sorted(RESERVED_FIELDS)}"
            )
        event = Event(
            seq=self._seq, tick=int(tick), plane=plane, kind=kind,
            rank=rank, fields=tuple(sorted(fields.items())),
        )
        self._seq += 1
        self._events.append(event)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        return event

    # -- bookkeeping ----------------------------------------------------

    @property
    def total_events(self) -> int:
        """Events ever emitted (including evicted ones)."""
        return self._seq

    @property
    def dropped_events(self) -> int:
        """Events evicted by the ring bound — counted, never silent."""
        return self._seq - len(self._events)

    def events(self) -> List[Event]:
        """The retained window, oldest first."""
        return list(self._events)

    def tail(self, n: int = DEFAULT_TAIL_EVENTS) -> dict:
        """The last-``n``-events payload error dumps attach: bounded,
        JSON-able, and honest about truncation (``dropped_events``
        counts ring eviction; ``omitted`` counts retained events this
        tail skipped)."""
        retained = len(self._events)
        take = min(n, retained)
        events = [e.to_json() for e in list(self._events)[retained - take:]]
        return {
            "events": events,
            "total_events": self.total_events,
            "dropped_events": self.dropped_events,
            "omitted": retained - take,
        }

    def snapshot(self) -> dict:
        """Deterministic full-state JSON: the retained window plus the
        no-silent-caps accounting and per-kind counts."""
        return {
            "capacity": self.capacity,
            "total_events": self.total_events,
            "dropped_events": self.dropped_events,
            "counts": dict(sorted(self.counts.items())),
            "events": [e.to_json() for e in self._events],
        }


def format_tail(tail: Optional[dict]) -> str:
    """Render a :meth:`FlightRecorder.tail` payload for an error
    message (the ``format_state_dump`` discipline)."""
    if not tail or not tail.get("events"):
        return "  (no recorded events)"
    lines = []
    dropped = tail.get("dropped_events", 0)
    if dropped:
        lines.append(f"  ... {dropped} earlier event(s) dropped by the "
                     f"ring bound ...")
    for e in tail["events"]:
        who = f" rank {e['rank']}" if "rank" in e else ""
        detail = " ".join(
            f"{k}={v}" for k, v in sorted(e.items())
            if k not in ("seq", "tick", "plane", "kind", "rank")
        )
        lines.append(
            f"  [{e['seq']}@t{e['tick']}]{who} {e['kind']}"
            + (f" {detail}" if detail else "")
        )
    return "\n".join(lines)


def attach_tail(error: BaseException, recorder: Optional["FlightRecorder"],
                n: int = DEFAULT_TAIL_EVENTS) -> None:
    """Attach a bounded flight-recorder tail to an error in flight
    (``error.recorder_tail``), folding it into a structured ``state``
    dict when the error carries one (``setdefault`` — a tail attached
    closer to the failure site wins). The canonical helper for every
    layer that can import obs (the serving tier uses it for
    ``AdmissionRejected`` and ``IntegrityError``);
    :mod:`~smi_tpu_torch.parallel.credits` and
    :mod:`~smi_tpu_torch.utils.watchdog` carry local duck-typed copies of
    this logic instead, because obs imports the analysis tier which
    imports credits — an import cycle this helper must not create.
    No-op without a recorder; never raises (the tail must not mask
    the error it annotates)."""
    if recorder is None:
        return
    try:
        tail = recorder.tail(n)
        error.recorder_tail = tail
        state = getattr(error, "state", None)
        if isinstance(state, dict):
            state.setdefault("flight_recorder", tail)
    except Exception:
        pass
