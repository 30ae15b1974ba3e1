"""The multi-tenant streaming front-end: admit, stream, shed, heal.

The port's copy of :mod:`smi_tpu.serving.frontend`, kept in step
with it line for line: the same seed gives the same decisions,
handoff blobs and reports.

One deterministic machine ties the serving layers together on the
membership step clock (:class:`~smi_tpu_torch.parallel.membership.StepClock`
— no wall time anywhere, every run replays bit-identically per seed):

- **routing**: a tenant hashes to a base rank; the live owner is
  :func:`~smi_tpu_torch.parallel.membership.route_owner` (the rank itself,
  or its heir once membership confirms a death). Streams carry
  transient per-tenant stream IDs — the serving analog of the
  reference's per-message channels, and the identity
  :func:`~smi_tpu_torch.parallel.channels.open_tenant_channel` maps onto a
  real :class:`~smi_tpu_torch.parallel.channels.P2PChannel` port on the
  runtime tier;
- **admission** (:class:`~smi_tpu_torch.serving.admission.AdmissionGate`):
  stream credits chain end to end into the wire credits — a stream's
  credit returns only when its last chunk is consumed and verified,
  so a stalled consumer backpressures the admission edge instead of
  growing a queue;
- **delivery**: chunks move as CRC+sequence frames over per-rank
  :class:`~smi_tpu_torch.serving.scheduler.WireLane` credit windows; damage
  is a named ``IntegrityError`` and the chunk replays from the
  stream's WAL (:class:`~smi_tpu_torch.parallel.recovery.ProgressLog`,
  written at acceptance — which is what makes "accepted" a durable
  promise);
- **degradation**: ranks heartbeat on the clock; the phi-accrual
  detector (:class:`~smi_tpu_torch.parallel.membership.PhiAccrualDetector`)
  distinguishes *dead* from *merely saturated* — a kill is suspected,
  confirmed, the view shrinks under a new epoch, tenant routes fail
  over to heirs, and every incomplete stream to the dead rank voids
  its partial deliveries (``ProgressLog.void_deliveries`` — the
  input-restart discipline of the reduction protocols) and replays to
  the heir on a fresh sequence lane. Straggler traffic from the dead
  incarnation is rejected by epoch
  (:class:`~smi_tpu_torch.parallel.membership.StaleEpochError`), counted,
  never folded in.

The exit gates the campaigns assert
(:mod:`smi_tpu_torch.serving.campaign`): zero silent corruption (every
delivered stream bit-identical to its submission), zero
lost-accepted-requests (every admitted stream delivered, or the run
fails with a named error), bounded queue occupancy, lowest-class-first
shedding, and bounded interactive admission latency.
"""

from __future__ import annotations

import pickle
import random
from typing import Callable, Dict, List, Optional

from smi_tpu_torch.parallel.membership import (
    HEARTBEAT_INTERVAL,
    ConfirmedDead,
    MembershipView,
    PhiAccrualDetector,
    QuorumDecision,
    QuorumLostError,
    StaleEpochError,
    StepClock,
    SuspectRank,
    SuspicionCleared,
    mint_fencing_token,
    quorum_size,
    regrow_pod,
    route_owner,
)
from smi_tpu_torch.obs.events import FlightRecorder
from smi_tpu_torch.obs.metrics import MetricsRegistry
from smi_tpu_torch.obs.slo import SloEngine
from smi_tpu_torch.parallel.checkpoint import pack_shard, unpack_shard
from smi_tpu_torch.parallel.credits import IntegrityError
from smi_tpu_torch.parallel.recovery import ProgressLog
from smi_tpu_torch.serving.admission import AdmissionGate, DEFAULT_POOL
from smi_tpu_torch.serving.placement import PlacementMap, tenant_base_rank
from smi_tpu_torch.serving.qos import QOS_CLASSES, Request, check_qos
from smi_tpu_torch.serving.scheduler import (
    CONSUME_RATE,
    WIRE_CREDITS,
    StreamScheduler,
    StreamState,
    WireLane,
    verify_chunk,
)
from smi_tpu_torch.tuning.swap import StalePlanError
from smi_tpu_torch.utils.watchdog import Deadline


__all__ = ["ServingFrontend", "tenant_base_rank"]


class ServingFrontend:
    """Deterministic multi-tenant front-end over ``n`` ranks."""

    def __init__(
        self,
        n: int,
        seed: int = 0,
        pool: int = DEFAULT_POOL,
        consume_rate: int = CONSUME_RATE,
        tenant_rate: float = 4.0,
        tenant_burst: float = 64.0,
        check_deadlines: bool = True,
        recorder: Optional[FlightRecorder] = None,
        metrics: Optional[MetricsRegistry] = None,
        retune: Optional[object] = None,
        elasticity: Optional[object] = None,
        quorum_fencing: bool = True,
        quorum_fraction: Optional[float] = None,
    ):
        if n < 2:
            raise ValueError(f"serving needs >= 2 ranks, got {n}")
        self.n = n
        self.rng = random.Random(f"serving:{n}:{seed}")
        self.clock = StepClock()
        # the observability spine is ALWAYS on (bounded ring buffer +
        # O(label-set) registry — the recorder's tail rides every
        # watchdog/integrity/admission error this front-end raises);
        # callers may inject their own to aggregate across front-ends
        self.recorder = recorder if recorder is not None \
            else FlightRecorder()
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        self.view = MembershipView(n).attach_recorder(self.recorder)
        self.detector = PhiAccrualDetector(self.clock, range(n))
        self.gate = AdmissionGate(
            pool=pool, tenant_rate=tenant_rate,
            tenant_burst=tenant_burst,
            recorder=self.recorder, metrics=self.metrics,
        )
        self.gate.on_admit = self._on_admit
        #: the burn-rate health engine (always-on, like the recorder):
        #: deliveries and service-caused sheds burn per-class error
        #: budgets, evaluated once per tick — the continuous health
        #: signal ROADMAP item 4's autoscaling consumes. Consumers
        #: that chain their own on_shed (the MoE dispatcher) wrap
        #: this one.
        self.slo = SloEngine(recorder=self.recorder,
                             metrics=self.metrics)
        self.gate.on_shed = self._on_shed
        #: per-destination accepted-stream cap: one saturated (or
        #: silently dead) destination may hold at most twice its fair
        #: share of the pool — and never more than pool minus one fair
        #: share, so even on a 2-rank front-end a sick destination
        #: leaves headroom and its backlog can never starve admission
        #: to healthy destinations. The backpressure edge is
        #: per-route, not just global.
        fair = -(-pool // n)
        self.dst_cap = max(2, min(2 * fair, pool - fair))
        # the cap holds for PENDING requests too: a request parked
        # while its destination was healthy must not slip past the
        # backlog cap when a credit frees later (it stays parked and
        # may time out with a named shed instead)
        self.gate.admit_filter = lambda req: (
            self._backlog(self._route_new(req.tenant, record=False,
                                          base=req.base_rank))
            < self.dst_cap
        )
        #: the online retuner (:class:`smi_tpu_torch.tuning.online.OnlineTuner`)
        #: — None = retuning off, byte-for-byte the pre-r14 loop. When
        #: wired, the front-end drives its PlanSwap machines one
        #: transition per tick (propose -> quiesce -> swap -> commit)
        #: with THIS loop's in-flight census as the drain set, and
        #: injects the stale-plan straggler check at every swap (the
        #: _failover discipline applied to plan epochs).
        self.tuner = retune
        if self.tuner is not None:
            if getattr(self.tuner, "recorder", None) is None:
                self.tuner.recorder = self.recorder
            if getattr(self.tuner, "metrics", None) is None:
                self.tuner.metrics = self.metrics
            self.tuner.clock = self.clock.now
        #: stream index -> plan epoch at admission (retune bookkeeping;
        #: streams admitted between propose and swap are re-planned —
        #: re-stamped — at the swap site)
        self.plan_stamp: Dict[int, int] = {}
        self.replanned_streams = 0
        self.stale_plan_rejections = 0
        self.stale_plan_leaks = 0
        #: sticky tenant placement (r16): unarmed = byte-identical to
        #: the crc32 rule; the elasticity controller arms it at bind
        self.placement = PlacementMap(n)
        #: the in-flight live migration, or None — one at a time, a
        #: dict {tenant, src, dst, state, streams, blob, reason, ...}
        #: driven one state transition per tick by _drive_migration
        self._migration: Optional[Dict] = None
        #: completed/aborted migration audit trail (report material)
        self.migrations: List[Dict] = []
        self.migrated_streams = 0
        #: per-rank decayed credit-stall window (halved every tick,
        #: +1 per stalled tick) — with the occupancy gauge, the load
        #: signal placement and migration targeting read
        self._recent_stalls: Dict[int, int] = {r: 0 for r in range(n)}
        self.lanes = [WireLane(r) for r in range(n)]
        self.scheduler = StreamScheduler(
            check_deadlines=check_deadlines
        )
        self.scheduler.on_send = self._observe_send
        self.consume_rate = consume_rate
        #: externally-killed ranks (stop heartbeating and consuming);
        #: membership catches up via phi-accrual
        self.killed: set = set()
        self.active: List[StreamState] = []
        self.completed: List[StreamState] = []
        self._stream_count = 0
        self._tenant_seq: Dict[str, int] = {}
        # report material
        self.delivered: Dict[str, int] = {c: 0 for c in QOS_CLASSES}
        self.silent_corruptions = 0
        self.integrity_detections = 0
        self.resequenced = 0
        self.stale_epoch_rejections = 0
        self.stale_epoch_leaks = 0
        self.drained_routes = 0
        self.suspected: List[int] = []
        self.cleared: List[int] = []
        self.confirmed: List[int] = []
        self.detect_ticks: Optional[int] = None
        self.replayed_chunks = 0
        self.lost_in_flight = 0
        #: stateful-recovery seam (r20). An engine holding rank-
        #: resident state (KV shards) installs a callable
        #: ``(stream, dead, heir) -> bool`` here; returning True means
        #: the engine restored the stream's progress at the heir from
        #: its own durable checkpoint, so the front-end must SKIP the
        #: stateless void-and-replay (the two recovery paths must
        #: never be confused). None (the default) keeps the replay
        #: path byte-for-byte.
        self.on_failover_reroute: Optional[Callable] = None
        self._kill_tick: Optional[int] = None
        self._next_beat = 0
        #: partition tolerance (r17). ``quorum_fencing`` gates the
        #: whole discipline: fenced (the default) means a rank that
        #: loses its quorum lease PARKS — new streams bounce with a
        #: named :class:`QuorumLostError` — and every epoch-advancing
        #: actuator runs under a minted :class:`FencingToken`.
        #: Unfenced is the DEMONSTRATION arm: the stale minority
        #: primary keeps accepting, and every accept that lands while
        #: the majority has already rerouted the tenant is a counted
        #: split-brain incident (two primaries, one tenant).
        self.quorum_fencing = quorum_fencing
        self.quorum_fraction = quorum_fraction
        #: the in-flight partition-class fault, or None — one at a
        #: time, armed by :meth:`inject_partition`, healed (and the
        #: parked side rejoined) by :meth:`_drive_partition` once the
        #: fault window closes
        self._partition = None
        #: the minority side's quorum evidence: phi-accrual over lease
        #: ROUND TRIPS to the control-plane home rank. A one-way cut
        #: (the asymmetric fault) kills the round trip even though the
        #: minority still hears the majority — exactly why a lease
        #: renewal must be an acknowledged exchange, not a received
        #: beat. Confirm grace is half the membership detector's:
        #: park-before-actuate, so the minority is parked BEFORE the
        #: majority's failover can create a second primary.
        self._ack_detector = PhiAccrualDetector(
            self.clock, range(n),
            confirm_grace=2 * HEARTBEAT_INTERVAL,
        )
        #: ranks whose quorum lease lapsed (parked while fenced)
        self._quorum_lost: set = set()
        #: rank -> the view epoch it parked under (the stale epoch its
        #: heal-time straggler presents to the rail)
        self._park_epoch: Dict[int, int] = {}
        #: ranks the membership detector confirmed dead WHILE a
        #: partition was in flight — rejoined at heal even if their
        #: ack lease never lapsed (they are alive behind the cut)
        self._partition_confirmed: set = set()
        self.partitions_injected = 0
        self.quorum_losses = 0
        self.quorum_rejections = 0
        self.heal_rejoins = 0
        self.split_brain_accepts = 0
        self.quorum_decisions: List[QuorumDecision] = []
        self.healed_partitions: List[Dict] = []
        self._bootstrap()
        #: the demand-elasticity controller
        #: (:class:`smi_tpu_torch.serving.elasticity.ElasticityController`)
        #: — None = elasticity off, byte-for-byte the pre-r16 loop.
        #: Bound AFTER bootstrap: parking the spare ranks is a real
        #: scale-in (epoch bump + ctl.scale), loud from tick zero.
        self.elasticity = elasticity
        if self.elasticity is not None:
            self.elasticity.bind(self)

    # -- clock & membership plumbing ------------------------------------

    def _bootstrap(self) -> None:
        """Seed the detector's inter-arrival window before any traffic
        (the elastic soak's discipline): four quiet heartbeat periods,
        no transitions allowed."""
        for _ in range(4):
            for _ in range(HEARTBEAT_INTERVAL):
                self.clock.advance(1)
                self._heartbeats()
                for tr in self.detector.poll():
                    raise RuntimeError(
                        f"transition during bootstrap: {tr}"
                    )

    def _heartbeats(self) -> None:
        if self.clock.now() < self._next_beat:
            return
        now = self.clock.now()
        # the control plane's heartbeat sink sits at the lowest live
        # member (``home``): a partition-class fault partitions this
        # front-end exactly when it cuts ranks off from that side
        fault = self._partition
        live = sorted(r for r in self.view.members
                      if r not in self.killed)
        home = live[0] if live else None
        for r in sorted(self.view.members):
            if r in self.killed:
                continue
            if (fault is not None and home is not None and r != home
                    and fault.blocks(r, home, now)):
                continue  # the beat never crosses the cut
            self.detector.heartbeat(r)
        # lease acks: every live rank renews its quorum lease with a
        # ROUND TRIP to home — an asymmetric cut (outbound lost,
        # inbound fine) fails the renewal even though the rank still
        # hears the majority, which is what makes the minority side of
        # an asymmetric partition detectable at all
        if home is not None:
            for r in sorted(set(range(self.n)) - self.killed):
                if (r == home or fault is None
                        or (not fault.blocks(r, home, now)
                            and not fault.blocks(home, r, now))):
                    self._ack_detector.heartbeat(r)
        self._next_beat = (
            self.clock.now() + HEARTBEAT_INTERVAL
            + self.rng.randrange(-1, 2)
        )

    def kill(self, rank: int) -> None:
        """Crash-stop a rank: no more heartbeats, no more consumption.
        Membership learns of it only through phi-accrual — the window
        in which "dead" and "saturated" look identical at the edge."""
        if not 0 <= rank < self.n:
            raise ValueError(f"rank {rank} out of range")
        self.killed.add(rank)
        self._kill_tick = self.clock.now()

    def inject_partition(self, fault) -> None:
        """Arm a partition-class fault (:class:`~smi_tpu_torch.parallel
        .faults.PartitionFault` / ``AsymmetricLinkFault`` /
        ``FlappingLink``) against the control plane's heartbeat and
        lease traffic. The fault's tick window is absolute clock
        ticks; one fault at a time — heal processing re-arms."""
        from smi_tpu_torch.parallel.faults import (
            AsymmetricLinkFault,
            FlappingLink,
            PartitionFault,
        )
        if not isinstance(fault, (PartitionFault, AsymmetricLinkFault,
                                  FlappingLink)):
            raise TypeError(
                f"inject_partition wants a partition-class fault "
                f"(PartitionFault / AsymmetricLinkFault / "
                f"FlappingLink), got {type(fault).__name__}"
            )
        if self._partition is not None:
            raise RuntimeError(
                f"a partition fault is already in flight "
                f"({type(self._partition).__name__})"
            )
        self._partition = fault
        self.partitions_injected += 1

    def stall_consumer(self, rank: int, until_tick: int) -> None:
        """A live-but-stalled consumer (the saturation half of the
        dead-vs-saturated distinction): the lane stops consuming until
        the tick, wire credits exhaust, and backpressure must reach
        the admission edge — with NO membership consequence."""
        self.lanes[rank].stalled_until = max(
            self.lanes[rank].stalled_until, until_tick
        )

    # -- submission -----------------------------------------------------

    def submit(self, tenant: str, qos: str, chunks,
               base_rank: Optional[int] = None) -> Request:
        """One tenant request at the admission edge. Returns the
        :class:`Request` (admitted now, parked, or — when shed on the
        spot — raises the named
        :class:`~smi_tpu_torch.serving.qos.AdmissionRejected`).
        ``base_rank`` pins the stream's base destination (the MoE
        expert-dispatch path); ``None`` keeps tenant-hash routing."""
        check_qos(qos)
        if base_rank is not None and not 0 <= base_rank < self.n:
            raise ValueError(
                f"base_rank={base_rank} outside 0..{self.n - 1}"
            )
        seq = self._tenant_seq.get(tenant, 0)
        self._tenant_seq[tenant] = seq + 1
        request = Request(
            tenant=tenant, qos=qos, chunks=tuple(chunks),
            arrived_at=self.clock.now(), stream_id=(tenant, seq),
            base_rank=base_rank,
        )
        # the quorum gate (r17): a request arriving at a tenant whose
        # home rank sits on the parked minority side of a partition.
        # Fenced, the stale primary REFUSES it — loud, counted, named
        # — because accepting without a quorum lease is exactly how a
        # second primary is born. Unfenced (the demonstration arm) it
        # keeps accepting; when the majority has already rerouted the
        # tenant, that accept IS a split-brain incident.
        home = base_rank if base_rank is not None \
            else self.placement.base_of(tenant)
        if home is None:
            home = tenant_base_rank(tenant, self.n)
        if home in self._quorum_lost:
            if self.quorum_fencing:
                self.quorum_rejections += 1
                decision = QuorumDecision(
                    epoch=self.view.epoch, quorum=(home,),
                    verdict="rejected",
                )
                self.quorum_decisions.append(decision)
                self.recorder.emit(
                    "ctl.quorum", self.clock.now(), rank=home,
                    **decision.as_fields(),
                )
                raise QuorumLostError(
                    home, reachable={home},
                    needed=quorum_size(
                        max(len(self.view.members), 1),
                        self.quorum_fraction,
                    ),
                    what=f"new stream for tenant {tenant!r}",
                )
            if (home not in self.view.members
                    or home in self.detector.suspected):
                self.split_brain_accepts += 1
        # per-destination backpressure: a route whose destination
        # already holds its stream-cap of credits (stalled consumer,
        # undetected death) sheds at the edge with a named error —
        # class-blind but destination-targeted, so one sick rank can
        # never starve admission to the healthy ones
        dst = self._route_new(tenant, record=False, base=base_rank)
        if self._backlog(dst) >= self.dst_cap:
            raise self.gate.shed_named(
                request, f"backpressure:rank{dst}"
            )
        self.gate.offer(request, self.clock.now())
        return request

    def _route_new(self, tenant: str, record: bool = True,
                   base: Optional[int] = None) -> int:
        """Routing for a NEWLY admitted stream: the tenant's live
        owner, except that a *suspected* owner receives no new work —
        the phi-accrual two-threshold semantics (suspect = drain new
        work away, keep in the ring; confirm = shrink). New streams
        divert to the heir-presumptive among unsuspected members;
        in-flight streams stay put (suspicion is reversible — flapping
        half-finished streams on a false positive would replay for
        nothing). ``base`` overrides the tenant hash (the explicit
        MoE expert home); failover semantics are identical either
        way."""
        from smi_tpu_torch.parallel.recovery import heir_of

        if base is None:
            base = self.placement.place(
                tenant, self.view.members, self._rank_load
            )
        owner = route_owner(self.view, base, self.n)
        if owner is None:  # pragma: no cover - last member can't die
            raise RuntimeError("no surviving rank to route to")
        if owner in self.detector.suspected:
            trusted = self.view.members - self.detector.suspected
            if trusted:
                owner = heir_of(owner, trusted, self.n)
                if record:
                    self.drained_routes += 1
        return owner

    def _backlog(self, rank: int) -> int:
        return sum(1 for st in self.active if st.dst == rank)

    def _rank_load(self, rank: int) -> float:
        """The measured per-rank load placement and migration
        targeting read: wire-lane occupancy (the shipped gauge) plus
        the decayed credit-stall window — both maintained in
        :meth:`step`'s lane loop, so the signal is exactly what the
        blame engine convicts with."""
        occupancy = self.metrics.gauge(
            "wire_lane_occupancy", rank=rank,
        ).value
        return float(occupancy + self._recent_stalls.get(rank, 0))

    def _observe_send(self, stream, seq, lane, now) -> None:
        """The scheduler's per-chunk hook: one ``serve.send`` event +
        the sent-chunk counter, at the decision site."""
        self.recorder.emit(
            "serve.send", now, rank=lane.rank,
            tenant=stream.request.tenant, qos=stream.request.qos,
            chunk=seq, dst=lane.rank,
            stream_seq=stream.request.stream_id[1],
        )
        self.metrics.counter("sent_chunks_total",
                             qos=stream.request.qos).inc()

    def _on_shed(self, rejection, request: Request) -> None:
        """Every named shed burns the class's SLO error budget
        (tenant-rate excluded inside the engine — client-caused)."""
        self.slo.observe_shed(request.qos, rejection.reason,
                              self.clock.now())

    def _on_admit(self, request: Request, waited: int) -> None:
        """Acceptance: durable WAL contribution + deadline start +
        stream activation. From here on the request must be delivered
        bit-identically — it holds a stream credit until it is."""
        index = self._stream_count
        self._stream_count += 1
        wal = ProgressLog(rank=index)
        wal.contribution = request.chunks
        dst = self._route_new(request.tenant, base=request.base_rank)
        deadline = Deadline(
            float(request.deadline_ticks),
            clock=lambda: float(self.clock.now()),
            recorder=self.recorder,
        )
        self.active.append(StreamState(
            request=request, index=index, dst=dst,
            deadline=deadline, wal=wal,
            lane_epoch=self.view.epoch,
            admitted_at=self.clock.now(),
        ))
        if self.tuner is not None:
            # the plan world this stream was admitted under; a swap
            # completing while it is in flight re-plans (re-stamps) it
            self.plan_stamp[index] = self.tuner.total_plan_epoch()

    # -- the serving loop -----------------------------------------------

    def _state_provider(self):
        """Per-stream serving state for watchdog dumps: (text,
        structured) — the protocol-mirror discipline of
        :func:`faults.mirror_state_provider` at the serving tier."""
        state = {}
        for st in self.active:
            state[st.index] = {
                "stream": st.request.stream_id,
                "qos": st.request.qos,
                "dst": st.dst,
                "sent": st.next_to_send,
                "delivered": len(st.delivered),
                "of": st.total_chunks,
            }
        lines = [
            f"  stream {v['stream']} ({v['qos']}) -> rank {v['dst']}: "
            f"{v['delivered']}/{v['of']} delivered, {v['sent']} sent"
            for v in state.values()
        ]
        return "\n".join(lines) or "  (no active streams)", state

    def _complete(self, st: StreamState) -> None:
        st.completed_at = self.clock.now()
        assembled = tuple(
            st.delivered[i] for i in range(st.total_chunks)
        )
        if assembled != st.request.chunks:
            # the one forbidden outcome: counted, and the campaign
            # gate fails the run
            self.silent_corruptions += 1
        self.delivered[st.request.qos] += 1
        self.recorder.emit(
            "serve.complete", st.completed_at, rank=st.dst,
            tenant=st.request.tenant, qos=st.request.qos, dst=st.dst,
            stream_seq=st.request.stream_id[1],
        )
        self.metrics.counter("delivered_total",
                             qos=st.request.qos).inc()
        self.metrics.histogram(
            "stream_latency_ticks", qos=st.request.qos,
        ).observe(st.completed_at - st.admitted_at)
        self.slo.observe_delivery(
            st.request.qos, st.completed_at - st.admitted_at,
            st.completed_at,
        )
        self.active.remove(st)
        self.completed.append(st)
        self.plan_stamp.pop(st.index, None)
        self.gate.release(st.request.qos, self.clock.now())

    def _consume(self) -> None:
        now = self.clock.now()
        for lane in self.lanes:
            lane.land(now)
            if lane.rank in self.killed:
                continue
            if lane.stalled_until > now:
                continue
            budget = self.consume_rate
            while budget > 0 and lane.landed:
                item = lane.landed.popleft()
                lane.credits += 1  # the slot frees either way
                budget -= 1
                st = item.stream
                if item.lane_epoch != st.lane_epoch:
                    # a pre-failover chunk reached a live consumer:
                    # the DATA-PATH stale-epoch gate (not the
                    # synthetic injection in _failover) — it must be
                    # rejected by epoch before any seq/dst reasoning;
                    # a validate() that passed here would mean the
                    # epoch machinery lost track of a failover, which
                    # is exactly what the leak counter exists to catch
                    try:
                        self.view.validate(
                            lane.rank, item.view_epoch,
                            what="pre-failover chunk",
                        )
                        self.stale_epoch_leaks += 1
                    except StaleEpochError:
                        self.stale_epoch_rejections += 1
                    continue
                try:
                    payload = verify_chunk(lane, item,
                                           recorder=self.recorder)
                except IntegrityError as e:
                    if e.kind == "checksum":
                        self.integrity_detections += 1
                    else:
                        self.resequenced += 1
                    self.metrics.counter("integrity_errors_total",
                                         kind=e.kind).inc()
                    if not st.complete and st.dst == lane.rank:
                        # replay from the receiver's expectation — the
                        # recovery's discipline: only undelivered chunks move
                        want = lane.next_seq.get(st.lane_key, 0)
                        if want < st.next_to_send:
                            delta = st.next_to_send - want
                            self.replayed_chunks += delta
                            st.replayed_chunks += delta
                            st.next_to_send = want
                            self._observe_replay(st, delta,
                                                 "integrity")
                    continue
                if st.complete or st.dst != lane.rank:
                    continue  # straggler to a failed-over route
                st.delivered[item.seq] = payload
                st.wal.record((st.index, item.seq), payload)
                self.recorder.emit(
                    "serve.consume", now, rank=lane.rank,
                    tenant=st.request.tenant, qos=st.request.qos,
                    chunk=item.seq, dst=lane.rank,
                    stream_seq=st.request.stream_id[1],
                )
                self.metrics.counter("consumed_chunks_total",
                                     qos=st.request.qos).inc()
                if st.complete:
                    self._complete(st)

    def _observe_replay(self, st: StreamState, chunks: int,
                        reason: str) -> None:
        self.recorder.emit(
            "serve.replay", self.clock.now(), rank=st.dst,
            tenant=st.request.tenant, qos=st.request.qos,
            chunks=chunks, reason=reason,
            stream_seq=st.request.stream_id[1],
        )
        self.metrics.counter("replayed_chunks_total",
                             reason=reason).inc(chunks)

    def _failover(self, dead: int) -> None:
        """Membership confirmed a death: shrink, re-route, replay."""
        old_epoch = self.view.epoch
        self.view.confirm_dead(dead)
        self.metrics.counter("epoch_bumps_total",
                             reason="shrink").inc()
        if self.detect_ticks is None and self._kill_tick is not None:
            self.detect_ticks = self.clock.now() - self._kill_tick
        self.lost_in_flight += self.lanes[dead].drop_all()
        for st in self.active:
            if st.dst != dead:
                # a live route stays put — including one the suspect
                # diversion already steered away from its base owner:
                # flapping a partially-delivered stream onto whatever
                # route_owner(base) now says (possibly a still-
                # suspected, saturated rank) would abandon progress
                # for nothing
                continue
            owner = self._route_new(st.request.tenant, record=False,
                                    base=st.request.base_rank)
            # the reroute is an event of its own (distinct from the
            # replay below, which only fires when chunks actually
            # move): the span builder charges the stream's blackout
            # wait to the DEAD destination, not to the heir it lands
            # on afterwards — a queued-never-sent stream still spent
            # its time waiting on the rank that died
            self.recorder.emit(
                "serve.reroute", self.clock.now(), rank=dead,
                tenant=st.request.tenant, qos=st.request.qos,
                src=dead, dst=owner,
                stream_seq=st.request.stream_id[1],
            )
            if (self.on_failover_reroute is not None
                    and self.on_failover_reroute(st, dead, owner)):
                # the engine restored the stream's progress at the
                # heir from its own durable checkpoint (the KV-shard
                # handoff path): route is already re-keyed, nothing
                # to void or replay
                continue
            # the dead consumer's partial state died with it: void
            # the stream's delivery record and replay everything
            # from the durable contribution on a fresh lane
            st.wal.void_deliveries()
            st.delivered.clear()
            self.replayed_chunks += st.next_to_send
            st.replayed_chunks += st.next_to_send
            if st.next_to_send:
                self._observe_replay(st, st.next_to_send, "failover")
            st.next_to_send = 0
            st.lane_epoch = self.view.epoch
            st.dst = owner
        # one straggler from the dead incarnation arrives after the
        # shrink: it must be rejected by epoch, never folded in
        try:
            self.view.validate(dead, old_epoch, what="straggler chunk")
            self.stale_epoch_leaks += 1
        except StaleEpochError:
            self.stale_epoch_rejections += 1

    # -- partition tolerance (r17) --------------------------------------

    def _reachable(self) -> frozenset:
        """The members the control plane currently hears — the
        evidence set every quorum mint is judged against."""
        return (frozenset(self.view.members)
                - frozenset(self.detector.suspected)
                - frozenset(self.detector.dead)
                - frozenset(self.killed))

    def mint_quorum_token(self, rank: int = -1,
                          what: str = "actuation"):
        """A :class:`FencingToken` over the currently-reachable
        members, or None when fencing is off (``token=None``
        downgrades every fenced actuator to the trivially-quorate
        full-member mint — byte-for-byte the pre-r17 behaviour).
        Raises :class:`QuorumLostError`, loudly, when the reachable
        set cannot muster a quorum."""
        if not self.quorum_fencing:
            return None
        return mint_fencing_token(
            self.view, reachable=self._reachable(),
            fraction=self.quorum_fraction, rank=rank, what=what,
        )

    def _poll_quorum(self, now: int) -> None:
        """Drain the lease detector. A confirmed lapse — phi past the
        dead threshold AND held through the (shortened) grace — parks
        the rank: its quorum lease is gone. Suspect/clear episodes are
        the hysteresis doing its job (a flapping link produces plenty
        of them and must produce NO parks), so they are deliberately
        ignored. Outside a partition window the transitions are
        drained and discarded — a crash-stopped rank also stops
        acking, and that is the membership detector's verdict to
        make, not the lease detector's."""
        transitions = self._ack_detector.poll()
        if self._partition is None:
            return
        for tr in transitions:
            if not isinstance(tr, ConfirmedDead):
                continue
            r = tr.rank
            if r in self.killed or r in self._quorum_lost:
                continue
            self._quorum_lost.add(r)
            self._park_epoch[r] = self.view.epoch
            self.quorum_losses += 1
            decision = QuorumDecision(
                epoch=self.view.epoch, quorum=(r,), verdict="lost",
            )
            self.quorum_decisions.append(decision)
            self.recorder.emit("ctl.quorum", now, rank=r,
                               **decision.as_fields())
            self.metrics.counter("quorum_transitions_total",
                                 kind="lost").inc()

    def _drive_partition(self, now: int) -> None:
        """Heal processing: once the fault window closes, every parked
        (or partition-confirmed) rank rejoins. A rank the majority
        shrank away rejoins via the regrow rail UNDER A FRESH EPOCH —
        and first presents its parked incarnation's stale epoch to the
        :class:`StaleEpochError` straggler rail exactly once, which
        must bounce (counted, never folded in)."""
        fault = self._partition
        if now < fault.until_tick:
            return
        healed = []
        rejoining = sorted(
            (self._quorum_lost | self._partition_confirmed)
            - self.killed
        )
        for r in rejoining:
            self._ack_detector.forget(r)
            if r not in self.view.members:
                try:
                    self.view.validate(
                        r, self._park_epoch.get(r, 0),
                        what="parked-rank straggler",
                    )
                    self.stale_epoch_leaks += 1
                except StaleEpochError:
                    self.stale_epoch_rejections += 1
                regrow_pod(
                    self.view, self.detector, r,
                    reason="heal-rejoin",
                    token=self.mint_quorum_token(
                        rank=r, what=f"heal rejoin of rank {r}",
                    ),
                )
            self._quorum_lost.discard(r)
            self._partition_confirmed.discard(r)
            self._park_epoch.pop(r, None)
            self.heal_rejoins += 1
            decision = QuorumDecision(
                epoch=self.view.epoch, quorum=(r,), verdict="rejoin",
            )
            self.quorum_decisions.append(decision)
            self.recorder.emit("ctl.quorum", now, rank=r,
                               **decision.as_fields())
            self.metrics.counter("quorum_transitions_total",
                                 kind="rejoin").inc()
            healed.append(r)
        self.healed_partitions.append({
            "fault": type(fault).__name__, "healed_at": now,
            "rejoined": healed,
        })
        self._partition = None

    def step(self) -> None:
        """One tick of the serving loop. Order matters and is fixed:
        heartbeats/detection first (failover reroutes before sends),
        then landing+consumption (frees credits), then scheduling
        (uses them), then the admission pump (newly freed stream
        credits admit pending requests highest-class-first)."""
        self.clock.advance(1)
        now = self.clock.now()
        self._heartbeats()
        for tr in self.detector.poll():
            if isinstance(tr, SuspectRank):
                self.suspected.append(tr.rank)
                self.recorder.emit("ctl.suspect", now, rank=tr.rank,
                                   reason=f"phi={tr.phi:.2f}")
                self.metrics.counter("membership_transitions_total",
                                     kind="suspect").inc()
            elif isinstance(tr, SuspicionCleared):
                self.cleared.append(tr.rank)
                self.recorder.emit("ctl.clear", now, rank=tr.rank)
                self.metrics.counter("membership_transitions_total",
                                     kind="clear").inc()
            elif isinstance(tr, ConfirmedDead):
                if self._partition is not None:
                    # the rank is (probably) alive behind the cut:
                    # remember it for heal-time rejoin, and fence the
                    # failover itself — a control plane that cannot
                    # mint a quorum token is the MINORITY side and
                    # must park its actuation, not shrink the view
                    self._partition_confirmed.add(tr.rank)
                    if self.quorum_fencing:
                        try:
                            self.mint_quorum_token(
                                rank=tr.rank,
                                what=f"failover of rank {tr.rank}",
                            )
                        except QuorumLostError:
                            continue
                self.confirmed.append(tr.rank)
                self.recorder.emit("ctl.confirm", now, rank=tr.rank)
                self.metrics.counter("membership_transitions_total",
                                     kind="confirm").inc()
                self._failover(tr.rank)
        self._poll_quorum(now)
        self._consume()
        for lane in self.lanes:
            lane.view_epoch = self.view.epoch
        provider = self._state_provider
        if self.scheduler.check_deadlines:
            # the send-time checks only fire while a stream still has
            # chunks to schedule; a fully-sent stream parked behind a
            # stalled consumer must ALSO surface when its budget runs
            # out — every active stream is checked every tick, so an
            # accepted stream can never miss its deadline silently
            for st in list(self.active):
                st.deadline.with_provider(provider).check(
                    f"stream {st.request.stream_id} "
                    f"({st.request.qos}) awaiting delivery at rank "
                    f"{st.dst} ({len(st.delivered)}/"
                    f"{st.total_chunks} delivered)"
                )
        # a draining migration freezes its streams' sends (delivery
        # continues — that IS the drain); everything else schedules
        # exactly as before
        schedulable = self.active
        if self._migration is not None:
            frozen = self._migration["streams"]
            schedulable = [st for st in self.active
                           if st.index not in frozen]
        for lane in self.lanes:
            self.scheduler.schedule_lane(
                lane, schedulable, now, provider
            )
            # wire-lane occupancy + credit stalls, AFTER scheduling:
            # a zero-credit lane with chunks still to move is a
            # stalled wire (the backpressure the credit chain exists
            # to propagate) — counted per tick, per rank
            self.metrics.gauge(
                "wire_lane_occupancy", rank=lane.rank,
            ).set(WIRE_CREDITS - lane.credits)
            self._recent_stalls[lane.rank] //= 2
            if lane.credits == 0 and any(
                st.dst == lane.rank
                and st.next_to_send < st.total_chunks
                for st in self.active
            ):
                self._recent_stalls[lane.rank] += 2
                self.metrics.counter("credit_stall_ticks",
                                     rank=lane.rank).inc()
                # the span builder's credit-stall sub-span record:
                # one event per (tick, lane) AT the stall, same site
                # as the counter — the wire's zero-credit ticks are
                # carved out of the affected streams' queue spans
                self.recorder.emit("serve.stall", now, rank=lane.rank,
                                   dst=lane.rank)
        self.gate.pump(now)
        self.slo.evaluate(now)
        if self.tuner is not None:
            self._drive_retune(now)
        if self._migration is not None:
            self._drive_migration(now)
        if self._partition is not None:
            self._drive_partition(now)
        if self.elasticity is not None:
            self.elasticity.step(now)
        self.gate.assert_bounded()

    # -- online retuning (r14) ------------------------------------------

    def _retune_drain_census(self, evidence) -> frozenset:
        """The in-flight streams keyed to the plan a proposal wants to
        retire: the proposing tenant's active streams (per-tenant
        specialization is the point of online retuning), or every
        active stream for a tenant-less cell."""
        tenant = evidence.get("tenant")
        return frozenset(
            st.index for st in self.active
            if tenant is None or st.request.tenant == tenant
        )

    def _drive_retune(self, now: int) -> None:
        """One swap-machine transition per tick per plan key: propose
        -> quiesce -> (drain) -> swap -> commit, with quiesce-timeout
        rollback. At every swap the old plan epoch is presented once
        as a straggler and must be rejected loudly
        (:class:`~smi_tpu_torch.tuning.swap.StalePlanError` — counted,
        never folded in), and every still-active stream NOT in the
        drain set is re-planned onto the new epoch."""
        tuner = self.tuner
        tuner.maybe_propose(now, drain_census=self._retune_drain_census)
        for swap in tuner.pending_swaps():
            if swap.state == "proposed":
                tuner.start_quiesce(swap, now)
            elif swap.state == "quiescing":
                drain = swap.proposal.drain
                still = [st for st in self.active
                         if st.index in drain]
                if not still:
                    old_epoch = swap.plan_epoch
                    tuner.execute_swap(swap)
                    total = tuner.total_plan_epoch()
                    tenant = swap.proposal.evidence.get("tenant")
                    for st in self.active:
                        if self.plan_stamp.get(st.index) != total:
                            self.plan_stamp[st.index] = total
                            if (tenant is None
                                    or st.request.tenant == tenant):
                                self.replanned_streams += 1
                    # the straggler: one sample/chunk planned under
                    # the retired entry presents its old plan epoch
                    # after the bump — reject, count, never fold in
                    try:
                        swap.validate(old_epoch,
                                      what="post-swap straggler")
                        self.stale_plan_leaks += 1
                    except StalePlanError:
                        self.stale_plan_rejections += 1
                elif (swap.quiesce_started is not None
                      and now - swap.quiesce_started
                      > tuner.quiesce_timeout):
                    tuner.rollback(swap, "quiesce-timeout", now)
            elif swap.state == "swapped":
                tuner.commit(swap)

    # -- live tenant migration (r16) ------------------------------------

    def request_migration(self, tenant: str, dst: int,
                          reason: str = "demand") -> None:
        """Start a live migration of ``tenant`` onto member ``dst``:
        drain -> handoff -> cutover -> commit, one state per tick,
        every transition a ``ctl.migrate`` event. The tenant's
        in-flight streams freeze their sends, the wire drains, the
        delivered state crosses as a CRC-framed checkpoint shard
        (:func:`~smi_tpu_torch.parallel.checkpoint.pack_shard`), and the
        cutover bumps the membership epoch so stragglers from the old
        route are rejected as :class:`StaleEpochError` — never folded
        in. Zero lost-accepted by construction: nothing is dropped,
        voided, or replayed on the happy path."""
        if self._migration is not None:
            raise RuntimeError(
                f"migration already in flight for tenant "
                f"{self._migration['tenant']!r} "
                f"({self._migration['state']})"
            )
        if dst not in self.view.members:
            raise ValueError(
                f"migration destination rank {dst} is not a member "
                f"(members: {sorted(self.view.members)})"
            )
        src = self._route_new(tenant, record=False)
        if src == dst:
            raise ValueError(
                f"tenant {tenant!r} is already served by rank {dst}"
            )
        streams = frozenset(
            st.index for st in self.active
            if st.request.tenant == tenant and st.dst == src
        )
        self._migration = {
            "tenant": tenant, "src": src, "dst": dst,
            "state": "draining", "streams": streams, "blob": None,
            "reason": reason, "requested_at": self.clock.now(),
        }
        self._emit_migrate("draining")

    def _emit_migrate(self, state: str) -> None:
        mig = self._migration
        self.recorder.emit(
            "ctl.migrate", self.clock.now(), rank=mig["src"],
            src=mig["src"], dst=mig["dst"], state=state,
            tenant=mig["tenant"],
        )
        self.metrics.counter("migration_transitions_total",
                             state=state).inc()

    def _migration_drained(self) -> bool:
        """True once no frozen stream has a frame on the source wire
        (in flight or landed-unconsumed) — sends are frozen, so this
        is monotone while the consumer lives."""
        mig = self._migration
        lane = self.lanes[mig["src"]]
        frozen = mig["streams"]
        return not any(
            item.stream.index in frozen
            for queue in (lane.in_flight, lane.landed)
            for item in queue
        )

    def _drive_migration(self, now: int) -> None:
        """One migration state transition per tick. A membership
        change touching either party aborts loudly first: after a
        failover has rerouted (voided, replayed) the frozen streams,
        restoring the handoff snapshot would resurrect stale state."""
        mig = self._migration
        if (mig["src"] not in self.view.members
                or mig["dst"] not in self.view.members):
            self._abort_migration("membership-change")
            return
        if mig["state"] == "draining":
            if self._migration_drained():
                self._migration_handoff(now)
        elif mig["state"] == "handoff":
            try:
                self._migration_cutover(now)
            except QuorumLostError:
                # the cutover's quorum mint failed: the control plane
                # is partitioned away from a majority. Cutting over
                # anyway could commit the tenant on BOTH sides — abort
                # loudly instead, loss-free (the frozen streams thaw
                # and finish on the source)
                self._abort_migration("quorum-lost")
        elif mig["state"] == "cutover":
            self._migration_commit(now)

    def _migration_handoff(self, now: int) -> None:
        """Pack the drained streams' delivered state into a checkpoint
        shard — the same CRC+seq framing the elastic soak writes to
        disk, here as the in-memory handoff transport. After a full
        drain every sent chunk was consumed, so delivered state and
        send cursor agree; the cutover restores BOTH from the shard
        (the blob is load-bearing, not ceremonial)."""
        mig = self._migration
        snapshot = sorted(
            (st.index, (dict(sorted(st.delivered.items())),
                        st.next_to_send))
            for st in self.active if st.index in mig["streams"]
        )
        payload = pickle.dumps(snapshot)
        blob, _crc = pack_shard(mig["src"], self.view.epoch, payload)
        mig["blob"] = blob
        mig["state"] = "handoff"
        self._emit_migrate("handoff")

    def _migration_cutover(self, now: int) -> None:
        mig = self._migration
        # mint BEFORE touching any state: a QuorumLostError here must
        # leave the migration cleanly abortable (nothing restored,
        # nothing re-routed, no epoch moved)
        token = self.mint_quorum_token(
            rank=mig["dst"],
            what=f"migration cutover {mig['src']}->{mig['dst']}",
        )
        _rank, _step, payload, _crc = unpack_shard(
            mig["blob"], origin=f"migration:{mig['tenant']}",
        )
        restored = dict(pickle.loads(payload))
        old_epoch = self.view.epoch
        new_epoch = self.view.migrate_cutover(
            mig["src"], mig["dst"], tenant=mig["tenant"], token=token,
        )
        self.metrics.counter("epoch_bumps_total",
                             reason="migrate").inc()
        dst_lane = self.lanes[mig["dst"]]
        for st in self.active:
            if st.index not in mig["streams"]:
                continue
            handed = restored.get(st.index)
            if handed is None:
                # the forbidden outcome: an accepted stream's state
                # missing from the shard packed at handoff
                raise RuntimeError(
                    f"migration handoff lost stream "
                    f"{st.request.stream_id}: not in the shard "
                    f"packed at handoff"
                )
            delivered, next_to_send = handed
            st.delivered = dict(delivered)
            st.next_to_send = next_to_send
            st.dst = mig["dst"]
            st.lane_epoch = new_epoch
            # the destination's dense-sequence expectation continues
            # where the source's left off — remaining chunks arrive
            # as seq next_to_send, next_to_send+1, ... on the fresh
            # (index, epoch) lane
            dst_lane.next_seq[(st.index, new_epoch)] = next_to_send
            self.migrated_streams += 1
        # one straggler from the old route presents the pre-cutover
        # epoch: it must be rejected by epoch, never folded in
        try:
            self.view.validate(mig["src"], old_epoch,
                               what="post-migration straggler")
            self.stale_epoch_leaks += 1
        except StaleEpochError:
            self.stale_epoch_rejections += 1
        self.placement.pin(mig["tenant"], mig["dst"],
                           reason="migrate", token=token)
        mig["state"] = "cutover"
        # the ctl.migrate cutover event itself is emitted by
        # MembershipView.migrate_cutover, at the epoch-bump site

    def _migration_commit(self, now: int) -> None:
        mig = self._migration
        mig["state"] = "committed"
        self._emit_migrate("committed")
        self.migrations.append({
            "tenant": mig["tenant"], "src": mig["src"],
            "dst": mig["dst"], "state": "committed",
            "reason": mig["reason"], "streams": len(mig["streams"]),
            "requested_at": mig["requested_at"], "committed_at": now,
        })
        self._migration = None

    def _abort_migration(self, why: str) -> None:
        mig = self._migration
        self._emit_migrate("aborted")
        self.migrations.append({
            "tenant": mig["tenant"], "src": mig["src"],
            "dst": mig["dst"], "state": "aborted",
            "reason": mig["reason"], "abort_reason": why,
            "streams": len(mig["streams"]),
            "requested_at": mig["requested_at"],
            "aborted_at": self.clock.now(),
        })
        self._migration = None

    def drain(self, max_ticks: int = 5000) -> None:
        """Run the loop until every accepted stream completes. A
        stream that cannot finish hits its per-chunk deadline
        (``WatchdogTimeout`` with the serving state dump) long before
        the tick bound; the bound is the backstop for a scheduler bug,
        and exceeding it raises with the same dump."""
        for _ in range(max_ticks):
            if not self.active and not any(
                q for q in self.gate.pending.values()
            ):
                return
            self.step()
        text, state = self._state_provider()
        raise RuntimeError(
            f"drain did not converge in {max_ticks} ticks; "
            f"active streams:\n{text}"
        )

    # -- report ---------------------------------------------------------

    def report(self) -> Dict:
        gate = self.gate
        delivered_total = sum(self.delivered.values())
        accepted_total = sum(gate.admitted.values())
        # accepted == delivered + still-active; after a full drain
        # active is empty, so any imbalance IS a lost accepted stream
        return {
            "n": self.n,
            "epoch": self.view.epoch,
            "members": sorted(self.view.members),
            "submitted": {
                c: gate.admitted[c] + gate.shed_total(c)
                for c in QOS_CLASSES
            },
            "accepted": dict(gate.admitted),
            "shed": {c: dict(gate.shed[c]) for c in QOS_CLASSES},
            "delivered": dict(self.delivered),
            "lost_accepted": accepted_total - delivered_total
            - len(self.active),
            "in_flight": len(self.active),
            "silent_corruptions": self.silent_corruptions,
            "integrity_detections": self.integrity_detections,
            "resequenced": self.resequenced,
            "replayed_chunks": self.replayed_chunks,
            "lost_in_flight": self.lost_in_flight,
            "stale_epoch_rejections": self.stale_epoch_rejections,
            "stale_epoch_leaks": self.stale_epoch_leaks,
            "drained_routes": self.drained_routes,
            "suspected": list(self.suspected),
            "cleared": list(self.cleared),
            "confirmed": list(self.confirmed),
            "detect_ticks": self.detect_ticks,
            "max_queue_depth": gate.max_queue_depth,
            "queue_bound": gate.pool * (1 + len(QOS_CLASSES)),
            "admission_waits": {
                c: list(gate.admission_waits[c]) for c in QOS_CLASSES
            },
            # the observability accounting: total/dropped event counts
            # (dropped by the ring bound — counted, never silent) and
            # the per-kind histogram of everything this run emitted
            "obs": {
                "total_events": self.recorder.total_events,
                "dropped_events": self.recorder.dropped_events,
                "recorder_capacity": self.recorder.capacity,
                "event_counts": dict(sorted(
                    self.recorder.counts.items()
                )),
            },
            # the burn-rate health snapshot (r15): per-class SLO
            # state, riding every campaign report and selftest
            "health": self.slo.health(),
            **({"retune": {
                **self.tuner.summary(),
                "replanned_streams": self.replanned_streams,
                "stale_plan_rejections": self.stale_plan_rejections,
                "stale_plan_leaks": self.stale_plan_leaks,
            }} if self.tuner is not None else {}),
            # the demand-elasticity snapshot (r16): controller state,
            # placement audit, migration trail — None = key absent,
            # byte-for-byte the pre-r16 report
            **({"elasticity": {
                **self.elasticity.report(),
                "placement": self.placement.report(),
                "migrations": list(self.migrations),
                "migrated_streams": self.migrated_streams,
            }} if self.elasticity is not None else {}),
            # the partition-tolerance snapshot (r17): quorum lease
            # verdicts, parked ranks, heal rejoins, and the one number
            # that must stay zero — split-brain incidents. No
            # partition injected = key absent, byte-for-byte the
            # pre-r17 report
            **({"partition": {
                "fenced": self.quorum_fencing,
                "partitions_injected": self.partitions_injected,
                "quorum_losses": self.quorum_losses,
                "quorum_rejections": self.quorum_rejections,
                "heal_rejoins": self.heal_rejoins,
                "split_brain_incidents": self.split_brain_accepts,
                "parked": sorted(self._quorum_lost),
                "healed": list(self.healed_partitions),
                "decisions": [d.as_fields()
                              for d in self.quorum_decisions],
            }} if self.partitions_injected else {}),
        }
