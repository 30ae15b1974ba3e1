"""Explicit-state model checker for the control plane.

The port's copy of :mod:`smi_tpu.analysis.model`, kept in step with
it line for line. It drives the port's own membership, checkpoint,
recovery, plan-cache and serving objects.

PR 7's verifier proves the *wire* protocols deadlock- and race-free for
every schedule, but the control plane layered on top — phi-accrual
membership with epoch bumps, WAL replay, and the serving admission /
backpressure / shedding gates — has so far only been *sampled* by
seeded chaos campaigns. This module closes that gap the same way the
reference's routing tables are verifiable by construction: exhaustive
small-scope verification (the "small scope hypothesis": control-plane
bugs manifest at tiny instance sizes) of the epoch, admission, and
recovery state machines.

The one design rule — **the transition functions drive the real
objects**. A :class:`World` composes the shipped
:class:`~smi_tpu_torch.serving.admission.AdmissionGate`,
:class:`~smi_tpu_torch.serving.scheduler.StreamScheduler` /
:class:`~smi_tpu_torch.serving.scheduler.WireLane`,
:class:`~smi_tpu_torch.parallel.membership.MembershipView` /
:class:`~smi_tpu_torch.parallel.membership.PhiAccrualDetector`, and
:class:`~smi_tpu_torch.parallel.recovery.ProgressLog`, and every transition
calls their real methods (``offer``/``pump``/``release``,
``schedule_lane``, ``land``/``verify_chunk``,
``confirm_dead``/``regrow``/``validate``, ``heartbeat``/``poll``,
``record``/``void_deliveries``). There is no hand-written re-model to
drift from the shipped code; the only model-owned glue is the thin
frontend wiring (routing, failover, rejoin) that
:class:`~smi_tpu_torch.serving.frontend.ServingFrontend` performs between
those same calls, and the control-plane mutants of
:mod:`smi_tpu_torch.analysis.mutants` break exactly that glue (or swap in a
broken subclass of one real object) to prove each property can fail.

Exploration is breadth-first over **canonicalized** states:

- the fingerprint renders only *relative* time (ages, deltas), so the
  unbounded step clock never splits behaviourally identical states;
- **symmetry reduction** on tenant and rank identities: the fingerprint
  is minimized over all (tenant, rank) permutation pairs compatible
  with the deterministic tenant->base-rank routing, so interchangeable
  tenants/ranks collapse to one orbit representative;
- BFS order makes the first violation found a **minimal** (shortest)
  counterexample trace; the trace is a plain tuple of named actions
  that :func:`smi_tpu_torch.serving.campaign.replay_model_trace` re-executes
  against a fresh ``World`` as a failing campaign cell — differential
  soundness in both directions;
- a state budget bounds runaway scopes with the same loud
  ``ScheduleCount``-style coverage reporting as
  ``credits.explore_all_schedules``: a truncated run warns AND carries
  ``explored``/``frontier``/``estimated_total``/``truncated`` in its
  report, so "no silent caps" holds for machine consumers too.

The action alphabet (one BFS edge each):

- ``tick`` — advance one heartbeat period with NO beats (the silence
  the detector must tolerate; quota-bounded by ``Scope.silence``),
  then poll the detector, land in-flight frames, pump admissions;
- ``heartbeat`` — the same period advance with every live, unkilled
  member beating first (the normal serving cadence);
- ``admit t`` — tenant ``t`` submits its next request through the
  real admission gate (sheds are named and recorded, never findings);
- ``send r`` — the real scheduler issues sends on rank ``r``'s lane
  until its wire credits or the ready work run out;
- ``consume r`` — rank ``r`` lands and consumes up to
  ``Scope.consume`` chunks (CRC + dense-sequence verification via the
  real :func:`~smi_tpu_torch.serving.scheduler.verify_chunk`);
- ``kill r`` — crash-stop rank ``r`` (no more beats, no more
  consumption; membership catches up through the real detector);
- ``rejoin r`` — the dead rank's new incarnation first presents its
  pre-shrink epoch (which the view must reject loudly), then regrows
  under a fresh epoch;
- ``plan_propose`` / ``plan_quiesce`` / ``plan_swap`` /
  ``plan_commit`` / ``plan_abort`` (``retune`` scopes only) — the r14
  online-retuning arc driven through a REAL
  :class:`~smi_tpu_torch.tuning.swap.PlanSwap` over a real plan cache: the
  swap may only install once the proposal's drain set (streams in
  flight under the plan being retired) has completed, installing
  bumps the plan epoch + entry revision and rejects a stale-plan
  straggler loudly, and an abort leaves the pre-proposal entry
  servable. Aborts are explored from the pre-swap states only — the
  shape the serving front-end actually drives (quiesce-timeout);
  PlanSwap's post-swap restore branch is covered by its unit tests,
  not by this exhaustive tier;
- ``mig_propose`` / ``mig_handoff`` / ``mig_cutover`` /
  ``mig_commit`` / ``mig_abort`` (``migrate`` scopes only) — the r16
  live-tenant-migration arc: the source lane's frozen streams drain,
  their delivered state crosses as a REAL CRC-framed checkpoint shard
  (:func:`~smi_tpu_torch.parallel.checkpoint.pack_shard`), the cutover
  bumps the membership epoch
  (:meth:`~smi_tpu_torch.parallel.membership.MembershipView.migrate_cutover`)
  and rejects a straggler from the old route loudly, and an abort
  before cutover leaves every stream where it was — zero
  lost-accepted either way (the ``migration-lost-accepted`` /
  ``placement-epoch-safety`` properties);
- ``scale_in`` / ``scale_out`` (``migrate`` scopes only) — the
  demand-elasticity capacity arc through the real actuators
  (:func:`~smi_tpu_torch.parallel.membership.shrink_pod` /
  :func:`~smi_tpu_torch.parallel.membership.regrow_pod`): scale-in parks a
  member only when it holds zero residents and an empty lane (the
  ``_scale_in_ok`` seam the ``scale_in_with_residents`` mutant
  breaks); scale-out re-admits it under a fresh incarnation;
- ``partition_start`` / ``partition_failover`` /
  ``minority_accept t`` / ``partition_heal`` (``partition`` scopes
  only) — the r17 partition-tolerance arc: a cut isolates one rank
  (the minority parks the moment its quorum lease lapses), the
  majority side may fail it over only when its reachable census is a
  majority quorum (the ``_quorum_ok`` seam the
  ``actuate_without_quorum`` mutant breaks), the stale side may never
  accept a new stream while parked (the ``_accept_ok`` seam the
  ``accept_in_minority`` mutant breaks — its stale claim colliding
  with the majority's heir is the ``no-split-brain`` conviction), and
  the heal rejoins a failed-over rank through the straggler rail +
  the real regrow actuators;
- ``generate r`` / ``kv_propose`` / ``kv_handoff`` / ``kv_cutover``
  / ``kv_commit`` / ``kv_abort`` (``infer`` scopes only) — the r20
  disaggregated-inference arc: a stream whose transport completed
  does NOT complete the request; its delivered chunks become the
  resident KV shard set at the decode destination and the request
  finishes only after ``chunks`` decode tokens are emitted from that
  residency (``generate``). The KV handoff sub-arc moves a source
  rank's resident shard sets to its successor: the drain keeps
  decoding at the source, the handoff fences the source's decode and
  packs shards + token cursors into a REAL CRC-framed checkpoint
  shard, the cutover restores FROM the shard under a bumped epoch
  (the ``_kv_resume`` seam the ``stale_kv_after_cutover`` mutant
  breaks — it reaches for the propose-time copy and rolls back every
  token decoded during the drain) and rejects an old-route straggler
  loudly. A decode death with resident KV takes the WAL-restore
  handoff path, never the stateless replay reserved for transport
  (prefill) streams (the ``_kv_failover`` seam the
  ``decode_failover_without_kv_handoff`` mutant breaks — it replays
  statelessly and strands the inventory on the dead rank, the
  ``kv-shard-safety`` conviction).

Scope: everything here is **fault-free wire, faulty control plane** —
the wire tier's own invariants are the PR 7 verifier's job; what is
checked exhaustively here is the layer above it, at scopes of at most
a few tenants x ranks x chunks (see :data:`DEFAULT_SCOPES`). What
exhaustive-at-small-scope does and does not prove is spelled out in
``docs/analysis.md``.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import pickle
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from smi_tpu_torch.parallel.membership import (
    HEARTBEAT_INTERVAL,
    ConfirmedDead,
    MembershipView,
    PhiAccrualDetector,
    StaleEpochError,
    StepClock,
    SuspectRank,
    SuspicionCleared,
    plan_regrow_ring,
    route_owner,
)
from smi_tpu_torch.parallel.checkpoint import pack_shard, unpack_shard
from smi_tpu_torch.parallel.credits import IntegrityError
from smi_tpu_torch.parallel.recovery import ProgressLog
from smi_tpu_torch.serving.admission import AdmissionGate
from smi_tpu_torch.serving.qos import QOS_CLASSES, Request
from smi_tpu_torch.serving.scheduler import (
    WIRE_CREDITS,
    StreamScheduler,
    StreamState,
    WireLane,
    verify_chunk,
)

#: Hard ceiling on tenants/ranks/chunks a scope may declare: the model
#: is an *exhaustive small-scope* tier, and larger instances belong to
#: the sampled campaigns (the state space grows combinatorially).
MAX_SCOPE_DIM = 3

#: Default BFS state budget. Exceeding it is never silent: the report
#: carries ``truncated``/``frontier``/``estimated_total`` and a
#: ``RuntimeWarning`` states the honest claim.
DEFAULT_BUDGET = 60_000


@dataclasses.dataclass(frozen=True)
class Scope:
    """One exhaustively-checked instance size.

    ``tenants``/``ranks``/``chunks`` are capped at
    :data:`MAX_SCOPE_DIM` (the small-scope contract); ``streams`` is
    requests per tenant; ``pool`` the stream-credit pool; ``kill`` the
    number of crash-stops the explorer may inject (0 or 1);
    ``silence`` the number of beat-less period advances the explorer
    may choose (the alive-but-silent scenarios); ``consume`` the
    chunks one consume action drains; ``starve`` the scope-scaled
    aging bound handed to the real scheduler; ``hot_rank`` (>= 0)
    replaces the modulo tenant->rank routing with a SKEWED one —
    every tenant's base rank is ``hot_rank`` (the hot-expert traffic
    matrix: one destination absorbs the whole offered load, the shape
    the MoE dispatch campaign samples and this scope checks
    exhaustively for queue-bound/starvation); ``-1`` keeps the
    uniform modulo routing; ``retune`` (0 or 1) arms the r14 online
    plan-swap arc — the world carries a REAL
    :class:`~smi_tpu_torch.tuning.swap.PlanSwap` over a real plan cache,
    the action alphabet grows ``plan_propose`` / ``plan_quiesce`` /
    ``plan_swap`` / ``plan_commit`` / ``plan_abort``, and the
    ``plan-epoch-safety`` / ``swap-lost-accepted`` properties become
    non-vacuous; ``migrate`` (0 or 1) arms the r16 demand-elasticity
    arc — live tenant migration (drain -> handoff -> cutover ->
    commit, checkpoint-shard transport, epoch-bumped cutover) plus
    one scale-in/scale-out round trip through the real membership
    actuators, and the ``migration-lost-accepted`` /
    ``placement-epoch-safety`` properties become non-vacuous;
    ``infer`` (0 or 1) arms the r20 disaggregated-inference arc —
    transport completion installs each stream's delivered chunks as
    a resident KV shard set and the request completes only after
    ``chunks`` decode tokens are generated from it, the action
    alphabet grows ``generate`` plus the ``kv_propose`` /
    ``kv_handoff`` / ``kv_cutover`` / ``kv_commit`` / ``kv_abort``
    handoff sub-arc, and the ``kv-shard-safety`` /
    ``generation-lost-accepted`` properties become non-vacuous.
    """

    tenants: int = 2
    ranks: int = 2
    chunks: int = 2
    streams: int = 1
    pool: int = 3
    kill: int = 0
    silence: int = 0
    consume: int = 2
    starve: int = 3
    hot_rank: int = -1
    retune: int = 0
    migrate: int = 0
    partition: int = 0
    infer: int = 0

    def __post_init__(self):
        for dim in ("tenants", "ranks", "chunks"):
            v = getattr(self, dim)
            if not 1 <= v <= MAX_SCOPE_DIM:
                raise ValueError(
                    f"scope {dim}={v} outside 1..{MAX_SCOPE_DIM}: the "
                    f"model tier is exhaustive-at-small-scope only — "
                    f"larger instances are the campaigns' job"
                )
        if self.streams < 1 or self.pool < 1 or self.consume < 1:
            raise ValueError(
                f"streams/pool/consume must be >= 1 (got "
                f"{self.streams}/{self.pool}/{self.consume})"
            )
        if self.kill not in (0, 1):
            raise ValueError(f"kill must be 0 or 1, got {self.kill}")
        if self.kill and self.ranks < 2:
            raise ValueError(
                "kill=1 needs ranks >= 2 (the last member cannot die)"
            )
        if self.silence < 0:
            raise ValueError(f"silence must be >= 0, got {self.silence}")
        if self.silence > 3:
            # >= 4 silent periods crosses the confirmation grace and a
            # healthy rank would be confirmed dead by design — a legal
            # behaviour, but one that turns every scope into a kill
            # scope; keep the knob below the grace so silence means
            # suspect-and-clear
            raise ValueError(
                f"silence={self.silence} reaches the confirmation "
                f"grace (4 periods): a healthy rank would be confirmed "
                f"dead; use kill=1 for death scenarios"
            )
        if self.starve < 1:
            raise ValueError(f"starve must be >= 1, got {self.starve}")
        if self.hot_rank != -1 and not 0 <= self.hot_rank < self.ranks:
            raise ValueError(
                f"hot_rank={self.hot_rank} outside the rank range "
                f"0..{self.ranks - 1} (-1 = uniform modulo routing)"
            )
        if self.retune not in (0, 1):
            raise ValueError(
                f"retune must be 0 or 1, got {self.retune} (one swap "
                f"arc per scope — the machine is key-local, so one "
                f"arc exhausts its interleavings)"
            )
        if self.migrate not in (0, 1):
            raise ValueError(
                f"migrate must be 0 or 1, got {self.migrate} (one "
                f"migration arc per scope — the front-end drives one "
                f"migration at a time, so one arc exhausts its "
                f"interleavings)"
            )
        if self.migrate and self.ranks < 2:
            raise ValueError(
                "migrate=1 needs ranks >= 2 (a migration needs a "
                "source and a distinct destination)"
            )
        if self.partition not in (0, 1):
            raise ValueError(
                f"partition must be 0 or 1, got {self.partition} (one "
                f"partition arc per scope — cut, explore, heal — "
                f"exhausts its interleavings)"
            )
        if self.partition and self.ranks < 2:
            raise ValueError(
                "partition=1 needs ranks >= 2 (a partition needs two "
                "sides)"
            )
        if self.infer not in (0, 1):
            raise ValueError(
                f"infer must be 0 or 1, got {self.infer} (one KV "
                f"handoff arc per scope — the front-end drives one "
                f"handoff at a time, so one arc exhausts its "
                f"interleavings)"
            )
        if self.infer and self.ranks < 2:
            raise ValueError(
                "infer=1 needs ranks >= 2 (a KV handoff needs a "
                "source and a distinct surviving destination)"
            )

    def describe(self) -> str:
        return ",".join(
            f"{f.name}={getattr(self, f.name)}"
            for f in dataclasses.fields(self)
        )

    def to_json(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def parse_scope(spec: str) -> Scope:
    """Parse a ``--scope`` spec like ``tenants=2,ranks=2,kill=1``.

    Loud on unknown keys, malformed values, and out-of-range
    dimensions — a typo'd scope must be a usage error, not a silently
    different verification run.
    """
    fields = {f.name for f in dataclasses.fields(Scope)}
    kwargs: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"malformed scope item {part!r} (want key=value); "
                f"known keys: {sorted(fields)}"
            )
        key, _, value = part.partition("=")
        key = key.strip()
        if key not in fields:
            raise ValueError(
                f"unknown scope key {key!r}; known: {sorted(fields)}"
            )
        try:
            kwargs[key] = int(value)
        except ValueError:
            raise ValueError(
                f"scope {key}={value.strip()!r} is not an integer"
            ) from None
    return Scope(**kwargs)


#: The scope grid ``smi-tpu lint --model --all`` verifies — each one
#: exhaustible in well under the default budget, together covering
#: admission/brownout, lane backpressure, scheduling contention,
#: alive-but-silent suspicion, and the kill->shrink->regrow arc.
#: docs/analysis.md's scope table quotes these (drift-guarded).
DEFAULT_SCOPES: Tuple[Scope, ...] = (
    # admission + brownout with all three QoS classes in play
    Scope(tenants=3, ranks=2, chunks=2, streams=1, pool=2),
    # one hot lane, recycled credits: scheduling contention + aging
    # (pool=3 lets two interactive streams exhaust the wire window
    # while a batch stream waits — the shape the aging bound exists
    # for)
    Scope(tenants=2, ranks=1, chunks=2, streams=3, pool=3, starve=3),
    # alive-but-silent: suspect -> clear without a kill
    Scope(tenants=1, ranks=2, chunks=2, streams=1, pool=2, silence=2),
    # the kill arc: detect -> shrink -> void+replay -> reject -> regrow
    Scope(tenants=2, ranks=2, chunks=2, streams=1, pool=3, kill=1,
          consume=1),
    # skewed routing: the hot-expert traffic matrix — all three QoS
    # classes hammer ONE destination while the other rank sits idle,
    # so the wire window, brownout ceilings, and aging bound are
    # exercised under maximal per-route contention (the exhaustive
    # counterpart of the MoE hot-expert campaign cell)
    Scope(tenants=3, ranks=2, chunks=2, streams=1, pool=2, hot_rank=0),
    # the r14 plan-swap arc: propose -> quiesce -> swap ->
    # commit/abort interleaved with admissions/sends/consumes —
    # plan-epoch-safety and swap-lost-accepted checked on every
    # reachable state (the exhaustive counterpart of the seeded
    # payload-shift retune cell)
    Scope(tenants=2, ranks=2, chunks=2, streams=1, pool=2, retune=1),
    # the r16 demand-elasticity arc: drain -> handoff -> cutover ->
    # commit/abort interleaved with admissions/sends/consumes, plus
    # one scale-in/scale-out round trip — migration-lost-accepted and
    # placement-epoch-safety checked on every reachable state (the
    # exhaustive counterpart of the seeded flash-crowd / migration
    # campaign cells; consume=1 keeps partially-delivered streams
    # reachable mid-arc, the states where a lost handoff would hide)
    Scope(tenants=2, ranks=2, chunks=2, streams=1, pool=2, consume=1,
          migrate=1),
    # the r17 partition arc, both-sides-minority shape: at n=2 NEITHER
    # side of a cut can muster a majority quorum, so the honest world
    # parks every epoch-advancing actuation until the heal — the scope
    # where actuate_without_quorum is convicted (its lying census
    # fails over with 1 of the 2 needed reachable)
    Scope(tenants=2, ranks=2, chunks=2, streams=1, pool=2,
          partition=1),
    # the r17 partition arc, majority-failover shape: at n=3 the
    # reachable side IS a quorum, the cut rank's tenants legitimately
    # fail over to heirs under a fresh epoch, and the parked minority
    # must not accept — the scope where accept_in_minority is
    # convicted (its stale claim collides with the heir: two primaries
    # for one tenant in one epoch)
    Scope(tenants=2, ranks=3, chunks=2, streams=1, pool=2, consume=1,
          partition=1),
    # the r20 disaggregated-inference arc: KV-shard transport ->
    # resident generation -> the drain -> fence -> cutover handoff
    # sub-arc, interleaved with one decode death (kill=1 pins the
    # victim to rank 0, tenant 0's decode destination) —
    # kv-shard-safety and generation-lost-accepted checked on every
    # reachable state (the exhaustive counterpart of the seeded
    # kill-decode / saturate-decode inference campaign cells;
    # consume=1 keeps partially-streamed shard sets reachable
    # mid-arc, the states where a confused recovery path would hide)
    Scope(tenants=2, ranks=2, chunks=2, streams=1, pool=2, kill=1,
          consume=1, infer=1),
)


# ---------------------------------------------------------------------------
# The world: real control-plane objects + thin frontend glue
# ---------------------------------------------------------------------------


class World:
    """One concrete control-plane state, built from the real objects.

    Subclass hooks (``_make_scheduler``, ``_release_credit``,
    ``_reroute_stream``, ``_beat_ranks``) are the seams the
    control-plane mutants override — each hook's default is exactly
    what :class:`~smi_tpu_torch.serving.frontend.ServingFrontend` does, and
    everything else goes straight through the shipped objects.
    """

    def __init__(self, scope: Scope):
        self.scope = scope
        self.clock = StepClock()
        self.view = MembershipView(scope.ranks)
        # window=4 keeps the detector's interval history — hence the
        # canonical fingerprint — bounded; the phi math is untouched
        self.detector = PhiAccrualDetector(
            self.clock, range(scope.ranks), window=4
        )
        # rate/burst sized so tenant-rate isolation never sheds inside
        # a scope's quota: the five checked properties live in the
        # pool/lane/epoch machinery, not the per-tenant bucket.
        # Wait caps are scope-scaled (strictly ordered like the
        # production 12/48/96): the timeout MECHANISM is what the
        # model checks, and production-sized caps would add ~10
        # behaviourally-inert aging periods per parked request to
        # every interleaving
        self.gate = AdmissionGate(
            pool=scope.pool,
            tenant_rate=1.0,
            tenant_burst=float(max(scope.streams, 1)),
            wait_caps={
                "interactive": HEARTBEAT_INTERVAL + 2,
                "batch": 2 * HEARTBEAT_INTERVAL + 2,
                "best_effort": 3 * HEARTBEAT_INTERVAL + 2,
            },
        )
        self.lanes = [WireLane(r) for r in range(scope.ranks)]
        self.scheduler = self._make_scheduler(scope)
        self.active: List[StreamState] = []
        self.completed: List[StreamState] = []
        self.killed: set = set()
        self.zombie_beats: set = set()
        self.rejoin_pending: List[int] = []
        self.death_epoch: Dict[int, int] = {}
        self.submissions_left = [scope.streams] * scope.tenants
        self.kills_left = scope.kill
        self.silence_left = scope.silence
        self.suspected_events = 0
        self.cleared_events = 0
        self.confirmed: List[int] = []
        self.stale_rejections = 0
        self.stale_leaks = 0
        self.corruptions = 0
        self.replayed_chunks = 0
        #: stream index -> {seq: (rank, lane_epoch)} at delivery time —
        #: the evidence the epoch-safety property audits
        self.delivery_meta: Dict[int, Dict[int, Tuple[int, int]]] = {}
        self._stream_count = 0
        self._tenant_seq = [0] * scope.tenants
        self._epoch_watermark = 0
        self._beaten_this_period = True
        # -- the r14 plan-swap arc (retune scopes): REAL PlanSwap /
        # PlanCache / CacheEntry objects, driven by explicit actions
        self.swap = None
        self.plan_cache = None
        self.swap_expected_entry = None
        self.stream_plan_epoch: Dict[int, int] = {}
        self.stale_plan_rejections = 0
        self.stale_plan_leaks = 0
        self._plan_epoch_watermark = 0
        self.retunes_left = 0
        self.plan_aborts_left = 0
        if scope.retune:
            from smi_tpu_torch.tuning.cache import CacheEntry, PlanCache
            from smi_tpu_torch.tuning.plan import PlanKey
            from smi_tpu_torch.tuning.swap import PlanSwap

            self.plan_cache = PlanCache()
            key = PlanKey("all_reduce", "pow2:22", "float32", "model",
                          f"n{scope.ranks}")
            seed_entry = CacheEntry(
                {"algorithm": "ring"}, cost_us=100.0,
                provenance="sweep:model-seed",
            )
            self.plan_cache.put(key, seed_entry)
            self._seed_plan_entry = seed_entry
            self._rival_plan_entry = CacheEntry(
                {"algorithm": "rs_ag"},
                provenance="live:retune:model",
            )
            self.swap = PlanSwap(self.plan_cache, key)
            self.swap_expected_entry = seed_entry
            self.retunes_left = 1
            self.plan_aborts_left = 1
        # -- the r16 migration/scale arc (migrate scopes): live tenant
        # migration over a REAL checkpoint shard + one capacity round
        # trip through the real membership actuators
        self.migration: Optional[Dict] = None
        self.migrations_left = 0
        self.mig_aborts_left = 0
        self.scale_ins_left = 0
        self.parked: set = set()
        #: delivered state lost across a cutover (a handoff that never
        #: happened) — the migration-lost-accepted property's evidence
        self.mig_lost = 0
        if scope.migrate:
            self.migrations_left = 1
            self.mig_aborts_left = 1
            self.scale_ins_left = 1
        # -- the r17 partition arc (partition scopes): one cut/heal
        # round trip; the quorum census and the minority's accept
        # discipline go through mutant seams (_quorum_ok / _accept_ok)
        self.partitioned: Optional[int] = None
        self.partitions_left = 0
        self.partition_epoch = -1
        self.q_parked: set = set()
        self.minority_accepts_left = 0
        #: tenant -> rank claiming primaryship from the stale side —
        #: the no-split-brain property's evidence
        self.minority_claims: Dict[int, int] = {}
        #: (what, reachable, members) censused at every
        #: epoch-advancing actuation under the arc — the
        #: fenced-actuation property's evidence
        self.actuations: List[Tuple[str, int, int]] = []
        if scope.partition:
            self.partitions_left = 1
            self.minority_accepts_left = 1
        # -- the r20 inference arc (infer scopes): resident KV shard
        # inventory + decode-token cursors + the one handoff sub-arc
        #: stream index -> (rank, route epoch) where the stream's KV
        #: shard set is resident — the kv-shard-safety evidence
        self.kv_resident: Dict[int, Tuple[int, int]] = {}
        #: stream index -> decode tokens emitted from the residency
        self.kv_tokens: Dict[int, int] = {}
        self.kv_arc: Optional[Dict] = None
        self.kv_handoffs_left = 0
        self.kv_aborts_left = 0
        #: accepted decode tokens rolled back across a cutover (a
        #: resume from stale shards) — the generation-lost-accepted
        #: property's evidence
        self.kv_lost_tokens = 0
        self.kv_wal_restores = 0
        self.kv_handoffs_committed = 0
        self.kv_tokens_emitted = 0
        if scope.infer:
            self.kv_handoffs_left = 1
            self.kv_aborts_left = 1
        self._bootstrap()

    # -- mutant seams (defaults == the shipped frontend behaviour) ------

    def _make_scheduler(self, scope: Scope) -> StreamScheduler:
        return StreamScheduler(check_deadlines=False,
                               max_starve_rounds=scope.starve)

    def _release_credit(self, st: StreamState) -> None:
        """A completed stream's credit returns to the pool and the
        pending tier re-pumps — the end-to-end chain's upstream edge."""
        for req in self.gate.release(st.request.qos, self.clock.now()):
            self._activate(req)

    def _reroute_stream(self, st: StreamState, owner: int) -> None:
        """Failover of one accepted stream: the dead consumer's
        partial state died with it — void the WAL deliveries, clear
        the delivery record, replay everything from the durable
        contribution on a fresh epoch-keyed sequence lane."""
        st.wal.void_deliveries()
        st.delivered.clear()
        self.delivery_meta[st.index] = {}
        self.replayed_chunks += st.next_to_send
        st.replayed_chunks += st.next_to_send
        st.next_to_send = 0
        st.lane_epoch = self.view.epoch
        st.dst = owner

    def _beat_ranks(self) -> List[int]:
        """Who heartbeats on a beat period: live, unkilled members —
        a killed rank's silence is the detector's evidence channel."""
        return [r for r in sorted(self.view.members)
                if r not in self.killed]

    def _swap_ready(self) -> bool:
        """May the quiescing swap install? Only when every stream in
        the proposal's drain set — the streams in flight under the
        plan being retired — has completed. The swap_without_quiesce
        mutant breaks exactly this census."""
        drain = self.swap.proposal.drain
        return not any(st.index in drain for st in self.active)

    def _rollback_swap(self, reason: str) -> None:
        """Abort the in-flight swap through the real machine — the
        rollback must leave the pre-proposal entry servable (zero
        lost-accepted); the rollback_discards_entry mutant breaks
        exactly this restore."""
        self.swap.rollback(reason)

    def _handoff_ready(self) -> bool:
        """May the draining migration pack its shard? Only when no
        frozen stream has a frame on the source wire — sends are
        frozen, so the census is monotone."""
        mig = self.migration
        lane = self.lanes[mig["src"]]
        frozen = mig["streams"]
        return not any(
            item.stream.index in frozen
            for queue in (lane.in_flight, lane.landed)
            for item in queue
        )

    def _cutover_ready(self) -> bool:
        """May the migration cut over? Only once the handoff shard is
        packed. The cutover_without_handoff mutant lies and cuts over
        straight from the drain — the delivered state never crosses."""
        return self.migration["state"] == "handoff"

    def _scale_in_ok(self, rank: int) -> bool:
        """May this rank be scaled in? Only with zero residents (no
        active stream destined to it) and an empty wire lane — the
        scale_in_with_residents mutant breaks exactly this census."""
        if any(st.dst == rank for st in self.active):
            return False
        lane = self.lanes[rank]
        return not (lane.in_flight or lane.landed)

    def _quorum_ok(self) -> bool:
        """May the control plane fail the partitioned rank over? Only
        when the side it can still reach is a majority quorum of the
        current membership — the actuate_without_quorum mutant lies
        and fails over from a minority census."""
        from smi_tpu_torch.parallel.membership import quorum_size

        members = self.view.members
        reachable = set(members) - {self.partitioned}
        return len(reachable) >= quorum_size(len(members))

    def _accept_ok(self) -> bool:
        """May the partitioned rank accept a new stream? Never — it
        parked the moment its quorum lease lapsed. The
        accept_in_minority mutant lies and keeps accepting on the
        stale side."""
        return self.partitioned not in self.q_parked

    def _kv_failover(self, st: StreamState, heir: int) -> None:
        """Decode death with resident KV: the shard set was WAL'd at
        every delivery, so the heir re-establishes residency and the
        token cursor from the durable checkpoint — the handoff path,
        zero shards and zero tokens lost. The
        decode_failover_without_kv_handoff mutant takes the stateless
        replay path instead — correct for a transport (prefill)
        stream, a silent confusion for a resident decode one: the
        inventory still names the dead rank and kv-shard-safety
        convicts at the confirm state."""
        idx = st.index
        st.dst = heir
        st.lane_epoch = self.view.epoch
        self.delivery_meta[idx] = {
            seq: (heir, self.view.epoch) for seq in st.delivered
        }
        self.lanes[heir].next_seq[(idx, self.view.epoch)] = \
            st.next_to_send
        self.kv_resident[idx] = (heir, self.view.epoch)
        self.kv_wal_restores += 1

    def _kv_resume(self, idx: int, restored: Dict) -> tuple:
        """Where the destination resumes decoding from after the KV
        cutover: the handoff blob's entry — delivered shards + token
        cursor exactly as packed at the fence. The
        stale_kv_after_cutover mutant reaches for the propose-time
        snapshot instead: every token decoded during the drain is
        rolled back and re-emitted, and the client's accepted token
        stream diverges (the generation-lost-accepted conviction)."""
        handed = restored.get(idx)
        if handed is None:  # nothing crossed: restart the decode
            st = next(s for s in self.active if s.index == idx)
            return (dict(st.delivered), 0)
        return handed

    # -- plumbing -------------------------------------------------------

    def _bootstrap(self) -> None:
        """Seed the detector's inter-arrival window before exploration
        (the serving front-end's discipline): four quiet beat periods,
        no transitions allowed."""
        for _ in range(4):
            self.clock.advance(HEARTBEAT_INTERVAL)
            for r in self._beat_ranks():
                self.detector.heartbeat(r)
            for tr in self.detector.poll():
                raise RuntimeError(f"transition during bootstrap: {tr}")

    def _base_rank(self, tenant: int) -> int:
        """Deterministic tenant -> base rank map (the model's analog
        of ``frontend.tenant_base_rank``; index-based so the symmetry
        reduction can reason about it). A ``hot_rank`` scope replaces
        the uniform modulo map with the hot-expert skew: every tenant
        routes to the one hot destination."""
        if self.scope.hot_rank >= 0:
            return self.scope.hot_rank
        return tenant % self.scope.ranks

    def _route(self, tenant: int) -> int:
        owner = route_owner(self.view, self._base_rank(tenant),
                            self.scope.ranks)
        if owner is None:  # pragma: no cover — last member cannot die
            raise RuntimeError("no surviving rank to route to")
        return owner

    def _payloads(self, tenant: int, seq: int) -> Tuple[str, ...]:
        return tuple(
            f"t{tenant}/s{seq}/c{c}" for c in range(self.scope.chunks)
        )

    def _activate(self, request: Request) -> None:
        index = self._stream_count
        self._stream_count += 1
        wal = ProgressLog(rank=index)
        wal.contribution = request.chunks
        tenant = int(request.tenant[1:])
        self.active.append(StreamState(
            request=request, index=index, dst=self._route(tenant),
            deadline=None, wal=wal, lane_epoch=self.view.epoch,
            admitted_at=self.clock.now(),
        ))
        self.delivery_meta[index] = {}
        if self.swap is not None:
            self.stream_plan_epoch[index] = self.swap.plan_epoch

    def _complete(self, st: StreamState) -> None:
        st.completed_at = self.clock.now()
        assembled = tuple(
            st.delivered[i] for i in range(st.total_chunks)
        )
        if assembled != st.request.chunks:
            self.corruptions += 1
        self.active.remove(st)
        self.completed.append(st)
        self._release_credit(st)

    def _failover(self, dead: int) -> None:
        """Membership confirmed a death: shrink under a new epoch,
        validate the survivors still ring up, drop the dead lane,
        replay every stream routed there, and reject the dead
        incarnation's straggler loudly."""
        old_epoch = self.view.epoch
        self.view.confirm_dead(dead)
        self.death_epoch[dead] = old_epoch
        plan_regrow_ring(self.view)
        self.lanes[dead].drop_all()
        if (self.kv_arc is not None
                and self.kv_arc["state"] in ("draining", "handoff",
                                             "cutover")
                and dead in (self.kv_arc["src"], self.kv_arc["dst"])):
            # a membership change under the in-flight handoff aborts
            # it loudly; the dead source's residents recover through
            # the WAL-restore path below, not the half-packed shard
            self.kv_arc["state"] = "aborted"
        for st in self.active:
            if st.dst != dead:
                continue
            tenant = int(st.request.tenant[1:])
            heir = self._route(tenant)
            if self.scope.infer and st.index in self.kv_resident:
                # resident KV: the WAL-handoff recovery path — never
                # the stateless replay reserved for transport streams
                self._kv_failover(st, heir)
            else:
                self._reroute_stream(st, heir)
        # one straggler from the dead incarnation presents its old
        # epoch after the shrink: reject, never fold in
        try:
            self.view.validate(dead, old_epoch, what="straggler chunk")
            self.stale_leaks += 1
        except StaleEpochError:
            self.stale_rejections += 1
        if dead in self.killed:
            self.rejoin_pending.append(dead)

    def _advance(self, beat: bool) -> None:
        self.clock.advance(HEARTBEAT_INTERVAL)
        if beat:
            for r in self._beat_ranks():
                if r in self.killed:
                    # only a broken _beat_ranks (the
                    # heartbeat_after_confirm mutant) emits this: a
                    # killed rank's beat keeps phi low forever
                    self.zombie_beats.add(r)
                self.detector.heartbeat(r)
            self._beaten_this_period = True
        else:
            self.silence_left -= 1
            self._beaten_this_period = False
        for tr in self.detector.poll():
            if isinstance(tr, SuspectRank):
                self.suspected_events += 1
            elif isinstance(tr, SuspicionCleared):
                self.cleared_events += 1
            elif isinstance(tr, ConfirmedDead):
                self.confirmed.append(tr.rank)
                self._failover(tr.rank)
        now = self.clock.now()
        for lane in self.lanes:
            lane.land(now)
            lane.view_epoch = self.view.epoch
        for req in self.gate.pump(now):
            self._activate(req)

    # -- transitions ----------------------------------------------------

    def _do_admit(self, tenant: int) -> None:
        self.submissions_left[tenant] -= 1
        seq = self._tenant_seq[tenant]
        self._tenant_seq[tenant] = seq + 1
        qos = QOS_CLASSES[tenant % len(QOS_CLASSES)]
        request = Request(
            tenant=f"t{tenant}", qos=qos,
            chunks=self._payloads(tenant, seq),
            arrived_at=self.clock.now(),
            stream_id=(f"t{tenant}", seq),
        )
        from smi_tpu_torch.serving.qos import AdmissionRejected

        try:
            if self.gate.offer(request, self.clock.now()):
                self._activate(request)
        except AdmissionRejected:
            pass  # named + recorded by the real gate

    def _sendable(self) -> List[StreamState]:
        """The streams the scheduler may issue sends for: everything
        active, minus a draining migration's frozen streams (delivery
        continues — that IS the drain — but no new frames enter the
        source wire until the cutover re-routes them)."""
        if (self.migration is not None
                and self.migration["state"] in
                ("draining", "handoff", "cutover")):
            frozen = self.migration["streams"]
            return [st for st in self.active
                    if st.index not in frozen]
        return self.active

    def _do_send(self, rank: int) -> None:
        self.scheduler.schedule_lane(
            self.lanes[rank], self._sendable(), self.clock.now()
        )

    def _do_consume(self, rank: int) -> None:
        lane = self.lanes[rank]
        now = self.clock.now()
        lane.land(now)
        budget = self.scope.consume
        while budget > 0 and lane.landed:
            item = lane.landed.popleft()
            lane.credits += 1
            budget -= 1
            st = item.stream
            if item.lane_epoch != st.lane_epoch:
                # a pre-failover chunk reached a live consumer: the
                # data-path stale-epoch gate (the frontend's exact
                # discipline) — rejected by epoch, never folded in
                try:
                    self.view.validate(lane.rank, item.view_epoch,
                                       what="pre-failover chunk")
                    self.stale_leaks += 1
                except StaleEpochError:
                    self.stale_rejections += 1
                continue
            try:
                payload = verify_chunk(lane, item)
            except IntegrityError:
                if not st.complete and st.dst == lane.rank:
                    want = lane.next_seq.get(st.lane_key, 0)
                    if want < st.next_to_send:
                        delta = st.next_to_send - want
                        self.replayed_chunks += delta
                        st.replayed_chunks += delta
                        st.next_to_send = want
                continue
            if st.complete or st.dst != lane.rank:
                continue
            st.delivered[item.seq] = payload
            self.delivery_meta[st.index][item.seq] = (
                lane.rank, st.lane_epoch
            )
            st.wal.record((st.index, item.seq), payload)
            if st.complete:
                self._on_transport_complete(st)

    def _on_transport_complete(self, st: StreamState) -> None:
        """Transport done. Non-``infer`` worlds complete the request;
        ``infer`` worlds instead install the delivered chunks as the
        stream's resident KV shard set at the decode destination — the
        request completes only after ``scope.chunks`` decode tokens
        are generated from that residency."""
        if not self.scope.infer:
            self._complete(st)
            return
        self.kv_resident[st.index] = (st.dst, st.lane_epoch)
        self.kv_tokens[st.index] = 0

    def _do_kill(self, rank: int) -> None:
        self.kills_left -= 1
        self.killed.add(rank)

    def _do_rejoin(self, rank: int) -> None:
        """The dead rank's new incarnation: its pre-shrink epoch must
        be rejected loudly, then it regrows under a fresh epoch and a
        fresh detector bootstrap."""
        try:
            self.view.validate(rank, self.death_epoch[rank],
                               what="rejoin request")
            self.stale_leaks += 1
        except StaleEpochError:
            self.stale_rejections += 1
        self.view.regrow(rank)
        plan_regrow_ring(self.view)
        self.detector.forget(rank)
        self.killed.discard(rank)
        self.zombie_beats.discard(rank)
        self.rejoin_pending.remove(rank)

    # -- the plan-swap arc (retune scopes) ------------------------------

    def _do_plan_propose(self) -> None:
        """The tuner's decision point, abstracted to one action: the
        rival entry is staged and the drain set snapshots every
        stream currently in flight under the plan being retired."""
        self.retunes_left -= 1
        drain = frozenset(st.index for st in self.active)
        self.swap.propose(
            self._rival_plan_entry,
            evidence={"from": "ring", "to": "rs_ag"},
            drain=drain,
        )

    def _do_plan_swap(self) -> None:
        old_epoch = self.swap.plan_epoch
        installed = self.swap.swap()
        self.swap_expected_entry = installed
        # streams admitted AFTER the proposal are re-planned onto the
        # new epoch at the swap site (the frontend's exact move);
        # drain-set streams are deliberately NOT re-stamped — they
        # were mid-delivery under the old plan, and a clean swap
        # proved them drained before installing
        drain = self.swap.proposal.drain
        for st in self.active:
            if st.index not in drain:
                self.stream_plan_epoch[st.index] = self.swap.plan_epoch
        # one straggler presents the retired plan epoch after the
        # bump: reject loudly, count, never fold in
        from smi_tpu_torch.tuning.swap import StalePlanError

        try:
            self.swap.validate(old_epoch, what="straggler sample")
            self.stale_plan_leaks += 1
        except StalePlanError:
            self.stale_plan_rejections += 1

    def _do_plan_abort(self) -> None:
        self.plan_aborts_left -= 1
        was_swapped = self.swap.state == "swapped"
        restored = self.swap.proposal.old
        self._rollback_swap("model-abort")
        # the machine's outcome after a rollback is the pre-proposal
        # entry; a post-swap rollback additionally re-plans every
        # in-flight stream onto its fresh epoch (defensive — the
        # explorer currently drives aborts pre-swap only, like the
        # serving front-end's quiesce-timeout path)
        self.swap_expected_entry = restored
        if was_swapped:
            for st in self.active:
                self.stream_plan_epoch[st.index] = self.swap.plan_epoch

    # -- the migration/scale arc (migrate scopes) -----------------------

    def _do_mig_propose(self) -> None:
        """Start the one migration arc: the source is the destination
        of the lowest-index active stream (a deterministic 'hot' pick
        the symmetry reduction can reason about), the destination its
        successor among the members, and the frozen set every active
        stream currently routed to the source."""
        self.migrations_left -= 1
        src = min(self.active, key=lambda s: s.index).dst
        members = sorted(self.view.members)
        dst = members[(members.index(src) + 1) % len(members)]
        self.migration = {
            "state": "draining", "src": src, "dst": dst,
            "streams": frozenset(st.index for st in self.active
                                 if st.dst == src),
            "blob": None, "handed": {},
        }

    def _do_mig_handoff(self) -> None:
        """Pack the drained streams' delivered state into a REAL
        checkpoint shard (CRC + framing) — the in-memory transport the
        serving front-end uses, byte for byte."""
        mig = self.migration
        snapshot = sorted(
            (st.index, (dict(sorted(st.delivered.items())),
                        st.next_to_send))
            for st in self.active if st.index in mig["streams"]
        )
        payload = pickle.dumps(snapshot, protocol=4)
        blob, _crc = pack_shard(mig["src"], self.view.epoch, payload)
        mig["blob"] = blob
        # render-only summary (the blob's bytes are identity-variant,
        # the fingerprint must not see them)
        mig["handed"] = {idx: len(d) for idx, (d, _n) in snapshot}
        mig["state"] = "handoff"

    def _do_mig_cutover(self) -> None:
        """Epoch-bumped cutover: restore each frozen stream's state
        FROM the shard (the blob is load-bearing — a cutover without a
        handoff has nothing to restore and the delivered state is
        lost, the migration-lost-accepted conviction), re-route onto
        the destination's fresh epoch-keyed lane, and reject one
        straggler from the old route loudly."""
        mig = self.migration
        restored: Dict = {}
        if mig["blob"] is not None:
            _r, _s, payload, _c = unpack_shard(mig["blob"])
            restored = dict(pickle.loads(payload))
        old_epoch = self.view.epoch
        new_epoch = self.view.migrate_cutover(mig["src"], mig["dst"])
        dst_lane = self.lanes[mig["dst"]]
        for st in self.active:
            if st.index not in mig["streams"]:
                continue
            handed = restored.get(st.index)
            if handed is None:
                # no shard: the delivered state did not cross
                self.mig_lost += len(st.delivered)
                st.delivered.clear()
                self.delivery_meta[st.index] = {}
                st.next_to_send = 0
                dst_lane.next_seq[(st.index, new_epoch)] = 0
            else:
                delivered, next_to_send = handed
                st.delivered = dict(delivered)
                st.next_to_send = next_to_send
                # the destination's dense-seq expectation continues
                # where the source's left off
                dst_lane.next_seq[(st.index, new_epoch)] = next_to_send
                self.delivery_meta[st.index] = {
                    seq: (mig["dst"], new_epoch)
                    for seq in st.delivered
                }
            st.dst = mig["dst"]
            st.lane_epoch = new_epoch
        try:
            self.view.validate(mig["src"], old_epoch,
                               what="post-migration straggler")
            self.stale_leaks += 1
        except StaleEpochError:
            self.stale_rejections += 1
        mig["state"] = "cutover"

    def _do_mig_commit(self) -> None:
        self.migration["state"] = "committed"

    def _do_mig_abort(self) -> None:
        """Abort before cutover: unfreeze, nothing moved, nothing
        lost — the streams resume on the source exactly as they were."""
        self.mig_aborts_left -= 1
        self.migration["state"] = "aborted"

    def _do_scale_in(self) -> None:
        """Park the highest member through the real actuator (epoch
        bump + ring re-plan + detector forget) — demand-driven, loudly
        distinct from a death."""
        from smi_tpu_torch.parallel.membership import shrink_pod

        self.scale_ins_left -= 1
        rank = max(self.view.members)
        shrink_pod(self.view, self.detector, rank, reason="demand")
        self.parked.add(rank)

    def _do_scale_out(self) -> None:
        """Re-admit the parked rank under a fresh incarnation."""
        from smi_tpu_torch.parallel.membership import regrow_pod

        rank = min(self.parked)
        regrow_pod(self.view, self.detector, rank, reason="demand")
        self.parked.discard(rank)

    # -- the partition arc (partition scopes) ---------------------------

    def _partition_victim(self) -> int:
        """The rank the cut isolates: deterministically, the highest
        member that is some tenant's base but not the control-plane
        home (the lowest member) — the shape where the majority's
        failover and the minority's stale claim can collide. Falls
        back to the highest member when every base IS the home (the
        hot-rank scopes). Deterministic in exactly the state the
        symmetry reduction permutes, so victim choice commutes with
        rank relabelling."""
        bases = {self._base_rank(t) for t in range(self.scope.tenants)}
        home = min(self.view.members)
        cands = sorted((bases & self.view.members) - {home})
        return cands[-1] if cands else max(self.view.members)

    def _record_actuation(self, what: str) -> None:
        """Census one epoch-advancing actuation under the partition
        arc: how many members the control plane could reach when it
        pulled the trigger, out of how many there were."""
        members = len(self.view.members)
        cut = {self.partitioned} if self.partitioned is not None else set()
        reachable = len(set(self.view.members) - cut)
        self.actuations.append((what, reachable, members))

    def _do_partition_start(self) -> None:
        self.partitions_left -= 1
        r = self._partition_victim()
        self.partitioned = r
        self.partition_epoch = self.view.epoch
        # the cut rank's quorum lease lapses: the honest minority
        # parks itself (evidence state — the _accept_ok seam decides
        # whether the park is respected)
        self.q_parked.add(r)

    def _do_partition_failover(self) -> None:
        """The majority side confirms the unreachable rank dead and
        fails it over — gated (via enabledness) on the _quorum_ok
        census. The detector is told to forget the rank first: its
        silence was the partition's, not a death's, and the failover
        decision here is the quorum census's, not phi's."""
        r = self.partitioned
        self._record_actuation("partition-failover")
        self.detector.forget(r)
        self._failover(r)

    def _do_minority_accept(self, tenant: int) -> None:
        """The stale side accepts a new stream for a tenant it still
        believes it owns — only a lying _accept_ok enables this; the
        claim is the no-split-brain property's witness."""
        self.minority_accepts_left -= 1
        self.minority_claims[tenant] = self.partitioned

    def _do_partition_heal(self) -> None:
        """The cut heals. A rank that was failed over during the cut
        presents its stale epoch once (the straggler rail), then
        rejoins through the real actuators under a fresh incarnation;
        a rank that was merely parked just unparks. Either way the
        stale side's claims die with the park."""
        r = self.partitioned
        self.partitioned = None  # the cut is gone before any actuation
        self.q_parked.discard(r)
        self.minority_claims.clear()
        if r not in self.view.members:
            try:
                self.view.validate(r, self.partition_epoch,
                                   what="parked-rank straggler")
                self.stale_leaks += 1
            except StaleEpochError:
                self.stale_rejections += 1
            self._record_actuation("heal-rejoin")
            self.view.regrow(r)
            plan_regrow_ring(self.view)
            self.detector.forget(r)
        self.partition_epoch = -1

    # -- the inference arc (infer scopes) -------------------------------

    def _kv_fenced(self, idx: int) -> bool:
        """Is this stream's decode fenced by the in-flight handoff?
        Once the shard is packed (``handoff``/``cutover``), the source
        must stop decoding — tokens emitted after the fence could
        never be in the blob, so a 'clean' cutover would lose them.
        The drain itself keeps decoding: that IS the drain."""
        arc = self.kv_arc
        return (arc is not None
                and arc["state"] in ("handoff", "cutover")
                and idx in arc["streams"])

    def _generatable(self, rank: int) -> bool:
        return any(
            self.kv_resident.get(st.index, (None,))[0] == rank
            and not self._kv_fenced(st.index)
            for st in self.active
        )

    def _do_generate(self, rank: int) -> None:
        """One decode step at ``rank``: every unfenced generating
        stream resident there emits one token from its resident KV;
        a stream reaching its token budget completes the request and
        retires the residency."""
        for st in list(self.active):
            idx = st.index
            res = self.kv_resident.get(idx)
            if res is None or res[0] != rank or self._kv_fenced(idx):
                continue
            self.kv_tokens[idx] += 1
            self.kv_tokens_emitted += 1
            if self.kv_tokens[idx] >= st.total_chunks:
                self.kv_resident.pop(idx)
                self.kv_tokens.pop(idx)
                self._complete(st)

    def _do_kv_propose(self) -> None:
        """Start the one KV handoff arc (the saturation-blame shape):
        the source is the resident rank of the lowest-index generating
        stream (a deterministic 'hot' pick the symmetry reduction can
        reason about), the destination its successor among the
        members, and the handed-off set every generating stream
        resident at the source. The propose-time token snapshot is
        recorded ONLY as the stale copy a broken resume would reach
        for — the clean arc restores from the handoff blob."""
        self.kv_handoffs_left -= 1
        gen = [st for st in self.active
               if st.index in self.kv_resident
               and self.kv_resident[st.index][0] in self.view.members]
        src = self.kv_resident[min(s.index for s in gen)][0]
        members = sorted(self.view.members)
        dst = members[(members.index(src) + 1) % len(members)]
        self.kv_arc = {
            "state": "draining", "src": src, "dst": dst,
            "streams": frozenset(
                st.index for st in gen
                if self.kv_resident[st.index][0] == src
            ),
            "blob": None,
            "stale": {st.index: self.kv_tokens[st.index]
                      for st in gen
                      if self.kv_resident[st.index][0] == src},
            "handed": {},
        }

    def _do_kv_handoff(self) -> None:
        """Fence the source's decode and pack the resident shard sets
        plus token cursors into a REAL checkpoint shard (CRC +
        framing) — the transport the serving front-end's failover
        restore uses, byte for byte."""
        arc = self.kv_arc
        snapshot = sorted(
            (st.index, (dict(sorted(st.delivered.items())),
                        self.kv_tokens[st.index]))
            for st in self.active
            if st.index in arc["streams"]
            and st.index in self.kv_resident
        )
        payload = pickle.dumps(snapshot, protocol=4)
        blob, _crc = pack_shard(arc["src"], self.view.epoch, payload)
        arc["blob"] = blob
        arc["handed"] = {i: (len(d), t) for i, (d, t) in snapshot}
        arc["state"] = "handoff"

    def _do_kv_cutover(self) -> None:
        """Epoch-bumped cutover: each handed-off stream resumes at the
        destination FROM the shard (via the ``_kv_resume`` seam — a
        resume from the propose-time copy rolls back every token the
        drain emitted, the generation-lost-accepted conviction),
        residency and route move together under the fresh epoch, and
        one straggler from the old route is rejected loudly."""
        arc = self.kv_arc
        restored: Dict = {}
        if arc["blob"] is not None:
            _r, _s, payload, _c = unpack_shard(arc["blob"])
            restored = dict(pickle.loads(payload))
        old_epoch = self.view.epoch
        new_epoch = self.view.migrate_cutover(arc["src"], arc["dst"])
        for st in self.active:
            idx = st.index
            if (idx not in arc["streams"]
                    or idx not in self.kv_resident):
                continue
            delivered, tokens = self._kv_resume(idx, restored)
            if tokens < self.kv_tokens[idx]:
                self.kv_lost_tokens += self.kv_tokens[idx] - tokens
            st.delivered = dict(delivered)
            self.kv_tokens[idx] = tokens
            self.kv_resident[idx] = (arc["dst"], new_epoch)
            st.dst = arc["dst"]
            st.lane_epoch = new_epoch
            self.delivery_meta[idx] = {
                seq: (arc["dst"], new_epoch) for seq in st.delivered
            }
            self.lanes[arc["dst"]].next_seq[(idx, new_epoch)] = \
                st.next_to_send
        try:
            self.view.validate(arc["src"], old_epoch,
                               what="post-handoff straggler")
            self.stale_leaks += 1
        except StaleEpochError:
            self.stale_rejections += 1
        arc["state"] = "cutover"

    def _do_kv_commit(self) -> None:
        self.kv_arc["state"] = "committed"
        self.kv_handoffs_committed += 1

    def _do_kv_abort(self) -> None:
        """Abort before cutover: the fence lifts, residency never
        moved, nothing lost — the source resumes decoding exactly
        where it stopped."""
        self.kv_aborts_left -= 1
        self.kv_arc["state"] = "aborted"

    def apply(self, action: Tuple) -> None:
        kind = action[0]
        if kind == "tick":
            self._advance(beat=False)
        elif kind == "heartbeat":
            self._advance(beat=True)
        elif kind == "admit":
            self._do_admit(action[1])
        elif kind == "send":
            self._do_send(action[1])
        elif kind == "consume":
            self._do_consume(action[1])
        elif kind == "kill":
            self._do_kill(action[1])
        elif kind == "rejoin":
            self._do_rejoin(action[1])
        elif kind == "plan_propose":
            self._do_plan_propose()
        elif kind == "plan_quiesce":
            self.swap.quiesce(self.clock.now())
        elif kind == "plan_swap":
            self._do_plan_swap()
        elif kind == "plan_commit":
            self.swap.commit()
        elif kind == "plan_abort":
            self._do_plan_abort()
        elif kind == "mig_propose":
            self._do_mig_propose()
        elif kind == "mig_handoff":
            self._do_mig_handoff()
        elif kind == "mig_cutover":
            self._do_mig_cutover()
        elif kind == "mig_commit":
            self._do_mig_commit()
        elif kind == "mig_abort":
            self._do_mig_abort()
        elif kind == "scale_in":
            self._do_scale_in()
        elif kind == "scale_out":
            self._do_scale_out()
        elif kind == "partition_start":
            self._do_partition_start()
        elif kind == "partition_failover":
            self._do_partition_failover()
        elif kind == "minority_accept":
            self._do_minority_accept(action[1])
        elif kind == "partition_heal":
            self._do_partition_heal()
        elif kind == "generate":
            self._do_generate(action[1])
        elif kind == "kv_propose":
            self._do_kv_propose()
        elif kind == "kv_handoff":
            self._do_kv_handoff()
        elif kind == "kv_cutover":
            self._do_kv_cutover()
        elif kind == "kv_commit":
            self._do_kv_commit()
        elif kind == "kv_abort":
            self._do_kv_abort()
        else:
            raise ValueError(f"unknown model action {action!r}")
        self._epoch_watermark = max(self._epoch_watermark,
                                    self.view.epoch)
        if self.swap is not None:
            self._plan_epoch_watermark = max(
                self._plan_epoch_watermark, self.swap.plan_epoch
            )

    # -- enabled actions ------------------------------------------------

    def _time_useful(self) -> bool:
        """A period advance can change behaviour: frames need landing,
        pending admissions can pump or time out, an undetected kill or
        an open suspicion needs the detector's clock."""
        if any(lane.in_flight for lane in self.lanes):
            return True
        if any(q for q in self.gate.pending.values()):
            return True
        if any(r in self.view.members for r in self.killed):
            return True
        if self.detector.suspected:
            return True
        if self.silence_left > 0:
            # unspent silence quota is scenario fuel: the
            # alive-but-silent arcs need consecutive beat-less
            # periods even when no frame is mid-flight
            return True
        return False

    def enabled_actions(self) -> List[Tuple]:
        out: List[Tuple] = []
        if self._time_useful():
            out.append(("heartbeat",))
            if self.silence_left > 0:
                out.append(("tick",))
        for t in range(self.scope.tenants):
            if self.submissions_left[t] > 0:
                out.append(("admit", t))
        sendable = self._sendable()
        for lane in self.lanes:
            if lane.rank in self.killed:
                continue
            if lane.can_send() and any(
                st.dst == lane.rank
                and st.next_to_send < st.total_chunks
                for st in sendable
            ):
                out.append(("send", lane.rank))
        now = self.clock.now()
        for lane in self.lanes:
            if lane.rank in self.killed:
                continue
            if lane.rank not in self.view.members:
                continue
            if lane.landed or any(f.ready_at <= now
                                  for f in lane.in_flight):
                out.append(("consume", lane.rank))
        if self.kills_left > 0 and len(self.view.members) > 1:
            # the victim is pinned to the lowest live rank (tenant
            # 0's base): at these scopes rank symmetry makes every
            # other victim choice isomorphic, and pinning halves the
            # branching the reduction would otherwise have to merge
            victim = min(self.view.members)
            if victim not in self.killed:
                out.append(("kill", victim))
        for r in self.rejoin_pending:
            out.append(("rejoin", r))
        if self.swap is not None:
            state = self.swap.state
            if state == "idle" and self.retunes_left > 0:
                out.append(("plan_propose",))
            elif state == "proposed":
                out.append(("plan_quiesce",))
                if self.plan_aborts_left > 0:
                    out.append(("plan_abort",))
            elif state == "quiescing":
                # enabledness goes through the mutant seam: the clean
                # census requires the drain set empty, the
                # swap_without_quiesce mutant lies and enables it with
                # old-plan streams still in flight
                if self._swap_ready():
                    out.append(("plan_swap",))
                if self.plan_aborts_left > 0:
                    out.append(("plan_abort",))
            elif state == "swapped":
                out.append(("plan_commit",))
        if self.scope.migrate:
            mig = self.migration
            if (mig is None and self.migrations_left > 0
                    and len(self.view.members) >= 2 and self.active):
                out.append(("mig_propose",))
            elif mig is not None:
                state = mig["state"]
                if state == "draining":
                    if self._handoff_ready():
                        out.append(("mig_handoff",))
                    # enabledness goes through the mutant seam: the
                    # clean census requires the shard packed, the
                    # cutover_without_handoff mutant lies and cuts
                    # over straight from the drain
                    if self._cutover_ready():
                        out.append(("mig_cutover",))
                    if self.mig_aborts_left > 0:
                        out.append(("mig_abort",))
                elif state == "handoff":
                    if self._cutover_ready():
                        out.append(("mig_cutover",))
                    if self.mig_aborts_left > 0:
                        out.append(("mig_abort",))
                elif state == "cutover":
                    out.append(("mig_commit",))
            if ((mig is None
                    or mig["state"] in ("committed", "aborted"))
                    and self.scale_ins_left > 0
                    and len(self.view.members) > 1):
                victim = max(self.view.members)
                if self._scale_in_ok(victim):
                    out.append(("scale_in",))
            if self.parked:
                out.append(("scale_out",))
        if self.scope.partition:
            if (self.partitioned is None and self.partitions_left > 0
                    and len(self.view.members) >= 2):
                out.append(("partition_start",))
            elif self.partitioned is not None:
                r = self.partitioned
                # enabledness goes through the mutant seams: the clean
                # quorum census blocks the failover when the reachable
                # side is a minority, and the clean park blocks every
                # stale-side accept
                if r in self.view.members and self._quorum_ok():
                    out.append(("partition_failover",))
                if self.minority_accepts_left > 0 and self._accept_ok():
                    for t in range(self.scope.tenants):
                        if self._base_rank(t) == r:
                            out.append(("minority_accept", t))
                out.append(("partition_heal",))
        if self.scope.infer:
            for r in sorted(self.view.members):
                if r in self.killed:
                    continue
                if self._generatable(r):
                    out.append(("generate", r))
            arc = self.kv_arc
            if (arc is None and self.kv_handoffs_left > 0
                    and len(self.view.members) >= 2
                    and any(st.index in self.kv_resident
                            and self.kv_resident[st.index][0]
                            in self.view.members
                            for st in self.active)):
                out.append(("kv_propose",))
            elif arc is not None:
                state = arc["state"]
                if state == "draining":
                    out.append(("kv_handoff",))
                    if self.kv_aborts_left > 0:
                        out.append(("kv_abort",))
                elif state == "handoff":
                    out.append(("kv_cutover",))
                    if self.kv_aborts_left > 0:
                        out.append(("kv_abort",))
                elif state == "cutover":
                    out.append(("kv_commit",))
        return out

    # -- canonical fingerprint (relative time + symmetry orbits) --------

    def _render(self, tau: Sequence[int], rho: Sequence[int]) -> tuple:
        """Render the behaviour-relevant state under a tenant
        permutation ``tau`` and a rank permutation ``rho``, with every
        clock value made relative to *now* and every epoch stamp made
        relative to the current view epoch."""
        now = self.clock.now()
        epoch = self.view.epoch

        # canonical stream relabelling: order preserved (the scheduler
        # tie-breaks on index ORDER, never on absolute value)
        order = {st.index: i
                 for i, st in enumerate(
                     sorted(self.active, key=lambda s: s.index))}

        def stream_key(st: StreamState) -> tuple:
            tenant = tau[int(st.request.tenant[1:])]
            base = (
                order[st.index], tenant, st.request.qos,
                rho[st.dst], st.next_to_send,
                tuple(sorted(st.delivered)), st.skips,
                epoch - st.lane_epoch, st.total_chunks,
            )
            if self.swap is not None:
                base += (self.swap.plan_epoch
                         - self.stream_plan_epoch.get(
                             st.index, self.swap.plan_epoch),)
            return base

        streams = tuple(
            stream_key(st)
            for st in sorted(self.active, key=lambda s: s.index)
        )

        def bucket_state(t: int) -> tuple:
            b = self.gate._buckets.get(f"t{t}")
            if b is None:
                return (-1.0,)  # no bucket yet (type-stable sentinel)
            effective = min(b.burst, b.tokens + (now - b._last) * b.rate)
            return (round(effective, 6),)

        tenants = tuple(
            (tau[t], self.submissions_left[t], self._tenant_seq[t])
            + bucket_state(t)
            for t in range(self.scope.tenants)
        )

        pending = tuple(
            (qos, tuple(
                (tau[int(p.request.tenant[1:])], now - p.since)
                for p in self.gate.pending[qos]
            ))
            for qos in QOS_CLASSES
        )
        held = tuple(self.gate.held[c] for c in QOS_CLASSES)

        def frame_key(item) -> tuple:
            st = item.stream
            # frames of completed streams are behaviourally inert
            # (consumption skips them) — one label covers them all
            owner = ((0, order[st.index]) if st.index in order
                     else (1, 0))
            return (
                owner,
                item.seq, max(0, item.ready_at - now),
                item.lane_epoch - st.lane_epoch,
                epoch - item.view_epoch,
            )

        lanes = tuple(
            (
                rho[lane.rank], lane.credits,
                tuple(frame_key(f) for f in lane.in_flight),
                tuple(frame_key(f) for f in lane.landed),
                tuple(sorted(
                    (order[idx], epoch - le, seq)
                    for (idx, le), seq in lane.next_seq.items()
                    if idx in order
                )),
            )
            for lane in self.lanes
        )

        det = tuple(
            (
                rho[r],
                r in self.detector.dead,
                (now - self.detector._suspected_at[r]
                 if r in self.detector.suspected else -1),
                (now - self.detector._last[r]
                 if r in self.detector._last else -1),
                tuple(self.detector._intervals.get(r, ())),
            )
            for r in range(self.scope.ranks)
        )

        base = (
            tuple(sorted(tenants)),
            held, pending, streams,
            tuple(sorted(lanes)),
            tuple(sorted(det)),
            frozenset(rho[r] for r in self.view.members),
            frozenset(rho[r] for r in self.killed),
            frozenset(rho[r] for r in self.zombie_beats),
            tuple(sorted(
                (rho[r], epoch - self.death_epoch[r])
                for r in self.rejoin_pending
            )),
            self.kills_left, self.silence_left,
            self._beaten_this_period,
        )
        if self.swap is not None:
            entry = self.plan_cache.lookup(self.swap.key)
            drain = (self.swap.proposal.drain
                     if self.swap.proposal is not None else frozenset())
            base += ((
                self.swap.state, self.swap.plan_epoch,
                self.retunes_left, self.plan_aborts_left,
                tuple(sorted(order[i] for i in drain if i in order)),
                (entry.knobs.get("algorithm"), entry.revision)
                if entry is not None else None,
            ),)
        if self.scope.migrate:
            mig = self.migration
            mig_t = None
            if mig is not None:
                # the blob's raw bytes are identity-variant (they
                # embed absolute stream indices/payload labels) — the
                # fingerprint sees its PRESENCE plus the order-mapped
                # handed summary, never the bytes
                mig_t = (
                    mig["state"], rho[mig["src"]], rho[mig["dst"]],
                    tuple(sorted(order[i] for i in mig["streams"]
                                 if i in order)),
                    tuple(sorted(
                        (order[i], count)
                        for i, count in mig["handed"].items()
                        if i in order
                    )),
                    mig["blob"] is not None,
                )
            base += ((
                mig_t, self.migrations_left, self.mig_aborts_left,
                self.scale_ins_left, self.mig_lost,
                tuple(sorted(rho[r] for r in self.parked)),
            ),)
        if self.scope.partition:
            base += ((
                rho[self.partitioned] if self.partitioned is not None
                else -1,
                self.partitions_left, self.minority_accepts_left,
                (epoch - self.partition_epoch
                 if self.partitioned is not None else -1),
                tuple(sorted(rho[r] for r in self.q_parked)),
                tuple(sorted((tau[t], rho[r])
                             for t, r in self.minority_claims.items())),
                tuple(self.actuations),
            ),)
        if self.scope.infer:
            arc = self.kv_arc
            arc_t = None
            if arc is not None:
                # like the migration blob: identity-variant bytes stay
                # out of the fingerprint — PRESENCE plus order-mapped
                # summaries only
                arc_t = (
                    arc["state"], rho[arc["src"]], rho[arc["dst"]],
                    tuple(sorted(order[i] for i in arc["streams"]
                                 if i in order)),
                    tuple(sorted(
                        (order[i], t) for i, t in arc["stale"].items()
                        if i in order
                    )),
                    tuple(sorted(
                        (order[i], n, t)
                        for i, (n, t) in arc["handed"].items()
                        if i in order
                    )),
                    arc["blob"] is not None,
                )
            base += ((
                tuple(sorted(
                    (order[i], rho[r], epoch - e,
                     self.kv_tokens.get(i, -1))
                    for i, (r, e) in self.kv_resident.items()
                    if i in order
                )),
                arc_t, self.kv_handoffs_left, self.kv_aborts_left,
                self.kv_lost_tokens, self.kv_wal_restores,
                self.kv_handoffs_committed,
            ),)
        return base

    def fingerprint(self) -> tuple:
        """Orbit representative: the minimum render over every
        (tenant, rank) permutation pair that commutes with BOTH
        deterministic tenant-identity maps — the routing map
        (``base(tau(t)) == rho(base(t))`` — the modulo map on uniform
        scopes, the constant hot-rank map on skewed ones, where the
        condition degenerates to ``rho`` fixing the hot destination)
        and the QoS assignment (``tau(t) % classes == t % classes``,
        since future admissions draw their class from the raw tenant
        index). Only genuinely interchangeable identities collapse; a
        permutation that would swap an interactive tenant with a
        best_effort one is not an isomorphism and is rejected."""
        nt, nr = self.scope.tenants, self.scope.ranks
        nc = len(QOS_CLASSES)
        best: Optional[tuple] = None
        for rho in itertools.permutations(range(nr)):
            for tau in itertools.permutations(range(nt)):
                if any(self._base_rank(tau[t])
                       != rho[self._base_rank(t)]
                       or tau[t] % nc != t % nc
                       for t in range(nt)):
                    continue
                r = self._render(tau, rho)
                if best is None or r < best:
                    best = r
        assert best is not None  # identity is always compatible
        return best

    # -- campaign-style report (the replay cell reads this) -------------

    def report(self) -> Dict:
        gate = self.gate
        accepted = sum(gate.admitted.values())
        delivered = len(self.completed)
        retune = {}
        if self.swap is not None:
            entry = self.plan_cache.lookup(self.swap.key)
            retune = {"retune": {
                "swap_state": self.swap.state,
                "plan_epoch": self.swap.plan_epoch,
                "active_algorithm": (entry.knobs.get("algorithm")
                                     if entry is not None else None),
                "active_revision": (entry.revision
                                    if entry is not None else None),
                "stale_plan_rejections": self.stale_plan_rejections,
                "stale_plan_leaks": self.stale_plan_leaks,
            }}
        migrate = {}
        if self.scope.migrate:
            migrate = {"migrate": {
                "state": (self.migration["state"]
                          if self.migration is not None else None),
                "migrations_left": self.migrations_left,
                "mig_lost": self.mig_lost,
                "scale_ins_left": self.scale_ins_left,
                "parked": sorted(self.parked),
            }}
        infer = {}
        if self.scope.infer:
            infer = {"infer": {
                "kv_resident": {
                    f"s{i}": {"rank": r, "epoch": e,
                              "tokens": self.kv_tokens.get(i, 0)}
                    for i, (r, e) in sorted(self.kv_resident.items())
                },
                "arc_state": (self.kv_arc["state"]
                              if self.kv_arc is not None else None),
                "handoffs_committed": self.kv_handoffs_committed,
                "tokens_emitted": self.kv_tokens_emitted,
                "lost_tokens": self.kv_lost_tokens,
                "wal_restores": self.kv_wal_restores,
            }}
        partition = {}
        if self.scope.partition:
            partition = {"partition": {
                "partitioned": self.partitioned,
                "partitions_left": self.partitions_left,
                "parked": sorted(self.q_parked),
                "minority_claims": {
                    f"t{t}": r
                    for t, r in sorted(self.minority_claims.items())
                },
                "actuations": [list(a) for a in self.actuations],
            }}
        return {
            **retune,
            **migrate,
            **infer,
            **partition,
            "scope": self.scope.to_json(),
            "epoch": self.view.epoch,
            "members": sorted(self.view.members),
            "accepted": dict(gate.admitted),
            "shed": {c: dict(gate.shed[c]) for c in QOS_CLASSES},
            "delivered": delivered,
            "in_flight": len(self.active),
            "lost_accepted": accepted - delivered - len(self.active),
            "silent_corruptions": self.corruptions,
            "replayed_chunks": self.replayed_chunks,
            "stale_epoch_rejections": self.stale_rejections,
            "stale_epoch_leaks": self.stale_leaks,
            "confirmed": list(self.confirmed),
            "max_queue_depth": gate.max_queue_depth,
            "queue_bound": gate.pool * (1 + len(QOS_CLASSES)),
        }


def _fork(world: World) -> World:
    """An independent copy of a world (pickle round-trip — faster than
    deepcopy for this object graph — with deepcopy as the fallback for
    mutant subclasses that carry unpicklable state)."""
    try:
        return pickle.loads(pickle.dumps(world, protocol=4))
    except Exception:
        return copy.deepcopy(world)


# ---------------------------------------------------------------------------
# Findings + report
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelFinding:
    """One property violation with its minimal counterexample trace.

    ``trace`` is the BFS-shortest action sequence from the initial
    state to the violating state —
    :func:`smi_tpu_torch.serving.campaign.replay_model_trace` re-executes it
    against a fresh :class:`World` as a failing campaign cell."""

    property: str
    message: str
    trace: Tuple[Tuple, ...]

    def to_json(self) -> dict:
        return {
            "property": self.property,
            "message": self.message,
            "trace": [list(a) for a in self.trace],
        }

    def __str__(self) -> str:
        steps = " -> ".join(
            " ".join(str(x) for x in a) for a in self.trace
        )
        return (f"[{self.property}] {self.message}\n"
                f"    trace ({len(self.trace)} steps): {steps}")


@dataclasses.dataclass(frozen=True)
class ModelReport:
    """Verdict of one scope: either every reachable state satisfies
    every property (``ok`` with full coverage), or the minimal
    counterexample. Coverage mirrors ``credits.ScheduleCount``:
    ``truncated`` runs report ``explored``/``frontier``/
    ``estimated_total`` instead of claiming exhaustiveness."""

    scope: Scope
    explored: int
    truncated: bool
    frontier: int
    findings: Tuple[ModelFinding, ...]
    properties: Tuple[str, ...]
    mutant: Optional[str] = None

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def estimated_total(self) -> int:
        return self.explored + self.frontier

    def to_json(self) -> dict:
        return {
            "scope": self.scope.to_json(),
            "mutant": self.mutant,
            "explored": self.explored,
            "truncated": self.truncated,
            "frontier": self.frontier,
            "estimated_total": self.estimated_total,
            "ok": self.ok,
            "properties": list(self.properties),
            "findings": [f.to_json() for f in self.findings],
        }

    def describe(self) -> str:
        head = f"model [{self.scope.describe()}]"
        if self.mutant:
            head += f" [{self.mutant}]"
        cov = (f"{self.explored} states"
               if not self.truncated else
               f"{self.explored} states explored, TRUNCATED — >= "
               f"{self.estimated_total} exist")
        if self.ok:
            return (f"{head}: ok ({cov}; properties: "
                    f"{', '.join(self.properties)})")
        body = "\n".join(f"  {line}" for f in self.findings
                         for line in str(f).splitlines())
        return f"{head}: {len(self.findings)} finding(s) ({cov})\n{body}"


# ---------------------------------------------------------------------------
# BFS driver
# ---------------------------------------------------------------------------


def check_scope(
    scope: Scope,
    budget: int = DEFAULT_BUDGET,
    world_factory=None,
    mutant: Optional[str] = None,
) -> ModelReport:
    """Exhaustively check one scope; stop at the first (hence minimal)
    violation.

    ``world_factory`` builds the initial world (default: the clean
    :class:`World`; the mutants module passes its broken subclasses —
    ``mutant`` is the label stamped into the report either way).
    """
    from smi_tpu_torch.analysis.properties import (
        PROPERTIES,
        check_state,
        check_terminal,
    )

    factory = world_factory or World
    init = factory(scope)
    seen = {init.fingerprint()}
    queue = deque([(init, ())])
    explored = 0
    truncated = False
    frontier = 0
    findings: List[ModelFinding] = []
    while queue:
        world, trace = queue.popleft()
        explored += 1
        if explored > budget:
            truncated = True
            frontier = len(queue) + 1
            warnings.warn(
                f"model checker: budget of {budget} states truncated "
                f"the scope [{scope.describe()}] with {frontier} "
                f"frontier states unexplored — the verified claim is "
                f"'the first {explored - 1} states in BFS order "
                f"hold', NOT exhaustive coverage",
                RuntimeWarning,
                stacklevel=2,
            )
            break
        actions = world.enabled_actions()
        if not actions:
            violations = check_terminal(world)
            if violations:
                prop, message = violations[0]
                findings.append(ModelFinding(prop, message, trace))
                break
            continue
        stop = False
        for action in actions:
            child = _fork(world)
            child.apply(action)
            child_trace = trace + (action,)
            violations = check_state(child)
            if violations:
                prop, message = violations[0]
                findings.append(
                    ModelFinding(prop, message, child_trace)
                )
                stop = True
                break
            fp = child.fingerprint()
            if fp in seen:
                continue
            seen.add(fp)
            queue.append((child, child_trace))
        if stop:
            break
    return ModelReport(
        scope=scope,
        explored=min(explored, budget),
        truncated=truncated,
        frontier=frontier,
        findings=tuple(findings),
        properties=PROPERTIES,
        mutant=mutant,
    )


def check_scopes(
    scopes: Optional[Sequence[Scope]] = None,
    budget: int = DEFAULT_BUDGET,
) -> List[ModelReport]:
    """The ``smi-tpu lint --model`` engine: every default scope (or
    the given ones), clean world, first-violation-minimal."""
    return [check_scope(s, budget=budget)
            for s in (DEFAULT_SCOPES if scopes is None else scopes)]


def model_reports_to_json(reports: Sequence[ModelReport]) -> dict:
    """The ``smi-tpu lint --model --json`` payload (schema-tested).

    Coverage is explicit per scope AND summarized at top level —
    the machine-consumer half of "no silent caps"."""
    from smi_tpu_torch.analysis.properties import PROPERTIES

    return {
        "ok": all(r.ok for r in reports),
        "tier": "model",
        "findings": sum(len(r.findings) for r in reports),
        "properties": list(PROPERTIES),
        "coverage": {
            "explored": sum(r.explored for r in reports),
            "truncated": any(r.truncated for r in reports),
            "estimated_total": sum(r.estimated_total
                                   for r in reports),
        },
        "scopes": [r.to_json() for r in reports],
    }


def render_model_reports(reports: Sequence[ModelReport]) -> str:
    lines = [r.describe() for r in reports]
    n_findings = sum(len(r.findings) for r in reports)
    total = sum(r.explored for r in reports)
    tail = f"{len(reports)} scope(s), {total} states, " \
           f"{n_findings} finding(s)"
    if any(r.truncated for r in reports):
        tail += " [TRUNCATED — coverage incomplete]"
    lines.append(tail)
    return "\n".join(lines)
