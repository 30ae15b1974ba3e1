"""The model-checked control-plane properties.

The port's copy of :mod:`smi_tpu.analysis.properties`, kept in step
with it line for line.

Each check is a pure predicate over a :class:`~smi_tpu_torch.analysis.model.World`
state — it reads the REAL objects (the gate's occupancy, the lanes'
credit windows, the scheduler's skip counters, the view's epoch, the
WAL) and returns ``(property, message)`` violations. The model
checker runs :func:`check_state` on every reachable state and
:func:`check_terminal` on every terminal one; the first violation (in
BFS order) becomes the minimal counterexample.

The properties are the campaign gates of
:mod:`smi_tpu_torch.serving.campaign` and the elastic soak, turned from
sampled assertions into exhaustively-checked invariants:

- **queue-bound** — stream-credit occupancy never exceeds the pool,
  each pending queue stays inside its cap, and total queue depth stays
  inside ``pool * (1 + classes)`` (the campaigns' bounded-occupancy
  gate, checked on every transition instead of at the end of a run).
- **stream-credit** — conservation end to end: credits held by the
  admission pool equal the accepted-but-incomplete streams (per class
  and in total), and every wire lane's window balances
  (``credits + in_flight + landed == WIRE_CREDITS``). A completed
  stream whose credit never returned — or a lane that minted or lost
  a wire credit — is caught at the first state it happens.
- **starvation** — the aging bound: an eligible stream is never
  passed over more than ``max_starve_rounds`` times plus one slot per
  concurrently active stream (the structural worst case of the
  starved-first ordering; see ``StreamScheduler._order``).
- **epoch-safety** — epoch monotonicity (the view's epoch never
  regresses), zero stale-epoch leaks (every stale presentation —
  straggler, rejoin request, pre-failover chunk — raised
  ``StaleEpochError``), and the shrink discipline: after a failover,
  no active stream retains deliveries recorded at its dead
  destination under an old lane epoch (``void_deliveries`` must have
  run before the replay).
- **lost-accepted** — an accepted stream is delivered bit-identically
  or the run fails loudly: zero silent corruptions, no zombie
  heartbeats (a killed rank that still beats pins its streams on a
  destination the detector will never confirm dead), and at every
  terminal state zero incomplete accepted streams, zero parked
  requests, and zero held credits.
- **plan-epoch-safety** (``retune`` scopes) — the r14 plan-swap arc
  is exactly as safe as a membership change: the plan epoch never
  regresses, every stale-plan presentation raised
  :class:`~smi_tpu_torch.tuning.swap.StalePlanError`, and no active stream
  still carries a pre-swap plan epoch once the swap installed — the
  quiesce (drain) step can never be skipped
  (the ``swap_without_quiesce`` mutant's conviction).
- **swap-lost-accepted** (``retune`` scopes) — a swap or an aborted
  swap never loses the plan traffic is keyed to: the plan cache
  always holds the entry the swap machine's outcome dictates
  (pre-proposal entry until the swap, the rival after it, the
  pre-proposal entry again after a rollback) — the
  ``rollback_discards_entry`` mutant's conviction.
- **migration-lost-accepted** (``migrate`` scopes) — a live tenant
  migration never loses delivered state: the cutover restores every
  frozen stream's progress from the checkpoint shard packed at
  handoff, so ``mig_lost`` (delivered chunks that did not cross) is
  always zero — the ``cutover_without_handoff`` mutant's conviction.
- **placement-epoch-safety** (``migrate`` scopes) — capacity changes
  never strand accepted work: every active stream's destination is a
  current member (a scale-in with residents would park the rank their
  frames route to, unreachable under the new epoch) — the
  ``scale_in_with_residents`` mutant's conviction.
- **no-split-brain** (``partition`` scopes) — never two primaries for
  one tenant in one epoch: while a cut is in flight, the isolated
  side's stale claim to a tenant must never coexist with a different
  rank currently owning that tenant's route — the
  ``accept_in_minority`` mutant's conviction (its stale-side accept
  collides with the majority's post-failover heir).
- **fenced-actuation** (``partition`` scopes) — no epoch-advancing
  actuator fires without a majority quorum: every actuation recorded
  under the partition arc must have censused at least
  ``quorum_size(members)`` reachable members when it pulled the
  trigger — the ``actuate_without_quorum`` mutant's conviction (it
  fails a rank over from a minority census).
- **kv-shard-safety** (``infer`` scopes) — every accepted request's
  KV-shard set is resident at exactly one live epoch-current rank
  (the rank its route names, under its current lane epoch), or is
  inside a fenced in-flight handoff — the
  ``decode_failover_without_kv_handoff`` mutant's conviction (its
  failover reroutes the transport but strands the resident shards on
  the dead decode rank).
- **generation-lost-accepted** (``infer`` scopes) — a KV handoff
  never rolls back accepted tokens: the cutover resumes each decode
  from the token cursor packed in the handoff shard, so
  ``kv_lost_tokens`` (tokens emitted during the drain that the
  resumed decode forgot) is always zero — the
  ``stale_kv_after_cutover`` mutant's conviction (it resumes from the
  propose-time pre-handoff shards).
"""

from __future__ import annotations

from typing import List, Tuple

from smi_tpu_torch.serving.qos import QOS_CLASSES
from smi_tpu_torch.serving.scheduler import WIRE_CREDITS

#: The checked properties, in reporting order. docs/analysis.md's
#: property table must name every one (drift-guarded by
#: tests/test_perf_docs.py). The two ``plan-*``/``swap-*`` properties
#: engage only on ``retune`` scopes (worlds without a swap machine
#: satisfy them vacuously).
PROPERTIES = ("queue-bound", "stream-credit", "starvation",
              "epoch-safety", "lost-accepted",
              "plan-epoch-safety", "swap-lost-accepted",
              "migration-lost-accepted", "placement-epoch-safety",
              "no-split-brain", "fenced-actuation",
              "kv-shard-safety", "generation-lost-accepted")

Violation = Tuple[str, str]


def check_queue_bound(world) -> List[Violation]:
    out: List[Violation] = []
    gate = world.gate
    occ = gate.occupancy()
    if occ > gate.pool:
        out.append((
            "queue-bound",
            f"stream-credit occupancy {occ} exceeds pool {gate.pool}",
        ))
    for qos, q in gate.pending.items():
        if len(q) > gate.pending_bound:
            out.append((
                "queue-bound",
                f"pending queue for {qos} grew to {len(q)} "
                f"(bound {gate.pending_bound})",
            ))
    bound = gate.pool * (1 + len(QOS_CLASSES))
    depth = gate.queue_depth()
    if depth > bound:
        out.append((
            "queue-bound",
            f"queue depth {depth} exceeds the structural bound {bound}",
        ))
    return out


def check_stream_credit(world) -> List[Violation]:
    out: List[Violation] = []
    gate = world.gate
    active_by_class = {c: 0 for c in QOS_CLASSES}
    for st in world.active:
        active_by_class[st.request.qos] += 1
    for qos in QOS_CLASSES:
        if gate.held[qos] != active_by_class[qos]:
            out.append((
                "stream-credit",
                f"pool holds {gate.held[qos]} {qos} credit(s) but "
                f"{active_by_class[qos]} {qos} stream(s) are "
                f"accepted-and-incomplete — a stream credit "
                f"{'leaked' if gate.held[qos] > active_by_class[qos] else 'was double-released'}",
            ))
    for lane in world.lanes:
        window = lane.credits + len(lane.in_flight) + len(lane.landed)
        if window != WIRE_CREDITS:
            out.append((
                "stream-credit",
                f"rank {lane.rank}'s wire lane balances to {window} "
                f"credit(s) instead of {WIRE_CREDITS} — the credit "
                f"window {'minted' if window > WIRE_CREDITS else 'lost'}"
                f" a wire credit",
            ))
    return out


def check_starvation(world) -> List[Violation]:
    out: List[Violation] = []
    bound = world.scheduler.max_starve_rounds + len(world.active)
    for st in world.active:
        if st.next_to_send >= st.total_chunks:
            continue  # fully sent: no longer competing for the lane
        if st.skips > bound:
            out.append((
                "starvation",
                f"stream {st.request.stream_id} ({st.request.qos}) "
                f"was passed over {st.skips} times — past the aging "
                f"bound {world.scheduler.max_starve_rounds} plus the "
                f"{len(world.active)} concurrent stream(s); the "
                f"starved-first ordering is not engaging",
            ))
    return out


def check_epoch_safety(world) -> List[Violation]:
    out: List[Violation] = []
    if world.view.epoch < world._epoch_watermark:
        out.append((
            "epoch-safety",
            f"membership epoch regressed from "
            f"{world._epoch_watermark} to {world.view.epoch}",
        ))
    if world.stale_leaks:
        out.append((
            "epoch-safety",
            f"{world.stale_leaks} stale-epoch presentation(s) were "
            f"accepted instead of raising StaleEpochError — traffic "
            f"from a dead incarnation folded into the current epoch",
        ))
    for st in world.active:
        meta = world.delivery_meta.get(st.index, {})
        for seq, (rank, lane_epoch) in meta.items():
            if rank != st.dst or lane_epoch != st.lane_epoch:
                out.append((
                    "epoch-safety",
                    f"stream {st.request.stream_id} retains chunk "
                    f"{seq} delivered at rank {rank} under lane "
                    f"epoch {lane_epoch}, but the stream now routes "
                    f"to rank {st.dst} at lane epoch "
                    f"{st.lane_epoch} — the epoch bump did not void "
                    f"the dead consumer's deliveries "
                    f"(ProgressLog.void_deliveries never ran)",
                ))
                return out
    return out


def check_lost_accepted(world) -> List[Violation]:
    out: List[Violation] = []
    if world.corruptions:
        out.append((
            "lost-accepted",
            f"{world.corruptions} accepted stream(s) completed with "
            f"wrong bits — delivery is not bit-identical to the "
            f"submission",
        ))
    for st in world.active:
        if st.dst in world.zombie_beats:
            out.append((
                "lost-accepted",
                f"accepted stream {st.request.stream_id} targets "
                f"killed rank {st.dst}, which heartbeated AFTER the "
                f"kill — the detector will never confirm the death, "
                f"so the stream can never complete or fail over",
            ))
            return out
    return out


def check_plan_epoch_safety(world) -> List[Violation]:
    """The r14 swap arc: plan-epoch monotonicity, loud stale-plan
    rejection, and the quiesce discipline — after a swap installs, no
    active stream may still be keyed to the retired plan epoch.
    Vacuous on worlds without a swap machine (non-``retune`` scopes)."""
    swap = getattr(world, "swap", None)
    if swap is None:
        return []
    out: List[Violation] = []
    if swap.plan_epoch < world._plan_epoch_watermark:
        out.append((
            "plan-epoch-safety",
            f"plan epoch regressed from "
            f"{world._plan_epoch_watermark} to {swap.plan_epoch}",
        ))
    if world.stale_plan_leaks:
        out.append((
            "plan-epoch-safety",
            f"{world.stale_plan_leaks} stale-plan presentation(s) "
            f"were accepted instead of raising StalePlanError — "
            f"traffic planned under a retired entry folded into the "
            f"live plan",
        ))
    for st in world.active:
        stamp = world.stream_plan_epoch.get(st.index, swap.plan_epoch)
        if stamp != swap.plan_epoch:
            out.append((
                "plan-epoch-safety",
                f"stream {st.request.stream_id} is still in flight "
                f"under plan epoch {stamp} but the active plan is at "
                f"epoch {swap.plan_epoch} — the swap installed "
                f"without draining the streams keyed to the old plan "
                f"(quiesce never ran)",
            ))
            return out
    return out


def check_swap_lost_accepted(world) -> List[Violation]:
    """Zero lost-accepted ACROSS a swap or rollback: the plan cache
    must always hold the entry the swap machine's outcome dictates —
    a rolled-back swap that dropped (or mis-restored) the pre-proposal
    entry leaves accepted traffic keyed to a plan that no longer
    exists. (The explorer drives aborts from the pre-swap states only,
    matching the front-end's quiesce-timeout path; PlanSwap's
    post-swap restore branch is unit-tested, not exhaustively
    explored.) Vacuous on worlds without a swap machine."""
    swap = getattr(world, "swap", None)
    if swap is None:
        return []
    expected = world.swap_expected_entry
    got = world.plan_cache.lookup(swap.key)
    if got is None:
        return [(
            "swap-lost-accepted",
            f"the plan cache no longer holds an entry for "
            f"{swap.key.signature()} (swap state {swap.state!r}) — a "
            f"rolled-back swap must restore the pre-proposal plan, or "
            f"the traffic keyed to it is lost",
        )]
    if expected is not None and (
        got.knobs.get("algorithm") != expected.knobs.get("algorithm")
    ):
        return [(
            "swap-lost-accepted",
            f"the active entry for {swap.key.signature()} names "
            f"{got.knobs.get('algorithm')!r} but the swap machine's "
            f"outcome (state {swap.state!r}) dictates "
            f"{expected.knobs.get('algorithm')!r} — commit/rollback "
            f"and the cache disagree",
        )]
    return []


def check_migration_lost_accepted(world) -> List[Violation]:
    """The r16 migration arc: delivered state always crosses the
    cutover — ``mig_lost`` counts chunks whose delivery record did not
    come back out of the handoff shard. Vacuous on non-``migrate``
    scopes (the counter only moves inside the migration arc)."""
    scope = getattr(world, "scope", None)
    if scope is None or not getattr(scope, "migrate", 0):
        return []
    if world.mig_lost:
        return [(
            "migration-lost-accepted",
            f"{world.mig_lost} delivered chunk(s) were lost across "
            f"the migration cutover — the handoff shard was never "
            f"packed (or never restored), so the destination restarts "
            f"the stream(s) from nothing and 'accepted' silently "
            f"stopped being durable",
        )]
    return []


def check_placement_epoch_safety(world) -> List[Violation]:
    """The r16 capacity arc: a scale-in may only park a rank with
    zero residents — every active stream's destination must be a
    current member. Vacuous on non-``migrate`` scopes (kill scopes
    reroute inside the same failover action, so only the elasticity
    actuators can strand a destination)."""
    scope = getattr(world, "scope", None)
    if scope is None or not getattr(scope, "migrate", 0):
        return []
    for st in world.active:
        if st.dst not in world.view.members:
            return [(
                "placement-epoch-safety",
                f"active stream {st.request.stream_id} is destined to "
                f"rank {st.dst}, which is not a member (members: "
                f"{sorted(world.view.members)}) — a capacity change "
                f"parked a rank that still holds residents, so their "
                f"frames route to a destination the new epoch cannot "
                f"reach",
            )]
    return []


def check_no_split_brain(world) -> List[Violation]:
    """The r17 partition arc: never two primaries for one tenant in
    one epoch. The isolated side's stale claim (a ``minority_accept``
    only a lying ``_accept_ok`` enables) must never coexist with a
    DIFFERENT rank currently owning the tenant's route — once the
    majority fails the cut rank over, the heir and the stale claimant
    would both be accepting the same tenant's streams. Vacuous on
    non-``partition`` scopes (the claims map only moves inside the
    partition arc)."""
    scope = getattr(world, "scope", None)
    if scope is None or not getattr(scope, "partition", 0):
        return []
    for tenant, claimed in sorted(world.minority_claims.items()):
        owner = world._route(tenant)
        if owner != claimed:
            return [(
                "no-split-brain",
                f"tenant t{tenant} has two primaries in epoch "
                f"{world.view.epoch}: rank {claimed} (the partitioned "
                f"side's stale claim) and rank {owner} (the current "
                f"route owner) — the minority accepted a new stream "
                f"while cut off, so both sides are serving the same "
                f"tenant",
            )]
    return []


def check_fenced_actuation(world) -> List[Violation]:
    """The r17 partition arc: no epoch-advancing actuator fires
    without a majority quorum. Every actuation censused under the arc
    must have reached at least ``quorum_size(members)`` members when
    it pulled the trigger. Vacuous on non-``partition`` scopes (the
    actuation log only moves inside the partition arc)."""
    scope = getattr(world, "scope", None)
    if scope is None or not getattr(scope, "partition", 0):
        return []
    from smi_tpu_torch.parallel.membership import quorum_size

    for what, reachable, members in world.actuations:
        needed = quorum_size(members)
        if reachable < needed:
            return [(
                "fenced-actuation",
                f"actuation {what!r} fired with only {reachable} of "
                f"{members} member(s) reachable — a majority quorum "
                f"needs {needed}, so a minority-side census mutated "
                f"membership state it had no mandate over",
            )]
    return []


def check_kv_shard_safety(world) -> List[Violation]:
    """The r20 inference arc: an accepted request's resident KV-shard
    set lives at exactly one live epoch-current rank — the rank its
    route names, under its current lane epoch — or sits inside a
    fenced in-flight handoff (``handoff``/``cutover`` arc states,
    where the source's decode is frozen and the shards are mid-
    transport by design). A failover that reroutes the request
    without restoring its shards at the heir strands the KV on a
    dead rank the new epoch cannot reach. Vacuous on non-``infer``
    scopes (the residency map only moves inside the inference arc)."""
    scope = getattr(world, "scope", None)
    if scope is None or not getattr(scope, "infer", 0):
        return []
    arc = world.kv_arc
    for st in world.active:
        idx = st.index
        res = world.kv_resident.get(idx)
        if res is None:
            continue  # prefill transport still in flight: no shards yet
        if (arc is not None and arc["state"] in ("handoff", "cutover")
                and idx in arc["streams"]):
            continue  # fenced in-flight handoff: mid-move is legal
        rank, ep = res
        if rank not in world.view.members:
            return [(
                "kv-shard-safety",
                f"accepted request {st.request.stream_id}'s KV shards "
                f"are resident at rank {rank}, which is not a member "
                f"(members: {sorted(world.view.members)}) — the "
                f"failover rerouted the request to rank {st.dst} but "
                f"never handed its shards off, so generation resumes "
                f"against KV stranded on a dead decode rank",
            )]
        if rank != st.dst or ep != st.lane_epoch:
            return [(
                "kv-shard-safety",
                f"accepted request {st.request.stream_id} routes to "
                f"rank {st.dst} at lane epoch {st.lane_epoch} but its "
                f"KV shards are resident at rank {rank} under epoch "
                f"{ep} — route and residency moved apart outside any "
                f"fenced handoff",
            )]
    return []


def check_generation_lost_accepted(world) -> List[Violation]:
    """The r20 inference arc: a KV handoff never rolls back accepted
    tokens — ``kv_lost_tokens`` counts tokens emitted during the
    drain that the cutover's resumed decode forgot (a resume from
    pre-handoff shards instead of the handoff blob). Vacuous on
    non-``infer`` scopes (the counter only moves at a KV cutover)."""
    scope = getattr(world, "scope", None)
    if scope is None or not getattr(scope, "infer", 0):
        return []
    if world.kv_lost_tokens:
        return [(
            "generation-lost-accepted",
            f"{world.kv_lost_tokens} accepted token(s) were rolled "
            f"back across the KV handoff cutover — the destination "
            f"resumed generation from pre-handoff shards instead of "
            f"the shard set packed at handoff, so tokens already "
            f"emitted (and possibly streamed to the caller) were "
            f"silently re-generated or lost",
        )]
    return []


def check_state(world) -> List[Violation]:
    """All per-state invariants, in property order."""
    out: List[Violation] = []
    out.extend(check_queue_bound(world))
    out.extend(check_stream_credit(world))
    out.extend(check_starvation(world))
    out.extend(check_epoch_safety(world))
    out.extend(check_lost_accepted(world))
    out.extend(check_plan_epoch_safety(world))
    out.extend(check_swap_lost_accepted(world))
    out.extend(check_migration_lost_accepted(world))
    out.extend(check_placement_epoch_safety(world))
    out.extend(check_no_split_brain(world))
    out.extend(check_fenced_actuation(world))
    out.extend(check_kv_shard_safety(world))
    out.extend(check_generation_lost_accepted(world))
    return out


def check_terminal(world) -> List[Violation]:
    """Terminal states additionally owe completion: every accepted
    stream delivered (its WAL holding every chunk), nothing parked,
    and every stream credit back in the pool."""
    out = check_state(world)
    if world.active:
        stuck = ", ".join(
            f"{st.request.stream_id} ({len(st.delivered)}/"
            f"{st.total_chunks} delivered at rank {st.dst})"
            for st in world.active
        )
        out.append((
            "lost-accepted",
            f"terminal state with {len(world.active)} accepted "
            f"stream(s) undelivered: {stuck}",
        ))
    pending = sum(len(q) for q in world.gate.pending.values())
    if pending:
        out.append((
            "lost-accepted",
            f"terminal state with {pending} request(s) still parked "
            f"at the admission edge — neither admitted nor shed",
        ))
    if not world.active and world.gate.occupancy():
        out.append((
            "stream-credit",
            f"terminal state holds {world.gate.occupancy()} stream "
            f"credit(s) with zero active streams — credits leaked",
        ))
    for st in world.completed:
        missing = st.wal.missing(
            (st.index, seq) for seq in range(st.total_chunks)
        )
        if missing:
            out.append((
                "lost-accepted",
                f"completed stream {st.request.stream_id}'s WAL is "
                f"missing delivery record(s) {sorted(missing)} — the "
                f"durable log disagrees with the delivery",
            ))
    return out
