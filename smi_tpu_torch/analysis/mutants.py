"""Deliberately broken protocol variants — the verifier's existence proof.

The port's copy of :mod:`smi_tpu.analysis.mutants`, kept in step
with it line for line.

A verifier that has never caught a bug proves nothing, so each mutant
here reinstates one of the defect classes the credit discipline exists
to prevent, expressed as an *event-stream transformer* wrapped around a
healthy rank's generator (the same adapter shape as
``credits.instance_steps``/``verified_steps``, so the clean state
machines stay untouched):

- :func:`drop_grant` — ``"dropped_wait"``: the credit grant a partner's
  semaphore wait is matched against is dropped, leaving that wait
  dangling forever. Statically a :class:`~.verifier.StaticDeadlock`
  (the starved wait and the ranks transitively blocked behind it);
  dynamically the exhaustive fuzzer's
  :class:`~smi_tpu_torch.parallel.credits.DeadlockError` on every schedule.
- :func:`reuse_slots` — ``"reused_slot"``: two comm buffers collapse to
  one VMEM address (an addressing/codegen bug): DMA destinations and
  local reads/writes are remapped while the semaphore wiring stays
  intact. Statically a :class:`~.verifier.SlotRace` naming both
  accesses; dynamically a
  :class:`~smi_tpu_torch.parallel.credits.ClobberError` (or wrong delivery)
  under the schedules that interleave the aliased writes.
- :func:`duplicate_grant` — ``"unbalanced_grant"``: one credit grant is
  signalled twice. Statically a
  :class:`~.verifier.CreditConservation` finding naming the surplus
  domain; dynamically
  :class:`~smi_tpu_torch.parallel.credits.CreditLeakError` at exit (or a
  clobber when a schedule spends the surplus early).
- :func:`delay_grant` — ``"late_grant"``: every rank holds its credit
  grant until after its own wait — the neighbour handshake becomes a
  genuine cross-rank wait-for *cycle* (every grant still exists; no
  wait is starved), which the deadlock check must report as the
  minimal cycle of (rank, step, primitive) events.

``tests/test_analysis.py``'s differential harness runs every mutant
through BOTH tiers and asserts the verdicts agree — same defect class,
same named events — on every space the dynamic fuzzer can exhaust.
"""

from __future__ import annotations

from typing import Callable, Iterator, List

from smi_tpu_torch.parallel import credits as C

from smi_tpu_torch.analysis.verifier import build_generators


def _transformed(gen: Iterator, fn: Callable[[tuple], List[tuple]]):
    """Apply ``fn`` (action -> replacement actions, possibly empty or
    duplicated) to one rank's stream, staying ``send``-transparent for
    ``read_slot`` feedback."""
    value = None
    while True:
        try:
            action = gen.send(value)
        except StopIteration:
            return
        value = None
        for out in fn(action):
            value = yield out


def drop_grant(gen: Iterator, nth: int = 0):
    """Drop the ``nth`` credit grant this rank signals — the matched
    downstream wait can never complete (the 'dropped wait')."""
    state = {"k": 0}

    def fn(action):
        if action[0] == "signal" and action[2] == C.SEM_CREDIT:
            k = state["k"]
            state["k"] += 1
            if k == nth:
                return []
        return [action]

    return _transformed(gen, fn)


def duplicate_grant(gen: Iterator, nth: int = 0):
    """Signal the ``nth`` credit grant twice — a surplus unit the
    protocol never consumes (or spends on an RDMA it had no right to)."""
    state = {"k": 0}

    def fn(action):
        if action[0] == "signal" and action[2] == C.SEM_CREDIT:
            k = state["k"]
            state["k"] += 1
            if k == nth:
                return [action, action]
        return [action]

    return _transformed(gen, fn)


def reuse_slots(gen: Iterator, slot_map: Callable[[int], int]):
    """Remap the physical slot ADDRESS of every dma / read / write
    while leaving semaphore indices untouched — aliased scratch, the
    realistic codegen bug where two logical buffers share one VMEM
    address."""

    def fn(action):
        kind = action[0]
        if kind == "dma":
            _, target, slot, payload, si, ri = action
            return [("dma", target, slot_map(slot), payload, si, ri)]
        if kind == "read_slot":
            return [("read_slot", slot_map(action[1]))]
        if kind == "write_slot":
            return [("write_slot", slot_map(action[1]), action[2])]
        return [action]

    return _transformed(gen, fn)


def delay_grant(gen: Iterator, nth: int = 0):
    """Hold this rank's ``nth`` credit grant until after its next wait
    has completed. Applied to EVERY rank (a shared scheduling bug),
    each rank then waits for a grant its neighbour is holding behind
    the same wait — a genuine cross-rank wait-for CYCLE, not a
    starvation: every grant still exists in some remaining sequence."""
    state = {"k": 0, "held": None}

    def fn(action):
        if action[0] == "signal" and action[2] == C.SEM_CREDIT:
            k = state["k"]
            state["k"] += 1
            if k == nth:
                state["held"] = action
                return []
        out = [action]
        if action[0] == "wait" and state["held"] is not None:
            out.append(state["held"])
            state["held"] = None
        return out

    return _transformed(gen, fn)


#: Mutant registry. The first three are the acceptance matrix
#: (dropped wait -> StaticDeadlock, reused slot -> slot race,
#: unbalanced grant -> credit-conservation); ``late_grant`` is the
#: cyclic-deadlock shape (a wait-for cycle rather than a starved wait).
MUTANTS = ("dropped_wait", "reused_slot", "unbalanced_grant",
           "late_grant")


# ---------------------------------------------------------------------------
# Control-plane mutants: the model checker's falsifiability story
# ---------------------------------------------------------------------------
#
# Each one breaks exactly one seam of the model's frontend glue — or
# swaps one REAL object for a broken subclass — and must be convicted
# by exactly its named property
# (:data:`smi_tpu_torch.analysis.properties.PROPERTIES`), with the minimal
# counterexample trace replaying as a failing campaign cell
# (``smi_tpu_torch.serving.campaign.replay_model_trace``).


def _model_world_base():
    from smi_tpu_torch.analysis.model import World

    return World


def _leaked_stream_credit_world():
    """``leaked_stream_credit``: a completed stream's credit never
    returns to the admission pool (the release call is lost, e.g. an
    exception path skipping it). Conviction: ``stream-credit`` — the
    pool holds more credits than accepted-incomplete streams at the
    first completion."""
    World = _model_world_base()

    class _LeakedStreamCredit(World):
        def _release_credit(self, st):
            pass  # the completed stream's credit is never released

    return _LeakedStreamCredit


def _skipped_aging_world():
    """``skipped_aging``: the scheduler ships without the starved-first
    ordering term (the aging bump is skipped), so strict class priority
    can pass a ready low-class stream over without bound. Conviction:
    ``starvation`` — a stream's skip counter crosses the aging bound
    plus the concurrent-stream slack."""
    from smi_tpu_torch.serving.qos import CLASS_PRIORITY
    from smi_tpu_torch.serving.scheduler import StreamScheduler

    World = _model_world_base()

    class _NoAgingScheduler(StreamScheduler):
        def _order(self, eligible):
            return sorted(
                eligible,
                key=lambda s: (CLASS_PRIORITY[s.request.qos], s.index),
            )

    class _SkippedAging(World):
        def _make_scheduler(self, scope):
            return _NoAgingScheduler(check_deadlines=False,
                                     max_starve_rounds=scope.starve)

    return _SkippedAging


def _epoch_bump_without_void_world():
    """``epoch_bump_without_void``: the failover bumps the epoch and
    reroutes the stream but skips ``ProgressLog.void_deliveries`` (and
    the delivery/lane-epoch reset), so the dead consumer's partial
    deliveries are silently folded into the rerouted stream.
    Conviction: ``epoch-safety`` — an active stream retains deliveries
    recorded at the dead rank under the old lane epoch."""
    World = _model_world_base()

    class _EpochBumpWithoutVoid(World):
        def _reroute_stream(self, st, owner):
            st.dst = owner  # ...but the dead rank's deliveries remain

    return _EpochBumpWithoutVoid


def _heartbeat_after_confirm_world():
    """``heartbeat_after_confirm``: a killed rank keeps heartbeating
    (the zombie NIC — the host crashed mid-consume but its heartbeat
    path survived), so phi never accrues and the detector can never
    confirm the death. Conviction: ``lost-accepted`` — a stream parked
    on the zombie destination can never complete or fail over."""
    World = _model_world_base()

    class _HeartbeatAfterConfirm(World):
        def _beat_ranks(self):
            return sorted(self.view.members)  # killed ranks beat too

    return _HeartbeatAfterConfirm


def _swap_without_quiesce_world():
    """``swap_without_quiesce``: the swap driver's drain census lies —
    the plan installs while streams keyed to the old plan are still in
    flight (the quiesce step is skipped). Only reachable on ``retune``
    scopes; benign elsewhere. Conviction: ``plan-epoch-safety`` — an
    active stream still carries the retired plan epoch after the
    install, with the BFS-minimal trace admit -> propose -> quiesce ->
    swap."""
    World = _model_world_base()

    class _SwapWithoutQuiesce(World):
        def _swap_ready(self):
            return True  # ...regardless of the drain set

    return _SwapWithoutQuiesce


def _rollback_discards_entry_world():
    """``rollback_discards_entry``: the abort path drops the plan-cache
    entry instead of leaving/restoring the pre-proposal plan — traffic
    keyed to the plan has nothing to run under. Conviction:
    ``swap-lost-accepted`` — the cache no longer holds the entry the
    swap machine's outcome dictates."""
    World = _model_world_base()

    class _RollbackDiscardsEntry(World):
        def _rollback_swap(self, reason):
            self.swap.rollback(reason)
            # ...and the entry goes with it (the defect)
            self.plan_cache.entries.pop(
                self.swap.key.signature(), None
            )

    return _RollbackDiscardsEntry


def _cutover_without_handoff_world():
    """``cutover_without_handoff``: the migration driver's readiness
    check lies — the cutover fires straight from ``draining`` without
    waiting for the handoff shard, so the destination restores from
    nothing and every chunk the source had already delivered is gone.
    Only reachable on ``migrate`` scopes; benign elsewhere.
    Conviction: ``migration-lost-accepted`` — ``mig_lost`` counts the
    delivered state that never crossed."""
    World = _model_world_base()

    class _CutoverWithoutHandoff(World):
        def _cutover_ready(self):
            # ...whether or not the shard was ever packed (the defect)
            return self.migration["state"] in ("draining", "handoff")

    return _CutoverWithoutHandoff


def _scale_in_with_residents_world():
    """``scale_in_with_residents``: the scale-in victim census lies —
    the controller parks a rank without checking for resident streams
    or in-flight frames, stranding accepted work on a non-member.
    Only reachable on ``migrate`` scopes; benign elsewhere.
    Conviction: ``placement-epoch-safety`` — an active stream's
    destination is no longer a member."""
    World = _model_world_base()

    class _ScaleInWithResidents(World):
        def _scale_in_ok(self, rank):
            return True  # ...residents or not (the defect)

    return _ScaleInWithResidents


def _actuate_without_quorum_world():
    """``actuate_without_quorum``: the failover driver's quorum census
    lies — the partitioned rank is failed over even when the side the
    control plane can reach is a minority (the both-sides-minority
    n=2 cut, where the honest world parks every actuator until the
    heal). Only reachable on ``partition`` scopes; benign elsewhere,
    and benign on partition scopes whose reachable side genuinely IS
    a quorum (the lie then agrees with the truth). Conviction:
    ``fenced-actuation`` — the actuation log records a trigger pulled
    with fewer reachable members than ``quorum_size(members)``."""
    World = _model_world_base()

    class _ActuateWithoutQuorum(World):
        def _quorum_ok(self):
            return True  # ...majority reachable or not (the defect)

    return _ActuateWithoutQuorum


def _accept_in_minority_world():
    """``accept_in_minority``: the cut rank ignores its lapsed quorum
    lease and keeps accepting new streams on the stale side. Only
    reachable on ``partition`` scopes; benign on the n=2 cut (no
    quorate majority exists to fail the rank over, so the stale claim
    never collides with an heir). Conviction: ``no-split-brain`` — on
    the n=3 scope the majority legitimately fails the cut rank over,
    and the stale claim plus the heir are two primaries for one
    tenant in one epoch."""
    World = _model_world_base()

    class _AcceptInMinority(World):
        def _accept_ok(self):
            return True  # ...parked or not (the defect)

    return _AcceptInMinority


def _decode_failover_without_kv_handoff_world():
    """``decode_failover_without_kv_handoff``: the decode failover
    treats a generating request like a stateless transport — it
    reroutes the stream to the heir (the kill-scope replay path) but
    never restores the request's resident KV shards there, leaving
    them stranded on the dead rank. The two recovery paths (prefill
    replay vs KV handoff) are confused. Only reachable on ``infer``
    scopes; benign elsewhere. Conviction: ``kv-shard-safety`` — at
    the confirm, the residency map names a non-member rank."""
    World = _model_world_base()

    class _DecodeFailoverWithoutKvHandoff(World):
        def _kv_failover(self, st, heir):
            # ...the stateless-replay path, shards left behind
            self._reroute_stream(st, heir)

    return _DecodeFailoverWithoutKvHandoff


def _stale_kv_after_cutover_world():
    """``stale_kv_after_cutover``: the cutover resumes each decode
    from the propose-time (pre-handoff) shard copy instead of the
    shard set packed at handoff — every token the drain emitted is
    rolled back and silently re-generated. Only reachable on
    ``infer`` scopes; benign elsewhere, and benign on arcs whose
    drain emitted nothing (the stale copy then agrees with the
    blob). Conviction: ``generation-lost-accepted`` —
    ``kv_lost_tokens`` counts the forgotten tokens."""
    World = _model_world_base()

    class _StaleKvAfterCutover(World):
        def _kv_resume(self, idx, restored):
            handed = restored.get(idx)
            st = next(s for s in self.active if s.index == idx)
            delivered = (dict(handed[0]) if handed is not None
                         else dict(st.delivered))
            # ...the token cursor from BEFORE the drain (the defect)
            return (delivered, self.kv_arc["stale"][idx])

    return _StaleKvAfterCutover


#: Control-plane mutant registry: name -> World factory.
_MODEL_MUTANT_FACTORIES = {
    "leaked_stream_credit": _leaked_stream_credit_world,
    "skipped_aging": _skipped_aging_world,
    "epoch_bump_without_void": _epoch_bump_without_void_world,
    "heartbeat_after_confirm": _heartbeat_after_confirm_world,
    "swap_without_quiesce": _swap_without_quiesce_world,
    "rollback_discards_entry": _rollback_discards_entry_world,
    "cutover_without_handoff": _cutover_without_handoff_world,
    "scale_in_with_residents": _scale_in_with_residents_world,
    "actuate_without_quorum": _actuate_without_quorum_world,
    "accept_in_minority": _accept_in_minority_world,
    "decode_failover_without_kv_handoff":
        _decode_failover_without_kv_handoff_world,
    "stale_kv_after_cutover": _stale_kv_after_cutover_world,
}

#: The shipped control-plane mutants, in acceptance-matrix order.
MODEL_MUTANTS = tuple(_MODEL_MUTANT_FACTORIES)

#: The exactly-one property each mutant must be convicted by
#: (docs/analysis.md's control-plane mutant table, drift-guarded).
MODEL_MUTANT_PROPERTY = {
    "leaked_stream_credit": "stream-credit",
    "skipped_aging": "starvation",
    "epoch_bump_without_void": "epoch-safety",
    "heartbeat_after_confirm": "lost-accepted",
    "swap_without_quiesce": "plan-epoch-safety",
    "rollback_discards_entry": "swap-lost-accepted",
    "cutover_without_handoff": "migration-lost-accepted",
    "scale_in_with_residents": "placement-epoch-safety",
    "actuate_without_quorum": "fenced-actuation",
    "accept_in_minority": "no-split-brain",
    "decode_failover_without_kv_handoff": "kv-shard-safety",
    "stale_kv_after_cutover": "generation-lost-accepted",
}


def model_mutant_world(mutant: str):
    """The broken-``World`` class for one control-plane mutant — pass
    it to :func:`smi_tpu_torch.analysis.model.check_scope` as
    ``world_factory``."""
    try:
        factory = _MODEL_MUTANT_FACTORIES[mutant]
    except KeyError:
        raise ValueError(
            f"unknown control-plane mutant {mutant!r}; known: "
            f"{list(MODEL_MUTANTS)}"
        ) from None
    return factory()


def mutant_generators(protocol: str, n: int, mutant: str,
                      chunks: int = 3, slices: int = 2,
                      rank: int = 0, nth: int = 0) -> List[Iterator]:
    """Per-rank generators of ``protocol`` with one mutant applied.

    ``dropped_wait`` / ``unbalanced_grant`` damage a single ``rank``
    (a one-rank firmware bug); ``reused_slot`` and ``late_grant``
    apply to EVERY rank (the compiled kernel is shared, so an
    addressing or scheduling bug ships to all of them).
    """
    gens = build_generators(protocol, n, chunks=chunks, slices=slices)
    if mutant == "dropped_wait":
        gens[rank] = drop_grant(gens[rank], nth=nth)
    elif mutant == "unbalanced_grant":
        gens[rank] = duplicate_grant(gens[rank], nth=nth)
    elif mutant == "late_grant":
        gens = [delay_grant(g, nth=nth) for g in gens]
    elif mutant == "reused_slot":
        if protocol == "all_reduce_chunked":
            slot_map = lambda s: s % 2  # noqa: E731 — collapse the pairs
        elif protocol == "allreduce_pod":
            # collapse phase A's double buffer only: the CROSS-phase
            # addresses are genuinely barrier-protected (aliasing them
            # is race-free — the verifier proves it), so the mutant
            # aliases within a phase where only the credits protect
            slot_map = lambda s: 0 if s < 2 else s  # noqa: E731
        else:
            slot_map = lambda s: 0  # noqa: E731 — both buffers at addr 0
        gens = [reuse_slots(g, slot_map) for g in gens]
    else:
        raise ValueError(
            f"unknown mutant {mutant!r}; known: {MUTANTS}"
        )
    return gens
