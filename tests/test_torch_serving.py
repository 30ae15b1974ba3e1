"""The port's serving front end and load campaigns: the reference's
cases, and parity.

``smi_tpu_torch/serving/`` is the port's copy of the JAX package's
serving tier (pure Python on the membership step clock): the front end
with admission, stream credits, wire lanes, failover, WAL replay and the
migration arc, and the seeded campaigns that drive it. The first part
carries over the cases of ``tests/test_serving.py`` that need the front
end or the campaigns (the leaves' own cases are in
``tests/test_torch_serving_leaves.py``; ``bench.py``'s field has no
counterpart in the port), its two tenant-channel cases on an 8-rank CPU
``LocalWorld`` in place of the JAX communicator, and the
``run_retune_cell`` and model-replay cases of ``tests/test_retune.py``.
The second part runs the same seeds through both packages with the
tolerance "equal": every cell and campaign report, the front end's
flight recorder, metrics and SLO health, and the replays of the model
checker's counterexamples, as sorted-key JSON.
"""

import json

import pytest

from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.parallel import faults as F
from smi_tpu_torch.parallel.membership import (
    MembershipView,
    WATCHDOG_TICKS,
    route_owner,
)
from smi_tpu_torch.parallel.recovery import ProgressLog
from smi_tpu_torch.serving import admission as A
from smi_tpu_torch.serving import qos as Q
from smi_tpu_torch.serving import scheduler as S
from smi_tpu_torch.serving.campaign import (
    bench_fields,
    load_campaign,
    run_load_cell,
    serve_selftest,
)
from smi_tpu_torch.serving.frontend import ServingFrontend, tenant_base_rank
from smi_tpu_torch.utils.watchdog import WatchdogTimeout

from torch_serving_parity import canon, frontend_state

pytestmark = pytest.mark.serving


# ---------------------------------------------------------------------------
# Frontend: healthy runs, backpressure, integrity, failover
# ---------------------------------------------------------------------------


def test_frontend_healthy_run_delivers_bit_identically():
    fe = ServingFrontend(4, seed=0, pool=8)
    reqs = []
    for i in range(12):
        reqs.append(fe.submit(
            f"t{i % 3}", "interactive", (f"p{i}a", f"p{i}b", f"p{i}c")
        ))
        fe.step()
    fe.drain()
    rep = fe.report()
    assert rep["lost_accepted"] == 0
    assert rep["silent_corruptions"] == 0
    assert rep["delivered"]["interactive"] == 12
    assert fe.gate.occupancy() == 0  # every stream credit returned
    # per-stream delivery is bit-identical and WAL-complete
    for st in fe.completed:
        assert tuple(
            st.delivered[i] for i in range(st.total_chunks)
        ) == st.request.chunks
        assert not st.wal.missing(
            {(st.index, i) for i in range(st.total_chunks)}
        )


def test_frontend_transient_stream_ids_are_per_tenant_sequences():
    fe = ServingFrontend(4, seed=0)
    a0 = fe.submit("alice", "interactive", ("x",))
    b0 = fe.submit("bob", "interactive", ("y",))
    a1 = fe.submit("alice", "interactive", ("z",))
    assert a0.stream_id == ("alice", 0)
    assert a1.stream_id == ("alice", 1)
    assert b0.stream_id == ("bob", 0)


def test_frontend_stalled_consumer_backpressures_to_admission():
    fe = ServingFrontend(4, seed=1, pool=8,
                         tenant_rate=10, tenant_burst=100)
    victim = tenant_base_rank("t0", 4)
    fe.stall_consumer(victim, fe.clock.now() + 10_000)  # forever
    shed = None
    for i in range(40):
        try:
            fe.submit("t0", "interactive", (f"c{i}",))
        except Q.AdmissionRejected as e:
            shed = e
            break
        fe.step()
    assert shed is not None, "stall never reached the admission edge"
    assert shed.reason == f"backpressure:rank{victim}"
    # the backlog cap held: the stalled destination owns at most its
    # per-route share of the pool
    assert fe._backlog(victim) <= fe.dst_cap
    fe.gate.assert_bounded()
    # no membership consequence: the rank still heartbeats
    assert not fe.confirmed and not fe.suspected


def test_frontend_integrity_damage_is_detected_and_replayed():
    fe = ServingFrontend(4, seed=2, pool=8)
    req = fe.submit("t1", "batch", ("aa", "bb", "cc", "dd"))
    # tamper the first chunk in flight once: flip payload, keep CRC
    state = {"done": False}
    orig_send = S.WireLane.send

    def tampering_send(lane, stream, seq, payload, now):
        orig_send(lane, stream, seq, payload, now)
        if not state["done"] and seq == 1:
            state["done"] = True
            item = lane.in_flight[-1]
            item.frame = C.Frame(
                item.frame.src, item.frame.seq, True,
                "garbage", item.frame.crc,
            )

    try:
        S.WireLane.send = tampering_send
        fe.drain()
    finally:
        S.WireLane.send = orig_send
    rep = fe.report()
    assert rep["integrity_detections"] == 1   # named, at the chunk
    assert rep["silent_corruptions"] == 0     # and NOT delivered wrong
    assert rep["lost_accepted"] == 0
    assert rep["replayed_chunks"] >= 1        # the damaged chunk moved again
    st = fe.completed[0]
    assert tuple(
        st.delivered[i] for i in range(4)
    ) == req.chunks


def test_frontend_kill_detect_failover_replay():
    fe = ServingFrontend(4, seed=3, pool=12,
                         tenant_rate=10, tenant_burst=100)
    # aim a tenant at a known rank, get streams in flight, then kill
    victim_tenant = next(
        f"t{i}" for i in range(32) if tenant_base_rank(f"t{i}", 4) == 2
    )
    submitted = []
    for i in range(3):
        submitted.append(fe.submit(
            victim_tenant, "batch", tuple(f"s{i}c{c}" for c in range(6))
        ))
        fe.step()
    fe.kill(2)
    fe.drain()
    rep = fe.report()
    assert rep["confirmed"] == [2]
    assert rep["detect_ticks"] is not None
    assert rep["detect_ticks"] <= WATCHDOG_TICKS
    assert rep["members"] == [0, 1, 3]
    assert rep["epoch"] == 1
    # the failover voided partial deliveries and replayed: accepted
    # streams completed bit-identically at the heir
    assert rep["lost_accepted"] == 0
    assert rep["silent_corruptions"] == 0
    assert rep["replayed_chunks"] > 0
    assert rep["stale_epoch_rejections"] >= 1
    assert rep["stale_epoch_leaks"] == 0
    heir = route_owner(fe.view, 2, 4)
    assert heir == 3
    for st in fe.completed:
        assert st.dst != 2


def test_frontend_fully_sent_stream_still_fires_its_deadline():
    """A stream whose chunks are ALL sent into a stalled lane has
    nothing left to schedule, so the send-time checks alone would
    never fire — the per-tick check must still surface the budget
    expiry as a named WatchdogTimeout with the serving dump (the
    'never a silent loss' contract)."""
    fe = ServingFrontend(4, seed=5, pool=8,
                         tenant_rate=10, tenant_burst=100)
    victim = tenant_base_rank("t0", 4)
    req = fe.submit("t0", "interactive", ("a", "b"))
    fe.step()  # both chunks send into the lane
    fe.stall_consumer(
        victim, fe.clock.now() + req.deadline_ticks + 200
    )
    with pytest.raises(WatchdogTimeout) as e:
        for _ in range(req.deadline_ticks + 50):
            fe.step()
    msg = str(e.value)
    assert "awaiting delivery" in msg
    assert "('t0', 0)" in msg
    assert e.value.state  # the per-stream serving mirror rides along


def test_frontend_pending_admissions_respect_the_backlog_cap():
    """The per-destination cap must hold for requests admitted LATER
    from the pending queue, not just at submit time: a credit freeing
    while a destination is sick must not slip parked requests past
    its backlog cap."""
    fe = ServingFrontend(4, seed=6, pool=4,
                         tenant_rate=10, tenant_burst=100)
    victim = tenant_base_rank("sick", 4)
    healthy = next(
        f"h{i}" for i in range(32)
        if tenant_base_rank(f"h{i}", 4) != victim
    )
    fe.stall_consumer(victim, fe.clock.now() + 10_000)
    # fill the pool: dst_cap streams to the sick rank + healthy rest
    parked = 0
    for i in range(fe.dst_cap):
        fe.submit("sick", "interactive", (f"s{i}",))
    for i in range(fe.gate.pool - fe.dst_cap):
        fe.submit(healthy, "interactive", (f"h{i}",))
    # park more sick-bound requests while the pool is full (they pass
    # the submit-time cap check only until the backlog builds, so
    # offer until two are parked)
    for i in range(8):
        try:
            if not fe.gate.offer(
                Q.Request(tenant="sick", qos="interactive",
                          chunks=(f"p{i}",),
                          arrived_at=fe.clock.now()),
                fe.clock.now(),
            ):
                parked += 1
        except Q.AdmissionRejected:
            break
    assert parked > 0
    # drain the healthy streams: credits free, pump runs — the parked
    # sick-bound requests must stay parked (filter), never pushing the
    # sick backlog past the cap
    for _ in range(60):
        fe.step()
        assert fe._backlog(victim) <= fe.dst_cap, (
            f"backlog {fe._backlog(victim)} exceeded dst_cap "
            f"{fe.dst_cap} via a pending admission"
        )


def test_failover_leaves_live_routes_alone_even_when_diverted():
    """A confirmed death elsewhere must not touch streams on LIVE
    routes — including one the suspect diversion already steered off
    its base owner. Force-moving a partially-delivered stream back
    onto a still-suspected rank would abandon progress for nothing."""
    fe = ServingFrontend(4, seed=21, pool=12,
                         tenant_rate=10, tenant_burst=100)
    # suspend rank 1 (kill it but don't let confirmation land yet)
    fe.kill(1)
    for _ in range(400):
        fe.step()
        if 1 in fe.detector.suspected:
            break
    assert 1 in fe.detector.suspected and 1 in fe.view.members
    # a new stream for a rank-1 tenant diverts to the heir-presumptive
    t1 = next(f"d{i}" for i in range(32)
              if tenant_base_rank(f"d{i}", 4) == 1)
    fe.submit(t1, "batch", tuple(f"c{c}" for c in range(6)))
    diverted = fe.active[-1]
    assert diverted.dst != 1
    diverted_dst = diverted.dst
    # now a DIFFERENT rank is confirmed dead: the diverted stream must
    # keep its live route
    other_dead = next(r for r in (0, 2, 3) if r != diverted_dst)
    fe._failover(other_dead)
    assert diverted.dst == diverted_dst
    assert diverted.replayed_chunks == 0


def test_consume_rejects_pre_failover_chunks_by_epoch():
    """The data-path half of the stale-epoch gate: a chunk sent under
    an old route incarnation that reaches a live consumer is rejected
    by epoch (counted), never folded into the failed-over stream."""
    fe = ServingFrontend(4, seed=22, pool=8,
                         tenant_rate=10, tenant_burst=100)
    fe.submit("t0", "batch", ("a", "b", "c", "d"))
    st = fe.active[0]
    # let a chunk get in flight, then simulate a failover of the
    # stream (fresh lane incarnation) while the old chunk still flies
    lane = fe.lanes[st.dst]
    fe.scheduler.schedule_lane(lane, fe.active, fe.clock.now())
    assert lane.in_flight
    # model what a real failover does: membership epoch bumps and the
    # stream restarts on a fresh lane incarnation (a real failover
    # would also reroute; keeping the rank makes the straggler land
    # at a LIVE consumer — the exact case the data-path gate covers)
    fe.view.epoch += 1
    st.lane_epoch = fe.view.epoch
    st.delivered.clear()
    st.next_to_send = 0
    before = fe.stale_epoch_rejections
    for _ in range(4):
        fe.step()
    assert fe.stale_epoch_rejections > before
    assert fe.stale_epoch_leaks == 0
    # the stale chunks were never folded in; the replayed ones were
    fe.drain()
    assert fe.report()["silent_corruptions"] == 0
    assert fe.report()["lost_accepted"] == 0


def test_run_load_cell_rejects_multi_stall_plans_with_clear_error():
    plan = F.FaultPlan.of([
        F.SlowConsumer(0, from_tick=30, stall_ticks=40),
        F.SlowConsumer(1, from_tick=35, stall_ticks=40),
    ])
    with pytest.raises(ValueError, match="one SlowConsumer per cell"):
        run_load_cell(n=4, seed=0, plan=plan)
    with pytest.raises(ValueError, match="not both"):
        run_load_cell(n=4, seed=0, stall_rank=2,
                      plan=F.FaultPlan.single(
                          F.SlowConsumer(0, from_tick=30)
                      ))


def test_run_load_cell_rejects_faults_outside_the_schedule():
    with pytest.raises(ValueError, match="never fires"):
        run_load_cell(n=4, seed=0, duration=50, kill_rank=1,
                      kill_at=60)
    with pytest.raises(ValueError, match="never fires"):
        run_load_cell(n=4, seed=0, duration=30, stall_rank=1,
                      stall_at=40)
    from smi_tpu_torch.serving.campaign import MIN_CAMPAIGN_DURATION

    with pytest.raises(ValueError, match="minimum"):
        load_campaign(seed=0, duration=MIN_CAMPAIGN_DURATION - 1)


def test_frontend_suspect_drains_new_routes_only():
    fe = ServingFrontend(4, seed=4, pool=12,
                         tenant_rate=10, tenant_burst=100)
    victim_tenant = next(
        f"t{i}" for i in range(32) if tenant_base_rank(f"t{i}", 4) == 1
    )
    fe.kill(1)
    # run until the detector suspects (but does not confirm) rank 1
    for _ in range(400):
        fe.step()
        if 1 in fe.detector.suspected:
            break
    assert 1 in fe.detector.suspected
    before = fe.drained_routes
    fe.submit(victim_tenant, "interactive", ("a", "b"))
    assert fe.drained_routes == before + 1
    st = fe.active[-1]
    assert st.dst != 1  # routed to the heir-presumptive


# ---------------------------------------------------------------------------
# Tenant fairness on the credits simulator (satellite: unequal bursts)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("counts", [
    [2, 12, 4],            # small first
    [12, 6, 2],            # small last (the starvation-prone order)
    [1, 16, 1, 8],         # four tenants, two tiny
])
def test_stream_concurrent_fairness_bounded_gap(seed, counts):
    """>= 3 tenants with unequal burst totals on ONE wire: under
    seeded and adversarial schedules the credit scheduler never
    starves a small stream behind a large one — every stream's
    interleaving gap is bounded by (tenants-1) * chunks_per_burst,
    CPU-deterministic."""
    cpb = 2
    n = 4
    bound = (len(counts) - 1) * cpb
    for strategy in (
        C.Strategy(seed),
        C.DelayDmaStrategy(seed),
        C.FavourRankStrategy(seed % n, seed),
    ):
        outs = C.simulate_tenant_streams(
            n, strategy, counts, chunks_per_burst=cpb
        )
        for s in range(len(counts)):
            for g in range(n):
                gap = C.fairness_gap(outs[g], s)
                assert gap <= bound, (
                    f"stream {s} starved at rank {g}: gap {gap} > "
                    f"bound {bound} (strategy "
                    f"{type(strategy).__name__}, seed {seed})"
                )


def test_stream_concurrent_fairness_counterexample_detects():
    """The regression's teeth: a channel-major schedule (one giant
    burst per stream — what dropping round-interleaving would do)
    blows the small stream's gap far past the round-robin bound."""
    outs = C.simulate_tenant_streams(
        3, C.Strategy(1), [20, 6, 2], chunks_per_burst=20
    )
    gap = max(C.fairness_gap(outs[g], 2) for g in range(3))
    assert gap >= 26  # 20 + 6 chunks ahead of the small stream
    assert gap > (3 - 1) * 2


def test_tenant_streams_delivery_verified_and_exhaustive_smoke():
    # delivery correctness is asserted inside the harness; a tiny
    # configuration additionally sweeps EVERY schedule
    count = C.explore_all_schedules(
        lambda: C.concurrent_stream_generators(
            2, [(0, 1), (1, 1)], chunks_per_burst=1,
            chunk_counts=[1, 2],
        ),
        max_schedules=150_000,
    )
    assert count.explored > 0 and not count.truncated


def test_concurrent_generators_validate_chunk_counts():
    with pytest.raises(ValueError):
        C.concurrent_stream_generators(
            2, [(0, 1), (1, 1)], chunk_counts=[1]
        )
    with pytest.raises(ValueError):
        C.concurrent_stream_generators(
            2, [(0, 1)], chunk_counts=[0]
        )


# ---------------------------------------------------------------------------
# Transient tenant channels (the P2PChannel bridge)
# ---------------------------------------------------------------------------


def test_tenant_stream_port_is_deterministic_and_spread():
    from smi_tpu_torch.parallel.channels import (
        TENANT_PORT_SPACE,
        tenant_stream_port,
    )

    assert tenant_stream_port("alice", 0) == tenant_stream_port(
        "alice", 0
    )
    ports = {
        tenant_stream_port(f"tenant-{i}", s)
        for i in range(16) for s in range(4)
    }
    assert len(ports) >= 60  # 64 identities, near-zero collisions
    assert all(0 <= p < TENANT_PORT_SPACE for p in ports)
    with pytest.raises(ValueError):
        tenant_stream_port("alice", -1)


def test_open_tenant_channel_maps_onto_ring_stream_domains():
    from smi_tpu_torch.kernels.ring import RING_STREAMS
    from smi_tpu_torch.parallel.channels import open_tenant_channel
    from smi_tpu_torch.parallel.local import LocalWorld

    comm = LocalWorld(8, device="cpu").comms[1]
    ch = open_tenant_channel(comm, "alice", 0, src=1, dst=5, count=16)
    assert ch._ring_stream() == ch.port % RING_STREAMS
    # consecutive streams of one tenant rotate barrier domains rather
    # than serializing behind one semaphore
    domains = {
        open_tenant_channel(
            comm, "alice", s, src=1, dst=5, count=16
        )._ring_stream()
        for s in range(8)
    }
    assert len(domains) > 1


def test_open_tenant_channel_transfers_for_real():
    import torch

    from smi_tpu_torch.parallel.channels import open_tenant_channel
    from smi_tpu_torch.parallel.local import LocalWorld

    n = 16
    world = LocalWorld(8, device="cpu")
    x = torch.arange(n, dtype=torch.float32)
    out = world.run(lambda c: open_tenant_channel(
        c, "alice", 3, src=1, dst=5, count=n).transfer(x))
    assert torch.equal(out[5], x)
    for r in range(8):
        if r != 5:
            assert torch.equal(out[r], torch.zeros(n))


# ---------------------------------------------------------------------------
# Chaos under load: seed-pinned campaign (tier-1) + soak (slow)
# ---------------------------------------------------------------------------

PINNED_SEED = 1729


def test_load_cell_overload_sheds_lowest_class_first():
    rep = run_load_cell(n=4, seed=PINNED_SEED, duration=200,
                        overload=2.0)
    assert rep["ok"], rep["verdict"]
    b = rep["brownout_shed"]
    assert b["interactive"] == 0
    assert b["best_effort"] >= b["batch"] >= b["interactive"]
    assert b["best_effort"] > 0  # 2x overload MUST shed something
    assert rep["max_queue_depth"] <= rep["queue_bound"]
    assert rep["admission_latency"]["interactive"]["p99"] <= (
        Q.INTERACTIVE_P99_TICKS
    )


def test_load_cell_kill_one_rank_under_open_loop_traffic():
    """The seed-pinned kill-under-load cell (fast shape, tier-1):
    detection inside the watchdog budget, zero lost accepted, zero
    silent corruption, stale-epoch stragglers rejected, replay
    actually exercised."""
    rep = run_load_cell(n=4, seed=PINNED_SEED, duration=200,
                        overload=1.0, kill_rank=2, kill_at=60)
    assert rep["ok"], rep["verdict"]
    assert rep["confirmed"] == [2]
    assert rep["detect_ticks"] <= WATCHDOG_TICKS
    assert rep["lost_accepted"] == 0
    assert rep["silent_corruptions"] == 0
    assert rep["stale_epoch_rejections"] >= 1
    assert rep["stale_epoch_leaks"] == 0
    assert rep["replayed_chunks"] > 0
    assert rep["members"] == [0, 1, 3]


def test_load_cell_is_deterministic_per_seed():
    a = run_load_cell(n=4, seed=7, duration=120, overload=1.5)
    b = run_load_cell(n=4, seed=7, duration=120, overload=1.5)
    assert json.dumps(a, sort_keys=True) == json.dumps(
        b, sort_keys=True
    )
    c = run_load_cell(n=4, seed=8, duration=120, overload=1.5)
    assert json.dumps(a, sort_keys=True) != json.dumps(
        c, sort_keys=True
    )


def test_load_campaign_seed_pinned_gates():
    camp = load_campaign(seed=PINNED_SEED, trials=1, duration=200)
    assert camp["ok"], camp["failures"]
    assert camp["cells"] == 3
    assert set(camp["outcomes"]) == {
        "overload", "kill", "backpressure"
    }
    assert camp["silent_corruptions"] == 0
    assert camp["lost_accepted"] == 0
    assert camp["stale_epoch_leaks"] == 0
    # the backpressure cell really propagated to the edge
    bp = next(c for c in camp["reports"]
              if c["cell"] == "backpressure")
    assert any(bp["backpressure_shed"].values())
    assert bp["plan"]  # drawn from FaultPlan.random("slow_consumer")


def test_serving_fault_class_registry_stays_seed_pinned():
    """SERVING_FAULT_CLASSES must stay OUT of the seed-pinned base
    FAULT_CLASSES (and the elastic tuple) — the same digest rule that
    protects the recovery campaign's cells."""
    assert F.SERVING_FAULT_CLASSES == ("slow_consumer",)
    assert not set(F.SERVING_FAULT_CLASSES) & set(F.FAULT_CLASSES)
    assert not set(F.SERVING_FAULT_CLASSES) & set(
        F.ELASTIC_FAULT_CLASSES
    )
    plan = F.FaultPlan.random("slow_consumer", 4, 11)
    assert len(plan.slow_consumers) == 1
    f = plan.slow_consumers[0]
    assert 0 <= f.rank < 4 and f.stall_ticks >= 40
    assert not plan.empty
    assert any("SlowConsumer" in line for line in plan.describe())
    with pytest.raises(ValueError):
        F.SlowConsumer(0, stall_ticks=0)


def test_route_owner_is_the_single_failover_authority():
    view = MembershipView(4)
    assert route_owner(view, 2, 4) == 2
    view.confirm_dead(2)
    assert route_owner(view, 2, 4) == 3   # nearest surviving successor
    view.confirm_dead(3)
    assert route_owner(view, 3, 4) == 0
    assert route_owner(view, 1, 4) == 1   # members route to themselves


def test_progress_log_void_deliveries_keeps_contribution():
    log = ProgressLog(rank=0)
    log.contribution = ("a", "b", "c")
    log.record((0, 0), "a")
    log.record((0, 1), "b")
    assert log.void_deliveries() == 2
    assert log.contribution == ("a", "b", "c")
    assert log.missing({(0, 0), (0, 1), (0, 2)}) == {
        (0, 0), (0, 1), (0, 2)
    }
    assert log.void_deliveries() == 0


@pytest.mark.slow
def test_load_campaign_long_soak():
    """The long chaos-under-load soak: many seeds, several shapes —
    every cell must pass its gates."""
    for seed in range(24):
        camp = load_campaign(seed=seed, trials=1)
        assert camp["ok"], (seed, camp["failures"])
    for n in (2, 3, 5, 6, 8):
        camp = load_campaign(seed=PINNED_SEED, n=n)
        assert camp["ok"], (n, camp["failures"])


# ---------------------------------------------------------------------------
# CLI + bench schema
# ---------------------------------------------------------------------------


def test_serve_selftest_gates_hold():
    rep = serve_selftest(seed=0)
    assert rep["ok"], rep["verdict"]
    assert rep["silent_corruptions"] == 0
    assert rep["lost_accepted"] == 0



# ---------------------------------------------------------------------------
# Model checker <-> campaign differential soundness
# ---------------------------------------------------------------------------


@pytest.mark.model
class TestModelCampaignDifferential:
    """Differential soundness in both directions: every control-plane
    mutant counterexample replays as a FAILING campaign cell with the
    matching gate verdict, and traces of the clean world replay as
    passing cells — while the clean model sweep and the seeded
    campaign gates agree on what "healthy" means."""

    def _mutant_finding(self, mutant):
        from smi_tpu_torch import analysis

        from tests.test_torch_model import MODEL_MUTANT_SCOPE

        scope = MODEL_MUTANT_SCOPE[mutant]
        report = analysis.check_scope(
            scope, world_factory=analysis.model_mutant_world(mutant),
            mutant=mutant,
        )
        assert report.findings, f"{mutant} did not manifest"
        return scope, report.findings[0]

    @pytest.mark.parametrize(
        "mutant", ("leaked_stream_credit", "skipped_aging",
                   "epoch_bump_without_void", "heartbeat_after_confirm"))
    def test_counterexample_replays_as_failing_cell(self, mutant):
        from smi_tpu_torch import analysis
        from smi_tpu_torch.serving.campaign import (
            MODEL_GATES,
            replay_model_trace,
        )

        scope, finding = self._mutant_finding(mutant)
        cell = replay_model_trace(scope, finding.trace, mutant=mutant)
        assert cell["ok"] is False
        assert cell["cell"] == "model-replay"
        assert MODEL_GATES[finding.property] in cell["verdict"]
        assert cell["trace_steps"] == len(finding.trace)
        # the JSON round-trip works too: the report's list-form trace
        # and scope dict replay identically
        json_trace = [list(a) for a in finding.trace]
        cell2 = replay_model_trace(scope.to_json(), json_trace,
                                   mutant=mutant)
        assert cell2["verdict"] == cell["verdict"]
        # ...and without the mutant, the same trace diverges or stays
        # clean — the defect lives in the mutated seam, not the trace
        assert analysis.MODEL_MUTANT_PROPERTY[mutant] == finding.property

    def test_clean_trace_replays_ok(self):
        from smi_tpu_torch import analysis
        from smi_tpu_torch.serving.campaign import replay_model_trace

        scope = analysis.DEFAULT_SCOPES[0]
        cell = replay_model_trace(
            scope, [("admit", 0), ("send", 0), ("heartbeat",),
                    ("consume", 0)],
        )
        assert cell["ok"] is True and cell["verdict"] == "ok"
        assert cell["silent_corruptions"] == 0
        assert cell["stale_epoch_leaks"] == 0

    def test_alien_trace_is_rejected_loudly(self):
        from smi_tpu_torch import analysis
        from smi_tpu_torch.serving.campaign import replay_model_trace

        with pytest.raises(ValueError, match="not enabled"):
            replay_model_trace(analysis.DEFAULT_SCOPES[0],
                               [("kill", 0)])  # kill=0 scope

    def test_model_gates_cover_exactly_the_properties(self):
        """The property -> campaign-gate map stays total: a property
        added to the checker must name its campaign gate (and the
        campaign phrases stay aligned with run_load_cell's verdicts)."""
        from smi_tpu_torch import analysis
        from smi_tpu_torch.serving.campaign import MODEL_GATES

        assert set(MODEL_GATES) == set(analysis.PROPERTIES)
        # the shared gates quote the campaign's own verdict phrasing
        assert "lost accepted" in MODEL_GATES["lost-accepted"]
        assert "stale-epoch" in MODEL_GATES["epoch-safety"]
        assert "queue occupancy" in MODEL_GATES["queue-bound"]

    def test_clean_sweep_agrees_with_campaign_gates(self):
        """Both tiers green on the same machine: the smallest model
        scope exhausts clean AND the seeded serving selftest passes
        its gates — the exhaustive tier and the sampled tier agree on
        health (the full-grid clean sweep runs in test_analysis)."""
        from smi_tpu_torch import analysis

        report = analysis.check_scope(analysis.DEFAULT_SCOPES[0])
        assert report.ok and not report.truncated
        selftest = serve_selftest(seed=0)
        assert selftest["ok"], selftest["verdict"]
        # the kill cell's campaign gates and the kill scope's model
        # properties describe the same contract
        assert report.properties == analysis.PROPERTIES


# ---------------------------------------------------------------------------
# The seeded payload-shift campaign cells
# ---------------------------------------------------------------------------


class TestRetuneCell:
    def test_flat_cell_converges_to_rs_ag(self):
        from smi_tpu_torch.serving.campaign import run_retune_cell

        rep = run_retune_cell(n=4, seed=0, duration=160)
        assert rep["ok"], rep["verdict"]
        rt = rep["retune"]
        assert rt["swaps"] >= 1 and rt["rollbacks"] == 0
        assert rep["converged_algorithm"] == "rs_ag"
        assert rep["converged_algorithm"] == rep["expected_algorithm"]
        assert rep["converged_revision"] == 1
        assert rep["convergence_ticks"] is not None
        assert rep["swap_tick"] >= rep["shift_at"]
        assert rep["silent_corruptions"] == 0
        assert rep["lost_accepted"] == 0
        assert rep["stale_epoch_leaks"] == 0
        assert rt["stale_plan_leaks"] == 0
        assert rt["stale_plan_rejections"] >= 1

    def test_pod_cell_converges_to_hierarchical(self):
        from smi_tpu_torch.serving.campaign import run_retune_cell

        rep = run_retune_cell(n=4, seed=1, duration=160, slices=2)
        assert rep["ok"], rep["verdict"]
        assert rep["converged_algorithm"] == "hierarchical"

    def test_tenant_churn_failover_during_the_window(self):
        """Satellite: samples keep flowing from a tenant whose
        destination failed over mid-window — the cells stay separate,
        the failover completes, and the tuner still converges."""
        from smi_tpu_torch.serving.campaign import run_retune_cell

        rep = run_retune_cell(n=4, seed=3, duration=240, kill_rank=1)
        assert rep["ok"], rep["verdict"]
        assert rep["confirmed"] == [1]
        assert rep["converged_algorithm"] == "rs_ag"
        assert rep["replayed_chunks"] >= 0

    def test_cell_is_deterministic_per_seed(self):
        from smi_tpu_torch.serving.campaign import run_retune_cell

        a = run_retune_cell(n=4, seed=7, duration=160)
        b = run_retune_cell(n=4, seed=7, duration=160)
        assert json.dumps(a, sort_keys=True) \
            == json.dumps(b, sort_keys=True)

    def test_degenerate_shapes_are_loud(self):
        from smi_tpu_torch.serving.campaign import run_retune_cell

        with pytest.raises(ValueError, match="minimum"):
            run_retune_cell(duration=60)
        with pytest.raises(ValueError, match="same payload bucket"):
            run_retune_cell(small_kb=64, large_kb=100)
        with pytest.raises(ValueError, match="slices"):
            run_retune_cell(slices=3)
        with pytest.raises(ValueError, match="never fires"):
            run_retune_cell(duration=160, kill_rank=0, kill_at=200)

    def test_frontend_replans_streams_admitted_during_quiesce(self):
        from smi_tpu_torch.serving.campaign import run_retune_cell

        rep = run_retune_cell(n=4, seed=0, duration=160)
        # the report carries the re-plan bookkeeping (>= 0; the drain
        # discipline means the count is exactly the proposing tenant's
        # streams admitted between propose and swap)
        assert rep["retune"]["replanned_streams"] >= 0

    @pytest.mark.slow
    def test_long_drift_soak(self):
        """The long soak: more seeds, longer schedules, both
        topologies — every cell green."""
        from smi_tpu_torch.serving.campaign import run_retune_cell

        for seed in range(4):
            for slices in (None, 2):
                rep = run_retune_cell(n=4, seed=seed, duration=480,
                                      slices=slices)
                assert rep["ok"], (seed, slices, rep["verdict"])


# ---------------------------------------------------------------------------
# The model-checker scope + mutants (the acceptance matrix)
# ---------------------------------------------------------------------------


class TestModelRetune:
    def scope(self):
        from smi_tpu_torch import analysis as A

        (scope,) = [s for s in A.DEFAULT_SCOPES if s.retune]
        return scope

    def test_clean_retune_scope_exhausts_ok(self):
        from smi_tpu_torch import analysis as A

        report = A.check_scope(self.scope())
        assert report.ok, report.describe()
        assert not report.truncated
        assert "plan-epoch-safety" in report.properties
        assert "swap-lost-accepted" in report.properties

    def test_swap_without_quiesce_minimal_trace(self):
        """THE acceptance criterion: convicted by exactly
        plan-epoch-safety, with the BFS-minimal 4-step trace
        admit -> propose -> quiesce -> swap, replayable as a failing
        campaign cell."""
        from smi_tpu_torch import analysis as A
        from smi_tpu_torch.serving.campaign import (
            MODEL_GATES,
            replay_model_trace,
        )

        report = A.check_scope(
            self.scope(),
            world_factory=A.model_mutant_world("swap_without_quiesce"),
            mutant="swap_without_quiesce",
        )
        assert not report.ok
        assert {f.property for f in report.findings} \
            == {"plan-epoch-safety"}
        finding = report.findings[0]
        kinds = [a[0] for a in finding.trace]
        assert kinds == ["admit", "plan_propose", "plan_quiesce",
                         "plan_swap"]
        cell = replay_model_trace(self.scope(), finding.trace,
                                  mutant="swap_without_quiesce")
        assert not cell["ok"]
        assert MODEL_GATES["plan-epoch-safety"] in cell["verdict"]

    def test_rollback_discards_entry_conviction(self):
        from smi_tpu_torch import analysis as A
        from smi_tpu_torch.serving.campaign import (
            MODEL_GATES,
            replay_model_trace,
        )

        report = A.check_scope(
            self.scope(),
            world_factory=A.model_mutant_world(
                "rollback_discards_entry"),
            mutant="rollback_discards_entry",
        )
        assert not report.ok
        assert {f.property for f in report.findings} \
            == {"swap-lost-accepted"}
        finding = report.findings[0]
        assert [a[0] for a in finding.trace] \
            == ["plan_propose", "plan_abort"]
        cell = replay_model_trace(self.scope(), finding.trace,
                                  mutant="rollback_discards_entry")
        assert not cell["ok"]
        assert MODEL_GATES["swap-lost-accepted"] in cell["verdict"]

    def test_retune_mutants_benign_on_non_retune_scopes(self):
        """The swap seams are inert without a swap machine: both
        mutants are clean on every scope with retune=0."""
        from smi_tpu_torch import analysis as A

        scope = A.DEFAULT_SCOPES[0]
        for mutant in ("swap_without_quiesce",
                       "rollback_discards_entry"):
            report = A.check_scope(
                scope, world_factory=A.model_mutant_world(mutant),
                mutant=mutant,
            )
            assert report.ok, mutant

    def test_scope_validation(self):
        from smi_tpu_torch import analysis as A

        with pytest.raises(ValueError, match="retune"):
            A.Scope(retune=2)
        parsed = A.parse_scope("tenants=2,ranks=2,retune=1")
        assert parsed.retune == 1

    def test_clean_world_report_carries_the_retune_block(self):
        from smi_tpu_torch import analysis as A

        world = A.World(self.scope())
        for action in ((("admit", 0)), ("plan_propose",),
                       ("plan_quiesce",)):
            world.apply(tuple(action))
        rep = world.report()
        assert rep["retune"]["swap_state"] == "quiescing"
        assert rep["retune"]["active_algorithm"] == "ring"


# ---------------------------------------------------------------------------
# Parity with the JAX package: the same seeds, the same reports
# ---------------------------------------------------------------------------

#: load cells of the reference's cases and beyond: overload, a kill, a
#: stall (backpressure), a three-rank pod, a wider one, and a faulted
#: plan drawn from the serving fault class
LOAD_CELLS = [
    dict(n=4, seed=PINNED_SEED, duration=200, overload=2.0),
    dict(n=4, seed=PINNED_SEED, duration=200, overload=1.0, kill_rank=2,
         kill_at=60),
    dict(n=4, seed=7, duration=120, overload=1.5),
    dict(n=4, seed=1, duration=240, overload=1.0, stall_rank=1,
         stall_at=40, stall_ticks=60),
    dict(n=3, seed=5, duration=160, overload=1.2, kill_rank=0, kill_at=50),
    dict(n=6, seed=11, duration=200, overload=0.5, tenants=9),
]


@pytest.mark.parametrize("cell", LOAD_CELLS, ids=[
    "overload", "kill", "steady", "stall", "n3-kill", "n6-fair"])
def test_load_cell_equals_the_jax_package_s(cell):
    from smi_tpu.serving import campaign as JC

    ours, fe = run_load_cell(return_frontend=True, **cell)
    theirs, jfe = JC.run_load_cell(return_frontend=True, **cell)
    assert ours["ok"], ours["verdict"]
    assert canon(ours) == canon(theirs)
    assert frontend_state(fe) == frontend_state(jfe)


def test_load_cell_under_a_drawn_fault_plan_equals_the_jax_package_s():
    from smi_tpu.parallel import faults as JF
    from smi_tpu.serving import campaign as JC

    ours = run_load_cell(n=4, seed=3, duration=240, overload=1.0,
                         plan=F.FaultPlan.random("slow_consumer", 4, 3))
    theirs = JC.run_load_cell(n=4, seed=3, duration=240, overload=1.0,
                              plan=JF.FaultPlan.random("slow_consumer",
                                                       4, 3))
    assert canon(ours) == canon(theirs)


@pytest.mark.parametrize("kwargs", [
    dict(seed=PINNED_SEED, trials=1, duration=200),
    dict(seed=0, n=5, trials=2),
    dict(seed=3, retune=True),
    dict(seed=2, flash_crowd=True),
], ids=["pinned", "n5-two-trials", "retune", "flash-crowd"])
def test_load_campaign_equals_the_jax_package_s(kwargs):
    from smi_tpu.serving import campaign as JC

    ours = load_campaign(**kwargs)
    assert ours["ok"], ours["failures"]
    assert canon(ours) == canon(JC.load_campaign(**kwargs))


@pytest.mark.parametrize("seed", range(4))
def test_serve_selftest_equals_the_jax_package_s(seed):
    from smi_tpu.serving import campaign as JC

    ours, fe = serve_selftest(seed=seed, return_frontend=True)
    theirs, jfe = JC.serve_selftest(seed=seed, return_frontend=True)
    assert canon(ours) == canon(theirs)
    assert frontend_state(fe) == frontend_state(jfe)


@pytest.mark.parametrize("seed", [0, 1])
def test_bench_fields_equal_the_jax_package_s(seed):
    from smi_tpu.serving import campaign as JC

    assert canon(bench_fields(seed=seed)) == canon(JC.bench_fields(
        seed=seed))


@pytest.mark.parametrize("seed,tenants,duration,rate", [
    (0, 6, 240, 1.0), (1729, 3, 200, 2.5), (5, 9, 64, 0.3)])
def test_open_loop_traffic_equals_the_jax_package_s(seed, tenants,
                                                   duration, rate):
    from smi_tpu.serving import campaign as JC
    from smi_tpu_torch.serving.campaign import open_loop_traffic

    assert open_loop_traffic(seed, tenants, duration, rate) == \
        JC.open_loop_traffic(seed, tenants, duration, rate)


@pytest.mark.parametrize("cell", [
    dict(n=4, seed=0, duration=160),
    dict(n=4, seed=1, duration=160, slices=2),
    dict(n=4, seed=3, duration=240, kill_rank=1),
], ids=["flat", "pod", "kill"])
def test_retune_cell_equals_the_jax_package_s(cell):
    from smi_tpu.serving import campaign as JC
    from smi_tpu_torch.serving.campaign import run_retune_cell

    ours, fe = run_retune_cell(return_frontend=True, **cell)
    theirs, jfe = JC.run_retune_cell(return_frontend=True, **cell)
    assert ours["ok"], ours["verdict"]
    assert canon(ours) == canon(theirs)
    assert frontend_state(fe) == frontend_state(jfe)


@pytest.mark.parametrize("call", [
    lambda m, F: m.run_load_cell(n=4, seed=0, plan=F.FaultPlan.of([
        F.SlowConsumer(0, from_tick=30, stall_ticks=40),
        F.SlowConsumer(1, from_tick=35, stall_ticks=40)])),
    lambda m, F: m.run_load_cell(n=4, seed=0, duration=50, kill_rank=1,
                                 kill_at=60),
    lambda m, F: m.run_load_cell(n=4, seed=0, duration=30, stall_rank=1,
                                 stall_at=40),
    lambda m, F: m.load_campaign(seed=0, duration=m.MIN_CAMPAIGN_DURATION
                                 - 1),
    lambda m, F: m.run_retune_cell(small_kb=64, large_kb=100),
    lambda m, F: m.run_retune_cell(duration=160, kill_rank=0, kill_at=200),
], ids=["two-stalls", "kill-late", "stall-late", "short-campaign",
        "one-bucket", "retune-kill-late"])
def test_refusals_name_the_jax_package_s_texts(call):
    from smi_tpu.parallel import faults as JF
    from smi_tpu.serving import campaign as JC
    from smi_tpu_torch.serving import campaign as SC

    with pytest.raises(ValueError) as ours:
        call(SC, F)
    with pytest.raises(ValueError) as theirs:
        call(JC, JF)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.model
@pytest.mark.parametrize("mutant", (
    "leaked_stream_credit", "skipped_aging", "epoch_bump_without_void",
    "heartbeat_after_confirm", "swap_without_quiesce",
    "rollback_discards_entry"))
def test_counterexample_replay_equals_the_jax_package_s(mutant):
    """The port's model checker convicts the mutant; its trace replays
    through both packages' campaign tiers to the same failing cell, and
    its first action alone to the same clean one."""
    from smi_tpu.serving import campaign as JC
    from smi_tpu_torch import analysis
    from smi_tpu_torch.serving.campaign import replay_model_trace

    from tests.test_torch_model import MODEL_MUTANT_SCOPE

    scope = MODEL_MUTANT_SCOPE[mutant]
    report = analysis.check_scope(
        scope, world_factory=analysis.model_mutant_world(mutant),
        mutant=mutant)
    trace = [list(a) for a in report.findings[0].trace]
    ours = replay_model_trace(scope.to_json(), trace, mutant=mutant)
    assert ours["ok"] is False
    assert canon(ours) == canon(JC.replay_model_trace(
        scope.to_json(), trace, mutant=mutant))
    assert canon(replay_model_trace(scope.to_json(), trace[:1])) == \
        canon(JC.replay_model_trace(scope.to_json(), trace[:1]))


def test_chip_smoke_pins_the_jax_package_s_campaign_digests():
    """``chip_smoke.py`` phase 37 holds each campaign's report on the
    card's host to the digest of the JAX package's report of the same
    call: those pins are the JAX package's, and the port's here."""
    import hashlib
    import importlib.util
    from pathlib import Path

    from smi_tpu.serving import campaign as JC
    from smi_tpu.serving import moe as JM
    from smi_tpu_torch.serving import campaign as SC
    from smi_tpu_torch.serving import moe as SM

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    def digest(report):
        return hashlib.sha256(json.dumps(
            report, sort_keys=True).encode()).hexdigest()

    for name, pinned in chip_smoke.SERVING_CAMPAIGNS.items():
        theirs = getattr(JC, name, None) or getattr(JM, name)
        ours = getattr(SC, name, None) or getattr(SM, name)
        assert digest(theirs(seed=0)) == pinned, name
        assert digest(ours(seed=0)) == pinned, name

