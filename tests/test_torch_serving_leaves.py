"""The port's serving leaves: the reference's cases, and parity.

``smi_tpu_torch/serving/`` holds, so far, the port's copies of the JAX
package's three serving leaves (pure Python, on a step clock): the QoS
classes and the request record (``qos.py``), the per-tenant token bucket
and the multi-class admission gate (``admission.py``), and the
credit-aware stream scheduler with its wire lanes (``scheduler.py``).
The first part carries over the cases of ``tests/test_serving.py`` that
exercise those leaves alone (the front end and the campaigns come with
a later slice). The second drives both packages' leaves through the same
seeded request stream (a small front end written here: offers, pumps,
scheduling, landing, verification, releases) and holds every decision
equal: admissions with their waits, sheds with their reasons, each sent
chunk's stream and lane, completions, the flight-recorder snapshot and
the metrics snapshot.
"""

import json
import random

import pytest

from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.parallel.recovery import ProgressLog
from smi_tpu_torch.serving import admission as A
from smi_tpu_torch.serving import qos as Q
from smi_tpu_torch.serving import scheduler as S
from smi_tpu_torch.utils.watchdog import WatchdogTimeout

pytestmark = pytest.mark.serving


# ---------------------------------------------------------------------------
# Token bucket + admission gate policy
# ---------------------------------------------------------------------------


def _req(tenant="t0", qos="interactive", chunks=("a", "b"), at=0):
    return Q.Request(tenant=tenant, qos=qos, chunks=tuple(chunks),
                     arrived_at=at)


def test_token_bucket_rate_and_burst():
    b = A.TokenBucket(rate_per_tick=0.5, burst=2.0)
    assert b.try_take(0) and b.try_take(0)      # the burst
    assert not b.try_take(0)                    # drained
    assert not b.try_take(1)                    # 0.5 tokens: not enough
    assert b.try_take(2)                        # refilled to 1.0
    # deterministic: same call sequence, same outcomes
    b2 = A.TokenBucket(0.5, 2.0)
    assert [b2.try_take(t) for t in (0, 0, 0, 1, 2)] == [
        True, True, False, False, True,
    ]


def test_gate_admits_within_pool_and_ceilings():
    gate = A.AdmissionGate(pool=4, tenant_rate=10, tenant_burst=100)
    # best_effort ceiling = ceil(0.5*4) = 2 slots
    assert gate.offer(_req("t0", "best_effort"), 0)
    assert gate.offer(_req("t1", "best_effort"), 0)
    assert not gate.offer(_req("t2", "best_effort"), 0)  # parked
    # batch ceiling = 3: one more admission
    assert gate.offer(_req("t3", "batch"), 0)
    assert not gate.offer(_req("t4", "batch"), 0)        # parked
    # interactive rides to the full pool
    assert gate.offer(_req("t5", "interactive"), 0)
    assert gate.occupancy() == 4
    # pool exhausted: even interactive parks now
    assert not gate.offer(_req("t6", "interactive"), 0)
    gate.assert_bounded()


def test_gate_brownout_is_lowest_class_first_and_named():
    gate = A.AdmissionGate(pool=2, tenant_rate=10, tenant_burst=100)
    assert gate.offer(_req("t0", "interactive"), 0)
    assert gate.offer(_req("t1", "interactive"), 0)
    # fill best_effort's pending tier (bound == pool == 2)
    assert not gate.offer(_req("t2", "best_effort"), 0)
    assert not gate.offer(_req("t3", "best_effort"), 0)
    # sustained brownout: the next one sheds immediately, named
    with pytest.raises(Q.AdmissionRejected) as e:
        gate.offer(_req("t4", "best_effort"), 0)
    assert e.value.reason == "brownout:best_effort"
    assert e.value.tenant == "t4"
    assert e.value.qos == "best_effort"
    assert e.value.queue_depth == 4
    assert gate.shed["best_effort"]["brownout:best_effort"] == 1


def test_gate_tenant_rate_is_isolated_and_class_blind():
    gate = A.AdmissionGate(pool=100, tenant_rate=0.1, tenant_burst=1)
    assert gate.offer(_req("hot", "interactive"), 0)
    with pytest.raises(Q.AdmissionRejected) as e:
        gate.offer(_req("hot", "interactive"), 0)
    assert e.value.reason == "tenant-rate"
    # a different tenant is unaffected
    assert gate.offer(_req("cold", "best_effort"), 0)


def test_gate_pending_admits_by_class_priority_on_release():
    gate = A.AdmissionGate(pool=2, tenant_rate=10, tenant_burst=100)
    assert gate.offer(_req("t0", "interactive"), 0)
    assert gate.offer(_req("t1", "interactive"), 0)
    # park one of each lower class, batch FIRST in arrival order
    assert not gate.offer(_req("t2", "best_effort", at=1), 1)
    assert not gate.offer(_req("t3", "batch", at=1), 1)
    assert not gate.offer(_req("t4", "interactive", at=1), 1)
    # one credit frees: the interactive waiter wins despite arriving
    # last
    admitted = gate.release("interactive", 2)
    assert [r.qos for r in admitted] == ["interactive"]
    waits = gate.admission_waits["interactive"]
    assert waits[-1] == 1  # parked at 1, admitted at 2


def test_gate_admission_timeout_sheds_named_after_cap():
    gate = A.AdmissionGate(pool=1, tenant_rate=10, tenant_burst=100)
    assert gate.offer(_req("t0", "interactive"), 0)
    assert not gate.offer(_req("t1", "interactive"), 0)
    cap = Q.CLASS_ADMISSION_WAIT_TICKS["interactive"]
    gate.pump(cap)          # still waiting, inside the cap
    assert len(gate.pending["interactive"]) == 1
    gate.pump(cap + 1)      # one past: shed, named
    assert not gate.pending["interactive"]
    assert gate.shed["interactive"]["admission-timeout"] == 1
    rejection = gate.rejections[-1]
    assert rejection.reason == "admission-timeout"
    assert rejection.tenant == "t1"


def test_gate_occupancy_bound_is_asserted():
    gate = A.AdmissionGate(pool=2, tenant_rate=10, tenant_burst=100)
    gate.held["interactive"] = 3  # corrupt the invariant by hand
    with pytest.raises(AssertionError):
        gate.assert_bounded()
    with pytest.raises(AssertionError):
        A.AdmissionGate(pool=2).release("batch", 0)  # never held


# ---------------------------------------------------------------------------
# Scheduler: class priority, aging bound, wire credits
# ---------------------------------------------------------------------------


def _stream(index, qos, dst=0, chunks=("x",) * 8, clock=None):
    from smi_tpu_torch.utils.watchdog import Deadline

    req = Q.Request(tenant=f"t{index}", qos=qos, chunks=tuple(chunks),
                    arrived_at=0, stream_id=(f"t{index}", 0))
    return S.StreamState(
        request=req, index=index, dst=dst,
        deadline=Deadline(None if clock is None else 10_000,
                          clock=clock or (lambda: 0.0)),
        wal=ProgressLog(rank=index),
    )


def test_scheduler_strict_priority_then_admission_order():
    lane = S.WireLane(0)
    streams = [
        _stream(0, "best_effort"),
        _stream(1, "interactive"),
        _stream(2, "batch"),
    ]
    sched = S.StreamScheduler(check_deadlines=False)
    sent = sched.schedule_lane(lane, streams, now=0)
    assert sent == S.WIRE_CREDITS
    order = [item.stream.index for item in lane.in_flight]
    # interactive drains first (4 credits: 4 of its chunks)
    assert order == [1, 1, 1, 1]


def test_scheduler_aging_bound_prevents_starvation():
    lane = S.WireLane(0)
    starving = _stream(0, "best_effort")
    streams = [starving, _stream(1, "interactive", chunks=("x",) * 64)]
    sched = S.StreamScheduler(check_deadlines=False)
    sends = []
    for tick in range(40):
        sched.schedule_lane(lane, streams, now=tick)
        while lane.in_flight:
            item = lane.in_flight.popleft()
            lane.credits += 1
            sends.append(item.stream.index)
    # the best_effort stream is served within the aging bound: its
    # first chunk is sent after at most MAX_STARVE_ROUNDS decisions
    first = sends.index(0)
    assert first <= S.MAX_STARVE_ROUNDS + 1
    assert starving.next_to_send > 0


def test_wire_lane_credits_exhaust_without_consumption():
    lane = S.WireLane(0)
    st = _stream(0, "interactive", chunks=("x",) * 10)
    sched = S.StreamScheduler(check_deadlines=False)
    assert sched.schedule_lane(lane, [st], now=0) == S.WIRE_CREDITS
    # no consumption -> no credits -> no further sends (backpressure)
    assert sched.schedule_lane(lane, [st], now=1) == 0
    assert not lane.can_send()


def test_deadline_propagates_to_per_chunk_checks_with_state():
    now = {"t": 0.0}
    from smi_tpu_torch.utils.watchdog import Deadline

    st = _stream(0, "interactive")
    st.deadline = Deadline(5.0, clock=lambda: now["t"])
    lane = S.WireLane(0)
    sched = S.StreamScheduler()
    now["t"] = 6.0  # budget spent before the first chunk moves
    provider = lambda: ("stream 0 parked at chunk 0", {"stream": 0})
    with pytest.raises(WatchdogTimeout) as e:
        sched.schedule_lane(lane, [st], now=6, state_provider=provider)
    msg = str(e.value)
    assert "chunk 0/8" in msg and "interactive" in msg
    assert e.value.state == {"stream": 0}  # the serving mirror rides


def test_verify_chunk_catches_crc_and_sequence_damage():
    lane = S.WireLane(0)
    st = _stream(7, "batch")
    sched = S.StreamScheduler(check_deadlines=False)
    sched.schedule_lane(lane, [st], now=0)
    lane.land(1)
    item = lane.landed.popleft()
    # CRC damage: a flipped payload with the sender's CRC
    bad = C.Frame(item.frame.src, item.frame.seq, True,
                  "corrupted!", item.frame.crc)
    import dataclasses as _dc

    with pytest.raises(C.IntegrityError) as e:
        S.verify_chunk(lane, _dc.replace(item, frame=bad))
    assert e.value.kind == "checksum"
    # healthy frame passes, advancing the lane; a stale re-send of
    # seq 0 is then an out-of-sequence error
    assert S.verify_chunk(lane, item) == "x"
    with pytest.raises(C.IntegrityError) as e:
        S.verify_chunk(lane, item)
    assert e.value.kind == "sequence"


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Parity with the JAX package: one seeded request stream, every decision
# ---------------------------------------------------------------------------


def _packages(which):
    """The leaves, the recorder, metrics, recovery and watchdog of one
    package."""
    if which == "jax":
        from smi_tpu.obs import events as E
        from smi_tpu.obs import metrics as M
        from smi_tpu.parallel import recovery as R
        from smi_tpu.serving import admission as AD
        from smi_tpu.serving import qos as QO
        from smi_tpu.serving import scheduler as SC
        from smi_tpu.utils import watchdog as W
    else:
        from smi_tpu_torch.obs import events as E
        from smi_tpu_torch.obs import metrics as M
        from smi_tpu_torch.parallel import recovery as R
        from smi_tpu_torch.serving import admission as AD
        from smi_tpu_torch.serving import qos as QO
        from smi_tpu_torch.serving import scheduler as SC
        from smi_tpu_torch.utils import watchdog as W
    return E, M, R, AD, QO, SC, W


def _drive(which, seed, ranks=3, ticks=160, pool=6, load=1.2):
    """A small front end over one package's leaves: a seeded open-loop
    stream of requests offered at the gate, pumped, routed to a rank by
    tenant, scheduled onto that rank's wire lane, landed, verified and
    consumed ``CONSUME_RATE`` a tick, with the stream credit released on
    its last chunk. Returns the decision log and both snapshots."""
    E, M, R, AD, QO, SC, W = _packages(which)
    rng = random.Random(seed)
    recorder = E.FlightRecorder(capacity=100_000)
    metrics = M.MetricsRegistry()
    gate = AD.AdmissionGate(pool=pool, tenant_rate=0.3, tenant_burst=3.0,
                            recorder=recorder, metrics=metrics)
    sched = SC.StreamScheduler()
    lanes = [SC.WireLane(r) for r in range(ranks)]
    streams, log, seq = [], [], {}

    def start(request, now):
        index = len(streams)
        streams.append(SC.StreamState(
            request=request, index=index,
            dst=int(request.tenant[1:]) % ranks,
            deadline=W.Deadline(None), wal=R.ProgressLog(rank=index),
            admitted_at=now))

    for now in range(ticks):
        for _ in range(rng.randrange(3) if rng.random() < load / 2 else 0):
            tenant = f"t{rng.randrange(5)}"
            seq[tenant] = seq.get(tenant, -1) + 1
            request = QO.Request(
                tenant=tenant, qos=rng.choice(QO.QOS_CLASSES),
                chunks=tuple(f"{tenant}.{seq[tenant]}.{i}"
                             for i in range(rng.randrange(1, 6))),
                arrived_at=now, stream_id=(tenant, seq[tenant]))
            try:
                if gate.offer(request, now):
                    log.append(("admit", now, request.stream_id, 0))
                    start(request, now)
                else:
                    log.append(("park", now, request.stream_id))
            except QO.AdmissionRejected as e:
                log.append(("shed", now, request.stream_id, e.reason,
                            e.queue_depth))
        for request in gate.pump(now):
            log.append(("admit", now, request.stream_id,
                        now - request.arrived_at))
            start(request, now)
        active = [s for s in streams if s.completed_at is None]
        for lane in lanes:
            sent = sched.schedule_lane(lane, active, now)
            lane.land(now)
            for _ in range(min(SC.CONSUME_RATE, len(lane.landed))):
                item = lane.landed.popleft()
                payload = SC.verify_chunk(lane, item, recorder=recorder)
                lane.credits += 1
                st = item.stream
                st.delivered[item.seq] = payload
                log.append(("consume", now, st.request.stream_id,
                            item.seq, lane.rank, payload))
                if st.complete and st.completed_at is None:
                    st.completed_at = now
                    log.append(("complete", now, st.request.stream_id))
                    for request in gate.release(st.request.qos, now):
                        log.append(("admit", now, request.stream_id,
                                    now - request.arrived_at))
                        start(request, now)
            log.append(("lane", now, lane.rank, sent, lane.credits))
    log.append(("shed_total", {q: gate.shed_total(q)
                               for q in QO.QOS_CLASSES}))
    log.append(("admitted", dict(gate.admitted)))
    log.append(("max_queue_depth", gate.max_queue_depth))
    return log, recorder.snapshot(), metrics.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 7, 23])
@pytest.mark.parametrize("load", [0.6, 2.0], ids=["light", "overload"])
def test_leaves_decide_as_the_jax_package_s_on_a_seeded_stream(seed, load):
    ours = _drive("port", seed, load=load)
    theirs = _drive("jax", seed, load=load)
    assert ours[0] == theirs[0]
    assert json.dumps(ours[1], sort_keys=True) == \
        json.dumps(theirs[1], sort_keys=True)
    assert json.dumps(ours[2], sort_keys=True) == \
        json.dumps(theirs[2], sort_keys=True)
    kinds = {entry[0] for entry in ours[0]}
    assert {"admit", "consume", "complete"} <= kinds
    if load > 1:
        assert "shed" in kinds


@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_decisions_equal_the_jax_package_s(seed):
    from smi_tpu.serving import admission as JA

    rng = random.Random(seed)
    rate, burst = rng.choice((0.1, 0.25, 0.5, 1.5)), rng.choice((1, 2, 6))
    ours, theirs = A.TokenBucket(rate, burst), JA.TokenBucket(rate, burst)
    now = 0
    for _ in range(300):
        now += rng.randrange(3)
        assert ours.try_take(now) == theirs.try_take(now)
        assert ours.tokens == theirs.tokens


def test_qos_tables_are_the_jax_package_s():
    from smi_tpu.serving import qos as JQ
    from smi_tpu.serving import scheduler as JS

    for name in ("QOS_CLASSES", "CLASS_PRIORITY", "CLASS_POOL_CEILING",
                 "CLASS_ADMISSION_WAIT_TICKS", "CLASS_DEADLINE_TICKS",
                 "INTERACTIVE_P99_TICKS"):
        assert getattr(Q, name) == getattr(JQ, name), name
    for name in ("WIRE_CREDITS", "TRANSIT_TICKS", "CONSUME_RATE",
                 "MAX_STARVE_ROUNDS"):
        assert getattr(S, name) == getattr(JS, name), name
    samples = [random.Random(3).randrange(100) for _ in range(50)]
    for q in (0.5, 0.9, 0.99, 1.0):
        assert Q.percentile(samples, q) == JQ.percentile(samples, q)
