"""The port's self-healing collectives: the reference's cases, and parity.

``smi_tpu_torch/parallel/recovery.py`` is the port's copy of the JAX
package's self-healing loop over the credit simulator: progress logs (the
WAL), shrink / re-route / retry, resume, and the chaos campaigns. The
first part carries over the CPU cases of ``tests/test_recovery.py`` and
``tests/test_chaos.py`` (all but the JAX CLI's) against the port, the
runtime bridge on an 8-rank CPU ``LocalWorld``. The second part runs the
same seeds through both packages with the tolerance "equal": campaign
reports byte-equal as sorted JSON, the minimized plans, every
``RecoveryOutcome``, and progress logs that one package writes and the
other reads.
"""

import dataclasses
import json

import pytest

import smi_tpu_torch as st
from smi_tpu.parallel import credits as JC
from smi_tpu.parallel import faults as JF
from smi_tpu.parallel import recovery as JR
from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.parallel import faults as F
from smi_tpu_torch.parallel import recovery as R
from smi_tpu_torch.parallel.routing import RouteCutError
from smi_tpu_torch.utils.watchdog import WatchdogTimeout

pytestmark = pytest.mark.faults

NS = [2, 3, 4, 5]


# ---------------------------------------------------------------------------
# Verified transport framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("seed", range(4))
def test_framing_transparent_when_healthy(protocol, seed):
    """The framed transport is behaviourally identical to bare
    transport on healthy runs — delivery verified by the harness."""
    F._simulate(protocol, 4, C.Strategy(seed), None, 5, verified=True)


@pytest.mark.parametrize("fault_class", F.INTEGRITY_FAULT_CLASSES)
@pytest.mark.parametrize("protocol", F.PROTOCOLS)
def test_tampering_detected_as_named_integrity_error(fault_class,
                                                     protocol):
    """Every payload-tampering injection must surface as IntegrityError
    naming the receiving rank, source, chunk, and expected vs got —
    never as silent corruption."""
    plan = F.FaultPlan.random(fault_class, 4, 1)
    verdict = F.run_under_faults(protocol, 4, plan, C.Strategy(0))
    assert verdict.detected
    assert verdict.error_name == "IntegrityError"
    e = verdict.error
    assert e.rank is not None and e.src is not None
    assert e.expected is not None and e.got is not None
    assert e.kind in ("checksum", "sequence")
    if fault_class == "reordered_chunks":
        assert e.kind == "sequence"
    else:
        assert e.kind == "checksum"


@pytest.mark.parametrize("fault_class",
                         ["bit_flip_payload", "truncated_dma"])
def test_bare_transport_corrupts_silently(fault_class):
    """WITHOUT framing the same injections complete with wrong data
    (SilentCorruption from the harness's output check) — the framing
    layer's existence proof. Tolerated is also legal: small runs may
    never issue the targeted nth DMA."""
    silent = 0
    for protocol in F.PROTOCOLS:
        for seed in range(3):
            plan = F.FaultPlan.random(fault_class, 4, seed)
            try:
                v = F.run_under_faults(protocol, 4, plan, C.Strategy(0),
                                       verified=False)
                assert v.tolerated, (protocol, seed, v.kind)
            except F.SilentCorruption:
                silent += 1
    assert silent >= len(F.PROTOCOLS)  # the damage is real, and unseen


def test_frame_crc_keys_identity_and_payload():
    f = C.make_frame(2, 7, "payload")
    assert C.frame_crc(2, 7, True, "payload") == f.crc
    assert C.frame_crc(2, 8, True, "payload") != f.crc
    assert C.frame_crc(3, 7, True, "payload") != f.crc
    assert C.frame_crc(2, 7, True, "payloaX") != f.crc


# ---------------------------------------------------------------------------
# Crash-stop recovery (shrink + heir inheritance)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("n", [3, 4, 5])
def test_crash_stop_resumes_identical(protocol, n):
    """A rank crash-stopping mid-collective is shrunk out; the
    survivors resume and end with results identical to the fault-free
    run — the dead rank's contribution recovered from its durable
    log."""
    plan = F.FaultPlan.single(F.StalledRank(1, after=6))
    out = R.run_with_recovery(protocol, n, plan, strategy_seed=0)
    assert out.ok
    assert out.survivors == tuple(r for r in range(n) if r != 1)
    assert out.attempts[0].verdict == "DeadlockError"
    assert 1 in out.attempts[0].failed_ranks
    assert out.attempts[-1].verdict in ("completed", "resumed-from-log")
    # identical-to-fault-free is checked per survivor, exactly
    for g in out.survivors:
        assert out.results[g] == out.expected[g]


@pytest.mark.parametrize("protocol", R.ITEM_PROTOCOLS)
def test_resume_replays_only_undelivered(protocol):
    """A late crash leaves most chunks delivered: the delivery
    protocols' resume pass must move strictly less than the full
    volume (only the union of missing items)."""
    plan = F.FaultPlan.single(F.StalledRank(2, after=20))
    out = R.run_with_recovery(protocol, 5, plan, strategy_seed=0,
                              chunks=6)
    assert out.ok
    total = sum(len(out.expected[g]) for g in out.survivors)
    assert 0 < out.replayed_chunks < total, (
        out.replayed_chunks, total
    )


@pytest.mark.parametrize("protocol", R.REDUCE_PROTOCOLS)
def test_reduce_resume_restarts_from_logged_inputs(protocol):
    """Reduction protocols never reuse partial state (a non-idempotent
    combine would double-count): the resume re-folds the durably
    logged INPUTS — at most one contribution per surviving executor
    moves again."""
    plan = F.FaultPlan.single(F.StalledRank(2, after=20))
    out = R.run_with_recovery(protocol, 5, plan, strategy_seed=0,
                              chunks=6)
    assert out.ok
    assert 0 < out.replayed_chunks <= len(out.survivors)


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
def test_resume_after_last_chunk_replays_nothing(protocol):
    """Satellite edge case: when the fault strikes after every chunk
    was delivered (a rank dies parked at its final waits), the resume
    finds complete logs and replays NOTHING — no second network
    pass."""
    hit = None
    for after in range(8, 120):
        plan = F.FaultPlan.single(F.StalledRank(1, after=after))
        try:
            out = R.run_with_recovery(protocol, 3, plan,
                                      strategy_seed=0, chunks=3)
        except R.UnrecoverableError:
            continue
        if (len(out.attempts) > 1
                and out.attempts[-1].verdict == "resumed-from-log"):
            hit = out
            break
    assert hit is not None, "no stall point with complete logs found"
    assert hit.ok
    assert hit.replayed_chunks == 0


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
def test_double_fault_during_replay(protocol):
    """Satellite edge case: a second crash-stop during the resume pass
    shrinks again and still completes identically."""
    out = R.run_with_recovery(
        protocol, 5, F.FaultPlan.single(F.StalledRank(1, after=4)),
        strategy_seed=3,
        followup_plans=[F.FaultPlan.single(F.StalledRank(2, after=3))],
    )
    assert out.ok
    assert len(out.attempts) == 3
    assert len(out.survivors) == 3
    trail = out.fault_trail
    assert trail[0] == "DeadlockError" and trail[1] == "DeadlockError"


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
def test_shrink_to_single_survivor(protocol):
    """Satellite edge case: n=2 with the peer dead shrinks to ONE rank,
    which assembles the full result locally from the durable WALs."""
    out = R.run_with_recovery(
        protocol, 2, F.FaultPlan.single(F.StalledRank(1, after=2)),
        strategy_seed=0, chunks=3,
    )
    assert out.ok
    assert out.survivors == (0,)
    assert out.results[0] == out.expected[0]


def test_every_rank_dead_is_named_annihilation():
    plan = F.FaultPlan.of(
        [F.StalledRank(0, after=5), F.StalledRank(1, after=5)]
    )
    with pytest.raises(R.UnrecoverableError) as e:
        R.run_with_recovery("all_gather", 2, plan, strategy_seed=0)
    assert e.value.annihilated


# ---------------------------------------------------------------------------
# Down-link recovery (re-route via FailureSet, shrink when impossible)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("n", [4, 5, 6])
def test_down_link_reroutes_keeping_all_ranks(protocol, n):
    """With n >= 4 a dead wire is re-routed: the logical ring re-forms
    with the endpoints non-adjacent, EVERY rank survives, and the dead
    wire stays enforced in the resumed run (a buggy re-route would
    deadlock, not silently transit it)."""
    plan = F.FaultPlan.single(F.DownLink(0, 1))
    out = R.run_with_recovery(protocol, n, plan, strategy_seed=1)
    assert out.ok
    assert out.survivors == tuple(range(n))
    ring = out.attempts[-1].ring
    pos = {g: i for i, g in enumerate(ring)}
    gap = abs(pos[0] - pos[1])
    assert gap not in (1, len(ring) - 1), f"0 and 1 adjacent in {ring}"


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
def test_down_link_small_ring_shrinks_endpoint(protocol):
    """A 3-ring cannot separate two ranks; the higher endpoint is
    shrunk (deterministically) and the pair's data is still complete
    at the survivors."""
    plan = F.FaultPlan.single(F.DownLink(0, 1))
    out = R.run_with_recovery(protocol, 3, plan, strategy_seed=1)
    assert out.ok
    assert out.survivors == (0, 2)


def test_separating_order_properties():
    assert R._separating_order([0, 1, 2, 3], set()) == [0, 1, 2, 3]
    order = R._separating_order([0, 1, 2, 3], {(0, 1)})
    pos = {g: i for i, g in enumerate(order)}
    assert abs(pos[0] - pos[1]) not in (1, 3)
    assert R._separating_order([0, 1], {(0, 1)}) is None
    assert R._separating_order([0, 1, 2], {(0, 1)}) is None


def test_cut_routability_check_uses_failure_set():
    """The re-route step validates against the routing layer's
    FailureSet machinery: a single ring-wire cut on a torus of n >= 3
    leaves every surviving pair routable the long way around (no
    raise); the same machinery raises RouteCutError when a failure
    set genuinely isolates a destination (the routing property tests
    cover that shape — here we pin the recovery-side call)."""
    for n in (3, 4, 5, 6):
        R._check_cut_routable(n, (0, 1), list(range(n)))
        R._check_cut_routable(n, (n - 1, 0), list(range(n)))  # wrap wire
    # non-ring-wire pairs (no physical wire to cut) are a no-op
    R._check_cut_routable(5, (0, 2), [0, 1, 2, 3, 4])
    # the named-isolation path: every wire of one device cut
    from smi_tpu_torch.parallel.routing import (
        FailureSet, build_routing_context, check_all_pairs_routable,
        grid_topology,
    )

    topo = grid_topology(1, 4)
    victim = topo.devices[1]
    cut = FailureSet(links=frozenset(
        (dev, li) for (dev, li) in topo.connections if dev == victim
    ))
    ctx = build_routing_context(topo, excluded=cut)
    with pytest.raises(RouteCutError):
        check_all_pairs_routable(ctx, topo.devices)


# ---------------------------------------------------------------------------
# Transient faults: retry-with-replay, full ring preserved
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", [
    F.BitFlipPayload(1, nth=0),
    F.TruncatedDma(2, nth=1),
    F.ReorderedChunks(0, nth=0),
    F.DroppedGrant(0, nth=0),
])
@pytest.mark.parametrize("protocol", F.PROTOCOLS)
def test_transient_fault_retries_whole_ring(protocol, fault):
    out = R.run_with_recovery(
        protocol, 4, F.FaultPlan.single(fault), strategy_seed=2,
    )
    assert out.ok
    assert out.survivors == (0, 1, 2, 3)


# ---------------------------------------------------------------------------
# Progress logs
# ---------------------------------------------------------------------------


def test_progress_log_idempotent_and_sequenced():
    log = R.ProgressLog(0, contribution="mine")
    assert log.record("a", 1) and log.seq == 1
    assert not log.record("a", 2)  # replayed delivery dropped
    assert log.entries["a"] == 1 and log.seq == 1
    assert log.missing({"a", "b"}) == {"b"}


def test_expected_results_match_simulator_delivery():
    """The analytic fault-free yardstick agrees with what the real
    protocols deliver — per protocol and rank count."""
    for protocol in F.PROTOCOLS:
        for n in (2, 4):
            chunks = 3
            inputs = R.canonical_inputs(protocol, n, chunks)
            expected = R.expected_results(protocol, n, inputs, chunks)
            out = R.run_with_recovery(protocol, n, None,
                                      strategy_seed=0, chunks=chunks)
            assert len(out.attempts) == 1
            for g in range(n):
                assert out.results[g] == expected[g], (protocol, n, g)


# ---------------------------------------------------------------------------
# Runtime bridge: shrink a live communicator from a caught error
# ---------------------------------------------------------------------------


def test_failed_ranks_of_maps_ring_local_to_global():
    state = {0: {"state": "blocked"}, 1: {"state": "stalled"},
             2: {"state": "finished"}}
    err = C.DeadlockError("dead", state=state)
    assert R.failed_ranks_of(err) == {1}
    assert R.failed_ranks_of(err, survivors=[0, 3, 4]) == {3}
    assert R.failed_ranks_of(ValueError("no dump")) == set()


@pytest.fixture(scope="module")
def world8():
    return st.LocalWorld(8, device="cpu")


def test_heirs_mapping(world8):
    comm = world8.comms[0]
    assert comm.heirs({2, 3}) == {2: 4, 3: 4}
    assert comm.heirs({7}) == {7: 0}
    assert comm.heirs({6, 7, 0}) == {6: 1, 7: 1, 0: 1}
    with pytest.raises(ValueError, match="no survivors"):
        comm.heirs(range(8))
    with pytest.raises(ValueError, match="out of range"):
        comm.heirs({9})


def test_recover_communicator_from_deadlock_error(world8):
    with pytest.raises(C.DeadlockError) as e:
        C.simulate_all_reduce(
            8, C.Strategy(0),
            faults=F.FaultPlan.single(F.StalledRank(5, after=3)),
        )
    small, heirs = st.recover_communicator(world8.comms[0], e.value)
    assert small.size == 7
    assert heirs == {5: 6}
    assert list(small.world.parent_ranks) == [0, 1, 2, 3, 4, 6, 7]


def test_recover_communicator_from_watchdog_timeout(world8):
    # a runtime watchdog timeout whose structured dump names rank 3
    state = {3: {"state": "stalled", "pending": None, "outputs": 0},
             0: {"state": "blocked", "pending": None, "outputs": 1}}
    err = WatchdogTimeout("hang", state=state)
    small, heirs = st.recover_communicator(world8.comms[0], err)
    assert small.size == 7 and heirs == {3: 4}
    # a transient failure (no ranks named) must NOT be shrunk
    with pytest.raises(ValueError, match="retry"):
        st.recover_communicator(world8.comms[0], WatchdogTimeout("hang"))


# ---------------------------------------------------------------------------
# The chaos soak (tests/test_chaos.py)
# ---------------------------------------------------------------------------

#: The tier-1 campaign's pinned seed. Do not bump casually: the whole
#: report is deterministic per seed, so a red run reproduces exactly
#: with ``python -m smi_tpu chaos --seed 1729``.
TIER1_SEED = 1729


def _assert_campaign_clean(report):
    assert report["silent_corruptions"] == 0, report["failures"]
    assert report["ok"], report["failures"]
    assert not report["failures"]
    healed = report["outcomes"].get("healed", 0)
    tolerated = report["outcomes"].get("tolerated", 0)
    annihilated = report["outcomes"].get("annihilated", 0)
    assert healed + tolerated + annihilated == report["cells"]
    assert healed > 0  # the campaign actually exercised recovery


@pytest.mark.chaos
def test_tier1_seed_pinned_campaign():
    """The default-test-run campaign: all four protocols, rings of
    2..5, two trials each, up to two faults per plan."""
    report = R.chaos_campaign(seed=TIER1_SEED, ns=(2, 3, 4, 5),
                              trials=2, max_faults=2)
    _assert_campaign_clean(report)
    assert report["cells"] == 4 * 4 * 2


@pytest.mark.chaos
def test_campaign_deterministic_per_seed():
    a = R.chaos_campaign(seed=5, ns=(3, 4), trials=2)
    b = R.chaos_campaign(seed=5, ns=(3, 4), trials=2)
    assert a == b
    c = R.chaos_campaign(seed=6, ns=(3, 4), trials=2)
    assert c != a  # different seed, different plans


@pytest.mark.chaos
def test_campaign_report_is_json_roundtrippable():
    report = R.chaos_campaign(seed=2, ns=(3,), trials=1)
    assert json.loads(json.dumps(report)) == report


@pytest.mark.chaos
def test_random_chaos_plan_seeded_and_bounded():
    a = R.random_chaos_plan(4, 99, max_faults=3)
    assert a == R.random_chaos_plan(4, 99, max_faults=3)
    described = a.describe()
    assert described and all(isinstance(s, str) for s in described)
    # every draw is a single fault, so max_faults bounds the plan
    # (DownLink dedup can only shrink it)
    for seed in range(40):
        for max_faults in (1, 2, 3):
            plan = R.random_chaos_plan(5, seed, max_faults=max_faults)
            assert 1 <= len(plan.faults()) <= max_faults, (
                seed, max_faults, plan.describe()
            )


@pytest.mark.chaos
def test_minimizer_shrinks_to_necessary_faults():
    """ddmin against a synthetic predicate: only the DownLink matters,
    so the minimal plan is exactly it."""
    plan = F.FaultPlan.of([
        F.DroppedGrant(0), F.DownLink(1, 2), F.BitFlipPayload(3),
        F.StalledRank(2, after=9),
    ])
    minimal = R.minimize_plan(
        plan,
        lambda p: any(isinstance(f, F.DownLink) for f in p.faults()),
    )
    assert minimal.faults() == (F.DownLink(1, 2),)


@pytest.mark.chaos
def test_minimizer_keeps_conjunction():
    """A failure needing BOTH faults keeps both (1-minimality, not
    emptiness)."""
    plan = F.FaultPlan.of([
        F.DroppedGrant(0), F.StalledRank(1), F.StalledRank(2),
    ])

    def needs_both_stalls(p):
        stalls = [f for f in p.faults() if isinstance(f, F.StalledRank)]
        return len(stalls) >= 2

    minimal = R.minimize_plan(plan, needs_both_stalls)
    assert len(minimal.faults()) == 2
    assert all(isinstance(f, F.StalledRank) for f in minimal.faults())


@pytest.mark.chaos
@pytest.mark.slow
def test_long_soak():
    """The overnight-shaped soak: bigger rings, more trials, triple
    faults — still zero silent corruptions, every cell named."""
    for seed in range(4):
        report = R.chaos_campaign(seed=seed, ns=(2, 3, 4, 5, 6, 7),
                                  trials=6, max_faults=3)
        _assert_campaign_clean(report)


# ---------------------------------------------------------------------------
# Parity with the JAX package: the same seed, the same report
# ---------------------------------------------------------------------------


def plain(value):
    """An outcome with each package's dataclasses as (class name,
    fields), so two packages' answers compare field by field."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,
                {f.name: plain(getattr(value, f.name))
                 for f in dataclasses.fields(value)})
    if isinstance(value, dict):
        return {plain(k): plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(plain(v) for v in value)
    return value


def sorted_json(report):
    return json.dumps(report, sort_keys=True)


@pytest.mark.chaos
@pytest.mark.parametrize("kwargs", [
    dict(seed=1729, ns=(2, 3, 4, 5), trials=2, max_faults=2),
    dict(seed=5, ns=(3, 4), trials=2),
    dict(seed=2, ns=(3,), trials=1),
    dict(seed=11, ns=(2, 3), trials=1, max_faults=3, chunks=3),
], ids=lambda k: f"seed{k['seed']}")
def test_chaos_campaign_reports_are_byte_equal(kwargs):
    port = sorted_json(R.chaos_campaign(**kwargs))
    assert port == sorted_json(JR.chaos_campaign(**kwargs))


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_recovery_outcomes_match_jax(protocol, n):
    """Every attempt of every seeded chaos cell: the rings, verdicts,
    details, replay counts and results of the JAX package's run."""
    for seed in range(3):
        got = []
        for mod_r in (R, JR):
            plan = mod_r.random_chaos_plan(n, seed, max_faults=2)
            try:
                out = mod_r.run_with_recovery(protocol, n, plan,
                                              strategy_seed=seed, chunks=4)
                got.append((repr(plan), plain(out), out.ok))
            except Exception as e:  # the refusal must read the same
                got.append((repr(plan), type(e).__name__, str(e),
                            plain(getattr(e, "attempts", None))))
        assert got[0] == got[1]


def test_minimized_plans_match_jax():
    def plan_of(mod_f):
        return mod_f.FaultPlan.of([
            mod_f.DroppedGrant(0), mod_f.DownLink(1, 2),
            mod_f.BitFlipPayload(3), mod_f.StalledRank(2, after=9),
            mod_f.DelayedDma(1),
        ])

    for mod_f, mod_c, mod_r in ((F, C, R), (JF, JC, JR)):
        detected = mod_r.minimize_plan(
            plan_of(mod_f),
            lambda p: mod_f.run_under_faults(
                "all_reduce", 4, p, mod_c.Strategy(0)).detected)
        down = mod_r.minimize_plan(
            plan_of(mod_f),
            lambda p: any(isinstance(f, mod_f.DownLink)
                          for f in p.faults()))
        if mod_r is R:
            port = (detected.describe(), down.describe())
        else:
            assert port == (detected.describe(), down.describe())
    assert port[1] == ["DownLink(a=1, b=2)"]
    assert 1 <= len(port[0]) < 5


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("n", [2, 3, 5])
def test_cells_and_canonical_data_match_jax(protocol, n):
    inputs = R.canonical_inputs(protocol, n, 4)
    assert inputs == JR.canonical_inputs(protocol, n, 4)
    assert R.expected_results(protocol, n, inputs, 4) == \
        JR.expected_results(protocol, n, inputs, 4)
    for seed in range(4):
        plans = [m.random_chaos_plan(n, seed, max_faults=3) for m in (R, JR)]
        assert repr(plans[0]) == repr(plans[1])
        assert R.cell_fails(protocol, n, plans[0], seed) == \
            JR.cell_fails(protocol, n, plans[1], seed)


def test_progress_logs_cross_between_packages(tmp_path):
    """A WAL one package writes, the other reads — and the two write the
    same bytes for the same log."""
    logs = []
    for mod_r in (R, JR):
        log = mod_r.ProgressLog(3, contribution=frozenset({3}))
        for key, payload in ((0, "a"), (2, frozenset({1, 2})), (0, "dup")):
            log.record(key, payload)
        logs.append(log)
    port_path = logs[0].save(str(tmp_path / "port.wal"))
    jax_path = logs[1].save(str(tmp_path / "jax.wal"))
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    for mod_r, path in ((JR, port_path), (R, jax_path)):
        back = mod_r.ProgressLog.load(path)
        assert (back.rank, back.contribution, back.entries) == (
            3, frozenset({3}), {0: "a", 2: frozenset({1, 2})})


def test_a_torn_wal_is_refused_alike(tmp_path):
    log = R.ProgressLog(1, contribution="c")
    log.record(0, "x")
    log.record(1, "y")
    path = log.save(str(tmp_path / "r1.wal"))
    text = open(path).read().split("\n")
    # damage before the tail: refused, with the same text
    bad = tmp_path / "mid.wal"
    bad.write_text("\n".join([text[0], text[1][:-3] + "AAA"] + text[2:]))
    errors = []
    for mod_r in (R, JR):
        with pytest.raises(mod_r.WalCorruptionError) as e:
            mod_r.ProgressLog.load(str(bad))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    # a torn final record: dropped loudly, alike
    torn = tmp_path / "tail.wal"
    torn.write_text("\n".join(text[:-2] + [text[-2][:10]]) + "\n")
    for mod_r in (R, JR):
        with pytest.warns(RuntimeWarning, match="final record is torn"):
            back = mod_r.ProgressLog.load(str(torn))
        assert back.torn_records == 1 and back.entries == {0: "x"}
