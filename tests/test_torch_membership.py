"""The port's elastic membership: the reference's cases, and parity.

``smi_tpu_torch/parallel/membership.py`` is the port's copy of the JAX
package's membership layer: the phi-accrual detector on a step clock,
epoch-numbered views with quorum fencing, ring and pod re-planning, and
the elastic and pod soaks (host tools: pure Python, numpy float64 for
the soak's Jacobi data plane, shards through the port's
``CheckpointStore``). The first part carries over the CPU cases of
``tests/test_membership.py`` and ``tests/test_elastic.py`` (all but the
JAX CLI's, ``bench.py``'s and the JAX communicator's, whose port
counterparts ``tests/test_torch_elastic.py`` holds), with the pod soak
of ``tests/test_multislice.py`` and the quorum and partition-fault cases
of ``tests/test_partition.py`` that need no serving front end. The
second part runs the same seeds through both packages with the
tolerance "equal": campaign reports byte-equal as sorted JSON, the
soak's grids and checkpoint shards, detector traces and error texts.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import smi_tpu_torch as st
from smi_tpu.parallel import faults as JF
from smi_tpu.parallel import membership as JM
from smi_tpu.parallel import recovery as JR
from smi_tpu_torch.parallel import faults as F
from smi_tpu_torch.parallel import membership as M
from smi_tpu_torch.parallel import recovery as R

pytestmark = pytest.mark.elastic

#: Seed-pinned: the tier-1 elastic campaign must reproduce exactly
#: with ``python -m smi_tpu chaos --elastic --seed 1729``.
TIER1_SEED = 1729


def _beat_all(det, ranks):
    for r in ranks:
        det.heartbeat(r)


def _bootstrap(det, clock, ranks, rounds=5, interval=M.HEARTBEAT_INTERVAL):
    for _ in range(rounds):
        _beat_all(det, ranks)
        clock.advance(interval)
        assert det.poll() == []


# ---------------------------------------------------------------------------
# The detector
# ---------------------------------------------------------------------------


def test_detector_bootstrap_never_suspects():
    clock = M.StepClock()
    det = M.PhiAccrualDetector(clock, range(3))
    # no samples at all: silence is not evidence yet
    clock.advance(500)
    assert det.poll() == []
    assert det.phi(0) == 0.0


def test_detector_silence_suspects_then_confirms_with_grace():
    clock = M.StepClock()
    det = M.PhiAccrualDetector(clock, range(3))
    _bootstrap(det, clock, range(3))
    transitions = []
    for _ in range(40):
        _beat_all(det, (0, 1))  # rank 2 goes silent
        clock.advance(2)
        transitions.extend(det.poll())
    kinds = [type(t).__name__ for t in transitions]
    assert kinds == ["SuspectRank", "ConfirmedDead"]
    assert all(t.rank == 2 for t in transitions)
    suspect, dead = transitions
    # the grace separates the two verdicts: no healthy->dead jump
    assert dead.step - suspect.step >= M.CONFIRM_GRACE_TICKS
    assert det.dead == {2} and det.suspected == set()
    # a very-late heartbeat from the dead incarnation changes nothing
    det.heartbeat(2)
    assert det.poll() == [] and det.dead == {2}


def test_detector_heartbeat_clears_suspicion():
    clock = M.StepClock()
    det = M.PhiAccrualDetector(clock, range(2))
    _bootstrap(det, clock, range(2))
    transitions = []
    # rank 1 silent just long enough to be suspected...
    while not det.suspected:
        det.heartbeat(0)
        clock.advance(2)
        transitions.extend(det.poll())
    assert [type(t).__name__ for t in transitions] == ["SuspectRank"]
    # ...then it beats again: cleared, never dead
    det.heartbeat(1)
    cleared = det.poll()
    assert [type(t).__name__ for t in cleared] == ["SuspicionCleared"]
    assert cleared[0].rank == 1
    assert det.dead == set()


def test_detector_phi_grows_with_silence():
    clock = M.StepClock()
    det = M.PhiAccrualDetector(clock, [0])
    _bootstrap(det, clock, [0])
    values = []
    for _ in range(10):
        clock.advance(4)
        values.append(det.phi(0))
    assert values == sorted(values)
    assert values[-1] > M.DEAD_PHI


def test_detector_forget_resets_history():
    clock = M.StepClock()
    det = M.PhiAccrualDetector(clock, range(2))
    _bootstrap(det, clock, range(2))
    clock.advance(200)
    det.poll(), det.poll()
    while 1 not in det.dead:
        clock.advance(2)
        det.poll()
    det.forget(1)
    assert 1 not in det.dead
    assert det.phi(1) == 0.0  # fresh bootstrap, no inherited silence


def test_detector_threshold_order_enforced():
    with pytest.raises(ValueError, match="must exceed"):
        M.PhiAccrualDetector(M.StepClock(), range(2),
                             suspect_phi=8.0, dead_phi=4.0)


def test_clock_never_runs_backwards():
    with pytest.raises(ValueError):
        M.StepClock().advance(-1)


# ---------------------------------------------------------------------------
# Membership view: epochs, incarnations, stale traffic
# ---------------------------------------------------------------------------


def test_view_epoch_bumps_per_composition_change():
    view = M.MembershipView(4)
    assert view.epoch == 0 and view.members == {0, 1, 2, 3}
    assert view.confirm_dead(2) == 1
    assert view.dead == {2}
    assert view.regrow(2) == 2
    assert view.members == {0, 1, 2, 3}
    assert view.incarnation[2] == 1 and view.incarnation[0] == 0
    assert view.transitions == [(1, "dead", 2), (2, "regrow", 2)]


def test_view_rejects_stale_future_and_nonmember_traffic():
    view = M.MembershipView(3)
    view.confirm_dead(1)
    view.validate(0, 1)  # current epoch from a member: fine
    with pytest.raises(M.StaleEpochError) as e:
        view.validate(1, 0)
    assert e.value.rank == 1 and e.value.stale == 0 and e.value.current == 1
    with pytest.raises(M.StaleEpochError, match="split view"):
        view.validate(0, 5)
    with pytest.raises(M.StaleEpochError, match="non-member"):
        view.validate(1, 1)


def test_view_guards():
    view = M.MembershipView(2)
    with pytest.raises(ValueError, match="not a member"):
        view.confirm_dead(5)
    view.confirm_dead(1)
    with pytest.raises(ValueError, match="last member"):
        view.confirm_dead(0)
    with pytest.raises(ValueError, match="already a member"):
        view.regrow(0)
    with pytest.raises(ValueError, match="out of range"):
        view.regrow(9)


def test_failure_set_names_dead_devices():
    from smi_tpu_torch.parallel.routing import grid_topology

    view = M.MembershipView(4)
    view.confirm_dead(1)
    topo = grid_topology(1, 4)
    fs = view.failure_set(topo)
    assert fs.devices == frozenset({topo.devices[1]})


def test_plan_regrow_ring_orders_members_and_validates_routing():
    view = M.MembershipView(5)
    view.confirm_dead(2)
    assert M.plan_regrow_ring(view) == [0, 1, 3, 4]
    view.regrow(2)
    assert M.plan_regrow_ring(view) == [0, 1, 2, 3, 4]
    # an unseparable down pair on a tiny ring is the caller's shrink
    tiny = M.MembershipView(2)
    with pytest.raises(ValueError, match="shrink first"):
        M.plan_regrow_ring(tiny, down_pairs=[(0, 1)])


# ---------------------------------------------------------------------------
# The elastic cells (THE acceptance criterion)
# ---------------------------------------------------------------------------


def test_flapping_rank_cell_full_story(tmp_path):
    """Seeded FlappingRank mid-Jacobi: suspected by phi-accrual before
    any watchdog budget, shrink + restore from the last complete
    manifest with tail replay, regrow under a new epoch, final grid
    bit-identical to the fault-free run, and the dead incarnation's
    traffic rejected loudly — never silently folded in."""
    # dies_at=4 with cadence=3: the latest manifest is at iteration 3,
    # so the restore must genuinely replay a tail
    plan = F.FaultPlan.single(F.FlappingRank(1, dies_at=4, rejoins_at=9))
    report = M.run_elastic_cell(
        3, plan, seed=11, iterations=15, cadence=3,
        checkpoint_dir=str(tmp_path / "ckpt"),
    )
    assert report["verdict"] == "ok"  # bit-identical final grid
    assert report["suspected"] == [1] and report["confirmed"] == [1]
    assert report["detect_ticks"] is not None
    assert report["detect_ticks"] <= M.WATCHDOG_TICKS
    assert not report["watchdog_fired"]
    assert report["shrinks"] == 1 and report["restores"] == 1
    assert report["replayed_iterations"] >= 1  # the tail, not a restart
    assert report["regrows"] == 1
    assert report["members"] == [0, 1, 2]  # rejoined
    assert report["epoch"] == 2  # dead bump + regrow bump
    assert report["stale_epoch_rejections"] >= 2  # rejoin + straggler
    assert report["stale_epoch_leaks"] == 0


def test_stalled_heartbeat_cell_suspected_never_killed(tmp_path):
    plan = F.FaultPlan.single(
        F.StalledHeartbeat(0, from_tick=60, silent_for=20)
    )
    report = M.run_elastic_cell(
        3, plan, seed=5, iterations=15, cadence=3,
        checkpoint_dir=str(tmp_path / "ckpt"),
    )
    assert report["verdict"] == "ok"
    assert report["suspected"] == [0] and report["cleared"] == [0]
    assert report["confirmed"] == []
    assert report["shrinks"] == 0 and report["restores"] == 0
    assert report["regrows"] == 0 and report["epoch"] == 0


def test_stalled_heartbeat_never_killed_across_phase_space():
    """Sweep the generator's whole calibration range — every window
    phase x length it can draw. The observable silence of a silent-
    but-alive rank is its window plus up to one heartbeat period of
    schedule phase on EACH side (last beat before the window, first
    scheduled beat after it), so with too small a confirmation grace
    the clearing beat loses the race to the confirm poll and a healthy
    rank dies. Every cell here must end ok with zero confirmations."""
    for from_tick in range(50, 90, 4):
        for silent_for in (16, 20, 24):
            plan = F.FaultPlan.single(F.StalledHeartbeat(
                1, from_tick=from_tick, silent_for=silent_for,
            ))
            report = M.run_elastic_cell(
                3, plan, seed=from_tick * 31 + silent_for,
                iterations=15, cadence=3,
            )
            assert report["verdict"] == "ok", (
                from_tick, silent_for, report["verdict"]
            )
            assert report["confirmed"] == []
            assert report["shrinks"] == 0 and report["regrows"] == 0


def test_elastic_cell_deterministic(tmp_path):
    plan = F.FaultPlan.single(F.FlappingRank(0, dies_at=3, rejoins_at=8))
    a = M.run_elastic_cell(2, plan, seed=3, iterations=12, cadence=3,
                           checkpoint_dir=str(tmp_path / "a"))
    b = M.run_elastic_cell(2, plan, seed=3, iterations=12, cadence=3,
                           checkpoint_dir=str(tmp_path / "b"))
    assert a == b


def test_elastic_cell_without_store_still_bit_identical():
    """Heir inheritance alone keeps the global grid exact — the store
    adds durability, not correctness of the surviving math."""
    plan = F.FaultPlan.single(F.FlappingRank(1, dies_at=3, rejoins_at=7))
    report = M.run_elastic_cell(3, plan, seed=2, iterations=12, cadence=4)
    assert report["verdict"] == "ok" and report["restores"] == 0


# ---------------------------------------------------------------------------
# The campaign
# ---------------------------------------------------------------------------


def _assert_clean(report):
    assert report["ok"], report["failures"]
    assert report["silent_corruptions"] == 0
    assert report["stale_epoch_leaks"] == 0
    assert report["stale_epoch_rejections"] > 0  # regrows were exercised
    assert report["outcomes"].get("regrown", 0) > 0
    assert report["max_detect_ticks"] is not None
    assert report["max_detect_ticks"] <= report["watchdog_budget_ticks"]


def test_tier1_seed_pinned_elastic_campaign():
    report = M.elastic_campaign(seed=TIER1_SEED, ns=(2, 3, 4), trials=2)
    _assert_clean(report)
    assert report["cells"] == 6


def test_elastic_campaign_deterministic_and_json_roundtrippable():
    a = M.elastic_campaign(seed=7, ns=(2, 3), trials=1)
    b = M.elastic_campaign(seed=7, ns=(2, 3), trials=1)
    assert a == b
    assert json.loads(json.dumps(a)) == a
    c = M.elastic_campaign(seed=8, ns=(2, 3), trials=1)
    assert c != a


def test_random_elastic_plan_seeded_and_single_fault():
    assert M.random_elastic_plan(3, 42) == M.random_elastic_plan(3, 42)
    seen = set()
    for seed in range(30):
        plan = M.random_elastic_plan(4, seed)
        faults = plan.faults()
        assert len(faults) == 1
        seen.add(type(faults[0]).__name__)
    assert seen == {"FlappingRank", "StalledHeartbeat"}


@pytest.mark.slow
def test_long_elastic_soak():
    for seed in range(3):
        report = M.elastic_campaign(seed=seed, ns=(2, 3, 4, 5, 6),
                                    trials=4, iterations=24, cadence=4)
        _assert_clean(report)



# ---------------------------------------------------------------------------
# Fault-class registration
# ---------------------------------------------------------------------------


def test_elastic_classes_not_in_base_fault_classes():
    """The seed-pinned base chaos campaign draws from FAULT_CLASSES;
    the elastic classes must live in their own tuple or every pinned
    cell silently re-rolls."""
    assert set(F.ELASTIC_FAULT_CLASSES) == {
        "flapping_rank", "stalled_heartbeat"
    }
    assert not set(F.ELASTIC_FAULT_CLASSES) & set(F.FAULT_CLASSES)


def test_elastic_faults_register_with_fault_plan():
    flap = F.FlappingRank(1, dies_at=2, rejoins_at=6)
    sil = F.StalledHeartbeat(0, from_tick=50, silent_for=20)
    plan = F.FaultPlan.of([flap, sil])
    assert plan.faults() == (flap, sil)
    assert not plan.empty
    assert F.FaultPlan.single(flap).flapping_ranks == (flap,)
    described = plan.describe()
    assert any("FlappingRank" in s for s in described)
    assert any("StalledHeartbeat" in s for s in described)
    # job-level faults have no simulator-hook effect
    assert plan.stall_after(1) is None
    assert plan.grant_multiplier(0, 0) == 1


def test_elastic_random_plans_seeded():
    for cls in F.ELASTIC_FAULT_CLASSES:
        a = F.FaultPlan.random(cls, 4, 17)
        assert a == F.FaultPlan.random(cls, 4, 17)
        assert len(a.faults()) == 1


def test_flapping_rank_must_die_before_rejoining():
    with pytest.raises(ValueError, match="die before it rejoins"):
        F.FlappingRank(0, dies_at=5, rejoins_at=5)


def test_base_campaign_seed_pinned_cells_unchanged():
    """Adding the elastic fields must not perturb a single base-chaos
    draw: the pinned plan for a known cell seed is byte-stable."""
    plan = R.random_chaos_plan(4, 12345, max_faults=2)
    assert plan == R.random_chaos_plan(4, 12345, max_faults=2)
    assert not plan.flapping_ranks and not plan.stalled_heartbeats


# ---------------------------------------------------------------------------
# run_with_recovery consults membership
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
def test_recovery_membership_preshrink_skips_doomed_ring(protocol):
    """A rank the detector already confirmed dead is shrunk out BEFORE
    attempt 1 — no deadlock is ever provoked, and the heirs serve the
    dead rank's logged contribution so results still match the
    fault-free run exactly."""
    view = M.MembershipView(4)
    view.confirm_dead(2)
    out = R.run_with_recovery(protocol, 4, None, membership=view)
    assert out.ok
    assert out.survivors == (0, 1, 3)
    assert out.attempts[0].verdict == "membership-shrink"
    assert out.attempts[0].failed_ranks == (2,)
    # no attempt ever deadlocked: the detector beat the error path
    assert not any("Deadlock" in a.verdict for a in out.attempts)


def test_recovery_membership_composes_with_error_parsing():
    """Detector knowledge and error-dump knowledge union: one rank
    pre-confirmed dead, another crashes mid-run."""
    view = M.MembershipView(5)
    view.confirm_dead(4)
    plan = F.FaultPlan.single(F.StalledRank(1, after=3))
    out = R.run_with_recovery("all_gather", 5, plan, membership=view)
    assert out.ok
    assert 4 not in out.survivors and 1 not in out.survivors
    assert out.fault_trail[0] == "membership-shrink"


def test_recovery_membership_annihilation_is_named():
    view = M.MembershipView(2)
    view.confirm_dead(0)
    # the view's own guard forbids removing the last member; a view
    # that nonetheless reports everyone dead (operator override, a
    # merged remote view) must surface as named annihilation
    view.members = set()
    with pytest.raises(R.UnrecoverableError) as e:
        R.run_with_recovery("all_reduce", 2, None, membership=view)
    assert e.value.annihilated


def test_recovery_without_membership_is_unchanged():
    plan = F.FaultPlan.single(F.StalledRank(2, after=5))
    a = R.run_with_recovery("all_reduce", 4, plan, strategy_seed=3)
    b = R.run_with_recovery("all_reduce", 4, plan, strategy_seed=3,
                            membership=None)
    assert a.ok and b.ok and a.fault_trail == b.fault_trail


# ---------------------------------------------------------------------------
# The epoch gate on a communicator (an 8-rank CPU LocalWorld)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def comm8():
    return st.LocalWorld(8, device="cpu").comms[0]


def test_regrow_validates_its_arguments(comm8):
    with pytest.raises(ValueError, match="not in the excluded set"):
        comm8.regrow({3}, {4})
    with pytest.raises(ValueError, match="at least one rank"):
        comm8.regrow({3}, set())
    with pytest.raises(ValueError, match="out of range"):
        comm8.regrow({99}, {99})


def test_validate_epoch_rejects_stale_traffic(comm8):
    regrown = comm8.regrow({2}, {2})
    regrown.validate_epoch(2, regrown.epoch)  # current: fine
    with pytest.raises(M.StaleEpochError) as e:
        regrown.validate_epoch(2, 0, what="halo slab")
    assert e.value.rank == 2 and e.value.current == regrown.epoch
    assert "halo slab" in str(e.value)


def test_regrow_default_epoch_outranks_the_shrunk_incarnation(comm8):
    shrunk = comm8.shrink({2})
    regrown = comm8.regrow({2}, {2})
    assert regrown.epoch > shrunk.epoch
    with pytest.raises(M.StaleEpochError):
        regrown.validate_epoch(2, shrunk.epoch, what="straggler")


def test_validate_epoch_names_the_split_view_side(comm8):
    with pytest.raises(M.StaleEpochError, match="split view") as e:
        comm8.validate_epoch(3, comm8.epoch + 5)
    assert "regrow()" not in str(e.value)


# ---------------------------------------------------------------------------
# Pod membership (tests/test_multislice.py)
# ---------------------------------------------------------------------------


@pytest.mark.multislice
def test_plan_pod_rings_shrinks_slice_ring_on_dead_rank():
    v = M.MembershipView(6)
    p = M.plan_pod_rings(v, 2, 3)
    assert p.hierarchical
    assert p.slice_rings == ((0, 1, 2), (3, 4, 5))
    assert p.cross_ring == (0, 3)
    v.confirm_dead(4)
    p = M.plan_pod_rings(v, 2, 3)
    assert p.hierarchical
    assert p.slice_rings == ((0, 1, 2), (3, 5))
    assert p.cross_ring == (0, 3)


@pytest.mark.multislice
def test_plan_pod_rings_dead_slice_falls_back_flat():
    v = M.MembershipView(6)
    for r in (3, 4, 5):
        v.confirm_dead(r)
    p = M.plan_pod_rings(v, 2, 3)
    assert not p.hierarchical
    assert p.flat_ring == (0, 1, 2)
    with pytest.raises(ValueError, match="does not match"):
        M.plan_pod_rings(M.MembershipView(5), 2, 3)


@pytest.mark.multislice
def test_pod_heir_prefers_the_slice_ring():
    assert M.pod_heir_of(4, {0, 1, 2, 3, 5}, 2, 3) == 5
    assert M.pod_heir_of(5, {0, 1, 2, 3}, 2, 3) == 3
    # whole slice dead: inheritance crosses to the global successor
    assert M.pod_heir_of(4, {0, 1, 2}, 2, 3) == 0


@pytest.mark.multislice
@pytest.mark.parametrize("kill", ["rank", "slice"])
def test_pod_soak_heals_seeded_kill(tmp_path, kill):
    rep = M.run_pod_cell(2, 2, kill, seed=11,
                         checkpoint_dir=str(tmp_path / "shards"))
    assert rep["verdict"] == "ok", rep
    assert rep["shrinks"] >= 1 and rep["regrows"] >= 1
    assert rep["restores"] >= 1
    assert rep["stale_epoch_rejections"] >= 2
    assert rep["stale_epoch_leaks"] == 0
    if kill == "rank":
        assert rep["plan_modes"][0] == "hierarchical"
    else:
        assert rep["plan_modes"][0] == "flat"
    assert rep["plan_modes"][-1] == "hierarchical"


@pytest.mark.multislice
def test_pod_campaign_seed_pinned():
    report = M.pod_campaign(seed=1729, shapes=((2, 2), (2, 3)), trials=1)
    assert report["ok"], report["failures"]
    assert report["silent_corruptions"] == 0
    assert report["stale_epoch_leaks"] == 0
    assert report["cells"] == 4
    assert report["outcomes"].get("regrown-rank", 0) >= 1
    assert report["outcomes"].get("regrown-slice", 0) >= 1
    again = M.pod_campaign(seed=1729, shapes=((2, 2), (2, 3)), trials=1)
    assert report == again
    assert json.loads(json.dumps(report)) == report


@pytest.mark.multislice
@pytest.mark.slow
def test_pod_campaign_wide():
    report = M.pod_campaign(seed=7, shapes=((2, 2), (2, 3), (3, 2)),
                            trials=3, iterations=24)
    assert report["ok"], report["failures"]


# ---------------------------------------------------------------------------
# Quorum fencing and the partition-class faults (tests/test_partition.py)
# ---------------------------------------------------------------------------


@pytest.mark.partition
def test_partition_fault_cuts_both_directions_across_the_cut():
    fault = F.PartitionFault(minority=frozenset({2}), from_tick=10,
                             until_tick=20)
    assert fault.blocks(2, 0, 10)       # minority -> majority
    assert fault.blocks(0, 2, 19)       # majority -> minority
    assert not fault.blocks(0, 1, 15)   # within the majority
    assert not fault.blocks(2, 2, 15)   # within the minority
    assert not fault.blocks(2, 0, 9)    # before the window
    assert not fault.blocks(2, 0, 20)   # after the heal


@pytest.mark.partition
def test_asymmetric_fault_cuts_exactly_one_direction():
    fault = F.AsymmetricLinkFault(src=2, dst=0, from_tick=10,
                                  until_tick=20)
    assert fault.blocks(2, 0, 15)       # the dead direction
    assert not fault.blocks(0, 2, 15)   # the live direction
    assert not fault.blocks(2, 1, 15)   # other peers unaffected
    assert not fault.blocks(2, 0, 20)


@pytest.mark.partition
def test_flapping_link_is_deterministic_and_windowed():
    a = F.FlappingLink(a=0, b=2, from_tick=40, until_tick=160, seed=7)
    b = F.FlappingLink(a=0, b=2, from_tick=40, until_tick=160, seed=7)
    ticks_a = [t for t in range(200) if a.blocks(0, 2, t)]
    ticks_b = [t for t in range(200) if b.blocks(2, 0, t)]
    assert ticks_a == ticks_b           # deterministic, symmetric
    assert ticks_a                      # the flap actually flaps
    assert all(40 <= t < 160 for t in ticks_a)
    assert len(ticks_a) < 120
    assert not a.blocks(0, 1, 50)       # other links untouched
    # the JAX package's flap is down on the same ticks
    twin = JF.FlappingLink(a=0, b=2, from_tick=40, until_tick=160, seed=7)
    assert ticks_a == [t for t in range(200) if twin.blocks(0, 2, t)]


@pytest.mark.partition
def test_flapping_link_validation_is_loud():
    with pytest.raises(ValueError, match="DISTINCT"):
        F.FlappingLink(a=1, b=1)
    with pytest.raises(ValueError, match="down_ticks"):
        F.FlappingLink(a=0, b=1, period=4, down_ticks=5)
    with pytest.raises(ValueError, match="window is empty"):
        F.FlappingLink(a=0, b=1, from_tick=50, until_tick=50)


@pytest.mark.partition
def test_quorum_fraction_default_env_and_explicit(monkeypatch):
    monkeypatch.delenv(M.QUORUM_FRACTION_ENV, raising=False)
    assert M.QUORUM_FRACTION_ENV == JM.QUORUM_FRACTION_ENV == \
        "SMI_TPU_QUORUM_FRACTION"
    assert M.quorum_fraction() == M.DEFAULT_QUORUM_FRACTION == 0.5
    monkeypatch.setenv(M.QUORUM_FRACTION_ENV, "0.75")
    assert M.quorum_fraction() == 0.75
    assert M.quorum_fraction(0.6) == 0.6


@pytest.mark.partition
@pytest.mark.parametrize("raw", ["garbage", "nan", "inf", "0.49", "1.0",
                                 "-1", "2"])
def test_quorum_fraction_refuses_what_jax_refuses(monkeypatch, raw):
    monkeypatch.setenv(M.QUORUM_FRACTION_ENV, raw)
    texts = []
    for mod in (M, JM):
        with pytest.raises(ValueError) as e:
            mod.quorum_fraction()
        texts.append(str(e.value))
    assert texts[0] == texts[1]


@pytest.mark.partition
@pytest.mark.parametrize("n,expected", [
    (1, 1), (2, 2), (3, 2), (4, 3), (5, 3), (8, 5),
])
def test_quorum_size_is_strict_majority(monkeypatch, n, expected):
    monkeypatch.delenv(M.QUORUM_FRACTION_ENV, raising=False)
    assert M.quorum_size(n) == expected
    assert M.quorum_size(4, fraction=0.75) == 4
    with pytest.raises(ValueError):
        M.quorum_size(0)


@pytest.mark.partition
def test_fencing_tokens_mint_check_and_refuse():
    view = M.MembershipView(4)
    token = M.mint_fencing_token(view)
    assert token == M.FencingToken(epoch=0,
                                   quorum_set=frozenset({0, 1, 2, 3}))
    with pytest.raises(M.QuorumLostError) as err:
        M.mint_fencing_token(view, reachable=[2], rank=2, what="cutover")
    assert err.value.rank == 2 and err.value.needed == 3
    assert err.value.reachable == frozenset({2})
    assert "park" in str(err.value)
    with pytest.raises(M.QuorumLostError):
        M.check_fencing_token(
            view, M.FencingToken(epoch=0, quorum_set=frozenset({1})))
    assert M.check_fencing_token(view, token) is token
    assert M.check_fencing_token(view, None).epoch == view.epoch
    view.confirm_dead(3)  # epoch moves; the token is now a straggler
    with pytest.raises(M.StaleEpochError):
        M.check_fencing_token(view, token)
    decision = M.QuorumDecision(epoch=3, quorum=(0, 1, 2), verdict="minted")
    assert decision.as_fields() == JM.QuorumDecision(
        epoch=3, quorum=(0, 1, 2), verdict="minted").as_fields()
    assert decision.as_fields()["quorum"] == "0,1,2"


# ---------------------------------------------------------------------------
# Parity with the JAX package: the same seed, the same report
# ---------------------------------------------------------------------------


def sorted_json(report):
    return json.dumps(report, sort_keys=True)


@pytest.mark.parametrize("kwargs", [
    dict(seed=TIER1_SEED, ns=(2, 3, 4), trials=2),
    dict(seed=7, ns=(2, 3), trials=1),
    dict(seed=8, ns=(3, 5), trials=1, iterations=18, cadence=3),
], ids=lambda k: f"seed{k['seed']}")
def test_elastic_campaign_reports_are_byte_equal(kwargs):
    assert sorted_json(M.elastic_campaign(**kwargs)) == sorted_json(
        JM.elastic_campaign(**kwargs))


@pytest.mark.multislice
@pytest.mark.parametrize("kwargs", [
    dict(seed=1729, shapes=((2, 2), (2, 3)), trials=1),
    dict(seed=3, shapes=((3, 2),), trials=1, iterations=12),
], ids=lambda k: f"seed{k['seed']}")
def test_pod_campaign_reports_are_byte_equal(kwargs):
    assert sorted_json(M.pod_campaign(**kwargs)) == sorted_json(
        JM.pod_campaign(**kwargs))


def files_of(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("cell", [
    ("flap", 3, 11, dict(iterations=15, cadence=3)),
    ("flap", 2, 3, dict(iterations=12, cadence=3)),
    ("silent", 3, 5, dict(iterations=15, cadence=3)),
    ("random", 4, 21, dict(iterations=24, cadence=4)),
], ids=lambda c: f"{c[0]}-n{c[1]}")
def test_elastic_cell_grids_and_shards_match_jax(tmp_path, cell):
    """One soak cell in both packages: the same report, the same
    checkpoint files byte for byte, and the same grid restored from the
    newest manifest, ``array_equal``."""
    kind, n, seed, kw = cell

    def plan(mod_f, mod_m):
        if kind == "flap":
            return mod_f.FaultPlan.single(
                mod_f.FlappingRank(1, dies_at=4, rejoins_at=9))
        if kind == "silent":
            return mod_f.FaultPlan.single(
                mod_f.StalledHeartbeat(0, from_tick=60, silent_for=20))
        return mod_m.random_elastic_plan(n, seed)

    reports, grids = [], []
    for tag, mod_f, mod_m in (("port", F, M), ("jax", JF, JM)):
        directory = str(tmp_path / tag)
        reports.append(mod_m.run_elastic_cell(
            n, plan(mod_f, mod_m), seed=seed, checkpoint_dir=directory, **kw))
        step, shards, epoch = st.CheckpointStore(directory).restore()
        grids.append((step, epoch,
                      np.concatenate([shards[r] for r in sorted(shards)])))
    assert reports[0] == reports[1] and reports[0]["verdict"] == "ok"
    assert files_of(str(tmp_path / "port")) == files_of(str(tmp_path / "jax"))
    assert grids[0][:2] == grids[1][:2]
    assert grids[0][2].dtype == np.float64
    assert np.array_equal(grids[0][2], grids[1][2])


def test_the_soak_data_plane_is_the_jax_one():
    """The Jacobi sweep over row blocks and its serial yardstick give
    the JAX package's float64 grids bit for bit."""
    n, rows, width = 4, 3, 9
    grid0 = M._initial_grid(n * rows, width)
    assert np.array_equal(grid0, JM._initial_grid(n * rows, width))
    rng = np.random.default_rng(0)
    grid0[1:-1, 1:-1] = rng.random((n * rows - 2, width - 2))
    blocks = {r: grid0[r * rows:(r + 1) * rows].copy() for r in range(n)}
    owners = {r: r for r in range(n)}
    port = M._jacobi_sweep(dict(blocks), owners, M.MembershipView(n), n)
    want = JM._jacobi_sweep(dict(blocks), owners, JM.MembershipView(n), n)
    for r in range(n):
        assert np.array_equal(port[r], want[r])
    assert np.array_equal(M._fault_free_grid(grid0, 7),
                          JM._fault_free_grid(grid0, 7))


def test_detector_traces_match_jax():
    """The same heartbeat trace through both detectors: the same phi at
    every poll and the same events in the same order."""
    def drive(mod):
        clock = mod.StepClock()
        det = mod.PhiAccrualDetector(clock, range(4))
        rng = __import__("random").Random("trace")
        trail = []
        for tick in range(400):
            for r in range(4):
                silent = (r == 2 and tick > 120) or (
                    r == 1 and 200 <= tick < 230)
                if not silent and rng.random() < 0.1:
                    det.heartbeat(r)
            clock.advance(1)
            trail.append([(type(e).__name__, dataclasses.asdict(e))
                          for e in det.poll()])
            trail.append([round(det.phi(r), 12) for r in range(4)])
        return trail

    assert drive(M) == drive(JM)


def test_membership_views_and_errors_match_jax():
    texts = []
    for mod in (M, JM):
        view = mod.MembershipView(5)
        view.confirm_dead(3)
        view.regrow(3)
        out = [view.epoch, sorted(view.members), dict(view.incarnation),
               mod.plan_regrow_ring(view), mod.route_owner(view, 2, 5)]
        for bad in (lambda: view.validate(3, 0, what="halo slab"),
                    lambda: view.validate(1, 9),
                    lambda: view.confirm_dead(7),
                    lambda: view.regrow(0)):
            try:
                bad()
            except (ValueError, mod.StaleEpochError) as e:
                out.append((type(e).__name__, str(e)))
        texts.append(out)
    assert texts[0] == texts[1]
    assert len(texts[0]) == 9


@pytest.mark.parametrize("n", [2, 3, 4, 6])
def test_recovery_under_a_membership_view_matches_jax(n):
    """run_with_recovery consulting a view: the same attempts as the
    JAX package's for every protocol."""
    for protocol in F.PROTOCOLS:
        got = []
        for mod_m, mod_r, mod_f in ((M, R, F), (JM, JR, JF)):
            view = mod_m.MembershipView(n)
            view.confirm_dead(n - 1)
            plan = mod_f.FaultPlan.single(mod_f.StalledRank(0, after=2))
            out = mod_r.run_with_recovery(protocol, n, plan,
                                          membership=view)
            got.append((out.ok, out.survivors, out.fault_trail,
                        [dataclasses.astuple(a) for a in out.attempts]))
        assert got[0] == got[1]
