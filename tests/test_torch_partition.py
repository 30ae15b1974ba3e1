"""The port's partition tolerance at the serving tier: the reference's
cases, and parity.

The front end's minority park, loud refusal and heal rejoin, the
split-brain A/B, and the three partition campaign cells, on the port's
serving tier (``smi_tpu_torch/serving/``). The first part carries over
``tests/test_partition.py`` against the port, all but the fault-trio
and quorum-size cases that ``tests/test_torch_membership.py`` already
carries. The second part runs the same seeds through both packages with
the tolerance "equal": cell and campaign reports, the front end's state
and the fencing decisions as sorted-key JSON, refusal texts equal.
"""

import pytest

from smi_tpu_torch.obs.events import EVENT_KINDS
from smi_tpu_torch.parallel.faults import (
    PARTITION_FAULT_CLASSES,
)
from smi_tpu_torch.parallel.membership import (
    DEFAULT_QUORUM_FRACTION,
    QUORUM_FRACTION_ENV,
    FencingToken,
    MembershipView,
    QuorumDecision,
    QuorumLostError,
    StaleEpochError,
    check_fencing_token,
    mint_fencing_token,
    quorum_fraction,
    quorum_size,
)
from smi_tpu_torch.serving.campaign import (
    MODEL_GATES,
    PARTITION_CELLS,
    _run_partition_traffic,
    partition_campaign,
    partition_selftest,
    run_flapping_link_cell,
    run_partition_cell,
    run_partition_migration_cell,
)

from torch_serving_parity import canon, frontend_state

pytestmark = pytest.mark.partition


# ---------------------------------------------------------------------------
# The partition-class fault trio
# ---------------------------------------------------------------------------


def test_partition_fault_class_registry():
    assert PARTITION_FAULT_CLASSES == (
        "partition", "asymmetric_link", "flapping_link",
    )


# ---------------------------------------------------------------------------
# Quorum fraction: the env knob's loudness discipline
# ---------------------------------------------------------------------------


def test_quorum_fraction_default_is_strict_majority(monkeypatch):
    monkeypatch.delenv(QUORUM_FRACTION_ENV, raising=False)
    assert quorum_fraction() == DEFAULT_QUORUM_FRACTION == 0.5


def test_quorum_fraction_env_and_explicit_precedence(monkeypatch):
    monkeypatch.setenv(QUORUM_FRACTION_ENV, "0.75")
    assert quorum_fraction() == 0.75
    # the explicit argument outranks the environment
    assert quorum_fraction(0.6) == 0.6


@pytest.mark.parametrize("raw", ["garbage", "nan", "inf"])
def test_quorum_fraction_rejects_malformed_env_loudly(monkeypatch,
                                                      raw):
    monkeypatch.setenv(QUORUM_FRACTION_ENV, raw)
    with pytest.raises(ValueError):
        quorum_fraction()


@pytest.mark.parametrize("raw", ["0.49", "1.0", "-1", "2"])
def test_quorum_fraction_rejects_unsafe_range_loudly(monkeypatch,
                                                     raw):
    # below 0.5 two disjoint quorums could coexist; 1.0 needs n+1 of n
    monkeypatch.setenv(QUORUM_FRACTION_ENV, raw)
    with pytest.raises(ValueError):
        quorum_fraction()



def test_quorum_size_honours_fraction(monkeypatch):
    monkeypatch.delenv(QUORUM_FRACTION_ENV, raising=False)
    assert quorum_size(4, fraction=0.75) == 4
    with pytest.raises(ValueError):
        quorum_size(0)


# ---------------------------------------------------------------------------
# Fencing tokens: mint/check matrix
# ---------------------------------------------------------------------------


def test_mint_fencing_token_full_view_is_trivially_quorate():
    view = MembershipView(4)
    token = mint_fencing_token(view)
    assert token == FencingToken(epoch=0,
                                 quorum_set=frozenset({0, 1, 2, 3}))


def test_mint_fencing_token_minority_raises_loudly():
    view = MembershipView(4)
    with pytest.raises(QuorumLostError) as err:
        mint_fencing_token(view, reachable=[2], rank=2,
                           what="cutover")
    assert err.value.rank == 2
    assert err.value.reachable == frozenset({2})
    assert err.value.needed == 3
    assert "park" in str(err.value)


def test_check_fencing_token_stale_epoch_rides_the_straggler_rail():
    view = MembershipView(4)
    token = mint_fencing_token(view)
    view.confirm_dead(3)  # epoch moves; the token is now a straggler
    with pytest.raises(StaleEpochError):
        check_fencing_token(view, token)


def test_check_fencing_token_filtered_quorum_is_rejected():
    view = MembershipView(4)
    forged = FencingToken(epoch=0, quorum_set=frozenset({1}))
    with pytest.raises(QuorumLostError):
        check_fencing_token(view, forged)


def test_check_fencing_token_none_mints_the_healthy_path():
    view = MembershipView(4)
    token = check_fencing_token(view, None)
    assert token.epoch == view.epoch
    # a valid token round-trips
    assert check_fencing_token(view, token) is token


def test_quorum_decision_fields_match_the_event_schema():
    decision = QuorumDecision(epoch=3, quorum=(0, 1, 2),
                              verdict="minted")
    fields = decision.as_fields()
    plane, keys = EVENT_KINDS["ctl.quorum"]
    assert plane == "control"
    assert set(fields) == set(keys)
    assert fields["quorum"] == "0,1,2"


# ---------------------------------------------------------------------------
# The front end: minority park, loud refusal, heal rejoin
# ---------------------------------------------------------------------------


def test_partition_cell_parks_refuses_loudly_and_rejoins():
    report, fe = run_partition_cell(n=4, seed=0, return_frontend=True)
    assert report["ok"], report["verdict"]
    part = report["partition"]
    assert part["fenced"]
    assert part["quorum_losses"] >= 1
    assert part["quorum_rejections"] >= 1
    # every refusal surfaced to the caller as QuorumLostError
    assert report["quorum_rejected_seen"] == part["quorum_rejections"]
    assert part["heal_rejoins"] >= 1
    assert part["split_brain_incidents"] == 0
    assert part["parked"] == []
    assert report["members"] == [0, 1, 2, 3]
    assert report["stale_epoch_rejections"] >= 1
    assert report["stale_epoch_leaks"] == 0
    assert report["lost_accepted"] == 0
    assert report["digest_match"]
    # the fencing decisions are on the record, loud and structured
    verdicts = {d["verdict"] for d in part["decisions"]}
    assert {"lost", "rejected", "rejoin"} <= verdicts
    kinds = {e["kind"] for e in fe.recorder.tail(10_000)["events"]}
    assert "ctl.quorum" in kinds


def test_split_brain_present_unfenced_eliminated_fenced():
    """The PR's headline A/B: the same cut, with and without the
    quorum fence. Unfenced, the cut rank keeps accepting streams the
    majority has already rerouted — split-brain incidents. Fenced,
    those accepts become loud refusals and the incident count is
    ZERO."""
    unfenced, _, _, unfenced_rejected = _run_partition_traffic(
        4, 0, 240, 3, 64, fenced=False, fault_kind="partition",
        partition_at=60, window=100)
    fenced, _, _, fenced_rejected = _run_partition_traffic(
        4, 0, 240, 3, 64, fenced=True, fault_kind="partition",
        partition_at=60, window=100)
    assert unfenced.split_brain_accepts > 0
    assert unfenced_rejected == 0       # nothing was ever refused
    assert fenced.split_brain_accepts == 0
    assert fenced_rejected > 0          # refusals, loud and counted
    assert fenced.report()["lost_accepted"] == 0


def test_asymmetric_cut_aborts_migration_loudly_loss_free():
    report = run_partition_migration_cell(n=4, seed=0)
    assert report["ok"], report["verdict"]
    migs = report["elasticity"]["migrations"]
    assert [m["state"] for m in migs] == ["aborted"]
    assert migs[0]["abort_reason"] in ("membership-change",
                                       "quorum-lost")
    assert report["lost_accepted"] == 0
    assert report["silent_corruptions"] == 0
    assert report["confirmed"] == [report["src"]]
    assert report["members"] == [0, 1, 2, 3]  # rejoined at the heal


def test_flapping_link_never_moves_membership():
    report = run_flapping_link_cell(n=4, seed=0)
    assert report["ok"], report["verdict"]
    assert report["epoch"] == 0
    assert report["confirmed"] == []
    assert report["suspected"]          # the soak engaged
    assert len(report["cleared"]) == len(report["suspected"])
    part = report["partition"]
    assert part["quorum_losses"] == 0
    assert part["quorum_rejections"] == 0


# ---------------------------------------------------------------------------
# Campaign plumbing
# ---------------------------------------------------------------------------


def test_partition_campaign_aggregates_and_narrows():
    report = partition_campaign(seed=0, n=4, trials=1)
    assert report["ok"], report["failures"]
    assert report["cells"] == len(PARTITION_CELLS) == 3
    assert report["split_brain_incidents"] == 0
    narrowed = partition_campaign(seed=0, n=4, trials=1,
                                  only="flapping-link")
    assert narrowed["ok"]
    assert narrowed["cells"] == 1
    with pytest.raises(ValueError, match="unknown partition cell"):
        partition_campaign(only="nope")


def test_partition_selftest_is_the_clean_cell():
    report = partition_selftest(seed=0)
    assert report["ok"], report["verdict"]
    assert report["partition"]["heal_rejoins"] >= 1


def test_partition_cell_guards_are_loud():
    with pytest.raises(ValueError, match="minimum"):
        run_partition_cell(n=4, duration=60)
    with pytest.raises(ValueError, match="lease"):
        run_partition_cell(n=4, window=10)
    with pytest.raises(ValueError, match="post-heal"):
        run_partition_cell(n=4, duration=240, partition_at=100,
                           window=120)
    with pytest.raises(ValueError, match="stall_at"):
        run_partition_migration_cell(n=4, stall_at=80, migrate_at=70)


def test_model_gates_name_the_partition_properties():
    assert MODEL_GATES["no-split-brain"]
    assert MODEL_GATES["fenced-actuation"]


# ---------------------------------------------------------------------------
# The wide sweep (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("seed", range(16))
def test_partition_cells_sweep(n, seed):
    for cell in (run_partition_cell, run_partition_migration_cell,
                 run_flapping_link_cell):
        r = cell(n=n, seed=seed)
        assert r["ok"], (cell.__name__, n, seed, r["verdict"])


# ---------------------------------------------------------------------------
# Parity with the JAX package: the same seeds, the same reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell,kwargs", [
    ("run_partition_cell", dict(n=4, seed=0)),
    ("run_partition_cell", dict(n=5, seed=3)),
    ("run_partition_migration_cell", dict(n=4, seed=0)),
    ("run_partition_migration_cell", dict(n=4, seed=6)),
    ("run_flapping_link_cell", dict(n=4, seed=0)),
    ("run_flapping_link_cell", dict(n=6, seed=2)),
], ids=["partition", "partition-n5", "migration", "migration-6",
        "flapping", "flapping-n6"])
def test_partition_cell_equals_the_jax_package_s(cell, kwargs):
    from smi_tpu.serving import campaign as JC
    from smi_tpu_torch.serving import campaign as SC

    ours, fe = getattr(SC, cell)(return_frontend=True, **kwargs)
    theirs, jfe = getattr(JC, cell)(return_frontend=True, **kwargs)
    assert ours["ok"], ours["verdict"]
    assert canon(ours) == canon(theirs)
    assert frontend_state(fe) == frontend_state(jfe)


@pytest.mark.parametrize("fenced", [False, True])
def test_split_brain_traffic_equals_the_jax_package_s(fenced):
    from smi_tpu.serving import campaign as JC

    runs = []
    for run in (_run_partition_traffic, JC._run_partition_traffic):
        fe, *rest = run(4, 0, 240, 3, 64, fenced=fenced,
                        fault_kind="partition", partition_at=60,
                        window=100)
        runs.append((frontend_state(fe), fe.split_brain_accepts,
                     canon(rest)))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("kwargs", [
    dict(seed=0, n=4, trials=1), dict(seed=2, n=4, trials=2),
    dict(seed=0, n=4, trials=1, only="flapping-link")],
    ids=["one-trial", "two-trials", "narrowed"])
def test_partition_campaign_equals_the_jax_package_s(kwargs):
    from smi_tpu.serving import campaign as JC

    ours = partition_campaign(**kwargs)
    assert ours["ok"], ours["failures"]
    assert canon(ours) == canon(JC.partition_campaign(**kwargs))


@pytest.mark.parametrize("seed", [0, 1])
def test_partition_selftest_equals_the_jax_package_s(seed):
    from smi_tpu.serving import campaign as JC

    assert canon(partition_selftest(seed=seed)) == canon(
        JC.partition_selftest(seed=seed))


@pytest.mark.parametrize("call", [
    lambda m: m.run_partition_cell(n=4, duration=60),
    lambda m: m.run_partition_cell(n=4, window=10),
    lambda m: m.run_partition_cell(n=4, duration=240, partition_at=100,
                                   window=120),
    lambda m: m.run_partition_migration_cell(n=4, stall_at=80,
                                             migrate_at=70),
    lambda m: m.partition_campaign(only="nope"),
], ids=["short", "lease", "post-heal", "stall-at", "unknown-cell"])
def test_partition_refusals_name_the_jax_package_s_texts(call):
    from smi_tpu.serving import campaign as JC
    from smi_tpu_torch.serving import campaign as SC

    with pytest.raises(ValueError) as ours:
        call(SC)
    with pytest.raises(ValueError) as theirs:
        call(JC)
    assert str(ours.value) == str(theirs.value)

