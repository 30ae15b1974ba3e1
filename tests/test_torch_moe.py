"""The port's MoE expert dispatch: the reference's cases, and parity.

``smi_tpu_torch/serving/moe.py`` is the port's copy of the JAX package's
data-dependent all-to-all workload through the serving front end: the
seeded router, the per-expert splits, the dispatcher's scatter and
gather, and the MoE campaign cells. The first part carries over
``tests/test_moe.py`` against the port, all but its CLI case (the port
has no CLI yet). The second part runs the same seeds through both
packages with the tolerance "equal": routings, the dispatcher's batches
and the front end's state, cell and campaign reports as sorted-key JSON.
"""

import pytest

from smi_tpu_torch.serving import moe
from smi_tpu_torch.serving.frontend import ServingFrontend, tenant_base_rank
from smi_tpu_torch.serving.qos import QOS_CLASSES

from torch_serving_parity import canon, frontend_state

pytestmark = pytest.mark.moe


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


def test_router_is_deterministic_and_total():
    a = moe.route_tokens("t0", 3, 7, 32, 4)
    b = moe.route_tokens("t0", 3, 7, 32, 4)
    assert a == b
    assert all(0 <= e < 4 for e in a)
    assert moe.route_tokens("t0", 4, 7, 32, 4) != a  # batch-dependent


def test_hot_expert_skews_the_matrix():
    """At 8x weight the hot expert draws the majority of a long batch
    — the data-dependent traffic matrix the campaign samples."""
    assignment = moe.route_tokens("t1", 0, 0, 400, 4, hot_expert=2,
                                  hot_factor=8)
    counts = {e: assignment.count(e) for e in range(4)}
    assert counts[2] > sum(v for e, v in counts.items() if e != 2)


def test_empty_splits_are_absent_streams():
    splits = moe.split_by_expert([1, 1, 3], 4)
    assert set(splits) == {1, 3}   # experts 0 and 2: no stream at all
    assert splits[1] == [0, 1] and splits[3] == [2]
    with pytest.raises(ValueError, match="unknown expert"):
        moe.split_by_expert([0, 9], 4)


def test_router_validation_is_loud():
    with pytest.raises(ValueError, match="hot_expert"):
        moe.route_tokens("t", 0, 0, 4, 4, hot_expert=4)
    with pytest.raises(ValueError, match="experts"):
        moe.route_tokens("t", 0, 0, 4, 0)
    with pytest.raises(ValueError, match="expert ids"):
        moe.expert_home(-1, 4)


# ---------------------------------------------------------------------------
# Scatter/gather bit-identity
# ---------------------------------------------------------------------------


def test_dispatch_gather_roundtrip_is_bit_identical():
    fe = ServingFrontend(4, seed=0)
    d = moe.MoeDispatcher(fe, experts=4, seed=0)
    batches = [
        d.dispatch("t0", "interactive", 4),
        d.dispatch("t1", "batch", 8),
        d.dispatch("t0", "best_effort", 12),
    ]
    for _ in range(8):
        fe.step()
    fe.drain()
    for b in batches:
        assert b.accepted
        assert d.gather(b) == b.tokens
    report = fe.report()
    assert report["lost_accepted"] == 0
    assert report["silent_corruptions"] == 0


def test_gather_of_a_shed_batch_is_none_not_garbage():
    from smi_tpu_torch.serving.qos import AdmissionRejected

    fe = ServingFrontend(4, seed=0)
    d = moe.MoeDispatcher(fe, experts=4, seed=0)
    b = d.dispatch("t0", "batch", 8)
    # simulate an aborted batch
    b.shed = AdmissionRejected("t0", "batch", 0, "tenant-rate")
    assert d.gather(b) is None


def test_base_rank_routes_to_the_expert_home():
    """The explicit base_rank extension: streams land at the expert's
    home rank, not the tenant hash — and None keeps the hash routing
    byte-for-byte."""
    fe = ServingFrontend(4, seed=0)
    fe.submit("tz", "batch", ("c0", "c1"), base_rank=3)
    assert fe.active[-1].dst == 3
    fe.submit("tz", "batch", ("c0", "c1"))
    assert fe.active[-1].dst == tenant_base_rank("tz", 4)
    with pytest.raises(ValueError, match="base_rank"):
        fe.submit("tz", "batch", ("c0",), base_rank=9)


def test_failover_keeps_the_expert_stream_and_the_batch():
    """A dead expert host mid-batch: the stream replays to the heir
    on a fresh epoch lane and the batch still reassembles
    bit-identically — the MoE path rides the front-end's failover
    unchanged."""
    fe = ServingFrontend(4, seed=0)
    d = moe.MoeDispatcher(fe, experts=4, seed=0)
    b = d.dispatch("t0", "best_effort", 12)
    assert b.accepted
    victims = {moe.expert_home(e, fe.n) for e in b.streams}
    victim = sorted(victims)[0]
    fe.step()
    fe.kill(victim)
    fe.drain()
    assert d.gather(b) == b.tokens
    report = fe.report()
    assert report["confirmed"] == [victim]
    assert report["lost_accepted"] == 0
    assert report["silent_corruptions"] == 0
    assert report["stale_epoch_leaks"] == 0


# ---------------------------------------------------------------------------
# Campaign cells
# ---------------------------------------------------------------------------


def test_uniform_cell_holds_its_gates():
    rep = moe.run_moe_cell(seed=0)
    assert rep["ok"], rep["verdict"]
    assert rep["cell"] == "moe"
    assert rep["reassembly_corruptions"] == 0
    assert rep["lost_accepted"] == 0


def test_hot_expert_cell_sheds_with_the_named_backpressure():
    """THE hot-expert acceptance cell: one expert at 8x routing
    weight saturates its home rank; the overflow surfaces as named
    ``backpressure:rank<h>`` shedding at the admission edge — zero
    silent corruption, zero lost-accepted, lowest-class-first
    brownout, no false death."""
    rep = moe.run_moe_cell(seed=0, hot_expert=1, batches_per_tick=0.75)
    assert rep["ok"], rep["verdict"]
    assert rep["cell"] == "moe-hot-expert"
    assert rep["batches_shed"] > 0
    assert rep["batch_shed_reasons"] == [
        f"backpressure:rank{rep['hot_rank']}"
    ]
    assert rep["confirmed"] == []
    assert rep["brownout_shed"]["interactive"] == 0
    assert rep["reassembly_corruptions"] == 0
    assert rep["lost_accepted"] == 0


def test_deferred_shed_is_named_never_silent_corruption():
    """A split PARKED at submit time and shed at pump time
    (admission-timeout / sustained brownout) marks its batch shed via
    the gate's on_shed hook — the batch gathers as None and the cell
    reports the loud named shed, never a bogus 'silent corruption'
    (the review repro: at 2x batch rate on a hot expert, parked
    splits time out while their siblings deliver)."""
    rep = moe.run_moe_cell(seed=18, hot_expert=2, batches_per_tick=2.0)
    assert rep["ok"], rep["verdict"]
    assert rep["reassembly_corruptions"] == 0
    assert "admission-timeout" in rep["batch_shed_reasons"]
    assert rep["orphaned_streams"] > 0   # siblings named, not hidden


def test_campaign_is_seed_deterministic_and_green():
    a = moe.moe_campaign(seed=3)
    b = moe.moe_campaign(seed=3)
    assert a == b
    assert a["ok"], a["failures"]
    assert set(a["outcomes"]) == {"moe", "moe-hot-expert"}
    assert a["silent_corruptions"] == 0
    assert a["lost_accepted"] == 0
    assert a["stale_epoch_leaks"] == 0


@pytest.mark.slow
def test_campaign_seed_sweep():
    for seed in range(16):
        rep = moe.moe_campaign(seed=seed)
        assert rep["ok"], (seed, rep["failures"])


def test_cell_duration_floor_is_loud():
    with pytest.raises(ValueError, match="minimum"):
        moe.run_moe_cell(duration=10)


def test_gate_accounting_covers_every_class():
    rep = moe.run_moe_cell(seed=1, hot_expert=0, batches_per_tick=0.75)
    assert set(rep["brownout_shed"]) == set(QOS_CLASSES)
    assert set(rep["backpressure_shed"]) == set(QOS_CLASSES)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Parity with the JAX package: the same seeds, the same reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args,kwargs", [
    (("t0", 3, 7, 32, 4), {}),
    (("t1", 0, 0, 400, 4), dict(hot_expert=2, hot_factor=8)),
    (("tenant-9", 11, 5, 64, 8), dict(hot_expert=7)),
])
def test_router_equals_the_jax_package_s(args, kwargs):
    from smi_tpu.serving import moe as JM

    routed = moe.route_tokens(*args, **kwargs)
    assert routed == JM.route_tokens(*args, **kwargs)
    assert moe.split_by_expert(routed, args[4]) == JM.split_by_expert(
        routed, args[4])
    assert [moe.expert_home(e, 4) for e in range(args[4])] == \
        [JM.expert_home(e, 4) for e in range(args[4])]


def test_dispatcher_run_equals_the_jax_package_s():
    """Batches dispatched by hand in both packages, an expert's home
    killed mid-batch: the same batches, gathers and front-end state."""
    from smi_tpu.serving import frontend as JFE
    from smi_tpu.serving import moe as JM

    runs = []
    for fe_cls, mod in ((ServingFrontend, moe), (JFE.ServingFrontend, JM)):
        fe = fe_cls(4, seed=0)
        d = mod.MoeDispatcher(fe, experts=4, seed=0)
        batches = [d.dispatch("t0", "interactive", 4),
                   d.dispatch("t1", "batch", 8),
                   d.dispatch("t0", "best_effort", 12)]
        fe.step()
        fe.kill(2)
        fe.drain()
        runs.append((
            canon([[b.tokens, b.assignment, sorted(b.streams.items()),
                    b.accepted, d.gather(b)]
                   for b in batches]),
            frontend_state(fe),
        ))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("kwargs", [
    dict(seed=0),
    dict(seed=0, hot_expert=1, batches_per_tick=0.75),
    dict(seed=18, hot_expert=2, batches_per_tick=2.0),
    dict(seed=1, hot_expert=0, batches_per_tick=0.75),
    dict(n=8, seed=4, experts=8, hot_expert=5),
], ids=["uniform", "hot", "deferred-shed", "hot-0", "n8"])
def test_moe_cell_equals_the_jax_package_s(kwargs):
    from smi_tpu.serving import moe as JM

    ours = moe.run_moe_cell(**kwargs)
    assert ours["ok"], ours["verdict"]
    assert canon(ours) == canon(JM.run_moe_cell(**kwargs))


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_moe_campaign_equals_the_jax_package_s(seed):
    from smi_tpu.serving import moe as JM

    assert canon(moe.moe_campaign(seed=seed)) == canon(JM.moe_campaign(
        seed=seed))

