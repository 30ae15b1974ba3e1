"""The port's control-plane model checker: the reference's cases.

``smi_tpu_torch/analysis/model.py`` and ``properties.py`` are the port's
copies of the JAX package's explicit-state model checker, which drives
the port's own membership, checkpoint, recovery, plan-cache and serving
objects over exhaustive small scopes. This file carries over the model
cases of ``tests/test_analysis.py`` against the port: the clean default
scopes (all but the two widest, which ``tests/test_torch_model_scopes.py``
runs on their own), every control-plane mutant's named minimal
counterexample, coverage reporting and scope parsing. The two cases the
reference marks slow (the mutants over the whole grid, a scope beyond
the grid) stay with the reference. ``tests/test_torch_model_parity.py``
holds the port to the JAX package scope for scope.
"""

import pytest

from smi_tpu_torch import analysis as A
from smi_tpu_torch.parallel import credits as C

pytestmark = pytest.mark.model

#: The designated scope per control-plane mutant — the grid entry
#: whose feature set (contention / kill) makes the defect reachable.
#: The full-grid exactly-one-finding sweep runs behind `slow`.
MODEL_MUTANT_SCOPE = {
    "leaked_stream_credit": A.DEFAULT_SCOPES[0],
    "skipped_aging": A.DEFAULT_SCOPES[1],
    "epoch_bump_without_void": A.DEFAULT_SCOPES[3],
    "heartbeat_after_confirm": A.DEFAULT_SCOPES[3],
    # the r14 plan-swap mutants need the retune scope (the swap
    # machine is inert everywhere else — benign by construction)
    "swap_without_quiesce": A.DEFAULT_SCOPES[5],
    "rollback_discards_entry": A.DEFAULT_SCOPES[5],
    # the r16 elasticity mutants need the migrate scope (the
    # migration arc and scale actuators are inert everywhere else)
    "cutover_without_handoff": A.DEFAULT_SCOPES[6],
    "scale_in_with_residents": A.DEFAULT_SCOPES[6],
    # the r17 partition mutants each need a specific cut shape: the
    # unfenced actuation is only WRONG where the reachable side is a
    # minority (n=2 — both sides are), and the stale-side accept only
    # collides with an heir where a quorate majority exists to fail
    # the cut rank over (n=3)
    "actuate_without_quorum": A.DEFAULT_SCOPES[7],
    "accept_in_minority": A.DEFAULT_SCOPES[8],
    # the r20 inference mutants need the infer scope (the KV-resident
    # generation arc is inert everywhere else)
    "decode_failover_without_kv_handoff": A.DEFAULT_SCOPES[9],
    "stale_kv_after_cutover": A.DEFAULT_SCOPES[9],
}



#: the default scopes this file exhausts: all but the two widest
#: (``WIDE_SCOPES``: the 3-stream admission scope and the inference
#: scope), which run alone in ``tests/test_torch_model_scopes.py``
WIDE_SCOPES = (1, 9)
NARROW_SCOPES = [s for i, s in enumerate(A.DEFAULT_SCOPES)
                 if i not in WIDE_SCOPES]


@pytest.mark.model
@pytest.mark.parametrize(
    "scope", NARROW_SCOPES,
    ids=[s.describe()[:40] for s in NARROW_SCOPES])
def test_model_clean_default_scopes(scope):
    """Every default scope exhausts (no truncation) with zero
    findings — all five control-plane properties hold on every
    reachable state, matching the campaign gates' clean sweeps."""
    report = A.check_scope(scope)
    assert report.ok, report.describe()
    assert not report.truncated, "default scope exceeded the budget"
    assert report.frontier == 0
    assert report.estimated_total == report.explored
    assert report.explored > 1
    assert report.properties == A.PROPERTIES



@pytest.mark.model
def test_model_scope_registry_is_consistent():
    assert set(A.MODEL_MUTANT_PROPERTY) == set(A.MODEL_MUTANTS)
    assert set(A.MODEL_MUTANT_PROPERTY.values()) <= set(A.PROPERTIES)
    assert set(MODEL_MUTANT_SCOPE) == set(A.MODEL_MUTANTS)


@pytest.mark.model
@pytest.mark.parametrize("mutant", A.MODEL_MUTANTS)
def test_model_mutants_yield_named_minimal_counterexamples(mutant):
    """Each control-plane mutant is convicted at its designated scope
    by EXACTLY its named property, with a minimal counterexample
    trace whose every step re-validates against a fresh world."""
    scope = MODEL_MUTANT_SCOPE[mutant]
    report = A.check_scope(
        scope, world_factory=A.model_mutant_world(mutant),
        mutant=mutant,
    )
    assert not report.ok, f"{mutant} not caught at {scope.describe()}"
    assert {f.property for f in report.findings} == {
        A.MODEL_MUTANT_PROPERTY[mutant]
    }
    finding = report.findings[0]
    assert finding.trace, "a counterexample must carry its trace"
    # the trace replays step-for-step on a fresh mutant world: every
    # action enabled where the trace uses it, and the final state
    # violating exactly the named property
    world = A.model_mutant_world(mutant)(scope)
    from smi_tpu_torch.analysis.properties import check_state

    for action in finding.trace:
        assert tuple(action) in world.enabled_actions(), action
        world.apply(tuple(action))
    assert {p for p, _ in check_state(world)} == {finding.property}


@pytest.mark.model
def test_model_counterexample_is_minimal():
    """BFS order: no strictly shorter trace reaches a violation. The
    zombie-heartbeat conviction needs admit+kill+heartbeat — three
    steps, and the checker reports exactly three."""
    report = A.check_scope(
        MODEL_MUTANT_SCOPE["heartbeat_after_confirm"],
        world_factory=A.model_mutant_world("heartbeat_after_confirm"),
        mutant="heartbeat_after_confirm",
    )
    assert len(report.findings[0].trace) == 3
    kinds = [a[0] for a in report.findings[0].trace]
    assert kinds == ["admit", "kill", "heartbeat"]


@pytest.mark.model
def test_model_migration_counterexamples_are_minimal():
    """The r16 convictions are BFS-minimal too: losing delivered state
    across a premature cutover needs a delivery first (admit -> send ->
    heartbeat -> consume) then the two-step arc; stranding residents
    needs only an admit before the bad scale-in."""
    report = A.check_scope(
        MODEL_MUTANT_SCOPE["cutover_without_handoff"],
        world_factory=A.model_mutant_world("cutover_without_handoff"),
        mutant="cutover_without_handoff",
    )
    kinds = [a[0] for a in report.findings[0].trace]
    assert kinds == ["admit", "send", "heartbeat", "consume",
                     "mig_propose", "mig_cutover"]

    report = A.check_scope(
        MODEL_MUTANT_SCOPE["scale_in_with_residents"],
        world_factory=A.model_mutant_world("scale_in_with_residents"),
        mutant="scale_in_with_residents",
    )
    kinds = [a[0] for a in report.findings[0].trace]
    assert kinds == ["admit", "scale_in"]


@pytest.mark.model
def test_model_partition_counterexamples_are_minimal():
    """The r17 convictions are BFS-minimal: an unfenced failover is
    wrong the moment it fires from a minority census (cut -> actuate,
    two steps), and the split-brain needs the majority's legitimate
    failover between the cut and the stale-side accept."""
    report = A.check_scope(
        MODEL_MUTANT_SCOPE["actuate_without_quorum"],
        world_factory=A.model_mutant_world("actuate_without_quorum"),
        mutant="actuate_without_quorum",
    )
    kinds = [a[0] for a in report.findings[0].trace]
    assert kinds == ["partition_start", "partition_failover"]

    report = A.check_scope(
        MODEL_MUTANT_SCOPE["accept_in_minority"],
        world_factory=A.model_mutant_world("accept_in_minority"),
        mutant="accept_in_minority",
    )
    kinds = [a[0] for a in report.findings[0].trace]
    assert kinds == ["partition_start", "partition_failover",
                     "minority_accept"]


@pytest.mark.model
def test_model_truncation_warns_and_reports_coverage():
    """A budget that cuts the BFS short is never silent: the report
    says truncated with explored/frontier/estimated_total (the
    machine-readable half of "no silent caps"), AND a RuntimeWarning
    fires for interactive callers."""
    scope = A.DEFAULT_SCOPES[1]
    with pytest.warns(RuntimeWarning, match="truncated the scope"):
        report = A.check_scope(scope, budget=50)
    assert report.truncated
    assert report.explored == 50
    assert report.frontier > 0
    assert report.estimated_total == report.explored + report.frontier
    payload = A.model_reports_to_json([report])
    assert payload["coverage"]["truncated"] is True
    assert payload["scopes"][0]["truncated"] is True
    assert payload["scopes"][0]["estimated_total"] > 50


@pytest.mark.model
def test_model_complete_run_reports_full_coverage():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a complete run must NOT warn
        report = A.check_scope(A.DEFAULT_SCOPES[2])
    assert not report.truncated and report.frontier == 0


@pytest.mark.model
def test_schedule_count_to_json_carries_coverage():
    """The explore_all_schedules satellite: truncation coverage is a
    first-class JSON payload, not a RuntimeWarning only."""

    def make():
        return A.build_generators("all_reduce", n=3)

    with pytest.warns(RuntimeWarning):
        count = C.explore_all_schedules(make, max_schedules=10,
                                        allow_budget=True)
    payload = count.to_json()
    assert payload == {
        "explored": 10,
        "truncated": True,
        "frontier": count.frontier,
        "estimated_total": 10 + count.frontier,
    }
    full = C.explore_all_schedules(
        lambda: A.build_generators("all_reduce", n=2),
        max_schedules=500_000, allow_budget=True,
    )
    assert full.to_json()["truncated"] is False
    assert full.to_json()["estimated_total"] == full.explored


@pytest.mark.model
def test_parse_scope_is_loud():
    s = A.parse_scope("tenants=2, ranks=1, kill=0")
    assert s.tenants == 2 and s.ranks == 1
    with pytest.raises(ValueError, match="unknown scope key"):
        A.parse_scope("tenant=2")
    with pytest.raises(ValueError, match="not an integer"):
        A.parse_scope("tenants=two")
    with pytest.raises(ValueError, match="small-scope"):
        A.parse_scope("tenants=9")
    with pytest.raises(ValueError, match="last member"):
        A.parse_scope("ranks=1,kill=1")
    with pytest.raises(ValueError, match="confirmation grace"):
        A.parse_scope("silence=7")


@pytest.mark.model
def test_model_symmetry_reduction_merges_orbits():
    """Two tenants of the same class/quota on symmetric ranks are
    interchangeable: the canonical space of a symmetric scope must be
    well below the raw interleaving count (the 3-tenant admission
    scope would blow past thousands of raw states)."""
    report = A.check_scope(A.DEFAULT_SCOPES[0])
    assert report.explored < 1000, report.explored


@pytest.mark.model
def test_model_symmetry_never_crosses_qos_classes():
    """Soundness regression: a tenant permutation that would swap
    tenants of DIFFERENT QoS classes is not an isomorphism (future
    admissions draw their class from the raw tenant index), so the
    states 'interactive tenant done' and 'best_effort tenant done'
    must keep distinct fingerprints — merging them would prune
    class-specific arcs (e.g. best_effort brownout) from a sweep that
    claims exhaustiveness."""
    scope = A.DEFAULT_SCOPES[0]  # tenants=3: one tenant per class

    def after_completing(tenant):
        world = A.World(scope)
        for action in [("admit", tenant), ("send", tenant % 2),
                       ("heartbeat",), ("consume", tenant % 2)]:
            assert action in world.enabled_actions(), action
            world.apply(action)
        assert not world.active  # the stream completed
        return world.fingerprint()

    assert after_completing(0) != after_completing(2)



@pytest.mark.model
def test_wide_scope_split_covers_the_default_grid():
    """The narrow scopes here and the wide ones in
    ``tests/test_torch_model_scopes.py`` are the default grid, whole."""
    assert len(NARROW_SCOPES) + len(WIDE_SCOPES) == len(A.DEFAULT_SCOPES)
    assert A.DEFAULT_SCOPES[1].streams == 3 and A.DEFAULT_SCOPES[9].infer
