"""The port's model checker against the JAX package's, scope for scope.

Both packages' checkers run the same control-plane scopes over their own
serving, membership, checkpoint, recovery and plan-cache objects (pure
Python), so the tolerance is "equal": each scope's report byte-equal as
sorted-key JSON (states explored, frontier, findings), and each
control-plane mutant's minimal counterexample equal step for step. The
two widest default scopes (tens of seconds each) are left to
``tests/test_analysis.py`` on the JAX side and
``tests/test_torch_model_scopes.py`` on the port's.
"""

import json

import pytest

from smi_tpu import analysis as JA
from smi_tpu_torch import analysis as A

pytestmark = pytest.mark.model

#: the default scopes held equal here: all but the two widest
PARITY_SCOPES = [i for i in range(len(A.DEFAULT_SCOPES)) if i not in (1, 9)]


def _canon(payload) -> str:
    return json.dumps(payload, sort_keys=True, default=str)


def test_scope_grids_and_property_tables_are_the_jax_package_s():
    assert [s.describe() for s in A.DEFAULT_SCOPES] == \
        [s.describe() for s in JA.DEFAULT_SCOPES]
    assert A.PROPERTIES == JA.PROPERTIES
    assert A.MODEL_MUTANTS == JA.MODEL_MUTANTS
    assert A.MODEL_MUTANT_PROPERTY == JA.MODEL_MUTANT_PROPERTY


@pytest.mark.parametrize("index", PARITY_SCOPES,
                         ids=[A.DEFAULT_SCOPES[i].describe()[:40]
                              for i in PARITY_SCOPES])
def test_clean_scope_report_equals_the_jax_package_s(index):
    ours = A.check_scope(A.DEFAULT_SCOPES[index])
    theirs = JA.check_scope(JA.DEFAULT_SCOPES[index])
    assert ours.explored == theirs.explored
    assert _canon(A.model_reports_to_json([ours])) == \
        _canon(JA.model_reports_to_json([theirs]))
    assert A.render_model_reports([ours]) == \
        JA.render_model_reports([theirs])


#: each control-plane mutant at the scope that convicts it (the
#: reference's ``MODEL_MUTANT_SCOPE``)
MUTANT_SCOPE_INDEX = {
    "leaked_stream_credit": 0, "skipped_aging": 1,
    "epoch_bump_without_void": 3, "heartbeat_after_confirm": 3,
    "swap_without_quiesce": 5, "rollback_discards_entry": 5,
    "cutover_without_handoff": 6, "scale_in_with_residents": 6,
    "actuate_without_quorum": 7, "accept_in_minority": 8,
    "decode_failover_without_kv_handoff": 9, "stale_kv_after_cutover": 9,
}


@pytest.mark.parametrize("mutant", A.MODEL_MUTANTS)
def test_mutant_counterexample_equals_the_jax_package_s(mutant):
    """The same minimal counterexample, action for action, and the same
    report, in both packages."""
    index = MUTANT_SCOPE_INDEX[mutant]
    ours = A.check_scope(A.DEFAULT_SCOPES[index],
                         world_factory=A.model_mutant_world(mutant),
                         mutant=mutant)
    theirs = JA.check_scope(JA.DEFAULT_SCOPES[index],
                            world_factory=JA.model_mutant_world(mutant),
                            mutant=mutant)
    assert not ours.ok and ours.findings
    assert [list(map(tuple, f.trace)) for f in ours.findings] == \
        [list(map(tuple, f.trace)) for f in theirs.findings]
    assert _canon(A.model_reports_to_json([ours])) == \
        _canon(JA.model_reports_to_json([theirs]))


def test_parse_scope_and_world_fingerprints_equal_the_jax_package_s():
    """A scope parsed from the same text, and the fingerprints of a
    world walked through the same actions, in both packages."""
    text = "tenants=2, ranks=2, kill=1, consume=1"
    assert A.parse_scope(text).describe() == JA.parse_scope(text).describe()
    scope, jscope = A.DEFAULT_SCOPES[3], JA.DEFAULT_SCOPES[3]
    world, jworld = A.World(scope), JA.World(jscope)
    for _ in range(12):
        actions = sorted(world.enabled_actions(), key=repr)
        assert actions == sorted(jworld.enabled_actions(), key=repr)
        assert repr(world.fingerprint()) == repr(jworld.fingerprint())
        if not actions:
            break
        world.apply(actions[-1])
        jworld.apply(actions[-1])
