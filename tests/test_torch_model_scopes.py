"""The port's model checker at the two widest default scopes.

The 3-stream admission scope and the inference scope of
``smi_tpu_torch.analysis.DEFAULT_SCOPES`` take tens of seconds each on
the CPU, so they exhaust here, on the port's side only, in a file of
their own (``tests/test_torch_model.py`` runs the rest of the grid, and
``tests/test_analysis.py`` runs them on the JAX package).
"""

import pytest

from smi_tpu_torch import analysis as A

pytestmark = pytest.mark.model

WIDE_SCOPES = [A.DEFAULT_SCOPES[1], A.DEFAULT_SCOPES[9]]


@pytest.mark.parametrize("scope", WIDE_SCOPES,
                         ids=[s.describe()[:40] for s in WIDE_SCOPES])
def test_model_clean_default_scopes(scope):
    """The scope exhausts (no truncation) with zero findings: every
    control-plane property holds on every reachable state."""
    report = A.check_scope(scope)
    assert report.ok, report.describe()
    assert not report.truncated, "default scope exceeded the budget"
    assert report.frontier == 0
    assert report.estimated_total == report.explored
    assert report.explored > 1
    assert report.properties == A.PROPERTIES
