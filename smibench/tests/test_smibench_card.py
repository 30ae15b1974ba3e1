"""Whole runs on the card at reduced sizes (marked ``gpu``; they skip
without one): the kernels build and run, the trace shows them, the
readers read them, the sound program is correct and the control not."""

import pytest

from smibench import harness

#: reduced sizes that still run both stencil kernels
CARD = {
    "stencil-1x1": {"config": {"X": 2048, "Y": 2048, "sweeps": 35}},
}
SEED = 2**31 + 2024


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CARD))
def test_traced_run_on_the_card(cell, cuda_device):
    result = harness.run_cell(cell, SEED, 0.5, True, cuda_device,
                              overrides=CARD[cell])
    assert result["correct"], result["checks"]
    device = result["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    assert 0 < device["busy_s"] <= device["window_s"]
    metrics = result["metrics"]
    assert metrics["stencil_launches_per_solve"]["value"] == 5
    assert 0 < metrics["ksweep_roofline"]["value"] <= 105
    assert 0 <= metrics["device_idle_pct.stencil"]["value"] < 100


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CARD))
def test_control_on_the_card_is_not_correct(cell, cuda_device):
    result = harness.run_cell(cell, SEED, 0.0, False, cuda_device,
                              overrides=CARD[cell], program="control")
    assert not result["correct"], result["checks"]
