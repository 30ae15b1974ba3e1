"""``correct`` on the CPU at a tiny size: true for the sound program,
false for the control (the lower-precision reference in the program's
place) and for each fault a cell can have, planted in the program under
a whole run of the harness (the look for a card skipped)."""

import itertools

import pytest
import torch

from smibench import harness
from smibench.tests.conftest import TINY

SEED = 2**31 + 101


def _run(cell, program="port", seed=SEED):
    return harness.run_cell(cell, seed, 0.0, False, "cpu",
                            overrides=TINY[cell], program=program)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_program_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    result = _run(cell, program="control")
    assert not result["correct"], result["checks"]


# -- the stencil's faults ------------------------------------------------

def _stencil_modules():
    from smi_tpu_torch.kernels import stencil as kstencil
    from smi_tpu_torch.kernels import stencil_temporal as kt

    return kt, kstencil


def test_stencil_step_that_returns_its_state(monkeypatch):
    kt, kstencil = _stencil_modules()
    monkeypatch.setattr(kt, "temporal_pass",
                        lambda block, comm, gh, gw, depth=8: block)
    monkeypatch.setattr(kstencil, "jacobi_step_block_fused",
                        lambda block, comm, gh, gw: block)
    assert not _run("stencil-1x1")["correct"]


def test_stencil_answer_altered_where_produced(monkeypatch):
    kt, _ = _stencil_modules()
    sweeps = kt.temporal_sweeps

    def altered(*args, **kwargs):
        out = sweeps(*args, **kwargs)
        out.view(-1)[out.numel() // 2] += 2.0 ** -20
        return out

    monkeypatch.setattr(kt, "temporal_sweeps", altered)
    assert not _run("stencil-1x1")["correct"]


#: the stencil cell's traffic on the upstream 2x4 grid of rank threads:
#: the driver's path for a multi-rank cell, with its halo exchange
GRID_2X4 = {"config": TINY["stencil-1x1"]["config"],
            "traffic": {"grid": [2, 4]}}


def _run_2x4(program="port"):
    return harness.run_cell("stencil-1x1", SEED, 0.0, False, "cpu",
                            overrides=GRID_2X4, program=program)


def test_stencil_on_rank_threads_is_correct():
    result = _run_2x4()
    assert result["correct"], result["checks"]
    assert not _run_2x4(program="control")["correct"]


def test_stencil_exchange_left_out(monkeypatch):
    from smi_tpu_torch.parallel.halo import Halos

    kt, _ = _stencil_modules()
    finish = kt.halo_exchange_2d_corners_finish

    def without_neighbours(exchange):
        h = finish(exchange)
        return Halos(top=torch.zeros_like(h.top),
                     bottom=torch.zeros_like(h.bottom),
                     left=torch.zeros_like(h.left),
                     right=torch.zeros_like(h.right))

    monkeypatch.setattr(kt, "halo_exchange_2d_corners_finish",
                        without_neighbours)
    assert not _run_2x4()["correct"]


def test_stencil_half_the_ranks_left_out(monkeypatch):
    kt, kstencil = _stencil_modules()
    passes, sweep = kt.temporal_pass, kstencil.jacobi_step_block_fused

    def half(step):
        def run(block, comm, *args, **kwargs):
            out = step(block, comm, *args, **kwargs)
            return out if comm.coords[0] == 0 else block
        return run

    monkeypatch.setattr(kt, "temporal_pass", half(passes))
    monkeypatch.setattr(kstencil, "jacobi_step_block_fused", half(sweep))
    assert not _run_2x4()["correct"]


# -- a solve that fails -------------------------------------------------

def test_a_failed_solve_is_counted_and_not_correct(monkeypatch):
    kt, _ = _stencil_modules()
    sweeps = kt.temporal_sweeps
    calls = itertools.count()
    warm = 2   # set-up's two solves, one k-sweep call each

    def fails_in_the_window(*args, **kwargs):
        if next(calls) >= warm:
            raise RuntimeError("planted")
        return sweeps(*args, **kwargs)

    monkeypatch.setattr(kt, "temporal_sweeps", fails_in_the_window)
    result = _run("stencil-1x1")
    assert (result["attempted"], result["failed"]) == (1, 1)
    assert not result["correct"] and result["metrics"] == {}
