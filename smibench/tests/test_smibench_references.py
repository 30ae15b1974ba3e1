"""The plain references against grids and clusters worked by hand."""

import pytest
import torch

from smibench import spec

stencil = spec.load_module("references", "stencil_smi-8192")


def test_one_sweep_of_a_4x4_grid_by_hand():
    g = torch.tensor([[1.0, 1.0, 1.0, 2.0],
                      [0.0, 4.0, 8.0, 2.0],
                      [0.0, 0.0, 16.0, 2.0],
                      [0.0, 0.0, 0.0, 2.0]])
    out = stencil.jacobi(g, 1)
    # (1,1): (up 1 + down 0 + left 0 + right 8) / 4; (1,2): (1+16+4+2)/4
    # (2,1): (4+0+0+16)/4; (2,2): (8+0+0+2)/4; the edge is held
    expect = g.clone()
    expect[1, 1], expect[1, 2] = 2.25, 5.75
    expect[2, 1], expect[2, 2] = 5.0, 2.5
    assert torch.equal(out, expect)


def test_two_sweeps_use_the_previous_sweep_only():
    g = torch.zeros(3, 4)
    g[0, :] = 4.0
    once = stencil.jacobi(g, 1)
    assert once[1, 1].item() == 1.0 and once[1, 2].item() == 1.0
    twice = stencil.jacobi(g, 2)
    assert twice[1, 1].item() == 1.25   # (4 + 0 + 0 + 1) / 4


def test_lower_precision_differs_and_returns_float32():
    g = stencil.make_grid(32, 32, 5, "cpu")
    low = stencil.jacobi(g, 50, torch.bfloat16)
    assert low.dtype == torch.float32
    assert stencil.max_abs_err(low, stencil.jacobi(g, 50)) > 1e-3


def test_made_grid_is_seeded_with_the_classic_edge():
    a = stencil.make_grid(16, 8, 2**31 + 5, "cpu")
    assert torch.equal(a, stencil.make_grid(16, 8, 2**31 + 5, "cpu"))
    assert not torch.equal(a, stencil.make_grid(16, 8, 6, "cpu"))
    assert a[0, :-1].eq(1.0).all() and a[:, -1].eq(2.0).all()
    assert a[-1, :-1].eq(0.0).all() and a[1:, 0].eq(0.0).all()
    assert ((a[1:-1, 1:-1] >= 0) & (a[1:-1, 1:-1] < 1)).all()


def test_max_abs_err_of_a_wrong_shape_is_infinite():
    assert stencil.max_abs_err(torch.zeros(2, 3), torch.zeros(3, 2)) == \
        float("inf")

