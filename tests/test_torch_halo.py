"""smi_tpu_torch on a real multi-rank grid: gloo process groups on CPU.

Each case spawns one process per rank (``tests/torch_gloo_worker.py``,
which imports no jax). Every rank checks its 1-deep, 2-deep and k-deep
halo slabs — corners included — against the zero-padded global grid;
rank 0 returns the gathered results of the plain, overlapped, fused and
temporal stencil tiers and of ``run_stencil``, which are held
``array_equal`` to the JAX package on the same mesh shape (its Pallas
kernels in interpret mode) and to the serial numpy reference.
"""

import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import smi_tpu as smi
from smi_tpu.kernels import stencil as kstencil
from smi_tpu.kernels import stencil_temporal as ktemporal
from smi_tpu.models import stencil

# spawned children import the worker by module name through this path
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_gloo_worker  # noqa: E402


def _run_group(shape, grid, halo_grid, iterations, depth):
    """Spawn the ranks; rank 0's report (the gathered tiers)."""
    return torch_gloo_worker.run_group(
        torch_gloo_worker.run, math.prod(shape),
        (shape, grid, halo_grid, iterations, depth))[0]


@pytest.mark.parametrize(
    "shape,h,w,iters,depth",
    [
        ((2, 2), 64, 512, 32, 16),   # two k=16 passes, no remainder
        ((2, 4), 64, 1024, 20, 8),   # two k=8 passes + 4 single sweeps
    ],
)
def test_gloo_grid_matches_jax_and_reference(eight_devices, shape, h, w,
                                             iters, depth):
    g = stencil.initial_grid(h, w)
    g[:, -1] = 2.0
    g[h // 2, :] = 0.5
    probe = np.random.default_rng(7).random((h, w), dtype=np.float32)
    out = _run_group(shape, g, probe, iters, depth)

    comm = smi.make_communicator(shape=shape, axis_names=("sx", "sy"),
                                 devices=eight_devices[:math.prod(shape)])
    ref = stencil.reference_stencil(g, iters)
    gj = jnp.asarray(g)
    jax_out = {
        "plain": stencil.make_stencil_fn(comm, iters)(gj),
        "overlapped": stencil.make_stencil_fn(comm, iters, overlap=True)(gj),
        "fused": kstencil.make_fused_stencil_fn(comm, iters, h, w,
                                                interpret=True)(gj),
        "temporal": ktemporal.make_temporal_stencil_fn(
            comm, iters, h, w, depth=depth, interpret=True)(gj),
    }
    jax_out["run_stencil"] = jax_out["plain"]
    for name, got in out.items():
        assert got.dtype == np.float32, name
        np.testing.assert_array_equal(got, np.asarray(jax_out[name]),
                                      err_msg=f"{name} vs JAX")
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} vs ref")
