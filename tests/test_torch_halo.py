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
import multiprocessing as mp
import queue
import socket
import sys
import time
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

#: wall-clock budget of one spawned group, well inside the 300 s watchdog
JOIN_TIMEOUT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(shape, grid, halo_grid, iterations, depth):
    """Spawn the ranks, collect every report, join them all."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    world = math.prod(shape)
    port = _free_port()
    procs = [
        ctx.Process(
            target=torch_gloo_worker.run,
            args=(r, world, port, shape, grid, halo_grid, iterations, depth,
                  results),
        )
        for r in range(world)
    ]
    for p in procs:
        p.start()
    try:
        reports = {}
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while len(reports) < world:
            left = deadline - time.monotonic()
            try:
                rank, status, payload = results.get(timeout=max(left, 1))
            except queue.Empty:
                pytest.fail(f"{world - len(reports)} rank(s) did not report "
                            f"within {JOIN_TIMEOUT_S} s")
            if status != "ok":
                pytest.fail(f"rank {rank} failed:\n{payload}")
            reports[rank] = payload
        for p in procs:
            p.join(timeout=30)
        assert [p.exitcode for p in procs] == [0] * world
        return reports[0]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


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
