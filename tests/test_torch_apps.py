"""The port's SMI applications against the JAX package's and the serial
references, at the tolerances of ``tests/test_apps.py``: k-means on 8
ranks, GESUMMV on 2, both tiers, and the 2x4 stencil over the ring tier.
The worlds are CPU ``LocalWorld``s (threads); on CPU tensors the ring
tier's wrappers run their plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.models import gesummv as jgesummv
from smi_tpu.models import kmeans as jkmeans
from smi_tpu.models import stencil as jstencil
from smi_tpu_torch.kernels import _build

BACKENDS = ["xla", "ring"]


def _points(n=1024, k=4, dims=2, seed=0):
    rng = np.random.RandomState(seed)
    centres = rng.rand(k, dims).astype(np.float32) * 10
    pts = (centres[rng.randint(0, k, n)]
           + rng.randn(n, dims).astype(np.float32) * 0.3)
    pts = pts.astype(np.float32)
    return pts, pts[:k].copy()


@pytest.mark.parametrize("backend", BACKENDS)
def test_kmeans_matches_jax_and_the_serial_reference(eight_devices, backend):
    points, init = _points()
    world = st.LocalWorld(8, device="cpu")
    before = dict(_build.LAUNCHES)
    out = st.run_kmeans(points, init, 10, world=world,
                        backend=backend).numpy()
    assert _build.LAUNCHES == before   # CPU tensors launch nothing
    ref = st.reference_kmeans(points, init, 10)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    want = np.asarray(jkmeans.run_kmeans(points, init, 10,
                                         devices=eight_devices))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ref, jkmeans.reference_kmeans(points,
                                                                init, 10))


def test_kmeans_pieces_match_jax(eight_devices):
    points, init = _points(n=64)
    np.testing.assert_array_equal(
        st.assign_points(torch.from_numpy(points),
                         torch.from_numpy(init)).numpy(),
        np.asarray(jkmeans.assign_points(jnp.asarray(points),
                                         jnp.asarray(init))))
    # one iteration on one rank is the serial update
    world = st.LocalWorld(1, device="cpu")
    one = world.run(lambda c: st.kmeans_iteration(
        torch.from_numpy(points), torch.from_numpy(init), c))[0]
    np.testing.assert_allclose(one.numpy(),
                               st.reference_kmeans(points, init, 1),
                               rtol=1e-5, atol=1e-5)


def test_kmeans_indivisible_points_rejected():
    points, init = _points(n=1001)
    with pytest.raises(ValueError, match="not divisible"):
        st.run_kmeans(points, init, 2, world=st.LocalWorld(8, device="cpu"))


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("backend", BACKENDS)
def test_gesummv_matches_jax_and_the_reference(eight_devices, backend, n):
    rng = np.random.RandomState(n)
    a = rng.rand(n, n).astype(np.float32)
    b = rng.rand(n, n).astype(np.float32)
    x = rng.rand(n).astype(np.float32)
    world = st.LocalWorld(2, device="cpu")
    out = st.run_gesummv(a, b, x, alpha=1.5, beta=0.5, world=world,
                         backend=backend).numpy()
    ref = st.reference_gesummv(a, b, x, alpha=1.5, beta=0.5)
    np.testing.assert_allclose(out, ref, rtol=2e-4)
    want = np.asarray(jgesummv.run_gesummv(a, b, x, alpha=1.5, beta=0.5,
                                           devices=eight_devices))
    np.testing.assert_allclose(out, want, rtol=2e-4)
    np.testing.assert_array_equal(
        ref, jgesummv.reference_gesummv(a, b, x, alpha=1.5, beta=0.5))


def test_gesummv_streams_in_chunks_of_its_buffer():
    """A small buffer cuts the result into several chunks, each folded by
    the axpy consumer; the sum is the same."""
    n = 128
    rng = np.random.RandomState(1)
    a, b = rng.rand(2, n, n).astype(np.float32)
    x = rng.rand(n).astype(np.float32)
    world = st.LocalWorld(2, device="cpu")
    ab = np.stack([a, b])
    outs = [st.make_gesummv_fn(world, n, 2.0, 0.25, buffer_size=bs,
                               backend=be)(ab, x).numpy()
            for bs in (7, 2048) for be in BACKENDS]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    np.testing.assert_allclose(outs[0],
                               st.reference_gesummv(a, b, x, 2.0, 0.25),
                               rtol=2e-4)


def test_gesummv_wrong_rank_count():
    with pytest.raises(ValueError, match="exactly 2 ranks"):
        st.make_gesummv_fn(st.LocalWorld(4, device="cpu"), 8, 1.0, 1.0)


@pytest.mark.parametrize("overlap", [False, True])
def test_stencil_on_the_2x4_world_over_the_ring_tier(eight_devices, overlap):
    g = st.initial_grid(32, 64)
    g[:, -1] = 2.0
    g[16, :] = 0.5
    iters = 6
    world = st.LocalWorld((2, 4), ("sx", "sy"), device="cpu")

    def run(backend):
        return world.run(lambda c: st.grid_to_numpy(
            st.make_stencil_fn(c, iters, backend=backend, overlap=overlap)(
                st.block_from_numpy(g, c)), c))

    ring, xla = run("ring"), run("xla")
    ref = st.reference_stencil(g, iters)
    for r in range(8):
        np.testing.assert_array_equal(ring[r], ref)
        np.testing.assert_array_equal(xla[r], ref)
    if overlap:
        return
    # and to the JAX package over its ring tier (interpreted kernels)
    comm = smi.make_communicator(shape=(2, 4), axis_names=("sx", "sy"),
                                 devices=eight_devices)
    want = np.asarray(jstencil.make_stencil_fn(comm, iters, backend="ring")(
        jnp.asarray(g)))
    np.testing.assert_array_equal(ring[0], want)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_halo_exchange_over_the_ring_tier_equals_the_xla_tier(ring, depth):
    world = st.LocalWorld((2, 4), ("sx", "sy"), device="cpu")
    g = np.random.default_rng(depth).random((16, 32), dtype=np.float32)

    def halos(backend):
        def fn(c):
            block = st.block_from_numpy(g, c)
            return (tuple(st.halo_exchange_2d(block, c, depth=depth,
                                              ring=ring, backend=backend))
                    + tuple(st.halo_exchange_2d_corners(
                        block, c, depth=depth, ring=ring, backend=backend)))
        return world.run(fn)

    for got, want in zip(halos("ring"), halos("xla")):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
