"""smi_tpu_torch's communicator, halo helpers and plain stencil against the
JAX package, on CPU tensors in one process (a 1x1 rank grid).

The same seeded float32 numpy grids go through ``smi_tpu.models.stencil``
on the 8-device fake mesh and through the port; the bar is
``np.array_equal``, since both packages keep the operand order
up + down + left + right, then x0.25. Multi-rank grids run under gloo in
``test_torch_halo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.models import stencil
from smi_tpu.parallel import halo as jhalo
from smi_tpu_torch.models import stencil as tstencil


def _grid(h, w):
    g = stencil.initial_grid(h, w)
    g[:, -1] = 2.0
    g[h // 2, :] = 0.5
    return g


@pytest.fixture
def comm11():
    return st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                device="cpu")


# ---------------------------------------------------------- communicator --


def test_communicator_one_rank_grid(comm11):
    assert comm11.shape == (1, 1) and comm11.size == 1
    assert comm11.axis_sizes == (1, 1)
    assert comm11.coords == (0, 0) and comm11.rank == 0
    assert comm11.device == torch.device("cpu")
    assert comm11.groups is None  # no process group at 1x1
    assert comm11.neighbour("sx", +1) is None
    assert comm11.neighbour("sy", -1, ring=True) == 0


def test_communicator_default_axes_match_jax():
    one = st.make_communicator(device="cpu")
    assert one.axis_names == (smi.make_communicator(1).axis_names)
    two = st.make_communicator(shape=(1, 1), device="cpu")
    assert two.axis_names == ("smi0", "smi1")


def test_communicator_rejects_a_grid_larger_than_the_world():
    with pytest.raises(ValueError, match="needs 8 ranks"):
        st.make_communicator(shape=(2, 4), device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        st.make_communicator(shape=(1, 1), axis_names=("x",), device="cpu")
    with pytest.raises(ValueError, match="not in communicator axes"):
        st.make_communicator(device="cpu").neighbour("nope", 1)


def test_row_major_rank_layout_matches_jax_mesh():
    from smi_tpu_torch.parallel import mesh as tmesh

    shape = (2, 4)
    jax_ranks = np.arange(8).reshape(shape)  # Mesh devices, row-major
    for r in range(8):
        assert tmesh._unravel(r, shape) == tuple(
            int(i) for i in np.argwhere(jax_ranks == r)[0])
        assert tmesh._ravel(tmesh._unravel(r, shape), shape) == r
    assert tmesh._axis_lines(shape, 0) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert tmesh._axis_lines(shape, 1) == [[0, 1, 2, 3], [4, 5, 6, 7]]


# ------------------------------------------------------------------ halo --


def test_one_rank_halos_are_zero_and_send_nothing(comm11):
    block = torch.from_numpy(np.random.default_rng(0).random(
        (8, 12), dtype=np.float32))
    halos = st.halo_exchange_2d(block, comm11, depth=2)
    assert [tuple(t.shape) for t in halos] == [(2, 12), (2, 12), (8, 2),
                                               (8, 2)]
    assert all(not t.any() for t in halos)
    split = st.halo_exchange_finish(st.halo_exchange_start(block, comm11,
                                                           depth=2))
    assert all(torch.equal(a, b) for a, b in zip(halos, split))
    corners = st.halo_exchange_2d_corners(block, comm11, depth=3)
    assert [tuple(t.shape) for t in corners] == [(3, 18), (3, 18), (8, 3),
                                                 (8, 3)]
    assert all(not t.any() for t in corners)


def test_one_rank_shift_wraps_only_with_ring(comm11):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert not st.shift_along(x, comm11, "sx", +1).any()
    assert torch.equal(st.shift_along(x, comm11, "sy", -1, ring=True), x)
    with pytest.raises(ValueError, match="direction"):
        st.shift_along(x, comm11, "sx", 2)


def test_ring_backend_is_not_ported_yet(comm11):
    block = torch.zeros(4, 4)
    # on a process-group communicator: the ring tier's kernels play the
    # ranks of a LocalWorld, and say so
    with pytest.raises(NotImplementedError, match="LocalWorld"):
        st.halo_exchange_2d(block, comm11, backend="ring")
    with pytest.raises(NotImplementedError, match="LocalWorld"):
        st.jacobi_step_block(block, comm11, backend="ring")
    with pytest.raises(ValueError, match="unknown backend"):
        st.shift_along(block, comm11, "sx", 1, backend="nccl")


@pytest.mark.parametrize("depth,corners", [(1, False), (2, False), (2, True),
                                           (3, True)])
def test_pad_with_halos_matches_jax(depth, corners):
    rng = np.random.default_rng(depth)
    h, w, d = 6, 10, depth
    block = rng.random((h, w), dtype=np.float32)
    tw = w + 2 * d if corners else w
    slabs = [rng.random(s, dtype=np.float32)
             for s in ((d, tw), (d, tw), (h, d), (h, d))]
    want = jhalo.pad_with_halos(jnp.asarray(block),
                                jhalo.Halos(*map(jnp.asarray, slabs)),
                                depth=d)
    got = st.pad_with_halos(torch.from_numpy(block),
                            st.Halos(*map(torch.from_numpy, slabs)), depth=d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------- stencil --


@pytest.mark.parametrize("h,w,iters", [(8, 16, 3), (16, 32, 5),
                                       (32, 256, 8), (64, 512, 20)])
@pytest.mark.parametrize("overlap", [False, True])
def test_make_stencil_fn_matches_jax_and_reference(eight_devices, comm11, h,
                                                   w, iters, overlap):
    g = _grid(h, w)
    ref = stencil.reference_stencil(g, iters)
    got = st.make_stencil_fn(comm11, iters, overlap=overlap)(
        st.block_from_numpy(g, comm11)).numpy()
    np.testing.assert_array_equal(got, ref)
    for shape in ((1, 1), (2, 4)):
        jcomm = smi.make_communicator(
            shape=shape, axis_names=("sx", "sy"),
            devices=eight_devices[:shape[0] * shape[1]])
        want = stencil.make_stencil_fn(jcomm, iters, overlap=overlap)(
            jnp.asarray(g))
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("overlap", [False, True])
def test_single_step_matches_jax_step(eight_devices, comm11, overlap):
    """One step through the block-level entry points of both packages."""
    g = np.random.default_rng(3).random((16, 24), dtype=np.float32)
    jcomm = smi.make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                  devices=eight_devices[:1])
    jstep = (stencil.jacobi_step_block_overlapped if overlap
             else stencil.jacobi_step_block)
    want = jax.jit(jax.shard_map(
        lambda b: jstep(b, jcomm), mesh=jcomm.mesh,
        in_specs=P("sx", "sy"), out_specs=P("sx", "sy"), check_vma=False,
    ))(jnp.asarray(g))
    tstep = (st.jacobi_step_block_overlapped if overlap
             else st.jacobi_step_block)
    got = tstep(torch.from_numpy(g), comm11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_overlapped_step_on_a_one_row_block(comm11):
    block = torch.from_numpy(np.random.default_rng(4).random(
        (1, 9), dtype=np.float32))
    np.testing.assert_array_equal(
        st.jacobi_step_block_overlapped(block, comm11).numpy(),
        st.jacobi_step_block(block, comm11).numpy())


def test_run_stencil_global_in_global_out(comm11):
    g = _grid(16, 32)
    out = st.run_stencil(g, 6, comm=comm11)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(),
                                  stencil.reference_stencil(g, 6))
    cpu = st.run_stencil(torch.from_numpy(g), 6, px=1, py=1, device="cpu")
    np.testing.assert_array_equal(cpu.numpy(), out.numpy())
    grid_2x1 = st.Communicator(shape=(2, 1), axis_names=("sx", "sy"),
                               rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        st.run_stencil(_grid(15, 32), 1, comm=grid_2x1)


@pytest.mark.parametrize("x,y", [(4, 4), (16, 40)])
def test_initial_grid_and_reference_match_jax(x, y):
    np.testing.assert_array_equal(st.initial_grid(x, y),
                                  stencil.initial_grid(x, y))
    g = np.random.default_rng(x).random((x, y), dtype=np.float32)
    np.testing.assert_array_equal(st.reference_stencil(g, 3),
                                  stencil.reference_stencil(g, 3))


def test_global_boundary_mask():
    mask = tstencil.global_boundary_mask((3, 4), 5, 6, 8, 10, "cpu").numpy()
    want = np.zeros((3, 4), bool)
    want[2, :] = True   # global row 7 = gh - 1
    want[:, 3] = True   # global col 9 = gw - 1
    np.testing.assert_array_equal(mask, want)


# ------------------------------------------------------------- conversion --


def test_block_conversion_round_trip_and_float32_only(comm11):
    g = np.random.default_rng(5).random((6, 8), dtype=np.float32)
    block = st.block_from_numpy(g, comm11)
    assert block.dtype == torch.float32 and block.is_contiguous()
    np.testing.assert_array_equal(st.grid_to_numpy(block, comm11), g)
    with pytest.raises(TypeError, match="float32"):
        st.block_from_numpy(g.astype(np.float64), comm11)
    with pytest.raises(ValueError, match="2-D"):
        st.block_from_numpy(g.reshape(-1), comm11)


# --------------------------------------------------------- default device --


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        st.make_communicator()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        st.run_stencil(_grid(8, 8), 1, px=1, py=1)
