"""The port's ring tier on a CPU ``LocalWorld`` against the JAX ring
kernels in Pallas TPU interpret mode on the fake mesh.

On CPU tensors each wrapper of ``smi_tpu_torch.kernels.ring`` runs its
plain version at the world's rendezvous: the same slots and the same fold
order as the kernel, so every dtype — f32 ADD included — is held
``array_equal`` to what the interpreted JAX kernel returns on the same
numpy inputs. The ``LocalWorld`` itself (threads, rendezvous, the
transport seam) is tested here too; it spawns no process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.kernels import ring as jring
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import ring as kring
from smi_tpu_torch.parallel.mesh import Communicator

pytestmark = pytest.mark.skipif(
    not jring.interpret_available(),
    reason="this JAX has no Pallas TPU interpret mode",
)

NP = {"float32": np.float32, "int32": np.int32, "int8": np.int8,
      "int16": np.int16, "float64": np.float64}


def _inputs(n, shape, dtype, seed):
    """One array per rank, from a seed, as float32-exact numpy data."""
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        x = rng.integers(-64, 64, (n,) + shape).astype(np.float32) / 8.0
        return x   # exactly representable in bf16
    if dtype.startswith("int"):
        hi = 20 if dtype == "int8" else 1000
        return rng.integers(-hi, hi, (n,) + shape).astype(NP[dtype])
    return rng.normal(size=(n,) + shape).astype(NP[dtype])


def _to_torch(x, dtype):
    t = torch.from_numpy(np.array(x))   # a copy; 0-d stays 0-d
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_ring(devices, n, shard, x, dtype, mesh_shape=None, names=None):
    """``shard(v)`` on every rank of the fake mesh, one leading row of
    ``x`` per rank; the per-rank results stacked."""
    if mesh_shape is None:
        comm = smi.make_communicator(n, devices=devices[:n])
        spec = P("smi")
    else:
        comm = smi.make_communicator(shape=mesh_shape, axis_names=names,
                                     devices=devices[:n])
        spec = P(names)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else None)
    ma = jring.mesh_axes_of(comm)
    f = jax.jit(jax.shard_map(lambda v: shard(v[0], ma)[None],
                              mesh=comm.mesh, in_specs=spec, out_specs=spec,
                              check_vma=False))
    out = f(xj)
    if dtype == "bfloat16":
        out = out.astype(jnp.float32)
    return np.asarray(out)


def _port_ring(n, call, x, dtype, shape=None, names=None):
    world = st.LocalWorld(shape or n, names, device="cpu")
    before = dict(_build.LAUNCHES)
    outs = world.run(lambda c: call(_to_torch(x[c.rank], dtype), c))
    assert _build.LAUNCHES == before   # CPU tensors: the plain versions
    assert kring.last_record(world) is None
    return np.stack([_to_numpy(o) for o in outs])


ALL_REDUCE = [
    (2, (3, 37), "float32", "add"), (3, (3, 37), "float32", "add"),
    (8, (3, 37), "float32", "add"), (8, (130,), "int32", "max"),
    (3, (2, 33), "float32", "min"), (2, (5, 7), "int8", "add"),
    (3, (4, 130), "bfloat16", "add"), (2, (3, 9), "float64", "add"),
    (4, (), "float32", "add"),
]


@pytest.mark.parametrize("n,shape,dtype,op", ALL_REDUCE)
def test_all_reduce_equals_the_interpreted_jax_kernel(eight_devices, n, shape,
                                                      dtype, op):
    x = _inputs(n, shape, dtype, seed=n)
    want = _jax_ring(eight_devices, n, lambda v, ma: jring.ring_all_reduce(
        v, "smi", n, op=op, interpret=True, mesh_axes=ma), x, dtype)
    got = _port_ring(n, lambda t, c: kring.ring_all_reduce(t, c, op=op), x,
                     dtype)
    np.testing.assert_array_equal(got, want)
    # and it is the reduction, on every rank
    ref = {"add": np.sum, "max": np.max, "min": np.min}[op](
        x.astype(np.float64), axis=0)
    np.testing.assert_allclose(got[0], ref, rtol=1e-5, atol=1e-5)


#: n, shape, dtype, op, chunks: rows that chunks divide and rows it does
#: not (zero-row padding), chunks above the row count (clamped), 1-D
#: payloads (``(chunks, 1, per)``), every op and five element types
CHUNKED = [
    (2, (6, 37), "float32", "add", 2), (3, (7, 37), "float32", "add", 3),
    (4, (10, 33), "int32", "max", 4), (8, (8, 19), "float32", "add", 4),
    (3, (5, 9), "int16", "min", 2), (2, (5, 7), "int8", "add", 3),
    (3, (4, 130), "bfloat16", "add", 2), (4, (3, 17), "float32", "min", 8),
    (2, (130,), "float32", "max", 4), (8, (64,), "int32", "add", 3),
]


@pytest.mark.parametrize("n,shape,dtype,op,chunks", CHUNKED)
def test_chunked_all_reduce_equals_the_interpreted_jax_kernel(
        eight_devices, n, shape, dtype, op, chunks):
    x = _inputs(n, shape, dtype, seed=60 + n)
    want = _jax_ring(eight_devices, n, lambda v, ma: jring.ring_all_reduce(
        v, "smi", n, op=op, interpret=True, mesh_axes=ma, chunks=chunks),
        x, dtype)
    got = _port_ring(n, lambda t, c: kring.ring_all_reduce(
        t, c, op=op, chunks=chunks), x, dtype)
    np.testing.assert_array_equal(got, want)
    # bit for bit the unchunked all-reduce, and the plain version's
    unchunked = _port_ring(n, lambda t, c: kring.ring_all_reduce(t, c, op=op),
                           x, dtype)
    np.testing.assert_array_equal(got, unchunked)
    plain = kring.ring_all_reduce_chunked_plain(
        [_to_torch(x[r], dtype) for r in range(n)], chunks, op)
    np.testing.assert_array_equal(got, np.stack([_to_numpy(p)
                                                 for p in plain]))


@pytest.mark.parametrize("axis", ["sx", "sy"])
def test_chunked_sub_ring_equals_the_interpreted_jax_kernel(eight_devices,
                                                            axis):
    names, shape = ("sx", "sy"), (2, 4)
    n_ring = shape[names.index(axis)]
    x = _inputs(8, (5, 21), "float32", seed=70)
    want = _jax_ring(eight_devices, 8, lambda v, ma: jring.ring_all_reduce(
        v, axis, n_ring, interpret=True, mesh_axes=ma, chunks=2), x,
        "float32", mesh_shape=shape, names=names)
    got = _port_ring(8, lambda t, c: kring.ring_all_reduce(t, c, axis,
                                                           chunks=2),
                     x, "float32", shape=shape, names=names)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,chunks,shape", [
    (10, 3, (3, 4, 5)), (7, 4, (4, 2, 5)), (6, 2, (2, 3, 5)),
    (3, 8, (8, 1, 5)),
])
def test_chunk_rows_pads_and_unchunk_rows_restores(rows, chunks, shape):
    x = torch.arange(rows * 5.0).reshape(rows, 5) + 1
    xu = kring.chunk_rows(x, chunks)
    assert tuple(xu.shape) == shape
    assert not xu.reshape(-1, 5)[rows:].any()   # the pad is zero rows
    assert torch.equal(kring.unchunk_rows(xu, x), x)
    flat = torch.arange(float(rows))
    assert tuple(kring.chunk_rows(flat, chunks).shape) == (
        chunks, 1, -(-rows // chunks))


@pytest.mark.parametrize("n,shape,dtype", [
    (2, (37,), "float32"), (3, (2, 37), "float32"), (8, (1, 37), "float32"),
    (3, (3, 5), "int16"),
])
def test_all_gather_equals_the_interpreted_jax_kernel(eight_devices, n, shape,
                                                      dtype):
    x = _inputs(n, shape, dtype, seed=10 + n)
    want = _jax_ring(eight_devices, n, lambda v, ma: jring.ring_all_gather(
        v, "smi", n, interpret=True, mesh_axes=ma), x, dtype)
    got = _port_ring(n, lambda t, c: kring.ring_all_gather(t, c), x, dtype)
    np.testing.assert_array_equal(got, want)
    tiled = x.reshape((n * shape[0],) + shape[1:])
    np.testing.assert_array_equal(got, np.broadcast_to(tiled, got.shape))


@pytest.mark.parametrize("n,shape,dtype,op", [
    (2, (4, 19), "float32", "add"), (3, (6, 19), "float32", "add"),
    (8, (8, 19), "float32", "add"), (8, (16,), "int32", "max"),
])
def test_reduce_scatter_equals_the_interpreted_jax_kernel(eight_devices, n,
                                                          shape, dtype, op):
    x = _inputs(n, shape, dtype, seed=20 + n)
    want = _jax_ring(eight_devices, n,
                     lambda v, ma: jring.ring_reduce_scatter(
                         v, "smi", n, op=op, interpret=True, mesh_axes=ma),
                     x, dtype)
    got = _port_ring(n, lambda t, c: kring.ring_reduce_scatter(t, c, op=op),
                     x, dtype)
    np.testing.assert_array_equal(got, want)
    full = {"add": np.sum, "max": np.max}[op](x.astype(np.float64), axis=0)
    np.testing.assert_allclose(got.reshape(full.shape), full, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,shape,dtype,direction", [
    (2, (3, 45), "float32", 1), (3, (3, 45), "float32", 1),
    (8, (3, 45), "float32", 1), (8, (4, 2, 5), "float32", -1),
    (2, (1, 130), "float32", -1), (3, (5, 28), "int8", -1),
])
def test_neighbour_stream_equals_the_interpreted_jax_kernel(
        eight_devices, n, shape, dtype, direction):
    x = _inputs(n, shape, dtype, seed=30 + n)
    want = _jax_ring(eight_devices, n, lambda v, ma: jring.neighbour_stream(
        v, "smi", n, direction=direction, interpret=True, mesh_axes=ma),
        x, dtype)
    got = _port_ring(n, lambda t, c: kring.neighbour_stream(
        t, c, direction=direction), x, dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.roll(x, direction, axis=0))


@pytest.mark.parametrize("axis", ["sx", "sy"])
def test_sub_ring_of_a_grid_equals_the_interpreted_jax_kernel(eight_devices,
                                                              axis):
    """A ring along one axis of the 2x4 grid: every line is its own ring,
    and a rank sees its own line only."""
    names, shape = ("sx", "sy"), (2, 4)
    n_ring = shape[names.index(axis)]
    x = _inputs(8, (2, 33), "float32", seed=40)
    want = _jax_ring(eight_devices, 8, lambda v, ma: jring.ring_all_reduce(
        v, axis, n_ring, interpret=True, mesh_axes=ma), x, "float32",
        mesh_shape=shape, names=names)
    got = _port_ring(8, lambda t, c: kring.ring_all_reduce(t, c, axis), x,
                     "float32", shape=shape, names=names)
    np.testing.assert_array_equal(got, want)


def test_ring_matches_lax_all_gather_and_psum_scatter(eight_devices):
    n = 4
    comm = smi.make_communicator(n, devices=eight_devices[:n])
    x = _inputs(n, (8, 3), "int32", seed=50)

    def both(v):
        v = v[0]
        return (lax.all_gather(v, "smi", axis=0, tiled=True)[None],
                lax.psum_scatter(v, "smi", scatter_dimension=0,
                                 tiled=True)[None])

    gathered, scattered = jax.jit(jax.shard_map(
        both, mesh=comm.mesh, in_specs=P("smi"),
        out_specs=(P("smi"), P("smi")), check_vma=False))(jnp.asarray(x))
    np.testing.assert_array_equal(
        _port_ring(n, lambda t, c: kring.ring_all_gather(t, c), x, "int32"),
        np.asarray(gathered))
    np.testing.assert_array_equal(
        _port_ring(n, lambda t, c: kring.ring_reduce_scatter(t, c), x,
                   "int32"),
        np.asarray(scattered))


# ---- the plain versions and the wrappers' edges -----------------------


def test_all_reduce_fold_starts_right_of_the_rank_and_ends_at_it():
    n = 5
    xs = [torch.tensor([10.0 ** r + 1e-3]) for r in range(n)]
    outs = kring.ring_all_reduce_plain(xs)
    for r in range(n):
        want = xs[(r + 1) % n]
        for k in range(2, n + 1):
            want = want + xs[(r + k) % n]
        assert torch.equal(outs[r], want)


@pytest.mark.parametrize("flow_control", [True, False])
def test_flow_control_does_not_change_the_values(flow_control):
    world = st.LocalWorld(3, device="cpu")
    xs = [torch.arange(12.0).reshape(4, 3) + r for r in range(3)]
    outs = world.run(lambda c: kring.neighbour_stream(
        xs[c.rank], c, flow_control=flow_control))
    assert all(torch.equal(outs[r], xs[(r - 1) % 3]) for r in range(3))


def test_one_rank_and_empty_payloads_launch_nothing():
    one = st.LocalWorld(1, device="cpu")
    x = torch.arange(6.0).reshape(2, 3)
    assert one.run(lambda c: kring.ring_all_reduce(x, c))[0] is x
    assert one.run(lambda c: kring.neighbour_stream(x, c))[0] is x
    assert one.run(lambda c: kring.ring_all_gather(x, c))[0] is x
    assert one.run(lambda c: kring.ring_reduce_scatter(x, c))[0] is x
    two = st.LocalWorld(2, device="cpu")
    empty = torch.zeros(0, 3)
    assert two.run(lambda c: kring.ring_all_reduce(empty, c))[0] is empty
    assert two.run(lambda c: kring.ring_all_gather(empty, c))[0].shape == (0, 3)
    assert two.run(lambda c: kring.ring_reduce_scatter(empty, c))[0].shape \
        == (0, 3)


def test_wrapper_errors():
    world = st.LocalWorld(2, device="cpu")
    x = torch.zeros(4, 3)

    def raises(exc, match, fn):
        with pytest.raises(exc, match=match):
            world.run(fn)

    raises(ValueError, "stream must be",
           lambda c: kring.ring_all_reduce(x, c, stream=kring.RING_STREAMS))
    raises(ValueError, "direction",
           lambda c: kring.neighbour_stream(x, c, direction=2))
    raises(ValueError, "chunks must be >= 1",
           lambda c: kring.ring_all_reduce(x, c, chunks=0))
    raises(TypeError, "chunks must be an int",
           lambda c: kring.ring_all_reduce(x, c, chunks=2.0))
    raises(ValueError, "not divisible",
           lambda c: kring.ring_reduce_scatter(torch.zeros(3, 2), c))
    raises(TypeError, "dtype",
           lambda c: kring.ring_all_reduce(x.to(torch.float16), c))
    raises(ValueError, "a ring spans",
           lambda c: kring.ring_all_reduce(x, c, ("smi", "other")))
    # ranks that bring different shapes: the leader refuses
    raises(ValueError, "rank 1 brought",
           lambda c: kring.ring_all_reduce(torch.zeros(4 + c.rank), c))
    # a rank that is a process has no ring tier yet
    lone = Communicator(shape=(2,), axis_names=("smi",), rank=0,
                        device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="LocalWorld"):
        kring.ring_all_reduce(x, lone)


# ---- the LocalWorld ---------------------------------------------------


def test_world_defaults_to_cuda_and_says_so_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        st.LocalWorld(2)


def test_world_runs_every_rank_and_keeps_rank_order():
    world = st.LocalWorld((2, 4), ("sx", "sy"), device="cpu")
    assert world.size == 8 and world.axis_names == ("sx", "sy")
    out = world.run(lambda c: (c.rank, c.coords, c.world is world))
    assert out == [(r, (r // 4, r % 4), True) for r in range(8)]
    assert world.lines("sy") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert world.lines("sx") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert world.comms[5].line("sx") == [1, 5]
    assert world.comms[5].line() == list(range(8))


def test_a_failing_rank_fails_the_world_and_nobody_hangs():
    world = st.LocalWorld(4, device="cpu")

    def fn(c):
        if c.rank == 2:
            raise KeyError("rank 2 gives up")
        return c.all_reduce(torch.ones(1))

    with pytest.raises(KeyError, match="rank 2 gives up"):
        world.run(fn)
    # the world is usable again
    assert [float(t) for t in world.run(
        lambda c: c.all_reduce(torch.ones(1)))] == [4.0] * 4


def test_ranks_that_diverge_fail_the_rendezvous():
    world = st.LocalWorld(2, device="cpu")
    x = torch.ones(2)

    def fn(c):
        return c.all_reduce(x) if c.rank else c.all_gather(x)

    with pytest.raises(RuntimeError, match="diverged"):
        world.run(fn)


def test_transport_seam_on_the_world_matches_numpy():
    world = st.LocalWorld((2, 4), ("sx", "sy"), device="cpu")
    x = np.random.default_rng(3).integers(-9, 9, (8, 4, 3)).astype(np.int32)
    grid = x.reshape(2, 4, 4, 3)

    def fn(c):
        t = torch.from_numpy(x[c.rank])
        return (c.all_reduce(t, "max", "sy"), c.all_reduce(t),
                c.all_gather(t, "sx"), c.reduce_scatter(t, "add", "sy"),
                c.permute(t, [(1, 6), (6, 1)]),
                c.exchange_start([(t, "sy", 1), (t, "sx", -1)],
                                 ring=False).wait(),
                c.exchange_start([(t, "sy", -1)], ring=True).wait()[0])

    for r, (mx, total, gath, rs, perm, (right, up), wrap) in enumerate(
            world.run(fn)):
        i, j = divmod(r, 4)
        np.testing.assert_array_equal(mx.numpy(), grid[i].max(0))
        np.testing.assert_array_equal(total.numpy(), x.sum(0))
        np.testing.assert_array_equal(
            gath.numpy(), np.concatenate([grid[0, j], grid[1, j]]))
        np.testing.assert_array_equal(rs.numpy(), grid[i].sum(0)[j:j + 1])
        want = {1: x[6], 6: x[1]}.get(r, np.zeros_like(x[0]))
        np.testing.assert_array_equal(perm.numpy(), want)
        np.testing.assert_array_equal(
            right.numpy(), grid[i, j - 1] if j else np.zeros_like(x[0]))
        np.testing.assert_array_equal(
            up.numpy(), grid[i + 1, j] if i == 0 else np.zeros_like(x[0]))
        np.testing.assert_array_equal(wrap.numpy(), grid[i, (j + 1) % 4])


def test_shard_and_assemble_round_trip():
    world = st.LocalWorld((2, 4), ("sx", "sy"), device="cpu")
    x = torch.arange(48.0).reshape(8, 6)
    for spec, n in (("sy", 4), ("sx", 2), (("sx", "sy"), 8)):
        shards = world.shard(x, spec)
        assert shards[0].shape == (8 // n, 6)
        assert torch.equal(world.assemble(shards, spec), x)
    assert all(torch.equal(s, x) for s in world.shard(x, None))
    assert torch.equal(world.assemble(world.shard(x, None), None), x)
    with pytest.raises(ValueError, match="not divisible"):
        world.shard(torch.zeros(6, 2), "sy")
    with pytest.raises(ValueError, match="a spec is"):
        world.shard(x, ("sy", "sx"))
    np.testing.assert_array_equal(
        st.shards_to_numpy(st.shards_from_numpy(x.numpy(), world, "sy"),
                           "sy", world), x.numpy())
