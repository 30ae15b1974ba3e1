"""The port's hybrid communicator and its two-tier and rs+ag allreduce
against the JAX package's.

The hybrid grid is ``(2, 4)`` with axes ``("dcn", "ici")``: an 8-rank CPU
``LocalWorld`` in the port, ``make_hybrid_communicator(n_slices=2)`` on the
8-device fake mesh in the JAX package. The same inputs, made from a seed,
go through ``allreduce_hierarchical``, the rooted ``hierarchical=True``
collectives and the reduce-scatter + all-gather allreduce on both sides:
integers and MAX/MIN exactly, f32 ADD within ``rtol=1e-6`` (the two-tier
and rs+ag forms add in another order than one all-reduce). The gates are
held to the JAX package's in every case: the rs+ag byte threshold and
``$SMI_TPU_RS_AG_MIN_BYTES``, the hierarchical pins and
``$SMI_TPU_HIER_MIN_SLICES``, and, where neither decides, each package's
plan engine on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.parallel import collectives as jcoll
from smi_tpu.parallel.mesh import _slice_groups as jax_slice_groups
from smi_tpu_torch.parallel import collectives as pcoll
from smi_tpu_torch.parallel import mesh as pmesh

N = 8
HYBRID = ((2, 4), ("dcn", "ici"))


@pytest.fixture(scope="module")
def hworld():
    return st.LocalWorld(*HYBRID, device="cpu")


@pytest.fixture(scope="module")
def hcomm():
    return make_jax_hybrid()


def make_jax_hybrid():
    return smi.make_hybrid_communicator(n_slices=2)


def _inputs(dtype, rows=12, cols=5, seed=11):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (N, rows, cols)).astype(np.int32)
    return rng.normal(size=(N, rows, cols)).astype(np.float32)


def _jax_per_rank(comm, fn, *xs):
    spec = P(tuple(comm.axis_names))

    def body(*vs):
        out = fn(*(v[0] for v in vs))
        return out[None]

    run = jax.jit(jax.shard_map(body, mesh=comm.mesh,
                                in_specs=(spec,) * len(xs), out_specs=spec,
                                check_vma=False))
    return np.asarray(run(*(jnp.asarray(x) for x in xs)))


def _port_per_rank(world, fn, *xs):
    ts = [torch.from_numpy(x) for x in xs]
    return torch.stack(world.run(
        lambda c: fn(c, *(t[c.rank] for t in ts)))).numpy()


def _close(got, want, exact):
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---- the communicator -------------------------------------------------


@pytest.mark.parametrize("n,n_slices,per_slice", [
    (6, None, None), (6, 2, 3), (6, 3, None), (6, None, 2), (8, 2, None),
    (8, 4, 2), (8, 3, None), (8, None, None), (8, 2, 3), (8, 3, 3),
])
def test_hybrid_shape_matches_the_jax_slice_groups(n, n_slices, per_slice):
    """The port's grid is the JAX package's split of a device list that
    reports no slice: the same ``(slices, per slice)``, or the same
    error."""
    def shape(fn):
        try:
            return fn()
        except ValueError as err:
            return f"ValueError: {err}"

    groups = shape(lambda: jax_slice_groups(list(range(n)), n_slices,
                                            per_slice))
    want = (groups if isinstance(groups, str)
            else (len(groups), len(groups[0])))
    assert shape(lambda: pmesh._hybrid_shape(n, n_slices, per_slice)) == want


def test_hybrid_communicator_on_one_process():
    comm = st.make_hybrid_communicator(n_slices=1, device="cpu")
    assert (comm.shape, comm.axis_names) == ((1, 1), ("dcn", "ici"))
    with pytest.raises(ValueError, match="n_slices"):
        st.make_hybrid_communicator(device="cpu")
    with pytest.raises(ValueError, match="split"):
        st.make_hybrid_communicator(n_slices=2, device="cpu")
    with pytest.raises(ValueError, match="outer, inner"):
        st.make_hybrid_communicator(n_slices=1, axis_names=("a",),
                                    device="cpu")


def test_mesh_from_topology_ranks_the_topologys_devices():
    from smi_tpu_torch.ops.program import Device, Program, ProgramMapping
    from smi_tpu_torch.ops.serialization import Topology

    program = Program([st.Broadcast(0)])
    mapping = ProgramMapping([program], {Device("node0", 0): program})
    topo = Topology(connections={}, mapping=mapping)
    comm = st.mesh_from_topology(topo, device="cpu")
    assert (comm.shape, comm.axis_names) == ((1,), ("smi",))


@pytest.mark.parametrize("shape,names,want", [
    ((2, 4), ("dcn", "ici"), (2, 4)),
    ((4, 2), ("dcn", "ici"), (4, 2)),
    ((1, 8), ("dcn", "ici"), (1, 8)),
    ((4, 2), ("ici", "dcn"), (2, 4)),
    ((2, 4), ("sx", "sy"), None),
    ((8,), ("dcn",), None),
])
def test_two_tier_split_matches_the_cost_model(shape, names, want):
    from smi_tpu.tuning import cost_model as cm
    from smi_tpu_torch.tuning import cost_model as pcm

    world = st.LocalWorld(shape, names, device="cpu")
    spec = cm.topology_from_comm(
        smi.make_communicator(shape=shape, axis_names=names))
    assert ((spec.outer, spec.inner) if spec.outer else None) == want
    for comm in (world.comms[0], world):
        got = pcm.topology_from_comm(comm)
        assert (got.n, got.inner, got.outer) == (spec.n, spec.inner,
                                                 spec.outer)


# ---- two-tier collectives ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_allreduce_hierarchical_matches(hworld, hcomm, dtype, op):
    x = _inputs(dtype)
    want = _jax_per_rank(
        hcomm, lambda v: jcoll.allreduce_hierarchical(v, hcomm, op=op), x)
    got = _port_per_rank(
        hworld, lambda c, v: pcoll.allreduce_hierarchical(v, c, op=op), x)
    _close(got, want, exact=dtype == "int32" or op != "add")
    combine = {"add": np.sum, "max": np.max, "min": np.min}[op]
    for r in range(N):
        _close(got[r], combine(x, axis=0).astype(x.dtype),
               exact=dtype == "int32" or op != "add")


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("case", [
    "allreduce", "bcast root 5", "reduce add root 2", "reduce max root 6",
    "reduce min all ranks"])
def test_hierarchical_knob_matches_smi_kernel(hworld, hcomm, dtype, case):
    """``hierarchical=True`` through the context, on both sides."""
    calls = {
        "allreduce": lambda ctx, v: ctx.allreduce(v, hierarchical=True),
        "bcast root 5": lambda ctx, v: ctx.bcast(v, root=5,
                                                 hierarchical=True),
        "reduce add root 2": lambda ctx, v: ctx.reduce(
            v, root=2, hierarchical=True),
        "reduce max root 6": lambda ctx, v: ctx.reduce(
            v, op="max", root=6, hierarchical=True),
        "reduce min all ranks": lambda ctx, v: ctx.reduce(
            v, op="min", all_ranks=True, hierarchical=True),
    }
    x = _inputs(dtype, seed=3)
    spec = P(("dcn", "ici"))

    @smi.smi_kernel(hcomm, in_specs=spec, out_specs=spec)
    def japp(ctx, v):
        return calls[case](ctx, v[0])[None]

    papp = st.smi_kernel(hworld, in_specs=("dcn", "ici"),
                         out_specs=("dcn", "ici"))(
        lambda ctx, v: calls[case](ctx, v[0])[None])
    want = np.asarray(japp(jnp.asarray(x)))
    got = papp(x).numpy()
    exact = dtype == "int32" or "add" not in case and case != "allreduce"
    _close(got, want, exact)


@pytest.mark.parametrize("root", [0, 3, 7])
def test_bcast_hierarchical_is_bit_identical_to_flat(hworld, root):
    x = _inputs("float32")
    flat = _port_per_rank(hworld, lambda c, v: st.bcast(v, c, root=root), x)
    tiered = _port_per_rank(
        hworld, lambda c, v: st.bcast(v, c, root=root, hierarchical=True),
        x)
    np.testing.assert_array_equal(tiered, flat)
    np.testing.assert_array_equal(tiered[1], x[root])


# ---- rs+ag ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("chunks", [None, 2, 3])
def test_rs_ag_allreduce_matches_smi_kernel(comm8, dtype, chunks):
    x = _inputs(dtype, rows=16, seed=7)

    @smi.smi_kernel(comm8, in_specs=P("smi"), out_specs=P("smi"))
    def japp(ctx, v):
        return ctx.allreduce(v[0], rs_ag=True, chunks=chunks)[None]

    world = st.LocalWorld(N, device="cpu")
    papp = st.smi_kernel(world, in_specs="smi", out_specs="smi")(
        lambda ctx, v: ctx.allreduce(v[0], rs_ag=True, chunks=chunks)[None])
    want = np.asarray(japp(jnp.asarray(x)))
    got = papp(x).numpy()
    _close(got, want, exact=dtype == "int32")
    # the world adds in rank order in both phases: equal to one all-reduce
    flat = st.smi_kernel(world, in_specs="smi", out_specs="smi")(
        lambda ctx, v: ctx.allreduce(v[0], rs_ag=False)[None])(x).numpy()
    np.testing.assert_array_equal(got, flat)


PAYLOADS = [(8, 4), (8, 1 << 17), (8 * 32767, 4), (8 * 32768, 4),
            (1 << 20,), (6, 1 << 18), (8,)]


@pytest.mark.parametrize("env", [None, "0", "4096", "8388608"])
@pytest.mark.parametrize("shape", PAYLOADS)
def test_rs_ag_gate_matches_the_jax_package(comm8, monkeypatch, env, shape):
    """The untuned gate is the byte threshold in both packages, and the
    env override moves it alike (4 MiB f32 on 8 ranks takes rs+ag)."""
    if env is None:
        monkeypatch.delenv(pcoll.RS_AG_ENV, raising=False)
    else:
        monkeypatch.setenv(pcoll.RS_AG_ENV, env)
    comm = st.LocalWorld(N, device="cpu").comms[0]
    for op in ("add", "max"):
        want = jcoll._use_rs_ag(jax.ShapeDtypeStruct(shape, jnp.float32),
                                comm8, jcoll.SmiOp.parse(op), None)
        got = pcoll._use_rs_ag(torch.empty(shape, device="meta"), comm,
                               st.SmiOp.parse(op), None)
        assert got == want, (op, shape, env)


def test_untuned_allreduce_of_4_mib_takes_rs_ag(monkeypatch):
    """An 8-rank allreduce of 4 MiB f32 a rank on the ``"xla"`` tier takes
    the reduce-scatter + all-gather form by default, and the sum is the
    same as one all-reduce's on the world (both add in rank order)."""
    monkeypatch.delenv(pcoll.RS_AG_ENV, raising=False)
    taken = []
    real = pcoll._rs_ag_allreduce
    monkeypatch.setattr(pcoll, "_rs_ag_allreduce",
                        lambda *a: taken.append(1) or real(*a))
    world = st.LocalWorld(N, device="cpu")
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.random((N, 1 << 20), dtype=np.float32))
    got = world.run(lambda c: st.allreduce(xs[c.rank], c))
    assert taken == [1] * N
    flat = world.run(lambda c: st.allreduce(xs[c.rank], c, rs_ag=False))
    assert taken == [1] * N
    for r in range(N):
        assert torch.equal(got[r], flat[r])
    np.testing.assert_allclose(got[0].numpy(),
                               xs.double().sum(0).float().numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("env", [None, "2", "3"])
@pytest.mark.parametrize("rows", [4, 8, 1 << 18, 6])
@pytest.mark.parametrize("pins", [
    dict(), dict(rs_ag=True), dict(rs_ag=False), dict(hierarchical=False),
    dict(hierarchical=True), dict(chunks=2)])
def test_hierarchical_gate_matches_the_jax_package(hcomm, hworld,
                                                   monkeypatch, env, rows,
                                                   pins):
    """Pins, conflicts, eligibility, ``$SMI_TPU_HIER_MIN_SLICES`` and,
    with no pin and no env, each package's plan engine (device kind
    ``"cpu"``: the model rung takes the two-tier form where its modeled
    advantage clears 4x, as at 3 MiB) decide alike."""
    if env is None:
        monkeypatch.delenv(pcoll.HIER_MIN_SLICES_ENV, raising=False)
    else:
        monkeypatch.setenv(pcoll.HIER_MIN_SLICES_ENV, env)
    pins = dict(dict(hierarchical=None, rs_ag=None, chunks=None), **pins)

    def decide(gate, x, comm, op):
        try:
            return gate(x, comm, op, pins["hierarchical"], pins["rs_ag"],
                        pins["chunks"])
        except ValueError as err:
            return f"ValueError: {err}"

    for op in ("add", "max"):
        got = decide(pcoll._use_hierarchical,
                     torch.empty((rows, 3), device="meta"), hworld.comms[0],
                     st.SmiOp.parse(op))
        want = decide(jcoll._use_hierarchical,
                      jax.ShapeDtypeStruct((rows, 3), jnp.float32), hcomm,
                      jcoll.SmiOp.parse(op))
        assert got == want, (op, rows, env, pins)


def test_hierarchical_env_forces_the_two_tier_form(hworld, monkeypatch):
    monkeypatch.setenv(pcoll.HIER_MIN_SLICES_ENV, "2")
    taken = []
    real = pcoll.allreduce_hierarchical
    monkeypatch.setattr(pcoll, "allreduce_hierarchical",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    x = _inputs("int32")
    got = _port_per_rank(hworld, lambda c, v: st.allreduce(v, c), x)
    assert taken == [1] * N
    np.testing.assert_array_equal(got[0], x.sum(0))


@pytest.mark.parametrize("raw,match", [
    ("two", "integer slice count"), ("1", ">= 2")])
def test_malformed_hier_env_is_loud(hworld, monkeypatch, raw, match):
    monkeypatch.setenv(pcoll.HIER_MIN_SLICES_ENV, raw)
    x = torch.zeros(8, 2)
    with pytest.raises(ValueError, match=match):
        hworld.run(lambda c: st.allreduce(x, c))


@pytest.mark.parametrize("raw,match", [
    ("lots", "integer byte count"), ("-1", ">= 0")])
def test_malformed_rs_ag_env_is_loud(monkeypatch, raw, match):
    monkeypatch.setenv(pcoll.RS_AG_ENV, raw)
    x = torch.zeros(8, 2)
    with pytest.raises(ValueError, match=match):
        st.LocalWorld(N, device="cpu").run(lambda c: st.allreduce(x, c))


@pytest.mark.parametrize("call,match", [
    (lambda c, x: st.allreduce(x, c, rs_ag=True, hierarchical=True),
     "competing decompositions"),
    (lambda c, x: st.allreduce(x, c, rs_ag=False, hierarchical=True),
     "conflicts with rs_ag=False"),
    (lambda c, x: st.allreduce(x, c, chunks=2, hierarchical=True),
     "does not compose"),
    (lambda c, x: st.bcast(x, c, chunks=3, hierarchical=True),
     "does not compose"),
    (lambda c, x: st.reduce(x, c, chunks=3, hierarchical=True),
     "does not compose"),
    (lambda c, x: st.bcast(x, c, backend="ring", hierarchical=True),
     "XLA-tier composition"),
    (lambda c, x: st.reduce(x, c, backend="ring", hierarchical=True),
     "XLA-tier composition"),
    (lambda c, x: st.allreduce(x[:6], c, hierarchical=True),
     "divisible by the inner"),
    (lambda c, x: st.allreduce(x, c, op="max", rs_ag=True),
     "needs an ADD allreduce"),
    (lambda c, x: st.allreduce(x[:4], c, rs_ag=True),
     "divisible by comm size"),
    (lambda c, x: pcoll.allreduce_hierarchical(x, c, inner="dcn"),
     "distinct"),
    (lambda c, x: pcoll.allreduce_hierarchical(x, c, inner="nope",
                                               outer="dcn"),
     "not in mesh"),
    (lambda c, x: pcoll.allreduce_hierarchical(x[:7], c),
     "divisible by inner"),
])
def test_loud_errors_as_in_the_jax_package(hworld, call, match):
    x = torch.zeros(8, 2)
    with pytest.raises(ValueError, match=match):
        hworld.run(lambda c: call(c, x))


def test_hierarchical_needs_a_hybrid_grid():
    x = torch.zeros(8, 2)
    for shape, names in (((8,), None), ((2, 4), ("sx", "sy")),
                         ((1, 8), ("dcn", "ici"))):
        with pytest.raises(ValueError, match="multi-slice hybrid"):
            st.LocalWorld(shape, names, device="cpu").run(
                lambda c: st.allreduce(x, c, hierarchical=True))
