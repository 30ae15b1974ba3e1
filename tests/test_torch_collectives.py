"""The port's rooted collectives against the JAX package's, both tiers.

One suite of collectives (non-zero roots, the three reduce ops, chunked
pipelines, distinct ports) runs once through ``smi_tpu``'s ``smi_kernel``
on the 8-device fake mesh and once through the port's on an 8-rank CPU
``LocalWorld``, on the same numpy inputs made from a seed, per backend:
``"xla"`` and ``"ring"`` (the JAX ring kernels in Pallas TPU interpret
mode; the port's wrappers on their plain versions). Every result is then
compared by name: exactly, except f32 ADD on the ``"xla"`` tier, where
the two packages may add in another order (``rtol=1e-6``). One 4-rank
gloo group runs the ``"xla"`` suite on ``torch.distributed``.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.parallel import collectives as jcoll
from smi_tpu_torch.parallel import collectives as pcoll

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_gloo_worker  # noqa: E402

N = 8
BACKENDS = ["xla", "ring"]

#: name -> (collective, keyword arguments, which input); inputs: "f" an
#: f32 (6, 5) array a rank, "i" an int32 one, "big" an f32 (16, 3) one
#: (16 = 8 ranks x 2 rows, for scatter)
SUITE = {
    "bcast root 3": ("bcast", dict(root=3), "f"),
    "bcast root 0 int": ("bcast", dict(root=0), "i"),
    "bcast root 7 port 2": ("bcast", dict(root=7, port=2), "f"),
    "reduce add root 5": ("reduce", dict(op="add", root=5), "f"),
    "reduce max root 0": ("reduce", dict(op="max", root=0), "f"),
    "reduce min root 7": ("reduce", dict(op="min", root=7), "f"),
    "reduce add int root 2": ("reduce", dict(op="add", root=2), "i"),
    "reduce all ranks": ("reduce", dict(op="max", all_ranks=True), "i"),
    "allreduce": ("allreduce", dict(), "f"),
    "allreduce min int": ("allreduce", dict(op="min"), "i"),
    "scatter root 6": ("scatter", dict(root=6), "big"),
    "scatter root 1 chunks 2": ("scatter", dict(root=1, chunks=2), "big"),
    "gather root 4": ("gather", dict(root=4), "f"),
    "gather root 0 chunks 4": ("gather", dict(root=0, chunks=4), "f"),
    "gather all ranks port 1": ("gather", dict(all_ranks=True, port=1), "f"),
    # chunked bcast/reduce/allreduce: on the ring tier one launch of the
    # chunked kernel (6 rows: 3 chunks of 2, 4 chunks of 2 with a zero
    # pad row, 2 chunks of 3)
    "bcast root 5 chunks 3": ("bcast", dict(root=5, chunks=3), "f"),
    "reduce add chunks 4": ("reduce", dict(op="add", root=1, chunks=4), "f"),
    "reduce max chunks 4": ("reduce", dict(op="max", root=6, chunks=4), "f"),
    "allreduce chunks 2": ("allreduce", dict(chunks=2), "i"),
}
F32_ADD = {"reduce add root 5", "allreduce", "reduce add chunks 4"}


def _inputs():
    rng = np.random.default_rng(2024)
    return {
        "f": rng.normal(size=(N, 6, 5)).astype(np.float32),
        "i": rng.integers(-1000, 1000, (N, 6, 5)).astype(np.int32),
        "big": rng.normal(size=(N, 16, 3)).astype(np.float32),
    }


def _jax_suite(comm8, backend):
    cases = SUITE

    @smi.smi_kernel(comm8, in_specs=P("smi"), out_specs=P("smi"),
                    backend=backend)
    def app(ctx, f, i, big):
        data = {"f": f[0], "i": i[0], "big": big[0]}
        return tuple(
            getattr(ctx, fn)(data[which], **kw)[None]
            for fn, kw, which in cases.values()
        )

    x = _inputs()
    outs = app(jnp.asarray(x["f"]), jnp.asarray(x["i"]),
               jnp.asarray(x["big"]))
    return {name: np.asarray(o) for name, o in zip(cases, outs)}


def _port_fn(cases):
    def fn(ctx, f, i, big):
        data = {"f": f[0], "i": i[0], "big": big[0]}
        return tuple(
            getattr(ctx, fn)(data[which], **kw)[None]
            for fn, kw, which in cases.values()
        )
    return fn


def _port_suite(backend):
    cases = SUITE
    world = st.LocalWorld(N, device="cpu")
    app = st.smi_kernel(world, in_specs="smi", out_specs="smi",
                        backend=backend)(_port_fn(cases))
    x = _inputs()
    outs = app(x["f"], x["i"], x["big"])
    return {name: o.numpy() for name, o in zip(cases, outs)}


@pytest.fixture(scope="module")
def suites(comm8):
    return {b: (_port_suite(b), _jax_suite(comm8, b)) for b in BACKENDS}


@pytest.mark.parametrize("backend,name", [
    (b, name) for b in BACKENDS for name in SUITE
])
def test_collective_matches_the_jax_package(suites, backend, name):
    got, want = (s[name] for s in suites[backend])
    assert got.shape == want.shape and got.dtype == want.dtype
    if backend == "xla" and name in F32_ADD:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_rooted_results_are_the_reference_values(suites, backend):
    """Against numpy, not only against the other package: the root sees
    the result, the others zeros; scatter hands rank r slice r."""
    got, x = suites[backend][0], _inputs()
    for r in range(N):
        np.testing.assert_array_equal(got["bcast root 3"][r], x["f"][3])
        np.testing.assert_array_equal(got["scatter root 6"][r],
                                      x["big"][6][2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["scatter root 1 chunks 2"][r],
                                      x["big"][1][2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["reduce all ranks"][r],
                                      x["i"].max(0))
        np.testing.assert_array_equal(got["gather all ranks port 1"][r],
                                      x["f"].reshape(-1, 5))
    for name, root, want in (
            ("reduce max root 0", 0, x["f"].max(0)),
            ("reduce min root 7", 7, x["f"].min(0)),
            ("reduce add int root 2", 2, x["i"].sum(0)),
            ("gather root 4", 4, x["f"].reshape(-1, 5)),
            ("gather root 0 chunks 4", 0, x["f"].reshape(-1, 5))):
        np.testing.assert_array_equal(got[name][root], want)
        assert not got[name][np.arange(N) != root].any()
    np.testing.assert_allclose(got["reduce add root 5"][5], x["f"].sum(0),
                               rtol=1e-5, atol=1e-6)


def test_ring_tier_equals_xla_tier_but_for_f32_add(suites):
    ring, xla = suites["ring"][0], suites["xla"][0]
    for name in SUITE:
        if name in F32_ADD:
            np.testing.assert_allclose(ring[name], xla[name], rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(ring[name], xla[name])


def test_gloo_group_runs_the_xla_tier():
    """The same collectives over ``torch.distributed`` (4 gloo ranks)
    equal the 4-rank world's."""
    rng = np.random.default_rng(7)
    x = rng.integers(-50, 50, (4, 8, 3)).astype(np.float32)
    reports = torch_gloo_worker.run_group(
        torch_gloo_worker.run_collectives, 4, (x,))
    world = st.LocalWorld(4, device="cpu")
    want = world.run(lambda c: torch_gloo_worker.collective_suite(
        c, torch.from_numpy(x[c.rank])))
    for r in range(4):
        assert sorted(reports[r]) == sorted(want[r])
        for name, value in want[r].items():
            # integer-valued f32 data: every order of addition is exact
            np.testing.assert_array_equal(reports[r][name], value.numpy(),
                                          err_msg=f"rank {r} {name}")


# ---- the pieces, against the JAX package's ------------------------------


@pytest.mark.parametrize("total,chunks", [
    (10, 1), (10, 3), (10, 10), (3, 8), (1, 4), (1000, 7), (64, 64),
])
def test_chunk_bounds_match(total, chunks):
    assert pcoll._chunk_bounds(total, chunks) == jcoll._chunk_bounds(
        total, chunks)


def test_reassemble_rank_major_matches():
    size, bounds = 3, [(0, 2), (2, 3)]
    rng = np.random.default_rng(1)
    pieces = [rng.normal(size=(size * (e - s), 4)).astype(np.float32)
              for s, e in bounds]
    want = np.asarray(jcoll._reassemble_rank_major(
        [jnp.asarray(p) for p in pieces], bounds, size))
    got = pcoll._reassemble_rank_major(
        [torch.from_numpy(p) for p in pieces], bounds, size).numpy()
    np.testing.assert_array_equal(got, want)


def test_stream_slots_follow_port_allocation():
    from smi_tpu.parallel.collectives import _stream_for as jax_stream_for

    prog_j = smi.Program([smi.Broadcast(i) for i in range(3)])
    prog_p = st.Program([st.Broadcast(i) for i in range(3)])
    for port in (None, 0, 1, 2, 5, 9):
        assert pcoll._stream_for(port, None, "broadcast") == jax_stream_for(
            port, None, "broadcast")
    streams = [pcoll._stream_for(p, prog_p, "broadcast") for p in range(3)]
    assert streams == [jax_stream_for(p, prog_j, "broadcast")
                       for p in range(3)]
    assert len(set(streams)) == 3
    # a program dealt over more streams than the ring tier has domains
    wide = st.Program([st.Broadcast(i) for i in range(6)], num_streams=6)
    with pytest.raises(ValueError, match="flag domains"):
        pcoll._stream_for(5, wide, "broadcast")


# ---- error paths ---------------------------------------------------------


def _on_world(fn, n=4):
    return st.LocalWorld(n, device="cpu").run(fn)


@pytest.mark.parametrize("call,exc,match", [
    (lambda c, x: st.bcast(x, c, backend="nccl"), ValueError,
     "unknown backend"),
    (lambda c, x: st.bcast(x, c, root=4), ValueError, "root=4"),
    (lambda c, x: st.reduce(x, c, root=-1), ValueError, "root=-1"),
    (lambda c, x: st.scatter(x[:6], c), ValueError, "not divisible"),
    (lambda c, x: st.gather(x, c, chunks=0), ValueError, "chunks must be"),
    (lambda c, x: st.bcast(x, c, chunks=1.5), TypeError, "chunks must be"),
    (lambda c, x: st.allreduce(x, c, rs_ag=True, backend="ring"),
     ValueError, "XLA-tier decomposition"),
    (lambda c, x: st.allreduce(x, c, hierarchical=True, backend="ring"),
     ValueError, "XLA-tier composition"),
    # the JAX package's loud errors of the all-to-all, rs+ag, two-tier
    # and precision knobs (four here, four after shrink: the cases before
    # and after keep their ids)
    (lambda c, x: pcoll.all_to_all(x, c, backend="ring"), ValueError,
     "no ring-tier kernel"),
    (lambda c, x: st.allreduce(x, c, rs_ag=True, hierarchical=True),
     ValueError, "competing decompositions"),
    (lambda c, x: st.allreduce(x, c, op="max", precision="int8"),
     ValueError, "needs an ADD allreduce"),
    (lambda c, x: pcoll.all_to_all(x, c, algorithm="ghost"), ValueError,
     "unknown all_to_all algorithm"),
    (lambda c, x: st.SmiContext(c).explain_plan("ghost"), ValueError,
     "unknown op 'ghost'"),
    (lambda c, x: st.SmiContext(c).shrink(range(c.size)), ValueError,
     "no survivors"),
    (lambda c, x: pcoll.all_to_all(x[:6], c), ValueError,
     "not divisible by comm size"),
    (lambda c, x: st.allreduce(x.int(), c, precision="bf16"), ValueError,
     "floating-point payload"),
    (lambda c, x: st.allreduce(x, c, precision="fp4"), ValueError,
     "precision must be one of"),
    (lambda c, x: st.bcast(x, c, hierarchical=True), ValueError,
     "multi-slice hybrid|2-axis"),
])
def test_error_paths(call, exc, match):
    x = torch.zeros(8, 2)
    with pytest.raises(exc, match=match):
        _on_world(lambda c: call(c, x))


def test_bruck_on_six_ranks_is_loud():
    x = torch.zeros(12, 2)
    with pytest.raises(ValueError, match="power-of-two comm size, got 6"):
        _on_world(lambda c: pcoll.all_to_all(x, c, algorithm="bruck"), 6)


@pytest.mark.parametrize("env,raw,match", [
    ("ALLTOALL_ALGO_ENV", "fastest", "SMI_TPU_ALLTOALL_ALGO"),
    ("RS_AG_ENV", "1MiB", "SMI_TPU_RS_AG_MIN_BYTES"),
    ("HIER_MIN_SLICES_ENV", "many", "SMI_TPU_HIER_MIN_SLICES"),
    ("ALLREDUCE_PRECISION_ENV", "int4", "SMI_TPU_ALLREDUCE_PRECISION"),
])
def test_a_malformed_env_variable_is_loud(monkeypatch, env, raw, match):
    monkeypatch.setenv(getattr(pcoll, env), raw)
    x = torch.zeros(8, 2)
    world = st.LocalWorld((2, 2), ("dcn", "ici"), device="cpu")
    call = (pcoll.all_to_all if env == "ALLTOALL_ALGO_ENV"
            else st.allreduce)
    with pytest.raises(ValueError, match=match):
        world.run(lambda c: call(x, c))


def test_expired_deadline_stops_a_ring_collective_before_dispatch():
    deadline = st.Deadline(0.0)
    x = torch.ones(4)
    with pytest.raises(st.WatchdogTimeout, match="ring reduce over 4 ranks"):
        _on_world(lambda c: st.reduce(x, c, backend="ring",
                                      deadline=deadline))
    # the xla tier does not consult it, an unbounded one never fires
    assert _on_world(lambda c: st.reduce(x, c, deadline=deadline))[0][0] == 4
    assert _on_world(lambda c: st.reduce(
        x, c, backend="ring", deadline=st.Deadline(None)))[0][0] == 4


def test_ring_tier_refuses_a_process_group_communicator():
    comm = st.make_communicator(shape=(1,), device="cpu")
    with pytest.raises(NotImplementedError, match="LocalWorld"):
        st.bcast(torch.ones(3), comm, backend="ring")
    assert torch.equal(st.bcast(torch.ones(3), comm), torch.ones(3))
