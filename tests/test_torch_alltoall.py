"""The port's all-to-all family against the JAX package's.

``smi_tpu_torch.all_to_all`` runs on an 8-rank CPU ``LocalWorld`` (flat,
and the ``(2, 4)`` hybrid grid ``("dcn", "ici")``) and ``smi_tpu``'s on
the 8-device fake mesh (flat, and ``make_hybrid_communicator(n_slices=2)``),
on the same inputs. Every algorithm is pure routing, so each result is
held ``array_equal`` to the JAX package's and to the serial block
transpose, in f32, bf16 and int32 and at odd per-destination counts (the
setup of ``tests/test_alltoall.py``). The JAX package's own check that an
untuned call compiles as the pairwise one fails on its side (ROADMAP.md
Queue 3), so the port's ``algorithm=None`` is held against the explicit
``"pairwise"`` call and the block transpose instead. A 4-rank gloo group
runs pairwise, Bruck and the ``(2, 2)`` two-tier form, the hybrid grid's
allreduce forms and a verified transfer on ``torch.distributed``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import smi_tpu_torch as st
from smi_tpu.parallel import collectives as jcoll
from smi_tpu.parallel.mesh import make_communicator, make_hybrid_communicator
from smi_tpu_torch.parallel import collectives as pcoll
from smi_tpu_torch.parallel import routing

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_gloo_worker  # noqa: E402

N = 8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}
COUNTS = [1, 3, 7]   # odd per-destination counts: uneven tails


def _inputs(count, n=N):
    """``(n, n * count, 2)``: rank r's buffer, block d bound for rank d,
    values made from a seed (small integers, exact in every dtype)."""
    rng = np.random.default_rng(1000 + count)
    return rng.integers(-120, 120, (n, n * count, 2)).astype(np.float32)


def _jax_alltoall(comm, x, algorithm, jdtype):
    spec = (P(tuple(comm.axis_names)) if len(comm.axis_names) > 1
            else P(comm.axis_names[0]))

    def shard_fn(v):
        return jcoll.all_to_all(v[0], comm, algorithm=algorithm)[None]

    fn = jax.jit(jax.shard_map(shard_fn, mesh=comm.mesh, in_specs=spec,
                               out_specs=spec, check_vma=False))
    out = fn(jnp.asarray(x, jnp.float32).astype(jdtype))
    return np.asarray(out.astype(jnp.float32))


def _port_alltoall(world, x, algorithm, tdtype, **kw):
    xs = torch.from_numpy(x).to(tdtype)
    outs = world.run(lambda c: st.all_to_all(xs[c.rank], c,
                                             algorithm=algorithm, **kw))
    return torch.stack(outs).float().numpy()


def _block_transpose(x):
    """Serial reference: rank r receives block r of every source, in
    source order."""
    n = x.shape[0]
    count = x.shape[1] // n
    return np.ascontiguousarray(
        x.reshape(n, n, count, -1).transpose(1, 0, 2, 3)
    ).reshape(x.shape)


@pytest.fixture(scope="module")
def flat_world():
    return st.LocalWorld(N, device="cpu")


@pytest.fixture(scope="module")
def hybrid_world():
    return st.LocalWorld((2, 4), ("dcn", "ici"), device="cpu")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("count", COUNTS)
def test_pairwise_and_bruck_match_the_jax_package(flat_world, dtype, count):
    jdtype, tdtype = DTYPES[dtype]
    x = _inputs(count)
    comm = make_communicator()
    want = _jax_alltoall(comm, x, "pairwise", jdtype)
    np.testing.assert_array_equal(
        _jax_alltoall(comm, x, "bruck", jdtype), want)
    np.testing.assert_array_equal(want, _block_transpose(x))
    for algorithm in ("pairwise", "bruck"):
        got = _port_alltoall(flat_world, x, algorithm, tdtype)
        np.testing.assert_array_equal(got, want, err_msg=algorithm)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hierarchical_matches_the_jax_hybrid_communicator(hybrid_world,
                                                         dtype):
    jdtype, tdtype = DTYPES[dtype]
    x = _inputs(3)
    hcomm = make_hybrid_communicator(n_slices=2)
    want = _jax_alltoall(hcomm, x, "hierarchical", jdtype)
    np.testing.assert_array_equal(want, _block_transpose(x))
    for algorithm in ("hierarchical", "pairwise", "bruck"):
        got = _port_alltoall(hybrid_world, x, algorithm, tdtype)
        np.testing.assert_array_equal(got, want, err_msg=algorithm)


@pytest.mark.parametrize("count", COUNTS)
def test_untuned_default_is_the_pairwise_call(flat_world, count,
                                              monkeypatch):
    monkeypatch.delenv(pcoll.ALLTOALL_ALGO_ENV, raising=False)
    x = _inputs(count)
    got = _port_alltoall(flat_world, x, None, torch.float32)
    np.testing.assert_array_equal(
        got, _port_alltoall(flat_world, x, "pairwise", torch.float32))
    np.testing.assert_array_equal(got, _block_transpose(x))


def test_a_trailing_shape_and_a_context_call(flat_world):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, N * 2, 3, 4)).astype(np.float32)
    app = st.smi_kernel(flat_world, in_specs="smi", out_specs="smi")(
        lambda ctx, v: ctx.all_to_all(v[0], algorithm="bruck")[None])
    np.testing.assert_array_equal(app(x).numpy(), _block_transpose(x))


@pytest.mark.parametrize("algorithm", ["bruck", "pairwise",
                                       "hierarchical"])
def test_env_override_is_the_operators_word(hybrid_world, algorithm,
                                            monkeypatch):
    monkeypatch.setenv(pcoll.ALLTOALL_ALGO_ENV, algorithm)
    calls = []
    for name in ("_bruck_all_to_all", "alltoall_hierarchical"):
        real = getattr(pcoll, name)
        monkeypatch.setattr(pcoll, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    x = _inputs(1)
    got = _port_alltoall(hybrid_world, x, None, torch.float32)
    np.testing.assert_array_equal(got, _block_transpose(x))
    expect = {"bruck": ["_bruck_all_to_all"] * N,
              "hierarchical": ["alltoall_hierarchical"] * N,
              "pairwise": []}[algorithm]
    assert calls == expect


def _on_world(fn, shape=4, names=None):
    return st.LocalWorld(shape, names, device="cpu").run(fn)


@pytest.mark.parametrize("call,world,match", [
    (lambda c, x: st.all_to_all(x, c, backend="ring"), 4, "ring"),
    (lambda c, x: st.all_to_all(x, c, algorithm="ghost"), 4,
     "unknown all_to_all"),
    (lambda c, x: st.all_to_all(x[:6], c), 4, "not divisible"),
    (lambda c, x: st.all_to_all(x[:12], c, algorithm="bruck"), 6,
     "power-of-two"),
    (lambda c, x: st.all_to_all(x, c, algorithm="hierarchical"), 4,
     "2-axis"),
    (lambda c, x: st.SmiContext(c, backend="ring").all_to_all(x), 4,
     "ring-tier kernel"),
])
def test_loud_errors_as_in_the_jax_package(call, world, match):
    x = torch.zeros(16, 2)
    with pytest.raises(ValueError, match=match):
        _on_world(lambda c: call(c, x), world)


def test_malformed_env_is_loud(monkeypatch):
    monkeypatch.setenv(pcoll.ALLTOALL_ALGO_ENV, "fastest")
    with pytest.raises(ValueError, match="SMI_TPU_ALLTOALL_ALGO"):
        _on_world(lambda c: st.all_to_all(torch.zeros(8), c))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_pairwise_schedule_matches_the_jax_package(n):
    from smi_tpu.parallel.routing import alltoall_pairwise_schedule

    comm = _on_world(lambda c: c, n)[0]
    assert comm.alltoall_schedule() == alltoall_pairwise_schedule(n)
    pairs = [p for step in comm.alltoall_schedule() for p in step]
    assert sorted(pairs) == [(s, d) for s in range(n) for d in range(n)
                             if s != d]


def test_schedule_rejects_zero_ranks():
    with pytest.raises(ValueError, match="n >= 1"):
        routing.alltoall_pairwise_schedule(0)


def test_transport_all_to_all_over_one_axis(hybrid_world):
    """The communicator's primitive over each axis of the hybrid grid:
    position p of a line receives block p of every rank of its line."""
    x = np.arange(N * 12, dtype=np.float32).reshape(N, 12)
    for axis, k in (("ici", 4), ("dcn", 2)):
        outs = hybrid_world.run(lambda c: c.all_to_all(
            torch.from_numpy(x[c.rank]), axis))
        for r, comm in enumerate(hybrid_world.comms):
            line = comm.line(axis)
            pos = line.index(r)
            want = np.concatenate([x[s].reshape(k, -1)[pos] for s in line])
            np.testing.assert_array_equal(outs[r].numpy(), want)


# ---- one gloo group --------------------------------------------------------


SURFACE = ("pairwise", "bruck", "bruck int", "hierarchical",
           "hierarchical bf16", "allreduce rs_ag", "allreduce hierarchical",
           "allreduce hierarchical max", "bcast hierarchical",
           "reduce hierarchical", "verified received", "verified expected",
           "verified got")


@pytest.fixture(scope="module")
def gloo_surface():
    rng = np.random.default_rng(11)
    x = rng.integers(-50, 50, (4, 16, 3)).astype(np.float32)
    reports = torch_gloo_worker.run_group(
        torch_gloo_worker.run_surface, 4, (x,))
    flat = st.LocalWorld(4, device="cpu")
    hybrid = st.LocalWorld((2, 2), ("dcn", "ici"), device="cpu")
    # the suite alternates between the two communicators: each thread of
    # the flat world drives its rank of the hybrid world too (a second
    # rendezvous of the same four threads)
    want = flat.run(lambda c: torch_gloo_worker.surface_suite(
        c, hybrid.comms[c.rank], torch.from_numpy(x[c.rank])))
    return x, reports, want


@pytest.mark.parametrize("name", SURFACE)
def test_gloo_group_matches_the_world(gloo_surface, name):
    x, reports, want = gloo_surface
    for r in range(4):
        value = want[r][name]
        value = value.float() if value.dtype == torch.bfloat16 else value
        np.testing.assert_array_equal(reports[r][name], value.numpy(),
                                      err_msg=f"rank {r} {name}")
    if name == "pairwise":
        for r in range(4):
            np.testing.assert_array_equal(
                reports[r][name], _block_transpose(x)[r])
