"""smi_tpu_torch's ring attention against the JAX package's.

The same seeded float32 numpy q/k/v go through the JAX package's
``make_ring_attention_fn`` on the fake CPU mesh (its flash tier in
interpret mode) and through the port's on CPU tensors: a one-rank
communicator in this process, and one gloo group on a 4-rank ``sp`` ring
(``tests/torch_gloo_worker.py``) where each rank's shard of the output
and of the gradients is held to its rows of JAX's. Gradients are of
``sum(out * w)`` for a seeded ``w``. Tolerances are
``tests/test_flash.py``'s: 2e-5 for f32, 3e-2 for bf16.
"""

import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.models import ring_attention as jra
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.models import ring_attention as tra

# spawned children import the worker by module name through this path
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_gloo_worker  # noqa: E402


def _qkv(s, h, d, seed, h_kv=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(s, h, d).astype(np.float32)
    k, v = (rng.randn(s, h_kv or h, d).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.fixture
def comm1():
    return st.make_communicator(shape=(1,), axis_names=("sp",), device="cpu")


def _port(comm, q, k, v, dtype=torch.float32, **kw):
    shards = [st.sequence_shard_from_numpy(x, comm, dtype=dtype)
              for x in (q, k, v)]
    return st.make_ring_attention_fn(comm, **kw)(*shards)


def _jax(devices, q, k, v, n=1, dtype=jnp.float32, **kw):
    comm = smi.make_communicator(n, devices=devices[:n])
    use_flash = kw.get("use_flash")
    fn = jra.make_ring_attention_fn(comm, interpret=bool(use_flash), **kw)
    out = fn(*(jnp.asarray(x).astype(dtype) for x in (q, k, v)))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("causal,window,h_kv", [
    (False, None, 2), (True, None, 2), (True, None, 1), (True, 8, 2),
])
def test_one_rank_matches_jax(eight_devices, comm1, use_flash, causal,
                              window, h_kv):
    """n=1: the flash tier is one fused launch, the plain tier one jnp
    fold; both equal JAX's same tier and the float64 reference."""
    q, k, v = _qkv(32, 2, 128, seed=2, h_kv=h_kv)
    kw = dict(causal=causal, window=window, use_flash=use_flash)
    got = _port(comm1, q, k, v, **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    want = _jax(eight_devices, q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    ref = tra.reference_attention(
        q, np.repeat(k, 2 // h_kv, axis=1), np.repeat(v, 2 // h_kv, axis=1),
        causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_one_rank_bf16_matches_jax(eight_devices, comm1):
    q, k, v = _qkv(32, 2, 128, seed=4)
    got = _port(comm1, q, k, v, dtype=torch.bfloat16, causal=True,
                use_flash=True)
    assert got.dtype == torch.bfloat16
    want = _jax(eight_devices, q, k, v, dtype=jnp.bfloat16, causal=True,
                use_flash=True)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("d", [64, 96])
def test_flash_pads_unaligned_head_dim(eight_devices, comm1, d):
    """d=96 runs the kernel's d=128 instantiation by exact zero padding
    with the original 1/sqrt(d) scale; d=64 has its own (JAX pads both
    to its 128-lane tile)."""
    assert tra._padded_head_dim(d) == {64: 64, 96: 128}[d]
    q, k, v = _qkv(32, 2, d, seed=7)
    got = _port(comm1, q, k, v, causal=True, use_flash=True)
    assert got.shape == (32, 2, d)
    want = _jax(eight_devices, q, k, v, causal=True, use_flash=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_reps_chain_the_output_as_the_next_query(eight_devices, comm1):
    q, k, v = _qkv(16, 2, 128, seed=5)
    got = _port(comm1, q, k, v, causal=True, use_flash=True, reps=3)
    want = _jax(eight_devices, q, k, v, causal=True, use_flash=True, reps=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_reference_attention_matches_jax():
    q, k, v = _qkv(24, 2, 16, seed=6)
    rows = [0, 5, 23]
    for window in (None, 6):
        np.testing.assert_allclose(
            tra.reference_attention(q, k, v, causal=True, window=window),
            jra.reference_attention(q, k, v, causal=True, window=window),
            rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            tra.reference_attention_rows(q, k, v, rows, causal=True,
                                         window=window),
            jra.reference_attention_rows(q, k, v, rows, causal=True,
                                         window=window),
            rtol=1e-12, atol=1e-12)


def test_rejects_bad_kv_heads(comm1):
    q, _, _ = _qkv(16, 4, 128, seed=0)
    k, v, _ = _qkv(16, 3, 128, seed=1)
    for use_flash in (True, False):
        with pytest.raises(ValueError, match="divide"):
            _port(comm1, q, k, v, use_flash=use_flash)


def test_window_requires_causal(comm1):
    q, k, v = _qkv(16, 2, 128, seed=0)
    for use_flash in (True, False):
        with pytest.raises(ValueError, match="causal"):
            _port(comm1, q, k, v, causal=False, window=8,
                  use_flash=use_flash)


def test_auto_tier_is_the_plain_one_on_the_cpu(comm1):
    """``use_flash=None`` resolves to the plain tier off CUDA, as the JAX
    package resolves to jnp off TPU; no kernel wrapper is reached."""
    assert not tra._use_flash_default(comm1, 512, 4, 128, torch.float32)
    q, k, v = _qkv(16, 2, 128, seed=3)
    before = dict(_build.LAUNCHES)
    auto = _port(comm1, q, k, v, causal=True)
    plain = _port(comm1, q, k, v, causal=True, use_flash=False)
    assert torch.equal(auto, plain)
    assert _build.LAUNCHES == before


def test_plain_tier_is_differentiable_and_flash_backward_raises(comm1):
    """Both tiers differentiate to the same gradients; the flash tier's
    backward runs its kernels once and is not itself differentiable, so
    a double backward raises."""
    q, k, v = _qkv(16, 2, 128, seed=8)
    grads = {}
    for use_flash in (False, True):
        shards = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = tra.ring_attention_shard(*shards, comm1, causal=True,
                                       use_flash=use_flash)
        out.sum().backward()
        grads[use_flash] = [t.grad for t in shards]
        assert all(torch.isfinite(g).all() for g in grads[use_flash])
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    shards = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tra.ring_attention_shard(*shards, comm1, causal=True,
                                   use_flash=True)
    (dq,) = torch.autograd.grad((out * out).sum(), shards[0],
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def _port_grads(comm, q, k, v, w, dtype=torch.float32, **kw):
    shards = [st.sequence_shard_from_numpy(x, comm, dtype=dtype)
              .requires_grad_() for x in (q, k, v)]
    out = st.make_ring_attention_fn(comm, **kw)(*shards)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert all(t.grad.dtype == dtype for t in shards)
    return [t.grad.float().numpy() for t in shards]


def _jax_grads(devices, q, k, v, w, n=1, dtype=jnp.float32, **kw):
    comm = smi.make_communicator(n, devices=devices[:n])
    fn = jra.make_ring_attention_fn(comm, interpret=bool(kw.get("use_flash")),
                                    **kw)
    grads = jax.grad(
        lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * w),
        argnums=(0, 1, 2))(*(jnp.asarray(x).astype(dtype) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _assert_grads(got, want, tol=2e-5):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("causal,window,h_kv,d", [
    (False, None, 2, 128), (True, None, 2, 128), (True, None, 1, 128),
    (True, 8, 2, 128), (True, None, 2, 96),
])
def test_flash_gradients_match_jax(eight_devices, comm1, causal, window,
                                   h_kv, d):
    """n=1: the flash tier's backward (one launch of each backward
    kernel) equals JAX's custom VJP, causal or not, with grouped K/V
    heads, a window, and a head dim padded to the kernel's (96 -> 128,
    the gradients sliced back by autograd)."""
    q, k, v = _qkv(32, 2, d, seed=12, h_kv=h_kv)
    w = np.random.RandomState(13).randn(32, 2, d).astype(np.float32)
    kw = dict(causal=causal, window=window, use_flash=True)
    got = _port_grads(comm1, q, k, v, w, **kw)
    assert got[1].shape == (32, h_kv, d)
    _assert_grads(got, _jax_grads(eight_devices, q, k, v, w, **kw))


def test_flash_gradients_bf16_match_jax(eight_devices, comm1):
    q, k, v = _qkv(32, 2, 128, seed=14)
    w = np.random.RandomState(15).randn(32, 2, 128).astype(np.float32)
    kw = dict(causal=True, use_flash=True)
    _assert_grads(_port_grads(comm1, q, k, v, w, dtype=torch.bfloat16, **kw),
                  _jax_grads(eight_devices, q, k, v, w, dtype=jnp.bfloat16,
                             **kw), tol=3e-2)


@pytest.mark.parametrize("window", [None, 8])
def test_flash_gradients_match_the_plain_tier(comm1, window):
    q, k, v = _qkv(48, 4, 128, seed=16, h_kv=2)
    w = np.random.RandomState(17).randn(48, 4, 128).astype(np.float32)
    flash, plain = (_port_grads(comm1, q, k, v, w, causal=True,
                                window=window, use_flash=use_flash)
                    for use_flash in (True, False))
    _assert_grads(flash, plain)


@pytest.mark.parametrize("use_flash", [True, False])
def test_remat_reps_gives_the_same_gradients(eight_devices, comm1, use_flash):
    """``remat_reps`` recomputes each rep under differentiation; the
    gradients equal the saved-residual chain's and JAX's."""
    q, k, v = _qkv(16, 2, 128, seed=18)
    w = np.random.RandomState(19).randn(16, 2, 128).astype(np.float32)
    kw = dict(causal=True, use_flash=use_flash, reps=3)
    saved = _port_grads(comm1, q, k, v, w, **kw)
    before = dict(_build.LAUNCHES)
    remat = _port_grads(comm1, q, k, v, w, remat_reps=True, **kw)
    assert _build.LAUNCHES == before   # CPU tensors: the plain versions
    _assert_grads(remat, saved, tol=1e-6)
    _assert_grads(remat, _jax_grads(eight_devices, q, k, v, w,
                                    remat_reps=True, **kw))


def test_ring_shift_on_one_rank(comm1):
    x = torch.arange(6.0).reshape(2, 3)
    for offset in (1, -1, 0, 3):
        assert st.ring_shift(x, comm1, offset=offset) is x
    # the ring tier runs on a LocalWorld, not on a process-group rank
    with pytest.raises(NotImplementedError, match="LocalWorld"):
        st.ring_shift(x, comm1, backend="ring")
    with pytest.raises(ValueError, match="unknown backend"):
        st.ring_shift(x, comm1, backend="nope")


def test_sequence_shards_round_trip(comm1):
    q, _, _ = _qkv(8, 2, 4, seed=9)
    shard = st.sequence_shard_from_numpy(q, comm1, dtype=torch.bfloat16)
    assert shard.dtype == torch.bfloat16 and shard.is_contiguous()
    back = st.sequence_to_numpy(shard, comm1)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, q.astype(jnp.bfloat16).astype(
        np.float32))
    with pytest.raises(TypeError, match="float32"):
        st.sequence_shard_from_numpy(q.astype(np.float64), comm1)


@pytest.fixture(scope="module")
def gloo_ring():
    """One 4-rank ``sp`` ring under gloo: S=64, H=4, kv_heads=2, causal,
    window 24, both tiers' outputs and gradients of ``sum(out * w)``."""
    n, s, h, h_kv, d, window = 4, 64, 4, 2, 128, 24
    q, k, v = _qkv(s, h, d, seed=23, h_kv=h_kv)
    w = np.random.RandomState(24).randn(s, h, d).astype(np.float32)
    reports = torch_gloo_worker.run_group(
        torch_gloo_worker.run_attention, n, (q, k, v, window, w))
    return (q, k, v, window, w, n), reports


def test_gloo_four_rank_ring_matches_jax(eight_devices, gloo_ring):
    """Every rank's shard of both tiers equals its rows of JAX's 4-device
    ring (flash tier in interpret mode); ``ring_shift`` by 1, -1 and 2
    delivers the expected shards; the gathered sequence is whole."""
    (q, k, v, window, _, n), reports = gloo_ring
    s_local = q.shape[0] // n
    for tier, use_flash in (("flash", True), ("plain", False)):
        want = _jax(eight_devices, q, k, v, n=n, causal=True, window=window,
                    use_flash=use_flash)
        for rank, out in reports.items():
            rows = slice(rank * s_local, (rank + 1) * s_local)
            np.testing.assert_allclose(out[tier], want[rows], rtol=2e-5,
                                       atol=2e-5,
                                       err_msg=f"{tier} rank {rank}")
            np.testing.assert_array_equal(out[f"{tier} gathered"],
                                          np.concatenate([
                                              reports[r][tier]
                                              for r in range(n)]))


def test_gloo_four_rank_ring_gradients_match_jax(eight_devices, gloo_ring):
    """The gradients' ring circuit across four processes: each rank's
    dq, dk and dv (dk/dv ridden home with their block) equal its rows of
    JAX's n=4 gradients, in both tiers."""
    (q, k, v, window, w, n), reports = gloo_ring
    s_local = q.shape[0] // n
    for tier, use_flash in (("flash", True), ("plain", False)):
        want = _jax_grads(eight_devices, q, k, v, w, n=n, causal=True,
                          window=window, use_flash=use_flash)
        for rank, out in reports.items():
            rows = slice(rank * s_local, (rank + 1) * s_local)
            _assert_grads(out[f"{tier} grads"], [g[rows] for g in want])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("window,h_kv", [(None, 2), (24, 1)])
def test_thread_ring_runs_the_ring_backward(comm1, window, h_kv):
    """``chip_smoke.py``'s emulated ring: one thread per rank runs
    ``_flash_forward`` and ``_flash_ring_backward`` on its shards, with
    ``ring_shift`` stood in by a swap at a barrier. Each rank's dq, dk and
    dv equal its rows of the one-rank flash tier's gradients."""
    cs = _chip_smoke()
    n, s = 4, 64
    s_local = s // n
    q, k, v = _qkv(s, 4, 128, seed=31, h_kv=h_kv)
    w = np.random.RandomState(32).randn(s, 4, 128).astype(np.float32)
    whole = _port_grads(comm1, q, k, v, w, causal=True, window=window,
                        use_flash=True)
    ring = cs.ThreadRing(n)

    def rank(r):
        comm = st.Communicator(shape=(n,), axis_names=("sp",), rank=r,
                               device=torch.device("cpu"))
        qs, ks, vs, ws = (torch.from_numpy(x[r * s_local:(r + 1) * s_local])
                          for x in (q, k, v, w))
        out, m, l = tra._flash_forward(qs, ks, vs, comm, True, "sp", window)
        return tra._flash_ring_backward(qs, ks, vs, out, m, l, ws, comm,
                                        True, "sp", window)

    with cs.patched(tra, ring_shift=ring.shift):
        grads = ring.run(rank)
    assert tra.ring_shift is st.ring_shift
    # K and V: n - 1 hops forward and backward; dk and dv: n hops home
    assert ring.calls == n * (4 * (n - 1) + 2 * n)
    for r, got in enumerate(grads):
        rows = slice(r * s_local, (r + 1) * s_local)
        _assert_grads([g.numpy() for g in got], [g[rows] for g in whole])


def test_thread_ring_raises_a_rank_failure_without_hanging():
    cs = _chip_smoke()
    ring = cs.ThreadRing(3)
    comm = [st.Communicator(shape=(3,), axis_names=("sp",), rank=r,
                            device=torch.device("cpu")) for r in range(3)]

    def rank(r):
        if r == 1:
            raise ValueError("rank 1 failed")
        return ring.shift(torch.zeros(2), comm[r])

    with pytest.raises(ValueError, match="rank 1 failed"):
        ring.run(rank)
    assert ring.barrier.broken


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_every_rank_of_a_thread_world_calls_backward(comm1, use_flash):
    """``.backward()`` on each rank's loss inside ``LocalWorld.run``: the
    ring backward meets at the rendezvous from the rank threads, and the
    gradients are the one-rank ones over the whole sequence."""
    n, s_local, h, d = 2, 16, 2, 8
    rng = np.random.RandomState(3)
    q, k, v, w = (rng.randn(n * s_local, h, d).astype(np.float32)
                  for _ in range(4))

    def grads(comm):
        xs = [st.sequence_shard_from_numpy(a, comm).requires_grad_(True)
              for a in (q, k, v)]
        out = st.make_ring_attention_fn(comm, causal=True,
                                        use_flash=use_flash)(*xs)
        (out * st.sequence_shard_from_numpy(w, comm)).sum().backward()
        return [x.grad for x in xs]

    want = grads(comm1)
    got = st.LocalWorld(n, ("sp",), device="cpu").run(grads)
    for i in range(3):
        torch.testing.assert_close(torch.cat([g[i] for g in got]), want[i],
                                   rtol=2e-5, atol=2e-5)


def test_a_backward_after_run_returned_fails_at_once():
    """The outputs' backward outside ``world.run`` would wait at the
    rendezvous for ranks that never come: it raises, naming the way."""
    world = st.LocalWorld(2, device="cpu")
    x = torch.ones(4, requires_grad=True)
    outs = world.run(lambda c: st.ring_shift(x * (c.rank + 1), c))
    with pytest.raises(RuntimeError, match="inside world.run"):
        torch.stack(outs).sum().backward()
    again = world.run(lambda c: st.ring_shift(x * (c.rank + 1), c))
    assert [o.tolist() for o in again] == [[2.0] * 4, [1.0] * 4]
