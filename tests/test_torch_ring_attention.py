"""smi_tpu_torch's ring attention (forward) against the JAX package's.

The same seeded float32 numpy q/k/v go through the JAX package's
``make_ring_attention_fn`` on the fake CPU mesh (its flash tier in
interpret mode) and through the port's on CPU tensors: a one-rank
communicator in this process, and one gloo case on a 4-rank ``sp`` ring
(``tests/torch_gloo_worker.py``) where each rank's shard is held to its
rows of JAX's output. Tolerances are ``tests/test_flash.py``'s: 2e-5 for
f32, 3e-2 for bf16.
"""

import math
import sys
from pathlib import Path

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
    q, k, v = _qkv(16, 2, 128, seed=8)
    shards = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    plain = tra.ring_attention_shard(*shards, comm1, causal=True,
                                     use_flash=False)
    plain.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in shards)
    flash = tra.ring_attention_shard(*shards, comm1, causal=True,
                                     use_flash=True)
    torch.testing.assert_close(flash, plain, rtol=2e-5, atol=2e-5)
    with pytest.raises(NotImplementedError, match="Queue 2 items 12-13"):
        flash.sum().backward()


def test_ring_shift_on_one_rank(comm1):
    x = torch.arange(6.0).reshape(2, 3)
    for offset in (1, -1, 0, 3):
        assert st.ring_shift(x, comm1, offset=offset) is x
    with pytest.raises(NotImplementedError, match="neighbour-stream"):
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


def test_gloo_four_rank_ring_matches_jax(eight_devices):
    """A 4-rank ``sp`` ring under gloo: S=64, H=4, kv_heads=2, causal,
    window 24. Every rank's shard of both tiers equals its rows of JAX's
    4-device ring (flash tier in interpret mode); ``ring_shift`` by 1, -1
    and 2 delivers the expected shards; the gathered sequence is whole."""
    n, s, h, h_kv, d, window = 4, 64, 4, 2, 128, 24
    q, k, v = _qkv(s, h, d, seed=23, h_kv=h_kv)
    reports = torch_gloo_worker.run_group(
        torch_gloo_worker.run_attention, n, (q, k, v, window))
    s_local = s // n
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
