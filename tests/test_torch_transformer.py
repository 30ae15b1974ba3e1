"""smi_tpu_torch's transformer block and train step against the JAX
package's.

The same parameters (both packages draw them from one
``np.random.RandomState``) and the same seeded float32 numpy data go
through the JAX package's ``block_shard`` / ``stack_shard`` /
``make_train_step`` on the fake CPU mesh and through the port's on CPU
tensors: a 1x1 ``(dp, sp)`` grid in this process, and one gloo group on
a 2x2 grid (``tests/torch_gloo_worker.py``). The flash tier runs its
kernels' plain versions on the CPU, and JAX's in interpret mode. The
train step is held by its loss and every parameter's gradient, not by
the updated parameters: ``lr * g / n_total`` would hide a wrong
gradient. Bars: ``tests/test_transformer.py``'s 2e-4 in f32 and 5e-2 for
bf16 compute.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.models import transformer as jtf
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.models import transformer as ttf

# spawned children import the worker by module name through this path
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_gloo_worker  # noqa: E402

TOL = 2e-4


def _configs(**kw):
    return jtf.BlockConfig(**kw), st.BlockConfig(**kw)


def _data(b, s, e, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, e).astype(np.float32),
            rng.randn(b, s, e).astype(np.float32))


@pytest.fixture
def comm11():
    return st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device="cpu")


def _jax_comm(devices, dp=1, sp=1):
    return smi.make_communicator(shape=(dp, sp), axis_names=("dp", "sp"),
                                 devices=devices[:dp * sp])


def _jax_fwd(devices, cfg, use_flash, layers=1):
    comm = _jax_comm(devices)
    fwd = jtf.stack_shard if layers > 1 else jtf.block_shard
    return jax.jit(jax.shard_map(
        lambda p, xx: fwd(p, xx, comm, cfg, use_flash=use_flash,
                          interpret=use_flash),
        mesh=comm.mesh, in_specs=(P(), P()), out_specs=P(),
        check_vma=False))


def _jax_loss_and_grads(devices, cfg, params, x, y, use_flash, layers=1):
    fn = _jax_fwd(devices, cfg, use_flash, layers)
    loss, grads = jax.value_and_grad(
        lambda p: jnp.sum((fn(p, jnp.asarray(x)) - jnp.asarray(y)) ** 2))(
        {n: jnp.asarray(a) for n, a in params.items()})
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def _assert_grads(model, want, tol=TOL):
    for name, p in model.weights().items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=tol,
                                   atol=tol, err_msg=name)


# ------------------------------------------------------------ parameters --


@pytest.mark.parametrize("kw", [
    dict(embed=32, heads=2, head_dim=128),
    dict(embed=64, heads=4, head_dim=64, kv_heads=2, mlp_ratio=3),
])
def test_init_params_equal_jax(kw):
    jcfg, tcfg = _configs(**kw)
    for seed in (0, 7):
        want = jtf.init_params(jcfg, seed=seed)
        got = st.init_params(tcfg, seed=seed)
        assert set(got) == set(want)
        for n in want:
            assert got[n].dtype == np.float32
            np.testing.assert_array_equal(got[n], np.asarray(want[n]))
    want = jtf.init_stack_params(jcfg, 3, seed=2)
    got = st.init_stack_params(tcfg, 3, seed=2)
    for n in want:
        assert got[n].shape[0] == 3
        np.testing.assert_array_equal(got[n], np.asarray(want[n]))


def test_kv_heads_must_divide():
    with pytest.raises(ValueError, match="divide"):
        st.init_params(st.BlockConfig(embed=32, heads=4, kv_heads=3))


def test_params_round_trip():
    cfg = st.BlockConfig(embed=32, heads=4, head_dim=128, kv_heads=2)
    params = st.init_params(cfg, seed=3)
    block = st.params_from_numpy(params, cfg, device="cpu")
    assert isinstance(block, st.TransformerBlock)
    assert [n for n, _ in block.named_parameters()] == list(ttf.PARAM_NAMES)
    back = st.params_to_numpy(block)
    for n in params:
        np.testing.assert_array_equal(back[n], params[n])
    stacked = st.init_stack_params(cfg, 2, seed=3)
    stack = st.params_from_numpy(stacked, cfg, device="cpu")
    assert isinstance(stack, st.TransformerStack) and len(stack.blocks) == 2
    back = st.params_to_numpy(stack)
    for n in stacked:
        np.testing.assert_array_equal(back[n], stacked[n])
    # the module holds copies: training it leaves the arrays alone
    with torch.no_grad():
        block.wo.add_(1.0)
    assert not np.array_equal(st.params_to_numpy(block)["wo"], params["wo"])


def test_params_from_numpy_refuses_bad_leaves():
    cfg = st.BlockConfig(embed=32, heads=2, head_dim=128)
    params = st.init_params(cfg)
    with pytest.raises(TypeError, match="float32"):
        st.params_from_numpy({**params, "w1": params["w1"].astype(np.float64)},
                             cfg, device="cpu")
    with pytest.raises(ValueError, match="wo has shape"):
        st.params_from_numpy({**params, "wo": params["wo"][:-1]}, cfg,
                             device="cpu")


def test_modules_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        st.TransformerBlock(st.BlockConfig(embed=32))


def test_data_shard_on_one_rank(comm11):
    x, _ = _data(2, 8, 4, seed=0)
    shard = st.data_shard_from_numpy(x, comm11, dtype=torch.bfloat16)
    assert shard.dtype == torch.bfloat16 and shard.shape == x.shape
    with pytest.raises(ValueError, match="B, S, E"):
        st.data_shard_from_numpy(x[0], comm11)


# --------------------------------------------------------------- forward --


def test_reference_block_matches_jax():
    jcfg, tcfg = _configs(embed=32, heads=4, head_dim=16, kv_heads=2,
                          window=6)
    params = jtf.init_params(jcfg, seed=5)
    x, _ = _data(2, 12, 32, seed=6)
    np.testing.assert_allclose(
        st.reference_block(st.init_params(tcfg, seed=5), x, tcfg),
        jtf.reference_block(params, jnp.asarray(x), jcfg),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("layers", [1, 3])
def test_block_and_stack_match_jax(eight_devices, comm11, use_flash, layers):
    """The block and a 3-layer stack (activation checkpointing per block)
    equal JAX's ``block_shard`` / ``stack_shard`` in both tiers, with
    GQA 4:2 and a window of 12."""
    jcfg, tcfg = _configs(embed=32, heads=4, head_dim=128, kv_heads=2,
                          window=12)
    params = (st.init_stack_params(tcfg, layers, seed=8) if layers > 1
              else st.init_params(tcfg, seed=8))
    x, _ = _data(2, 32, 32, seed=9)
    model = st.params_from_numpy(params, tcfg, device="cpu")
    got = model(torch.from_numpy(x), comm11, use_flash=use_flash)
    want = _jax_fwd(eight_devices, jcfg, use_flash, layers)(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    if layers == 1:
        np.testing.assert_allclose(got.detach().numpy(),
                                   st.reference_block(params, x, tcfg),
                                   rtol=TOL, atol=TOL)
    functional = (st.stack_shard if layers > 1 else st.block_shard)(
        {n: torch.from_numpy(a) for n, a in params.items()},
        torch.from_numpy(x), comm11, tcfg, use_flash=use_flash)
    torch.testing.assert_close(functional, got, rtol=0, atol=0)


# ------------------------------------------------------------ train step --


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("layers", [1, 3])
def test_train_step_gradients_match_jax(eight_devices, comm11, use_flash,
                                        layers):
    """One step's loss and every gradient equal ``jax.value_and_grad`` of
    the same loss, and the update is ``p - lr * g / n_total``."""
    jcfg, tcfg = _configs(embed=32, heads=4, head_dim=128, kv_heads=2,
                          window=12)
    params = (st.init_stack_params(tcfg, layers, seed=10) if layers > 1
              else st.init_params(tcfg, seed=10))
    b, s, lr = 2, 32, 1e-2
    x, y = _data(b, s, 32, seed=11)
    model = st.params_from_numpy(params, tcfg, device="cpu")
    step = st.make_train_step(comm11, tcfg, lr=lr, use_flash=use_flash,
                              layers=layers)
    before = dict(_build.LAUNCHES)
    loss = step(model, torch.from_numpy(x), torch.from_numpy(y))
    assert _build.LAUNCHES == before   # CPU tensors: the plain versions
    lref, gref = _jax_loss_and_grads(eight_devices, jcfg, params, x, y,
                                     use_flash, layers)
    np.testing.assert_allclose(float(loss), lref / (b * s), rtol=TOL)
    if layers == 1:
        _assert_grads(model, gref)
    else:
        for i, block in enumerate(model.blocks):
            _assert_grads(block, {n: g[i] for n, g in gref.items()})
    new = st.params_to_numpy(model)
    for n in params:
        np.testing.assert_allclose(
            new[n], params[n] - lr * gref[n] / (b * s), rtol=1e-6,
            atol=1e-6, err_msg=n)


def test_train_step_bf16_matches_jax(eight_devices, comm11):
    """bf16 compute with f32 master weights: the loss within
    ``test_transformer.py``'s 5e-2 of JAX's bf16 step, and each gradient
    within 5e-2 of JAX's by ``||g - g'|| / ||g'||``; parameters and
    gradients stay f32."""
    jcfg, tcfg = _configs(embed=32, heads=4, head_dim=128, kv_heads=2,
                          compute_dtype="bfloat16")
    params = st.init_params(tcfg, seed=12)
    x, y = _data(2, 32, 32, seed=13)
    model = st.params_from_numpy(params, tcfg, device="cpu")
    loss = st.make_train_step(comm11, tcfg, use_flash=True)(
        model, torch.from_numpy(x), torch.from_numpy(y))
    lref, gref = _jax_loss_and_grads(eight_devices, jcfg, params, x, y, True)
    np.testing.assert_allclose(float(loss), lref / 64, rtol=5e-2)
    for n, p in model.weights().items():
        assert p.dtype == p.grad.dtype == torch.float32
        g = p.grad.numpy()
        assert np.linalg.norm(g - gref[n]) <= 5e-2 * np.linalg.norm(gref[n])


def test_training_reduces_loss(comm11):
    cfg = st.BlockConfig(embed=32, heads=2, head_dim=128, window=8)
    model = st.TransformerBlock(cfg, st.init_params(cfg, seed=14),
                                device="cpu")
    x, y = _data(2, 16, 32, seed=15)
    step = st.make_train_step(comm11, cfg, lr=5e-2, use_flash=True)
    losses = [float(step(model, torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(4)]
    assert losses[-1] < losses[0] * 0.9, losses


def test_train_step_checks_the_depth(comm11):
    cfg = st.BlockConfig(embed=32, heads=2, head_dim=128)
    stack = st.TransformerStack(cfg, layers=2, device="cpu")
    x, _ = _data(1, 8, 32, seed=0)
    with pytest.raises(ValueError, match="1 layer"):
        st.make_train_step(comm11, cfg)(stack, torch.from_numpy(x),
                                        torch.from_numpy(x))
    with pytest.raises(ValueError, match="3 layers asked"):
        st.TransformerStack(cfg, layers=3,
                            params=st.init_stack_params(cfg, 2),
                            device="cpu")


def test_gloo_two_by_two_train_step_matches_jax(eight_devices):
    """A (dp, sp) = (2, 2) gloo group takes one flash-tier step: every
    rank's loss and summed gradients equal ``jax.value_and_grad`` on the
    gathered data, and its updated parameters equal JAX's
    ``make_train_step`` on the 2x2 fake mesh."""
    jcfg, tcfg = _configs(embed=32, heads=2, head_dim=128, window=12)
    params = st.init_params(tcfg, seed=16)
    b, s, lr = 4, 32, 1e-2
    x, y = _data(b, s, 32, seed=17)
    reports = torch_gloo_worker.run_group(
        torch_gloo_worker.run_train_step, 4,
        ((2, 2), tcfg, params, x, y, lr))
    lref, gref = _jax_loss_and_grads(eight_devices, jcfg, params, x, y,
                                     False)
    jstep = jtf.make_train_step(_jax_comm(eight_devices, 2, 2), jcfg, lr=lr,
                                use_flash=False)
    jparams, jloss = jstep({n: jnp.asarray(a) for n, a in params.items()},
                           jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(jloss), lref / (b * s), rtol=TOL)
    for rank, out in reports.items():
        np.testing.assert_allclose(out["loss"], lref / (b * s), rtol=TOL)
        for n in params:
            np.testing.assert_allclose(out["grads"][n], gref[n], rtol=TOL,
                                       atol=TOL, err_msg=f"{n} rank {rank}")
            np.testing.assert_allclose(out["params"][n],
                                       np.asarray(jparams[n]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{n} rank {rank}")
