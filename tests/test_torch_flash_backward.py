"""smi_tpu_torch's flash-attention backward against the JAX package's.

The same seeded float32 numpy inputs go through the JAX package's
``flash_block_backward_dq`` / ``flash_block_backward_dkdv`` (their Pallas
kernels in interpret mode) and through the port's wrappers on CPU
tensors, which run the kernels' plain PyTorch versions. The saved
statistics (``m``, ``linv = 1/l``, ``delta = rowsum(dout * out)``) come
from a plain forward over the query rows' own diagonal block and the
block under test, so every row has seen a live key, as in a ring.
Tolerances are ``tests/test_flash.py``'s: 2e-5 for f32, 3e-2 for bf16.
The CUDA kernels are held to these plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_gpu.py``).
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smi_tpu.kernels import flash as jflash
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import flash as tflash


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _stats(q, k, v, dout, q_off, k_off, causal, window, dtype):
    """``(m, linv, delta)`` as float32 numpy: the forward's statistics
    over the diagonal block (the keys at ``q_off``) and the block under
    test, and delta from the output rounded to ``dtype``."""
    h, s_q, d = q.shape
    scale = 1.0 / math.sqrt(d)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    state = tflash.fresh_state(h, s_q, d, "cpu")
    for off in dict.fromkeys((q_off, k_off)):
        state = tflash.flash_block_attend_plain(tq, tk, tv, *state, q_off,
                                                off, causal, scale,
                                                window=window)
    m, l, acc = state
    assert (l > 0).all()
    out = (acc / l.transpose(1, 2)).to(dtype).float()
    delta = (torch.from_numpy(dout).to(dtype).float() * out).sum(-1)
    return m.numpy(), (1.0 / l).numpy(), delta[:, None].numpy()


def _both(q, k, v, dout, q_off, k_off, causal, window=None,
          dtype=torch.float32, jdtype=jnp.float32):
    """dq and (dk, dv) of one block through the port and through JAX
    (interpret mode), as float32 numpy: ``(port, jax)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    stats = _stats(q, k, v, dout, q_off, k_off, causal, window, dtype)
    tin = [torch.from_numpy(x).to(dtype) for x in (q, k, v, dout)]
    tin += [torch.from_numpy(x) for x in stats]
    jin = [jnp.asarray(x).astype(jdtype) for x in (q, k, v, dout)]
    jin += [jnp.asarray(x) for x in stats]
    args = (q_off, k_off, causal, scale)
    port = (tflash.flash_block_backward_dq(*tin, *args, window=window),
            *tflash.flash_block_backward_dkdv(*tin, *args, window=window))
    want = (jflash.flash_block_backward_dq(*jin, *args, interpret=True,
                                           window=window),
            *jflash.flash_block_backward_dkdv(*jin, *args, interpret=True,
                                              window=window))
    for t in port:
        assert t.dtype == torch.float32 and t.is_contiguous()
    return ([t.numpy() for t in port],
            [np.asarray(x, dtype=np.float32) for x in want])


def _assert_close(port, want, tol=2e-5):
    for name, a, b in zip(("dq", "dk", "dv"), port, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("q_off,k_off,causal", [
    (0, 0, True),      # fresh: the diagonal of a one-rank ring
    (0, 0, False),
    (48, 16, True),    # a past block, partly overlapping the diagonal
    (32, 32, True),    # a mid-ring diagonal block
    (64, 0, False),    # a non-causal step at offsets
])
def test_backward_matches_jax(q_off, k_off, causal):
    h, s_q, s_k, d = 2, 32, 48, 128
    q, dout = _arrays(1, (h, s_q, d), (h, s_q, d))
    k, v = _arrays(2, (h, s_k, d), (h, s_k, d))
    _assert_close(*_both(q, k, v, dout, q_off, k_off, causal))


def test_future_block_gives_exact_zeros():
    """A block wholly in the causal future contributes nothing: both
    gradients are zeros bit for bit, as in JAX."""
    h, s, d = 2, 32, 128
    q, dout, k, v = _arrays(3, *[(h, s, d)] * 4)
    port, want = _both(q, k, v, dout, 0, 64, True)
    for a, b in zip(port, want):
        np.testing.assert_array_equal(a, 0.0)
        np.testing.assert_array_equal(b, 0.0)


@pytest.mark.parametrize("h_kv", [2, 1])
def test_gqa_reduces_the_group(h_kv):
    """dk/dv come back with the K/V head count, summed over each group
    of query heads, as JAX reduces the group in its kernel."""
    h, s_q, s_k, d = 4, 32, 48, 128
    q, dout = _arrays(4, (h, s_q, d), (h, s_q, d))
    k, v = _arrays(5, (h_kv, s_k, d), (h_kv, s_k, d))
    port, want = _both(q, k, v, dout, 16, 0, True)
    assert port[1].shape == (h_kv, s_k, d)
    _assert_close(port, want)


@pytest.mark.parametrize("window", [8, 24])
def test_window_matches_jax(window):
    """Window edges inside the block (rows whose window starts past the
    block's first key) and, at 8, keys no query of the block reaches."""
    h, s_q, s_k, d = 2, 32, 48, 128
    q, dout = _arrays(6, (h, s_q, d), (h, s_q, d))
    k, v = _arrays(7, (h, s_k, d), (h, s_k, d))
    port, want = _both(q, k, v, dout, 40, 16, True, window=window)
    _assert_close(port, want)
    if window == 8:   # keys 16..23 lie before every row's window
        np.testing.assert_array_equal(port[1][:, :8], 0.0)


def test_bf16_matches_jax():
    h, s, d = 2, 32, 128
    q, dout, k, v = _arrays(8, *[(h, s, d)] * 4)
    port, want = _both(q, k, v, dout, 32, 16, True, dtype=torch.bfloat16,
                       jdtype=jnp.bfloat16)
    _assert_close(port, want, tol=3e-2)


def test_multi_chunk_jax_tiling(monkeypatch):
    """JAX with several key chunks and sub-tiles per grid step (the
    tiling ``tests/test_flash.py`` patches in) agrees with the port's
    one-pass plain version: the tiling is JAX's concern, not the
    result's."""
    monkeypatch.setattr(jflash, "BLOCK_Q", 16)
    monkeypatch.setattr(jflash, "BLOCK_K", 8)
    monkeypatch.setattr(jflash, "KV_CHUNK_BUDGET", 32768)
    h, h_kv, s, d = 2, 1, 128, 128
    q, dout = _arrays(9, (h, s, d), (h, s, d))
    k, v = _arrays(10, (h_kv, s, d), (h_kv, s, d))
    for causal in (True, False):
        _assert_close(*_both(q, k, v, dout, 0, 0, causal))
    _assert_close(*_both(q, k, v, dout, 128, 64, True, window=40))


def test_plain_row_chunks_match_one_chunk(monkeypatch):
    """The plain versions walk query rows in chunks to bound memory at
    long context; dq's rows are independent and dk/dv add the chunks,
    so chunking changes only the summation order."""
    h, s, d = 2, 48, 128
    q, dout, k, v = (torch.from_numpy(x) for x in _arrays(11,
                                                          *[(h, s, d)] * 4))
    stats = [torch.from_numpy(x) for x in _stats(
        *(t.numpy() for t in (q, k, v, dout)), 0, 0, True, 24,
        torch.float32)]
    args = (q, k, v, dout, *stats, 0, 0, True, 1.0 / math.sqrt(d))
    whole = (tflash.flash_block_backward_dq_plain(*args, window=24),
             *tflash.flash_block_backward_dkdv_plain(*args, window=24))
    monkeypatch.setattr(tflash, "PLAIN_SCORE_ELEMS", h * s * 5)
    parts = (tflash.flash_block_backward_dq_plain(*args, window=24),
             *tflash.flash_block_backward_dkdv_plain(*args, window=24))
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def _operands(dtype=torch.float32):
    h, s, d = 2, 16, 128
    q = torch.zeros((h, s, d), dtype=dtype)
    row = torch.zeros((h, 1, s))
    return [q, q.clone(), q.clone(), q.clone(), row, row.clone(),
            row.clone()]


@pytest.mark.parametrize("case,error,match", [
    ("f64", TypeError, "float32 or bfloat16"),
    ("dout_dtype", TypeError, "dout must be torch.float32 like q"),
    ("delta_bf16", TypeError, "delta must be float32"),
    ("linv_shape", ValueError, "linv must have shape"),
    ("dout_shape", ValueError, "dout must have shape"),
    ("strided_dout", ValueError, "dout must be contiguous"),
    ("meta", ValueError, "no kernel for meta"),
])
@pytest.mark.parametrize("kernel", ["dq", "dkdv"])
def test_operand_checks_raise(case, error, match, kernel):
    ops = _operands(torch.float64 if case == "f64" else torch.float32)
    if case == "dout_dtype":
        ops[3] = ops[3].to(torch.bfloat16)
    elif case == "delta_bf16":
        ops[6] = ops[6].to(torch.bfloat16)
    elif case == "linv_shape":
        ops[5] = torch.zeros((2, 16, 1))
    elif case == "dout_shape":
        ops[3] = torch.zeros((2, 8, 128))
    elif case == "strided_dout":
        ops[3] = torch.zeros((2, 128, 16)).transpose(1, 2)
    elif case == "meta":
        ops = [t.to("meta") for t in ops]
    fn = {"dq": tflash.flash_block_backward_dq,
          "dkdv": tflash.flash_block_backward_dkdv}[kernel]
    with pytest.raises(error, match=match):
        fn(*ops, 0, 0, True, 0.1)


def test_window_without_causal_raises():
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_block_backward_dq(*_operands(), 0, 0, False, 0.1,
                                       window=8)


def test_cpu_calls_launch_nothing():
    before = dict(_build.LAUNCHES)
    ops = _operands()
    tflash.flash_block_backward_dq(*ops, 0, 0, True, 0.1)
    tflash.flash_block_backward_dkdv(*ops, 0, 0, True, 0.1)
    assert _build.LAUNCHES == before
    assert {"flash_bwd_dq", "flash_bwd_dkdv"} <= set(before)
    assert _build.source_of("flash_bwd_dq") == "flash_bwd"
    assert _build.source_of("flash_bwd_dkdv") == "flash_bwd"
    assert "flash_bwd" in _build.SOURCES and "flash_bwd" in _build.FMA_SOURCES


def test_backward_tile_plan_fits_hopper_shared_memory():
    """The sums ``kSmem`` in ``csrc/flash_bwd.cu`` makes. bf16: 1024
    bytes of alignment slack, the block's own rows (dq: Q and dO of 128
    rows; dkdv: K and V of 128 keys, 64 in the 64-key form), two stages
    of the streamed tiles (dq: K and V of 64 keys; dkdv: Q and dO of 64
    rows, 128 in the 64-key form, with three f32 statistic rows) and 64
    bytes of mbarriers. f32, rows padded by 16 bytes: dq holds Q and dO
    (128 rows), one K and one V tile (32 keys) and the 128 x 48 dS tile;
    dkdv holds K and V (128 keys), one Q and one dO tile (32 rows) with
    their statistics, and the 128 x 48 P^T and dS^T tiles."""
    f32, bf16 = torch.float32, torch.bfloat16
    dq, dkdv = tflash.KERNEL_BWD_DQ, tflash.KERNEL_BWD_DKDV
    assert tflash.bwd_smem_bytes(dq, 128, f32) == \
        4 * ((2 * 128 + 2 * 32) * 132 + 128 * 48) == 193_536
    assert tflash.bwd_smem_bytes(dkdv, 128, f32) == \
        4 * (2 * 128 * 132 + 2 * 32 * 132 + 96 + 2 * 128 * 48) == 218_496
    assert tflash.bwd_smem_bytes(dq, 128, bf16) == \
        1024 + 2 * 128 * 256 + 2 * 2 * 64 * 256 + 64 == 132_160
    assert tflash.bwd_smem_bytes(dkdv, 128, bf16) == \
        1024 + 2 * 128 * 256 + 2 * 2 * 64 * 256 + 2 * 3 * 64 * 4 + 64 \
        == 133_696
    assert tflash.bwd_smem_bytes(dkdv, 128, bf16, split=True) == \
        1024 + 2 * 64 * 256 + 2 * 2 * 128 * 256 + 2 * 3 * 128 * 4 + 64 \
        == 168_000
    for d in tflash.HEAD_DIMS:
        for dt in (f32, bf16):
            for kernel in (dq, dkdv):
                for split in (False, True):
                    assert tflash.bwd_smem_bytes(kernel, d, dt, split) <= \
                        _build.SMEM_BYTES_LIMIT
                assert tflash._bwd_plan(kernel, d, dt) is not None
    assert tflash._bwd_plan(dq, 128, bf16) == (128, 64)
    assert tflash._bwd_plan(dq, 256, bf16) == (128, 32)
    assert tflash._bwd_plan(dq, 128, f32) == (128, 32)
    assert tflash._bwd_plan(dq, 256, f32) == (64, 32)
    assert tflash._bwd_plan(dkdv, 128, bf16) == (64, 128)
    assert tflash._bwd_plan(dkdv, 256, bf16) == (32, 128)
    assert tflash._bwd_plan(dkdv, 128, f32) == (32, 128)
    assert tflash._bwd_plan(dkdv, 256, f32) == (32, 32)
    assert tflash._bwd_plan(dkdv, 96, f32) is None


@pytest.mark.parametrize("kernel,plan,h,h_kv,s_q,s_k,d,blocks", [
    ("flash_bwd_dq", (128, 64), 8, 8, 8192, 8192, 128, 512),
    ("flash_bwd_dq", (128, 64), 8, 1, 2048, 2048, 128, 128),
    ("flash_bwd_dq", (64, 32), 4, 2, 200, 77, 256, 16),
    ("flash_bwd_dkdv", (64, 128), 8, 8, 8192, 8192, 128, 512),
    ("flash_bwd_dkdv", (64, 128), 8, 1, 2048, 2048, 128, 16),
    ("flash_bwd_dkdv", (128, 64), 8, 1, 2048, 2048, 128, 32),
    ("flash_bwd_dkdv", (32, 128), 4, 2, 200, 200, 256, 8),
    ("flash_bwd_dkdv", (32, 128), 4, 2, 300, 129, 64, 4),
])
def test_backward_grid_mirrors_the_launch(kernel, plan, h, h_kv, s_q, s_k,
                                          d, blocks):
    """``bwd_blocks`` counts the blocks the C entry points launch: dq one
    a (query block, head); dk/dv one a (key block, K/V head) and two at
    D=256, where each block takes half of the output columns."""
    assert tflash.bwd_blocks(kernel, plan, h, h_kv, s_q, s_k, d) == blocks


@pytest.mark.parametrize("s_k,h_kv,d,sms,split", [
    (8192, 8, 128, 132, False),   # 512 blocks of 128 keys
    (2048, 1, 128, 132, True),    # the 4-rank GQA ring's block: 16
    (2048, 4, 128, 132, True),    # 64: the 64-key form's 128 fit a wave
    (2048, 8, 128, 132, False),   # 128: its 256 would take two
    (2048, 2, 256, 132, True),    # 16 key blocks x 2 heads x 2 halves
    (2048, 4, 256, 132, False),   # 128
    (2048, 8, 128, 256, True),    # a card with more SMs
    (100, 1, 64, 1, False),       # one block fills a one-SM card
])
def test_gqa_few_blocks_take_the_64_key_form(s_k, h_kv, d, sms, split):
    """bf16 dk/dv takes its 64-key form (two warpgroups on the same keys,
    a 2x taller query tile) exactly where its doubled grid still fits one
    wave of the card's SMs; f32 and dq have one form."""
    dkdv, bf16 = tflash.KERNEL_BWD_DKDV, torch.bfloat16
    plan = tflash._bwd_plan(dkdv, d, bf16, s_k=s_k, h_kv=h_kv, sms=sms)
    normal = tflash._bwd_plan(dkdv, d, bf16)
    assert (plan != normal) == split
    if split:
        assert plan == (2 * normal[0], 64)
        assert tflash.bwd_blocks(dkdv, plan, h_kv, h_kv, 0, s_k, d) == \
            2 * tflash.bwd_blocks(dkdv, normal, h_kv, h_kv, 0, s_k, d)
    for kernel, dt in ((dkdv, torch.float32),
                       (tflash.KERNEL_BWD_DQ, bf16)):
        assert tflash._bwd_plan(kernel, d, dt, s_k=s_k, h_kv=h_kv,
                                sms=sms) == tflash._bwd_plan(kernel, d, dt)


def test_earlier_backward_source_takes_its_own_plan(monkeypatch):
    """``chip_smoke.py --earlier .../flash_bwd.cu`` times the parent's
    backward, whose C entry refuses any plan but its own: while it is
    swapped in, the wrappers ask for that plan and its library; after,
    the tree's again."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    tree_lib, earlier_lib = object(), object()
    monkeypatch.setitem(_build._libs, "flash_bwd", tree_lib)
    source = object.__new__(chip_smoke.EarlierSource)
    source.stem, source.lib = "flash_bwd", earlier_lib
    dq, dkdv = tflash.KERNEL_BWD_DQ, tflash.KERNEL_BWD_DKDV
    bf16, f32 = torch.bfloat16, torch.float32
    with source.swapped():
        assert _build._libs["flash_bwd"] is earlier_lib
        assert tflash._bwd_plan(dq, 128, bf16) == (64, 64)
        assert tflash._bwd_plan(dq, 256, f32) == (64, 32)
        assert tflash._bwd_plan(dkdv, 128, bf16, s_k=2048, h_kv=1,
                                sms=132) == (32, 64)
    assert _build._libs["flash_bwd"] is tree_lib
    assert tflash._bwd_plan(dq, 128, bf16) == (128, 64)
    flash_fwd = object.__new__(chip_smoke.EarlierSource)
    flash_fwd.stem, flash_fwd.lib = "flash_fwd", earlier_lib
    monkeypatch.setitem(_build._libs, "flash_fwd", tree_lib)
    with flash_fwd.swapped():
        assert tflash._bwd_plan(dq, 128, bf16) == (128, 64)
