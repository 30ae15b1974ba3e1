"""smi_tpu_torch's flash-attention forward against the JAX package's.

The same seeded float32 numpy inputs go through the JAX package's
``flash_attend_fused`` / ``flash_block_attend`` (their Pallas kernels in
interpret mode) and through the port's wrappers on CPU tensors, which
run the kernels' plain PyTorch versions. Shapes are those of
``tests/test_flash.py``. Tolerances are that file's: 2e-5 for out/acc,
1e-5 for m/l, 3e-2 for bf16.

Rows with no live key differ by design: the port keeps them at exactly
``(NEG_INF, 0, 0)`` (a masked key adds nothing), while the JAX kernels
let them hold transient garbage that the first live key zeroes. So the
state is compared on rows that have seen a live key, and the port's
other rows are held to ``(NEG_INF, 0, 0)`` exactly. The CUDA kernels are
held to these plain versions on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``).
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

NEG_INF = np.float32(-1e30)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _jax(*xs, dtype=jnp.float32):
    return [jnp.asarray(x).astype(dtype) for x in xs]


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _assert_state(got, want, live, atol_stat=1e-5, atol_acc=2e-5):
    """``got`` = the port's (m, l, acc), ``want`` = JAX's, compared on
    the ``(H, Sq)`` rows in ``live``; the port's dead rows are exact."""
    m, l, acc = (_np(x) for x in got)
    jm, jl, jacc = (_np(x) for x in want)
    np.testing.assert_allclose(m[:, 0][live], jm[:, 0][live], rtol=atol_stat,
                               atol=atol_stat)
    np.testing.assert_allclose(l[:, 0][live], jl[:, 0][live], rtol=atol_stat,
                               atol=atol_stat)
    np.testing.assert_allclose(acc[live], jacc[live], rtol=atol_acc,
                               atol=atol_acc)
    dead = ~live
    np.testing.assert_array_equal(m[:, 0][dead], NEG_INF)
    np.testing.assert_array_equal(l[:, 0][dead], 0.0)
    np.testing.assert_array_equal(acc[dead], 0.0)


def _has_live_key(h, s_q, s_k, q_off, k_off, causal, window):
    """``(H, Sq)`` bool: the row sees at least one live key."""
    q_pos = q_off + np.arange(s_q)[:, None]
    k_pos = k_off + np.arange(s_k)[None, :]
    live = np.ones((s_q, s_k), bool)
    if causal:
        live &= k_pos <= q_pos
    if window is not None:
        live &= k_pos >= q_pos - (window - 1)
    return np.broadcast_to(live.any(axis=1), (h, s_q))


def _fold_both(q, k, v, state, q_off, k_off, causal, window=None,
               dtype=torch.float32, jdtype=jnp.float32):
    """One fold through the port and through JAX (interpret mode)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk, tv = _torch(q, k, v, dtype=dtype)
    ts = _torch(*state)
    got = tflash.flash_block_attend(tq, tk, tv, *ts, q_off, k_off, causal,
                                    scale, window=window)
    jq, jk, jv = _jax(q, k, v, dtype=jdtype)
    want = jflash.flash_block_attend(jq, jk, jv, *_jax(*state), q_off, k_off,
                                     causal, scale, interpret=True,
                                     window=window)
    return got, want


def _fresh(h, s_q, d):
    return [np.full((h, 1, s_q), NEG_INF, np.float32),
            np.zeros((h, 1, s_q), np.float32),
            np.zeros((h, s_q, d), np.float32)]


def _carried(q, k, v, q_off, causal, window=None, k_off=0):
    """State after one plain fold of the keys at ``k_off``: the input of
    a mid-ring step, the same numpy values for both packages."""
    h, s_q, d = q.shape
    scale = 1.0 / math.sqrt(d)
    state = tflash.flash_block_attend(*_torch(q, k, v),
                                      *_torch(*_fresh(h, s_q, d)), q_off,
                                      k_off, causal, scale, window=window)
    return [x.numpy() for x in state]


# ------------------------------------------------------- carried kernel --


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("carry", ["fresh", "carried"])
def test_block_matches_jax(causal, carry):
    """One fold == the JAX carried kernel, with carried state and nonzero
    global offsets (q rows 16..47, keys 32..79: a mid-ring step)."""
    s_q, s_k, h, d = 32, 48, 2, 128
    q, = _arrays(1, (h, s_q, d))
    k, v = _arrays(2, (h, s_k, d), (h, s_k, d))
    q_off, k_off = 16, 32
    state = (_fresh(h, s_q, d) if carry == "fresh"
             else _carried(q, k, v, q_off, causal))
    got, want = _fold_both(q, k, v, state, q_off, k_off, causal)
    live = _has_live_key(h, s_q, s_k, q_off, k_off, causal, None)
    if carry == "carried":
        live = live | _has_live_key(h, s_q, s_k, q_off, 0, causal, None)
    _assert_state(got, want, live)


@pytest.mark.parametrize("h_kv", [2, 1])
def test_block_gqa_matches_jax(h_kv):
    s_q, s_k, h, d = 32, 48, 4, 128
    q, = _arrays(3, (h, s_q, d))
    k, v = _arrays(4, (h_kv, s_k, d), (h_kv, s_k, d))
    state = _carried(q, k, v, 16, True)
    got, want = _fold_both(q, k, v, state, 16, 32, True)
    live = (_has_live_key(h, s_q, s_k, 16, 32, True, None)
            | _has_live_key(h, s_q, s_k, 16, 0, True, None))
    _assert_state(got, want, live)


@pytest.mark.parametrize("window", [8, 24])
def test_block_window_matches_jax(window):
    """Window edges inside the block: rows whose window starts past the
    block's first key, and (window 8) rows with no live key in it."""
    s_q, s_k, h, d = 32, 48, 2, 128
    q, = _arrays(5, (h, s_q, d))
    k, v = _arrays(6, (h, s_k, d), (h, s_k, d))
    q_off, k_off = 40, 16
    got, want = _fold_both(q, k, v, _fresh(h, s_q, d), q_off, k_off, True,
                           window=window)
    live = _has_live_key(h, s_q, s_k, q_off, k_off, True, window)
    assert not live.all() or window == 24
    _assert_state(got, want, live)


def test_block_bf16_matches_jax():
    s, h, d = 32, 2, 128
    q, k, v = _arrays(7, (h, s, d), (h, s, d), (h, s, d))
    state = _carried(q, k, v, 32, True)
    got, want = _fold_both(q, k, v, state, 32, 16, True,
                           dtype=torch.bfloat16, jdtype=jnp.bfloat16)
    live = _has_live_key(h, s, s, 32, 16, True, None)
    _assert_state(got, want, live, atol_stat=3e-2, atol_acc=3e-2)


@pytest.mark.parametrize("q_off,live_off,k_off,window", [
    (0, 0, 1000, None),   # the causal future
    (4096, 4080, 0, 64),  # wholly before the window
])
def test_dead_block_leaves_the_carry_array_equal(q_off, live_off, k_off,
                                                 window):
    """A block with no live key for any row returns the carry bit for
    bit (the carry is live: one fold of the block at ``live_off``)."""
    s, h, d = 16, 1, 128
    q, k, v = _arrays(9, (h, s, d), (h, s, d), (h, s, d))
    carry = _carried(q, k, v, q_off, True, window, k_off=live_off)
    assert (carry[1] > 0).all()
    m, l, acc = tflash.flash_block_attend(
        *_torch(q, k, v), *_torch(*carry), q_off, k_off, True,
        1.0 / math.sqrt(d), window=window)
    for got, want in zip((m, l, acc), carry):
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------- fused kernel --


def _fused_both(q, k, v, q_off, k_off, causal, window=None,
                dtype=torch.float32, jdtype=jnp.float32):
    scale = 1.0 / math.sqrt(q.shape[-1])
    got = tflash.flash_attend_fused(*_torch(q, k, v, dtype=dtype), q_off,
                                    k_off, causal, scale, window=window)
    want = jflash.flash_attend_fused(*_jax(q, k, v, dtype=jdtype), q_off,
                                     k_off, causal, scale, interpret=True,
                                     window=window)
    return got, want


def _assert_fused(got, want, live, atol_stat=1e-5, atol_out=2e-5):
    out, m, l = (_np(x) for x in got)
    jout, jm, jl = (_np(x) for x in want)
    np.testing.assert_allclose(out[live], jout[live], rtol=atol_out,
                               atol=atol_out)
    np.testing.assert_allclose(m[:, 0][live], jm[:, 0][live],
                               rtol=atol_stat, atol=atol_stat)
    np.testing.assert_allclose(l[:, 0][live], jl[:, 0][live],
                               rtol=atol_stat, atol=atol_stat)
    np.testing.assert_array_equal(out[~live], 0.0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_off,k_off", [(0, 0), (16, 32)])
def test_fused_matches_jax(causal, q_off, k_off):
    s_q, s_k, h, d = 32, 48, 2, 128
    q, = _arrays(11, (h, s_q, d))
    k, v = _arrays(12, (h, s_k, d), (h, s_k, d))
    got, want = _fused_both(q, k, v, q_off, k_off, causal)
    assert got[0].dtype == torch.float32 and got[1].shape == (h, 1, s_q)
    _assert_fused(got, want,
                  _has_live_key(h, s_q, s_k, q_off, k_off, causal, None))


@pytest.mark.parametrize("h_kv", [2, 1])
def test_fused_gqa_matches_jax(h_kv):
    s, h, d = 48, 4, 128
    q, = _arrays(13, (h, s, d))
    k, v = _arrays(14, (h_kv, s, d), (h_kv, s, d))
    got, want = _fused_both(q, k, v, 0, 0, True)
    _assert_fused(got, want, np.ones((h, s), bool))


@pytest.mark.parametrize("window", [8, 24])
def test_fused_window_matches_jax(window):
    s, h, d = 48, 2, 128
    q, k, v = _arrays(15, (h, s, d), (h, s, d), (h, s, d))
    got, want = _fused_both(q, k, v, 0, 0, True, window=window)
    _assert_fused(got, want, np.ones((h, s), bool))


def test_fused_bf16_matches_jax():
    s, h, d = 32, 2, 128
    q, k, v = _arrays(16, (h, s, d), (h, s, d), (h, s, d))
    got, want = _fused_both(q, k, v, 0, 0, True, dtype=torch.bfloat16,
                            jdtype=jnp.bfloat16)
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    _assert_fused(got, want, np.ones((h, s), bool), atol_stat=3e-2,
                  atol_out=3e-2)


def test_fused_equals_one_fold_from_fresh_state():
    """The fused kernel is the carried kernel's fold from fresh state,
    then ``acc / l``: the identity the one-rank ring rests on."""
    s, h, d = 40, 2, 64
    q, k, v = _torch(*_arrays(17, (h, s, d), (h, s, d), (h, s, d)))
    scale = 1.0 / math.sqrt(d)
    out, m, l = tflash.flash_attend_fused(q, k, v, 0, 0, True, scale)
    m2, l2, acc = tflash.flash_block_attend(
        q, k, v, *_torch(*_fresh(h, s, d)), 0, 0, True, scale)
    assert torch.equal(m, m2) and torch.equal(l, l2)
    assert torch.equal(out, acc / l.transpose(1, 2))


def test_plain_row_chunks_match_one_chunk(monkeypatch):
    """The plain versions walk query rows in chunks to bound memory at
    long context; the rows are independent, so chunking changes nothing
    but the matmul's blocking (accumulation-order noise, inside the f32
    bar)."""
    s, h, d = 48, 2, 128
    q, k, v = _torch(*_arrays(18, (h, s, d), (h, s, d), (h, s, d)))
    args = (q, k, v, 0, 0, True, 1.0 / math.sqrt(d))
    whole = tflash.flash_attend_fused_plain(*args, window=24)
    monkeypatch.setattr(tflash, "PLAIN_SCORE_ELEMS", h * s * 5)
    parts = tflash.flash_attend_fused_plain(*args, window=24)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


# ------------------------------------------- support, plan and operands --


def test_flash_supported_is_the_cuda_kernels_condition():
    f32, bf16 = torch.float32, torch.bfloat16
    for d in tflash.HEAD_DIMS:
        assert tflash.flash_supported(8192, 8192, d, f32)
        assert tflash.flash_supported(32768, 32768, d, bf16)
    assert tflash.flash_supported(7, 13, 128, f32)   # ragged tiles: masked
    assert not tflash.flash_supported(512, 512, 96, f32)   # pad to 128
    assert not tflash.flash_supported(512, 512, 512, bf16)
    assert not tflash.flash_supported(512, 512, 128, torch.float64)
    assert not tflash.flash_supported(512, 512, 128, torch.float16)
    assert not tflash.flash_supported(0, 512, 128, f32)


def test_tile_plan_fits_hopper_shared_memory():
    """bf16: 1024 alignment bytes, the 128-row Q tile and two stages of
    one K and one V tile of block_k unpadded rows, and 64 mbarrier bytes;
    f32: (128 + 2·block_k) rows of Q/K/V padded by 16 bytes and the
    128 x (block_k + 16) probability tile."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert tflash.smem_bytes(128, f32) == 4 * ((128 + 128) * 132 + 128 * 80)
    assert tflash.smem_bytes(128, f32) == 176_128
    assert tflash.smem_bytes(128, bf16) == 1024 + 128 * 256 + 4 * 128 * 256 \
        + 64 == 164_928
    assert tflash.smem_bytes(256, f32) == 224_256
    for d in tflash.HEAD_DIMS:
        for dt in (f32, bf16):
            assert tflash.smem_bytes(d, dt) <= _build.SMEM_BYTES_LIMIT
    assert tflash._plan(128, f32) == (128, 64)
    assert tflash._plan(128, bf16) == (128, 128)
    assert tflash._plan(96, f32) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
def test_tile_plan_takes_the_kernels_shapes(d, dtype):
    """What ``csrc/flash_fwd.cu`` builds on: bf16 tiles are whole
    128-byte TMA boxes (64 bf16) with box extents of at most 256 rows and
    key tiles a multiple of wgmma's 16 and at most its 256; f32 rows are
    read by 16 threads (keys tx + 16 j) and written as float4 groups at
    64 g + 4 tx. Every plan fits, with its alignment slack and barriers."""
    block_q, block_k = tflash._plan(d, dtype)
    assert block_q == tflash.BLOCK_Q == 128
    assert d % 64 == 0 and block_k % 16 == 0
    assert block_k == (32 if d == 256 else 64) * (
        2 if dtype == torch.bfloat16 else 1)
    if dtype == torch.bfloat16:
        assert block_q <= 256 and block_k <= 256
        assert tflash.smem_bytes(d, dtype) % 8 == 0   # mbarriers: 8 bytes
    assert tflash.smem_bytes(d, dtype) <= _build.SMEM_BYTES_LIMIT


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def test_earlier_source_is_named_by_a_source_of_the_tree(tmp_path):
    """``chip_smoke.py --earlier PATH`` takes an earlier copy of a
    ``csrc/`` source by its stem and refuses another name before it
    builds anything."""
    chip_smoke = _chip_smoke()
    other = tmp_path / "flash.cu"
    other.write_text("")
    with pytest.raises(SystemExit, match="no source of the tree"):
        chip_smoke.EarlierSource(str(other))
    assert "flash_fwd" in _build.SOURCES and "ring" in _build.SOURCES


def _operands(dtype=torch.float32, device="cpu"):
    h, s, d = 2, 16, 128
    q = torch.zeros((h, s, d), dtype=dtype, device=device)
    m = torch.zeros((h, 1, s), device=device)
    return q, q.clone(), q.clone(), m, m.clone(), torch.zeros((h, s, d),
                                                              device=device)


@pytest.mark.parametrize("case,error,match", [
    ("f64", TypeError, "float32 or bfloat16"),
    ("k_dtype", TypeError, "like q"),
    ("acc_bf16", TypeError, "acc must be float32"),
    ("meta", ValueError, "no kernel for meta"),
    ("mixed_device", ValueError, "is on meta"),
    ("m_shape", ValueError, "m must have shape"),
    ("kv_heads", ValueError, "must divide"),
    ("strided", ValueError, "contiguous"),
])
def test_operand_checks_raise(case, error, match):
    q, k, v, m, l, acc = _operands(
        torch.float64 if case == "f64" else torch.float32,
        "meta" if case == "meta" else "cpu")
    if case == "k_dtype":
        k = k.to(torch.bfloat16)
    elif case == "acc_bf16":
        acc = acc.to(torch.bfloat16)
    elif case == "mixed_device":
        v = torch.zeros(v.shape, device="meta")
    elif case == "m_shape":
        m = m.reshape(2, 16, 1).contiguous()
    elif case == "kv_heads":
        q = torch.zeros((3, 16, 128))
        m, l, acc = torch.zeros((3, 1, 16)), torch.zeros((3, 1, 16)), q.clone()
    elif case == "strided":
        q = torch.zeros((2, 128, 16)).transpose(1, 2)
    with pytest.raises(error, match=match):
        tflash.flash_block_attend(q, k, v, m, l, acc, 0, 0, True, 0.1)


def test_window_without_causal_raises():
    q, k, v, *_ = _operands()
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_attend_fused(q, k, v, 0, 0, False, 0.1, window=8)


def test_cpu_calls_launch_nothing():
    before = dict(_build.LAUNCHES)
    q, k, v, m, l, acc = _operands()
    tflash.flash_attend_fused(q, k, v, 0, 0, True, 0.1)
    tflash.flash_block_attend(q, k, v, m, l, acc, 0, 0, True, 0.1)
    assert _build.LAUNCHES == before
    assert {"flash_fused", "flash_block"} <= set(before)
    assert _build.source_of("flash_fused") == "flash_fwd"
    assert _build.source_of("flash_block") == "flash_fwd"


def test_live_pairs_counts_the_masks_work():
    """``chip_smoke.live_pairs``, the work its operation bounds count."""
    live_pairs = _chip_smoke().live_pairs
    assert live_pairs(8, 8, 0, 0, False) == 64
    assert live_pairs(8, 8, 0, 0, True) == 8 * 9 // 2
    assert live_pairs(8192, 8192, 0, 0, True) == 8192 * 8193 // 2
    # window w over S rows: w(w+1)/2 for the first w rows, then w each
    assert live_pairs(100, 100, 0, 0, True, 10) == 55 + 90 * 10
    assert live_pairs(16, 16, 0, 1000, True) == 0
    assert live_pairs(16, 16, 32, 0, False) == 256
    # against the mask itself, at offsets
    live = _has_live_key(1, 48, 40, 30, 20, True, 12)
    q_pos = 30 + np.arange(48)[:, None]
    k_pos = 20 + np.arange(40)[None, :]
    mask = (k_pos <= q_pos) & (k_pos >= q_pos - 11)
    assert live_pairs(48, 40, 30, 20, True, 12) == int(mask.sum())
    assert live.sum() == int(mask.any(axis=1).sum())
