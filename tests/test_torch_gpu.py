"""smi_tpu_torch's kernels on a CUDA card: the tests that need one.

Each test is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false. On a GPU host they run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``. This
file imports no JAX, and ``--noconftest`` skips ``tests/conftest.py``,
which does, so it runs where only PyTorch is installed.
"""

import math

import numpy as np
import pytest
import torch

import smi_tpu_torch as st
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import flash as kflash
from smi_tpu_torch.kernels import stencil_temporal as ktemporal

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_comm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                device="cuda")


def _grid(h, w):
    g = st.initial_grid(h, w)
    g[:, -1] = 2.0
    g[h // 2, :] = 0.5
    return g


@pytest.mark.parametrize("make_fn,iters", [
    (lambda comm, n: st.make_fused_stencil_fn(comm, n, 64, 96), 3),
    (lambda comm, n: st.make_temporal_stencil_fn(comm, n, 64, 96, depth=8),
     3),   # remainder sweeps only
    (lambda comm, n: st.make_temporal_stencil_fn(comm, n, 64, 96, depth=8),
     11),  # one k-sweep pass, then the remainder
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_drivers_refuse_a_non_f32_cuda_block(cuda_comm, make_fn, iters,
                                             dtype):
    block = st.block_from_numpy(_grid(64, 96), cuda_comm).to(dtype)
    with pytest.raises(TypeError, match="float32"):
        make_fn(cuda_comm, iters)(block)


@pytest.mark.parametrize("iters,depth", [(19, 8), (35, 16)])
def test_temporal_stencil_matches_the_serial_reference(cuda_comm, iters,
                                                       depth):
    g = _grid(64, 96)
    out = st.make_temporal_stencil_fn(cuda_comm, iters, 64, 96, depth=depth)(
        st.block_from_numpy(g, cuda_comm))
    np.testing.assert_array_equal(st.grid_to_numpy(out, cuda_comm),
                                  st.reference_stencil(g, iters))


def _temporal_case(depth, shape, at, grid, seed):
    """A random block and random corner-complete halos on the card."""
    h, w = shape
    k = depth
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*s):
        return torch.rand(s, generator=gen, device="cuda")

    return (rand(h, w), rand(k, w + 2 * k), rand(k, w + 2 * k), rand(h, k),
            rand(h, k), *at, *grid, k)


#: (block, its offset, the grid): no multiple of the plan's stripe and
#: band, inside the grid, holding every global edge, each edge alone; then
#: the level groups' cases: a global boundary row inside the halo, 3, 8
#: or 13 rows past the block (inside the first group's levels, on the
#: seam of two groups of 8 levels, inside the second's), odd stripes
#: (the step unroll pads them), one band, and the 8192^2 main shape
TEMPORAL_BLOCKS = [
    ((300, 700), (1000, 1200), (4096, 4096)),
    ((300, 700), (0, 0), (300, 700)),
    ((300, 700), (0, 1200), (4096, 4096)),
    ((300, 700), (1000, 0), (4096, 4096)),
    ((300, 700), (3796, 1200), (4096, 4096)),
    ((300, 700), (1000, 3396), (4096, 4096)),
    ((301, 300), (3, 0), (304, 4096)),
    ((257, 700), (8, 1000), (273, 4096)),
    ((333, 500), (13, 3596), (354, 4096)),
    ((8192, 8192), (0, 0), (8192, 8192)),
]


@pytest.mark.parametrize("block,at,grid", TEMPORAL_BLOCKS)
@pytest.mark.parametrize("depth", [1, 2, 7, 8, 16, 32])
def test_temporal_kernel_equals_its_plain_version(cuda_comm, depth, block,
                                                  at, grid):
    """The wavefront kernel, one launch in its depth's form (within that
    form's launch bound), torch.equal to its plain version at every
    register depth and on the generic loop."""
    args = _temporal_case(depth, block, at, grid, seed=depth)
    _, band = ktemporal._plan(*block, depth)
    assert ktemporal.threads(band, depth) <= ktemporal.form(depth).max_threads
    before = _build.LAUNCHES["stencil_temporal"]
    got = st.temporal_sweeps(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stencil_temporal"] == before + 1
    assert torch.equal(got, st.temporal_sweeps_plain(*args))


def test_temporal_kernel_under_one_band(cuda_comm):
    """A 16x40 block at k=8: one block, most of its window past the
    block's columns."""
    args = _temporal_case(8, (16, 40), (0, 0), (16, 40), seed=3)
    assert torch.equal(st.temporal_sweeps(*args),
                       st.temporal_sweeps_plain(*args))


@pytest.mark.parametrize("depth", [8, 16, 32])
def test_temporal_kernel_gives_the_same_bits_twice(cuda_comm, depth):
    args = _temporal_case(depth, (1000, 1500), (0, 0), (1000, 1500),
                          seed=5)
    assert torch.equal(st.temporal_sweeps(*args), st.temporal_sweeps(*args))


def test_traced_8192_solve_has_one_launch_span_a_launch(cuda_comm):
    """The upstream 8192^2 solve, 259 sweeps at k=16: 16 passes and 3
    remainder sweeps, 19 ``smi.stencil.launch`` spans, as many as the
    launch counters count."""
    n, sweeps = 8192, 259
    fn = st.make_temporal_stencil_fn(cuda_comm, sweeps, n, n, depth=16)
    block = torch.rand(n, n, device="cuda")
    fn(block)   # builds the kernels outside the trace
    torch.cuda.synchronize()
    before = sum(_build.LAUNCHES[k]
                 for k in ("stencil_temporal", "stencil_sweep"))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(block)
        torch.cuda.synchronize()
    launches = sum(_build.LAUNCHES[k]
                   for k in ("stencil_temporal", "stencil_sweep")) - before
    # host spans only: the trace mirrors each on the device's timeline
    names = [e.name for e in prof.events()
             if e.name.startswith("smi.")
             and e.device_type == torch.autograd.DeviceType.CPU]
    assert names.count("smi.stencil.launch") == launches == 19
    assert names.count("smi.stencil.solve") == 1
    assert names.count("smi.stencil.pass") == 16
    assert names.count("smi.stencil.sweep") == 3


# ------------------------------------------------------ flash attention --


@pytest.fixture
def cuda_sp():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return st.make_communicator(shape=(1,), axis_names=("sp",),
                                device="cuda")


def _heads(seed, h, s, d, dtype, device):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((h, s, d), generator=gen).to(device=device,
                                                     dtype=dtype)


def _worst_row_rel(got, want):
    """Worst ``||got - want|| / ||want||`` over the rows (last axis)."""
    got, want = got.float(), want.float()
    err = (got - want).norm(dim=-1)
    ref = want.norm(dim=-1)
    return torch.where(ref > 0, err / ref, err).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("window,h_kv", [(None, 4), (24, 2)])
def test_flash_kernels_equal_their_plain_versions(cuda_sp, dtype, fused,
                                                  window, h_kv):
    """S=64 (one ragged tile past 32 or 64 keys when offset), carried
    state from a previous fold, global offsets. ``chip_smoke.py``'s bars:
    m and l within 1e-5 in either dtype, out/acc within 2e-5 in f32 and
    by the worst row's relative error, 1e-2, in bf16."""
    h, s, d = 4, 64, 128
    dev = cuda_sp.device
    q = _heads(1, h, s, d, dtype, dev)
    k, v = (_heads(i, h_kv, s, d, dtype, dev) for i in (2, 3))
    scale = 1.0 / math.sqrt(d)
    before = dict(_build.LAUNCHES)
    if fused:
        got = kflash.flash_attend_fused(q, k, v, 0, 0, True, scale,
                                        window=window)
        want = kflash.flash_attend_fused_plain(q, k, v, 0, 0, True, scale,
                                               window=window)
        name, parts = "flash_fused", ("out", "m", "l")
    else:
        fresh = (torch.full((h, 1, s), kflash.NEG_INF, device=dev),
                 torch.zeros((h, 1, s), device=dev),
                 torch.zeros((h, s, d), device=dev))
        carry = kflash.flash_block_attend_plain(q, k, v, *fresh, 64, 0, True,
                                                scale, window=window)
        got = kflash.flash_block_attend(q, k, v, *carry, 64, 40, True, scale,
                                        window=window)
        want = kflash.flash_block_attend_plain(q, k, v, *carry, 64, 40, True,
                                               scale, window=window)
        name, parts = "flash_block", ("m", "l", "acc")
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before[name] + 1
    for part, a, b in zip(parts, got, want):
        if part in ("m", "l"):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        elif dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        else:
            assert _worst_row_rel(a, b) <= 1e-2, part


def _fold_operands(dev, dtype, h, h_kv, s, s_k, d, causal, window):
    """q (H, s, D) at q_off = s_k, k/v (H_kv, s_k, D), and a carry from a
    plain fold of the same keys at k_off = 0."""
    q = _heads(11, h, s, d, dtype, dev)
    k, v = (_heads(i, h_kv, s_k, d, dtype, dev) for i in (12, 13))
    scale = 1.0 / math.sqrt(d)
    carry = kflash.flash_block_attend_plain(
        q, k, v, *kflash.fresh_state(h, s, d, dev), s_k, 0, causal, scale,
        window=window)
    return q, k, v, carry, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("s,s_k,d,h,h_kv,causal,window", [
    (64, 64, 128, 4, 4, True, None),     # smaller than one tile
    (200, 200, 128, 4, 2, True, None),   # ragged past one tile
    (1000, 1000, 128, 2, 1, True, 300),  # ragged past several, window
    (200, 200, 64, 4, 4, True, None),    # D=64: one 128-byte box a row
    (200, 200, 256, 4, 2, True, None),   # D=256: four boxes a row
    (333, 333, 128, 4, 4, False, None),  # non-causal
    (256, 77, 128, 4, 2, False, None),   # GQA, s_k ragged at the heads
])
def test_flash_kernels_at_the_tiles_edges(cuda_sp, dtype, fused, s, s_k, d,
                                          h, h_kv, causal, window):
    """The edges of the tiled design against the plain versions at
    ``chip_smoke.py``'s bars: a query block or key tile cut short by the
    extent, a last K/V tile whose rows past s_k must fill with zeros
    inside their head, the head dims' box counts, and GQA."""
    dev = cuda_sp.device
    q, k, v, carry, scale = _fold_operands(dev, dtype, h, h_kv, s, s_k, d,
                                           causal, window)
    if fused:
        got = kflash.flash_attend_fused(q, k, v, 0, 0, causal, scale,
                                        window=window)
        want = kflash.flash_attend_fused_plain(q, k, v, 0, 0, causal, scale,
                                               window=window)
        parts = ("out", "m", "l")
    else:
        args = (q, k, v, *carry, s_k, s_k // 2, causal, scale)
        got = kflash.flash_block_attend(*args, window=window)
        want = kflash.flash_block_attend_plain(*args, window=window)
        parts = ("m", "l", "acc")
    torch.cuda.synchronize()
    for part, a, b in zip(parts, got, want):
        if part in ("m", "l"):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        elif dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        else:
            assert _worst_row_rel(a, b) <= 1e-2, part


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_fold_of_a_future_block_returns_its_carry(cuda_sp, dtype, d):
    """A K/V block wholly in the causal future of every query runs no
    tile: the carry comes back bit for bit."""
    q, k, v, carry, scale = _fold_operands(cuda_sp.device, dtype, 4, 2, 200,
                                           200, d, True, None)
    before = _build.LAUNCHES["flash_block"]
    got = kflash.flash_block_attend(q, k, v, *carry, 200, 400, True, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_block"] == before + 1
    for a, b in zip(got, carry):
        assert torch.equal(a, b)


def test_flash_kernel_refuses_an_f64_cuda_input(cuda_sp):
    q = torch.zeros((2, 64, 128), dtype=torch.float64, device=cuda_sp.device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kflash.flash_attend_fused(q, q, q, 0, 0, True, 0.1)


def test_auto_tier_raises_on_a_shape_the_kernel_cannot_take(cuda_sp):
    q = torch.zeros((64, 2, 512), device=cuda_sp.device)
    fn = st.make_ring_attention_fn(cuda_sp, causal=True)
    with pytest.raises(ValueError, match="use_flash=False"):
        fn(q, q, q)


def test_ring_attention_on_the_card_matches_the_reference(cuda_sp):
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(128, 4, 128).astype(np.float32) for _ in range(3))
    shards = [st.sequence_shard_from_numpy(x, cuda_sp) for x in (q, k, v)]
    before = _build.LAUNCHES["flash_fused"]
    out = st.make_ring_attention_fn(cuda_sp, causal=True)(*shards)
    assert _build.LAUNCHES["flash_fused"] == before + 1
    np.testing.assert_allclose(st.sequence_to_numpy(out, cuda_sp),
                               st.reference_attention(q, k, v, causal=True),
                               rtol=2e-5, atol=2e-5)


# ------------------------------------------------ flash backward --


def _bwd_args(dev, dtype, h, h_kv, s, q_off, k_off, causal, window, d=128):
    """One block's backward operands: the statistics of a fused forward
    over keys ``[0, q_off + s)`` and a random dout; the block's K/V are
    those keys at ``k_off``, or fresh ones past them (a future block)."""
    scale = 1.0 / math.sqrt(d)
    q, dout = (_heads(i, h, s, d, dtype, dev) for i in (1, 2))
    k_all, v_all = (_heads(i, h_kv, q_off + s, d, dtype, dev)
                    for i in (3, 4))
    out, m, l = kflash.flash_attend_fused(q, k_all, v_all, q_off, 0, causal,
                                          scale, window=window)
    if k_off + s <= k_all.shape[1]:
        k, v = (x[:, k_off:k_off + s].contiguous() for x in (k_all, v_all))
    else:
        k, v = (_heads(i, h_kv, s, d, dtype, dev) for i in (5, 6))
    return (q, k, v, dout, m, *kflash.backward_rows(out, l, dout), q_off,
            k_off, causal, scale)


def _worst_row_above_floor(got, want, floor=1e-3):
    """Worst row relative error over rows whose reference norm exceeds
    ``floor`` times the median row's (``chip_smoke.py``'s GRAD_FLOOR)."""
    got, want = got.float(), want.float()
    ref = want.norm(dim=-1)
    keep = ref > floor * ref.median()
    return ((got - want).norm(dim=-1)[keep] / ref[keep]).max().item()


def _bwd_both(args, window):
    """dq, dk and dv of the kernels and of their plain versions."""
    got = (kflash.flash_block_backward_dq(*args, window=window),
           *kflash.flash_block_backward_dkdv(*args, window=window))
    want = (kflash.flash_block_backward_dq_plain(*args, window=window),
            *kflash.flash_block_backward_dkdv_plain(*args, window=window))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,h_kv,s,q_off,k_off,causal,window,d", [
    (4, 4, 96, 0, 0, True, None, 128),      # the diagonal, ragged tiles
    (4, 2, 64, 128, 64, True, None, 128),   # a past block, GQA 2:1
    (4, 1, 96, 96, 48, True, 40, 128),      # the window's edge, GQA 4:1
    (2, 2, 80, 0, 0, False, None, 128),     # no mask
    (2, 2, 129, 0, 0, True, None, 128),     # one row past 128-row blocks
    (4, 2, 200, 0, 0, True, None, 128),     # ragged 64-row tiles, GQA
    (2, 1, 200, 0, 0, False, None, 128),    # ragged, no mask
    (4, 4, 160, 100, 37, True, None, 128),  # offsets off the tiles' grid
    (2, 1, 150, 90, 30, True, 70, 128),     # and a window
    (4, 2, 200, 0, 0, True, None, 64),      # D=64: one box a row
    (2, 2, 129, 64, 21, True, 100, 64),
    (4, 2, 200, 0, 0, True, None, 256),     # D=256: halves over gridDim.y
    (2, 2, 129, 64, 21, True, 100, 256),
    (8, 1, 2048, 0, 0, True, None, 128),    # GQA 8:1, s_k=2048: few blocks
    (8, 1, 2048, 2048, 1024, True, 1536, 128),   # and a window's edge
    (8, 1, 1000, 0, 0, True, None, 64),     # the few-block form at D=64
    (8, 1, 1000, 0, 0, True, None, 256),    # and at D=256
])
def test_flash_backward_kernels_equal_their_plain_versions(
        cuda_sp, dtype, h, h_kv, s, q_off, k_off, causal, window, d):
    """dq and (dk, dv) against the plain versions: within 2e-5 in f32,
    by the worst row's relative error, 1e-2, in bf16; one launch each.
    Ragged extents, offsets off the tiles' grid, every head dim and the
    64-key form of bf16 dk/dv (a K/V head of 2048 keys or fewer)."""
    args = _bwd_args(cuda_sp.device, dtype, h, h_kv, s, q_off, k_off,
                     causal, window, d)
    before = dict(_build.LAUNCHES)
    got, want = _bwd_both(args, window)
    for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        assert _build.LAUNCHES[name] == before[name] + 1
    assert got[1].shape == (h_kv, s, d)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), name
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        else:
            assert _worst_row_above_floor(a, b) <= 1e-2, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,h_kv,s,d", [
    (4, 4, 300, 128),    # 128-key blocks (bf16), 64-key (f32)
    (8, 1, 2048, 128),   # the 64-key form of bf16 dk/dv
    (2, 2, 200, 256),    # halves of the output columns
])
def test_flash_backward_kernels_give_the_same_bits_twice(cuda_sp, dtype, h,
                                                         h_kv, s, d):
    """dk and dv reduce the GQA group in registers (and the 64-key
    form's two halves through shared memory in a fixed order), dq its
    key tiles: no atomics, so two launches on the same inputs agree bit
    for bit."""
    args = _bwd_args(cuda_sp.device, dtype, h, h_kv, s, 0, 0, True, None, d)
    runs = [(kflash.flash_block_backward_dq(*args),
             *kflash.flash_block_backward_dkdv(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h_kv,s", [(2, 256), (1, 2048)])
def test_flash_backward_bar_sees_one_dropped_tile(cuda_sp, h_kv, s):
    """The bf16 bar is not blind: the plain versions with one live
    64-row tile left out (dq without the middle key tile, dk and dv
    without the middle query tile, ``chip_smoke.py``'s control) read
    above 1e-2 where the kernels read within it."""
    args = _bwd_args(cuda_sp.device, torch.bfloat16, 4 * h_kv, h_kv, s, 0, 0,
                     True, None)
    q, k, v, dout, m, linv, delta, q_off, k_off, causal, scale = args
    got, want = _bwd_both(args, None)
    j = s // 2 // 64 * 64
    lo, hi = slice(0, j), slice(j + 64, s)
    dq = sum(kflash.flash_block_backward_dq_plain(
        q, k[:, r], v[:, r], dout, m, linv, delta, q_off, k_off + r.start,
        causal, scale) for r in (lo, hi))
    dk, dv = (sum(parts) for parts in zip(*(
        kflash.flash_block_backward_dkdv_plain(
            q[:, r], k, v, dout[:, r], m[..., r], linv[..., r],
            delta[..., r], q_off + r.start, k_off, causal, scale)
        for r in (lo, hi))))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, (dq, dk, dv)):
        assert _worst_row_above_floor(a, b) <= 1e-2, name
        assert _worst_row_above_floor(c, b) > 1e-2, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_of_a_future_block_is_zeros(cuda_sp, dtype):
    args = _bwd_args(cuda_sp.device, dtype, 4, 2, 64, 0, 128, True, None)
    for t in (kflash.flash_block_backward_dq(*args),
              *kflash.flash_block_backward_dkdv(*args)):
        assert torch.count_nonzero(t) == 0


@pytest.fixture
def cuda_grid():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device="cuda")


@pytest.mark.parametrize("compute_dtype,bar", [("float32", 2e-5),
                                               ("bfloat16", 1e-2)])
@pytest.mark.parametrize("layers", [1, 2])
def test_train_step_on_the_card_matches_the_plain_tier(cuda_grid,
                                                       compute_dtype, bar,
                                                       layers):
    """One step on the kernels: each parameter's gradient within ``bar``
    of the plain tier's by ``||g - g'|| / ||g'||`` (B=2, GQA 2:1, window
    48), and per step one fused forward per layer (two under the stack's
    recompute) and one launch of each backward kernel per layer."""
    cfg = st.BlockConfig(embed=128, heads=2, head_dim=128, kv_heads=1,
                         window=48, compute_dtype=compute_dtype)
    params = (st.init_stack_params(cfg, layers, seed=3) if layers > 1
              else st.init_params(cfg, seed=3))
    rng = np.random.RandomState(4)
    x, y = (torch.from_numpy(rng.randn(2, 96, 128).astype(np.float32))
            .to("cuda") for _ in range(2))
    grads = {}
    for use_flash in (None, False):
        model = st.params_from_numpy(params, cfg)
        step = st.make_train_step(cuda_grid, cfg, use_flash=use_flash,
                                  layers=layers)
        before = dict(_build.LAUNCHES)
        loss = step(model, x, y)
        torch.cuda.synchronize()
        made = {n: _build.LAUNCHES[n] - before[n] for n in before}
        if use_flash is None:
            assert made["flash_fused"] == (2 * layers if layers > 1 else 1)
            assert made["flash_bwd_dq"] == made["flash_bwd_dkdv"] == layers
        else:
            assert set(made.values()) == {0}
        assert math.isfinite(float(loss))
        grads[use_flash] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads[None].items():
        want = grads[False][n]
        assert ((g - want).norm() / want.norm()).item() <= bar, n


# ------------------------------------- flash split form (192, 128) --

#: DeepSeek-V3's latent attention: queries and keys 192 wide, values 128
D_QK, D_V = 192, 128


def _split_operands(dev, h, h_kv, s, s_k=None, seed=21):
    s_k = s if s_k is None else s_k
    q = _heads(seed, h, s, D_QK, torch.bfloat16, dev)
    k = _heads(seed + 1, h_kv, s_k, D_QK, torch.bfloat16, dev)
    v = _heads(seed + 2, h_kv, s_k, D_V, torch.bfloat16, dev)
    return q, k, v, D_QK ** -0.5


def _split_bars(parts, got, want):
    for part, a, b in zip(parts, got, want):
        if part in ("m", "l"):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert _worst_row_rel(a, b) <= 1e-2, part


def test_split_forward_at_the_cell_shape(cuda_sp):
    """The fused (192, 128) forward at S=8192, 16 heads, bf16 causal
    against its plain version at the bf16 bars, one launch counted under
    its own name and none of the (d, d) forms."""
    q, k, v, scale = _split_operands(cuda_sp.device, 16, 16, 8192)
    before = dict(_build.LAUNCHES)
    got = kflash.flash_attend_fused(q, k, v, 0, 0, True, scale)
    torch.cuda.synchronize()
    made = {n: _build.LAUNCHES[n] - before[n] for n in before}
    assert {n: c for n, c in made.items() if c} == {"flash_fused_192x128": 1}
    assert got[0].shape == (16, 8192, D_V)
    want = kflash.flash_attend_fused_plain(q, k, v, 0, 0, True, scale)
    _split_bars(("out", "m", "l"), got, want)


@pytest.mark.parametrize("s,s_k,h,h_kv,q_off,k_off,causal,window", [
    (200, 200, 4, 4, 200, 100, True, None),   # ragged tiles, a past block
    (333, 333, 2, 1, 0, 0, False, None),      # GQA, no mask
    (256, 77, 4, 2, 77, 0, True, 100),        # s_k ragged, a window
    (200, 200, 4, 4, 0, 400, True, None),     # a future block: the carry
])
def test_split_carried_fold_equals_its_plain_version(
        cuda_sp, s, s_k, h, h_kv, q_off, k_off, causal, window):
    """The carried (192, 128) fold from a carry of an earlier plain fold:
    acc ``Dv`` wide; a block wholly in the future returns the carry bit
    for bit."""
    q, k, v, scale = _split_operands(cuda_sp.device, h, h_kv, s, s_k)
    carry = kflash.flash_block_attend_plain(
        q, k, v, *kflash.fresh_state(h, s, D_V, cuda_sp.device), q_off, 0,
        causal, scale, window=window)
    args = (q, k, v, *carry, q_off, k_off, causal, scale)
    before = _build.LAUNCHES["flash_block_192x128"]
    got = kflash.flash_block_attend(*args, window=window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_block_192x128"] == before + 1
    if k_off > q_off + s:
        for a, b in zip(got, carry):
            assert torch.equal(a, b)
        return
    _split_bars(("m", "l", "acc"), got,
                kflash.flash_block_attend_plain(*args, window=window))


def _split_bwd_args(dev, h, h_kv, s, q_off=0, k_off=0, causal=True,
                    window=None):
    q, k_all, v_all, scale = _split_operands(dev, h, h_kv, s, q_off + s)
    dout = _heads(31, h, s, D_V, torch.bfloat16, dev)
    out, m, l = kflash.flash_attend_fused(q, k_all, v_all, q_off, 0, causal,
                                          scale, window=window)
    k, v = (x[:, k_off:k_off + s].contiguous() for x in (k_all, v_all))
    return (q, k, v, dout, m, *kflash.backward_rows(out, l, dout), q_off,
            k_off, causal, scale)


@pytest.mark.parametrize("h,h_kv,s,q_off,k_off,causal,window", [
    (16, 16, 8192, 0, 0, True, None),    # the cell's shape
    (4, 4, 200, 0, 0, True, None),       # ragged tiles
    (4, 2, 160, 100, 37, True, None),    # offsets off the tiles' grid, GQA
    (2, 1, 150, 90, 30, True, 70),       # and a window
    (2, 2, 129, 0, 0, False, None),      # no mask
])
def test_split_backward_equals_its_plain_version(cuda_sp, h, h_kv, s, q_off,
                                                 k_off, causal, window):
    """dq ``(H, S, 192)``, dk ``(H_kv, S, 192)`` and dv ``(H_kv, S, 128)``
    against the plain versions by the worst row's relative error, 1e-2
    (rows at the floor left out); one launch of each split form."""
    args = _split_bwd_args(cuda_sp.device, h, h_kv, s, q_off, k_off, causal,
                           window)
    before = dict(_build.LAUNCHES)
    got, want = _bwd_both(args, window)
    for name in ("flash_bwd_dq_192x128", "flash_bwd_dkdv_192x128"):
        assert _build.LAUNCHES[name] == before[name] + 1
    assert [t.shape[-1] for t in got] == [D_QK, D_QK, D_V]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert _worst_row_above_floor(a, b) <= 1e-2, name


def test_split_backward_gives_the_same_bits_twice(cuda_sp):
    args = _split_bwd_args(cuda_sp.device, 4, 2, 300)
    runs = [(kflash.flash_block_backward_dq(*args),
             *kflash.flash_block_backward_dkdv(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_split_backward_bar_sees_one_dropped_tile(cuda_sp):
    """The plain versions with one live 64-row tile left out read above
    the bar where the kernels read within it, at the split dims."""
    args = _split_bwd_args(cuda_sp.device, 4, 4, 256)
    q, k, v, dout, m, linv, delta, q_off, k_off, causal, scale = args
    got, want = _bwd_both(args, None)
    lo, hi = slice(0, 128), slice(192, 256)
    dq = sum(kflash.flash_block_backward_dq_plain(
        q, k[:, r], v[:, r], dout, m, linv, delta, q_off, k_off + r.start,
        causal, scale) for r in (lo, hi))
    dk, dv = (sum(parts) for parts in zip(*(
        kflash.flash_block_backward_dkdv_plain(
            q[:, r], k, v, dout[:, r], m[..., r], linv[..., r],
            delta[..., r], q_off + r.start, k_off, causal, scale)
        for r in (lo, hi))))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, (dq, dk, dv)):
        assert _worst_row_above_floor(a, b) <= 1e-2, name
        assert _worst_row_above_floor(c, b) > 1e-2, name


#: a 27-layer ``deepseek_v3`` model at a small width with Moonlight's
#: head dims (128 without positions, 64 rotated, values of 128)
MLA_STEP_MODEL = {
    "model_type": "deepseek_v3", "num_hidden_layers": 27,
    "first_k_dense_replace": 1, "hidden_size": 256,
    "num_attention_heads": 2, "num_key_value_heads": 2, "kv_lora_rank": 64,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "intermediate_size": 384, "moe_intermediate_size": 64,
    "n_routed_experts": 4, "num_experts_per_tok": 2, "n_shared_experts": 2,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "rms_norm_eps": 1e-5, "rope_theta": 50000,
    "vocab_size": 512, "tie_word_embeddings": False,
}


#: the model of ``moonlight-train-2x8k`` as the cell runs it: 27 layers at
#: Moonlight-16B-A3B's published widths, 8 of the router's 64 experts and
#: 20,480 vocabulary rows held
MOONLIGHT_STEP_MODEL = dict(
    MLA_STEP_MODEL, hidden_size=2048, num_attention_heads=16,
    num_key_value_heads=16, kv_lora_rank=512, intermediate_size=11264,
    moe_intermediate_size=1408, n_routed_experts=8, router_experts=64,
    num_experts_per_tok=6, vocab_size=20480)


def test_mla_step_launches_the_split_form_alone(cuda_grid):
    """One step of the cell's model over 2 x 8192 tokens, every flash
    count set to 0 first: 27 forward launches and 27 in the recompute, 27
    dq and 27 dk/dv, each of the (192, 128) form, and no launch of a
    padded (d, d) form."""
    from smi_tpu_torch.models import transformer as ttf

    model = ttf.LanguageModel.from_config(MOONLIGHT_STEP_MODEL,
                                          device="cuda", seed=5)
    step = ttf.make_train_step(cuda_grid, model.config, layers=27)
    gen = torch.Generator().manual_seed(6)
    ids, labels = (torch.randint(0, MOONLIGHT_STEP_MODEL["vocab_size"],
                                 (2, 8192), generator=gen).cuda()
                   for _ in "ab")
    step(model, ids, labels)
    flash_keys = [n for n in _build.LAUNCHES if n.startswith("flash_")]
    for n in flash_keys:
        _build.LAUNCHES[n] = 0
    loss = step(model, ids, labels)
    torch.cuda.synchronize()
    made = {n: _build.LAUNCHES[n] for n in flash_keys if _build.LAUNCHES[n]}
    assert made == {"flash_fused_192x128": 54, "flash_bwd_dq_192x128": 27,
                    "flash_bwd_dkdv_192x128": 27}
    assert math.isfinite(float(loss))
    del model, step
    torch.cuda.empty_cache()


def test_mla_step_on_the_card_matches_the_plain_tier(cuda_grid):
    """Dense layers only (an expert choice near a tie flips under
    rounding): each gradient within 1e-2 of the plain tier's by ``||g -
    g'|| / ||g'||``, as the block's bf16 bar."""
    from smi_tpu_torch.models import transformer as ttf

    cfg = dict(MLA_STEP_MODEL, num_hidden_layers=2, first_k_dense_replace=2)
    gen = torch.Generator().manual_seed(7)
    ids, labels = (torch.randint(0, 512, (2, 192), generator=gen).cuda()
                   for _ in "ab")
    grads = {}
    for use_flash in (None, False):
        model = ttf.LanguageModel.from_config(cfg, device="cuda", seed=8)
        ttf.make_train_step(cuda_grid, model.config, use_flash=use_flash,
                            layers=2)(model, ids, labels)
        grads[use_flash] = model.reference_names(grads=True)
    for n, g in grads[None].items():
        want = grads[False][n]
        assert ((g - want).norm() / want.norm()).item() <= 1e-2, n


# ------------------------------------------------ stencil pipeline --


@pytest.mark.parametrize("buffering", [1, 3])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,depth,stripe,at,grid", [
    (24, 128, 8, None, (0, 0), (24, 128)),           # one window
    (72, 384, 16, 24, (8, 128), (200, 1024)),        # a ragged band
    (4096, 1024, 8, None, (0, 0), (4096, 1024)),     # several windows a block
    # a ragged last band inside the grid and at its four edges, at every
    # register depth and on the generic loop (k=24)
    (256, 1408, 16, None, (1024, 2048), (4096, 4096)),
    (256, 1408, 32, None, (0, 0), (256, 1408)),
    (256, 1408, 8, None, (3840, 2688), (4096, 4096)),
    (256, 1408, 24, 16, (1024, 0), (4096, 4096)),
])
def test_pipeline_kernel_equals_its_plain_version(cuda_comm, buffering,
                                                  compute_dtype, h, w,
                                                  depth, stripe, at, grid):
    """Random extended state (the halos in its border): the kernel is
    torch.equal to its plain version in both compute dtypes, one launch,
    and out's border is not written."""
    k = depth
    gen = torch.Generator(device="cuda").manual_seed(h + k)
    ext = torch.rand((h + 2 * k, w + 2 * k), generator=gen, device="cuda")
    out = torch.full_like(ext, float("nan"))
    before = _build.LAUNCHES["stencil_pipeline"]
    got = st.pipeline_sweeps(ext, *at, *grid, k, stripe=stripe,
                             compute_dtype=compute_dtype,
                             buffering=buffering, out=out)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stencil_pipeline"] == before + 1
    want = st.pipeline_sweeps_plain(ext, *at, *grid, k, compute_dtype)
    assert torch.equal(got, want)
    assert bool(torch.isnan(out[:k]).all() and torch.isnan(out[:, :k]).all())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [8, 16, 32])
def test_pipeline_kernel_gives_the_same_bits_twice(cuda_comm, compute_dtype,
                                                   depth):
    k = depth
    gen = torch.Generator(device="cuda").manual_seed(k)
    ext = torch.rand((512 + 2 * k, 1408 + 2 * k), generator=gen,
                     device="cuda")
    runs = [st.pipeline_sweeps(ext, 0, 0, 512, 1408, k,
                               compute_dtype=compute_dtype).clone()
            for _ in range(2)]
    assert torch.equal(*runs)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pipeline_stencil_on_the_card(cuda_comm, compute_dtype):
    """19 sweeps at depth 8 (two passes, then the remainder on the
    single-sweep kernel): f32 equals the serial reference, bf16 stays
    within the reference's 0.05 per pass and is not f32."""
    g = _grid(64, 256)
    before = dict(_build.LAUNCHES)
    out = st.make_pipeline_stencil_fn(cuda_comm, 19, 64, 256, depth=8,
                                      compute_dtype=compute_dtype)(
        st.block_from_numpy(g, cuda_comm))
    made = {n: _build.LAUNCHES[n] - before[n] for n in before}
    assert made["stencil_pipeline"] == 2 and made["stencil_sweep"] == 3
    got, ref = st.grid_to_numpy(out, cuda_comm), st.reference_stencil(g, 19)
    if compute_dtype == "float32":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 2 * 0.05
        assert not np.array_equal(got, ref)


def test_pipeline_refuses_a_non_f32_cuda_block(cuda_comm):
    block = st.block_from_numpy(_grid(64, 256), cuda_comm).double()
    with pytest.raises(ValueError, match="float32"):
        st.make_pipeline_stencil_fn(cuda_comm, 8, 64, 256, depth=8)(block)


# ------------------------------------------------------- the ring tier --


@pytest.fixture
def cuda_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    worlds = {}

    def make(n):
        if n not in worlds:
            worlds[n] = st.LocalWorld(n)
        return worlds[n]

    return make


def _ring_inputs(n, shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        xs = [torch.randn(shape, generator=gen).to(dtype) for _ in range(n)]
    else:
        xs = [torch.randint(-100, 100, shape, generator=gen).to(dtype)
              for _ in range(n)]
    return [x.cuda() for x in xs]


def _check_ring(world, call, plain, xs):
    """The kernel equals its plain version on every rank, every credit
    domain drained, and the plain version without rank 1's contribution
    is not equal."""
    from smi_tpu_torch.kernels import ring as kring

    name = call(None, None, probe=True)
    before = _build.LAUNCHES[name]
    got = world.run(lambda c: call(xs[c.rank], c))
    assert _build.LAUNCHES[name] == before + 1
    record = kring.last_record(world)
    assert kring.drained(record), record
    want = plain(xs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dropped = list(xs)
    dropped[1] = torch.zeros_like(xs[1])
    control = plain(dropped)
    assert not all(torch.equal(g, c) for g, c in zip(got, control))
    return record


RING_DTYPES = [torch.float32, torch.int32, torch.bfloat16, torch.int8,
               torch.int16, torch.float64]


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype", RING_DTYPES, ids=str)
@pytest.mark.parametrize("op", ["add", "max"])
def test_ring_all_reduce_kernel_equals_plain(cuda_world, n, dtype, op):
    from smi_tpu_torch.kernels import ring as kring

    xs = _ring_inputs(n, (3, 130), dtype, seed=n)
    record = _check_ring(
        cuda_world(n),
        lambda x, c, probe=False: "ring_all_reduce" if probe
        else kring.ring_all_reduce(x, c, op=op),
        lambda ys: kring.ring_all_reduce_plain(ys, op), xs)
    # n-1 credits a block: slot 1 at the start, then one a step but the last
    assert int(record["granted"].sum()) == n * (n - 1)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype", RING_DTYPES, ids=str)
@pytest.mark.parametrize("shape,chunks,op", [
    ((12, 130), 3, "add"),   # rows that the chunks divide
    ((10, 33), 4, "max"),    # 3 rows a chunk, two zero pad rows
    ((3, 17), 8, "min"),     # clamped to 3 chunks
    ((1000,), 4, "add"),     # 1-D: (4, 1, 250)
])
def test_ring_all_reduce_chunked_kernel_equals_plain(cuda_world, n, dtype,
                                                     shape, chunks, op):
    from smi_tpu_torch.kernels import ring as kring

    world = cuda_world(n)
    xs = _ring_inputs(n, shape, dtype, seed=70 + n)
    record = _check_ring(
        world,
        lambda x, c, probe=False: "ring_all_reduce_chunked" if probe
        else kring.ring_all_reduce(x, c, op=op, chunks=chunks, stream=1),
        lambda ys: kring.ring_all_reduce_chunked_plain(ys, chunks, op), xs)
    # every chunk's row of every block is a credit domain of its own
    rows = min(chunks, shape[0]) * record["blocks"]
    assert record["chunks"] == min(chunks, shape[0])
    assert int(record["granted"].sum()) == n * (n - 1) * rows
    # and bit for bit the unchunked kernel
    plain = kring.ring_all_reduce_chunked_plain(xs, chunks, op)
    unchunked = world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c,
                                                          op=op))
    assert all(torch.equal(u, p) for u, p in zip(unchunked, plain))


def test_chunked_sub_rings_of_a_grid_share_one_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from smi_tpu_torch.kernels import ring as kring

    world = st.LocalWorld((2, 4), ("sx", "sy"))
    xs = _ring_inputs(8, (9, 77), torch.float32, seed=80)
    for axis in ("sx", "sy"):
        before = _build.LAUNCHES["ring_all_reduce_chunked"]
        got = world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c, axis,
                                                        chunks=4))
        assert _build.LAUNCHES["ring_all_reduce_chunked"] == before + 1
        assert kring.drained(kring.last_record(world))
        for line in world.lines(axis):
            want = kring.ring_all_reduce_plain([xs[r] for r in line])
            for r, w in zip(line, want):
                assert torch.equal(got[r], w)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("shape", [(1000,), (2, 130), (1, 33000)])
def test_ring_all_gather_kernel_equals_plain(cuda_world, n, shape):
    from smi_tpu_torch.kernels import ring as kring

    xs = _ring_inputs(n, shape, torch.float32, seed=10 + n)
    _check_ring(
        cuda_world(n),
        lambda x, c, probe=False: "ring_all_gather" if probe
        else kring.ring_all_gather(x, c, stream=1),
        kring.ring_all_gather_plain, xs)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype,op", [(torch.float32, "add"),
                                      (torch.int8, "min"),
                                      (torch.bfloat16, "add")], ids=str)
def test_ring_reduce_scatter_kernel_equals_plain(cuda_world, n, dtype, op):
    from smi_tpu_torch.kernels import ring as kring

    xs = _ring_inputs(n, (2 * n, 130), dtype, seed=20 + n)
    _check_ring(
        cuda_world(n),
        lambda x, c, probe=False: "ring_reduce_scatter" if probe
        else kring.ring_reduce_scatter(x, c, op=op, stream=2),
        lambda ys: kring.ring_reduce_scatter_plain(ys, op), xs)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("chunks", [1, 2, 5])
def test_neighbour_stream_kernel_equals_plain(cuda_world, n, direction,
                                              chunks):
    from smi_tpu_torch.kernels import ring as kring

    xs = _ring_inputs(n, (chunks, 130), torch.float32, seed=30 + n)
    record = _check_ring(
        cuda_world(n),
        lambda x, c, probe=False: "ring_neighbour_stream" if probe
        else kring.neighbour_stream(x, c, direction=direction, stream=3),
        lambda ys: kring.neighbour_stream_plain(ys, direction), xs)
    # no grant for the last two chunks
    assert int(record["granted"].sum()) == n * max(0, chunks - 2)


def test_ring_kernels_without_flow_control(cuda_world):
    """No barrier, no credits; safe where nothing can be overwritten: one
    step (two ranks) and a stream of two chunks."""
    from smi_tpu_torch.kernels import ring as kring

    xs = _ring_inputs(2, (4, 1000), torch.float32, seed=40)
    for call, plain in (
            (lambda x, c, probe=False: "ring_all_reduce" if probe
             else kring.ring_all_reduce(x, c, flow_control=False),
             kring.ring_all_reduce_plain),
            (lambda x, c, probe=False: "ring_all_gather" if probe
             else kring.ring_all_gather(x, c, flow_control=False),
             kring.ring_all_gather_plain),
            (lambda x, c, probe=False: "ring_reduce_scatter" if probe
             else kring.ring_reduce_scatter(x, c, flow_control=False),
             kring.ring_reduce_scatter_plain)):
        record = _check_ring(cuda_world(2), call, plain, xs)
        assert not record["granted"].any() and not record["barrier"].any()
    xs = _ring_inputs(8, (2, 1000), torch.float32, seed=41)
    _check_ring(
        cuda_world(8),
        lambda x, c, probe=False: "ring_neighbour_stream" if probe
        else kring.neighbour_stream(x, c, flow_control=False),
        kring.neighbour_stream_plain, xs)


def _stream_record_holds(record, chunks, flow_control=True):
    """The stream's credit record: every block drained; with credits a
    live block held the barrier with both neighbours and granted and
    consumed ``chunks - 2`` credits, a block past the end of a small chunk
    none; without them no barrier and no credit."""
    from smi_tpu_torch.kernels import ring as kring

    assert kring.drained(record), record
    if not flow_control:
        assert not record["granted"].any() and not record["barrier"].any()
        return
    live = record["barrier"] == 2
    assert bool(live.any()) and not record["barrier"][~live].any()
    credits = max(0, chunks - 2)
    assert bool((record["granted"][live] == credits).all()), record
    assert bool((record["consumed"][live] == credits).all()), record


#: chunk sizes from one byte to 4 MiB (int8 where the size is no multiple
#: of 4, f32 otherwise: ragged slices, byte tails, one to 64 blocks a
#: rank), each at 1, 2, 3, 16 and 507 chunks where a rank's message stays
#: within 64 MiB
STREAM_CHUNK_BYTES = [1, 3, 520, 4096, 4099, 8288, 32768, 1 << 20, 4 << 20]
STREAM_CASES = [(b, c) for b in STREAM_CHUNK_BYTES for c in (1, 2, 3, 16, 507)
                if b * c <= 64 << 20]


@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("chunk_bytes,chunks", STREAM_CASES)
def test_neighbour_stream_at_every_chunk_size(cuda_world, chunk_bytes, chunks,
                                              direction):
    from smi_tpu_torch.kernels import ring as kring

    dtype = torch.float32 if chunk_bytes % 4 == 0 else torch.int8
    xs = _ring_inputs(8, (chunks, chunk_bytes // dtype.itemsize), dtype,
                      seed=chunk_bytes + chunks)
    record = _check_ring(
        cuda_world(8),
        lambda x, c, probe=False: "ring_neighbour_stream" if probe
        else kring.neighbour_stream(x, c, direction=direction),
        lambda ys: kring.neighbour_stream_plain(ys, direction), xs)
    _stream_record_holds(record, chunks)
    assert record["blocks"] == kring.launch_plan(
        chunk_bytes, 8, 1, kring.STREAM_SLICE_BYTES)[0]


@pytest.mark.parametrize("shape", [(1, 2048), (16, 4096), (37, 130)])
@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("axis", ["sx", "sy"])
def test_neighbour_stream_on_the_lines_of_a_grid(axis, direction, shape):
    """The 2x4 world's ``sx`` rings of two and ``sy`` rings of four, every
    line in one launch: the halo's one-chunk slabs and longer streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from smi_tpu_torch.kernels import ring as kring

    world = st.LocalWorld((2, 4), ("sx", "sy"))
    xs = _ring_inputs(8, shape, torch.float32, seed=shape[0] + direction)
    before = _build.LAUNCHES["ring_neighbour_stream"]
    got = world.run(lambda c: kring.neighbour_stream(
        xs[c.rank], c, axis, direction=direction))
    assert _build.LAUNCHES["ring_neighbour_stream"] == before + 1
    _stream_record_holds(kring.last_record(world), shape[0])
    for line in world.lines(axis):
        want = kring.neighbour_stream_plain([xs[r] for r in line], direction)
        for r, w in zip(line, want):
            assert torch.equal(got[r], w)


@pytest.mark.parametrize("chunk_bytes", [4, 8288, 32768, 1 << 20])
def test_neighbour_stream_without_flow_control_at_two_chunks(cuda_world,
                                                             chunk_bytes):
    """Two chunks, one a slot, need no credit however many blocks a rank
    plays them."""
    from smi_tpu_torch.kernels import ring as kring

    xs = _ring_inputs(8, (2, chunk_bytes // 4), torch.float32,
                      seed=chunk_bytes)
    record = _check_ring(
        cuda_world(8),
        lambda x, c, probe=False: "ring_neighbour_stream" if probe
        else kring.neighbour_stream(x, c, flow_control=False),
        kring.neighbour_stream_plain, xs)
    _stream_record_holds(record, 2, flow_control=False)


@pytest.mark.parametrize("chunks", [2, 4, 8])
def test_chunked_kernel_spreads_chunks_over_blocks(cuda_world, chunks):
    """1 MiB f32 a rank on 8 ranks: chunk c on blocks of its own, 64
    blocks a rank whatever the chunk count, every row drained, bit for
    bit the unchunked kernel."""
    from smi_tpu_torch.kernels import ring as kring

    world = cuda_world(8)
    xs = _ring_inputs(8, (64, 4096), torch.float32, seed=90 + chunks)
    got = world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c,
                                                    chunks=chunks))
    record = kring.last_record(world)
    assert (record["chunks"], record["blocks"]) == (chunks, 64 // chunks)
    assert kring.drained(record), record
    assert int(record["granted"].sum()) == 8 * 7 * 64
    assert bool((record["barrier"] == 2).all())
    unchunked = world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c))
    assert all(torch.equal(g, u) for g, u in zip(got, unchunked))
    plain = kring.ring_all_reduce_chunked_plain(xs, chunks)
    assert all(torch.equal(g, w) for g, w in zip(got, plain))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.float32,
                                   torch.float64])
def test_live_blocks_follow_the_slicing(cuda_world, dtype):
    """The kernel's own slicing (``ring.cu``'s ``slice_of``), over the
    payloads of ``test_torch_ring.py``'s launch-plan cases: a block whose
    16-byte-rounded slice starts inside its chunk's unit holds the
    barrier with its two neighbours (2), one past the end returns at once
    (0), and the values are the plain version's."""
    from smi_tpu_torch.kernels import ring as kring

    world = cuda_world(8)
    esize = dtype.itemsize
    for nbytes in (1, 16, 520, 4096, 16 * 1024 + 8, 131072, 1 << 20,
                   4 << 20):
        elems = max(1, nbytes // esize)
        for chunks in (1, 3, 8):
            xs = _ring_inputs(8, (elems,), dtype, seed=nbytes + chunks)
            got = world.run(lambda c: kring.ring_all_reduce(
                xs[c.rank], c, chunks=chunks))
            record = kring.last_record(world)
            assert kring.drained(record), (nbytes, chunks, record)
            c, blocks = record["chunks"], record["blocks"]
            unit = -(-elems // c)
            per = -(-unit // blocks)
            per = -(-per // (16 // esize)) * (16 // esize)
            live = -(-unit // per)
            barrier = record["barrier"].reshape(8, c, blocks)
            assert bool((barrier[:, :, :live] == 2).all()), (nbytes, chunks)
            assert not barrier[:, :, live:].any(), (nbytes, chunks)
            want = kring.ring_all_reduce_chunked_plain(xs, chunks)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


#: one block a rank (one a chunk for the chunked entry): 4 KiB units
ONE_BLOCK = {
    "ring_all_reduce": ((1024,), {}),
    "ring_all_reduce_chunked": ((4, 1024), {"chunks": 4}),
    "ring_all_gather": ((1024,), {}),
    "ring_reduce_scatter": ((8 * 1024,), {}),
    "ring_neighbour_stream": ((16, 1024), {}),
}


@pytest.mark.parametrize("kernel", sorted(ONE_BLOCK))
def test_ring_entry_repeats_equal_at_one_block_a_rank(cuda_world, kernel):
    """A race shows rarely: 100 launches of one entry on 8 ranks, fresh
    random inputs each, every one equal to the plain version and
    drained."""
    from smi_tpu_torch.kernels import ring as kring

    shape, kw = ONE_BLOCK[kernel]
    call, plain = {
        "ring_all_reduce": (kring.ring_all_reduce,
                            kring.ring_all_reduce_plain),
        "ring_all_reduce_chunked": (
            kring.ring_all_reduce,
            lambda ys: kring.ring_all_reduce_chunked_plain(ys, 4)),
        "ring_all_gather": (kring.ring_all_gather,
                            kring.ring_all_gather_plain),
        "ring_reduce_scatter": (kring.ring_reduce_scatter,
                                kring.ring_reduce_scatter_plain),
        "ring_neighbour_stream": (kring.neighbour_stream,
                                  kring.neighbour_stream_plain),
    }[kernel]
    world = cuda_world(8)
    before = _build.LAUNCHES[kernel]
    for i in range(100):
        xs = _ring_inputs(8, shape, torch.float32, seed=1000 + i)
        got = world.run(lambda c: call(xs[c.rank], c, **kw))
        record = kring.last_record(world)
        assert record["blocks"] == 1
        assert kring.drained(record), (i, record)
        for g, w in zip(got, plain(xs)):
            assert torch.equal(g, w), i
    assert _build.LAUNCHES[kernel] == before + 100


def test_sub_rings_of_a_grid_share_one_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from smi_tpu_torch.kernels import ring as kring

    world = st.LocalWorld((2, 4), ("sx", "sy"))
    xs = _ring_inputs(8, (5, 77), torch.int32, seed=50)
    for axis in ("sx", "sy"):
        before = _build.LAUNCHES["ring_all_reduce"]
        got = world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c, axis))
        assert _build.LAUNCHES["ring_all_reduce"] == before + 1
        assert kring.drained(kring.last_record(world))
        for line in world.lines(axis):
            want = kring.ring_all_reduce_plain([xs[r] for r in line])
            for r, w in zip(line, want):
                assert torch.equal(got[r], w)


def test_pointer_table_follows_the_tensors_brought(cuda_world):
    """The table on the card is rewritten only when a pointer in it
    changed: the same tensors twice, then others while the first live."""
    from smi_tpu_torch.kernels import ring as kring

    world = cuda_world(3)
    first = _ring_inputs(3, (7, 130), torch.float32, seed=60)
    second = _ring_inputs(3, (7, 130), torch.float32, seed=61)
    for xs in (first, first, second, first):
        got = world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c))
        assert kring.drained(kring.last_record(world))
        for g, w in zip(got, kring.ring_all_reduce_plain(xs)):
            assert torch.equal(g, w)


def test_smi_api_on_the_card_matches_the_xla_tier(cuda_world):
    world = cuda_world(8)
    x = np.arange(8 * 4096, dtype=np.int32)

    def app(backend):
        @st.smi_kernel(world, in_specs="smi", out_specs="smi",
                       backend=backend)
        def run(ctx, v):
            ch = ctx.open_channel(port=0, src=0, dst=5, count=v.shape[0],
                                  dtype="int")
            return (ctx.bcast(v, root=5), ctx.reduce(v, op="max", root=2),
                    ctx.scatter(v, root=3), ctx.gather(v[:16], root=7),
                    ctx.transfer(ch, v), ctx.stream(ch, v)[0])
        return run(x)

    _build.reset_launches()
    ring = app("ring")
    assert _build.LAUNCHES["ring_all_reduce"] == 2
    assert _build.LAUNCHES["ring_neighbour_stream"] == 6   # 3 hops, twice
    for r, w in zip(ring, app("xla")):
        assert torch.equal(r, w)
    assert torch.equal(ring[0].view(8, -1)[1].cpu(),
                       torch.from_numpy(x[5 * 4096:6 * 4096]))


# ------------------------------- the rest of the collective surface --


@pytest.fixture
def cuda_hybrid():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return st.LocalWorld((2, 4), ("dcn", "ici"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("count", [1, 3, 128])
def test_all_to_all_forms_on_the_card(cuda_hybrid, dtype, count):
    """Pairwise, Bruck and the two-tier form on the ``(2, 4)`` world on
    the card, each equal to the block transpose of the stacked inputs."""
    xs = _ring_inputs(8, (8 * count, 33), dtype, seed=count)
    want = torch.stack(xs).view(8, 8, count, 33).transpose(0, 1)
    for algorithm in ("pairwise", "bruck", "hierarchical"):
        got = cuda_hybrid.run(lambda c: st.all_to_all(
            xs[c.rank], c, algorithm=algorithm))
        assert torch.equal(torch.stack(got).view(8, 8, count, 33), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32], ids=str)
def test_allreduce_forms_on_the_card(cuda_hybrid, dtype):
    xs = _ring_inputs(8, (64, 130), dtype, seed=3)
    runs = {kw: cuda_hybrid.run(lambda c: st.allreduce(
        xs[c.rank], c, **dict(kw))) for kw in (
            (("rs_ag", False),), (("rs_ag", True),),
            (("hierarchical", True),))}
    flat = runs[(("rs_ag", False),)]
    for outs in runs.values():
        for got, want in zip(outs, flat):
            if dtype == torch.int32:
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("precision", ["bf16", "int8", "topk"])
def test_precision_allreduce_on_the_card(cuda_world, precision):
    """Quantise, then the ring kernel: equal to the plain ring all-reduce
    of the quantised contributions; the xla tier within 1e-6; clean values
    exact on both tiers."""
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.parallel import collectives as pcoll

    world = cuda_world(8)
    xs = _ring_inputs(8, (4096,), torch.float32, seed=5)
    want = kring.ring_all_reduce_plain(
        [pcoll._quantize(x, precision) for x in xs], "add")
    for backend in ("ring", "xla"):
        pcoll.error_feedback_reset()
        _build.reset_launches()
        got = world.run(lambda c: st.allreduce(
            xs[c.rank], c, precision=precision, backend=backend))
        assert _build.LAUNCHES["ring_all_reduce"] == (backend == "ring")
        for g, w in zip(got, want):
            if backend == "ring":
                assert torch.equal(g, w)
            else:
                torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-5)
        clean = world.run(lambda c: st.allreduce(
            torch.full((16,), 3.5, device="cuda"), c, precision=precision,
            backend=backend))
        assert all(torch.equal(o, torch.full_like(o, 28.0)) for o in clean)
    pcoll.error_feedback_reset()


@pytest.mark.parametrize("backend", ["xla", "ring"])
def test_verified_transfers_on_the_card(cuda_world, backend):
    world = cuda_world(8)
    count = 3 * 2072 + 5
    x = torch.randn(count, generator=torch.Generator().manual_seed(9)).cuda()

    def on_rank(c):
        ch = st.P2PChannel(c, port=0, src=5, dst=6, count=count,
                           buffer_size=2048)
        received, check = ch.transfer_verified(x, backend=backend)
        streamed, _, s_check = ch.stream_verified(x, backend=backend)
        ch.verify_frames(check)
        ch.verify_frames(s_check)
        return ch, received, streamed, check

    _build.reset_launches()
    outs = world.run(on_rank)
    assert _build.LAUNCHES["ring_neighbour_stream"] == (
        4 if backend == "ring" else 0)   # payload and checksums, twice
    ch, received, streamed, check = outs[6]
    assert torch.equal(received, x) and torch.equal(streamed, x)
    assert torch.equal(check.expected, ch.chunk_checksums(x))
    bad = received.clone()
    bad.view(torch.int32)[2072 + 17] ^= 1 << 30
    with pytest.raises(st.IntegrityError) as err:
        ch.verify_frames(st.FrameCheck(check.expected,
                                       ch.chunk_checksums(bad),
                                       check.at_dst))
    assert (err.value.seq, err.value.kind) == (1, "checksum")


# ------------------------------------------------------- roll chains --


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("length", [1, 3, 1000, 4097])
@pytest.mark.parametrize("shape,ilp", [((512, 2048), 1), ((256, 2048), 2),
                                       ((7, 300), 3)])
@pytest.mark.parametrize("body", ["lane", "sublane", "add"])
def test_roll_chain_kernel_equals_its_plain_version(cuda_dev, body, shape,
                                                    ilp, length):
    """Random inputs at lengths whose net shift is not 0 (a multiple of
    the rolled axis would give back the input), with the R=1 control
    unequal to the input."""
    from smi_tpu_torch.kernels import roll

    gen = torch.Generator(device=cuda_dev).manual_seed(length + ilp)
    xs = tuple(torch.randn(shape, generator=gen, device=cuda_dev)
               for _ in range(ilp))
    before = _build.LAUNCHES["roll_chain"]
    got = roll.roll_chain(xs, length, body)
    assert _build.LAUNCHES["roll_chain"] == before + 1
    for g, w in zip(got, roll.roll_chain_plain(xs, length, body)):
        assert torch.equal(g, w)
    control = roll.roll_chain(xs, 1, body)
    assert not any(torch.equal(c, x) for c, x in zip(control, xs))


@pytest.mark.parametrize("shape", [(45, 1000), (1000, 45), (70, 77)])
@pytest.mark.parametrize("ilp", [1, 2, 3])
@pytest.mark.parametrize("body", ["lane", "sublane", "add"])
def test_roll_chain_kernel_on_ragged_axes(cuda_dev, body, ilp, shape):
    """Axes that are not a multiple of 32: a line leaves the top of its
    last register empty, and the wrap takes element n - 1 from a
    register chosen at run time."""
    from smi_tpu_torch.kernels import roll

    gen = torch.Generator(device=cuda_dev).manual_seed(sum(shape) + ilp)
    xs = tuple(torch.randn(shape, generator=gen, device=cuda_dev)
               for _ in range(ilp))
    for length in (1, 33, 1001):
        got = roll.roll_chain(xs, length, body)
        for g, w in zip(got, roll.roll_chain_plain(xs, length, body)):
            assert torch.equal(g, w), length
    control = roll.roll_chain(xs, 1, body)
    assert not any(torch.equal(c, x) for c, x in zip(control, xs))


@pytest.mark.parametrize("chains", [1, 2, 3, 4])
@pytest.mark.parametrize("body", ["lane", "sublane", "add"])
def test_roll_chain_kernel_at_its_axis_limit(cuda_dev, body, chains):
    """The longest axis the kernel takes (all its registers a thread), at
    each chain count, and one element more refused."""
    from smi_tpu_torch.kernels import roll

    n = roll.MAX_AXIS
    shape = (n, 5) if body == "sublane" else (5, n)
    gen = torch.Generator(device=cuda_dev).manual_seed(n + chains)
    xs = tuple(torch.randn(shape, generator=gen, device=cuda_dev)
               for _ in range(chains))
    for length in (1, n + 7):
        got = roll.roll_chain(xs, length, body)
        for g, w in zip(got, roll.roll_chain_plain(xs, length, body)):
            assert torch.equal(g, w), length
    longer = (n + 1, 5) if body == "sublane" else (5, n + 1)
    with pytest.raises(ValueError, match=f"limit of {n} elements"):
        roll.roll_chain(tuple(torch.zeros(longer, device=cuda_dev)
                              for _ in range(chains)), 1, body)


@pytest.mark.parametrize("shape,ilp", [((512, 2048), 1), ((256, 2048), 2),
                                       ((7, 300), 3)])
@pytest.mark.parametrize("body", ["lane", "sublane", "add"])
def test_roll_chain_kernel_gives_the_same_bits_twice(cuda_dev, body, shape,
                                                     ilp):
    from smi_tpu_torch.kernels import roll

    gen = torch.Generator(device=cuda_dev).manual_seed(ilp)
    xs = tuple(torch.randn(shape, generator=gen, device=cuda_dev)
               for _ in range(ilp))
    first = roll.roll_chain(xs, 1000, body)
    second = roll.roll_chain(xs, 1000, body)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_roll_chain_kernel_refuses_an_axis_too_long(cuda_dev):
    from smi_tpu_torch.kernels import roll

    with pytest.raises(ValueError, match="limit of 4096 elements"):
        roll.roll_chain((torch.zeros(2, 20000, device=cuda_dev),), 1, "lane")
    with pytest.raises(ValueError, match="limit of 4096 elements"):
        roll.roll_chain((torch.zeros(4097, 2, device=cuda_dev),) * 2, 1,
                        "sublane")
    with pytest.raises(TypeError, match="float32"):
        roll.roll_chain((torch.zeros(2, 8, device=cuda_dev,
                                     dtype=torch.float64),), 1, "add")


# ------------------------------------------------------ the plan engine --


@pytest.fixture
def engine_on_card():
    """The plan engine's module, its process-global engine reset to the
    default (the seeded cache) and restored after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine keys by its name")
    from smi_tpu_torch.tuning import engine as eng

    saved = eng._ENGINE
    eng.set_engine(None)
    yield eng
    eng.set_engine(saved)


def _kinds_of(world, fn):
    """``(outs, kinds)``: the rendezvous kinds of one ``world.run(fn)``."""
    calls = []
    real = world.rendezvous

    def rendezvous(rank, kind, payload, work):
        if rank == 0:
            calls.append(kind)
        return real(rank, kind, payload, work)

    world.rendezvous = rendezvous
    try:
        outs = world.run(fn)
    finally:
        del world.rendezvous
    return outs, calls


def test_plan_engine_detects_the_card(engine_on_card):
    from smi_tpu_torch.tuning import plan, seeded

    name = torch.cuda.get_device_name(0)
    kind = engine_on_card.get_engine().device_kind()
    assert kind == engine_on_card._detect_device_kind() == \
        plan.normalize_device_kind(name)
    if name == "NVIDIA H100 80GB HBM3":
        assert kind == seeded.SEEDED_H100_DEVICE_KIND


@pytest.mark.parametrize("topology", ["n8", "n8:dcn2"])
@pytest.mark.parametrize("op", ["all_reduce", "all_to_all"])
def test_seeded_h100_entries_decide_the_untuned_gates(engine_on_card, op,
                                                      topology):
    """Each seeded H100 entry is the gate's answer from the cache, and an
    untuned f32 call at its payload makes the rendezvous of the pinned
    form it names, with equal results on every rank."""
    from smi_tpu_torch.tuning import cost_model as cm
    from smi_tpu_torch.tuning import seeded
    from smi_tpu_torch.tuning.plan import PlanKey

    eng = engine_on_card.get_engine()
    if eng.device_kind() != seeded.SEEDED_H100_DEVICE_KIND:
        pytest.skip("the seeded entries are the H100 80GB HBM3's")
    world = (st.LocalWorld((2, 4), ("dcn", "ici")) if topology == "n8:dcn2"
             else st.LocalWorld(8))
    topo = cm.topology_from_comm(world)
    cache = seeded.seeded_cache()
    for bucket in (16, 18, 20, 22):
        payload = 1 << bucket
        entry = cache.lookup(PlanKey(op, f"pow2:{bucket}", "float32",
                                     seeded.SEEDED_H100_DEVICE_KIND,
                                     topology))
        algorithm = entry.knobs["algorithm"]
        if op == "all_to_all":
            assert eng.use_alltoall(payload, topo) == (algorithm, "cache")
            pinned = dict(algorithm=algorithm)
            call = st.all_to_all
        elif topology == "n8:dcn2":
            assert eng.use_hierarchical(payload, topo) == (
                algorithm == "hierarchical", "cache")
            pinned = (dict(hierarchical=True) if algorithm == "hierarchical"
                      else dict(hierarchical=False))
            call = st.allreduce
        else:
            assert eng.use_rs_ag(payload, topo) == (algorithm == "rs_ag",
                                                    "cache")
            pinned = dict(rs_ag=algorithm == "rs_ag")
            call = st.allreduce
        xs = _ring_inputs(8, (payload // 4,), torch.float32, seed=bucket)
        untuned, kinds = _kinds_of(world, lambda c: call(xs[c.rank], c))
        want, want_kinds = _kinds_of(world, lambda c: call(xs[c.rank], c,
                                                           **pinned))
        assert kinds == want_kinds, (bucket, pinned)
        for u, w in zip(untuned, want):
            assert torch.equal(u, w)


def test_sweeps_write_entries_keyed_to_the_card(engine_on_card):
    from smi_tpu_torch.tuning import sweep
    from smi_tpu_torch.tuning.cache import PlanCache
    from smi_tpu_torch.tuning.plan import PlanKey, normalize_device_kind

    kind = normalize_device_kind(torch.cuda.get_device_name(0))
    engine_on_card.set_engine(engine_on_card.PlanEngine(cache=PlanCache()))
    record = []
    caches = (
        sweep.sweep_allreduce(st.LocalWorld(4), sizes_kb=(64,),
                              chunk_candidates=(1, 2), runs=1,
                              record=record),
        sweep.sweep_alltoall(st.LocalWorld((2, 2), ("dcn", "ici")),
                             sizes_kb=(64,), runs=1, record=record),
    )
    sigs = [sig for c in caches for sig in c.entries]
    assert {"all_reduce|pow2:16|float32|" + kind + "|n4",
            "all_to_all|pow2:16|float32|" + kind + "|n4:dcn2"} <= set(sigs)
    assert all(PlanKey.from_signature(s).device_kind == kind for s in sigs)
    assert len(record) == 4 + 3 and all(us > 0 for _, _, us in record)


# ------------------------------------- the backward on a thread world --

#: a rendezvous that waits this long has hung; the default is 600 s
SHORT_RENDEZVOUS_S = 30.0
#: the f32 bar of the ring's gradients against the one-rank gradients
#: (``F32_TOL`` of ``chip_smoke.py``: atol = rtol)
GRAD_TOL = 2e-5


@pytest.fixture
def short_rendezvous(monkeypatch):
    """Worlds built under this fixture break a hung rendezvous in
    ``SHORT_RENDEZVOUS_S`` (the barrier takes its timeout when the world
    is built)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from smi_tpu_torch.parallel import local

    monkeypatch.setattr(local, "RENDEZVOUS_TIMEOUT_S", SHORT_RENDEZVOUS_S)


def _attention_grads(comm, shards, weight, use_flash, threads):
    """``(dq, dk, dv)`` of ``sum(attention(q, k, v) * weight)`` on this
    rank by one ``.backward()``; the name of the thread that ran q's
    gradient node goes into ``threads``."""
    import threading

    q, k, v = (s.clone().requires_grad_(True) for s in shards)
    q.register_hook(lambda g: threads.append(
        (comm.rank, threading.current_thread().name)))
    out = st.make_ring_attention_fn(comm, causal=True,
                                    use_flash=use_flash)(q, k, v)
    (out * weight).sum().backward()
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_backward_on_a_thread_world(short_rendezvous, n,
                                                   use_flash):
    """Every rank of a CUDA ``LocalWorld`` calls ``.backward()`` on its
    loss: the ring's backward meets at the world's rendezvous from the
    rank threads, and the gradients equal the one-rank gradients over the
    whole sequence."""
    import time

    s_local, h, d = 512, 2, 64
    rng = np.random.RandomState(16 + n)
    q, k, v, w = (rng.randn(s_local * n, h, d).astype(np.float32)
                  for _ in range(4))
    one = st.make_communicator(shape=(1,), axis_names=("sp",),
                               device="cuda")
    whole = [st.sequence_shard_from_numpy(x, one) for x in (q, k, v)]
    want = _attention_grads(one, whole, st.sequence_shard_from_numpy(w, one),
                            use_flash, [])
    world = st.LocalWorld(n, ("sp",))
    threads = []

    def rank(c):
        shards = [st.sequence_shard_from_numpy(x, c) for x in (q, k, v)]
        return _attention_grads(c, shards, st.sequence_shard_from_numpy(w, c),
                                use_flash, threads)

    t0 = time.perf_counter()
    got = world.run(rank)
    assert time.perf_counter() - t0 < SHORT_RENDEZVOUS_S
    assert sorted(threads) == [(r, f"smi-rank-{r}") for r in range(n)]
    for i, name in enumerate(("dq", "dk", "dv")):
        ring = torch.cat([g[i] for g in got])
        torch.testing.assert_close(ring, want[i], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, msg=name)


def test_ring_shift_backward_on_a_thread_world(short_rendezvous):
    """``ring_shift(x).sum().backward()`` on every rank of a 4-rank CUDA
    world: rank r's x went to rank r + 1, whose loss weights it by
    ``(r + 1) % 4 + 1``, so that is rank r's gradient."""
    n = 4
    world = st.LocalWorld(n)

    def rank(c):
        x = torch.full((3, 130), float(c.rank), device=c.device,
                       requires_grad=True)
        (st.ring_shift(x, c) * (c.rank + 1)).sum().backward()
        return x.grad

    got = world.run(rank)
    for r, g in enumerate(got):
        assert torch.equal(g, torch.full_like(g, (r + 1) % n + 1))


# --------------------------------- rings of 7 and the elastic worlds --


@pytest.mark.parametrize("dtype,op", [(torch.float32, "add"),
                                      (torch.int32, "max")], ids=str)
def test_ring_all_reduce_on_seven_ranks(cuda_world, dtype, op):
    """A ring whose size is not a power of two (the survivors of an
    8-rank world): the kernel equals its plain version."""
    from smi_tpu_torch.kernels import ring as kring

    xs = _ring_inputs(7, (65520 // 7, 16), dtype, seed=7)
    _check_ring(cuda_world(7),
                lambda x, c, probe=False: "ring_all_reduce" if probe
                else kring.ring_all_reduce(x, c, op=op),
                lambda ys: kring.ring_all_reduce_plain(ys, op), xs)


@pytest.mark.parametrize("root", [0, 3, 6])
def test_ring_bcast_on_seven_ranks(cuda_world, root):
    """``bcast`` on the ring tier (one launch of the ring all-reduce, the
    root's value the only non-zero contribution) equals the root's value
    on every rank of a 7-rank world."""
    world = cuda_world(7)
    xs = _ring_inputs(7, (16, 130), torch.float32, seed=root)
    before = _build.LAUNCHES["ring_all_reduce"]
    got = world.run(lambda c: st.bcast(xs[c.rank], c, root=root,
                                       backend="ring"))
    assert _build.LAUNCHES["ring_all_reduce"] == before + 1
    for g in got:
        assert torch.equal(g, xs[root])


@pytest.mark.parametrize("direction", [1, -1])
def test_neighbour_stream_on_seven_ranks(cuda_world, direction):
    from smi_tpu_torch.kernels import ring as kring

    xs = _ring_inputs(7, (16, 8192), torch.float32, seed=7 + direction)
    _check_ring(cuda_world(7),
                lambda x, c, probe=False: "ring_neighbour_stream" if probe
                else kring.neighbour_stream(x, c, direction=direction),
                lambda ys: kring.neighbour_stream_plain(ys, direction), xs)


@pytest.mark.parametrize("backend", ["xla", "ring"])
def test_shrunk_and_regrown_worlds_all_reduce_on_the_card(backend):
    """8 ranks lose rank 5: the survivors' world (7 ranks, epoch 1) and
    the regrown one (8 ranks, epoch 2) each all-reduce to the plain sum
    of their members' inputs, in the survivors' own run and inside the
    parent's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from smi_tpu_torch.kernels import ring as kring

    world = st.LocalWorld(8)
    xs = _ring_inputs(8, (4096,), torch.float32, seed=16)
    small = world.shrink({5})
    assert (small.size, small.epoch, small.parent_ranks) == (
        7, 1, (0, 1, 2, 3, 4, 6, 7))
    members = [xs[r] for r in small.parent_ranks]
    want = kring.ring_all_reduce_plain(members)
    got = small.run(lambda c: st.allreduce(members[c.rank], c,
                                           backend=backend))
    inside = world.run(lambda c: None if c.rank == 5 else st.allreduce(
        xs[c.rank], c.shrink({5}), backend=backend))
    for g, w, i in zip(got, want, [o for o in inside if o is not None]):
        if backend == "ring":
            assert torch.equal(g, w) and torch.equal(i, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-5)
            assert torch.equal(i, g)
    back = world.regrow({5}, {5})
    assert (back.size, back.epoch) == (8, 2)
    got = back.run(lambda c: st.allreduce(xs[c.rank], c, backend=backend))
    for g, w in zip(got, kring.ring_all_reduce_plain(xs)):
        if backend == "ring":
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-5)


# ------------------------------------------------ the fault-simulator tier --

#: family -> (the mirror's protocol, the ring-tier call under a deadline)
MIRROR_FAMILIES = {
    "bcast": ("all_reduce", lambda x, c, d: st.bcast(
        x, c, root=1, backend="ring", deadline=d)),
    "reduce": ("all_reduce", lambda x, c, d: st.reduce(
        x, c, backend="ring", deadline=d)),
    "allreduce": ("all_reduce", lambda x, c, d: st.allreduce(
        x, c, backend="ring", deadline=d)),
    "scatter": ("reduce_scatter", lambda x, c, d: st.scatter(
        x, c, backend="ring", deadline=d)),
    "gather": ("all_gather", lambda x, c, d: st.gather(
        x, c, backend="ring", deadline=d)),
    "transfer": ("neighbour_stream", lambda x, c, d: st.P2PChannel(
        comm=c, port=0, src=0, dst=1, count=64).transfer(
            x, backend="ring", deadline=d)),
    "stream": ("neighbour_stream", lambda x, c, d: st.P2PChannel(
        comm=c, port=0, src=0, dst=1, count=64).stream(
            x, backend="ring", deadline=d)),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("family", sorted(MIRROR_FAMILIES))
def test_an_expired_ring_deadline_carries_the_mirror_on_the_card(
        cuda_world, family, n):
    """Every rank of a CUDA world raises ``WatchdogTimeout`` holding the
    family's protocol mirror, and no ring kernel launches."""
    from smi_tpu_torch.parallel import faults
    from smi_tpu_torch.utils.watchdog import Deadline, WatchdogTimeout

    protocol, call = MIRROR_FAMILIES[family]
    world = cuda_world(n)
    xs = _ring_inputs(n, (64,), torch.float32, seed=n)
    before = {k: v for k, v in _build.LAUNCHES.items()
              if k.startswith("ring_")}

    def rank(c):
        with pytest.raises(WatchdogTimeout) as e:
            call(xs[c.rank], c, Deadline(0.0))
        return e.value

    for err in world.run(rank):
        assert err.state == faults.mirror_stall_dump(protocol, n)
        assert f"protocol mirror [{protocol}, n={n}]" in err.state_dump
    assert {k: v for k, v in _build.LAUNCHES.items()
            if k.startswith("ring_")} == before


@pytest.mark.parametrize("n,dead", [(3, 1), (4, 2), (4, 3)])
def test_survivors_of_a_simulated_crash_run_the_ring_kernels(n, dead):
    """The credit simulator's all-reduce with rank ``dead`` crash-stopped
    names it; ``recover_communicator`` shrinks a CUDA world from that
    error, and the survivors' all-reduce and neighbour stream equal their
    plain versions with the credits drained, each rank's result read back
    under ``run_with_deadline``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.parallel import credits, faults
    from smi_tpu_torch.utils.watchdog import run_with_deadline

    with pytest.raises(credits.DeadlockError) as e:
        credits.simulate_all_reduce(
            n, credits.Strategy(0),
            faults=faults.FaultPlan.single(faults.StalledRank(dead,
                                                              after=3)))
    world = st.LocalWorld(n)
    small, heirs = st.recover_communicator(world.comms[0], e.value)
    assert heirs == {dead: (dead + 1) % n}
    survivors = small.world
    assert dead not in survivors.parent_ranks
    m = survivors.size
    for kernel, xs, call, plain in (
            ("ring_all_reduce",
             _ring_inputs(m, (4096,), torch.float32, seed=n),
             kring.ring_all_reduce, kring.ring_all_reduce_plain),
            ("ring_neighbour_stream",
             _ring_inputs(m, (8, 512), torch.float32, seed=n + 1),
             kring.neighbour_stream, kring.neighbour_stream_plain)):
        def rank(c):
            y = call(xs[c.rank], c)
            return run_with_deadline(lambda: y.cpu(), 60.0)

        before = _build.LAUNCHES[kernel]
        got = survivors.run(rank)
        assert _build.LAUNCHES[kernel] == before + 1
        assert kring.drained(kring.last_record(survivors))
        for g, w in zip(got, plain(xs)):
            assert torch.equal(g, w.cpu())


def test_timed_feeds_one_sample_from_a_ring_all_reduce(cuda_world):
    """``timed(deadline_s=, sink=)`` around a 4-rank ring all-reduce on the
    card: one sample in the tuner, and the result its plain version's."""
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.tuning.online import OnlineTuner
    from smi_tpu_torch.utils.tracing import timed

    world = cuda_world(4)
    xs = _ring_inputs(4, (4096,), torch.float32, seed=35)
    tuner = OnlineTuner()
    got, secs = timed(
        lambda: world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c)),
        deadline_s=60.0, sink=tuner, op="all_reduce",
        payload_bytes=4 * 4096.0)
    assert tuner.samples_ingested == 1 and secs > 0
    for g, w in zip(got, kring.ring_all_reduce_plain(xs)):
        assert torch.equal(g, w)


# ------------------------------------ the analysis and observability tiers --


def test_sweep_stencil_times_one_candidate_on_the_card():
    """A narrow ``sweep_stencil`` on the card (one pipelined candidate
    and the synchronous control, at a block the kernel admits): each is
    timed by its launches, the entry is keyed to the card, and the
    winner's one pass equals its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from smi_tpu_torch.kernels import stencil_pipeline as kpipe
    from smi_tpu_torch.tuning.plan import normalize_device_kind
    from smi_tpu_torch.tuning.sweep import sweep_stencil

    h = w = 1024
    rows = []
    before = _build.LAUNCHES["stencil_pipeline"]
    cache = sweep_stencil(h, w, depths=(8,), stripes=(64,), runs=1,
                          record=rows)
    timed_rows = [r for r in rows if r[1] is not None]
    assert [r[0] for r in timed_rows] == [r[0] for r in rows]
    # a warm-up and one timed pass a candidate, one launch each
    assert _build.LAUNCHES["stencil_pipeline"] - before == 2 * len(rows)
    (sig, entry), = cache.entries.items()
    dk = normalize_device_kind(torch.cuda.get_device_name())
    assert sig == f"stencil_pipeline|{h}|float32|{dk}|chip"
    assert entry.provenance == f"sweep:stencil:{h}x{w}:float32"
    assert entry.cost_us == min(r[1] for r in timed_rows) > 0
    k = entry.knobs
    x = torch.from_numpy(_grid(h, w)).cuda()
    comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                device="cuda")
    got = kpipe.make_pipeline_stencil_fn(
        comm, k["depth"], h, w, depth=k["depth"], stripe=k["stripe"],
        compute_dtype=k["compute_dtype"], buffering=k["buffering"])(x)
    want = kpipe.pipeline_sweeps_plain(kpipe._extend(x, k["depth"]), 0, 0,
                                       h, w, k["depth"], k["compute_dtype"])
    if k["compute_dtype"] == "float32":
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 0.05


def test_timed_feeds_one_sample_sink_cell_from_a_ring_all_reduce(cuda_world):
    """``timed(sink=SampleSink())`` around a ring all-reduce on the card
    records one cell in the sink, and the result is its plain
    version's, credits drained."""
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.obs.metrics import SampleSink
    from smi_tpu_torch.utils.tracing import timed

    world = cuda_world(8)
    xs = _ring_inputs(8, (4096,), torch.float32, seed=36)
    sink = SampleSink()
    got, secs = timed(
        lambda: world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c)),
        sink=sink, op="all_reduce", payload_bytes=4 * 4096.0)
    (entry,) = sink.entries()
    assert len(sink) == 1 and entry["knobs"]["op"] == "all_reduce"
    assert entry["knobs"]["payload_bucket_bytes"] == 4 * 4096
    assert entry["cost_us"] == pytest.approx(secs * 1e6, abs=1e-3)
    assert kring.drained(kring.last_record(world))
    for g, w in zip(got, kring.ring_all_reduce_plain(xs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [2, 8])
def test_an_expired_ring_deadline_carries_the_recorder_tail_on_the_card(
        cuda_world, n):
    """``Deadline(0.0, recorder=FlightRecorder())`` on the ring
    all-reduce: every rank's ``WatchdogTimeout`` carries its recorder's
    tail, on the error and in the structured state beside the protocol
    mirror, and no ring kernel launches."""
    from smi_tpu_torch.obs.events import FlightRecorder
    from smi_tpu_torch.parallel import credits
    from smi_tpu_torch.utils.watchdog import Deadline, WatchdogTimeout

    world = cuda_world(n)
    xs = _ring_inputs(n, (64,), torch.float32, seed=n)
    recorders = [FlightRecorder() for _ in range(n)]
    for r, rec in enumerate(recorders):
        credits.simulate_all_reduce(n, credits.Strategy(r), recorder=rec)
    before = {k: v for k, v in _build.LAUNCHES.items()
              if k.startswith("ring_")}

    def rank(c):
        with pytest.raises(WatchdogTimeout) as e:
            st.allreduce(xs[c.rank], c, backend="ring",
                         deadline=Deadline(0.0, recorder=recorders[c.rank]))
        return e.value

    for r, err in enumerate(world.run(rank)):
        tail = recorders[r].tail()
        assert tail["events"] and err.recorder_tail == tail
        assert err.state["flight_recorder"] == tail
        assert "protocol mirror [all_reduce" in err.state_dump
    assert {k: v for k, v in _build.LAUNCHES.items()
            if k.startswith("ring_")} == before


def _kv_closed_form(n, requests, kv_chunks, gen_len):
    """``traced_kv_dataflow``'s tokens in float64: ``chip_smoke.py``'s
    ``kv_closed_form``."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.kv_closed_form(n, requests, kv_chunks, gen_len)


@pytest.mark.parametrize("requests,kv_chunks,gen_len,rtol", [
    (2, 8, 3, 0.0),            # the reference's shape: exact
    (1 << 16, 8, 4, 1e-5),     # wide: the f32 sums round past 2^24
])
def test_traced_kv_dataflow_and_its_ring_fold_on_the_card(
        cuda_world, requests, kv_chunks, gen_len, rtol):
    """``traced_kv_dataflow`` on an 8-rank world of the card on both
    tiers: every rank's tokens within ``rtol`` of the float64 closed
    form; the step-0 row sums folded through the ring all-reduce equal
    to its plain version, credits drained; one ring launch a decode step
    and one for the fold."""
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.serving.inference import traced_kv_dataflow

    world = cuda_world(8)
    want = _kv_closed_form(8, requests, kv_chunks, gen_len)
    before = _build.LAUNCHES["ring_all_reduce"]
    for backend in ("xla", "ring"):
        outs = world.run(lambda c: traced_kv_dataflow(
            c, requests=requests, kv_chunks=kv_chunks, gen_len=gen_len,
            backend=backend))
        for tokens, record in outs:
            assert tokens.is_cuda and tokens.dtype == torch.float32
            assert tuple(tokens.shape) == (gen_len, requests)
            got = tokens.double().cpu().numpy()
            assert (np.abs(got - want) / want).max() <= rtol
            assert len(record.splitlines()) == gen_len
    prompts = torch.arange(requests * kv_chunks, dtype=torch.float32,
                           device="cuda").reshape(requests, kv_chunks)
    rows = [(prompts * float(r + 1)).sum(-1) for r in range(8)]
    got = world.run(lambda c: st.allreduce(rows[c.rank], c, backend="ring"))
    assert kring.drained(kring.last_record(world))
    for g, w in zip(got, kring.ring_all_reduce_plain(rows)):
        assert torch.equal(g, w)
    assert _build.LAUNCHES["ring_all_reduce"] - before == gen_len + 1


# ---------------------------------------------------------------------------
# The command line's tiers on the card
# ---------------------------------------------------------------------------


def test_aot_surface_fits_and_the_runtime_agrees():
    """``aot.check_surface`` on the card: every source builds for
    sm_90a, every launch of the JAX surface's cases fits, and each ring
    kernel's blocks an SM from the ptxas figures equal the runtime's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the occupancy is asked of it")
    from smi_tpu_torch.parallel import aot

    reports = aot.check_surface("v5e:2x4", runtime=True)
    ring = [l for r in reports.values() for l in r["launches"]
            if l["cooperative"]]
    assert ring and all(
        l["runtime_blocks_per_sm"] == l["blocks_per_sm"] for l in ring)
    assert set(reports) == {n for n, _ in aot.surface_cases("v5e:2x4")}


@pytest.mark.parametrize("count", [96, 4096])
def test_cli_app_on_both_tiers_of_an_8_rank_world(cuda_world, tmp_path,
                                                  count):
    """The CLI-generated device module's transfer -> reduce(max) ->
    bcast on 8 rank threads of the card: the ring tier launches the
    stream once and the all-reduce twice, and equals the default tier
    and max(x, 0) on every rank."""
    import importlib.util
    import os

    import smi_tpu_torch.__main__ as cli

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    meta = tmp_path / "app.json"
    meta.write_text(open(os.path.join(data, "cli-program.json")).read())
    assert cli.main(["device", str(tmp_path / "appdev.py"), str(meta)]) == 0
    spec = importlib.util.spec_from_file_location("gpu_appdev",
                                                  tmp_path / "appdev.py")
    dev = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dev)
    world = cuda_world(8)
    x = torch.randn(count, generator=torch.Generator().manual_seed(count))
    outs = {}
    for backend in ("xla", "ring"):
        @st.smi_kernel(world, in_specs=None, out_specs="smi",
                       program=dev.PROGRAM, backend=backend)
        def app(ctx, v):
            ch = dev.SMI_Open_send_channel_0_float(ctx, src=0, dst=1,
                                                   count=v.shape[0])
            got = dev.SMI_Push_0_float(ctx, ch, v)
            r = dev.SMI_Reduce_1_int(ctx, got, root=0)
            return dev.SMI_Bcast_2_int(ctx, r, root=0)[None]

        _build.reset_launches()
        outs[backend] = app(x)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert launched == {"ring_neighbour_stream": 1, "ring_all_reduce": 2}
    assert torch.equal(outs["ring"], outs["xla"])
    assert torch.equal(outs["ring"].cpu(),
                       x.clamp(min=0).expand(8, -1))


def test_program_report_counts_the_ring_launches(cuda_world):
    from smi_tpu_torch.ops.operations import Broadcast, Pop, Push, Reduce
    from smi_tpu_torch.ops.program import Program
    from smi_tpu_torch.utils.report import format_report, program_report

    program = Program([Push(port=0, dtype="float", buffer_size=17),
                       Pop(port=0, dtype="float", buffer_size=17),
                       Reduce(port=1, dtype="int", op="max"),
                       Broadcast(port=2, dtype="int")])
    report = program_report(program, cuda_world(8), count=4096)
    kernels = [e["kernels"] for e in report["operations"]]
    assert kernels == [{"ring_neighbour_stream": 1},
                       {"ring_all_reduce": 1}, {"ring_all_reduce": 1}]
    for e in report["operations"]:
        (figs,) = e["figures"].values()
        assert figs["registers"] is not None and figs["registers"] <= 64
    assert "hbm_pred_us" in format_report(report)
