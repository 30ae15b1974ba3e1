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


def _bwd_args(dev, dtype, h, h_kv, s, q_off, k_off, causal, window):
    """One block's backward operands: the statistics of a fused forward
    over keys ``[0, q_off + s)`` and a random dout; the block's K/V are
    those keys at ``k_off``, or fresh ones past them (a future block)."""
    d = 128
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,h_kv,s,q_off,k_off,causal,window", [
    (4, 4, 96, 0, 0, True, None),      # the diagonal, ragged tiles
    (4, 2, 64, 128, 64, True, None),   # a past block, GQA 2:1
    (4, 1, 96, 96, 48, True, 40),      # the window's edge, GQA 4:1
    (2, 2, 80, 0, 0, False, None),     # no mask
])
def test_flash_backward_kernels_equal_their_plain_versions(
        cuda_sp, dtype, h, h_kv, s, q_off, k_off, causal, window):
    """dq and (dk, dv) against the plain versions: within 2e-5 in f32,
    by the worst row's relative error, 1e-2, in bf16; one launch each."""
    args = _bwd_args(cuda_sp.device, dtype, h, h_kv, s, q_off, k_off,
                     causal, window)
    before = dict(_build.LAUNCHES)
    got = (kflash.flash_block_backward_dq(*args, window=window),
           *kflash.flash_block_backward_dkdv(*args, window=window))
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        assert _build.LAUNCHES[name] == before[name] + 1
    want = (kflash.flash_block_backward_dq_plain(*args, window=window),
            *kflash.flash_block_backward_dkdv_plain(*args, window=window))
    assert got[1].shape == (h_kv, s, 128)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        else:
            assert _worst_row_above_floor(a, b) <= 1e-2, name


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


# ------------------------------------------------ stencil pipeline --


@pytest.mark.parametrize("buffering", [1, 3])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,depth,stripe,at,grid", [
    (24, 128, 8, None, (0, 0), (24, 128)),           # one window
    (72, 384, 16, 24, (8, 128), (200, 1024)),        # a ragged band
    (4096, 1024, 8, None, (0, 0), (4096, 1024)),     # several windows a block
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
