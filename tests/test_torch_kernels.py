"""smi_tpu_torch's kernel modules on the CPU: the plain versions beside
each CUDA kernel, the wrappers' checks, the planner, and the loader.

On a CPU tensor ``fused_sweep`` and ``temporal_sweeps`` run their plain
PyTorch versions, so the arithmetic every kernel is held to on the card
is held here to the JAX package's Pallas kernels in interpret mode, on
the shapes of ``tests/test_kernels.py``. Multi-rank grids are emulated in
one process: each rank's block and halo slabs are cut from the
zero-padded global grid, which is exactly what the exchange delivers
(``test_torch_halo.py`` checks that under gloo). The bar is
``np.array_equal``.

The kernels themselves run only on the card, where ``chip_smoke.py``
holds each against its plain version.
"""

import contextlib
import importlib.util
import math
import re
import shutil
import sys
import threading
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.kernels import stencil as jstencil
from smi_tpu.kernels import stencil_temporal as jtemporal
from smi_tpu.models import stencil
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import stencil as kstencil
from smi_tpu_torch.kernels import stencil_temporal as ktemporal


def _grid(h, w):
    g = stencil.initial_grid(h, w)
    g[:, -1] = 2.0
    g[h // 2, :] = 0.5
    return g


def _blocks(g, px, py, depth):
    """Per rank: (block, top, bottom, left, right, row0, col0) cut from
    the zero-padded global grid, with corner-complete top/bottom slabs."""
    gh, gw = g.shape
    h, w, d = gh // px, gw // py, depth
    gp = np.pad(g, d)
    t = torch.from_numpy
    for rx in range(px):
        for cy in range(py):
            r0, c0 = rx * h, cy * w
            yield (
                t(np.ascontiguousarray(g[r0:r0 + h, c0:c0 + w])),
                t(np.ascontiguousarray(gp[r0:r0 + d, c0:c0 + w + 2 * d])),
                t(np.ascontiguousarray(
                    gp[r0 + h + d:r0 + h + 2 * d, c0:c0 + w + 2 * d])),
                t(np.ascontiguousarray(gp[r0 + d:r0 + d + h, c0:c0 + d])),
                t(np.ascontiguousarray(
                    gp[r0 + d:r0 + d + h, c0 + w + d:c0 + w + 2 * d])),
                r0, c0,
            )


def _fused_sweep_emulated(g, px, py):
    gh, gw = g.shape
    h, w = gh // px, gw // py
    out = np.empty_like(g)
    for block, top, bottom, left, right, r0, c0 in _blocks(g, px, py, 1):
        new = st.fused_sweep(block, top[:, 1:-1].contiguous(),
                             bottom[:, 1:-1].contiguous(), left, right,
                             r0, c0, gh, gw)
        out[r0:r0 + h, c0:c0 + w] = new.numpy()
    return out


def _temporal_pass_emulated(g, px, py, depth):
    gh, gw = g.shape
    h, w = gh // px, gw // py
    out = np.empty_like(g)
    for block, top, bottom, left, right, r0, c0 in _blocks(g, px, py,
                                                           depth):
        new = st.temporal_sweeps(block, top, bottom, left, right, r0, c0,
                                 gh, gw, depth)
        out[r0:r0 + h, c0:c0 + w] = new.numpy()
    return out


def _temporal_emulated(g, px, py, iters, depth):
    full, rem = divmod(iters, depth)
    for _ in range(full):
        g = _temporal_pass_emulated(g, px, py, depth)
    for _ in range(rem):
        g = _fused_sweep_emulated(g, px, py)
    return g


def _jax_comm(devices, px, py):
    return smi.make_communicator(shape=(px, py), axis_names=("sx", "sy"),
                                 devices=devices[:px * py])


# ------------------------------------------------- single-sweep kernel --


@pytest.mark.parametrize("px,py,h,w,iters", [
    (2, 2, 32, 256, 4),    # tests/test_kernels.py:19-28
    (1, 1, 16, 128, 3),    # tests/test_kernels.py:31-39
    (2, 4, 64, 1024, 5),
])
def test_fused_sweep_plain_matches_jax_interpret(eight_devices, px, py, h,
                                                 w, iters):
    g = _grid(h, w)
    got = g
    for _ in range(iters):
        got = _fused_sweep_emulated(got, px, py)
    want = jstencil.make_fused_stencil_fn(
        _jax_comm(eight_devices, px, py), iters, h, w, interpret=True,
    )(jnp.asarray(g))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, stencil.reference_stencil(g, iters))


def test_make_fused_stencil_fn_one_rank(eight_devices):
    comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                device="cpu")
    g = _grid(16, 128)
    got = st.make_fused_stencil_fn(comm, 3, 16, 128)(
        st.block_from_numpy(g, comm))
    want = jstencil.make_fused_stencil_fn(
        _jax_comm(eight_devices, 1, 1), 3, 16, 128, interpret=True,
    )(jnp.asarray(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_sweep_plain_holds_the_boundary_at_an_offset():
    """A block at the bottom-right of a larger grid, random halos: the
    global edge holds, every other cell is the four-neighbour average."""
    rng = np.random.default_rng(11)
    h, w, gh, gw, r0, c0 = 6, 9, 12, 18, 6, 9
    block, top, bottom = (rng.random(s, dtype=np.float32)
                          for s in ((h, w), (1, w), (1, w)))
    left, right = (rng.random((h, 1), dtype=np.float32) for _ in range(2))
    got = st.fused_sweep(*map(torch.from_numpy,
                              (block, top, bottom, left, right)),
                         r0, c0, gh, gw).numpy()
    padded = np.zeros((h + 2, w + 2), np.float32)
    padded[1:-1, 1:-1] = block
    padded[0, 1:-1], padded[-1, 1:-1] = top[0], bottom[0]
    padded[1:-1, 0], padded[1:-1, -1] = left[:, 0], right[:, 0]
    want = 0.25 * (padded[:-2, 1:-1] + padded[2:, 1:-1]
                   + padded[1:-1, :-2] + padded[1:-1, 2:])
    want[-1, :] = block[-1, :]   # global row gh-1
    want[:, -1] = block[:, -1]   # global col gw-1
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- k-sweep kernel --


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("px,py,h,w,iters", [
    # tests/test_kernels.py:136-161 (full-width dispatch in JAX)
    (1, 1, 32, 256, 8),
    (2, 2, 64, 512, 16),
    (2, 4, 64, 1024, 20),
    (1, 2, 16, 256, 8),
    (2, 2, 64, 512, 32),
])
def test_temporal_plain_matches_jax_interpret(eight_devices, px, py, h, w,
                                              iters, depth):
    g = _grid(h, w)
    got = _temporal_emulated(g, px, py, iters, depth)
    want = jtemporal.make_temporal_stencil_fn(
        _jax_comm(eight_devices, px, py), iters, h, w, depth=depth,
        interpret=True,
    )(jnp.asarray(g))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, stencil.reference_stencil(g, iters))


@pytest.mark.parametrize("px,py,h,w,t,wc,depth", [
    # tests/test_kernels.py:221-254 (column-tiled dispatch in JAX)
    (1, 1, 32, 512, 16, 256, 8),
    (1, 2, 16, 256, 16, 128, 8),
    (1, 1, 64, 512, 64, 768, 8),
    (2, 2, 64, 512, 16, 256, 8),
    (1, 1, 32, 512, 16, 256, 16),
    (2, 2, 64, 512, 16, 256, 16),
])
def test_temporal_plain_matches_jax_tiled_interpret(
        eight_devices, monkeypatch, px, py, h, w, t, wc, depth):
    monkeypatch.setattr(jtemporal, "_plan", lambda *_a: ("tiled", (t, wc)))
    g = _grid(h, w)
    got = _temporal_emulated(g, px, py, 16, depth)
    want = jtemporal.make_temporal_stencil_fn(
        _jax_comm(eight_devices, px, py), 16, h, w, depth=depth,
        interpret=True,
    )(jnp.asarray(g))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("h,w,iters,depth", [(32, 256, 19, 8),
                                             (64, 512, 35, 16)])
def test_make_temporal_stencil_fn_one_rank(eight_devices, h, w, iters,
                                           depth):
    """The port's driver at 1x1, remainder sweeps included."""
    comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                device="cpu")
    g = _grid(h, w)
    got = st.make_temporal_stencil_fn(comm, iters, h, w, depth=depth)(
        st.block_from_numpy(g, comm))
    want = jtemporal.make_temporal_stencil_fn(
        _jax_comm(eight_devices, 1, 1), iters, h, w, depth=depth,
        interpret=True,
    )(jnp.asarray(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("depth", [1, 3, 8])
def test_temporal_plain_equals_serial_sweeps_on_random_data(depth):
    """k sweeps over a block on the global edge, at an offset, with
    random data in it and its halos, equal k serial sweeps of the grid."""
    rng = np.random.default_rng(depth)
    gh, gw, h, w, r0, c0, k = 40, 48, 12, 16, 20, 32, depth
    g = rng.random((gh, gw), dtype=np.float32)
    sub = np.pad(g, k)[r0:r0 + h + 2 * k, c0:c0 + w + 2 * k]
    t = torch.from_numpy
    block = t(np.ascontiguousarray(sub[k:k + h, k:k + w]))
    top, bottom = t(sub[:k].copy()), t(sub[k + h:].copy())
    left = t(np.ascontiguousarray(sub[k:k + h, :k]))
    right = t(np.ascontiguousarray(sub[k:k + h, k + w:]))
    got = st.temporal_sweeps(block, top, bottom, left, right, r0, c0, gh, gw,
                             k).numpy()
    want = stencil.reference_stencil(g, k)[r0:r0 + h, c0:c0 + w]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- plan and gating --


def test_plan_fits_shared_memory():
    assert ktemporal._plan(8192, 8192, 16) == (191, 456)
    assert ktemporal._plan(4096, 2048, 16) == (96, 344)
    # the input ring (4 rows of the 512-column window), the edge slabs
    # (2 parities x 2 groups x 6 slabs x 2 sides x 8 levels) and the
    # hand-off rows (2 parities x 1 seam x 512 columns)
    assert ktemporal.window_bytes(456, 16) == 4 * (
        4 * 512 + 2 * 2 * 6 * 2 * 8 + 2 * 1 * 512)
    assert ktemporal._plan(16, 40, 8) == (16, 40)   # cut to the block
    for k in (1, 8, 16, 32, 50):
        stripe, band = ktemporal._plan(8192, 8192, k)
        assert ktemporal.window_bytes(band, k) <= _build.SMEM_BYTES_LIMIT
    assert ktemporal._plan(8192, 8192, 200) is None


@pytest.mark.parametrize("depth", [8, 16, 32])
def test_the_temporal_block_follows_its_level_groups(depth):
    """At 8192^2 a block is its form's level groups, each covering the
    window; its shared memory holds each group's edge slabs and the
    hand-off rows between groups; an SM holds at least 16 warps."""
    n = 8192
    stripe, band = ktemporal._plan(n, n, depth)
    form = ktemporal.form(depth)
    group = -(-(band + 2 * depth) // (32 * form.columns)) * 32
    width = group * form.columns
    assert ktemporal.threads(band, depth) == form.groups * group
    assert ktemporal.threads(band, depth) <= form.max_threads
    assert ktemporal.window_width(band, depth) == width
    levels = depth // form.groups
    edges = 2 * form.groups * (group // 32 + 2) * 2 * levels
    hand = 2 * (form.groups - 1) * width
    assert ktemporal.window_bytes(band, depth) == 4 * (
        ktemporal.PREFETCH_ROWS * width + edges + hand)
    per_sm = ktemporal.blocks_per_sm(band, depth)
    assert per_sm >= form.min_blocks
    assert per_sm * ktemporal.threads(band, depth) // 32 >= 16
    if depth == 16:
        assert (form.groups, form.columns) == (2, 4)
        assert (per_sm, ktemporal.threads(band, depth)) == (2, 256)


def test_the_forms_are_the_kernels():
    """The plan's forms, input ring and register counts are the C
    source's (``form`` and ``kPrefetch`` in ``stencil_temporal.cu``)."""
    source = (_build.CSRC / "stencil_temporal.cu").read_text()
    body = source[source.index("constexpr Form form(int K)"):]
    body = body[:body.index("\n}\n")]
    found = {int(k): ktemporal.Form(*map(int, f.split(",")))
             for k, f in re.findall(r"K == (\d+)\s*\? Form\{([^}]*)\}", body)}
    assert found == ktemporal.FORMS
    generic = re.search(r":\s*Form\{([^}]*)\};", body).group(1)
    assert ktemporal.Form(*map(int, generic.split(","))) == ktemporal.GENERIC
    assert re.search(r"constexpr int kPrefetch = (\d+);", source).group(1) \
        == str(ktemporal.PREFETCH_ROWS)
    assert set(ktemporal.REGISTERS) == set(ktemporal.FORMS) | {None}
    for depth, form in ktemporal.FORMS.items():
        # the launch bound's register cap holds each instance's count
        cap = 65_536 // (form.max_threads * form.min_blocks)
        assert ktemporal.REGISTERS[depth] <= min(cap, 255)
        assert depth % (4 * form.groups) == 0   # edges move 4 levels


#: window columns a band sweeps per output column (the k-column aprons, a
#: warp of columns at a time) and the whole swept area per output cell
#: (with each stripe's 2k-row apron), at 8192^2
SWEPT = {8: (1.07, 1.2), 16: (1.13, 1.41), 32: (1.19, 1.79)}


@pytest.mark.parametrize("depth", sorted(SWEPT))
def test_the_plan_sweeps_a_small_apron(depth):
    n = 8192
    stripe, band = ktemporal._plan(n, n, depth)
    width = ktemporal.window_width(band, depth)
    columns, area = SWEPT[depth]
    assert -(-n // band) * width / n <= columns
    assert ktemporal.swept_ratio(n, n, depth) <= area
    assert band + 2 * depth <= width <= ktemporal.MAX_WIDTH
    assert stripe >= ktemporal.MIN_STRIPE_DEPTHS * depth


@pytest.mark.parametrize("shape", [(8192, 8192), (4096, 2048)])
@pytest.mark.parametrize("depth", [8, 16, 32])
def test_the_main_shapes_fill_the_card(shape, depth):
    """Rows 1 and 2 of PERF.md (and the other register depths) launch
    blocks in waves of the H100 (SMs x blocks an SM at once) whose last
    wave is at least 85 % full: no short tail of blocks."""
    h, w = shape
    stripe, band = ktemporal._plan(h, w, depth)
    blocks = -(-h // stripe) * -(-w // band)
    waves = blocks / (_build.SMS * ktemporal.blocks_per_sm(band, depth))
    assert waves - math.ceil(waves) + 1 >= 0.85


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("depth", [1, 2, 7, 8, 16, 24, 32, 50, 81, 82])
def test_the_supported_set_is_no_narrower_than_the_first_forms(depth):
    """Every block the first, shared-memory kernel took (its plan is
    ``chip_smoke.earlier_temporal_plan``) the wavefront still takes."""
    first = _chip_smoke().earlier_temporal_plan
    for h in (1, 7, 16, 40, 63, 100, 333, 4096, 8192):
        for w in (1, 8, 40, 90, 129, 1000, 2048, 8192):
            took = (1 <= depth <= min(h, w)
                    and first(h, w, depth) is not None)
            if took:
                assert ktemporal._plan(h, w, depth) is not None, (h, w)


def test_earlier_stencil_sources_take_their_own_plans(monkeypatch):
    """``chip_smoke.py --earlier .../stencil_temporal.cu`` (or
    ``stencil_pipeline.cu``) times the parent's kernel, whose C entry
    reads its own plan: while it is swapped in, the wrappers ask for that
    plan and its library; after, the tree's again."""
    from smi_tpu_torch.kernels import stencil_pipeline as kpipe

    chip_smoke = _chip_smoke()
    for stem, module, tree_plan, first_plan, args in (
            ("stencil_temporal", ktemporal, (191, 456), (64, 64),
             (8192, 8192, 16)),
            ("stencil_pipeline", kpipe, (8, 456), (64, 96),
             (8192, 8192, 16))):
        tree_lib, earlier_lib = object(), object()
        monkeypatch.setitem(_build._libs, stem, tree_lib)
        source = object.__new__(chip_smoke.EarlierSource)
        source.stem, source.lib = stem, earlier_lib
        with source.swapped():
            assert _build._libs[stem] is earlier_lib
            assert module._plan(*args) == first_plan
        assert _build._libs[stem] is tree_lib
        assert module._plan(*args) == tree_plan


def test_depth_picker_and_gating():
    f32 = torch.float32
    assert st.pick_temporal_depth(8192, 8192, f32, 256) == 16
    assert st.pick_temporal_depth(4096, 2048, f32, 256) == 16
    assert st.pick_temporal_depth(8192, 8192, f32, 10) == 8
    assert st.pick_temporal_depth(8192, 8192, f32, 7) is None
    assert st.pick_temporal_depth(8192, 8192, torch.float64, 256) is None
    assert st.pick_temporal_depth(12, 256, f32, 256) == 8
    assert not st.temporal_supported(8, 256, f32, depth=16)
    assert not st.temporal_supported(512, 1024, f32, depth=0)
    assert st.temporal_supported(512, 1000, f32, depth=7)  # no lane rule


# ------------------------------------------------------------- wrappers --


def _sweep_args(h=4, w=6):
    z = torch.zeros
    return [z(h, w), z(1, w), z(1, w), z(h, 1), z(h, 1), 0, 0, h, w]


def _temporal_args(h=8, w=10, k=2):
    z = torch.zeros
    return [z(h, w), z(k, w + 2 * k), z(k, w + 2 * k), z(h, k), z(h, k),
            0, 0, h, w, k]


@pytest.mark.parametrize("wrapper,make", [
    (st.fused_sweep, _sweep_args), (st.temporal_sweeps, _temporal_args)])
def test_wrappers_check_their_operands(wrapper, make):
    args = make()
    args[0] = args[0].double()
    with pytest.raises(TypeError, match="float32"):
        wrapper(*args)
    args = make()
    args[2] = args[2][:, :-1].contiguous()
    with pytest.raises(ValueError, match="must have shape"):
        wrapper(*args)
    args = make()
    args[0] = args[0].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(*args)
    args = make()
    args[3] = args[3].to("meta")
    with pytest.raises(ValueError, match="is on meta"):
        wrapper(*args)
    args = make()
    args[:5] = [a.to("meta") for a in args[:5]]
    with pytest.raises(ValueError, match="no kernel for meta"):
        wrapper(*args)


@pytest.mark.parametrize("make_fn,iters", [
    (lambda comm, n: st.make_fused_stencil_fn(comm, n, 16, 40), 3),
    (lambda comm, n: st.make_temporal_stencil_fn(comm, n, 16, 40, depth=8),
     3),   # remainder sweeps only
    (lambda comm, n: st.make_temporal_stencil_fn(comm, n, 16, 40, depth=8),
     11),  # one k-sweep pass, then the remainder
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_drivers_refuse_a_non_f32_block(make_fn, iters, dtype):
    """The drivers never hand a block the kernels do not take to the
    plain sweep: a non-f32 block raises."""
    comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                device="cpu")
    block = st.block_from_numpy(_grid(16, 40), comm).to(dtype)
    with pytest.raises(TypeError, match="float32"):
        make_fn(comm, iters)(block)


def test_temporal_wrapper_refuses_an_unsupported_depth():
    with pytest.raises(ValueError, match="not supported"):
        st.temporal_sweeps(*_temporal_args(h=4, w=10, k=6))


def test_cpu_calls_launch_nothing():
    before = dict(_build.LAUNCHES)
    st.fused_sweep(*_sweep_args())
    st.temporal_sweeps(*_temporal_args())
    assert _build.LAUNCHES == before
    assert set(before) == {"stencil_sweep", "stencil_temporal",
                           "stencil_pipeline", "flash_fused", "flash_block",
                           "flash_bwd_dq", "flash_bwd_dkdv",
                           "flash_fused_192x128", "flash_block_192x128",
                           "flash_bwd_dq_192x128", "flash_bwd_dkdv_192x128",
                           "ring_neighbour_stream", "ring_all_gather",
                           "ring_all_reduce", "ring_reduce_scatter",
                           "ring_all_reduce_chunked", "roll_chain",
                           "attn_prologue", "attn_prologue_bwd",
                           "attn_epilogue", "attn_epilogue_bwd",
                           "residual_norm", "residual_norm_bwd"}


# --------------------------------------------------------------- loader --


def test_nvcc_command_targets_sm90a_without_fast_math(tmp_path):
    cmd = _build.nvcc_command("nvcc", tmp_path / "k.cu", tmp_path / "k.so")
    line = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in line
    assert "-fmad=false" in cmd and "-O3" in cmd and "-std=c++17" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd
    assert "fast_math" not in line and "fast-math" not in line


def test_only_the_flash_source_contracts_fma(tmp_path):
    """The stencil sources, the ring source (a reduction is held bit
    for bit), the attention glue and the residual junctions keep
    ``-fmad=false``; the flash sources' (forward and backward) bar is a
    tolerance, so they build with FMA."""
    for name in _build.SOURCES:
        cmd = _build.nvcc_command("nvcc", tmp_path / f"{name}.cu",
                                  tmp_path / "k.so")
        assert ("-fmad=false" in cmd) == (not name.startswith("flash_")), \
            name
        assert "-gencode" in cmd and "fast_math" not in " ".join(cmd)
    assert _build.SOURCES == ["attn_glue", "flash_bwd", "flash_fwd",
                              "residual_norm", "ring", "roll_chain",
                              "stencil_pipeline", "stencil_sweep",
                              "stencil_temporal"]


def test_launch_counts_add_up_across_threads():
    """Wrappers may launch from several threads at once (an emulated ring
    runs one thread per rank): every launch is counted."""
    threads, per_thread, name = 16, 2000, "flash_bwd_dq"
    before = _build.LAUNCHES[name]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            _build.count_launch(name) for _ in range(per_thread)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert _build.LAUNCHES[name] == before + threads * per_thread
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES[name] = before


def test_launch_checks_then_counts_on_the_given_stream(monkeypatch):
    """``_build.launch`` (a fake entry, device and stream patched in): a
    refused launch raises naming the kernel and counts nothing; an
    accepted one counts once; the device's current stream is passed
    unless a stream is named."""
    name, calls, status = "roll_chain", [], [0]
    entered = []

    def fake_entry(kernel):
        assert kernel == name
        return lambda *args: calls.append(args) or status[0]

    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(torch.cuda, "device", lambda d: (
        entered.append(d) or contextlib.nullcontext()))
    stream = types.SimpleNamespace(cuda_stream=7)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setitem(_build.LAUNCHES, name, 0)
    status[0] = 700
    with pytest.raises(RuntimeError, match=f"{name} .*cudaError 700"):
        _build.launch(name, "cuda:1", 1, 2)
    assert _build.LAUNCHES[name] == 0 and calls == [(1, 2, 7)]
    status[0] = 0
    _build.launch(name, "cuda:1", 3)
    assert _build.LAUNCHES[name] == 1 and calls[-1] == (3, 7)
    _build.launch(name, "cuda:1", 4, stream=99)
    assert _build.LAUNCHES[name] == 2 and calls[-1] == (4, 99)
    assert entered == ["cuda:1"] * 3


@pytest.mark.parametrize("source", sorted(_build.QUERIES))
def test_sources_declare_their_occupancy_queries(source):
    """Each occupancy query is exported by its source with the declared
    arguments, beside the kernels the source launches."""
    query = _build.QUERIES[source]
    assert query.source == source
    assert source in _build.SOURCES
    text = (_build.CSRC / f"{source}.cu").read_text()
    match = re.search(r'extern "C" int ' + query.symbol + r"\(([^)]*)\)",
                      text)
    assert match, f"{query.symbol} not exported by {source}.cu"
    assert len(match.group(1).split(",")) == len(query.argtypes)


def test_missing_nvcc_raises_and_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("stencil_sweep")
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))


def test_library_path_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    path = _build.library_path("stencil_sweep")
    assert path.parent == _build.BUILD_DIR
    assert path != _build.library_path("stencil_temporal")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("stencil_sweep") != path
    # and by the csrc/ headers a source includes: the wavefront sources
    # build anew when their shared header changes
    monkeypatch.undo()
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    header = csrc / "stencil_wavefront.cuh"
    assert _build.included_headers(csrc / "stencil_pipeline.cu") == [header]
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == {
        "stencil_pipeline", "stencil_temporal"}


def test_build_dir_is_ignored_by_git():
    root = Path(_build.__file__).resolve().parents[2]
    assert "build/torch_kernels/" in (root / ".gitignore").read_text()
    assert _build.BUILD_DIR == root / "build" / "torch_kernels"


#: sources with no TPU counterpart (the afmoe block's glue and residual
#: junctions: the JAX package has no afmoe block); every other source
#: names its TPU kernel
NO_TPU_KERNEL = {"attn_glue", "residual_norm"}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_sources_declare_the_bound_entry_points(name):
    source = (_build.CSRC / f"{_build.source_of(name)}.cu").read_text()
    _, symbol, argtypes = _build.SIGNATURES[name]
    match = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", source)
    assert match, f"{symbol} not exported by {_build.source_of(name)}.cu"
    assert len(match.group(1).split(",")) == len(argtypes)
    assert "return static_cast<int>(cudaGetLastError());" in source
    # the note names the TPU kernel it replaces (a source with none says
    # so and why it was added) and what bounds it
    head = source[:source.index("#include")]
    # (the roll-chain probe's TPU kernel lives in the JAX surface)
    if _build.source_of(name) in NO_TPU_KERNEL:
        assert re.search(r"Replaces no TPU kernel: \w", head)
    else:
        assert "Replaces" in head and re.search(
            r"smi_tpu/(kernels|benchmarks)/", head)
    assert "Bound on the H100" in head and "Design" in head
    assert "use_fast_math" not in source
