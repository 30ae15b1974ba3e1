"""smi_tpu_torch's stencil pipeline against the JAX package on the CPU.

The same seeded float32 grids (``tests/test_stencil_pipeline.py``'s
``_grid`` plus seeded noise) go through
``smi_tpu.kernels.stencil_pipeline.make_pipeline_stencil_fn`` in
interpret mode and through the port on CPU tensors, where the kernel
wrapper runs its plain version. The bar is ``np.array_equal`` in both
compute dtypes: f32 keeps the reference's operand order, and bf16 rounds
each neighbour to bf16 (round to nearest even) and keeps the centre and
the sum in f32, as the reference's ``_sweep_trapezoid_mixed`` does. The
bf16 cases also meet the reference's own contract: within
``BF16_PASS_ATOL`` of the serial reference per pass, and not equal to it.
A 2x2 grid runs under gloo (``tests/torch_gloo_worker.py``).

The kernel itself runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phases 17-19).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.kernels import stencil_pipeline as jpipe
from smi_tpu.models import stencil
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import stencil_pipeline as kpipe

# spawned children import the worker by module name through this path
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_gloo_worker  # noqa: E402

#: the reference's pinned bf16 contract (tests/test_stencil_pipeline.py)
BF16_PASS_ATOL = 0.05


def _grid(h, w, seed=0):
    g = stencil.initial_grid(h, w)
    g[:, -1] = 2.0
    g[h // 2, :] = 0.5
    noise = np.random.default_rng(seed).random((h, w), dtype=np.float32)
    return (g + np.float32(0.25) * noise).astype(np.float32)


def _jax(eight_devices, g, iters, depth, shape=(1, 1), **kw):
    comm = smi.make_communicator(
        shape=shape, axis_names=("sx", "sy"),
        devices=eight_devices[:shape[0] * shape[1]])
    h, w = g.shape
    return np.asarray(jpipe.make_pipeline_stencil_fn(
        comm, iters, h, w, depth=depth, interpret=True, **kw)(
        jnp.asarray(g)))


@pytest.fixture
def comm11():
    return st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                device="cpu")


def _port(comm, g, iters, depth, **kw):
    h, w = g.shape
    out = st.make_pipeline_stencil_fn(comm, iters, h, w, depth=depth, **kw)(
        st.block_from_numpy(g, comm))
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    return out.numpy()


# ------------------------------------------------------------ numerics --


@pytest.mark.parametrize("h,w,depth,stripe", [
    (24, 128, 8, None),    # tests/test_stencil_pipeline.py:64-69
    (40, 256, 8, 8),
    (72, 384, 16, 24),
    (24, 128, 16, None),
])
@pytest.mark.parametrize("buffering", [1, kpipe.PIPELINE_SLOTS])
def test_pipeline_f32_matches_jax_interpret(eight_devices, comm11, h, w,
                                            depth, stripe, buffering):
    g = _grid(h, w, seed=h + depth)
    got = _port(comm11, g, depth, depth, stripe=stripe, buffering=buffering)
    want = _jax(eight_devices, g, depth, depth, stripe=stripe,
                buffering=buffering)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stencil.reference_stencil(g, depth))


@pytest.mark.parametrize("iters", [16, 19])  # two passes; and a remainder
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pipeline_passes_and_remainder_match_jax(eight_devices, comm11,
                                                  iters, compute_dtype):
    """iterations > depth chains passes through the two extended
    buffers; 19 sweeps at depth 8 leave 3 for the single-sweep tier."""
    g = _grid(64, 256, seed=iters)
    got = _port(comm11, g, iters, 8, compute_dtype=compute_dtype)
    want = _jax(eight_devices, g, iters, 8, compute_dtype=compute_dtype)
    np.testing.assert_array_equal(got, want)
    ref = stencil.reference_stencil(g, iters)
    if compute_dtype == "float32":
        np.testing.assert_array_equal(got, ref)
    else:
        assert not np.array_equal(got, ref)


@pytest.mark.parametrize("h,w,depth,stripe", [(32, 128, 8, 16),
                                              (72, 384, 16, 24)])
def test_pipeline_bf16_matches_jax_and_its_contract(eight_devices, comm11,
                                                    h, w, depth, stripe):
    g = _grid(h, w, seed=depth)
    got = _port(comm11, g, depth, depth, stripe=stripe,
                compute_dtype="bfloat16")
    want = _jax(eight_devices, g, depth, depth, stripe=stripe,
                compute_dtype="bfloat16")
    np.testing.assert_array_equal(got, want)
    ref = stencil.reference_stencil(g, depth)
    assert np.allclose(got, ref, atol=BF16_PASS_ATOL)
    assert not np.array_equal(got, ref)


def test_pipeline_sweeps_plain_is_k_serial_sweeps_at_an_offset():
    """A block on the bottom-right global edge with random data in it and
    its halos: k sweeps of the extended state equal k serial sweeps of
    the whole grid, and only ``out``'s interior is written."""
    rng = np.random.default_rng(5)
    gh, gw, h, w, r0, c0, k = 48, 384, 24, 128, 24, 256, 8
    g = rng.random((gh, gw), dtype=np.float32)
    ext = torch.from_numpy(np.ascontiguousarray(
        np.pad(g, k)[r0:r0 + h + 2 * k, c0:c0 + w + 2 * k]))
    out = torch.full_like(ext, float("nan"))
    got = st.pipeline_sweeps(ext, r0, c0, gh, gw, k, out=out)
    want = stencil.reference_stencil(g, k)[r0:r0 + h, c0:c0 + w]
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.data_ptr() == out[k:, k:].data_ptr()
    assert torch.isnan(out[:k]).all() and torch.isnan(out[:, w + k:]).all()


def test_pipeline_pass_leaves_the_block_alone(comm11):
    g = _grid(32, 128)
    block = st.block_from_numpy(g, comm11)
    got = st.pipeline_pass(block, comm11, 32, 128, depth=8)
    np.testing.assert_array_equal(block.numpy(), g)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(),
                                  stencil.reference_stencil(g, 8))


def test_gloo_2x2_grid_matches_jax_and_reference(eight_devices):
    """tests/test_stencil_pipeline.py:88-96 on a 2x2 gloo group: the halo
    refresh into the extended border, rank by rank, in f32 and bf16."""
    g = _grid(64, 256, seed=2)
    out = torch_gloo_worker.run_group(
        torch_gloo_worker.run_pipeline, 4, ((2, 2), g, 8, 8))[0]
    for cd in kpipe.COMPUTE_DTYPES:
        want = _jax(eight_devices, g, 8, 8, shape=(2, 2), compute_dtype=cd)
        np.testing.assert_array_equal(out[cd], want, err_msg=cd)
    np.testing.assert_array_equal(out["float32"],
                                  stencil.reference_stencil(g, 8))


# ------------------------------------------------------ plan and gating --


@pytest.mark.parametrize("h,w,depth,stripe,compute_dtype", [
    # every shape of tests/test_stencil_pipeline.py:64-128
    (24, 128, 8, None, "float32"), (40, 256, 8, 8, "float32"),
    (72, 384, 16, 24, "float32"), (24, 128, 16, None, "float32"),
    (32, 128, 8, None, "float32"),     # a rank's block of the 2x2 grid
    (64, 256, 8, None, "float32"), (32, 128, 8, 16, "bfloat16"),
    # the main path's blocks
    (8192, 8192, 8, None, "float32"), (8192, 8192, 16, None, "float32"),
    (8192, 8192, 32, None, "bfloat16"), (4096, 2048, 8, None, "float32"),
    (4096, 2048, 16, None, "bfloat16"), (4096, 2048, 32, None, "float32"),
])
@pytest.mark.parametrize("buffering", [1, kpipe.PIPELINE_SLOTS])
def test_supported_shapes(h, w, depth, stripe, compute_dtype, buffering):
    assert st.pipeline_supported(h, w, torch.float32, depth, stripe=stripe,
                                 compute_dtype=compute_dtype,
                                 buffering=buffering)
    t, band = kpipe._plan(h, w, depth, buffering, stripe)
    assert h % t == 0 and t % 8 == 0 and t <= kpipe.TMA_BOX_MAX
    # the C entry's rules: the window within the launch bound, equal
    # store boxes of whole 16-byte rows, each 128-byte aligned
    assert kpipe.window_threads(band, depth) <= kpipe.MAX_THREADS
    boxes = -(-band // kpipe.TMA_BOX_MAX)
    assert band % boxes == 0 and band // boxes % 4 == 0
    assert t * (band // boxes) % 32 == 0
    assert kpipe.MIN_BAND <= band <= max(w, kpipe.MIN_BAND)
    assert (kpipe.pipeline_smem_bytes(t, band, depth, buffering)
            <= _build.SMEM_BYTES_LIMIT)


@pytest.mark.parametrize("depth,band", [(8, 488), (16, 456), (32, 432)])
def test_the_pipeline_keeps_one_level_group(depth, band):
    """The pipeline kernel runs the wavefront's one-group form (every
    level in each thread, as before the temporal kernel's level split):
    its 8192^2 plan, block and shared memory are unchanged."""
    assert kpipe._plan(8192, 8192, depth) == (8, band)
    assert kpipe._plan(8192, 8192, depth, 1) == (8, band)
    threads = kpipe.window_threads(band, depth)
    assert threads == -(-(band + 2 * depth)
                        // (32 * kpipe.columns(depth))) * 32
    assert threads <= kpipe.MAX_THREADS == 256
    assert kpipe.pipeline_smem_bytes(8, band, depth) == {
        8: 86528, 16: 85248, 32: 87296}[depth]


def test_picker_names_its_choice_and_every_refusal():
    stripe, note = st.pick_pipeline_stripe_explained(8192, 8192, 16)
    assert stripe == 8 and "band 456" in note and "3 slots" in note
    assert kpipe._plan(8192, 8192, 16) == (8, 456)
    assert kpipe._pick_pipeline_stripe(8192, 8192, 16) == 8
    for args, words in (((8192, 8192, 7), "multiple of 8"),
                        ((8192, 8192, 0), "multiple of 8"),
                        ((64, 100, 8), "w=100"),
                        ((8192, 8192, 88), "shared memory"),
                        ((20, 128, 8), "divides h=20")):
        none, note = st.pick_pipeline_stripe_explained(*args)
        assert none is None and words in note, (args, note)
        assert not st.pipeline_supported(*args[:2], torch.float32, args[2])
    # three 8-row slots of the 512-column window, two staging buffers of
    # the 456-column band, the mbarriers, the edge slabs (2 parities x 6
    # slabs x 2 sides x 16 levels), the bf16 keep, the alignment slack
    assert kpipe.pipeline_smem_bytes(8, 456, 16) == (
        4 * 3 * 8 * 512 + 4 * 2 * 8 * 456 + 128 + 4 * 2 * 6 * 2 * 16
        + 4 * (2 * 512 + 2 * 128) + 128)


#: window columns a band sweeps per output column at 8192^2, and the
#: whole swept area per output cell with a 2k-row apron a 128-row run
PIPE_SWEPT = {8: (1.07, 1.2), 16: (1.13, 1.41), 32: (1.19, 1.79)}


@pytest.mark.parametrize("depth", sorted(PIPE_SWEPT))
def test_the_pipeline_plan_sweeps_a_small_apron(depth):
    n = 8192
    _, band = kpipe._plan(n, n, depth)
    width = kpipe.window_threads(band, depth) * kpipe.columns(depth)
    columns, area = PIPE_SWEPT[depth]
    assert -(-n // band) * width / n <= columns
    assert kpipe._area_ratio(n, n, depth, band) <= area


@pytest.mark.parametrize("shape", [(8192, 8192), (4096, 2048)])
@pytest.mark.parametrize("depth", [8, 16, 32])
def test_the_pipeline_fills_the_card(shape, depth):
    """The C entry cuts each band's stripes into runs of at most
    RUN_ROWS rows: at least a block for every SM at the main shapes."""
    h, w = shape
    stripe, band = kpipe._plan(h, w, depth)
    runs = min(h // stripe, -(-h // kpipe.RUN_ROWS))
    assert -(-w // band) * runs >= _build.SMS


def test_the_pipeline_takes_every_shape_its_first_form_took():
    """No narrower than the first, window-sweeping kernel (its plan is
    ``chip_smoke.earlier_pipeline_plan``), stripe named or not."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    first = chip_smoke.earlier_pipeline_plan
    for h in (8, 16, 24, 40, 72, 256, 4096, 8192):
        for w in (128, 384, 1024, 8192):
            for depth in (8, 16, 24, 32, 40, 48, 56):
                for buffering in (1, kpipe.PIPELINE_SLOTS):
                    for stripe in (None, 8, 16, 24, 64):
                        if first(h, w, depth, buffering, stripe) is None:
                            continue
                        assert kpipe._plan(h, w, depth, buffering,
                                           stripe) is not None, (
                            h, w, depth, buffering, stripe)


def test_pass_refusals_raise_value_errors(comm11):
    block = st.block_from_numpy(_grid(32, 128), comm11)
    for kw, words in (({"compute_dtype": "float16"}, "compute_dtype"),
                      ({"buffering": 2}, "buffering must be 1 or 3"),
                      ({"stripe": 12}, "requested stripe 12"),
                      ({"depth": 7}, "multiple of 8")):
        kw = {"depth": 8, **kw}
        with pytest.raises(ValueError, match=words):
            st.make_pipeline_stencil_fn(comm11, 16, 32, 128, **kw)(block)
        with pytest.raises(ValueError, match=words):
            st.pipeline_pass(block, comm11, 32, 128, **kw)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="must be float32"):
            st.make_pipeline_stencil_fn(comm11, 8, 32, 128)(block.to(dtype))
    assert not st.pipeline_supported(32, 128, torch.float64, 8)
    assert not st.pipeline_supported(32, 128, torch.float32, 8,
                                     compute_dtype="float16")
    assert not st.pipeline_supported(32, 128, torch.float32, 8, buffering=2)


def test_sweeps_wrapper_checks_out_and_device():
    ext = torch.zeros(48, 144)
    with pytest.raises(ValueError, match="must not share"):
        st.pipeline_sweeps(ext, 0, 0, 32, 128, 8, out=ext)
    with pytest.raises(ValueError, match="out must be"):
        st.pipeline_sweeps(ext, 0, 0, 32, 128, 8, out=torch.zeros(48, 136))
    with pytest.raises(ValueError, match="contiguous"):
        st.pipeline_sweeps(ext.t().contiguous().t(), 0, 0, 32, 128, 8)
    with pytest.raises(ValueError, match="no kernel for meta"):
        st.pipeline_sweeps(ext.to("meta"), 0, 0, 32, 128, 8)
    before = dict(_build.LAUNCHES)
    st.pipeline_sweeps(ext, 0, 0, 32, 128, 8)
    assert _build.LAUNCHES == before   # the CPU path launches nothing
