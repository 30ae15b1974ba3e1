"""smi_tpu_torch's kernels on a CUDA card: the tests that need one.

Each test is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false. On a GPU host they run with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``. This
file imports no JAX, and ``--noconftest`` skips ``tests/conftest.py``,
which does, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

import smi_tpu_torch as st

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
