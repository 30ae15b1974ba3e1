"""Shared fixtures of the benchmark's tests. Whether a card is present
is decided inside the ``cuda_device`` fixture, never at import."""

import pytest

#: sizes at which a cell runs on the CPU in a test: every path of the
#: cell (both stencil kernels' plain versions), at a few milliseconds a
#: solve
TINY = {
    "stencil-1x1": {"config": {"X": 64, "Y": 64, "sweeps": 19}},
}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
