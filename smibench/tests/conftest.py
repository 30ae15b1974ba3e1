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


def reduced_faults(entry: dict, config: dict) -> list:
    """What breaks the rule of a cut to one chip's share in a
    configuration's ``BENCHMARK.json`` entry and its file: each name in
    ``reduced`` is a key of the file, the file's ``published`` object
    gives the source's value of each, and its ``deployment`` says over
    how many chips a layer is divided, and how. A configuration with
    nothing reduced needs neither key."""
    reduced = entry["reduced"]
    if not reduced:
        return []
    faults = []
    published = config.get("published")
    if not isinstance(published, dict):
        faults.append("no published object")
        published = {}
    for key in reduced:
        if key not in config:
            faults.append(f"{key!r} is not a key of the file")
        if key not in published:
            faults.append(f"{key!r} has no published value")
    deployment = config.get("deployment")
    if not isinstance(deployment, str) or not deployment.strip():
        faults.append("no deployment")
    return faults
