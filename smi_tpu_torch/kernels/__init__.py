"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources live in ``csrc/`` and build at first use (``_build``)."""
