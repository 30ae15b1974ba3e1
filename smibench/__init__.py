"""The benchmark of the PyTorch and CUDA port (``smi_tpu_torch``): one
closed-loop run of one cell a process, ``python3 -m smibench``."""
