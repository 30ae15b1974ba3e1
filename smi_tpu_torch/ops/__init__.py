"""Substrate-neutral operation/port/program model.

This is the front half of the SMI "compiler": the taxonomy of communication
operations, the per-rank program metadata, and its JSON wire format. It is
deliberately independent of PyTorch so it can be unit-tested without devices.
It is this package's own copy of the model (the JAX package keeps its own).

Reference parity: ``codegen/ops.py``, ``codegen/program.py``,
``codegen/serialization.py``.
"""
