"""Collective implementation tiers and shared reduce-op dispatch.

PyTorch counterpart of :mod:`smi_tpu.parallel.backend`. Two data-plane
tiers:

- ``"xla"``: the collective-library tier, named as in the JAX package —
  here ``torch.distributed`` groups, or the in-process rendezvous of a
  :class:`~smi_tpu_torch.parallel.local.LocalWorld`;
- ``"ring"``: the explicit neighbour-write kernels with credit flow
  control (:mod:`smi_tpu_torch.kernels.ring`).

This module owns the backend vocabulary and the single ADD/MAX/MIN
dispatch used by every tier, so collectives, channels and kernels cannot
drift apart.
"""

from __future__ import annotations

from typing import Union

import torch

from smi_tpu_torch.ops.types import SmiOp

BACKENDS = ("xla", "ring")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of "
            f"{BACKENDS}"
        )
    return backend


def combine_fn(op: Union[str, SmiOp]):
    """Elementwise combiner for a reduce op."""
    return {
        SmiOp.ADD: torch.add,
        SmiOp.MAX: torch.maximum,
        SmiOp.MIN: torch.minimum,
    }[SmiOp.parse(op)]


def reduction_fn(op: Union[str, SmiOp]):
    """Reduction over one axis for a reduce op: ``fn(x, axis=0)``."""
    op = SmiOp.parse(op)
    if op is SmiOp.ADD:
        return lambda x, axis=0: torch.sum(x, dim=axis, dtype=x.dtype)
    if op is SmiOp.MAX:
        return lambda x, axis=0: torch.amax(x, dim=axis)
    return lambda x, axis=0: torch.amin(x, dim=axis)


def identity_for(op: Union[str, SmiOp], dtype: torch.dtype):
    """The reduce op's identity element in ``dtype`` (a Python number)."""
    op = SmiOp.parse(op)
    if op is SmiOp.ADD:
        return 0
    if dtype.is_floating_point:
        return float("inf") if op is SmiOp.MIN else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op is SmiOp.MIN else info.min
