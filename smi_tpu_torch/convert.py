"""State carried between the host and the rank grid.

The stencil's state is the grid; attention's is q, k and v, sharded on
the sequence; the transformer's is its weights, replicated, and its
``(B, S, E)`` data, sharded on the batch and the sequence; an SMI
kernel's are whatever arrays its specs shard or replicate over a world.
These functions are how a caller (and the parity tests) hands the same
global arrays to this package and reads them back.
"""

from __future__ import annotations

import numpy as np
import torch

from smi_tpu_torch.models import transformer as tf
from smi_tpu_torch.parallel.mesh import Communicator


def block_from_numpy(global_grid: np.ndarray,
                     comm: Communicator) -> torch.Tensor:
    """This rank's ``(H/px, W/py)`` block of a global float32 grid, as a
    contiguous float32 tensor on ``comm.device``."""
    grid = np.asarray(global_grid)
    if grid.dtype != np.float32:
        raise TypeError(
            f"the grid must be float32, got {grid.dtype}: build the "
            f"state as float32 so every package sees the same values"
        )
    if grid.ndim != 2:
        raise ValueError(f"the grid must be 2-D, got shape {grid.shape}")
    px, py = comm.axis_sizes
    x, y = grid.shape
    if x % px or y % py:
        raise ValueError(
            f"grid {grid.shape} not divisible by process grid {(px, py)}"
        )
    h, w = x // px, y // py
    rx, cy = comm.coords
    block = np.ascontiguousarray(grid[rx * h:(rx + 1) * h,
                                      cy * w:(cy + 1) * w])
    return torch.from_numpy(block).to(comm.device)


def grid_to_numpy(block: torch.Tensor, comm: Communicator) -> np.ndarray:
    """Gather every rank's block into the global grid, on every rank."""
    px, py = comm.axis_sizes
    if comm.size == 1:
        return block.detach().cpu().numpy()
    parts = comm.all_gather(block.contiguous()[None])
    rows = [torch.cat(tuple(parts[r * py:(r + 1) * py]), dim=1)
            for r in range(px)]
    return torch.cat(rows, dim=0).cpu().numpy()


def sequence_shard_from_numpy(x: np.ndarray, comm: Communicator,
                              dtype=torch.float32) -> torch.Tensor:
    """This rank's rows of a global float32 ``(S, H, D)`` array, sharded
    on the sequence over the communicator's first axis (the ring-attention
    axis), as a contiguous tensor of ``dtype`` on ``comm.device``."""
    x = np.asarray(x)
    if x.dtype != np.float32:
        raise TypeError(
            f"the array must be float32, got {x.dtype}: build the state as "
            f"float32 so every package sees the same values"
        )
    if x.ndim != 3:
        raise ValueError(f"the array must be (S, H, D), got shape {x.shape}")
    n, r = comm.shape[0], comm.coords[0]
    if x.shape[0] % n:
        raise ValueError(
            f"sequence length {x.shape[0]} not divisible by {n} ranks"
        )
    s_local = x.shape[0] // n
    shard = np.ascontiguousarray(x[r * s_local:(r + 1) * s_local])
    return torch.from_numpy(shard).to(device=comm.device, dtype=dtype)


def sequence_to_numpy(shard: torch.Tensor, comm: Communicator) -> np.ndarray:
    """Gather every rank's ``(S_local, H, D)`` shard along the first axis
    into the global sequence, on every rank; float32 (bf16 widened)."""
    shard = shard.detach()
    if shard.dtype == torch.bfloat16:
        shard = shard.float()
    axis = comm.axis_names[0]
    if comm.shape[0] == 1:
        return shard.cpu().numpy()
    return comm.all_gather(shard.contiguous(), axis).cpu().numpy()


def _check_float32(x: np.ndarray, what: str) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype != np.float32:
        raise TypeError(
            f"{what} must be float32, got {x.dtype}: build the state as "
            f"float32 so every package sees the same values"
        )
    return x


def data_shard_from_numpy(x: np.ndarray, comm: Communicator,
                          dtype=torch.float32) -> torch.Tensor:
    """This rank's ``(B/dp, S/sp, E)`` shard of a global float32
    ``(B, S, E)`` array on a ``(dp, sp)`` grid: the batch over the first
    axis, the sequence over the second, as a contiguous tensor of
    ``dtype`` on ``comm.device``."""
    x = _check_float32(x, "the data")
    if x.ndim != 3 or len(comm.shape) != 2:
        raise ValueError(f"need a (B, S, E) array on a (dp, sp) grid, got "
                         f"shape {x.shape} on grid {comm.shape}")
    (dp, sp), (i, j) = comm.shape, comm.coords
    b, s, _ = x.shape
    if b % dp or s % sp:
        raise ValueError(f"(B, S) = {(b, s)} not divisible by the grid "
                         f"{(dp, sp)}")
    b_loc, s_loc = b // dp, s // sp
    shard = np.ascontiguousarray(x[i * b_loc:(i + 1) * b_loc,
                                   j * s_loc:(j + 1) * s_loc])
    return torch.from_numpy(shard).to(device=comm.device, dtype=dtype)


def params_from_numpy(params, config, device=None):
    """A :class:`~smi_tpu_torch.models.transformer.TransformerBlock` from
    one block's float32 parameters, or a ``TransformerStack`` from the
    stacked ``(layers, ...)`` ones (the JAX package's ``init_params`` and
    ``init_stack_params`` trees, as numpy), on ``device`` (CUDA by
    default). The weights are copied."""
    leaves = {n: _check_float32(params[n], f"parameter {n}")
              for n in tf.PARAM_NAMES}
    e, hd, hidden = (config.embed, config.heads * config.head_dim,
                     config.mlp_ratio * config.embed)
    shapes = {"wqkv": (e, hd + 2 * config._kv * config.head_dim),
              "wo": (hd, e), "w1": (e, hidden), "w2": (hidden, e)}
    stacked = leaves["wqkv"].ndim == 3
    depth = leaves["wqkv"].shape[:1] if stacked else ()
    for n, x in leaves.items():
        if x.shape != depth + shapes[n]:
            raise ValueError(f"parameter {n} has shape {x.shape}, the "
                             f"config needs {depth + shapes[n]}")
    if stacked:
        return tf.TransformerStack(config, params=leaves, device=device)
    return tf.TransformerBlock(config, params=leaves, device=device)


def params_to_numpy(model) -> dict:
    """A block's or a stack's parameters as float32 numpy arrays, in the
    JAX package's layout (a stack's leaves stacked ``(layers, ...)``)."""
    blocks = getattr(model, "blocks", None)
    if blocks is None:
        return {n: p.detach().cpu().numpy().copy()
                for n, p in model.weights().items()}
    return {n: np.stack([b.weights()[n].detach().cpu().numpy()
                         for b in blocks])
            for n in tf.PARAM_NAMES}


def shards_from_numpy(array: np.ndarray, world, spec) -> list:
    """One tensor per rank of ``world`` from a global array, on the
    world's device: a copy each for ``spec=None`` (the JAX side's
    ``P()``), else the leading dimension cut over the spec's axis (its
    ``P(axis)``), as :func:`smi_tpu_torch.parallel.context.smi_kernel`
    shards its arguments."""
    return world.shard(torch.from_numpy(np.ascontiguousarray(array)), spec)


def shards_to_numpy(shards, spec, world=None) -> np.ndarray:
    """The global array of per-rank outputs: rank 0's for ``spec=None``,
    else the shards concatenated along the leading dimension — all of
    them in rank order on a 1-D grid, or, given the ``world``, those of
    rank 0's line of the spec's axis."""
    if spec is None:
        out = shards[0]
    elif world is not None:
        out = world.assemble(list(shards), spec)
    else:
        out = torch.cat(list(shards), dim=0)
    return out.detach().cpu().numpy()
