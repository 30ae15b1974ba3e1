"""Ring attention: sequence-parallel attention over a rank ring.

PyTorch counterpart of :mod:`smi_tpu.models.ring_attention`. Each rank
holds its ``(S_local, H, D)`` query shard and its ``(S_local, H_kv, D)``
K/V shards; K/V circulate around the ring with one :func:`ring_shift`
per step while each rank folds the block it holds into the
online-softmax state (running row max ``m``, normaliser ``l``, weighted
value sum ``acc``). Causality and the sliding window come from global
positions, so the result equals full attention on the gathered sequence.

Two tiers, as in the JAX package:

- the flash tier (``kernels/flash.py``): on a one-rank ring the fused
  kernel attends the whole extent in one launch; on a longer ring each
  step is one launch of the carried kernel. V may be narrower than Q and
  K (DeepSeek-V3's 192 against 128, a form the bf16 kernels take as it
  is). Head dims the kernel has no instantiation for are zero-padded up
  to one it has, with the scale of the original query and key head dim.
  Its backward is a ``torch.autograd.Function``
  over the FlashAttention-2 kernels: the probabilities are recomputed
  from the saved ``(m, l)``, K/V make one more ring circuit carrying
  their ``(dk, dv)`` home, and dq accumulates locally; one launch of
  each backward kernel per ring step.
- the plain tier (the JAX package's jnp tier): the same ring over the
  kernels' plain version (``flash_block_attend_plain``, torch ops),
  differentiable by autograd. Both tiers share one fold and one mask
  rule (a masked score is ``-inf``); the JAX jnp tier masks with
  ``NEG_INF`` instead, which changes only rows with no live key, so the
  outputs agree.

``use_flash=None`` picks the flash tier on a CUDA communicator and the
plain tier on the CPU. On CUDA a shape the kernel cannot take raises and
says to pass ``use_flash=False``: nothing gives way to the plain tier
quietly.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from smi_tpu_torch.kernels.flash import (
    HEAD_DIMS,
    backward_rows,
    fresh_state,
    flash_attend_fused,
    flash_block_attend,
    flash_block_attend_plain,
    flash_block_backward_dkdv,
    flash_block_backward_dq,
    flash_supported,
)
from smi_tpu_torch.parallel.channels import ring_shift
from smi_tpu_torch.parallel.mesh import Communicator


def _ring_order(rank: int, n: int) -> List[int]:
    """Origin rank of the block a rank holds at each ring step: its own,
    then its left neighbour's, and so on (``rank - s`` mod ``n``)."""
    return [(rank - s) % n for s in range(n)]


def _ring_schedule(fold: Callable, comm: Communicator, axis: str, k0, v0,
                   carry0):
    """The ring circuit shared by both tiers: hold Q, pass K/V to the
    right neighbour after each fold, fold the currently held block with
    its origin rank (for the global offsets); the last block folds
    without a trailing shift. ``fold(src_rank, k, v, carry) -> carry``."""
    a = comm._axis(axis)
    order = _ring_order(comm.coords[a], comm.shape[a])
    k_cur, v_cur, carry = k0, v0, carry0
    for step, src in enumerate(order):
        carry = fold(src, k_cur, v_cur, carry)
        if step < len(order) - 1:
            k_cur = ring_shift(k_cur, comm, offset=1, axis_name=axis)
            v_cur = ring_shift(v_cur, comm, offset=1, axis_name=axis)
    return carry


def _padded_head_dim(d: int) -> int:
    """Head dim rounded up to one the flash kernel is instantiated for
    (``d`` itself when it is wider than them all)."""
    return next((hd for hd in HEAD_DIMS if hd >= d), d)


def _flash_head_dims(s_local, d, d_v, dtype):
    """The head dims the flash kernels run ``(d, d_v)`` at: as they are
    where the kernels have that form, else both zero-padded to one head
    dim they have."""
    if flash_supported(s_local, s_local, d, dtype, d_v):
        return d, d_v
    dp = _padded_head_dim(max(d, d_v))
    return dp, dp


def _use_flash_default(comm: Communicator, s_local, h, d, dtype,
                       d_v=None) -> bool:
    """The flash tier on a CUDA communicator, the plain tier elsewhere
    (as the JAX package picks Pallas only on a TPU). A CUDA shape the
    kernel cannot take raises rather than falling back."""
    if comm.device.type != "cuda":
        return False
    d_v = d if d_v is None else d_v
    dp, dvp = _flash_head_dims(s_local, d, d_v, dtype)
    if not flash_supported(s_local, s_local, dp, dtype, dvp):
        raise ValueError(
            f"the flash kernel does not take S_local={s_local}, head dims "
            f"({d}, {d_v}), {dtype} on {comm.device}: pass use_flash=False "
            f"to run the plain tier"
        )
    return True


def _flash_finalize(acc, l, dtype):
    """``acc / l`` in ``dtype``; rows that no fold reached keep 0."""
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)  # (H, 1, S)
    return (acc / safe_l.transpose(1, 2)).to(dtype)


def _ring_forward(fold_block: Callable, q, k, v, comm, causal, axis,
                  window, scale):
    """Both tiers' ring over head-major layouts: each step folds the held
    K/V block into the f32 ``(m, l, acc)`` through ``fold_block``
    (:func:`flash_block_attend` for the flash tier, its plain version for
    the plain tier), the block's offset from its origin rank. Returns
    ``(out, m, l)``; only the smaller grouped K/V circulate."""
    a = comm._axis(axis)
    s_local, h, _ = q.shape
    q_off = comm.coords[a] * s_local
    qT, kT, vT = (x.transpose(0, 1).contiguous() for x in (q, k, v))

    def fold(src, k_cur, v_cur, carry):
        return fold_block(qT, k_cur, v_cur, *carry, q_off, src * s_local,
                          causal, scale, window=window)

    m, l, acc = _ring_schedule(fold, comm, axis, kT, vT,
                               fresh_state(h, s_local, v.shape[2], q.device))
    return _flash_finalize(acc, l, q.dtype).transpose(0, 1), m, l


def _flash_forward(q, k, v, comm, causal, axis, window, scale=None):
    """Flash-tier ring forward: one launch per ring step, K/V moved by
    ``ring_shift``. Returns ``(out, m, l)``; the statistics are the
    backward's residuals."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    if comm.shape[comm._axis(axis)] == 1:
        # one rank: the whole extent in one fused launch, no (m, l, acc)
        # round trip through device memory
        out, m, l = flash_attend_fused(
            *(x.transpose(0, 1).contiguous() for x in (q, k, v)), 0, 0,
            causal, scale, window=window)
        return out.transpose(0, 1), m, l
    return _ring_forward(flash_block_attend, q, k, v, comm, causal, axis,
                         window, scale)


def _flash_ring_backward(q, k, v, out, m, l, dout, comm, causal, axis,
                         window, scale=None):
    """FlashAttention-2 backward over the ring: ``(dq, dk, dv)`` in the
    inputs' dtypes.

    The probabilities are recomputed blockwise from the saved ``(m, l)``
    (nothing quadratic is stored). K/V make one more ring circuit, this
    time carrying their ``(dk, dv)`` accumulators: after ``n`` fold+shift
    steps each block is home with the contributions of every rank's
    queries on board. dq accumulates locally. ``delta`` comes from the
    saved output in q's dtype, as the reference forms it."""
    a = comm._axis(axis)
    s_local, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q_off = comm.coords[a] * s_local
    qT, kT, vT = (x.transpose(0, 1).contiguous() for x in (q, k, v))
    doutT = dout.transpose(0, 1).to(q.dtype).contiguous()
    # statistics stay (H, 1, S) rows end to end, as the kernels read them
    linv, delta = backward_rows(out.transpose(0, 1), l, doutT)
    shift = functools.partial(ring_shift, comm=comm, offset=1,
                              axis_name=axis)

    def fold(src, k_cur, v_cur, carry):
        dk, dv, dq = carry
        k_off = src * s_local
        dq_c = flash_block_backward_dq(qT, k_cur, v_cur, doutT, m, linv,
                                       delta, q_off, k_off, causal, scale,
                                       window=window)
        dk_c, dv_c = flash_block_backward_dkdv(qT, k_cur, v_cur, doutT, m,
                                               linv, delta, q_off, k_off,
                                               causal, scale, window=window)
        # the accumulators travel with their block; after n shifts both
        # are back at the block's owner
        return (shift(dk + dk_c), shift(dv + dv_c),
                dq_c if dq is None else dq + dq_c)

    dk, dv, dq = _ring_schedule(fold, comm, axis, kT, vT, tuple(
        torch.zeros(x.shape, dtype=torch.float32, device=q.device)
        for x in (kT, vT)) + (None,))
    return (dq.transpose(0, 1).to(q.dtype), dk.transpose(0, 1).to(k.dtype),
            dv.transpose(0, 1).to(v.dtype))


class _FlashRingAttention(torch.autograd.Function):
    """The flash tier under autograd: the forward saves ``q, k, v, out,
    m, l``; the backward is :func:`_flash_ring_backward` on the backward
    kernels. It is not itself differentiable (no double backward)."""

    @staticmethod
    def forward(ctx, q, k, v, comm, causal, axis, window, scale):
        out, m, l = _flash_forward(q, k, v, comm, causal, axis, window,
                                   scale=scale)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.ring = (comm, causal, axis, window, scale)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        grads = _flash_ring_backward(*ctx.saved_tensors, dout, *ctx.ring)
        return (*grads, None, None, None, None, None)


def ring_attention_shard(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    comm: Communicator,
    causal: bool = False,
    axis_name: Optional[str] = None,
    precision=None,
    use_flash: Optional[bool] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ring attention over this rank's shard.

    ``q`` is this rank's ``(S_local, H, D)`` sequence shard; ``k`` is
    ``(S_local, H_kv, D)`` and ``v`` ``(S_local, H_kv, Dv)`` with ``H_kv``
    dividing ``H`` (grouped-query attention); the output is ``(S_local,
    H, Dv)``, at scale ``1/sqrt(D)``. ``window`` (requires ``causal``)
    restricts each query to its ``window`` most recent positions.
    ``precision`` is accepted for the JAX signature; f32 is always full
    f32 in the flash tier.
    """
    if window is not None and (not causal or window < 1):
        raise ValueError(
            "sliding window requires causal attention and window >= 1"
        )
    axis = axis_name or comm.axis_names[0]
    s_local, h, d = q.shape
    h_kv, d_v = k.shape[1], v.shape[2]
    if h % h_kv or v.shape[1] != h_kv:
        raise ValueError(
            f"kv heads {k.shape[1]}/{v.shape[1]} must agree and divide "
            f"query heads {h}"
        )
    if use_flash is None:
        use_flash = _use_flash_default(comm, s_local, h, d, q.dtype, d_v)
    if use_flash:
        dp, dvp = _flash_head_dims(s_local, d, d_v, q.dtype)
        if (dp, dvp) != (d, d_v):
            # zero-pad the head dims: padded lanes add 0 to every dot
            # product, so scores and outputs are exact; the explicit
            # scale keeps 1/sqrt(d) of the original head dim
            out = _FlashRingAttention.apply(
                F.pad(q, (0, dp - d)), F.pad(k, (0, dp - d)),
                F.pad(v, (0, dvp - d_v)), comm, causal, axis, window,
                1.0 / math.sqrt(d))
            return out[..., :d_v]
        return _FlashRingAttention.apply(q, k, v, comm, causal, axis, window,
                                         None)
    out, _, _ = _ring_forward(flash_block_attend_plain, q, k, v, comm,
                              causal, axis, window, 1.0 / math.sqrt(d))
    return out


def make_ring_attention_fn(
    comm: Communicator,
    causal: bool = False,
    precision=None,
    use_flash: Optional[bool] = None,
    reps: int = 1,
    window: Optional[int] = None,
    remat_reps: bool = False,
):
    """``fn(q, k, v)``: sequence-parallel attention over the
    communicator's first axis, on this rank's shards.

    ``reps > 1`` chains that many applications (the output fed back as
    the next query), the JAX package's timing harness. ``remat_reps``
    recomputes each rep under differentiation
    (``torch.utils.checkpoint``) instead of saving every rep's residuals;
    as in the JAX package it applies only when ``reps > 1``.
    """
    axis = comm.axis_names[0]

    def once(q, k, v):
        return ring_attention_shard(
            q, k, v, comm, causal=causal, axis_name=axis,
            precision=precision, use_flash=use_flash, window=window,
        )

    chained = once
    if remat_reps and reps > 1:
        chained = functools.partial(checkpoint, once, use_reentrant=False)

    def fn(q, k, v):
        for _ in range(reps):
            q = chained(q, k, v)
        return q

    return fn


def _reference_rows(q, k, v, rows, causal, window) -> np.ndarray:
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    rows = np.asarray(rows)
    d = q.shape[-1]
    # (H, rows, D) @ (H, D, S): batched BLAS products in float64
    scores = np.matmul(q[rows].transpose(1, 0, 2),
                       k.transpose(1, 2, 0)) / math.sqrt(d)
    if causal:
        k_pos = np.arange(k.shape[0])
        masked = k_pos[None, None] > rows[None, :, None]
        if window is not None:
            masked |= k_pos[None, None] < rows[None, :, None] - (window - 1)
        scores = np.where(masked, -np.inf, scores)
    scores -= scores.max(axis=-1, keepdims=True)
    p = np.exp(scores)
    p /= p.sum(axis=-1, keepdims=True)
    return np.matmul(p, v.transpose(1, 0, 2)).transpose(1, 0, 2)


def reference_attention(q, k, v, causal: bool = False,
                        window=None) -> np.ndarray:
    """Full (gathered) attention in float64 numpy, for verification."""
    return _reference_rows(q, k, v, np.arange(np.shape(q)[0]), causal,
                           window)


def reference_attention_rows(q, k, v, rows, causal: bool = False,
                             window=None) -> np.ndarray:
    """Reference attention for a subset of query rows — O(len(rows)·S)
    host memory, for verification at full size."""
    return _reference_rows(q, k, v, rows, causal, window)
