"""The ``afmoe`` attention sublayer's elementwise glue as two fused
kernel pairs (``csrc/attn_glue.cu``), each under autograd.

- :func:`attn_prologue` takes the ``wqkv`` product in bf16, ``(B*S,
  (H + 2*KV)*D)``, to the flash kernels' q, k and v: every query and key
  head RMS-normed by its weight (``q_norm``, ``k_norm``), rotated on
  windowed layers by the rotary tables, rounded once to bf16 and written
  head-major, q ``(B*H, S, D)`` and k, v ``(B*KV, S, D)``, the heads of
  one batch adjacent (index ``b*H + h``, so the GQA map ``hh // (H/KV)``
  holds). Its backward writes ``d qkv`` in bf16 and the norm weights'
  gradients in f32.
- :func:`attn_epilogue` takes the flash output, the ``(S, B*H, D)``
  view of its head-major bf16 tensor, and the gate product ``x Wg`` in
  bf16, ``(B*S, H*D)``, to ``attn * sigmoid(gate)`` rounded once to bf16
  in token order ``(B*S, H*D)``, the ``wo`` product's input. Its backward
  hands ``d attn`` back as the ``(S, B*H, D)`` view of a head-major
  tensor, the layout the flash backward reads.

Each rounds where the unfused composition in ``models/transformer.py``
rounds (the products' outputs, the fold to bf16, ``wo``'s input), with
f32 math between. CUDA tensors launch the kernels; CPU tensors run the
plain versions (:func:`attn_prologue_plain`, :func:`attn_epilogue_plain`)
and differentiate them by autograd. Each kernel's launches are counted in
``_build.LAUNCHES``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from smi_tpu_torch.kernels import _build

KERNEL_PROLOGUE = "attn_prologue"
KERNEL_PROLOGUE_BWD = "attn_prologue_bwd"
KERNEL_EPILOGUE = "attn_epilogue"
KERNEL_EPILOGUE_BWD = "attn_epilogue_bwd"

#: head dims the kernels are instantiated for (a warp a row, D/32 a lane)
HEAD_DIMS = (64, 128, 256)

#: rows (one token's head) a block: 8 warps of 256 threads
BLOCK_ROWS = 8

#: blocks of 256 threads an SM in the prologue's backward
BWD_BLOCKS_PER_SM = 8


def launch_blocks(kernel: str, rows: int) -> int:
    """Blocks of one launch over ``rows`` (token, head) rows: a warp a
    row, except the prologue's backward, a fixed grid
    (:func:`~smi_tpu_torch.kernels._build.fixed_grid`) whose warps stride
    over the rows."""
    blocks = -(-rows // BLOCK_ROWS)
    if kernel == KERNEL_PROLOGUE_BWD:
        return _build.fixed_grid(blocks, BWD_BLOCKS_PER_SM)
    return blocks


def _rotate(t, cos, sin):
    """``t * cos + rot * sin`` with ``rot = (-t[..., D/2:], t[..., :D/2])``
    over the last dim; ``cos``/``sin`` broadcast ``(S, D)`` over the batch
    and heads of ``t`` ``(B, S, heads, D)``."""
    half = t.shape[-1] // 2
    rotated = torch.cat((-t[..., half:], t[..., :half]), dim=-1)
    return t * cos[None, :, None] + rotated * sin[None, :, None]


def attn_prologue_plain(qkv, q_norm, k_norm, batch: int, heads: int,
                        kv_heads: int, eps: float,
                        rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                        = None, dtype: torch.dtype = torch.bfloat16):
    """:func:`attn_prologue` in PyTorch ops: the kernels' plain version,
    and the plain composition ``models/transformer.py`` runs off the
    card. ``rope``: the ``(cos, sin)`` tables, ``(S, D)`` f32, or None;
    ``dtype``: the compute dtype q, k and v are rounded to."""
    s = qkv.shape[0] // batch
    width = heads + 2 * kv_heads
    d = qkv.shape[1] // width
    x = qkv.float().view(batch, s, width, d)
    q = F.rms_norm(x[:, :, :heads], (d,), q_norm, eps)
    k = F.rms_norm(x[:, :, heads:heads + kv_heads], (d,), k_norm, eps)
    v = x[:, :, heads + kv_heads:]
    if rope is not None:
        q, k = (_rotate(t, *rope) for t in (q, k))
    return tuple(t.to(dtype).transpose(1, 2).reshape(
        batch * t.shape[2], s, d).contiguous() for t in (q, k, v))


def token_order(attn, batch: int, heads: int):
    """The attention output ``attn`` ``(S, B*H, D)`` widened to f32 in
    token order ``(B*S, H*D)``, in one copy."""
    s, _, d = attn.shape
    return attn.reshape(s, batch, heads, d).transpose(0, 1).to(
        torch.float32, memory_format=torch.contiguous_format
    ).reshape(batch * s, heads * d)


def attn_epilogue_plain(attn, gate, batch: int, heads: int):
    """:func:`attn_epilogue` in PyTorch ops: the kernels' plain version."""
    return (token_order(attn, batch, heads)
            * torch.sigmoid(gate.float())).to(torch.bfloat16)


def _head_dim(what: str, d: int, device) -> None:
    _build.check_device(what, device, d in HEAD_DIMS,
                        f"head dim {d} (head dims {HEAD_DIMS})")


class _Prologue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, q_norm, k_norm, cos, sin, batch, heads, kv_heads,
                eps):
        ctx.save_for_backward(qkv, q_norm, k_norm, cos, sin)
        ctx.shape = (batch, heads, kv_heads, eps)
        rope = None if cos is None else (cos, sin)
        if qkv.device.type == "cpu":
            return attn_prologue_plain(qkv, q_norm, k_norm, batch, heads,
                                       kv_heads, eps, rope)
        s, d = qkv.shape[0] // batch, q_norm.shape[0]
        q = torch.empty((batch * heads, s, d), dtype=qkv.dtype,
                        device=qkv.device)
        k = torch.empty((batch * kv_heads, s, d), dtype=qkv.dtype,
                        device=qkv.device)
        v = torch.empty_like(k)
        _build.launch(KERNEL_PROLOGUE, qkv.device,
                      qkv, q_norm, k_norm, cos, sin, q, k, v,
                      batch, s, heads, kv_heads, d, float(eps))
        return q, k, v

    @staticmethod
    @once_differentiable
    def backward(ctx, dq, dk, dv):
        qkv, q_norm, k_norm, cos, sin = ctx.saved_tensors
        batch, heads, kv_heads, eps = ctx.shape
        rope = None if cos is None else (cos, sin)
        if qkv.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_()
                          for t in (qkv, q_norm, k_norm)]
                outs = attn_prologue_plain(*leaves, batch, heads, kv_heads,
                                           eps, rope)
                grads = torch.autograd.grad(outs, leaves, (dq, dk, dv))
            return (*grads, None, None, None, None, None, None)
        s, d = qkv.shape[0] // batch, q_norm.shape[0]
        grads_in = [t.contiguous() for t in (dq, dk, dv)]
        for name, t, h in (("dq", grads_in[0], heads),
                           ("dk", grads_in[1], kv_heads),
                           ("dv", grads_in[2], kv_heads)):
            _build.check_operand("attn_prologue backward", name, t,
                                 qkv.dtype, (batch * h, s, d))
        rows = qkv.shape[0] * (heads + 2 * kv_heads)
        blocks = launch_blocks(KERNEL_PROLOGUE_BWD, rows)
        dqkv = torch.empty_like(qkv)
        partial = torch.empty((blocks, 2, d), dtype=torch.float32,
                              device=qkv.device)
        dw = torch.empty((2, d), dtype=torch.float32, device=qkv.device)
        _build.launch(KERNEL_PROLOGUE_BWD, qkv.device,
                      qkv, q_norm, k_norm, cos, sin, *grads_in, dqkv,
                      partial, dw,
                      batch, s, heads, kv_heads, d, blocks, float(eps))
        return dqkv, dw[0], dw[1], None, None, None, None, None, None


def attn_prologue(qkv, q_norm, k_norm, batch: int, heads: int,
                  kv_heads: int, eps: float,
                  rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``(q, k, v)`` of the attention from the ``wqkv`` product ``qkv``
    ``(B*S, (H + 2*KV)*D)`` bf16: q ``(B*H, S, D)``, k and v ``(B*KV, S,
    D)``, bf16, head-major. ``q_norm``/``k_norm`` are the ``(D,)`` f32
    weights of the query and key heads' RMSNorm (``eps`` inside the
    reciprocal square root); ``rope`` the ``(cos, sin)`` tables ``(S,
    D)`` f32 with equal halves, or None on a layer without positions.
    Differentiable in ``qkv`` and the two weights."""
    what = "attn_prologue"
    rows, cols = qkv.shape
    width = heads + 2 * kv_heads
    d = q_norm.shape[0]
    if rows % batch or cols != width * d:
        raise ValueError(f"{what}: qkv {tuple(qkv.shape)} is not ({batch} * "
                         f"S, ({heads} + 2 * {kv_heads}) * {d})")
    _head_dim(what, d, qkv.device)
    _build.check_operand(what, "qkv", qkv, torch.bfloat16, (rows, cols))
    q_norm, k_norm = q_norm.contiguous(), k_norm.contiguous()
    for name, t in (("q_norm", q_norm), ("k_norm", k_norm)):
        _build.check_operand(what, name, t, torch.float32, (d,))
    cos, sin = (None, None) if rope is None else rope
    if rope is not None:
        for name, t in (("cos", cos), ("sin", sin)):
            _build.check_operand(what, name, t, torch.float32,
                                 (rows // batch, d))
    return _Prologue.apply(qkv, q_norm, k_norm, cos, sin, batch, heads,
                           kv_heads, eps)


class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attn, gate, batch, heads):
        heads_major = attn.transpose(0, 1).contiguous()
        ctx.save_for_backward(heads_major, gate)
        ctx.shape = (batch, heads)
        if gate.device.type == "cpu":
            return attn_epilogue_plain(attn, gate, batch, heads)
        s, _, d = attn.shape
        _build.check_operand("attn_epilogue", "attn", heads_major,
                             gate.dtype, (batch * heads, s, d))
        out = torch.empty_like(gate)
        _build.launch(KERNEL_EPILOGUE, gate.device, heads_major, gate, out,
                      batch, s, heads, d)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        heads_major, gate = ctx.saved_tensors
        batch, heads = ctx.shape
        if gate.device.type == "cpu":
            with torch.enable_grad():
                leaves = [heads_major.detach().requires_grad_(),
                          gate.detach().requires_grad_()]
                out = attn_epilogue_plain(leaves[0].transpose(0, 1),
                                          leaves[1], batch, heads)
                dattn, dgate = torch.autograd.grad(out, leaves, dout)
            return dattn.transpose(0, 1), dgate, None, None
        dout = dout.contiguous()
        _build.check_operand("attn_epilogue backward", "dout", dout,
                             gate.dtype, gate.shape)
        _, s, d = heads_major.shape
        dattn = torch.empty_like(heads_major)
        dgate = torch.empty_like(gate)
        _build.launch(KERNEL_EPILOGUE_BWD, gate.device,
                      heads_major, gate, dout, dattn, dgate,
                      batch, s, heads, d)
        return dattn.transpose(0, 1), dgate, None, None


def attn_epilogue(attn, gate, batch: int, heads: int):
    """``attn * sigmoid(gate)`` in bf16, ``(B*S, H*D)`` in token order,
    from the attention output ``attn`` ``(S, B*H, D)`` bf16 (read where
    it lies when it is the view of a head-major tensor, as the flash tier
    returns it) and the gate product ``gate`` ``(B*S, H*D)`` bf16.
    Differentiable in both."""
    what = "attn_epilogue"
    s, bh, d = attn.shape
    if bh != batch * heads:
        raise ValueError(f"{what}: attn has {bh} heads, not {batch} * "
                         f"{heads}")
    _head_dim(what, d, gate.device)
    if attn.dtype != torch.bfloat16 or attn.device != gate.device:
        raise TypeError(f"{what}: attn must be bfloat16 on {gate.device}, "
                        f"got {attn.dtype} on {attn.device}")
    _build.check_operand(what, "gate", gate, torch.bfloat16,
                         (batch * s, heads * d))
    return _Epilogue.apply(attn, gate, batch, heads)
