"""The ``afmoe`` block's residual junctions as one fused kernel each way
(``csrc/residual_norm.cu``), in three forms, each under autograd. Every
activation is ``(T, E)``, a token a row; every norm an RMSNorm over the
row with an f32 weight ``(E,)`` and ``eps`` inside the reciprocal square
root.

- :func:`entry_norm` (the block's start; the final norm before the
  head): ``(x, xn)``, the residual stream ``x`` (f32) passed on and ``xn
  = rms(x) * w`` rounded to bf16 for the products. Passing ``x`` on (a
  view, nothing written) lets the backward sum both of its gradients,
  the next junction's and the norm's, in the same pass.
- :func:`middle_norm` (after the attention): ``(h, yn)``, ``h = x +
  rms(out) * w_post`` from the ``wo`` product ``out`` in bf16, and ``yn
  = rms(h) * w_pre`` in bf16 for a dense MLP or f32 for an expert layer
  (its router reads f32).
- :func:`exit_norm` (after the MLP): ``x_out = h + rms(out) * w`` from
  the MLP's f32 output.

Each reads its inputs once and writes its outputs once, with f32 math
between, rounding where the plain composition rounds (xn, a bf16 yn, and
in the middle's backward ``d out``, as the plain path's widening of the
bf16 product does). Each backward writes ``dx`` in f32 (the exit's is its
incoming gradient, passed on) and the norm weights' gradients in f32,
summed over a grid fixed by the row count (:func:`launch_blocks`), so a
step repeats bit for bit. CUDA tensors launch the kernels; CPU tensors
run the plain versions (:func:`entry_norm_plain`,
:func:`middle_norm_plain`, :func:`exit_norm_plain`) and differentiate
them by autograd. Launches are counted in ``_build.LAUNCHES`` under
``residual_norm`` and ``residual_norm_bwd``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from smi_tpu_torch.kernels import _build

KERNEL = "residual_norm"
KERNEL_BWD = "residual_norm_bwd"

#: the forms, as the C entries number them
ENTRY, MIDDLE, EXIT = 0, 1, 2

#: threads a block: a warp group, a row at a time
BLOCK_THREADS = 128

#: widths the kernels take: two spans of 1024 columns (Trinity-Mini's
#: 2048), in multiples of 8 (a thread's 16-byte bf16 load)
SPANS = 2

#: blocks of 128 threads an SM in the backward
BWD_BLOCKS_PER_SM = 4


def launch_blocks(kernel: str, rows: int) -> int:
    """Blocks of one launch over ``rows`` rows: a row a block forward; the
    backward a fixed grid (:func:`~smi_tpu_torch.kernels._build.fixed_grid`)
    whose blocks stride over the rows."""
    if kernel == KERNEL_BWD:
        return _build.fixed_grid(rows, BWD_BLOCKS_PER_SM)
    return rows


def entry_norm_plain(x, w, eps: float, dtype=torch.bfloat16):
    """:func:`entry_norm` in PyTorch ops: the kernels' plain version, and
    the composition ``models/transformer.py`` runs off the card."""
    return x, F.rms_norm(x, w.shape, w, eps).to(dtype)


def middle_norm_plain(x, out, w_post, w_pre, eps: float, dtype):
    """:func:`middle_norm` in PyTorch ops: the kernels' plain version."""
    h = x + F.rms_norm(out.float(), w_post.shape, w_post, eps)
    return h, F.rms_norm(h, w_pre.shape, w_pre, eps).to(dtype)


def exit_norm_plain(h, out, w, eps: float):
    """:func:`exit_norm` in PyTorch ops: the kernels' plain version."""
    return h + F.rms_norm(out, w.shape, w, eps)


def _plain(form: int, x, out, w0, w1, eps: float, dtype):
    if form == ENTRY:
        return entry_norm_plain(x, w0, eps, dtype)
    if form == MIDDLE:
        return middle_norm_plain(x, out, w0, w1, eps, dtype)
    return exit_norm_plain(x, out, w0, eps)


class _Junction(torch.autograd.Function):
    """One junction of form ``form`` on ``x`` ``(T, E)`` f32 (the exit's
    ``h``), the sublayer's ``out`` (None at the entry) and the weights
    ``w0`` and, in the middle, ``w1``."""

    @staticmethod
    def forward(ctx, form, x, out, w0, w1, eps, dtype):
        # an output nothing reads (the head's x passed on) has no gradient
        ctx.set_materialize_grads(False)
        ctx.form, ctx.eps, ctx.dtype = form, eps, dtype
        ctx.on_cpu = x.device.type == "cpu"
        if ctx.on_cpu:
            ctx.save_for_backward(x, out, w0, w1)
            return _plain(form, x, out, w0, w1, eps, dtype)
        rows, width = x.shape
        norms = 2 if form == MIDDLE else 1
        rstd = torch.empty((norms, rows), dtype=torch.float32,
                           device=x.device)
        y0 = torch.empty_like(x, dtype=torch.bfloat16 if form == ENTRY
                              else torch.float32)
        y1 = torch.empty_like(x, dtype=dtype) if form == MIDDLE else None
        _build.launch(KERNEL, x.device, x, out, w0, w1, y0, y1, rstd, form,
                      int(dtype == torch.bfloat16), rows, width, float(eps))
        # the exit's backward needs no h: its gradient is d x_out
        ctx.save_for_backward(None if form == EXIT else x, out, w0, w1, rstd)
        if form == ENTRY:
            return x, y0
        return y0 if y1 is None else (y0, y1)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        form = ctx.form
        if ctx.on_cpu:
            with torch.enable_grad():
                leaves = [None if t is None else t.detach().requires_grad_()
                          for t in ctx.saved_tensors]
                outs = _plain(form, *leaves, ctx.eps, ctx.dtype)
                if form == ENTRY:
                    # x passed on, as a node made after the norm's: its
                    # gradient is summed first, as the plain block sums it
                    outs = (leaves[0].view_as(leaves[0]), outs[1])
                elif form == EXIT:
                    outs = (outs,)
                given = [(o, g) for o, g in zip(outs, grads) if g is not None]
                found = iter(torch.autograd.grad(
                    [o for o, _ in given],
                    [t for t in leaves if t is not None],
                    [g for _, g in given]))
            return (None, *(None if t is None else next(found)
                            for t in leaves), None, None)
        x, out, w0, w1, rstd = ctx.saved_tensors
        norms, rows = rstd.shape
        width = w0.shape[0]
        what = "residual_norm backward"
        dres, dy = (None if g is None else g.contiguous()
                    for g in (*grads, None)[:2])
        if form != EXIT and dy is None:
            dy = torch.zeros((rows, width), dtype=ctx.dtype,
                             device=rstd.device)
        if dres is not None:
            _build.check_operand(what, "d x_out" if form == EXIT else
                                 "the stream's gradient", dres,
                                 torch.float32, (rows, width))
        if dy is not None:
            _build.check_operand(what, "d xn" if form == ENTRY else "d yn",
                                 dy, ctx.dtype, (rows, width))
        blocks = launch_blocks(KERNEL_BWD, rows)
        dx = None if form == EXIT else torch.empty_like(x)
        dout = None if form == ENTRY else torch.empty_like(out)
        partial = torch.empty((blocks, norms, width), dtype=torch.float32,
                              device=rstd.device)
        dw = torch.empty((norms, width), dtype=torch.float32,
                         device=rstd.device)
        _build.launch(KERNEL_BWD, rstd.device, x, out, w0, w1, rstd, dres,
                      dy, dx, dout, partial, dw, form,
                      int(ctx.dtype == torch.bfloat16), rows, width, blocks)
        if form == EXIT:
            dx = dres    # d h: the stream's gradient passes the add as it is
        return (None, dx, dout, dw[0], dw[1] if form == MIDDLE else None,
                None, None)


def _width(what: str, width: int, device) -> None:
    widest = SPANS * 8 * BLOCK_THREADS
    _build.check_device(what, device, width % 8 == 0 and width <= widest,
                        f"width {width} (a multiple of 8 up to {widest})")


def _operands(what: str, x, weights, others=()) -> None:
    """Check ``x`` ``(T, E)`` f32, the ``(E,)`` f32 ``weights`` and
    ``others``, each ``(T, E)`` (both ``(name, tensor)`` pairs, the
    others with their dtype); a width the kernels do not take raises on a
    card."""
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (T, E), got {tuple(x.shape)}")
    rows, width = x.shape
    _width(what, width, x.device)
    _build.check_operand(what, "x", x, torch.float32, (rows, width))
    for name, t, dtype, shape in (
            [(n, t, torch.float32, (width,)) for n, t in weights]
            + [(n, t, dtype, (rows, width)) for n, t, dtype in others]):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
        _build.check_operand(what, name, t, dtype, shape)


def entry_norm(x, w, eps: float, dtype=torch.bfloat16):
    """``(x, xn)``: the residual stream ``x`` ``(T, E)`` f32 passed on and
    ``xn = rms(x) * w`` rounded to bf16, from the norm's weight ``w``
    ``(E,)`` f32 (``dtype``: the compute dtype, bf16). Differentiable in
    ``x`` and ``w``."""
    if dtype != torch.bfloat16:
        raise TypeError(f"residual_norm entry: rounds to torch.bfloat16, "
                        f"not {dtype}")
    _operands("residual_norm entry", x, [("w", w)])
    return _Junction.apply(ENTRY, x, None, w, None, eps, dtype)


def middle_norm(x, out, w_post, w_pre, eps: float, dtype):
    """``(h, yn)``: ``h = x + rms(out) * w_post`` f32 and ``yn = rms(h) *
    w_pre`` in ``dtype`` (bf16 or f32), each ``(T, E)``, from the residual
    stream ``x`` f32 and the sublayer's product ``out`` bf16. Differentiable
    in ``x``, ``out`` and both weights."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"residual_norm middle: yn is bf16 or f32, not "
                        f"{dtype}")
    _operands("residual_norm middle", x, [("w_post", w_post),
                                          ("w_pre", w_pre)],
              [("out", out, torch.bfloat16)])
    return _Junction.apply(MIDDLE, x, out, w_post, w_pre, eps, dtype)


def exit_norm(h, out, w, eps: float):
    """``h + rms(out) * w`` f32 ``(T, E)`` from the residual stream ``h``
    and the sublayer's output ``out``, both f32. Differentiable in all
    three."""
    _operands("residual_norm exit", h, [("w", w)],
              [("out", out, torch.float32)])
    return _Junction.apply(EXIT, h, out, w, None, eps, torch.float32)
