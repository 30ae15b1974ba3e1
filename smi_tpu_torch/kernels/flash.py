"""Flash-attention forward for the ring-attention schedule.

PyTorch counterpart of the forward half of :mod:`smi_tpu.kernels.flash`.
Two kernels with the JAX package's contracts and layouts:

- :func:`flash_attend_fused` attends the whole K/V extent in one launch
  and returns ``(out, m, l)``: the normalised output in q's dtype and the
  softmax statistics as ``(H, 1, Sq)`` f32 rows, the backward's residuals.
  The ring takes it when it has one rank.
- :func:`flash_block_attend` folds one K/V block into the carried
  ``(m, l, acc)`` with global ``q_off``/``k_off`` positions: one launch
  per ring step.

Both launch ``csrc/flash_fwd.cu`` for CUDA tensors and run their plain
PyTorch versions (:func:`flash_attend_fused_plain`,
:func:`flash_block_attend_plain`) only for CPU tensors. Layouts are
head-major: q ``(H, Sq, D)``, k/v ``(H_kv, Sk, D)`` with ``H_kv`` dividing
``H`` (grouped-query attention), acc ``(H, Sq, D)`` f32.

Masked scores count as ``-inf`` in both the kernel and its plain
version, so a masked key adds exactly nothing: a row with no live key
keeps ``(NEG_INF, 0, 0)``, and a block wholly in the causal future or
outside the window leaves the carry bit for bit as it came in. (The JAX
package instead lets such rows gather transient garbage that the first
live key's correction zeroes; the two agree on every row that has a
live key, and on the final output of every ring.)

f32 runs in full f32 (no TF32), as the reference runs at HIGHEST
precision; bf16 multiplies in bf16 with f32 accumulation, and the
probabilities are rounded to V's dtype before the P·V product.
``precision`` is accepted so the signatures match and changes nothing.
The TPU tile targets, chunk budgets and the 128-lane statistics layout
have no counterpart: :func:`_plan` sizes the tile to Hopper shared memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from smi_tpu_torch.kernels import _build

NEG_INF = -1e30

KERNEL_FUSED = "flash_fused"
KERNEL_BLOCK = "flash_block"

#: dynamic shared memory one H100 block may use (227 KB)
SMEM_BYTES_LIMIT = 232_448

#: query rows per CUDA block: 4 warps of 16 rows (``kBlockQ``)
BLOCK_Q = 64

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128, 256)

#: dtype -> (key rows per tile, shared-memory row pad in elements), as
#: ``TileOf`` in ``csrc/flash_fwd.cu``
_TILE = {torch.float32: (32, 4), torch.bfloat16: (64, 8)}

#: dtype code of the C entry points
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: score elements one plain-version step may hold (1 GiB of f32): the
#: plain versions walk the query rows in chunks under this budget
PLAIN_SCORE_ELEMS = 1 << 28


def _gqa_group(h: int, h_kv: int) -> int:
    """Validated query-heads-per-KV-head group factor."""
    if h_kv < 1 or h % h_kv:
        raise ValueError(f"kv heads {h_kv} must divide query heads {h}")
    return h // h_kv


def _validate_window(causal: bool, window) -> None:
    if window is None:
        return
    if not causal:
        raise ValueError("sliding window requires causal attention")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def smem_bytes(d: int, dtype) -> int:
    """Dynamic shared memory of one block: the Q tile and one K and one
    V tile, rows padded by 16 bytes, plus (f32 only) each warp's
    ``16 x (block_k + 4)`` f32 probability buffer."""
    block_k, pad = _TILE[dtype]
    item = torch.empty((), dtype=dtype).element_size()
    tiles = (BLOCK_Q + 2 * block_k) * (d + pad) * item
    probs = 4 * 16 * (block_k + 4) * 4 if dtype == torch.float32 else 0
    return tiles + probs


def _plan(d: int, dtype) -> Optional[Tuple[int, int]]:
    """``(block_q, block_k)`` of the kernel for head dim ``d``, or None
    where it has no instantiation or its tiles would not fit shared
    memory."""
    if dtype not in _TILE or d not in HEAD_DIMS:
        return None
    if smem_bytes(d, dtype) > SMEM_BYTES_LIMIT:
        return None
    return BLOCK_Q, _TILE[dtype][0]


def flash_supported(s_q: int, s_k: int, d: int, dtype) -> bool:
    """Whether the CUDA kernel takes these shapes: f32 or bf16, a head
    dim it is instantiated for, and non-empty extents (ragged tiles are
    masked in the kernel, so any length goes)."""
    return s_q >= 1 and s_k >= 1 and _plan(d, dtype) is not None


def check_operands(what: str, q, k, v, state=()) -> Tuple[int, int, int, int]:
    """Raise unless q/k/v (and the carried ``state``, name-tensor pairs)
    are contiguous tensors of the kernel's dtypes and layouts on one
    device. Returns ``(h, h_kv, s_q, s_k)``."""
    named = (("q", q), ("k", k), ("v", v), *state)
    for name, t in named:
        if not torch.is_tensor(t):
            raise TypeError(f"{what}: {name} must be a tensor")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in _TILE:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} must be {q.dtype} like q, got "
                            f"{t.dtype}")
    for name, t in state:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"{what}: q and k must be 3-D (heads, rows, dim), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    h, s_q, d = q.shape
    h_kv, s_k, _ = k.shape
    _gqa_group(h, h_kv)
    shapes = {"k": (h_kv, s_k, d), "v": (h_kv, s_k, d), "m": (h, 1, s_q),
              "l": (h, 1, s_q), "acc": (h, s_q, d)}
    for name, t in named[1:]:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} must have shape "
                             f"{shapes[name]}, got {tuple(t.shape)}")
    if q.device.type == "cuda":
        if not flash_supported(s_q, s_k, d, q.dtype):
            raise ValueError(
                f"{what}: the CUDA kernel does not take Sq={s_q}, Sk={s_k}, "
                f"head dim {d} (head dims {HEAD_DIMS})"
            )
        for name, t in named:
            if t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be 16-byte aligned")
    elif q.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for {q.device}")
    return h, h_kv, s_q, s_k


def _dead_keys(s_q, s_k, q_off, k_off, causal, window, device):
    """``(Sq, Sk)`` bool: True where the key is masked for the query."""
    q_pos = q_off + torch.arange(s_q, device=device)[:, None]
    k_pos = k_off + torch.arange(s_k, device=device)[None, :]
    dead = torch.zeros((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        dead |= k_pos > q_pos
    if window is not None:
        dead |= k_pos < q_pos - (window - 1)
    return dead


def _fold_plain(q, k, v, m, l, acc, q_off, k_off, causal, scale, window):
    """The fold in PyTorch ops, query rows in chunks of at most
    :data:`PLAIN_SCORE_ELEMS` scores (the rows are independent)."""
    h, s_q, _ = q.shape
    s_k = k.shape[1]
    group = h // k.shape[0]
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.repeat_interleave(group, dim=0)
    rows = max(1, PLAIN_SCORE_ELEMS // (h * s_k))
    outs = []
    for r0 in range(0, s_q, rows):
        r1 = min(s_q, r0 + rows)
        s = torch.matmul(q[:, r0:r1].float(), kf.transpose(1, 2)) * scale
        dead = _dead_keys(r1 - r0, s_k, q_off + r0, k_off, causal, window,
                          q.device)
        s = s.masked_fill(dead, float("-inf"))
        m_prev = m[:, :, r0:r1].transpose(1, 2)              # (H, r, 1)
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new)                             # 0 where dead
        l_new = l[:, :, r0:r1].transpose(1, 2) * alpha + p.sum(-1, True)
        pv = torch.matmul(p.to(v.dtype).float(), vf.float())
        acc_new = acc[:, r0:r1] * alpha + pv
        outs.append((m_new.transpose(1, 2), l_new.transpose(1, 2), acc_new))
    m_o, l_o, acc_o = (torch.cat(parts, dim=-1 if i < 2 else 1)
                       for i, parts in enumerate(zip(*outs)))
    return m_o.contiguous(), l_o.contiguous(), acc_o.contiguous()


def fresh_state(h: int, s_q: int, d: int, device):
    """``(m, l, acc)`` before any fold: ``(NEG_INF, 0, 0)``, in f32
    whatever the inputs' dtype."""
    return (torch.full((h, 1, s_q), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((h, 1, s_q), dtype=torch.float32, device=device),
            torch.zeros((h, s_q, d), dtype=torch.float32, device=device))


def flash_block_attend_plain(q, k, v, m, l, acc, q_off, k_off, causal: bool,
                             scale: float, precision=None,
                             window: Optional[int] = None):
    """:func:`flash_block_attend` in PyTorch ops: the kernel's plain
    version. Returns ``(m, l, acc)``."""
    _validate_window(causal, window)
    return _fold_plain(q, k, v, m, l, acc, int(q_off), int(k_off), causal,
                       scale, window)


def flash_attend_fused_plain(q, k, v, q_off, k_off, causal: bool,
                             scale: float, precision=None,
                             window: Optional[int] = None):
    """:func:`flash_attend_fused` in PyTorch ops: the kernel's plain
    version. Returns ``(out, m, l)``."""
    _validate_window(causal, window)
    h, s_q, d = q.shape
    m, l, acc = _fold_plain(q, k, v, *fresh_state(h, s_q, d, q.device),
                            int(q_off), int(k_off), causal, scale, window)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe_l.transpose(1, 2)).to(q.dtype)
    return out, m, l


def _launch(kernel: str, q, pointers, ints, scale: float) -> None:
    block_q, block_k = _plan(q.shape[2], q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.entry(kernel)(
            *(t.data_ptr() for t in pointers), _DTYPE_CODE[q.dtype], *ints,
            float(scale), block_q, block_k, stream,
        )
    _build.check(kernel, status)
    _build.LAUNCHES[kernel] += 1


def _int32(what: str, name: str, x) -> int:
    x = int(x)
    if not -(1 << 31) <= x < (1 << 31):
        raise ValueError(f"{what}: {name}={x} does not fit 32 bits")
    return x


def flash_attend_fused(q, k, v, q_off, k_off, causal: bool, scale: float,
                       precision=None, window: Optional[int] = None):
    """Whole-extent attention in one launch: ``(out, m, l)``.

    ``out`` is normalised and in ``q.dtype``; ``m``/``l`` are
    ``(H, 1, Sq)`` f32 rows. Launches ``csrc/flash_fwd.cu`` for CUDA
    tensors and raises on shapes or dtypes it does not take."""
    _validate_window(causal, window)
    h, h_kv, s_q, s_k = check_operands("flash_attend_fused", q, k, v)
    if q.device.type == "cpu":
        return flash_attend_fused_plain(q, k, v, q_off, k_off, causal, scale,
                                        precision, window)
    what = "flash_attend_fused"
    out = torch.empty_like(q)
    m = torch.empty((h, 1, s_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch(KERNEL_FUSED, q, (q, k, v, out, m, l),
            (h, h_kv, s_q, s_k, q.shape[2], _int32(what, "q_off", q_off),
             _int32(what, "k_off", k_off), int(causal),
             _int32(what, "window", window or 0)), scale)
    return out, m, l


def flash_block_attend(q, k, v, m, l, acc, q_off, k_off, causal: bool,
                       scale: float, precision=None,
                       window: Optional[int] = None):
    """Fold one K/V block into the online-softmax carry: ``(m, l, acc)``.

    ``m``/``l`` are ``(H, 1, Sq)`` f32 rows, ``acc`` ``(H, Sq, D)`` f32;
    the results are new tensors. Launches ``csrc/flash_fwd.cu`` for CUDA
    tensors and raises on shapes or dtypes it does not take."""
    _validate_window(causal, window)
    h, h_kv, s_q, s_k = check_operands(
        "flash_block_attend", q, k, v, (("m", m), ("l", l), ("acc", acc)))
    if q.device.type == "cpu":
        return flash_block_attend_plain(q, k, v, m, l, acc, q_off, k_off,
                                        causal, scale, precision, window)
    what = "flash_block_attend"
    m_out, l_out, acc_out = (torch.empty_like(m), torch.empty_like(l),
                             torch.empty_like(acc))
    _launch(KERNEL_BLOCK, q, (q, k, v, m, l, acc, m_out, l_out, acc_out),
            (h, h_kv, s_q, s_k, q.shape[2], _int32(what, "q_off", q_off),
             _int32(what, "k_off", k_off), int(causal),
             _int32(what, "window", window or 0)), scale)
    return m_out, l_out, acc_out

