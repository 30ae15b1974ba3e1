"""Flash attention for the ring-attention schedule, forward and backward.

PyTorch counterpart of :mod:`smi_tpu.kernels.flash`. Four kernels with
the JAX package's contracts and layouts:

- :func:`flash_attend_fused` attends the whole K/V extent in one launch
  and returns ``(out, m, l)``: the normalised output in q's dtype and the
  softmax statistics as ``(H, 1, Sq)`` f32 rows, the backward's residuals.
  The ring takes it when it has one rank.
- :func:`flash_block_attend` folds one K/V block into the carried
  ``(m, l, acc)`` with global ``q_off``/``k_off`` positions: one launch
  per ring step.
- :func:`flash_block_backward_dq` and :func:`flash_block_backward_dkdv`
  are the FlashAttention-2 backward of one K/V block: dq, and (dk, dv)
  with the GQA group reduced in the kernel, recomputed from the saved
  ``m``, ``linv = 1/l`` and ``delta = rowsum(dout * out)``. One launch of
  each per ring step.

The forward pair launches ``csrc/flash_fwd.cu``, the backward pair
``csrc/flash_bwd.cu``, for CUDA tensors; each runs its plain PyTorch
version (the ``*_plain`` functions) only for CPU tensors. Layouts are
head-major: q ``(H, Sq, D)``, k ``(H_kv, Sk, D)`` and v ``(H_kv, Sk,
Dv)`` with ``H_kv`` dividing ``H`` (grouped-query attention); out, acc
and dout ``(H, Sq, Dv)``, dq ``(H, Sq, D)`` f32, dk ``(H_kv, Sk, D)`` and
dv ``(H_kv, Sk, Dv)`` f32. Q and K share a head dim, V may have its own:
the kernels take ``D = Dv`` in :data:`HEAD_DIMS` and, in bf16, the forms
of :data:`SPLIT_HEAD_DIMS` (DeepSeek-V3's latent attention, 192 against
128); a launch of such a form counts under its own name
(:func:`launch_name`).

Masked scores count as ``-inf`` in both the kernel and its plain
version, so a masked key adds exactly nothing: a row with no live key
keeps ``(NEG_INF, 0, 0)``, and a block wholly in the causal future or
outside the window leaves the carry bit for bit as it came in. (The JAX
package instead lets such rows gather transient garbage that the first
live key's correction zeroes; the two agree on every row that has a
live key, and on the final output of every ring.)

f32 runs in full f32 (no TF32), as the reference runs at HIGHEST
precision; bf16 multiplies in bf16 with f32 accumulation, and rounds
where the reference rounds: the probabilities to V's dtype before P·V,
and in the backward dS to K's dtype before dS·K, P^T to dout's dtype
before P^T·dout and dS^T to q's dtype before dS^T·Q. ``precision`` is
accepted so the signatures match and changes nothing. The TPU tile
targets, chunk budgets and the 128-lane statistics layout have no
counterpart: :func:`_plan` and :func:`_bwd_plan` size the tiles to Hopper
shared memory, and the forward asks the plan engine only to confirm its
pair (:func:`fwd_plan_explained`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from smi_tpu_torch.kernels import _build

NEG_INF = -1e30

KERNEL_FUSED = "flash_fused"
KERNEL_BLOCK = "flash_block"
KERNEL_BWD_DQ = "flash_bwd_dq"
KERNEL_BWD_DKDV = "flash_bwd_dkdv"

#: head dims the kernels are instantiated for, Q, K and V alike
HEAD_DIMS = (64, 128, 256)

#: ``(D, Dv)`` forms with V narrower than Q and K, instantiated in bf16
#: alone: DeepSeek-V3's latent attention (128 dims without positions and
#: 64 rotated ones against 128-wide values)
SPLIT_HEAD_DIMS = ((192, 128),)

#: query rows per forward block (``BQ`` of ``Bf16Plan``/``F32Plan`` in
#: ``csrc/flash_fwd.cu``): two consumer warpgroups of 64 rows in bf16,
#: 256 threads of 8 rows in f32
BLOCK_Q = 128

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


def has_form(d: int, dtype, d_v: Optional[int] = None) -> bool:
    """Whether the kernels are instantiated for head dims ``(d, d_v)``
    (``d_v`` None: ``d``) in ``dtype``."""
    d_v = d if d_v is None else d_v
    if dtype not in _DTYPE_CODE:
        return False
    if d == d_v:
        return d in HEAD_DIMS
    return dtype == torch.bfloat16 and (d, d_v) in SPLIT_HEAD_DIMS


def launch_name(kernel: str, d: int, d_v: int) -> str:
    """The ``_build.LAUNCHES`` name of a launch of ``kernel`` at head dims
    ``(d, d_v)``: the kernel's own where they agree, else
    ``<kernel>_<d>x<d_v>`` (a split form, counted apart)."""
    return kernel if d == d_v else f"{kernel}_{d}x{d_v}"


def _block_k(d: int, dtype) -> int:
    """Keys per forward tile: bf16 128 (64 at D=256), f32 64 (32 at
    D=256), as ``BK`` in ``csrc/flash_fwd.cu``."""
    full = 128 if dtype == torch.bfloat16 else 64
    return full // 2 if d == 256 else full


def smem_bytes(d: int, dtype, d_v: Optional[int] = None) -> int:
    """Dynamic shared memory of one forward block, as ``kSmem`` in
    ``csrc/flash_fwd.cu`` sums it. bf16: 1024 bytes to align the base to
    the 128-byte swizzle's period, the Q tile, two stages of one K and
    one V tile (unpadded: TMA swizzles) and 64 bytes of mbarriers. f32:
    the Q tile and one K and one V tile, rows padded by 16 bytes, and the
    ``BLOCK_Q x (block_k + 16)`` probability tile."""
    d_v = d if d_v is None else d_v
    block_k = _block_k(d, dtype)
    if dtype == torch.bfloat16:
        return 1024 + BLOCK_Q * d * 2 + 2 * block_k * (d + d_v) * 2 + 64
    return 4 * ((BLOCK_Q + 2 * block_k) * (d + 4)
                + BLOCK_Q * (block_k + 16))


def _plan(d: int, dtype, d_v: Optional[int] = None
          ) -> Optional[Tuple[int, int]]:
    """``(block_q, block_k)`` of the forward kernel for head dims ``(d,
    d_v)``, or None where it has no instantiation or its tiles would not
    fit shared memory. The (192, 128) form tiles as D=128 does: 128-key
    tiles, two stages of a 192-wide K and a 128-wide V tile."""
    if not has_form(d, dtype, d_v):
        return None
    if smem_bytes(d, dtype, d_v) > _build.SMEM_BYTES_LIMIT:
        return None
    return BLOCK_Q, _block_k(d, dtype)


def fwd_plan_explained(d: int, dtype,
                       window: Optional[int] = None,
                       d_v: Optional[int] = None,
                       ) -> Tuple[Optional[Tuple[int, int]], str]:
    """``(plan, layer)`` of the forward kernels: the plan engine's tile
    pair (``planned_flash_blocks``, layer ``"cache"``) where its cache
    entry names the pair the kernel compiles for this dtype and head dim,
    else :func:`_plan` (layer ``"heuristic"``). The kernels compile one
    pair a dtype and head dims, so an entry naming any other pair, the
    v5e's seeded (1024, 1024) among them, leaves the plan as it is,
    without an error. A split form ``(d, d_v)`` has no cache entry: its
    plan is :func:`_plan`'s."""
    plan = _plan(d, dtype, d_v)
    if d_v is not None and d_v != d:
        return plan, "heuristic"
    try:
        from smi_tpu_torch.tuning.engine import (
            dtype_name,
            planned_flash_blocks,
        )

        got = planned_flash_blocks(dtype_name(dtype), window is not None)
    except Exception:
        got = None
    if got is not None and plan is not None and tuple(got) == plan:
        return plan, "cache"
    return plan, "heuristic"


#: the backward's tiles, as ``csrc/flash_bwd.cu`` has them (``DqBf16``,
#: ``DkdvBf16``, ``DqF32``, ``DkdvF32``). dq: a block owns ``block_q``
#: query rows and walks key tiles of ``block_k`` rows; dkdv: a block owns
#: ``block_k`` keys and walks query tiles of ``block_q`` rows. bf16 dkdv
#: has a 64-key form (``kSplit``) for launches that would leave most SMs
#: idle, where ``D = Dv``.
BWD_BLOCK_Q = 128
BWD_BLOCK_K = 128


def _bwd_tiles(kernel: str, d: int, dtype, split: bool = False,
               d_v: Optional[int] = None) -> Tuple[int, int]:
    """``(block_q, block_k)`` of a backward kernel's tiles. bf16 dkdv at
    D=256 and at a split form walks query tiles of 32 a warpgroup: at
    (192, 128) dK and dV take 160 registers a thread across the loop."""
    d_v = d if d_v is None else d_v
    if dtype == torch.bfloat16:
        if kernel == KERNEL_BWD_DQ:
            return BWD_BLOCK_Q, 32 if d == 256 else 64
        qn = 32 if d == 256 or d != d_v else 64   # queries a warpgroup a tile
        return (2 * qn, 64) if split else (qn, BWD_BLOCK_K)
    if kernel == KERNEL_BWD_DQ:
        return (64 if d == 256 else BWD_BLOCK_Q), 32
    return 32, (32 if d == 256 else BWD_BLOCK_K)


def bwd_smem_bytes(kernel: str, d: int, dtype, split: bool = False,
                   d_v: Optional[int] = None) -> int:
    """Dynamic shared memory of one backward block, as ``kSmem`` in
    ``csrc/flash_bwd.cu`` sums it. bf16 (tiles unpadded: TMA swizzles):
    1024 bytes to align the base to the 128-byte swizzle's period, the
    block's own rows (dq: Q and dO; dkdv: K and V), two stages of the
    streamed tiles (dq: K and V; dkdv: Q and dO, with their three f32
    statistic rows) and 64 bytes of mbarriers; Q and K rows are ``d``
    wide, V and dO rows ``d_v``. f32 (rows padded by 16 bytes): dq holds
    Q and dO, one K and one V tile and the dS tile; dkdv holds K and V,
    one Q and one dO tile with their statistics, and the P^T and dS^T
    tiles (rows of ``block_q + 16`` floats)."""
    d_v = d if d_v is None else d_v
    block_q, block_k = _bwd_tiles(kernel, d, dtype, split, d_v)
    dq = kernel == KERNEL_BWD_DQ
    if dtype == torch.bfloat16:
        own, streamed = (block_q, block_k) if dq else (block_k, block_q)
        stats = 0 if dq else 2 * 3 * block_q * 4
        return (1024 + own * (d + d_v) * 2 + 2 * streamed * (d + d_v) * 2
                + stats + 64)
    ld = d + 4
    if dq:
        return 4 * (2 * block_q * ld + 2 * block_k * ld
                    + block_q * (block_k + 16))
    return 4 * (2 * block_k * ld + 2 * block_q * ld + 3 * block_q
                + 2 * block_k * (block_q + 16))


def bwd_blocks(kernel: str, plan: Tuple[int, int], h: int, h_kv: int,
               s_q: int, s_k: int, d: int) -> int:
    """Blocks of one backward launch on ``plan``, as the C entry points
    size the grid: dq one a (query block, head); dkdv one a (key block,
    K/V head, half of the output columns at D=256)."""
    block_q, block_k = plan
    if kernel == KERNEL_BWD_DQ:
        return -(-s_q // block_q) * h
    return -(-s_k // block_k) * h_kv * (2 if d == 256 else 1)


def _bwd_plan(kernel: str, d: int, dtype, s_k: Optional[int] = None,
              h_kv: Optional[int] = None,
              sms: int = _build.SMS,
              d_v: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """``(block_q, block_k)`` of a backward kernel for head dims ``(d,
    d_v)``, or None where it has no instantiation or would not fit shared
    memory. Given ``s_k`` and ``h_kv``, bf16 dkdv with ``d = d_v`` takes
    its 64-key form where twice its 128-key blocks still fit one wave of
    ``sms`` (the 64-key form halves each block's work and doubles the
    blocks, which helps only where the doubled grid leaves no SM a second
    block). A split form takes the 128-key form alone: dq 128 query rows
    a block and 64-key tiles, dkdv 128 keys a block and 32-row query
    tiles."""
    if not has_form(d, dtype, d_v):
        return None
    split = (kernel == KERNEL_BWD_DKDV and dtype == torch.bfloat16
             and d_v in (None, d) and s_k is not None
             and 2 * bwd_blocks(kernel, _bwd_tiles(kernel, d, dtype),
                                h_kv, h_kv, 0, s_k, d) <= sms)
    if bwd_smem_bytes(kernel, d, dtype, split, d_v) > \
            _build.SMEM_BYTES_LIMIT:
        return None
    return _bwd_tiles(kernel, d, dtype, split, d_v)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_supported(s_q: int, s_k: int, d: int, dtype,
                    d_v: Optional[int] = None) -> bool:
    """Whether the CUDA kernels, forward and backward, take these shapes:
    f32 or bf16, head dims ``(d, d_v)`` they are instantiated for
    (:func:`has_form`), and non-empty extents (ragged tiles are masked in
    the kernels, so any length goes)."""
    return (s_q >= 1 and s_k >= 1 and _plan(d, dtype, d_v) is not None
            and _bwd_plan(KERNEL_BWD_DQ, d, dtype, d_v=d_v) is not None
            and _bwd_plan(KERNEL_BWD_DKDV, d, dtype, d_v=d_v) is not None)


def check_operands(what: str, q, k, v, state=(),
                   dout=None) -> Tuple[int, int, int, int]:
    """Raise unless q/k/v (with ``dout`` in q's dtype and v's layout, and
    the f32 ``state``, name-tensor pairs: the carry or the saved
    statistics) are contiguous tensors of the kernels' dtypes and layouts
    on one device. Returns ``(h, h_kv, s_q, s_k)``."""
    grads = () if dout is None else (("dout", dout),)
    named = (("q", q), ("k", k), ("v", v), *grads, *state)
    for name, t in named:
        if not torch.is_tensor(t):
            raise TypeError(f"{what}: {name} must be a tensor")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v), *grads):
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} must be {q.dtype} like q, got "
                            f"{t.dtype}")
    for name, t in state:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{what}: q, k and v must be 3-D (heads, rows, "
                         f"dim), got {tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    h, s_q, d = q.shape
    h_kv, s_k, _ = k.shape
    d_v = v.shape[2]
    _gqa_group(h, h_kv)
    row = (h, 1, s_q)
    shapes = {"k": (h_kv, s_k, d), "v": (h_kv, s_k, d_v),
              "dout": (h, s_q, d_v), "m": row, "l": row, "linv": row,
              "delta": row, "acc": (h, s_q, d_v)}
    for name, t in named[1:]:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} must have shape "
                             f"{shapes[name]}, got {tuple(t.shape)}")
    if q.device.type == "cuda":
        if not flash_supported(s_q, s_k, d, q.dtype, d_v):
            raise ValueError(
                f"{what}: the CUDA kernel does not take Sq={s_q}, Sk={s_k}, "
                f"head dims ({d}, {d_v}) in {q.dtype} (head dims "
                f"{HEAD_DIMS}; bf16 also {SPLIT_HEAD_DIMS})"
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
    whatever the inputs' dtype; ``d`` is V's head dim (acc's width)."""
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
    h, s_q, _ = q.shape
    m, l, acc = _fold_plain(q, k, v,
                            *fresh_state(h, s_q, v.shape[2], q.device),
                            int(q_off), int(k_off), causal, scale, window)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe_l.transpose(1, 2)).to(q.dtype)
    return out, m, l


def _launch(kernel: str, q, v, pointers, ints, scale: float, plan) -> None:
    _build.launch(launch_name(kernel, q.shape[2], v.shape[2]), q.device,
                  *(t.data_ptr() for t in pointers), _DTYPE_CODE[q.dtype],
                  *ints, float(scale), *plan)


def _int32(what: str, name: str, x) -> int:
    x = int(x)
    if not -(1 << 31) <= x < (1 << 31):
        raise ValueError(f"{what}: {name}={x} does not fit 32 bits")
    return x


def _shape_ints(what, q, k, v, q_off, k_off, causal, window):
    """The C entry points' ``h, h_kv, s_q, s_k, d, d_v, q_off, k_off,
    causal, window`` (window 0: none)."""
    h, s_q, d = q.shape
    h_kv, s_k, _ = k.shape
    return (h, h_kv, s_q, s_k, d, v.shape[2], _int32(what, "q_off", q_off),
            _int32(what, "k_off", k_off), int(causal),
            _int32(what, "window", window or 0))


def flash_attend_fused(q, k, v, q_off, k_off, causal: bool, scale: float,
                       precision=None, window: Optional[int] = None):
    """Whole-extent attention in one launch: ``(out, m, l)``.

    ``out`` ``(H, Sq, Dv)`` is normalised and in ``q.dtype``; ``m``/``l`` are
    ``(H, 1, Sq)`` f32 rows. Launches ``csrc/flash_fwd.cu`` for CUDA
    tensors and raises on shapes or dtypes it does not take."""
    _validate_window(causal, window)
    what = "flash_attend_fused"
    h, _, s_q, _ = check_operands(what, q, k, v)
    if q.device.type == "cpu":
        return flash_attend_fused_plain(q, k, v, q_off, k_off, causal, scale,
                                        precision, window)
    out = torch.empty((h, s_q, v.shape[2]), dtype=q.dtype, device=q.device)
    m = torch.empty((h, 1, s_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch(KERNEL_FUSED, q, v, (q, k, v, out, m, l),
            _shape_ints(what, q, k, v, q_off, k_off, causal, window), scale,
            fwd_plan_explained(q.shape[2], q.dtype, window, v.shape[2])[0])
    return out, m, l


def flash_block_attend(q, k, v, m, l, acc, q_off, k_off, causal: bool,
                       scale: float, precision=None,
                       window: Optional[int] = None):
    """Fold one K/V block into the online-softmax carry: ``(m, l, acc)``.

    ``m``/``l`` are ``(H, 1, Sq)`` f32 rows, ``acc`` ``(H, Sq, Dv)`` f32;
    the results are new tensors. Launches ``csrc/flash_fwd.cu`` for CUDA
    tensors and raises on shapes or dtypes it does not take."""
    _validate_window(causal, window)
    what = "flash_block_attend"
    check_operands(what, q, k, v, (("m", m), ("l", l), ("acc", acc)))
    if q.device.type == "cpu":
        return flash_block_attend_plain(q, k, v, m, l, acc, q_off, k_off,
                                        causal, scale, precision, window)
    m_out, l_out, acc_out = (torch.empty_like(m), torch.empty_like(l),
                             torch.empty_like(acc))
    _launch(KERNEL_BLOCK, q, v, (q, k, v, m, l, acc, m_out, l_out, acc_out),
            _shape_ints(what, q, k, v, q_off, k_off, causal, window), scale,
            fwd_plan_explained(q.shape[2], q.dtype, window, v.shape[2])[0])
    return m_out, l_out, acc_out


# ---------------------------------------------------------------------
# Backward (FlashAttention-2): the probabilities are recomputed from the
# saved statistics, so nothing quadratic is stored. dq accumulates over
# key tiles per query block; dk/dv over query tiles per key block, for
# every query head of the K/V head's group. The ring-level backward
# (the gradients riding the ring home) is models/ring_attention.py.
# ---------------------------------------------------------------------


def _bwd_chunks(q, kf, vf, dout, m, linv, delta, q_off, k_off, causal,
                scale, window):
    """Yield ``(r0, r1, p, ds)`` over chunks of query rows under
    :data:`PLAIN_SCORE_ELEMS` scores: the recomputed probabilities
    ``P = exp(S - m) * linv`` and ``dS = P * (dout V^T - delta)``, f32
    ``(H, r, Sk)``, 0 where masked (by a select: ``exp(S - m)`` is inf
    on a row that no key reached). ``kf``/``vf`` are K and V widened to
    f32 and repeated over the GQA group."""
    h, s_q, _ = q.shape
    s_k = kf.shape[1]
    rows = max(1, PLAIN_SCORE_ELEMS // (h * s_k))
    for r0 in range(0, s_q, rows):
        r1 = min(s_q, r0 + rows)
        s = torch.matmul(q[:, r0:r1].float(), kf.transpose(1, 2)) * scale
        p = torch.exp(s - m[:, 0, r0:r1, None]) * linv[:, 0, r0:r1, None]
        del s
        dead = _dead_keys(r1 - r0, s_k, q_off + r0, k_off, causal, window,
                          q.device)
        p = p.masked_fill(dead, 0.0)
        dp = torch.matmul(dout[:, r0:r1].float(), vf.transpose(1, 2))
        yield r0, r1, p, p * (dp - delta[:, 0, r0:r1, None])


def _repeat_kv(k, v, group: int):
    return (x.float().repeat_interleave(group, dim=0) for x in (k, v))


def backward_rows(out, l, dout):
    """The backward kernels' row operands from a forward's ``out`` and
    ``l`` and the output gradient ``dout`` (head-major, ``(H, Sq, D)``):
    ``linv = 1/l``, with rows that no key reached mapped to 1, and
    ``delta = rowsum(dout * out)`` from ``out`` in q's dtype (in bf16 the
    rounded output, as the reference forms it); both ``(H, 1, Sq)`` f32."""
    linv = 1.0 / torch.where(l == 0.0, torch.ones_like(l), l)
    delta = (dout.float() * out.float()).sum(-1)[:, None]
    return linv, delta.contiguous()


def flash_block_backward_dq_plain(q, k, v, dout, m, linv, delta, q_off,
                                  k_off, causal: bool, scale: float,
                                  precision=None,
                                  window: Optional[int] = None):
    """:func:`flash_block_backward_dq` in PyTorch ops: the kernel's plain
    version. Returns dq ``(H, Sq, D)`` f32; dS is rounded to K's dtype
    before ``dS K``, as the reference rounds it."""
    _validate_window(causal, window)
    kf, vf = _repeat_kv(k, v, q.shape[0] // k.shape[0])
    parts = [torch.matmul(ds.to(k.dtype).float(), kf) * scale
             for _, _, _, ds in _bwd_chunks(q, kf, vf, dout, m, linv, delta,
                                            int(q_off), int(k_off), causal,
                                            scale, window)]
    return torch.cat(parts, dim=1).contiguous()


def flash_block_backward_dkdv_plain(q, k, v, dout, m, linv, delta, q_off,
                                    k_off, causal: bool, scale: float,
                                    precision=None,
                                    window: Optional[int] = None):
    """:func:`flash_block_backward_dkdv` in PyTorch ops: the kernel's
    plain version. Returns ``(dk, dv)``, ``(H_kv, Sk, D)`` and ``(H_kv,
    Sk, Dv)`` f32, summed over each K/V head's group of query heads; P^T
    is rounded to dout's dtype before ``P^T dout`` and dS^T to q's before
    ``dS^T Q``."""
    _validate_window(causal, window)
    h, _, d = q.shape
    h_kv, s_k, _ = k.shape
    d_v = v.shape[2]
    group = h // h_kv
    kf, vf = _repeat_kv(k, v, group)
    dk = torch.zeros((h, s_k, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((h, s_k, d_v), dtype=torch.float32, device=q.device)
    for r0, r1, p, ds in _bwd_chunks(q, kf, vf, dout, m, linv, delta,
                                     int(q_off), int(k_off), causal, scale,
                                     window):
        dv += torch.matmul(p.to(dout.dtype).float().transpose(1, 2),
                           dout[:, r0:r1].float())
        dk += torch.matmul(ds.to(q.dtype).float().transpose(1, 2),
                           q[:, r0:r1].float())
    return ((dk * scale).view(h_kv, group, s_k, d).sum(1).contiguous(),
            dv.view(h_kv, group, s_k, d_v).sum(1).contiguous())


def _bwd_operands(what, q, k, v, dout, m, linv, delta, causal, window):
    _validate_window(causal, window)
    return check_operands(what, q, k, v,
                          (("m", m), ("linv", linv), ("delta", delta)),
                          dout=dout)


def flash_block_backward_dq(q, k, v, dout, m, linv, delta, q_off, k_off,
                            causal: bool, scale: float, precision=None,
                            window: Optional[int] = None):
    """dq contribution of one K/V block: ``(H, Sq, D)`` f32.

    ``dout`` is ``(H, Sq, Dv)`` in q's dtype; ``m``, ``linv = 1/l`` (rows
    no key reached map to 1) and ``delta = rowsum(dout * out)`` are the
    saved ``(H, 1, Sq)`` f32 rows. ``k``/``v`` may carry fewer (grouped)
    heads. Launches ``csrc/flash_bwd.cu`` for CUDA tensors and raises on
    shapes or dtypes it does not take."""
    what = "flash_block_backward_dq"
    _bwd_operands(what, q, k, v, dout, m, linv, delta, causal, window)
    if q.device.type == "cpu":
        return flash_block_backward_dq_plain(q, k, v, dout, m, linv, delta,
                                             q_off, k_off, causal, scale,
                                             precision, window)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch(KERNEL_BWD_DQ, q, v, (q, k, v, dout, m, linv, delta, dq),
            _shape_ints(what, q, k, v, q_off, k_off, causal, window), scale,
            _bwd_plan(KERNEL_BWD_DQ, q.shape[2], q.dtype, d_v=v.shape[2]))
    return dq


def flash_block_backward_dkdv(q, k, v, dout, m, linv, delta, q_off, k_off,
                              causal: bool, scale: float, precision=None,
                              window: Optional[int] = None):
    """``(dk, dv)`` of one K/V block from this rank's queries, ``(H_kv,
    Sk, D)`` and ``(H_kv, Sk, Dv)`` f32: the GQA group is reduced in the
    kernel.

    Operands as :func:`flash_block_backward_dq`. Launches
    ``csrc/flash_bwd.cu`` for CUDA tensors and raises on shapes or dtypes
    it does not take."""
    what = "flash_block_backward_dkdv"
    _bwd_operands(what, q, k, v, dout, m, linv, delta, causal, window)
    if q.device.type == "cpu":
        return flash_block_backward_dkdv_plain(q, k, v, dout, m, linv, delta,
                                               q_off, k_off, causal, scale,
                                               precision, window)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    _launch(KERNEL_BWD_DKDV, q, v, (q, k, v, dout, m, linv, delta, dk, dv),
            _shape_ints(what, q, k, v, q_off, k_off, causal, window), scale,
            _bwd_plan(KERNEL_BWD_DKDV, q.shape[2], q.dtype, s_k=k.shape[1],
                      h_kv=k.shape[0], sms=_sm_count(q.device),
                      d_v=v.shape[2]))
    return dk, dv

