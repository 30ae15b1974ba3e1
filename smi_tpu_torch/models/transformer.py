"""Long-context transformer-block training on a (dp, sp) rank grid.

PyTorch counterpart of :mod:`smi_tpu.models.transformer`: one pre-norm
block whose attention is the sequence-parallel ring
(``models/ring_attention.py``, flash tier on CUDA), trained
data-parallel over the canonical 2-D ``(dp, sp)`` grid.

Layout per rank: activations ``(B_local, S_local, E)`` with the batch
sharded over ``dp`` and the sequence over ``sp``; parameters replicated,
f32, in the JAX package's ``(in, out)`` layout (``x @ W``), so converting
weights is a copy. Attention folds the local batch into the head axis,
``(S, B_local * H, D)``, and causal masking stays exact because offsets
come from the ``sp`` coordinate. :func:`make_train_step` runs the local
loss, autograd (through the flash tier's backward kernels), an all-reduce
of the gradients and the loss over every rank, and an in-place SGD
update.

Mixed precision as in the JAX package: with ``compute_dtype="bfloat16"``
the products and the attention ring run in bf16 while the parameters,
norm statistics, gradients and the update stay f32. Each product
rounds its result to the compute dtype before widening it, as ``mm``
does there.

:class:`BlockConfig`'s defaults are the JAX package's block: a
layernorm without affine, no positions, a GELU MLP, one ``window`` for
every layer. Options the JAX package does not have (its defaults keep
today's outputs bit for bit), which the ``afmoe`` family needs:

- ``family="afmoe"``: the ``afmoe`` block's attention and norms, all
  together: an RMSNorm with a weight before and after each sublayer, an
  RMSNorm of each query and key head, rotary positions (``rope_theta``)
  on windowed layers only, and the attention output times
  ``sigmoid(x Wg)`` before ``Wo``;
- ``mlp`` ``"swiglu"`` (of ``mlp_width``) or ``"experts"`` (an expert
  layer that holds some of a router's experts, :mod:`.moe`);
- per layer of a stack, ``layer_types`` (``"sliding"``: windowed to
  ``window``; ``"full"``) and ``layer_mlps``;
- ``family="mla"``: DeepSeek-V3's block, pre-norm with RMSNorms that
  have weights, and latent attention (MLA): ``q = x Wq`` split per head
  into ``head_dim`` dims without positions and ``rope_dim`` rotated
  ones; ``[c | k_pe] = x Wkv_a`` with the latent ``c`` (``latent`` wide)
  RMS-normed; ``[k_nope | v] = c Wkv_b`` per head; rotary positions on
  ``q_pe`` and on ``k_pe`` (one head, shared by all); causal attention of
  ``[q_nope | q_pe]`` against ``[k_nope | k_pe]`` at scale
  ``(head_dim + rope_dim)^-1/2`` over ``v_head_dim``-wide values, then
  ``Wo``. Its glue runs as torch ops around the products.

:class:`LanguageModel` wraps a stack of such layers as a language model
(an embedding, the stack, a final RMSNorm, the head over the vocabulary
rows held here and a cross-entropy), built from a ``config.json``'s keys
by :meth:`LanguageModel.from_config`; :func:`make_train_step` trains it
as it trains a block.

On a CUDA tensor in bf16, an ``afmoe`` block's glue runs as fused
kernels, with the products' outputs kept in bf16: the attention's (the
QK norm, the rotation and the fold into the flash kernels' layout; the
gate on their output) as those of
:mod:`~smi_tpu_torch.kernels.attn_glue`, its residual junctions (the
sandwich norms, the residual adds and the casts around them; the final
norm before the head) as those of
:mod:`~smi_tpu_torch.kernels.residual_norm`. Elsewhere the plain
composition runs, and the two round at the same places.

Spans (``utils/tracing.annotate``): ``smi.train.step`` with its children
``smi.train.forward``, ``.backward`` and ``.update``; ``smi.attn.sliding``,
``smi.attn.full`` and ``smi.attn.mla`` (a layer's attention from its norm
through ``Wo``, by the layer's kind), inside the last the siblings
``smi.mla.latent`` (the ``Wkv_a`` product, the latent norm and the
``Wkv_b`` product) and ``smi.mla.keys`` (the rotations and the assembly
of q and k); ``smi.lm.head`` (the final norm, the head and the loss); the
expert layer's ``smi.moe.*`` (:mod:`.moe`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import (Callable, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from smi_tpu_torch.kernels import attn_glue as glue
from smi_tpu_torch.kernels import residual_norm as rn
from smi_tpu_torch.models import moe
from smi_tpu_torch.models import ring_attention as ra
from smi_tpu_torch.parallel.mesh import Communicator, resolve_device
from smi_tpu_torch.utils.tracing import annotate

#: the block's weights, in the order ``nn.Module.parameters`` yields them
PARAM_NAMES = ("wqkv", "wo", "w1", "w2")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    embed: int = 256
    heads: int = 2
    head_dim: int = 128
    mlp_ratio: int = 2
    causal: bool = True
    window: Optional[int] = None
    #: grouped-query attention: the number of K/V heads (None: ``heads``,
    #: plain MHA). Must divide ``heads``; only the smaller K/V ride the ring.
    kv_heads: Optional[int] = None
    #: "bfloat16" runs the products and the attention ring in bf16 with
    #: f32 master weights; "float32" is full precision
    compute_dtype: str = "float32"
    #: "jax": the JAX package's block (a layernorm without affine, no
    #: positions); "afmoe": an RMSNorm with a weight before and after
    #: each sublayer, an RMSNorm of each query and key head, rotary
    #: positions on windowed layers, the attention output times
    #: ``sigmoid(x Wg)`` before ``Wo``; "mla": DeepSeek-V3's pre-norm
    #: block with latent attention (``latent``, ``rope_dim``,
    #: ``v_head_dim``)
    family: str = "jax"
    #: added to the variance (layernorm) or mean square (RMSNorm) inside
    #: the reciprocal square root
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    #: "gelu" (``w1``, ``w2``), "swiglu" (``w1``, ``w3``, ``w2``) or
    #: "experts" (:func:`moe.expert_layer`, configured by ``experts``)
    mlp: str = "gelu"
    #: the dense MLP's width (None: ``mlp_ratio * embed``)
    mlp_width: Optional[int] = None
    experts: Optional[moe.ExpertConfig] = None
    #: per layer of a stack: "sliding" (windowed to ``window``) or
    #: "full"; None: every layer takes ``window``
    layer_types: Optional[Tuple[str, ...]] = None
    #: per layer of a stack: its ``mlp``; None: every layer takes ``mlp``
    layer_mlps: Optional[Tuple[str, ...]] = None
    #: "mla": the width of the keys' and values' latent (``kv_lora_rank``),
    #: the rotated dims of each query and key head beside its
    #: ``head_dim`` without positions (``qk_rope_head_dim``), and V's
    #: head dim (None: ``head_dim``)
    latent: Optional[int] = None
    rope_dim: int = 0
    v_head_dim: Optional[int] = None

    def __post_init__(self):
        if self.family not in ("jax", "afmoe", "mla"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "mla" and (self.latent is None or self.rope_dim < 2
                                     or self.rope_dim % 2):
            raise ValueError("an mla block needs a latent width and an "
                             "even, positive rope_dim")
        for mlp in (self.mlp,) + tuple(self.layer_mlps or ()):
            if mlp not in ("gelu", "swiglu", "experts"):
                raise ValueError(f"unknown mlp {mlp!r}")
            if mlp == "experts" and self.experts is None:
                raise ValueError("an experts MLP needs an ExpertConfig")
        for kind in self.layer_types or ():
            if kind not in ("sliding", "full"):
                raise ValueError(f"unknown layer type {kind!r}")
            if kind == "sliding" and self.window is None:
                raise ValueError("a sliding layer needs a window")
        if (self.layer_types is not None and self.layer_mlps is not None
                and len(self.layer_types) != len(self.layer_mlps)):
            raise ValueError("layer_types and layer_mlps differ in length")

    def layer(self, i: int) -> "BlockConfig":
        """Layer ``i``'s block: its window and MLP from ``layer_types``
        and ``layer_mlps``; the config itself where both are None."""
        if self.layer_types is None and self.layer_mlps is None:
            return self
        window = self.window
        if self.layer_types is not None and self.layer_types[i] == "full":
            window = None
        mlp = self.mlp if self.layer_mlps is None else self.layer_mlps[i]
        return dataclasses.replace(self, window=window, mlp=mlp,
                                   layer_types=None, layer_mlps=None)

    @property
    def _width(self) -> int:
        return self.mlp_width or self.mlp_ratio * self.embed

    @property
    def _cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def _v_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def _kv(self) -> int:
        kv = self.kv_heads if self.kv_heads is not None else self.heads
        if self.heads % kv:
            raise ValueError(
                f"kv_heads {kv} must divide heads {self.heads}"
            )
        return kv


def init_params(config: BlockConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """One block's parameters as f32 numpy arrays: the JAX package's
    values, drawn from ``np.random.RandomState(seed)`` in its order."""
    e, h, d = config.embed, config.heads, config.head_dim
    rng = np.random.RandomState(seed)

    def w(shape, scale):
        return rng.randn(*shape).astype(np.float32) * scale

    kv = config._kv
    return {
        "wqkv": w((e, (h + 2 * kv) * d), e ** -0.5),
        "wo": w((h * d, e), (h * d) ** -0.5),
        "w1": w((e, config.mlp_ratio * e), e ** -0.5),
        "w2": w((config.mlp_ratio * e, e), (config.mlp_ratio * e) ** -0.5),
    }


def init_stack_params(config: BlockConfig, layers: int,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Stacked parameters of a ``layers``-deep stack: each leaf is
    ``(layers, ...)``, layer ``i`` drawn with seed ``seed + i``."""
    per_layer = [init_params(config, seed=seed + i) for i in range(layers)]
    return {name: np.stack([p[name] for p in per_layer])
            for name in PARAM_NAMES}


def param_shapes(config: BlockConfig) -> Dict[str, tuple]:
    """The shape of each weight of one block (the layer's config,
    :meth:`BlockConfig.layer`), by name: ``wqkv``, ``wo`` and the MLP's
    always; the rest as the options ask."""
    e, h, d, kv = config.embed, config.heads, config.head_dim, config._kv
    f = config._width
    if config.family == "mla":
        r, c, dv = config.rope_dim, config.latent, config._v_dim
        shapes = {"wq": (e, h * (d + r)), "wkv_a": (e, c + r),
                  "kv_norm": (c,), "wkv_b": (c, h * (d + dv)),
                  "wo": (h * dv, e), "input_norm": (e,),
                  "pre_mlp_norm": (e,)}
    else:
        shapes = {"wqkv": (e, (h + 2 * kv) * d), "wo": (h * d, e)}
    if config.family == "afmoe":
        shapes.update(wg=(e, h * d), input_norm=(e,), pre_mlp_norm=(e,),
                      post_attn_norm=(e,), post_mlp_norm=(e,),
                      q_norm=(d,), k_norm=(d,))
    if config.mlp == "experts":
        shapes.update(moe.param_shapes(e, config.experts))
    else:
        shapes.update(w1=(e, f), w2=(f, e))
        if config.mlp == "swiglu":
            shapes["w3"] = (e, f)
    return shapes


def _layernorm(x, eps=1e-6):
    """Layernorm without affine: biased variance, ``eps`` inside the
    reciprocal square root."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


@functools.lru_cache(maxsize=16)
def _rope_tables(s: int, d: int, offset: int, theta: float, device):
    """Rotary positions' ``(cos, sin)`` tables, ``(S, D)`` f32, at
    positions ``offset + [0, S)``: the cosines and sines of ``position *
    theta ** (-2j / D)``, the ``D/2`` frequencies twice over; built once a
    shape, offset and device."""
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, device=device)
                               .float() / d)
    pos = torch.arange(offset, offset + s, device=device).float()
    angles = torch.outer(pos, inv_freq).repeat(1, 2)
    return angles.cos(), angles.sin()


def _rope(config: BlockConfig, comm, sp_axis: str, s: int, device):
    """The tables of an ``afmoe`` layer's rotary positions at this rank's
    ``sp`` offset, or None on a layer without positions (a full one)."""
    if config.window is None:
        return None
    offset = comm.coords[comm._axis(sp_axis)] * s
    return _rope_tables(s, config.head_dim, offset, config.rope_theta,
                        device)


def _mla_attention(params, xn, comm, config: BlockConfig, b: int, s: int,
                   sp_axis: str, use_flash: Optional[bool]):
    """The ``mla`` attention sublayer from the normed input ``xn`` ``(B*S,
    E)`` to the ``wo`` product's input ``(B*S, H*Dv)`` f32, in torch ops
    around the products (each rounded to the compute dtype and widened):
    the query product; the latent (``Wkv_a``, its RMSNorm, ``Wkv_b``);
    the rotary positions of ``q_pe`` and ``k_pe`` at this rank's ``sp``
    offset, each head's pairs ``(x_2i, x_2i+1)`` rotated by position times
    ``rope_theta ** (-2i / rope_dim)`` and laid out halves first (the
    DeepSeek-V3 modeling code's ``rope_interleave``); q and k assembled
    ``head_dim + rope_dim`` wide, rounded once to the compute dtype; the
    ring at scale ``(head_dim + rope_dim)^-1/2``."""
    h, d, r, dv = config.heads, config.head_dim, config.rope_dim, \
        config._v_dim
    cd, c = config._cdtype, config.latent
    mm = functools.partial(_product, dtype=cd)
    q = mm(xn, params["wq"]).view(b, s, h, d + r)
    with annotate("smi.mla.latent"):
        ckv = mm(xn, params["wkv_a"])
        latent = F.rms_norm(ckv[:, :c], (c,), params["kv_norm"],
                            config.norm_eps)
        kv = mm(latent, params["wkv_b"]).view(b, s, h, d + dv)
    with annotate("smi.mla.keys"):
        cos, sin = _rope_tables(s, r, comm.coords[comm._axis(sp_axis)] * s,
                                config.rope_theta, xn.device)

        def rotated(t):
            return glue._rotate(_pairs_to_halves(t), cos, sin)

        q = torch.cat((q[..., :d], rotated(q[..., d:])), dim=-1)
        k_pe = rotated(ckv[:, c:].view(b, s, 1, r)).expand(b, s, h, r)
        k = torch.cat((kv[..., :d], k_pe), dim=-1)
        q, k = (_fold_heads(t, cd) for t in (q, k))
    attn = ra.ring_attention_shard(
        q, k, _fold_heads(kv[..., d:], cd), comm, causal=config.causal,
        axis_name=sp_axis, use_flash=use_flash)          # (S, B*H, Dv)
    return glue.token_order(attn, b, h)                   # (B*S, H*Dv) f32


def _pairs_to_halves(t):
    """The last dim's pairs ``(x_2i, x_2i+1)`` laid out halves first,
    ``[x_0, x_2, ..., x_1, x_3, ...]``, so that rotating halves
    (``glue._rotate``) rotates each pair: DeepSeek-V3's
    ``rope_interleave``."""
    return t.unflatten(-1, (t.shape[-1] // 2, 2)).transpose(-1, -2).flatten(
        -2)


def _fold_heads(t, dtype):
    """``(B, S, H, D)`` in token order to the ring's ``(S, B*H, D)`` in
    ``dtype``: the batch folded into the heads, each batch's heads
    adjacent."""
    b, s, h, d = t.shape
    return t.to(dtype).transpose(0, 1).reshape(s, b * h, d)


def _product(a, w, dtype):
    """``a @ w`` in the compute dtype ``dtype``, rounded to it, then
    widened; autograd carries the casts, so gradients land in f32."""
    return (a.to(dtype) @ w.to(dtype)).float()


def _gate(attn, xn, wg, mm):
    """The attention output ``attn`` times ``sigmoid(xn Wg)``."""
    return attn * torch.sigmoid(mm(xn, wg))


def _plain_attention(params, xn, comm, config: BlockConfig, b: int, s: int,
                     sp_axis: str, use_flash: Optional[bool]):
    """The attention sublayer from the normed input ``xn`` ``(B*S, E)`` to
    the ``wo`` product's input ``(B*S, H*D)`` f32, in torch ops: the
    ``wqkv`` product; for ``afmoe`` the fused kernels' plain version of
    the QK norm, the rotation and the fold, for the JAX package's block
    the fold alone; the ring; the output widened in token order, and for
    ``afmoe`` gated."""
    h, kv, d, cd = config.heads, config._kv, config.head_dim, config._cdtype
    mm = functools.partial(_product, dtype=cd)
    qkv = mm(xn, params["wqkv"])
    if config.family == "afmoe":
        # head-major, handed to the ring as (S, B*Hx, D) views
        q, k, v = (t.transpose(0, 1) for t in glue.attn_prologue_plain(
            qkv, params["q_norm"], params["k_norm"], b, h, kv,
            config.norm_eps, _rope(config, comm, sp_axis, s, xn.device),
            dtype=cd))
    else:
        # each batch's heads stay contiguous in the fold, so the GQA map
        # hh // (H/KV) holds
        qkv = qkv.reshape(b, s, h + 2 * kv, d)
        q, k, v = (_fold_heads(t, cd) for t in (
            qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]))
    attn = ra.ring_attention_shard(
        q, k, v, comm, causal=config.causal, axis_name=sp_axis,
        use_flash=use_flash, window=config.window,
    )                                                     # (S, B*H, D)
    attn = glue.token_order(attn, b, h)                   # (B*S, H*D) f32
    if config.family == "afmoe":
        attn = _gate(attn, xn, params["wg"], mm)
    return attn


def _fuses_glue(config: BlockConfig, x: torch.Tensor) -> bool:
    """Whether the block's glue runs as fused kernels (the attention's,
    :mod:`~smi_tpu_torch.kernels.attn_glue`; the residual junctions',
    :mod:`~smi_tpu_torch.kernels.residual_norm`): an ``afmoe`` block in
    bf16 on a CUDA tensor. Elsewhere (the CPU, the JAX package's block,
    f32) the plain composition runs."""
    return (config.family == "afmoe" and config._cdtype == torch.bfloat16
            and x.is_cuda)


def _fused_attention(params, xn, comm, config: BlockConfig, b: int, s: int,
                     sp_axis: str, use_flash: Optional[bool]):
    """The ``afmoe`` attention sublayer from the normed input ``xn``
    ``(B*S, E)`` bf16 to the ``wo`` product's input ``(B*S, H*D)`` bf16:
    the products kept in bf16, the QK norm, the rotation and the fold in
    one kernel, the flash ring on its head-major output, the gate in
    another kernel on the ring's output where it lies."""
    h, kv, cd = config.heads, config._kv, config._cdtype
    q, k, v = glue.attn_prologue(xn @ params["wqkv"].to(cd),
                                 params["q_norm"], params["k_norm"], b, h,
                                 kv, config.norm_eps,
                                 _rope(config, comm, sp_axis, s, xn.device))
    attn = ra.ring_attention_shard(
        q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), comm,
        causal=config.causal, axis_name=sp_axis, use_flash=use_flash,
        window=config.window,
    )                                                     # (S, B*H, D)
    return glue.attn_epilogue(attn, xn @ params["wg"].to(cd), b, h)


def _layernorm_entry(x, w, eps, dtype):
    """The JAX package's block at its start: ``x`` passed on and its
    layernorm without affine (``w`` is None) in the compute dtype."""
    return x, _layernorm(x, eps).to(dtype)


def _layernorm_middle(x, out, w_post, w_pre, eps, dtype):
    """``(h, yn)`` of the JAX package's block: the residual add of the
    widened product, then a layernorm without affine in ``dtype``."""
    h = x + out.float()
    return h, _layernorm(h, eps).to(dtype)


def _rms_middle(x, out, w_post, w_pre, eps, dtype):
    """``(h, yn)`` of a pre-norm block with RMSNorms (``mla``): the
    residual add of the widened product (no norm after the sublayer:
    ``w_post`` is None), then the next sublayer's RMSNorm in ``dtype``."""
    h = x + out.float()
    return h, F.rms_norm(h, w_pre.shape, w_pre, eps).to(dtype)


def _plain_exit(h, out, w, eps):
    """A pre-norm block at its end (the JAX package's, ``mla``): the plain
    residual add."""
    return h + out


class _Glue(NamedTuple):
    """A block's glue around its products, chosen once a call by
    :func:`_block_glue`: the attention sublayer from the normed input to
    ``wo``'s input, the three residual junctions with the signatures of
    :mod:`~smi_tpu_torch.kernels.residual_norm`'s ``entry_norm``,
    ``middle_norm`` and ``exit_norm``, and the attention's span."""

    attention: Callable
    entry: Callable
    middle: Callable
    exit: Callable
    span: str


def _block_glue(config: BlockConfig, x: torch.Tensor) -> _Glue:
    """The fused kernels where :func:`_fuses_glue`; else the plain
    composition: the ``mla`` block's latent attention and pre-norm
    RMSNorms, the ``afmoe`` block's RMSNorms with weights, or the JAX
    package's layernorms without affine and its plain residual adds."""
    span = f"smi.attn.{'full' if config.window is None else 'sliding'}"
    if _fuses_glue(config, x):
        return _Glue(_fused_attention, rn.entry_norm, rn.middle_norm,
                     rn.exit_norm, span)
    if config.family == "mla":
        return _Glue(_mla_attention, rn.entry_norm_plain, _rms_middle,
                     _plain_exit, "smi.attn.mla")
    if config.family == "afmoe":
        return _Glue(_plain_attention, rn.entry_norm_plain,
                     rn.middle_norm_plain, rn.exit_norm_plain, span)
    return _Glue(_plain_attention, _layernorm_entry, _layernorm_middle,
                 _plain_exit, span)


def block_shard(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,               # (B_local, S_local, E)
    comm: Communicator,
    config: BlockConfig,
    sp_axis: str = "sp",
    use_flash: Optional[bool] = None,
    route_cache: Optional[dict] = None,
) -> torch.Tensor:
    """One pre-norm block on this rank's activation shard.
    ``route_cache``: an expert layer's routing, kept from its first call
    for a later one (:func:`moe.expert_layer`)."""
    b, s, e = x.shape
    cd, eps = config._cdtype, config.norm_eps
    mm = functools.partial(_product, dtype=cd)
    parts = _block_glue(config, x)
    x = x.reshape(b * s, e)

    with annotate(parts.span):
        x, xn = parts.entry(x, params.get("input_norm"), eps, cd)
        attn = parts.attention(params, xn, comm, config, b, s, sp_axis,
                               use_flash)
        # the wo product stays in the compute dtype: the junction widens
        # it
        out = attn.to(cd) @ params["wo"].to(cd)
    # an expert layer's router reads its input in f32
    x, yn = parts.middle(x, out, params.get("post_attn_norm"),
                         params.get("pre_mlp_norm"), eps,
                         torch.float32 if config.mlp == "experts" else cd)
    if config.mlp == "gelu":
        out = mm(F.gelu(mm(yn, params["w1"]), approximate="tanh"),
                 params["w2"])
    elif config.mlp == "swiglu":
        out = moe.swiglu(yn, params["w1"], params["w3"], params["w2"], mm)
    else:
        out = moe.expert_layer(params, yn, config.experts, mm, cd,
                               route_cache)
    return parts.exit(x, out, params.get("post_mlp_norm"), eps).reshape(
        b, s, e)


def stack_shard(
    params,
    x: torch.Tensor,
    comm: Communicator,
    config: BlockConfig,
    sp_axis: str = "sp",
    use_flash: Optional[bool] = None,
    routing: Optional[Sequence[dict]] = None,
) -> torch.Tensor:
    """A ``layers``-deep stack of pre-norm blocks on this rank's shard,
    each block recomputed under differentiation (activation
    checkpointing, the JAX package's ``jax.checkpoint`` inside
    ``lax.scan``): training memory holds one block's residuals plus the
    per-layer activations.

    ``params`` is stacked (every leaf ``(layers, ...)``) for layers of
    one shape, or a sequence of per-layer dictionaries; layer ``i``
    runs ``config.layer(i)``. ``routing`` holds a dict a layer, where an
    expert layer keeps its routing for its recompute (fresh dicts when
    None)."""
    if isinstance(params, Mapping):
        depth = params["wqkv"].shape[0]
        layers = [{n: p[i] for n, p in params.items()} for i in range(depth)]
    else:
        layers = list(params)
    if routing is None:
        routing = [{} for _ in layers]
    for i, p in enumerate(layers):
        x = checkpoint(block_shard, p, x, comm, config.layer(i), sp_axis,
                       use_flash, routing[i], use_reentrant=False)
    return x


class TransformerBlock(nn.Module):
    """One pre-norm block: ``wqkv``, ``wo``, ``w1`` and ``w2`` as f32
    parameters in the JAX package's ``(in, out)`` layout, on ``device``
    (CUDA by default). ``params`` defaults to :func:`init_params`."""

    def __init__(self, config: BlockConfig, params=None, device=None):
        super().__init__()
        self.config = config
        params = init_params(config) if params is None else params
        dev = resolve_device(device)
        for name in PARAM_NAMES:
            value = torch.tensor(np.asarray(params[name], np.float32))
            setattr(self, name, nn.Parameter(value.to(dev)))

    def weights(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, x, comm: Communicator, sp_axis: str = "sp",
                use_flash: Optional[bool] = None):
        return block_shard(self.weights(), x, comm, self.config,
                           sp_axis=sp_axis, use_flash=use_flash)


class TransformerStack(nn.Module):
    """``layers`` pre-norm blocks, each run under activation
    checkpointing. ``params`` is the stacked dictionary of
    :func:`init_stack_params` (its default)."""

    def __init__(self, config: BlockConfig, layers: Optional[int] = None,
                 params=None, device=None):
        super().__init__()
        if params is None:
            params = init_stack_params(config, layers)
        depth = len(params["wqkv"])
        if layers is not None and layers != depth:
            raise ValueError(f"{layers} layers asked, the parameters hold "
                             f"{depth}")
        self.config = config
        self.blocks = nn.ModuleList(
            TransformerBlock(config, {n: p[i] for n, p in params.items()},
                             device=device)
            for i in range(depth))

    def forward(self, x, comm: Communicator, sp_axis: str = "sp",
                use_flash: Optional[bool] = None):
        for block in self.blocks:
            x = checkpoint(block, x, comm, sp_axis, use_flash,
                           use_reentrant=False)
        return x


#: keys of an ``afmoe`` ``config.json`` this port fixes: other values
#: describe a model it does not run
_AFMOE_FIXED = {"hidden_act": "silu", "score_func": "sigmoid",
                "n_group": 1, "topk_group": 1, "num_expert_groups": 1,
                "num_limited_groups": 1, "rope_scaling": None,
                "tie_word_embeddings": False}


def afmoe_block_config(cfg: Mapping, held: Optional[Sequence[int]] = None,
                       compute_dtype: str = "bfloat16") -> BlockConfig:
    """The stack's :class:`BlockConfig` from an ``afmoe`` ``config.json``'s
    keys. ``num_experts`` is the count held here (experts ``0 ..
    num_experts - 1`` unless ``held`` names them); ``router_experts``,
    where given, the router's width (else ``num_experts``)."""
    for key, want in _AFMOE_FIXED.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"{key} = {cfg[key]!r}: the port runs "
                             f"{want!r}")
    layers = cfg["num_hidden_layers"]
    dense = cfg["num_dense_layers"]
    held = tuple(range(cfg["num_experts"])) if held is None else held
    experts = moe.ExpertConfig(
        router=cfg.get("router_experts", cfg["num_experts"]),
        topk=cfg["num_experts_per_tok"], width=cfg["moe_intermediate_size"],
        held=tuple(held), shared=cfg["num_shared_experts"],
        route_scale=cfg["route_scale"], route_norm=cfg["route_norm"])
    types = tuple({"sliding_attention": "sliding",
                   "full_attention": "full"}[t] for t in cfg["layer_types"])
    if len(types) != layers:
        raise ValueError(f"{len(types)} layer types for {layers} layers")
    return BlockConfig(
        embed=cfg["hidden_size"], heads=cfg["num_attention_heads"],
        head_dim=cfg["head_dim"], kv_heads=cfg["num_key_value_heads"],
        window=cfg["sliding_window"], compute_dtype=compute_dtype,
        family="afmoe", norm_eps=cfg["rms_norm_eps"],
        rope_theta=cfg["rope_theta"], mlp="swiglu",
        mlp_width=cfg["intermediate_size"],
        experts=experts, layer_types=types,
        layer_mlps=("swiglu",) * dense + ("experts",) * (layers - dense))


#: keys of a ``deepseek_v3`` ``config.json`` this port fixes: other values
#: describe a model it does not run (a low-rank query, YaRN, grouped
#: routing, multi-token prediction)
_DEEPSEEK_V3_FIXED = {"hidden_act": "silu", "scoring_func": "sigmoid",
                      "topk_method": "noaux_tc", "n_group": 1,
                      "topk_group": 1, "q_lora_rank": None,
                      "rope_scaling": None, "attention_bias": False,
                      "moe_layer_freq": 1, "num_nextn_predict_layers": 0,
                      "tie_word_embeddings": False}


def deepseek_v3_block_config(cfg: Mapping,
                             held: Optional[Sequence[int]] = None,
                             compute_dtype: str = "bfloat16") -> BlockConfig:
    """The stack's :class:`BlockConfig` from a ``deepseek_v3``
    ``config.json``'s keys: ``first_k_dense_replace`` dense SwiGLU layers,
    then expert layers of ``n_routed_experts`` (the count held here:
    experts ``0 .. n_routed_experts - 1`` unless ``held`` names them;
    ``router_experts``, where given, the router's width) and
    ``n_shared_experts`` shared ones, every layer with latent attention.
    The router's choice bias (``e_score_correction_bias``) is held at 0."""
    for key, want in _DEEPSEEK_V3_FIXED.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"{key} = {cfg[key]!r}: the port runs "
                             f"{want!r}")
    layers = cfg["num_hidden_layers"]
    dense = cfg["first_k_dense_replace"]
    held = tuple(range(cfg["n_routed_experts"])) if held is None else held
    experts = moe.ExpertConfig(
        router=cfg.get("router_experts", cfg["n_routed_experts"]),
        topk=cfg["num_experts_per_tok"], width=cfg["moe_intermediate_size"],
        held=tuple(held), shared=cfg["n_shared_experts"],
        route_scale=cfg["routed_scaling_factor"],
        route_norm=cfg["norm_topk_prob"])
    return BlockConfig(
        embed=cfg["hidden_size"], heads=cfg["num_attention_heads"],
        head_dim=cfg["qk_nope_head_dim"], compute_dtype=compute_dtype,
        family="mla", norm_eps=cfg["rms_norm_eps"],
        rope_theta=cfg["rope_theta"], mlp="swiglu",
        mlp_width=cfg["intermediate_size"], experts=experts,
        layer_mlps=("swiglu",) * dense + ("experts",) * (layers - dense),
        latent=cfg["kv_lora_rank"], rope_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"])


#: ``config.json``'s ``model_type`` -> the stack's config from its keys,
#: and the key whose truth scales the embedding by sqrt(hidden) (None:
#: the type never scales it)
MODEL_TYPES = {"afmoe": (afmoe_block_config, "mup_enabled"),
               "deepseek_v3": (deepseek_v3_block_config, None)}


class LanguageModel(nn.Module):
    """A language model over a stack of blocks: ``h = embed[ids]`` (times
    ``sqrt(embed)`` where ``embed_scale``), the stack (layer ``i`` runs
    ``config.layer(i)``, each under activation checkpointing), a final
    RMSNorm, the head, and the summed cross-entropy of each next token
    over the ``vocab`` rows held here.

    Every weight is an f32 parameter in the ``(in, out)`` layout; the
    embedding is ``(vocab, embed)``. ``weights`` are by the names of
    :meth:`reference_names` (``wq``, ``wk`` and ``wv`` apart where the
    blocks hold them as one ``wqkv``); None draws matrices normal with
    std 0.02 and norm weights of 1 from ``seed``."""

    def __init__(self, config: BlockConfig, layers: int, vocab: int,
                 weights: Optional[Mapping[str, torch.Tensor]] = None,
                 embed_scale: bool = True, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        self.vocab = vocab
        self.scale = math.sqrt(config.embed) if embed_scale else 1.0
        #: each layer's routing of the last call (:meth:`stack`)
        self.routing = []
        dev = resolve_device(device)
        shapes = self._shapes(config, layers, vocab)
        if weights is None:
            gen = torch.Generator().manual_seed(seed)
            weights = {n: (torch.ones(shape) if n.endswith("norm")
                           else torch.randn(shape, generator=gen) * 0.02)
                       for n, shape in shapes.items()}

        def value(name, copy=False):
            got = weights[name]
            if tuple(got.shape) != shapes[name]:
                raise ValueError(f"{name} has shape {tuple(got.shape)}, "
                                 f"the model {shapes[name]}")
            return got.detach().to(dev, torch.float32, copy=copy)

        def param(name):
            return nn.Parameter(value(name, copy=True))

        self.embed = param("embed")
        self.blocks = nn.ModuleList()
        for i in range(layers):
            pre = f"layers.{i}."
            block = nn.ParameterDict()
            for name in param_shapes(config.layer(i)):
                if name == "wqkv":
                    block[name] = nn.Parameter(torch.cat(
                        [value(pre + w) for w in ("wq", "wk", "wv")], dim=1))
                else:
                    block[name] = param(pre + name)
            self.blocks.append(block)
        self.final_norm = param("final_norm")
        self.head = param("head")

    @staticmethod
    def _shapes(config, layers, vocab) -> Dict[str, tuple]:
        e, h, d, kv = (config.embed, config.heads, config.head_dim,
                       config._kv)
        shapes = {"embed": (vocab, e)}
        for i in range(layers):
            block = param_shapes(config.layer(i))
            if block.pop("wqkv", None) is not None:
                block.update(wq=(e, h * d), wk=(e, kv * d), wv=(e, kv * d))
            shapes.update({f"layers.{i}.{n}": v for n, v in block.items()})
        shapes.update(final_norm=(e,), head=(e, vocab))
        return shapes

    @classmethod
    def from_config(cls, cfg: Mapping, weights=None,
                    held: Optional[Sequence[int]] = None,
                    compute_dtype: str = "bfloat16", device=None,
                    seed: int = 0) -> "LanguageModel":
        """The model of a ``config.json``'s keys, by its ``model_type``
        (:data:`MODEL_TYPES`). A config without ``model_type``, or with
        one the port does not run, is refused by name."""
        kind = cfg.get("model_type")
        if kind not in MODEL_TYPES:
            raise ValueError(f"model_type {kind!r}: the port runs "
                             f"{sorted(MODEL_TYPES)}")
        block_config, scale_key = MODEL_TYPES[kind]
        return cls(block_config(cfg, held, compute_dtype),
                   cfg["num_hidden_layers"], cfg["vocab_size"],
                   weights=weights,
                   embed_scale=scale_key is not None and bool(cfg[scale_key]),
                   device=device, seed=seed)

    def reference_names(self, grads: bool = False
                        ) -> Dict[str, torch.Tensor]:
        """Every weight (or, with ``grads``, its gradient) by the names
        the constructor takes: ``wq``, ``wk`` and ``wv`` are views of a
        block's ``wqkv`` where it has one."""
        h, d, kv = self.config.heads, self.config.head_dim, self.config._kv

        def get(p):
            return p.grad if grads else p

        out = {"embed": get(self.embed)}
        for i, block in enumerate(self.blocks):
            for name, p in block.items():
                t = get(p)
                if name != "wqkv":
                    out[f"layers.{i}.{name}"] = t
                    continue
                for w, lo, hi in (("wq", 0, h), ("wk", h, h + kv),
                                  ("wv", h + kv, h + 2 * kv)):
                    out[f"layers.{i}.{w}"] = (None if t is None
                                              else t[:, lo * d:hi * d])
        out.update(final_norm=get(self.final_norm), head=get(self.head))
        return out

    def forward(self, ids, comm: Communicator, sp_axis: str = "sp",
                use_flash: Optional[bool] = None):
        """The logits ``(B_local, S_local, vocab)`` of this rank's ids, f32
        (rounded to the compute dtype by the head's product)."""
        h = self.stack(ids, comm, sp_axis, use_flash)
        with annotate("smi.lm.head"):
            return self._logits(h)

    def stack(self, ids, comm, sp_axis="sp", use_flash=None):
        """The last layer's output; ``routing`` keeps each expert
        layer's routing of this call (``"sel"``: each token's expert
        ids)."""
        x = self.embed[ids] * self.scale
        self.routing = [{} for _ in self.blocks]
        return stack_shard([dict(b.items()) for b in self.blocks], x, comm,
                           self.config, sp_axis, use_flash, self.routing)

    def _logits(self, h):
        cd = self.config._cdtype
        b, s, e = h.shape
        # the final norm is an afmoe block's entry, chosen as its are
        _, hn = _block_glue(self.config, h).entry(
            h.reshape(b * s, e), self.final_norm, self.config.norm_eps, cd)
        return (hn @ self.head.to(cd)).float().reshape(b, s, self.vocab)

    def loss(self, ids, labels, comm: Communicator, sp_axis: str = "sp",
             use_flash: Optional[bool] = None):
        """The summed cross-entropy of ``labels`` (each position's next
        token) under the logits of ``ids``, f32."""
        h = self.stack(ids, comm, sp_axis, use_flash)
        with annotate("smi.lm.head"):
            logits = self._logits(h)
            return F.cross_entropy(logits.reshape(-1, self.vocab),
                                   labels.reshape(-1), reduction="sum")


def make_train_step(
    comm: Communicator,
    config: BlockConfig,
    lr: float = 1e-3,
    use_flash: Optional[bool] = None,
    layers: int = 1,
):
    """SGD training step over the communicator's ``(dp, sp)`` grid.

    ``step(model, x, y) -> loss`` takes this rank's ``(B_local, S_local,
    E)`` shards of the inputs and targets and a :class:`TransformerBlock`
    (``layers == 1``) or a ``layers``-deep :class:`TransformerStack`,
    replicated on every rank. It computes the local loss ``sum((pred -
    y)**2)``, runs autograd, sums the gradients and the loss over every
    rank (a 1x1 grid sends nothing), updates the parameters in place
    (``p -= lr * g / n_total``) and returns the mean loss. Each
    parameter's ``grad`` keeps the summed gradient of the step.

    For a ``layers``-deep :class:`LanguageModel`, ``x`` and ``y`` are
    ``(B_local, S_local)`` token ids and their next tokens, and the local
    loss is the summed cross-entropy (:meth:`LanguageModel.loss`); the
    rest is the same.
    """
    _, sp_axis = comm.axis_names

    def step(model: nn.Module, x: torch.Tensor, y: torch.Tensor):
        depth = len(model.blocks) if isinstance(
            model, (TransformerStack, LanguageModel)) else 1
        if depth != layers:
            raise ValueError(f"the train step is for {layers} layer(s), the "
                             f"model has {depth}")
        n_total = x.shape[0] * x.shape[1] * comm.size
        params = list(model.parameters())
        with annotate("smi.train.step"):
            for p in params:
                p.grad = None
            with annotate("smi.train.forward"):
                if isinstance(model, LanguageModel):
                    loss = model.loss(x, y, comm, sp_axis=sp_axis,
                                      use_flash=use_flash)
                else:
                    pred = model(x, comm, sp_axis=sp_axis,
                                 use_flash=use_flash)
                    loss = ((pred - y) ** 2).sum()
            with annotate("smi.train.backward"):
                loss.backward()
            loss = loss.detach()
            with annotate("smi.train.update"):
                if comm.size > 1:
                    for p in params:
                        dist.all_reduce(p.grad)
                    dist.all_reduce(loss)
                with torch.no_grad():
                    for p in params:
                        p -= lr * p.grad / n_total
        return loss / n_total

    return step


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                    * (x + 0.044715 * x ** 3)))


def reference_block(params, x, config: BlockConfig) -> np.ndarray:
    """Single-device float64 numpy reference of the block on the gathered
    ``(B, S, E)`` input, for verification."""
    p = {n: np.asarray(params[n], np.float64) for n in PARAM_NAMES}
    x = np.asarray(x, np.float64)
    b, s, e = x.shape
    h, d = config.heads, config.head_dim
    kv = config._kv

    def layernorm(t):
        mu = t.mean(axis=-1, keepdims=True)
        var = ((t - mu) ** 2).mean(axis=-1, keepdims=True)
        return (t - mu) / np.sqrt(var + 1e-6)

    qkv = (layernorm(x).reshape(b * s, e) @ p["wqkv"]).reshape(
        b, s, h + 2 * kv, d)
    q = qkv[:, :, :h]
    k = np.repeat(qkv[:, :, h:h + kv], h // kv, axis=2)
    v = np.repeat(qkv[:, :, h + kv:], h // kv, axis=2)
    attn = np.stack([ra.reference_attention(q[i], k[i], v[i],
                                            causal=config.causal,
                                            window=config.window)
                     for i in range(b)])
    x = x + (attn.reshape(b * s, h * d) @ p["wo"]).reshape(b, s, e)
    yn = layernorm(x).reshape(b * s, e)
    return x + (_gelu_tanh(yn @ p["w1"]) @ p["w2"]).reshape(b, s, e)
