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
layernorm statistics, gradients and the update stay f32. Each product
rounds its result to the compute dtype before widening it, as ``mm``
does there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from smi_tpu_torch.models import ring_attention as ra
from smi_tpu_torch.parallel.mesh import Communicator, resolve_device

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

    @property
    def _cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

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


def _layernorm(x):
    """Layernorm without affine: biased variance, ``1e-6`` inside the
    reciprocal square root."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def block_shard(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,               # (B_local, S_local, E)
    comm: Communicator,
    config: BlockConfig,
    sp_axis: str = "sp",
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """One pre-norm block on this rank's activation shard."""
    b, s, e = x.shape
    h, d = config.heads, config.head_dim
    cd = config._cdtype
    kv = config._kv

    def mm(a, w):
        """A product in the compute dtype, rounded to it, then widened;
        autograd carries the casts, so gradients land in f32."""
        return (a.to(cd) @ params[w].to(cd)).float()

    xn = _layernorm(x)
    qkv = mm(xn.reshape(b * s, e), "wqkv").reshape(b, s, h + 2 * kv, d)
    q = qkv[:, :, :h]
    k = qkv[:, :, h:h + kv]
    v = qkv[:, :, h + kv:]

    # fold the batch into the heads: (B, S, Hx, D) -> (S, B*Hx, D); each
    # batch's heads stay contiguous, so the GQA map hh // (H/KV) holds
    def fold(t, hx):
        return t.transpose(0, 1).reshape(s, b * hx, d).to(cd)

    attn = ra.ring_attention_shard(
        fold(q, h), fold(k, kv), fold(v, kv), comm, causal=config.causal,
        axis_name=sp_axis, use_flash=use_flash, window=config.window,
    ).float()                                             # (S, B*H, D)
    attn = attn.reshape(s, b, h * d).transpose(0, 1)      # (B, S, H*D)
    x = x + mm(attn.reshape(b * s, h * d), "wo").reshape(b, s, e)

    yn = _layernorm(x).reshape(b * s, e)
    mlp = mm(F.gelu(mm(yn, "w1"), approximate="tanh"), "w2")
    return x + mlp.reshape(b, s, e)


def stack_shard(
    params: Mapping[str, torch.Tensor],   # stacked: every leaf (layers, ...)
    x: torch.Tensor,
    comm: Communicator,
    config: BlockConfig,
    sp_axis: str = "sp",
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """A ``layers``-deep stack of pre-norm blocks on this rank's shard,
    each block recomputed under differentiation (activation
    checkpointing, the JAX package's ``jax.checkpoint`` inside
    ``lax.scan``): training memory holds one block's residuals plus the
    per-layer activations."""
    for i in range(params["wqkv"].shape[0]):
        x = checkpoint(block_shard, {n: p[i] for n, p in params.items()}, x,
                       comm, config, sp_axis, use_flash, use_reentrant=False)
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
    """
    _, sp_axis = comm.axis_names

    def step(model: nn.Module, x: torch.Tensor, y: torch.Tensor):
        depth = len(model.blocks) if isinstance(model, TransformerStack) \
            else 1
        if depth != layers:
            raise ValueError(f"the train step is for {layers} layer(s), the "
                             f"model has {depth}")
        n_total = x.shape[0] * x.shape[1] * comm.size
        params = list(model.parameters())
        for p in params:
            p.grad = None
        pred = model(x, comm, sp_axis=sp_axis, use_flash=use_flash)
        loss = ((pred - y) ** 2).sum()
        loss.backward()
        loss = loss.detach()
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
