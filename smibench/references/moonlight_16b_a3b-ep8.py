"""Plain reference of a ``deepseek_v3`` language model's training step
(Moonlight-16B-A3B): the forward pass, the loss and, by autograd, the
gradients, in float32. Its inputs are made from a seed as the Trinity
cell's are (:func:`make_batch` and the control's :func:`fp8_round` are
that reference's).

Plain PyTorch: it imports nothing of the program, and has no kernel and
no cache. TF32 is turned off for every product. Attention is a masked
softmax over the keys a block of queries can see, one block at a time
under activation checkpointing, as is each layer, so that the whole
step fits on one card at 8192 positions.

The equations (the DeepSeek-V3 modeling code), for a configuration dict
holding the keys of the model's ``config.json`` (``n_routed_experts`` the
experts held here, ``router_experts`` the router's width where the two
differ):

- ``h = embed[ids]``;
- each layer ``h = h + attn(input_norm(h))``, then ``h = h +
  mlp(pre_mlp_norm(h))``, every norm an RMSNorm with a weight;
- ``attn(x)``: ``q = x Wq``, each head ``[q_nope | q_pe]``
  (``qk_nope_head_dim`` and ``qk_rope_head_dim`` dims); ``[c | k_pe] = x
  Wkv_a`` and ``c = kv_norm(c)``; ``[k_nope | v] = c Wkv_b`` per head;
  ``q_pe`` and ``k_pe`` (one head, shared by all) rotated: each pair
  ``(x_2i, x_2i+1)`` as the complex number ``x_2i + i x_2i+1`` times
  ``exp(i * position * rope_theta ** (-2i / qk_rope_head_dim))``; causal
  attention of ``[q_nope | q_pe]`` against ``[k_nope | k_pe]`` with scale
  ``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5`` over ``v``, then
  ``Wo``;
- ``mlp`` on the first ``first_k_dense_replace`` layers: ``W2(silu(W1 x)
  * W3 x)``;
- on the others, an expert layer: ``s = sigmoid(x Wr)`` over all the
  router's experts, ``sel = topk(s)`` (``e_score_correction_bias`` held
  at 0), ``w = s[sel] / sum(s[sel]) * routed_scaling_factor``
  (``norm_topk_prob``), and ``out = shared(x) + sum over held e in sel
  of w_e * expert_e(x)``, every expert a SwiGLU and the shared experts
  one SwiGLU of ``n_shared_experts * moe_intermediate_size``; the absent
  experts' part is left out;
- a final RMSNorm, the head, and the mean cross-entropy of each next
  token over the vocabulary rows held here.

``round_fn``, where given, rounds both operands of every product (the
control: float8 e4m3). ``forced``, where given, maps an expert layer to
the expert ids its tokens take in place of ``topk(s)`` (the choices of
the run under judgement, so that a choice flipped by rounding moves no
gradient); ``routes`` still records ``topk(s)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from smibench import spec

_trinity = spec.load_module("references", "trinity_mini-ep16")
make_batch = _trinity.make_batch
fp8_round = _trinity.fp8_round
_mix = _trinity._mix

#: queries of one attention block
QUERY_BLOCK = 1024


def _held(cfg, held=None):
    return list(range(cfg["n_routed_experts"])) if held is None else list(
        held)


def weight_shapes(cfg, held=None) -> dict:
    """Each weight's shape by name, in the order :func:`make_weights`
    draws them; every matrix is ``(in, out)``, the embedding ``(vocab,
    hidden)``."""
    e, v, h = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    c = cfg["kv_lora_rank"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * fe
    n = len(_held(cfg, held))
    shapes = {"embed": (v, e)}
    for i in range(cfg["num_hidden_layers"]):
        layer = {"wq": (e, h * (dn + dr)), "wkv_a": (e, c + dr),
                 "kv_norm": (c,), "wkv_b": (c, h * (dn + dv)),
                 "wo": (h * dv, e), "input_norm": (e,),
                 "pre_mlp_norm": (e,)}
        if i < cfg["first_k_dense_replace"]:
            layer.update(w1=(e, f), w3=(e, f), w2=(f, e))
        else:
            layer.update(
                router=(e, cfg.get("router_experts",
                                   cfg["n_routed_experts"])),
                experts_w1=(n, e, fe), experts_w3=(n, e, fe),
                experts_w2=(n, fe, e), shared_w1=(e, fs), shared_w3=(e, fs),
                shared_w2=(fs, e))
        shapes.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    shapes.update(final_norm=(e,), head=(e, v))
    return shapes


def make_weights(cfg, seed: int, device, held=None) -> dict:
    """The model's weights from the seed, float32 on ``device``: every
    matrix normal with std 0.02, every norm weight 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(seed, 1))
    out = {}
    for name, shape in weight_shapes(cfg, held).items():
        if name.endswith("norm"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.randn(shape, generator=gen,
                                    device=device) * 0.02
    return out


def _mm(a, b, rnd):
    if rnd is not None:
        a, b = rnd(a), rnd(b)
    return a @ b


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rotary(t, theta):
    """Rotary positions 0.. on ``t`` ``(B, S, heads, D)``: each adjacent
    pair of dims rotated as a complex number, in place."""
    s, d = t.shape[1], t.shape[3]
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, device=t.device)
                               .float() / d)
    angles = torch.outer(torch.arange(s, device=t.device).float(), inv_freq)
    turn = torch.polar(torch.ones_like(angles), angles)[None, :, None, :]
    pairs = torch.view_as_complex(t.float().reshape(*t.shape[:3], d // 2,
                                                    2).contiguous())
    return torch.view_as_real(pairs * turn).reshape(t.shape)


def _attend(q, k, v, q0, rnd):
    """One block of queries ``(bq, H, Dqk)`` against the keys ``(bk, H,
    Dqk)`` and values ``(bk, H, Dv)`` before it, from position 0 and
    ``q0``: a masked softmax."""
    scores = _mm(q.transpose(0, 1), k.permute(1, 2, 0), rnd) / math.sqrt(
        q.shape[-1])                                      # (H, bq, bk)
    qpos = q0 + torch.arange(q.shape[0], device=q.device)[:, None]
    kpos = torch.arange(k.shape[0], device=q.device)[None, :]
    p = torch.softmax(scores.masked_fill(kpos > qpos, float("-inf")), dim=-1)
    return _mm(p, v.transpose(0, 1), rnd).transpose(0, 1)


def _attention(q, k, v, rnd):
    """Causal attention of ``q``, ``k`` ``(B, S, H, Dqk)`` over ``v``
    ``(B, S, H, Dv)``, block by block of queries, each over the keys it
    can see."""
    s = q.shape[1]
    out = []
    for b in range(q.shape[0]):
        rows = []
        for q0 in range(0, s, QUERY_BLOCK):
            q1 = min(s, q0 + QUERY_BLOCK)
            rows.append(checkpoint(_attend, q[b, q0:q1], k[b, :q1],
                                   v[b, :q1], q0, rnd, use_reentrant=False))
        out.append(torch.cat(rows))
    return torch.stack(out)


def _swiglu(x, w1, w3, w2, rnd):
    return _mm(F.silu(_mm(x, w1, rnd)) * _mm(x, w3, rnd), w2, rnd)


def _experts(x, w, pre, cfg, held, rnd, routes, forced=None):
    """The expert layer's share on ``x`` ``(T, E)``: the held experts'
    weighted outputs and the shared experts; each token takes the
    experts ``forced`` names where given."""
    scores = torch.sigmoid(_mm(x, w[pre + "router"], rnd))
    sel = scores.topk(cfg["num_experts_per_tok"], dim=-1).indices
    if routes is not None:
        routes.append(sel.detach())
    if forced is not None:
        sel = forced
    ws = scores.gather(-1, sel)
    if cfg["norm_topk_prob"]:
        ws = ws / ws.sum(-1, keepdim=True)
    ws = ws * cfg["routed_scaling_factor"]
    out = _swiglu(x, w[pre + "shared_w1"], w[pre + "shared_w3"],
                  w[pre + "shared_w2"], rnd)
    for j, e in enumerate(held):
        hit = sel == e
        tokens = hit.any(-1).nonzero().squeeze(1)
        weight = (ws * hit).sum(-1)[tokens]
        y = _swiglu(x[tokens], w[pre + "experts_w1"][j],
                    w[pre + "experts_w3"][j], w[pre + "experts_w2"][j], rnd)
        out = out.index_add(0, tokens, y * weight[:, None])
    return out


def _latent_attention(w, pre, x, cfg, rnd):
    """The attention sublayer on the normed ``x`` ``(B, S, E)``."""
    b, s, _ = x.shape
    h = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    c, eps, theta = cfg["kv_lora_rank"], cfg["rms_norm_eps"], cfg["rope_theta"]
    q = _mm(x, w[pre + "wq"], rnd).reshape(b, s, h, dn + dr)
    ckv = _mm(x, w[pre + "wkv_a"], rnd)
    latent = _rms(ckv[..., :c], w[pre + "kv_norm"], eps)
    kv = _mm(latent, w[pre + "wkv_b"], rnd).reshape(b, s, h, dn + dv)
    k_pe = _rotary(ckv[..., c:].reshape(b, s, 1, dr), theta)
    q = torch.cat((q[..., :dn], _rotary(q[..., dn:], theta)), dim=-1)
    k = torch.cat((kv[..., :dn], k_pe.expand(b, s, h, dr)), dim=-1)
    a = _attention(q, k, kv[..., dn:], rnd)
    return _mm(a.reshape(b, s, h * dv), w[pre + "wo"], rnd)


def _layer(w, i, x, cfg, held, rnd, routes, forced):
    pre = f"layers.{i}."
    eps = cfg["rms_norm_eps"]
    b, s, e = x.shape
    x = x + _latent_attention(w, pre, _rms(x, w[pre + "input_norm"], eps),
                              cfg, rnd)
    yn = _rms(x, w[pre + "pre_mlp_norm"], eps)
    if i < cfg["first_k_dense_replace"]:
        m = _swiglu(yn, w[pre + "w1"], w[pre + "w3"], w[pre + "w2"], rnd)
    else:
        m = _experts(yn.reshape(b * s, e), w, pre, cfg, held, rnd,
                     routes, forced).reshape(b, s, e)
    return x + m


def forward(weights, ids, cfg, held=None, round_fn=None, routes=None,
            forced=None):
    """The logits ``(B, S, vocab)`` of ``ids``, float32. ``routes`` maps a
    layer to a list its tokens' own expert ids are appended to (twice:
    its forward and its recompute); ``forced`` maps a layer to the
    expert ids ``(B * S, topk)`` its tokens take."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    held = _held(cfg, held)
    routes = routes or {}
    forced = forced or {}
    x = weights["embed"][ids]
    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(_layer, weights, i, x, cfg, held, round_fn,
                       routes.get(i), forced.get(i), use_reentrant=False)
    x = _rms(x, weights["final_norm"], cfg["rms_norm_eps"])
    return _mm(x, weights["head"], round_fn)


def loss_and_grads(weights, ids, labels, cfg, names=None, held=None,
                   round_fn=None, routes=None, forced=None):
    """``(loss, grads)``: the mean next-token cross-entropy and its
    gradient with respect to each weight in ``names`` (every weight when
    None), by name."""
    names = list(weights) if names is None else list(names)
    leaves = {n: t.detach().requires_grad_(n in names)
              for n, t in weights.items()}
    logits = forward(leaves, ids, cfg, held, round_fn, routes, forced)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return loss.detach(), dict(zip(names, grads))
