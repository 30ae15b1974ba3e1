"""Plain reference of an ``afmoe`` language model's training step (the
Trinity family): its inputs made from a seed, the forward pass, the
loss and, by autograd, the gradients, in float32.

Plain PyTorch: it imports nothing but ``torch``, and has no kernel and
no cache. TF32 is turned off for every product. Attention is a masked
softmax over the keys a block of queries can see, one block at a time
under activation checkpointing, as is each layer, so that the whole
step fits on one card at 8192 positions.

The equations, for a configuration dict holding the keys of the model's
``config.json`` (``num_experts`` the experts held here, ``router_experts``
the router's width where the two differ):

- ``h = embed[ids] * sqrt(hidden_size)`` (``mup_enabled``);
- each layer ``h = h + post_attn_norm(attn(input_norm(h)))``, then
  ``h = h + post_mlp_norm(mlp(pre_mlp_norm(h)))``, every norm an RMSNorm
  with a weight;
- ``attn(x)``: ``q, k, v = x Wq, x Wk, x Wv``; an RMSNorm of each query
  and key head over its dims; rotary positions on sliding layers only;
  causal grouped-query attention with scale ``1/sqrt(head_dim)``,
  windowed to the last ``sliding_window`` positions on sliding layers;
  the output times ``sigmoid(x Wg)``, then ``Wo``;
- ``mlp`` on the first ``num_dense_layers``: ``W2(silu(W1 x) * W3 x)``;
- on the others, an expert layer: ``s = sigmoid(x Wr)`` over all the
  router's experts, ``sel = topk(s)`` (the score bias held at 0),
  ``w = s[sel] / sum(s[sel]) * route_scale``, and ``out = shared(x) +
  sum over held e in sel of w_e * expert_e(x)``, every expert a SwiGLU;
  the absent experts' part is left out;
- a final RMSNorm, the head, and the mean cross-entropy of each next
  token over the vocabulary rows held here.

``round_fn``, where given, rounds both operands of every product (the
control: :func:`fp8_round`). ``forced``, where given, maps an expert
layer to the expert ids its tokens take in place of ``topk(s)`` (the
choices of the run under judgement, so that a choice flipped by rounding
moves no gradient); ``routes`` still records ``topk(s)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: queries of one attention block
QUERY_BLOCK = 1024

#: the control's format: float8 e4m3, whose largest finite value is 448
FP8_MAX = 448.0


def _held(cfg, held=None):
    return list(range(cfg["num_experts"])) if held is None else list(held)


def weight_shapes(cfg, held=None) -> dict:
    """Each weight's shape by name, in the order :func:`make_weights`
    draws them; every matrix is ``(in, out)``, the embedding ``(vocab,
    hidden)``."""
    e, v = cfg["hidden_size"], cfg["vocab_size"]
    hd = cfg["num_attention_heads"] * cfg["head_dim"]
    kvd = cfg["num_key_value_heads"] * cfg["head_dim"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs = cfg["num_shared_experts"] * fe
    n = len(_held(cfg, held))
    shapes = {"embed": (v, e)}
    for i in range(cfg["num_hidden_layers"]):
        layer = {"wq": (e, hd), "wk": (e, kvd), "wv": (e, kvd),
                 "wg": (e, hd), "wo": (hd, e), "input_norm": (e,),
                 "post_attn_norm": (e,), "pre_mlp_norm": (e,),
                 "post_mlp_norm": (e,), "q_norm": (cfg["head_dim"],),
                 "k_norm": (cfg["head_dim"],)}
        if i < cfg["num_dense_layers"]:
            layer.update(w1=(e, f), w3=(e, f), w2=(f, e))
        else:
            layer.update(
                router=(e, cfg.get("router_experts", cfg["num_experts"])),
                experts_w1=(n, e, fe), experts_w3=(n, e, fe),
                experts_w2=(n, fe, e), shared_w1=(e, fs), shared_w3=(e, fs),
                shared_w2=(fs, e))
        shapes.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    shapes.update(final_norm=(e,), head=(e, v))
    return shapes


def _mix(seed: int, salt: int) -> int:
    """A generator seed from a run's seed and a salt."""
    return (seed * 6364136223846793005 + salt * 1442695040888963407
            + 1) % 2**63


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


def make_batch(vocab: int, batch: int, seq: int, zipf_s: float, seed: int,
               step: int, device):
    """``(ids, labels)`` of one step, each ``(batch, seq)`` int64 on
    ``device``: token ranks drawn Zipf with exponent ``zipf_s`` from
    (seed, step), over a permutation of the ``vocab`` rows drawn from the
    seed; the labels are the next tokens (one document per sequence, no
    packing).

    The draw is made on the host, whatever ``device`` is: the program and
    the reference each draw a judged step's batch, and on an H100 the
    same CUDA generator state gave another batch in 4 draws of 26, which
    read as a gradient gap of 0.17 against a step that was sound."""
    gen = torch.Generator()
    gen.manual_seed(_mix(seed, 2))
    perm = torch.randperm(vocab, generator=gen)
    p = torch.arange(1, vocab + 1, dtype=torch.float64) ** -zipf_s
    gen.manual_seed(_mix(seed, 1000 + step))
    draw = torch.multinomial(p.float(), batch * (seq + 1), replacement=True,
                             generator=gen)
    tokens = perm[draw].reshape(batch, seq + 1).to(device)
    return tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 after scaling its amax to 448, and
    scaled back; gradients pass through unchanged."""
    x = t.detach()
    if x.numel() == 0:
        return t
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - x)


def _mm(a, b, rnd):
    if rnd is not None:
        a, b = rnd(a), rnd(b)
    return a @ b


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rotary(t, theta):
    """Rotary positions 0.. on ``t`` ``(B, S, heads, D)``: each head's
    halves rotated (``rotate_half``)."""
    s, d = t.shape[1], t.shape[3]
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, device=t.device)
                               .float() / d)
    freqs = torch.outer(torch.arange(s, device=t.device).float(), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)[None, :, None, :]
    x1, x2 = t[..., :d // 2], t[..., d // 2:]
    return t * emb.cos() + torch.cat((-x2, x1), dim=-1) * emb.sin()


def _attend(q, k, v, q0, k0, window, rnd):
    """One block of queries ``(bq, H, D)`` against keys and values
    ``(bk, KV, D)`` at positions ``q0..`` and ``k0..``: a masked softmax."""
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scores = _mm(q.transpose(0, 1), k.permute(1, 2, 0), rnd) / math.sqrt(
        q.shape[-1])                                      # (H, bq, bk)
    qpos = q0 + torch.arange(q.shape[0], device=q.device)[:, None]
    kpos = k0 + torch.arange(k.shape[0], device=q.device)[None, :]
    dead = kpos > qpos
    if window is not None:
        dead = dead | (kpos <= qpos - window)
    p = torch.softmax(scores.masked_fill(dead, float("-inf")), dim=-1)
    return _mm(p, v.transpose(0, 1), rnd).transpose(0, 1)


def _attention(q, k, v, window, rnd):
    """Causal attention of ``q`` ``(B, S, H, D)`` over ``k``, ``v``
    ``(B, S, KV, D)``, block by block of queries, each over the keys it
    can see."""
    s = q.shape[1]
    out = []
    for b in range(q.shape[0]):
        rows = []
        for q0 in range(0, s, QUERY_BLOCK):
            q1 = min(s, q0 + QUERY_BLOCK)
            k0 = 0 if window is None else max(0, q0 - window + 1)
            rows.append(checkpoint(_attend, q[b, q0:q1], k[b, k0:q1],
                                   v[b, k0:q1], q0, k0, window, rnd,
                                   use_reentrant=False))
        out.append(torch.cat(rows))
    return torch.stack(out)


def _swiglu(x, w1, w3, w2, rnd):
    return _mm(F.silu(_mm(x, w1, rnd)) * _mm(x, w3, rnd), w2, rnd)


def _experts(x, w, pre, cfg, held, rnd, routes, forced=None):
    """The expert layer's share on ``x`` ``(T, E)``: the held experts'
    weighted outputs and the shared expert; each token takes the experts
    ``forced`` names where given."""
    scores = torch.sigmoid(_mm(x, w[pre + "router"], rnd))
    sel = scores.topk(cfg["num_experts_per_tok"], dim=-1).indices
    if routes is not None:
        routes.append(sel.detach())
    if forced is not None:
        sel = forced
    ws = scores.gather(-1, sel)
    if cfg["route_norm"]:
        ws = ws / ws.sum(-1, keepdim=True)
    ws = ws * cfg["route_scale"]
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


def _layer(w, i, x, cfg, held, rnd, routes, forced):
    pre = f"layers.{i}."
    eps = cfg["rms_norm_eps"]
    b, s, e = x.shape
    h, kv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    xn = _rms(x, w[pre + "input_norm"], eps)
    q = _rms(_mm(xn, w[pre + "wq"], rnd).reshape(b, s, h, d),
             w[pre + "q_norm"], eps)
    k = _rms(_mm(xn, w[pre + "wk"], rnd).reshape(b, s, kv, d),
             w[pre + "k_norm"], eps)
    v = _mm(xn, w[pre + "wv"], rnd).reshape(b, s, kv, d)
    sliding = cfg["layer_types"][i] == "sliding_attention"
    if sliding:
        q, k = _rotary(q, cfg["rope_theta"]), _rotary(k, cfg["rope_theta"])
    a = _attention(q, k, v, cfg["sliding_window"] if sliding else None, rnd)
    a = a.reshape(b, s, h * d) * torch.sigmoid(_mm(xn, w[pre + "wg"], rnd))
    x = x + _rms(_mm(a, w[pre + "wo"], rnd), w[pre + "post_attn_norm"], eps)
    yn = _rms(x, w[pre + "pre_mlp_norm"], eps)
    if i < cfg["num_dense_layers"]:
        m = _swiglu(yn, w[pre + "w1"], w[pre + "w3"], w[pre + "w2"], rnd)
    else:
        m = _experts(yn.reshape(b * s, e), w, pre, cfg, held, rnd,
                     routes, forced).reshape(b, s, e)
    return x + _rms(m, w[pre + "post_mlp_norm"], eps)


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
    if cfg["mup_enabled"]:
        x = x * math.sqrt(cfg["hidden_size"])
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
