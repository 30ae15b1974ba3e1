"""The port's ``afmoe`` language model (the Trinity family) against its
plain float32 reference, on the CPU at a small size: hidden 64, 4 query
and 2 key/value heads of 16, 64 positions, window 16, layers
``S,S,S,F,S,S,S,F`` of which 2 dense, 16 experts of which each token
picks 4, one shared expert, a vocabulary of 97.

The reference is the benchmark's (``smibench/references/
trinity_mini-ep16.py``, which imports only ``torch``); the model runs the port's normal path: ``stack_shard`` over
``block_shard`` with ``ring_attention_shard`` (its plain tier here) and
the expert layer of ``models/moe.py``, trained by ``make_train_step``.
Tolerances, each with its reason, are beside the tests.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import smi_tpu_torch as st
from smi_tpu_torch.models import moe
from smi_tpu_torch.models import transformer as ttf
from smibench import spec

ROOT = Path(__file__).resolve().parents[1]
ref = spec.load_module("references", "trinity_mini-ep16")

SMALL = {
    "model_type": "afmoe", "num_hidden_layers": 8, "num_dense_layers": 2, "hidden_size": 64,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "layer_types": (["sliding_attention"] * 3 + ["full_attention"]) * 2,
    "sliding_window": 16, "intermediate_size": 96,
    "moe_intermediate_size": 32, "num_experts": 16,
    "num_experts_per_tok": 4, "num_shared_experts": 1, "route_scale": 2.826,
    "route_norm": True, "score_func": "sigmoid", "rms_norm_eps": 1e-5,
    "rope_theta": 10000, "mup_enabled": True, "vocab_size": 97,
    "tie_word_embeddings": False,
}
SEQ = 64
SEED = 2**31 + 7

#: f32 on both sides: the same equations, the products summed in another
#: order (one fused q/k/v product, the ring's blockwise online softmax,
#: gathered expert rows): a few ulps a layer over 8 layers
F32_TOL = 2e-5
#: bf16 products against f32: each product rounds to 8 bits of
#: mantissa (2^-9 relative); over 8 layers the errors add to ~1e-2
BF16_TOL = 5e-2


@pytest.fixture
def comm11():
    return st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device="cpu")


def _setup(cfg=SMALL, seed=SEED, dtype="float32"):
    weights = ref.make_weights(cfg, seed, "cpu")
    ids, labels = ref.make_batch(cfg["vocab_size"], 2, SEQ, 1.1, seed, 0,
                                 "cpu")
    model = ttf.LanguageModel.from_config(cfg, weights=weights,
                                          compute_dtype=dtype, device="cpu")
    return weights, ids, labels, model


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def test_model_matches_reference_in_f32(comm11):
    weights, ids, labels, model = _setup()
    want = ref.forward(weights, ids, SMALL)
    got = model(ids, comm11)
    assert _rel(got, want) < F32_TOL
    loss, grads = ref.loss_and_grads(weights, ids, labels, SMALL)
    step = ttf.make_train_step(comm11, model.config, layers=8)
    assert abs(float(step(model, ids, labels)) - float(loss)) < F32_TOL
    mine = model.reference_names(grads=True)
    assert set(mine) == set(grads) == set(ref.weight_shapes(SMALL))
    for name, g in grads.items():
        assert _rel(mine[name] / ids.numel(), g) < F32_TOL, name


@pytest.mark.parametrize("name", ["layers.0.wq", "layers.4.experts_w2",
                                  "head"])
def test_a_weight_of_the_wrong_shape_is_refused(name):
    weights = ref.make_weights(SMALL, SEED, "cpu")
    weights[name] = weights[name][..., :-1]
    with pytest.raises(ValueError, match=name):
        ttf.LanguageModel.from_config(SMALL, weights=weights, device="cpu")


def test_bf16_model_matches_reference_where_no_route_flips(comm11):
    """Dense layers only: routing choices near a tie flip under bf16
    rounding and move an expert layer's output by a whole expert's
    share, which no rounding tolerance bounds."""
    cfg = dict(SMALL, num_dense_layers=8)
    weights, ids, labels, model = _setup(cfg, dtype="bfloat16")
    assert _rel(model(ids, comm11), ref.forward(weights, ids, cfg)) < \
        BF16_TOL
    loss, grads = ref.loss_and_grads(weights, ids, labels, cfg)
    step = ttf.make_train_step(comm11, model.config, layers=8)
    # the loss is an average of 128 log-probabilities near log(97)
    assert abs(float(step(model, ids, labels)) - float(loss)) < 1e-2
    mine = model.reference_names(grads=True)
    for name, g in grads.items():
        assert _rel(mine[name] / ids.numel(), g) < BF16_TOL, name


def test_train_step_updates_by_the_reference_gradient(comm11):
    weights, ids, labels, model = _setup()
    lr = 0.5
    _, grads = ref.loss_and_grads(weights, ids, labels, SMALL)
    ttf.make_train_step(comm11, model.config, lr=lr, layers=8)(
        model, ids, labels)
    after = model.reference_names()
    for name in ("layers.0.wq", "layers.3.wg", "layers.5.experts_w1",
                 "embed", "head"):
        delta = after[name].detach() - weights[name]
        assert _rel(delta, -lr * grads[name]) < 1e-4, name


def _expert_inputs(tokens=48, seed=3):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(tokens, SMALL["hidden_size"], generator=gen)
    w = {f"l.{n}": t for n, t in ref.make_weights(
        SMALL, seed, "cpu").items()}
    whole = {n[len("l.layers.2."):]: t for n, t in w.items()
             if n.startswith("l.layers.2.")}
    return x, whole


def _f32_mm(a, w):
    return a @ w


def _expert_config(held):
    return moe.ExpertConfig(router=16, topk=4, width=32, held=held,
                            route_scale=SMALL["route_scale"])


def test_shares_of_eight_ranks_add_up_to_the_whole_layer():
    """Eight ranks of two experts each: their outputs less the shared
    expert, summed, plus the shared expert once, are the reference's
    whole layer (f32, the same sums in another order)."""
    x, whole = _expert_inputs()
    want = ref._experts(x, {f"p.{n}": t for n, t in whole.items()}, "p.",
                        SMALL, list(range(16)), None, None)
    shared = moe.swiglu(x, whole["shared_w1"], whole["shared_w3"],
                         whole["shared_w2"], _f32_mm)
    total = shared.clone()
    for rank in range(8):
        held = (2 * rank, 2 * rank + 1)
        params = dict(whole)
        for name in ("experts_w1", "experts_w3", "experts_w2"):
            params[name] = whole[name][list(held)]
        share = moe.expert_layer(params, x, _expert_config(held), _f32_mm,
                                 torch.float32)
        total += share - shared
    assert _rel(total, want) < F32_TOL
    # a share alone is not the layer
    assert _rel(share, want) > 0.1


def test_forced_imbalance_drops_no_token():
    """The router sends every token to expert 0 (held, with expert 1):
    it takes all 48, and the share equals the reference's."""
    x, whole = _expert_inputs()
    x = x.abs()
    whole["router"] = whole["router"].clone()
    whole["router"][:, 0] = 1.0
    held = (0, 1)
    params = dict(whole)
    for name in ("experts_w1", "experts_w3", "experts_w2"):
        params[name] = whole[name][list(held)]
    moe.reset_counters()
    cache = {}
    got = moe.expert_layer(params, x, _expert_config(held), _f32_mm,
                           torch.float32, cache)
    assert (cache["sel"] == 0).any(-1).all()
    assert cache["loads"][0] == moe.COUNTERS["max_expert_load"] == x.shape[0]
    want = ref._experts(x, {f"p.{n}": t for n, t in params.items()}, "p.",
                        SMALL, list(held), None, None)
    assert _rel(got, want) < F32_TOL


def test_held_experts_no_token_picks_give_the_shared_expert_alone():
    x, whole = _expert_inputs()
    x = x.abs()
    whole["router"] = whole["router"].clone()
    whole["router"][:, :4] = 1.0        # every token picks experts 0-3
    held = (14, 15)
    params = dict(whole)
    for name in ("experts_w1", "experts_w3", "experts_w2"):
        params[name] = whole[name][list(held)]
    cache = {}
    got = moe.expert_layer(params, x, _expert_config(held), _f32_mm,
                           torch.float32, cache)
    assert cache["loads"] == [0, 0]
    shared = moe.swiglu(x, whole["shared_w1"], whole["shared_w3"],
                         whole["shared_w2"], _f32_mm)
    assert torch.equal(got, shared)


@pytest.mark.parametrize("kind, sees_first", [("full", True),
                                               ("sliding", False)])
def test_a_query_past_the_window_sees_the_first_key_on_full_layers_only(
        comm11, kind, sees_first):
    cfg = ttf.afmoe_block_config(dict(SMALL, num_hidden_layers=1,
                                      num_dense_layers=1,
                                      layer_types=[f"{kind}_attention"]),
                                 compute_dtype="float32")
    block = cfg.layer(0)
    assert block.window == (16 if kind == "sliding" else None)
    shapes = ttf.param_shapes(block)
    gen = torch.Generator().manual_seed(1)
    params = {n: (torch.ones(s) if n.endswith("norm")
                  else torch.randn(s, generator=gen) * 0.1)
              for n, s in shapes.items()}
    x = torch.randn(1, SEQ, 64, generator=gen, requires_grad=True)
    out = ttf.block_shard(params, x, comm11, block)
    out[0, 40].sum().backward()
    reach = x.grad[0, 0].abs().max().item()
    assert (reach > 0) == sees_first
    # inside the window both kinds see every earlier key
    assert x.grad[0, 30].abs().max().item() > 0


@pytest.mark.parametrize("family, window, moves", [
    ("afmoe", 8, True), ("afmoe", None, False), ("jax", 8, False)])
def test_rope_reaches_windowed_afmoe_layers_only(comm11, monkeypatch,
                                                 family, window, moves):
    """Rotary positions move a windowed ``afmoe`` layer's output; a full
    layer, and the JAX package's block, take no positions."""
    block = ttf.BlockConfig(embed=32, heads=2, head_dim=16, window=window,
                            family=family)
    gen = torch.Generator().manual_seed(5)
    params = {n: torch.randn(s, generator=gen) * 0.2
              for n, s in ttf.param_shapes(block).items()}
    x = torch.randn(1, 24, 32, generator=gen)
    base = ttf.block_shard(params, x, comm11, block)
    # tables that rotate by 0: every head as it came
    monkeypatch.setattr(ttf, "_rope_tables",
                        lambda s, d, offset, theta, device: (
                            torch.ones(s, d), torch.zeros(s, d)))
    plain = ttf.block_shard(params, x, comm11, block)
    assert torch.equal(base, plain) != moves


def _old_block(params, x, comm, config):
    """The block as it was before the options: layernorm, GELU, no
    positions, one window."""
    b, s, e = x.shape
    h, d, kv, cd = config.heads, config.head_dim, config._kv, config._cdtype

    def mm(a, w):
        return (a.to(cd) @ params[w].to(cd)).float()

    def ln(t):
        mu = t.mean(dim=-1, keepdim=True)
        var = ((t - mu) ** 2).mean(dim=-1, keepdim=True)
        return (t - mu) * torch.rsqrt(var + 1e-6)

    qkv = mm(ln(x).reshape(b * s, e), "wqkv").reshape(b, s, h + 2 * kv, d)

    def fold(t, hx):
        return t.transpose(0, 1).reshape(s, b * hx, d).to(cd)

    attn = st.models.ring_attention.ring_attention_shard(
        fold(qkv[:, :, :h], h), fold(qkv[:, :, h:h + kv], kv),
        fold(qkv[:, :, h + kv:], kv), comm, causal=config.causal,
        axis_name="sp", window=config.window).float()
    attn = attn.reshape(s, b, h * d).transpose(0, 1)
    x = x + mm(attn.reshape(b * s, h * d), "wo").reshape(b, s, e)
    mlp = mm(torch.nn.functional.gelu(mm(ln(x).reshape(b * s, e), "w1"),
                                      approximate="tanh"), "w2")
    return x + mlp.reshape(b, s, e)


@pytest.mark.parametrize("kw", [
    dict(embed=32, heads=2, head_dim=16),
    dict(embed=32, heads=4, head_dim=16, kv_heads=2, window=8),
    dict(embed=32, heads=2, head_dim=16, compute_dtype="bfloat16"),
])
def test_old_block_defaults_are_bit_for_bit(comm11, kw):
    cfg = ttf.BlockConfig(**kw)
    assert (cfg.family, cfg.mlp, cfg.layer_types) == ("jax", "gelu", None)
    assert cfg.layer(5) is cfg
    params = {n: torch.tensor(a) for n, a in ttf.init_params(cfg, 4).items()}
    assert set(params) == set(ttf.param_shapes(cfg))
    x = torch.randn(2, 24, 32, generator=torch.Generator().manual_seed(2))
    assert torch.equal(ttf.block_shard(params, x, comm11, cfg),
                       _old_block(params, x, comm11, cfg))


def test_counters_count_one_read_a_layer_and_step(comm11):
    _, ids, labels, model = _setup()
    step = ttf.make_train_step(comm11, model.config, layers=8)
    moe.reset_counters()
    step(model, ids, labels)
    # 6 expert layers read their counts in the forward; the recompute
    # reuses them. Each token's 4 choices land on the 16 experts held here
    assert moe.COUNTERS["host_reads"] == 6
    assert moe.COUNTERS["held_assignments"] == 6 * ids.numel() * 4
    assert 0 < moe.COUNTERS["max_expert_load"] <= ids.numel()


def test_recompute_routes_as_the_forward(comm11, monkeypatch):
    """The backward's recompute of an expert layer takes its forward's
    expert ids (a cache hit) and makes no read of its own."""
    _, ids, labels, model = _setup()
    calls = []
    layer = moe.expert_layer

    def spy(params, x, cfg, mm, dtype, cache=None):
        calls.append("hit" if cache and "loads" in cache else "miss")
        return layer(params, x, cfg, mm, dtype, cache)

    monkeypatch.setattr(moe, "expert_layer", spy)
    ttf.make_train_step(comm11, model.config, layers=8)(model, ids, labels)
    assert calls == ["miss"] * 6 + ["hit"] * 6
    assert [bool(r) for r in model.routing] == [False] * 2 + [True] * 6
    for cache in model.routing[2:]:
        assert cache["sel"].shape == (ids.numel(), 4)
        assert sum(cache["loads"]) == ids.numel() * 4


def test_spans_of_a_step(comm11):
    _, ids, labels, model = _setup()
    step = ttf.make_train_step(comm11, model.config, layers=8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(model, ids, labels)
    names = {e.name for e in prof.events()}
    assert {"smi.train.step", "smi.train.forward", "smi.train.backward",
            "smi.train.update", "smi.attn.sliding", "smi.attn.full",
            "smi.moe.route", "smi.moe.dispatch", "smi.moe.experts",
            "smi.moe.combine", "smi.lm.head"} <= names


@pytest.mark.parametrize("key, value", [
    ("score_func", "softmax"), ("n_group", 2), ("hidden_act", "gelu"),
    ("tie_word_embeddings", True), ("rope_scaling", {"type": "yarn"}),
])
def test_config_the_port_does_not_run_is_refused(key, value):
    with pytest.raises(ValueError, match=key):
        ttf.afmoe_block_config(dict(SMALL, **{key: value}))


@pytest.mark.parametrize("kw, match", [
    (dict(family="llama"), "family"), (dict(mlp="relu"), "mlp"),
    (dict(mlp="experts"), "ExpertConfig"),
    (dict(layer_types=("sliding",)), "window"),
    (dict(layer_types=("full",), layer_mlps=("gelu", "gelu")), "length"),
])
def test_block_config_refuses_unknown_options(kw, match):
    with pytest.raises(ValueError, match=match):
        ttf.BlockConfig(**kw)


def test_benchmark_configuration_holds_the_published_sizes():
    """The benchmark's Trinity-Mini cut (without allocating): 2 dense
    layers of 65.0 M, 30 expert layers of 84.2 M with 8 of 128 experts,
    the embedding and head of 25,024 rows: 2,757,240,832 parameters
    (2.7572 B; the per-layer sizes rounded first sum to 2.7585 B)."""
    cfg = json.loads((ROOT / "smibench" / "configs"
                      / "trinity_mini-ep16.json").read_text())
    block = ttf.afmoe_block_config(cfg)
    assert block.experts.router == 128 and block.experts.held == tuple(
        range(8))
    assert block.layer(3).window is None and block.layer(4).window == 2048
    shapes = ttf.LanguageModel._shapes(block, 32, cfg["vocab_size"])
    assert shapes == ref.weight_shapes(cfg)

    def count(prefix):
        return sum(math.prod(s) for n, s in shapes.items()
                   if n.startswith(prefix))

    assert round(count("layers.0.") / 1e6, 1) == 65.0
    assert round(count("layers.2.") / 1e6, 1) == 84.2
    assert sum(math.prod(s) for s in shapes.values()) == 2_757_240_832


def test_reference_imports_only_torch():
    path = ROOT / "smibench" / "references" / "trinity_mini-ep16.py"
    script = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('r', {str(path)!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"smi_tpu_torch", "smi_tpu", "jax", "jaxlib"}
