"""The port's ``deepseek_v3`` language model (Moonlight-16B-A3B's block:
latent attention and sigmoid-routed experts with shared ones) against its
plain float32 reference, and the flash kernels' plain versions at a
value head dim narrower than the query and key one, on the CPU at a
small size: hidden 64, 2 heads, a latent of 32, 16 dims without
positions and 8 rotated ones against values of 16, 3 layers of which the
first dense, 8 router experts of which 2 held, 2 shared, 64 positions.

The reference is the benchmark's (``smibench/references/
moonlight_16b_a3b-ep8.py``); the model runs the port's normal path:
``LanguageModel.from_config``, ``stack_shard`` over ``block_shard`` with
``ring_attention_shard`` and the expert layer of ``models/moe.py``,
trained by ``make_train_step``. Tolerances, each with its reason, are
beside the tests.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import smi_tpu_torch as st
from smi_tpu_torch.kernels import flash as kflash
from smi_tpu_torch.models import moe
from smi_tpu_torch.models import transformer as ttf
from smibench import spec

ROOT = Path(__file__).resolve().parents[1]
ref = spec.load_module("references", "moonlight_16b_a3b-ep8")

SMALL = {
    "model_type": "deepseek_v3", "num_hidden_layers": 3,
    "first_k_dense_replace": 1, "hidden_size": 64,
    "num_attention_heads": 2, "num_key_value_heads": 2,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "intermediate_size": 96, "moe_intermediate_size": 32,
    "n_routed_experts": 2, "router_experts": 8, "num_experts_per_tok": 3,
    "n_shared_experts": 2, "routed_scaling_factor": 2.446,
    "norm_topk_prob": True, "scoring_func": "sigmoid", "rms_norm_eps": 1e-5,
    "rope_theta": 50000, "vocab_size": 97, "tie_word_embeddings": False,
    "hidden_act": "silu", "q_lora_rank": None, "n_group": 1,
    "topk_group": 1, "topk_method": "noaux_tc",
}
SEQ = 64
SEED = 2**31 + 11

#: f32 on both sides: the same equations, the products summed in another
#: order (the ring's blockwise online softmax, the rotations as a real
#: 2x2 turn of halves against the reference's complex pairs, gathered
#: expert rows): a few ulps a layer over 3 layers
F32_TOL = 2e-5


@pytest.fixture
def comm11():
    return st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device="cpu")


def _setup(cfg=SMALL, seed=SEED):
    weights = ref.make_weights(cfg, seed, "cpu")
    ids, labels = ref.make_batch(cfg["vocab_size"], 2, SEQ, 1.1, seed, 0,
                                 "cpu")
    model = ttf.LanguageModel.from_config(cfg, weights=weights,
                                          compute_dtype="float32",
                                          device="cpu")
    return weights, ids, labels, model


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


# -- the model against the reference ------------------------------------

def test_model_matches_reference_on_one_rank(comm11):
    weights, ids, labels, model = _setup()
    assert _rel(model(ids, comm11), ref.forward(weights, ids, SMALL)) < \
        F32_TOL
    loss, grads = ref.loss_and_grads(weights, ids, labels, SMALL)
    step = ttf.make_train_step(comm11, model.config, layers=3)
    assert abs(float(step(model, ids, labels)) - float(loss)) < F32_TOL
    mine = model.reference_names(grads=True)
    assert set(mine) == set(grads) == set(ref.weight_shapes(SMALL))
    for name, g in grads.items():
        assert _rel(mine[name] / ids.numel(), g) < F32_TOL, name


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_model_matches_reference_on_two_sequence_ranks(use_flash):
    """A (dp, sp) = (1, 2) grid of rank threads: each rank holds half of
    every sequence, its rotary positions at its offset, and the ring
    carries the keys and values over both halves. The two ranks' summed
    losses and gradients are the reference's over the whole sequence
    (``use_flash``: the flash tier's autograd function over the kernels'
    plain versions, the split head dims end to end)."""
    weights, ids, labels, _ = _setup()
    world = st.LocalWorld((1, 2), ("dp", "sp"), device="cpu")
    models = [ttf.LanguageModel.from_config(SMALL, weights=weights,
                                            compute_dtype="float32",
                                            device="cpu") for _ in range(2)]
    half = SEQ // 2

    def rank(comm):
        r = comm.rank
        cut = slice(r * half, (r + 1) * half)
        loss = models[r].loss(ids[:, cut].contiguous(),
                              labels[:, cut].contiguous(), comm,
                              use_flash=use_flash)
        loss.backward()
        return loss.detach()

    losses = world.run(rank)
    loss, grads = ref.loss_and_grads(weights, ids, labels, SMALL)
    assert abs(float(sum(losses)) / ids.numel() - float(loss)) < F32_TOL
    mine = [m.reference_names(grads=True) for m in models]
    for name, g in grads.items():
        assert _rel((mine[0][name] + mine[1][name]) / ids.numel(), g) < \
            F32_TOL, name


def test_train_step_updates_by_the_reference_gradient(comm11):
    weights, ids, labels, model = _setup()
    lr = 0.5
    _, grads = ref.loss_and_grads(weights, ids, labels, SMALL)
    ttf.make_train_step(comm11, model.config, lr=lr, layers=3)(
        model, ids, labels)
    after = model.reference_names()
    for name in ("layers.0.wkv_a", "layers.0.kv_norm", "layers.1.wkv_b",
                 "layers.2.experts_w1", "embed", "head"):
        delta = after[name].detach() - weights[name]
        assert _rel(delta, -lr * grads[name]) < 1e-4, name


@pytest.mark.parametrize("part", ["latent_norm", "k_pe_rope",
                                  "interleave"])
def test_each_part_of_the_attention_moves_the_output_past_the_bar(
        comm11, monkeypatch, part):
    """The latent norm left out, the rotation left off ``k_pe``, and the
    pairs rotated as halves without laying them out first (the layout of
    a model without ``rope_interleave``) each move the logits far past
    the f32 tolerance from the reference's."""
    weights, ids, _, model = _setup()
    if part == "latent_norm":
        norm = ttf.F.rms_norm
        monkeypatch.setattr(ttf.F, "rms_norm", lambda x, shape, w, eps: (
            x * w if shape == (SMALL["kv_lora_rank"],)
            else norm(x, shape, w, eps)))
    elif part == "k_pe_rope":
        rotate = ttf.glue._rotate
        monkeypatch.setattr(ttf.glue, "_rotate", lambda t, cos, sin: (
            t if t.shape[2] == 1 else rotate(t, cos, sin)))
    else:
        monkeypatch.setattr(ttf, "_pairs_to_halves", lambda t: t)
    got = model(ids, comm11)
    assert _rel(got, ref.forward(weights, ids, SMALL)) > 1e-3


def test_bf16_model_tracks_the_reference(comm11):
    """bf16 products against f32, dense layers only (an expert choice
    near a tie flips under rounding and moves a layer by a whole
    expert's share): within 5e-2, as the Trinity model's bar."""
    cfg = dict(SMALL, first_k_dense_replace=3)
    weights, ids, labels, _ = _setup(cfg)
    model = ttf.LanguageModel.from_config(cfg, weights=weights,
                                          compute_dtype="bfloat16",
                                          device="cpu")
    assert _rel(model(ids, comm11), ref.forward(weights, ids, cfg)) < 5e-2


def test_spans_of_a_step(comm11):
    _, ids, labels, model = _setup()
    step = ttf.make_train_step(comm11, model.config, layers=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(model, ids, labels)
    names = [e.name for e in prof.events()]
    assert {"smi.train.step", "smi.attn.mla", "smi.mla.latent",
            "smi.mla.keys", "smi.moe.route", "smi.lm.head"} <= set(names)
    assert not {"smi.attn.full", "smi.attn.sliding"} & set(names)
    # each layer's latent and keys once in the forward, once in the
    # recompute
    assert names.count("smi.mla.latent") == names.count("smi.mla.keys") == 6


# -- the expert layer's shares -------------------------------------------

def test_shares_of_four_ranks_add_up_to_the_whole_layer():
    """Four ranks of two of the 8 experts each: their outputs less the
    shared experts, summed, plus the shared experts once, are the
    reference's uncut layer (f32, the same sums in another order)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(48, SMALL["hidden_size"], generator=gen)
    uncut = dict(SMALL, n_routed_experts=8)
    whole = {n[len("layers.1."):]: t for n, t in ref.make_weights(
        uncut, 3, "cpu").items() if n.startswith("layers.1.")}
    want = ref._experts(x, {f"p.{n}": t for n, t in whole.items()}, "p.",
                        uncut, list(range(8)), None, None)
    block = ttf.deepseek_v3_block_config(uncut, compute_dtype="float32")
    experts = block.experts
    assert (experts.router, experts.topk, experts.shared) == (8, 3, 2)

    def mm(a, w):
        return a @ w

    shared = moe.swiglu(x, whole["shared_w1"], whole["shared_w3"],
                        whole["shared_w2"], mm)
    total = shared.clone()
    for rank in range(4):
        held = (2 * rank, 2 * rank + 1)
        params = dict(whole)
        for name in ("experts_w1", "experts_w3", "experts_w2"):
            params[name] = whole[name][list(held)]
        cfg = moe.ExpertConfig(router=8, topk=3, width=32, held=held,
                               shared=2, route_scale=2.446)
        share = moe.expert_layer(params, x, cfg, mm, torch.float32)
        total += share - shared
    assert _rel(total, want) < F32_TOL
    assert _rel(share, want) > 0.1


# -- the configuration ----------------------------------------------------

def test_from_config_refuses_an_unknown_model_type():
    with pytest.raises(ValueError, match="model_type 'llama'"):
        ttf.LanguageModel.from_config(dict(SMALL, model_type="llama"),
                                      device="cpu")


def test_from_config_refuses_a_config_without_a_model_type():
    cfg = {k: v for k, v in SMALL.items() if k != "model_type"}
    with pytest.raises(ValueError, match="model_type None"):
        ttf.LanguageModel.from_config(cfg, device="cpu")


@pytest.mark.parametrize("key, value", [
    ("q_lora_rank", 1536), ("rope_scaling", {"type": "yarn"}),
    ("n_group", 8), ("scoring_func", "softmax"),
    ("num_nextn_predict_layers", 1), ("moe_layer_freq", 2),
])
def test_config_the_port_does_not_run_is_refused(key, value):
    with pytest.raises(ValueError, match=key):
        ttf.deepseek_v3_block_config(dict(SMALL, **{key: value}))


def test_block_config_refuses_an_mla_block_without_its_sizes():
    with pytest.raises(ValueError, match="latent"):
        ttf.BlockConfig(family="mla", rope_dim=8)
    with pytest.raises(ValueError, match="rope_dim"):
        ttf.BlockConfig(family="mla", latent=32, rope_dim=7)


def test_benchmark_configuration_holds_the_published_sizes():
    """The benchmark's Moonlight-16B-A3B cut (without allocating): the
    dense layer of 83.0 M, 26 expert layers of 100.4 M with 8 of 64
    experts, the embedding and head of 20,480 rows: 2,777,411,072
    parameters (11.1 GB of f32)."""
    cfg = json.loads((ROOT / "smibench" / "configs"
                      / "moonlight_16b_a3b-ep8.json").read_text())
    block = ttf.deepseek_v3_block_config(cfg)
    assert block.experts.router == 64 and block.experts.held == tuple(
        range(8))
    assert (block.head_dim + block.rope_dim, block._v_dim) == (192, 128)
    assert block.layer(0).mlp == "swiglu" and block.layer(1).mlp == \
        "experts"
    shapes = ttf.LanguageModel._shapes(block, 27, cfg["vocab_size"])
    assert shapes == ref.weight_shapes(cfg)

    def count(prefix):
        return sum(math.prod(s) for n, s in shapes.items()
                   if n.startswith(prefix))

    assert round(count("layers.0.") / 1e6, 1) == 83.0
    assert round(count("layers.1.") / 1e6, 1) == 100.4
    assert sum(math.prod(s) for s in shapes.values()) == 2_777_411_072


def test_reference_imports_no_program():
    path = ROOT / "smibench" / "references" / "moonlight_16b_a3b-ep8.py"
    script = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
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


# -- the flash kernels' plain versions at split head dims ----------------

def _dense(q, k, v, q_off, k_off, causal, scale):
    """Softmax attention of ``q`` ``(H, Sq, D)`` over ``k`` ``(H_kv, Sk,
    D)`` and ``v`` ``(H_kv, Sk, Dv)`` in float64, masked causally by
    global positions."""
    group = q.shape[0] // k.shape[0]
    k, v = (t.double().repeat_interleave(group, 0) for t in (k, v))
    s = q.double() @ k.transpose(1, 2) * scale
    if causal:
        qp = q_off + torch.arange(q.shape[1])[:, None]
        kp = k_off + torch.arange(k.shape[1])[None, :]
        s = s.masked_fill(kp > qp, float("-inf"))
    return torch.softmax(s, -1) @ v


SPLIT = [(4, 2, 40, 24, 16), (2, 2, 33, 192, 128)]


def _operands(h, h_kv, s, d, d_v, seed=5):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(h, s, d, generator=gen)
    k = torch.randn(h_kv, s, d, generator=gen)
    v = torch.randn(h_kv, s, d_v, generator=gen)
    return q, k, v


@pytest.mark.parametrize("h,h_kv,s,d,d_v", SPLIT)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_fold_at_split_head_dims(h, h_kv, s, d, d_v, causal):
    """The fused forward and two carried folds (the keys in halves, the
    second half at its offset) give dense softmax attention, out and acc
    ``Dv`` wide."""
    q, k, v = _operands(h, h_kv, s, d, d_v)
    scale = d ** -0.5
    want = _dense(q, k, v, 0, 0, causal, scale)
    out, m, l = kflash.flash_attend_fused(q, k, v, 0, 0, causal, scale)
    assert out.shape == (h, s, d_v)
    torch.testing.assert_close(out.double(), want, rtol=1e-5, atol=1e-5)
    carry = kflash.fresh_state(h, s, d_v, "cpu")
    cut = s // 2
    for lo, hi in ((0, cut), (cut, s)):
        carry = kflash.flash_block_attend(
            q, k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(), *carry,
            0, lo, causal, scale)
    m2, l2, acc = carry
    torch.testing.assert_close(m2, m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close((acc / l2.transpose(1, 2)).double(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,h_kv,s,d,d_v", SPLIT)
def test_plain_backward_at_split_head_dims(h, h_kv, s, d, d_v):
    """dq ``(H, Sq, D)``, dk ``(H_kv, Sk, D)`` and dv ``(H_kv, Sk, Dv)``
    from the saved statistics equal autograd's of dense attention."""
    q, k, v = _operands(h, h_kv, s, d, d_v)
    dout = torch.randn(h, s, d_v, generator=torch.Generator().manual_seed(9))
    scale = d ** -0.5
    out, m, l = kflash.flash_attend_fused(q, k, v, 0, 0, True, scale)
    linv, delta = kflash.backward_rows(out, l, dout)
    args = (q, k, v, dout, m, linv, delta, 0, 0, True, scale)
    dq = kflash.flash_block_backward_dq(*args)
    dk, dv = kflash.flash_block_backward_dkdv(*args)
    assert (dq.shape, dk.shape, dv.shape) == ((h, s, d), (h_kv, s, d),
                                              (h_kv, s, d_v))
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    _dense(*leaves, 0, 0, True, scale).backward(dout.double())
    for got, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got.double(), leaf.grad, rtol=1e-4,
                                   atol=1e-5)


def test_split_form_has_its_own_plans_and_launch_names():
    bf16 = torch.bfloat16
    assert kflash.has_form(192, bf16, 128)
    assert not kflash.has_form(192, torch.float32, 128)
    assert not kflash.has_form(96, bf16, 64)
    assert kflash.fwd_plan_explained(192, bf16, d_v=128) == ((128, 128),
                                                           "heuristic")
    assert kflash.smem_bytes(192, bf16, 128) == 214_080
    assert kflash._bwd_plan(kflash.KERNEL_BWD_DQ, 192, bf16,
                            d_v=128) == (128, 64)
    # dk and dv whole in registers: query tiles of 32, no 64-key form even
    # where the 128-key blocks leave the card idle
    assert kflash._bwd_plan(kflash.KERNEL_BWD_DKDV, 192, bf16, s_k=256,
                            h_kv=1, d_v=128) == (32, 128)
    assert kflash.launch_name("flash_fused", 192, 128) == \
        "flash_fused_192x128"
    assert kflash.launch_name("flash_fused", 128, 128) == "flash_fused"
    assert kflash.flash_supported(8192, 8192, 192, bf16, 128)


def test_split_form_takes_no_padding_where_it_has_a_form():
    from smi_tpu_torch.models import ring_attention as ra

    assert ra._flash_head_dims(8192, 192, 128, torch.bfloat16) == (192, 128)
    # f32 has no split form: both pad to 256
    assert ra._flash_head_dims(8192, 192, 128, torch.float32) == (256, 256)
    assert ra._flash_head_dims(64, 96, 64, torch.bfloat16) == (128, 128)
