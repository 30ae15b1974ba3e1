"""The ``afmoe`` attention sublayer's fused glue
(``smi_tpu_torch/kernels/attn_glue.py`` over ``csrc/attn_glue.cu``).

On the CPU: each kernel's plain version, which has the kernel's contract
(bf16 in and out, f32 math, one rounding, head-major q, k, v) and is the
composition ``block_shard`` runs off the card, against its definition
computed in f64, forward within one bf16 step and in every gradient; and
``block_shard`` with the fused path forced runs the plain versions under
the kernels' autograd wrappers and gives the plain block's outputs and
gradients bit for bit. Off the card, for the JAX package's block and in
f32, ``block_shard`` takes the plain path.

On the card (marked ``gpu``; each skips where CUDA or ``nvcc`` is
missing; ``python -m pytest --noconftest -m gpu
tests/test_torch_afmoe_glue.py``): each kernel against its plain version
at the ``trinity-train-2x8k`` shape, two runs of each backward bit for
bit, the launches of one 32-layer step, and a small stack's step fused
against unfused. This file imports no JAX.
"""

import pytest
import torch

import smi_tpu_torch as st
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import attn_glue as glue
from smi_tpu_torch.models import transformer as ttf

BF16 = torch.bfloat16
EPS = 1e-5
THETA = 10000.0


def _ulps(got, want):
    """Each element's distance in bf16 steps (signed values ordered as
    integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(got) - ordered(want)).abs()


def _rel(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def _defined_prologue(qkv, q_norm, k_norm, b, h, kv, offset, sliding):
    """The prologue by its definition in f64, token-major ``(B, S, Hx,
    D)``: each query and key head ``x / sqrt(mean(x^2) + eps) * w``, on
    windowed layers its halves rotated by ``position * theta ** (-2j /
    D)``; v as it came."""
    s = qkv.shape[0] // b
    d = q_norm.shape[0]
    x = qkv.double().reshape(b, s, h + 2 * kv, d)

    def norm(t, w):
        return t / torch.sqrt((t * t).mean(-1, keepdim=True) + EPS) \
            * w.double()

    q, k = norm(x[:, :, :h], q_norm), norm(x[:, :, h:h + kv], k_norm)
    if sliding:
        freq = THETA ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
        pos = torch.arange(offset, offset + s, dtype=torch.float64)
        angles = torch.outer(pos, freq).repeat(1, 2)[None, :, None]

        def rotate(t):
            rot = torch.cat((-t[..., d // 2:], t[..., :d // 2]), -1)
            return t * angles.cos() + rot * angles.sin()

        q, k = rotate(q), rotate(k)
    return q, k, x[:, :, h + kv:]


def _prologue_inputs(b, s, h, kv, d, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    qkv = (torch.randn(b * s, (h + 2 * kv) * d, generator=gen) * 1.5).to(BF16)
    q_norm = torch.rand(d, generator=gen) + 0.5
    k_norm = torch.rand(d, generator=gen) + 0.5
    return qkv.to(device), q_norm.to(device), k_norm.to(device)


def _grads(outs, leaves, seed):
    gen = torch.Generator().manual_seed(seed)
    cot = [torch.randn(o.shape, generator=gen).to(o.dtype).to(o.device)
           for o in outs]
    return cot, torch.autograd.grad(outs, leaves, cot)


def _leaves(*ts):
    return [t.detach().clone().requires_grad_() for t in ts]


#: (heads, kv_heads): GQA 1:1 and 8:1
GROUPS = [(4, 4), (8, 1)]


@pytest.mark.parametrize("offset", [0, 48])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("h, kv", GROUPS)
@pytest.mark.parametrize("kind", ["sliding", "full"])
def test_prologue_plain_follows_its_definition(kind, h, kv, b, offset):
    """q, k and v head-major (row ``b*Hx + hx``), each the definition
    rounded once to bf16 (v exact); the gradients the definition's within
    bf16 rounding (``d qkv``) and f32 sums (the norm weights')."""
    s, d = 24, 16
    sliding = kind == "sliding"
    qkv, qn, kn = _prologue_inputs(b, s, h, kv, d, seed=h + b + offset)
    rope = (ttf._rope_tables(s, d, offset, THETA, torch.device("cpu"))
            if sliding else None)
    got_in = _leaves(qkv, qn, kn)
    want_in = [t.detach().double().requires_grad_() for t in (qkv, qn, kn)]
    got = glue.attn_prologue_plain(*got_in, b, h, kv, EPS, rope)
    want = _defined_prologue(*want_in, b, h, kv, offset, sliding)
    for name, g, w, hx in zip("qkv", got, want, (h, kv, kv)):
        assert g.shape == (b * hx, s, d) and g.is_contiguous()
        assert g.dtype == BF16
        w = w.transpose(1, 2).reshape(b * hx, s, d)
        if name == "v":
            assert torch.equal(g, w.to(BF16))
        else:
            # half a bf16 step of rounding, and f32's error where the
            # rotation's two products cancel (the rows' rms is ~1)
            err = (g.double() - w).abs()
            assert bool((err <= 2.0 ** -8 * w.abs() + 1e-5).all()), name
    cot, got_grads = _grads(got, got_in, seed=7)
    want_grads = torch.autograd.grad(
        want, want_in, [c.double().reshape(b, hx, s, d).transpose(1, 2)
                        for c, hx in zip(cot, (h, kv, kv))])
    for name, g, w in zip(("d qkv", "d q_norm", "d k_norm"), got_grads,
                          want_grads):
        assert g.dtype == (BF16 if name == "d qkv" else torch.float32)
        assert _rel(g, w) <= (2.0 ** -8 if name == "d qkv" else 1e-5), name


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("h", [4, 8])
def test_epilogue_plain_follows_its_definition(h, b):
    """``attn * sigmoid(gate)`` in token order, the definition in f64
    rounded once to bf16 (within one step); the gradients ``dout *
    sigmoid(g)`` and ``dout * attn * sigmoid(g) * (1 - sigmoid(g))``
    within bf16 rounding."""
    s, d = 24, 16
    gen = torch.Generator().manual_seed(h * b)
    heads_major = torch.randn(b * h, s, d, generator=gen).to(BF16)
    gate = (torch.randn(b * s, h * d, generator=gen) * 3).to(BF16)
    got_in = _leaves(heads_major, gate)
    got = glue.attn_epilogue_plain(got_in[0].transpose(0, 1), got_in[1],
                                   b, h)
    a = heads_major.double().reshape(b, h, s, d).transpose(1, 2).reshape(
        b * s, h * d)
    sig = torch.sigmoid(gate.double())
    assert got.shape == (b * s, h * d) and got.dtype == BF16
    assert int(_ulps(got, (a * sig).to(BF16)).max()) <= 1
    cot, (d_attn, d_gate) = _grads([got], got_in, seed=3)
    dout = cot[0].double()
    want_attn = (dout * sig).reshape(b, s, h, d).transpose(1, 2).reshape(
        b * h, s, d)
    for name, g, w in (("d attn", d_attn, want_attn),
                       ("d gate", d_gate, dout * a * sig * (1 - sig))):
        assert g.dtype == BF16 and _rel(g, w) <= 2.0 ** -8, name


def _block(kind, h, kv, family="afmoe", dtype="bfloat16"):
    return ttf.BlockConfig(embed=64, heads=h, head_dim=16, kv_heads=kv,
                           window=8 if kind == "sliding" else None,
                           family=family, compute_dtype=dtype,
                           norm_eps=EPS, mlp="swiglu", mlp_width=96)


def _block_step(cfg, params, x, comm):
    ps = {n: p.clone().requires_grad_() for n, p in params.items()}
    xx = x.clone().requires_grad_()
    y = ttf.block_shard(ps, xx, comm, cfg)
    (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
    return y.detach(), xx.grad, {n: p.grad for n, p in ps.items()}


def _block_case(cfg, b, seed):
    gen = torch.Generator().manual_seed(seed)
    params = {n: torch.randn(s, generator=gen) * 0.2
              + (1.0 if n.endswith("norm") else 0.0)
              for n, s in ttf.param_shapes(cfg).items()}
    return params, torch.randn(b, 24, cfg.embed, generator=gen)


@pytest.fixture
def comm11():
    return st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device="cpu")


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("h, kv", GROUPS)
@pytest.mark.parametrize("kind", ["sliding", "full"])
def test_fused_block_wiring_matches_the_plain_block(comm11, monkeypatch,
                                                    kind, h, kv, b):
    """The fused path's wiring (the products kept in bf16, the autograd
    wrappers, the head-major hand-off to the ring and back) run on the
    CPU with the plain versions inside: the plain block's output and
    every gradient, bit for bit."""
    cfg = _block(kind, h, kv)
    params, x = _block_case(cfg, b, seed=h + b)
    want = _block_step(cfg, params, x, comm11)
    monkeypatch.setattr(ttf, "_fuses_glue", lambda c, t: True)
    got = _block_step(cfg, params, x, comm11)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(got[2]) == set(want[2])
    for name, g in want[2].items():
        assert torch.equal(got[2][name], g), name


@pytest.mark.parametrize("family, dtype", [
    ("afmoe", "bfloat16"), ("jax", "bfloat16"), ("afmoe", "float32")])
def test_block_takes_the_plain_path_off_the_card(comm11, monkeypatch,
                                                 family, dtype):
    """On the CPU, for the JAX package's block and in f32 the glue is the
    plain composition: no wrapper of the fused kernels is called."""
    cfg = _block("sliding", 4, 2, family=family, dtype=dtype)
    params, x = _block_case(cfg, 1, seed=2)
    assert not ttf._fuses_glue(cfg, x)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused glue ran")

    monkeypatch.setattr(glue, "attn_prologue", refuse)
    monkeypatch.setattr(glue, "attn_epilogue", refuse)
    _block_step(cfg, params, x, comm11)


def test_rope_tables_are_cached_with_equal_halves():
    """The tables are the cosines and sines of ``position * theta **
    (-2j / D)``, the frequencies twice over, built once a shape, offset
    and device; a layer's tables sit at its rank's ``sp`` offset, and a
    full layer has none."""
    dev = torch.device("cpu")
    cos, sin = ttf._rope_tables(40, 32, 80, THETA, dev)
    freq = THETA ** (-torch.arange(0, 32, 2, dtype=torch.float64) / 32)
    angles = torch.outer(torch.arange(80, 120, dtype=torch.float64), freq)
    assert torch.allclose(cos[:, :16].double(), angles.cos(), atol=1e-4)
    assert torch.allclose(sin[:, :16].double(), angles.sin(), atol=1e-4)
    assert torch.equal(cos[:, :16], cos[:, 16:])
    assert torch.equal(sin[:, :16], sin[:, 16:])
    assert ttf._rope_tables(40, 32, 80, THETA, dev)[0] is cos
    # the second of two sp ranks: positions 40 to 79
    rank1 = type("Rank", (), {"coords": (0, 1),
                              "_axis": staticmethod(lambda name: 1)})()
    sliding, full = _block("sliding", 4, 2), _block("full", 4, 2)
    assert ttf._rope(sliding, rank1, "sp", 40, dev)[0] is \
        ttf._rope_tables(40, 16, 40, sliding.rope_theta, dev)[0]
    assert ttf._rope(full, rank1, "sp", 40, dev) is None


def test_fused_glue_takes_every_head_dim_on_the_card():
    """The fused path is chosen by the family, the dtype and the device
    alone; a head dim with no kernel instance raises in the wrappers,
    where the plain composition would have run unseen."""
    card = type("CardTensor", (), {"is_cuda": True})()
    for d in (16, 96, 128):
        cfg = ttf.BlockConfig(embed=64, heads=4, head_dim=d, family="afmoe",
                              compute_dtype="bfloat16")
        assert ttf._fuses_glue(cfg, card)
    with pytest.raises(ValueError, match="no kernel for head dim 96"):
        glue._head_dim("attn_prologue", 96, torch.device("cuda", 0))
    glue._head_dim("attn_prologue", 96, torch.device("cpu"))


@pytest.mark.parametrize("case, error, match", [
    ("f32_qkv", TypeError, "qkv must be torch.bfloat16"),
    ("width", ValueError, "is not"),
    ("strided", ValueError, "contiguous"),
    ("f64_norm", TypeError, "q_norm must be torch.float32"),
    ("table", ValueError, "cos must have shape"),
    ("heads", ValueError, "attn has"),
    ("gate", TypeError, "gate must be torch.bfloat16"),
])
def test_operand_checks_raise(case, error, match):
    qkv, qn, kn = _prologue_inputs(2, 8, 4, 2, 16, seed=1)
    rope = None
    if case == "f32_qkv":
        qkv = qkv.float()
    elif case == "width":
        qkv = qkv[:, :-16].contiguous()
    elif case == "strided":
        qkv = qkv.t().contiguous().t()
    elif case == "f64_norm":
        qn = qn.double()
    elif case == "table":
        rope = (torch.zeros(8, 8), torch.zeros(8, 8))
    attn = torch.zeros(8, 8, 16, dtype=BF16)
    gate = torch.zeros(16, 64, dtype=BF16)
    with pytest.raises(error, match=match):
        if case == "heads":
            glue.attn_epilogue(attn, gate, 2, 3)
        elif case == "gate":
            glue.attn_epilogue(attn, gate.float(), 2, 4)
        else:
            glue.attn_prologue(qkv, qn, kn, 2, 4, 2, EPS, rope)


def test_cpu_calls_launch_nothing():
    before = dict(_build.LAUNCHES)
    qkv, qn, kn = _prologue_inputs(1, 8, 4, 2, 16, seed=4)
    q, k, v = glue.attn_prologue(*_leaves(qkv, qn, kn), 1, 4, 2, EPS)
    out = glue.attn_epilogue(q.transpose(0, 1),
                             torch.zeros(8, 64, dtype=BF16), 1, 4)
    (out.float().sum() + k.float().sum() + v.float().sum()).backward()
    assert _build.LAUNCHES == before
    assert {glue.KERNEL_PROLOGUE, glue.KERNEL_PROLOGUE_BWD,
            glue.KERNEL_EPILOGUE, glue.KERNEL_EPILOGUE_BWD} <= set(before)
    assert {_build.source_of(k) for k in before if k.startswith("attn_")
            } == {"attn_glue"}


def test_backward_grid_is_fixed_by_the_rows():
    """A warp a row; the prologue's backward strides a fixed grid over
    the rows, so its weight-gradient sums do not depend on the card."""
    rows = 2 * 8192 * 40
    assert glue.launch_blocks(glue.KERNEL_PROLOGUE, rows) == rows // 8
    assert glue.launch_blocks(glue.KERNEL_PROLOGUE_BWD, rows) == \
        glue.BWD_BLOCKS_PER_SM * _build.SMS == 1056
    assert glue.launch_blocks(glue.KERNEL_PROLOGUE_BWD, 100) == 13


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

#: trinity-train-2x8k's attention: 2 x 8192 tokens, 32 query and 4
#: key/value heads of 128
CELL = dict(b=2, s=8192, h=32, kv=4, d=128)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused glue kernels have no CPU "
                    "mode")
    try:
        _build.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build csrc/attn_glue.cu")
    _build.build_kernels(["attn_glue"])
    return torch.device("cuda", 0)


def _within_one_ulp(name, got, want):
    ulps = _ulps(got, want)
    share = float((ulps > 0).double().mean())
    print(f"{name}: {100 * share:.4f} % of elements 1 bf16 ulp apart")
    assert int(ulps.max()) <= 1, name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sliding", "full"])
def test_card_prologue_matches_its_plain_version(card, kind):
    b, s, h, kv, d = (CELL[k] for k in ("b", "s", "h", "kv", "d"))
    qkv, qn, kn = _prologue_inputs(b, s, h, kv, d, seed=11, device=card)
    rope = (ttf._rope_tables(s, d, 0, THETA, card) if kind == "sliding"
            else None)
    got_in, want_in = _leaves(qkv, qn, kn), _leaves(qkv, qn, kn)
    before = dict(_build.LAUNCHES)
    got = glue.attn_prologue(*got_in, b, h, kv, EPS, rope)
    want = glue.attn_prologue_plain(*want_in, b, h, kv, EPS, rope)
    for name, g, w in zip("qkv", got, want):
        _within_one_ulp(f"{kind} {name}", g, w)
    assert torch.equal(got[2], want[2])          # v: moved, not computed
    cot, want_grads = _grads(want, want_in, seed=5)
    got_grads = torch.autograd.grad(got, got_in, cot)
    again = torch.autograd.grad(
        glue.attn_prologue(*got_in, b, h, kv, EPS, rope), got_in, cot)
    torch.cuda.synchronize()
    for name, g, w, g2 in zip(("d qkv", "d q_norm", "d k_norm"), got_grads,
                              want_grads, again):
        assert torch.equal(g, g2), f"{name} repeats bit for bit"
        rel = _rel(g, w)
        print(f"{kind} {name}: relative error {rel:.3e}")
        # d qkv: bf16 rounding of two f32 forms of the same sums (2^-8);
        # the weights' gradients: f32 sums of 2^19 rows in two orders
        assert rel <= (2.0 ** -8 if name == "d qkv" else 1e-3), name
    made = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert made[glue.KERNEL_PROLOGUE] == 2
    assert made[glue.KERNEL_PROLOGUE_BWD] == 2


@pytest.mark.gpu
def test_card_epilogue_matches_its_plain_version(card):
    b, s, h, d = (CELL[k] for k in ("b", "s", "h", "d"))
    gen = torch.Generator().manual_seed(13)
    heads_major = torch.randn(b * h, s, d, generator=gen).to(BF16).to(card)
    gate = (torch.randn(b * s, h * d, generator=gen) * 3).to(BF16).to(card)
    got_in, want_in = _leaves(heads_major, gate), _leaves(heads_major, gate)
    got = glue.attn_epilogue(got_in[0].transpose(0, 1), got_in[1], b, h)
    want = glue.attn_epilogue_plain(want_in[0].transpose(0, 1), want_in[1],
                                    b, h)
    _within_one_ulp("gated output", got, want)
    cot, want_grads = _grads([want], want_in, seed=9)
    got_grads = torch.autograd.grad([got], got_in, cot)
    again = torch.autograd.grad(
        [glue.attn_epilogue(got_in[0].transpose(0, 1), got_in[1], b, h)],
        got_in, cot)
    torch.cuda.synchronize()
    for name, g, w, g2 in zip(("d attn", "d gate"), got_grads, want_grads,
                              again):
        assert torch.equal(g, g2), f"{name} repeats bit for bit"
        _within_one_ulp(name, g, w)


def _small_trinity(layers=32):
    """Trinity-Mini's layer pattern (three windowed layers, then a full
    one) at a small width, every layer dense: heads of 64, GQA 4:1."""
    return {
        "model_type": "afmoe", "num_hidden_layers": layers,
        "num_dense_layers": layers, "hidden_size": 256, "num_attention_heads": 4,
        "num_key_value_heads": 1, "head_dim": 64,
        "layer_types": (["sliding_attention"] * 3
                        + ["full_attention"]) * (layers // 4),
        "sliding_window": 64, "intermediate_size": 384,
        "moe_intermediate_size": 64, "num_experts": 4,
        "num_experts_per_tok": 2, "num_shared_experts": 1,
        "route_scale": 1.0, "route_norm": True, "score_func": "sigmoid",
        "rms_norm_eps": EPS, "rope_theta": THETA, "mup_enabled": True,
        "vocab_size": 512, "tie_word_embeddings": False,
    }


def _card_step(cfg, device, seed=17):
    comm = st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device=device)
    model = ttf.LanguageModel.from_config(cfg, device=device, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg["vocab_size"], (2, 256), generator=gen)
    labels = torch.randint(0, cfg["vocab_size"], (2, 256), generator=gen)
    step = ttf.make_train_step(comm, model.config, layers=len(model.blocks))
    loss = step(model, ids.to(device), labels.to(device))
    torch.cuda.synchronize()
    return float(loss), model.reference_names(grads=True)


@pytest.mark.gpu
def test_card_step_launches_each_forward_kernel_twice_a_layer(card):
    """A 32-layer step: each forward kernel in the forward and again in
    its recompute (64), each backward kernel once a layer (32)."""
    before = dict(_build.LAUNCHES)
    _card_step(_small_trinity(), card)
    made = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert made[glue.KERNEL_PROLOGUE] == made[glue.KERNEL_EPILOGUE] == 64
    assert made[glue.KERNEL_PROLOGUE_BWD] == 32
    assert made[glue.KERNEL_EPILOGUE_BWD] == 32


@pytest.mark.gpu
def test_card_step_fused_against_unfused(card, monkeypatch):
    """An 8-layer step with the fused glue and with the plain
    composition: the loss and every weight's gradient within the bf16
    model test's tolerance (``test_torch_afmoe.BF16_TOL``: each product
    rounds to 8 bits of mantissa)."""
    cfg = _small_trinity(layers=8)
    loss, fused = _card_step(cfg, card)
    monkeypatch.setattr(ttf, "_fuses_glue", lambda c, t: False)
    before = dict(_build.LAUNCHES)
    want_loss, plain = _card_step(cfg, card)
    assert all(_build.LAUNCHES[k] == before[k] for k in before
               if k.startswith("attn_"))
    assert abs(loss - want_loss) < 1e-2
    for name, g in plain.items():
        assert _rel(fused[name], g) < 5e-2, name
