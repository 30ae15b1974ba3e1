"""The ``afmoe`` block's fused residual junctions
(``smi_tpu_torch/kernels/residual_norm.py`` over
``csrc/residual_norm.cu``).

On the CPU: each form's plain version, which has the kernel's contract
(f32 math, rounding only where the plain composition rounds) and is the
composition ``block_shard`` runs off the card, against its definition
computed in f64, forward and in every gradient, the norm weights'
included; ``block_shard`` and the language model's head with the fused
path forced run the plain versions under the kernels' autograd wrapper
and give the plain path's outputs and gradients bit for bit, for a dense
layer and for an expert layer. Off the card, for the JAX package's block
and in f32, ``block_shard`` takes the plain path.

On the card (marked ``gpu``; each skips where CUDA or ``nvcc`` is
missing; ``python -m pytest --noconftest -m gpu
tests/test_torch_residual_norm.py``): each form against its plain
version at the ``trinity-train-2x8k`` shape, two runs of each backward
bit for bit, the launches of one 32-layer step, and an 8-layer step with
expert layers, the fused junctions against the plain ones routed alike.
This file imports no JAX.
"""

import pytest
import torch

import smi_tpu_torch as st
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import residual_norm as rn
from smi_tpu_torch.models import moe
from smi_tpu_torch.models import transformer as ttf

BF16 = torch.bfloat16
EPS = 1e-5

#: the forms, each with the dtype of its bf16-or-f32 result (the
#: middle's yn: bf16 before a dense MLP, f32 before an expert layer)
FORMS = [("entry", BF16), ("middle", BF16), ("middle", torch.float32),
         ("exit", torch.float32)]


def _rel(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def _ulps(got, want):
    """Each element's distance in bf16 steps (signed values ordered as
    integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(got) - ordered(want)).abs()


def _inputs(form, t, e, seed, device="cpu"):
    """``(x, out, w0, w1)`` of one form: the residual stream ``x`` f32,
    the sublayer's output (bf16 in the middle, f32 at the exit, None at
    the entry) at another scale, the weights near 1."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(t, e, generator=gen) * 2.0
    out = torch.randn(t, e, generator=gen) * 0.3 + 0.1
    w0 = torch.rand(e, generator=gen) + 0.5
    w1 = torch.rand(e, generator=gen) + 0.5
    out = {"entry": None, "middle": out.to(BF16), "exit": out}[form]
    w1 = w1 if form == "middle" else None
    return tuple(None if v is None else v.to(device)
                 for v in (x, out, w0, w1))


def _call(fns, form, x, out, w0, w1, dtype):
    """One form through ``fns``: the wrappers (``rn.entry_norm``, ...) or
    the plain versions (``rn.entry_norm_plain``, ...); a tuple of
    outputs."""
    entry, middle, exit_ = fns
    if form == "entry":
        return entry(x, w0, EPS, dtype)
    if form == "middle":
        return middle(x, out, w0, w1, EPS, dtype)
    return (exit_(x, out, w0, EPS),)


WRAPPERS = (rn.entry_norm, rn.middle_norm, rn.exit_norm)
PLAIN = (rn.entry_norm_plain, rn.middle_norm_plain, rn.exit_norm_plain)


def _defined(form, x, out, w0, w1):
    """The form by its definition, in the dtype of its inputs: ``norm(t,
    w) = t / sqrt(mean(t^2) + eps) * w`` over each row."""
    def norm(t, w):
        return t / torch.sqrt((t * t).mean(-1, keepdim=True) + EPS) * w

    if form == "entry":
        return x, norm(x, w0)
    h = x + norm(out, w0)
    return (h, norm(h, w1)) if form == "middle" else (h,)


def _leaves(ts, dtype=None):
    return [None if t is None else
            (t.detach().clone() if dtype is None else t.detach().to(dtype))
            .requires_grad_() for t in ts]


def _cotangents(outs, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=gen).to(o.dtype).to(o.device)
            for o in outs]


@pytest.mark.parametrize("form, dtype", FORMS)
def test_plain_forms_follow_their_definition(form, dtype):
    """Each output the definition in f64 (a bf16 one rounded once, within
    half a bf16 step; an f32 one within f32 rounding); every gradient the
    definition's (``d out`` of the bf16 product rounded once to bf16; the
    f32 ones, the norm weights' included, within f32 sums)."""
    ins = _inputs(form, 24, 48, seed=len(form) + (dtype == BF16))
    got_in = _leaves(ins)
    want_in = _leaves(ins, torch.float64)
    got = _call(PLAIN, form, *got_in, dtype)
    want = _defined(form, *want_in)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        rounded = form != "exit" and i == 1
        assert g.dtype == (dtype if rounded else torch.float32)
        assert g.shape == w.shape
        err = (g.double() - w).abs()
        if rounded and dtype == BF16:
            assert bool((err <= 2.0 ** -8 * w.abs() + 1e-6).all()), i
        else:
            assert bool((err <= 1e-6 * w.abs() + 1e-6).all()), i
    cot = _cotangents(got, seed=7)
    leaves = [t for t in got_in if t is not None]
    got_grads = torch.autograd.grad(got, leaves, cot)
    want_grads = torch.autograd.grad(
        want, [t for t in want_in if t is not None],
        [c.double() for c in cot])
    names = [n for n, t in zip(("d x", "d out", "d w0", "d w1"), got_in)
             if t is not None]
    for name, t, g, w in zip(names, leaves, got_grads, want_grads):
        assert g.dtype == t.dtype, name
        bar = 2.0 ** -8 if g.dtype == BF16 else 1e-5
        assert _rel(g, w) <= bar, name


def _block(mlp, kind="sliding", family="afmoe", dtype="bfloat16"):
    experts = moe.ExpertConfig(router=8, topk=2, width=32,
                               held=(0, 1, 2, 3))
    return ttf.BlockConfig(embed=64, heads=4, head_dim=16, kv_heads=2,
                           window=8 if kind == "sliding" else None,
                           family=family, compute_dtype=dtype, norm_eps=EPS,
                           mlp=mlp, mlp_width=96, experts=experts)


def _block_case(cfg, b, seed):
    gen = torch.Generator().manual_seed(seed)
    params = {n: torch.randn(s, generator=gen) * 0.2
              + (1.0 if n.endswith("norm") else 0.0)
              for n, s in ttf.param_shapes(cfg).items()}
    return params, torch.randn(b, 24, cfg.embed, generator=gen)


def _block_step(cfg, params, x, comm):
    ps = {n: p.clone().requires_grad_() for n, p in params.items()}
    xx = x.clone().requires_grad_()
    y = ttf.block_shard(ps, xx, comm, cfg,
                        route_cache={} if cfg.mlp == "experts" else None)
    (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
    return y.detach(), xx.grad, {n: p.grad for n, p in ps.items()}


@pytest.fixture
def comm11():
    return st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device="cpu")


def _assert_same(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(got[2]) == set(want[2])
    for name, g in want[2].items():
        assert torch.equal(got[2][name], g), name


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("kind", ["sliding", "full"])
@pytest.mark.parametrize("mlp", ["swiglu", "experts"])
def test_fused_block_wiring_matches_the_plain_block(comm11, monkeypatch,
                                                    mlp, kind, b):
    """The fused path's wiring (the ``wo`` product kept in bf16, the
    junctions' autograd wrapper, yn in bf16 before a dense MLP and in f32
    before an expert layer) run on the CPU with the plain versions
    inside: the plain block's output and every gradient, bit for bit."""
    cfg = _block(mlp, kind)
    params, x = _block_case(cfg, b, seed=b + len(kind) + len(mlp))
    want = _block_step(cfg, params, x, comm11)
    calls = []
    for name in ("entry_norm", "middle_norm", "exit_norm"):
        wrapper = getattr(rn, name)
        monkeypatch.setattr(rn, name, lambda *a, _w=wrapper, _n=name:
                            calls.append(_n) or _w(*a))
    monkeypatch.setattr(ttf, "_fuses_glue", lambda c, t: True)
    got = _block_step(cfg, params, x, comm11)
    assert calls == ["entry_norm", "middle_norm", "exit_norm"]
    _assert_same(got, want)


def _small_lm_config(layers=2, dense=1):
    return {
        "model_type": "afmoe", "num_hidden_layers": layers,
        "num_dense_layers": dense,
        "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16,
        "layer_types": (["sliding_attention", "full_attention"]
                        * layers)[:layers],
        "sliding_window": 8, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_experts": 4,
        "num_experts_per_tok": 2, "num_shared_experts": 1,
        "route_scale": 1.0, "route_norm": True, "score_func": "sigmoid",
        "rms_norm_eps": EPS, "rope_theta": 10000.0, "mup_enabled": True,
        "vocab_size": 97, "tie_word_embeddings": False,
    }


def _lm_step(cfg, comm, seed=3):
    model = ttf.LanguageModel.from_config(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg["vocab_size"], (2, 24), generator=gen)
    labels = torch.randint(0, cfg["vocab_size"], (2, 24), generator=gen)
    loss = model.loss(ids, labels, comm)
    loss.backward()
    return loss.detach(), model.reference_names(grads=True)


def test_fused_head_norm_matches_the_plain_head(comm11, monkeypatch):
    """The language model's final norm takes the entry form where the
    block's glue is fused: a dense and an expert layer, then the head,
    forced fused on the CPU, give the plain model's loss and every
    gradient bit for bit, through three junctions a layer and the head's
    entry."""
    cfg = _small_lm_config()
    want_loss, want = _lm_step(cfg, comm11)
    calls = []
    wrapper = rn.entry_norm
    monkeypatch.setattr(rn, "entry_norm",
                        lambda *a: calls.append("entry") or wrapper(*a))
    monkeypatch.setattr(ttf, "_fuses_glue", lambda c, t: True)
    loss, got = _lm_step(cfg, comm11)
    assert len(calls) == 2 * 2 + 1     # a layer's forward and recompute
    assert torch.equal(loss, want_loss)
    for name, g in want.items():
        assert torch.equal(got[name], g), name


@pytest.mark.parametrize("family, dtype", [
    ("afmoe", "bfloat16"), ("jax", "bfloat16"), ("afmoe", "float32")])
@pytest.mark.parametrize("mlp", ["swiglu", "experts"])
def test_block_takes_the_plain_path_off_the_card(comm11, monkeypatch,
                                                 family, dtype, mlp):
    """On the CPU, for the JAX package's block and in f32 the junctions
    are the plain composition: no wrapper of the fused kernels is
    called, by the block or by the head."""
    cfg = _block(mlp, family=family, dtype=dtype)
    params, x = _block_case(cfg, 1, seed=2)
    assert not ttf._fuses_glue(cfg, x)
    parts = ttf._block_glue(cfg, x)
    assert parts.entry is not rn.entry_norm
    assert (parts.middle is rn.middle_norm_plain) == (family == "afmoe")

    def refuse(*args, **kwargs):
        raise AssertionError("a fused junction ran")

    for name in ("entry_norm", "middle_norm", "exit_norm"):
        monkeypatch.setattr(rn, name, refuse)
    _block_step(cfg, params, x, comm11)
    if family == "afmoe":
        _lm_step(_small_lm_config(), comm11)


def test_junctions_take_every_width_off_the_card():
    """The fused path is chosen by the family, the dtype and the device
    alone; a width the kernels do not take raises in the wrappers on a
    card, where the plain composition would have run unseen."""
    card = type("CardTensor", (), {"is_cuda": True})()
    for e in (200, 2048, 8192):
        cfg = ttf.BlockConfig(embed=e, heads=4, head_dim=16, family="afmoe",
                              compute_dtype="bfloat16", mlp="swiglu")
        assert ttf._fuses_glue(cfg, card)
        assert ttf._block_glue(cfg, card).middle is rn.middle_norm
    cuda = torch.device("cuda", 0)
    for e in (12, 2056, 4096):
        with pytest.raises(ValueError, match=f"no kernel for width {e}"):
            rn._width("residual_norm middle", e, cuda)
    for e in (8, 256, 2048):
        rn._width("residual_norm middle", e, cuda)
    rn._width("residual_norm middle", 12, torch.device("cpu"))


@pytest.mark.parametrize("case, error, match", [
    ("bf16_x", TypeError, "x must be torch.float32"),
    ("3d_x", ValueError, r"x must be \(T, E\)"),
    ("strided_x", ValueError, "x must be contiguous"),
    ("f32_out", TypeError, "out must be torch.bfloat16"),
    ("bf16_exit_out", TypeError, "out must be torch.float32"),
    ("out_rows", ValueError, "out must have shape"),
    ("weight_shape", ValueError, "w_pre must have shape"),
    ("f64_weight", TypeError, "w must be torch.float32"),
    ("f16_yn", TypeError, "yn is bf16 or f32"),
    ("f32_xn", TypeError, "rounds to torch.bfloat16"),
])
def test_operand_checks_raise(case, error, match):
    x, out, w0, w1 = _inputs("middle", 8, 32, seed=1)
    with pytest.raises(error, match=match):
        if case == "bf16_x":
            rn.entry_norm(x.to(BF16), w0, EPS)
        elif case == "3d_x":
            rn.entry_norm(x.reshape(2, 4, 32), w0, EPS)
        elif case == "strided_x":
            rn.middle_norm(x.t().contiguous().t()[:, :16], out[:, :16],
                           w0[:16], w1[:16], EPS, BF16)
        elif case == "f32_out":
            rn.middle_norm(x, out.float(), w0, w1, EPS, BF16)
        elif case == "bf16_exit_out":
            rn.exit_norm(x, out, w0, EPS)
        elif case == "out_rows":
            rn.middle_norm(x, out[:4], w0, w1, EPS, BF16)
        elif case == "weight_shape":
            rn.middle_norm(x, out, w0, w1[:16], EPS, BF16)
        elif case == "f64_weight":
            rn.exit_norm(x, out.float(), w0.double(), EPS)
        elif case == "f16_yn":
            rn.middle_norm(x, out, w0, w1, EPS, torch.float16)
        else:
            rn.entry_norm(x, w0, EPS, torch.float32)


def test_cpu_calls_launch_nothing():
    before = dict(_build.LAUNCHES)
    for form, dtype in FORMS:
        ins = _leaves(_inputs(form, 8, 32, seed=4))
        outs = _call(WRAPPERS, form, *ins, dtype)
        sum(o.float().sum() for o in outs).backward()
        assert all(t.grad is not None for t in ins if t is not None)
    assert _build.LAUNCHES == before
    assert {rn.KERNEL, rn.KERNEL_BWD} <= set(before)
    assert {_build.source_of(k) for k in (rn.KERNEL, rn.KERNEL_BWD)} == {
        "residual_norm"}


def test_backward_grid_is_fixed_by_the_rows():
    """A block a row forward; the backward strides a fixed grid over the
    rows, so its weight-gradient sums do not depend on the card."""
    rows = 2 * 8192
    assert rn.launch_blocks(rn.KERNEL, rows) == rows
    assert rn.launch_blocks(rn.KERNEL_BWD, rows) == \
        rn.BWD_BLOCKS_PER_SM * _build.SMS == 528
    assert rn.launch_blocks(rn.KERNEL_BWD, 100) == 100


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

#: trinity-train-2x8k's junctions: 2 x 8192 tokens of 2048
CELL = dict(t=2 * 8192, e=2048)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused junction kernels have no "
                    "CPU mode")
    try:
        _build.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build csrc/residual_norm.cu")
    _build.build_kernels(["residual_norm"])
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("form, dtype", FORMS)
def test_card_form_matches_its_plain_version(card, form, dtype):
    """Each output within one bf16 step (a bf16 one; or 1e-5 where ``h``
    cancels, ``yn`` near 0: an f32 ulp of ``x`` then is many bf16 steps
    of ``yn``) or f32 rounding of the norm's scale (an f32 one) of the
    plain version on the card; every
    gradient within the bf16 rounding of ``d out`` or f32 sums in
    another order; two backward runs bit for bit; one launch each way a
    call."""
    ins = _inputs(form, CELL["t"], CELL["e"], seed=11, device=card)
    got_in, want_in = _leaves(ins), _leaves(ins)
    before = dict(_build.LAUNCHES)
    got = _call(WRAPPERS, form, *got_in, dtype)
    want = _call(PLAIN, form, *want_in, dtype)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == BF16:
            ulps = _ulps(g, w)
            apart = float((ulps > 0).double().mean())
            err = (g.float() - w.float()).abs()
            print(f"{form} out {i}: {100 * apart:.4f} % of elements apart, "
                  f"at most {int(ulps.max())} bf16 steps, "
                  f"{float(err.max()):.3e}")
            assert bool(((ulps <= 1) | (err <= 1e-5)).all()), i
        else:
            rel = _rel(g, w)
            print(f"{form} out {i}: relative error {rel:.3e}")
            assert rel <= 1e-6, i
    cot = _cotangents(want, seed=5)
    leaves = [t for t in got_in if t is not None]
    got_grads = torch.autograd.grad(got, leaves, cot)
    want_grads = torch.autograd.grad(
        want, [t for t in want_in if t is not None], cot)
    again = torch.autograd.grad(_call(WRAPPERS, form, *got_in, dtype),
                                leaves, cot)
    torch.cuda.synchronize()
    names = [n for n, t in zip(("d x", "d out", "d w0", "d w1"), got_in)
             if t is not None]
    for name, g, w, g2 in zip(names, got_grads, want_grads, again):
        assert torch.equal(g, g2), f"{name} repeats bit for bit"
        rel = _rel(g, w)
        print(f"{form} {name}: relative error {rel:.3e}")
        # d out of the bf16 product: two f32 forms of one gradient, each
        # rounded to bf16 (2^-8); the weights': f32 sums of 16,384 rows in
        # two orders; d x: two f32 forms of the closed gradient
        bar = {"d out": 2.0 ** -8 if g.dtype == BF16 else 1e-5,
               "d x": 1e-5}.get(name, 1e-3)
        assert rel <= bar, name
    made = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert made[rn.KERNEL] == 2 and made[rn.KERNEL_BWD] == 2


def _small_trinity(layers, dense=2):
    """Trinity-Mini's layer pattern (three windowed layers, then a full
    one) at a small width: heads of 64, GQA 4:1; the first ``dense``
    layers dense, the rest expert layers."""
    return {
        "model_type": "afmoe", "num_hidden_layers": layers,
        "num_dense_layers": dense,
        "hidden_size": 256, "num_attention_heads": 4,
        "num_key_value_heads": 1, "head_dim": 64,
        "layer_types": (["sliding_attention"] * 3
                        + ["full_attention"]) * (layers // 4),
        "sliding_window": 64, "intermediate_size": 384,
        "moe_intermediate_size": 64, "num_experts": 4,
        "num_experts_per_tok": 2, "num_shared_experts": 1,
        "route_scale": 1.0, "route_norm": True, "score_func": "sigmoid",
        "rms_norm_eps": EPS, "rope_theta": 10000.0, "mup_enabled": True,
        "vocab_size": 512, "tie_word_embeddings": False,
    }


def _card_step(cfg, device, seed=17):
    """One step of a fresh model: its loss, every weight's gradient and
    each layer's routing (``LanguageModel.routing``)."""
    comm = st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device=device)
    model = ttf.LanguageModel.from_config(cfg, device=device, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg["vocab_size"], (2, 256), generator=gen)
    labels = torch.randint(0, cfg["vocab_size"], (2, 256), generator=gen)
    step = ttf.make_train_step(comm, model.config, layers=len(model.blocks))
    loss = step(model, ids.to(device), labels.to(device))
    torch.cuda.synchronize()
    return float(loss), model.reference_names(grads=True), model.routing


@pytest.mark.gpu
def test_card_step_launches_three_junctions_a_layer(card):
    """A 32-layer step: three forward launches a layer, in the forward
    and again in its recompute, and the head's final norm once (193);
    three backward launches a layer and the head's one (97)."""
    before = dict(_build.LAUNCHES)
    _card_step(_small_trinity(32), card)
    made = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert made[rn.KERNEL] == 3 * 32 * 2 + 1 == 193
    assert made[rn.KERNEL_BWD] == 3 * 32 + 1 == 97


@pytest.mark.gpu
def test_card_step_fused_against_plain_junctions(card, monkeypatch):
    """An 8-layer step, two dense layers and six expert layers, with the
    fused junctions and with their plain versions (the attention glue
    fused in both): the loss and every weight's gradient within the bf16
    model test's tolerance (``test_torch_afmoe.BF16_TOL``: each product
    rounds to 8 bits of mantissa). The plain run routes as the fused run
    did (its expert ids and loads handed to each expert layer's first
    call), as the benchmark's reference does: where rounding flips a
    choice near a tie, a router's gradient moves by a whole token's
    share, which no rounding tolerance bounds. The share of the
    assignments each run would have chosen apart is printed."""
    cfg = _small_trinity(8, dense=2)
    loss, fused, routing = _card_step(cfg, card)
    routes = iter([r for r in routing if r])
    assert len(routing) == 8 and sum(bool(r) for r in routing) == 6
    flips = []
    expert_layer = moe.expert_layer

    def routed(params, x, cfg_, mm, dtype, cache=None):
        if "loads" not in cache:      # the forward: the fused run's routes
            got = next(routes)
            with torch.no_grad():     # nothing saved for the recompute
                own = torch.sigmoid(x @ params["router"]).topk(
                    got["sel"].shape[1], dim=-1).indices
            flips.append(float((own.sort(-1).values
                                != got["sel"].sort(-1).values).any(-1)
                               .double().mean()))
            cache.update(sel=got["sel"], loads=got["loads"])
        return expert_layer(params, x, cfg_, mm, dtype, cache)

    monkeypatch.setattr(moe, "expert_layer", routed)
    for name, plain in zip(("entry_norm", "middle_norm", "exit_norm"),
                           PLAIN):
        monkeypatch.setattr(rn, name, plain)
    before = dict(_build.LAUNCHES)
    want_loss, plain, _ = _card_step(cfg, card)
    print(f"tokens whose own top-k differs from the fused run's, by "
          f"expert layer: {[f'{100 * f:.2f} %' for f in flips]}")
    assert len(flips) == 6
    assert _build.LAUNCHES[rn.KERNEL] == before[rn.KERNEL]
    assert _build.LAUNCHES[rn.KERNEL_BWD] == before[rn.KERNEL_BWD]
    assert abs(loss - want_loss) < 1e-2
    for name, g in plain.items():
        assert _rel(fused[name], g) < 5e-2, name
