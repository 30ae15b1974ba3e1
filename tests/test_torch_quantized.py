"""The port's quantised allreduce against the JAX package's.

``_quantize`` is held bit for bit to the JAX package's (eager, on the
CPU) in bf16, int8 and top-k, f32 and bf16 payloads, the degenerate
shapes included. The precision ladder (pin, env, dense) and its loud
errors are the JAX package's. ``allreduce(precision=...)`` on an 8-rank
CPU ``LocalWorld`` matches ``smi_tpu``'s ``smi_kernel`` on the fake mesh,
on both tiers, within ``rtol=1e-6``: the JAX side is traced and so never
compensates, and the port compensates from a call site's second call on,
so every such comparison is a first call after ``error_feedback_reset()``
(ROADMAP.md Queue 3). The error-feedback store keeps the ranks of a world
apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.parallel import collectives as jcoll
from smi_tpu.tuning import cost_model as cm
from smi_tpu_torch.parallel import collectives as pcoll

N = 8
LOSSY = ["bf16", "int8", "topk"]
#: rank 0 of an 8-rank CPU world: the precision ladder's topology
PCOMM8 = st.LocalWorld(N, device="cpu").comms[0]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _no_residuals(monkeypatch):
    monkeypatch.delenv(pcoll.ALLREDUCE_PRECISION_ENV, raising=False)
    pcoll.error_feedback_reset()
    yield
    pcoll.error_feedback_reset()


def _payloads():
    rng = np.random.default_rng(19)
    return {
        "normal 4096": rng.normal(size=4096).astype(np.float32),
        "scaled 37x5": (rng.normal(size=(37, 5)) * 40).astype(np.float32),
        "ties 64": np.repeat(rng.normal(size=8), 8).astype(np.float32),
        "one": np.asarray([2.5], np.float32),
        "three": np.asarray([1.0, -2.0, 3.0], np.float32),
        "sixteen": rng.normal(size=16).astype(np.float32),
        "seventeen": rng.normal(size=17).astype(np.float32),
        "zeros": np.zeros(16, np.float32),
        "empty": np.zeros(0, np.float32),
        "scalar": np.asarray(-1.75, np.float32),
    }


@pytest.mark.parametrize("precision", LOSSY)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(_payloads()))
def test_quantize_is_bit_equal_to_the_jax_package(precision, dtype, name):
    x = _payloads()[name]
    jdtype, tdtype = DTYPES[dtype]
    try:
        want = np.asarray(jcoll._quantize(jnp.asarray(x).astype(jdtype),
                                          precision).astype(jnp.float32))
    except ValueError:
        # int8 of an empty payload has no largest magnitude: loud in both
        with pytest.raises(RuntimeError):
            pcoll._quantize(torch.from_numpy(x).to(tdtype), precision)
        return
    got = pcoll._quantize(torch.from_numpy(x).to(tdtype), precision)
    assert got.dtype == tdtype and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("precision,bound", [("bf16", 0.01),
                                             ("int8", 0.02)])
def test_relative_error_is_bounded(precision, bound):
    x = torch.from_numpy(np.random.default_rng(7).normal(size=4096)
                         .astype(np.float32))
    q = pcoll._quantize(x, precision)
    rel = float(torch.linalg.norm(q - x) / torch.linalg.norm(x))
    assert 0.0 < rel < bound


def test_topk_keeps_the_heavy_hitters_exactly():
    x = torch.from_numpy(np.random.default_rng(7).normal(size=256)
                         .astype(np.float32))
    q = pcoll._quantize(x, "topk").numpy()
    k = max(1, int(np.ceil(256 * pcoll.SPARSE_TOPK_DENSITY)))
    nz = np.flatnonzero(q)
    assert len(nz) <= k
    assert set(nz) <= set(np.argsort(-np.abs(x.numpy()))[:k].tolist())
    np.testing.assert_array_equal(q[nz], x.numpy()[nz])


def test_constants_match_the_jax_package():
    assert pcoll.ALLREDUCE_PRECISIONS == jcoll.ALLREDUCE_PRECISIONS
    assert pcoll.ALLREDUCE_PRECISIONS == cm.ALLREDUCE_PRECISIONS
    assert pcoll.SPARSE_TOPK_DENSITY == cm.SPARSE_TOPK_DENSITY
    for name in ("ALLREDUCE_PRECISION_ENV", "RS_AG_ENV", "RS_AG_MIN_BYTES",
                 "HIER_MIN_SLICES_ENV", "ALLTOALL_ALGO_ENV",
                 "ALLTOALL_ALGORITHMS"):
        assert getattr(pcoll, name) == getattr(jcoll, name), name


def test_quantize_rejects_unknown_precision():
    with pytest.raises(ValueError, match="no lossy lowering"):
        pcoll._quantize(torch.ones(4), "fp4")


def test_error_feedback_drives_the_accumulated_bias_to_zero():
    x = torch.from_numpy(np.random.default_rng(7).normal(size=512)
                         .astype(np.float32) * 3.0)

    def emitted_mean(steps, compensated):
        pcoll.error_feedback_reset()
        total = torch.zeros(512, dtype=torch.float64)
        for _ in range(steps):
            fn = (pcoll._compensated_quantize if compensated
                  else pcoll._quantize)
            total += fn(x, "int8").double()
        return total / steps

    plain_bias = (emitted_mean(50, False) - x.double()).abs().max()
    comp_bias = (emitted_mean(50, True) - x.double()).abs().max()
    assert comp_bias < plain_bias / 5
    assert comp_bias < 1e-3


def test_error_feedback_is_per_call_site_and_resettable():
    x = torch.ones(8) * 0.3
    pcoll._compensated_quantize(x, "int8")
    pcoll._compensated_quantize(x, "int8")
    assert len(pcoll._ERROR_FEEDBACK) == 2   # two lines, two sites
    for _ in range(2):
        pcoll._compensated_quantize(x, "int8")
    assert len(pcoll._ERROR_FEEDBACK) == 3
    pcoll.error_feedback_reset()
    assert len(pcoll._ERROR_FEEDBACK) == 0


def _fold(parts):
    """The world's all-reduce order: rank 0 + rank 1 + ..."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def test_residuals_are_kept_apart_per_rank():
    """Eight rank threads at one call site: each rank's residual is what
    its own rounding dropped, and its second call adds its own."""
    rng = np.random.default_rng(23)
    xs = torch.from_numpy(rng.normal(size=(N, 64)).astype(np.float32)
                          * np.arange(1, N + 1, dtype=np.float32)[:, None])
    world = st.LocalWorld(N, device="cpu")

    def twice(c):
        return [st.allreduce(xs[c.rank], c, precision="int8")
                for _ in range(2)]

    outs = world.run(twice)
    residuals = {key[-1]: value for key, value in
                 pcoll._ERROR_FEEDBACK.items()}
    assert sorted(residuals) == list(range(N))
    q1 = [pcoll._quantize(xs[r], "int8") for r in range(N)]
    for r in range(N):
        y = xs[r] + (xs[r] - q1[r])
        q2 = pcoll._quantize(y, "int8")
        assert torch.equal(residuals[r], y - q2)
    first = _fold(q1)
    second = _fold([pcoll._quantize(xs[r] + xs[r] - q1[r], "int8")
                    for r in range(N)])
    for r in range(N):
        assert torch.equal(outs[r][0], first)
        assert torch.equal(outs[r][1], second)


# ---- the precision ladder ------------------------------------------------


def test_explicit_pin_outranks_env(monkeypatch):
    x = torch.ones(64)
    monkeypatch.setenv(pcoll.ALLREDUCE_PRECISION_ENV, "int8")
    assert pcoll._resolve_precision("f32", x, PCOMM8,
                                    st.SmiOp.ADD) == "f32"
    assert pcoll._resolve_precision(None, x, PCOMM8,
                                    st.SmiOp.ADD) == "int8"
    monkeypatch.setenv(pcoll.ALLREDUCE_PRECISION_ENV, "f32")
    assert pcoll._resolve_precision("bf16", x, PCOMM8,
                                    st.SmiOp.ADD) == "bf16"


def test_env_malformed_errors_loudly(monkeypatch):
    monkeypatch.setenv(pcoll.ALLREDUCE_PRECISION_ENV, "int7")
    with pytest.raises(ValueError) as err:
        pcoll._resolve_precision(None, torch.ones(64), PCOMM8,
                                 st.SmiOp.ADD)
    assert pcoll.ALLREDUCE_PRECISION_ENV in str(err.value)
    assert "int7" in str(err.value)


@pytest.mark.parametrize("source_kind", ["pin", "env"])
@pytest.mark.parametrize("precision", LOSSY)
def test_ineligible_op_and_dtype_error_as_in_the_jax_package(
        comm8, monkeypatch, source_kind, precision):
    if source_kind == "env":
        monkeypatch.setenv(pcoll.ALLREDUCE_PRECISION_ENV, precision)
        pin = None
    else:
        pin = precision
    for op, dtype, match in (("max", "float32", "ADD allreduce"),
                             ("min", "float32", "ADD allreduce"),
                             ("add", "int32", "floating-point payload")):
        with pytest.raises(ValueError, match=match) as got:
            pcoll._resolve_precision(
                pin, torch.ones(64, dtype=getattr(torch, dtype)), PCOMM8,
                st.SmiOp.parse(op))
        with pytest.raises(ValueError) as want:
            jcoll._resolve_precision(
                pin, jnp.ones(64, dtype=dtype), comm8,
                jcoll.SmiOp.parse(op))
        assert str(got.value).replace("torch.", "") == str(want.value)


def test_unknown_pin_is_loud():
    with pytest.raises(ValueError, match="precision must be one of"):
        pcoll._resolve_precision("fp4", torch.ones(4), PCOMM8,
                                 st.SmiOp.ADD)


@pytest.mark.parametrize("dtype,op", [("int32", "add"), ("float32", "max"),
                                      ("float32", "add")])
def test_auto_path_stays_dense(comm8, dtype, op):
    """No pin, no env: dense, as the JAX package's untuned ladder."""
    assert pcoll._resolve_precision(
        None, torch.ones(64, dtype=getattr(torch, dtype)), PCOMM8,
        st.SmiOp.parse(op)) == "f32"
    assert jcoll._resolve_precision(
        None, jnp.ones(64, dtype=dtype), comm8,
        jcoll.SmiOp.parse(op)) == "f32"


# ---- the allreduce -------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "ring"])
@pytest.mark.parametrize("precision", LOSSY)
def test_pinned_allreduce_is_exact_on_clean_values(backend, precision):
    world = st.LocalWorld(N, device="cpu")
    x = torch.ones(16) * 3.5
    outs = world.run(lambda c: st.allreduce(x, c, precision=precision,
                                            backend=backend))
    for r in range(N):
        assert torch.equal(outs[r], torch.full((16,), 28.0))


@pytest.mark.parametrize("backend", ["xla", "ring"])
@pytest.mark.parametrize("precision", LOSSY + ["f32"])
def test_precision_allreduce_matches_smi_kernel(comm8, backend, precision):
    rng = np.random.default_rng(31)
    x = (rng.normal(size=(N, 48)) * 5).astype(np.float32)

    @smi.smi_kernel(comm8, in_specs=P("smi"), out_specs=P("smi"),
                    backend=backend)
    def japp(ctx, v):
        return ctx.allreduce(v[0], precision=precision)[None]

    world = st.LocalWorld(N, device="cpu")
    papp = st.smi_kernel(world, in_specs="smi", out_specs="smi",
                         backend=backend)(
        lambda ctx, v: ctx.allreduce(v[0], precision=precision)[None])
    want = np.asarray(japp(jnp.asarray(x)))
    got = papp(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # quantise, then the same dense reduction: the port against itself
    q = torch.stack([pcoll._quantize(torch.from_numpy(x[r]), precision)
                     if precision != "f32" else torch.from_numpy(x[r])
                     for r in range(N)])
    np.testing.assert_allclose(got[0], q.double().sum(0).float().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_untuned_allreduce_equals_the_dense_pin():
    world = st.LocalWorld(N, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(N, 64))
                         .astype(np.float32))
    auto = world.run(lambda c: st.allreduce(x[c.rank], c))
    dense = world.run(lambda c: st.allreduce(x[c.rank], c,
                                             precision="f32"))
    for a, d in zip(auto, dense):
        assert torch.equal(a, d)
    assert not pcoll._ERROR_FEEDBACK
