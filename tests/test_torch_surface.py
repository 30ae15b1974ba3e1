"""The port's single-card surface against the JAX package's, on the CPU.

- the roll chain (``smi_tpu_torch.kernels.roll``) against the JAX
  surface's kernel body (``smi_tpu/benchmarks/surface.py:561-573``),
  rebuilt here and run in interpret mode: ``array_equal``;
- ``models/onchip.py`` against ``smi_tpu.models.onchip``;
- the harness (``diff_rate``, ``_attention_flops``) against JAX's;
- every section run on the CPU at ``CPU_SHAPES``, and every section at
  the JAX shapes on the ``meta`` device with the timing stubbed (nothing
  is allocated or run): the 38 metric names of the root ``PERF.json``,
  with its units and ``config`` keys.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from smi_tpu.benchmarks import surface as jsurface
from smi_tpu.models import onchip as jonchip
from smi_tpu_torch.benchmarks import surface
from smi_tpu_torch.kernels import roll
from smi_tpu_torch.models import onchip
from smi_tpu_torch.models import transformer as ttf

ROOT = Path(__file__).resolve().parents[1]
PERF = {m["metric"]: m
        for m in json.loads((ROOT / "PERF.json").read_text())["metrics"]}

_JAX_BODIES = {
    "lane": lambda v: pltpu.roll(v, 1, axis=1),
    "sublane": lambda v: pltpu.roll(v, 1, axis=0),
    "add": lambda v: v + jnp.float32(1.0),
}


def _jax_roll_chain(xs, length, body):
    """The JAX surface's roll kernel (``surface.py:561-573``) for these
    arrays, in interpret mode."""
    ilp = len(xs)
    step = _JAX_BODIES[body]

    def kernel(*refs):
        ins, outs = refs[:ilp], refs[ilp:]
        final = jax.lax.fori_loop(
            0, length,
            lambda i, vs: tuple(step(v) for v in vs),
            tuple(r[...] for r in ins),
        )
        for o, v in zip(outs, final):
            o[...] = v

    shape = jax.ShapeDtypeStruct(xs[0].shape, jnp.float32)
    call = pl.pallas_call(kernel, out_shape=(shape,) * ilp, interpret=True)
    return [np.asarray(o) for o in call(*(jnp.asarray(x) for x in xs))]


@pytest.mark.parametrize("shape", [(16, 256), (32, 128)])
@pytest.mark.parametrize("length", [1, 3, 37])
@pytest.mark.parametrize("ilp", [1, 2])
@pytest.mark.parametrize("body", ["lane", "sublane", "add"])
def test_roll_chain_matches_the_jax_kernel(body, ilp, length, shape):
    rng = np.random.RandomState(length * 10 + ilp)
    xs = [rng.randn(*shape).astype(np.float32) for _ in range(ilp)]
    want = _jax_roll_chain(xs, length, body)
    ts = tuple(torch.from_numpy(x) for x in xs)
    for got in (roll.roll_chain(ts, length, body),
                roll.roll_chain_plain(ts, length, body)):
        assert len(got) == ilp
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("body,axis", [("lane", 1), ("sublane", 0)])
def test_a_whole_turn_returns_the_input(body, axis):
    """A length that is a multiple of the rolled axis gives back the
    input, so a kernel that returned its input unchanged would pass
    there: the card's checks use other lengths and an R=1 control."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(16, 256).astype(np.float32))
    turn = x.shape[axis]
    for length in (turn, 4 * turn):
        assert torch.equal(roll.roll_chain((x,), length, body)[0], x)
    assert not torch.equal(roll.roll_chain((x,), 1, body)[0], x)
    np.testing.assert_array_equal(
        roll.roll_chain((x,), turn + 3, body)[0].numpy(),
        np.roll(x.numpy(), 3, axis))


def test_roll_chain_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(8, 64)
    with pytest.raises(TypeError, match="float32"):
        roll.roll_chain((x.double(),), 1, "lane")
    with pytest.raises(ValueError, match="contiguous"):
        roll.roll_chain((torch.zeros(64, 8).t(),), 1, "lane")
    with pytest.raises(ValueError, match="one shape"):
        roll.roll_chain((x, torch.zeros(8, 32)), 1, "lane")
    with pytest.raises(ValueError, match="body"):
        roll.roll_chain((x,), 1, "diagonal")
    with pytest.raises(ValueError, match="limit of 4096 elements"):
        roll.plan(4, 20000, 1, "lane")
    with pytest.raises(ValueError, match="limit of 4096 elements"):
        roll.plan(9000, 4, 2, "sublane")


@pytest.mark.parametrize("shape,ilp,body,regs,warps,blocks", [
    ((512, 2048), 1, "lane", 64, 4, 128),
    ((256, 2048), 2, "lane", 64, 4, 128),
    ((512, 2048), 1, "sublane", 16, 4, 512),
    ((256, 2048), 2, "sublane", 8, 4, 1024),
    ((512, 2048), 1, "add", 64, 4, 128),
    ((7, 300), 3, "lane", 16, 4, 6),
    ((33, 5), 1, "sublane", 2, 4, 2),
])
def test_roll_plan_keeps_the_rolled_axis_whole(shape, ilp, body, regs,
                                               warps, blocks):
    """A warp holds a whole line of a chain: the rolled axis in the least
    power-of-two count of registers that holds it, within the kernel's
    registers a thread; blocks of 4 warps, a warp for each line of each
    chain."""
    p = roll.plan(*shape, ilp, body)
    n = shape[0] if body == "sublane" else shape[1]
    assert (p["axis"], p["lines"]) == (n, shape[1] if body == "sublane"
                                       else shape[0])
    assert (p["regs"], p["warps"], p["blocks"]) == (regs, warps, blocks)
    assert 32 * regs >= n and (regs == 1 or 16 * regs < n)
    assert regs <= roll.MAX_REGS
    assert p["args"] == (regs, warps)
    assert (blocks - 1) * warps < ilp * p["lines"] <= blocks * warps


# ------------------------------------------------------------- onchip --


def test_stencil_onchip_matches_the_jax_module():
    rng = np.random.RandomState(0)
    grid = rng.rand(64, 96).astype(np.float32)
    want = np.asarray(jonchip.run_stencil_onchip(jnp.asarray(grid,
                                                             jnp.float32),
                                                 25))
    assert want.dtype == np.float32
    got = onchip.run_stencil_onchip(grid, 25, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the edges hold, as in the JAX module
    np.testing.assert_array_equal(got.numpy()[0], grid[0])


def test_gesummv_onchip_matches_the_jax_module():
    rng = np.random.RandomState(1)
    a, b = rng.rand(2, 128, 128).astype(np.float32)
    x = rng.rand(128).astype(np.float32)
    want = np.asarray(jonchip.run_gesummv_onchip(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
        jnp.asarray(x, jnp.float32), alpha=1.5, beta=0.5))
    got = onchip.run_gesummv_onchip(a, b, x, alpha=1.5, beta=0.5,
                                    device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_gesummv_onchip_refuses_tf32_and_leaves_the_flag(monkeypatch):
    fn = onchip.make_gesummv_onchip_fn()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ValueError, match="TF32"):
        fn(torch.ones(4, 4), torch.ones(4, 4), torch.ones(4))
    assert torch.backends.cuda.matmul.allow_tf32 is True


# ------------------------------------------------------------ harness --


@pytest.mark.parametrize("s", [1, 7, 4096])
@pytest.mark.parametrize("h,d", [(1, 16), (8, 128)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_attention_flops_equal_jax(s, h, d, causal, train):
    assert (surface._attention_flops(s, h, d, causal, train)
            == jsurface._attention_flops(s, h, d, causal, train))


@pytest.mark.parametrize("kwargs", [
    {}, {"r1": 4, "factor": 4, "max_reps": 1024},
    {"min_delta": 0.05, "runs": 1}, {"r1": 4, "factor": 3, "max_reps": 6},
])
def test_diff_rate_equals_jax_under_a_stubbed_clock(monkeypatch, kwargs):
    """``make_fn(r)`` hands the rep count to a stubbed ``_timed``, which
    answers a fixed cost plus a per-rep time: both harnesses must walk
    the same rep counts to the same rate and trace."""
    seen = {}

    def clock(tag):
        def timed(r, runs=None):
            seen.setdefault(tag, []).append((r, runs))
            return 0.05 + 0.0031 * r
        return timed

    monkeypatch.setattr(surface, "_timed", clock("port"))
    monkeypatch.setattr(jsurface, "_timed", clock("jax"))
    got = surface.diff_rate(lambda r: r, 2.5, **kwargs)
    want = jsurface.diff_rate(lambda r: r, 2.5, **kwargs)
    assert got == want
    assert [r for r, _ in seen["port"]] == [r for r, _ in seen["jax"]]


def test_diff_rate_guard_is_eager_as_in_jax():
    calls = []
    for module in (surface, jsurface):
        with pytest.raises(ValueError) as exc:
            module.diff_rate(calls.append, 1.0, r1=8, max_reps=8)
        calls.append(str(exc.value))
    assert calls[0] == calls[1] and "r1 < max_reps" in calls[0]


def test_stencil_roofline_reads_the_h100_peaks():
    roof = surface.stencil_roofline(1e12, 16)
    assert roof["vs_hbm_roofline"] == pytest.approx(1e12 * 8 / 16 / 3.35e12)
    assert roof["vs_f32_roofline"] == pytest.approx(4e12 / 67e12)
    assert roof["essential_gflops"] == pytest.approx(4000.0)
    assert roof["depth"] == 16
    mfu = surface._mfu_roofline(67.0, "f32")
    assert mfu["mfu_vs_f32_effective_peak"] == pytest.approx(1.0)
    assert mfu["peak_bf16_tflops"] == 989.0
    assert "mfu_vs_f32_effective_peak" not in surface._mfu_roofline(1.0,
                                                                    "bf16")


# ----------------------------------------------------------- sections --

#: where the port's records rightly differ from ``PERF.json``'s: the H100
#: has no VPU, so the stencil rows carry an f32 share instead; the
#: ``estimator`` key of one forward row and the baseline add row's
#: missing ``chains`` are older than the JAX source, which writes neither
#: the one nor omits the other (``surface.py:191-196, 604``)
ROOFLINE_RENAMES = {"vs_vpu_roofline": "vs_f32_roofline"}
CONFIG_DRIFT = {"flash_attn_fwd_s8192_bf16": ({"estimator"}, set()),
                "roll_chain_baseline_add_ps_per_elem": (set(), {"chains"})}


def _shapes_only(config):
    """``init_params``' shapes in zeros, without drawing the numbers."""
    e, h, d, kv = (config.embed, config.heads, config.head_dim,
                   config._kv)
    return {"wqkv": np.zeros((e, (h + 2 * kv) * d), np.float32),
            "wo": np.zeros((h * d, e), np.float32),
            "w1": np.zeros((e, config.mlp_ratio * e), np.float32),
            "w2": np.zeros((config.mlp_ratio * e, e), np.float32)}


@pytest.fixture(scope="module")
def dry_run():
    """Every section at the JAX shapes on the meta device: the harness
    stubbed (nothing is timed or run) and the transformer's weights left
    at zero, so nothing of full size is allocated."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(surface, "diff_rate",
                   lambda make_fn, work, **kw: (1.0, (1, 4, 0.1, 0.2)))
        mp.setattr(surface, "_timed", lambda fn, runs=None: 0.1)
        mp.setattr(ttf, "init_params", lambda config, seed=0:
                   _shapes_only(config))
        bench = surface.Bench("meta", surface.CARD_SHAPES)
        return {name: section(bench)
                for name, section in surface.SECTIONS.items()}


def test_the_jax_shapes_give_the_38_metrics_of_perf_json(dry_run):
    names = [r["metric"] for recs in dry_run.values() for r in recs]
    assert len(names) == len(set(names)) == 38
    assert set(names) == set(PERF)


@pytest.mark.parametrize("name", list(surface.SECTIONS))
def test_each_record_keeps_the_jax_schema(dry_run, name):
    for rec in dry_run[name]:
        want = PERF[rec["metric"]]
        assert rec["unit"] == want["unit"], rec["metric"]
        extra, missing = CONFIG_DRIFT.get(rec["metric"], (set(), set()))
        assert set(rec["config"]) == (set(want["config"]) - extra) | missing
        want_roof = {ROOFLINE_RENAMES.get(k, k)
                     for k in want.get("roofline", {})}
        assert set(rec.get("roofline", {})) == want_roof, rec["metric"]


def test_the_roll_rows_keep_the_jax_source_schema(monkeypatch):
    """The JAX roll section itself, with its harness stubbed (no kernel
    is built or run): the port's roll records have its names and
    ``config`` keys."""
    monkeypatch.setattr(jsurface, "_diff_rate",
                        lambda make_fn, work, **kw: (1.0, (4, 16, 0.1, 0.2)))
    monkeypatch.setattr(surface, "diff_rate",
                        lambda make_fn, work, **kw: (1.0, (4, 16, 0.1, 0.2)))
    want = jsurface.roll_chain_points(None)
    got = surface.roll_chain_points(
        surface.Bench("meta", surface.CARD_SHAPES))
    assert [r["metric"] for r in got] == [r["metric"] for r in want]
    for g, w in zip(got, want):
        assert g["unit"] == w["unit"] and g["config"] == w["config"]


@pytest.fixture(scope="module")
def cpu_run():
    """Every section on the CPU at ``CPU_SHAPES``, at the least harness
    depth (one run a point, one escalation)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(surface, "RUNS", 1)
        mp.setattr(surface, "MIN_DELTA", -1.0)
        bench = surface.Bench("cpu", surface.CPU_SHAPES)
        assert not bench.rooflines
        return {name: section(bench)
                for name, section in surface.SECTIONS.items()}


@pytest.mark.parametrize("name", list(surface.SECTIONS))
def test_each_section_runs_on_the_cpu(cpu_run, dry_run, name):
    """The CPU run's records follow the JAX-shape records one for one
    (the shapes in the names differ): unit and ``config`` keys equal,
    values finite, and no roofline, since a CPU time is no card
    metric."""
    got, want = cpu_run[name], dry_run[name]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["unit"] == w["unit"]
        assert set(g["config"]) == set(w["config"]), g["metric"]
        assert math.isfinite(g["value"])
        assert "roofline" not in g


def test_quick_keeps_the_jax_subset(monkeypatch):
    monkeypatch.setattr(surface, "diff_rate",
                        lambda make_fn, work, **kw: (1.0, (1, 4, 0.1, 0.2)))
    bench = surface.Bench("meta", surface.CARD_SHAPES)
    names = [r["metric"] for section in surface.SECTIONS.values()
             for r in section(bench, quick=True)]
    assert names == [
        "flash_attn_fwd_s4096_f32", "flash_attn_fwd_s8192_f32",
        "flash_attn_train_tflops_f32", "flash_attn_train_tokens_f32",
        "flash_vs_jnp_speedup", "flash_vs_stock_default",
        "stencil_fused_gcells", "stencil_temporal_gcells",
        "stencil_temporal_vs_fused", "gesummv_onchip_gflops",
        "kmeans_mpoint_iters",
    ]


def test_main_writes_and_merges_the_cpu_artifact(monkeypatch, tmp_path):
    monkeypatch.setattr(surface, "RUNS", 1)
    monkeypatch.setattr(surface, "MIN_DELTA", -1.0)
    out = tmp_path / "surface.json"
    assert surface.main(["--cpu", "--only", "rolls", "-o", str(out)]) == 0
    first = json.loads(out.read_text())
    assert first["device"] == "cpu" and first["rooflines"] is None
    assert len(first["metrics"]) == 5
    assert surface.main(["--cpu", "--quick", "--only", "apps", "-o",
                         str(out)]) == 0
    merged = json.loads(out.read_text())
    assert [m["metric"] for m in merged["metrics"]] == (
        [m["metric"] for m in first["metrics"]]
        + ["gesummv_onchip_gflops", "kmeans_mpoint_iters"])
    assert surface.main(["--cpu", "--quick", "--fresh", "--only", "apps",
                         "-o", str(out)]) == 0
    assert len(json.loads(out.read_text())["metrics"]) == 2
    with pytest.raises(SystemExit):
        surface.main(["--cpu", "--only", "bogus", "-o", str(out)])


def test_the_default_artifact_is_never_the_root_perf_json():
    assert surface.OUT_DIR == ROOT / "build" / "surface"
    assert "build/surface/" in (ROOT / ".gitignore").read_text()
