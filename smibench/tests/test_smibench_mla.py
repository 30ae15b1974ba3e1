"""The Moonlight-16B-A3B (``deepseek_v3``) cell on the CPU: its readers on
hand-made traces, its arithmetic, and whole runs of the cell through the
harness at a tiny size: the sound program is ``correct``, the control
and each planted fault are not, and a program that cannot build the
model fails at set-up.

As in the Trinity cell's tests, the tiny size runs the products in
float32: the router's choices near ties would flip under bf16 rounding
and move a probe gradient by a whole expert's share."""

import pytest

from smibench import harness, mla, spec
from smibench.harness import Run
from smibench.trace import SOLVE_SPAN, Trace

CELL = "moonlight-train-2x8k"
SEED = 2**31 + 404
TINY = {
    "config": {
        "num_hidden_layers": 4, "first_k_dense_replace": 1,
        "hidden_size": 64, "num_attention_heads": 2,
        "num_key_value_heads": 2, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "intermediate_size": 96, "moe_intermediate_size": 32,
        "n_routed_experts": 2, "router_experts": 8,
        "num_experts_per_tok": 3, "vocab_size": 97,
        "compute_dtype": "float32"},
    "traffic": {"seq": 64},
}

# -- readers on hand-made traces -----------------------------------------

FACTS = {"batch": 2, "heads": 16, "qk_head_dim": 192, "v_head_dim": 128,
         "live_pairs": 1000.0}
HARNESS = [(SOLVE_SPAN, 0.0, 1.0), (SOLVE_SPAN, 1.0, 2.0),
           (SOLVE_SPAN, 2.0, 3.0)]
PROGRAM = [
    ("smi.train.step", 0.1, 0.9),           # before the window: not read
    ("smi.mla.latent", 0.2, 0.3),           # before the window: not read
    ("smi.train.step", 1.1, 1.9),
    ("smi.attn.mla", 1.15, 1.4),
    ("smi.mla.latent", 1.2, 1.22),
    ("smi.mla.keys", 1.22, 1.25),
    ("smi.moe.route", 1.3, 1.31),
    ("smi.train.step", 2.1, 2.9),
    ("smi.mla.keys", 2.5, 2.55),
]
_NS = "void (anonymous namespace)::"
#: one forward, dq and dk/dv launch of the split form, and a (128, 128)
#: forward that the reader leaves out
KERNELS = [
    (f"{_NS}flash_bf16_kernel<192, 128, false>(CUtensorMap_st)", 1.3, 1.4),
    (f"{_NS}flash_dq_bf16_kernel<192, 128>(CUtensorMap_st)", 1.5, 1.6),
    (f"{_NS}flash_dkdv_bf16_kernel<192, 128, false>(CUtensorMap_st)",
     2.2, 2.4),
    (f"{_NS}flash_bf16_kernel<128, 128, false>(CUtensorMap_st)", 2.4, 2.5),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 2.6, 2.8),
]


def _run(device=KERNELS, host=HARNESS + PROGRAM, trace=True, facts=FACTS,
         counters=None):
    t = Trace(list(device), list(host), (1.0, 3.0)) if trace else None
    return Run({}, {}, dict(facts), {"flops": 1.0}, 3.0, [1.0, 1.0], 2.0,
               dict(counters or {}), t)


def _read(name, run):
    return spec.load_module("metrics", name).read(run)


def test_roofline_counts_the_split_form_alone():
    # 640 + 1024 + 1280 ops a pair and head over 2 x 16 heads and 1000
    # pairs, in 0.1 + 0.1 + 0.2 s of kernel time
    ops = (640 + 1024 + 1280) * 2 * 16 * 1000.0
    assert _read("mla_attention_roofline", _run()) == pytest.approx(
        100 * ops / mla.BF16_FLOPS / 0.4)


def test_glue_host_time_is_the_mla_spans_over_the_steps():
    # 0.02 + 0.03 + 0.05 s over two steps in the window
    assert _read("mla_host_ms_per_step", _run()) == pytest.approx(50.0)


def test_expert_host_time_is_the_moe_spans_over_the_steps():
    # 0.01 s of smi.moe.* over two steps in the window
    assert _read("moe_host_ms_per_step.moonlight", _run()) == pytest.approx(
        5.0)


def test_expert_syncs_are_the_counter_over_the_solves():
    # 60 reads over the two solves of the window
    run = _run(counters={"moe_host_reads": 60})
    assert _read("moe_syncs_per_step.moonlight", run) == pytest.approx(30.0)


def test_idle_is_the_window_share_without_device_work():
    # busy 1.3-1.4, 1.5-1.6, 2.2-2.5 and 2.6-2.8 of the 2 s window
    assert _read("device_idle_pct.moonlight", _run()) == pytest.approx(65.0)


@pytest.mark.parametrize("name, change", [
    ("mla_attention_roofline", dict(device=KERNELS[3:])),
    ("mla_attention_roofline", dict(trace=False)),
    ("mla_attention_roofline", dict(facts={})),
    ("mla_host_ms_per_step", dict(host=HARNESS)),
    ("mla_host_ms_per_step",
     dict(host=HARNESS + [op for op in PROGRAM
                          if not op[0].startswith("smi.mla.")])),
    ("mla_host_ms_per_step", dict(device=[])),
    ("mla_host_ms_per_step", dict(trace=False)),
    ("device_idle_pct.moonlight", dict(host=HARNESS)),
    ("device_idle_pct.moonlight", dict(device=[])),
    ("device_idle_pct.moonlight", dict(trace=False)),
    ("moe_host_ms_per_step.moonlight", dict(host=HARNESS)),
    ("moe_host_ms_per_step.moonlight", dict(device=[])),
    ("moe_host_ms_per_step.moonlight", dict(trace=False)),
    ("moe_syncs_per_step.moonlight", dict()),
], ids=lambda v: v if isinstance(v, str) else "-".join(v) or "nothing")
def test_nothing_to_read_without_what_the_reader_reads(name, change):
    """A program without the split form, the latent spans, the step spans
    or the expert layer's counter gives nothing to read, and raises
    nothing."""
    assert _read(name, _run(**change)) is None


def test_operations_at_the_published_sizes():
    config = spec.config("moonlight_16b_a3b-ep8")
    assert mla.head_dims(config) == (192, 128)
    assert [mla.flash_ops_per_pair(k, 192, 128)
            for k in mla.FLASH_KERNELS] == [640, 1024, 1280]
    fwd = mla.forward_flops(config, 2, 8192)
    assert fwd == pytest.approx(54.76e12, rel=1e-3)
    assert mla.step_flops(config, 2, 8192) == pytest.approx(164.3e12,
                                                            rel=1e-3)
    # the attention core's share of the step
    core = 27 * 640 * 16 * 2 * mla.live_pairs(8192, None)
    assert core / fwd == pytest.approx(0.339, abs=1e-3)


# -- whole runs of the cell -----------------------------------------------

def _cell(program="port"):
    return harness.run_cell(CELL, SEED, 0.0, False, "cpu", overrides=TINY,
                            program=program)


def test_sound_program_is_correct():
    result = _cell()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"grad_rel_err", "update_rel_err",
                                     "route_mismatch_pct"}
    assert set(result["metrics"]) == {"setup_s", "solve_ms_p95"}


def test_traced_run_is_correct():
    result = harness.run_cell(CELL, SEED, 0.2, True, "cpu", overrides=TINY)
    assert result["correct"], result["checks"]


def test_control_is_not_correct():
    assert not _cell("control")["correct"]


def test_latent_norm_left_out(monkeypatch):
    from smi_tpu_torch.models import transformer

    norm = transformer.F.rms_norm
    latent = TINY["config"]["kv_lora_rank"]
    monkeypatch.setattr(transformer.F, "rms_norm", lambda x, shape, w, eps: (
        x * w if tuple(shape) == (latent,) else norm(x, shape, w, eps)))
    assert not _cell()["correct"]


def test_rope_left_off_k_pe(monkeypatch):
    from smi_tpu_torch.models import transformer

    rotate = transformer.glue._rotate
    monkeypatch.setattr(transformer.glue, "_rotate", lambda t, cos, sin: (
        t if t.shape[2] == 1 else rotate(t, cos, sin)))
    assert not _cell()["correct"]


def test_shared_experts_left_out(monkeypatch):
    from smi_tpu_torch.models import moe

    layer = moe.expert_layer

    def without_shared(params, *args, **kwargs):
        params = dict(params)
        params["shared_w2"] = params["shared_w2"] * 0.0   # still a weight
        return layer(params, *args, **kwargs)

    monkeypatch.setattr(moe, "expert_layer", without_shared)
    assert not _cell()["correct"]


def test_router_gradient_halved(monkeypatch):
    """Every router's gradient half what it is, the forward unchanged:
    only the routers' probe sees it."""
    from smi_tpu_torch.models import moe

    layer = moe.expert_layer

    def halved(params, *args, **kwargs):
        params = dict(params)
        r = params["router"] * 0.5
        params["router"] = r + r.detach()
        return layer(params, *args, **kwargs)

    monkeypatch.setattr(moe, "expert_layer", halved)
    assert not _cell()["correct"]


def test_routers_are_judged_stacked():
    """One gap for every router together: a router whose gradient nearly
    cancels, and so is wholly off by a small amount, weighs by its size;
    the other probes keep gaps of their own."""
    import torch

    driver = spec.load_module("drivers", "moonlight_16b_a3b-ep8")
    config = dict(spec.config("moonlight_16b_a3b-ep8"),
                  **TINY["config"])
    names = driver.routers(config)
    assert names == [f"layers.{i}.router" for i in (1, 2, 3)]
    assert set(names) <= set(driver.probes(config)[0])
    want = {n: torch.full((4, 8), 1.0) for n in names}
    want[names[1]] = torch.full((4, 8), 1e-3)       # nearly cancelled
    want["final_norm"] = torch.ones(4)
    got = {n: w.clone() for n, w in want.items()}
    got[names[1]] = torch.zeros(4, 8)                # wholly off
    got["final_norm"] = torch.full((4,), 1.5)
    gaps = driver.probe_gaps(got, want, names)
    assert set(gaps) == {"final_norm", "routers"}
    assert gaps["final_norm"] == pytest.approx(0.5)
    assert gaps["routers"] == pytest.approx(1e-3 / 2 ** 0.5, rel=1e-6)


def test_program_without_the_model_type_fails_at_set_up(monkeypatch):
    """A program that cannot build a ``deepseek_v3`` model (the parent of
    this cell reads every config as ``afmoe``) raises before the first
    solve."""
    from smi_tpu_torch.models import transformer

    monkeypatch.setattr(transformer, "MODEL_TYPES",
                        {"afmoe": transformer.MODEL_TYPES["afmoe"]})
    with pytest.raises(ValueError, match="deepseek_v3"):
        _cell()
