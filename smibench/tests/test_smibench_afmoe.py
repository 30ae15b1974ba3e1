"""The Trinity-Mini (``afmoe``) cell on the CPU: its readers on hand-made
traces, its reference's batches, and whole runs of the cell through the harness at a tiny size: the sound program is
``correct``, the control and each planted fault are not.

The tiny size runs the products in float32: with 16 experts over 64
dims the router's choices sit near ties, and bf16 rounding flips them
for a few % of the tokens, moving a probe gradient by a whole expert's
share (20-50 % at this size, against the limits set for the published
widths). In float32 the program reads ~1e-6 against the reference."""

import json
import sys

import pytest
import torch

from smibench import afmoe, harness, spec
from smibench.harness import Run
from smibench.trace import SOLVE_SPAN, Trace

CELL = "trinity-train-2x8k"
SEED = 2**31 + 303
TINY = {
    "config": {
        "num_hidden_layers": 8, "num_dense_layers": 2, "hidden_size": 64,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "layer_types": (["sliding_attention"] * 3 + ["full_attention"]) * 2,
        "sliding_window": 16, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_experts": 2, "router_experts": 16,
        "num_experts_per_tok": 4, "vocab_size": 97,
        "compute_dtype": "float32"},
    "traffic": {"seq": 64},
}

# -- readers on hand-made traces -----------------------------------------

FACTS = {"batch": 2, "heads": 4, "head_dim": 16, "mean_live_pairs": 1000.0}
HARNESS = [(SOLVE_SPAN, 0.0, 1.0), (SOLVE_SPAN, 1.0, 2.0),
           (SOLVE_SPAN, 2.0, 3.0)]
PROGRAM = [
    ("smi.train.step", 0.1, 0.9),           # before the window: not read
    ("smi.moe.dispatch", 0.2, 0.3),         # before the window: not read
    ("smi.train.step", 1.1, 1.9),
    ("smi.moe.route", 1.2, 1.21),
    ("smi.moe.dispatch", 1.21, 1.25),
    ("smi.moe.experts", 1.25, 1.3),
    ("smi.moe.combine", 1.3, 1.31),
    ("smi.train.step", 2.1, 2.9),
    ("smi.moe.dispatch", 2.5, 2.6),
]
#: one forward, dq and dk/dv launch a layer, two layers a step
KERNELS = [
    ("void flash_bf16_kernel<128, false>(CUtensorMap_st)", 1.3, 1.4),
    ("void flash_bf16_kernel<128, false>(CUtensorMap_st)", 1.4, 1.5),
    ("void (anonymous namespace)::flash_dq_bf16_kernel<128>(Params)",
     1.5, 1.65),
    ("void (anonymous namespace)::flash_dq_bf16_kernel<128>(Params)",
     1.65, 1.8),
    ("void flash_dkdv_bf16_kernel<128, false>(Params)", 2.2, 2.4),
    ("void flash_dkdv_bf16_kernel<128, false>(Params)", 2.4, 2.6),
    ("ampere_bf16_gemm", 2.6, 2.8),
]
READERS = ("afmoe_attention_roofline", "moe_host_ms_per_step",
           "moe_syncs_per_step", "device_idle_pct.afmoe")


def _run(device=KERNELS, host=HARNESS + PROGRAM, trace=True, facts=FACTS,
         counters=None):
    t = Trace(list(device), list(host), (1.0, 3.0)) if trace else None
    return Run({}, {}, dict(facts), {"flops": 1.0}, 3.0, [1.0, 1.0], 2.0,
               {"moe_host_reads": 120} if counters is None else counters, t)


def _read(name, run):
    return spec.load_module("metrics", name).read(run)


def test_roofline_counts_each_launch_at_its_operations():
    # 2 forward launches at 4, 2 dq at 6, 2 dk/dv at 8 ops a pair, head
    # and dim: 36 * 2 * 4 * 16 * 1000 ops over 0.9 s of kernel time
    ops = 36 * 2 * 4 * 16 * 1000.0
    assert _read("afmoe_attention_roofline", _run()) == pytest.approx(
        100 * ops / afmoe.BF16_FLOPS / 0.9)


def test_roofline_reads_the_same_with_the_forward_recomputed():
    fwd = [k for k in KERNELS if "flash_bf16" in k[0]]
    shifted = [(n, s + 0.5, e + 0.5) for n, s, e in fwd]
    assert _read("afmoe_attention_roofline",
                 _run(device=KERNELS + shifted)) == pytest.approx(
        _read("afmoe_attention_roofline", _run()))


def test_expert_host_time_is_the_moe_spans_over_the_steps():
    # 0.01 + 0.04 + 0.05 + 0.01 + 0.1 s over two steps in the window
    assert _read("moe_host_ms_per_step", _run()) == pytest.approx(105.0)


def test_syncs_are_the_counter_over_the_solves():
    assert _read("moe_syncs_per_step", _run()) == 60.0


def test_idle_is_the_window_share_without_device_work():
    # busy 1.3-1.8 and 2.2-2.8 of the 2 s window
    assert _read("device_idle_pct.afmoe", _run()) == pytest.approx(45.0)


@pytest.mark.parametrize("name, change", [
    ("afmoe_attention_roofline", dict(device=KERNELS[-1:])),
    ("afmoe_attention_roofline", dict(trace=False)),
    ("afmoe_attention_roofline", dict(facts={})),
    ("moe_host_ms_per_step", dict(host=HARNESS)),
    ("moe_host_ms_per_step", dict(device=[])),
    ("moe_host_ms_per_step", dict(trace=False)),
    ("moe_syncs_per_step", dict(counters={})),
    ("device_idle_pct.afmoe", dict(host=HARNESS)),
    ("device_idle_pct.afmoe", dict(device=[])),
    ("device_idle_pct.afmoe", dict(trace=False)),
], ids=lambda v: v if isinstance(v, str) else "-".join(v))
def test_nothing_to_read_without_what_the_reader_reads(name, change):
    assert _read(name, _run(**change)) is None


def test_live_pairs_and_step_work_at_the_published_sizes():
    config = spec.config("trinity_mini-ep16")
    assert afmoe.live_pairs(8192, 2048) == 14_681_088
    assert afmoe.live_pairs(8192, None) == 33_558_528
    assert afmoe.live_pairs(16, 64) == afmoe.live_pairs(16, None) == 136
    fwd = afmoe.forward_flops(config, 2, 8192)
    assert fwd == pytest.approx(62.6e12, rel=2e-3)
    assert afmoe.step_flops(config, 2, 8192) == 3 * fwd


# -- the reference --------------------------------------------------------

def test_batch_is_zipf_over_the_slice_and_seeded_by_step():
    ref = spec.load_module("references", "trinity_mini-ep16")
    ids, labels = ref.make_batch(1000, 2, 4096, 1.1, SEED, 0, "cpu")
    assert torch.equal(ids[:, 1:], labels[:, :-1])
    assert 0 <= int(ids.min()) and int(ids.max()) < 1000
    counts = torch.bincount(ids.reshape(-1), minlength=1000).sort(
        descending=True).values.double()
    # the most drawn token against the tenth: 10 ** 1.1 = 12.6 under Zipf
    assert 9 < float(counts[0] / counts[9]) < 17
    again, _ = ref.make_batch(1000, 2, 4096, 1.1, SEED, 0, "cpu")
    other, _ = ref.make_batch(1000, 2, 4096, 1.1, SEED, 1, "cpu")
    assert torch.equal(ids, again) and not torch.equal(ids, other)


# -- whole runs of the cell -----------------------------------------------

def _cell(program="port"):
    return harness.run_cell(CELL, SEED, 0.0, False, "cpu", overrides=TINY,
                            program=program)


def test_sound_program_is_correct():
    result = _cell()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_abs_err", "grad_rel_err",
                                     "update_rel_err", "route_mismatch_pct"}
    assert set(result["metrics"]) == {"setup_s", "solve_ms_p95"}


def test_traced_run_reads_the_counter_and_is_correct():
    result = harness.run_cell(CELL, SEED, 0.2, True, "cpu", overrides=TINY)
    assert result["correct"], result["checks"]
    # 6 expert layers, each read once a step (the recompute reuses it)
    assert result["metrics"]["moe_syncs_per_step"]["value"] == 6.0


def test_control_is_not_correct():
    result = _cell("control")
    assert not result["correct"], result["checks"]


def test_held_experts_are_judged_one_by_one(capfd):
    """Each probe's gap of each judged step goes to stderr, the held
    experts' matrices expert by expert; the check is the widest."""
    result = _cell()
    lines = [json.loads(line) for line in capfd.readouterr().err.splitlines()
             if line.startswith('{"step"')]
    # 10 probes, and the tiny size's 2 held experts in each of 3 matrices
    assert lines and all(len(line["probe_rel_err"]) == 16 for line in lines)
    assert "layers.2.experts_w3[1]" in lines[0]["probe_rel_err"]
    assert result["checks"]["grad_rel_err"]["value"] == max(
        v for line in lines for v in line["probe_rel_err"].values())


def test_reference_takes_the_forced_choices():
    """Forced to its own choices the reference is unchanged; forced to
    others it is not, and it still records its own."""
    ref = spec.load_module("references", "trinity_mini-ep16")
    cfg = dict(spec.config("trinity_mini-ep16"), **TINY["config"])
    w = ref.make_weights(cfg, SEED, "cpu")
    ids, labels = ref.make_batch(97, 2, 64, 1.1, SEED, 0, "cpu")
    own = {i: [] for i in range(2, 8)}
    loss, grads = ref.loss_and_grads(w, ids, labels, cfg, routes=own)
    same = {i: r[0] for i, r in own.items()}
    again, grads_again = ref.loss_and_grads(w, ids, labels, cfg,
                                            forced=same)
    assert torch.equal(loss, again)
    for name, g in grads.items():
        assert torch.equal(g, grads_again[name]), name
    other = dict(same)
    other[4] = (same[4] + 1) % 16
    recorded = {4: []}
    moved, _ = ref.loss_and_grads(w, ids, labels, cfg, forced=other,
                                  routes=recorded)
    assert not torch.equal(moved, loss)
    assert torch.equal(recorded[4][0], same[4])


def test_held_expert_left_out(monkeypatch):
    from smi_tpu_torch.models import moe

    layer = moe.expert_layer

    def without_expert_0(params, *args, **kwargs):
        params = dict(params)
        w2 = params["experts_w2"].clone()
        w2[0] = 0.0
        params["experts_w2"] = w2
        return layer(params, *args, **kwargs)

    monkeypatch.setattr(moe, "expert_layer", without_expert_0)
    assert not _cell()["correct"]


def test_gate_left_out(monkeypatch):
    from smi_tpu_torch.models import transformer

    # ``wg`` stays a weight of the step, its gradient zero
    monkeypatch.setattr(transformer, "_gate",
                        lambda attn, xn, wg, mm: attn + 0.0 * wg.sum())
    assert not _cell()["correct"]


def test_program_without_the_expert_layer_fails_at_set_up(monkeypatch):
    """A program without ``models/moe.py`` (the parent of this cell)
    raises on the driver's first import."""
    import smi_tpu_torch.models as models

    monkeypatch.delattr(models, "moe")
    monkeypatch.setitem(sys.modules, "smi_tpu_torch.models.moe", None)
    with pytest.raises(ImportError):
        _cell()
