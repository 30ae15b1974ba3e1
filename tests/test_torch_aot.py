"""The port's ahead-of-card check: ``smi_tpu_torch/parallel/aot.py``.

The JAX module compiles the multi-chip surface against abstract TPU
topologies; the port builds its CUDA sources for ``sm_90a`` and holds
every launch the port makes for each of the same cases to the card's
limits. Here (no ``nvcc``) the build is faked with a ``-Xptxas -v`` log
in ptxas's own format; the card case in ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase 38 build for real and ask the runtime. Checked:
the case names per topology are the JAX surface's (as recorded in the
committed ``AOT_TPU_r05.json``), plus the port's own pipeline and roll
cases; the ring cases' recorded launches are the ones
``kernels/ring.py`` plans for those payloads; the log parser and the
occupancy arithmetic; a launch over a limit raises naming it; and
without ``nvcc`` the check fails by name, never silently.
"""

import json
import os

import pytest

from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import ring as kring
from smi_tpu_torch.kernels import stencil_temporal as kt
from smi_tpu_torch.parallel import aot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: mangled instances of every kernel, as ptxas names them
_NS = "_ZN12_GLOBAL__N_1"


def _instances():
    out = {
        "ring": [f"{_NS}23neighbour_stream_kernelENS_6ParamsEi",
                 f"{_NS}17all_gather_kernelENS_6ParamsEi"]
        + [f"{_NS}13reduce_kernelI{t}Li{op}ELb{rs}EEEvNS_6ParamsE"
           for t in ("i", "f", "d", "a", "s", "13__nv_bfloat16")
           for op in range(3) for rs in (0, 1)],
        "flash_fwd": [f"{_NS}17flash_{dt}_kernelILi{d}ELb{c}EEEvNS_6ParamsE"
                      for dt in ("bf16", "f32") for d in (64, 128, 256)
                      for c in (0, 1)]
        + [f"{_NS}17flash_bf16_kernelILi192ELi128ELb{c}EEEvNS_6ParamsE"
           for c in (0, 1)],
        "flash_bwd": [f"{_NS}{len(n)}{n}ILi{d}EEEvNS_6ParamsE"
                      for n in ("flash_dq_bf16_kernel",
                                "flash_dkdv_bf16_kernel",
                                "flash_dq_f32_kernel",
                                "flash_dkdv_f32_kernel")
                      for d in (64, 128, 256)]
        + [f"{_NS}{len(n)}{n}ILi192ELi128EEEvNS_6ParamsE"
           for n in ("flash_dq_bf16_kernel", "flash_dkdv_bf16_kernel")],
        "stencil_temporal": [f"{_NS}15temporal_kernelILi{k}EEEvNS_4ArgsE"
                             for k in (0, 8, 16, 32)],
        "stencil_pipeline": [f"{_NS}15pipeline_kernelILi{k}ELb{b}EEEvv"
                             for k in (8, 16, 32) for b in (0, 1)],
        "stencil_sweep": [f"{_NS}12sweep_kernelEPKfS1_S1_S1_S1_Pfiiiiii"],
        "roll_chain": [f"{_NS}17roll_chain_kernelILb{r}ELi{g}EEEvv"
                       for r in (0, 1) for g in (1, 2, 4, 8, 16, 32, 64,
                                                 128)],
        "attn_glue": [f"{_NS}{len(n)}{n}ILi{d}EEEvNS_{p}E"
                      for n, p in (("attn_prologue_kernel", "8Prologue"),
                                   ("attn_prologue_bwd_kernel",
                                    "11PrologueBwd"),
                                   ("attn_epilogue_kernel", "8Epilogue"),
                                   ("attn_epilogue_bwd_kernel", "8Epilogue"))
                      for d in (64, 128, 256)]
        + [f"{_NS}18weight_grad_kernelEPKfiiPf"],
        "residual_norm": [f"{_NS}{len(n)}{n}ILi{f}ELb{y}EEEvNS_{p}E"
                          for n, p in (("residual_norm_kernel", "3Fwd"),
                                       ("residual_norm_bwd_kernel",
                                        "3Bwd"))
                          for f, y in ((0, 1), (1, 0), (1, 1), (2, 0))]
        + [f"{_NS}18weight_grad_kernelEPKfiiPf"],
    }
    return out


#: registers and static shared memory a fake build reports (the flash
#: f32 instances, 256 threads a block, take 255 registers)
_FIGURES = {"ring": (64, 0), "flash_fwd": (168, 0), "flash_bwd": (168, 0),
            "stencil_temporal": (218, 0), "stencil_pipeline": (128, 0),
            "stencil_sweep": (16, 0), "roll_chain": (150, 0),
            "attn_glue": (40, 8192), "residual_norm": (96, 16)}


def fake_log(source, registers=None, smem=None):
    regs, static = _FIGURES[source]
    regs = regs if registers is None else registers
    static = static if smem is None else smem
    lines = []
    for name in _instances()[source]:
        used = (255 if registers is None and "flash" in name
                and "f32" in name else regs)
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads",
            f"ptxas info    : Used {used} registers, used 1 barriers, "
            f"{static} bytes smem, 400 bytes cmem[0]",
        ]
    return "\n".join(lines) + "\n"


@pytest.fixture()
def fake_build(monkeypatch):
    """A build without nvcc: every source's log is :func:`fake_log`."""
    logs = {s: fake_log(s) for s in _build.SOURCES}
    monkeypatch.setattr(aot, "build_sources", lambda names=None: {})
    monkeypatch.setattr(_build, "build_log", lambda name: logs[name])
    return logs


def _artifact_names():
    with open(os.path.join(REPO, "AOT_TPU_r05.json")) as f:
        data = json.load(f)
    return {t: sorted(e["programs"]) for t, e in data["topologies"].items()}


@pytest.mark.parametrize("topology", ["v5e:2x4", "v5e:4x4", "v5e:2x4*2"])
def test_cases_are_the_jax_surface(topology):
    names = [n for n, _ in aot.cases_for(topology)(topology)]
    jax = _artifact_names()[topology]
    assert sorted(n for n in names if not n.startswith("port_")) == jax
    extra = [n for n in names if n.startswith("port_")]
    if aot.is_multislice(topology):
        assert extra == []
    else:
        px, py = aot.grid2d(aot.topology_ranks(topology))
        assert extra == [f"port_stencil_pipeline_8192_{px}x{py}",
                         "port_roll_chain_surface",
                         "port_afmoe_attention_glue",
                         "port_afmoe_residual_norm",
                         "port_mla_flash"]


@pytest.mark.parametrize("topology,ranks", [
    ("v5e:2x4", 8), ("v5e:4x4", 16), ("v5e:2x4*2", 16), ("v5e:8", 8),
])
def test_topology_names(topology, ranks):
    from smi_tpu.parallel import aot as jaot

    assert aot.topology_ranks(topology) == ranks
    assert aot.parse_topology(topology) == jaot.parse_topology(topology)
    assert aot.grid2d(ranks) == jaot.grid2d(ranks)
    part = aot.slice_partition(topology)
    assert sorted(part) == list(range(ranks))
    assert len(set(part.values())) == (2 if "*2" in topology else 1)
    with pytest.raises(ValueError):
        aot.topology_ranks("v5e")


def test_surface_fits_on_a_fake_build(fake_build):
    for topology in ("v5e:2x4", "v5e:4x4", "v5e:2x4*2"):
        reports = aot.check_surface(topology, runtime=False)
        assert set(reports) == {n for n, _ in aot.cases_for(topology)(topology)}
        for name, rep in reports.items():
            for launch in rep["launches"]:
                assert launch["smem"] <= _build.SMEM_BYTES_LIMIT
                assert launch["instances"], name
                if launch["cooperative"]:
                    assert launch["blocks"] <= launch["resident_blocks"]
        kernels = {k for r in reports.values() for k in r["kernels"]}
        if not aot.is_multislice(topology):
            # every kernel of the port is launched by some case
            assert kernels == set(_build.SIGNATURES) - {
                "ring_all_reduce_chunked"}
        else:
            assert kernels == set()


@pytest.mark.parametrize("n", [8, 16])
def test_ring_cases_record_the_planned_launches(n):
    """The recorded ring launches are what ``ring.launch_plan`` gives for
    the JAX cases' payloads: 16x256 f32 gathered, 256 f32 reduced, a
    (4, 8, 256) stream of four 8 KiB chunks."""
    topology = "v5e:2x4" if n == 8 else "v5e:4x4"
    plans = dict(aot.surface_cases(topology))
    want = {
        "ring_all_gather_fc": ("ring_all_gather", 16 * 256 * 4),
        "ring_all_reduce_fc": ("ring_all_reduce", 256 * 4),
        "ring_reduce_scatter_nofc": ("ring_reduce_scatter", 16 * 256 * 4),
        "neighbour_stream_fc": ("ring_neighbour_stream", 8 * 256 * 4),
        "ring_all_reduce_bf16": ("ring_all_reduce", 256 * 2),
        "neighbour_stream_int8": ("ring_neighbour_stream", 8 * 256),
        "p2p_transfer_ring_multihop": ("ring_neighbour_stream", 2048 * 4),
    }
    for case, (kernel, unit) in want.items():
        (launch,) = plans[case]()
        assert (launch["kernel"], launch["unit_bytes"]) == (kernel, unit)
        slice_bytes = (kring.STREAM_SLICE_BYTES
                       if kernel == "ring_neighbour_stream"
                       else kring.SLICE_BYTES)
        assert launch["blocks"] == n * kring.launch_plan(
            unit, n, 1, slice_bytes)[1]
        assert launch["ranks"] == n and launch["cooperative"]
    (rooted,) = plans["reduce_ring_rooted"]()
    assert rooted["op"] == kring.OP_CODES[kring.SmiOp.MAX]
    halo = plans["halo_ring_corners"]()
    assert {l["kernel"] for l in halo} == {"ring_neighbour_stream"}


def test_log_parser_reads_ptxas_figures():
    log = fake_log("ring", registers=40, smem=96)
    figs = aot.kernel_resources(log)
    assert len(figs) == len(_instances()["ring"])
    for f in figs.values():
        assert f == {"stack": 0, "spill": (0, 0), "registers": 40,
                     "smem": 96}
    log += ("ptxas info    : Function properties for helper\n"
            "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\n")
    assert "helper" not in aot.kernel_resources(log)


@pytest.mark.parametrize("mangled,want", [
    (f"{_NS}13reduce_kernelIfLi1ELb0EEEvNS_6ParamsE",
     ("ring_reduce", {"t": "float32", "op": "1", "rs": "0"})),
    (f"{_NS}13reduce_kernelI13__nv_bfloat16Li0ELb1EEEvNS_6ParamsE",
     ("ring_reduce", {"t": "bfloat16", "op": "0", "rs": "1"})),
    (f"{_NS}17flash_bf16_kernelILi128ELb1EEEvv",
     ("flash_block", {"dt": "bf16", "d": "128"})),
    (f"{_NS}16flash_f32_kernelILi64ELb0EEEvv",
     ("flash_fused", {"dt": "f32", "d": "64"})),
    (f"{_NS}22flash_dkdv_bf16_kernelILi128ELb1EEEvv",
     ("flash_bwd_dkdv", {"dt": "bf16", "d": "128"})),
    (f"{_NS}17flash_bf16_kernelILi192ELi128ELb0EEEvv",
     ("flash_fused", {"dt": "bf16", "d": "192", "dv": "128"})),
    (f"{_NS}22flash_dkdv_bf16_kernelILi128ELi128ELb1EEEvv",
     ("flash_bwd_dkdv", {"dt": "bf16", "d": "128", "dv": "128"})),
    (f"{_NS}20flash_dq_bf16_kernelILi192ELi128EEEvv",
     ("flash_bwd_dq", {"dt": "bf16", "d": "192", "dv": "128"})),
    (f"{_NS}17roll_chain_kernelILb0ELi64EEEvv",
     ("roll_chain", {"rotate": "0", "regs": "64"})),
    (f"{_NS}20attn_prologue_kernelILi128EEEvNS_8PrologueE",
     ("attn_prologue", {"d": "128"})),
    (f"{_NS}24attn_prologue_bwd_kernelILi64EEEvNS_11PrologueBwdE",
     ("attn_prologue_bwd", {"d": "64"})),
    (f"{_NS}24attn_epilogue_bwd_kernelILi256EEEvNS_8EpilogueE",
     ("attn_epilogue_bwd", {"d": "256"})),
    (f"{_NS}20residual_norm_kernelILi1ELb0EEEvNS_3FwdE",
     ("residual_norm", {"form": "1", "yn": "0"})),
    (f"{_NS}18weight_grad_kernelEPKfiiPf",
     ("weight_grad", {})),
    ("_Z6helperv", None),
])
def test_instance_names(mangled, want):
    assert aot.instance_kernel(mangled) == want


def test_blocks_per_sm_agrees_with_the_temporal_plan():
    """The one occupancy model (which phase 6 and the AOT check hold to
    the runtime's occupancy API on the card) gives the temporal block
    the counts it had when the temporal module kept its own copy: for
    the level-group forms at the bands of the 8192^2 and 4096x2048
    plans, and for the generic loop."""
    pinned = {(488, 16): 1, (240, 8): 8, (448, 32): 1, (100, 5): 10,
              (488, 8): 4, (456, 16): 2, (432, 32): 1, (344, 8): 5,
              (344, 16): 2, (416, 32): 1}
    shapes = [(kt._plan(h, w, d)[1], d) for h, w in ((8192, 8192),
                                                     (4096, 2048))
              for d in (8, 16, 32)]
    assert set(shapes) <= set(pinned)
    for (band, depth), want in pinned.items():
        regs = kt.REGISTERS[depth if depth in kt.FORMS else None]
        smem = kt.window_bytes(band, depth)
        assert _build.blocks_per_sm(regs, kt.threads(band, depth),
                                    smem) == want, (band, depth)
        assert kt.blocks_per_sm(band, depth) == want, (band, depth)
    # the ring kernels' launch bound: 64 registers, 256 threads -> 4
    assert _build.blocks_per_sm(64, 256, 0) == 4
    assert _build.blocks_per_sm(32, 256, 0) == 8
    assert _build.blocks_per_sm(255, 1024, 0) == 0


def test_a_launch_over_a_limit_is_named(fake_build):
    resources = aot.source_resources()
    flash = {"kernel": "flash_fused", "dtype": "bfloat16", "d": 128,
             "threads": 384, "blocks": 128, "cooperative": False}
    assert aot.check_launch(dict(flash, dynamic_smem=164928),
                            resources)["blocks_per_sm"] == 1
    with pytest.raises(aot.LaunchDoesNotFit, match="shared memory"):
        aot.check_launch(dict(flash, dynamic_smem=240_000), resources)
    ring = aot._ring_launch("ring_all_reduce", "float32", 1 << 20, 8)
    with pytest.raises(aot.LaunchDoesNotFit, match="resident"):
        aot.check_launch(dict(ring, blocks=10_000), resources)
    heavy = {n: aot.kernel_resources(fake_log(n, registers=300))
             for n in _build.SOURCES}
    with pytest.raises(aot.LaunchDoesNotFit, match="registers"):
        aot.check_launch(ring, heavy)
    with pytest.raises(aot.LaunchDoesNotFit, match="no instance"):
        aot.check_launch(dict(flash, d=96, dynamic_smem=0), resources)


def test_without_nvcc_the_check_fails_by_name(monkeypatch, tmp_path,
                                              capsys):
    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", missing)
    with pytest.raises(aot.NvccNotFound, match="nvcc not found"):
        aot.check_surface("v5e:2x4")
    import smi_tpu_torch.__main__ as pcli

    out = tmp_path / "aot.json"
    assert pcli.main(["aot-verify", "-o", str(out)]) == 1
    assert "NvccNotFound" in capsys.readouterr().err
    assert not out.exists()


def test_aot_verify_cli_writes_the_evidence(fake_build, tmp_path, capsys):
    import smi_tpu_torch.__main__ as pcli

    out = tmp_path / "aot" / "AOT_H100.json"
    assert pcli.main(["aot-verify", "--topology", "v5e:2x4", "v5e:2x4*2",
                      "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "all topologies ok" in text
    payload = json.loads(out.read_text())
    assert payload["ok"] is True and payload["topology"] == "v5e:2x4"
    assert set(payload["topologies"]) == {"v5e:2x4", "v5e:2x4*2"}
    assert payload["topologies"]["v5e:2x4*2"]["slice_partition"]["15"] == 1
    assert set(payload["sources"]) == set(_build.SOURCES)
    progs = payload["topologies"]["v5e:2x4"]["programs"]
    assert progs["xla_all_reduce"]["launches"] == []
    assert progs["train_step_mha_bf16"]["kernels"] == [
        "flash_block", "flash_bwd_dkdv", "flash_bwd_dq", "flash_fused"]
