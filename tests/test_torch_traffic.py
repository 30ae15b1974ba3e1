"""The port's HLO text parser and the serialized-dma rule, against JAX's.

``smi_tpu_torch/parallel/traffic.py`` is the JAX package's text parser
carried whole (it imports only ``re``). The reference cases of
``tests/test_traffic.py`` and the text-level cases of
``tests/test_overlap.py`` re-run here with their module alias ``T``
standing for both packages' parsers (``tests/torch_ref_rerun.py``):
every call's result must be equal, and the reference assertions hold.
Beside the synthetic texts they carry, the port parses the optimised
HLO of JAX programs compiled on the CPU (the 8-device fake mesh):
psum, all-gather, ppermute, reduce-scatter, a psum inside a loop, and
the CLI's transfer -> reduce(max) -> bcast app. ``tests/test_perf_analysis.py``'s
``serialized-dma`` cases (its lines 355-395) run the same way with the
perf module: ``roofline_lint(hlo_text=...)`` no longer refuses, and its
findings equal the JAX package's.
"""

import json

import pytest

from smi_tpu.analysis import perf as JP
from smi_tpu.parallel import traffic as JT
from smi_tpu_torch.analysis import perf as PP
from smi_tpu_torch.parallel import traffic as PT
from torch_ref_rerun import Both, load_reference, norm, run_reference

REF_TRAFFIC = load_reference("test_traffic")
REF_OVERLAP = load_reference("test_overlap")
REF_PERF = load_reference("test_perf_analysis")

#: every case of tests/test_traffic.py but the two that read the JAX
#: package's AOT module rather than the parser
TRAFFIC_CASES = sorted(
    n for n in dir(REF_TRAFFIC)
    if n.startswith("test_") and n not in (
        "test_ring_predictions_name_surface_programs",
        "test_executable_report_flags_parser_miss",
    )
)

#: tests/test_overlap.py's cases that read HLO text (its stencil-schedule
#: case fails on the JAX side itself and is left out)
OVERLAP_CASES = [
    "test_overlap_report_async_pairs_scheduled_between",
    "test_overlap_report_excludes_data_movement",
    "test_overlap_report_dedups_overlapping_windows",
]

#: tests/test_perf_analysis.py:355-395
PERF_CASES = [
    "test_serialized_dma_fires_on_bare_dependent_chain",
    "test_serialized_dma_quiet_when_compute_hides_the_chain",
    "test_overlap_report_carries_the_chain_column",
]


@pytest.mark.parametrize("name", TRAFFIC_CASES)
def test_reference_traffic_case_on_the_port(name, request, monkeypatch):
    both = Both(JT, PT)
    monkeypatch.setattr(REF_TRAFFIC, "T", both)
    run_reference(getattr(REF_TRAFFIC, name), request)


@pytest.mark.parametrize("name", OVERLAP_CASES)
def test_reference_overlap_case_on_the_port(name, request, monkeypatch):
    both = Both(JT, PT)
    monkeypatch.setattr(REF_OVERLAP, "T", both)
    run_reference(getattr(REF_OVERLAP, name), request)
    assert both.calls, "the case must read HLO through the parser"


@pytest.mark.parametrize("name", PERF_CASES)
def test_reference_serialized_dma_case_on_the_port(name, request,
                                                   monkeypatch):
    monkeypatch.setattr(REF_PERF, "P", Both(JP, PP))
    import smi_tpu.parallel.traffic as jt_mod

    # the chain-column case imports the JAX parser itself
    monkeypatch.setattr(jt_mod, "overlap_report",
                        Both(JT, PT).overlap_report)
    run_reference(getattr(REF_PERF, name), request)


def _compiled_hlos(comm8):
    """The optimised HLO text of JAX programs compiled on the CPU."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    import smi_tpu as smi

    mesh = comm8.mesh

    def sm(f, in_specs, out_specs):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    x = jnp.arange(8 * 256, dtype=jnp.float32).reshape(8, 256)
    out = {}
    out["psum"] = sm(lambda v: lax.psum(v, "smi"), P("smi"), P("smi"))
    out["all_gather"] = sm(lambda v: lax.all_gather(v, "smi", tiled=True),
                           P("smi"), P())
    out["ppermute"] = sm(
        lambda v: lax.ppermute(v, "smi", [(i, (i + 1) % 8)
                                         for i in range(8)]),
        P("smi"), P("smi"))
    out["psum_scatter"] = sm(
        lambda v: lax.psum_scatter(v, "smi", tiled=True), P(), P("smi"))

    def looped(v):
        return lax.fori_loop(0, 3, lambda i, a: lax.psum(a, "smi") * 0.5, v)

    out["loop"] = sm(looped, P("smi"), P("smi"))

    @smi.smi_kernel(comm8, in_specs=P(), out_specs=P("smi"))
    def app(ctx, v):
        ch = ctx.open_channel(port=0, src=0, dst=1, count=256,
                              dtype="float")
        got = ctx.transfer(ch, v)
        r = ctx.reduce(got, op="max", port=1)
        return ctx.bcast(r, root=0, port=2)[None]

    texts = {k: f.lower(x).compile().as_text() for k, f in out.items()}
    texts["cli_app"] = jax.jit(app).lower(x[0]).compile().as_text()
    return texts


def test_compiled_jax_programs_parse_alike(comm8):
    """Every analysis of the port on the compiled HLO of JAX programs
    equals the JAX package's."""
    texts = _compiled_hlos(comm8)
    partition = {i: i // 4 for i in range(8)}
    for name, text in texts.items():
        got = {
            "records": PT.collective_traffic(None, hlo_text=text),
            "overlap": PT.overlap_report(hlo_text=text),
            "lint": PT.traffic_lint(hlo_text=text),
            "has": PT.has_collectives(text),
            "crossing": PT.tier_crossing_bytes(
                PT.collective_traffic(None, hlo_text=text), partition),
            "us": PT.predicted_program_us(
                PT.collective_traffic(None, hlo_text=text)),
            "dma": [f.to_json() for f in PP.serialized_dma_findings(text)],
        }
        want = {
            "records": JT.collective_traffic(None, hlo_text=text),
            "overlap": JT.overlap_report(hlo_text=text),
            "lint": JT.traffic_lint(hlo_text=text),
            "has": JT.has_collectives(text),
            "crossing": JT.tier_crossing_bytes(
                JT.collective_traffic(None, hlo_text=text), partition),
            "us": JT.predicted_program_us(
                JT.collective_traffic(None, hlo_text=text)),
            "dma": [f.to_json() for f in JP.serialized_dma_findings(text)],
        }
        assert norm(got) == norm(want), name
        assert json.dumps(got, sort_keys=True, default=str) == \
            json.dumps(want, sort_keys=True, default=str)
    # the programs do hold collectives, one of them inside a loop
    assert PT.collective_traffic(None, hlo_text=texts["psum"])
    assert any(r.get("in_loop") for r in
               PT.collective_traffic(None, hlo_text=texts["loop"]))


class _Compiled:
    def __init__(self, text):
        self.text = text

    def as_text(self):
        return self.text


def test_compiled_accepts_any_object_with_as_text():
    text = REF_TRAFFIC.HLO
    assert PT.collective_traffic(_Compiled(text)) == \
        JT.collective_traffic(_Compiled(text))
    assert PT.overlap_report(_Compiled(text)) == \
        JT.overlap_report(_Compiled(text))
    assert PT.traffic_lint(_Compiled(text)) == \
        JT.traffic_lint(_Compiled(text))


@pytest.mark.parametrize("kind,n,payload,chunks,hops", [
    ("all_gather", 8, 16384, 1, 1), ("all_reduce", 4, 1024, 1, 1),
    ("reduce_scatter", 16, 4096, 1, 1), ("neighbour_stream", 8, 8192, 4, 3),
])
def test_ring_traffic_equals(kind, n, payload, chunks, hops):
    assert PT.ring_traffic(kind, n, payload, chunks=chunks, hops=hops) == \
        JT.ring_traffic(kind, n, payload, chunks=chunks, hops=hops)
    b = PT.ring_traffic(kind, n, payload, chunks, hops)["ici_send_bytes"]
    assert PT.predicted_us(b) == JT.predicted_us(b)


def test_roofline_lint_with_hlo_equals_jax():
    """``roofline_lint(hlo_text=...)``: the shipped tiles' findings plus
    the text's ``serialized-dma`` ones, as the JAX package's."""
    hidden = REF_PERF._CHAINED_HLO.replace(
        "  %cp2-done =",
        "  %mul2 = f32[1024,128]{1,0} multiply(f32[1024,128]{1,0} "
        "%mul, f32[1024,128]{1,0} %mul)\n  %cp2-done =",
    )
    for text in (REF_PERF._CHAINED_HLO, hidden, "HloModule m"):
        for expect in (True, False):
            got = PP.roofline_lint(hlo_text=text, check_expectations=expect)
            want = JP.roofline_lint(hlo_text=text,
                                    check_expectations=expect)
            assert [f.to_json() for f in got] == [f.to_json() for f in want]
    chained = PP.roofline_lint(hlo_text=REF_PERF._CHAINED_HLO)
    assert "serialized-dma" in {f.check for f in chained}
