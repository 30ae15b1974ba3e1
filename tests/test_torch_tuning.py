"""The port's plan engine (``smi_tpu_torch.tuning``) against the JAX
package's (``smi_tpu.tuning``).

Held on the CPU, no card: the plan keys' device-kind and payload-bucket
rules; every public cost-model function and candidate table on a grid of
rank counts (2, 4, 6, 8 and the ``(2, 4)`` hybrid), payloads from 4 KiB
to 64 MiB and four dtypes, names, knobs, notes and ``modeled_us`` equal;
plan-cache JSON both ways; the seeded v5e entries entry for entry; every
engine answer and its deciding layer, and ``explain_text`` string for
string, for the device kinds ``"cpu"``, ``"tpu v5 lite"`` and ``"nvidia
h100 80gb hbm"`` over one cache (the ``flash_fwd`` and ``stencil`` tables
differ by design: they name the port's Hopper tile plans); the
collectives' and the ring kernel's chunk consults; the flash consult
leaving the Hopper tile plan alone under the v5e's (1024, 1024); eight
rank threads consulting at once; ``OnlineTuner`` and ``PlanSwap`` driven
in step with the JAX package's, the JAX ``obs`` recorder and registry
handed to both; and the collective sweeps on a CPU ``LocalWorld``.
Payloads come from a seeded numpy generator where they are random.
"""

import dataclasses
import json
import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.kernels import ring as jring
from smi_tpu.obs.events import FlightRecorder
from smi_tpu.obs.metrics import MetricsRegistry
from smi_tpu.parallel import collectives as jcoll
from smi_tpu.tuning import cache as jcache
from smi_tpu.tuning import cost_model as jcm
from smi_tpu.tuning import engine as jeng
from smi_tpu.tuning import online as jonline
from smi_tpu.tuning import plan as jplan
from smi_tpu.tuning import seeded as jseeded
from smi_tpu.tuning import swap as jswap
from smi_tpu_torch.kernels import flash as kflash
from smi_tpu_torch.kernels import ring as kring
from smi_tpu_torch.parallel import collectives as pcoll
from smi_tpu_torch.tuning import cache as pcache
from smi_tpu_torch.tuning import cost_model as pcm
from smi_tpu_torch.tuning import engine as peng
from smi_tpu_torch.tuning import online as ponline
from smi_tpu_torch.tuning import plan as pplan
from smi_tpu_torch.tuning import seeded as pseeded
from smi_tpu_torch.tuning import swap as pswap
from smi_tpu_torch.tuning import sweep as psweep

KINDS = ("cpu", "tpu v5 lite", "nvidia h100 80gb hbm")
DTYPES = ("float32", "bfloat16", "int32", "int8")
PAYLOADS = [4 << 10, 12345, 64 << 10, 262144, 1 << 20, 1048575,
            3 << 20, 4 << 20, 16 << 20, 64 << 20]
RANKS = (2, 4, 6, 8)


def topos(pkg):
    return ([pkg.TopologySpec(n=n) for n in RANKS]
            + [pkg.TopologySpec(n=8, inner=4, outer=2)])


def rows(cands):
    """A candidate table as plain data, with its exclusions."""
    out = [(c.name, c.knobs, c.modeled_us, c.measured_us, c.note)
           for c in cands]
    excluded = getattr(cands, "excluded", None)
    if excluded is not None:
        out.append(("excluded", [(c.name, c.knobs, c.note)
                                 for c in excluded]))
    return out


@pytest.fixture(autouse=True)
def _restore_engines():
    """Each test leaves both process-global engines as it found them."""
    saved = (jeng._ENGINE, peng._ENGINE)
    yield
    jeng.set_engine(saved[0])
    peng.set_engine(saved[1])


# ---- plan keys -----------------------------------------------------------


@pytest.mark.parametrize("kind", [
    "NVIDIA H100 80GB HBM3", "TPU v5 lite0", "TPU v5 lite", "cpu", None,
    "", "  Some   Card 12  ", "7", "NVIDIA A100-SXM4-80GB"])
def test_device_kind_keys_as_in_the_jax_package(kind):
    assert (pplan.normalize_device_kind(kind)
            == jplan.normalize_device_kind(kind))
    assert (pplan.normalize_device_kind("NVIDIA H100 80GB HBM3")
            == pseeded.SEEDED_H100_DEVICE_KIND == "nvidia h100 80gb hbm")


def test_payload_buckets_and_signatures_as_in_the_jax_package():
    rng = np.random.default_rng(5)
    for b in [0, 1, 2, 3, 1023, 1024, 4 << 20, (4 << 20) - 1,
              *rng.integers(1, 1 << 40, 64)]:
        assert pplan.payload_bucket(int(b)) == jplan.payload_bucket(int(b))
    key = pplan.PlanKey("all_reduce", "pow2:22", "float32",
                        "NVIDIA H100 80GB HBM3", "n8:dcn2")
    assert key.signature() == jplan.PlanKey(
        *dataclasses.astuple(key)).signature()
    assert pplan.PlanKey.from_signature(key.signature()).signature() \
        == key.signature()
    assert pplan.LAYERS == jplan.LAYERS


def test_dtype_names_are_the_jax_package_keys():
    for t, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                    (torch.int8, "int8"), (torch.int32, "int32"),
                    (torch.float16, "float16"), (torch.bool, "bool")):
        assert peng.dtype_name(t) == name == jnp.dtype(name).name
    assert peng.dtype_name("float32") == "float32"


# ---- the cost model ------------------------------------------------------


def test_cost_model_constants_are_the_jax_package_s():
    names = [n for n in dir(jcm) if n.isupper()]
    assert names and names == [n for n in dir(pcm) if n.isupper()]
    for name in names:
        assert getattr(pcm, name) == getattr(jcm, name), name


@pytest.mark.parametrize("fn", [
    "allreduce_candidates", "alltoall_candidates", "hierarchical_advantage",
    "alltoall_advantage", "ring_allreduce_us", "rs_ag_allreduce_us",
    "pairwise_alltoall_us", "hierarchical_allreduce_us",
    "hierarchical_alltoall_us", "rs_ag_crossover_bytes"])
def test_collective_costs_match_on_the_grid(fn):
    link = jcm.LinkModel()
    plink, pdcn = pcm.LinkModel(), pcm.dcn_link_model()
    dcn = jcm.dcn_link_model()
    for jt, pt in zip(topos(jcm), topos(pcm)):
        for b in PAYLOADS:
            if fn.endswith("candidates") or fn.endswith("advantage"):
                want = getattr(jcm, fn)(b, jt)
                got = getattr(pcm, fn)(b, pt)
            elif fn.startswith("hierarchical_"):
                want = getattr(jcm, fn)(b, jt, link, dcn)
                got = getattr(pcm, fn)(b, pt, plink, pdcn)
            elif fn == "rs_ag_crossover_bytes":
                want, got = jcm.rs_ag_crossover_bytes(jt.n), \
                    pcm.rs_ag_crossover_bytes(pt.n)
            else:
                want = getattr(jcm, fn)(b, jt.n, link)
                got = getattr(pcm, fn)(b, pt.n, plink)
            if isinstance(want, list):
                assert rows(got) == rows(want), (fn, jt, b)
            else:
                assert got == want, (fn, jt, b)
    assert pcm.bruck_alltoall_us(4096, 8, plink) == \
        jcm.bruck_alltoall_us(4096, 8, link)
    with pytest.raises(ValueError, match="power-of-two rank count"):
        pcm.bruck_alltoall_us(4096, 6, plink)


@pytest.mark.parametrize("dtype", DTYPES)
def test_precision_tables_match_on_the_grid(dtype):
    for jt, pt in zip(topos(jcm), topos(pcm)):
        for b in PAYLOADS:
            for op in ("add", "max"):
                assert rows(pcm.allreduce_precision_candidates(
                    b, pt, dtype=dtype, op=op)) == rows(
                    jcm.allreduce_precision_candidates(
                        b, jt, dtype=dtype, op=op)), (jt, b, op)
                for p in jcm.ALLREDUCE_PRECISIONS:
                    assert pcm.precision_ineligibility(p, op, dtype, b) \
                        == jcm.precision_ineligibility(p, op, dtype, b)
            for p in jcm.ALLREDUCE_PRECISIONS:
                assert pcm.precision_advantage(b, pt, p) == \
                    jcm.precision_advantage(b, jt, p)
                assert pcm.precision_wire_fraction(p) == \
                    jcm.precision_wire_fraction(p)
            for c in (1, 2, 4):
                assert pcm.chunk_pipeline_us(b, pt.n, c, pcm.LinkModel(),
                                             30.0) == \
                    jcm.chunk_pipeline_us(b, jt.n, c, jcm.LinkModel(), 30.0)
        assert pcm.kernel_roofline_us(1e12, 4e9, dtype) == \
            jcm.kernel_roofline_us(1e12, 4e9, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_tables_match(dtype):
    for s in (2048, 8192, 32768):
        for d in (64, 128, 256):
            for windowed in (False, True):
                assert rows(pcm.flash_block_candidates(s, d, dtype,
                                                       windowed)) == \
                    rows(jcm.flash_block_candidates(s, d, dtype, windowed))
    for h, w in ((8192, 8192), (4096, 2048), (256, 384), (1000, 1000)):
        assert rows(pcm.stencil_pipeline_candidates(h, w, dtype)) == \
            rows(jcm.stencil_pipeline_candidates(h, w, dtype))


def test_dcn_beta_env_reprices_both_alike(monkeypatch):
    monkeypatch.setenv(jcm.DCN_BETA_ENV, "1.2e10")
    pod_j = jcm.TopologySpec(n=8, inner=4, outer=2)
    pod_p = pcm.TopologySpec(n=8, inner=4, outer=2)
    assert pcm.dcn_beta_bytes_per_s() == jcm.dcn_beta_bytes_per_s() == 1.2e10
    assert rows(pcm.allreduce_candidates(4 << 20, pod_p)) == \
        rows(jcm.allreduce_candidates(4 << 20, pod_j))
    monkeypatch.setenv(jcm.DCN_BETA_ENV, "-3")
    with pytest.raises(ValueError, match="positive finite"):
        pcm.dcn_beta_bytes_per_s()


# ---- the plan cache ------------------------------------------------------


def _mixed_cache_json():
    return {"schema_version": 1, "entries": {
        "all_reduce|pow2:20|float32|cpu|n8": {
            "knobs": {"algorithm": "rs_ag", "chunks": 2}, "cost_us": 812.5,
            "provenance": "sweep:allreduce:1024KiB:n8"},
        "all_reduce|threshold||cpu|any": {
            "knobs": {"rs_ag_min_bytes": 262144}},
        "all_to_all|pow2:22|float32|nvidia h100 80gb hbm|n8:dcn2": {
            "knobs": {"algorithm": "bruck"}, "cost_us": 7000.0,
            "provenance": "live:retune:samples=20:margin=2.00x",
            "revision": 3},
    }}


def test_cache_json_round_trips_both_ways(tmp_path):
    payload = _mixed_cache_json()
    pc = pcache.PlanCache.from_json(payload)
    jc = jcache.PlanCache.from_json(payload)
    assert pc.to_json() == jc.to_json() == jcache.PlanCache.from_json(
        pc.to_json()).to_json()
    # files: the port writes, the JAX package reads, and back
    path = pc.save(str(tmp_path / "plans.json"))
    assert jcache.PlanCache.load(path).to_json() == pc.to_json()
    jc.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "plans.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    back = pcache.PlanCache.load(str(tmp_path / "jax.json"))
    assert back.to_json() == jc.to_json()
    # the port's whole seeded cache, H100 entries included, loads there
    seeded = pseeded.seeded_cache()
    seeded.save(str(tmp_path / "seeded.json"))
    assert jcache.PlanCache.load(
        str(tmp_path / "seeded.json")).to_json() == seeded.to_json()


@pytest.mark.parametrize("payload,match", [
    ({"schema_version": 2, "entries": {}}, "schema_version"),
    ({"schema_version": 1, "entries": {"a|b": {"knobs": {}}}},
     "malformed plan signature"),
    ({"schema_version": 1, "entries": {"a|b|c|d|e": {"knobs": 3}}},
     "is not"),
    ({"schema_version": 1, "entries": {"a|b|c|d|e": {
        "knobs": {}, "revision": -1}}}, "malformed revision"),
    ([], "JSON object"),
])
def test_malformed_caches_are_loud_alike(payload, match):
    with pytest.raises(ValueError, match=match) as got:
        pcache.PlanCache.from_json(payload)
    with pytest.raises(ValueError) as want:
        jcache.PlanCache.from_json(payload)
    assert str(got.value) == str(want.value)


def test_merge_keeps_the_better_measured_entry_alike():
    def entries(pkg):
        a = pkg.PlanCache.from_json(_mixed_cache_json())
        b = pkg.PlanCache()
        key = pkg.PlanKey.from_signature("all_reduce|pow2:20|float32|cpu|n8")
        b.put(key, pkg.CacheEntry({"algorithm": "ring"}, cost_us=700.0))
        a.merge(b)
        a.put(key, pkg.CacheEntry({"algorithm": "x"}, cost_us=9e9))
        return a.to_json()

    import smi_tpu.tuning as jt
    import smi_tpu_torch.tuning as pt

    assert entries(pt) == entries(jt)
    assert entries(pt)["entries"][
        "all_reduce|pow2:20|float32|cpu|n8"]["knobs"] == {"algorithm": "ring"}


def test_seeded_v5e_entries_are_the_jax_package_s():
    want = jseeded.seeded_cache().to_json()["entries"]
    got = {sig: e for sig, e in pseeded.seeded_cache().to_json()[
        "entries"].items()
        if pplan.PlanKey.from_signature(sig).device_kind
        == pseeded.SEEDED_DEVICE_KIND}
    assert got == want
    for name in ("SEEDED_DEVICE_KIND", "SEEDED_FLASH_BF16_BLOCKS",
                 "SEEDED_FLASH_BF16_WINDOW_BLOCKS", "SEEDED_FLASH_F32_BLOCKS",
                 "SEEDED_STENCIL_DEPTH", "SEEDED_RS_AG_MIN_BYTES",
                 "SEEDED_STENCIL_PIPELINE_KNOBS"):
        assert getattr(pseeded, name) == getattr(jseeded, name)


def test_seeded_h100_entries_are_routing_knobs_that_cite_the_card():
    cache = pseeded.seeded_cache()
    h100 = {sig: e for sig, e in cache.entries.items()
            if pplan.PlanKey.from_signature(sig).device_kind
            == pseeded.SEEDED_H100_DEVICE_KIND
            and pplan.PlanKey.from_signature(sig).op != "stencil_pipeline"}
    assert len(h100) == len(pseeded.SEEDED_H100_ENTRIES) > 0
    engine = peng.PlanEngine(cache=cache,
                             device_kind=pseeded.SEEDED_H100_DEVICE_KIND)
    for sig, entry in h100.items():
        key = pplan.PlanKey.from_signature(sig)
        assert "precision" not in entry.knobs, sig
        assert "PERF.md" in entry.provenance, sig
        assert pseeded.SEEDED_H100_CARD in entry.provenance, sig
        assert key.op in ("all_reduce", "all_to_all"), sig
        if key.detail.startswith("pow2:"):
            payload = 1 << int(key.detail[5:])
            topo = (peng.cm.TopologySpec(n=8, inner=4, outer=2)
                    if key.topology == "n8:dcn2"
                    else peng.cm.TopologySpec(n=8))
            algo = entry.knobs["algorithm"]
            if key.op == "all_to_all":
                assert engine.use_alltoall(payload, topo) == (algo, "cache")
            elif key.topology == "n8:dcn2":
                assert engine.use_hierarchical(payload, topo) == (
                    algo == "hierarchical", "cache")
            else:
                assert engine.use_rs_ag(payload, topo, threshold=None) == (
                    algo == "rs_ag", "cache")
                assert engine.collective_chunks(
                    "all_reduce", payload, 8, "float32") == (
                    entry.knobs.get("chunks", 1),
                    "cache" if "chunks" in entry.knobs else "heuristic")
        elif key.detail == "hier_threshold":
            assert engine.hier_threshold(2) == (
                entry.knobs["hier_min_bytes"], "cache")
        else:
            assert key.detail == "threshold", sig
            assert engine.rs_ag_threshold() == (
                entry.knobs["rs_ag_min_bytes"], "cache")


# ---- the engine's answers ------------------------------------------------


def _probe_cache_json():
    """The port's seeded cache (both device kinds) plus entries that reach
    every rung: chunks, crossovers, all-to-all, a live entry, junk."""
    payload = pseeded.seeded_cache().to_json()
    extra = {
        "all_reduce|pow2:18|float32|cpu|n8": {
            "knobs": {"algorithm": "rs_ag", "chunks": 4}, "cost_us": 100.0},
        "all_reduce|pow2:16|float32|cpu|n8": {
            "knobs": {"precision": "int8"}, "cost_us": 90.0},
        "all_reduce|pow2:16|int32|cpu|n8": {
            "knobs": {"precision": "int8"}, "cost_us": 90.0},
        "all_reduce|hier_threshold||cpu|dcn2": {
            "knobs": {"hier_min_bytes": 1 << 20}},
        "all_reduce|precision_threshold||tpu v5 lite|dcn2": {
            "knobs": {"precision_min_bytes": 1 << 21,
                      "precision": "bf16"}},
        "all_to_all|pow2:20|float32|cpu|n6": {
            "knobs": {"algorithm": "bruck"}, "cost_us": 5.0},
        "all_to_all|pow2:20|float32|cpu|n8": {
            "knobs": {"algorithm": "bruck"}, "cost_us": 5.0},
        "ring_all_reduce|pow2:20|float32|cpu|n8": {
            "knobs": {"chunks": 2}, "cost_us": 50.0},
        "broadcast|pow2:20|float32|tpu v5 lite|n4": {
            "knobs": {"chunks": 3}},
        "all_reduce|pow2:22|float32|cpu|n8:dcn2": {
            "knobs": {"algorithm": "ring"},
            "provenance": "live:retune:samples=16:margin=1.70x",
            "revision": 2},
        "flash_fwd|causal|float32|cpu|chip": {
            "knobs": {"block_q": 100, "block_k": 64}},
    }
    payload["entries"].update(extra)
    return payload


def _engines(kind, payload=None):
    payload = payload or _probe_cache_json()
    return (jeng.PlanEngine(cache=jcache.PlanCache.from_json(payload),
                            device_kind=kind),
            peng.PlanEngine(cache=pcache.PlanCache.from_json(payload),
                            device_kind=kind))


def _topo_pairs():
    return list(zip(topos(jcm), topos(pcm)))


@pytest.mark.parametrize("kind", KINDS)
def test_every_gate_answers_as_the_jax_engine(kind):
    je, pe = _engines(kind)
    assert pe.device_kind() == je.device_kind()
    assert pe.rs_ag_threshold() == je.rs_ag_threshold()
    for outer in (0, 2, 4):
        assert pe.hier_threshold(outer) == je.hier_threshold(outer)
        assert pe.precision_threshold(outer) == je.precision_threshold(outer)
    for jt, pt in _topo_pairs():
        for b in PAYLOADS:
            for dtype in DTYPES:
                for thr in (None, 0, 1 << 20):
                    assert pe.use_rs_ag(b, pt, dtype, threshold=thr) == \
                        je.use_rs_ag(b, jt, dtype, threshold=thr)
                for ms in (None, 2, 3):
                    assert pe.use_hierarchical(b, pt, dtype, min_slices=ms) \
                        == je.use_hierarchical(b, jt, dtype, min_slices=ms)
                for op in ("add", "max"):
                    for pin in (None, "bf16"):
                        assert pe.use_precision(b, pt, dtype, op, pin) == \
                            je.use_precision(b, jt, dtype, op, pin)
                for algo in (None, "pairwise", "bruck"):
                    assert pe.use_alltoall(b, pt, dtype, algo) == \
                        je.use_alltoall(b, jt, dtype, algo)
                for family in ("all_reduce", "ring_all_reduce", "broadcast",
                               "reduce", "scatter", "gather"):
                    assert pe.collective_chunks(family, b, pt.n, dtype) == \
                        je.collective_chunks(family, b, jt.n, dtype)
    for dtype in ("float32", "bfloat16"):
        for windowed in (False, True):
            assert pe.flash_blocks(dtype, windowed) == \
                je.flash_blocks(dtype, windowed)
    for extent in (8192, 4096):
        assert pe.stencil_depth(extent) == je.stencil_depth(extent)
        assert pe.stencil_pipeline_knobs(extent) == \
            je.stencil_pipeline_knobs(extent)


@pytest.mark.parametrize("kind", KINDS)
def test_plans_and_explain_text_match_the_jax_engine(kind):
    je, pe = _engines(kind)
    for jt, pt in _topo_pairs():
        for b in PAYLOADS:
            for dtype in ("float32", "bfloat16", "int32"):
                assert pe.allreduce_plan(b, pt, dtype).explain() == \
                    je.allreduce_plan(b, jt, dtype).explain()
                assert pe.alltoall_plan(b, pt, dtype).explain() == \
                    je.alltoall_plan(b, jt, dtype).explain()
    for op in ("all_reduce", "all-reduce", "all_to_all", "ring_all_reduce",
               "stencil_temporal"):
        for n, slices in ((8, None), (8, 2), (4, None), (6, 3)):
            assert pe.explain_text(op, n=n, slices=slices) == \
                je.explain_text(op, n=n, slices=slices), (op, n, slices)
    for bad in ("ghost",):
        with pytest.raises(ValueError, match="unknown op") as got:
            pe.explain_text(bad)
        with pytest.raises(ValueError) as want:
            je.explain_text(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="do not split"):
        pe.explain_text("all_reduce", n=8, slices=3)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_tables_name_the_port_s_own_tile_plans(kind):
    """By design, not parity: the flash table's heuristic tier is the
    Hopper forward kernel's plan, and the stencil table's tier notes are
    the port's pickers; the candidate rows (the model's) are the JAX
    package's."""
    je, pe = _engines(kind)
    for dtype in ("bfloat16", "float32"):
        got = pe.flash_plan(dtype=dtype)
        want = je.flash_plan(dtype=dtype)
        assert rows(got.candidates) == rows(want.candidates)
        assert (got.knobs["block_q"], got.knobs["block_k"]) == \
            kflash._plan(128, getattr(torch, dtype))
        assert got.decided_by == {"block_q": "heuristic",
                                  "block_k": "heuristic"}
    assert "Hopper" in pe.explain_text("flash_fwd")
    text = pe.explain_text("stencil")
    want = je.explain_text("stencil")
    assert text.splitlines()[0] == want.splitlines()[0]
    assert "pipeline tier: stripe" in text and "fused tier:" in text


@pytest.mark.parametrize("kind", KINDS)
def test_planned_functions_answer_as_the_jax_ones(kind):
    je, pe = _engines(kind)
    jeng.set_engine(je)
    peng.set_engine(pe)
    for b in PAYLOADS:
        for dtype in DTYPES:
            for n in RANKS:
                for thr in (None, 1 << 16):
                    assert peng.planned_rs_ag(b, n, dtype, thr) == \
                        jeng.planned_rs_ag(b, n, dtype, thr)
                for family in ("all_reduce", "ring_all_reduce", "broadcast"):
                    assert peng.planned_chunks(family, b, n, dtype) == \
                        jeng.planned_chunks(family, b, n, dtype)
            for args in ((8, 4, 2), (8, 8, 1), (6, 3, 2), (4, 1, 0)):
                for ms in (None, 3):
                    assert peng.planned_hierarchical(b, *args, dtype, ms) \
                        == jeng.planned_hierarchical(b, *args, dtype, ms)
                for p in (None, "topk"):
                    assert peng.planned_precision(b, *args, dtype, p) == \
                        jeng.planned_precision(b, *args, dtype, p)
                for a in (None, "bruck"):
                    assert peng.planned_alltoall(b, *args, dtype, a) == \
                        jeng.planned_alltoall(b, *args, dtype, a)
    for dtype in ("float32", "bfloat16"):
        for w in (False, True):
            assert peng.planned_flash_blocks(dtype, w) == \
                jeng.planned_flash_blocks(dtype, w)
            assert peng.planned_stencil_pipeline(8192, "float32") == \
                jeng.planned_stencil_pipeline(8192, "float32")


def test_a_broken_engine_costs_tuning_never_a_call():
    class Broken:
        def __getattr__(self, name):
            raise RuntimeError("broken")

    jeng.set_engine(Broken())
    peng.set_engine(Broken())
    for fn, args in (("planned_rs_ag", (4 << 20, 8, "float32")),
                     ("planned_chunks", ("all_reduce", 4 << 20, 8,
                                         "float32")),
                     ("planned_hierarchical", (4 << 20, 8, 4, 2, "float32")),
                     ("planned_alltoall", (4 << 20, 8, 4, 2, "float32")),
                     ("planned_precision", (4 << 20, 8, 4, 2, "float32")),
                     ("planned_flash_blocks", ("bfloat16", False)),
                     ("planned_stencil_pipeline", ())):
        assert getattr(peng, fn)(*args) == getattr(jeng, fn)(*args), fn
    world = st.LocalWorld((2, 2), ("dcn", "ici"), device="cpu")
    x = torch.ones(4096)
    got = world.run(lambda c: st.allreduce(x, c))
    assert all(torch.equal(g, torch.full_like(x, 4.0)) for g in got)


def test_a_user_cache_file_merges_over_the_seeded_one(tmp_path,
                                                      monkeypatch):
    path = tmp_path / "plans.json"
    pcache.PlanCache.from_json(_mixed_cache_json()).save(str(path))
    monkeypatch.setenv(pcache.CACHE_ENV, str(path))
    assert pcache.default_cache_path() == jcache.default_cache_path() \
        == str(path)
    pe = peng.PlanEngine(device_kind="cpu")
    je = jeng.PlanEngine(device_kind="cpu")
    assert pe.cache.to_json()["entries"].keys() >= \
        je.cache.to_json()["entries"].keys()
    assert pe.rs_ag_threshold() == je.rs_ag_threshold() == (262144, "cache")
    path.write_text("{not json")
    with pytest.warns(UserWarning, match="ignoring unreadable plan cache"):
        pe = peng.PlanEngine(device_kind="cpu")
    assert pe.rs_ag_threshold() == (pcoll.RS_AG_MIN_BYTES, "heuristic")


def test_the_detected_device_kind_is_cpu_without_cuda():
    """The JAX package's CPU kind, so the CPU tests key alike, and no
    CUDA context is made to find it."""
    assert peng._detect_device_kind() == jeng._detect_device_kind() == "cpu"
    assert peng.PlanEngine().device_kind() == "cpu"
    assert not torch.cuda.is_initialized()


# ---- the consults in the collectives and kernels -------------------------


def _chunk_cache(kind="cpu"):
    cache = jcache.PlanCache()
    for family in ("all_reduce", "ring_all_reduce", "broadcast", "reduce",
                   "scatter", "gather"):
        for n in (4, 8):
            cache.put(jplan.PlanKey(family, "pow2:12", "float32", kind,
                                    f"n{n}"),
                      jcache.CacheEntry({"chunks": 3}))
    return cache.to_json()


def test_a_chunks_entry_chunks_the_collectives_as_in_the_jax_package(
        monkeypatch):
    payload = _chunk_cache()
    je, pe = _engines("cpu", payload)
    jeng.set_engine(je)
    peng.set_engine(pe)
    jcomm = smi.make_communicator(shape=(8,), axis_names=("smi",))
    world = st.LocalWorld(8, device="cpu")
    for rows_, dtype in ((1024, "float32"), (1024, "int32"), (512, "float32"),
                         (4096, "float32")):
        xj = jnp.ones(rows_, dtype)
        xp = torch.ones(rows_, dtype=getattr(torch, dtype))
        for family in ("all_reduce", "broadcast", "reduce", "scatter",
                       "gather"):
            want = jcoll._resolve_chunks(None, xj, jcomm, family)
            assert pcoll._resolve_chunks(None, xp, world.comms[0],
                                         family) == want, (family, rows_)
            assert pcoll._resolve_chunks(2, xp, world.comms[0], family) == 2
        assert kring._planned_ring_chunks(xp, 8) == \
            jring._planned_ring_chunks(xj, 8)
    assert kring._planned_ring_chunks(torch.ones(1024), 8) == 3
    # the ring tier really launches the chunked form, on every rank
    kernels = []
    real = kring._run
    monkeypatch.setattr(kring, "_run",
                        lambda name, *a, **k: kernels.append(name)
                        or real(name, *a, **k))
    rng = np.random.default_rng(9)
    xs = torch.from_numpy(rng.normal(size=(8, 1024)).astype(np.float32))
    got = world.run(lambda c: st.allreduce(xs[c.rank], c, backend="ring"))
    direct = world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c))
    assert kernels == ["ring_all_reduce_chunked"] * 16
    pinned = world.run(lambda c: st.allreduce(xs[c.rank], c, backend="ring",
                                              chunks=1))
    assert kernels[16:] == ["ring_all_reduce"] * 8
    for g, d, p in zip(got, direct, pinned):
        assert torch.equal(g, p) and torch.equal(d, p)


def test_the_v5e_flash_entry_leaves_the_hopper_plan_alone():
    peng.set_engine(peng.PlanEngine(cache=pseeded.seeded_cache(),
                                    device_kind="tpu v5 lite"))
    assert peng.planned_flash_blocks("bfloat16", False) == (1024, 1024)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (64, 128, 256):
            for window in (None, 4096):
                assert kflash.fwd_plan_explained(d, dtype, window) == (
                    kflash._plan(d, dtype), "heuristic")
    # an entry naming the pair the kernel compiles is taken, from the cache
    cache = pcache.PlanCache()
    cache.put(pplan.PlanKey("flash_fwd", "causal", "bfloat16", "cpu", "chip"),
              pcache.CacheEntry({"block_q": 128, "block_k": 128}))
    peng.set_engine(peng.PlanEngine(cache=cache, device_kind="cpu"))
    assert kflash.fwd_plan_explained(128, torch.bfloat16) == ((128, 128),
                                                               "cache")
    assert kflash.fwd_plan_explained(128, torch.bfloat16, 4096)[1] == \
        "heuristic"
    q = torch.randn(2, 64, 64)
    out, m, l = kflash.flash_attend_fused(q, q, q, 0, 0, True, 0.125)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())


def test_untuned_gates_decide_as_the_jax_package_on_the_cpu(monkeypatch):
    """No pin, no env, the default engines (device kind ``"cpu"``): the
    rs+ag, two-tier, precision, all-to-all and chunk gates of the
    collectives decide as the JAX package's, on the hybrid grid and on
    8 ranks, at payloads on both sides of every crossover."""
    for env in (pcoll.RS_AG_ENV, pcoll.HIER_MIN_SLICES_ENV,
                pcoll.ALLTOALL_ALGO_ENV, pcoll.ALLREDUCE_PRECISION_ENV):
        monkeypatch.delenv(env, raising=False)
    hybrid = smi.make_hybrid_communicator(n_slices=2)
    flat = smi.make_communicator(shape=(8,), axis_names=("smi",))
    pairs = ((hybrid, st.LocalWorld((2, 4), ("dcn", "ici"),
                                    device="cpu").comms[0]),
             (flat, st.LocalWorld(8, device="cpu").comms[0]))
    add = (jcoll.SmiOp.ADD, st.SmiOp.ADD)
    for jc, pc in pairs:
        for elems in (8, 1024, 16384, 65536, 1 << 18, 1 << 20, 3 << 20):
            for dtype in ("float32", "bfloat16", "int32"):
                xj = jnp.zeros((elems,), dtype)
                xp = torch.empty((elems,), dtype=getattr(torch, dtype),
                                 device="meta")
                assert pcoll._use_rs_ag(xp, pc, add[1], None) == \
                    jcoll._use_rs_ag(xj, jc, add[0], None)
                assert pcoll._use_hierarchical(xp, pc, add[1], None, None) \
                    == jcoll._use_hierarchical(xj, jc, add[0], None, None)
                assert pcoll._resolve_precision(None, xp, pc, add[1]) == \
                    jcoll._resolve_precision(None, xj, jc, add[0])
                assert pcoll._resolve_chunks(None, xp, pc, "all_reduce") == \
                    jcoll._resolve_chunks(None, xj, jc, "all_reduce")
                algo = []
                monkeypatch.setattr(pcoll, "_bruck_all_to_all",
                                    lambda x, c: algo.append("bruck") or x)
                monkeypatch.setattr(pcoll, "alltoall_hierarchical",
                                    lambda x, c: algo.append("hier") or x)
                monkeypatch.setattr(type(pc), "all_to_all",
                                    lambda self, x, axis_name=None:
                                    algo.append("pairwise") or x)
                pcoll.all_to_all(xp, pc)
                want = jeng.planned_alltoall(
                    elems * xj.dtype.itemsize, 8,
                    *((4, 2) if jc is hybrid else (8, 1)), dtype)
                assert algo == [{"hierarchical": "hier"}.get(want, want)]


def test_explain_plan_is_the_jax_context_s():
    hybrid = st.LocalWorld((2, 4), ("dcn", "ici"), device="cpu")
    flat = st.LocalWorld(8, device="cpu")
    for world, jcomm in (
            (hybrid, smi.make_hybrid_communicator(n_slices=2)),
            (flat, smi.make_communicator(shape=(8,), axis_names=("smi",)))):
        ctx, jctx = st.SmiContext(world.comms[3]), smi.SmiContext(jcomm)
        for op in ("all_reduce", "all_to_all", "ring_all_reduce",
                   "stencil_temporal"):
            for dtype in ("float32", "bfloat16"):
                assert ctx.explain_plan(op, dtype) == \
                    jctx.explain_plan(op, dtype), (op, world.shape)
    text = st.SmiContext(hybrid.comms[0]).explain_plan()
    assert "hierarchical" in text and "device kind 'cpu'" in text


def test_eight_rank_threads_consult_at_once_and_agree():
    """One engine, eight rank threads released together by a barrier:
    every rank gets the one answer (the memo is under the engine's
    lock), and an untuned hybrid allreduce takes one form on every
    rank — the two-tier form at 3 MiB, by the model rung, as in the JAX
    package."""
    peng.set_engine(peng.PlanEngine(cache=pcache.PlanCache.from_json(
        _probe_cache_json()), device_kind="cpu"))
    gate = threading.Barrier(8)
    answers = [None] * 8
    pod = pcm.TopologySpec(n=8, inner=4, outer=2)

    def consult(r):
        gate.wait()
        e = peng.get_engine()
        answers[r] = [(e.use_hierarchical(b, pod), e.use_rs_ag(
            b, pcm.TopologySpec(n=8)), e.use_alltoall(b, pod),
            peng.planned_chunks("all_reduce", b, 8, "float32"))
            for b in PAYLOADS]

    threads = [threading.Thread(target=consult, args=(r,)) for r in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(a == answers[0] for a in answers)
    peng.set_engine(peng.PlanEngine(device_kind="cpu"))
    taken = []
    real = pcoll.allreduce_hierarchical
    world = st.LocalWorld((2, 4), ("dcn", "ici"), device="cpu")
    x = torch.ones(3 << 18)
    pcoll.allreduce_hierarchical = lambda *a, **k: taken.append(1) or real(
        *a, **k)
    try:
        got = world.run(lambda c: st.allreduce(x, c))
    finally:
        pcoll.allreduce_hierarchical = real
    assert taken == [1] * 8
    assert jeng.planned_hierarchical(4 * (3 << 18), 8, 4, 2, "float32")
    assert all(torch.equal(g, torch.full_like(x, 8.0)) for g in got)


# ---- the online tuner and the swap machine -------------------------------


def _fed(pkg_online, pkg_cm, pkg_cache, pkg_plan, pkg_eng, recorder,
         metrics):
    topo = pkg_cm.TopologySpec(n=8)
    key = pkg_plan.PlanKey("all_reduce", pkg_plan.payload_bucket(4 << 20),
                           "float32", "live-sim",
                           pkg_eng._collective_topology(topo))
    cache = pkg_cache.PlanCache()
    cache.put(key, pkg_cache.CacheEntry({"algorithm": "ring"}, cost_us=700.0,
                                        provenance="sweep:stale-offline"))
    small = pkg_plan.PlanKey("all_reduce", pkg_plan.payload_bucket(64 << 10),
                             "float32", "live-sim",
                             pkg_eng._collective_topology(topo))
    cache.put(small, pkg_cache.CacheEntry({"algorithm": "rs_ag"},
                                          provenance="sweep:bad"))
    return pkg_online.OnlineTuner(cache=cache, topo=topo,
                                  device_kind="live-sim", recorder=recorder,
                                  metrics=metrics)


def test_online_tuner_and_swap_run_in_step_with_the_jax_package():
    obs = {side: (FlightRecorder(capacity=4096), MetricsRegistry())
           for side in ("jax", "port")}
    tuners = {
        "jax": _fed(jonline, jcm, jcache, jplan, jeng, *obs["jax"]),
        "port": _fed(ponline, pcm, pcache, pplan, peng, *obs["port"]),
    }
    rng = np.random.default_rng(21)
    ring_us = jonline.priced_sample_us("all_reduce", "ring", 4 << 20,
                                       jcm.TopologySpec(n=8))
    small_us = jonline.priced_sample_us("all_reduce", "rs_ag", 64 << 10,
                                        jcm.TopologySpec(n=8))
    samples = [(4 << 20, ring_us * (1 + 0.1 * rng.random()), "t1")
               for _ in range(20)]
    samples += [(64 << 10, small_us * 2.0, "t2") for _ in range(16)]
    samples += [(None, 1.0, None), (4096, 3.0, "t3")]
    logs = {}
    for side, tuner in tuners.items():
        tuner.clock = iter(range(1000)).__next__
        for payload, us, tenant in samples:
            tuner.record("all_reduce", us * 1e-6, payload_bytes=payload,
                         tenant=tenant)
        log = []
        swaps = tuner.maybe_propose(drain_census=lambda ev: frozenset({7}))
        log.append([dict(s.proposal.evidence) for s in swaps])
        first, second = swaps
        tuner.start_quiesce(first)
        installed = tuner.execute_swap(first)
        tuner.commit(first)
        log.append((installed.to_json(), first.plan_epoch, first.state))
        with pytest.raises(RuntimeError) as stale:
            first.validate(0, what="in flight")
        log.append(str(stale.value))
        tuner.start_quiesce(second)
        tuner.execute_swap(second)
        tuner.rollback(second, "quiesce-timeout")
        log.append((second.state, second.plan_epoch,
                    second.last_rollback_reason))
        with pytest.raises(RuntimeError) as illegal:
            second.commit()
        log.append(str(illegal.value))
        log.append(tuner.run_offline())
        log.append(tuner.summary())
        log.append(tuner.total_plan_epoch())
        log.append(tuner.cache.to_json())
        logs[side] = log
    assert logs["port"] == logs["jax"]
    for side in ("jax", "port"):
        assert obs[side][0].counts.get("tune.swap") == 2
    assert obs["port"][0].snapshot() == obs["jax"][0].snapshot()
    assert obs["port"][1].snapshot() == obs["jax"][1].snapshot()
    assert isinstance(logs["port"][2], str) and "stale plan epoch" in \
        logs["port"][2]
    assert pswap.SWAP_STATES == jswap.SWAP_STATES


@pytest.mark.parametrize("env,raw", [
    ("ONLINE_RETUNE_ENV", "on"), ("ONLINE_RETUNE_ENV", "maybe"),
    ("MIN_SAMPLES_ENV", "4"), ("MIN_SAMPLES_ENV", "0"),
    ("MARGIN_ENV", "2.5"), ("MARGIN_ENV", "1.0")])
def test_online_env_knobs_read_as_in_the_jax_package(monkeypatch, env, raw):
    monkeypatch.setenv(getattr(jonline, env), raw)

    def outcome(mod):
        try:
            return (mod.online_retune_enabled(), mod.retune_min_samples(),
                    mod.retune_margin())
        except ValueError as err:
            return str(err)

    assert outcome(ponline) == outcome(jonline)


def test_op_candidates_match_for_every_tunable_op():
    for op in jonline.TUNABLE_OPS + ("ghost",):
        for jt, pt in _topo_pairs():
            for b in (64 << 10, 4 << 20, 256 << 20):
                want = jonline.op_candidates(op, b, jt)
                got = ponline.op_candidates(op, b, pt)
                assert (None if got is None else rows(got)) == \
                    (None if want is None else rows(want))


# ---- the sweeps on a CPU world -------------------------------------------


def test_cpu_sweeps_write_entries_keyed_cpu():
    flat = st.LocalWorld(4, device="cpu")
    pod = st.LocalWorld((2, 2), ("dcn", "ici"), device="cpu")
    record = []
    peng.set_engine(peng.PlanEngine(cache=pcache.PlanCache(),
                                    device_kind="cpu"))
    caches = [
        psweep.sweep_allreduce(flat, sizes_kb=(4, 16), chunk_candidates=(1, 2),
                               runs=1, record=record),
        psweep.sweep_allreduce_hierarchical(pod, sizes_kb=(4,), runs=1,
                                            record=record),
        psweep.sweep_allreduce_precision(pod, sizes_kb=(4,), runs=1,
                                         record=record),
        psweep.sweep_alltoall(pod, sizes_kb=(4,), runs=1, record=record),
        psweep.sweep_alltoall(st.LocalWorld(3, device="cpu"), sizes_kb=(4,),
                              runs=1),
    ]
    sigs = [sig for c in caches for sig in c.entries]
    assert all(pplan.PlanKey.from_signature(s).device_kind == "cpu"
               for s in sigs)
    assert "all_reduce|pow2:12|float32|cpu|n4" in caches[0].entries
    assert "all_reduce|pow2:14|float32|cpu|n4" in caches[0].entries
    assert "all_reduce|pow2:12|float32|cpu|n4:dcn2" in caches[1].entries
    assert caches[2].entries["all_reduce|pow2:12|float32|cpu|n4:dcn2"] \
        .knobs["precision"] in jcm.ALLREDUCE_PRECISIONS
    assert caches[3].entries["all_to_all|pow2:12|float32|cpu|n4:dcn2"] \
        .knobs["algorithm"] in ("pairwise", "bruck", "hierarchical")
    # 1023 elements: the largest multiple of 3 ranks in 4 KiB
    assert caches[4].entries["all_to_all|pow2:11|float32|cpu|n3"] \
        .knobs == {"algorithm": "pairwise"}
    names = {(kb, name) for kb, name, _ in record}
    assert {(4, "ring chunks=1"), (16, "rs_ag chunks=2"), (4, "flat"),
            (4, "hierarchical"), (4, "topk"), (4, "bruck")} <= names
    assert all(us > 0 and math.isfinite(us) for _, _, us in record)
    # every entry loads in the JAX package's cache, key for key
    for c in caches:
        assert jcache.PlanCache.from_json(
            json.loads(json.dumps(c.to_json()))).to_json() == c.to_json()
    with pytest.raises(ValueError, match="multi-slice hybrid world"):
        psweep.sweep_allreduce_hierarchical(flat, sizes_kb=(4,), runs=1)
