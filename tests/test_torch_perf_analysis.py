"""The port's static performance analyzer: the reference's cases, parity,
and the stencil sweep that reads it.

``smi_tpu_torch/analysis/perf.py`` and ``perf_mutants.py`` are the
port's copies of the JAX package's critical-path decomposition, roofline
lint and perf mutants (pure Python; the flash-tile rules price through
the port's cost model, which keeps the JAX package's v5e model prices).
The first part carries over ``tests/test_perf_analysis.py`` against the
port, all but its one slow case (its ``serialized-dma`` cases are in
``tests/test_torch_traffic.py``, beside the HLO parser they read
through).
The second part holds the port to the JAX package with the tolerance
"equal": ``perf_all`` reports, ``analytic_predictions``,
``roofline_lint`` and the stencil stream's decomposition, sorted-key
JSON byte-equal, floats ``==``. The third covers
``tuning.sweep.sweep_stencil`` on the CPU (its proxy tier, held equal to
the JAX package's) and the seeded H100 stencil entry.
"""

import json

import numpy as np
import pytest
import torch

from smi_tpu import analysis as JA
from smi_tpu.analysis import perf as JP
from smi_tpu_torch import analysis as A
from smi_tpu_torch.analysis import perf as P
from smi_tpu_torch.analysis import perf_mutants as PM
from smi_tpu_torch.analysis.verifier import DEFAULT_SHAPES, build_generators
from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.tuning import cost_model as cm

pytestmark = pytest.mark.perflint



GRID = [
    (protocol, shape)
    for protocol, shapes in sorted(DEFAULT_SHAPES.items())
    for shape in shapes
]


def _ids(cases):
    return [
        p + "-" + "-".join(f"{k}{v}" for k, v in sorted(s.items()))
        for p, s in cases
    ]


def _clean_sim(protocol, shape, costs=None):
    return C.RingSimulator(
        build_generators(protocol, shape["n"],
                         chunks=shape.get("chunks", 3),
                         slices=shape.get("slices", 2)),
        C.Strategy(0), costs=costs,
    )


# ---------------------------------------------------------------------------
# 1. Clean matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("protocol,shape", GRID, ids=_ids(GRID))
def test_clean_grid_decomposes_with_zero_findings(protocol, shape):
    rep = P.decompose_protocol(protocol, **shape)
    assert rep.ok, rep.describe()
    assert rep.makespan_s > 0.0
    # genuine idle is EXACTLY zero on every healthy protocol: each
    # wait lands inside its producer's latency/bandwidth window
    for row in rep.per_rank:
        assert row["idle_fraction"] == 0.0, (protocol, shape, row)
    # the binding wait edge names (rank, step, primitive) coordinates
    assert rep.binding is not None
    assert set(rep.binding["waiter"]) == {"rank", "step", "primitive"}


@pytest.mark.parametrize("protocol,shape", GRID, ids=_ids(GRID))
def test_makespan_matches_elapsed_seconds_exactly(protocol, shape):
    """The acceptance bar: the static decomposition reproduces the
    timestamped simulator bit-for-bit on the full registered grid."""
    rep = P.decompose_protocol(protocol, **shape)
    costs, _message, _k = P._costs_for(
        protocol, dict(shape), float(P.PERF_PAYLOAD_BYTES)
    )
    sim = _clean_sim(protocol, shape, costs=costs)
    sim.run()
    assert rep.makespan_s == sim.elapsed_seconds()


@pytest.mark.parametrize("protocol,shape", GRID, ids=_ids(GRID))
def test_components_partition_each_rank_clock(protocol, shape):
    """alpha + beta + serialization + idle == the rank's clock (the
    decomposition is a partition, not a sampling)."""
    rep = P.decompose_protocol(protocol, **shape)
    for row in rep.per_rank:
        total = sum(
            v for tier in row["components_us"].values()
            for v in tier.values()
        )
        assert total == pytest.approx(row["clock_us"], abs=1e-6)


def test_pod_wallclock_vectors_are_the_analyzer_test_vectors():
    """The PR 6 acceptance numbers (4894.3 us flat / 1197.3 us
    two-tier at 2x2, 4 MiB) reproduce exactly through the analyzer."""
    rep = C.pod_wallclock_comparison(2, 2, 4 << 20)
    pod = P.decompose_protocol("allreduce_pod", n=4, slices=2)
    assert pod.makespan_s == rep["hierarchical_s"]
    assert round(pod.makespan_s * 1e6, 1) == 1197.3
    # the flat ring priced the pod_wallclock way (full payload, pod
    # tier split) through decompose_generators
    flat_costs = C.default_tier_costs(float(4 << 20), 2)
    flat = P.decompose_generators(
        lambda: [
            C.all_reduce_rank(
                g, 4, frozenset((g, c) for c in range(2)),
                lambda a, b: a | b,
            )
            for g in range(4)
        ],
        flat_costs, protocol="all_reduce_flat_pod",
        shape={"n": 4},
    )
    assert flat.makespan_s == rep["flat_s"]
    assert round(flat.makespan_s * 1e6, 1) == 4894.3


def test_chunked_pipeline_depth_equals_declared_chunks():
    """The healthy chunked ring's measured wire depth IS its chunk
    count — the quantity the serialized-critical-path rule defends."""
    for shape in DEFAULT_SHAPES["all_reduce_chunked"]:
        rep = P.decompose_protocol("all_reduce_chunked", **shape)
        assert rep.pipeline_chunks == shape["chunks"]
        assert max(w["depth"] for w in rep.wires) == shape["chunks"]


def test_pod_decomposition_splits_tiers():
    """The two-tier pod's critical path carries BOTH tiers, and the
    DCN share dominates (the cross-slice phase is the bottleneck the
    decomposition exists to name)."""
    rep = P.decompose_protocol("allreduce_pod", n=4, slices=2)
    assert set(rep.components) >= {"ici", "dcn"}
    dcn = sum(rep.components["dcn"].values())
    ici = sum(rep.components["ici"].values())
    assert dcn > ici


def test_unsafe_protocol_is_refused_not_priced():
    """A deadlocking mutant has no makespan: decomposition refuses
    with the safety tier's finding instead of pricing garbage."""
    with pytest.raises(A.AnalysisError, match="unsafe"):
        P.decompose_generators(
            lambda: A.mutant_generators("all_reduce", 3,
                                        mutant="dropped_wait"),
            C.default_tier_costs(1 << 20),
            protocol="all_reduce[dropped_wait]", shape={"n": 3},
        )


# ---------------------------------------------------------------------------
# 2. Differential mutant harness
# ---------------------------------------------------------------------------


def _decompose_mutant(protocol, shape, mutant):
    costs, _message, pipeline = P._costs_for(
        protocol, dict(shape), float(P.PERF_PAYLOAD_BYTES)
    )
    return P.decompose_generators(
        lambda: PM.perf_mutant_generators(
            protocol, mutant, shape["n"],
            chunks=shape.get("chunks", 3),
            slices=shape.get("slices", 2),
        ),
        costs, protocol=f"{protocol}[{mutant}]", shape=dict(shape),
        pipeline_chunks=pipeline,
    )


HALVED_CASES = [
    # neighbour_stream's 2-chunk window absorbs the held grant
    # (documented benign case); all_to_all_pod has NO credit grants at
    # all — its phases land on write-once slots, so there is nothing
    # for the mutant to hold (tested benign below)
    (p, s) for p, s in GRID
    if p not in ("neighbour_stream", "all_to_all_pod")
]


def test_halved_wire_credits_benign_on_the_creditless_pod_exchange():
    """all_to_all_pod runs its phases on write-once slots with no
    credit grants — the hold_grants transform finds nothing to hold,
    so the mutant is genuinely benign there (makespan unchanged), the
    same documented-benign discipline as neighbour_stream's 2-chunk
    window."""
    shape = {"n": 4, "slices": 2}
    rep = _decompose_mutant("all_to_all_pod", shape,
                            "halved_wire_credits")
    clean = P.decompose_protocol("all_to_all_pod", **shape)
    assert rep.ok and rep.makespan_s == clean.makespan_s


@pytest.mark.parametrize("protocol,shape", HALVED_CASES,
                         ids=_ids(HALVED_CASES))
def test_halved_wire_credits_convicted_by_idle_fraction(protocol, shape):
    """Conviction by exactly its rule, differentially against the
    timestamped simulator: the mutant is safe (the verifier ran inside
    decompose), measurably slower, delivery-identical — and every
    finding is idle-fraction with named (rank, step, primitive)
    events."""
    rep = _decompose_mutant(protocol, shape, "halved_wire_credits")
    assert not rep.ok
    assert {f.check for f in rep.findings} == {"idle-fraction"}
    finding = rep.findings[0]
    assert finding.fraction > A.IDLE_FRACTION_THRESHOLD
    assert finding.lane is not None and finding.tier in ("ici", "dcn")
    assert len(finding.events) == 2  # the blocked wait + its producer
    for event in finding.events:
        assert isinstance(event.rank, int) and isinstance(event.step, int)
    clean = P.decompose_protocol(protocol, **shape)
    assert rep.makespan_s > clean.makespan_s
    # delivery identical: slower, never wrong
    mutated = C.RingSimulator(
        PM.perf_mutant_generators(
            protocol, "halved_wire_credits", shape["n"],
            chunks=shape.get("chunks", 3),
            slices=shape.get("slices", 2),
        ),
        C.Strategy(0),
    ).run()
    assert mutated == PM.healthy_outputs(
        protocol, shape["n"], chunks=shape.get("chunks", 3),
        slices=shape.get("slices", 2),
    )


def test_halved_wire_credits_benign_on_neighbour_stream():
    """The stream's 2-chunk window absorbs a one-round-late grant —
    benign there, which the CLI reports as an explicit note rather
    than a silent ok (mirrors the protocol tier's benign mutants)."""
    for shape in DEFAULT_SHAPES["neighbour_stream"]:
        rep = _decompose_mutant("neighbour_stream", shape,
                                "halved_wire_credits")
        assert rep.ok


@pytest.mark.parametrize("shape", DEFAULT_SHAPES["all_reduce_chunked"],
                         ids=["n2-k2", "n3-k3"])
def test_unoverlapped_chunks_convicted_by_serialized_critical_path(shape):
    rep = _decompose_mutant("all_reduce_chunked", shape,
                            "unoverlapped_chunks")
    assert not rep.ok
    assert {f.check for f in rep.findings} == {"serialized-critical-path"}
    finding = rep.findings[0]
    assert finding.expected == shape["chunks"]  # declared pipeline
    assert finding.got == 1                     # measured depth
    assert len(finding.events) == 2             # collapse edge named
    clean = P.decompose_protocol("all_reduce_chunked", **shape)
    assert rep.makespan_s > clean.makespan_s
    # the mutant is SAFE — only slow: the verifier passes it clean
    safety = A.verify_generators(
        lambda: PM.perf_mutant_generators(
            "all_reduce_chunked", "unoverlapped_chunks", shape["n"],
            chunks=shape["chunks"],
        ),
        protocol="serial", shape=shape,
    )
    assert safety.ok
    # and delivery-identical
    mutated = C.RingSimulator(
        PM.perf_mutant_generators(
            "all_reduce_chunked", "unoverlapped_chunks", shape["n"],
            chunks=shape["chunks"],
        ),
        C.Strategy(0),
    ).run()
    assert mutated == PM.healthy_outputs(
        "all_reduce_chunked", shape["n"], chunks=shape["chunks"],
    )


def test_oversized_flash_tile_convicted_by_no_double_buffer():
    findings = P.no_double_buffer_findings([PM.OVERSIZED_FLASH_TILE])
    assert {f.check for f in findings} == {"no-double-buffer"}
    single = P.flash_single_buffer_bytes(4096, 4096, 128, 2)
    assert findings[0].got == single
    assert single > A.VMEM_DOUBLE_BUFFER_BOUND
    # the mutant footprint arithmetic mirrors the cost model's
    # double-buffered bookkeeping: single-buffer + one more tile
    # generation == flash_fwd_vmem_bytes
    tiles = (4096 * 128 + 2 * 4096 * 128) * 2
    assert single + tiles == cm.flash_fwd_vmem_bytes(4096, 4096, 128, 2)


def test_every_perf_mutant_has_exactly_one_convicting_rule():
    assert set(PM.PERF_MUTANT_RULE) == set(PM.PERF_MUTANTS)
    assert set(PM.PERF_MUTANT_RULE.values()) <= set(P.PERF_CHECKS)


def test_perf_mutant_registry_is_loud_on_misuse():
    with pytest.raises(ValueError, match="all_reduce_chunked"):
        PM.perf_mutant_generators("all_gather", "unoverlapped_chunks", 3)
    with pytest.raises(ValueError, match="roofline"):
        PM.perf_mutant_generators("all_gather", "oversized_flash_tile", 3)
    with pytest.raises(ValueError, match="unknown perf mutant"):
        PM.perf_mutant_generators("all_gather", "bogus", 3)


# ---------------------------------------------------------------------------
# 3. Roofline rules
# ---------------------------------------------------------------------------


def test_roofline_lint_clean_on_shipped_tree():
    assert P.roofline_lint() == []


def test_below_roofline_tile_fires_on_narrow_block_q():
    """A bq=64 tile forces 128 k/v streaming passes — far off the
    roofline; the shipped seeded tiles stay on it."""
    findings = P.below_roofline_findings([
        {"name": "narrow", "dtype": "bfloat16",
         "block_q": 64, "block_k": 512},
    ])
    assert {f.check for f in findings} == {"below-roofline-tile"}
    assert findings[0].fraction < A.BELOW_ROOFLINE_FRACTION
    assert P.below_roofline_findings() == []


def test_analytic_regression_fires_on_worse_and_missing_only():
    expected = {"x_us": 100.0, "y_us": 100.0, "z_us": 100.0}
    findings = P.analytic_regression_findings(
        predictions={"x_us": 100.0, "y_us": 130.0},  # z missing
        expected=expected,
    )
    assert len(findings) == 2
    assert {f.check for f in findings} == {"analytic-regression"}
    drifted = next(f for f in findings if f.got == 130.0)
    assert drifted.expected == 100.0
    missing = next(f for f in findings if f.got is None)
    assert "no recomputed" in missing.message
    # an improvement must NOT fire
    assert P.analytic_regression_findings(
        predictions={"x_us": 50.0}, expected={"x_us": 100.0}
    ) == []
    # inside the drift band: quiet
    assert P.analytic_regression_findings(
        predictions={"x_us": 120.0}, expected={"x_us": 100.0}
    ) == []


def test_analytic_expectations_match_recomputation():
    """The committed expectation table IS today's prediction — zero
    drift on the shipped tree (the clean half of the rule)."""
    assert P.analytic_predictions() == P.ANALYTIC_EXPECTED_US


# ---------------------------------------------------------------------------
# FlashCandidates: no silent caps in the tile search space
# ---------------------------------------------------------------------------


def test_flash_candidates_return_excluded_with_footprint():
    cands = cm.flash_block_candidates(
        8192, 128, "float32", False,
        targets=((1024, 1024), (4096, 4096)),
    )
    assert [c.name for c in cands] == ["bq1024/bk1024"]
    assert [c.name for c in cands.excluded] == ["bq4096/bk4096"]
    note = cands.excluded[0].note
    assert "EXCLUDED" in note and "KiB" in note
    vmem = cm.flash_fwd_vmem_bytes(4096, 4096, 128, 4)
    assert f"{vmem // 1024} KiB" in note


def test_flash_candidates_default_targets_all_feasible():
    """At the canonical d=128 every default target fits the frame; the
    only refusal is the r18 k/v double-buffer gate — the f32
    bq4096/bk2048 tile fits single-buffered only, so it is excluded
    with the no-double-buffer reason instead of ranked into a
    serializing config (bf16 halves the footprint and keeps it)."""
    bf16 = cm.flash_block_candidates(8192, 128, "bfloat16", False)
    assert isinstance(bf16, list)
    assert len(bf16) == len(cm.FLASH_BLOCK_TARGETS)
    assert bf16.excluded == []
    f32 = cm.flash_block_candidates(8192, 128, "float32", False)
    assert len(f32) == len(cm.FLASH_BLOCK_TARGETS) - 1
    assert [c.name for c in f32.excluded] == ["bq4096/bk2048"]
    assert "no-double-buffer" in f32.excluded[0].note


def test_explain_prints_excluded_candidates():
    from smi_tpu_torch.tuning.engine import PlanEngine

    eng = PlanEngine(device_kind="unknown")
    text = eng.flash_plan(dtype="float32", d=1024).explain()
    assert "excluded bq1024/bk1024" in text
    assert "scoped-VMEM frame" in text


# ---------------------------------------------------------------------------
# Report plumbing
# ---------------------------------------------------------------------------


def test_perf_json_schema():
    reports = [P.decompose_protocol("all_reduce", n=3)]
    roofline = P.no_double_buffer_findings([PM.OVERSIZED_FLASH_TILE])
    payload = P.perf_reports_to_json(reports, roofline)
    assert set(payload) == {"ok", "tier", "findings", "checks",
                            "idle_fraction_threshold", "protocols",
                            "roofline"}
    assert payload["tier"] == "perf"
    assert payload["ok"] is False and payload["findings"] == 1
    assert payload["checks"] == list(P.PERF_CHECKS)
    (proto,) = payload["protocols"]
    assert {"protocol", "shape", "makespan_us", "components_us",
            "per_rank", "wires", "binding", "ok",
            "findings"} <= set(proto)
    (rf,) = payload["roofline"]
    assert rf["check"] == "no-double-buffer"


def test_render_reports_name_the_binding_edge():
    text = P.render_perf_reports([P.decompose_protocol("all_reduce", n=3)])
    assert "binding edge" in text
    assert "makespan" in text
    assert "0 perf finding(s)" in text

def test_roofline_lint_refuses_hlo_text():
    """HLO text was refused while the port had no HLO parser; it now
    goes through the port's ``parallel/traffic.py`` and is never
    ignored: ``roofline_lint(hlo_text=...)`` adds exactly the
    ``serialized-dma`` findings of that text, as the JAX package's."""
    assert hasattr(P, "serialized_dma_findings")
    assert "serialized-dma" in P.PERF_LINT_CHECKS
    base = P.roofline_lint(check_expectations=False)
    got = P.roofline_lint(hlo_text="HloModule m", check_expectations=False)
    assert [f.to_json() for f in got] == [f.to_json() for f in base]
    want = JP.roofline_lint(hlo_text="HloModule m", check_expectations=False)
    assert [f.to_json() for f in got] == [f.to_json() for f in want]


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


def _canon(payload) -> str:
    return json.dumps(payload, sort_keys=True, default=str)


def test_perf_all_reports_equal_the_jax_package_s():
    """Every registered protocol over the default grid: the
    ``lint --perf`` payload and text byte-equal."""
    ours, theirs = P.perf_all(), JP.perf_all()
    assert _canon(P.perf_reports_to_json(ours)) == \
        _canon(JP.perf_reports_to_json(theirs))
    assert P.render_perf_reports(ours) == JP.render_perf_reports(theirs)
    for a, b in zip(ours, theirs):
        assert a.makespan_s == b.makespan_s


def test_thresholds_and_tables_are_the_jax_package_s():
    for name in ("PERF_CHECKS", "PERF_LINT_CHECKS", "PERF_PROTOCOL_CHECKS",
                 "IDLE_FRACTION_THRESHOLD", "VMEM_DOUBLE_BUFFER_BOUND",
                 "BELOW_ROOFLINE_FRACTION", "ANALYTIC_DRIFT_FRACTION",
                 "ANALYTIC_EXPECTED_US", "PERF_PAYLOAD_BYTES",
                 "STENCIL_STRIPE_BYTES", "STENCIL_STREAM_STRIPES"):
        assert getattr(P, name) == getattr(JP, name), name
    assert set(PM.PERF_MUTANTS) == set(JA.PERF_MUTANTS)
    assert PM.PERF_MUTANT_RULE == JA.PERF_MUTANT_RULE
    assert PM.OVERSIZED_FLASH_TILE == JA.OVERSIZED_FLASH_TILE


def test_analytic_predictions_equal_the_jax_package_s():
    ours, theirs = P.analytic_predictions(), JP.analytic_predictions()
    assert list(ours) == list(theirs)
    for name in ours:
        assert ours[name] == theirs[name], name


@pytest.mark.parametrize("tiles", [None, "mutant", "narrow"])
@pytest.mark.parametrize("expectations", [True, False])
def test_roofline_lint_equals_the_jax_package_s(tiles, expectations):
    tile_set = {
        None: None,
        "mutant": [PM.OVERSIZED_FLASH_TILE],
        "narrow": [{"name": "narrow", "dtype": "float32",
                    "block_q": 128, "block_k": 512}],
    }[tiles]
    ours = P.roofline_lint(tile_set, check_expectations=expectations)
    theirs = JP.roofline_lint(tile_set, check_expectations=expectations)
    assert _canon([f.to_json() for f in ours]) == \
        _canon([f.to_json() for f in theirs])


@pytest.mark.parametrize("buffering", [1, 3])
def test_stencil_stream_decomposition_equals_the_jax_package_s(buffering):
    ours = P.decompose_stencil_stream(buffering=buffering)
    theirs = JP.decompose_stencil_stream(buffering=buffering)
    assert ours.makespan_s == theirs.makespan_s
    assert [r["idle_fraction"] for r in ours.per_rank] == \
        [r["idle_fraction"] for r in theirs.per_rank]
    assert _canon(ours.to_json()) == _canon(theirs.to_json())
    assert ours.describe() == theirs.describe()


PERF_MUTANT_GRID = [
    (mutant, protocol, shape)
    for mutant in ("halved_wire_credits", "unoverlapped_chunks")
    for protocol, shape in GRID
    if mutant == "halved_wire_credits" or protocol == "all_reduce_chunked"
]


@pytest.mark.parametrize("mutant,protocol,shape", PERF_MUTANT_GRID,
                         ids=[f"{m}-{p}-{sorted(s.items())}"
                              for m, p, s in PERF_MUTANT_GRID])
def test_perf_mutant_decomposition_equals_the_jax_package_s(mutant, protocol,
                                                            shape):
    """Each protocol perf mutant's priced run in both packages: the
    same makespan, components and findings."""
    from smi_tpu.analysis import perf_mutants as JPM

    def decompose(perf, mutants):
        costs, _message, pipeline = perf._costs_for(
            protocol, dict(shape), float(perf.PERF_PAYLOAD_BYTES))
        return perf.decompose_generators(
            lambda: mutants.perf_mutant_generators(
                protocol, mutant, shape["n"],
                chunks=shape.get("chunks", 3),
                slices=shape.get("slices", 2)),
            costs, protocol=f"{protocol}[{mutant}]", shape=dict(shape),
            pipeline_chunks=pipeline)

    ours, theirs = decompose(P, PM), decompose(JP, JPM)
    assert ours.makespan_s == theirs.makespan_s
    assert _canon(ours.to_json()) == _canon(theirs.to_json())
    assert ours.describe() == theirs.describe()


# ---------------------------------------------------------------------------
# sweep_stencil and the seeded H100 stencil entry
# ---------------------------------------------------------------------------


def _stencil_entries(cache):
    return {sig: (e.knobs, e.cost_us, e.provenance)
            for sig, e in cache.entries.items()}


def test_narrow_sweep_stencil_equals_the_jax_package_s():
    """The proxy tier on the CPU: the same key, knobs, cost and
    provenance as the JAX package's sweep over the same candidates."""
    from smi_tpu.tuning.sweep import sweep_stencil as jsweep
    from smi_tpu_torch.tuning.sweep import sweep_stencil

    kw = dict(depths=(8,), stripes=(64,), runs=1, proxy_shape=(128, 256))
    ours = sweep_stencil(device="cpu", **kw)
    theirs = jsweep(**kw)
    assert _stencil_entries(ours) == _stencil_entries(theirs)
    (sig, (knobs, cost_us, provenance)), = _stencil_entries(ours).items()
    assert sig == "stencil_pipeline|8192|float32|cpu|chip"
    assert knobs == {"algorithm": "pipeline", "depth": 8, "stripe": 64,
                     "compute_dtype": "float32", "buffering": 3}
    assert cost_us > 0 and provenance.startswith("sweep:stencil:proxy")


def test_sweep_stencil_records_every_candidate():
    """``record`` holds one row per candidate: its price and where it
    came from, or None and why it was dropped."""
    from smi_tpu_torch.tuning.sweep import sweep_stencil

    rows = []
    cache = sweep_stencil(depths=(8,), stripes=(64, 128), runs=1,
                          proxy_shape=(128, 256), device="cpu", record=rows)
    names = [c.name for c in cm.stencil_pipeline_candidates(
        8192, 8192, "float32", (8,), (64, 128))]
    assert [r[0] for r in rows] == names
    priced = [r for r in rows if r[1] is not None]
    dropped = [r for r in rows if r[1] is None]
    assert {r[0] for r in dropped} == {"pipe:d8:t128:f32",
                                       "pipe:d8:t128:bf16"}
    assert all("no proxy gate" in r[2] for r in dropped)
    (entry,) = cache.entries.values()
    assert entry.cost_us == min(r[1] for r in priced)


def test_card_sweep_names_the_candidates_the_kernel_refuses():
    """Stripe 128 at 8192^2 overflows the pipeline's shared memory: the
    card sweep's gate refuses it with the kernel's own reason, and
    admits stripe 64 at the same depth."""
    from smi_tpu_torch.tuning.sweep import _stencil_refusal

    knobs = {"algorithm": "pipeline", "depth": 8, "stripe": 128,
             "compute_dtype": "float32", "buffering": 3}
    note = _stencil_refusal(8192, 8192, knobs)
    assert note is not None and "stripe 128" in note
    assert "shared memory" in note
    assert _stencil_refusal(8192, 8192, dict(knobs, stripe=64)) is None
    assert _stencil_refusal(8192, 8192, dict(knobs, depth=12)) is not None


@pytest.mark.slow
def test_sweep_stencil_full_grid_winner_is_the_best_gated_candidate():
    """The full-grid proxy sweep picks the best-priced candidate that
    the port's own gate admits at the proxy shape. The port's kernel
    refuses stripe 128 at the JAX package's proxy winner's depths
    (``pipe:d8:t128:f32``: its slots overflow shared memory), so the
    port's winner differs from it."""
    from smi_tpu_torch.kernels import stencil_pipeline as kpipe
    from smi_tpu_torch.tuning.sweep import sweep_stencil

    cache = sweep_stencil(runs=1, device="cpu")
    (entry,) = cache.entries.values()
    ph, pw = 256, 384
    idle = {b: max(r["idle_fraction"] for r in
                   P.decompose_stencil_stream(buffering=b).per_rank)
            for b in (1, 3)}
    gated = []
    for cand in cm.stencil_pipeline_candidates(8192, 8192, "float32"):
        k = cand.knobs
        stripe = (None if ph % k["stripe"] or k["stripe"] < k["depth"]
                  else k["stripe"])
        if kpipe.pipeline_supported(ph, pw, torch.float32, k["depth"],
                                    stripe=stripe,
                                    compute_dtype=k["compute_dtype"],
                                    buffering=k["buffering"]):
            gated.append((cand.modeled_us * (1 + idle[k["buffering"]]),
                          cand.name, k))
    best = min(gated, key=lambda g: (g[0], g[1]))
    assert entry.knobs == best[2] and entry.cost_us == best[0]
    assert (entry.knobs["depth"], entry.knobs["stripe"]) != (8, 128)


def test_seeded_h100_stencil_entry_is_a_cache_hit_the_kernel_admits():
    """On the card the seeded H100 entry answers the stencil plan: a
    cache hit (not the model's pick, which the port's kernel refuses at
    8192^2), whose knobs the pipeline kernel admits, citing the card's
    own sweep."""
    from smi_tpu_torch.kernels import stencil_pipeline as kpipe
    from smi_tpu_torch.tuning.engine import PlanEngine
    from smi_tpu_torch.tuning.seeded import (
        SEEDED_H100_CARD,
        SEEDED_H100_DEVICE_KIND,
        seeded_cache,
    )

    engine = PlanEngine(cache=seeded_cache(),
                        device_kind=SEEDED_H100_DEVICE_KIND)
    got = engine.stencil_pipeline_knobs()
    assert got is not None
    knobs, layer = got
    assert layer == "cache"
    assert kpipe.pipeline_supported(
        8192, 8192, torch.float32, knobs["depth"], stripe=knobs["stripe"],
        compute_dtype=knobs["compute_dtype"], buffering=knobs["buffering"])
    text = engine.stencil_pipeline_plan().explain()
    assert "[cache]" in text and "[model]" not in text
    entry = engine.cache.lookup(engine.stencil_pipeline_plan().key)
    assert "PERF.md" in entry.provenance
    assert SEEDED_H100_CARD in entry.provenance
    assert entry.cost_us > 0
    # the model's own pick at 8192^2 is one the port's kernel refuses
    model = cm.stencil_pipeline_candidates(8192, 8192, "float32")[0].knobs
    assert not kpipe.pipeline_supported(
        8192, 8192, torch.float32, model["depth"], stripe=model["stripe"],
        compute_dtype=model["compute_dtype"], buffering=model["buffering"])
