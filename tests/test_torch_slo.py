"""The port's request spans, blame and SLO health on its own front end:
the reference's cases, and parity.

The cases of ``tests/test_slo.py`` that need the serving front end, the
campaigns or MoE, carried over against the port (the SLO engine's own
cases, the recorder knob's, the span builder's refusals and the blame
vocabulary's are in ``tests/test_torch_obs.py``; ``bench.py``'s field has
no counterpart in the port): span exactness across the seeded campaign
matrix, blame ground truth in every fault cell, breach determinism and
the fair-weather noise floor, the per-tenant serving trace. The last
part holds the serving trace file each package writes from its own
front end's run byte for byte equal, and the health and blame of the
same cells equal as sorted-key JSON.
"""

import json
import math

import pytest

from smi_tpu_torch.obs.events import FlightRecorder
from smi_tpu_torch.obs.slo import SLO_WINDOWS
from smi_tpu_torch.obs.spans import (
    COMPONENTS,
    DELIVERY_COMPONENTS,
    BlameVerdict,
    SpanError,
    blame_report,
    blame_verdict,
    build_spans,
    exactness_problems,
    format_blame,
    frontend_spans,
)
from smi_tpu_torch.serving.campaign import run_load_cell, run_retune_cell
from smi_tpu_torch.serving.frontend import ServingFrontend
from smi_tpu_torch.serving.moe import expert_home, run_moe_cell
from smi_tpu_torch.serving.qos import QOS_CLASSES

pytestmark = pytest.mark.slo




# ---------------------------------------------------------------------------
# Span builder: refusal, walk correctness, stall carving
# ---------------------------------------------------------------------------


class TestSpanBuilder:
    def test_truncated_stream_is_refused_naming_the_knob(self):
        fe = ServingFrontend(2, seed=0,
                             recorder=FlightRecorder(capacity=8))
        fe.submit("t0", "batch",
                  tuple(f"c{i}" for i in range(8)))
        fe.drain()
        assert fe.recorder.dropped_events > 0
        with pytest.raises(SpanError, match="SMI_TPU_OBS_RING"):
            build_spans(fe.recorder)
        # the opt-in best-effort path still builds the retained window
        report = build_spans(fe.recorder, allow_partial=True)
        assert report.dropped_events > 0

    def test_single_stream_partition_is_exact(self):
        fe = ServingFrontend(2, seed=0)
        fe.submit("t0", "batch", ("c0", "c1", "c2"))
        fe.drain()
        report = frontend_spans(fe)
        assert exactness_problems(report, fe) == []
        [st] = fe.completed
        tree = report.requests[st.request.stream_id]
        assert tree.latency == st.completed_at - st.admitted_at
        assert tree.delivery_sum() == tree.latency
        # component spans tile: sorted by t0, each starts where the
        # previous ended, from admission to completion
        comp = [s for s in tree.spans if s.kind == "component"
                and s.component != "admit.wait"]
        t = tree.admitted
        for span in comp:
            assert span.t0 == t
            t = span.t1
        assert t == tree.completed

    def test_snapshot_roundtrip_builds_identical_trees(self):
        rep, fe = run_load_cell(n=4, seed=3, duration=120,
                                overload=1.0, return_frontend=True)
        live = frontend_spans(fe)
        recorded = build_spans(fe.recorder.snapshot())
        assert live.requests.keys() == recorded.requests.keys()
        for key in live.requests:
            assert (live.requests[key].to_json()
                    == recorded.requests[key].to_json())

    def test_shed_requests_get_terminal_trees(self):
        rep, fe = run_load_cell(n=4, seed=0, duration=160,
                                overload=2.0, return_frontend=True)
        report = frontend_spans(fe)
        shed = [t for t in report.requests.values()
                if t.shed_reason is not None]
        assert shed, "a 2x overload cell must shed"
        for tree in shed:
            assert tree.outcome.startswith("shed:")
            assert tree.completed is None
        digest = report.digest()
        assert digest["outcomes"]["shed"] == len(shed)

    def test_stall_cell_carves_credit_stall_subspans(self):
        rep, fe = run_load_cell(
            n=4, seed=1, duration=240, overload=1.0, stall_rank=1,
            stall_at=40, stall_ticks=60, return_frontend=True,
        )
        report = frontend_spans(fe)
        stall_ticks = sum(
            t.by_dst.get(("credit.stall", 1), 0)
            for t in report.requests.values()
        )
        assert stall_ticks > 0, (
            "a 60-tick consumer stall never surfaced as credit.stall "
            "time on the stalled lane"
        )
        # the carving is a sub-partition: queue + credit.stall spans
        # never overlap within a tree (every component span tiles)
        for tree in report.delivered():
            assert tree.delivery_sum() == tree.latency


# ---------------------------------------------------------------------------
# Span exactness across the seeded campaign matrix (the acceptance)
# ---------------------------------------------------------------------------


MATRIX_SEEDS = (0, 7, 23)


class TestSpanExactnessMatrix:
    @pytest.mark.parametrize("seed", MATRIX_SEEDS)
    @pytest.mark.parametrize("shape", [
        ("overload", dict(overload=2.0, duration=240)),
        ("kill", dict(overload=1.0, duration=240, kill_rank=2,
                      kill_at=60)),
        ("stall", dict(overload=1.0, duration=240, stall_rank=1,
                       stall_at=40, stall_ticks=60)),
    ], ids=lambda s: s[0])
    def test_load_cells_are_bit_exact(self, shape, seed):
        """Every request's span-component sum == the front-end's own
        measured admission-to-delivery latency, bit-identically — the
        cell's own gate AND an independent re-derivation here."""
        name, kwargs = shape
        rep, fe = run_load_cell(n=4, seed=seed, return_frontend=True,
                                **kwargs)
        assert rep["ok"], rep["verdict"]
        assert rep["span_exact"] is True
        report = frontend_spans(fe)
        assert exactness_problems(report, fe) == []
        # belt and braces: compare stream by stream, == not approx
        for st in fe.completed:
            tree = report.requests[st.request.stream_id]
            assert tree.delivery_sum() == \
                st.completed_at - st.admitted_at

    @pytest.mark.parametrize("seed", MATRIX_SEEDS)
    @pytest.mark.parametrize("hot", [None, 1], ids=["uniform", "hot"])
    def test_moe_cells_are_bit_exact(self, seed, hot):
        rep = run_moe_cell(n=4, seed=seed, duration=120,
                           hot_expert=hot,
                           batches_per_tick=0.75 if hot else 0.5)
        assert rep["ok"], rep["verdict"]
        assert rep["span_exact"] is True

    @pytest.mark.parametrize("seed", MATRIX_SEEDS[:2])
    def test_retune_cell_is_bit_exact(self, seed):
        rep = run_retune_cell(n=4, seed=seed, duration=160)
        assert rep["ok"], rep["verdict"]
        assert rep["span_exact"] is True

    def test_exactness_detects_a_lying_frontend(self):
        """The gate is a real comparison: perturb the front-end's
        bookkeeping after the run and the check must fail."""
        rep, fe = run_load_cell(n=4, seed=0, duration=120,
                                overload=1.0, return_frontend=True)
        report = frontend_spans(fe)
        assert exactness_problems(report, fe) == []
        fe.completed[0].completed_at += 1
        problems = exactness_problems(report, fe)
        assert problems and "span exactness" in problems[0]


# ---------------------------------------------------------------------------
# Tail-latency blame vs injected ground truth
# ---------------------------------------------------------------------------


class TestBlame:
    @pytest.mark.parametrize("seed,kill", [(0, 2), (3, 0), (8, 2),
                                           (11, 3)])
    def test_kill_cell_blames_the_dead_rank(self, seed, kill):
        rep = run_load_cell(n=4, seed=seed, duration=240,
                            overload=1.0, kill_rank=kill, kill_at=60)
        assert rep["ok"], rep["verdict"]
        verdict = blame_verdict(rep["blame"])
        assert verdict.component == "failover"
        assert verdict.kind == "failover" and verdict.rank == kill

    def test_kill_with_nothing_in_flight_blames_the_heirs_wire(self):
        """A kill that caught zero in-flight streams (suspicion
        drained everything first) has no failover time to blame — the
        binding falls to the heir's wire, which is where the diverted
        load actually bound. Seed pinned from the seeded sweep."""
        rep = run_load_cell(n=4, seed=4, duration=240, overload=1.0,
                            kill_rank=1, kill_at=60)
        assert rep["ok"], rep["verdict"]
        assert "failover" not in rep["spans"]["components_ticks"]
        verdict = blame_verdict(rep["blame"])
        assert verdict.kind == "wire" and verdict.rank is not None

    @pytest.mark.parametrize("seed,stall", [(0, 3), (2, 1), (6, 1),
                                            (9, 2)])
    def test_stall_cell_blames_the_stalled_rank(self, seed, stall):
        rep = run_load_cell(n=4, seed=seed, duration=240,
                            overload=1.0, stall_rank=stall,
                            stall_at=40, stall_ticks=60)
        assert rep["ok"], rep["verdict"]
        verdict = blame_verdict(rep["blame"])
        assert verdict.rank == stall, verdict

    @pytest.mark.parametrize("seed", (0, 7, 11))
    def test_overload_cell_blames_wire_and_brownout_class(self, seed):
        rep = run_load_cell(n=4, seed=seed, duration=240,
                            overload=2.0)
        assert rep["ok"], rep["verdict"]
        verdict = blame_verdict(rep["blame"])
        # the tail of DELIVERED requests bound on the saturated wire;
        # the shed pressure names the browned-out class
        assert verdict.kind == "wire" and verdict.rank is not None
        admission = rep["blame"]["admission"]
        assert admission["brownout_class"] == "best_effort"
        assert admission["brownout_sheds"] > 0

    @pytest.mark.parametrize("seed,hot", [(0, 1), (5, 3)])
    def test_moe_hot_expert_blames_its_home_rank(self, seed, hot):
        rep = run_moe_cell(n=4, seed=seed, duration=120,
                           hot_expert=hot, batches_per_tick=0.75)
        assert rep["ok"], rep["verdict"]
        home = expert_home(hot, 4)
        verdict = blame_verdict(rep["blame"])
        assert verdict.rank == home, verdict

    def test_blame_rows_decompose_p99_into_shares(self):
        rep = run_load_cell(n=4, seed=0, duration=240, overload=2.0)
        for qos, row in rep["blame"]["by_qos"].items():
            if row is None:
                continue
            assert row["p99"] >= row["p50"]
            assert set(row["shares"]) <= set(DELIVERY_COMPONENTS)
            if row["shares"]:
                assert abs(sum(row["shares"].values()) - 1.0) < 0.01
            assert row["decile_count"] == max(
                1, math.ceil(0.1 * row["count"])
            )

    def test_bad_decile_is_loud(self):
        rep, fe = run_load_cell(n=4, seed=0, duration=120,
                                overload=1.0, return_frontend=True)
        with pytest.raises(ValueError, match="decile"):
            blame_report(frontend_spans(fe), decile=0.0)

    def test_format_blame_renders_the_verdict(self):
        rep = run_load_cell(n=4, seed=0, duration=240, overload=2.0)
        text = "\n".join(format_blame(rep["blame"]))
        assert "binding" in text and "brownout class best_effort" \
            in text


# ---------------------------------------------------------------------------
# SLO breaches in the seeded campaigns: deterministic, no false alarms
# ---------------------------------------------------------------------------


class TestSloCampaign:
    @pytest.mark.parametrize("seed", (0, 7, 11, 23))
    def test_brownout_campaign_breaches_deterministically(self, seed):
        """The 2x overload (brownout) cell must fire slo.breach on
        best_effort — the class the ceilings shed first — and the
        breach must be in the event stream, not just the snapshot."""
        rep = run_load_cell(n=4, seed=seed, duration=240,
                            overload=2.0)
        assert rep["ok"], rep["verdict"]
        cls = rep["health"]["classes"]["best_effort"]
        assert cls["breaches"] >= 1
        assert rep["obs"]["event_counts"].get("slo.breach", 0) >= 1
        # brownout is the dominant error reason for the class
        assert cls["errors_by_reason"].get("brownout", 0) > 0
        # and the counters agree with the engine's own bookkeeping
        counters = rep["metrics"]["counters"]
        assert counters.get(
            "slo_breaches_total{qos=best_effort}", 0
        ) == cls["breaches"]

    @pytest.mark.parametrize("seed", (0, 7, 11, 23))
    def test_fair_weather_fires_zero_alarms(self, seed):
        """0.5x load: zero breaches AND zero burn warnings, any seed —
        the noise floor of the signal."""
        rep = run_load_cell(n=4, seed=seed, duration=240,
                            overload=0.5)
        assert rep["ok"], rep["verdict"]
        health = rep["health"]
        assert health["breaches_total"] == 0
        assert all(c["burn_warnings"] == 0
                   for c in health["classes"].values())
        assert rep["obs"]["event_counts"].get("slo.breach", 0) == 0
        assert rep["obs"]["event_counts"].get("slo.burn", 0) == 0

    def test_health_rides_every_cell_report(self):
        for rep in (
            run_load_cell(n=4, seed=0, duration=160, overload=2.0),
            run_moe_cell(n=4, seed=0, duration=120),
            run_retune_cell(n=4, seed=0, duration=160),
        ):
            health = rep["health"]
            assert health["windows"] == list(SLO_WINDOWS)
            assert set(health["classes"]) == set(QOS_CLASSES)

    def test_health_is_deterministic_per_seed(self):
        a = run_load_cell(n=4, seed=5, duration=160, overload=2.0)
        b = run_load_cell(n=4, seed=5, duration=160, overload=2.0)
        assert json.dumps(a["health"], sort_keys=True) == \
            json.dumps(b["health"], sort_keys=True)
        assert json.dumps(a["blame"], sort_keys=True) == \
            json.dumps(b["blame"], sort_keys=True)

    def test_breach_is_observation_not_gate(self):
        """An overload cell breaches AND passes its gates: health is
        a signal for the control loop, never a campaign verdict."""
        rep = run_load_cell(n=4, seed=0, duration=240, overload=2.0)
        assert rep["health"]["breaches_total"] > 0
        assert rep["ok"] is True


# ---------------------------------------------------------------------------
# Serving trace export (per-tenant track groups)
# ---------------------------------------------------------------------------


class TestServingTrace:
    def _trace(self, seed=5):
        from smi_tpu_torch.obs.trace import trace_serving

        rep, fe = run_load_cell(n=4, seed=seed, duration=160,
                                overload=2.0, return_frontend=True)
        return trace_serving(frontend_spans(fe), seed=seed)

    def test_same_seed_byte_identical_file(self):
        from smi_tpu_torch.obs.trace import trace_to_json_bytes

        assert trace_to_json_bytes(self._trace(5)) == \
            trace_to_json_bytes(self._trace(5))

    def test_validates_and_groups_by_tenant(self):
        from smi_tpu_torch.obs.trace import validate_chrome_trace

        payload = self._trace()
        validate_chrome_trace(payload)
        other = payload["otherData"]
        assert other["trace_kind"] == "serving"
        # one process per tenant, named
        processes = [e for e in payload["traceEvents"]
                     if e.get("name") == "process_name"]
        assert len(processes) == other["tenants"]
        assert all(e["args"]["name"].startswith("tenant ")
                   for e in processes)
        # spans carry component cats from the span taxonomy
        cats = {e["cat"] for e in payload["traceEvents"]
                if e["ph"] == "X"}
        assert cats <= set(COMPONENTS) | {"annotation"}
        assert "credit.stall" in cats  # the overload signature

    def test_components_ticks_match_the_span_digest(self):
        rep, fe = run_load_cell(n=4, seed=3, duration=160,
                                overload=2.0, return_frontend=True)
        from smi_tpu_torch.obs.trace import trace_serving

        spans = frontend_spans(fe)
        payload = trace_serving(spans, seed=3)
        digest = spans.digest()
        traced = payload["otherData"]["components_ticks"]
        for c, v in digest["components_ticks"].items():
            assert traced.get(c, 0) == v


# ---------------------------------------------------------------------------
# bench.py additive slo field
# ---------------------------------------------------------------------------



# ---------------------------------------------------------------------------
# BlameVerdict: the structured verdict accessor (r16)
# ---------------------------------------------------------------------------


class TestBlameVerdict:

    def test_accessor_reads_report_binding_and_rows(self):
        rep = run_load_cell(n=4, seed=0, duration=240, overload=2.0)
        top = blame_verdict(rep["blame"])
        assert top == blame_verdict(rep["blame"]["binding"])
        assert isinstance(top, BlameVerdict)
        assert top.resource == rep["blame"]["binding"]["resource"]
        for row in rep["blame"]["by_qos"].values():
            if row is None:
                continue
            v = blame_verdict(row)
            assert v.resource == row["resource"]
            assert v.component == row["binding"]


# ---------------------------------------------------------------------------
# Wide sweeps behind slow
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(12))
def test_wide_matrix_exactness_and_blame(seed):
    import random

    kill = random.Random(f"k{seed}").randrange(4)
    rep = run_load_cell(n=4, seed=seed, duration=240, overload=1.0,
                        kill_rank=kill, kill_at=60)
    assert rep["ok"] and rep["span_exact"], rep["verdict"]
    if "failover" in rep["spans"]["components_ticks"]:
        verdict = blame_verdict(rep["blame"])
        assert verdict.kind == "failover" and verdict.rank == kill
    stall = random.Random(f"s{seed}").randrange(4)
    rep = run_load_cell(n=4, seed=seed, duration=240, overload=1.0,
                        stall_rank=stall, stall_at=40, stall_ticks=60)
    assert rep["ok"] and rep["span_exact"], rep["verdict"]
    assert blame_verdict(rep["blame"]).rank == stall


# ---------------------------------------------------------------------------
# Parity with the JAX package: each package's trace of its own run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", [
    dict(seed=5, duration=160, overload=2.0),
    dict(seed=1, duration=240, overload=1.0, kill_rank=2, kill_at=60),
    dict(seed=0, duration=240, overload=1.0, stall_rank=1, stall_at=40,
         stall_ticks=60),
], ids=["overload", "kill", "stall"])
def test_serving_trace_file_equals_the_jax_package_s(cell):
    """The per-tenant serving trace each package writes from its own
    front end's run of the same cell: the same bytes."""
    from smi_tpu.obs import spans as JSP
    from smi_tpu.obs import trace as JT
    from smi_tpu.serving import campaign as JC
    from smi_tpu_torch.obs.trace import trace_serving, trace_to_json_bytes

    _rep, fe = run_load_cell(n=4, return_frontend=True, **cell)
    _jrep, jfe = JC.run_load_cell(n=4, return_frontend=True, **cell)
    ours = trace_to_json_bytes(trace_serving(frontend_spans(fe),
                                             seed=cell["seed"]))
    theirs = JT.trace_to_json_bytes(JT.trace_serving(
        JSP.frontend_spans(jfe), seed=cell["seed"]))
    assert ours == theirs


@pytest.mark.parametrize("run", [
    lambda m, mo: m.run_load_cell(n=4, seed=7, duration=240, overload=2.0),
    lambda m, mo: m.run_load_cell(n=4, seed=11, duration=240, overload=0.5),
    lambda m, mo: mo.run_moe_cell(n=4, seed=2, duration=120, hot_expert=1,
                                  batches_per_tick=0.75),
    lambda m, mo: m.run_retune_cell(n=4, seed=1, duration=160),
], ids=["brownout", "fair-weather", "moe-hot", "retune"])
def test_health_and_blame_equal_the_jax_package_s(run):
    from smi_tpu.serving import campaign as JC
    from smi_tpu.serving import moe as JM
    from smi_tpu_torch.serving import campaign as SC
    from smi_tpu_torch.serving import moe as SM

    ours, theirs = run(SC, SM), run(JC, JM)
    for key in ("health", "blame", "spans", "obs"):
        assert json.dumps(ours[key], sort_keys=True) == \
            json.dumps(theirs[key], sort_keys=True), key

