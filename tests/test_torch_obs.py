"""The port's observability tier: the reference's cases, and parity.

``smi_tpu_torch/obs/`` is the port's copy of the JAX package's
observability layer (pure Python): the flight recorder and its event
schema, the metrics registry and sample sink, the Perfetto export of the
timestamped simulator, request spans with tail-latency blame, and the
burn-rate SLO engine. The first part carries over ``tests/test_obs.py``
against the port, all but ``bench.py``'s field (the port has no
counterpart of ``bench.py`` yet), and the cases of ``tests/test_slo.py``
that need none of the front end, the campaigns or MoE
(``tests/test_torch_slo.py`` carries the rest). The second part runs
both packages on the same seeds with the tolerance "equal": trace files
byte-identical, simulator event streams and metrics snapshots equal as
sorted-key JSON, span trees, blame and SLO health equal, each package's
spans built from its own front end's recording of the same serving
run.
"""

import copy
import json
import pickle

import pytest

from smi_tpu_torch.obs.events import (
    DEFAULT_RECORDER_CAPACITY,
    DEFAULT_TAIL_EVENTS,
    EVENT_KINDS,
    OBS_RING_ENV,
    FlightRecorder,
    format_tail,
    ring_capacity,
)
from smi_tpu_torch.obs.metrics import MetricsRegistry, SampleSink, payload_bucket
from smi_tpu_torch.obs.slo import (
    BREACH_BURN,
    DEFAULT_SLOS,
    MIN_WINDOW_EVENTS,
    SLO_WINDOWS,
    SloEngine,
    SloSpec,
    format_health,
)
from smi_tpu_torch.obs.spans import (
    BlameVerdict,
    SpanError,
    blame_verdict,
    build_spans,
    parse_blame_resource,
)
from smi_tpu_torch.obs.trace import (
    trace_all,
    trace_name,
    trace_protocol,
    trace_to_json_bytes,
    validate_chrome_trace,
)
from smi_tpu_torch.analysis.verifier import DEFAULT_SHAPES
from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.parallel import faults as F
from smi_tpu_torch.serving.qos import QOS_CLASSES

pytestmark = pytest.mark.obs

GRID = [
    (protocol, shape)
    for protocol, shapes in DEFAULT_SHAPES.items()
    for shape in shapes
]


def _grid_id(case):
    protocol, shape = case
    return protocol + "," + ",".join(
        f"{k}={v}" for k, v in sorted(shape.items())
    )


# ---------------------------------------------------------------------------
# Event schema + flight recorder
# ---------------------------------------------------------------------------


class TestFlightRecorder:
    def test_schema_is_well_formed(self):
        for kind, (plane, fields) in EVENT_KINDS.items():
            assert plane in ("sim", "serving", "control", "tuning",
                             "slo")
            assert isinstance(fields, tuple)

    def test_unknown_kind_is_loud(self):
        rec = FlightRecorder()
        with pytest.raises(ValueError, match="unknown event kind"):
            rec.emit("serve.frobnicate", 0)

    def test_missing_required_field_is_loud(self):
        rec = FlightRecorder()
        with pytest.raises(ValueError, match="missing required field"):
            rec.emit("serve.shed", 0, tenant="t0", qos="batch")

    def test_extra_fields_ride_along(self):
        rec = FlightRecorder()
        e = rec.emit("credit.grant", 3, rank=0, src=0, dst=1, index=1,
                     mult=2)
        assert e.to_json()["mult"] == 2

    def test_reserved_envelope_keys_cannot_be_shadowed(self):
        """A field named like an envelope key would clobber the causal
        emission counter in ``to_json`` — rejected at the source (the
        reason chunk sequence numbers travel as ``chunk``)."""
        rec = FlightRecorder()
        with pytest.raises(ValueError, match="reserved envelope"):
            rec.emit("serve.shed", 0, tenant="t", qos="batch",
                     reason="r", seq=5)
        # and to_json keeps the emission counter authoritative
        e = rec.emit("serve.send", 1, rank=0, tenant="t", qos="batch",
                     chunk=0, dst=0)
        assert e.to_json()["seq"] == 0 and e.to_json()["chunk"] == 0

    def test_ring_bound_counts_drops(self):
        rec = FlightRecorder(capacity=4)
        for i in range(10):
            rec.emit("barrier.wait", i, rank=0)
        assert rec.total_events == 10
        assert rec.dropped_events == 6
        snap = rec.snapshot()
        assert snap["dropped_events"] == 6  # never silent
        assert len(snap["events"]) == 4
        assert snap["counts"] == {"barrier.wait": 10}

    def test_tail_is_bounded_and_honest(self):
        rec = FlightRecorder(capacity=100)
        for i in range(60):
            rec.emit("barrier.wait", i, rank=0)
        tail = rec.tail()
        assert len(tail["events"]) == DEFAULT_TAIL_EVENTS
        assert tail["dropped_events"] == 0
        assert tail["omitted"] == 60 - DEFAULT_TAIL_EVENTS
        assert tail["events"][-1]["seq"] == 59
        assert "barrier.wait" in format_tail(tail)

    def test_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            FlightRecorder(capacity=0)

    def test_default_capacity_is_documented_value(self):
        assert FlightRecorder().capacity == DEFAULT_RECORDER_CAPACITY


# ---------------------------------------------------------------------------
# Simulator events: determinism + error tails
# ---------------------------------------------------------------------------


class TestSimulatorEvents:
    def _stream(self, seed=0):
        rec = FlightRecorder(capacity=10_000)
        C.simulate_all_reduce(4, C.Strategy(seed), recorder=rec)
        return [e.to_json() for e in rec.events()]

    def test_same_seed_identical_event_stream(self):
        assert self._stream(7) == self._stream(7)

    def test_different_seed_different_schedule(self):
        # the event stream reflects the schedule: distinct seeds must
        # be distinguishable (else the stream carries no ordering)
        assert self._stream(0) != self._stream(1)

    def test_sim_plane_kinds_cover_the_primitives(self):
        rec = FlightRecorder(capacity=10_000)
        C.simulate_all_reduce(3, C.Strategy(0), recorder=rec)
        assert set(rec.counts) == {
            "credit.grant", "credit.wait", "dma.start", "dma.land",
            "barrier.signal", "barrier.wait",
        }
        # one landing per start, schedule-independent
        assert rec.counts["dma.start"] == rec.counts["dma.land"]

    def test_deadlock_carries_the_tail(self):
        plan = F.FaultPlan(dropped_grants=(F.DroppedGrant(0, 0),))
        rec = FlightRecorder(capacity=8)
        with pytest.raises(C.DeadlockError) as info:
            C.simulate_all_reduce(3, C.Strategy(0), faults=plan,
                                  recorder=rec)
        e = info.value
        assert e.recorder_tail["events"]
        assert e.recorder_tail["dropped_events"] > 0  # ring wrapped
        assert "flight_recorder" in e.state
        # the formatted dump renders the history
        assert "flight recorder" in str(e)

    def test_integrity_error_carries_the_tail(self):
        plan = F.FaultPlan(bit_flips=(F.BitFlipPayload(0, 0),))
        verdict = F.run_under_faults(
            "all_reduce", 3, plan, recorder=FlightRecorder()
        )
        assert verdict.kind == "detected"
        assert isinstance(verdict.error, C.IntegrityError)
        assert verdict.error.recorder_tail["events"]

    def test_no_recorder_is_the_default_and_free(self):
        sim = C.RingSimulator(
            C.all_to_all_generators(3), C.Strategy(0)
        )
        sim.run()
        assert sim.recorder is None
        assert "flight_recorder" not in sim.state_dump()


# ---------------------------------------------------------------------------
# Metrics registry + sample sink
# ---------------------------------------------------------------------------


class TestMetrics:
    def test_snapshot_is_sorted_and_deterministic(self):
        def build():
            m = MetricsRegistry()
            m.counter("b", x=2).inc(3)
            m.counter("a").inc()
            m.gauge("g").set(5)
            m.gauge("g").set(2)
            m.histogram("h", qos="batch").observe(3)
            return json.dumps(m.snapshot(), sort_keys=True)

        assert build() == build()
        snap = json.loads(build())
        assert snap["counters"] == {"a": 1, "b{x=2}": 3}
        assert snap["gauges"]["g"] == {"value": 2, "max": 5}
        assert snap["histograms"]["h{qos=batch}"]["count"] == 1

    def test_type_confusion_is_loud(self):
        m = MetricsRegistry()
        m.counter("n").inc()
        with pytest.raises(TypeError, match="is a Counter"):
            m.gauge("n")

    def test_histogram_overflow_is_explicit(self):
        m = MetricsRegistry()
        h = m.histogram("h")
        h.observe(2.0 ** 40)  # beyond the fixed bucket grid
        assert h.to_json()["overflow"] == 1

    def test_sample_sink_aggregates_per_key(self):
        s = SampleSink()
        s.record("allreduce", 1e-3, payload_bytes=900_000, tenant="t0")
        s.record("allreduce", 3e-3, payload_bytes=1_000_000,
                 tenant="t0")
        s.record("allreduce", 2e-3, payload_bytes=5_000_000,
                 tenant="t0")
        entries = s.entries()
        assert len(entries) == 2  # two payload buckets
        first = entries[0]
        assert first["knobs"]["payload_bucket_bytes"] == payload_bucket(
            1_000_000
        )
        assert first["knobs"]["samples"] == 2
        assert first["cost_us"] == pytest.approx(2000.0)

    def test_sample_sink_entries_load_as_plan_cache_entries(self):
        """The ROADMAP-3 contract: a sink aggregate IS a plan-cache
        entry — `CacheEntry.from_json` must accept it unchanged."""
        from smi_tpu_torch.tuning.cache import CacheEntry

        s = SampleSink()
        s.record("flash_fwd", 5e-4, payload_bytes=1 << 20)
        entry = CacheEntry.from_json("probe", s.entries()[0])
        assert entry.cost_us == pytest.approx(500.0)
        assert entry.provenance == "obs:sample_sink"

    def test_negative_sample_is_loud(self):
        with pytest.raises(ValueError):
            SampleSink().record("op", -1.0)


class TestTimedSink:
    def test_timed_records_into_a_sample_sink(self):
        from smi_tpu_torch.utils.tracing import timed

        sink = SampleSink()
        result, seconds = timed(
            lambda: 42, sink=sink, op="probe",
            payload_bytes=2048, tenant="t1",
        )
        assert result == 42
        assert len(sink) == 1
        entry = sink.entries()[0]
        assert entry["knobs"]["op"] == "probe"
        assert entry["knobs"]["tenant"] == "t1"
        assert entry["knobs"]["payload_bucket_bytes"] == 2048
        assert entry["cost_us"] == pytest.approx(seconds * 1e6)

    def test_timed_accepts_a_plain_callable(self):
        from smi_tpu_torch.utils.tracing import timed

        seen = []
        timed(lambda: 1, sink=lambda op, s: seen.append((op, s)))
        assert seen and seen[0][0] == "timed"

    def test_timed_without_sink_is_unchanged(self):
        from smi_tpu_torch.utils.tracing import timed

        result, seconds = timed(lambda: "x")
        assert result == "x" and seconds >= 0.0


# ---------------------------------------------------------------------------
# Perfetto export: schema, determinism, exactness over the full grid
# ---------------------------------------------------------------------------


class TestTraceExport:
    def test_export_validates_against_the_pinned_schema(self):
        validate_chrome_trace(trace_protocol("all_reduce", 3))

    def test_schema_validator_rejects_drift(self):
        payload = trace_protocol("all_reduce", 2)
        payload["otherData"]["schema_version"] = 999
        with pytest.raises(ValueError, match="schema_version"):
            validate_chrome_trace(payload)
        broken = trace_protocol("all_reduce", 2)
        broken["traceEvents"][len(broken["traceEvents"]) - 1].pop("cat")
        with pytest.raises(ValueError, match="missing"):
            validate_chrome_trace(broken)

    def test_same_seed_byte_identical_file(self):
        a = trace_to_json_bytes(trace_protocol("allreduce_pod", 4,
                                               slices=2, seed=3))
        b = trace_to_json_bytes(trace_protocol("allreduce_pod", 4,
                                               slices=2, seed=3))
        assert a == b

    def test_trace_all_covers_the_registry_and_names_are_unique(self):
        traces = trace_all()
        assert len(traces) == len(GRID)
        names = [trace_name(t) for t in traces]
        assert len(set(names)) == len(names)
        for t in traces:
            validate_chrome_trace(t)

    def test_unknown_protocol_is_loud(self):
        with pytest.raises(ValueError, match="unknown protocol"):
            trace_all(["nope"])

    @pytest.mark.parametrize("case", GRID, ids=_grid_id)
    def test_span_sums_bit_identical_to_elapsed_seconds(self, case):
        """The acceptance criterion, over the FULL registered grid:
        per-rank span tiling ends at the rank clock, the makespan
        equals ``elapsed_seconds()``, and the component attribution
        matches the PR 11 decomposer — all compared exactly, no
        tolerance anywhere."""
        from smi_tpu_torch.analysis.perf import decompose_protocol

        protocol, shape = case
        payload = trace_protocol(protocol, **shape)
        other = payload["otherData"]
        # trace-internal exactness (the exporter asserts it too —
        # re-derived here so a weakened exporter assert can't hide)
        assert other["span_makespan_us"] == other["makespan_us"]
        for row in other["per_rank"]:
            assert row["span_end_us"] == row["clock_us"]
        # the decomposer and the exporter price the same run: same
        # makespan bit-identically, same per-rank component split
        report = decompose_protocol(protocol, **shape, verify=False)
        assert report.makespan_s * 1e6 == other["makespan_us"]
        for row, dec_row in zip(other["per_rank"], report.per_rank):
            assert row["components_us"] == dec_row["components_us"]

    def test_pod_vector_renders_the_committed_makespan(self):
        """The 2x2 4 MiB two-tier pod trace must carry the committed
        1197.3 us acceptance vector (ANALYTIC_EXPECTED_US) as its
        makespan — the exporter and the analytic expectation table
        describe the same simulator."""
        from smi_tpu_torch.analysis.perf import ANALYTIC_EXPECTED_US

        payload = trace_protocol("allreduce_pod", 4, slices=2)
        assert round(payload["otherData"]["makespan_us"], 1) == \
            ANALYTIC_EXPECTED_US["pod_allreduce_two_tier_2x2_4mib_us"]

    def test_spans_are_contiguous_and_component_labeled(self):
        payload = trace_protocol("all_reduce", 3)
        per_tid = {}
        for e in payload["traceEvents"]:
            if e["ph"] == "X":
                per_tid.setdefault(e["tid"], []).append(e)
        assert per_tid
        for tid, events in per_tid.items():
            t = 0.0
            for e in events:
                assert e["ts"] == t  # boundaries tile exactly
                t = e["ts"] + e["dur"]
                assert e["cat"] in ("alpha", "beta", "serialization",
                                    "idle")


# ---------------------------------------------------------------------------
# Serving leaves + control plane: error tails and epoch events
# ---------------------------------------------------------------------------


@pytest.mark.serving
class TestServingObservability:
    def test_metrics_snapshot_equals_campaign_bookkeeping(self):
        """The acceptance criterion: a seeded chaos-under-load cell's
        metrics snapshot must agree with the campaign gate's own
        accounting — counter for counter."""
        from smi_tpu_torch.serving.campaign import run_load_cell
        from smi_tpu_torch.serving.qos import QOS_CLASSES

        rep = run_load_cell(n=4, seed=11, duration=160, overload=2.0)
        assert rep["ok"], rep["verdict"]
        counters = rep["metrics"]["counters"]
        for qos in QOS_CLASSES:
            assert counters.get(f"admitted_total{{qos={qos}}}", 0) \
                == rep["accepted"][qos]
            assert counters.get(f"delivered_total{{qos={qos}}}", 0) \
                == rep["delivered"][qos]
            for reason, count in rep["shed"][qos].items():
                key = f"shed_total{{qos={qos},reason={reason}}}"
                assert counters.get(key, 0) == count
        # and nothing in the registry claims sheds the gate never saw
        metric_shed = sum(
            v for k, v in counters.items()
            if k.startswith("shed_total{")
        )
        assert metric_shed == sum(
            sum(rep["shed"][q].values()) for q in QOS_CLASSES
        )

    def test_snapshot_and_event_stream_deterministic_per_seed(self):
        from smi_tpu_torch.serving.campaign import run_load_cell

        a = run_load_cell(n=4, seed=5, duration=120, overload=2.0)
        b = run_load_cell(n=4, seed=5, duration=120, overload=2.0)
        assert json.dumps(a["metrics"], sort_keys=True) == \
            json.dumps(b["metrics"], sort_keys=True)
        assert a["obs"] == b["obs"]
        assert a["obs"]["dropped_events"] == (
            a["obs"]["total_events"]
            - min(a["obs"]["total_events"],
                  a["obs"]["recorder_capacity"])
        )

    def test_kill_cell_emits_control_plane_events(self):
        from smi_tpu_torch.serving.campaign import run_load_cell

        rep = run_load_cell(n=4, seed=1, duration=240, kill_rank=2,
                            kill_at=60)
        assert rep["ok"], rep["verdict"]
        counts = rep["obs"]["event_counts"]
        assert counts.get("ctl.suspect", 0) >= 1
        assert counts.get("ctl.confirm", 0) == 1
        assert counts.get("ctl.shrink", 0) == 1
        assert counts.get("serve.replay", 0) >= 1
        counters = rep["metrics"]["counters"]
        assert counters.get("epoch_bumps_total{reason=shrink}") == 1

    def test_admission_rejected_carries_the_tail(self):
        from smi_tpu_torch.serving.frontend import ServingFrontend
        from smi_tpu_torch.serving.qos import AdmissionRejected

        fe = ServingFrontend(4, seed=0, tenant_rate=0.25,
                             tenant_burst=1.0)
        fe.submit("t0", "batch", ("c0",))
        with pytest.raises(AdmissionRejected) as info:
            fe.submit("t0", "batch", ("c1",))  # bucket empty
        e = info.value
        assert e.reason == "tenant-rate"
        assert e.recorder_tail is not None
        assert e.recorder_tail["events"]
        # the tail survives the copy/pickle paths the model checker
        # and campaign reports exercise
        assert copy.copy(e).recorder_tail == e.recorder_tail
        assert pickle.loads(pickle.dumps(e)).recorder_tail \
            == e.recorder_tail


class TestControlPlaneObservability:
    def test_integrity_error_tail_at_the_serving_tier(self):
        import dataclasses as dc

        from smi_tpu_torch.parallel.credits import IntegrityError, make_frame
        from smi_tpu_torch.parallel.recovery import ProgressLog
        from smi_tpu_torch.serving.scheduler import (
            StreamState,
            WireLane,
            _InFlight,
            verify_chunk,
        )
        from smi_tpu_torch.serving.qos import Request
        from smi_tpu_torch.utils.watchdog import Deadline

        st = StreamState(
            request=Request("t0", "batch", ("payload",), 0),
            index=0, dst=1, deadline=Deadline(None),
            wal=ProgressLog(0),
        )
        frame = dc.replace(make_frame(0, 0, "payload"),
                           payload="tampered")
        item = _InFlight(ready_at=0, stream=st, seq=0, frame=frame)
        rec = FlightRecorder()
        rec.emit("serve.send", 0, rank=1, tenant="t0", qos="batch",
                 chunk=0, dst=1)
        lane = WireLane(1)
        with pytest.raises(IntegrityError) as info:
            verify_chunk(lane, item, recorder=rec)
        assert info.value.kind == "checksum"
        assert info.value.recorder_tail["events"]

    def test_watchdog_timeout_carries_the_tail(self):
        from smi_tpu_torch.utils.watchdog import Deadline, WatchdogTimeout

        rec = FlightRecorder()
        rec.emit("ctl.confirm", 0, rank=1)
        deadline = Deadline(0.0, recorder=rec)
        with pytest.raises(WatchdogTimeout) as info:
            deadline.check("probe")
        assert info.value.recorder_tail["events"]
        # with_provider keeps the recorder (the front-end swaps dump
        # providers per check without restarting the budget)
        with pytest.raises(WatchdogTimeout) as info2:
            deadline.with_provider(lambda: "dump").check("probe")
        assert info2.value.recorder_tail["events"]

    def test_membership_view_emits_epoch_events(self):
        from smi_tpu_torch.parallel.membership import MembershipView

        rec = FlightRecorder()
        view = MembershipView(4).attach_recorder(rec)
        view.confirm_dead(1)
        view.regrow(1)
        kinds = [e.kind for e in rec.events()]
        assert kinds == ["ctl.shrink", "ctl.regrow"]
        assert [e.to_json()["epoch"] for e in rec.events()] == [1, 2]

    def test_recovery_emits_recover_events(self):
        from smi_tpu_torch.parallel.recovery import run_with_recovery

        rec = FlightRecorder(capacity=4096)
        out = run_with_recovery(
            "all_reduce", 4,
            F.FaultPlan(stalled_ranks=(F.StalledRank(2, 5),)),
            recorder=rec,
        )
        assert out.recovered
        recovers = [e for e in rec.events()
                    if e.kind == "ctl.recover"]
        assert recovers, "recovery never emitted its transitions"
        fields = dict(recovers[0].fields)
        assert fields["protocol"] == "all_reduce"


# ---------------------------------------------------------------------------
# bench.py additive obs field
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# $SMI_TPU_OBS_RING, the SLO engine, span refusals, blame vocabulary
# (the cases of tests/test_slo.py that need no serving front end)
# ---------------------------------------------------------------------------


class TestRingEnvOverride:
    def test_default_unchanged_when_unset(self, monkeypatch):
        monkeypatch.delenv(OBS_RING_ENV, raising=False)
        assert ring_capacity() == DEFAULT_RECORDER_CAPACITY
        assert FlightRecorder().capacity == DEFAULT_RECORDER_CAPACITY

    def test_env_overrides_the_default(self, monkeypatch):
        monkeypatch.setenv(OBS_RING_ENV, "2048")
        assert FlightRecorder().capacity == 2048
        # ... and a caller-supplied default too (campaigns pass their
        # schedule estimate; the operator's word outranks it)
        assert ring_capacity(default=99_999) == 2048

    def test_explicit_capacity_outranks_the_env(self, monkeypatch):
        monkeypatch.setenv(OBS_RING_ENV, "2048")
        assert FlightRecorder(capacity=4).capacity == 4

    @pytest.mark.parametrize("junk", ["abc", "1.5", "0", "-3", "nan"])
    def test_malformed_is_loud_naming_the_knob(self, monkeypatch, junk):
        monkeypatch.setenv(OBS_RING_ENV, junk)
        with pytest.raises(ValueError, match="SMI_TPU_OBS_RING"):
            ring_capacity()

    def test_empty_means_unset(self, monkeypatch):
        monkeypatch.setenv(OBS_RING_ENV, "  ")
        assert ring_capacity() == DEFAULT_RECORDER_CAPACITY


# ---------------------------------------------------------------------------
# SLO engine unit behaviour
# ---------------------------------------------------------------------------


class TestSloEngine:
    def test_spec_validation_is_loud(self):
        with pytest.raises(ValueError, match="error_budget"):
            SloSpec("interactive", 10, 1.5)
        with pytest.raises(ValueError, match="latency_target"):
            SloSpec("interactive", 0, 0.1)

    def test_missing_class_is_loud(self):
        with pytest.raises(ValueError, match="missing QoS class"):
            SloEngine(specs={"interactive": DEFAULT_SLOS["interactive"]})

    def test_unknown_class_is_loud(self):
        with pytest.raises(ValueError, match="unknown QoS class"):
            SloEngine(specs={
                **DEFAULT_SLOS,
                "premium": SloSpec("premium", 100, 0.05),
            })

    def test_window_validation_is_loud(self):
        with pytest.raises(ValueError, match="short < long"):
            SloEngine(windows=(64, 32))

    def test_below_the_evidence_floor_burn_reads_zero(self):
        engine = SloEngine()
        # a handful of errors, but fewer than MIN_WINDOW_EVENTS
        # events total: one unlucky shed must not page
        for tick in range(1, 6):
            engine.observe_shed("interactive", "brownout:interactive",
                                tick)
            engine.evaluate(tick)
        health = engine.health()
        cls = health["classes"]["interactive"]
        assert cls["errors"] == 5
        assert cls["burn"]["short"] == 0.0
        assert cls["breaches"] == 0

    def test_sustained_errors_breach_then_recover(self):
        rec = FlightRecorder(capacity=4096)
        engine = SloEngine(recorder=rec)
        tick = 0
        # sustained outage: every interactive request shed, enough
        # volume to clear the floor in BOTH windows
        for _ in range(SLO_WINDOWS[1]):
            tick += 1
            for _ in range(2):
                engine.observe_shed("interactive",
                                    "backpressure:rank0", tick)
            engine.evaluate(tick)
        health = engine.health()
        cls = health["classes"]["interactive"]
        assert cls["breached"] is True
        assert cls["breaches"] == 1
        assert health["breached"] is True
        # recovery: healthy traffic until both windows drain
        for _ in range(SLO_WINDOWS[1] + 1):
            tick += 1
            for _ in range(2):
                engine.observe_delivery("interactive", 1, tick)
            engine.evaluate(tick)
        health = engine.health()
        cls = health["classes"]["interactive"]
        assert cls["breached"] is False
        assert cls["recoveries"] == 1
        kinds = [e.kind for e in rec.events()
                 if e.kind.startswith("slo.")]
        assert "slo.breach" in kinds and "slo.recover" in kinds
        # the recover event carries the breach duration
        recover = next(e for e in rec.events()
                       if e.kind == "slo.recover")
        assert dict(recover.fields)["breached_ticks"] > 0

    def test_short_burst_warns_but_does_not_breach(self):
        rec = FlightRecorder(capacity=4096)
        engine = SloEngine(recorder=rec)
        tick = 0
        # a long healthy prefix fills the LONG window with good events
        for _ in range(SLO_WINDOWS[1]):
            tick += 1
            for _ in range(3):
                engine.observe_delivery("batch", 1, tick)
            engine.evaluate(tick)
        # then one short burst of errors: the 32-tick window burns,
        # the 128-tick window (mostly healthy) does not agree
        for _ in range(8):
            tick += 1
            for _ in range(3):
                engine.observe_shed("batch", "brownout:batch", tick)
            engine.evaluate(tick)
        health = engine.health()
        cls = health["classes"]["batch"]
        assert cls["burn_warnings"] >= 1
        assert cls["breaches"] == 0
        kinds = [e.kind for e in rec.events()]
        assert "slo.burn" in kinds and "slo.breach" not in kinds

    def test_tenant_rate_sheds_are_not_slo_errors(self):
        engine = SloEngine()
        engine.observe_shed("batch", "tenant-rate", 1)
        engine.evaluate(1)
        assert engine.health()["classes"]["batch"]["errors"] == 0

    def test_late_delivery_is_a_latency_error(self):
        engine = SloEngine()
        target = DEFAULT_SLOS["batch"].latency_target_ticks
        engine.observe_delivery("batch", target + 1, 1)
        engine.observe_delivery("batch", target, 1)
        engine.evaluate(1)
        cls = engine.health()["classes"]["batch"]
        assert cls["errors"] == 1 and cls["good"] == 1
        assert cls["errors_by_reason"] == {"latency": 1}

    def test_health_snapshot_is_deterministic(self):
        def build():
            engine = SloEngine()
            for tick in range(1, 40):
                engine.observe_delivery("interactive", 2, tick)
                if tick % 3 == 0:
                    engine.observe_shed("best_effort",
                                        "brownout:best_effort", tick)
                engine.evaluate(tick)
            return json.dumps(engine.health(), sort_keys=True)

        assert build() == build()

    def test_format_health_renders_every_class(self):
        engine = SloEngine()
        engine.evaluate(1)
        text = "\n".join(format_health(engine.health()))
        for qos in QOS_CLASSES:
            assert qos in text



class TestSpanBuilderRefusals:
    def test_inconsistent_stream_is_loud(self):
        events = [
            {"kind": "serve.admit", "tick": 5, "tenant": "t0",
             "qos": "batch", "waited": 0, "stream_seq": 0},
            # a consume with no matching send: causally impossible
            {"kind": "serve.consume", "tick": 9, "tenant": "t0",
             "qos": "batch", "chunk": 0, "dst": 1, "stream_seq": 0},
        ]
        with pytest.raises(SpanError, match="no matching send"):
            build_spans(events)

    def test_walk_complete_mismatch_is_loud(self):
        events = [
            {"kind": "serve.admit", "tick": 5, "tenant": "t0",
             "qos": "batch", "waited": 0, "stream_seq": 0},
            {"kind": "serve.send", "tick": 5, "tenant": "t0",
             "qos": "batch", "chunk": 0, "dst": 1, "stream_seq": 0},
            {"kind": "serve.consume", "tick": 7, "tenant": "t0",
             "qos": "batch", "chunk": 0, "dst": 1, "stream_seq": 0},
            {"kind": "serve.complete", "tick": 11, "tenant": "t0",
             "qos": "batch", "dst": 1, "stream_seq": 0},
        ]
        with pytest.raises(SpanError, match="disagree"):
            build_spans(events)



class TestServingTraceRefusals:
    def test_protocol_traces_still_validate_at_v2(self):
        from smi_tpu_torch.obs.trace import (
            trace_protocol,
            validate_chrome_trace,
        )

        payload = trace_protocol("all_reduce", 3)
        assert payload["otherData"]["trace_kind"] == "protocol"
        validate_chrome_trace(payload)

    def test_trace_serving_rejects_non_span_input(self):
        from smi_tpu_torch.obs.trace import trace_serving

        with pytest.raises(TypeError, match="SpanReport"):
            trace_serving({"not": "a span report"})



class TestBlameVerdict:
    @pytest.mark.parametrize("resource,kind,rank", [
        ("none", "none", None),
        ("wire", "wire", None),
        ("consumer", "consumer", None),
        ("replay", "replay", None),
        ("failover", "failover", None),
        ("wire:rank3", "wire", 3),
        ("consumer:rank0", "consumer", 0),
        ("failover:rank11", "failover", 11),
    ])
    def test_parse_round_trips_the_vocabulary(self, resource, kind,
                                              rank):
        v = parse_blame_resource(resource)
        assert (v.kind, v.rank) == (kind, rank)
        assert v.resource == resource

    @pytest.mark.parametrize("bad", [
        "wires", "wire:", "wire:rank", "wire:rankX", "wire:3",
        "replay:rank1", "none:rank0", "wire:rank-2", "", "rank3",
    ])
    def test_malformed_resource_is_loud(self, bad):
        with pytest.raises(ValueError) as e:
            parse_blame_resource(bad)
        assert repr(bad) in str(e.value)


    def test_accessor_rejects_non_blame_dicts(self):
        with pytest.raises(ValueError):
            blame_verdict({"verdict": "wire:rank1"})
        with pytest.raises(ValueError):
            blame_verdict("wire:rank1")  # type: ignore[arg-type]



# ---------------------------------------------------------------------------
# Parity with the JAX package: the same seeds, the same bytes
# ---------------------------------------------------------------------------


def _canon(payload) -> str:
    return json.dumps(payload, sort_keys=True, default=str)


def test_event_schema_and_knobs_are_the_jax_package_s():
    from smi_tpu.obs import events as JE
    from smi_tpu.obs import slo as JS
    from smi_tpu.obs import spans as JSP

    assert EVENT_KINDS == JE.EVENT_KINDS
    assert (DEFAULT_RECORDER_CAPACITY, DEFAULT_TAIL_EVENTS, OBS_RING_ENV) \
        == (JE.DEFAULT_RECORDER_CAPACITY, JE.DEFAULT_TAIL_EVENTS,
            JE.OBS_RING_ENV)
    assert (BREACH_BURN, MIN_WINDOW_EVENTS, SLO_WINDOWS) == \
        (JS.BREACH_BURN, JS.MIN_WINDOW_EVENTS, JS.SLO_WINDOWS)
    assert {k: v.to_json() for k, v in DEFAULT_SLOS.items()} == \
        {k: v.to_json() for k, v in JS.DEFAULT_SLOS.items()}
    from smi_tpu_torch.obs import spans as SP

    assert SP.COMPONENTS == JSP.COMPONENTS
    assert SP.DELIVERY_COMPONENTS == JSP.DELIVERY_COMPONENTS


@pytest.mark.parametrize("case", GRID, ids=_grid_id)
def test_trace_file_is_byte_identical_to_the_jax_package_s(case):
    """The Perfetto export of every registered protocol at every
    default shape: the same bytes from both packages."""
    from smi_tpu.obs import trace as JT

    protocol, shape = case
    ours = trace_to_json_bytes(trace_protocol(protocol, **shape))
    theirs = JT.trace_to_json_bytes(JT.trace_protocol(protocol, **shape))
    assert ours == theirs


def test_trace_all_names_equal_the_jax_package_s():
    from smi_tpu.obs import trace as JT

    assert [trace_name(t) for t in trace_all()] == \
        [JT.trace_name(t) for t in JT.trace_all()]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("protocol,n", [("all_reduce", 4),
                                        ("all_gather", 3)])
def test_simulator_event_stream_equals_the_jax_package_s(protocol, n, seed):
    """The credit simulator's recorded stream under the same seed: the
    same events, snapshot and tail."""
    from smi_tpu.obs.events import FlightRecorder as JFlightRecorder
    from smi_tpu.parallel import credits as JC

    ours, theirs = FlightRecorder(capacity=64), JFlightRecorder(capacity=64)
    getattr(C, f"simulate_{protocol}")(n, C.Strategy(seed), recorder=ours)
    getattr(JC, f"simulate_{protocol}")(n, JC.Strategy(seed),
                                        recorder=theirs)
    assert _canon(ours.snapshot()) == _canon(theirs.snapshot())
    assert _canon(ours.tail()) == _canon(theirs.tail())
    assert format_tail(ours.tail()) == format_tail(theirs.tail())


def test_deadlock_dump_with_tail_equals_the_jax_package_s():
    from smi_tpu.obs.events import FlightRecorder as JFlightRecorder
    from smi_tpu.parallel import credits as JC
    from smi_tpu.parallel import faults as JF

    def dump(c, f, rec):
        with pytest.raises(c.DeadlockError) as e:
            c.simulate_all_reduce(
                4, c.Strategy(3), recorder=rec,
                faults=f.FaultPlan.single(f.StalledRank(2, after=4)))
        return e.value

    ours = dump(C, F, FlightRecorder())
    theirs = dump(JC, JF, JFlightRecorder())
    assert _canon(ours.recorder_tail) == _canon(theirs.recorder_tail)
    assert repr(ours.state) == repr(theirs.state)
    assert str(ours) == str(theirs)


def _feed_metrics(metrics_mod, seed):
    """One seeded stream of registry updates and sink samples."""
    import random

    rng = random.Random(seed)
    reg = metrics_mod.MetricsRegistry()
    sink = metrics_mod.SampleSink()
    for i in range(200):
        tenant = f"t{rng.randrange(3)}"
        qos = rng.choice(sorted(QOS_CLASSES))
        reg.counter("serve.admitted", tenant=tenant, qos=qos).inc()
        reg.gauge("wire.credits", rank=rng.randrange(4)).set(
            rng.randrange(8))
        reg.histogram("serve.latency", qos=qos).observe(
            rng.randrange(1, 400))
        sink.record(rng.choice(("all_reduce", "all_to_all")),
                    rng.random() * 1e-3,
                    payload_bytes=rng.choice((None, 1024.0, 3000.0,
                                              1 << 22)),
                    tenant=rng.choice((None, tenant)))
    return reg.snapshot(), sink.snapshot()


@pytest.mark.parametrize("seed", [0, 5])
def test_metrics_snapshots_equal_the_jax_package_s(seed):
    from smi_tpu.obs import metrics as JM
    from smi_tpu_torch.obs import metrics as M

    assert _canon(_feed_metrics(M, seed)) == _canon(_feed_metrics(JM, seed))
    for size in (None, 0, 1, 1000, 4096, 4097, 1 << 30):
        assert payload_bucket(size) == JM.payload_bucket(size)


def _feed_slo(slo_mod, seed):
    """One seeded stream of deliveries and sheds through an engine."""
    import random

    rng = random.Random(seed)
    engine = slo_mod.SloEngine()
    classes = sorted(QOS_CLASSES)
    for tick in range(1, 400):
        for _ in range(rng.randrange(4)):
            qos = rng.choice(classes)
            if rng.random() < (0.4 if 150 < tick < 250 else 0.05):
                engine.observe_shed(qos, rng.choice(
                    ("brownout:" + qos, "deadline", "tenant-rate")), tick)
            else:
                engine.observe_delivery(qos, rng.randrange(1, 120), tick)
        engine.evaluate(tick)
    return engine.health(), slo_mod.format_health(engine.health())


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_slo_health_equals_the_jax_package_s(seed):
    from smi_tpu.obs import slo as JS
    from smi_tpu_torch.obs import slo as S

    ours, theirs = _feed_slo(S, seed), _feed_slo(JS, seed)
    assert _canon(ours[0]) == _canon(theirs[0])
    assert ours[1] == theirs[1]


@pytest.mark.parametrize("cell", [
    dict(seed=3, duration=120, overload=1.0),
    dict(seed=0, duration=160, overload=2.0),
    dict(seed=1, duration=240, overload=1.0, stall_rank=1, stall_at=40,
         stall_ticks=60),
    dict(seed=0, duration=240, overload=1.0, kill_rank=2, kill_at=60),
], ids=["steady", "overload", "stall", "kill"])
def test_spans_and_blame_of_one_recorded_run_equal_the_jax_package_s(cell):
    """The same serving run, recorded by each package's own front end:
    the two event snapshots equal, and the span trees and blame report
    each package builds from its own snapshot equal tree for tree."""
    from smi_tpu.obs import spans as JSP
    from smi_tpu.serving.campaign import run_load_cell as jax_run_load_cell
    from smi_tpu_torch.obs import spans as SP
    from smi_tpu_torch.serving.campaign import run_load_cell

    _rep, fe = run_load_cell(n=4, return_frontend=True, **cell)
    _jrep, jfe = jax_run_load_cell(n=4, return_frontend=True, **cell)
    snap = json.loads(json.dumps(fe.recorder.snapshot()))
    jsnap = json.loads(json.dumps(jfe.recorder.snapshot()))
    assert _canon(snap) == _canon(jsnap)
    ours, theirs = SP.build_spans(snap), JSP.build_spans(jsnap)
    assert list(ours.requests) == list(theirs.requests)
    for key in ours.requests:
        assert _canon(ours.requests[key].to_json()) == \
            _canon(theirs.requests[key].to_json())
    assert _canon(ours.digest()) == _canon(theirs.digest())
    ours_blame = SP.blame_report(ours)
    assert _canon(ours_blame) == _canon(JSP.blame_report(theirs))
    assert SP.format_blame(ours_blame) == \
        JSP.format_blame(JSP.blame_report(theirs))
