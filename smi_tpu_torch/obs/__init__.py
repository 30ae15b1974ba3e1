"""Unified observability: flight recorder, metrics, Perfetto export.

The port's copy of :mod:`smi_tpu.obs` (pure Python).

One structured event schema spans every step-clock machine in the
stack — the credits simulator's primitives, the serving front-end's
request lifecycle, and the membership/recovery control plane — feeding
three consumers:

- the always-on bounded **flight recorder**
  (:class:`~smi_tpu_torch.obs.events.FlightRecorder`), whose tail rides
  every ``DeadlockError`` / ``WatchdogTimeout`` / ``IntegrityError`` /
  ``AdmissionRejected`` so a failure names its causal history;
- the **metrics registry**
  (:class:`~smi_tpu_torch.obs.metrics.MetricsRegistry`) with deterministic
  JSON snapshots wired into campaign reports, ``serve --selftest
  --metrics``, and the bench ``obs`` field — plus the
  :class:`~smi_tpu_torch.obs.metrics.SampleSink` timing substrate ROADMAP's
  online-autotuning arc consumes;
- the **Perfetto/Chrome-trace exporter**
  (:func:`~smi_tpu_torch.obs.trace.trace_protocol`), rendering per-rank
  tracks from the timestamped simulator with every span attributed by
  the PR 11 decomposer and span sums asserted bit-identical to
  ``RingSimulator.elapsed_seconds()`` — ``smi-tpu trace`` is the CLI
  surface.

The r15 layer *interprets* the record:

- the **span builder** (:mod:`smi_tpu_torch.obs.spans`) assembles a causal
  span tree per serving request — component sums asserted
  bit-identical to the front-end's measured latencies — and the
  **tail-latency blame** verdict names the binding resource of the
  slowest decile per (tenant, qos);
- the **SLO engine** (:mod:`smi_tpu_torch.obs.slo`) evaluates declarative
  per-class latency/error-budget specs as multi-window burn rates on
  the step clock (``slo.burn``/``slo.breach``/``slo.recover``), the
  continuous health signal riding every campaign report —
  ``smi-tpu health`` and ``smi-tpu trace --serve`` are the CLI
  surfaces.

Everything is seeded-deterministic: same seed, byte-identical event
stream, metrics snapshot, and trace file. docs/observability.md holds
the schema table, metric catalog, span taxonomy, and SLO table
(drift-guarded).
"""

from smi_tpu_torch.obs.events import (
    DEFAULT_RECORDER_CAPACITY,
    DEFAULT_TAIL_EVENTS,
    EVENT_KINDS,
    OBS_RING_ENV,
    Event,
    FlightRecorder,
    attach_tail,
    format_tail,
    ring_capacity,
)
from smi_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SampleSink,
    payload_bucket,
)
# import order matters below: slo and spans are imported by the
# serving tier, which is itself imported mid-init here (via trace ->
# analysis.model) — they must be fully loaded before trace runs, and
# neither may import serving at module level
from smi_tpu_torch.obs.slo import (
    DEFAULT_SLOS,
    SLO_WINDOWS,
    SloEngine,
    SloSpec,
    format_health,
)
from smi_tpu_torch.obs.spans import (
    BLAME_DECILE,
    COMPONENTS,
    DELIVERY_COMPONENTS,
    RequestTree,
    Span,
    SpanError,
    SpanReport,
    blame_report,
    build_spans,
    campaign_fields,
    exactness_problems,
    format_blame,
    frontend_spans,
)
from smi_tpu_torch.obs.trace import (
    TRACE_SCHEMA_VERSION,
    trace_all,
    trace_name,
    trace_protocol,
    trace_serving,
    trace_to_json_bytes,
    validate_chrome_trace,
)

__all__ = [
    "BLAME_DECILE",
    "COMPONENTS",
    "Counter",
    "DEFAULT_RECORDER_CAPACITY",
    "DEFAULT_SLOS",
    "DEFAULT_TAIL_EVENTS",
    "DELIVERY_COMPONENTS",
    "EVENT_KINDS",
    "Event",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "OBS_RING_ENV",
    "RequestTree",
    "SLO_WINDOWS",
    "SampleSink",
    "SloEngine",
    "SloSpec",
    "Span",
    "SpanError",
    "SpanReport",
    "TRACE_SCHEMA_VERSION",
    "attach_tail",
    "blame_report",
    "build_spans",
    "campaign_fields",
    "exactness_problems",
    "format_blame",
    "format_health",
    "format_tail",
    "frontend_spans",
    "payload_bucket",
    "ring_capacity",
    "trace_all",
    "trace_name",
    "trace_protocol",
    "trace_serving",
    "trace_to_json_bytes",
    "validate_chrome_trace",
]
