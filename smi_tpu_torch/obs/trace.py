"""Perfetto/Chrome-trace export of the timestamped simulator.

The port's copy of :mod:`smi_tpu.obs.trace`, kept in step with it
line for line: the same protocol gives a byte-identical trace file.

The PR 6 cost-model simulator prices a protocol run; the PR 11
decomposer attributes every clock advance to alpha / beta /
serialization / idle. This module renders that attribution as a
Chrome-trace-event JSON (the format Perfetto and ``chrome://tracing``
both open): one track per rank, one complete span per attributed
component interval, each span's ``args`` naming the producing event
the decomposer blamed.

Exactness contract (asserted at export time, pinned by
``tests/test_obs.py``):

- a rank's spans **tile** ``[0, clock[rank]]`` — consecutive span
  boundaries are the simulator's own float timestamps, so the last
  span's end is the rank's clock *bit-identically* (no duration
  arithmetic, no rounding on the checked path);
- the max over ranks is therefore bit-identical to
  ``RingSimulator.elapsed_seconds()``;
- every span's component label comes from the decomposer's
  classification (:class:`smi_tpu_torch.analysis.perf._TimedReplay` — the
  same ``_book`` calls that build ``lint --perf``'s report), so the
  trace and the static report can never tell different stories about
  the same run.

Determinism: the replay is deterministic per (protocol, shape,
payload, seed); :func:`trace_to_json_bytes` serializes with sorted
keys — same seed, byte-identical file.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from smi_tpu_torch.analysis import perf as P
from smi_tpu_torch.analysis.verifier import (
    DEFAULT_SHAPES,
    AnalysisError,
    build_generators,
    verify_generators,
)
from smi_tpu_torch.parallel import credits as C

#: Pinned Chrome-trace schema version for this exporter's payloads —
#: bumped on any shape change; :func:`validate_chrome_trace` and the
#: tests check it. v2 (r15): payloads carry ``trace_kind`` —
#: ``protocol`` (the simulator decomposition, unchanged) or
#: ``serving`` (request span trees on per-tenant track groups).
TRACE_SCHEMA_VERSION = 2

#: Chronological order of a jump's components inside its wait window:
#: idle is time before the producer even issued, then the latency
#: window (serialization for control signals, alpha for data), then
#: the bandwidth window.
_COMPONENT_ORDER = {"idle": 0, "serialization": 1, "alpha": 1, "beta": 2}


class _TraceReplay(P._TimedReplay):
    """The decomposer's replay plus per-jump span capture.

    The base class books each jump's split through ``_book`` (alpha /
    beta / idle for a DMA wait, serialization / idle for a signal
    wait); this subclass groups those calls per ``_classify`` and lays
    them out chronologically inside the jump's ``[before, after]``
    window, forcing the final boundary to ``after`` exactly — which is
    what makes span tiling bit-identical to the rank clocks.
    """

    def __init__(self, generators, strategy, costs):
        #: rank -> [{"t0", "t1", "component", "tier", ...}] in time order
        self.spans: Dict[int, List[dict]] = {}
        self._jump_parts: Optional[List[Tuple[str, str, float]]] = None
        super().__init__(generators, strategy, costs)

    def _book(self, r, tier, component, s):
        if self._jump_parts is not None:
            self._jump_parts.append((tier, component, s))
        super()._book(r, tier, component, s)

    def _classify(self, r, step, action, before, after):
        self._jump_parts = []
        try:
            super()._classify(r, step, action, before, after)
        finally:
            parts, self._jump_parts = self._jump_parts, None
        parts = [p for p in parts if p[2] > 0.0]
        parts.sort(key=lambda p: _COMPONENT_ORDER[p[1]])
        jump = self._last_jump.get(r)
        spans = self.spans.setdefault(r, [])
        t = before
        for i, (tier, component, s) in enumerate(parts):
            # interior boundaries accumulate; the LAST boundary is the
            # simulator's own post-wait clock — the tiling invariant
            end = after if i == len(parts) - 1 else t + s
            span = {
                "t0": t, "t1": end, "component": component,
                "tier": tier,
            }
            if jump is not None:
                span["producer"] = str(jump["producer"])
                span["waiter"] = str(jump["waiter"])
                span["lane"] = list(jump["lane"])
            spans.append(span)
            t = end

    def rank_span_end(self, r: int) -> float:
        """The rank's last span boundary (0.0 when it never waited on
        a priced event) — asserted ``== clock[r]`` bit-identically."""
        spans = self.spans.get(r)
        return spans[-1]["t1"] if spans else 0.0


def trace_protocol(
    protocol: str, n: int, chunks: int = 3, slices: int = 2,
    payload_bytes: float = float(P.PERF_PAYLOAD_BYTES), seed: int = 0,
    verify: bool = True,
) -> dict:
    """Export one registered protocol instance as a Chrome-trace JSON.

    Mirrors :func:`smi_tpu_torch.analysis.perf.decompose_protocol`'s shape
    and pricing conventions exactly (same ``_costs_for``, same
    verifier pre-pass) and asserts the span-tiling contract before
    returning — a payload this function returns has already proven
    its span sums against ``elapsed_seconds()``.
    """
    shape: Dict[str, int] = {"n": n}
    if protocol in ("neighbour_stream", "all_reduce_chunked"):
        shape["chunks"] = chunks
    if protocol in ("allreduce_pod", "all_to_all_pod",
                    "all_reduce_quantized"):
        shape["slices"] = slices
    if verify:
        safety = verify_generators(
            lambda: build_generators(protocol, n, chunks=chunks,
                                     slices=slices),
            protocol=protocol, shape=shape,
        )
        if not safety.ok:
            raise AnalysisError(
                f"{protocol}: cannot trace an unsafe protocol — the "
                f"static verifier found: "
                + "; ".join(f.check for f in safety.findings)
            )
    costs, message, _pipeline = P._costs_for(protocol, shape,
                                             payload_bytes)
    replay = _TraceReplay(
        build_generators(protocol, n, chunks=chunks, slices=slices),
        C.Strategy(seed), costs,
    )
    replay.run()
    makespan = replay.elapsed_seconds()

    # -- the exactness contract, asserted at the source ----------------
    for r in range(replay.n):
        end = replay.rank_span_end(r)
        if end != replay.clock[r]:
            raise AnalysisError(
                f"{protocol} rank {r}: span tiling ends at {end!r} but "
                f"the simulator clock reads {replay.clock[r]!r} — the "
                f"exporter and the simulator disagree about the same "
                f"run"
            )
    span_makespan = max(
        (replay.rank_span_end(r) for r in range(replay.n)), default=0.0
    )
    if span_makespan != makespan:
        raise AnalysisError(
            f"{protocol}: max span end {span_makespan!r} != "
            f"elapsed_seconds() {makespan!r}"
        )

    events: List[dict] = [{
        "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
        "args": {"name": f"smi_tpu {protocol}"},
    }]
    for r in range(replay.n):
        events.append({
            "ph": "M", "pid": 0, "tid": r, "name": "thread_name",
            "args": {"name": f"rank {r}"},
        })
    per_rank: List[dict] = []
    for r in range(replay.n):
        components = {
            tier: {k: round(v * 1e6, 6) for k, v in comps.items()}
            for (rank, tier), comps in replay._parts.items()
            if rank == r
        }
        per_rank.append({
            "rank": r,
            "clock_us": replay.clock[r] * 1e6,
            "span_end_us": replay.rank_span_end(r) * 1e6,
            "spans": len(replay.spans.get(r, ())),
            "components_us": components,
        })
        for span in replay.spans.get(r, ()):
            args = {
                "tier": span["tier"],
                "component": span["component"],
            }
            for key in ("producer", "waiter", "lane"):
                if key in span:
                    args[key] = span[key]
            events.append({
                "ph": "X", "pid": 0, "tid": r,
                "name": f"{span['component']} ({span['tier']})",
                "cat": span["component"],
                "ts": span["t0"] * 1e6,
                "dur": (span["t1"] - span["t0"]) * 1e6,
                "args": args,
            })
    return {
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "otherData": {
            "schema_version": TRACE_SCHEMA_VERSION,
            "trace_kind": "protocol",
            "protocol": protocol,
            "shape": dict(shape),
            "ranks": replay.n,
            "seed": seed,
            "payload_bytes": payload_bytes,
            "message_bytes": message,
            "makespan_us": makespan * 1e6,
            "span_makespan_us": span_makespan * 1e6,
            "per_rank": per_rank,
        },
    }


def trace_all(
    protocols: Optional[Sequence[str]] = None,
    payload_bytes: float = float(P.PERF_PAYLOAD_BYTES),
    seed: int = 0,
    verify: bool = True,
) -> List[dict]:
    """Trace every registered protocol (or the named subset) over the
    verifier's DEFAULT_SHAPES grid — the ``smi-tpu trace`` engine."""
    known = list(DEFAULT_SHAPES)
    if protocols is None:
        protocols = known
    else:
        unknown = [p for p in protocols if p not in known]
        if unknown:
            raise ValueError(
                f"unknown protocol(s) {unknown}; known: {known}"
            )
    out = []
    for protocol in protocols:
        for shape in DEFAULT_SHAPES[protocol]:
            out.append(trace_protocol(
                protocol, payload_bytes=payload_bytes, seed=seed,
                verify=verify, **shape
            ))
    return out


def trace_name(payload: dict) -> str:
    """Deterministic file stem for one trace payload:
    ``<protocol>_n<k>[_chunks<c>][_slices<s>]`` for protocol traces,
    ``serve_<label>_seed<s>`` for serving traces."""
    other = payload["otherData"]
    if other.get("trace_kind") == "serving":
        return f"serve_{other['label']}_seed{other['seed']}"
    shape = other["shape"]
    stem = f"{other['protocol']}_n{shape['n']}"
    for key in ("chunks", "slices"):
        if key in shape:
            stem += f"_{key}{shape[key]}"
    return stem


def trace_serving(span_report, seed: int = 0,
                  label: str = "selftest") -> dict:
    """Render a serving run's request span trees as a Chrome trace.

    Per-tenant track groups: each tenant is one Chrome-trace
    *process* (``pid``), each of its requests one *thread* (``tid`` =
    the per-tenant stream sequence), so Perfetto renders a serving
    run as grouped request spans rather than simulator primitives.
    Component spans carry their component as ``cat``; annotation
    spans (parks, sheds, retune-quiesce windows) carry
    ``annotation``. Timestamps are step-clock ticks rendered as
    microseconds — a logical clock, honestly labeled in ``otherData``.
    Deterministic: same seed, byte-identical file through
    :func:`trace_to_json_bytes`.
    """
    from smi_tpu_torch.obs.spans import COMPONENTS, SpanReport

    if not isinstance(span_report, SpanReport):
        raise TypeError(
            f"trace_serving takes a SpanReport (build_spans' "
            f"output), got {type(span_report).__name__}"
        )
    tenants = sorted({t.tenant for t in span_report.requests.values()})
    pid_of = {tenant: i for i, tenant in enumerate(tenants)}
    events: List[dict] = []
    for tenant in tenants:
        events.append({
            "ph": "M", "pid": pid_of[tenant], "tid": 0,
            "name": "process_name",
            "args": {"name": f"tenant {tenant}"},
        })
    components_ticks = {c: 0 for c in COMPONENTS}
    makespan = 0
    delivered = shed = 0
    for key in sorted(span_report.requests):
        tree = span_report.requests[key]
        pid = pid_of[tree.tenant]
        if tree.completed is not None:
            delivered += 1
        elif tree.shed_reason is not None:
            shed += 1
        events.append({
            "ph": "M", "pid": pid, "tid": tree.seq,
            "name": "thread_name",
            "args": {"name": f"s{tree.seq} ({tree.qos}) "
                             f"{tree.outcome}"},
        })
        for span in tree.spans:
            cat = (span.component if span.kind == "component"
                   else "annotation")
            if span.kind == "component":
                components_ticks[span.component] += span.duration
            args = {"tenant": tree.tenant, "seq": tree.seq,
                    "qos": tree.qos, "kind": span.kind}
            args.update(span.detail)
            events.append({
                "ph": "X", "pid": pid, "tid": tree.seq,
                "name": span.component, "cat": cat,
                "ts": float(span.t0), "dur": float(span.duration),
                "args": args,
            })
            makespan = max(makespan, span.t1)
    return {
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "otherData": {
            "schema_version": TRACE_SCHEMA_VERSION,
            "trace_kind": "serving",
            "label": label,
            "seed": seed,
            "time_unit": "step-clock ticks (rendered as us)",
            "tenants": len(tenants),
            "requests": len(span_report.requests),
            "delivered": delivered,
            "shed": shed,
            "makespan_ticks": makespan,
            "components_ticks": {
                c: components_ticks[c] for c in COMPONENTS
                if components_ticks[c]
            },
            "total_events": span_report.total_events,
            "dropped_events": span_report.dropped_events,
        },
    }


def trace_to_json_bytes(payload: dict) -> bytes:
    """Deterministic serialization: sorted keys, fixed separators,
    trailing newline — same seed, byte-identical file (the
    determinism claim the tests pin)."""
    import json

    return (json.dumps(payload, sort_keys=True,
                       separators=(",", ": "), indent=1) + "\n").encode()


def validate_chrome_trace(payload: dict) -> None:
    """Pinned structural validation of an exported payload — the
    schema the tests (and any downstream consumer) can rely on.
    Raises ``ValueError`` naming the first violation."""
    if not isinstance(payload, dict):
        raise ValueError(f"trace payload must be a dict, got "
                         f"{type(payload).__name__}")
    for key in ("displayTimeUnit", "traceEvents", "otherData"):
        if key not in payload:
            raise ValueError(f"trace payload missing {key!r}")
    other = payload["otherData"]
    if other.get("schema_version") != TRACE_SCHEMA_VERSION:
        raise ValueError(
            f"trace schema_version {other.get('schema_version')!r} != "
            f"pinned {TRACE_SCHEMA_VERSION}"
        )
    kind = other.get("trace_kind", "protocol")
    if kind == "serving":
        from smi_tpu_torch.obs.spans import COMPONENTS

        for key in ("label", "seed", "tenants", "requests",
                    "makespan_ticks", "components_ticks",
                    "dropped_events"):
            if key not in other:
                raise ValueError(f"otherData missing {key!r}")
        allowed_cats = tuple(COMPONENTS) + ("annotation",)
    elif kind == "protocol":
        for key in ("protocol", "shape", "ranks", "seed",
                    "makespan_us", "span_makespan_us", "per_rank"):
            if key not in other:
                raise ValueError(f"otherData missing {key!r}")
        allowed_cats = ("alpha", "beta", "serialization", "idle")
    else:
        raise ValueError(f"unknown trace_kind {kind!r}")
    events = payload["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph not in ("M", "X"):
            raise ValueError(f"traceEvents[{i}] has unknown ph {ph!r}")
        for key in ("pid", "tid", "name"):
            if key not in e:
                raise ValueError(f"traceEvents[{i}] missing {key!r}")
        if ph == "X":
            for key in ("ts", "dur", "cat", "args"):
                if key not in e:
                    raise ValueError(
                        f"traceEvents[{i}] (complete span) missing "
                        f"{key!r}"
                    )
            if e["dur"] < 0:
                raise ValueError(f"traceEvents[{i}] has negative dur")
            if e["cat"] not in allowed_cats:
                raise ValueError(
                    f"traceEvents[{i}] has unknown component "
                    f"{e['cat']!r}"
                )
