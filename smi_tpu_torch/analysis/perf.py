"""Static performance analyzer: critical-path decomposition + roofline lint.

The port's copy of :mod:`smi_tpu.analysis.perf`, kept in step with it
line for line. ``serialized_dma_findings`` parses XLA HLO text a user
hands it (a JAX program's dump) through the port's copy of the text
parser, :mod:`smi_tpu_torch.parallel.traffic`. The flash-tile checks and :data:`ANALYTIC_EXPECTED_US` price through the
port's :mod:`smi_tpu_torch.tuning.cost_model`, which keeps the JAX
package's model prices for the TPU v5e (VMEM frame, HBM rate, link
rates): they are the model's numbers for that chip, never times of an
H100, and they are kept so that the port answers as the JAX package
does.

The third analysis tier. PR 7's verifier and PR 10's model checker
prove *safety* — nothing in the repo could say why a slow protocol or
kernel is slow. This module closes that gap with two sub-tiers, both
pure Python (no JAX, no devices), both priced the way Hockney's
alpha-beta model prices a message (``T(m) = alpha + m/beta``,
PAPERS.md) and both subordinate to measurement per ATLAS: the analyzer
*names bottlenecks and catches drift*; the plan cache's measured
entries keep the last word on every knob.

Sub-tier (a): critical-path decomposition over protocols
--------------------------------------------------------
Reuses PR 7's single symbolic replay (the safety precondition — a
protocol must verify clean before a makespan means anything) and runs
the PR 6 timestamped simulator (``RingSimulator(costs=TierCostModel)``)
once under the canonical deterministic schedule, with instrumentation
that attributes every clock advance. A rank's clock only moves at
waits, and every jump is split against the *producing* event's window:

- **alpha** — the portion inside an inbound DMA's per-message latency
  window (the Hockney alpha of the data tier);
- **beta** — the portion inside its bandwidth window (bytes/beta);
- **serialization** — the portion inside a control signal's latency
  window (credit grants, barriers — the flow-control handshake cost);
- **idle** — the remainder: time the rank sat blocked *before the
  producing event was even issued*. Idle is genuine upstream lateness;
  on the healthy registered protocols it is exactly zero, which is
  what makes the `idle-fraction` rule a sharp detector.

The components sum to each rank's clock by construction, the makespan
is ``max`` of the rank clocks — **bit-identical to
``RingSimulator.elapsed_seconds()``**, because the decomposition runs
the same simulator on the same schedule (the 4894.3 us flat vs
1197.3 us two-tier pod numbers are test vectors). The timestamps are
schedule-independent for this zoo (single-producer time lanes push
monotonically; the only multi-producer domain is the symmetric
barrier, consumed whole), so the canonical schedule prices every
schedule.

Sub-tier (b): HLO/kernel roofline lint
---------------------------------------
``traffic_lint``-style rules fed by ``aot.cost_facts()``-shaped facts
and :mod:`smi_tpu_torch.tuning.cost_model`:

- ``no-double-buffer`` — a kernel tile whose single-buffer VMEM
  footprint exceeds :data:`VMEM_DOUBLE_BUFFER_BOUND`
  (``VMEM_LIMIT_BYTES / 2``): the HBM->VMEM pipeline cannot
  double-buffer, so every tile load serializes against compute.
- ``below-roofline-tile`` — a tile choice whose forced HBM traffic
  (k/v re-read once per q-tile pass) pushes its achievable fraction of
  the ideal ``kernel_roofline_us`` under
  :data:`BELOW_ROOFLINE_FRACTION`.
- ``serialized-dma`` — an async collective pair that moved with ZERO
  compute scheduled in its flight window while being part of a
  dependent collective chain (extends ``overlap_report``'s new
  ``depends_on_collective`` column).
- ``analytic-regression`` — a statically predicted cost drifted more
  than :data:`ANALYTIC_DRIFT_FRACTION` *worse* than the committed
  expectation for the same knobs (:data:`ANALYTIC_EXPECTED_US`, the
  plan-cache/PERF.json discipline applied to the model itself).

Scope: fault-free schedules only (same honesty clause as the
verifier), and analytic throughout — a finding is a *named hypothesis*
about where the time goes; the measured sweep (``smi-tpu tune``)
outranks it on any knob it has measured. ``docs/analysis.md`` states
the full does/does-not-prove table; ``tests/test_perf_docs.py`` pins
every threshold here against its cost-model mirror.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.tuning import cost_model as cm

from smi_tpu_torch.analysis.verifier import (
    DEFAULT_SHAPES,
    AnalysisError,
    VerifyEvent,
    _describe,
    build_generators,
    verify_generators,
)

#: Decomposition-tier rules (sub-tier a) — documented one-for-one in
#: docs/analysis.md (drift-guarded by tests/test_perf_docs).
PERF_PROTOCOL_CHECKS = ("idle-fraction", "serialized-critical-path")

#: Roofline-lint rules (sub-tier b), same documentation discipline.
PERF_LINT_CHECKS = ("no-double-buffer", "below-roofline-tile",
                    "serialized-dma", "analytic-regression")

PERF_CHECKS = PERF_PROTOCOL_CHECKS + PERF_LINT_CHECKS

#: A rank genuinely blocked (upstream had not even issued the awaited
#: event) for more than this fraction of the makespan is a finding.
#: Healthy registered protocols measure exactly 0.0 here — every wait
#: lands inside its producer's latency/bandwidth window — so the
#: threshold's only job is absorbing float dust and tiny topologies.
IDLE_FRACTION_THRESHOLD = 0.05

#: Single-buffer VMEM footprint above which a kernel tile cannot
#: double-buffer the HBM->VMEM pipeline inside the Mosaic scoped-VMEM
#: frame. MUST equal ``cost_model.VMEM_LIMIT_BYTES // 2``
#: (drift-guarded by tests/test_perf_docs).
VMEM_DOUBLE_BUFFER_BOUND = cm.VMEM_LIMIT_BYTES // 2

#: Minimum achievable fraction of the ideal kernel roofline a tile
#: choice may cost before ``below-roofline-tile`` fires.
BELOW_ROOFLINE_FRACTION = 0.5

#: ``analytic-regression`` fires when a recomputed static prediction is
#: more than this fraction WORSE than its committed expectation.
ANALYTIC_DRIFT_FRACTION = 0.25

#: Float-dust floor for the idle component (seconds): a jump's idle
#: part is ``delta - alpha - beta`` and can carry 1-ulp subtraction
#: residue; anything below a picosecond — seven orders of magnitude
#: under the smallest real alpha — is arithmetic, not lateness.
IDLE_DUST_S = 1e-12

#: Total collective payload each protocol instance is priced at; the
#: per-message granularity follows the protocol (full payload for the
#: circulating rings, ``payload/chunks`` for the pipelined ring,
#: ``payload/per_slice`` for every pod phase — the
#: ``pod_wallclock_comparison`` convention).
PERF_PAYLOAD_BYTES = 4 << 20

#: Canonical flash shape the roofline-lint rules price tiles at
#: (sequence length, head dim — the PERF.json S=8192 d=128 surface).
FLASH_CANONICAL_S = 8192
FLASH_CANONICAL_D = 128


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PerfFinding:
    """One performance defect (or drift), named the way the verifier
    names safety findings: ``events`` carries (rank, step, primitive)
    coordinates where they exist; the structured fields let tests
    convict mutants without string parsing."""

    check: str
    message: str
    events: Tuple[VerifyEvent, ...] = ()
    rank: Optional[int] = None
    lane: Optional[Tuple[int, int]] = None
    tier: Optional[str] = None
    fraction: Optional[float] = None
    expected: Optional[object] = None
    got: Optional[object] = None

    def to_json(self) -> dict:
        out = {
            "check": self.check,
            "message": self.message,
            "events": [e.to_json() for e in self.events],
        }
        for key in ("rank", "tier", "fraction"):
            if getattr(self, key) is not None:
                out[key] = getattr(self, key)
        if self.lane is not None:
            out["lane"] = list(self.lane)
        if self.expected is not None:
            out["expected"] = str(self.expected)
        if self.got is not None:
            out["got"] = str(self.got)
        return out

    def __str__(self) -> str:
        lines = [f"[{self.check}] {self.message}"]
        lines.extend(f"    at {e}" for e in self.events)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Timed replay: the instrumented PR 6 simulator
# ---------------------------------------------------------------------------


class _TimedReplay(C.RingSimulator):
    """One deterministic run of the timestamped simulator with every
    clock advance attributed to its producing event.

    The base simulator's arithmetic is untouched (every ``super()``
    call runs the exact float operations ``elapsed_seconds()`` is built
    from — the bit-exactness claim); this subclass only shadows the
    semaphore time lanes with provenance metadata, mirroring the base's
    ``bisect.insort`` order (ties broken by push sequence, the
    insort-right order the base uses on bare floats).
    """

    def __init__(self, generators, strategy, costs):
        #: shadow time lanes: key -> sorted [(time, push_seq, meta)]
        self._meta: Dict[tuple, list] = {}
        self._push_seq = 0
        self._ctx: Optional[tuple] = None
        self._last_pop: list = []
        #: id(dma) -> issue/ready window + naming coordinates
        self._dmas: Dict[int, dict] = {}
        #: (src, dst) wire lane -> [dma ids] in issue order
        self._lanes: Dict[Tuple[int, int], List[int]] = {}
        #: (rank, tier) -> {component: seconds}
        self._parts: Dict[Tuple[int, str], Dict[str, float]] = {}
        #: (rank, lane) -> idle seconds attributed to that lane
        self._lane_idle: Dict[Tuple[int, Tuple[int, int]], float] = {}
        #: rank -> its most recent (hence final) clock-setting jump
        self._last_jump: Dict[int, dict] = {}
        #: rank -> its largest idle jump (the binding wait edge of an
        #: idle-fraction finding)
        self._max_idle_jump: Dict[int, dict] = {}
        super().__init__(generators, strategy, costs=costs)

    # -- shadow lanes ---------------------------------------------------
    def _push_time(self, key, at, times=1):
        super()._push_time(key, at, times)
        lane = self._meta.setdefault(key, [])
        for _ in range(times):
            bisect.insort(lane, (at, self._push_seq, self._ctx))
            self._push_seq += 1

    def _pop_times(self, key, amount):
        t = super()._pop_times(key, amount)
        lane = self._meta.get(key, [])
        take = min(amount, len(lane))
        self._last_pop = lane[:take]
        del lane[:take]
        return t

    # -- event context --------------------------------------------------
    def _land_dma(self, i):
        dma = self.inflight[i]
        self._ctx = ("land", id(dma))
        try:
            super()._land_dma(i)
        finally:
            self._ctx = None

    def _execute_one(self, r):
        action, _ = self.state[r]
        kind = action[0]
        step = self.actions_done[r]
        before = self.clock[r]
        self._last_pop = []
        if kind in ("signal", "dma"):
            self._ctx = (kind, r, step, action, before)
        try:
            super()._execute_one(r)
        finally:
            self._ctx = None
        if kind == "dma":
            dma = self.inflight[-1]
            src, origin_step = dma.origin
            # "obj" pins the _Dma alive: the simulator nulls its
            # inflight slot at landing, and a freed object's id() can
            # be RECYCLED by a later DMA — which would silently rewire
            # every attribution through this table
            self._dmas[id(dma)] = {
                "src": src, "dst": action[1], "step": origin_step,
                "action": action, "issue": before,
                "ready": dma.ready_at,
                "gate": self._last_jump.get(r),
                "obj": dma,
            }
            self._lanes.setdefault((r, action[1]), []).append(id(dma))
        elif kind == "wait" and self.clock[r] > before and self._last_pop:
            self._classify(r, step, action, before, self.clock[r])

    # -- attribution ----------------------------------------------------
    def _tier(self, a: int, b: int) -> str:
        if a == b:
            return "local"
        return "dcn" if self.costs.crosses_dcn(a, b) else "ici"

    def _book(self, r: int, tier: str, component: str, s: float) -> None:
        if s <= 0.0:
            return
        slot = self._parts.setdefault((r, tier), {})
        slot[component] = slot.get(component, 0.0) + s

    def _classify(self, r, step, action, before, after):
        """Split the jump ``after - before`` against the max popped
        entry's producing window (module docstring: alpha / beta /
        serialization / idle)."""
        delta = after - before
        _, _, ctx = self._last_pop[-1]
        waiter = VerifyEvent(r, step, _describe(action))
        if ctx is not None and ctx[0] == "land":
            info = self._dmas[ctx[1]]
            src, dst = info["src"], info["dst"]
            tier = self._tier(src, dst)
            link = self.costs.link(src, dst)
            alpha = link.alpha_s
            beta_s = info["ready"] - info["issue"] - alpha
            covered = max(0.0, info["ready"] - max(info["issue"], before))
            beta_part = min(covered, beta_s)
            alpha_part = min(covered - beta_part, alpha)
            idle_part = delta - beta_part - alpha_part
            if idle_part < IDLE_DUST_S:
                alpha_part += max(0.0, idle_part)
                idle_part = 0.0
            self._book(r, tier, "alpha", alpha_part)
            self._book(r, tier, "beta", beta_part)
            self._book(r, tier, "idle", idle_part)
            producer = VerifyEvent(info["src"], info["step"],
                                   _describe(info["action"]))
            lane = (src, dst)
        elif ctx is not None and ctx[0] == "signal":
            _, src, sstep, saction, sclock = ctx
            dst = saction[1]
            tier = self._tier(src, dst)
            alpha = self.costs.signal_seconds(src, dst)
            covered = max(0.0, (sclock + alpha) - max(sclock, before))
            ser_part = min(covered, alpha)
            idle_part = delta - ser_part
            if idle_part < IDLE_DUST_S:
                ser_part += max(0.0, idle_part)
                idle_part = 0.0
            self._book(r, tier, "serialization", ser_part)
            self._book(r, tier, "idle", idle_part)
            producer = VerifyEvent(src, sstep, _describe(saction))
            lane = (src, dst)
        else:
            # a SEM_SEND completion (pushed at the sender's own clock)
            # can never raise the sender's clock; anything else books
            # whole as serialization so the sum invariant holds
            tier, lane, idle_part = "local", (r, r), 0.0
            self._book(r, tier, "serialization", delta)
            producer = waiter
        jump = {"waiter": waiter, "producer": producer, "jump_s": delta,
                "idle_s": max(0.0, idle_part), "lane": lane, "tier": tier}
        self._last_jump[r] = jump
        if idle_part > 0.0:
            key = (r, lane)
            self._lane_idle[key] = self._lane_idle.get(key, 0.0) + idle_part
            best = self._max_idle_jump.get(r)
            if best is None or idle_part > best["idle_s"]:
                self._max_idle_jump[r] = jump


# ---------------------------------------------------------------------------
# Decomposition report
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PerfReport:
    """Makespan decomposition of one protocol instance."""

    protocol: str
    shape: Dict[str, int]
    ranks: int
    payload_bytes: float
    message_bytes: float
    pipeline_chunks: int
    makespan_s: float
    critical_rank: int
    #: the critical rank's per-tier component split (seconds)
    components: Dict[str, Dict[str, float]]
    #: one row per rank: clock, components, idle fraction, binding edge
    per_rank: Tuple[dict, ...]
    #: one row per wire lane: tier, messages, busy/span, pipeline depth
    wires: Tuple[dict, ...]
    findings: Tuple[PerfFinding, ...]
    #: the critical rank's final clock-setting wait edge
    binding: Optional[dict]

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "protocol": self.protocol,
            "shape": dict(self.shape),
            "ranks": self.ranks,
            "payload_bytes": self.payload_bytes,
            "message_bytes": self.message_bytes,
            "pipeline_chunks": self.pipeline_chunks,
            "makespan_us": self.makespan_s * 1e6,
            "critical_rank": self.critical_rank,
            "components_us": {
                tier: {k: v * 1e6 for k, v in comps.items()}
                for tier, comps in self.components.items()
            },
            "per_rank": [dict(row) for row in self.per_rank],
            "wires": [dict(w) for w in self.wires],
            "ok": self.ok,
            "findings": [f.to_json() for f in self.findings],
            "binding": self.binding,
        }

    def describe(self) -> str:
        shape = ", ".join(f"{k}={v}" for k, v in sorted(self.shape.items()))
        comps = []
        for tier in sorted(self.components):
            inner = ", ".join(
                f"{k} {v * 1e6:.1f}"
                for k, v in sorted(self.components[tier].items())
            )
            comps.append(f"{tier}: {inner}")
        head = (f"{self.protocol} [{shape}]: makespan "
                f"{self.makespan_s * 1e6:.1f} us on rank "
                f"{self.critical_rank} ({'; '.join(comps) or 'free'})")
        if self.binding is not None:
            head += f"\n  binding edge: {self.binding['text']}"
        if self.ok:
            return head
        body = "\n".join(f"  {line}" for f in self.findings
                         for line in str(f).splitlines())
        return f"{head}\n{body}"


def _wire_stats(replay: _TimedReplay) -> List[dict]:
    makespan = replay.elapsed_seconds()
    out = []
    for (src, dst), ids in sorted(replay._lanes.items()):
        infos = [replay._dmas[i] for i in ids]
        windows = sorted((i["issue"], i["ready"]) for i in infos)
        busy = sum(r - i for i, r in windows)
        span = max(r for _, r in windows) - min(i for i, _ in windows)
        # max concurrently-in-flight copies (strict overlap): the
        # measured pipeline depth of this wire
        depth = 0
        for i, (issue, _ready) in enumerate(windows):
            depth = max(depth, sum(
                1 for i2, (is2, rd2) in enumerate(windows)
                if is2 <= issue < rd2 or (i2 == i)
            ))
        out.append({
            "src": src, "dst": dst,
            "tier": replay._tier(src, dst),
            "messages": len(ids),
            "busy_us": busy * 1e6,
            "span_us": span * 1e6,
            "depth": depth,
            "idle_fraction": (
                max(0.0, 1.0 - busy / span)
                if span > 0 and len(ids) >= 2 else 0.0
            ),
            "utilization": busy / makespan if makespan else 0.0,
        })
    return out


def _costs_for(protocol: str, shape: Dict[str, int],
               payload_bytes: float) -> Tuple[C.TierCostModel, float, int]:
    """(costs, message_bytes, pipeline_chunks) for one registered
    instance — the ``pod_wallclock_comparison`` pricing convention."""
    n = shape["n"]
    chunks = shape.get("chunks", 1)
    if protocol == "allreduce_pod":
        per_slice = n // shape["slices"]
        message = payload_bytes / max(1, per_slice)
        return (
            C.default_tier_costs(message, per_slice),
            message, 1,
        )
    if protocol == "all_to_all":
        # per-destination block granularity: the payload splits n ways
        message = payload_bytes / max(1, n)
        return C.default_tier_costs(message, 0), message, 1
    if protocol == "all_to_all_bruck":
        # each round's n/2 block copies coalesce into one aggregate
        # message (the alltoall_variant_wallclocks pricing convention)
        message = payload_bytes / 2.0
        return C.default_tier_costs(message, 0), message, 1
    if protocol == "all_to_all_pod":
        per_slice = n // shape["slices"]
        block = payload_bytes / max(1, n)
        # mixed granularity: blocks on ICI, per_slice-block bundles on
        # DCN (the alltoall_wallclock_comparison convention)
        return (
            C.default_tier_costs(block, per_slice, ici_bytes=block,
                                 dcn_bytes=per_slice * block),
            block, 1,
        )
    if protocol == "all_reduce_quantized":
        # the pod shard granularity scaled by the int8 wire ratio —
        # the reduced bytes ride the per-tier sizing on BOTH tiers
        per_slice = n // shape["slices"]
        message = (payload_bytes / max(1, per_slice)
                   ) * C.PRECISION_WIRE_RATIO["int8"]
        return (
            C.default_tier_costs(message, per_slice, ici_bytes=message,
                                 dcn_bytes=message),
            message, 1,
        )
    if protocol == "all_reduce_sparse":
        # k (index, value) pairs per hop instead of the dense payload:
        # density * (index + value) overhead of the kept elements
        message = (payload_bytes * C.SPARSE_TOPK_DENSITY
                   * C.SPARSE_INDEX_OVERHEAD)
        return C.default_tier_costs(message, 0), message, 1
    if protocol == "all_reduce_chunked":
        message = payload_bytes / max(1, chunks)
        return C.default_tier_costs(message, 0), message, chunks
    if protocol == "neighbour_stream":
        message = payload_bytes / max(1, chunks)
        return C.default_tier_costs(message, 0), message, 1
    if protocol == "reduce_scatter":
        message = payload_bytes / max(1, n)
        return C.default_tier_costs(message, 0), message, 1
    return C.default_tier_costs(payload_bytes, 0), payload_bytes, 1


def decompose_generators(
    make_generators: Callable[[], Sequence[Iterator]],
    costs: C.TierCostModel,
    protocol: str = "<anonymous>",
    shape: Optional[Dict[str, int]] = None,
    payload_bytes: float = float(PERF_PAYLOAD_BYTES),
    pipeline_chunks: int = 1,
    seed: int = 0,
    verify: bool = True,
) -> PerfReport:
    """Decompose one protocol instance's makespan.

    ``make_generators`` follows the verifier's zero-arg-factory
    contract; with ``verify=True`` (the default) the PR 7 static
    verifier runs first — a protocol that can deadlock or race has no
    meaningful makespan, and the failure is the safety tier's finding,
    not a perf number (:class:`AnalysisError` naming it).
    """
    shape = dict(shape or {})
    if verify:
        safety = verify_generators(make_generators, protocol=protocol,
                                   shape=shape)
        if not safety.ok:
            raise AnalysisError(
                f"{protocol}: cannot decompose an unsafe protocol — "
                f"the static verifier found: "
                + "; ".join(f.check for f in safety.findings)
            )
    replay = _TimedReplay(make_generators(), C.Strategy(seed), costs)
    replay.run()
    makespan = replay.elapsed_seconds()
    ranks = replay.n
    critical = max(range(ranks), key=lambda r: replay.clock[r])

    per_rank: List[dict] = []
    findings: List[PerfFinding] = []
    for r in range(ranks):
        tiers: Dict[str, Dict[str, float]] = {}
        for (rank, tier), comps in replay._parts.items():
            if rank == r:
                tiers[tier] = {k: round(v * 1e6, 6)
                               for k, v in comps.items()}
        idle_s = sum(
            comps.get("idle", 0.0)
            for (rank, _t), comps in replay._parts.items() if rank == r
        )
        idle_fraction = idle_s / makespan if makespan else 0.0
        row = {
            "rank": r,
            "clock_us": replay.clock[r] * 1e6,
            "components_us": tiers,
            "idle_fraction": idle_fraction,
        }
        jump = replay._last_jump.get(r)
        if jump is not None:
            row["binding"] = _jump_json(jump)
        per_rank.append(row)
        if idle_fraction > IDLE_FRACTION_THRESHOLD:
            worst = replay._max_idle_jump.get(r)
            lane_key = max(
                ((lane, s) for (rk, lane), s in replay._lane_idle.items()
                 if rk == r),
                key=lambda kv: kv[1], default=((r, r), 0.0),
            )[0]
            tier = replay._tier(*lane_key)
            events = ()
            detail = ""
            if worst is not None:
                events = (worst["waiter"], worst["producer"])
                detail = (f", critical path blocked at "
                          f"{worst['waiter']} waiting on "
                          f"{worst['producer']}")
            findings.append(PerfFinding(
                check="idle-fraction",
                message=(
                    f"idle fraction {idle_fraction:.2f} on {tier} lane "
                    f"{lane_key[0]}->{lane_key[1]}: rank {r} sat "
                    f"blocked {idle_s * 1e6:.1f} us of the "
                    f"{makespan * 1e6:.1f} us makespan before the "
                    f"awaited event was even issued"
                    + detail
                ),
                events=events, rank=r, lane=lane_key, tier=tier,
                fraction=idle_fraction,
                expected=IDLE_FRACTION_THRESHOLD, got=idle_fraction,
            ))

    wires = _wire_stats(replay)
    if pipeline_chunks > 1 and wires:
        max_depth = max(w["depth"] for w in wires)
        if max_depth <= 1:
            busiest = max(wires, key=lambda w: w["busy_us"])
            lane = (busiest["src"], busiest["dst"])
            ids = replay._lanes[lane]
            gate = next(
                (replay._dmas[i]["gate"] for i in ids[1:]
                 if replay._dmas[i]["gate"] is not None),
                None,
            )
            events = ()
            detail = ""
            if gate is not None:
                events = (gate["waiter"], gate["producer"])
                detail = (f"; the pipeline collapses at "
                          f"{gate['waiter']} (gated by "
                          f"{gate['producer']})")
            findings.append(PerfFinding(
                check="serialized-critical-path",
                message=(
                    f"declared pipeline of {pipeline_chunks} chunks "
                    f"but no two copies were ever in flight together "
                    f"on any wire (measured depth {max_depth} on "
                    f"{busiest['tier']} lane "
                    f"{lane[0]}->{lane[1]}): every transfer sits on "
                    f"the critical path instead of overlapping its "
                    f"siblings" + detail
                ),
                events=events, lane=lane, tier=busiest["tier"],
                expected=pipeline_chunks, got=max_depth,
            ))

    binding = None
    jump = replay._last_jump.get(critical)
    if jump is not None:
        binding = _jump_json(jump)
    components = {
        tier: dict(comps)
        for (rank, tier), comps in replay._parts.items()
        if rank == critical
    }
    return PerfReport(
        protocol=protocol, shape=shape, ranks=ranks,
        payload_bytes=payload_bytes,
        message_bytes=costs.bytes_per_message,
        pipeline_chunks=pipeline_chunks,
        makespan_s=makespan, critical_rank=critical,
        components=components,
        per_rank=tuple(per_rank), wires=tuple(wires),
        findings=tuple(findings), binding=binding,
    )


def _jump_json(jump: dict) -> dict:
    return {
        "waiter": jump["waiter"].to_json(),
        "producer": jump["producer"].to_json(),
        "jump_us": jump["jump_s"] * 1e6,
        "idle_us": jump["idle_s"] * 1e6,
        "lane": list(jump["lane"]),
        "tier": jump["tier"],
        "text": (f"{jump['waiter']} <- {jump['producer']} "
                 f"(+{jump['jump_s'] * 1e6:.1f} us on {jump['tier']} "
                 f"lane {jump['lane'][0]}->{jump['lane'][1]})"),
    }


def decompose_protocol(
    protocol: str, n: int, chunks: int = 3, slices: int = 2,
    payload_bytes: float = float(PERF_PAYLOAD_BYTES), seed: int = 0,
    verify: bool = True,
) -> PerfReport:
    """Decompose one registered protocol at one shape (the
    ``smi-tpu lint --perf`` engine's unit of work). ``verify=False``
    skips the safety pre-pass — for callers that JUST ran the verifier
    over the same instance (``route --check --lint``,
    ``lint --combined``), where re-proving it would double the
    static-analysis bill."""
    shape: Dict[str, int] = {"n": n}
    if protocol in ("neighbour_stream", "all_reduce_chunked"):
        shape["chunks"] = chunks
    if protocol in ("allreduce_pod", "all_to_all_pod",
                    "all_reduce_quantized"):
        shape["slices"] = slices
    costs, _message, pipeline = _costs_for(protocol, shape, payload_bytes)
    return decompose_generators(
        lambda: build_generators(protocol, n, chunks=chunks,
                                 slices=slices),
        costs, protocol=protocol, shape=shape,
        payload_bytes=payload_bytes, pipeline_chunks=pipeline, seed=seed,
        verify=verify,
    )


def perf_all(
    protocols: Optional[Sequence[str]] = None,
    payload_bytes: float = float(PERF_PAYLOAD_BYTES),
    verify: bool = True,
) -> List[PerfReport]:
    """Decompose every registered protocol (or the named subset) over
    the verifier's default shape grid. ``verify=False`` when the
    caller has already run the safety tier over the same grid."""
    known = list(DEFAULT_SHAPES)
    if protocols is None:
        protocols = known
    else:
        unknown = [p for p in protocols if p not in known]
        if unknown:
            raise ValueError(
                f"unknown protocol(s) {unknown}; known: {known}"
            )
    reports = []
    for protocol in protocols:
        for shape in DEFAULT_SHAPES[protocol]:
            reports.append(decompose_protocol(
                protocol, payload_bytes=payload_bytes, verify=verify,
                **shape
            ))
    return reports


# ---------------------------------------------------------------------------
# Roofline lint (sub-tier b)
# ---------------------------------------------------------------------------


def flash_single_buffer_bytes(bq: int, bk: int, d: int,
                              itemsize: int) -> int:
    """VMEM footprint of ONE buffer generation of the flash forward
    tiles plus the persistent f32 scratch — the quantity that must fit
    in half the scoped-VMEM frame for the HBM->VMEM pipeline to
    double-buffer (mirrors ``cost_model.flash_fwd_vmem_bytes``, which
    books the tiles twice)."""
    tiles = (bq * d + 2 * bk * d) * itemsize
    scratch = bq * d * 4 + 2 * bq * 128 * 4
    return tiles + scratch


def flash_tile_hbm_bytes(s: int, d: int, bq: int, itemsize: int) -> int:
    """HBM traffic a (block_q = ``bq``) forward tiling forces at
    sequence length ``s``: k/v stream once per q-tile pass, q and the
    output move once."""
    passes = max(1, -(-s // bq))
    return passes * 2 * s * d * itemsize + 2 * s * d * itemsize


def flash_ideal_hbm_bytes(s: int, d: int, itemsize: int) -> int:
    """The compulsory traffic: q, k, v in, o out, each once."""
    return 4 * s * d * itemsize


def flash_canonical_flops(s: int, d: int) -> float:
    """QK^T + PV at full attention: 2 matmuls x 2 flops/MAC."""
    return 4.0 * s * s * d


def _shipped_flash_tiles() -> List[dict]:
    """The tile set ``lint --perf`` prices on a clean tree: the seeded
    measured-best blocks (tuning/seeded.py, drift-guarded against
    PERF.json)."""
    from smi_tpu_torch.tuning import seeded

    return [
        {"name": "seeded bf16 causal", "dtype": "bfloat16",
         "block_q": seeded.SEEDED_FLASH_BF16_BLOCKS[0],
         "block_k": seeded.SEEDED_FLASH_BF16_BLOCKS[1]},
        {"name": "seeded bf16 windowed", "dtype": "bfloat16",
         "block_q": seeded.SEEDED_FLASH_BF16_WINDOW_BLOCKS[0],
         "block_k": seeded.SEEDED_FLASH_BF16_WINDOW_BLOCKS[1]},
        {"name": "seeded f32 causal", "dtype": "float32",
         "block_q": seeded.SEEDED_FLASH_F32_BLOCKS[0],
         "block_k": seeded.SEEDED_FLASH_F32_BLOCKS[1]},
    ]


def no_double_buffer_findings(
    tiles: Optional[Sequence[dict]] = None,
    d: int = FLASH_CANONICAL_D,
) -> List[PerfFinding]:
    """``no-double-buffer``: tiles whose single-buffer footprint
    exceeds half the scoped-VMEM frame."""
    findings = []
    for tile in (_shipped_flash_tiles() if tiles is None else tiles):
        itemsize = 2 if tile.get("dtype") == "bfloat16" else 4
        td = tile.get("d", d)
        single = flash_single_buffer_bytes(
            tile["block_q"], tile["block_k"], td, itemsize
        )
        if single > VMEM_DOUBLE_BUFFER_BOUND:
            findings.append(PerfFinding(
                check="no-double-buffer",
                message=(
                    f"flash tile bq{tile['block_q']}/bk{tile['block_k']}"
                    f" ({tile.get('dtype', 'float32')}, d={td}) needs "
                    f"{single // 1024} KiB of VMEM per buffer "
                    f"generation — over the "
                    f"{VMEM_DOUBLE_BUFFER_BOUND // 1024} KiB "
                    f"double-buffer bound of the "
                    f"{cm.VMEM_LIMIT_BYTES // 1024} KiB scoped-VMEM "
                    f"frame, so the HBM->VMEM pipeline cannot prefetch "
                    f"the next tile while computing this one"
                ),
                expected=VMEM_DOUBLE_BUFFER_BOUND, got=single,
            ))
    return findings


def below_roofline_findings(
    tiles: Optional[Sequence[dict]] = None,
    s: int = FLASH_CANONICAL_S,
    d: int = FLASH_CANONICAL_D,
) -> List[PerfFinding]:
    """``below-roofline-tile``: tiles whose forced k/v re-read traffic
    drops their achievable fraction of the ideal roofline under the
    threshold."""
    findings = []
    for tile in (_shipped_flash_tiles() if tiles is None else tiles):
        dtype = tile.get("dtype", "float32")
        itemsize = 2 if dtype == "bfloat16" else 4
        flops = flash_canonical_flops(s, d)
        ideal = cm.kernel_roofline_us(
            flops, flash_ideal_hbm_bytes(s, d, itemsize), dtype
        )
        tiled = cm.kernel_roofline_us(
            flops, flash_tile_hbm_bytes(s, d, tile["block_q"], itemsize),
            dtype,
        )
        if not ideal or not tiled:
            continue
        fraction = ideal / tiled
        if fraction < BELOW_ROOFLINE_FRACTION:
            findings.append(PerfFinding(
                check="below-roofline-tile",
                message=(
                    f"flash tile bq{tile['block_q']}/bk{tile['block_k']}"
                    f" ({dtype}) can reach only {fraction:.2f} of the "
                    f"kernel roofline at S={s}: its "
                    f"{-(-s // tile['block_q'])} k/v streaming passes "
                    f"force "
                    f"{flash_tile_hbm_bytes(s, d, tile['block_q'], itemsize) >> 20}"
                    f" MiB of HBM traffic vs the "
                    f"{flash_ideal_hbm_bytes(s, d, itemsize) >> 20} MiB"
                    f" compulsory minimum — widen block_q or accept "
                    f"the memory-bound tier"
                ),
                fraction=fraction,
                expected=BELOW_ROOFLINE_FRACTION, got=fraction,
            ))
    return findings


def serialized_dma_findings(hlo_text: str) -> List[PerfFinding]:
    """``serialized-dma``: async collective pairs that are part of a
    dependent collective chain yet moved with zero compute scheduled in
    their flight window — the transfer is pure critical path even
    though the program HAS compute to hide behind it."""
    from smi_tpu_torch.parallel import traffic as T

    findings = []
    report = T.overlap_report(hlo_text=hlo_text)
    for rec in report["per_collective"]:
        if not rec["async"]:
            continue
        upstream = rec.get("depends_on_collective")
        if (rec.get("scheduled_ops", 0) == 0
                and rec["computation_compute_bytes"] > 0
                and upstream):
            findings.append(PerfFinding(
                check="serialized-dma",
                message=(
                    f"async {rec['op']} %{rec['name']} depends on "
                    f"collective %{upstream} and has ZERO compute "
                    f"scheduled between its start and done — the "
                    f"dependent DMA chain runs end-to-end on the "
                    f"critical path while the computation holds "
                    f"{rec['computation_compute_bytes']} B of compute "
                    f"that could hide it (see overlap_report)"
                ),
                expected=">0 scheduled bytes", got=0,
            ))
    return findings


# -- stencil stripe stream (r18 roofline closure) ----------------------------

#: The stream model is two ranks: the HBM side (0) pushing stripes and
#: collecting writebacks, and the compute core (1) consuming them.
STENCIL_STREAM_RANKS = 2

#: Default stripe payload of the replay: the shipped pipeline's
#: t=128 x (8192 + 2*128) lanes x 4 B extended stripe.
STENCIL_STRIPE_BYTES = 128 * (8192 + 256) * 4


def stencil_stream_generators(
    chunks: int, buffering: int,
) -> List[Iterator]:
    """Per-rank generators of the stencil stripe stream at one
    buffering depth — the credits-vocabulary twin of the explicit-DMA
    kernel (``kernels/stencil_pipeline.py``), so the PR 7 verifier and
    the decomposer can certify/price the SAME slot-rotation discipline
    the Pallas kernel hand-codes with ``pltpu.SemaphoreType.DMA``.

    ``buffering == 1`` is the synchronous control path: the HBM side
    issues fetch ``i`` only after consuming writeback ``i - 1``, so
    every stripe flight sits on the critical path twice — the shape
    whose replay the ``idle-fraction`` finding must name.

    ``buffering >= 2`` is the slot rotation: ``buffering`` fetches run
    ahead of the consumer (fetch-slot reuse fenced by the consumer's
    read credit — the sim twin of the kernel's writeback-semaphore
    wait before reusing a VMEM slot), and writebacks stream into
    per-stripe HBM-side slots the moment each stripe is consumed —
    HBM is the destination, so there is no landing-slot scarcity to
    fence, exactly as in the kernel. Credit grants are counted exactly
    (``chunks - buffering``) so the verifier's leak check drains to
    zero, and with the canonical stripe count every wait lands inside
    an already-issued DMA window (idle under the threshold on BOTH
    ranks).
    """
    if chunks < 1 or buffering < 1:
        raise ValueError(
            f"stencil stream needs chunks >= 1 and buffering >= 1, "
            f"got chunks={chunks} buffering={buffering}"
        )

    if buffering == 1:
        def hbm_sync():
            for i in range(chunks):
                yield ("dma", 1, 0, ("stripe", i), 0, 0)
                yield ("wait", C.SEM_SEND, 0, 1)
                yield ("wait", C.SEM_RECV, 0, 1)
                done = yield ("read_slot", 0)
                yield ("output", i, done)

        def core_sync():
            for i in range(chunks):
                yield ("wait", C.SEM_RECV, 0, 1)
                stripe = yield ("read_slot", 0)
                yield ("dma", 0, 0, stripe, 0, 0)
                yield ("wait", C.SEM_SEND, 0, 1)

        return [hbm_sync(), core_sync()]

    depth = buffering

    def hbm_stream():
        for i in range(chunks):
            slot = i % depth
            if i >= depth:
                # fetch-slot reuse fenced by the consumer's read credit
                yield ("wait", C.SEM_CREDIT, slot, 1)
            yield ("dma", 1, slot, ("stripe", i), slot, slot)
            yield ("wait", C.SEM_SEND, slot, 1)
            if i >= depth:
                j = i - depth
                yield ("wait", C.SEM_RECV, ("wb", j), 1)
                done = yield ("read_slot", ("wb", j))
                yield ("output", j, done)
        for j in range(max(0, chunks - depth), chunks):
            yield ("wait", C.SEM_RECV, ("wb", j), 1)
            done = yield ("read_slot", ("wb", j))
            yield ("output", j, done)

    def compute_core():
        for i in range(chunks):
            slot = i % depth
            yield ("wait", C.SEM_RECV, slot, 1)
            stripe = yield ("read_slot", slot)
            if i < chunks - depth:
                yield ("signal", 0, C.SEM_CREDIT, slot, 1)
            yield ("dma", 0, ("wb", i), stripe, ("wb", i), ("wb", i))
            yield ("wait", C.SEM_SEND, ("wb", i), 1)

    return [hbm_stream(), compute_core()]


#: Canonical stripe count of the replay: one 8192-row pass at the
#: shipped stripe width t=128 (startup transients amortize away at
#: this length — shorter replays book the fill/drain ramp as idle).
STENCIL_STREAM_STRIPES = 64


def decompose_stencil_stream(
    n_stripes: int = STENCIL_STREAM_STRIPES,
    stripe_bytes: float = float(STENCIL_STRIPE_BYTES),
    buffering: int = 3,
    seed: int = 0,
    verify: bool = True,
) -> PerfReport:
    """Verify + decompose the stencil stripe stream at one buffering
    depth — the overlap PROOF behind the r18 pipeline claim: the
    synchronous replay exceeds :data:`IDLE_FRACTION_THRESHOLD` on the
    DMA wait edge, the pipelined replay stays under it with measured
    wire depth >= 2 (``tests/test_stencil_pipeline.py`` asserts both
    sides, ``bench.py`` ships the pipelined fraction)."""
    costs = C.default_tier_costs(stripe_bytes, 0)
    return decompose_generators(
        lambda: stencil_stream_generators(n_stripes, buffering),
        costs,
        protocol=f"stencil_stream_b{buffering}",
        shape={"n": STENCIL_STREAM_RANKS, "chunks": n_stripes,
               "buffering": buffering},
        payload_bytes=n_stripes * stripe_bytes,
        pipeline_chunks=n_stripes if buffering >= 2 else 1,
        seed=seed, verify=verify,
    )


def stencil_overlap_fraction(report: PerfReport) -> float:
    """The decomposer-measured share of the stripe stream hidden
    behind compute: one minus the worst per-rank idle fraction of the
    replay (1.0 = every wait landed inside an already-issued DMA
    window — perfect overlap)."""
    worst = max((r["idle_fraction"] for r in report.per_rank),
                default=0.0)
    return max(0.0, 1.0 - worst)


# -- analytic regression -----------------------------------------------------

#: Committed static predictions (microseconds) at the published rates —
#: the PERF.json discipline applied to the analyzer itself: a code
#: change that silently reprices one of these shows up as an
#: ``analytic-regression`` finding (and a test_perf_docs failure)
#: instead of a quietly different curve. Regenerate with
#: ``analytic_predictions()`` when the cost model legitimately moves.
ANALYTIC_EXPECTED_US = {
    "pod_allreduce_flat_2x2_4mib_us": 4894.3,
    "pod_allreduce_two_tier_2x2_4mib_us": 1197.3,
    "allreduce_n8_64kib_us": 132.7,
    "allreduce_n8_256kib_us": 163.3,
    "allreduce_n8_1024kib_us": 285.6,
    "allreduce_n8_4096kib_us": 408.1,
    "alltoall_n8_64kib_us": 54.7,
    "alltoall_n8_256kib_us": 61.2,
    "alltoall_n8_1024kib_us": 87.5,
    "alltoall_n8_4096kib_us": 192.3,
    "alltoall_pairwise_2x2_1mib_us": 1548.6,
    "alltoall_two_tier_2x2_1mib_us": 957.4,
    "flash_fwd_bf16_seeded_roofline_us": 174.4,
    "flash_fwd_f32_seeded_roofline_us": 523.2,
    "stencil_pipeline_8192_sweep_us": 318.6,
    "stencil_sync_8192_sweep_us": 390.1,
    # r19 compressed collectives: the 2x2-pod 4 MiB A/B vectors (f32
    # baseline is pod_allreduce_two_tier_2x2_4mib_us above) and the
    # int8 flat curve the bench `compression` row compares against.
    # The acceptance bar: int8/f32 <= 0.55 on BOTH the full makespan
    # (603.1 / 1197.3 = 0.504) and the DCN phase (274.8 / 799.1 =
    # 0.344), tier-1-asserted.
    "quantized_pod_allreduce_int8_2x2_4mib_us": 603.1,
    "quantized_pod_allreduce_bf16_2x2_4mib_us": 801.1,
    "quantized_pod_dcn_phase_f32_2x2_4mib_us": 799.1,
    "quantized_pod_dcn_phase_int8_2x2_4mib_us": 274.8,
    "allreduce_int8_n8_64kib_us": 125.0,
    "allreduce_int8_n8_256kib_us": 132.7,
    "allreduce_int8_n8_1024kib_us": 163.3,
    "allreduce_int8_n8_4096kib_us": 285.6,
}


#: The payload grid of the committed allreduce curve (KiB).
ALLREDUCE_CURVE_SIZES_KB = (64, 256, 1024, 4096)

#: The payload grid of the committed all-to-all curve (KiB, total
#: per-rank payload — one payload/n block per destination).
ALLTOALL_CURVE_SIZES_KB = (64, 256, 1024, 4096)


def allreduce_curve_us(
    sizes_kb: Sequence[int] = ALLREDUCE_CURVE_SIZES_KB, n: int = 8,
) -> List[float]:
    """The best-flat-candidate allreduce latency curve at the published
    ICI rates — the SINGLE pricing used by both the
    ``analytic-regression`` lint rule and the bench.py scoreboard, so
    the two consumers can never silently price the same curve
    differently."""
    link = cm.LinkModel()
    return [
        round(min(
            cm.ring_allreduce_us(kb * 1024, n, link),
            cm.rs_ag_allreduce_us(kb * 1024, n, link),
        ), 1)
        for kb in sizes_kb
    ]


def alltoall_curve_us(
    sizes_kb: Sequence[int] = ALLTOALL_CURVE_SIZES_KB, n: int = 8,
) -> List[float]:
    """The best-flat-candidate all-to-all latency curve (pairwise vs
    Bruck) at the published ICI rates — the SINGLE pricing used by
    both the ``analytic-regression`` lint rule and the bench.py
    ``alltoall`` scoreboard row, mirroring
    :func:`allreduce_curve_us`'s one-pricing discipline."""
    link = cm.LinkModel()
    return [
        round(min(
            cm.pairwise_alltoall_us(kb * 1024, n, link),
            cm.bruck_alltoall_us(kb * 1024, n, link),
        ), 1)
        for kb in sizes_kb
    ]


def quantized_curve_us(
    sizes_kb: Sequence[int] = ALLREDUCE_CURVE_SIZES_KB, n: int = 8,
    precision: str = "int8",
) -> List[float]:
    """The quantized-wire allreduce latency curve at the published ICI
    rates: the best flat candidate priced at the precision's wire bytes
    (:data:`credits.PRECISION_WIRE_RATIO`) — the SINGLE pricing used by
    both the ``analytic-regression`` lint rule and the bench.py
    ``compression`` scoreboard row, mirroring
    :func:`allreduce_curve_us`'s one-pricing discipline. The curves are
    directly comparable point-for-point: same grid, same candidates,
    same rates, only the wire width differs."""
    ratio = C.PRECISION_WIRE_RATIO[precision]
    link = cm.LinkModel()
    return [
        round(min(
            cm.ring_allreduce_us(kb * 1024 * ratio, n, link),
            cm.rs_ag_allreduce_us(kb * 1024 * ratio, n, link),
        ), 1)
        for kb in sizes_kb
    ]


def analytic_predictions() -> Dict[str, float]:
    """Recompute today's static predictions for the committed
    expectation set, at the PUBLISHED rates (a fleet
    ``$SMI_TPU_DCN_BETA`` must not leak into the drift check)."""
    out: Dict[str, float] = {}
    dcn = C.LinkCost(cm.DCN_ALPHA_S, cm.DCN_BETA_BYTES_PER_S)
    rep = C.pod_wallclock_comparison(2, 2, 4 << 20, dcn=dcn)
    out["pod_allreduce_flat_2x2_4mib_us"] = round(rep["flat_s"] * 1e6, 1)
    out["pod_allreduce_two_tier_2x2_4mib_us"] = round(
        rep["hierarchical_s"] * 1e6, 1
    )
    for kb, us in zip(ALLREDUCE_CURVE_SIZES_KB, allreduce_curve_us()):
        out[f"allreduce_n8_{kb}kib_us"] = us
    for kb, us in zip(ALLTOALL_CURVE_SIZES_KB, alltoall_curve_us()):
        out[f"alltoall_n8_{kb}kib_us"] = us
    a2a = C.alltoall_wallclock_comparison(2, 2, float(1 << 20),
                                          dcn=dcn)
    out["alltoall_pairwise_2x2_1mib_us"] = round(
        a2a["pairwise_s"] * 1e6, 1
    )
    out["alltoall_two_tier_2x2_1mib_us"] = round(
        a2a["hierarchical_s"] * 1e6, 1
    )
    # r19: the quantized A/B vectors from the SAME simulator run shape
    # as the committed two-tier baseline, plus the int8 flat curve
    q8 = C.quantized_wallclock_comparison(2, 2, 4 << 20, "int8",
                                          dcn=dcn)
    out["quantized_pod_allreduce_int8_2x2_4mib_us"] = round(
        q8["quantized_s"] * 1e6, 1
    )
    out["quantized_pod_dcn_phase_f32_2x2_4mib_us"] = round(
        q8["f32_dcn_s"] * 1e6, 1
    )
    out["quantized_pod_dcn_phase_int8_2x2_4mib_us"] = round(
        q8["quantized_dcn_s"] * 1e6, 1
    )
    qb = C.quantized_wallclock_comparison(2, 2, 4 << 20, "bf16",
                                          dcn=dcn)
    out["quantized_pod_allreduce_bf16_2x2_4mib_us"] = round(
        qb["quantized_s"] * 1e6, 1
    )
    for kb, us in zip(ALLREDUCE_CURVE_SIZES_KB, quantized_curve_us()):
        out[f"allreduce_int8_n8_{kb}kib_us"] = us
    from smi_tpu_torch.tuning import seeded

    for name, (bq, _bk), dtype in (
        ("flash_fwd_bf16_seeded_roofline_us",
         seeded.SEEDED_FLASH_BF16_BLOCKS, "bfloat16"),
        ("flash_fwd_f32_seeded_roofline_us",
         seeded.SEEDED_FLASH_F32_BLOCKS, "float32"),
    ):
        itemsize = 2 if dtype == "bfloat16" else 4
        out[name] = round(cm.kernel_roofline_us(
            flash_canonical_flops(FLASH_CANONICAL_S, FLASH_CANONICAL_D),
            flash_tile_hbm_bytes(FLASH_CANONICAL_S, FLASH_CANONICAL_D,
                                 bq, itemsize),
            dtype,
        ), 1)
    # r18: one 8192^2 sweep under the seeded pipeline knobs vs the
    # synchronous control — the margin the measured sweep must confirm
    out["stencil_pipeline_8192_sweep_us"] = round(
        cm.stencil_pipeline_us(8192, 8192, 8, 128, "float32"), 1
    )
    out["stencil_sync_8192_sweep_us"] = round(
        cm.stencil_pipeline_us(8192, 8192, 16, 128, "float32",
                               buffering=1), 1
    )
    return out


def analytic_regression_findings(
    predictions: Optional[Dict[str, float]] = None,
    expected: Optional[Dict[str, float]] = None,
) -> List[PerfFinding]:
    """``analytic-regression``: recomputed predictions that drifted
    more than :data:`ANALYTIC_DRIFT_FRACTION` WORSE than the committed
    expectation for the same knobs. Improvements do not fire (they
    should land as updated expectations); a missing prediction is a
    loud finding, never a silent skip."""
    preds = analytic_predictions() if predictions is None else predictions
    exp = ANALYTIC_EXPECTED_US if expected is None else expected
    findings = []
    for name, want in sorted(exp.items()):
        got = preds.get(name)
        if got is None:
            findings.append(PerfFinding(
                check="analytic-regression",
                message=(
                    f"expectation {name!r} has no recomputed "
                    f"prediction — the expectation table and the "
                    f"predictor drifted apart"
                ),
                expected=want, got=None,
            ))
            continue
        if got > want * (1.0 + ANALYTIC_DRIFT_FRACTION):
            findings.append(PerfFinding(
                check="analytic-regression",
                message=(
                    f"static prediction {name} regressed to "
                    f"{got:.1f} us vs the committed {want:.1f} us "
                    f"({got / want:.2f}x, beyond the "
                    f"{ANALYTIC_DRIFT_FRACTION:.0%} drift bound) for "
                    f"unchanged knobs — a cost-model or protocol "
                    f"change made the same configuration analytically "
                    f"slower; re-measure or update the expectation"
                ),
                fraction=got / want, expected=want, got=got,
            ))
    return findings


def roofline_lint(
    flash_tiles: Optional[Sequence[dict]] = None,
    hlo_text: Optional[str] = None,
    check_expectations: bool = True,
) -> List[PerfFinding]:
    """The full sub-tier (b) pass: VMEM double-buffer + tile roofline
    over ``flash_tiles`` (default: the shipped seeded tiles),
    ``serialized-dma`` when an HLO artifact is given, and the analytic
    drift check against the committed expectations."""
    findings = no_double_buffer_findings(flash_tiles)
    findings += below_roofline_findings(flash_tiles)
    if hlo_text is not None:
        findings += serialized_dma_findings(hlo_text)
    if check_expectations:
        findings += analytic_regression_findings()
    return findings


# ---------------------------------------------------------------------------
# Report aggregation (the ``smi-tpu lint --perf`` payload)
# ---------------------------------------------------------------------------


def perf_reports_to_json(
    reports: Sequence[PerfReport],
    roofline: Sequence[PerfFinding] = (),
) -> dict:
    n_findings = (sum(len(r.findings) for r in reports)
                  + len(roofline))
    return {
        "ok": n_findings == 0,
        "tier": "perf",
        "findings": n_findings,
        "checks": list(PERF_CHECKS),
        "idle_fraction_threshold": IDLE_FRACTION_THRESHOLD,
        "protocols": [r.to_json() for r in reports],
        "roofline": [f.to_json() for f in roofline],
    }


def render_perf_reports(
    reports: Sequence[PerfReport],
    roofline: Sequence[PerfFinding] = (),
) -> str:
    lines = [r.describe() for r in reports]
    lines.extend(str(f) for f in roofline)
    n_findings = (sum(len(r.findings) for r in reports)
                  + len(roofline))
    lines.append(
        f"{len(reports)} protocol instance(s) decomposed, "
        f"{n_findings} perf finding(s)"
    )
    return "\n".join(lines)
