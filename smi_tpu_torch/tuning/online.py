"""Online autotuner: live-sample shadow comparison, epoch-guarded swap.

The port's copy of :mod:`smi_tpu.tuning.online`, pure Python and name
for name. Its ``recorder`` (``emit(kind, tick, **fields)``) and
``metrics`` (``counter(name, **labels).inc(by)``) are duck-typed, so it
takes the JAX package's ``obs`` flight recorder and metrics registry, or
anything shaped like them: the port needs no ``obs/`` of its own. The
serving front-end, CLI and observability schema this text cites are the
JAX package's.

The plan engine resolves
env → cache → live → model → heuristic at *trace* time from an
*offline* sweep, but the serving front-end generates exactly the
per-tenant, per-payload traffic distributions an offline sweep cannot
anticipate. This module is ATLAS (PAPERS.md) moved from install-time
to run-time, specialized per tenant:

- **ingest** — :class:`OnlineTuner` is ``record()``-compatible with
  the JAX package's ``obs.metrics.SampleSink``, so
  ``tracing.timed(sink=tuner, op=..., payload_bytes=..., tenant=...)``
  streams live wall-clocks straight into it with zero call-site
  changes, and :meth:`OnlineTuner.ingest` replays a recorded
  ``SampleSink`` snapshot offline (``smi-tpu tune --online``).
- **shadow-compare** — per (op, power-of-two payload bucket, tenant)
  cell, the ACTIVE plan's measured mean cost is compared against the
  best rival candidate from :mod:`smi_tpu_torch.tuning.cost_model`'s
  :class:`~smi_tpu_torch.tuning.cost_model.CandidateSet`. A proposal fires
  only past BOTH thresholds — at least :data:`DEFAULT_RETUNE_MIN_SAMPLES`
  samples in the cell AND a measured-over-modeled win of at least
  :data:`DEFAULT_RETUNE_MARGIN` — so noise can never flip a plan.
- **hot-swap** — the winning rival goes through the explicit
  :class:`~smi_tpu_torch.tuning.swap.PlanSwap` machine (propose → quiesce →
  swap → commit/rollback): the plan-cache entry is replaced mid-job
  under a bumped plan epoch + entry ``revision``, stale-plan traffic
  is rejected loudly, and an aborted swap rolls back with zero
  lost-accepted. The machine itself is exhaustively model-checked
  (``smi-tpu lint --model``, the ``retune=1`` scope).

The tuner only RETUNES plans — a cell with no active cache entry has
nothing to hot-swap and is left to the sweep/heuristic layers (first
plans are the offline sweep's job; replacing a *measured* entry that
live traffic proves wrong is this module's).

Everything is observable through the JAX package's ``obs`` schema:
``tune.sample`` /
``tune.propose`` / ``tune.swap`` / ``tune.rollback`` events plus the
``tune_*_total`` counters, incremented at the tuner's own accounting
sites so a metrics snapshot can never disagree with the bookkeeping.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

from smi_tpu_torch.tuning import cost_model as cm
from smi_tpu_torch.tuning.cache import CacheEntry, PlanCache
from smi_tpu_torch.tuning.engine import _collective_topology
from smi_tpu_torch.tuning.plan import PlanKey, payload_bucket
from smi_tpu_torch.tuning.swap import PlanSwap

#: Minimum samples a shadow cell must hold before it may propose a
#: swap — one slow outlier can never flip a plan. Overridable by
#: ``$SMI_TPU_RETUNE_MIN_SAMPLES`` (and per-tuner). docs/tuning.md
#: quotes this (drift-guarded).
DEFAULT_RETUNE_MIN_SAMPLES = 16

#: Minimum measured-over-modeled win factor the rival must show
#: (``measured_mean >= margin * rival_modeled``) before a proposal
#: fires — the hysteresis band that keeps a near-tie from flapping.
#: Overridable by ``$SMI_TPU_RETUNE_MARGIN``.
DEFAULT_RETUNE_MARGIN = 1.5

#: Ticks a quiesce may wait for its drain set before the swap rolls
#: back (reason ``quiesce-timeout``) — a wedged stream must cost the
#: retune, never wedge the tuner.
QUIESCE_TIMEOUT_TICKS = 64

#: Master switch for trace-path integrations (off by default — the
#: tuner only runs where a caller asked for it). Boolean vocabulary
#: below; anything else is a LOUD ValueError naming knob and value
#: (the ``default_deadline`` discipline: a typo must never silently
#: pick a different behaviour).
ONLINE_RETUNE_ENV = "SMI_TPU_ONLINE_RETUNE"
MIN_SAMPLES_ENV = "SMI_TPU_RETUNE_MIN_SAMPLES"
MARGIN_ENV = "SMI_TPU_RETUNE_MARGIN"

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("", "0", "false", "no", "off")

#: Ops the tuner can arbitrate: the ones whose rival candidates the
#: cost model prices (:func:`op_candidates`). Samples for any other op
#: aggregate in their cells but never propose.
TUNABLE_OPS = ("all_reduce", "all_to_all", "stencil_pipeline")


def online_retune_enabled() -> bool:
    """``$SMI_TPU_ONLINE_RETUNE``: unset/empty/0/false/no/off = OFF;
    1/true/yes/on = ON; anything else is a loud ValueError."""
    raw = os.environ.get(ONLINE_RETUNE_ENV, "").strip().lower()
    if raw in _FALSY:
        return False
    if raw in _TRUTHY:
        return True
    raise ValueError(
        f"${ONLINE_RETUNE_ENV} must be one of "
        f"{_TRUTHY + tuple(v for v in _FALSY if v)} (or unset), got "
        f"{os.environ.get(ONLINE_RETUNE_ENV)!r}"
    )


def retune_min_samples() -> int:
    """``$SMI_TPU_RETUNE_MIN_SAMPLES`` (a positive integer — it
    outranks the built-in :data:`DEFAULT_RETUNE_MIN_SAMPLES`), loud on
    malformed or non-positive values."""
    raw = os.environ.get(MIN_SAMPLES_ENV, "").strip()
    if not raw:
        return DEFAULT_RETUNE_MIN_SAMPLES
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"${MIN_SAMPLES_ENV} must be a positive integer sample "
            f"count, got {raw!r}"
        ) from None
    if value < 1:
        raise ValueError(
            f"${MIN_SAMPLES_ENV} must be >= 1 (a zero-sample "
            f"threshold would let a single outlier flip a plan), "
            f"got {raw!r}"
        )
    return value


def retune_margin() -> float:
    """``$SMI_TPU_RETUNE_MARGIN`` (a finite factor > 1.0 — it outranks
    the built-in :data:`DEFAULT_RETUNE_MARGIN`), loud on malformed
    values: a margin at or below 1.0 removes the hysteresis band and
    noise could flip plans."""
    raw = os.environ.get(MARGIN_ENV, "").strip()
    if not raw:
        return DEFAULT_RETUNE_MARGIN
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"${MARGIN_ENV} must be a win-margin factor, got {raw!r}"
        ) from None
    if not value > 1.0 or math.isinf(value) or math.isnan(value):
        raise ValueError(
            f"${MARGIN_ENV} must be a finite factor > 1.0 (the "
            f"hysteresis band that keeps noise from flipping plans), "
            f"got {raw!r}"
        )
    return value


def op_candidates(op: str, payload_bytes: float, topo: cm.TopologySpec,
                  link: Optional[cm.LinkModel] = None,
                  dtype: str = "float32"):
    """The rival candidate table for one tunable op — the SAME pricing
    ``tune --explain`` prints and the analytic-regression lint rule
    recomputes (one pricing, every consumer). For ``all_reduce`` the
    table is algorithms FIRST (so :func:`priced_sample_us`'s
    first-algorithm-match scan is unchanged), then the lossy wire
    precisions from :func:`cm.allreduce_precision_candidates` — the
    r19 vocabulary growth that lets live traffic retune a dense plan
    into an int8 one through the same swap machine."""
    link = link or cm.LinkModel()
    if op == "all_reduce":
        algos = cm.allreduce_candidates(int(payload_bytes), topo,
                                        link=link)
        pcands = cm.allreduce_precision_candidates(
            int(payload_bytes), topo, dtype=dtype, link=link
        )
        # drop the dense f32 row: it IS the best algorithm candidate,
        # and a duplicate identity would let the tuner propose a
        # no-op swap
        lossy = [c for c in pcands if c.name != "f32"]
        return cm.CandidateSet(list(algos) + lossy, pcands.excluded)
    if op == "all_to_all":
        return cm.alltoall_candidates(int(payload_bytes), topo,
                                      link=link)
    if op == "stencil_pipeline":
        # the payload is the f32 block (extent^2 x 4 B); candidate
        # NAMES are the tuner's algorithm vocabulary (each depth x
        # stripe x dtype point is its own rival), while the remaining
        # knobs stay kernel-shaped so an installed entry is complete
        extent = max(1, int(math.isqrt(max(0, int(payload_bytes)) // 4)))
        cands = cm.stencil_pipeline_candidates(h=extent, w=extent)
        renamed = [
            dataclasses.replace(
                c, knobs={**c.knobs, "algorithm": c.name}
            )
            for c in cands
        ]
        return type(cands)(renamed, cands.excluded)
    return None


def priced_sample_us(op: str, algorithm: str, payload_bytes: float,
                     topo: cm.TopologySpec,
                     link: Optional[cm.LinkModel] = None) -> float:
    """The modeled cost of running ``algorithm`` for ``op`` at this
    payload — the pricing the seeded campaign cells use to synthesize
    deterministic "live" timings (the credits simulator's Hockney
    tiers). Loud on an op/algorithm pair the model cannot price."""
    cands = op_candidates(op, payload_bytes, topo, link)
    if cands is not None:
        for c in cands:
            if (c.knobs.get("algorithm") == algorithm
                    and c.modeled_us is not None):
                return c.modeled_us
    raise ValueError(
        f"no pricing for op {op!r} algorithm {algorithm!r} "
        f"(tunable ops: {TUNABLE_OPS})"
    )


def sample_bucket_bytes(payload_bytes: Optional[float]) -> Optional[int]:
    """The PLAN engine's power-of-two bucket (lower bound, bytes) —
    deliberately the :func:`smi_tpu_torch.tuning.plan.payload_bucket`
    vocabulary, not the metrics histogram's upper-bound grid, so a
    cell maps onto exactly the plan-cache key the engine consults for
    every payload in the bucket (edge payloads included)."""
    if payload_bytes is None:
        return None
    b = max(1, int(payload_bytes))
    return 1 << (b.bit_length() - 1)


@dataclasses.dataclass
class _ShadowCell:
    """Bounded aggregate of one (op, bucket, tenant)'s live timings of
    the ACTIVE plan."""

    count: int = 0
    total_us: float = 0.0
    min_us: Optional[float] = None
    max_us: Optional[float] = None

    def add(self, us: float, n: int = 1) -> None:
        self.count += n
        self.total_us += us * n
        if self.min_us is None or us < self.min_us:
            self.min_us = us
        if self.max_us is None or us > self.max_us:
            self.max_us = us

    @property
    def mean_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0


class OnlineTuner:
    """Live-sample plan retuning over one plan cache.

    ``record()`` is ``SampleSink``-shaped
    (the ``tracing.timed(sink=)`` target); :meth:`maybe_propose` turns
    qualified cells into :class:`~smi_tpu_torch.tuning.swap.PlanSwap`
    proposals; the swap transitions (:meth:`start_quiesce`,
    :meth:`execute_swap`, :meth:`commit`, :meth:`rollback`) are driven
    by the host — the serving front-end one transition per tick, the
    model checker one per BFS action, :meth:`run_offline` to
    completion.
    """

    def __init__(
        self,
        cache: Optional[PlanCache] = None,
        topo: Optional[cm.TopologySpec] = None,
        dtype: str = "float32",
        device_kind: str = "unknown",
        min_samples: Optional[int] = None,
        margin: Optional[float] = None,
        link: Optional[cm.LinkModel] = None,
        recorder=None,
        metrics=None,
        quiesce_timeout: int = QUIESCE_TIMEOUT_TICKS,
    ):
        self.cache = cache if cache is not None else PlanCache()
        self.topo = topo or cm.TopologySpec(n=8)
        self.dtype = dtype
        self.device_kind = device_kind
        # env overrides outrank the built-ins; an explicit argument
        # outranks both (the operator wiring the tuner by hand)
        self.min_samples = (retune_min_samples() if min_samples is None
                            else int(min_samples))
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}"
            )
        self.margin = retune_margin() if margin is None else float(margin)
        if not self.margin > 1.0:
            raise ValueError(
                f"margin must be > 1.0 (the noise-hysteresis band), "
                f"got {self.margin}"
            )
        self.link = link or cm.LinkModel()
        self.recorder = recorder
        self.metrics = metrics
        self.quiesce_timeout = int(quiesce_timeout)
        #: host-attached logical clock for event stamps (the serving
        #: front-end wires its StepClock); default = tick 0
        self.clock: Optional[Callable[[], int]] = None
        self.cells: Dict[Tuple[str, Optional[int], Optional[str]],
                         _ShadowCell] = {}
        self._swaps: Dict[str, PlanSwap] = {}
        # bookkeeping — the tune_* metrics counters are incremented at
        # the same sites, so snapshot == bookkeeping (tested)
        self.samples_ingested = 0
        self.proposals = 0
        self.swaps = 0
        self.rollbacks = 0

    # -- observability plumbing ----------------------------------------

    def _now(self) -> int:
        return int(self.clock()) if self.clock is not None else 0

    def _emit(self, kind: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.emit(kind, self._now(), **fields)

    def _count(self, name: str, by: int = 1, **labels) -> None:
        if self.metrics is not None:
            self.metrics.counter(name, **labels).inc(by)

    # -- ingestion ------------------------------------------------------

    def record(self, op: str, seconds: float,
               payload_bytes: Optional[float] = None,
               tenant: Optional[str] = None) -> None:
        """One live timing of the ACTIVE plan (the
        ``SampleSink`` signature, so
        ``timed(sink=tuner)`` needs no adapter)."""
        if seconds < 0:
            raise ValueError(f"negative sample {seconds} for {op!r}")
        bucket = sample_bucket_bytes(payload_bytes)
        key = (str(op), bucket, tenant)
        cell = self.cells.get(key)
        if cell is None:
            cell = self.cells[key] = _ShadowCell()
        cell.add(float(seconds) * 1e6)
        self.samples_ingested += 1
        self._emit("tune.sample", op=str(op), bucket=bucket,
                   tenant=tenant)
        self._count("tune_samples_total", op=str(op))

    def ingest(self, sink) -> int:
        """Bulk-ingest a recorded :class:`SampleSink` (the object, its
        ``snapshot()`` dict, or a bare ``entries()`` list) — the
        ``smi-tpu tune --online`` offline-replay path. Returns the
        number of samples folded in; malformed entries are a loud
        ValueError naming the entry.

        Bucket vocabulary caveat: a SampleSink bucket is an
        UPPER-bound power of two covering payloads in ``(B/2, B]``,
        which straddles two plan buckets (``[B/2, B)`` for interior
        payloads, ``[B, 2B)`` for exactly ``B``). The exact payloads
        are gone by the time the sink aggregated, so this mapping
        takes the bound itself as the representative — exact for the
        pow2-aligned payloads this framework's sweeps and collective
        buffers actually use (64 KiB/1 MiB/4 MiB grids), one bucket
        high for interior-heavy traffic. Workloads with interior
        payloads should feed the tuner LIVE via :meth:`record`,
        which buckets the exact payload in the plan vocabulary
        (pinned by tests/test_retune.py)."""
        if hasattr(sink, "entries"):
            entries = sink.entries()
        elif isinstance(sink, dict):
            entries = sink.get("entries")
        else:
            entries = sink
        if not isinstance(entries, (list, tuple)):
            raise ValueError(
                f"a sample sink is a SampleSink, its snapshot dict, "
                f"or an entries list; got {type(sink).__name__}"
            )
        total = 0
        for i, entry in enumerate(entries):
            if (not isinstance(entry, dict)
                    or not isinstance(entry.get("knobs"), dict)
                    or not isinstance(entry.get("cost_us"), (int, float))):
                raise ValueError(
                    f"sample-sink entry {i} is not the SampleSink "
                    f"vocabulary {{'knobs': {{'op': ..., "
                    f"'samples': ...}}, 'cost_us': ...}}: {entry!r}"
                )
            knobs = entry["knobs"]
            op = knobs.get("op")
            samples = knobs.get("samples")
            if not isinstance(op, str) or not isinstance(samples, int) \
                    or samples < 1:
                raise ValueError(
                    f"sample-sink entry {i} needs a string 'op' and a "
                    f"positive integer 'samples' in its knobs, got "
                    f"op={op!r} samples={samples!r}"
                )
            bucket = knobs.get("payload_bucket_bytes")
            tenant = knobs.get("tenant")
            # representative payload = the sink bucket's bound itself
            # (see the docstring's vocabulary caveat)
            key = (op, sample_bucket_bytes(bucket), tenant)
            cell = self.cells.get(key)
            if cell is None:
                cell = self.cells[key] = _ShadowCell()
            cell.add(float(entry["cost_us"]), n=samples)
            if knobs.get("min_us") is not None:
                cell.min_us = min(cell.min_us, float(knobs["min_us"]))
            if knobs.get("max_us") is not None:
                cell.max_us = max(cell.max_us, float(knobs["max_us"]))
            total += samples
            self._emit("tune.sample", op=op,
                       bucket=sample_bucket_bytes(bucket),
                       tenant=tenant, samples=samples)
            self._count("tune_samples_total", by=samples, op=op)
        self.samples_ingested += total
        return total

    # -- the shadow comparison -----------------------------------------

    def plan_key(self, op: str,
                 bucket_bytes: Optional[int]) -> Optional[PlanKey]:
        """The plan-cache key a cell's samples speak about, or ``None``
        for unbucketed (hence untunable) cells."""
        if bucket_bytes is None:
            return None
        return PlanKey(op, payload_bucket(bucket_bytes), self.dtype,
                       self.device_kind,
                       _collective_topology(self.topo))

    def swap_for(self, key: PlanKey) -> PlanSwap:
        sig = key.signature()
        swap = self._swaps.get(sig)
        if swap is None:
            swap = self._swaps[sig] = PlanSwap(self.cache, key)
        return swap

    def _lossy_rivals_armed(self) -> bool:
        """Is there MEASURED evidence that a lossy wire width works on
        this device kind — the quantized sweep's distilled
        ``precision_threshold`` crossover? Mirrors the plan engine's
        ladder: without it the live tier, like the model rung, only
        reroutes (algorithm swaps) and never flips numerics."""
        outer = ((self.topo.outer or 0)
                 if self.topo.hierarchical_eligible else 0)
        for kind in (self.device_kind, "unknown"):
            hit = self.cache.lookup(
                PlanKey("all_reduce", "precision_threshold", "", kind,
                        f"dcn{outer}" if outer else "flat")
            )
            if (hit is not None
                    and "precision_min_bytes" in hit.knobs
                    and "precision" in hit.knobs):
                return True
        return False

    def active_entry(self, key: Optional[PlanKey]) -> Optional[CacheEntry]:
        return None if key is None else self.cache.lookup(key)

    def plan_epoch(self, key: PlanKey) -> int:
        return self.swap_for(key).plan_epoch

    def total_plan_epoch(self) -> int:
        """Monotone sum of every key's plan epoch — the one scalar a
        host stamps onto in-flight work to know whether ANY plan
        changed since it was admitted (the serving front-end's
        re-plan bookkeeping)."""
        return sum(s.plan_epoch for s in self._swaps.values())

    def maybe_propose(self, now: int = 0,
                      drain_census: Optional[Callable] = None
                      ) -> List[PlanSwap]:
        """Scan the cells; stage a :class:`PlanSwap` proposal for every
        one past BOTH thresholds whose best rival candidate beats the
        active plan's measured mean by the margin. ``drain_census``
        maps a proposal-evidence dict to the frozenset of in-flight
        stream ids keyed to the old plan (the host's knowledge);
        ``None`` = nothing to drain. Deterministic scan order."""
        proposed: List[PlanSwap] = []
        for (op, bucket, tenant) in sorted(
            self.cells,
            key=lambda k: (k[0], -1 if k[1] is None else k[1],
                           k[2] or ""),
        ):
            cell = self.cells[(op, bucket, tenant)]
            if op not in TUNABLE_OPS or bucket is None:
                continue
            if cell.count < self.min_samples:
                continue
            key = self.plan_key(op, bucket)
            swap = self.swap_for(key)
            if swap.in_flight():
                continue
            entry = self.active_entry(key)
            if entry is None or "algorithm" not in entry.knobs:
                # nothing to retune: first plans are the sweep's job
                continue
            # the plan's identity is (algorithm, wire precision): an
            # int8 row with the active algorithm is a genuine rival
            # of the dense plan, and vice versa
            active = str(entry.knobs["algorithm"])
            active_id = (active,
                         str(entry.knobs.get("precision", "f32")))
            cands = op_candidates(op, bucket, self.topo, self.link,
                                  dtype=self.dtype)
            # the r19 asymmetry holds on the live tier too: a lossy
            # width is model-priced here, and the model alone must
            # never flip numerics — lossy rows join the rival pool
            # only once a measured precision artifact exists (the
            # quantized sweep's crossover, or the active plan already
            # runs a lossy width and we're retuning between widths)
            lossy_armed = (active_id[1] != "f32"
                           or self._lossy_rivals_armed())
            rivals = [
                c for c in cands
                if (str(c.knobs.get("algorithm")),
                    str(c.knobs.get("precision", "f32"))) != active_id
                and c.modeled_us is not None
                and (lossy_armed
                     or str(c.knobs.get("precision", "f32")) == "f32")
            ]
            if not rivals:
                continue
            best = min(rivals, key=lambda c: c.modeled_us)
            measured = cell.mean_us
            if measured < best.modeled_us * self.margin:
                continue   # inside the hysteresis band: hold the plan
            advantage = measured / best.modeled_us
            rival_algo = str(best.knobs["algorithm"])
            evidence = {
                "op": op, "bucket": bucket, "tenant": tenant,
                "from": active, "to": rival_algo,
                "samples": cell.count,
                "measured_us": round(measured, 3),
                "rival_modeled_us": round(best.modeled_us, 3),
                "advantage": round(advantage, 2),
            }
            rival_precision = str(best.knobs.get("precision", "f32"))
            if rival_precision != "f32" or active_id[1] != "f32":
                # a precision change is named in the evidence — a
                # numerics-affecting swap must never look like a pure
                # routing change in the audit log
                evidence["from_precision"] = active_id[1]
                evidence["to_precision"] = rival_precision
            new_entry = CacheEntry(
                knobs=dict(best.knobs),
                cost_us=None,
                provenance=(
                    f"live:retune:samples={cell.count}:"
                    f"margin={advantage:.2f}x"
                    + (f":tenant={tenant}" if tenant else "")
                ),
            )
            drain = (drain_census(evidence) if drain_census is not None
                     else frozenset())
            swap.propose(new_entry, evidence=evidence, drain=drain)
            self.proposals += 1
            self._emit("tune.propose", op=op, bucket=bucket,
                       from_algo=active, to_algo=rival_algo,
                       samples=cell.count,
                       margin=round(advantage, 2), tenant=tenant)
            self._count("tune_proposals_total", op=op)
            proposed.append(swap)
        return proposed

    # -- driving the swap machine --------------------------------------

    def pending_swaps(self) -> List[PlanSwap]:
        return [s for s in self._swaps.values() if s.in_flight()]

    def start_quiesce(self, swap: PlanSwap,
                      now: Optional[int] = None) -> None:
        swap.quiesce(now if now is not None else self._now())

    def execute_swap(self, swap: PlanSwap) -> CacheEntry:
        """Install the rival entry (revision-bumped, plan epoch
        bumped) and reset every cell speaking about this key — the
        fresh window measures the NEW plan, so a just-committed swap
        can never immediately re-propose itself away."""
        installed = swap.swap()
        self.swaps += 1
        ev = swap.proposal.evidence
        self._emit("tune.swap", op=str(ev.get("op")),
                   bucket=ev.get("bucket"),
                   to_algo=str(ev.get("to")),
                   plan_epoch=swap.plan_epoch,
                   revision=installed.revision)
        self._count("tune_swaps_total", op=str(ev.get("op")))
        sig = swap.key.signature()
        for cell_key in list(self.cells):
            k = self.plan_key(cell_key[0], cell_key[1])
            if k is not None and k.signature() == sig:
                self.cells[cell_key] = _ShadowCell()
        return installed

    def commit(self, swap: PlanSwap) -> None:
        swap.commit()

    def rollback(self, swap: PlanSwap, reason: str = "",
                 now: Optional[int] = None) -> None:
        ev = swap.proposal.evidence if swap.proposal else {}
        swap.rollback(reason)
        self.rollbacks += 1
        self._emit("tune.rollback", op=str(ev.get("op")),
                   bucket=ev.get("bucket"), reason=reason)
        self._count("tune_rollbacks_total",
                    reason=reason or "explicit")

    def run_offline(self) -> List[Tuple[str, Dict[str, object]]]:
        """Drive every qualified proposal straight through the full
        arc (nothing is in flight offline, so quiesce is immediate) —
        the ``smi-tpu tune --online`` engine. Returns the decision
        log: ``("propose", evidence)`` and ``("swap", outcome)``
        records in order."""
        decisions: List[Tuple[str, Dict[str, object]]] = []
        for swap in self.maybe_propose():
            decisions.append(("propose", dict(swap.proposal.evidence)))
        for swap in list(self.pending_swaps()):
            self.start_quiesce(swap, 0)
            installed = self.execute_swap(swap)
            self.commit(swap)
            decisions.append(("swap", {
                "key": swap.key.signature(),
                "algorithm": installed.knobs.get("algorithm"),
                "revision": installed.revision,
                "plan_epoch": swap.plan_epoch,
                "provenance": installed.provenance,
            }))
        return decisions

    # -- reporting ------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        """The campaign-report / ``serve --selftest --retune`` block:
        the bookkeeping the tune_* counters mirror, plus every live
        entry currently installed."""
        live_entries = {
            sig: e.to_json()
            for sig, e in sorted(self.cache.entries.items())
            if e.provenance.startswith("live:")
        }
        return {
            "samples_ingested": self.samples_ingested,
            "cells": len(self.cells),
            "proposals": self.proposals,
            "swaps": self.swaps,
            "rollbacks": self.rollbacks,
            "min_samples": self.min_samples,
            "margin": self.margin,
            "plan_epochs": {
                sig: s.plan_epoch
                for sig, s in sorted(self._swaps.items())
                if s.plan_epoch
            },
            "live_entries": live_entries,
        }
