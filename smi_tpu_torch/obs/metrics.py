"""Metrics registry: counters, gauges, histograms, timing samples.

The port's copy of :mod:`smi_tpu.obs.metrics`, kept in step with it
line for line: the same samples give the same snapshot.

The numeric half of the observability layer. Events
(:mod:`smi_tpu_torch.obs.events`) answer *what happened, in what order*;
metrics answer *how much, how often, how long* — the shape a campaign
report, ``serve --selftest``, and the bench ``obs`` field can carry
without shipping the whole event stream.

Design constraints, in order:

- **deterministic** — no wall time, no process state: a snapshot is a
  pure function of the recorded values, keys are sorted, histogram
  buckets are fixed powers of two. Same seed, byte-identical JSON.
- **bounded** — counters/gauges are O(label-set); histograms store
  bucket counts, never samples. The one sample-holding structure
  (:class:`SampleSink`) aggregates per key.
- **honest** — a histogram's ``overflow`` bucket is explicit;
  :class:`SampleSink` never claims more precision than count/total/
  min/max support.

:class:`SampleSink` is the live-measurement substrate ROADMAP item 3
(online autotuning) consumes: per-(op, payload-bucket, tenant) timing
samples distilled to the plan cache's entry vocabulary
(``knobs`` + measured ``cost_us`` + provenance — the
:class:`~smi_tpu_torch.tuning.cache.CacheEntry` JSON shape), so a future
shadow-compare can diff a live sample directly against the active
plan entry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

#: Histogram bucket upper bounds are powers of two starting here — a
#: fixed, data-independent grid (deterministic across runs and
#: payload distributions).
_FIRST_BUCKET = 1.0

#: Number of power-of-two histogram buckets before ``overflow``.
_BUCKETS = 20


def _labels_key(labels: Dict[str, object]) -> str:
    """Canonical label rendering: ``name{a=1,b=x}`` with sorted keys —
    the snapshot's dict key, stable across insertion orders."""
    if not labels:
        return ""
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return "{" + inner + "}"


class Counter:
    """Monotone event count."""

    def __init__(self) -> None:
        self.value = 0

    def inc(self, by: int = 1) -> None:
        if by < 0:
            raise ValueError(f"counter increments must be >= 0, got {by}")
        self.value += by


class Gauge:
    """Last-set value plus the running max (queue depths, occupancy —
    the max is what the bounds gates quote)."""

    def __init__(self) -> None:
        self.value: float = 0
        self.max: float = 0

    def set(self, value) -> None:
        self.value = value
        if value > self.max:
            self.max = value


class Histogram:
    """Fixed power-of-two buckets; stores counts, sum, min, max.

    Bucket ``i`` counts samples ``<= 2**i`` (upper-inclusive,
    starting at :data:`_FIRST_BUCKET`); larger samples land in the
    explicit ``overflow`` bucket — bounded state, no silent clipping.
    """

    def __init__(self) -> None:
        self.buckets: List[int] = [0] * _BUCKETS
        self.overflow = 0
        self.count = 0
        self.total: float = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        bound = _FIRST_BUCKET
        for i in range(_BUCKETS):
            if v <= bound:
                self.buckets[i] += 1
                return
            bound *= 2.0
        self.overflow += 1

    def to_json(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "buckets": list(self.buckets),
            "overflow": self.overflow,
        }


class MetricsRegistry:
    """Named, labeled metric instruments with deterministic snapshots.

    ``counter/gauge/histogram(name, **labels)`` find-or-create the
    instrument for one (name, label-set); a name may not change type
    (loud TypeError — a counter silently re-read as a gauge is a
    consumer bug). ``snapshot()`` renders everything as sorted JSON:
    byte-identical per run history.
    """

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, str], object] = {}
        self._types: Dict[str, type] = {}

    def _get(self, cls: type, name: str, labels: Dict[str, object]):
        want = self._types.setdefault(name, cls)
        if want is not cls:
            raise TypeError(
                f"metric {name!r} is a {want.__name__}, requested as "
                f"{cls.__name__}"
            )
        key = (name, _labels_key(labels))
        metric = self._metrics.get(key)
        if metric is None:
            metric = self._metrics[key] = cls()
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``
        with ``name{labels}`` keys, sorted — the campaign-report /
        ``serve --selftest --metrics`` payload."""
        counters: Dict[str, int] = {}
        gauges: Dict[str, dict] = {}
        histograms: Dict[str, dict] = {}
        for (name, labels), metric in self._metrics.items():
            key = name + labels
            if isinstance(metric, Counter):
                counters[key] = metric.value
            elif isinstance(metric, Gauge):
                gauges[key] = {"value": metric.value, "max": metric.max}
            else:
                histograms[key] = metric.to_json()
        return {
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": dict(sorted(histograms.items())),
        }


# ---------------------------------------------------------------------------
# Timing samples (the ROADMAP item 3 substrate)
# ---------------------------------------------------------------------------


def payload_bucket(payload_bytes: Optional[float]) -> Optional[int]:
    """Power-of-two payload bucket (bytes, upper bound): the plan
    engine's payload-tier vocabulary. ``None`` payload -> ``None``
    bucket (an un-sized op still aggregates under one key)."""
    if payload_bytes is None:
        return None
    b = 1
    while b < payload_bytes:
        b <<= 1
    return b


@dataclasses.dataclass
class _SampleCell:
    count: int = 0
    total_s: float = 0.0
    min_s: Optional[float] = None
    max_s: Optional[float] = None

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        if self.min_s is None or seconds < self.min_s:
            self.min_s = seconds
        if self.max_s is None or seconds > self.max_s:
            self.max_s = seconds


class SampleSink:
    """Per-(op, payload-bucket, tenant) timing samples, aggregated.

    The hook target of :func:`smi_tpu_torch.utils.tracing.timed`'s ``sink=``
    and the scheduler's per-chunk timings: every recorded sample folds
    into one bounded cell per key. :meth:`entries` renders the cells
    in the plan cache's entry vocabulary (``knobs`` + measured
    ``cost_us`` + ``provenance``) so the online-autotuning arc can
    shadow-compare a live cell against the active
    :class:`~smi_tpu_torch.tuning.cache.CacheEntry` without translation.
    """

    def __init__(self) -> None:
        self._cells: Dict[Tuple[str, Optional[int], Optional[str]],
                          _SampleCell] = {}

    def record(self, op: str, seconds: float,
               payload_bytes: Optional[float] = None,
               tenant: Optional[str] = None) -> None:
        if seconds < 0:
            raise ValueError(f"negative sample {seconds} for {op!r}")
        key = (str(op), payload_bucket(payload_bytes), tenant)
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _SampleCell()
        cell.add(float(seconds))

    def __len__(self) -> int:
        return sum(c.count for c in self._cells.values())

    def entries(self) -> List[dict]:
        """Plan-cache-compatible aggregates, deterministically ordered
        by (op, bucket, tenant). ``cost_us`` is the mean (the cache's
        one scalar); min/max ride in ``knobs`` so a swing is visible
        next to the mean it would destabilize."""
        out = []
        for (op, bucket, tenant) in sorted(
            self._cells,
            key=lambda k: (k[0], -1 if k[1] is None else k[1],
                           k[2] or ""),
        ):
            cell = self._cells[(op, bucket, tenant)]
            knobs: Dict[str, object] = {"op": op}
            if bucket is not None:
                knobs["payload_bucket_bytes"] = bucket
            if tenant is not None:
                knobs["tenant"] = tenant
            knobs["samples"] = cell.count
            knobs["min_us"] = round(cell.min_s * 1e6, 3)
            knobs["max_us"] = round(cell.max_s * 1e6, 3)
            out.append({
                "knobs": knobs,
                "cost_us": round(cell.total_s / cell.count * 1e6, 3),
                "provenance": "obs:sample_sink",
            })
        return out

    def snapshot(self) -> dict:
        return {"samples": len(self), "entries": self.entries()}
