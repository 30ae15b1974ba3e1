"""QoS classes, brownout policy, and the named admission error.

The port's copy of :mod:`smi_tpu.serving.qos`, kept in step with it
line for line (pure Python).

The serving front-end (:mod:`smi_tpu_torch.serving.frontend`) multiplexes
many tenants onto the channel substrate; this module is its *policy*
surface — the constants every other serving layer (and
``docs/robustness.md``, drift-guarded by ``tests/test_perf_docs.py``)
quotes:

- three priority classes, strictly ordered (``interactive`` >
  ``batch`` > ``best_effort``);
- the **brownout ceilings**: the fraction of the stream-credit pool a
  class may occupy before *that class* is shed. Ceilings are ordered
  lowest-class-lowest, which is what makes shedding
  lowest-class-first structural rather than heuristic: as occupancy
  climbs, ``best_effort`` hits its ceiling first, then ``batch``;
  ``interactive`` is refused only when the pool is fully exhausted;
- per-class **admission wait caps**: a request may queue at the
  admission edge at most this long before it is shed with a named
  error — the mechanism that keeps admission latency *bounded*
  instead of letting the pending queue become an unbounded buffer;
- per-class end-to-end **deadline budgets** (step-clock ticks),
  propagated from the request into per-chunk
  :class:`~smi_tpu_torch.utils.watchdog.Deadline` checks.

Every rejection is a named :class:`AdmissionRejected` carrying the
tenant, the class, the queue depth at decision time, and the reason —
never a silent drop, and never after acceptance (an accepted stream
is delivered or the run fails loudly).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: Priority classes, highest priority first. The tuple order IS the
#: scheduling and admission order everywhere in the serving layer.
QOS_CLASSES = ("interactive", "batch", "best_effort")

#: Strict priority rank per class (lower = served first).
CLASS_PRIORITY = {c: i for i, c in enumerate(QOS_CLASSES)}

#: Brownout ceilings: class ``c`` is admitted only while pool
#: occupancy < ``ceil(ceiling * pool)``. best_effort 50%, batch 75%,
#: interactive 100% — the lowest class browns out first by
#: construction.
CLASS_POOL_CEILING = {
    "interactive": 1.0,
    "batch": 0.75,
    "best_effort": 0.5,
}

#: Admission wait caps (ticks): a pending request older than this is
#: shed with reason ``admission-timeout``. Interactive waits least —
#: it would rather fail fast than queue.
CLASS_ADMISSION_WAIT_TICKS = {
    "interactive": 12,
    "batch": 48,
    "best_effort": 96,
}

#: End-to-end deadline budgets (ticks) propagated from the request
#: into per-chunk Deadline checks. Sized to absorb a failure-detection
#: window (~60 ticks) plus a full replay to an heir — an accepted
#: stream's deadline firing is a *named* campaign failure, never a
#: silent loss.
CLASS_DEADLINE_TICKS = {
    "interactive": 400,
    "batch": 1200,
    "best_effort": 2400,
}

#: The p99 admission-latency bound (ticks) the campaigns assert for
#: the interactive class. Deliberately BELOW the interactive wait cap:
#: the cap makes latency bounded by shedding; this bound additionally
#: proves interactive requests actually jump the pending queue.
INTERACTIVE_P99_TICKS = 8


class AdmissionRejected(RuntimeError):
    """A request was refused at the admission edge — loudly.

    Carries the ``tenant``, the ``qos`` class, the ``queue_depth``
    (held stream credits + pending requests) at decision time, and
    the ``reason``:

    - ``tenant-rate`` — the tenant's token bucket is empty (per-tenant
      isolation; independent of class);
    - ``brownout:<class>`` — pool occupancy reached the class ceiling
      AND a full pool's worth of the class is already parked (the QoS
      shed path; lowest class first by ceiling order — the backpressure
      edge never buffers unboundedly);
    - ``admission-timeout`` — a parked request waited out its class's
      admission cap without a credit freeing.

    A rejection happens only BEFORE acceptance: once a stream holds a
    credit it is delivered bit-identically or the run fails with a
    named error — "accepted then lost" is the outcome the serving
    gates forbid.
    """

    def __init__(self, tenant: str, qos: str, queue_depth: int,
                 reason: str):
        super().__init__(
            f"admission rejected for tenant {tenant!r} class {qos}: "
            f"{reason} (queue depth {queue_depth})"
        )
        self.tenant = tenant
        self.qos = qos
        self.queue_depth = queue_depth
        self.reason = reason
        #: bounded flight-recorder tail attached by the gate when a
        #: recorder is wired (:mod:`smi_tpu_torch.obs.events`) — the causal
        #: history behind the shed, riding the error itself
        self.recorder_tail: Optional[dict] = None

    def __reduce__(self):
        # exceptions pickle as cls(*args), but args holds the rendered
        # message, not the constructor fields — without this, a gate
        # whose rejection audit trail is copied (the model checker
        # forks worlds; campaign reports deep-copy cells) dies with a
        # TypeError instead of round-tripping. The third element
        # (state dict) keeps the flight-recorder tail on the copy.
        return (
            type(self),
            (self.tenant, self.qos, self.queue_depth, self.reason),
            {"recorder_tail": self.recorder_tail},
        )


def check_qos(qos: str) -> str:
    if qos not in QOS_CLASSES:
        raise ValueError(
            f"unknown QoS class {qos!r}; known: {QOS_CLASSES}"
        )
    return qos


@dataclasses.dataclass
class Request:
    """One tenant request: a stream of chunk payloads to deliver.

    ``stream_id`` is the tenant-scoped transient stream identity
    (tenant, per-tenant sequence number) — the serving analog of the
    reference's per-message transient channels. ``deadline_ticks``
    defaults to the class budget. ``base_rank`` (>= 0) overrides the
    tenant-hash routing with an explicit base destination — the MoE
    expert-dispatch path, where the stream must reach a specific
    expert's home rank; failover to heirs still rides
    ``membership.route_owner`` on top of it. ``None`` keeps the hash
    routing, byte-for-byte the pre-MoE behaviour.
    """

    tenant: str
    qos: str
    chunks: Tuple
    arrived_at: int
    stream_id: Tuple[str, int] = ("", -1)
    deadline_ticks: Optional[int] = None
    base_rank: Optional[int] = None

    def __post_init__(self):
        check_qos(self.qos)
        if not self.chunks:
            raise ValueError("a request must carry at least one chunk")
        if self.deadline_ticks is None:
            self.deadline_ticks = CLASS_DEADLINE_TICKS[self.qos]


def percentile(samples, q: float) -> Optional[float]:
    """Deterministic nearest-rank percentile (no numpy dependency in
    the pure-Python serving core). ``None`` on an empty sample set."""
    import math

    if not samples:
        return None
    ordered = sorted(samples)
    # nearest-rank: ceil(q * N), 1-indexed
    rank = max(1, math.ceil(q * len(ordered)))
    return float(ordered[rank - 1])
