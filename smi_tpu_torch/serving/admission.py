"""Admission gate: token buckets, stream credits, bounded queues.

The port's copy of :mod:`smi_tpu.serving.admission`, kept in step
with it line for line: the same requests give the same decisions.

The gate is the serving edge of the credit discipline the wire already
enforces (:mod:`smi_tpu_torch.parallel.credits`): a bounded pool of **stream
credits** plays the role the receiver's buffer slots play on the wire.
A stream holds its credit from acceptance until its LAST chunk is
consumed and verified at the destination — not merely sent — so the
credit chain runs end to end: a stalled consumer keeps wire credits
held, which keeps its streams incomplete, which keeps stream credits
held, which drives pool occupancy to the brownout ceilings, which sheds
new requests *at the admission edge* with a named error. Queue growth
is bounded by construction (pool + per-class pending caps) and the gate
asserts the bound on every transition.

Three decision layers, in order:

1. **per-tenant token bucket** — isolation between tenants, class-blind
   (reason ``tenant-rate``);
2. **brownout ceilings** (:data:`~smi_tpu_torch.serving.qos.CLASS_POOL_CEILING`)
   — occupancy-triggered, lowest class first. A short burst above the
   ceiling parks in the class's bounded pending queue; sustained
   overload (a full pool's worth of the class already waiting) sheds
   immediately with reason ``brownout:<class>``;
3. **bounded pending wait** — a parked request waits at most its
   class's admission cap for a credit to free (priority classes drain
   first), then is shed (reason ``admission-timeout``).

Every shed is recorded as a full :class:`~smi_tpu_torch.serving.qos.AdmissionRejected`
instance; nothing is dropped silently.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from smi_tpu_torch.serving.qos import (
    CLASS_ADMISSION_WAIT_TICKS,
    CLASS_POOL_CEILING,
    QOS_CLASSES,
    AdmissionRejected,
    Request,
)

#: Default stream-credit pool: concurrent accepted streams across all
#: classes. The serving queue-occupancy bound (asserted, and quoted by
#: docs/robustness.md).
DEFAULT_POOL = 12

#: Pending-queue bound per class: one pool's worth. A class with a
#: full pool of requests already parked is in *sustained* brownout —
#: new arrivals would only time out behind the waiters, so they are
#: shed immediately (``brownout:<class>``) instead of buffered. This
#: is what keeps the admission edge a bounded buffer: queue depth can
#: never exceed ``pool * (1 + len(QOS_CLASSES))``.

#: Default per-tenant token bucket: sustained streams/tick and burst.
DEFAULT_TENANT_RATE = 0.25
DEFAULT_TENANT_BURST = 6.0


class TokenBucket:
    """Deterministic token bucket on the step clock (no wall time)."""

    def __init__(self, rate_per_tick: float, burst: float):
        if rate_per_tick <= 0 or burst < 1:
            raise ValueError(
                f"need rate > 0 and burst >= 1, got rate="
                f"{rate_per_tick}, burst={burst}"
            )
        self.rate = float(rate_per_tick)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = 0

    def _refill(self, now: int) -> None:
        if now > self._last:
            self.tokens = min(
                self.burst, self.tokens + (now - self._last) * self.rate
            )
            self._last = now

    def try_take(self, now: int) -> bool:
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclasses.dataclass
class _Pending:
    request: Request
    since: int


class AdmissionGate:
    """Bounded multi-class admission with end-to-end credit chaining.

    ``on_admit(request, waited_ticks)`` is called for every admission
    (immediate or from the pending queue); ``on_shed(rejection,
    request)`` for every shed. Credits return via :meth:`release`
    (call when the stream's last chunk is consumed and verified —
    NOT when it is sent), which immediately drains the pending
    queues highest-class-first.
    """

    def __init__(
        self,
        pool: int = DEFAULT_POOL,
        tenant_rate: float = DEFAULT_TENANT_RATE,
        tenant_burst: float = DEFAULT_TENANT_BURST,
        ceilings: Optional[Dict[str, float]] = None,
        wait_caps: Optional[Dict[str, int]] = None,
        recorder=None,
        metrics=None,
    ):
        if pool < 1:
            raise ValueError(f"pool must be >= 1, got {pool}")
        self.pool = pool
        #: observability hooks (both optional, zero-cost when None):
        #: ``recorder`` — a flight recorder
        #: (:class:`smi_tpu_torch.obs.events.FlightRecorder`) receiving one
        #: ``serve.admit`` / ``serve.park`` / ``serve.shed`` event per
        #: decision, and whose bounded tail rides every
        #: :class:`AdmissionRejected`; ``metrics`` — a
        #: :class:`smi_tpu_torch.obs.metrics.MetricsRegistry` fed the
        #: admitted/shed/parked counters, the per-(tenant, class)
        #: admission-wait histogram, and the queue-depth gauge. The
        #: counters are incremented at the SAME sites as the gate's
        #: own accounting, so a metrics snapshot can never disagree
        #: with the campaign report's bookkeeping.
        self.recorder = recorder
        self.metrics = metrics
        self._now = 0
        self.tenant_rate = tenant_rate
        self.tenant_burst = tenant_burst
        self.ceilings = dict(ceilings or CLASS_POOL_CEILING)
        self.wait_caps = dict(wait_caps or CLASS_ADMISSION_WAIT_TICKS)
        self._buckets: Dict[str, TokenBucket] = {}
        self.held: Dict[str, int] = {c: 0 for c in QOS_CLASSES}
        self.pending: Dict[str, Deque[_Pending]] = {
            c: deque() for c in QOS_CLASSES
        }
        self.pending_bound = pool
        # accounting (the campaign report reads these)
        self.admitted: Dict[str, int] = {c: 0 for c in QOS_CLASSES}
        self.shed: Dict[str, Dict[str, int]] = {
            c: {} for c in QOS_CLASSES
        }
        self.rejections: List[AdmissionRejected] = []
        self.admission_waits: Dict[str, List[int]] = {
            c: [] for c in QOS_CLASSES
        }
        self.max_queue_depth = 0
        self.on_admit: Optional[Callable[[Request, int], None]] = None
        self.on_shed: Optional[
            Callable[[AdmissionRejected, Request], None]
        ] = None
        #: Optional caller predicate consulted before any PENDING
        #: request is admitted (the front-end's per-destination
        #: backlog cap): False keeps it parked — it may admit on a
        #: later pump or time out with a named shed. Immediate
        #: admissions in :meth:`offer` are the caller's own
        #: responsibility (it can check before offering).
        self.admit_filter: Optional[Callable[[Request], bool]] = None

    # -- bookkeeping ----------------------------------------------------

    def occupancy(self) -> int:
        """Stream credits currently held (accepted, incomplete)."""
        return sum(self.held.values())

    def queue_depth(self) -> int:
        """Held credits + pending requests: the serving queue the
        bound covers."""
        return self.occupancy() + sum(
            len(q) for q in self.pending.values()
        )

    def assert_bounded(self) -> None:
        """The structural occupancy bound, asserted on every
        transition: held <= pool and each pending queue <= its cap.
        A violation is a front-end bug, not an overload symptom —
        overload must surface as shedding, never as growth."""
        occ = self.occupancy()
        if occ > self.pool:
            raise AssertionError(
                f"stream-credit occupancy {occ} exceeds pool {self.pool}"
            )
        for c, q in self.pending.items():
            if len(q) > self.pending_bound:
                raise AssertionError(
                    f"pending queue for {c} grew to {len(q)} "
                    f"(bound {self.pending_bound})"
                )
        self.max_queue_depth = max(self.max_queue_depth,
                                   self.queue_depth())
        if self.metrics is not None:
            self.metrics.gauge("queue_depth").set(self.queue_depth())
            self.metrics.gauge("pool_occupancy").set(occ)

    def _ceiling_slots(self, qos: str) -> int:
        return math.ceil(self.ceilings[qos] * self.pool)

    def _can_admit(self, qos: str) -> bool:
        return self.occupancy() < self._ceiling_slots(qos)

    def shed_named(self, request: Request, reason: str
                   ) -> AdmissionRejected:
        """Record an externally-decided shed (e.g. the front-end's
        per-destination backpressure cap) under the gate's accounting,
        so every rejection in the system flows through one audited
        path. Returns the named error for the caller to raise."""
        return self._record_shed(request, reason)

    def _record_shed(self, request: Request, reason: str
                     ) -> AdmissionRejected:
        rejection = AdmissionRejected(
            request.tenant, request.qos, self.queue_depth(), reason
        )
        self.shed[request.qos][reason] = (
            self.shed[request.qos].get(reason, 0) + 1
        )
        self.rejections.append(rejection)
        if self.recorder is not None:
            from smi_tpu_torch.obs.events import attach_tail

            self.recorder.emit(
                "serve.shed", self._now, tenant=request.tenant,
                qos=request.qos, reason=reason,
                stream_seq=request.stream_id[1],
            )
            # a shed names its causal history, not just its reason
            attach_tail(rejection, self.recorder)
        if self.metrics is not None:
            self.metrics.counter("shed_total", qos=request.qos,
                                 reason=reason).inc()
        if self.on_shed is not None:
            self.on_shed(rejection, request)
        return rejection

    def _admit(self, request: Request, now: int) -> None:
        self.held[request.qos] += 1
        self.admitted[request.qos] += 1
        waited = now - request.arrived_at
        self.admission_waits[request.qos].append(waited)
        if self.recorder is not None:
            self.recorder.emit(
                "serve.admit", now, tenant=request.tenant,
                qos=request.qos, waited=waited,
                stream_seq=request.stream_id[1],
            )
        if self.metrics is not None:
            self.metrics.counter("admitted_total",
                                 qos=request.qos).inc()
            self.metrics.histogram(
                "admission_wait_ticks", tenant=request.tenant,
                qos=request.qos,
            ).observe(waited)
        if self.on_admit is not None:
            self.on_admit(request, waited)
        self.assert_bounded()

    # -- the gate -------------------------------------------------------

    def offer(self, request: Request, now: int) -> bool:
        """One request at the admission edge.

        Returns True when admitted immediately, False when parked in
        the (bounded) pending queue; raises
        :class:`~smi_tpu_torch.serving.qos.AdmissionRejected` when shed on
        the spot. Deferred sheds (admission-timeout) surface through
        ``on_shed``/``rejections`` — every outcome is named either way.
        """
        self._now = now
        bucket = self._buckets.get(request.tenant)
        if bucket is None:
            bucket = self._buckets[request.tenant] = TokenBucket(
                self.tenant_rate, self.tenant_burst
            )
        if not bucket.try_take(now):
            raise self._record_shed(request, "tenant-rate")
        if self._can_admit(request.qos):
            self._admit(request, now)
            return True
        if len(self.pending[request.qos]) >= self.pending_bound:
            # sustained brownout: a full pool of this class already
            # waits; buffering more would only convert the shed into
            # a slower admission-timeout
            raise self._record_shed(request, f"brownout:{request.qos}")
        # a short burst above the ceiling parks: a credit may free
        # within the class's wait cap
        self.pending[request.qos].append(_Pending(request, now))
        if self.recorder is not None:
            self.recorder.emit("serve.park", now, tenant=request.tenant,
                               qos=request.qos,
                               stream_seq=request.stream_id[1])
        if self.metrics is not None:
            self.metrics.counter("parked_total", qos=request.qos).inc()
        self.assert_bounded()
        return False

    def pump(self, now: int) -> List[Request]:
        """Drain the pending tier: shed requests that waited out their
        class cap, then admit in strict class-priority order while
        ceilings allow. Returns the newly admitted requests."""
        self._now = now
        admitted: List[Request] = []
        for qos in QOS_CLASSES:
            queue = self.pending[qos]
            keep: Deque[_Pending] = deque()
            while queue:
                p = queue.popleft()
                if now - p.since > self.wait_caps[qos]:
                    self._record_shed(p.request, "admission-timeout")
                elif self._can_admit(qos) and (
                    self.admit_filter is None
                    or self.admit_filter(p.request)
                ):
                    self._admit(p.request, now)
                    admitted.append(p.request)
                else:
                    keep.append(p)
            self.pending[qos] = keep
        self.assert_bounded()
        return admitted

    def release(self, qos: str, now: int) -> List[Request]:
        """Return one stream credit (the stream's last chunk consumed
        and verified) and immediately re-pump the pending tier — the
        end-to-end chain's upstream edge."""
        if self.held[qos] <= 0:
            raise AssertionError(
                f"release of a credit class {qos} never held"
            )
        self.held[qos] -= 1
        return self.pump(now)

    # -- report material ------------------------------------------------

    def shed_total(self, qos: str) -> int:
        return sum(self.shed[qos].values())

    def brownout_shed(self, qos: str) -> int:
        """Sheds attributable to overload policy (ceilings/pending),
        i.e. everything except per-tenant isolation."""
        return sum(v for k, v in self.shed[qos].items()
                   if k != "tenant-rate")
