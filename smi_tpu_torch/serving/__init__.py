"""Multi-tenant streaming front-end: admission, QoS, backpressure.

The port's counterpart of :mod:`smi_tpu.serving`, so far its three
leaves: :mod:`.qos` (the request record and the priority classes),
:mod:`.admission` (per-tenant token buckets in front of the class pools)
and :mod:`.scheduler` (the credit-aware stream scheduler that feeds the
wire lanes). They are pure Python and step-clock deterministic, and the
analysis and observability tiers drive them. The rest of the serving
tier (the front end, placement, elasticity, the campaigns, MoE dispatch
and inference) comes in a later slice.
"""

from smi_tpu_torch.serving.admission import AdmissionGate, TokenBucket
from smi_tpu_torch.serving.qos import (
    CLASS_ADMISSION_WAIT_TICKS,
    CLASS_DEADLINE_TICKS,
    CLASS_POOL_CEILING,
    CLASS_PRIORITY,
    INTERACTIVE_P99_TICKS,
    QOS_CLASSES,
    AdmissionRejected,
    Request,
)
from smi_tpu_torch.serving.scheduler import (
    CONSUME_RATE,
    MAX_STARVE_ROUNDS,
    TRANSIT_TICKS,
    WIRE_CREDITS,
    StreamScheduler,
    StreamState,
    WireLane,
)

__all__ = [
    "AdmissionGate",
    "AdmissionRejected",
    "CLASS_ADMISSION_WAIT_TICKS",
    "CLASS_DEADLINE_TICKS",
    "CLASS_POOL_CEILING",
    "CLASS_PRIORITY",
    "CONSUME_RATE",
    "INTERACTIVE_P99_TICKS",
    "MAX_STARVE_ROUNDS",
    "QOS_CLASSES",
    "Request",
    "StreamScheduler",
    "StreamState",
    "TokenBucket",
    "TRANSIT_TICKS",
    "WIRE_CREDITS",
    "WireLane",
]
