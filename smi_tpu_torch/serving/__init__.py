"""Multi-tenant streaming front-end: admission, QoS, backpressure.

The port's counterpart of :mod:`smi_tpu.serving`, kept in step with it
line for line: the serving-side analogue of the paper's transient
per-message channels switched under credit flow control — many
concurrent tenant streams multiplexed onto the channel/collective
substrate, with admission control chained end to end into the wire
credit discipline, priority classes with an explicit brownout policy,
deadline propagation into the watchdog layer, and membership-driven
failover under faults. Pure Python and step-clock deterministic: the
same seed gives the same report, byte for byte, in both packages. Its
one device program is :func:`.inference.traced_kv_dataflow`, the decode
fold as a collective on a world of ranks.
"""

from smi_tpu_torch.serving.admission import AdmissionGate, TokenBucket
from smi_tpu_torch.serving.campaign import (
    autoscale_selftest,
    load_campaign,
    run_flash_crowd_cell,
    run_load_cell,
    run_migrate_under_kill_cell,
    run_migration_cell,
    serve_selftest,
)
from smi_tpu_torch.serving.elasticity import (
    MIN_SERVING_RANKS,
    SCALE_BURN_THRESHOLD,
    SCALE_COOLDOWN_TICKS,
    SCALE_IN_BURN_FRACTION,
    SCALE_IN_SUSTAIN_TICKS,
    SCALE_OUT_SUSTAIN_TICKS,
    ElasticityController,
    autoscale_enabled,
    scale_burn_threshold,
    scale_cooldown_ticks,
)
from smi_tpu_torch.serving.frontend import ServingFrontend, tenant_base_rank
from smi_tpu_torch.serving.placement import PlacementMap
from smi_tpu_torch.serving.moe import (
    HOT_FACTOR,
    MoeDispatcher,
    expert_home,
    moe_campaign,
    route_tokens,
    run_moe_cell,
)
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
    "ElasticityController",
    "HOT_FACTOR",
    "INTERACTIVE_P99_TICKS",
    "MIN_SERVING_RANKS",
    "MoeDispatcher",
    "MAX_STARVE_ROUNDS",
    "PlacementMap",
    "QOS_CLASSES",
    "Request",
    "SCALE_BURN_THRESHOLD",
    "SCALE_COOLDOWN_TICKS",
    "SCALE_IN_BURN_FRACTION",
    "SCALE_IN_SUSTAIN_TICKS",
    "SCALE_OUT_SUSTAIN_TICKS",
    "ServingFrontend",
    "StreamScheduler",
    "StreamState",
    "TokenBucket",
    "TRANSIT_TICKS",
    "WIRE_CREDITS",
    "WireLane",
    "autoscale_enabled",
    "autoscale_selftest",
    "expert_home",
    "load_campaign",
    "moe_campaign",
    "route_tokens",
    "run_flash_crowd_cell",
    "run_load_cell",
    "run_migrate_under_kill_cell",
    "run_migration_cell",
    "run_moe_cell",
    "scale_burn_threshold",
    "scale_cooldown_ticks",
    "serve_selftest",
    "tenant_base_rank",
]
