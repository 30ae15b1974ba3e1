"""smi_tpu_torch — the PyTorch/CUDA port of smi_tpu for the NVIDIA H100.

Six slices are ported. The first carries the flagship workload: the
distributed 4-point Jacobi stencil with Dirichlet edges on a 2-D rank
grid, its halo exchange, and the hand-written CUDA sweep kernels (one
sweep per launch, and k sweeps per memory pass). The second is ring
attention's forward: sequence-parallel attention over a rank ring
(``ring_shift`` moves K/V), with hand-written CUDA flash kernels for the
whole-extent forward and for one ring step's fold (causal, sliding
window, grouped K/V heads; f32 and bf16). The third trains: the flash
tier's backward on hand-written FlashAttention-2 kernels (dq, and dk/dv
with the GQA group reduced in the kernel), and the long-context
transformer block and its train step over a ``(dp, sp)`` grid, bf16
compute with f32 master weights. The fourth closes the stencil family:
the explicit-copy pipeline, k sweeps per pass streamed through shared
memory by TMA on a ring of mbarrier slots, in f32 and with bf16
neighbour arithmetic. The fifth is the Streaming Message Interface
itself: ``smi_kernel`` and ``SmiContext``, the rooted collectives and the
P2P channels, on a ``LocalWorld`` (an n-rank grid of threads on one
card), with the ring backend on hand-written CUDA kernels whose ranks
write into each other's buffers under credit flow control, and the
k-means and GESUMMV applications. The sixth adds the chunked ring
all-reduce kernel, ``stream_concurrent`` and SMI's microbenchmark suite
(``python -m smi_tpu_torch.benchmarks``), which ``import smi_tpu_torch``
does not load. Later slices complete SMI's collective surface:
``all_to_all`` (pairwise, Bruck, two-tier), the hybrid ``("dcn",
"ici")`` communicator with hierarchical and reduce-scatter + all-gather
allreduce, quantised allreduce, verified transfers and tenant ports; and
the plan engine (``smi_tpu_torch.tuning``) that decides their untuned
knobs, from the card's own measured sweeps on an H100; and the elastic
runtime's first tier: the routing layer and its ``FailureSet``, the
degraded-mode communicator (``shrink``/``regrow`` and their pod forms,
membership epochs, heirs, ``recover_communicator``), the hostfile
bootstrap, and CRC-framed checkpoints with the checkpointed Jacobi and
K-means drivers.
The seventeenth adds the fault-simulator tier: the
credit protocol's executable specification and schedule fuzzer
(``parallel.credits``), fault plans and verdicts (``parallel.faults``),
self-healing collectives over progress logs and the chaos campaigns
(``parallel.recovery``), the phi-accrual detector, membership views and
the elastic and pod soaks (``parallel.membership``) — host tools, in step
with the JAX package seed for seed — and the watchdog's protocol mirror
on every ring-tier deadline.
Entry points run on CUDA unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead.
"""

from smi_tpu_torch.convert import (
    block_from_numpy,
    data_shard_from_numpy,
    grid_to_numpy,
    params_from_numpy,
    params_to_numpy,
    sequence_shard_from_numpy,
    sequence_to_numpy,
    shards_from_numpy,
    shards_to_numpy,
)
from smi_tpu_torch.kernels.ring import (
    RING_STREAMS,
    neighbour_stream,
    neighbour_stream_plain,
    ring_all_gather,
    ring_all_gather_plain,
    ring_all_reduce,
    ring_all_reduce_chunked_plain,
    ring_all_reduce_plain,
    ring_reduce_scatter,
    ring_reduce_scatter_plain,
)
from smi_tpu_torch.kernels.flash import (
    flash_attend_fused,
    flash_attend_fused_plain,
    flash_block_attend,
    flash_block_attend_plain,
    flash_block_backward_dkdv,
    flash_block_backward_dkdv_plain,
    flash_block_backward_dq,
    flash_block_backward_dq_plain,
    flash_supported,
)
from smi_tpu_torch.kernels.stencil import (
    fused_sweep,
    fused_sweep_plain,
    jacobi_step_block_fused,
    make_fused_stencil_fn,
)
from smi_tpu_torch.kernels.stencil_pipeline import (
    make_pipeline_stencil_fn,
    pick_pipeline_stripe_explained,
    pipeline_pass,
    pipeline_supported,
    pipeline_sweeps,
    pipeline_sweeps_plain,
)
from smi_tpu_torch.kernels.stencil_temporal import (
    make_temporal_stencil_fn,
    pick_temporal_depth,
    temporal_pass,
    temporal_supported,
    temporal_sweeps,
    temporal_sweeps_plain,
)
from smi_tpu_torch.models.gesummv import (
    make_gesummv_fn,
    reference_gesummv,
    run_gesummv,
)
from smi_tpu_torch.models.kmeans import (
    assign_points,
    kmeans_iteration,
    make_kmeans_fn,
    reference_kmeans,
    run_kmeans,
)
from smi_tpu_torch.models.ring_attention import (
    make_ring_attention_fn,
    reference_attention,
    reference_attention_rows,
    ring_attention_shard,
)
from smi_tpu_torch.models.stencil import (
    initial_grid,
    jacobi_step_block,
    jacobi_step_block_overlapped,
    make_stencil_fn,
    reference_stencil,
    run_stencil,
)
from smi_tpu_torch.models.transformer import (
    BlockConfig,
    TransformerBlock,
    TransformerStack,
    block_shard,
    init_params,
    init_stack_params,
    make_train_step,
    reference_block,
    stack_shard,
)
from smi_tpu_torch.ops.operations import (
    OP_REGISTRY,
    Broadcast,
    Gather,
    Pop,
    Push,
    Reduce,
    Scatter,
    SmiOperation,
)
from smi_tpu_torch.ops.program import (
    Device,
    Program,
    ProgramMapping,
    allocate_ports,
    combined_program,
)
from smi_tpu_torch.ops.serialization import (
    parse_program,
    parse_topology_file,
    serialize_program,
)
from smi_tpu_torch.ops.types import (
    SMI_ADD,
    SMI_MAX,
    SMI_MIN,
    SmiDtype,
    SmiOp,
    dtype_to_torch,
)
from smi_tpu_torch.parallel.checkpoint import (
    CheckpointIntegrityError,
    CheckpointStore,
    run_iterative,
)
from smi_tpu_torch.parallel.channels import (
    FrameCheck,
    P2PChannel,
    open_tenant_channel,
    ring_shift,
    stream_concurrent,
    tenant_stream_port,
)
from smi_tpu_torch.parallel.collectives import (
    all_to_all,
    allreduce,
    allreduce_hierarchical,
    bcast,
    error_feedback_reset,
    gather,
    reduce,
    scatter,
)
from smi_tpu_torch.parallel.context import SmiContext, smi_kernel
from smi_tpu_torch.parallel.errors import IntegrityError
from smi_tpu_torch.parallel.faults import FaultPlan
from smi_tpu_torch.parallel.halo import (
    Halos,
    halo_exchange_2d,
    halo_exchange_2d_corners,
    halo_exchange_2d_corners_finish,
    halo_exchange_2d_corners_start,
    halo_exchange_finish,
    halo_exchange_start,
    pad_with_halos,
    shift_along,
)
from smi_tpu_torch.parallel.local import LocalWorld
from smi_tpu_torch.parallel.membership import (
    ConfirmedDead,
    MembershipView,
    PhiAccrualDetector,
    PodRingPlan,
    StaleEpochError,
    SuspectRank,
    elastic_campaign,
    plan_pod_rings,
    pod_campaign,
)
from smi_tpu_torch.parallel.mesh import (
    Communicator,
    make_communicator,
    make_hybrid_communicator,
    mesh_from_topology,
)
from smi_tpu_torch.parallel.recovery import (
    ProgressLog,
    RecoveryOutcome,
    WalCorruptionError,
    chaos_campaign,
    recover_communicator,
    run_with_recovery,
)
from smi_tpu_torch.parallel.routing import FailureSet, RouteCutError
from smi_tpu_torch.utils.watchdog import Deadline, WatchdogTimeout

__all__ = [
    "SmiDtype", "SmiOp", "SMI_ADD", "SMI_MAX", "SMI_MIN", "dtype_to_torch",
    "SmiOperation", "Push", "Pop", "Broadcast", "Reduce", "Scatter",
    "Gather", "OP_REGISTRY",
    "Program", "Device", "ProgramMapping", "allocate_ports",
    "combined_program",
    "parse_program", "serialize_program", "parse_topology_file",
    "Communicator", "make_communicator", "make_hybrid_communicator",
    "mesh_from_topology", "LocalWorld",
    "P2PChannel", "stream_concurrent", "SmiContext", "smi_kernel",
    "FrameCheck", "IntegrityError", "tenant_stream_port",
    "open_tenant_channel",
    "bcast", "reduce", "allreduce", "scatter", "gather", "all_to_all",
    "allreduce_hierarchical", "error_feedback_reset",
    "Deadline", "WatchdogTimeout",
    "FailureSet", "RouteCutError", "recover_communicator",
    "CheckpointStore", "CheckpointIntegrityError", "run_iterative",
    "StaleEpochError", "FaultPlan", "MembershipView", "PhiAccrualDetector",
    "SuspectRank", "ConfirmedDead", "PodRingPlan", "plan_pod_rings",
    "pod_campaign", "elastic_campaign", "ProgressLog", "RecoveryOutcome",
    "WalCorruptionError", "run_with_recovery", "chaos_campaign",
    "RING_STREAMS", "neighbour_stream", "neighbour_stream_plain",
    "ring_all_gather", "ring_all_gather_plain", "ring_all_reduce",
    "ring_all_reduce_plain", "ring_all_reduce_chunked_plain",
    "ring_reduce_scatter",
    "ring_reduce_scatter_plain",
    "assign_points", "kmeans_iteration", "make_kmeans_fn", "run_kmeans",
    "reference_kmeans",
    "make_gesummv_fn", "run_gesummv", "reference_gesummv",
    "shards_from_numpy", "shards_to_numpy",
    "Halos", "shift_along", "halo_exchange_2d", "halo_exchange_start",
    "halo_exchange_finish", "halo_exchange_2d_corners",
    "halo_exchange_2d_corners_start", "halo_exchange_2d_corners_finish",
    "pad_with_halos",
    "jacobi_step_block", "jacobi_step_block_overlapped", "make_stencil_fn",
    "run_stencil", "reference_stencil", "initial_grid",
    "fused_sweep", "fused_sweep_plain", "jacobi_step_block_fused",
    "make_fused_stencil_fn",
    "temporal_pass", "temporal_sweeps", "temporal_sweeps_plain",
    "make_temporal_stencil_fn", "pick_temporal_depth", "temporal_supported",
    "pipeline_pass", "pipeline_sweeps", "pipeline_sweeps_plain",
    "make_pipeline_stencil_fn", "pipeline_supported",
    "pick_pipeline_stripe_explained",
    "block_from_numpy", "grid_to_numpy",
    "ring_shift",
    "flash_attend_fused", "flash_attend_fused_plain", "flash_block_attend",
    "flash_block_attend_plain", "flash_supported",
    "flash_block_backward_dq", "flash_block_backward_dq_plain",
    "flash_block_backward_dkdv", "flash_block_backward_dkdv_plain",
    "ring_attention_shard", "make_ring_attention_fn", "reference_attention",
    "reference_attention_rows",
    "sequence_shard_from_numpy", "sequence_to_numpy",
    "BlockConfig", "TransformerBlock", "TransformerStack", "init_params",
    "init_stack_params", "block_shard", "stack_shard", "make_train_step",
    "reference_block",
    "data_shard_from_numpy", "params_from_numpy", "params_to_numpy",
]
