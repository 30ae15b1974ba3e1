"""Static verification of the credits protocol zoo + the control plane.

The port's copy of :mod:`smi_tpu.analysis`, with the same names.

The compile-time correctness tiers: :mod:`.verifier` proves
deadlock-freedom, slot-race-freedom, credit conservation, and wire-lane
monotonicity over every schedule of a registered protocol from a single
symbolic replay per rank (happens-before analysis — Lamport CACM'78,
Eraser SOSP'97; see PAPERS.md); :mod:`.model` + :mod:`.properties` are
the control-plane analog — an explicit-state model checker that
exhaustively verifies the epoch, admission, and recovery state machines
at small scopes by driving the REAL serving/membership/WAL objects
(``smi-tpu lint --model``); :mod:`.perf` is the PERFORMANCE tier —
critical-path decomposition of every registered protocol's makespan on
the timestamped simulator plus a kernel roofline lint
(``smi-tpu lint --perf``), pricing what the safety tiers prove;
:mod:`.mutants` and :mod:`.perf_mutants` ship the broken variants —
protocol-tier event-stream transformers, control-plane seam breaks,
and safe-but-slow timing mutants — that prove every check can fail. Pure Python — no JAX, no devices — so
``smi-tpu lint`` runs anywhere in seconds and CI can gate merges on it.
The dynamic schedule fuzzer (``credits.explore_all_schedules``) and the
chaos campaigns remain the authority on *faulted wire* behaviour;
``docs/analysis.md`` states exactly what each tier does and does not
prove.
"""

from smi_tpu_torch.analysis.verifier import (  # noqa: F401
    CHECKS,
    DEFAULT_SHAPES,
    MAX_LINT_N,
    AnalysisError,
    CreditConservation,
    Finding,
    SlotRace,
    StaticDeadlock,
    StaticReport,
    VerifyEvent,
    WireLaneViolation,
    build_generators,
    lint_all,
    render_reports,
    reports_to_json,
    symbolic_events,
    verify_generators,
    verify_protocol,
)
from smi_tpu_torch.analysis.mutants import (  # noqa: F401
    MODEL_MUTANT_PROPERTY,
    MODEL_MUTANTS,
    MUTANTS,
    model_mutant_world,
    mutant_generators,
)
from smi_tpu_torch.analysis.model import (  # noqa: F401
    DEFAULT_SCOPES,
    ModelFinding,
    ModelReport,
    Scope,
    World,
    check_scope,
    check_scopes,
    model_reports_to_json,
    parse_scope,
    render_model_reports,
)
from smi_tpu_torch.analysis.properties import PROPERTIES  # noqa: F401
from smi_tpu_torch.analysis.perf import (  # noqa: F401
    ANALYTIC_DRIFT_FRACTION,
    ANALYTIC_EXPECTED_US,
    BELOW_ROOFLINE_FRACTION,
    IDLE_FRACTION_THRESHOLD,
    PERF_CHECKS,
    PERF_LINT_CHECKS,
    PERF_PAYLOAD_BYTES,
    PERF_PROTOCOL_CHECKS,
    VMEM_DOUBLE_BUFFER_BOUND,
    PerfFinding,
    PerfReport,
    analytic_predictions,
    analytic_regression_findings,
    below_roofline_findings,
    decompose_generators,
    decompose_protocol,
    no_double_buffer_findings,
    perf_all,
    perf_reports_to_json,
    render_perf_reports,
    roofline_lint,
    serialized_dma_findings,
)
from smi_tpu_torch.analysis.perf_mutants import (  # noqa: F401
    OVERSIZED_FLASH_TILE,
    PERF_MUTANT_RULE,
    PERF_MUTANTS,
    perf_mutant_generators,
)
