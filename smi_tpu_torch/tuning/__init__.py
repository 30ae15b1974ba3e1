"""Plan engine: cost-model-driven autotuning with a persistent cache.

The port's copy of :mod:`smi_tpu.tuning`, with the same exports. Three
layers turn the collectives' and kernels' frozen knobs into inspectable,
overridable decisions (PAPERS.md: ATLAS empirical autotuning + the
Hockney alpha-beta model):

1. :mod:`~smi_tpu_torch.tuning.cost_model` — deterministic analytic
   ranking, the JAX package's v5e constants unchanged (it only ranks).
2. :mod:`~smi_tpu_torch.tuning.sweep` — the measured refinement: the
   collective sweeps on a ``LocalWorld``, timed with the
   ``benchmarks/micro.py`` harness.
3. :mod:`~smi_tpu_torch.tuning.cache` — the persistent, versioned,
   mergeable JSON plan cache (one file format for both packages),
   shipped pre-seeded (:mod:`~smi_tpu_torch.tuning.seeded`) with the
   v5e's measured configs and the H100's own sweep winners.

:mod:`~smi_tpu_torch.tuning.engine` resolves cache -> model -> heuristic
for ``parallel/collectives.py``, ``kernels/ring.py``, ``kernels/flash.py``
and :meth:`SmiContext.explain_plan`, never erroring; :meth:`Plan.explain`
renders the decision trail.
"""

from smi_tpu_torch.tuning.cache import (
    CacheEntry,
    PlanCache,
    PlanCacheError,
    default_cache_path,
)
from smi_tpu_torch.tuning.cost_model import LinkModel, TopologySpec
from smi_tpu_torch.tuning.engine import PlanEngine, get_engine, set_engine
from smi_tpu_torch.tuning.online import (
    OnlineTuner,
    online_retune_enabled,
    retune_margin,
    retune_min_samples,
)
from smi_tpu_torch.tuning.plan import Candidate, Plan, PlanKey
from smi_tpu_torch.tuning.seeded import seeded_cache
from smi_tpu_torch.tuning.swap import (
    PlanSwap,
    PlanSwapError,
    StalePlanError,
    SwapProposal,
)

__all__ = [
    "CacheEntry",
    "Candidate",
    "LinkModel",
    "OnlineTuner",
    "Plan",
    "PlanCache",
    "PlanCacheError",
    "PlanEngine",
    "PlanKey",
    "PlanSwap",
    "PlanSwapError",
    "StalePlanError",
    "SwapProposal",
    "TopologySpec",
    "default_cache_path",
    "get_engine",
    "online_retune_enabled",
    "retune_margin",
    "retune_min_samples",
    "seeded_cache",
    "set_engine",
]
