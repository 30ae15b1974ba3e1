"""Analytic layer: alpha-beta (Hockney) link costs + kernel rooflines.

The port's copy of :mod:`smi_tpu.tuning.cost_model`, pure Python, every
constant unchanged and under its v5e name. **The model layer prices v5e
links and the v5e's memory and VMEM**: ICI beta 45 GB/s, DCN beta 3 GB/s
and alpha 100 us, 17.5 us a collective phase. No H100 link rate is
invented here. The model only *ranks* candidates, and the engine lets
it decide only outside its confidence margins; on an H100 the card's
own measurements (the sweeps of :mod:`smi_tpu_torch.tuning.sweep`,
shipped in :mod:`smi_tpu_torch.tuning.seeded`) answer first. Both
packages rank alike from these constants, which is what the parity
tests hold.

The Hockney model prices one message as ``T(m) = alpha + m / beta`` —
a fixed per-step overhead plus bytes over link bandwidth (PAPERS.md).
Collective algorithms differ in how many alpha steps they take and how
many payload bytes cross each link, so the model ranks whole
decompositions deterministically on CPU, with no hardware in the loop:

- ``ring`` (one fused collective, the small-payload regime): the
  payload makes ``n - 1`` neighbour hops — few launches, but each link
  carries the *full* payload (the "gather-everything" volume the
  collectives module documents).
- ``rs_ag`` (reduce-scatter + all-gather): twice the steps, but each
  link carries only ``2 (n-1) / n`` of the payload — the
  bandwidth-optimal decomposition every large-payload allreduce takes.
- ``hierarchical`` (two-tier meshes): the slow DCN tier is crossed once
  with already-combined shards (``1/n_inner`` of the payload), at the
  cost of three phases.

The ranking flips from ``ring`` to ``rs_ag`` at
:func:`rs_ag_crossover_bytes` — :data:`DEFAULT_ALPHA_S` is calibrated
so the 8-rank crossover lands on the *measured* switch point the repo
ships (``collectives.RS_AG_MIN_BYTES``, the HLO-verified 1 MiB tier);
alpha here is per-collective-phase launch+dispatch overhead (tens of
microseconds on a real XLA program), not raw wire latency.

Kernel-side costs are rooflines over the facts the AOT tier already
extracts (``parallel/aot.py::cost_facts``): bytes-accessed over HBM
bandwidth vs flops over peak, whichever binds. Flash block candidates
additionally carry the VMEM-footprint feasibility gate — a candidate
that cannot fit the 16 MB scoped-VMEM frame is excluded, not ranked
(the measured bq=1024 backward rejection, ``kernels/flash.py``).

Link/roofline constants mirror ``parallel/traffic.py`` and PERF.json's
roofline blocks; ``tests/test_tuning.py`` pins them against each other
so the two evidence columns cannot drift apart.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

from smi_tpu_torch.tuning.plan import Candidate

#: v5e one-way ICI link bandwidth — MUST equal
#: ``traffic.V5E_ICI_LINK_BYTES_PER_S`` (drift-guarded); re-declared so
#: the model stays importable without the traffic module's JAX surface.
V5E_ICI_BETA_BYTES_PER_S = 4.5e10

#: DCN (inter-slice) bandwidth per host NIC — roughly 25 GbE effective;
#: only the *ratio* to ICI matters for ranking (the reference routes
#: intra-node at cost 1 vs QSFP at cost 100, ``codegen/program.py:7-8``).
DCN_BETA_BYTES_PER_S = 3.0e9

#: DCN per-message latency (host NIC + datacenter fabric round, ~100 us
#: — order-of-magnitude above the ICI alpha the same way the beta sits
#: ~15x under ICI's). The credits simulator's DCN wire tier and the
#: hierarchical cost both price cross-slice steps with it; the flat
#: ring pays it on every slice-crossing hop, which is exactly the term
#: the two-tier protocol amortizes to once-per-shard.
DCN_ALPHA_S = 1.0e-4

#: Explicit override of the DCN bandwidth model
#: (bytes/s). Mirrors ``$SMI_TPU_RS_AG_MIN_BYTES`` semantics: unset =
#: the published :data:`DCN_BETA_BYTES_PER_S`; a malformed or
#: non-positive value is a LOUD error (a typo silently falling back
#: would reprice every hierarchical decision without a trace). The
#: override reaches every consumer of the DCN rate — the model's
#: hierarchical pricing, the credits simulator's wire tier, and the
#: explain tables — so one env var retunes the whole DCN story to a
#: fleet's measured interconnect.
DCN_BETA_ENV = "SMI_TPU_DCN_BETA"


def dcn_beta_bytes_per_s() -> float:
    """The resolved DCN bandwidth: ``$SMI_TPU_DCN_BETA`` when set
    (loud on malformed), else :data:`DCN_BETA_BYTES_PER_S`."""
    raw = os.environ.get(DCN_BETA_ENV, "").strip()
    if not raw:
        return DCN_BETA_BYTES_PER_S
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"${DCN_BETA_ENV} must be a bytes-per-second number, "
            f"got {raw!r}"
        ) from None
    if not value > 0 or math.isinf(value) or math.isnan(value):
        raise ValueError(
            f"${DCN_BETA_ENV} must be a positive finite bandwidth, "
            f"got {raw!r}"
        )
    return value


def dcn_link_model(alpha_s: float = DCN_ALPHA_S) -> LinkModel:
    """The DCN tier as a :class:`LinkModel`, env-resolved beta."""
    return LinkModel(alpha_s=alpha_s,
                     beta_bytes_per_s=dcn_beta_bytes_per_s())

#: Per-collective-phase overhead (launch + dispatch + first-byte
#: latency). Calibrated so :func:`rs_ag_crossover_bytes` at n=8 equals
#: the measured 1 MiB switch tier (``RS_AG_MIN_BYTES``):
#: ``alpha = RS_AG_MIN_BYTES * (n-2) / (n * beta)`` = 1.7476e-5 s.
DEFAULT_ALPHA_S = 1.75e-5

#: v5e HBM bandwidth / compute peaks (PERF.json ``rooflines``,
#: ``benchmarks/surface.py``): 819 GB/s, 197 bf16 TFLOP/s, 65.67
#: effective f32 TFLOP/s.
V5E_HBM_BYTES_PER_S = 8.19e11
V5E_PEAK_FLOPS = {"bfloat16": 1.97e14, "float32": 6.56667e13}
#: Mosaic scoped-VMEM frame the flash kernels compile against.
VMEM_LIMIT_BYTES = 16 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Alpha-beta parameters of one interconnect tier."""

    alpha_s: float = DEFAULT_ALPHA_S
    beta_bytes_per_s: float = V5E_ICI_BETA_BYTES_PER_S

    def step_us(self, payload_bytes: float, steps: float = 1.0) -> float:
        return (steps * self.alpha_s
                + payload_bytes / self.beta_bytes_per_s) * 1e6


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """What the model needs to know about where the collective runs:
    rank count, and (for two-tier meshes) the inner/outer split."""

    n: int
    inner: Optional[int] = None      # ICI ranks per slice (hybrid mesh)
    outer: Optional[int] = None      # slice count across DCN

    @property
    def hierarchical_eligible(self) -> bool:
        return bool(self.inner and self.outer and self.outer > 1)


def topology_from_comm(comm) -> TopologySpec:
    """TopologySpec of a :class:`~smi_tpu_torch.parallel.mesh.
    Communicator` (or a :class:`~smi_tpu_torch.parallel.local.LocalWorld`):
    its ``axis_names`` and ``axis_sizes``. A ``(dcn, ici)``-style 2-axis
    hybrid grid exposes the two-tier split."""
    names = tuple(comm.axis_names)
    sizes = tuple(int(s) for s in getattr(comm, "axis_sizes", comm.shape))
    n = 1
    for s in sizes:
        n *= s
    if len(sizes) == 2 and "dcn" in names:
        outer = sizes[names.index("dcn")]
        return TopologySpec(n=n, inner=n // outer, outer=outer)
    return TopologySpec(n=n)


def topology_from_routing(topology) -> TopologySpec:
    """TopologySpec from a build-time routing topology
    (:func:`smi_tpu_torch.parallel.routing.grid_topology` et al.): the
    route-table world's device count, fed to the same model as a live
    communicator's."""
    return TopologySpec(n=len(topology.devices))


# ---------------------------------------------------------------------------
# Collective algorithm costs
# ---------------------------------------------------------------------------


def ring_allreduce_us(payload_bytes: float, n: int,
                      link: LinkModel) -> float:
    """One fused collective: the payload circulates ``n - 1`` hops with
    the running partial — minimal steps, full payload per link."""
    if n <= 1:
        return 0.0
    return link.step_us((n - 1) * payload_bytes, steps=n - 1)


def rs_ag_allreduce_us(payload_bytes: float, n: int,
                       link: LinkModel) -> float:
    """Reduce-scatter + all-gather: ``2 (n-1)`` steps, each link carries
    ``2 (n-1) / n`` of the payload — bandwidth-optimal."""
    if n <= 1:
        return 0.0
    return link.step_us(2 * (n - 1) / n * payload_bytes,
                        steps=2 * (n - 1))


def hierarchical_allreduce_us(
    payload_bytes: float, topo: TopologySpec,
    ici: LinkModel, dcn: LinkModel,
) -> float:
    """rs(ICI) + allreduce(DCN, 1/inner of the payload) + ag(ICI)."""
    ni, no = topo.inner or topo.n, topo.outer or 1
    t = 0.0
    if ni > 1:
        t += ici.step_us(2 * (ni - 1) / ni * payload_bytes,
                         steps=2 * (ni - 1))
    if no > 1:
        t += dcn.step_us((no - 1) * (payload_bytes / max(1, ni)),
                         steps=no - 1)
    return t


def hierarchical_advantage(
    payload_bytes: float,
    topo: TopologySpec,
    link: LinkModel = LinkModel(),
    dcn: Optional[LinkModel] = None,
) -> float:
    """Modeled speedup of the two-tier form over the best flat form
    (``> 1`` = hierarchical wins). ``0.0`` when the topology is not
    hierarchical-eligible — a single-slice mesh has no DCN tier to
    amortize, so the two-tier form can never be advised there."""
    if not topo.hierarchical_eligible:
        return 0.0
    if dcn is None:
        dcn = dcn_link_model()
    # a flat ring over a pod advances in lockstep at its SLOWEST hop:
    # the slice-crossing DCN wires gate every lap, so the flat forms
    # are priced at the DCN rate (the single-tier pricing would call
    # the flat ring ICI-fast on a topology where it never is)
    flat = min(
        ring_allreduce_us(payload_bytes, topo.n, dcn),
        rs_ag_allreduce_us(payload_bytes, topo.n, dcn),
    )
    hier = hierarchical_allreduce_us(payload_bytes, topo, link, dcn)
    if hier <= 0.0:
        return math.inf if flat > 0 else 0.0
    return flat / hier


def rs_ag_crossover_bytes(n: int, link: LinkModel = LinkModel()) -> float:
    """Payload size where ``rs_ag`` overtakes ``ring``:
    ``alpha * beta * n / (n - 2)`` (from equating the two formulas).
    ``inf`` for n <= 2 — the decomposition can never win a 2-ring
    (identical volume, twice the steps)."""
    if n <= 2:
        return math.inf
    return link.alpha_s * link.beta_bytes_per_s * n / (n - 2)


def allreduce_candidates(
    payload_bytes: int,
    topo: TopologySpec,
    link: LinkModel = LinkModel(),
    dcn: Optional[LinkModel] = None,
) -> List[Candidate]:
    """Modeled candidate table for an ADD allreduce, best first.

    Ties keep declaration order (``ring`` first): at a tie the fused
    single collective wins — fewer launches, no epilogue. The DCN tier
    defaults to :func:`dcn_link_model` (env-resolved beta) at CALL
    time, so ``$SMI_TPU_DCN_BETA`` reprices every table consistently.
    """
    if dcn is None:
        dcn = dcn_link_model()
    n = topo.n
    # on a pod, a flat collective's lockstep laps are gated by the
    # slice-crossing DCN wires — price the flat forms at that tier
    # (see hierarchical_advantage); single-slice stays pure ICI
    flat_link = dcn if topo.hierarchical_eligible else link
    flat_note = (", every lap gated by DCN"
                 if topo.hierarchical_eligible else "")
    cands = [
        Candidate(
            "ring", {"algorithm": "ring"},
            modeled_us=ring_allreduce_us(payload_bytes, n, flat_link),
            note=f"1 collective, {n - 1} hops x full payload/link"
                 + flat_note,
        ),
        Candidate(
            "rs_ag", {"algorithm": "rs_ag"},
            modeled_us=rs_ag_allreduce_us(payload_bytes, n, flat_link),
            note=f"2 phases, 2(n-1)/n = {2 * (n - 1) / n:.2f}x "
                 f"payload/link" + flat_note,
        ),
    ]
    if topo.hierarchical_eligible:
        cands.append(Candidate(
            "hierarchical", {"algorithm": "hierarchical"},
            modeled_us=hierarchical_allreduce_us(
                payload_bytes, topo, link, dcn
            ),
            note=f"DCN crossed once at 1/{topo.inner} volume",
        ))
    order = sorted(enumerate(cands),
                   key=lambda ic: (ic[1].modeled_us, ic[0]))
    return [c for _, c in order]


# ---------------------------------------------------------------------------
# All-to-all algorithm costs
# ---------------------------------------------------------------------------
# ``payload_bytes`` is the TOTAL per-rank all-to-all payload (one
# ``payload / n`` block per destination — the pod_wallclock pricing
# convention). Pairwise pays n-1 alphas at block granularity; Bruck
# pays log2(n) alphas at n/2-block aggregates (more volume, far fewer
# launches — the latency-bound regime's winner); the two-tier form
# crosses DCN once per destination slice with per_slice-block bundles.


def pairwise_alltoall_us(payload_bytes: float, n: int,
                         link: LinkModel) -> float:
    """Pairwise exchange: ``n - 1`` steps, one block per link per
    step."""
    if n <= 1:
        return 0.0
    return link.step_us((n - 1) * payload_bytes / n, steps=n - 1)


def bruck_alltoall_us(payload_bytes: float, n: int,
                      link: LinkModel) -> float:
    """Bruck log-step: ``log2 n`` rounds, each moving an ``n/2``-block
    aggregate. Power-of-two ``n`` only — a non-power-of-two request is
    a loud error, never a silently repriced fallback."""
    if n < 1 or (n & (n - 1)):
        raise ValueError(
            f"the Bruck all-to-all needs a power-of-two rank count, "
            f"got n={n}"
        )
    if n == 1:
        return 0.0
    rounds = n.bit_length() - 1
    return link.step_us(rounds * payload_bytes / 2.0, steps=rounds)


def hierarchical_alltoall_us(
    payload_bytes: float, topo: TopologySpec,
    ici: LinkModel, dcn: LinkModel,
) -> float:
    """Two-tier: in-slice exchange over ICI (``inner - 1`` steps of
    ``outer``-block messages), then one DCN crossing per destination
    slice (``outer - 1`` steps of ``inner``-block bundles)."""
    ni, no = topo.inner or topo.n, topo.outer or 1
    n = ni * no
    block = payload_bytes / max(1, n)
    t = 0.0
    if ni > 1:
        t += ici.step_us((ni - 1) * no * block, steps=ni - 1)
    if no > 1:
        t += dcn.step_us((no - 1) * ni * block, steps=no - 1)
    return t


def alltoall_advantage(
    payload_bytes: float,
    topo: TopologySpec,
    link: LinkModel = LinkModel(),
    dcn: Optional[LinkModel] = None,
) -> float:
    """Modeled speedup of the two-tier all-to-all over the best
    eligible flat form (``> 1`` = two-tier wins); ``0.0`` off-pod."""
    if not topo.hierarchical_eligible:
        return 0.0
    if dcn is None:
        dcn = dcn_link_model()
    # a flat exchange on a pod is gated by its slice-crossing steps:
    # price the flat forms at the DCN rate (hierarchical_advantage's
    # lockstep argument, applied to the rotating-partner schedule)
    flat = pairwise_alltoall_us(payload_bytes, topo.n, dcn)
    if topo.n >= 1 and not (topo.n & (topo.n - 1)):
        flat = min(flat, bruck_alltoall_us(payload_bytes, topo.n, dcn))
    hier = hierarchical_alltoall_us(payload_bytes, topo, link, dcn)
    if hier <= 0.0:
        return math.inf if flat > 0 else 0.0
    return flat / hier


class CandidateSet(List[Candidate]):
    """A candidate table PLUS the candidates a structural gate
    excluded (``excluded``) — the ``ScheduleCount`` pattern applied to
    candidate filtering: callers keep receiving the plain ranked list,
    and no-silent-caps consumers (``smi-tpu tune --explain``) can name
    exactly which candidates were dropped and why instead of letting a
    shorter table read as the whole search space."""

    def __init__(self, feasible: Sequence[Candidate] = (),
                 excluded: Sequence[Candidate] = ()):
        super().__init__(feasible)
        self.excluded: List[Candidate] = list(excluded)


def alltoall_candidates(
    payload_bytes: int,
    topo: TopologySpec,
    link: LinkModel = LinkModel(),
    dcn: Optional[LinkModel] = None,
) -> CandidateSet:
    """Modeled candidate table for an all-to-all, best first.

    Ties keep declaration order (``pairwise`` first — the fused
    single-collective default). The Bruck variant is structurally
    power-of-two-only: on other rank counts it lands on ``excluded``
    with the refusal in its note, never silently missing. The
    hierarchical variant appears only on hierarchical-eligible pods,
    with the flat forms priced at the DCN rate there (their lockstep
    steps are gated by slice-crossing hops).
    """
    if dcn is None:
        dcn = dcn_link_model()
    n = topo.n
    flat_link = dcn if topo.hierarchical_eligible else link
    flat_note = (", every step gated by DCN"
                 if topo.hierarchical_eligible else "")
    cands = [Candidate(
        "pairwise", {"algorithm": "pairwise"},
        modeled_us=pairwise_alltoall_us(payload_bytes, n, flat_link),
        note=f"{n - 1} steps x payload/{n} per link" + flat_note,
    )]
    excluded = []
    if n >= 1 and not (n & (n - 1)):
        rounds = max(1, n.bit_length() - 1)
        cands.append(Candidate(
            "bruck", {"algorithm": "bruck"},
            modeled_us=bruck_alltoall_us(payload_bytes, n, flat_link),
            note=f"{rounds} log-steps x n/2-block aggregates"
                 + flat_note,
        ))
    else:
        excluded.append(Candidate(
            "bruck", {"algorithm": "bruck"}, modeled_us=None,
            note=(f"EXCLUDED: n={n} is not a power of two — the "
                  f"Bruck schedule refuses loudly rather than pad"),
        ))
    if topo.hierarchical_eligible:
        cands.append(Candidate(
            "hierarchical", {"algorithm": "hierarchical"},
            modeled_us=hierarchical_alltoall_us(
                payload_bytes, topo, link, dcn
            ),
            note=(f"DCN crossed once per slice with "
                  f"{topo.inner}-block bundles"),
        ))
    order = sorted(enumerate(cands),
                   key=lambda ic: (ic[1].modeled_us, ic[0]))
    return CandidateSet([c for _, c in order], excluded)


# ---------------------------------------------------------------------------
# Precision candidates: compressed-collective wire widths (r19)
# ---------------------------------------------------------------------------
# Hockney says the large-payload allreduce is pure bytes/beta — the
# quantized protocols attack the bytes. The model prices each precision
# by shrinking the wire payload through the SAME ring/rs_ag/
# hierarchical formulas used for the algorithm choice, so a precision
# pick is always "best algorithm at the reduced width", never a
# separate code path.

#: Wire bytes per dense precision as a fraction of f32 — MUST equal
#: ``credits.PRECISION_WIRE_RATIO`` (drift-guarded); re-declared so
#: the model stays importable without the simulator module.
PRECISION_WIRE_RATIO = {"f32": 1.0, "bf16": 0.5, "int8": 0.25}

#: Top-k sparse wire shape — MUST equal the credits constants
#: (drift-guarded): k/n density times the (index, value) bundle
#: overhead. Net: 1/8 of the dense f32 bytes.
SPARSE_TOPK_DENSITY = 1.0 / 16.0
SPARSE_INDEX_OVERHEAD = 2.0

#: Every precision the plan engine may name; declaration order is the
#: tie-break order (lossless first).
ALLREDUCE_PRECISIONS = ("f32", "bf16", "int8", "topk")

#: Payload floor for the lossy precisions: below this the collective
#: is alpha-bound (the same regime the ``RS_AG_MIN_BYTES`` crossover
#: documents) and the quantize/dequantize epilogue plus the scale
#: exchange outweigh any beta win — the model EXCLUDES lossy
#: candidates there rather than ranking a modeled win the wire cannot
#: deliver.
QUANTIZE_MIN_BYTES = 64 * 1024

#: Confidence margin of the MODEL rung of ``engine.use_precision``: a
#: modeled advantage must clear this factor before the model alone may
#: propose a lossy precision. Set equal to the int8 byte ratio (4x),
#: which upper-bounds every modeled win (the alphas are unchanged, so
#: the ratio sits strictly below 4). The bound is deliberate: the
#: model alone can NEVER flip numerics — only an explicit ``precision=``
#: pin, the ``$SMI_TPU_ALLREDUCE_PRECISION`` knob, or a MEASURED cache
#: entry puts a lossy width on the wire.
PRECISION_MODEL_MARGIN = 4.0


def precision_wire_fraction(precision: str) -> float:
    """Wire bytes of one precision as a fraction of dense f32 — loud
    on an unknown name (never a silent full-width fallback)."""
    if precision == "topk":
        return SPARSE_TOPK_DENSITY * SPARSE_INDEX_OVERHEAD
    try:
        return PRECISION_WIRE_RATIO[precision]
    except KeyError:
        raise ValueError(
            f"unknown allreduce precision {precision!r}; expected one "
            f"of {ALLREDUCE_PRECISIONS}"
        ) from None


def precision_ineligibility(
    precision: str, op: str, dtype: str, payload_bytes: float,
) -> Optional[str]:
    """Why a LOSSY precision cannot run here (``None`` = eligible).
    ``f32`` is the identity and is always eligible."""
    if precision == "f32":
        return None
    if op != "add":
        return (f"op {op!r} is not ADD — compensated rounding is "
                f"defined only for additive reduction")
    if dtype.startswith(("int", "uint")) or dtype == "bool":
        return (f"dtype {dtype!r} is exact — quantizing an integer "
                f"reduction silently changes its semantics")
    if payload_bytes < QUANTIZE_MIN_BYTES:
        return (f"payload {int(payload_bytes)} B sits below the "
                f"{QUANTIZE_MIN_BYTES // 1024} KiB quantize floor — "
                f"alpha-bound, the cast epilogue outweighs the beta "
                f"win")
    return None


def allreduce_precision_candidates(
    payload_bytes: int,
    topo: TopologySpec,
    dtype: str = "float32",
    op: str = "add",
    link: LinkModel = LinkModel(),
    dcn: Optional[LinkModel] = None,
) -> CandidateSet:
    """Precision x algorithm candidate table for an allreduce, best
    first. Each precision is priced as its BEST algorithm at the
    reduced wire width — the precision rides the r6/r12 algorithm
    table, it does not fork it. Ineligible lossy precisions (non-ADD
    op, exact integer dtype, below the payload floor) land on
    ``excluded`` with the refusal in the note — the no-silent-caps
    pattern ``tune --explain allreduce`` renders; ``f32`` is always
    feasible. Ties keep declaration order: lossless first.
    """
    if dcn is None:
        dcn = dcn_link_model()
    feasible = []
    excluded = []
    for precision in ALLREDUCE_PRECISIONS:
        why = precision_ineligibility(precision, op, dtype,
                                       payload_bytes)
        if why is not None:
            excluded.append(Candidate(
                precision, {"precision": precision}, modeled_us=None,
                note=f"EXCLUDED: {why}",
            ))
            continue
        frac = precision_wire_fraction(precision)
        best = allreduce_candidates(payload_bytes * frac, topo,
                                    link, dcn)[0]
        sparse_note = (
            f" (density {SPARSE_TOPK_DENSITY:g} x "
            f"{SPARSE_INDEX_OVERHEAD:g} index overhead)"
            if precision == "topk" else ""
        )
        feasible.append(Candidate(
            precision,
            {"precision": precision,
             "algorithm": best.knobs["algorithm"]},
            modeled_us=best.modeled_us,
            note=f"{frac:g}x wire bytes via {best.name}" + sparse_note,
        ))
    order = sorted(enumerate(feasible),
                   key=lambda ic: (ic[1].modeled_us, ic[0]))
    return CandidateSet([c for _, c in order], excluded)


def precision_advantage(
    payload_bytes: float,
    topo: TopologySpec,
    precision: str,
    link: LinkModel = LinkModel(),
    dcn: Optional[LinkModel] = None,
) -> float:
    """Modeled speedup of one precision over dense f32 (best algorithm
    on each side; ``> 1`` = the reduced width wins). Bounded above by
    the byte ratio — the alphas are unchanged — so the dense quantized
    widths (bf16 2x, int8 4x) stay strictly below
    :data:`PRECISION_MODEL_MARGIN`, the bound the engine's model rung
    leans on. ``topk``'s 8x byte-ratio bound EXCEEDS the margin, which
    is exactly why the model rung never consults it: a sparse width
    reaches the wire only through a measured crossover or an explicit
    pin."""
    if dcn is None:
        dcn = dcn_link_model()
    base = allreduce_candidates(payload_bytes, topo, link,
                                dcn)[0].modeled_us
    wire = payload_bytes * precision_wire_fraction(precision)
    lossy = allreduce_candidates(wire, topo, link, dcn)[0].modeled_us
    if lossy <= 0.0:
        return math.inf if base > 0 else 0.0
    return base / lossy


def chunk_pipeline_us(
    payload_bytes: float, n: int, chunks: int, link: LinkModel,
    overlappable_us: float = 0.0,
) -> float:
    """Advisory pipeline model for ``chunks=``: splitting into ``c``
    independent collectives lets up to ``(c-1)/c`` of adjacent compute
    hide behind the wire time, at ``(c-1)`` extra launches."""
    base = ring_allreduce_us(payload_bytes, n, link)
    c = max(1, chunks)
    hidden = overlappable_us * (c - 1) / c
    return base + (c - 1) * link.alpha_s * 1e6 - min(hidden, base)


# ---------------------------------------------------------------------------
# Kernel-side rooflines (fed by the AOT cost analysis)
# ---------------------------------------------------------------------------


def kernel_roofline_us(
    flops: Optional[float],
    bytes_accessed: Optional[float],
    dtype: str = "bfloat16",
    hbm_bytes_per_s: float = V5E_HBM_BYTES_PER_S,
) -> Optional[float]:
    """max(HBM time, compute time) of one kernel launch, from the facts
    ``parallel/aot.py::cost_facts`` extracts out of a compiled
    executable. ``None`` when neither fact is available (the tier the
    heuristics then cover)."""
    times = []
    if bytes_accessed:
        times.append(bytes_accessed / hbm_bytes_per_s)
    if flops:
        peak = V5E_PEAK_FLOPS.get(dtype, V5E_PEAK_FLOPS["float32"])
        times.append(flops / peak)
    if not times:
        return None
    return max(times) * 1e6


def flash_fwd_vmem_bytes(bq: int, bk: int, d: int, itemsize: int) -> int:
    """VMEM frame of one forward grid step: double-buffered q/k/v tiles
    plus the f32 online-softmax scratch (``kernels/flash.py`` layout)."""
    tiles = (bq * d + 2 * bk * d) * itemsize * 2   # double-buffered
    scratch = bq * d * 4 + 2 * bq * 128 * 4        # acc + lane-wide m/l
    return tiles + scratch


def flash_single_buffer_vmem_bytes(bq: int, bk: int, d: int,
                                   itemsize: int) -> int:
    """ONE buffer generation of the forward tiles plus the persistent
    f32 scratch — the quantity that must fit HALF the scoped-VMEM
    frame for the k/v stream to double-buffer. Mirror of
    ``analysis/perf.flash_single_buffer_bytes`` (drift-guarded); the
    r18 candidate gate uses it so a tile that would force the k/v
    stream single-buffered is *excluded*, never ranked."""
    tiles = (bq * d + 2 * bk * d) * itemsize
    scratch = bq * d * 4 + 2 * bq * 128 * 4
    return tiles + scratch


class FlashCandidates(CandidateSet):
    """The feasible flash-tile candidate list, PLUS the candidates the
    VMEM gate rejected (``excluded``) — :class:`CandidateSet`
    specialized to the tile search: existing callers keep receiving the
    plain list they always did, and "no silent caps" consumers
    (``smi-tpu tune --explain``, the perf lint tier) can state exactly
    which targets were dropped and at what footprint instead of letting
    a silently shorter table read as the whole search space."""


#: Forward-tile targets the model prices. The r18 widening adds the
#: (2048, 2048)/(4096, 2048) tiles: the former is feasible and
#: double-bufferable, the latter demonstrates the k/v-stream gate —
#: its SINGLE-buffer footprint already eats more than half the frame,
#: so streaming k/v behind it would serialize every chunk fetch.
FLASH_BLOCK_TARGETS = (
    (512, 512), (512, 1024), (1024, 512), (1024, 1024),
    (2048, 2048), (4096, 2048),
)


def flash_block_candidates(
    s: int, d: int, dtype: str, windowed: bool,
    targets: Sequence[Tuple[int, int]] = FLASH_BLOCK_TARGETS,
) -> FlashCandidates:
    """Feasible forward-tile candidates, ranked by modeled grid-step
    overhead (fewer, larger tiles amortize per-tile masking); the
    VMEM-infeasible ones are *excluded* — and returned on the result's
    ``excluded`` list with the failing footprint in the note, never
    silently dropped. This ranking is deliberately coarse — it seeds
    the sweep order; measurement (the cache layer) has the last word,
    which is exactly why f32 keeps bk=512 despite the model preferring
    1024 (PERF.json: f32 measured slower at 1024).
    """
    itemsize = 2 if dtype == "bfloat16" else 4
    out = []
    excluded = []
    for bq, bk in targets:
        vmem = flash_fwd_vmem_bytes(bq, bk, d, itemsize)
        if vmem > VMEM_LIMIT_BYTES:
            excluded.append(Candidate(
                f"bq{bq}/bk{bk}", {"block_q": bq, "block_k": bk},
                modeled_us=None,
                note=(f"EXCLUDED: vmem {vmem // 1024} KiB exceeds the "
                      f"{VMEM_LIMIT_BYTES // 1024} KiB scoped-VMEM "
                      f"frame"),
            ))
            continue
        single = flash_single_buffer_vmem_bytes(bq, bk, d, itemsize)
        if single > VMEM_LIMIT_BYTES // 2:
            # the r18 k/v double-buffer gate: a tile that fits only
            # single-buffered would serialize every k/v chunk fetch
            # against compute — the exact defect the perf lint's
            # ``no-double-buffer`` rule names; refuse to rank it
            excluded.append(Candidate(
                f"bq{bq}/bk{bk}", {"block_q": bq, "block_k": bk},
                modeled_us=None,
                note=(f"EXCLUDED: single-buffer footprint "
                      f"{single // 1024} KiB exceeds half the "
                      f"{VMEM_LIMIT_BYTES // 1024} KiB frame — the "
                      f"k/v stream could not double-buffer "
                      f"(no-double-buffer lint rule)"),
            ))
            continue
        steps = max(1, s // bq) * max(1, s // bk)
        # per-step overhead ~2us (grid bookkeeping + edge masking);
        # windowed grids touch few tiles, so finer bk wastes less dead
        # span at the window edges — modeled as a mild fine-tile credit
        overhead = steps * 2.0
        if windowed and bk <= 512:
            overhead *= 0.9
        out.append(Candidate(
            f"bq{bq}/bk{bk}",
            {"block_q": bq, "block_k": bk, "kv_buffering": 2},
            modeled_us=overhead,
            note=f"vmem {vmem // 1024} KiB, {steps} grid steps",
        ))
    return FlashCandidates(
        sorted(out, key=lambda c: (c.modeled_us, -c.knobs["block_q"])),
        excluded,
    )


# ---------------------------------------------------------------------------
# Stencil pipeline candidates (r18 roofline closure)
# ---------------------------------------------------------------------------

#: r5 isolated-probe VPU rates (docs/perf_notes.md "Pinning the
#: roll-port rate in isolation"): the VMEM round-trip floor every
#: whole-array sweep pays, and the exposed crossbar time per lane roll.
STENCIL_SWEEP_VMEM_FLOOR_PS = 1.91
STENCIL_LANE_ROLL_PORT_PS = 1.04

#: Composite per-element sweep cost: one VMEM stream + two exposed
#: lane-roll port slots, everything else (sublane rolls, adds, select)
#: hidden behind the stream — the r5 composite-floor model.
STENCIL_SWEEP_PS = STENCIL_SWEEP_VMEM_FLOOR_PS + 2 * STENCIL_LANE_ROLL_PORT_PS

#: Advisory per-sweep surcharge of the bf16-compute variant: the
#: f32->bf16 rounding casts of the four neighbour operands (v5e has no
#: packed-pair VPU ALU, so bf16 buys no issue-rate credit — the casts
#: are pure cost unless HBM is the binding term).
STENCIL_BF16_CAST_PS = 0.60

#: Per-stripe DMA issue overhead (advisory): one fetch + one writeback
#: descriptor per stripe per pass, amortized over the pass's sweeps.
STENCIL_DMA_ISSUE_US = 1.0

#: Slot count of the shipped explicit-DMA rotation — MUST equal
#: ``kernels/stencil_pipeline.PIPELINE_SLOTS`` (drift-guarded).
STENCIL_PIPELINE_SLOTS = 3

#: The state array is always f32 (Jacobi numerics contract); bf16
#: exists only inside the sweep arithmetic, so HBM and VMEM are priced
#: at 4 B/cell for every candidate.
STENCIL_STATE_BYTES = 4

#: Depth/stripe grids the candidate table prices (the sweep's search
#: space). Depths deliberately extend beyond the temporal tier's
#: measured knee of 16: overlap changes where the knee sits.
STENCIL_PIPELINE_DEPTHS = (8, 16, 24, 32)
STENCIL_PIPELINE_STRIPES = (32, 64, 128, 256)

#: Lane padding of the extended layout (mirror of
#: ``kernels/stencil_temporal.LANE_PAD``, drift-guarded).
STENCIL_LANE_PAD = 128


def stencil_pipeline_vmem_bytes(
    stripe: int, w: int, depth: int,
    buffering: int = STENCIL_PIPELINE_SLOTS,
) -> int:
    """VMEM footprint of the explicit-DMA slot rotation — mirror of
    ``kernels/stencil_pipeline.pipeline_vmem_bytes`` (drift-guarded)."""
    return (buffering * (stripe + 2 * depth)
            * (w + 2 * STENCIL_LANE_PAD) * STENCIL_STATE_BYTES)


def stencil_sweep_overhead(stripe: int, depth: int, w: int) -> float:
    """Swept-area overhead per useful cell: the 2k recompute apron over
    the stripe height times the 256-lane pad over the width."""
    return ((stripe + 2.0 * depth) / stripe
            * (w + 2.0 * STENCIL_LANE_PAD) / w)


def stencil_compute_ps(stripe: int, depth: int, w: int,
                       compute_dtype: str = "float32") -> float:
    """Modeled VPU cost per useful cell per sweep (picoseconds)."""
    ps = STENCIL_SWEEP_PS
    if compute_dtype == "bfloat16":
        ps += STENCIL_BF16_CAST_PS
    return ps * stencil_sweep_overhead(stripe, depth, w)


def stencil_hbm_ps(depth: int) -> float:
    """HBM cost per useful cell per sweep: one f32 read + one f32
    write per pass, amortized over the pass's ``depth`` sweeps."""
    bytes_per_cell = 2.0 * STENCIL_STATE_BYTES / depth
    return bytes_per_cell / (V5E_HBM_BYTES_PER_S * 1e-12)


def stencil_pipeline_us(
    h: int, w: int, depth: int, stripe: int,
    compute_dtype: str = "float32",
    buffering: int = STENCIL_PIPELINE_SLOTS,
) -> float:
    """Modeled wall-clock of ONE sweep over an ``(h, w)`` block.

    ``buffering >= 2`` overlaps the stripe stream with compute
    (``max``); ``buffering == 1`` is the synchronous control path where
    every HBM byte sits on the critical path (``+``). Advisory — the
    sweep's measured entries outrank this on every knob (ATLAS).
    """
    compute = stencil_compute_ps(stripe, depth, w, compute_dtype)
    hbm = stencil_hbm_ps(depth)
    ps = max(compute, hbm) if buffering >= 2 else compute + hbm
    per_pass_us = (h / stripe) * STENCIL_DMA_ISSUE_US
    return h * w * ps * 1e-6 + per_pass_us / depth


def stencil_pipeline_candidates(
    h: int = 8192, w: int = 8192, dtype: str = "float32",
    depths: Sequence[int] = STENCIL_PIPELINE_DEPTHS,
    stripes: Sequence[int] = STENCIL_PIPELINE_STRIPES,
    compute_dtypes: Sequence[str] = ("float32", "bfloat16"),
) -> CandidateSet:
    """Priced depth x stripe x compute-dtype table for the explicit-DMA
    stencil pipeline at one block shape, best first, plus the
    synchronous control path as an always-priced baseline.

    Every infeasible combination lands on ``excluded`` with the exact
    refusal — VMEM over the frame, stripe shorter than the sweep
    depth, stripe not dividing the block — the no-silent-caps
    discipline ``tune --explain stencil`` renders. A non-f32 state
    dtype excludes the whole family (the Jacobi numerics contract).
    """
    if dtype != "float32":
        return CandidateSet((), (Candidate(
            "pipeline", {"algorithm": "pipeline"}, modeled_us=None,
            note=(f"EXCLUDED: state dtype {dtype} — the stencil state "
                  f"is f32 by the numerics contract (bf16 exists only "
                  f"as a compute variant)"),
        ),))
    feasible = []
    excluded = []
    # the synchronous control: the shipped temporal plan's knobs with
    # the stripe stream serialized against compute (what the perf
    # decomposer's idle-fraction finding prices)
    sync_depth, sync_stripe = 16, 128
    feasible.append(Candidate(
        f"sync:d{sync_depth}:t{sync_stripe}:f32",
        {"algorithm": "sync", "depth": sync_depth,
         "stripe": sync_stripe, "compute_dtype": "float32",
         "buffering": 1},
        modeled_us=round(stencil_pipeline_us(
            h, w, sync_depth, sync_stripe, "float32", buffering=1
        ), 1),
        note="synchronous control: stripe stream on the critical path",
    ))
    for k in depths:
        for t in stripes:
            for cdt in compute_dtypes:
                name = f"pipe:d{k}:t{t}:{'bf16' if cdt == 'bfloat16' else 'f32'}"
                knobs = {"algorithm": "pipeline", "depth": k,
                         "stripe": t, "compute_dtype": cdt,
                         "buffering": STENCIL_PIPELINE_SLOTS}
                if t < k:
                    excluded.append(Candidate(
                        name, knobs, modeled_us=None,
                        note=(f"EXCLUDED: stripe {t} shorter than "
                              f"sweep depth {k} — the trapezoid cone "
                              f"would swallow the whole stripe"),
                    ))
                    continue
                if h % t or t % 8:
                    excluded.append(Candidate(
                        name, knobs, modeled_us=None,
                        note=(f"EXCLUDED: stripe {t} is not an "
                              f"8-aligned divisor of h={h}"),
                    ))
                    continue
                vmem = stencil_pipeline_vmem_bytes(t, w, k)
                if vmem > VMEM_LIMIT_BYTES:
                    excluded.append(Candidate(
                        name, knobs, modeled_us=None,
                        note=(f"EXCLUDED: vmem {vmem // 1024} KiB "
                              f"({STENCIL_PIPELINE_SLOTS} slots) "
                              f"exceeds the "
                              f"{VMEM_LIMIT_BYTES // 1024} KiB "
                              f"scoped-VMEM frame"),
                    ))
                    continue
                feasible.append(Candidate(
                    name, knobs,
                    modeled_us=round(stencil_pipeline_us(
                        h, w, k, t, cdt
                    ), 1),
                    note=(f"vmem {vmem // 1024} KiB, "
                          f"{h // t} stripes/pass"),
                ))
    order = sorted(enumerate(feasible),
                   key=lambda ic: (ic[1].modeled_us, ic[0]))
    return CandidateSet([c for _, c in order], excluded)
