"""Plan data model: every silent default becomes an inspectable decision.

The port's copy of :mod:`smi_tpu_torch.tuning.plan`, name for name. A
:class:`Plan` is the engine's answer to "which knobs should this op run
with here": the chosen knob values, *which layer decided each knob*
(``cache`` — a measured entry in the persistent plan cache; ``live`` —
an entry the online retuner installed; ``model`` — the deterministic
analytic cost model; ``heuristic`` — the frozen defaults), and the
modeled/measured costs the decision was based on. :meth:`Plan.explain`
renders the candidate table.

Keys (:class:`PlanKey`) name the decision point: ``(op, detail, dtype,
device kind, topology)``. ``detail`` is op-specific — the power-of-two
payload bucket for collectives, the causal/window schedule for the
flash kernels, the grid extent for the stencil tier. Device kinds are
normalized by :func:`normalize_device_kind`: lowercased, a trailing
device index stripped. The rule strips every trailing digit, so
``torch.cuda.get_device_name()``'s ``"NVIDIA H100 80GB HBM3"`` keys as
``"nvidia h100 80gb hbm"``, as it does in the JAX package: one cache
file keys both packages alike.

No torch imports here: keys and plans are plain data.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

#: the decision layers, in consultation order. ``live`` is the online
#: retuner's tier (:mod:`smi_tpu_torch.tuning.online`): an entry the live
#: tuner hot-swapped in renders as ``[live]`` — same cache storage,
#: its provenance names the sample count and win margin — so the
#: resolution ladder reads env -> cache -> live -> model -> heuristic.
LAYERS = ("cache", "live", "model", "heuristic")


def normalize_device_kind(kind: Optional[str]) -> str:
    """Canonical device-kind key: lowercased, trailing device index
    stripped (``"TPU v5 lite0"`` -> ``"tpu v5 lite"``), whitespace
    collapsed. Unknown/absent kinds key as ``"unknown"`` — they simply
    never hit a seeded entry."""
    if not kind:
        return "unknown"
    kind = re.sub(r"\d+$", "", str(kind).strip().lower()).strip()
    return re.sub(r"\s+", " ", kind) or "unknown"


def payload_bucket(payload_bytes: int) -> str:
    """Power-of-two payload bucket (``"pow2:20"`` = [1 MiB, 2 MiB)).

    Collective sweeps measure a size grid, not every byte count; the
    bucket is the cache key's resolution, matching the sweep grid's.
    """
    b = max(1, int(payload_bytes))
    return f"pow2:{b.bit_length() - 1}"


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of one tuning decision point."""

    op: str            # "all_reduce", "flash_fwd", "stencil_temporal", ...
    detail: str        # op-specific: payload bucket / schedule / extent
    dtype: str         # "float32", "bfloat16", "int32", ... ("" = any)
    device_kind: str   # normalized (normalize_device_kind)
    topology: str      # "1d:8", "2x4", "chip" (single-chip kernels)

    def signature(self) -> str:
        return "|".join(
            (self.op, self.detail, self.dtype,
             normalize_device_kind(self.device_kind), self.topology)
        )

    @staticmethod
    def from_signature(sig: str) -> "PlanKey":
        parts = sig.split("|")
        if len(parts) != 5:
            raise ValueError(
                f"malformed plan signature {sig!r}: want "
                f"op|detail|dtype|device_kind|topology"
            )
        return PlanKey(*parts)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One candidate configuration with its evidence columns."""

    name: str                       # e.g. "ring", "rs_ag", "bq1024/bk512"
    knobs: Dict[str, object]
    modeled_us: Optional[float] = None
    measured_us: Optional[float] = None
    note: str = ""


@dataclasses.dataclass
class Plan:
    """A resolved tuning decision. ``knobs`` are the values callers use;
    ``decided_by`` names the layer per knob; ``candidates`` carries the
    table :meth:`explain` renders."""

    key: PlanKey
    knobs: Dict[str, object]
    decided_by: Dict[str, str]          # knob -> layer (LAYERS)
    candidates: List[Candidate] = dataclasses.field(default_factory=list)
    rationale: List[str] = dataclasses.field(default_factory=list)

    @property
    def source(self) -> str:
        """The dominant layer: the earliest layer any knob came from
        (cache beats model beats heuristic) — the one-word provenance
        bench.py records next to a measurement."""
        for layer in LAYERS:
            if layer in self.decided_by.values():
                return layer
        return "heuristic"

    def explain(self) -> str:
        """Human-readable candidate table + per-knob decision trail."""
        lines = [f"plan {self.key.signature()}"]
        if self.candidates:
            w = max(len(c.name) for c in self.candidates) + 2
            lines.append(
                f"  {'candidate':<{w}} {'modeled_us':>12} "
                f"{'measured_us':>12}  note"
            )
            for c in self.candidates:
                mod = f"{c.modeled_us:.2f}" if c.modeled_us is not None else "-"
                mea = (f"{c.measured_us:.2f}"
                       if c.measured_us is not None else "-")
                lines.append(
                    f"  {c.name:<{w}} {mod:>12} {mea:>12}  {c.note}"
                )
        for knob in sorted(self.knobs):
            layer = self.decided_by.get(knob, "heuristic")
            lines.append(f"  {knob} = {self.knobs[knob]!r}  [{layer}]")
        for why in self.rationale:
            lines.append(f"  - {why}")
        return "\n".join(lines)
