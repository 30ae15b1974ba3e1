"""Demand elasticity: SLO-driven autoscaling and migration triggers.

The port's copy of :mod:`smi_tpu.serving.elasticity`, kept in step
with it line for line: the same knobs, errors and decisions.

ROADMAP item 2's control loop, closed over signals the stack already
ships — nothing here invents a new measurement:

- **capacity autoscaling** — the controller watches the SLO engine's
  burn rates (:meth:`smi_tpu_torch.obs.slo.SloEngine.health`) and the
  admission gate's queue pressure, and drives the membership
  actuators :func:`~smi_tpu_torch.parallel.membership.regrow_pod` /
  :func:`~smi_tpu_torch.parallel.membership.shrink_pod` — *proactively*,
  before a breach, not after. Scale-out needs :data:`SCALE_OUT_SUSTAIN_TICKS`
  consecutive hot ticks; scale-in needs :data:`SCALE_IN_SUSTAIN_TICKS`
  consecutive cold ticks at under :data:`SCALE_IN_BURN_FRACTION` of
  the scale-out threshold — a hysteresis band, so burn hovering at
  the threshold can never flap capacity — and every actuation starts
  a :data:`SCALE_COOLDOWN_TICKS` cooldown (the retune min-samples /
  margin discipline applied to capacity: noise can never flip it).
- **migration triggers** — a structured
  :class:`~smi_tpu_torch.obs.spans.BlameVerdict` naming a wire-contended
  rank (``wire:rank<r>``) for a hot tenant turns into a live
  migration request against the front-end
  (:meth:`~smi_tpu_torch.serving.frontend.ServingFrontend.request_migration`),
  destination chosen by the same measured load signal the placement
  map uses.

Scale-in *parks* a healthy rank (membership ``scale-in`` transition,
epoch bump, ``ctl.scale`` event) — deliberately distinct from a death:
the detector's history is dropped so a parked rank is never suspected,
and scale-out re-admits it under a fresh incarnation. A victim is only
eligible when it holds **zero residents** (no active stream destined
to it) and its wire lane is empty — capacity changes never strand
accepted work.

Everything is off by default: ``$SMI_TPU_AUTOSCALE`` arms the loop
(the ``default_deadline`` loudness discipline — a typo is a ValueError
naming knob and value, never a silently different behaviour), and
``$SMI_TPU_SCALE_COOLDOWN`` / ``$SMI_TPU_SCALE_BURN_THRESHOLD``
outrank the built-ins below.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

from smi_tpu_torch.obs.spans import BlameVerdict
from smi_tpu_torch.parallel.membership import regrow_pod, shrink_pod

#: Master switch (off by default — elasticity only runs where a
#: caller or the environment asked for it). Boolean vocabulary below;
#: anything else is a LOUD ValueError naming knob and value.
AUTOSCALE_ENV = "SMI_TPU_AUTOSCALE"
SCALE_COOLDOWN_ENV = "SMI_TPU_SCALE_COOLDOWN"
SCALE_BURN_ENV = "SMI_TPU_SCALE_BURN_THRESHOLD"

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("", "0", "false", "no", "off")

#: Ticks after any actuation before the next one may fire — one
#: capacity decision must see its own effect before the next.
#: Overridable by ``$SMI_TPU_SCALE_COOLDOWN``. docs/robustness.md
#: quotes this (drift-guarded).
SCALE_COOLDOWN_TICKS = 64

#: Short-window burn rate at or above which a tick counts as *hot*
#: (1.0 = burning the error budget exactly at the breach rate).
#: Overridable by ``$SMI_TPU_SCALE_BURN_THRESHOLD``.
SCALE_BURN_THRESHOLD = 1.0

#: Consecutive hot ticks (sustained burn or queue pressure) before a
#: scale-out fires — one bursty tick can never grow the pod.
SCALE_OUT_SUSTAIN_TICKS = 12

#: Consecutive cold ticks before a scale-in fires — deliberately
#: several times the scale-out sustain: growing is cheap, stranding
#: capacity mid-crowd is not.
SCALE_IN_SUSTAIN_TICKS = 48

#: A tick is *cold* only when burn is under this fraction of the
#: scale-out threshold (and the queue is quiet) — the hysteresis band
#: between the two thresholds absorbs hover-at-threshold noise.
SCALE_IN_BURN_FRACTION = 0.25

#: The serving floor: scale-in never shrinks below this many members
#: (the front-end's own ``n >= 2`` invariant).
MIN_SERVING_RANKS = 2


def autoscale_enabled() -> bool:
    """``$SMI_TPU_AUTOSCALE``: unset/empty/0/false/no/off = OFF;
    1/true/yes/on = ON; anything else is a loud ValueError."""
    raw = os.environ.get(AUTOSCALE_ENV, "").strip().lower()
    if raw in _FALSY:
        return False
    if raw in _TRUTHY:
        return True
    raise ValueError(
        f"${AUTOSCALE_ENV} must be one of "
        f"{_TRUTHY + tuple(v for v in _FALSY if v)} (or unset), got "
        f"{os.environ.get(AUTOSCALE_ENV)!r}"
    )


def scale_cooldown_ticks() -> int:
    """``$SMI_TPU_SCALE_COOLDOWN`` (a positive tick count — it
    outranks the built-in :data:`SCALE_COOLDOWN_TICKS`), loud on
    malformed or non-positive values."""
    raw = os.environ.get(SCALE_COOLDOWN_ENV, "").strip()
    if not raw:
        return SCALE_COOLDOWN_TICKS
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"${SCALE_COOLDOWN_ENV} must be a positive integer tick "
            f"count, got {raw!r}"
        ) from None
    if value < 1:
        raise ValueError(
            f"${SCALE_COOLDOWN_ENV} must be >= 1 (a zero cooldown "
            f"would let one tick's noise flap capacity), got {raw!r}"
        )
    return value


def scale_burn_threshold() -> float:
    """``$SMI_TPU_SCALE_BURN_THRESHOLD`` (a finite burn rate > 0 — it
    outranks the built-in :data:`SCALE_BURN_THRESHOLD`), loud on
    malformed values: a non-positive threshold would mark every tick
    hot and pin capacity at the ceiling."""
    raw = os.environ.get(SCALE_BURN_ENV, "").strip()
    if not raw:
        return SCALE_BURN_THRESHOLD
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"${SCALE_BURN_ENV} must be a burn-rate threshold, got "
            f"{raw!r}"
        ) from None
    if not math.isfinite(value):
        raise ValueError(
            f"${SCALE_BURN_ENV} must be finite, got {raw!r}"
        )
    if value <= 0:
        raise ValueError(
            f"${SCALE_BURN_ENV} must be > 0 (a non-positive threshold "
            f"marks every tick hot), got {raw!r}"
        )
    return value


class ElasticityController:
    """The demand-elasticity control loop over one serving front-end.

    Deterministic on the front-end's step clock: ``bind()`` parks
    ``spares`` ranks (the grow headroom), then :meth:`step` runs once
    per tick after the SLO engine evaluates, applying at most one
    actuation per tick. ``cooldown`` / ``burn_threshold`` default to
    the env-resolved knobs (env outranks built-ins; an explicit
    argument outranks both).
    """

    def __init__(
        self,
        spares: int = 1,
        cooldown: Optional[int] = None,
        burn_threshold: Optional[float] = None,
        sustain_out: int = SCALE_OUT_SUSTAIN_TICKS,
        sustain_in: int = SCALE_IN_SUSTAIN_TICKS,
        burn_fraction: float = SCALE_IN_BURN_FRACTION,
        min_ranks: int = MIN_SERVING_RANKS,
    ):
        if spares < 0:
            raise ValueError(f"spares must be >= 0, got {spares}")
        if sustain_out < 1 or sustain_in < 1:
            raise ValueError(
                f"sustain windows must be >= 1, got "
                f"out={sustain_out} in={sustain_in}"
            )
        if not 0.0 < burn_fraction < 1.0:
            raise ValueError(
                f"burn_fraction must be in (0, 1) — it IS the "
                f"hysteresis band, got {burn_fraction}"
            )
        self.cooldown = scale_cooldown_ticks() if cooldown is None \
            else cooldown
        if self.cooldown < 1:
            raise ValueError(
                f"cooldown must be >= 1, got {self.cooldown}"
            )
        self.burn_threshold = scale_burn_threshold() \
            if burn_threshold is None else burn_threshold
        if not (math.isfinite(self.burn_threshold)
                and self.burn_threshold > 0):
            raise ValueError(
                f"burn_threshold must be finite and > 0, got "
                f"{self.burn_threshold}"
            )
        self.spares = spares
        self.sustain_out = sustain_out
        self.sustain_in = sustain_in
        self.burn_fraction = burn_fraction
        self.min_ranks = min_ranks
        self.fe = None
        #: ranks currently parked (available to scale out onto)
        self.parked: set = set()
        self.hot_ticks = 0
        self.cold_ticks = 0
        self.last_scale_tick: Optional[int] = None
        #: (tick, direction, rank) audit trail
        self.scale_events: List[tuple] = []
        self.migrations_requested = 0

    # -- wiring ---------------------------------------------------------

    def bind(self, frontend) -> None:
        """Attach to a front-end: arm load-aware placement and park
        the ``spares`` highest ranks as grow headroom (each parking is
        a real ``scale-in`` epoch bump — loud from tick zero)."""
        if self.fe is not None:
            raise RuntimeError("elasticity controller already bound")
        self.fe = frontend
        frontend.placement.armed = True
        floor = max(self.min_ranks, 2)
        for _ in range(self.spares):
            if len(frontend.view.members) <= floor:
                break
            rank = max(frontend.view.members)
            shrink_pod(frontend.view, frontend.detector, rank,
                       reason="spare",
                       token=self._mint(frontend, rank,
                                        f"scale-in of rank {rank}"))
            self.parked.add(rank)

    # -- signal reads ---------------------------------------------------

    def _burn(self) -> float:
        """The hottest short-window burn across classes — the same
        number the SLO report quotes, so an operator can always
        reproduce the controller's view from ``health()``."""
        classes = self.fe.slo.health()["classes"]
        return max(
            (c["burn"]["short"] for c in classes.values()),
            default=0.0,
        )

    def _pressure(self) -> bool:
        gate = self.fe.gate
        return gate.queue_depth() > gate.pool

    # -- the control loop -----------------------------------------------

    def step(self, now: int) -> None:
        """One controller tick: classify hot/cold, age the sustain
        counters, fire at most one actuation."""
        if self.fe is None:
            raise RuntimeError("elasticity controller is not bound")
        burn = self._burn()
        pressure = self._pressure()
        if burn >= self.burn_threshold or pressure:
            self.hot_ticks += 1
            self.cold_ticks = 0
        elif (burn < self.burn_threshold * self.burn_fraction
              and not pressure):
            self.cold_ticks += 1
            self.hot_ticks = 0
        else:
            # inside the hysteresis band: neither signal sustains
            self.hot_ticks = 0
            self.cold_ticks = 0
        if not self._cooled(now):
            return
        if self.hot_ticks >= self.sustain_out and self.parked:
            self._scale_out(now)
        elif self.cold_ticks >= self.sustain_in:
            self._scale_in(now)

    def _cooled(self, now: int) -> bool:
        return (self.last_scale_tick is None
                or now - self.last_scale_tick >= self.cooldown)

    @staticmethod
    def _mint(frontend, rank: int, what: str):
        """The front-end's quorum fencing token for an actuation —
        None when the front-end predates fencing (duck-typed, so the
        controller still binds to bare test doubles)."""
        mint = getattr(frontend, "mint_quorum_token", None)
        return mint(rank=rank, what=what) if mint is not None else None

    def _scale_out(self, now: int) -> None:
        rank = min(self.parked)
        regrow_pod(self.fe.view, self.fe.detector, rank,
                   reason="demand",
                   token=self._mint(self.fe, rank,
                                    f"scale-out of rank {rank}"))
        self.parked.discard(rank)
        self.last_scale_tick = now
        self.hot_ticks = 0
        self.scale_events.append((now, "out", rank))

    def _scale_in_victim(self) -> Optional[int]:
        """The eligible victim, or None: the highest member that holds
        zero residents, has an empty wire lane, is not party to an
        in-flight migration, and whose departure keeps the floor."""
        fe = self.fe
        if len(fe.view.members) <= max(self.min_ranks, 2):
            return None
        mig = getattr(fe, "_migration", None)
        for rank in sorted(fe.view.members, reverse=True):
            if rank in fe.killed:
                continue
            if mig is not None and rank in (mig["src"], mig["dst"]):
                continue
            if any(st.dst == rank for st in fe.active):
                continue
            # resident KV shards (r20): a decode rank whose transport
            # streams all completed still holds the KV its requests
            # generate from — stateful inventory the active-stream
            # census cannot see. Duck-typed: front-ends without an
            # inference engine bound have no inventory to refuse.
            kv = getattr(fe, "kv_shard_residents", None)
            if kv and kv.get(rank):
                continue
            lane = fe.lanes[rank]
            if lane.in_flight or lane.landed:
                continue
            return rank
        return None

    def _scale_in(self, now: int) -> None:
        rank = self._scale_in_victim()
        if rank is None:
            return
        shrink_pod(self.fe.view, self.fe.detector, rank,
                   reason="demand",
                   token=self._mint(self.fe, rank,
                                    f"scale-in of rank {rank}"))
        self.parked.add(rank)
        self.last_scale_tick = now
        self.cold_ticks = 0
        self.scale_events.append((now, "in", rank))

    # -- migration triggers ---------------------------------------------

    def offer_blame(self, verdict: BlameVerdict,
                    tenant: str) -> bool:
        """A tail-latency verdict for a hot tenant: when it convicts a
        specific wire rank, request a live migration off it. Returns
        True when a migration was actually requested."""
        if not isinstance(verdict, BlameVerdict):
            raise TypeError(
                f"offer_blame wants a BlameVerdict, got "
                f"{type(verdict).__name__}: {verdict!r}"
            )
        if self.fe is None:
            raise RuntimeError("elasticity controller is not bound")
        if verdict.kind != "wire" or verdict.rank is None:
            return False
        fe = self.fe
        if getattr(fe, "_migration", None) is not None:
            return False  # one migration at a time
        src = verdict.rank
        if fe._route_new(tenant, record=False) != src:
            return False  # the verdict convicts someone else's rank
        others = sorted(r for r in fe.view.members if r != src)
        if src not in fe.view.members or not others:
            return False
        residents = fe.placement.residents()
        dst = min(others, key=lambda r: (fe._rank_load(r),
                                         residents.get(r, 0), r))
        fe.request_migration(tenant, dst,
                             reason=f"blame:{verdict.resource}")
        self.migrations_requested += 1
        return True

    # -- report ---------------------------------------------------------

    def report(self) -> Dict:
        return {
            "cooldown": self.cooldown,
            "burn_threshold": self.burn_threshold,
            "parked": sorted(self.parked),
            "scale_outs": sum(1 for _, d, _r in self.scale_events
                              if d == "out"),
            "scale_ins": sum(1 for _, d, _r in self.scale_events
                             if d == "in"),
            "events": list(self.scale_events),
            "migrations_requested": self.migrations_requested,
        }
