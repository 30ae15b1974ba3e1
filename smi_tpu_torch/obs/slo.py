"""SLO engine: declarative per-QoS targets, multi-window burn rates.

The port's copy of :mod:`smi_tpu.obs.slo`, kept in step with it
line for line.

The phi-accrual insight (Hayashibara, PAPERS.md) applied to service
health: a binary pass/fail gate answers "did the run break" after the
fact, but a control loop (ROADMAP item 4's demand-elastic serving)
needs a *continuous, threshold-per-consumer* signal while the run is
still going. This module turns the serving front-end's delivery and
shed streams into exactly that:

- an :class:`SloSpec` per QoS class declares the **latency target**
  (admission-to-delivery ticks a delivered stream must beat) and the
  **error budget** (the fraction of requests allowed to miss — shed
  for a service-caused reason, or delivered late);
- the engine folds every delivery/shed into per-tick good/error
  counts and evaluates **burn rates** over two rolling windows on the
  deterministic step clock (:data:`SLO_WINDOWS` — a short window that
  reacts, a long window that refuses to flap; the SRE multi-window
  discipline). ``burn = (error fraction in window) / budget``: burn 1
  means the class is consuming its budget exactly as fast as the spec
  allows;
- transitions are events, not logs: ``slo.burn`` when the short
  window first crosses burn 1 (the early warning), ``slo.breach``
  when BOTH windows burn at ≥ 1 (sustained — the autoscaler's regrow
  trigger), ``slo.recover`` when both fall back under 1. All three
  are emission-validated kinds in the one obs schema.

Policy lines, stated where they bind:

- ``tenant-rate`` sheds are **not** SLO errors: the per-tenant token
  bucket refusing a tenant that exceeds its own contract is the
  service *working*, not failing. Every other shed reason
  (``brownout:*``, ``admission-timeout``, ``backpressure:*``) counts.
- A breach is a *health observation*, never a campaign gate: the
  seeded overload cell is SUPPOSED to brown out best_effort — the
  breach firing there deterministically is the signal working, and
  the fair-weather cells firing zero alarms is the noise floor
  holding (both pinned by ``tests/test_slo.py``).

Everything is deterministic: integer tick counts, integer window
sums, burn rates rendered as rounded floats — same seed, byte-
identical ``health()`` snapshot.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

#: Multi-window burn-rate evaluation windows (ticks): (short, long).
#: The short window catches a fast burn within one admission-wait cap;
#: the long window must agree before a breach is declared, so a
#: one-burst blip can warn but never page. docs/observability.md
#: quotes these (drift-guarded).
SLO_WINDOWS: Tuple[int, int] = (32, 128)

#: Burn rate at/above which a window is considered burning: 1.0 means
#: errors consume the budget exactly as fast as the spec allows.
BREACH_BURN = 1.0

#: Minimum events (good + error) a window must hold before its burn
#: rate means anything: below this, burn reads 0 — one unlucky shed
#: among a handful of requests (or during the first few ticks before
#: the windows fill) must not page. Honestly stated: a class too
#: sparse to clear the floor can never breach; the floor is the
#: noise gate, not a loophole — sheds count as events, so a total
#: outage keeps the window full and burns at rate 1/budget.
MIN_WINDOW_EVENTS = 16


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One QoS class's service-level objective.

    ``latency_target_ticks``: a delivered stream whose admission-to-
    delivery latency exceeds this is an SLO error even though it
    delivered (late is wrong, per class). ``error_budget``: the
    fraction of the class's requests allowed to error inside a burn
    window before the class is breaching.
    """

    qos: str
    latency_target_ticks: int
    error_budget: float

    def __post_init__(self):
        if self.latency_target_ticks < 1:
            raise ValueError(
                f"latency_target_ticks must be >= 1, got "
                f"{self.latency_target_ticks}"
            )
        if not 0.0 < self.error_budget < 1.0:
            raise ValueError(
                f"error_budget must be in (0, 1), got "
                f"{self.error_budget}"
            )

    def to_json(self) -> dict:
        return {
            "latency_target_ticks": self.latency_target_ticks,
            "error_budget": self.error_budget,
        }


#: The shipped per-class SLOs. Latency targets sit well above the
#: fair-weather tails (interactive delivers in a handful of ticks at
#: 1x load) and well below the deadline budgets (400/1200/2400 — the
#: watchdog's hard wall): a stream can be an SLO error long before it
#: is a watchdog failure, which is the point — the burn signal leads
#: the failure. Budgets order strictest-class-strictest.
#: docs/observability.md quotes this table (drift-guarded).
DEFAULT_SLOS: Dict[str, SloSpec] = {
    "interactive": SloSpec("interactive", latency_target_ticks=64,
                           error_budget=0.02),
    "batch": SloSpec("batch", latency_target_ticks=160,
                     error_budget=0.10),
    "best_effort": SloSpec("best_effort", latency_target_ticks=320,
                           error_budget=0.25),
}

#: Shed reasons excluded from the error count: the service refusing a
#: client that broke its own contract is not a service error.
NON_SLO_SHED_REASONS = ("tenant-rate",)


class _ClassState:
    """Rolling burn-window state for one QoS class (all integers)."""

    def __init__(self, spec: SloSpec, windows: Tuple[int, ...]):
        self.spec = spec
        # per window: deque of (good, error) per closed tick + running
        # sums (bounded state — the windows are the only history)
        self.ticks = [deque(maxlen=w) for w in windows]
        self.good_sum = [0] * len(windows)
        self.err_sum = [0] * len(windows)
        # the CURRENT tick's accumulation (closed by evaluate())
        self.pending_good = 0
        self.pending_err = 0
        # full-run accounting
        self.good = 0
        self.errors = 0
        self.errors_by_reason: Dict[str, int] = {}
        self.burns = [0.0] * len(windows)
        self.worst_burn = 0.0
        self.breached = False
        self.breach_started: Optional[int] = None
        self.breaches = 0
        self.recoveries = 0
        self.burn_warnings = 0
        self.breached_ticks = 0
        self._warned = False

    def close_tick(self) -> None:
        for i, window in enumerate(self.ticks):
            if len(window) == window.maxlen:
                g, e = window[0]
                self.good_sum[i] -= g
                self.err_sum[i] -= e
            window.append((self.pending_good, self.pending_err))
            self.good_sum[i] += self.pending_good
            self.err_sum[i] += self.pending_err
            total = self.good_sum[i] + self.err_sum[i]
            if total < MIN_WINDOW_EVENTS:
                self.burns[i] = 0.0  # insufficient evidence
            else:
                rate = self.err_sum[i] / total
                self.burns[i] = rate / self.spec.error_budget
        self.pending_good = 0
        self.pending_err = 0
        if max(self.burns) > self.worst_burn:
            self.worst_burn = max(self.burns)


class SloEngine:
    """Per-QoS-class burn-rate evaluation on the step clock.

    Feed it ``observe_delivery`` / ``observe_shed`` as they happen and
    ``evaluate(now)`` once per tick (the serving front-end wires all
    three). ``recorder``/``metrics`` are the optional obs hooks — one
    event per *transition* (warn/breach/recover, never per tick) and
    the ``slo_*`` counters at the same sites.
    """

    def __init__(
        self,
        specs: Optional[Dict[str, SloSpec]] = None,
        windows: Tuple[int, int] = SLO_WINDOWS,
        recorder=None,
        metrics=None,
    ):
        from smi_tpu_torch.serving.qos import QOS_CLASSES  # leaf; lazy for
        # import-order safety (obs loads before serving finishes init)

        if len(windows) != 2 or windows[0] >= windows[1]:
            raise ValueError(
                f"windows must be (short, long) with short < long, "
                f"got {windows}"
            )
        if any(w < 1 for w in windows):
            raise ValueError(f"windows must be >= 1 tick, got {windows}")
        self.specs = dict(specs if specs is not None else DEFAULT_SLOS)
        missing = [c for c in QOS_CLASSES if c not in self.specs]
        if missing:
            raise ValueError(
                f"SLO specs missing QoS class(es) {missing}; every "
                f"class needs a declared target"
            )
        unknown = [c for c in self.specs if c not in QOS_CLASSES]
        if unknown:
            # a misspelled class key would otherwise be silently
            # dropped — the exact outcome loud validation exists for
            raise ValueError(
                f"SLO specs name unknown QoS class(es) {unknown}; "
                f"known: {QOS_CLASSES}"
            )
        self.windows = tuple(int(w) for w in windows)
        self.recorder = recorder
        self.metrics = metrics
        self._classes: Dict[str, _ClassState] = {
            qos: _ClassState(self.specs[qos], self.windows)
            for qos in QOS_CLASSES
        }

    # -- observation ----------------------------------------------------

    def observe_delivery(self, qos: str, latency_ticks: int,
                         now: int) -> None:
        """One delivered stream: good if within the class's latency
        target, an SLO error (reason ``latency``) otherwise."""
        state = self._classes[qos]
        if latency_ticks <= state.spec.latency_target_ticks:
            state.pending_good += 1
            state.good += 1
        else:
            self._error(state, "latency")

    def observe_shed(self, qos: str, reason: str, now: int) -> None:
        """One named shed. ``tenant-rate`` is excluded (client-caused,
        see :data:`NON_SLO_SHED_REASONS`); every service-caused reason
        burns the budget under its leading token (``brownout``,
        ``admission-timeout``, ``backpressure``)."""
        if reason in NON_SLO_SHED_REASONS:
            return
        self._error(self._classes[qos], reason.split(":")[0])

    def _error(self, state: _ClassState, reason: str) -> None:
        state.pending_err += 1
        state.errors += 1
        state.errors_by_reason[reason] = (
            state.errors_by_reason.get(reason, 0) + 1
        )

    # -- evaluation -----------------------------------------------------

    def evaluate(self, now: int) -> None:
        """Close the tick: fold the pending counts into both windows,
        recompute burn rates, and emit warn/breach/recover transitions
        (events + counters at the transition, never per tick)."""
        short_w, long_w = self.windows
        for qos in sorted(self._classes):
            state = self._classes[qos]
            state.close_tick()
            if state.breached:
                state.breached_ticks += 1
            burn_short, burn_long = state.burns
            if not state.breached:
                if (burn_short >= BREACH_BURN
                        and burn_long >= BREACH_BURN):
                    state.breached = True
                    state.breach_started = now
                    state.breaches += 1
                    state._warned = False
                    self._emit("slo.breach", now, qos=qos, window=long_w,
                               rate=round(burn_long, 4),
                               budget=state.spec.error_budget)
                    self._count("slo_breaches_total", qos=qos)
                elif burn_short >= BREACH_BURN and not state._warned:
                    # the early warning: the short window is burning
                    # but the long window has not (yet) agreed
                    state._warned = True
                    state.burn_warnings += 1
                    self._emit("slo.burn", now, qos=qos, window=short_w,
                               rate=round(burn_short, 4))
                    self._count("slo_burn_warnings_total", qos=qos)
                elif burn_short < BREACH_BURN:
                    state._warned = False
            elif (burn_short < BREACH_BURN
                    and burn_long < BREACH_BURN):
                state.breached = False
                state.recoveries += 1
                state._warned = False
                self._emit(
                    "slo.recover", now, qos=qos,
                    breached_ticks=now - state.breach_started,
                )
                self._count("slo_recoveries_total", qos=qos)

    def _emit(self, kind: str, now: int, **fields) -> None:
        if self.recorder is not None:
            self.recorder.emit(kind, now, **fields)

    def _count(self, name: str, **labels) -> None:
        if self.metrics is not None:
            self.metrics.counter(name, **labels).inc()

    # -- the health snapshot --------------------------------------------

    @property
    def breached(self) -> bool:
        """Any class currently breaching."""
        return any(s.breached for s in self._classes.values())

    def health(self) -> dict:
        """The deterministic health snapshot riding every campaign
        report and ``serve --selftest`` (sorted keys, rounded burns —
        byte-identical per seed)."""
        classes = {}
        for qos in sorted(self._classes):
            s = self._classes[qos]
            classes[qos] = {
                "slo": s.spec.to_json(),
                "good": s.good,
                "errors": s.errors,
                "errors_by_reason": dict(
                    sorted(s.errors_by_reason.items())
                ),
                "burn": {
                    "short": round(s.burns[0], 4),
                    "long": round(s.burns[1], 4),
                },
                "worst_burn": round(s.worst_burn, 4),
                "breached": s.breached,
                "breaches": s.breaches,
                "recoveries": s.recoveries,
                "burn_warnings": s.burn_warnings,
                "breached_ticks": s.breached_ticks,
            }
        return {
            "windows": list(self.windows),
            "breach_burn": BREACH_BURN,
            "min_window_events": MIN_WINDOW_EVENTS,
            "breached": self.breached,
            "breaches_total": sum(
                s.breaches for s in self._classes.values()
            ),
            "classes": classes,
        }


def format_health(health: dict) -> List[str]:
    """Render a :meth:`SloEngine.health` snapshot as text lines (the
    ``smi-tpu health`` / ``serve --selftest`` surface)."""
    lines = [
        f"SLO health (windows {health['windows'][0]}/"
        f"{health['windows'][1]} ticks): "
        + ("BREACHED" if health["breached"] else "ok")
        + f", {health['breaches_total']} breach(es) over the run"
    ]
    for qos, c in health["classes"].items():
        slo = c["slo"]
        state = "BREACHED" if c["breached"] else (
            "burning" if c["burn"]["short"] >= BREACH_BURN else "ok"
        )
        reasons = ", ".join(
            f"{k}={v}" for k, v in c["errors_by_reason"].items()
        ) or "none"
        lines.append(
            f"  {qos:<12} {state:<8} burn {c['burn']['short']:g}/"
            f"{c['burn']['long']:g} (worst {c['worst_burn']:g}) "
            f"target<={slo['latency_target_ticks']} budget "
            f"{slo['error_budget']:g}  good {c['good']} errors "
            f"{c['errors']} [{reasons}]"
        )
    return lines
