"""Chaos under load: open-loop traffic cells and the seeded campaign.

The port's copy of :mod:`smi_tpu.serving.campaign`, kept in step
with it line for line: the same seed gives the same report, byte for
byte as sorted JSON.

Every robustness layer before this one ran against a single batch job;
these cells run the front-end against *sustained open-loop traffic* —
arrivals keep coming whether or not the system keeps up — and assert
the overload story end to end. Three cell shapes:

- **overload** — 2x the service capacity, no faults: admission must
  shed lowest-class-first (brownout ceilings), queue occupancy must
  stay inside the structural bound, interactive p99 admission latency
  must hold, and every accepted stream must still be delivered
  bit-identically;
- **kill** — a seeded kill-one-rank *during* the traffic: phi-accrual
  must confirm the death inside the watchdog budget, tenant routes
  must fail over to heirs, accepted in-flight streams must replay and
  complete bit-identically, straggler traffic from the dead
  incarnation must be rejected by epoch (counted; zero leaks);
- **backpressure** — one rank's consumer stalls (alive, heartbeating:
  the *saturated* half of the dead-vs-saturated distinction): the
  stall must propagate to the admission edge as named shedding, must
  NOT trigger any membership transition beyond a cleared suspicion,
  and every accepted stream must complete once the stall lifts.

Gates per cell (the campaign exit is nonzero if any fails):
zero silent corruption, zero lost-accepted, zero stale-epoch leaks,
bounded queue occupancy, lowest-class-first shedding (brownout sheds
ordered best_effort >= batch >= interactive, with zero interactive
brownout sheds), and interactive p99 admission wait <=
:data:`~smi_tpu_torch.serving.qos.INTERACTIVE_P99_TICKS`. Deterministic per
seed — a red campaign reproduces from its JSON alone
(``smi-tpu chaos --load --seed N``).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from smi_tpu_torch.parallel import faults as F
from smi_tpu_torch.parallel.membership import WATCHDOG_TICKS, QuorumLostError
from smi_tpu_torch.serving.admission import DEFAULT_POOL
from smi_tpu_torch.serving.frontend import ServingFrontend
from smi_tpu_torch.serving.qos import (
    CLASS_ADMISSION_WAIT_TICKS,
    INTERACTIVE_P99_TICKS,
    QOS_CLASSES,
    AdmissionRejected,
    percentile,
)

#: Traffic mix (weights) and chunks-per-request per class: interactive
#: requests are small and frequent, best_effort large and patient.
CLASS_MIX = {"interactive": 3, "batch": 3, "best_effort": 4}
CLASS_CHUNKS = {"interactive": 2, "batch": 4, "best_effort": 6}

#: Minimum campaign cell duration: every seeded fault the campaign can
#: draw (kill at tick 60, SlowConsumer from_tick <= 69) must land
#: INSIDE the traffic schedule with room for its effects to reach the
#: admission edge — a shorter run would report a misleading
#: "fault never fired" gate failure instead of a usage error.
MIN_CAMPAIGN_DURATION = 120


def _payload(tenant: str, stream_seq: int, chunk: int) -> str:
    """Deterministic, content-addressed chunk payload — bit-identity
    of delivery is checked against exactly this."""
    return f"{tenant}/s{stream_seq}/c{chunk}"


def campaign_recorder(duration: int, n: int):
    """A flight recorder sized to retain a WHOLE cell's event stream
    (the r15 span builder refuses a wrapped ring): generous per-tick
    estimate times the schedule, plus a drain cushion.
    ``$SMI_TPU_OBS_RING`` outranks the estimate — the operator's word
    stands, and an undersized override surfaces as a named
    span-exactness problem, never a silent truncation."""
    from smi_tpu_torch.obs.events import FlightRecorder, ring_capacity

    estimate = duration * (n * 8 + 24) + 8192
    return FlightRecorder(capacity=ring_capacity(default=estimate))


def span_fields(fe, report: Dict, problems: List[str]) -> None:
    """Fold the span/blame payload into a cell report and extend the
    gate problems with any span-exactness failure (the bit-identity
    criterion: event-stream component sums == the front-end's own
    measured admission-to-delivery latencies)."""
    from smi_tpu_torch.obs.spans import campaign_fields

    fields, span_problems = campaign_fields(fe)
    report.update(fields)
    problems.extend(span_problems)


def open_loop_traffic(
    seed: int,
    tenants: int,
    duration: int,
    requests_per_tick: float,
):
    """Seeded open-loop arrival schedule: a list per tick of
    ``(tenant, qos)`` submissions. Open-loop means the schedule never
    consults the system's state — arrivals continue regardless of
    shedding, which is what makes overload expressible at all."""
    rng = random.Random(f"traffic:{seed}")
    classes = [c for c in QOS_CLASSES for _ in range(CLASS_MIX[c])]
    schedule: List[List[Tuple[str, str]]] = []
    acc = 0.0
    for _ in range(duration):
        acc += requests_per_tick
        burst = []
        while acc >= 1.0:
            acc -= 1.0
            tenant = f"t{rng.randrange(tenants)}"
            burst.append((tenant, rng.choice(classes)))
        schedule.append(burst)
    return schedule


def run_load_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 240,
    overload: float = 1.0,
    kill_rank: Optional[int] = None,
    kill_at: int = 60,
    stall_rank: Optional[int] = None,
    stall_at: int = 40,
    stall_ticks: int = 60,
    tenants: int = 6,
    pool: int = DEFAULT_POOL,
    plan: Optional[F.FaultPlan] = None,
    return_frontend: bool = False,
):
    """One chaos-under-load cell: open-loop traffic, optional fault,
    full drain, gates evaluated. Deterministic per (shape, seed).

    Faults come either as explicit knobs (``kill_rank``/``kill_at``,
    ``stall_rank``/...) or as a :class:`~smi_tpu_torch.parallel.faults.FaultPlan`
    carrying serving-level faults: each
    :class:`~smi_tpu_torch.parallel.faults.SlowConsumer` maps onto a
    consumer stall in ticks (the seeded draw
    ``FaultPlan.random("slow_consumer", n, seed)`` is how the campaign
    sweeps the class). ``return_frontend=True`` returns
    ``(report, frontend)`` — the span/trace consumers need the live
    recorder, not just the report."""
    fe = ServingFrontend(n, seed=seed, pool=pool,
                         recorder=campaign_recorder(duration, n))
    if plan is not None:
        if plan.slow_consumers and stall_rank is not None:
            raise ValueError(
                "pass a stall either explicitly or via the plan, "
                "not both"
            )
        if len(plan.slow_consumers) > 1:
            raise ValueError(
                f"run_load_cell drives one SlowConsumer per cell; "
                f"the plan carries {len(plan.slow_consumers)} — "
                f"sweep more cells instead"
            )
        for f in plan.slow_consumers:
            stall_rank, stall_at = f.rank, f.from_tick
            stall_ticks = f.stall_ticks
    if kill_rank is not None and kill_at >= duration:
        raise ValueError(
            f"kill_at={kill_at} never fires inside a {duration}-tick "
            f"schedule — raise duration past the fault tick"
        )
    if stall_rank is not None and stall_at >= duration:
        raise ValueError(
            f"stall at tick {stall_at} never fires inside a "
            f"{duration}-tick schedule — raise duration past the "
            f"fault tick"
        )
    mean_chunks = (
        sum(CLASS_MIX[c] * CLASS_CHUNKS[c] for c in QOS_CLASSES)
        / sum(CLASS_MIX.values())
    )
    capacity = n * fe.consume_rate  # chunks/tick
    requests_per_tick = overload * capacity / mean_chunks
    schedule = open_loop_traffic(seed, tenants, duration,
                                 requests_per_tick)
    tenant_seq: Dict[str, int] = {}
    submitted = 0
    verdict = "ok"
    try:
        for tick, burst in enumerate(schedule):
            now = fe.clock.now()
            if kill_rank is not None and tick == kill_at:
                fe.kill(kill_rank)
            if stall_rank is not None and tick == stall_at:
                fe.stall_consumer(stall_rank, now + stall_ticks)
            for tenant, qos in burst:
                submitted += 1
                seq = tenant_seq.get(tenant, 0)
                tenant_seq[tenant] = seq + 1
                chunks = tuple(
                    _payload(tenant, seq, c)
                    for c in range(CLASS_CHUNKS[qos])
                )
                try:
                    fe.submit(tenant, qos, chunks)
                except AdmissionRejected:
                    pass  # named + recorded by the gate
            fe.step()
        fe.drain()
    except Exception as e:  # a watchdog/assert firing IS the verdict
        verdict = f"{type(e).__name__}: {e}"

    report = fe.report()
    report.update({
        "seed": seed,
        "duration": duration,
        "overload": overload,
        "kill_rank": kill_rank,
        "stall_rank": stall_rank,
        "plan": plan.describe() if plan is not None else [],
        "submitted_total": submitted,
        "offered_chunks_per_tick": round(
            requests_per_tick * mean_chunks, 3
        ),
        "capacity_chunks_per_tick": capacity,
        # the deterministic metrics snapshot (smi_tpu_torch.obs): its
        # admitted/shed counters are incremented at the gate's own
        # accounting sites, so they EQUAL the report's bookkeeping —
        # tested, and the `--metrics` CLI surfaces quote it
        "metrics": fe.metrics.snapshot(),
    })

    # -- gates ----------------------------------------------------------
    problems: List[str] = []
    if verdict != "ok":
        problems.append(verdict)
    if report["silent_corruptions"]:
        problems.append(
            f"silent corruption: {report['silent_corruptions']} "
            f"stream(s) delivered wrong bits"
        )
    if report["lost_accepted"]:
        problems.append(
            f"lost accepted: {report['lost_accepted']} admitted "
            f"stream(s) never delivered"
        )
    if report["stale_epoch_leaks"]:
        problems.append("stale-epoch traffic accepted")
    if report["max_queue_depth"] > report["queue_bound"]:
        problems.append(
            f"queue occupancy {report['max_queue_depth']} exceeded "
            f"bound {report['queue_bound']}"
        )
    brownout = {
        c: sum(v for k, v in report["shed"][c].items()
               if k.startswith("brownout") or k == "admission-timeout")
        for c in QOS_CLASSES
    }
    report["brownout_shed"] = brownout
    # destination-unavailability sheds (per-route backpressure) are a
    # separate, named category: class-blind by design, so they are
    # excluded from the lowest-class-first ordering gate
    report["backpressure_shed"] = {
        c: sum(v for k, v in report["shed"][c].items()
               if k.startswith("backpressure:"))
        for c in QOS_CLASSES
    }
    if kill_rank is None and brownout["interactive"] > 0:
        # fair weather and saturation: interactive never browns out.
        # During a kill's detection blackout the pool can genuinely
        # exhaust (stalled streams hold their credits by design), so
        # there the guarantee is ORDERING + the bounded wait cap.
        problems.append(
            f"interactive brownout-shed {brownout['interactive']} "
            f"(> 0): shedding is not lowest-class-first"
        )
    if (brownout["best_effort"] < brownout["batch"]
            or brownout["batch"] < brownout["interactive"]):
        problems.append(
            "shedding not lowest-class-first: best_effort "
            f"{brownout['best_effort']} / batch {brownout['batch']} / "
            f"interactive {brownout['interactive']}"
        )
    waits = report["admission_waits"]["interactive"]
    p99 = percentile(waits, 0.99)
    report["admission_latency"] = {
        c: {
            "p50": percentile(report["admission_waits"][c], 0.50),
            "p99": percentile(report["admission_waits"][c], 0.99),
        }
        for c in QOS_CLASSES
    }
    # the p99 bound: tight in fair weather, the structural wait cap
    # during a kill's detection blackout (bounded either way — the
    # admission edge sheds rather than queue past the cap)
    p99_bound = (INTERACTIVE_P99_TICKS if kill_rank is None
                 else CLASS_ADMISSION_WAIT_TICKS["interactive"])
    report["interactive_p99_bound"] = p99_bound
    if p99 is not None and p99 > p99_bound:
        problems.append(
            f"interactive p99 admission latency {p99:g} ticks "
            f"exceeds the {p99_bound}-tick bound"
        )
    if kill_rank is not None:
        if report["confirmed"] != [kill_rank]:
            problems.append(
                f"kill of rank {kill_rank} not confirmed "
                f"(confirmed: {report['confirmed']})"
            )
        elif report["detect_ticks"] is None or (
            report["detect_ticks"] > WATCHDOG_TICKS
        ):
            problems.append(
                f"detect latency {report['detect_ticks']} ticks "
                f"outside the {WATCHDOG_TICKS}-tick watchdog budget"
            )
        if not report["stale_epoch_rejections"]:
            problems.append("straggler from dead incarnation was "
                            "never presented/rejected")
    if stall_rank is not None:
        if report["confirmed"]:
            problems.append(
                f"stalled-but-alive consumer confirmed dead: "
                f"{report['confirmed']} (saturation mistaken for "
                f"death)"
            )
        if not any(report["backpressure_shed"].values()):
            problems.append(
                "consumer stall never propagated to the admission "
                "edge (zero backpressure sheds)"
            )
    # the r15 span layer: per-request span trees from the event
    # stream, the tail-latency blame verdict, and the bit-identity
    # exactness gate (span-component sums == measured latencies)
    span_fields(fe, report, problems)
    # drop the unhashed per-request wait lists from the shipped report
    # (the percentiles above carry the evidence)
    del report["admission_waits"]
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    if return_frontend:
        return report, fe
    return report


def load_campaign(
    seed: int = 0,
    n: int = 4,
    duration: int = 240,
    trials: int = 1,
    retune: bool = False,
    flash_crowd: bool = False,
) -> Dict:
    """The seeded chaos-under-load campaign: one overload cell, one
    kill-one-rank cell, and one backpressure cell per trial, each
    deterministic per seed. Exit gate: every cell ``ok``.

    ``duration`` below :data:`MIN_CAMPAIGN_DURATION` is a loud
    ``ValueError``: the seeded fault ticks would fall outside the
    schedule and report as (bogus) detection failures."""
    if duration < MIN_CAMPAIGN_DURATION:
        raise ValueError(
            f"campaign duration {duration} is below the "
            f"{MIN_CAMPAIGN_DURATION}-tick minimum: the seeded kill "
            f"(tick 60) and consumer-stall (from_tick <= 69) cells "
            f"need the fault inside the traffic schedule"
        )
    cells: List[Dict] = []
    for trial in range(trials):
        base = random.Random(f"load:{seed}:{trial}").randrange(1 << 30)
        kill = random.Random(f"kill:{seed}:{trial}").randrange(n)
        stall_plan = F.FaultPlan.random(
            "slow_consumer", n,
            random.Random(f"stall:{seed}:{trial}").randrange(1 << 30),
        )
        shapes = [
            ("overload", dict(overload=2.0)),
            ("kill", dict(overload=1.0, kill_rank=kill, kill_at=60)),
            ("backpressure", dict(overload=1.0, plan=stall_plan)),
        ]
        for name, kwargs in shapes:
            report = run_load_cell(
                n=n, seed=base, duration=duration, **kwargs
            )
            report["cell"] = name
            report["trial"] = trial
            cells.append(report)
        if retune:
            # the r14 cell: the payload distribution shifts mid-run
            # and the online tuner must hot-swap to the offline-sweep
            # pick with bit-identical delivery
            report = run_retune_cell(n=n, seed=base, duration=duration)
            report["cell"] = "retune-shift"
            report["trial"] = trial
            cells.append(report)
        if flash_crowd:
            # the r16 cell: one tenant 10x's its rate mid-run and
            # capacity must follow the load — scale-out, (blame-driven
            # migration when convicted), scale-in, loss-free
            report = run_flash_crowd_cell(
                n=n, seed=base,
                duration=max(duration, MIN_FLASH_CROWD_DURATION),
            )
            report["cell"] = "flash-crowd"
            report["trial"] = trial
            cells.append(report)
    failures = [c for c in cells if not c["ok"]]
    return {
        "seed": seed,
        "n": n,
        "duration": duration,
        "trials": trials,
        "cells": len(cells),
        "outcomes": {
            c["cell"]: ("ok" if c["ok"] else "failed") for c in cells
        },
        "failures": [
            {"cell": c["cell"], "trial": c["trial"],
             "verdict": c["verdict"]}
            for c in failures
        ],
        "silent_corruptions": sum(
            c["silent_corruptions"] for c in cells
        ),
        "lost_accepted": sum(c["lost_accepted"] for c in cells),
        "stale_epoch_leaks": sum(
            c["stale_epoch_leaks"] for c in cells
        ),
        "reports": cells,
        "ok": not failures,
    }


def run_retune_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 240,
    tenants: int = 4,
    pool: int = DEFAULT_POOL,
    slices: Optional[int] = None,
    small_kb: int = 64,
    large_kb: int = 4096,
    kill_rank: Optional[int] = None,
    kill_at: int = 60,
    return_frontend: bool = False,
):
    """The seeded payload-shift retuning cell (ROADMAP item 3's gate).

    A front-end runs with the online tuner wired
    (``ServingFrontend(retune=)``); every admitted request stands for
    one allreduce whose live timing is the Hockney pricing of the
    ACTIVE plan at that payload (the credits simulator's wire tiers)
    with seeded ±5% noise — exactly the measurement
    ``tracing.timed(sink=tuner)`` would stream on hardware, made
    deterministic. The tenants' payload distribution shifts mid-run
    (``small_kb`` → ``large_kb``), invalidating a STALE offline sweep
    entry that pinned the fused ring for the large bucket: the tuner
    must shadow-compare, propose, quiesce (drain the proposing
    tenant's in-flight streams), hot-swap the entry under a bumped
    plan epoch + revision, and converge to the plan a fresh offline
    sweep would pick for the new distribution (rs+ag flat,
    hierarchical on a ``slices``-pod) — with bit-identical delivery
    throughout, zero lost-accepted, zero stale-plan leaks, and zero
    swaps before the shift (the noise-can't-flip thresholds).
    """
    from smi_tpu_torch.tuning import cost_model as cm
    from smi_tpu_torch.tuning.cache import CacheEntry, PlanCache
    from smi_tpu_torch.tuning.engine import _collective_topology
    from smi_tpu_torch.tuning.online import OnlineTuner, priced_sample_us
    from smi_tpu_torch.tuning.plan import PlanKey, payload_bucket

    if duration < MIN_CAMPAIGN_DURATION:
        raise ValueError(
            f"retune cell duration {duration} is below the "
            f"{MIN_CAMPAIGN_DURATION}-tick minimum: the payload shift "
            f"(mid-run) and the post-shift sample window both need "
            f"room inside the schedule"
        )
    if kill_rank is not None and kill_at >= duration:
        raise ValueError(
            f"kill_at={kill_at} never fires inside a {duration}-tick "
            f"schedule — raise duration past the fault tick"
        )
    if slices is not None:
        if slices < 2 or 8 % slices:
            raise ValueError(
                f"slices={slices} does not tier an 8-rank pod "
                f"(need a divisor >= 2)"
            )
        topo = cm.TopologySpec(n=8, inner=8 // slices, outer=slices)
    else:
        topo = cm.TopologySpec(n=8)
    device_kind = "live-sim"
    small_bytes, large_bytes = small_kb * 1024, large_kb * 1024
    if payload_bucket(small_bytes) == payload_bucket(large_bytes):
        raise ValueError(
            f"small_kb={small_kb} and large_kb={large_kb} land in the "
            f"same payload bucket — no distribution shift to retune on"
        )

    # the stale offline artifact: yesterday's sweep (run under the
    # small-payload mix this tenant no longer sends) pinned the fused
    # ring for the large bucket — the entry the live tuner must retire
    cache = PlanCache()
    topology = _collective_topology(topo)
    large_key = PlanKey("all_reduce", payload_bucket(large_bytes),
                        "float32", device_kind, topology)
    cache.put(large_key, CacheEntry(
        {"algorithm": "ring"},
        cost_us=round(priced_sample_us(
            "all_reduce", "ring", small_bytes, topo), 3),
        provenance="sweep:stale-offline",
    ))
    tuner = OnlineTuner(cache=cache, topo=topo,
                        device_kind=device_kind)
    fe = ServingFrontend(n, seed=seed, pool=pool, retune=tuner,
                         recorder=campaign_recorder(duration, n))

    # what a FRESH offline sweep would measure best for the new
    # distribution: the model's top candidate (samples are priced by
    # the same tables, so measurement and model agree here by
    # construction — the deterministic analog of the ATLAS claim)
    expected = cm.allreduce_candidates(large_bytes, topo)[0].name

    shift_at = duration // 2
    noise = random.Random(f"retune-noise:{seed}")
    mean_chunks = (
        sum(CLASS_MIX[c] * CLASS_CHUNKS[c] for c in QOS_CLASSES)
        / sum(CLASS_MIX.values())
    )
    capacity = n * fe.consume_rate
    requests_per_tick = capacity / mean_chunks
    schedule = open_loop_traffic(seed, tenants, duration,
                                 requests_per_tick)
    tenant_seq: Dict[str, int] = {}
    submitted = 0
    swap_tick = None
    early_swaps = 0
    verdict = "ok"
    try:
        for tick, burst in enumerate(schedule):
            if kill_rank is not None and tick == kill_at:
                fe.kill(kill_rank)
            payload = small_bytes if tick < shift_at else large_bytes
            for tenant, qos in burst:
                submitted += 1
                seq = tenant_seq.get(tenant, 0)
                tenant_seq[tenant] = seq + 1
                chunks = tuple(
                    _payload(tenant, seq, c)
                    for c in range(CLASS_CHUNKS[qos])
                )
                try:
                    fe.submit(tenant, qos, chunks)
                except AdmissionRejected:
                    # shed at the edge: the allreduce this request
                    # stood for never ran, so there is no timing to
                    # record — a rejected request must not inflate a
                    # cell's sample count toward the min_samples gate
                    continue
                # the live timing of the allreduce this request
                # drives, under whatever plan is ACTIVE right now
                entry = tuner.active_entry(
                    tuner.plan_key("all_reduce", payload)
                )
                algorithm = (
                    str(entry.knobs["algorithm"]) if entry is not None
                    else cm.allreduce_candidates(payload, topo)[0].name
                )
                us = priced_sample_us(
                    "all_reduce", algorithm, payload, topo
                ) * (1.0 + (noise.random() - 0.5) * 0.1)
                tuner.record("all_reduce", us * 1e-6,
                             payload_bytes=payload, tenant=tenant)
            fe.step()
            if tuner.swaps and swap_tick is None:
                swap_tick = tick
                if tick < shift_at:
                    early_swaps += 1
        fe.drain()
    except Exception as e:  # a watchdog/assert firing IS the verdict
        verdict = f"{type(e).__name__}: {e}"

    report = fe.report()
    final = tuner.active_entry(large_key)
    converged_algorithm = (
        str(final.knobs["algorithm"]) if final is not None else None
    )
    report.update({
        "seed": seed,
        "duration": duration,
        "shift_at": shift_at,
        "small_kb": small_kb,
        "large_kb": large_kb,
        "slices": slices,
        "kill_rank": kill_rank,
        "submitted_total": submitted,
        "expected_algorithm": expected,
        "converged_algorithm": converged_algorithm,
        "converged_revision": final.revision if final else None,
        "swap_tick": swap_tick,
        "convergence_ticks": (swap_tick - shift_at
                              if swap_tick is not None else None),
        "metrics": fe.metrics.snapshot(),
    })

    # -- gates ----------------------------------------------------------
    problems: List[str] = []
    if verdict != "ok":
        problems.append(verdict)
    if report["silent_corruptions"]:
        problems.append(
            f"silent corruption: {report['silent_corruptions']} "
            f"stream(s) delivered wrong bits"
        )
    if report["lost_accepted"]:
        problems.append(
            f"lost accepted: {report['lost_accepted']} admitted "
            f"stream(s) never delivered"
        )
    if report["stale_epoch_leaks"]:
        problems.append("stale-epoch traffic accepted")
    rt = report["retune"]
    if rt["stale_plan_leaks"]:
        problems.append("stale-plan traffic accepted")
    if report["max_queue_depth"] > report["queue_bound"]:
        problems.append(
            f"queue occupancy {report['max_queue_depth']} exceeded "
            f"bound {report['queue_bound']}"
        )
    if early_swaps:
        problems.append(
            f"{early_swaps} swap(s) fired BEFORE the payload shift — "
            f"noise flipped a plan the thresholds should hold"
        )
    if rt["swaps"] < 1:
        problems.append(
            "the tuner never swapped: the stale offline entry "
            "survived the shifted distribution"
        )
    elif converged_algorithm != expected:
        problems.append(
            f"converged to {converged_algorithm!r} but a fresh "
            f"offline sweep of the shifted distribution picks "
            f"{expected!r}"
        )
    if rt["swaps"] >= 1 and not rt["stale_plan_rejections"]:
        problems.append(
            "post-swap straggler was never presented/rejected"
        )
    if rt["rollbacks"]:
        problems.append(
            f"{rt['rollbacks']} rollback(s) in the seeded cell — "
            f"quiesce did not drain inside its window"
        )
    if kill_rank is not None and report["confirmed"] != [kill_rank]:
        problems.append(
            f"kill of rank {kill_rank} not confirmed "
            f"(confirmed: {report['confirmed']})"
        )
    waits = report["admission_waits"]
    report["admission_latency"] = {
        c: {
            "p50": percentile(waits[c], 0.50),
            "p99": percentile(waits[c], 0.99),
        }
        for c in QOS_CLASSES
    }
    span_fields(fe, report, problems)
    del report["admission_waits"]
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    if return_frontend:
        return report, fe
    return report


def retune_selftest(seed: int = 0) -> Dict:
    """The ``smi-tpu serve --selftest --retune`` smoke: the seeded
    payload-shift cell at a fast shape — the tuner must converge to
    the offline-sweep pick with bit-identical delivery."""
    return run_retune_cell(n=4, seed=seed, duration=160)


# ---------------------------------------------------------------------------
# Demand elasticity (r16): flash-crowd, migration, migrate-under-kill
# ---------------------------------------------------------------------------

#: Minimum flash-crowd cell duration: the arc needs a fair-weather
#: lead-in, a crowd long enough to sustain scale-out past its
#: hysteresis, and a post-crowd tail long enough for the burn windows
#: to drain AND the scale-in sustain + cooldown to elapse.
MIN_FLASH_CROWD_DURATION = 240


def _delivery_digest(fe) -> Dict:
    """The bit-identity witness: every completed stream's DELIVERED
    payloads (what actually crossed the wire and was consumed, in
    sequence order), keyed by (tenant, stream seq). The migration
    cell diffs this against a no-migration control: any stream BOTH
    arms completed must carry identical bits. (The arms' accepted
    sets may lawfully diverge after the cutover — moving the tenant
    changes which rank later arrivals queue on, so backpressure may
    shed different requests — but delivery, for comparable work,
    must be bit-identical.)"""
    return {
        (st.request.tenant, st.request.stream_id[1]):
            tuple(st.delivered[k] for k in sorted(st.delivered))
        for st in fe.completed
    }


def _offer_live_blame(fe, ctrl, tenant: str) -> Dict:
    """Mid-run blame: build spans over the partial event stream,
    take the cell-level verdict, and offer it to the controller.
    Returns the audit dict the cell report carries; a span build
    failing mid-run is recorded, never raised (the end-of-run
    exactness gate still runs over the full stream)."""
    from smi_tpu_torch.obs.spans import (
        SpanError,
        blame_report,
        blame_verdict,
        frontend_spans,
    )

    try:
        spans = frontend_spans(fe, allow_partial=True)
        verdict = blame_verdict(blame_report(spans))
    except SpanError as e:
        return {"verdict": None, "offered": False,
                "error": str(e)}
    return {
        "verdict": str(verdict),
        "kind": verdict.kind,
        "rank": verdict.rank,
        "offered": ctrl.offer_blame(verdict, tenant),
        "error": None,
    }


def run_flash_crowd_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 240,
    tenants: int = 6,
    pool: int = DEFAULT_POOL,
    spares: int = 1,
    crowd_factor: int = 10,
    return_frontend: bool = False,
):
    """The seeded flash-crowd cell (ROADMAP item 2's gate): one tenant
    ``crowd_factor``x's its arrival rate mid-run and capacity must
    FOLLOW the load, not just survive it.

    The controller parks ``spares`` ranks at bind (grow headroom), so
    fair weather runs on the reduced pod. The crowd (middle third of
    the schedule) drives sustained queue pressure + batch-class burn:
    the controller must scale OUT onto a parked rank (hysteresis +
    cooldown mean one bursty tick can never do it); at the crowd's
    midpoint the live blame verdict is offered — a ``wire:rank<r>``
    conviction of the hot tenant's rank turns into a live migration
    (gated loud, named, loss-free when it fires). After the crowd the
    burn windows drain, the cold sustain elapses, and the controller
    must scale back IN — ending with at least ``spares`` ranks
    parked. Throughout: interactive p99 admission wait holds the
    fair-weather cap, interactive is never brownout-shed (the crowd
    cannot break lowest-class-first), every SLO page is backed by
    recorded errors and unlatches once the crowd drains (zero false
    alarms, zero stuck alarms), and the standard zero-corruption /
    zero-lost / zero-stale-leak gates hold.
    """
    from smi_tpu_torch.serving.elasticity import ElasticityController

    if duration < MIN_FLASH_CROWD_DURATION:
        raise ValueError(
            f"flash-crowd cell duration {duration} is below the "
            f"{MIN_FLASH_CROWD_DURATION}-tick minimum: the crowd, the "
            f"burn-window drain, and the scale-in sustain + cooldown "
            f"must all fit inside the schedule"
        )
    if crowd_factor < 2:
        raise ValueError(
            f"crowd_factor={crowd_factor} is not a flash crowd — "
            f"need >= 2 (the hot tenant must actually surge)"
        )
    if not 1 <= spares <= n - 2:
        raise ValueError(
            f"spares={spares} leaves no headroom arc for n={n}: need "
            f"1 <= spares <= n - 2 (park something, keep the floor)"
        )
    ctrl = ElasticityController(spares=spares)
    fe = ServingFrontend(n, seed=seed, pool=pool, elasticity=ctrl,
                         recorder=campaign_recorder(duration, n))
    mean_chunks = (
        sum(CLASS_MIX[c] * CLASS_CHUNKS[c] for c in QOS_CLASSES)
        / sum(CLASS_MIX.values())
    )
    # fair weather is sized to the REDUCED pod the spares leave
    capacity = len(fe.view.members) * fe.consume_rate
    requests_per_tick = 0.7 * capacity / mean_chunks
    schedule = open_loop_traffic(seed, tenants, duration,
                                 requests_per_tick)
    hot = "t0"
    # the crowd must land BEFORE a fair-weather cold sustain can
    # elapse (an error-free pod is always burn-cold, so the
    # controller would otherwise park toward the floor first and
    # spend the crowd inside the actuation cooldown)
    crowd_from = min(duration // 4, ctrl.sustain_in // 2)
    crowd_to = duration // 2
    # offer the blame verdict periodically through the crowd until
    # one lands: the migration is what relieves the hot tenant's
    # rank WHILE the crowd still rages (early offers may find the
    # tail not yet convicting it — keep asking, deterministically)
    blame_from = crowd_from + (crowd_to - crowd_from) // 4
    blame_every = 8
    # the hot tenant's own share of the open-loop rate, surged to
    # crowd_factor x: the extra arrivals ride on top of its base
    extra_rate = (crowd_factor - 1) * requests_per_tick / tenants
    tenant_seq: Dict[str, int] = {}
    submitted = 0
    crowd_submitted = 0
    crowd_acc = 0.0
    blame = {"verdict": None, "offered": False, "error": None}
    verdict = "ok"

    def _submit(tenant: str, qos: str) -> None:
        nonlocal submitted
        submitted += 1
        seq = tenant_seq.get(tenant, 0)
        tenant_seq[tenant] = seq + 1
        chunks = tuple(
            _payload(tenant, seq, c)
            for c in range(CLASS_CHUNKS[qos])
        )
        try:
            fe.submit(tenant, qos, chunks)
        except AdmissionRejected:
            pass  # named + recorded by the gate

    try:
        for tick, burst in enumerate(schedule):
            for tenant, qos in burst:
                _submit(tenant, qos)
            if crowd_from <= tick < crowd_to:
                crowd_acc += extra_rate
                while crowd_acc >= 1.0:
                    crowd_acc -= 1.0
                    crowd_submitted += 1
                    _submit(hot, "batch")
            fe.step()
            if (ctrl.migrations_requested == 0
                    and blame_from <= tick < crowd_to
                    and (tick - blame_from) % blame_every == 0):
                blame = _offer_live_blame(fe, ctrl, hot)
        fe.drain()
        # a quiet coda: the controller keeps stepping on an idle
        # system until the scale-in sustain + cooldown can elapse AND
        # every latched SLO page unlatches. Recovery needs the long
        # burn window to slide past the crowd's error era — an
        # under-populated window reads burn 0.0 ("insufficient
        # evidence"), so idle ticks DO drain it. The bound is
        # generous; an alarm still latched past it is genuinely stuck
        # and the gate below fires.
        coda_bound = (ctrl.sustain_in + ctrl.cooldown
                      + 2 * max(fe.slo.windows) + 64)
        for _ in range(coda_bound):
            if (len(ctrl.parked) >= spares
                    and not any(
                        cls["breached"]
                        for cls in fe.slo.health()["classes"].values()
                    )):
                break
            fe.step()
    except Exception as e:  # a watchdog/assert firing IS the verdict
        verdict = f"{type(e).__name__}: {e}"

    report = fe.report()
    report.update({
        "seed": seed,
        "duration": duration,
        "crowd_window": [crowd_from, crowd_to],
        "crowd_factor": crowd_factor,
        "crowd_submitted": crowd_submitted,
        "hot_tenant": hot,
        "spares": spares,
        "submitted_total": submitted,
        "blame_offer": blame,
        "metrics": fe.metrics.snapshot(),
    })

    # -- gates ----------------------------------------------------------
    problems: List[str] = []
    if verdict != "ok":
        problems.append(verdict)
    if report["silent_corruptions"]:
        problems.append(
            f"silent corruption: {report['silent_corruptions']} "
            f"stream(s) delivered wrong bits"
        )
    if report["lost_accepted"]:
        problems.append(
            f"lost accepted: {report['lost_accepted']} admitted "
            f"stream(s) never delivered"
        )
    if report["stale_epoch_leaks"]:
        problems.append("stale-epoch traffic accepted")
    if report["max_queue_depth"] > report["queue_bound"]:
        problems.append(
            f"queue occupancy {report['max_queue_depth']} exceeded "
            f"bound {report['queue_bound']}"
        )
    el = report.get("elasticity", {})
    outs = [t for t, d, _r in el.get("events", ()) if d == "out"]
    ins = [t for t, d, _r in el.get("events", ()) if d == "in"]
    if not outs:
        problems.append(
            "the crowd never scaled the pod OUT: sustained pressure "
            "left the spare parked"
        )
    elif outs[0] < crowd_from:
        problems.append(
            f"scale-out at tick {outs[0]} PRECEDES the crowd "
            f"(tick {crowd_from}) — fair weather flapped capacity"
        )
    if not any(outs and t > outs[0] for t in ins):
        problems.append(
            "capacity never followed the load back down: no "
            "scale-in after the crowd's scale-out"
        )
    if len(el.get("parked", ())) < spares:
        problems.append(
            f"ended with {sorted(el.get('parked', ()))} parked — "
            f"capacity did not come back down to headroom"
        )
    for mig in el.get("migrations", ()):
        if mig["state"] != "committed":
            problems.append(
                f"migration of {mig['tenant']!r} ended "
                f"{mig['state']} ({mig.get('abort_reason', '?')})"
            )
        elif not mig["reason"].startswith("blame:wire:rank"):
            problems.append(
                f"migration of {mig['tenant']!r} carries reason "
                f"{mig['reason']!r} — not the blame verdict that "
                f"triggered it"
            )
    # SLO false alarms: a page with zero recorded errors, or one
    # still latched after the crowd drained, is spurious. (A page
    # DURING the crowd backed by real sheds is a true alarm — the
    # signal the controller scales on.)
    health = report["health"]["classes"]
    for qos in sorted(health):
        cls = health[qos]
        if cls["breaches"] and not cls["errors"]:
            problems.append(
                f"{qos} paged with zero recorded errors — an SLO "
                f"false alarm"
            )
        if cls["breached"]:
            problems.append(
                f"{qos} is still paging after the crowd drained — "
                f"a stuck alarm"
            )
    interactive_brownout = sum(
        v for k, v in report["shed"]["interactive"].items()
        if k.startswith("brownout") or k == "admission-timeout"
    )
    if interactive_brownout:
        problems.append(
            f"interactive brownout-shed {interactive_brownout} "
            f"(> 0): the crowd broke lowest-class-first shedding"
        )
    waits = report["admission_waits"]
    report["admission_latency"] = {
        c: {
            "p50": percentile(waits[c], 0.50),
            "p99": percentile(waits[c], 0.99),
        }
        for c in QOS_CLASSES
    }
    p99 = report["admission_latency"]["interactive"]["p99"]
    if p99 is not None and p99 > INTERACTIVE_P99_TICKS:
        problems.append(
            f"interactive p99 admission latency {p99:g} ticks "
            f"exceeds the {INTERACTIVE_P99_TICKS}-tick bound"
        )
    span_fields(fe, report, problems)
    del report["admission_waits"]
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    if return_frontend:
        return report, fe
    return report


def _distinct_home_tenants(n: int, count: int) -> List[str]:
    """``count`` deterministic tenant names with pairwise-distinct
    crc32 home ranks mod ``n`` — each rank hosts at most one tenant,
    so 'one hot tenant' means exactly one hot RANK (a crc32 collision
    would silently double-load a rank and shed)."""
    from smi_tpu_torch.serving.placement import tenant_base_rank

    names: List[str] = []
    homes: set = set()
    i = 0
    while len(names) < count:
        cand = f"m{i}"
        home = tenant_base_rank(cand, n)
        if home not in homes:
            homes.add(home)
            names.append(cand)
        i += 1
    return names


def _run_migration_traffic(
    n: int,
    seed: int,
    duration: int,
    tenants: int,
    pool: int,
    migrate: bool,
):  # noqa: C901 — one seeded traffic arm, linear
    """One arm of the migration A/B: identical seeded traffic (the
    hot tenant surged until its rank runs just past saturation, so
    the tail concentrates on its wire lane), with or without the
    mid-run blame offer. Returns ``(frontend, blame_audit,
    hot_tenant)``. The controller carries no spares and an
    unreachable cold sustain: this cell isolates MIGRATION — a
    capacity change mid-A/B would let the two arms' admission
    decisions diverge for reasons unrelated to the cutover."""
    from smi_tpu_torch.serving.elasticity import ElasticityController

    names = _distinct_home_tenants(n, tenants)
    remap = {f"t{j}": names[j] for j in range(tenants)}
    hot = names[0]
    ctrl = ElasticityController(spares=0, sustain_in=10 * duration)
    fe = ServingFrontend(n, seed=seed, pool=pool, elasticity=ctrl,
                         recorder=campaign_recorder(duration, n))
    mean_chunks = (
        sum(CLASS_MIX[c] * CLASS_CHUNKS[c] for c in QOS_CLASSES)
        / sum(CLASS_MIX.values())
    )
    capacity = n * fe.consume_rate
    requests_per_tick = 0.35 * capacity / mean_chunks
    schedule = open_loop_traffic(seed, tenants, duration,
                                 requests_per_tick)
    # the hot tenant's rank is driven to a FIXED utilization target,
    # independent of pod size: just past saturation, so the wire
    # queue on its lane builds and the tail verdict convicts
    # ``wire:rank<src>`` at any n. (Sizing the surge as a share of
    # the open-loop rate under-loads big pods — at n=8 the hot rank
    # sat below its consume rate and the verdict degraded to
    # ``consume.wait``, which migration rightly ignores.)
    base_chunks = requests_per_tick * mean_chunks / tenants
    hot_target = 1.15 * fe.consume_rate
    extra_rate = (
        max(0.0, hot_target - base_chunks) / CLASS_CHUNKS["batch"]
    )
    tenant_seq: Dict[str, int] = {}
    acc = 0.0
    blame = {"verdict": None, "offered": False, "error": None}
    migrate_at = duration // 2
    for tick, burst in enumerate(schedule):
        for tenant, qos in burst:
            tenant = remap[tenant]
            seq = tenant_seq.get(tenant, 0)
            tenant_seq[tenant] = seq + 1
            chunks = tuple(
                _payload(tenant, seq, c)
                for c in range(CLASS_CHUNKS[qos])
            )
            try:
                fe.submit(tenant, qos, chunks)
            except AdmissionRejected:
                pass
        acc += extra_rate
        while acc >= 1.0:
            acc -= 1.0
            seq = tenant_seq.get(hot, 0)
            tenant_seq[hot] = seq + 1
            chunks = tuple(
                _payload(hot, seq, c)
                for c in range(CLASS_CHUNKS["batch"])
            )
            try:
                fe.submit(hot, "batch", chunks)
            except AdmissionRejected:
                pass
        fe.step()
        # offer at the first post-midpoint tick where the hot tenant
        # actually has in-flight streams — an empty handoff shard
        # would prove nothing about the cutover
        if (migrate and tick >= migrate_at
                and ctrl.migrations_requested == 0
                and any(st.request.tenant == hot
                        for st in fe.active)):
            blame = _offer_live_blame(fe, ctrl, hot)
    fe.drain()
    return fe, blame, hot


def run_migration_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 200,
    tenants: Optional[int] = None,
    pool: int = DEFAULT_POOL,
    return_frontend: bool = False,
):
    """The zero-loss live-migration cell: the tentpole's bit-identity
    gate, run as an A/B against its own no-migration control.

    Both arms run IDENTICAL seeded traffic with the hot tenant
    surged past its rank's consume rate (so the tail-latency blame
    verdict convicts its wire rank). The subject arm offers the live
    verdict mid-run — the controller must turn ``wire:rank<src>``
    into a migration that drains, hands off (CRC-framed shard), cuts
    over under a bumped epoch (straggler rejected, counted), and
    commits. Gate: every stream BOTH arms completed — including the
    migrated tenant's — carries bit-identical delivered payloads,
    and the arms overlap on at least half their completions (the
    accepted sets may lawfully diverge after the cutover, because
    moving the tenant changes which lane later arrivals queue on).
    Migration moved the tenant; it changed nothing about what was
    delivered."""
    if duration < MIN_CAMPAIGN_DURATION:
        raise ValueError(
            f"migration cell duration {duration} is below the "
            f"{MIN_CAMPAIGN_DURATION}-tick minimum: the hot tenant "
            f"needs in-flight streams at the mid-run offer for the "
            f"handoff to carry anything"
        )
    if tenants is None:
        # one fewer tenant than ranks: load-aware placement leaves a
        # rank free, so the migration has somewhere to go without
        # overloading a resident
        tenants = n - 1
    if not 2 <= tenants < n:
        raise ValueError(
            f"migration cell needs 2 <= tenants < n (a free "
            f"destination rank), got tenants={tenants} n={n}"
        )
    fe, blame, hot = _run_migration_traffic(
        n, seed, duration, tenants, pool, migrate=True)
    control, _, _ = _run_migration_traffic(
        n, seed, duration, tenants, pool, migrate=False)

    report = fe.report()
    digest = _delivery_digest(fe)
    control_digest = _delivery_digest(control)
    common = sorted(set(digest) & set(control_digest))
    divergent = [k for k in common if digest[k] != control_digest[k]]
    control_report = control.report()
    report.update({
        "seed": seed,
        "duration": duration,
        "hot_tenant": hot,
        "blame_offer": blame,
        "digest_streams": len(digest),
        "control_digest_streams": len(control_digest),
        "digest_common": len(common),
        "digest_divergent": len(divergent),
        "digest_match": not divergent,
        "metrics": fe.metrics.snapshot(),
    })

    # -- gates ----------------------------------------------------------
    problems: List[str] = []
    for name, rep in (("subject", report), ("control", control_report)):
        if rep["silent_corruptions"]:
            problems.append(f"{name}: silent corruption")
        if rep["lost_accepted"]:
            problems.append(
                f"{name}: lost accepted: {rep['lost_accepted']}"
            )
        if rep["stale_epoch_leaks"]:
            problems.append(f"{name}: stale-epoch traffic accepted")
    el = report.get("elasticity", {})
    migs = list(el.get("migrations", ()))
    if not blame["offered"]:
        problems.append(
            f"the live blame verdict ({blame['verdict']!r}) did not "
            f"trigger a migration — the hot tenant's rank was never "
            f"convicted as wire-bound"
        )
    elif len(migs) != 1 or migs[0]["state"] != "committed":
        problems.append(
            f"expected exactly one committed migration, got {migs}"
        )
    else:
        mig = migs[0]
        if not mig["reason"].startswith("blame:wire:rank"):
            problems.append(
                f"migration reason {mig['reason']!r} does not carry "
                f"the wire blame verdict"
            )
        if mig["streams"] < 1:
            problems.append(
                "the migration froze zero in-flight streams — the "
                "handoff shard carried nothing (raise the load)"
            )
    if not report["stale_epoch_rejections"]:
        problems.append(
            "post-migration straggler was never presented/rejected"
        )
    if control_report.get("elasticity", {}).get("migrations"):
        problems.append("the control arm migrated — A/B is broken")
    if divergent:
        problems.append(
            f"{len(divergent)} stream(s) delivered different bits "
            f"than the no-migration control (first: {divergent[0]}) "
            f"— migration changed the delivered payloads"
        )
    if len(common) < min(len(digest), len(control_digest)) // 2:
        problems.append(
            f"the A/B arms' completed sets barely overlap "
            f"({len(common)} common of {len(digest)} vs "
            f"{len(control_digest)}) — the bit-identity diff is "
            f"not comparing like work"
        )
    if not any(k[0] == hot for k in common):
        problems.append(
            f"no completed stream of the migrated tenant {hot!r} is "
            f"in both arms — the cutover's delivery was never "
            f"diffed against the control"
        )
    span_fields(fe, report, problems)
    del report["admission_waits"]
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    if return_frontend:
        return report, fe
    return report


def run_migrate_under_kill_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 200,
    tenants: int = 4,
    pool: int = DEFAULT_POOL,
    stall_at: int = 60,
    migrate_at: int = 70,
    kill_at: int = 90,
    return_frontend: bool = False,
):
    """The migration-abort cell: the source rank DIES mid-drain and
    the migration must abort loudly — never cut over onto state a
    failover already voided.

    The source's consumer is stalled first (so the drain cannot
    finish and the migration is still ``draining`` when the kill
    lands), then the source is killed. Failover confirms the death,
    reroutes and replays the frozen streams through the normal kill
    path, and the migration driver — seeing the source gone — aborts
    with ``membership-change``. Gates: exactly one ABORTED migration
    (named), the kill confirmed, zero lost-accepted (failover's
    replay delivers everything), zero corruption, stragglers
    rejected."""
    from smi_tpu_torch.serving.elasticity import ElasticityController

    if not stall_at < migrate_at < kill_at < duration:
        raise ValueError(
            f"migrate-under-kill needs stall_at < migrate_at < "
            f"kill_at < duration, got {stall_at}/{migrate_at}/"
            f"{kill_at}/{duration}"
        )
    # no spares, unreachable cold sustain: this cell isolates the
    # migration-vs-failover race, not autoscaling
    ctrl = ElasticityController(spares=0, sustain_in=10 * duration)
    fe = ServingFrontend(n, seed=seed, pool=pool, elasticity=ctrl,
                         recorder=campaign_recorder(duration, n))
    mean_chunks = (
        sum(CLASS_MIX[c] * CLASS_CHUNKS[c] for c in QOS_CLASSES)
        / sum(CLASS_MIX.values())
    )
    capacity = n * fe.consume_rate
    requests_per_tick = 0.6 * capacity / mean_chunks
    schedule = open_loop_traffic(seed, tenants, duration,
                                 requests_per_tick)
    hot = "t0"
    tenant_seq: Dict[str, int] = {}
    src = None
    verdict = "ok"
    migration_error = None
    try:
        for tick, burst in enumerate(schedule):
            now = fe.clock.now()
            if tick == stall_at:
                src = fe.placement.base_of(hot)
                if src is None:
                    src = fe._route_new(hot, record=False)
                fe.stall_consumer(src, now + (kill_at - stall_at) * 4)
            if tick == migrate_at:
                others = sorted(
                    r for r in fe.view.members if r != src
                )
                dst = min(others,
                          key=lambda r: (fe._rank_load(r), r))
                try:
                    fe.request_migration(hot, dst, reason="demand")
                except ValueError as e:
                    migration_error = str(e)
            if tick == kill_at:
                fe.kill(src)
            for tenant, qos in burst:
                seq = tenant_seq.get(tenant, 0)
                tenant_seq[tenant] = seq + 1
                chunks = tuple(
                    _payload(tenant, seq, c)
                    for c in range(CLASS_CHUNKS[qos])
                )
                try:
                    fe.submit(tenant, qos, chunks)
                except AdmissionRejected:
                    pass
            fe.step()
        fe.drain()
    except Exception as e:  # a watchdog/assert firing IS the verdict
        verdict = f"{type(e).__name__}: {e}"

    report = fe.report()
    report.update({
        "seed": seed,
        "duration": duration,
        "hot_tenant": hot,
        "src": src,
        "stall_at": stall_at,
        "migrate_at": migrate_at,
        "kill_at": kill_at,
        "migration_error": migration_error,
        "metrics": fe.metrics.snapshot(),
    })

    # -- gates ----------------------------------------------------------
    problems: List[str] = []
    if verdict != "ok":
        problems.append(verdict)
    if migration_error is not None:
        problems.append(
            f"migration request failed: {migration_error}"
        )
    if report["silent_corruptions"]:
        problems.append(
            f"silent corruption: {report['silent_corruptions']} "
            f"stream(s) delivered wrong bits"
        )
    if report["lost_accepted"]:
        problems.append(
            f"lost accepted: {report['lost_accepted']} admitted "
            f"stream(s) never delivered"
        )
    if report["stale_epoch_leaks"]:
        problems.append("stale-epoch traffic accepted")
    migs = list(report.get("elasticity", {}).get("migrations", ()))
    aborted = [m for m in migs if m["state"] == "aborted"]
    if [m["state"] for m in migs] != ["aborted"]:
        problems.append(
            f"expected exactly one aborted migration, got "
            f"{[m['state'] for m in migs]} — a cutover against a "
            f"dead source would resurrect voided state"
        )
    elif aborted[0]["abort_reason"] != "membership-change":
        problems.append(
            f"abort reason {aborted[0]['abort_reason']!r} — the "
            f"membership change was not what aborted it"
        )
    if report["confirmed"] != [src]:
        problems.append(
            f"kill of rank {src} not confirmed "
            f"(confirmed: {report['confirmed']})"
        )
    if not report["stale_epoch_rejections"]:
        problems.append(
            "straggler from dead incarnation was never "
            "presented/rejected"
        )
    span_fields(fe, report, problems)
    del report["admission_waits"]
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    if return_frontend:
        return report, fe
    return report


def autoscale_selftest(seed: int = 0) -> Dict:
    """The ``smi-tpu serve --selftest --autoscale`` smoke: the seeded
    flash-crowd cell at its minimum shape — capacity must follow the
    load out AND back in, loss-free."""
    return run_flash_crowd_cell(n=4, seed=seed,
                                duration=MIN_FLASH_CROWD_DURATION)


# -- the r17 partition-tolerance cells ----------------------------------

#: Minimum ticks a cut must stay open: the quorum lease (phi evidence
#: on the ack round trip, ConfirmedDead at a 2x-heartbeat grace) needs
#: several missed beat periods to lapse before the heal arrives.
MIN_PARTITION_WINDOW = 60


def _partition_victim(n: int, tenants: int):
    """The cell's tenant names plus the cut victim: the first tenant
    whose crc32 home is NOT the control-plane home (the lowest rank —
    cutting the sink itself would cut everyone and prove nothing
    about minority fencing). Returns ``(names, victim_tenant,
    victim_rank)``."""
    from smi_tpu_torch.serving.placement import tenant_base_rank

    names = _distinct_home_tenants(n, tenants)
    for name in names:
        home = tenant_base_rank(name, n)
        if home != 0:
            return names, name, home
    raise RuntimeError(  # pragma: no cover — homes are distinct
        "every distinct-home tenant landed on rank 0"
    )


def _run_partition_traffic(
    n: int,
    seed: int,
    duration: int,
    tenants: int,
    pool: int,
    fenced: bool,
    fault_kind: Optional[str],
    partition_at: int,
    window: int,
    flap_seed: Optional[int] = None,
):
    """One arm of the partition A/B: identical seeded traffic, with or
    without a control-plane cut injected at ``partition_at``. Returns
    ``(frontend, victim_tenant, victim_rank, quorum_rejected)`` —
    the last is the count of submits the caller saw refused LOUDLY
    (:class:`~smi_tpu_torch.parallel.membership.QuorumLostError`), which
    must match the front-end's own census."""
    names, victim_tenant, victim = _partition_victim(n, tenants)
    remap = {f"t{j}": names[j] for j in range(tenants)}
    fe = ServingFrontend(n, seed=seed, pool=pool,
                         quorum_fencing=fenced,
                         recorder=campaign_recorder(duration, n))
    mean_chunks = (
        sum(CLASS_MIX[c] * CLASS_CHUNKS[c] for c in QOS_CLASSES)
        / sum(CLASS_MIX.values())
    )
    capacity = n * fe.consume_rate
    requests_per_tick = 0.35 * capacity / mean_chunks
    schedule = open_loop_traffic(seed, tenants, duration,
                                 requests_per_tick)
    tenant_seq: Dict[str, int] = {}
    quorum_rejected = 0
    for tick, burst in enumerate(schedule):
        if fault_kind is not None and tick == partition_at:
            now = fe.clock.now()
            if fault_kind == "partition":
                fault = F.PartitionFault(
                    minority=frozenset({victim}),
                    from_tick=now, until_tick=now + window,
                )
            elif fault_kind == "asymmetric":
                # the victim's OUTBOUND dies; it still hears the
                # majority — exactly the cut one-way beat evidence
                # cannot see, and the round-trip lease must
                fault = F.AsymmetricLinkFault(
                    src=victim, dst=0,
                    from_tick=now, until_tick=now + window,
                )
            else:
                fault = F.FlappingLink(
                    a=0, b=victim,
                    from_tick=now, until_tick=now + window,
                    seed=seed if flap_seed is None else flap_seed,
                )
            fe.inject_partition(fault)
        for tenant, qos in burst:
            tenant = remap[tenant]
            seq = tenant_seq.get(tenant, 0)
            tenant_seq[tenant] = seq + 1
            chunks = tuple(
                _payload(tenant, seq, c)
                for c in range(CLASS_CHUNKS[qos])
            )
            try:
                fe.submit(tenant, qos, chunks)
            except QuorumLostError:
                quorum_rejected += 1  # the loud minority-park refusal
            except AdmissionRejected:
                pass
        fe.step()
    fe.drain()
    return fe, victim_tenant, victim, quorum_rejected


def run_partition_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 240,
    tenants: Optional[int] = None,
    pool: int = DEFAULT_POOL,
    partition_at: int = 60,
    window: int = 100,
    return_frontend: bool = False,
):
    """The clean partition/heal cell: a symmetric cut isolates one
    rank mid-traffic, run as an A/B against its own no-partition
    control.

    The minority rank's quorum lease lapses (phi evidence on the ack
    round trip), it parks, and every new stream homed there is
    refused LOUDLY (``QuorumLostError``, counted — the caller-visible
    count must match the front-end's census). The majority — a
    quorate side — confirms the unreachable rank and fails its
    tenants over under a fenced epoch bump; at the heal the parked
    rank presents its stale epoch once (rejected, counted) and
    rejoins through the real regrow actuator. Gates: zero
    lost-accepted, zero split-brain incidents, zero corruption,
    membership restored to full strength, and every stream BOTH arms
    completed delivered bit-identical to the control."""
    if duration < MIN_CAMPAIGN_DURATION:
        raise ValueError(
            f"partition cell duration {duration} is below the "
            f"{MIN_CAMPAIGN_DURATION}-tick minimum"
        )
    if window < MIN_PARTITION_WINDOW:
        raise ValueError(
            f"partition window {window} is below the "
            f"{MIN_PARTITION_WINDOW}-tick minimum: the quorum lease "
            f"cannot lapse before the heal"
        )
    if duration - (partition_at + window) < 40:
        raise ValueError(
            f"partition cell needs >= 40 post-heal ticks "
            f"(partition_at={partition_at} + window={window} vs "
            f"duration={duration}) for the rejoin to prove itself"
        )
    if tenants is None:
        tenants = max(2, n - 1)
    fe, victim_tenant, victim, quorum_rejected = (
        _run_partition_traffic(n, seed, duration, tenants, pool,
                               fenced=True, fault_kind="partition",
                               partition_at=partition_at,
                               window=window))
    control, _, _, _ = _run_partition_traffic(
        n, seed, duration, tenants, pool,
        fenced=True, fault_kind=None,
        partition_at=partition_at, window=window)

    report = fe.report()
    control_report = control.report()
    digest = _delivery_digest(fe)
    control_digest = _delivery_digest(control)
    common = sorted(set(digest) & set(control_digest))
    divergent = [k for k in common if digest[k] != control_digest[k]]
    report.update({
        "seed": seed,
        "duration": duration,
        "victim_tenant": victim_tenant,
        "victim_rank": victim,
        "partition_at": partition_at,
        "window": window,
        "quorum_rejected_seen": quorum_rejected,
        "digest_streams": len(digest),
        "control_digest_streams": len(control_digest),
        "digest_common": len(common),
        "digest_divergent": len(divergent),
        "digest_match": not divergent,
        "metrics": fe.metrics.snapshot(),
    })

    # -- gates ----------------------------------------------------------
    problems: List[str] = []
    for name, rep in (("subject", report),
                      ("control", control_report)):
        if rep["silent_corruptions"]:
            problems.append(f"{name}: silent corruption")
        if rep["lost_accepted"]:
            problems.append(
                f"{name}: lost accepted: {rep['lost_accepted']}"
            )
        if rep["stale_epoch_leaks"]:
            problems.append(f"{name}: stale-epoch traffic accepted")
    if "partition" in control_report:
        problems.append("the control arm saw a partition — A/B is "
                        "broken")
    part = report.get("partition")
    if part is None:
        problems.append("the subject arm never injected a partition")
    else:
        if part["split_brain_incidents"]:
            problems.append(
                f"split brain: {part['split_brain_incidents']} "
                f"stream(s) accepted by a rank the majority no "
                f"longer trusts"
            )
        if part["quorum_losses"] < 1:
            problems.append(
                "the minority never detected its quorum loss — the "
                "lease did not lapse inside the cut window"
            )
        if part["quorum_rejections"] < 1:
            problems.append(
                "no new stream was refused during the park — the "
                "fencing gate never engaged"
            )
        if part["quorum_rejections"] != quorum_rejected:
            problems.append(
                f"the front-end counted "
                f"{part['quorum_rejections']} quorum rejection(s) "
                f"but the caller saw {quorum_rejected} "
                f"QuorumLostError(s) — refusals are not loud"
            )
        if part["heal_rejoins"] < 1:
            problems.append(
                "the parked rank never rejoined at the heal"
            )
        if part["parked"]:
            problems.append(
                f"rank(s) {part['parked']} still parked after the "
                f"heal"
            )
    if report["members"] != list(range(n)):
        problems.append(
            f"membership not restored after the heal "
            f"(members: {report['members']})"
        )
    if not report["stale_epoch_rejections"]:
        problems.append(
            "the healed rank's stale epoch was never "
            "presented/rejected"
        )
    if divergent:
        problems.append(
            f"{len(divergent)} stream(s) delivered different bits "
            f"than the no-partition control (first: {divergent[0]})"
        )
    if len(common) < min(len(digest), len(control_digest)) // 2:
        problems.append(
            f"the A/B arms' completed sets barely overlap "
            f"({len(common)} common of {len(digest)} vs "
            f"{len(control_digest)})"
        )
    if not any(k[0] == victim_tenant for k in common):
        problems.append(
            f"no completed stream of the victim tenant "
            f"{victim_tenant!r} is in both arms — the cut rank's "
            f"delivery was never diffed against the control"
        )
    waits = report["admission_waits"]
    report["admission_latency"] = {
        c: {
            "p50": percentile(waits[c], 0.50),
            "p99": percentile(waits[c], 0.99),
        }
        for c in QOS_CLASSES
    }
    span_fields(fe, report, problems)
    del report["admission_waits"]
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    if return_frontend:
        return report, fe
    return report


def run_partition_migration_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 240,
    tenants: int = 4,
    pool: int = DEFAULT_POOL,
    stall_at: int = 50,
    migrate_at: int = 60,
    partition_at: int = 70,
    window: int = 120,
    return_frontend: bool = False,
):
    """The asymmetric-partition-during-migration cell: the migration
    source's OUTBOUND link dies mid-drain (it still hears the
    majority — the one-way cut only round-trip lease evidence can
    see) and the migration must abort loudly, loss-free.

    The source's consumer is stalled first so the drain cannot finish
    before the cut's phi evidence lands (deadline checking is off for
    the same reason: the stall must outlive the confirm grace, and
    the watchdog's own conduct is the backpressure cell's gate, not
    this one's). The majority — quorate — confirms the silent source,
    fails its tenants over through the normal replay path, and the
    migration driver aborts with a NAMED reason. Gates: exactly one
    aborted migration (``membership-change`` or ``quorum-lost``),
    zero lost-accepted, zero split-brain, stragglers rejected, and
    the source rejoined at the heal."""
    from smi_tpu_torch.serving.elasticity import ElasticityController

    if not stall_at < migrate_at < partition_at < duration:
        raise ValueError(
            f"partition-migration cell needs stall_at < migrate_at "
            f"< partition_at < duration, got {stall_at}/{migrate_at}"
            f"/{partition_at}/{duration}"
        )
    if window < MIN_PARTITION_WINDOW:
        raise ValueError(
            f"partition window {window} is below the "
            f"{MIN_PARTITION_WINDOW}-tick minimum"
        )
    names, hot, src = _partition_victim(n, tenants)
    remap = {f"t{j}": names[j] for j in range(tenants)}
    ctrl = ElasticityController(spares=0, sustain_in=10 * duration)
    fe = ServingFrontend(n, seed=seed, pool=pool, elasticity=ctrl,
                         check_deadlines=False,
                         recorder=campaign_recorder(duration, n))
    mean_chunks = (
        sum(CLASS_MIX[c] * CLASS_CHUNKS[c] for c in QOS_CLASSES)
        / sum(CLASS_MIX.values())
    )
    capacity = n * fe.consume_rate
    requests_per_tick = 0.6 * capacity / mean_chunks
    schedule = open_loop_traffic(seed, tenants, duration,
                                 requests_per_tick)
    tenant_seq: Dict[str, int] = {}
    migration_error = None
    verdict = "ok"
    try:
        for tick, burst in enumerate(schedule):
            now = fe.clock.now()
            if tick == stall_at:
                # freeze the source FIRST, then pin a few hot streams
                # on it: the drain must still be open when the cut's
                # phi evidence lands, even on seeds where the
                # open-loop schedule left the hot tenant idle
                fe.stall_consumer(src, now + window + 60)
                for _ in range(3):
                    seq = tenant_seq.get(hot, 0)
                    tenant_seq[hot] = seq + 1
                    chunks = tuple(
                        _payload(hot, seq, c)
                        for c in range(CLASS_CHUNKS["batch"])
                    )
                    try:
                        fe.submit(hot, "batch", chunks)
                    except AdmissionRejected:
                        pass
            if tick == migrate_at:
                others = sorted(
                    r for r in fe.view.members if r != src
                )
                dst = min(others,
                          key=lambda r: (fe._rank_load(r), r))
                try:
                    fe.request_migration(hot, dst, reason="demand")
                except ValueError as e:
                    migration_error = str(e)
            if tick == partition_at:
                fe.inject_partition(F.AsymmetricLinkFault(
                    src=src, dst=0,
                    from_tick=now, until_tick=now + window,
                ))
            for tenant, qos in burst:
                tenant = remap[tenant]
                seq = tenant_seq.get(tenant, 0)
                tenant_seq[tenant] = seq + 1
                chunks = tuple(
                    _payload(tenant, seq, c)
                    for c in range(CLASS_CHUNKS[qos])
                )
                try:
                    fe.submit(tenant, qos, chunks)
                except (AdmissionRejected, QuorumLostError):
                    pass
            fe.step()
        fe.drain()
    except Exception as e:  # a watchdog/assert firing IS the verdict
        verdict = f"{type(e).__name__}: {e}"

    report = fe.report()
    report.update({
        "seed": seed,
        "duration": duration,
        "hot_tenant": hot,
        "src": src,
        "stall_at": stall_at,
        "migrate_at": migrate_at,
        "partition_at": partition_at,
        "window": window,
        "migration_error": migration_error,
        "metrics": fe.metrics.snapshot(),
    })

    # -- gates ----------------------------------------------------------
    problems: List[str] = []
    if verdict != "ok":
        problems.append(verdict)
    if migration_error is not None:
        problems.append(
            f"migration request failed: {migration_error}"
        )
    if report["silent_corruptions"]:
        problems.append("silent corruption")
    if report["lost_accepted"]:
        problems.append(
            f"lost accepted: {report['lost_accepted']}"
        )
    if report["stale_epoch_leaks"]:
        problems.append("stale-epoch traffic accepted")
    migs = list(report.get("elasticity", {}).get("migrations", ()))
    aborted = [m for m in migs if m["state"] == "aborted"]
    if [m["state"] for m in migs] != ["aborted"]:
        problems.append(
            f"expected exactly one aborted migration, got "
            f"{[m['state'] for m in migs]} — cutting over across a "
            f"partition would resurrect state the failover voided"
        )
    elif aborted[0]["abort_reason"] not in ("membership-change",
                                            "quorum-lost"):
        problems.append(
            f"abort reason {aborted[0]['abort_reason']!r} — neither "
            f"the membership change nor the quorum loss is what "
            f"aborted it"
        )
    part = report.get("partition")
    if part is None:
        problems.append("the asymmetric cut was never injected")
    else:
        if part["split_brain_incidents"]:
            problems.append(
                f"split brain: {part['split_brain_incidents']}"
            )
        if part["heal_rejoins"] < 1:
            problems.append(
                "the cut source never rejoined at the heal"
            )
        if part["parked"]:
            problems.append(
                f"rank(s) {part['parked']} still parked after the "
                f"heal"
            )
    if report["confirmed"] != [src]:
        problems.append(
            f"the silent source {src} was not confirmed "
            f"(confirmed: {report['confirmed']})"
        )
    if report["members"] != list(range(n)):
        problems.append(
            f"membership not restored after the heal "
            f"(members: {report['members']})"
        )
    if not report["stale_epoch_rejections"]:
        problems.append(
            "straggler from the cut incarnation was never "
            "presented/rejected"
        )
    waits = report["admission_waits"]
    report["admission_latency"] = {
        c: {
            "p50": percentile(waits[c], 0.50),
            "p99": percentile(waits[c], 0.99),
        }
        for c in QOS_CLASSES
    }
    span_fields(fe, report, problems)
    del report["admission_waits"]
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    if return_frontend:
        return report, fe
    return report


#: How many seeded flap vectors the soak may try before declaring the
#: hysteresis broken. The duty cycle's per-window offsets are random:
#: an unlucky vector can blank enough CONSECUTIVE beats that the
#: silence exceeds the lease's confirm grace — and that vector IS a
#: cut (parking on it is the contract), while a too-lucky vector
#: never blocks a beat at all and exercises nothing. The soak's claim
#: is about vectors BETWEEN those: silences long enough to suspect,
#: short enough that the lease must absorb them.
FLAP_VECTOR_ATTEMPTS = 5


def run_flapping_link_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 240,
    tenants: Optional[int] = None,
    pool: int = DEFAULT_POOL,
    flap_at: int = 60,
    window: int = 120,
    return_frontend: bool = False,
):
    """The flapping-link soak: one control link duty-cycles up/down
    for ``window`` ticks and the membership must NOT oscillate.

    A flap whose silences stay under the lease's confirm grace must
    ride suspect/clear cycles WITHOUT ever confirming a death: zero
    confirms, zero parks, zero epoch changes, zero refused streams,
    zero loss. Because the fault's per-window offsets are seeded
    random, the cell searches up to :data:`FLAP_VECTOR_ATTEMPTS`
    vectors for one inside the hysteresis margin — a vector that
    blanks 3+ consecutive beats is indistinguishable from a cut
    (the lease LAPSING there is correct, and the partition cell
    owns that flow), and one that never blocks a beat proves
    nothing. Discarded vectors are reported; loss/corruption/
    split-brain are hard gates on EVERY vector, kept or not. If
    every vector parks, the grace is not absorbing sub-confirm
    silences — that is the failure this cell exists to catch."""
    if duration < MIN_CAMPAIGN_DURATION:
        raise ValueError(
            f"flapping cell duration {duration} is below the "
            f"{MIN_CAMPAIGN_DURATION}-tick minimum"
        )
    if tenants is None:
        tenants = max(2, n - 1)
    problems: List[str] = []
    discarded: List[Dict] = []
    flap_seed = seed
    for attempt in range(FLAP_VECTOR_ATTEMPTS):
        flap_seed = seed * FLAP_VECTOR_ATTEMPTS + attempt
        fe, victim_tenant, victim, quorum_rejected = (
            _run_partition_traffic(n, seed, duration, tenants, pool,
                                   fenced=True,
                                   fault_kind="flapping",
                                   partition_at=flap_at,
                                   window=window,
                                   flap_seed=flap_seed))
        report = fe.report()
        part = report.get("partition") or {}
        # hard invariants bind EVERY vector, kept or discarded: even
        # a cut-equivalent flap may only park and heal, never lose
        if report["silent_corruptions"]:
            problems.append(f"vector {flap_seed}: silent corruption")
        if report["lost_accepted"]:
            problems.append(
                f"vector {flap_seed}: lost accepted: "
                f"{report['lost_accepted']}"
            )
        if report["stale_epoch_leaks"]:
            problems.append(
                f"vector {flap_seed}: stale-epoch traffic accepted"
            )
        if part.get("split_brain_incidents"):
            problems.append(
                f"vector {flap_seed}: split brain: "
                f"{part['split_brain_incidents']}"
            )
        if problems:
            break  # no vector rescues a safety violation
        if report["confirmed"] or part.get("quorum_losses"):
            discarded.append({
                "flap_seed": flap_seed,
                "why": "cut-equivalent silence: the lease lapsed",
            })
            continue
        if not report["suspected"]:
            discarded.append({
                "flap_seed": flap_seed,
                "why": "no beat blocked: suspicion never tripped",
            })
            continue
        break  # a vector inside the hysteresis margin
    else:
        problems.append(
            f"no seeded flap vector stayed inside the hysteresis "
            f"margin in {FLAP_VECTOR_ATTEMPTS} attempts "
            f"({[d['why'] for d in discarded]}) — if every vector "
            f"parked, the confirm grace is not absorbing "
            f"sub-confirm silences"
        )

    report.update({
        "seed": seed,
        "duration": duration,
        "victim_tenant": victim_tenant,
        "victim_rank": victim,
        "flap_at": flap_at,
        "window": window,
        "flap_seed": flap_seed,
        "discarded_vectors": discarded,
        "metrics": fe.metrics.snapshot(),
    })

    # -- gates on the kept vector ---------------------------------------
    if not problems:
        part = report.get("partition")
        if part is None:
            problems.append("the flap was never injected")
        else:
            if part["parked"]:
                problems.append(
                    f"rank(s) {part['parked']} left parked by a "
                    f"mere flap"
                )
            if part["quorum_rejections"] or quorum_rejected:
                problems.append(
                    f"{part['quorum_rejections']} stream(s) were "
                    f"refused under a mere flap"
                )
            if not part["healed"]:
                problems.append("the flap window never closed")
        if report["epoch"] != 0:
            problems.append(
                f"the epoch moved to {report['epoch']} under a "
                f"mere flap — an actuator fired"
            )
        if len(report["cleared"]) != len(report["suspected"]):
            problems.append(
                f"{len(report['suspected'])} suspicion(s) but only "
                f"{len(report['cleared'])} cleared — a flap left a "
                f"suspicion standing"
            )
    waits = report["admission_waits"]
    report["admission_latency"] = {
        c: {
            "p50": percentile(waits[c], 0.50),
            "p99": percentile(waits[c], 0.99),
        }
        for c in QOS_CLASSES
    }
    span_fields(fe, report, problems)
    del report["admission_waits"]
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    if return_frontend:
        return report, fe
    return report


#: The partition campaign's menu, keyed the way cell reports name
#: themselves; ``only=`` narrows the campaign to one entry.
PARTITION_CELLS = (
    ("partition-heal", run_partition_cell),
    ("partition-migration-abort", run_partition_migration_cell),
    ("flapping-link", run_flapping_link_cell),
)


def partition_campaign(
    seed: int = 0,
    n: int = 4,
    duration: int = 240,
    trials: int = 1,
    only: Optional[str] = None,
) -> Dict:
    """The seeded partition-tolerance campaign: one clean
    partition/heal A/B, one asymmetric-cut-during-migration abort,
    and one flapping-link soak per trial (``only=`` narrows to a
    single named cell). Exit gate: every cell ``ok``."""
    if duration < MIN_CAMPAIGN_DURATION:
        raise ValueError(
            f"campaign duration {duration} is below the "
            f"{MIN_CAMPAIGN_DURATION}-tick minimum"
        )
    menu = PARTITION_CELLS
    if only is not None:
        menu = tuple((nm, fn) for nm, fn in menu if nm == only)
        if not menu:
            raise ValueError(
                f"unknown partition cell {only!r}; known: "
                f"{[nm for nm, _ in PARTITION_CELLS]}"
            )
    cells: List[Dict] = []
    for trial in range(trials):
        base = random.Random(
            f"partition:{seed}:{trial}").randrange(1 << 30)
        for name, runner in menu:
            report = runner(n=n, seed=base,
                            duration=max(duration, 240))
            report["cell"] = name
            report["trial"] = trial
            cells.append(report)
    failures = [c for c in cells if not c["ok"]]
    return {
        "seed": seed,
        "n": n,
        "duration": duration,
        "trials": trials,
        "cells": len(cells),
        "outcomes": {
            c["cell"]: ("ok" if c["ok"] else "failed") for c in cells
        },
        "failures": [
            {"cell": c["cell"], "trial": c["trial"],
             "verdict": c["verdict"]}
            for c in failures
        ],
        "silent_corruptions": sum(
            c["silent_corruptions"] for c in cells
        ),
        "lost_accepted": sum(c["lost_accepted"] for c in cells),
        "stale_epoch_leaks": sum(
            c["stale_epoch_leaks"] for c in cells
        ),
        "split_brain_incidents": sum(
            c.get("partition", {}).get("split_brain_incidents", 0)
            for c in cells
        ),
        "reports": cells,
        "ok": not failures,
    }


def partition_selftest(seed: int = 0) -> Dict:
    """The ``smi-tpu serve --selftest --partition`` smoke: the clean
    partition/heal cell at its default shape — park, fence, fail
    over, heal, rejoin, bit-identical to the no-partition control."""
    return run_partition_cell(n=4, seed=seed, duration=240)


#: Model-checker property -> the campaign gate it instantiates. The
#: model tier (:mod:`smi_tpu_torch.analysis.model`) checks these same gates
#: exhaustively at small scope; a counterexample trace replayed here
#: must fail with the matching campaign verdict — differential
#: soundness in both directions (tests/test_serving.py pins it).
MODEL_GATES = {
    "queue-bound": "queue occupancy exceeded bound",
    "stream-credit": "stream-credit conservation violated",
    "starvation": "ready stream starved past the aging bound",
    "epoch-safety": "stale-epoch traffic accepted",
    "lost-accepted": "lost accepted",
    "plan-epoch-safety": "stale-plan traffic accepted",
    "swap-lost-accepted": "plan swap lost the active plan",
    "migration-lost-accepted": "migration lost delivered state",
    "placement-epoch-safety": "capacity change stranded residents",
    "no-split-brain": "two primaries for one tenant",
    "fenced-actuation": "actuation fired without a quorum",
    "kv-shard-safety": "KV shards stranded off the serving route",
    "generation-lost-accepted": "KV handoff rolled back accepted tokens",
}


def replay_model_trace(scope, trace, mutant: Optional[str] = None) -> Dict:
    """Re-execute a model-checker counterexample as a campaign cell.

    ``scope`` is an :class:`~smi_tpu_torch.analysis.model.Scope`, a scope
    dict (the JSON report's ``scope`` field), or a ``--scope`` spec
    string; ``trace`` the finding's action list (tuples or the JSON
    report's lists); ``mutant`` the control-plane mutant the trace was
    found under (None replays against the clean world). The trace is
    driven through a fresh :class:`~smi_tpu_torch.analysis.model.World` —
    the same real gate/scheduler/membership/WAL objects — and the
    cell's gates are evaluated on the resulting state. A
    counterexample must come back ``ok=False`` with the matching
    :data:`MODEL_GATES` verdict; any trace of a clean world must come
    back ``ok=True``.
    """
    from smi_tpu_torch.analysis import model as M
    from smi_tpu_torch.analysis import model_mutant_world
    from smi_tpu_torch.analysis.properties import check_state, check_terminal

    if isinstance(scope, str):
        scope = M.parse_scope(scope)
    elif isinstance(scope, dict):
        scope = M.Scope(**scope)
    factory = M.World if mutant is None else model_mutant_world(mutant)
    world = factory(scope)
    for action in trace:
        action = tuple(action)
        enabled = world.enabled_actions()
        if action not in enabled:
            raise ValueError(
                f"trace step {action!r} is not enabled in the replayed "
                f"state (enabled: {enabled}) — the trace does not "
                f"belong to this scope/mutant"
            )
        world.apply(action)
    violations = check_state(world)
    if not violations and not world.enabled_actions():
        violations = check_terminal(world)
    report = world.report()
    problems = [
        f"{MODEL_GATES[prop]}: {message}"
        for prop, message in violations
    ]
    report.update({
        "cell": "model-replay",
        "mutant": mutant,
        "trace_steps": len(list(trace)),
        "verdict": "; ".join(problems) if problems else "ok",
        "ok": not problems,
    })
    return report


def serve_selftest(seed: int = 0, return_frontend: bool = False):
    """The ``smi-tpu serve --selftest`` smoke: a deterministic CPU
    admit -> stream -> shed -> drain pass (overload cell at a fast
    shape) whose gates must all hold. Returns the cell report
    (``ok=False`` on any gate failure); ``return_frontend=True``
    returns ``(report, frontend)`` — the ONE selftest shape, shared
    with ``trace --serve`` so the exported trace can never drift from
    the run the selftest gates."""
    return run_load_cell(
        n=4, seed=seed, duration=160, overload=2.0,
        return_frontend=return_frontend,
    )


def bench_fields(seed: int = 0) -> Dict:
    """The additive ``serving`` field for ``bench.py``: a small
    deterministic front-end smoke (pure Python, milliseconds) whose
    offered load, per-class accept/shed counts, and admission-latency
    percentiles ride next to the headline number — the serving regime
    the build would sustain, measured, not asserted."""
    rep = run_load_cell(n=4, seed=seed, duration=120, overload=2.0)
    return {
        "offered_chunks_per_tick": rep["offered_chunks_per_tick"],
        "capacity_chunks_per_tick": rep["capacity_chunks_per_tick"],
        "accepted": rep["accepted"],
        "shed": {c: sum(rep["shed"][c].values())
                 for c in QOS_CLASSES},
        "admission_latency": rep["admission_latency"],
        "ok": rep["ok"],
    }


# -- streaming inference (r20) -------------------------------------------

#: Minimum inference cell duration: the kill/saturation windows below
#: must land while generations are resident, with room for the
#: failover/handoff arc and the delivery drain.
MIN_INFER_DURATION = 80

#: Generation length the chaos cells pin: long enough that the seeded
#: fault always lands mid-generation (the zero-loss window under
#: test), short enough that the cell drains in bounded ticks.
INFER_GEN_LEN = 24


def _run_infer_cell(
    n: int,
    seed: int,
    duration: int,
    tenants: int,
    gen_len: int,
    pool: int,
    hook=None,
    elasticity=None,
    decode_ranks=None,
    arrivals_per_tick: float = 0.12,
):
    """The shared inference-cell chassis: ONE front-end + ONE engine,
    open-loop request arrivals (deterministic per seed), an optional
    per-tick chaos hook, engine drain, and the cell report. Every
    inference cell — including each fault cell's no-fault CONTROL arm
    — runs through this exact loop, so an A/B digest comparison can
    only differ where the fault made it differ."""
    from smi_tpu_torch.serving.inference import InferenceEngine

    fe = ServingFrontend(n, seed=seed, pool=pool,
                         check_deadlines=False,
                         elasticity=elasticity,
                         recorder=campaign_recorder(duration, n))
    eng = InferenceEngine(fe, decode_ranks=decode_ranks, seed=seed)
    rng = random.Random(f"infer-cell:{n}:{seed}")
    verdict = "ok"
    acc = 0.0
    try:
        for tick in range(duration):
            if hook is not None:
                hook(tick, fe, eng)
            acc += arrivals_per_tick
            while acc >= 1.0:
                acc -= 1.0
                tenant = f"t{rng.randrange(tenants)}"
                eng.submit(tenant, "interactive", gen_len=gen_len)
            eng.step()
        eng.drain()
    except Exception as e:  # a watchdog/assert firing IS the verdict
        verdict = f"{type(e).__name__}: {e}"
    report = fe.report()
    report["inference"] = eng.report()
    report["seed"] = seed
    report["duration"] = duration
    problems: List[str] = []
    if verdict != "ok":
        problems.append(verdict)
    return fe, eng, report, problems


def _infer_common_gates(report: Dict, problems: List[str]) -> None:
    """The gates every inference cell shares: the front-end's
    zero-corruption/zero-loss invariants plus the engine's
    zero-lost-accepted-TOKENS invariant (the accept-time WAL's
    contract — one rolled-back token anywhere fails the cell)."""
    if report["silent_corruptions"]:
        problems.append("silent corruption")
    if report["lost_accepted"]:
        problems.append(f"lost accepted: {report['lost_accepted']}")
    if report["stale_epoch_leaks"]:
        problems.append("stale-epoch traffic accepted")
    inf = report["inference"]
    if inf["lost_accepted_tokens"]:
        problems.append(
            f"generation lost accepted tokens: "
            f"{inf['lost_accepted_tokens']} — the KV handoff rolled "
            f"back an accepted prefix"
        )
    if inf["states"]["generating"] or inf["states"]["kv-transport"]:
        problems.append(
            f"requests stranded mid-lifecycle after drain: "
            f"{inf['states']}"
        )


def _infer_digest_gate(eng, control_digest: Dict,
                       problems: List[str]) -> int:
    """Bit-identity on the intersection: every request BOTH arms
    completed must have delivered the exact same token tuple. Returns
    the intersection size (a zero intersection is its own failure —
    an identity gate over nothing proves nothing)."""
    digest = eng.generation_digest()
    inter = sorted(set(digest) & set(control_digest))
    if not inter:
        problems.append(
            "empty digest intersection with the no-fault control arm "
            "— the bit-identity gate compared nothing"
        )
    diverged = [k for k in inter if digest[k] != control_digest[k]]
    if diverged:
        problems.append(
            f"generation digest diverged from the no-fault control "
            f"on {len(diverged)} request(s) (first: {diverged[0]}) — "
            f"recovery did not resume bit-identically"
        )
    return len(inter)


def run_infer_smoke_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 160,
    tenants: int = 4,
    gen_len: int = INFER_GEN_LEN,
    pool: int = DEFAULT_POOL,
) -> Dict:
    """The no-fault inference cell: disaggregated prefill/decode under
    open-loop arrivals, every request prefilled, transported,
    generated, and delivered — zero handoffs, zero replays, every
    terminal state ``done`` or a loudly-named shed."""
    if duration < MIN_INFER_DURATION:
        raise ValueError(
            f"inference cell duration {duration} is below the "
            f"{MIN_INFER_DURATION}-tick minimum"
        )
    fe, eng, report, problems = _run_infer_cell(
        n, seed, duration, tenants, gen_len, pool)
    _infer_common_gates(report, problems)
    inf = report["inference"]
    if inf["kv_handoffs_committed"] or inf["kv_handoffs_aborted"]:
        problems.append(
            f"no-fault cell minted handoffs: "
            f"{inf['kv_handoffs_committed']} committed / "
            f"{inf['kv_handoffs_aborted']} aborted"
        )
    if inf["replayed_prefills"]:
        problems.append(
            f"no-fault cell replayed {inf['replayed_prefills']} "
            f"prefill(s)"
        )
    if not inf["states"]["done"]:
        problems.append("no request completed")
    report["cell"] = "infer-smoke"
    span_fields(fe, report, problems)
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    return report


def run_infer_kill_decode_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 200,
    tenants: int = 4,
    gen_len: int = INFER_GEN_LEN,
    pool: int = DEFAULT_POOL,
    kill_at: int = 40,
) -> Dict:
    """Kill a decode rank mid-generation. The STATEFUL path, gated
    hard: delivery bit-identical to the no-fault control arm on the
    intersection, zero lost accepted tokens, zero stale-epoch leaks,
    and EXACTLY ONE committed KV handoff whose failover attribution
    names the dead rank — never a prefill replay (the stateless path
    must not fire for a decode death)."""
    if not 0 < kill_at < duration:
        raise ValueError(
            f"kill_at={kill_at} outside 1..{duration - 1}"
        )
    from smi_tpu_torch.serving.inference import decode_ranks_for

    victim = decode_ranks_for(n)[0]
    _, ctl, _ctl_report, ctl_problems = _run_infer_cell(
        n, seed, duration, tenants, gen_len, pool)

    def hook(tick, fe, eng):
        if tick == kill_at:
            fe.kill(victim)

    fe, eng, report, problems = _run_infer_cell(
        n, seed, duration, tenants, gen_len, pool, hook=hook)
    problems.extend(
        f"control arm: {p}" for p in ctl_problems
    )
    _infer_common_gates(report, problems)
    inter = _infer_digest_gate(eng, ctl.generation_digest(), problems)
    inf = report["inference"]
    committed = [h for h in inf["handoffs"]
                 if h["state"] == "committed"]
    if len(committed) != 1:
        problems.append(
            f"expected exactly one committed KV handoff, got "
            f"{[(h['kind'], h['reason']) for h in committed]}"
        )
    elif committed[0]["kind"] != "failover" or (
            committed[0]["reason"] != f"failover:rank{victim}"):
        problems.append(
            f"the committed handoff does not attribute the dead "
            f"decode rank: kind={committed[0]['kind']!r} "
            f"reason={committed[0]['reason']!r}"
        )
    if inf["replayed_prefills"]:
        problems.append(
            f"a decode death triggered {inf['replayed_prefills']} "
            f"prefill replay(s) — the stateless path fired for the "
            f"stateful failure"
        )
    if report["confirmed"] != [victim]:
        problems.append(
            f"the dead decode rank was not confirmed "
            f"(confirmed: {report['confirmed']})"
        )
    report.update({
        "cell": "infer-kill-decode", "victim": victim,
        "kill_at": kill_at, "digest_intersection": inter,
    })
    span_fields(fe, report, problems)
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    return report


def run_infer_kill_prefill_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 200,
    tenants: int = 4,
    gen_len: int = INFER_GEN_LEN,
    pool: int = DEFAULT_POOL,
    kill_at: int = 40,
    arrivals_per_tick: float = 0.08,
) -> Dict:
    """Kill a prefill rank mid-prompt. The STATELESS path, gated to
    stay stateless: prompts in flight on the dead rank re-prefill
    from the WAL'd request on a survivor (>= 1 replay), ZERO KV
    handoffs are minted (a prefill death moves no residency), and
    delivery stays bit-identical to the no-fault control. Arrivals
    run BELOW the half-prefill-capacity knee: the cell proves the
    replay path, so the post-kill queue spike must never dress the
    stateless failure up as decode backpressure (a blame handoff
    here would be exactly the path confusion the gate forbids)."""
    if not 0 < kill_at < duration:
        raise ValueError(
            f"kill_at={kill_at} outside 1..{duration - 1}"
        )
    _, ctl, _ctl_report, ctl_problems = _run_infer_cell(
        n, seed, duration, tenants, gen_len, pool,
        arrivals_per_tick=arrivals_per_tick)

    state = {"victim": None}

    def hook(tick, fe, eng):
        if tick == kill_at:
            # kill the prefill rank with prompts IN FLIGHT (falling
            # back to the first prefill rank keeps the cell
            # deterministic when no prompt is mid-prefill this tick)
            busy = [r.prefill_rank for r in eng.requests
                    if r.state == "prefill"]
            state["victim"] = (busy[0] if busy
                               else eng.prefill_ranks[0])
            fe.kill(state["victim"])

    fe, eng, report, problems = _run_infer_cell(
        n, seed, duration, tenants, gen_len, pool, hook=hook,
        arrivals_per_tick=arrivals_per_tick)
    problems.extend(
        f"control arm: {p}" for p in ctl_problems
    )
    _infer_common_gates(report, problems)
    inter = _infer_digest_gate(eng, ctl.generation_digest(), problems)
    inf = report["inference"]
    if inf["replayed_prefills"] < 1:
        problems.append(
            "the dead prefill rank's prompts were never replayed"
        )
    # the path-confusion gate, precisely: the DEATH must recover by
    # replay alone — no failover-kind handoff anywhere (only a death
    # can mint one, and the only death here is the prefill rank's),
    # and no handoff of any kind naming or touching the dead rank
    # (a prefill rank holds no residency to move). An unrelated
    # blame handoff between two busy decode ranks is the engine
    # doing its job under load, not a confused recovery.
    victim = state["victim"]
    confused = [
        h for h in inf["handoffs"]
        if h["kind"] == "failover"
        or f"rank{victim}" in h["reason"]
        or victim in (h["src"], h["dst"])
    ]
    if confused:
        problems.append(
            f"a prefill death minted KV handoffs: "
            f"{[(h['kind'], h['reason'], h['state']) for h in confused]}"
            f" — the stateful path fired for the stateless failure"
        )
    if report["confirmed"] != [state["victim"]]:
        problems.append(
            f"the dead prefill rank was not confirmed "
            f"(confirmed: {report['confirmed']})"
        )
    report.update({
        "cell": "infer-kill-prefill", "victim": state["victim"],
        "kill_at": kill_at, "digest_intersection": inter,
    })
    span_fields(fe, report, problems)
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    return report


def run_infer_saturate_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 320,
    tenants: int = 4,
    gen_len: int = 40,
    pool: int = DEFAULT_POOL,
    stall_at: int = 30,
    stall_ticks: int = 60,
    flood_ticks: int = 50,
) -> Dict:
    """Saturate a decode rank (stalled consumer + a noisy co-tenant
    flooding its lane): the named ``backpressure:rank<r>`` blame
    verdict must trigger the KV handoff arc — draining, handoff,
    cutover, committed — moving the resident generations to the
    least-loaded surviving decode rank, with ZERO membership events
    (saturation is not death) and zero lost tokens."""
    from smi_tpu_torch.serving.inference import decode_ranks_for

    sat = decode_ranks_for(n)[0]
    _, ctl, _ctl_report, ctl_problems = _run_infer_cell(
        n, seed, duration, tenants, gen_len, pool)

    def hook(tick, fe, eng):
        now = fe.clock.now()
        if tick == stall_at:
            fe.stall_consumer(sat, now + stall_ticks)
        if stall_at <= tick < stall_at + flood_ticks:
            try:
                fe.submit(
                    "noisy", "batch",
                    tuple(f"noise/{tick}/{c}" for c in range(4)),
                    base_rank=sat,
                )
            except (AdmissionRejected, QuorumLostError):
                pass

    fe, eng, report, problems = _run_infer_cell(
        n, seed, duration, tenants, gen_len, pool, hook=hook)
    problems.extend(
        f"control arm: {p}" for p in ctl_problems
    )
    _infer_common_gates(report, problems)
    inter = _infer_digest_gate(eng, ctl.generation_digest(), problems)
    inf = report["inference"]
    blame = f"backpressure:rank{sat}"
    if not any(b["reason"] == blame for b in inf["blame_triggers"]):
        problems.append(
            f"the saturated decode rank never drew the named "
            f"{blame!r} blame verdict"
        )
    committed = [h for h in inf["handoffs"]
                 if h["state"] == "committed"]
    if not committed:
        problems.append("saturation never committed a KV handoff")
    elif committed[0]["kind"] != "handoff" or (
            committed[0]["reason"] != f"blame:{blame}"):
        problems.append(
            f"the first handoff was not blame-triggered off the "
            f"saturated rank: kind={committed[0]['kind']!r} "
            f"reason={committed[0]['reason']!r}"
        )
    confused = [h for h in committed if h["kind"] != "handoff"
                or not h["reason"].startswith("blame:")]
    if confused:
        problems.append(
            f"non-blame handoff(s) under pure saturation: "
            f"{[(h['kind'], h['reason']) for h in confused]} — "
            f"saturation took the failover path"
        )
    if report["confirmed"]:
        problems.append(
            f"saturation confirmed a death: {report['confirmed']} — "
            f"the handoff must ride the blame verdict, never a "
            f"membership event"
        )
    report.update({
        "cell": "infer-saturate", "saturated": sat,
        "stall_at": stall_at, "digest_intersection": inter,
    })
    span_fields(fe, report, problems)
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    return report


def run_infer_partition_handoff_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 420,
    tenants: int = 4,
    gen_len: int = INFER_GEN_LEN,
    pool: int = DEFAULT_POOL,
    stall_at: int = 30,
    partition_at: int = 90,
    window: int = 120,
    pinned: int = 2,
    pinned_gen_len: int = 180,
    arrivals_per_tick: float = 0.02,
) -> Dict:
    """An asymmetric cut lands on the handoff arc's SOURCE while the
    arc is still draining (its wire held open by the stall): the arc
    must abort LOUDLY — ``membership-change`` or ``quorum-lost``,
    never a cutover across the partition — while the confirm-driven
    failover path moves the resident generations loss-free, the cut
    rank rejoins at the heal, and delivery stays bit-identical to the
    no-fault control. Zero split-brain, zero parked ranks after.

    Load shape matters here: ``pinned`` LONG generations are placed
    on the arc's source (fault arm only — they never enter the A/B
    intersection) so real residents span the confirm, while the
    open-loop background stays far below a single decode rank's
    ceiling — the survivor absorbs the whole pod during the stall
    without drawing its own blame verdict, which would smuggle a
    second, committed handoff into the window the gate must keep
    abort-only."""
    if not stall_at < partition_at < duration:
        raise ValueError(
            f"partition cell needs stall_at < partition_at < "
            f"duration, got {stall_at}/{partition_at}/{duration}"
        )
    if window < MIN_PARTITION_WINDOW:
        raise ValueError(
            f"partition window {window} is below the "
            f"{MIN_PARTITION_WINDOW}-tick minimum"
        )
    from smi_tpu_torch.serving.inference import decode_ranks_for

    sat = decode_ranks_for(n)[0]
    _, ctl, _ctl_report, ctl_problems = _run_infer_cell(
        n, seed, duration, tenants, gen_len, pool,
        arrivals_per_tick=arrivals_per_tick)

    def hook(tick, fe, eng):
        now = fe.clock.now()
        if tick == 1:
            # the residents the failover must move: long generations
            # pinned to the arc's source, still mid-stream when the
            # confirm lands (fault arm only, so the digest gate
            # compares the shared open-loop traffic, not these)
            for _ in range(pinned):
                eng.submit("pin", "interactive",
                           gen_len=pinned_gen_len, decode_rank=sat)
        if tick == stall_at:
            # hold the arc's drain open past the cut: frames parked
            # on the source wire keep the arc in ``draining`` until
            # the confirm aborts it
            fe.stall_consumer(sat, now + window + 90)
        if stall_at <= tick < stall_at + 50:
            try:
                fe.submit(
                    "noisy", "batch",
                    tuple(f"noise/{tick}/{c}" for c in range(4)),
                    base_rank=sat,
                )
            except (AdmissionRejected, QuorumLostError):
                pass
        if tick == partition_at:
            fe.inject_partition(F.AsymmetricLinkFault(
                src=sat, dst=0,
                from_tick=now, until_tick=now + window,
            ))

    fe, eng, report, problems = _run_infer_cell(
        n, seed, duration, tenants, gen_len, pool, hook=hook,
        arrivals_per_tick=arrivals_per_tick)
    problems.extend(
        f"control arm: {p}" for p in ctl_problems
    )
    _infer_common_gates(report, problems)
    inter = _infer_digest_gate(eng, ctl.generation_digest(), problems)
    inf = report["inference"]
    aborted = [h for h in inf["handoffs"]
               if h["kind"] == "handoff" and h["state"] == "aborted"]
    blame_committed = [
        h for h in inf["handoffs"]
        if h["kind"] == "handoff" and h["state"] == "committed"
    ]
    if len(aborted) != 1:
        problems.append(
            f"expected exactly one aborted KV handoff, got "
            f"{[(h['state'], h.get('abort_reason')) for h in inf['handoffs'] if h['kind'] == 'handoff']} "
            f"— cutting over across a partition would resurrect "
            f"state the failover moved"
        )
    elif aborted[0]["abort_reason"] not in ("membership-change",
                                            "quorum-lost"):
        problems.append(
            f"abort reason {aborted[0]['abort_reason']!r} — neither "
            f"the membership change nor the quorum loss aborted it"
        )
    if blame_committed:
        problems.append(
            f"a blame handoff committed across the partition window: "
            f"{[(h['reason']) for h in blame_committed]}"
        )
    failed_over = [h for h in inf["handoffs"]
                   if h["kind"] == "failover"
                   and h["state"] == "committed"]
    if not any(h["reason"] == f"failover:rank{sat}"
               for h in failed_over):
        problems.append(
            f"the cut rank's resident generations were never failed "
            f"over at the confirm (failovers: "
            f"{[(h['reason'], h['state']) for h in failed_over]})"
        )
    part = report.get("partition")
    if part is None:
        problems.append("the asymmetric cut was never injected")
    else:
        if part["split_brain_incidents"]:
            problems.append(
                f"split brain: {part['split_brain_incidents']}"
            )
        if part["heal_rejoins"] < 1:
            problems.append(
                "the cut decode rank never rejoined at the heal"
            )
        if part["parked"]:
            problems.append(
                f"rank(s) {part['parked']} still parked after the "
                f"heal"
            )
    if report["members"] != list(range(n)):
        problems.append(
            f"membership not restored after the heal "
            f"(members: {report['members']})"
        )
    report.update({
        "cell": "infer-partition-handoff", "saturated": sat,
        "partition_at": partition_at, "window": window,
        "digest_intersection": inter,
    })
    span_fields(fe, report, problems)
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    return report


def run_infer_scale_in_cell(
    n: int = 5,
    seed: int = 0,
    duration: int = 200,
    gen_len: int = 160,
    pool: int = DEFAULT_POOL,
) -> Dict:
    """Scale-in during generation: the elasticity controller's cold
    signal wants ranks back, but a decode rank holding RESIDENT KV
    shards must never be the victim (its transport streams all
    completed — the active-stream census is blind to the residency;
    the controller reads the engine's published inventory instead).
    Gate: at least one scale-in actually happens (the discipline is
    exercised, not vacuous) and no scaled-in rank ever held
    residents."""
    from smi_tpu_torch.serving.elasticity import ElasticityController
    from smi_tpu_torch.serving.inference import InferenceEngine

    # min_ranks = n - 1 caps the cold signal at ONE scale-in: the cell
    # proves victim selection, and a second eviction on this little
    # ring would cut decode routes for reasons that have nothing to
    # do with residency
    ctrl = ElasticityController(spares=0, sustain_in=30,
                                min_ranks=n - 1)
    fe = ServingFrontend(n, seed=seed, pool=pool,
                         check_deadlines=False,
                         elasticity=ctrl,
                         recorder=campaign_recorder(duration, n))
    # decode on the two HIGHEST ranks — exactly the ranks the scale-in
    # victim scan prefers — so only the inventory read can save them
    eng = InferenceEngine(fe, decode_ranks=(n - 2, n - 1), seed=seed)
    verdict = "ok"
    resident_scale_ins: List[Tuple[int, int]] = []
    try:
        # one long generation RESIDENT on each decode rank — pinned,
        # because a least-loaded pick can double up on one rank and
        # leave the other a legitimate (empty-inventory) victim
        for tenant, rank in (("t0", n - 2), ("t1", n - 1)):
            eng.submit(tenant, "interactive", gen_len=gen_len,
                       decode_rank=rank)
        for _tick in range(duration):
            eng.step()
            for when, direction, rank in ctrl.scale_events:
                if (direction == "in"
                        and eng.residents.get(rank)
                        and (when, rank) not in resident_scale_ins):
                    resident_scale_ins.append((when, rank))
        eng.drain()
    except Exception as e:
        verdict = f"{type(e).__name__}: {e}"
    report = fe.report()
    report["inference"] = eng.report()
    report["seed"] = seed
    report["duration"] = duration
    problems: List[str] = []
    if verdict != "ok":
        problems.append(verdict)
    _infer_common_gates(report, problems)
    scale_ins = [e for e in ctrl.scale_events if e[1] == "in"]
    if not scale_ins:
        problems.append(
            "the cold signal never scaled in — the victim "
            "discipline was not exercised"
        )
    if resident_scale_ins:
        problems.append(
            f"scale-in took rank(s) holding resident KV shards: "
            f"{resident_scale_ins}"
        )
    victims = {r for _, d, r in ctrl.scale_events if d == "in"}
    if victims & set(eng.decode_ranks):
        problems.append(
            f"scale-in took decode rank(s) {sorted(victims & set(eng.decode_ranks))} "
            f"while their generations were resident"
        )
    if not report["inference"]["states"]["done"]:
        problems.append("no generation completed")
    report.update({
        "cell": "infer-scale-in",
        "scale_ins": [list(e) for e in scale_ins],
    })
    span_fields(fe, report, problems)
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    return report


INFER_CELLS = (
    ("infer-smoke", run_infer_smoke_cell),
    ("infer-kill-decode", run_infer_kill_decode_cell),
    ("infer-kill-prefill", run_infer_kill_prefill_cell),
    ("infer-saturate", run_infer_saturate_cell),
    ("infer-partition-handoff", run_infer_partition_handoff_cell),
    ("infer-scale-in", run_infer_scale_in_cell),
)


def infer_campaign(
    seed: int = 0,
    n: int = 4,
    duration: int = 200,
    trials: int = 1,
    only: Optional[str] = None,
) -> Dict:
    """The seeded streaming-inference campaign: the no-fault smoke,
    both kill cells (decode = stateful handoff, prefill = stateless
    replay), the saturation blame handoff, the partition-during-
    handoff abort, and the scale-in victim discipline, per trial
    (``only=`` narrows to a single named cell). Exit gate: every cell
    ``ok``."""
    if duration < MIN_INFER_DURATION:
        raise ValueError(
            f"campaign duration {duration} is below the "
            f"{MIN_INFER_DURATION}-tick minimum"
        )
    menu = INFER_CELLS
    if only is not None:
        menu = tuple((nm, fn) for nm, fn in menu if nm == only)
        if not menu:
            raise ValueError(
                f"unknown inference cell {only!r}; known: "
                f"{[nm for nm, _ in INFER_CELLS]}"
            )
    cells: List[Dict] = []
    for trial in range(trials):
        base = random.Random(
            f"infer:{seed}:{trial}").randrange(1 << 30)
        for name, runner in menu:
            kwargs = {"n": n, "seed": base}
            if name == "infer-scale-in":
                # the victim scan needs a spare-able pod: one more
                # rank than the smallest disaggregated shape
                kwargs["n"] = max(n + 1, 5)
            elif name == "infer-saturate":
                kwargs["duration"] = max(duration, 320)
            elif name == "infer-partition-handoff":
                kwargs["duration"] = max(duration, 420)
            else:
                kwargs["duration"] = max(duration,
                                         MIN_INFER_DURATION)
            report = runner(**kwargs)
            report["cell"] = name
            report["trial"] = trial
            cells.append(report)
    failures = [c for c in cells if not c["ok"]]
    return {
        "seed": seed,
        "n": n,
        "duration": duration,
        "trials": trials,
        "cells": len(cells),
        "outcomes": {
            c["cell"]: ("ok" if c["ok"] else "failed") for c in cells
        },
        "failures": [
            {"cell": c["cell"], "trial": c["trial"],
             "verdict": c["verdict"]}
            for c in failures
        ],
        "silent_corruptions": sum(
            c["silent_corruptions"] for c in cells
        ),
        "lost_accepted": sum(c["lost_accepted"] for c in cells),
        "lost_accepted_tokens": sum(
            c["inference"]["lost_accepted_tokens"] for c in cells
        ),
        "stale_epoch_leaks": sum(
            c["stale_epoch_leaks"] for c in cells
        ),
        "kv_handoffs_committed": sum(
            c["inference"]["kv_handoffs_committed"] for c in cells
        ),
        "replayed_prefills": sum(
            c["inference"]["replayed_prefills"] for c in cells
        ),
        "reports": cells,
        "ok": not failures,
    }


def infer_selftest(seed: int = 0) -> Dict:
    """The ``smi-tpu serve --selftest --infer`` smoke: the kill-decode
    cell at its default shape — prefill, transport, generate, kill,
    fail over through the KV handoff, deliver bit-identically."""
    return run_infer_kill_decode_cell(n=4, seed=seed, duration=200)


def inference_fields(seed: int = 0) -> Dict:
    """The additive ``inference`` field for ``bench.py``: a small
    deterministic disaggregated-serving smoke whose prefill/decode
    rates, handoff counts, and interactive TTFT p99 ride next to the
    headline number — the streaming-inference regime the build would
    sustain, measured, not asserted."""
    rep = run_infer_smoke_cell(n=4, seed=seed, duration=160)
    inf = rep["inference"]
    ttft = inf["ttft"]
    duration = rep["duration"]
    return {
        "requests": inf["requests"],
        "done": inf["states"]["done"],
        "prefill_chunks_per_tick": round(
            sum(rep["delivered"].values()) / max(duration, 1), 4
        ),
        "tokens_per_tick": round(
            inf["tokens_emitted"] / max(duration, 1), 4
        ),
        "kv_handoffs_committed": inf["kv_handoffs_committed"],
        "kv_handoffs_aborted": inf["kv_handoffs_aborted"],
        "replayed_prefills": inf["replayed_prefills"],
        "lost_accepted_tokens": inf["lost_accepted_tokens"],
        "ttft_p99": percentile(ttft, 0.99),
        "ok": rep["ok"],
    }
