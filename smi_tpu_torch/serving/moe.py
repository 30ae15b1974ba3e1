"""MoE expert dispatch: the all-to-all traffic shape through serving.

The port's copy of :mod:`smi_tpu.serving.moe`, kept in step with it
line for line: the same seed gives the same report.

The first serving workload whose traffic matrix is DATA-DEPENDENT: a
tenant's token batch is routed per token to experts (a seeded router —
the gating network's verdict), the per-expert splits scatter to the
experts' home ranks as ordinary admitted streams, and the batch
gathers back by inverse permutation once every split delivered. The
wire-level executable spec of this shape is the all-to-all protocol
family (``credits.all_to_all_rank`` and friends); this module is its
workload-level consumer, run entirely under the EXISTING serving
machinery — per-tenant token buckets, QoS brownout ceilings,
end-to-end stream credits, per-destination backpressure caps,
phi-accrual failover — none of which is bypassed or special-cased:

- an expert's home rank is ``expert % n`` (``expert_home``); a stream
  reaches it through :meth:`ServingFrontend.submit`'s explicit
  ``base_rank`` (failover to heirs still rides
  ``membership.route_owner`` on top, so a dead expert host replays
  its in-flight splits to the heir like any tenant stream);
- a token routed NOWHERE near capacity is the hot-expert regime: the
  seeded campaign's skew cell gives ONE expert ``hot_factor`` (8x)
  the routing weight, its home rank's backlog cap trips, and the
  admission edge must shed with the named ``backpressure:rank<h>``
  error — never a queue, never a membership transition (the
  exhaustive small-scope counterpart is the model checker's
  ``hot_rank`` scope);
- empty per-expert splits (a batch routing zero tokens to an expert)
  simply submit no stream — the degenerate all-to-all block the
  protocol tests pin.

Gates (the campaign exit is nonzero if any fails): **zero silent
corruption** — every fully-accepted batch reassembles bit-identically
to its submitted tokens under the inverse routing permutation; **zero
lost-accepted** — every admitted split stream is delivered (the
front-end's own invariant, re-asserted here); **lowest-class-first
shedding** — brownout/timeout sheds ordered best_effort >= batch >=
interactive with zero interactive brownout (per-destination
backpressure sheds are class-blind by design and gated separately on
NAMING the hot rank); bounded queue occupancy; and zero false
membership transitions under pure skew (saturation is not death).
Deterministic per seed — ``tests/test_moe.py`` pins the campaign.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

from smi_tpu_torch.serving.admission import DEFAULT_POOL
from smi_tpu_torch.serving.frontend import ServingFrontend
from smi_tpu_torch.serving.qos import QOS_CLASSES, AdmissionRejected, check_qos

#: Tokens per batch per QoS class (interactive batches are small and
#: latency-sensitive; best_effort large and patient) — the MoE analog
#: of campaign.CLASS_CHUNKS.
CLASS_TOKENS = {"interactive": 4, "batch": 8, "best_effort": 12}

#: Traffic mix weights per class (campaign.CLASS_MIX's shape).
CLASS_MIX = {"interactive": 3, "batch": 3, "best_effort": 4}

#: The hot-expert skew the seeded campaign applies: one expert draws
#: this multiple of every other expert's routing weight.
HOT_FACTOR = 8

#: Minimum MoE campaign cell duration (ticks): long enough that a
#: hot-expert cell's backlog provably reaches the admission edge.
MIN_MOE_DURATION = 60


def expert_home(expert: int, n: int) -> int:
    """The rank that serves ``expert`` — deterministic, stable across
    runs; failover rides ``membership.route_owner`` on top."""
    if n < 1:
        raise ValueError(f"need n >= 1 ranks, got {n}")
    if expert < 0:
        raise ValueError(f"expert ids are >= 0, got {expert}")
    return expert % n


def token_payload(tenant: str, batch: int, position: int) -> str:
    """Content-addressed token payload: reassembly is checked against
    exactly this, so wrong routing OR wrong bits both fail the
    bit-identity gate."""
    return f"{tenant}/b{batch}/t{position}"


def route_tokens(
    tenant: str,
    batch: int,
    seed: int,
    n_tokens: int,
    experts: int,
    hot_expert: Optional[int] = None,
    hot_factor: int = HOT_FACTOR,
) -> List[int]:
    """The seeded gating decision: token position -> expert id.

    Deterministic per (tenant, batch, seed) — the data-dependent
    traffic matrix the all-to-all family exists for. ``hot_expert``
    (the skew cell) draws with ``hot_factor`` x every other expert's
    weight; ``None`` is the uniform router.
    """
    if experts < 1:
        raise ValueError(f"need >= 1 experts, got {experts}")
    if hot_expert is not None and not 0 <= hot_expert < experts:
        raise ValueError(
            f"hot_expert={hot_expert} outside 0..{experts - 1}"
        )
    if hot_factor < 1:
        raise ValueError(f"hot_factor must be >= 1, got {hot_factor}")
    rng = random.Random(f"moe:{tenant}:{batch}:{seed}")
    pool = list(range(experts))
    if hot_expert is not None:
        pool += [hot_expert] * (hot_factor - 1)
    return [rng.choice(pool) for _ in range(n_tokens)]


def split_by_expert(assignment: Sequence[int],
                    experts: int) -> Dict[int, List[int]]:
    """Per-expert token POSITIONS, experts with zero tokens omitted —
    the empty split is the absence of a stream, never an empty one
    (a request must carry at least one chunk)."""
    splits: Dict[int, List[int]] = {}
    for pos, e in enumerate(assignment):
        if not 0 <= e < experts:
            raise ValueError(
                f"token {pos} routed to unknown expert {e} "
                f"(experts=0..{experts - 1})"
            )
        splits.setdefault(e, []).append(pos)
    return splits


@dataclasses.dataclass
class MoeBatch:
    """One dispatched token batch's bookkeeping."""

    tenant: str
    qos: str
    batch: int
    tokens: Tuple[str, ...]
    assignment: Tuple[int, ...]
    #: expert -> (stream_id, token positions) for each submitted split
    streams: Dict[int, Tuple[Tuple[str, int], Tuple[int, ...]]]
    #: the shed that aborted the batch: at dispatch (a split refused
    #: on the spot) or DEFERRED (a parked split shed at pump time —
    #: admission-timeout / sustained brownout, wired through the
    #: gate's on_shed hook). None = every split admitted.
    shed: Optional[AdmissionRejected] = None
    #: sibling splits already holding credits when the shed landed
    #: (they still deliver — named in the report, never silently
    #: dropped)
    orphaned: int = 0

    @property
    def accepted(self) -> bool:
        return self.shed is None


class MoeDispatcher:
    """Scatter token batches to experts, gather them back.

    A thin layer over ONE :class:`ServingFrontend`: each non-empty
    per-expert split is an ordinary admitted stream to the expert's
    home rank, so admission, QoS, backpressure, and failover all apply
    unchanged. ``dispatch`` returns the batch bookkeeping; ``gather``
    (after the front-end drains) reassembles the token sequence by
    inverse permutation and verifies bit-identity.
    """

    def __init__(self, frontend: ServingFrontend, experts: int,
                 hot_expert: Optional[int] = None,
                 hot_factor: int = HOT_FACTOR, seed: int = 0):
        if experts < 1:
            raise ValueError(f"need >= 1 experts, got {experts}")
        self.fe = frontend
        self.experts = experts
        self.hot_expert = hot_expert
        self.hot_factor = hot_factor
        self.seed = seed
        self.batches: List[MoeBatch] = []
        self._batch_seq: Dict[str, int] = {}
        #: stream_id -> owning batch, for DEFERRED sheds: a split
        #: parked at submit time can still be shed at pump time
        #: (admission-timeout / sustained brownout) — the gate's
        #: on_shed hook marks the owning batch shed so a loudly-shed
        #: stream can never be misread as silent corruption at gather
        self._stream_to_batch: Dict[Tuple[str, int], MoeBatch] = {}
        prev_on_shed = frontend.gate.on_shed

        def _on_deferred_shed(rejection, request):
            if prev_on_shed is not None:
                prev_on_shed(rejection, request)
            batch = self._stream_to_batch.get(request.stream_id)
            if batch is not None and batch.shed is None:
                batch.shed = rejection
                batch.orphaned = sum(
                    1 for sid, _pos in batch.streams.values()
                    if sid != request.stream_id
                )

        frontend.gate.on_shed = _on_deferred_shed

    def dispatch(self, tenant: str, qos: str, n_tokens: int) -> MoeBatch:
        """Route one batch and submit its per-expert splits.

        A shed on ANY split aborts the batch loudly (recorded on the
        returned :class:`MoeBatch`; splits already admitted are
        counted as ``orphaned`` — they hold credits and WILL deliver,
        the accounting just names them instead of letting a partial
        batch read as accepted).
        """
        check_qos(qos)
        if n_tokens < 1:
            raise ValueError(f"need >= 1 tokens, got {n_tokens}")
        batch_no = self._batch_seq.get(tenant, 0)
        self._batch_seq[tenant] = batch_no + 1
        tokens = tuple(
            token_payload(tenant, batch_no, p) for p in range(n_tokens)
        )
        assignment = tuple(route_tokens(
            tenant, batch_no, self.seed, n_tokens, self.experts,
            hot_expert=self.hot_expert, hot_factor=self.hot_factor,
        ))
        batch = MoeBatch(
            tenant=tenant, qos=qos, batch=batch_no, tokens=tokens,
            assignment=assignment, streams={},
        )
        self.batches.append(batch)
        for expert, positions in sorted(
            split_by_expert(assignment, self.experts).items()
        ):
            chunks = tuple(tokens[p] for p in positions)
            try:
                request = self.fe.submit(
                    tenant, qos, chunks,
                    base_rank=expert_home(expert, self.fe.n),
                )
            except AdmissionRejected as e:
                batch.shed = e
                batch.orphaned = len(batch.streams)
                break
            batch.streams[expert] = (
                request.stream_id, tuple(positions)
            )
            self._stream_to_batch[request.stream_id] = batch
        return batch

    def _delivered_chunks(self) -> Dict[Tuple[str, int], Tuple]:
        """stream_id -> delivered chunk tuple, for completed streams."""
        out = {}
        for st in self.fe.completed:
            out[st.request.stream_id] = tuple(
                st.delivered[i] for i in range(st.total_chunks)
            )
        return out

    def gather(self, batch: MoeBatch) -> Optional[Tuple[str, ...]]:
        """Reassemble one fully-accepted batch after the front-end
        drained: inverse-permute the delivered per-expert splits back
        into token order. Returns the reassembled tuple (compare
        against ``batch.tokens`` for the bit-identity gate), or
        ``None`` for a shed batch (nothing to reassemble)."""
        if not batch.accepted:
            return None
        delivered = self._delivered_chunks()
        out: List[Optional[str]] = [None] * len(batch.tokens)
        for expert, (stream_id, positions) in batch.streams.items():
            chunks = delivered.get(stream_id)
            if chunks is None or len(chunks) != len(positions):
                return tuple("<missing>" for _ in batch.tokens)
            for p, payload in zip(positions, chunks):
                out[p] = payload
        return tuple("<missing>" if t is None else t for t in out)


def run_moe_cell(
    n: int = 4,
    seed: int = 0,
    duration: int = 120,
    experts: int = 4,
    tenants: int = 4,
    hot_expert: Optional[int] = None,
    hot_factor: int = HOT_FACTOR,
    batches_per_tick: float = 0.5,
    pool: int = DEFAULT_POOL,
) -> Dict:
    """One seeded MoE expert-dispatch cell: open-loop batch arrivals,
    scatter/gather through the serving front-end, gates evaluated.
    Deterministic per (shape, seed)."""
    if duration < MIN_MOE_DURATION:
        raise ValueError(
            f"MoE cell duration {duration} is below the "
            f"{MIN_MOE_DURATION}-tick minimum (a hot-expert backlog "
            f"needs the schedule to reach the admission edge)"
        )
    from smi_tpu_torch.serving.campaign import campaign_recorder

    fe = ServingFrontend(n, seed=seed, pool=pool,
                         recorder=campaign_recorder(duration, n))
    dispatcher = MoeDispatcher(
        fe, experts, hot_expert=hot_expert, hot_factor=hot_factor,
        seed=seed,
    )
    rng = random.Random(f"moe-cell:{n}:{seed}")
    classes = [c for c in QOS_CLASSES for _ in range(CLASS_MIX[c])]
    verdict = "ok"
    acc = 0.0
    try:
        for _tick in range(duration):
            acc += batches_per_tick
            while acc >= 1.0:
                acc -= 1.0
                tenant = f"t{rng.randrange(tenants)}"
                qos = rng.choice(classes)
                dispatcher.dispatch(tenant, qos, CLASS_TOKENS[qos])
            fe.step()
        fe.drain()
    except Exception as e:  # a watchdog/assert firing IS the verdict
        verdict = f"{type(e).__name__}: {e}"

    report = fe.report()
    accepted_batches = [b for b in dispatcher.batches if b.accepted]
    shed_batches = [b for b in dispatcher.batches if not b.accepted]
    corrupt = 0
    for b in accepted_batches:
        if dispatcher.gather(b) != b.tokens:
            corrupt += 1
    hot_rank = (expert_home(hot_expert, n)
                if hot_expert is not None else None)
    report.update({
        "cell": "moe-hot-expert" if hot_expert is not None else "moe",
        "seed": seed,
        "duration": duration,
        "experts": experts,
        "hot_expert": hot_expert,
        "hot_rank": hot_rank,
        "hot_factor": hot_factor if hot_expert is not None else 1,
        "batches": len(dispatcher.batches),
        "batches_accepted": len(accepted_batches),
        "batches_shed": len(shed_batches),
        "batch_shed_reasons": sorted(
            {b.shed.reason for b in shed_batches}
        ),
        "orphaned_streams": sum(b.orphaned for b in shed_batches),
        "reassembly_corruptions": corrupt,
    })

    problems: List[str] = []
    if verdict != "ok":
        problems.append(verdict)
    if corrupt:
        problems.append(
            f"silent corruption: {corrupt} batch(es) reassembled "
            f"wrong bits"
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
    report["backpressure_shed"] = {
        c: sum(v for k, v in report["shed"][c].items()
               if k.startswith("backpressure:"))
        for c in QOS_CLASSES
    }
    if brownout["interactive"] > 0:
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
    if hot_expert is not None:
        hot_reason = f"backpressure:rank{hot_rank}"
        all_reasons = {
            k for c in QOS_CLASSES for k in report["shed"][c]
        }
        if hot_reason not in all_reasons:
            problems.append(
                f"hot expert {hot_expert} (rank {hot_rank}) at "
                f"{hot_factor}x skew never tripped the per-route "
                f"backpressure edge (no {hot_reason!r} shed)"
            )
        if report["confirmed"]:
            problems.append(
                f"hot-expert saturation confirmed a death: "
                f"{report['confirmed']} (skew mistaken for failure)"
            )
    # the r15 span layer: expert-dispatch streams get the same span
    # trees, blame verdict, and bit-identity exactness gate as every
    # other serving cell
    from smi_tpu_torch.serving.campaign import span_fields

    span_fields(fe, report, problems)
    report["verdict"] = "; ".join(problems) if problems else "ok"
    report["ok"] = not problems
    return report


def moe_campaign(
    seed: int = 0,
    n: int = 4,
    duration: int = 120,
    experts: int = 4,
    trials: int = 1,
) -> Dict:
    """The seeded MoE campaign: one uniform-routing cell and one
    hot-expert cell (a seeded expert at :data:`HOT_FACTOR` x weight)
    per trial, each deterministic per seed. Exit gate: every cell
    ``ok``."""
    cells: List[Dict] = []
    for trial in range(trials):
        base = random.Random(f"moe:{seed}:{trial}").randrange(1 << 30)
        hot = random.Random(f"moe-hot:{seed}:{trial}").randrange(experts)
        for kwargs in (
            dict(hot_expert=None),
            dict(hot_expert=hot, batches_per_tick=0.75),
        ):
            report = run_moe_cell(
                n=n, seed=base, duration=duration, experts=experts,
                **kwargs,
            )
            report["trial"] = trial
            cells.append(report)
    failures = [c for c in cells if not c["ok"]]
    return {
        "seed": seed,
        "n": n,
        "experts": experts,
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
            c["silent_corruptions"] + c["reassembly_corruptions"]
            for c in cells
        ),
        "lost_accepted": sum(c["lost_accepted"] for c in cells),
        "stale_epoch_leaks": sum(
            c["stale_epoch_leaks"] for c in cells
        ),
        "reports": cells,
        "ok": not failures,
    }
