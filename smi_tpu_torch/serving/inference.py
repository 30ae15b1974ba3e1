"""Disaggregated prefill/decode streaming inference under chaos.

The port's copy of :mod:`smi_tpu.serving.inference`, kept in step
with it line for line, but for :func:`traced_kv_dataflow`, which runs
its decode fold as the port's :func:`allreduce` on a world of ranks.

The streaming-inference flagship: prefill ranks stream CRC+seq-framed
KV shards to decode ranks over the per-destination wire lanes, decode
runs continuous batching under interactive QoS (prefill bursts ride
the ``batch`` class, so token latency never queues behind prompt
processing), and the KV-shard lifecycle is ZERO-LOSS end to end —
every accepted token survives any single failure the campaign throws
at it. Everything runs through ONE :class:`ServingFrontend`: per-
tenant token buckets, QoS brownout ceilings, stream credits, per-
destination backpressure caps, phi-accrual failover — none bypassed.

Two recovery paths, never confused:

- **KV-shard handoff** (stateful): a decode rank that saturates (the
  named ``backpressure:rank<r>`` blame verdict) or dies mid-generation
  hands its resident KV shards to the least-loaded surviving decode
  rank through the house migration arc — draining -> handoff ->
  cutover -> committed/aborted — with checkpoint shards
  (:func:`pack_shard`'s CRC+seq framing) as the transport, the lane
  switch keyed by a fresh membership epoch
  (:meth:`MembershipView.migrate_cutover`), and the cutover gated by a
  quorum fencing token (the r17 discipline: no quorum, no cutover —
  abort loudly, loss-free). Generation resumes bit-identically:
  tokens are derived from the resident KV bits plus the accepted-
  token prefix chain, so a stale or corrupt resume DIVERGES instead
  of silently passing.
- **Stateless re-prefill**: a killed PREFILL rank holds nothing
  durable — its in-progress prompts replay from the WAL'd request
  (the engine's submission log) on a surviving prefill rank. No
  handoff is ever minted for a prefill death; the two paths are
  attributed separately in the audit trail and the campaign gates
  that they stay separate.

Gates (``tests/test_inference.py`` pins the campaign; the model
checker's ``Scope.infer`` tier exhausts the small-scope counterpart):
**zero lost accepted tokens** — a token appended to a generation is
checkpointed synchronously (the accept-time WAL) and survives
failover and handoff; **bit-identity** — the kill-decode cell's
delivered generations match the no-fault control arm on the
intersection of completed requests; **exactly-one attribution** —
a decode death commits exactly one KV handoff naming the dead rank;
**no stale-epoch leaks** — post-cutover stragglers from the old
incarnation are rejected by epoch; **saturation is not death** —
the blame-triggered handoff must not ride a membership transition.
"""

from __future__ import annotations

import dataclasses
import pickle
import random
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from smi_tpu_torch.parallel.checkpoint import pack_shard, unpack_shard
from smi_tpu_torch.parallel.membership import QuorumLostError, StaleEpochError
from smi_tpu_torch.serving.admission import DEFAULT_POOL
from smi_tpu_torch.serving.frontend import ServingFrontend
from smi_tpu_torch.serving.qos import AdmissionRejected

#: Prompt chunks per request per QoS class of the SUBMITTING tenant
#: (the KV-shard count: one shard per prompt chunk). Small on purpose
#: — the campaign sweeps many requests, not long prompts.
PROMPT_CHUNKS = {"interactive": 2, "batch": 4}

#: Ticks of prefill compute per prompt chunk (the prefill rank is
#: busy this long before the KV shards hit the wire).
PREFILL_TICKS_PER_CHUNK = 1

#: Tokens generated per request unless the caller says otherwise.
DEFAULT_GEN_LEN = 4

#: Minimum inference campaign cell duration (ticks): long enough for
#: admission, prefill, KV transport, generation, and delivery to
#: complete for the open-loop arrival schedule.
MIN_INFER_DURATION = 80

#: Named backpressure sheds a decode rank must accumulate — while
#: holding resident generations — before the blame verdict arms the
#: handoff arc. A one-off transient (a delivery burst grazing the
#: backlog cap) is not saturation; a stalled consumer's shed stream
#: is. The saturation campaign cell crosses this within its flood
#: window; the no-fault smoke must never reach it.
SATURATION_SHED_MIN = 6

#: The engine-level request states, in lifecycle order. ``shed`` is
#: terminal-by-admission (loud, counted); ``done`` is the only
#: successful terminal state.
REQUEST_STATES = (
    "prefill", "kv-transport", "generating", "delivering", "done",
    "shed",
)


def kv_payload(tenant: str, req_no: int, chunk: int) -> str:
    """Content-addressed KV-shard payload: the decode side's token
    derivation hashes exactly these bits, so wrong routing, wrong
    bits, or a stale resume all diverge visibly."""
    return f"{tenant}/r{req_no}/kv{chunk}"


def decode_token(kv_payloads: Sequence[str],
                 tokens: Sequence[str]) -> str:
    """The next accepted token: a CRC chain over the RESIDENT KV bits
    and the accepted-token prefix. Deterministic, so a handed-off
    generation resumes bit-identically — and a resume from stale KV
    or a rolled-back prefix produces a DIFFERENT token, turning
    silent state loss into a loud bit-identity failure."""
    h = zlib.crc32("|".join(kv_payloads).encode())
    h = zlib.crc32("|".join(tokens).encode(), h)
    return f"tok{len(tokens)}/{h:08x}"


def decode_ranks_for(n: int) -> Tuple[int, ...]:
    """The default disaggregation split: the upper half of the pod
    decodes, the lower half prefills (at n=2: rank 0 prefills, rank 1
    decodes — the smallest disaggregated shape)."""
    if n < 2:
        raise ValueError(f"disaggregation needs >= 2 ranks, got {n}")
    return tuple(range(n // 2, n))


@dataclasses.dataclass
class InferenceRequest:
    """One streaming-inference request's engine bookkeeping."""

    tenant: str
    req_no: int
    prompt: Tuple[str, ...]          # prompt chunk payloads (WAL'd)
    gen_len: int
    prefill_rank: int
    decode_rank: int
    state: str = "prefill"
    prefill_left: int = 0
    kv_stream_id: Optional[Tuple[str, int]] = None
    token_stream_id: Optional[Tuple[str, int]] = None
    kv_payloads: Tuple[str, ...] = ()
    tokens: List[str] = dataclasses.field(default_factory=list)
    submitted_at: int = 0
    ttft: Optional[int] = None       # first accepted token latency
    shed_reason: Optional[str] = None
    replays: int = 0                 # stateless re-prefills
    pinned: bool = False             # caller-pinned decode placement

    @property
    def key(self) -> Tuple[str, int]:
        return (self.tenant, self.req_no)


class InferenceEngine:
    """Prefill/decode disaggregation over ONE serving front-end.

    Prefill ranks turn prompts into KV shards (``batch``-class streams
    to the decode rank's wire lane); decode ranks generate tokens from
    resident shards (continuous batching: one token per resident
    generation per tick) and deliver finished generations as
    ``interactive`` streams. The engine owns the KV-shard residency
    inventory and the zero-loss handoff arc; the front-end owns
    admission, transport, integrity, and membership — the engine never
    reaches around them.

    Wiring: the engine installs itself as the front-end's
    ``on_failover_reroute`` hook (in-flight KV transport restores at
    the heir from a checkpoint round-trip instead of replaying from
    zero) and publishes its residency inventory as
    ``fe.kv_shard_residents`` (the scale-in victim discipline reads
    it: a rank holding resident shards is never a scale-in victim).
    """

    def __init__(self, frontend: ServingFrontend,
                 decode_ranks: Optional[Sequence[int]] = None,
                 seed: int = 0):
        self.fe = frontend
        n = frontend.n
        picked = (tuple(sorted(decode_ranks))
                  if decode_ranks is not None else decode_ranks_for(n))
        if not picked:
            raise ValueError("need at least one decode rank")
        for r in picked:
            if not 0 <= r < n:
                raise ValueError(
                    f"decode rank {r} outside 0..{n - 1}"
                )
        if len(picked) == n:
            raise ValueError(
                "every rank decodes: disaggregation needs at least "
                "one prefill rank"
            )
        self.decode_ranks = picked
        self.prefill_ranks = tuple(
            r for r in range(n) if r not in picked
        )
        self.rng = random.Random(f"infer:{n}:{seed}")
        self.requests: List[InferenceRequest] = []
        self._req_seq: Dict[str, int] = {}
        self._by_kv_stream: Dict[Tuple[str, int], InferenceRequest] = {}
        self._by_token_stream: Dict[
            Tuple[str, int], InferenceRequest
        ] = {}
        #: rank -> {request key -> resident shard count}: THE KV-shard
        #: inventory. Published to the front-end for the scale-in
        #: victim discipline; every gate about "resident shards" reads
        #: this.
        self.residents: Dict[int, Dict[Tuple[str, int], int]] = {
            r: {} for r in range(n)
        }
        #: request key -> CRC-framed checkpoint blob of (kv_payloads,
        #: accepted tokens) — written synchronously at every token
        #: accept (the accept-time WAL the zero-loss gate rides).
        self.checkpoints: Dict[Tuple[str, int], bytes] = {}
        #: the in-flight saturation handoff arc, or None — one at a
        #: time, driven one state transition per step, mirroring the
        #: front-end's live-migration machine.
        self._arc: Optional[Dict] = None
        #: committed/aborted handoff audit trail: every entry names
        #: kind ("handoff" = blame-triggered, "failover" = decode
        #: death), src, dst, moved request keys, and the reason.
        self.handoffs: List[Dict] = []
        self.kv_handoffs_committed = 0
        self.kv_handoffs_aborted = 0
        #: in-flight KV-transport streams restored at an heir through
        #: the failover hook (checkpoint round-trip, NOT a committed
        #: handoff — attribution stays clean).
        self.transport_restores: List[Dict] = []
        self.replayed_prefills = 0
        self.lost_accepted_tokens = 0
        self.wal_restores = 0
        self.tokens_emitted = 0
        self.blame_triggers: List[Dict] = []
        self._confirm_cursor = 0
        self._shed_seen: Dict[int, int] = {}
        self._blame_growth: Dict[int, int] = {}
        frontend.on_failover_reroute = self._on_failover_reroute
        frontend.kv_shard_residents = self.residents
        # chain the admission gate's deferred-shed hook (the MoE
        # dispatcher's discipline): a stream PARKED at submit can
        # still be shed at pump time (admission-timeout, sustained
        # brownout) — a loudly-shed KV transport must move its
        # request to the terminal ``shed`` state, and a shed token
        # delivery must fall back to ``generating`` for a retry,
        # never hang in ``delivering`` forever
        prev_on_shed = frontend.gate.on_shed

        def _on_deferred_shed(rejection, request):
            if prev_on_shed is not None:
                prev_on_shed(rejection, request)
            req = self._by_kv_stream.pop(request.stream_id, None)
            if req is not None and req.state == "kv-transport":
                req.state = "shed"
                req.shed_reason = rejection.reason
            req = self._by_token_stream.pop(request.stream_id, None)
            if req is not None and req.state == "delivering":
                req.state = "generating"
                req.token_stream_id = None

        frontend.gate.on_shed = _on_deferred_shed

    # -- submission ------------------------------------------------------

    def submit(self, tenant: str, qos: str = "interactive",
               prompt_chunks: Optional[int] = None,
               gen_len: int = DEFAULT_GEN_LEN,
               decode_rank: Optional[int] = None) -> InferenceRequest:
        """Accept one request into the engine's WAL. Prefill starts
        next step; admission control applies when the KV shards hit
        the front-end (prefill output rides the ``batch`` class so
        prompt bursts never brown out interactive tokens)."""
        if qos not in PROMPT_CHUNKS:
            raise ValueError(
                f"inference rides {sorted(PROMPT_CHUNKS)} QoS, "
                f"got {qos!r}"
            )
        if gen_len < 0:
            raise ValueError(f"gen_len must be >= 0, got {gen_len}")
        chunks = (prompt_chunks if prompt_chunks is not None
                  else PROMPT_CHUNKS[qos])
        if chunks < 1:
            raise ValueError(f"need >= 1 prompt chunks, got {chunks}")
        if decode_rank is not None and decode_rank not in self.decode_ranks:
            raise ValueError(
                f"decode_rank {decode_rank} is not a decode rank "
                f"(decode ranks: {self.decode_ranks})"
            )
        req_no = self._req_seq.get(tenant, 0)
        self._req_seq[tenant] = req_no + 1
        prompt = tuple(
            kv_payload(tenant, req_no, c) for c in range(chunks)
        )
        req = InferenceRequest(
            tenant=tenant, req_no=req_no, prompt=prompt,
            gen_len=gen_len,
            prefill_rank=self._pick_prefill(),
            decode_rank=(decode_rank if decode_rank is not None
                         else self._pick_decode()),
            pinned=decode_rank is not None,
            prefill_left=chunks * PREFILL_TICKS_PER_CHUNK,
            submitted_at=self.fe.clock.now(),
        )
        self.requests.append(req)
        return req

    def _live(self, ranks: Sequence[int]) -> List[int]:
        members = self.fe.view.members
        return [r for r in ranks if r in members]

    def _pick_prefill(self) -> int:
        live = self._live(self.prefill_ranks)
        if not live:
            # every prefill rank is down: prefill on the least-loaded
            # decode rank (colocated mode) rather than reject — the
            # campaign never exercises this, but the degenerate shape
            # must not crash
            live = self._live(self.decode_ranks)
        if not live:
            raise RuntimeError("no live rank to prefill on")
        return min(live, key=lambda r: (self.fe._rank_load(r), r))

    def _pick_decode(self, exclude: Tuple[int, ...] = ()) -> int:
        live = [r for r in self._live(self.decode_ranks)
                if r not in exclude]
        if not live:
            live = self._live(self.decode_ranks)
        if not live:
            raise RuntimeError("no live decode rank")
        # a draining handoff source takes no NEW residents
        arc = self._arc
        if arc is not None and len(live) > 1:
            live = [r for r in live if r != arc["src"]] or live
        return min(live, key=lambda r: (self.fe._rank_load(r), r))

    # -- the step loop ---------------------------------------------------

    def step(self) -> None:
        """One engine tick: front-end first (transport, membership,
        admission), then the engine's reactions in dependency order —
        deaths before the arc (a dead arc party must abort it), the
        arc before prefill (a draining source takes no new work),
        transports before generation (a shard landing this tick
        generates this tick)."""
        self.fe.step()
        self._note_confirms()
        self._drive_arc()
        self._pump_prefill()
        self._note_transports()
        self._generate()
        self._note_deliveries()
        self._watch_saturation()

    def drain(self, max_ticks: int = 5000) -> None:
        """Step until every request reaches a terminal state (and the
        front-end itself is drained). The bound is a backstop for an
        engine bug, not a tunable."""
        for _ in range(max_ticks):
            if (all(r.state in ("done", "shed") for r in self.requests)
                    and not self.fe.active
                    and not any(
                        q for q in self.fe.gate.pending.values()
                    )):
                return
            self.step()
        stuck = sorted(
            (r.key, r.state) for r in self.requests
            if r.state not in ("done", "shed")
        )
        raise RuntimeError(
            f"inference drain did not converge in {max_ticks} ticks; "
            f"stuck requests: {stuck}"
        )

    # -- decode death: the stateful failover path ------------------------

    def _note_confirms(self) -> None:
        """React to newly confirmed deaths. A decode death with
        resident shards is the STATEFUL path: restore every resident
        generation at the heir from its accept-time checkpoint and
        commit exactly one failover handoff naming the dead rank. A
        prefill death is the STATELESS path: re-prefill from the
        WAL'd request — no handoff, ever."""
        new = self.fe.confirmed[self._confirm_cursor:]
        self._confirm_cursor = len(self.fe.confirmed)
        for dead in new:
            if self.residents.get(dead):
                self._failover_residents(dead)
            if dead in self.prefill_ranks:
                self._replay_prefills(dead)
            # a generation whose residency already retired (tokens
            # complete, delivery retrying) still routes its delivery
            # at the dead rank: move the route, nothing to restore
            for req in self.requests:
                if (req.state == "generating"
                        and req.decode_rank == dead
                        and not any(req.key in inv
                                    for inv in self.residents.values())):
                    try:
                        req.decode_rank = self._pick_decode(
                            exclude=(dead,)
                        )
                    except RuntimeError:
                        pass

    def _failover_residents(self, dead: int) -> None:
        now = self.fe.clock.now()
        keys = sorted(self.residents[dead])
        try:
            heir = self._pick_decode(exclude=(dead,))
        except RuntimeError:
            # no live decode rank left: the shards are orphaned —
            # loudly, in the audit trail, never silently
            self.handoffs.append({
                "kind": "failover", "src": dead, "dst": None,
                "streams": [list(k) for k in keys],
                "state": "aborted", "abort_reason": "no-heir",
                "reason": f"failover:rank{dead}", "at": now,
            })
            self.kv_handoffs_aborted += 1
            return
        try:
            token = self.fe.mint_quorum_token(
                rank=heir, what=f"kv failover {dead}->{heir}",
            )
        except QuorumLostError:
            # the r17 discipline: no quorum, no failover actuation.
            # Abort loudly; the shards stay attributed to the dead
            # rank and the next confirm (post-heal) retries.
            self.handoffs.append({
                "kind": "failover", "src": dead, "dst": heir,
                "streams": [list(k) for k in keys],
                "state": "aborted", "abort_reason": "quorum-lost",
                "reason": f"failover:rank{dead}", "at": now,
            })
            self.kv_handoffs_aborted += 1
            return
        del token  # actuation fenced; the mint is the gate
        moved = []
        for key in keys:
            req = next(
                r for r in self.requests if r.key == key
            )
            shards = self.residents[dead].pop(key)
            if req.state != "generating":
                continue  # transported-not-yet-generating: rebuilt below
            blob = self.checkpoints[key]
            _rank, _step, payload, _crc = unpack_shard(
                blob, origin=f"kv-failover:{key[0]}/r{key[1]}",
            )
            kv, tokens = pickle.loads(payload)
            if len(tokens) < len(req.tokens):
                # the forbidden outcome: the synchronous accept-time
                # checkpoint is BEHIND the accepted prefix
                self.lost_accepted_tokens += (
                    len(req.tokens) - len(tokens)
                )
            req.kv_payloads = tuple(kv)
            req.tokens = list(tokens)
            req.decode_rank = heir
            self.residents[heir][key] = shards
            self.wal_restores += 1
            moved.append(key)
        self.handoffs.append({
            "kind": "failover", "src": dead, "dst": heir,
            "streams": [list(k) for k in moved],
            "state": "committed",
            "reason": f"failover:rank{dead}", "at": now,
        })
        self.kv_handoffs_committed += 1

    def _replay_prefills(self, dead: int) -> None:
        """Stateless re-prefill: prompts in flight on a dead prefill
        rank restart from the WAL'd request on a survivor. KV shards
        already on the wire are the front-end's problem (its WAL
        replays them); shards already resident need nothing."""
        for req in self.requests:
            if req.state != "prefill" or req.prefill_rank != dead:
                continue
            req.prefill_rank = self._pick_prefill()
            req.prefill_left = (
                len(req.prompt) * PREFILL_TICKS_PER_CHUNK
            )
            req.replays += 1
            self.replayed_prefills += 1

    # -- the in-flight KV transport hook ---------------------------------

    def _on_failover_reroute(self, st, dead: int, owner: int) -> bool:
        """The front-end's failover asks: can the engine restore this
        stream's progress at an heir from its own durable state?
        True only for KV-TRANSPORT streams (delivered shards round-
        trip through a CRC-framed checkpoint to the engine's chosen
        decode heir — progress survives, nothing replays from zero).
        Token-delivery streams return False: their chunks live in the
        request WAL, and the stateless void-and-replay path is
        exactly right for them."""
        req = self._by_kv_stream.get(st.request.stream_id)
        if req is None or req.state != "kv-transport":
            return False
        try:
            heir = self._pick_decode(exclude=(dead,))
        except RuntimeError:
            return False
        try:
            token = self.fe.mint_quorum_token(
                rank=heir, what=f"kv transport restore -> {heir}",
            )
        except QuorumLostError:
            # no quorum: fall back to the loud, loss-free stateless
            # replay rather than actuate unfenced
            return False
        del token
        # the delivered prefix survives the death because it round-
        # trips the same CRC+seq framing the handoff arc uses — a
        # corrupt restore raises, never silently resumes
        payload = pickle.dumps(
            (dict(sorted(st.delivered.items())), st.next_to_send)
        )
        blob, _crc = pack_shard(dead, self.fe.view.epoch, payload)
        _rank, _step, back, _crc2 = unpack_shard(
            blob, origin=f"kv-transport:{req.tenant}/r{req.req_no}",
        )
        delivered, next_to_send = pickle.loads(back)
        st.delivered = dict(delivered)
        st.next_to_send = next_to_send
        st.dst = heir
        st.lane_epoch = self.fe.view.epoch
        self.fe.lanes[heir].next_seq[
            (st.index, st.lane_epoch)
        ] = next_to_send
        req.decode_rank = heir
        self.transport_restores.append({
            "stream": list(st.request.stream_id), "src": dead,
            "dst": heir, "restored_chunks": len(st.delivered),
            "at": self.fe.clock.now(),
        })
        return True

    # -- the saturation handoff arc --------------------------------------

    def _start_arc(self, src: int, reason: str) -> None:
        keys = sorted(
            k for k, r in (
                (rq.key, rq) for rq in self.requests
            ) if r.state == "generating" and r.decode_rank == src
        )
        self._arc = {
            "state": "draining", "src": src,
            "dst": self._pick_decode(exclude=(src,)),
            "reqs": keys, "blob": None, "reason": reason,
            "requested_at": self.fe.clock.now(),
        }

    def _fenced(self, req: InferenceRequest) -> bool:
        """True while the request's shards are in the handoff window
        (handoff packed, cutover not yet committed): generation is
        FROZEN so the packed snapshot and the live prefix cannot
        diverge. Draining does NOT fence — tokens accepted during the
        drain are in the snapshot because the pack happens after."""
        arc = self._arc
        return (arc is not None
                and arc["state"] in ("handoff", "cutover")
                and req.key in arc["reqs"])

    def _arc_drained(self) -> bool:
        """No in-flight KV transport still targets the source AND the
        source wire is quiet (no frame in flight or landed-unconsumed
        — the ``_migration_drained`` discipline): the snapshot at
        handoff must not race traffic still landing at the source.
        Monotone while the source lives: a draining source takes no
        new residents (``_pick_decode`` skips it)."""
        src = self._arc["src"]
        lane = self.fe.lanes[src]
        if lane.in_flight or lane.landed:
            return False
        return not any(
            req.state == "kv-transport" and req.decode_rank == src
            for req in self.requests
        )

    def _drive_arc(self) -> None:
        """One handoff-arc transition per tick, the house migration
        discipline applied to KV residency: a membership change
        touching either party aborts FIRST (a failover already moved
        or voided the state; cutting over would resurrect it), then
        draining -> handoff -> cutover -> committed."""
        arc = self._arc
        if arc is None:
            return
        members = self.fe.view.members
        if arc["src"] not in members or arc["dst"] not in members:
            self._abort_arc("membership-change")
            return
        if arc["state"] == "draining":
            if self._arc_drained():
                self._arc_handoff()
        elif arc["state"] == "handoff":
            try:
                self._arc_cutover()
            except QuorumLostError:
                # the cutover's quorum mint failed: committing across
                # a partition could generate the same request on both
                # sides. Abort loudly, loss-free — the fence lifts and
                # generation continues on the source.
                self._abort_arc("quorum-lost")
        elif arc["state"] == "cutover":
            self._arc_commit()

    def _arc_handoff(self) -> None:
        """Fence and pack: the arc requests' KV shards and accepted-
        token prefixes go into ONE CRC+seq-framed checkpoint shard —
        the same framing the elastic soak writes to disk, here as the
        handoff transport. Packed AFTER the fence, so the blob and
        the live prefix agree by construction."""
        arc = self._arc
        arc["state"] = "handoff"  # fence first, then snapshot
        snapshot = sorted(
            (req.key, (req.kv_payloads, tuple(req.tokens)))
            for req in self.requests
            if req.key in arc["reqs"] and req.state == "generating"
        )
        payload = pickle.dumps(snapshot)
        blob, _crc = pack_shard(
            arc["src"], self.fe.view.epoch, payload
        )
        arc["blob"] = blob

    def _arc_cutover(self) -> None:
        arc = self._arc
        # mint BEFORE touching any state: a QuorumLostError must
        # leave the arc cleanly abortable
        token = self.fe.mint_quorum_token(
            rank=arc["dst"],
            what=f"kv handoff cutover {arc['src']}->{arc['dst']}",
        )
        _rank, _step, payload, _crc = unpack_shard(
            arc["blob"], origin=f"kv-handoff:{arc['src']}",
        )
        restored = dict(pickle.loads(payload))
        old_epoch = self.fe.view.epoch
        new_epoch = self.fe.view.migrate_cutover(
            arc["src"], arc["dst"], tenant="kv-handoff", token=token,
        )
        for req in self.requests:
            if req.key not in arc["reqs"]:
                continue
            if req.state != "generating":
                continue  # finished during the drain: nothing resident
            handed = restored.get(req.key)
            if handed is None:
                raise RuntimeError(
                    f"KV handoff lost request {req.key}: not in the "
                    f"shard packed at handoff"
                )
            kv, tokens = handed
            if len(tokens) < len(req.tokens):
                self.lost_accepted_tokens += (
                    len(req.tokens) - len(tokens)
                )
            req.kv_payloads = tuple(kv)
            req.tokens = list(tokens)
            shards = self.residents[arc["src"]].pop(req.key, 0)
            self.residents[arc["dst"]][req.key] = shards
            req.decode_rank = arc["dst"]
        # one straggler from the old incarnation presents the pre-
        # cutover epoch: rejected by epoch, never folded in
        try:
            self.fe.view.validate(
                arc["src"], old_epoch, what="post-handoff straggler",
            )
            self.fe.stale_epoch_leaks += 1
        except StaleEpochError:
            self.fe.stale_epoch_rejections += 1
        del new_epoch
        arc["state"] = "cutover"

    def _arc_commit(self) -> None:
        arc = self._arc
        self.handoffs.append({
            "kind": "handoff", "src": arc["src"], "dst": arc["dst"],
            "streams": [list(k) for k in arc["reqs"]],
            "state": "committed", "reason": arc["reason"],
            "requested_at": arc["requested_at"],
            "committed_at": self.fe.clock.now(),
        })
        self.kv_handoffs_committed += 1
        self._arc = None

    def _abort_arc(self, why: str) -> None:
        arc = self._arc
        self.handoffs.append({
            "kind": "handoff", "src": arc["src"], "dst": arc["dst"],
            "streams": [list(k) for k in arc["reqs"]],
            "state": "aborted", "abort_reason": why,
            "reason": arc["reason"],
            "requested_at": arc["requested_at"],
            "aborted_at": self.fe.clock.now(),
        })
        self.kv_handoffs_aborted += 1
        self._arc = None

    # -- prefill, transport, decode, delivery ----------------------------

    def _pump_prefill(self) -> None:
        for req in self.requests:
            if req.state != "prefill":
                continue
            if (req.prefill_rank not in self.fe.view.members
                    or req.prefill_rank in self.fe.killed):
                # a dead rank computes nothing NOW; recovery waits for
                # the confirm (-> _replay_prefills) like everything else
                continue
            req.prefill_left -= 1
            if req.prefill_left > 0:
                continue
            # placement is decided when the KV is actually ready; a
            # caller's pin holds as long as its rank is live (the
            # wire and the failover path still outrank it)
            if not (req.pinned
                    and req.decode_rank in self._live(self.decode_ranks)
                    and req.decode_rank not in self.fe.killed):
                req.decode_rank = self._pick_decode()
            try:
                fe_req = self.fe.submit(
                    req.tenant, "batch", req.prompt,
                    base_rank=req.decode_rank,
                )
            except AdmissionRejected as e:
                req.state = "shed"
                req.shed_reason = e.reason
                continue
            except QuorumLostError:
                req.prefill_left = 1  # retry next tick
                continue
            req.kv_stream_id = fe_req.stream_id
            self._by_kv_stream[fe_req.stream_id] = req
            req.state = "kv-transport"

    def _note_transports(self) -> None:
        """A completed KV stream installs residency at its landing
        rank: the shards live where the wire put them (which may be a
        failover heir, not the rank chosen at submit)."""
        for st in self.fe.completed:
            req = self._by_kv_stream.pop(st.request.stream_id, None)
            if req is None or req.state != "kv-transport":
                continue
            req.kv_payloads = tuple(
                st.delivered[i] for i in range(st.total_chunks)
            )
            req.decode_rank = st.dst
            self.residents[st.dst][req.key] = len(req.kv_payloads)
            req.state = "generating"
            self._checkpoint(req)
            if req.gen_len == 0:
                # the degenerate zero-token generation: done at
                # arrival, nothing to deliver, shards retire
                self._retire(req)
                req.state = "done"

    def _checkpoint(self, req: InferenceRequest) -> None:
        """The accept-time WAL: (KV bits, accepted prefix) packed
        through the CRC+seq shard framing, synchronously — BEFORE the
        token counts as accepted. This is the zero-loss guarantee's
        entire mechanism."""
        payload = pickle.dumps(
            (req.kv_payloads, tuple(req.tokens))
        )
        blob, _crc = pack_shard(
            req.decode_rank, len(req.tokens), payload
        )
        self.checkpoints[req.key] = blob

    def _generate(self) -> None:
        """Continuous batching: one token per resident, unfenced
        generation per tick. A finished generation submits its tokens
        as an INTERACTIVE stream (token latency is the product)."""
        now = self.fe.clock.now()
        for req in self.requests:
            if req.state != "generating":
                continue
            if self._fenced(req):
                continue
            if (req.decode_rank not in self.fe.view.members
                    or req.decode_rank in self.fe.killed):
                # physically dead = no compute, instantly; the shards
                # stay attributed to the dead rank until the CONFIRM
                # moves them (-> _failover_residents) — detection
                # latency is the control plane's, not physics'
                continue
            if len(req.tokens) < req.gen_len:
                req.tokens.append(
                    decode_token(req.kv_payloads, req.tokens)
                )
                self.tokens_emitted += 1
                self._checkpoint(req)
                if req.ttft is None:
                    req.ttft = now - req.submitted_at
            if len(req.tokens) >= req.gen_len:
                self._try_deliver(req)

    def _try_deliver(self, req: InferenceRequest) -> None:
        try:
            fe_req = self.fe.submit(
                req.tenant, "interactive", tuple(req.tokens),
                base_rank=req.decode_rank,
            )
        except (AdmissionRejected, QuorumLostError):
            return  # retry next tick; tokens are checkpointed
        req.token_stream_id = fe_req.stream_id
        self._by_token_stream[fe_req.stream_id] = req
        # generation is complete and every token checkpointed: the
        # shards have done their job, the inventory releases the rank
        self._retire(req)
        req.state = "delivering"

    def _note_deliveries(self) -> None:
        for st in self.fe.completed:
            req = self._by_token_stream.pop(
                st.request.stream_id, None
            )
            if req is None or req.state != "delivering":
                continue
            req.state = "done"

    def _retire(self, req: InferenceRequest) -> None:
        for inv in self.residents.values():
            inv.pop(req.key, None)
        self.checkpoints.pop(req.key, None)

    # -- saturation blame ------------------------------------------------

    def _watch_saturation(self) -> None:
        """A decode rank accumulating NEW named backpressure sheds
        while holding resident generations is the blame verdict the
        handoff arc keys on. The trigger is the shed counter — an
        admission-edge fact — never a membership event: saturation is
        not death, and the campaign gates that no confirm rides a
        pure-saturation cell."""
        gate = self.fe.gate
        for r in self.decode_ranks:
            reason = f"backpressure:rank{r}"
            count = sum(
                gate.shed[c].get(reason, 0) for c in gate.shed
            )
            grew = count - self._shed_seen.get(r, 0)
            self._shed_seen[r] = count
            if grew <= 0:
                # the accrual DECAYS on quiet ticks (the house
                # _recent_stalls discipline): only SUSTAINED shedding
                # — growth most ticks — reaches the arming threshold;
                # a transient graze halves away
                if self._blame_growth.get(r):
                    self._blame_growth[r] //= 2
                continue
            if r not in self.fe.view.members:
                continue
            if r in self.fe.detector.suspected or r in self.fe.killed:
                # suspicion pauses blame: a rank the detector already
                # doubts is the FAILOVER path's problem — starting a
                # load-balancing handoff from it would race the
                # confirm and muddle the two recovery attributions
                continue
            if not self.residents.get(r):
                continue
            accrued = self._blame_growth.get(r, 0) + grew
            self._blame_growth[r] = accrued
            if accrued < SATURATION_SHED_MIN:
                continue  # a transient graze, not saturation
            self.blame_triggers.append({
                "rank": r, "reason": reason, "sheds": count,
                "at": self.fe.clock.now(),
            })
            if self._arc is not None:
                continue
            live = self._live(self.decode_ranks)
            if len(live) < 2:
                continue  # nowhere to hand off to: named, not acted
            self._blame_growth[r] = 0
            self._start_arc(r, reason=f"blame:{reason}")

    # -- report ----------------------------------------------------------

    def generation_digest(self) -> Dict[Tuple[str, int], Tuple[str, ...]]:
        """(tenant, req_no) -> accepted token tuple, for DONE requests
        — the bit-identity surface the kill-decode cell compares
        against its no-fault control arm on the key intersection."""
        return {
            req.key: tuple(req.tokens)
            for req in self.requests if req.state == "done"
        }

    def report(self) -> Dict:
        states = {s: 0 for s in REQUEST_STATES}
        for req in self.requests:
            states[req.state] += 1
        ttfts = sorted(
            req.ttft for req in self.requests
            if req.ttft is not None
        )
        return {
            "decode_ranks": list(self.decode_ranks),
            "prefill_ranks": list(self.prefill_ranks),
            "requests": len(self.requests),
            "states": states,
            "tokens_emitted": self.tokens_emitted,
            "kv_handoffs_committed": self.kv_handoffs_committed,
            "kv_handoffs_aborted": self.kv_handoffs_aborted,
            "replayed_prefills": self.replayed_prefills,
            "lost_accepted_tokens": self.lost_accepted_tokens,
            "wal_restores": self.wal_restores,
            "transport_restores": len(self.transport_restores),
            "handoffs": [dict(h) for h in self.handoffs],
            "blame_triggers": [dict(b) for b in self.blame_triggers],
            "resident_shards": {
                r: sum(inv.values())
                for r, inv in self.residents.items() if inv
            },
            "ttft": ttfts,
            "arc_state": (self._arc["state"]
                          if self._arc is not None else None),
        }


# -- the traced execution variant ----------------------------------------

def traced_kv_dataflow(comm, requests: int = 2, kv_chunks: int = 4,
                       gen_len: int = 2, backend: str = "xla"):
    """The same prefill -> KV-scatter -> decode-gather dataflow as a
    program of collectives (the SNIPPETS [2]/[3] shard/gather shape),
    called on every rank of a world (inside :meth:`LocalWorld.run`, or
    once a process of a process group): prompts enter replicated on
    ``comm``'s device, every rank scales them by ``rank + 1`` (its KV
    projection — the decode residency), and each of ``gen_len`` decode
    steps folds the ranks' row sums with one :func:`allreduce` on
    ``backend`` (the default tier, or ``"ring"``) — the gather that makes
    every token depend on every resident shard, exactly the bit-identity
    coupling :func:`decode_token` gives the engine.

    Returns ``(tokens, dataflow)``: the accepted-token prefixes stacked
    as a ``(gen_len, requests)`` float32 tensor (``(0, requests)`` when
    ``gen_len`` is 0), and the record of the collectives this call
    issued, one line each in issue order, naming the collective with its
    shape and dtype (``all-reduce f32[requests] ...``). The JAX package
    returns the optimized HLO text for the static verifier and the
    traffic lint there; the port compiles no HLO, so its record holds
    only the dataflow it issued, and no lint reads it.
    """
    import torch

    from smi_tpu_torch.parallel.collectives import allreduce

    n = comm.size
    if kv_chunks % n:
        raise ValueError(
            f"kv_chunks={kv_chunks} must divide over {n} devices"
        )
    axis = ",".join(comm.axis_names)
    prompts = (
        torch.arange(requests * kv_chunks, dtype=torch.float32,
                     device=comm.device)
        .reshape(requests, kv_chunks)
    )
    # prefill: the KV projection of each prompt chunk, computed on the
    # rank that holds it
    local = prompts * float(comm.rank + 1)
    tokens, dataflow = [], []
    prefix = torch.zeros((requests,), dtype=torch.float32,
                         device=comm.device)
    for step in range(gen_len):
        folded = allreduce(local.sum(-1), comm, backend=backend)
        dataflow.append(
            f"all-reduce f32[{requests}] op=add replica_groups=[{axis}] "
            f"n={n} backend={backend} step={step}"
        )
        # the next step's local KV update is independent of this step's
        # gather (the overlap the JAX package's traffic lint checks for)
        local = local + float(step + 1)
        prefix = prefix + folded
        tokens.append(prefix)
    out = torch.stack(tokens) if tokens else torch.zeros(
        (0, requests), dtype=torch.float32, device=comm.device
    )
    return out, "\n".join(dataflow)
