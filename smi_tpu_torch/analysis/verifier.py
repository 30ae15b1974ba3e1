"""Static protocol verifier: happens-before analysis of the credits zoo.

The port's copy of :mod:`smi_tpu.analysis.verifier`, kept in step
with it line for line: the same protocols give the same reports.

Reference parity: the SMI toolchain verifies programs *at compile time*
— codegen derives routing tables and channel descriptors and rejects
ill-formed programs before anything runs. The TPU port's protocol layer
(:mod:`smi_tpu_torch.parallel.credits`) has so far been verified dynamically:
``explore_all_schedules`` walks interleavings, but the composite and pod
schedule spaces are beyond exhaustive reach (PR 6 capped them with
``allow_budget=``). This module closes that gap with a *static* pass
that proves the invariants for the WHOLE schedule space in polynomial
time, in the tradition of Lamport's happens-before relation (CACM'78)
and Eraser-style race detection (Savage et al., SOSP'97 — lockset /
vector-clock checking; PAPERS.md).

Why a single symbolic replay is enough
--------------------------------------
Every registered protocol obeys the one-yield-per-primitive discipline:
a rank's generator emits a *schedule-independent* primitive sequence —
control flow never branches on a payload, so replaying each generator
once (feeding a symbolic token to every ``read_slot``) recovers the
complete per-rank event alphabet. The verifier double-traces each rank
and insists the two sequences are identical, so the assumption is
checked, not trusted.

On those fixed sequences the system is a monotone counting-semaphore
program: signals only ever *add* permission, each semaphore domain
``(rank, sem, index)`` has exactly one consumer (the owning rank, which
waits in program order), and DMA landings affect data, never progress.
Such systems are **confluent** (Keller's persistence/diamond argument):
whether the program terminates — and how many units each domain ends
with — is the same under every schedule. One canonical replay therefore
decides deadlock-freedom and credit balance for the whole space.

What each check proves (see ``docs/analysis.md`` for the fine print):

1. **deadlock** — the canonical replay either completes (no schedule
   can deadlock) or blocks; on a block the cross-rank wait-for relation
   is analysed and the finding names the minimal cycle — or the starved
   wait no remaining signal can ever satisfy — as
   ``(rank, step, primitive)`` events.
2. **slot-race** — a static happens-before graph is built from the
   matched signal/wait pairs (fixpoint-refined, see
   :func:`_happens_before`) and every pair of accesses to one comm slot
   (DMA landings, local writes, reads) must be HB-ordered; an unordered
   write/write or write/read pair is a race, verified on the reachability
   closure (the vector-clock formulation with one component per event)
   and reported with both events named.
3. **credit-conservation** — per semaphore domain, total signalled
   units must equal total consumed units: a surplus is a leak (the
   count Pallas would report non-zero at exit), a deficit is a wait
   that must starve.
4. **wire-lane** — per (src, dst) destination lane — and per-rank local
   lane — consumption order must equal send order with strictly
   increasing sequence numbers (re-reads of the last frame allowed),
   statically proving the PR 2/PR 6 verified-transport framing
   invariant for race-free protocols.

Scope: the static guarantee is **fault-free only** — it quantifies over
schedules, not over dropped grants, dead links, or in-flight damage.
Faults remain the chaos campaign's job (:mod:`smi_tpu_torch.parallel.faults`);
the two tiers are cross-validated by ``tests/test_analysis.py``'s
differential harness (every space the dynamic fuzzer can exhaust must
agree with the verifier, on clean protocols and on the broken mutants of
:mod:`smi_tpu_torch.analysis.mutants` alike).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from smi_tpu_torch.parallel import credits as C

#: The checks the verifier runs, in order. ``docs/analysis.md`` must
#: document every one of them (drift-guarded by tests/test_perf_docs).
CHECKS = ("deadlock", "slot-race", "credit-conservation", "wire-lane")

#: Largest ring the ``route --check --lint`` tier verifies per protocol:
#: the protocols are size-generic, so a representative instance stands
#: for the topology (the graph grows ~n^2 events; n=8 stays instant).
MAX_LINT_N = 8


class AnalysisError(ValueError):
    """The verifier's own preconditions failed (nondeterministic rank
    sequence, malformed primitive) — a bug in the *input*, distinct
    from a protocol finding."""


# ---------------------------------------------------------------------------
# Symbolic replay: recover each rank's schedule-independent sequence
# ---------------------------------------------------------------------------


class _Sym:
    """Placeholder payload fed to every ``read_slot``: absorbs the
    union-combines the registered protocols apply to arrived values, so
    the trace never depends on real data.

    Any OBSERVATION of the payload — equality, ordering, truth-testing,
    hashing — raises :class:`AnalysisError`: a generator that branches
    on what arrived is not schedule-independent, and silently taking
    the same (arbitrary) branch in both replays would let the
    double-trace mis-verify it instead of rejecting it."""

    __slots__ = ()

    def __or__(self, other):
        return self

    def __ror__(self, other):
        return self

    def __repr__(self):
        return "<sym>"

    def _observed(self, *_args):
        raise AnalysisError(
            "protocol control flow depends on a read payload (the "
            "symbolic token was compared/tested/hashed): the sequence "
            "is not schedule-independent and no static claim is "
            "possible"
        )

    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _observed
    __bool__ = __hash__ = _observed


SYM = _Sym()


def symbolic_events(gen: Iterator) -> List[tuple]:
    """Drive one rank's protocol generator to completion, feeding the
    symbolic token to every ``read_slot`` — the single replay that
    recovers the rank's full primitive sequence."""
    events: List[tuple] = []
    value = None
    while True:
        try:
            action = gen.send(value)
        except StopIteration:
            return events
        if not isinstance(action, tuple) or not action:
            raise AnalysisError(f"malformed primitive {action!r}")
        events.append(action)
        value = SYM if action[0] == "read_slot" else None


def _describe(action: tuple) -> tuple:
    """Normalize a primitive for reporting: payloads elided (they are
    symbolic anyway), structure kept."""
    kind = action[0]
    if kind == "dma":
        _, target, slot, _payload, send_index, recv_index = action
        return ("dma", target, slot, send_index, recv_index)
    if kind == "write_slot":
        return ("write_slot", action[1])
    if kind == "output":
        return ("output", action[1])
    return action


@dataclasses.dataclass(frozen=True)
class VerifyEvent:
    """One (rank, step, primitive) coordinate in a finding — ``step``
    indexes the rank's recovered primitive sequence."""

    rank: int
    step: int
    primitive: tuple

    def __str__(self) -> str:
        return f"(rank {self.rank}, step {self.step}, {self.primitive})"

    def to_json(self) -> dict:
        return {"rank": self.rank, "step": self.step,
                "primitive": list(map(str, self.primitive))}


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verified defect. ``events`` carries the (rank, step,
    primitive) coordinates the message names; the structured fields let
    the differential harness compare against the dynamic fuzzer's named
    errors without string parsing."""

    CHECK = "?"

    message: str
    events: Tuple[VerifyEvent, ...] = ()
    rank: Optional[int] = None
    slot: Optional[int] = None
    domain: Optional[tuple] = None
    expected: Optional[object] = None
    got: Optional[object] = None

    @property
    def check(self) -> str:
        return type(self).CHECK

    def to_json(self) -> dict:
        out = {
            "check": self.check,
            "message": self.message,
            "events": [e.to_json() for e in self.events],
        }
        for key in ("rank", "slot"):
            if getattr(self, key) is not None:
                out[key] = getattr(self, key)
        if self.domain is not None:
            out["domain"] = list(map(str, self.domain))
        if self.expected is not None:
            out["expected"] = str(self.expected)
        if self.got is not None:
            out["got"] = str(self.got)
        return out

    def __str__(self) -> str:
        lines = [f"[{self.check}] {self.message}"]
        lines.extend(f"    at {e}" for e in self.events)
        return "\n".join(lines)


class StaticDeadlock(Finding):
    """A wait-for cycle — or a starved wait — proving some (hence, by
    confluence, every) schedule cannot complete."""

    CHECK = "deadlock"


class SlotRace(Finding):
    """Two accesses to one comm slot with no happens-before edge — the
    clobber the credit protocol exists to prevent."""

    CHECK = "slot-race"


class CreditConservation(Finding):
    """A semaphore domain whose signalled and consumed totals differ —
    surplus units leak (poisoning the next collective on the
    semaphore), missing units starve a wait."""

    CHECK = "credit-conservation"


class WireLaneViolation(Finding):
    """A destination consumed frames out of send order on one sequence
    lane — the framing invariant (`credits.verified_steps`) would raise
    ``IntegrityError(kind="sequence")`` at runtime."""

    CHECK = "wire-lane"


@dataclasses.dataclass(frozen=True)
class StaticReport:
    """Verdict of one protocol instance. ``checks`` lists the checks
    that actually ran (a deadlock stops the HB-dependent checks; slot
    races invalidate the wire-lane claim — see docs/analysis.md)."""

    protocol: str
    shape: Dict[str, int]
    ranks: int
    events: int
    findings: Tuple[Finding, ...]
    checks: Tuple[str, ...] = CHECKS

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "protocol": self.protocol,
            "shape": dict(self.shape),
            "ranks": self.ranks,
            "events": self.events,
            "ok": self.ok,
            "checks": list(self.checks),
            "findings": [f.to_json() for f in self.findings],
        }

    def describe(self) -> str:
        shape = ", ".join(f"{k}={v}" for k, v in sorted(self.shape.items()))
        head = f"{self.protocol} [{shape}]"
        if self.ok:
            return (f"{head}: ok ({self.events} events, "
                    f"checks: {', '.join(self.checks)})")
        body = "\n".join(f"  {line}" for f in self.findings
                         for line in str(f).splitlines())
        return f"{head}: {len(self.findings)} finding(s)\n{body}"


# ---------------------------------------------------------------------------
# Event graph
# ---------------------------------------------------------------------------


class _Graph:
    """Static event graph of one protocol instance.

    Nodes are (a) every rank primitive, in program order, and (b) one
    *landing* node per DMA (the copy arriving at the target — ordered
    after its start, unordered with anything else until semaphore
    matching adds edges). Semaphore bookkeeping is per *domain*
    ``(owner_rank, sem_name, index)``: producers are signal events and
    DMA send/landing side-effects; consumers are the owner's waits in
    program order.
    """

    def __init__(self, seqs: Sequence[Sequence[tuple]]):
        self.seqs = [list(s) for s in seqs]
        self.n_ranks = len(self.seqs)
        self.offsets: List[int] = []
        total = 0
        for s in self.seqs:
            self.offsets.append(total)
            total += len(s)
        self.n_rank_nodes = total
        #: landing node per dma node id
        self.land_of: Dict[int, int] = {}
        #: landing node id -> its dma node id
        self.dma_of_land: Dict[int, int] = {}
        #: node id -> (rank, step) for rank nodes
        self.preds: List[List[int]] = [[] for _ in range(total)]
        #: domain -> [(node, amount)] in no particular cross-producer order
        self.producers: Dict[tuple, List[Tuple[int, int]]] = {}
        #: domain -> [(node, amount)] in the owner's program order
        self.waits: Dict[tuple, List[Tuple[int, int]]] = {}
        #: per (rank, slot): [(node, "read"|"write")] — landings included
        self.accesses: Dict[Tuple[int, int], List[Tuple[int, str]]] = {}
        #: dma node -> (src, dst, per-destination wire sequence number)
        self.lane_of: Dict[int, Tuple[int, int, int]] = {}
        #: local write_slot node -> (rank, local sequence number)
        self.local_lane_of: Dict[int, Tuple[int, int]] = {}

        wire_seqs: Dict[Tuple[int, int], int] = {}
        for r, seq in enumerate(self.seqs):
            local_seq = 0
            for i, action in enumerate(seq):
                nid = self.nid(r, i)
                if i:
                    self.preds[nid].append(nid - 1)
                kind = action[0]
                if kind == "signal":
                    _, target, name, index, inc = action
                    self._produce((target, name, index), nid, inc)
                elif kind == "wait":
                    _, name, index, amount = action
                    self.waits.setdefault((r, name, index), []).append(
                        (nid, amount)
                    )
                elif kind == "dma":
                    _, target, slot, _p, send_index, recv_index = action
                    land = len(self.preds)
                    self.preds.append([nid])
                    self.land_of[nid] = land
                    self.dma_of_land[land] = nid
                    seq_no = wire_seqs.get((r, target), 0)
                    wire_seqs[(r, target)] = seq_no + 1
                    self.lane_of[nid] = (r, target, seq_no)
                    self._produce((r, C.SEM_SEND, send_index), nid, 1)
                    self._produce((target, C.SEM_RECV, recv_index), land, 1)
                    self.accesses.setdefault((target, slot), []).append(
                        (land, "write")
                    )
                elif kind == "write_slot":
                    _, slot, _p = action
                    self.local_lane_of[nid] = (r, local_seq)
                    local_seq += 1
                    self.accesses.setdefault((r, slot), []).append(
                        (nid, "write")
                    )
                elif kind == "read_slot":
                    _, slot = action
                    self.accesses.setdefault((r, slot), []).append(
                        (nid, "read")
                    )
                elif kind != "output":
                    raise AnalysisError(f"unknown primitive {action!r}")

    def nid(self, rank: int, step: int) -> int:
        return self.offsets[rank] + step

    def _produce(self, domain: tuple, nid: int, amount: int) -> None:
        self.producers.setdefault(domain, []).append((nid, amount))

    def event(self, nid: int) -> VerifyEvent:
        """The reporting coordinate of a node; landings report as the
        originating dma with a ``dma-land`` primitive."""
        if nid in self.dma_of_land:
            dma = self.dma_of_land[nid]
            rank, step = self.rank_step(dma)
            action = self.seqs[rank][step]
            return VerifyEvent(rank, step, (
                "dma-land", action[1], action[2], action[5]
            ))
        rank, step = self.rank_step(nid)
        return VerifyEvent(rank, step, _describe(self.seqs[rank][step]))

    def rank_step(self, nid: int) -> Tuple[int, int]:
        lo, hi = 0, self.n_ranks - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.offsets[mid] <= nid:
                lo = mid
            else:
                hi = mid - 1
        return lo, nid - self.offsets[lo]


# ---------------------------------------------------------------------------
# Check 3: credit conservation (pure counting over the sequences)
# ---------------------------------------------------------------------------


def _check_credit_conservation(g: _Graph) -> List[Finding]:
    findings: List[Finding] = []
    domains = sorted(set(g.producers) | set(g.waits), key=repr)
    for domain in domains:
        produced = sum(a for _, a in g.producers.get(domain, ()))
        consumed = sum(a for _, a in g.waits.get(domain, ()))
        if produced == consumed:
            continue
        if produced > consumed:
            # name the tail producers whose units can never drain
            surplus = produced - consumed
            tail: List[VerifyEvent] = []
            acc = 0
            for nid, amount in reversed(g.producers.get(domain, ())):
                tail.append(g.event(nid))
                acc += amount
                if acc >= surplus:
                    break
            findings.append(CreditConservation(
                message=(
                    f"semaphore domain {domain} leaks {surplus} unit(s): "
                    f"{produced} signalled but only {consumed} consumed — "
                    f"the count stays non-zero at exit and poisons the "
                    f"next collective on this semaphore"
                ),
                events=tuple(reversed(tail)),
                rank=domain[0], domain=domain,
                expected=consumed, got=produced,
            ))
        else:
            deficit = consumed - produced
            waiters = tuple(
                g.event(nid) for nid, _ in g.waits.get(domain, ())
            )[-1:]
            findings.append(CreditConservation(
                message=(
                    f"semaphore domain {domain} is short {deficit} "
                    f"unit(s): {consumed} consumed by waits but only "
                    f"{produced} ever signalled — the final wait must "
                    f"starve under every schedule"
                ),
                events=waiters,
                rank=domain[0], domain=domain,
                expected=consumed, got=produced,
            ))
    return findings


# ---------------------------------------------------------------------------
# Canonical replay: deadlock freedom + the read/write observation map
# ---------------------------------------------------------------------------


def _future_producers(g: _Graph, pcs: List[int], domain: tuple) -> List[int]:
    """Ranks whose *remaining* sequence still produces units on
    ``domain`` (signals, or DMAs whose send/landing side-effects land
    there)."""
    out = []
    for p in range(g.n_ranks):
        for action in g.seqs[p][pcs[p]:]:
            kind = action[0]
            if kind == "signal" and (action[1], action[2],
                                     action[3]) == domain:
                out.append(p)
                break
            if kind == "dma":
                _, target, _slot, _pl, send_index, recv_index = action
                if ((p, C.SEM_SEND, send_index) == domain
                        or (target, C.SEM_RECV, recv_index) == domain):
                    out.append(p)
                    break
    return out


def _shortest_cycle(edges: Dict[int, set]) -> Optional[List[int]]:
    """Shortest directed cycle in a tiny digraph (BFS from each node)."""
    best: Optional[List[int]] = None
    for start in edges:
        # BFS back to start
        parent = {start: None}
        frontier = [start]
        found = None
        while frontier and found is None:
            nxt = []
            for v in frontier:
                for w in edges.get(v, ()):
                    if w == start:
                        found = v
                        break
                    if w not in parent:
                        parent[w] = v
                        nxt.append(w)
                if found is not None:
                    break
            frontier = nxt
        if found is None:
            continue
        cycle = [found]
        while parent[cycle[-1]] is not None:
            cycle.append(parent[cycle[-1]])
        cycle.reverse()
        if best is None or len(cycle) < len(best):
            best = cycle
    return best


@dataclasses.dataclass
class _Replay:
    """Result of the canonical eager execution."""

    completed: bool
    findings: List[Finding]
    #: read node -> writer node it observed (None: unwritten slot)
    observed: Dict[int, Optional[int]]


def _replay(g: _Graph) -> _Replay:
    """Run the canonical schedule: every rank advances as far as it
    can, DMAs land immediately. By confluence (module docstring) the
    outcome — completion vs deadlock, and final semaphore counts —
    holds for every schedule."""
    pcs = [0] * g.n_ranks
    sems: Dict[tuple, int] = {}
    slots: Dict[Tuple[int, int], Optional[int]] = {}
    observed: Dict[int, Optional[int]] = {}
    findings: List[Finding] = []

    progress = True
    while progress:
        progress = False
        for r in range(g.n_ranks):
            while pcs[r] < len(g.seqs[r]):
                action = g.seqs[r][pcs[r]]
                kind = action[0]
                nid = g.nid(r, pcs[r])
                if kind == "wait":
                    _, name, index, amount = action
                    key = (r, name, index)
                    if sems.get(key, 0) < amount:
                        break
                    sems[key] = sems.get(key, 0) - amount
                elif kind == "signal":
                    _, target, name, index, inc = action
                    key = (target, name, index)
                    sems[key] = sems.get(key, 0) + inc
                elif kind == "dma":
                    _, target, slot, _p, send_index, recv_index = action
                    sems[(r, C.SEM_SEND, send_index)] = (
                        sems.get((r, C.SEM_SEND, send_index), 0) + 1
                    )
                    # land immediately: landings only add permission,
                    # so the eager landing is progress-equivalent
                    slots[(target, slot)] = g.land_of[nid]
                    sems[(target, C.SEM_RECV, recv_index)] = (
                        sems.get((target, C.SEM_RECV, recv_index), 0) + 1
                    )
                elif kind == "write_slot":
                    _, slot, _p = action
                    slots[(r, slot)] = nid
                elif kind == "read_slot":
                    _, slot = action
                    observed[nid] = slots.get((r, slot))
                pcs[r] += 1
                progress = True

    if all(pcs[r] >= len(g.seqs[r]) for r in range(g.n_ranks)):
        # reads of slots no sequence ever writes are broken regardless
        # of schedule; reads whose writer merely raced are the slot-race
        # check's business (the write exists, ordering is the question)
        for nid, writer in observed.items():
            if writer is None:
                rank, step = g.rank_step(nid)
                slot = g.seqs[rank][step][1]
                if not any(
                    kind == "write"
                    for _, kind in g.accesses.get((rank, slot), ())
                ):
                    findings.append(SlotRace(
                        message=(
                            f"rank {rank} reads slot {slot} which no "
                            f"rank's sequence ever writes"
                        ),
                        events=(g.event(nid),), rank=rank, slot=slot,
                    ))
        return _Replay(True, findings, observed)

    # blocked: analyse the cross-rank wait-for relation
    blocked: Dict[int, Tuple[int, tuple, tuple]] = {}
    for r in range(g.n_ranks):
        if pcs[r] >= len(g.seqs[r]):
            continue
        action = g.seqs[r][pcs[r]]
        # only waits can block the eager replay
        _, name, index, amount = action
        blocked[r] = (g.nid(r, pcs[r]), (r, name, index), action)

    waitfor: Dict[int, set] = {}
    starved: List[int] = []
    for r, (nid, domain, _a) in blocked.items():
        producers = [p for p in _future_producers(g, pcs, domain)
                     if p != r]
        if not producers:
            starved.append(r)
        waitfor[r] = set(producers)

    if starved:
        s = starved[0]
        nid, domain, action = blocked[s]
        chain = [g.event(nid)]
        chain += [g.event(blocked[r][0]) for r in sorted(blocked)
                  if r != s]
        findings.append(StaticDeadlock(
            message=(
                f"rank {s} waits on semaphore domain {domain} but no "
                f"remaining signal in any rank's sequence can satisfy "
                f"it — every schedule deadlocks with "
                f"{len(blocked)} rank(s) blocked"
            ),
            events=tuple(chain), rank=s, domain=domain,
        ))
    else:
        cycle = _shortest_cycle(waitfor)
        if cycle is None:  # pragma: no cover — see docs: impossible at
            cycle = sorted(blocked)  # a blocked fixpoint w/o starvation
        findings.append(StaticDeadlock(
            message=(
                "cross-rank wait-for cycle: "
                + " -> ".join(
                    f"rank {r} at {_describe(blocked[r][2])}"
                    for r in cycle
                )
                + f" -> rank {cycle[0]} — no schedule can complete"
            ),
            events=tuple(g.event(blocked[r][0]) for r in cycle),
            rank=cycle[0], domain=blocked[cycle[0]][1],
        ))
    return _Replay(False, findings, observed)


# ---------------------------------------------------------------------------
# Happens-before graph (fixpoint) + slot races
# ---------------------------------------------------------------------------


def _ancestor_sets(n_nodes: int, preds: Sequence[Sequence[int]],
                   extra: Dict[int, set]) -> Optional[List[int]]:
    """Strict-ancestor bitmask per node (int bitsets — the vector-clock
    closure with one binary component per event). None on a cycle."""
    succs: List[List[int]] = [[] for _ in range(n_nodes)]
    indeg = [0] * n_nodes
    for v in range(n_nodes):
        ps = list(preds[v]) + list(extra.get(v, ()))
        indeg[v] = len(ps)
        for p in ps:
            succs[p].append(v)
    order = [v for v in range(n_nodes) if indeg[v] == 0]
    anc = [0] * n_nodes
    done = 0
    while order:
        v = order.pop()
        done += 1
        mask = anc[v] | (1 << v)
        for s in succs[v]:
            anc[s] |= mask
            indeg[s] -= 1
            if indeg[s] == 0:
                order.append(s)
    return anc if done == n_nodes else None


def _happens_before(g: _Graph) -> Optional[List[int]]:
    """The static happens-before closure.

    Base edges: program order and dma-start -> landing. Signal/wait
    matching is refined to a fixpoint: a wait whose cumulative demand is
    ``c`` happens-after exactly those increments without which the
    domain's *causally available* units fall below ``c`` (increments the
    wait itself precedes are not available to it — that exclusion is
    what the fixpoint iterates on). For the zoo's domains — single
    producer per credit/recv/send lane, the symmetric two-producer
    barrier — this matching is exact, not just sound; see
    docs/analysis.md for the precision statement.
    """
    n_nodes = len(g.preds)
    extra: Dict[int, set] = {}
    for _ in range(n_nodes + 1):
        anc = _ancestor_sets(n_nodes, g.preds, extra)
        if anc is None:
            return None  # HB cycle: inconsistent protocol
        changed = False
        for domain, waits in g.waits.items():
            producers = g.producers.get(domain, ())
            cumulative = 0
            for wnid, amount in waits:
                cumulative += amount
                candidates = [
                    (pid, a) for pid, a in producers
                    if not (anc[pid] >> wnid) & 1
                ]
                total = sum(a for _, a in candidates)
                for pid, a in candidates:
                    if total - a < cumulative:
                        if pid not in extra.setdefault(wnid, set()):
                            extra[wnid].add(pid)
                            changed = True
        if not changed:
            return anc
    raise AnalysisError("happens-before fixpoint did not converge")


def _check_slot_races(g: _Graph, anc: List[int]) -> List[Finding]:
    findings: List[Finding] = []
    for (rank, slot), accs in sorted(g.accesses.items()):
        for i in range(len(accs)):
            a_nid, a_kind = accs[i]
            for j in range(i + 1, len(accs)):
                b_nid, b_kind = accs[j]
                if a_kind == "read" and b_kind == "read":
                    continue
                if ((anc[b_nid] >> a_nid) & 1
                        or (anc[a_nid] >> b_nid) & 1):
                    continue
                ea, eb = g.event(a_nid), g.event(b_nid)
                findings.append(SlotRace(
                    message=(
                        f"rank {rank} slot {slot}: {a_kind} by {ea} "
                        f"races {b_kind} by {eb} — no happens-before "
                        f"edge orders them, so some schedule clobbers "
                        f"unconsumed data"
                    ),
                    events=(ea, eb), rank=rank, slot=slot,
                ))
    return findings


# ---------------------------------------------------------------------------
# Wire-lane monotonicity
# ---------------------------------------------------------------------------


def _check_wire_lanes(g: _Graph,
                      observed: Dict[int, Optional[int]]) -> List[Finding]:
    """Per destination, frames must be consumed in send order.

    Uses the replay's read -> writer map: in a race-free protocol each
    read observes the same writer under every schedule (data-race
    freedom determinism), so the replay's lane order IS the protocol's
    lane order. The re-read of the lane's last frame is legal (the
    all-gather's deliver-then-forward double read), mirroring
    ``credits._verify_frame``.
    """
    findings: List[Finding] = []
    # (reader_rank, lane key) -> (last seq, last writer nid)
    state: Dict[tuple, Tuple[int, int]] = {}
    for nid in sorted(observed):
        writer = observed[nid]
        if writer is None:
            continue
        reader, _ = g.rank_step(nid)
        if writer in g.dma_of_land:
            src, dst, seq = g.lane_of[g.dma_of_land[writer]]
            lane = (reader, ("wire", src, dst))
        else:
            src, seq = g.local_lane_of[writer]
            lane = (reader, ("local", src))
        last = state.get(lane)
        if last is not None:
            last_seq, last_writer = last
            if writer == last_writer:
                continue  # verified re-read of the same frame
            if seq != last_seq + 1:
                findings.append(WireLaneViolation(
                    message=(
                        f"rank {reader} consumed frame seq={seq} on "
                        f"lane {lane[1]} after seq={last_seq} — "
                        f"consumption order diverges from send order; "
                        f"the verified-transport framing would raise "
                        f"IntegrityError(kind='sequence') here"
                    ),
                    events=(g.event(nid), g.event(writer)),
                    rank=reader, expected=last_seq + 1, got=seq,
                ))
                continue
        elif seq != 0:
            findings.append(WireLaneViolation(
                message=(
                    f"rank {reader} consumed frame seq={seq} as the "
                    f"FIRST frame of lane {lane[1]} — frames before it "
                    f"were lost or overtaken"
                ),
                events=(g.event(nid), g.event(writer)),
                rank=reader, expected=0, got=seq,
            ))
            continue
        state[lane] = (seq, writer)
    return findings


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def verify_generators(
    make_generators: Callable[[], Sequence[Iterator]],
    protocol: str = "<anonymous>",
    shape: Optional[Dict[str, int]] = None,
) -> StaticReport:
    """Statically verify one protocol instance.

    ``make_generators`` builds the per-rank generators fresh (the same
    zero-arg-factory contract as ``credits.explore_all_schedules``); it
    is called twice so the recovered sequences can be compared — the
    schedule-independence assumption is checked, not trusted.
    """
    seqs = [symbolic_events(gen) for gen in make_generators()]
    seqs2 = [symbolic_events(gen) for gen in make_generators()]
    norm = [[_describe(a) for a in s] for s in seqs]
    norm2 = [[_describe(a) for a in s] for s in seqs2]
    if norm != norm2:
        # name the first diverging (rank, step, primitive) pair — a
        # bare "sequences differ" leaves the author of a
        # nondeterministic protocol grepping blind
        if len(norm) != len(norm2):
            raise AnalysisError(
                f"{protocol}: the two symbolic replays produced "
                f"{len(norm)} vs {len(norm2)} rank sequences — the "
                f"factory is not rebuilding the same instance, and no "
                f"static claim is possible"
            )
        rank, step, first, second = next(
            (r, i,
             s1[i] if i < len(s1) else "<end of sequence>",
             s2[i] if i < len(s2) else "<end of sequence>")
            for r, (s1, s2) in enumerate(zip(norm, norm2))
            for i in range(max(len(s1), len(s2)))
            if (s1[i:i + 1] or ["<end>"]) != (s2[i:i + 1] or ["<end>"])
        )
        raise AnalysisError(
            f"{protocol}: rank {rank} diverges at step {step} between "
            f"two symbolic replays — first replay yielded {first}, "
            f"second yielded {second}; the one-yield-per-primitive "
            f"discipline is violated and no static claim is possible"
        )
    g = _Graph(seqs)
    findings: List[Finding] = []
    checks: List[str] = ["credit-conservation"]
    findings.extend(_check_credit_conservation(g))
    replay = _replay(g)
    checks.append("deadlock")
    findings.extend(replay.findings)
    if replay.completed:
        anc = _happens_before(g)
        if anc is None:
            findings.append(StaticDeadlock(
                message=(
                    "happens-before graph contains a cycle — the "
                    "signal/wait matching is circular"
                ),
            ))
        else:
            checks.append("slot-race")
            races = _check_slot_races(g, anc)
            findings.extend(races)
            if not races:
                # lane order is schedule-independent only under DRF
                checks.append("wire-lane")
                findings.extend(_check_wire_lanes(g, replay.observed))
    ordered = tuple(c for c in CHECKS if c in checks)
    return StaticReport(
        protocol=protocol,
        shape=dict(shape or {}),
        ranks=g.n_ranks,
        events=len(g.preds),
        findings=tuple(findings),
        checks=ordered,
    )


# ---------------------------------------------------------------------------
# Registry: every protocol the fault layer knows, buildable by name
# ---------------------------------------------------------------------------


def _registered() -> Tuple[str, ...]:
    # the consolidated registry (credits.all_protocol_registries) is
    # the one enumeration — a protocol family registered there joins
    # the verifier, the perf decomposer, and the launch gate at once
    return C.registered_protocols()


def build_generators(protocol: str, n: int, chunks: int = 3,
                     slices: int = 2,
                     flow_control: bool = True) -> List[Iterator]:
    """Fresh per-rank generators for a registered protocol, with the
    standard symbolic contributions (mirrors the harnesses in
    :mod:`smi_tpu_torch.parallel.credits`)."""
    if protocol == "all_gather":
        return [C.all_gather_rank(r, n, ("chunk", r),
                                  flow_control=flow_control)
                for r in range(n)]
    if protocol == "all_reduce":
        return [C.all_reduce_rank(r, n, frozenset([r]), lambda a, b: a | b,
                                  flow_control=flow_control)
                for r in range(n)]
    if protocol == "reduce_scatter":
        return [C.reduce_scatter_rank(
            r, n, [frozenset([(r, b)]) for b in range(n)],
            lambda a, b: a | b, flow_control=flow_control)
            for r in range(n)]
    if protocol == "neighbour_stream":
        return [C.neighbour_stream_rank(
            r, n, [(r, c) for c in range(chunks)],
            flow_control=flow_control)
            for r in range(n)]
    if protocol == "all_reduce_chunked":
        return [C.all_reduce_chunked_rank(
            r, n, [frozenset([(r, c)]) for c in range(chunks)],
            lambda a, b: a | b, flow_control=flow_control)
            for r in range(n)]
    if protocol == "allreduce_pod":
        if n % slices:
            raise ValueError(
                f"allreduce_pod needs n divisible by slices, got "
                f"n={n} slices={slices}"
            )
        return C.allreduce_pod_generators(slices, n // slices,
                                          flow_control=flow_control)
    if protocol == "all_to_all":
        return C.all_to_all_generators(n, flow_control=flow_control)
    if protocol == "all_to_all_bruck":
        # non-power-of-two n raises inside the generator factory — the
        # loud refusal the "no silent caps" satellite demands
        return C.all_to_all_generators(n, variant="bruck",
                                       flow_control=flow_control)
    if protocol == "all_to_all_pod":
        if n % slices:
            raise ValueError(
                f"all_to_all_pod needs n divisible by slices, got "
                f"n={n} slices={slices}"
            )
        return C.all_to_all_pod_generators(slices, n // slices,
                                           flow_control=flow_control)
    if protocol == "all_reduce_quantized":
        if n % slices:
            raise ValueError(
                f"all_reduce_quantized needs n divisible by slices, "
                f"got n={n} slices={slices}"
            )
        # symbolic-safe identity codec: the wire codec is caller
        # policy applied to opaque values and the structure does not
        # depend on it — the double-trace proves exactly that
        per_slice = n // slices
        return [
            C.all_reduce_quantized_rank(
                g, slices, per_slice,
                [frozenset([(g, c)]) for c in range(per_slice)],
                lambda a, b: a | b, flow_control=flow_control,
            )
            for g in range(n)
        ]
    if protocol == "all_reduce_sparse":
        return [
            C.all_reduce_sparse_rank(r, n, ("bundle", r),
                                     lambda bs: bs,
                                     flow_control=flow_control)
            for r in range(n)
        ]
    raise ValueError(
        f"unknown protocol {protocol!r}; known: {_registered()}"
    )


#: The shapes ``lint_all`` (and the CLI's ``smi-tpu lint``) verifies per
#: protocol — small enough to be instant, varied enough to cover the
#: degenerate (n=2) and odd cases the protocols special-case.
DEFAULT_SHAPES: Dict[str, Tuple[Dict[str, int], ...]] = {
    "all_gather": ({"n": 2}, {"n": 3}, {"n": 5}),
    "all_reduce": ({"n": 2}, {"n": 3}, {"n": 5}),
    "reduce_scatter": ({"n": 2}, {"n": 3}, {"n": 5}),
    "neighbour_stream": (
        {"n": 2, "chunks": 3}, {"n": 4, "chunks": 5},
    ),
    "all_reduce_chunked": (
        {"n": 2, "chunks": 2}, {"n": 3, "chunks": 3},
    ),
    "allreduce_pod": (
        {"n": 4, "slices": 2}, {"n": 6, "slices": 2},
        {"n": 6, "slices": 3},
    ),
    "all_to_all": ({"n": 2}, {"n": 3}, {"n": 5}),
    # Bruck is power-of-two only (loud otherwise), so its grid is too
    "all_to_all_bruck": ({"n": 2}, {"n": 4}, {"n": 8}),
    "all_to_all_pod": (
        {"n": 4, "slices": 2}, {"n": 6, "slices": 2},
        {"n": 6, "slices": 3},
    ),
    # the compressed-wire family (r19): the quantized composition over
    # the pod grid, the sparse gather over the ring grid
    "all_reduce_quantized": (
        {"n": 4, "slices": 2}, {"n": 6, "slices": 2},
        {"n": 6, "slices": 3},
    ),
    "all_reduce_sparse": ({"n": 2}, {"n": 3}, {"n": 5}),
}


def verify_protocol(protocol: str, n: int, chunks: int = 3,
                    slices: int = 2) -> StaticReport:
    """Statically verify one registered protocol at one shape."""
    shape: Dict[str, int] = {"n": n}
    if protocol in ("neighbour_stream", "all_reduce_chunked"):
        shape["chunks"] = chunks
    if protocol in ("allreduce_pod", "all_to_all_pod",
                    "all_reduce_quantized"):
        shape["slices"] = slices
    return verify_generators(
        lambda: build_generators(protocol, n, chunks=chunks,
                                 slices=slices),
        protocol=protocol, shape=shape,
    )


def lint_all(
    protocols: Optional[Sequence[str]] = None,
    shapes: Optional[Dict[str, Sequence[Dict[str, int]]]] = None,
) -> List[StaticReport]:
    """Verify every registered protocol (or the named subset) over the
    default shape grid — the ``smi-tpu lint`` engine."""
    known = _registered()
    if protocols is None:
        protocols = known
    else:
        unknown = [p for p in protocols if p not in known]
        if unknown:
            raise ValueError(
                f"unknown protocol(s) {unknown}; known: {list(known)}"
            )
    shapes = dict(DEFAULT_SHAPES, **(shapes or {}))
    reports = []
    for protocol in protocols:
        for shape in shapes[protocol]:
            reports.append(verify_protocol(protocol, **shape))
    return reports


def reports_to_json(reports: Sequence[StaticReport]) -> dict:
    """The ``smi-tpu lint --json`` payload (schema-tested)."""
    return {
        "ok": all(r.ok for r in reports),
        "findings": sum(len(r.findings) for r in reports),
        "checks": list(CHECKS),
        "protocols": [r.to_json() for r in reports],
    }


def render_reports(reports: Sequence[StaticReport]) -> str:
    lines = [r.describe() for r in reports]
    n_findings = sum(len(r.findings) for r in reports)
    lines.append(
        f"{len(reports)} protocol instance(s) verified, "
        f"{n_findings} finding(s)"
    )
    return "\n".join(lines)


def _json_default(o):  # pragma: no cover — debugging convenience
    return str(o)


def dumps(reports: Sequence[StaticReport]) -> str:
    return json.dumps(reports_to_json(reports), indent=2,
                      default=_json_default)
