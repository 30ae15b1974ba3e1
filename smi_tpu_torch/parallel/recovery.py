"""Self-healing collectives: progress logs, shrink/re-route, resume.

PyTorch counterpart of :mod:`smi_tpu.parallel.recovery`, kept in step
with it line for line: the same seed gives the same campaign report,
byte for byte, in both packages. The progress logs write the JAX
package's WAL format through :func:`smi_tpu_torch.parallel.checkpoint.
write_atomic`, so a log written by one package loads in the other.

PR 1 made faults *visible* — every injected fault is tolerated or
raised as a named invariant violation. This module makes them
*survivable*: the four ring protocols become restartable, in the
ULFM shrink-and-continue style production MPI stacks use.

The recovery model is standard write-ahead message logging:

- every rank keeps a :class:`ProgressLog` — a durable, sequence-
  numbered record of its original *contribution* (written before the
  collective starts) and of every chunk it has *delivered* (recorded
  as the protocol outputs it). The log is the WAL: it survives a
  crash-stop of the rank's process even though the rank's in-flight
  protocol state does not.
- on a detected fault (:class:`~credits.DeadlockError` from the
  simulator, a :class:`~smi_tpu_torch.utils.watchdog.WatchdogTimeout` at
  runtime, a ``StalledRank``/``DownLink`` verdict), the runtime
  classifies the failure:

  - **crash-stopped ranks** (named "stalled" in the state dump) are
    *shrunk* out — the surviving ring re-forms in original rank order
    and the dead rank's duties pass to its **heir**, the nearest
    surviving successor, which reads the dead rank's durable log;
  - **down links** are *re-routed* — the logical ring re-forms in an
    order where the dead wire's endpoints are no longer neighbours
    (validated against the routing layer's
    :class:`~smi_tpu_torch.parallel.routing.FailureSet` machinery: the cut
    must leave every surviving pair physically routable). When no such
    order exists (rings of 2 or 3), the higher endpoint is shrunk
    instead — the same decision an operator would make;
  - **everything else** (lost/duplicated credits, in-flight payload
    damage caught by the verified transport) is *transient*: the ring
    retries whole, and the retry replays only what the logs say is
    undelivered.

- the collective then **resumes**: the delivery protocols (all_gather,
  neighbour_stream) replay only the union of chunks some survivor is
  missing, served by each chunk's owner (origin rank, or its heir from
  the durable log) over a recovery ring pass; the reduction protocols
  (all_reduce, reduce_scatter) restart from logged *inputs* — partial
  reduction state is never reused, because replaying a non-idempotent
  combine from a partial double-counts — with dead ranks' inputs folded
  into their heirs' contributions.

The invariant ``tests/test_recovery.py`` enforces: after recovery the
survivors' results are **identical to the fault-free run's** — every
original contribution is accounted for, because contributions are
durably logged before the first packet moves.

The chaos soak harness (:func:`chaos_campaign`) sweeps seeded random
multi-fault plans across all protocols and rank counts; any cell that
ends in silent corruption or fails to recover is delta-debugged down
to a minimal reproducing :class:`~faults.FaultPlan`
(:func:`minimize_plan`) and reported in the campaign JSON — the
JAX package's ``python -m smi_tpu chaos`` subcommand.

Pure Python end to end (no torch import at module load); the runtime
bridge (:func:`failed_ranks_of`, :func:`recover_communicator`) imports
the mesh layer lazily.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.parallel import faults as F

#: Protocols whose resume path is item replay (recovery ring pass of
#: only-undelivered chunks) vs input restart (re-fold logged inputs).
ITEM_PROTOCOLS = ("all_gather", "neighbour_stream")
REDUCE_PROTOCOLS = ("all_reduce", "reduce_scatter")


class UnrecoverableError(RuntimeError):
    """Recovery exhausted its attempts or its survivors.

    Carries the attempt trail so an operator sees every verdict on the
    way down. ``annihilated`` marks the one *expected* unrecoverable
    shape — every rank crash-stopped, nobody left to shrink onto —
    which the chaos campaign books as its own outcome rather than a
    harness failure."""

    def __init__(self, message: str, attempts=None,
                 annihilated: bool = False):
        super().__init__(message)
        self.attempts = attempts or []
        self.annihilated = annihilated


# ---------------------------------------------------------------------------
# Progress logs (the durable WAL)
# ---------------------------------------------------------------------------


class WalCorruptionError(RuntimeError):
    """A progress-log file is damaged beyond its final record.

    A torn *tail* (the last record cut mid-write by a crash) is the
    expected crash shape and is skipped loudly (a ``RuntimeWarning``
    names the file and the dropped record); damage anywhere *before*
    the tail — or a corrupt header — is not a crash artifact and must
    never be silently truncated into a shorter-but-plausible log."""


@dataclasses.dataclass
class ProgressLog:
    """One rank's durable recovery state.

    ``contribution`` is the sequence-0 entry: the rank's original input
    to the collective, written before the first packet moves — which is
    why a crash can never lose a contribution. ``entries`` maps
    globally-unique item keys to delivered payloads, in delivery order
    (``seq`` numbers them). Records are idempotent: replayed deliveries
    of a known key are dropped, so recovery passes may over-deliver
    without corrupting the log.

    :meth:`save`/:meth:`load` persist the log with the repo's shared
    durability discipline (temp file + fsync + atomic rename; one
    CRC-framed record per line), so the WAL survives not just a rank
    crash but a crash *of the writer mid-save*: a reader either sees
    the previous complete file or the new one, and a torn final record
    inside a file (crash between write and rename on filesystems that
    reorder) is skipped loudly, never parsed as garbage.
    """

    rank: int
    contribution: object = None
    entries: Dict = dataclasses.field(default_factory=dict)
    #: Records dropped by :meth:`load` as a torn tail (0 on a clean
    #: load) — the loud part of "skipped loudly".
    torn_records: int = dataclasses.field(default=0, compare=False)

    @property
    def seq(self) -> int:
        """Next sequence number = deliveries so far. The per-entry
        sequence is the insertion order of ``entries`` (dicts preserve
        it): entry N of ``iter(entries)`` was the Nth delivery."""
        return len(self.entries)

    def record(self, key, payload) -> bool:
        if key in self.entries:
            return False
        self.entries[key] = payload
        return True

    def missing(self, expected_keys) -> Set:
        return {k for k in expected_keys if k not in self.entries}

    def void_deliveries(self) -> int:
        """Forget every delivered entry while keeping the durable
        contribution — the input-restart discipline of the reduction
        protocols applied to a failed-over stream: deliveries consumed
        by a dead destination died with its consumer state, so the
        heir's replay must restart from the contribution, never from
        partial delivery records. Returns the number voided (the
        serving front-end books them as replayed chunks)."""
        voided = len(self.entries)
        self.entries.clear()
        return voided

    # -- durability -----------------------------------------------------

    @staticmethod
    def _frame(seq: int, obj) -> str:
        import base64
        import pickle
        import zlib

        blob = base64.b64encode(pickle.dumps(obj)).decode("ascii")
        crc = zlib.crc32(f"{seq}:{blob}".encode()) & 0xFFFFFFFF
        return f"{seq} {crc:08x} {blob}"

    @staticmethod
    def _unframe(line: str):
        """Decode one framed record; raises ``ValueError`` on any
        damage (truncation, bit rot, wrong sequence text)."""
        import base64
        import pickle
        import zlib

        seq_s, crc_s, blob = line.split(" ", 2)
        seq = int(seq_s)
        want = int(crc_s, 16)
        got = zlib.crc32(f"{seq}:{blob}".encode()) & 0xFFFFFFFF
        if want != got:
            raise ValueError(
                f"record {seq}: crc {got:#010x} != framed {want:#010x}"
            )
        return seq, pickle.loads(base64.b64decode(blob))

    def save(self, path: str) -> str:
        """Persist the WAL atomically (temp + fsync + rename)."""
        from smi_tpu_torch.parallel.checkpoint import write_atomic

        lines = [f"smi-tpu-wal v1 rank {self.rank}"]
        lines.append(self._frame(0, ("contribution", self.contribution)))
        for i, (key, payload) in enumerate(self.entries.items()):
            lines.append(self._frame(i + 1, ("entry", key, payload)))
        write_atomic(path, ("\n".join(lines) + "\n").encode())
        return path

    @classmethod
    def load(cls, path: str) -> "ProgressLog":
        """Load a WAL, skipping a torn final record loudly.

        A record that fails its CRC (or will not parse at all) ends the
        log: if it is the *last* record in the file it is the torn tail
        of an interrupted append — dropped with a ``RuntimeWarning``
        naming the file and counted in ``torn_records``; anything
        damaged before the tail raises :class:`WalCorruptionError`.
        """
        import warnings

        with open(path) as f:
            raw = f.read().split("\n")
        lines = [l for l in raw if l]
        if not lines or not lines[0].startswith("smi-tpu-wal v1 rank "):
            raise WalCorruptionError(
                f"{path!r} is not a smi-tpu WAL (bad header)"
            )
        try:
            rank = int(lines[0].rsplit(" ", 1)[1])
        except ValueError as e:
            raise WalCorruptionError(
                f"{path!r} header names no rank "
                f"({lines[0]!r}): damaged header"
            ) from e
        records = []
        torn = 0
        for i, line in enumerate(lines[1:]):
            try:
                seq, obj = cls._unframe(line)
                if seq != len(records):
                    raise ValueError(
                        f"sequence skip: expected {len(records)}, "
                        f"got {seq}"
                    )
            except (ValueError, KeyError, EOFError) as e:
                if i == len(lines) - 2:
                    torn = 1
                    warnings.warn(
                        f"progress log {path!r}: final record is torn "
                        f"({e}); dropping it — the WAL prefix of "
                        f"{len(records)} record(s) is intact",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                    break
                raise WalCorruptionError(
                    f"{path!r} record {i} is damaged before the tail "
                    f"({e}); refusing to truncate a WAL mid-file"
                ) from e
            records.append(obj)
        if not records or records[0][0] != "contribution":
            raise WalCorruptionError(
                f"{path!r} is missing its contribution record "
                f"(sequence 0) — the one entry a WAL must never lose"
            )
        log = cls(rank, contribution=records[0][1])
        for obj in records[1:]:
            _tag, key, payload = obj
            log.record(key, payload)
        log.torn_records = torn
        return log


def logged_steps(gen, log: ProgressLog, item_of: Callable):
    """Adapter recording every delivered ``output`` into the progress
    log before it leaves the rank. ``item_of(key, payload)`` maps a
    protocol output to its globally-unique log entry ``(key, payload)``
    — or None to drop it (padding chunks of a resumed stream)."""
    value = None
    while True:
        try:
            action = gen.send(value)
        except StopIteration:
            return
        if action[0] == "output":
            item = item_of(action[1], action[2])
            if item is not None:
                log.record(item[0], item[1])
        value = yield action


# ---------------------------------------------------------------------------
# Protocol item model: inputs, expected results, ownership
# ---------------------------------------------------------------------------


def canonical_inputs(protocol: str, n: int, chunks: int) -> Dict[int, object]:
    """The per-rank contributions the verdict harnesses circulate —
    recovery uses the same payloads so its fault-free results are
    bit-comparable with :mod:`faults`' matrix."""
    if protocol == "all_gather":
        return {r: f"chunk{r}" for r in range(n)}
    if protocol == "all_reduce":
        return {r: frozenset([r]) for r in range(n)}
    if protocol == "reduce_scatter":
        return {r: tuple(frozenset([(r, b)]) for b in range(n))
                for r in range(n)}
    if protocol == "neighbour_stream":
        return {r: tuple((r, c) for c in range(chunks)) for r in range(n)}
    raise ValueError(
        f"unknown protocol {protocol!r}; known: {F.PROTOCOLS}"
    )


def expected_results(protocol: str, n: int,
                     inputs: Dict[int, object],
                     chunks: int) -> Dict[int, Dict]:
    """The fault-free result at every rank, computed analytically —
    the yardstick every recovered run must match exactly."""
    if protocol == "all_gather":
        full = {o: inputs[o] for o in range(n)}
        return {r: dict(full) for r in range(n)}
    if protocol == "all_reduce":
        total = frozenset().union(*inputs.values())
        return {r: {0: total} for r in range(n)}
    if protocol == "reduce_scatter":
        return {
            r: {r: frozenset().union(
                *(inputs[src][r] for src in range(n))
            )}
            for r in range(n)
        }
    if protocol == "neighbour_stream":
        out: Dict[int, Dict] = {}
        for r in range(n):
            up = (r - 1) % n
            out[r] = {(up, c): (up, c) for c in range(chunks)}
        return out
    raise ValueError(f"unknown protocol {protocol!r}")


def _item_of_fn(protocol: str, me_global: int,
                survivors: Optional[Sequence[int]] = None) -> Callable:
    """Output→log-item mapping per protocol (global keys)."""
    if protocol == "all_gather":
        return lambda key, payload: (key, payload)
    if protocol == "neighbour_stream":
        # payload IS (origin, chunk_index): self-keying
        return lambda key, payload: (payload, payload)
    if protocol == "all_reduce":
        return lambda key, payload: (0, payload)
    if protocol == "reduce_scatter":
        # resumed rings are smaller: local output index j maps back to
        # the survivor's global rank
        def rs_item(key, payload):
            g = survivors[key] if survivors is not None else key
            return (g, payload) if g == me_global else None
        return rs_item
    raise ValueError(f"unknown protocol {protocol!r}")


# ---------------------------------------------------------------------------
# Failure classification and ring re-planning
# ---------------------------------------------------------------------------


def failed_ranks_of(error, survivors: Optional[Sequence[int]] = None
                    ) -> Set[int]:
    """Crash-stopped ranks named by a detected failure.

    Reads the per-rank protocol-state dump attached to simulator
    :class:`~credits.DeadlockError`\\ s and runtime
    :class:`~smi_tpu_torch.utils.watchdog.WatchdogTimeout`\\ s (``.state``):
    every rank the dump marks ``"stalled"``. ``survivors`` maps the
    dump's ring-local indices back to global ranks on resumed rings.
    """
    state = getattr(error, "state", None)
    if not isinstance(state, dict):
        return set()
    failed = set()
    for k, v in state.items():
        if isinstance(k, int) and isinstance(v, dict) \
                and v.get("state") == "stalled":
            failed.add(survivors[k] if survivors is not None else k)
    return failed


def _check_cut_routable(n: int, pair: Tuple[int, int],
                        survivors: Sequence[int]) -> None:
    """Validate a ring-wire cut against the routing layer.

    Builds the 1-D ring topology, declares the dead wire as a
    :class:`~routing.FailureSet`, and asserts every surviving pair
    still routes around it — raising
    :class:`~routing.RouteCutError` (naming the cut) when the failure
    isolates someone. This is the \"re-route via the existing
    FailureSet machinery\" step: the logical ring re-order below is
    only legal because the physical torus still connects the
    survivors.
    """
    from smi_tpu_torch.parallel.routing import (
        FailureSet,
        build_routing_context,
        check_all_pairs_routable,
        grid_topology,
    )

    a, b = sorted(pair)
    if (a + 1) % n != b and (b + 1) % n != a:
        return  # not a ring wire of this topology; nothing to check
    topo = grid_topology(1, n)
    # devices are ranked in grid order; the east wire of device a is
    # the a—a+1 ring link (the wrap link is the east wire of n-1)
    dev = topo.devices[a if (a + 1) % n == b else b]
    cut = FailureSet(links=frozenset({(dev, 0)}))
    ctx = build_routing_context(topo, excluded=cut)
    check_all_pairs_routable(
        ctx, [topo.devices[g] for g in survivors]
    )


def plan_ring(survivors: Sequence[int],
              down_pairs: Sequence[Tuple[int, int]],
              n_original: int) -> Tuple[List[int], Set[int]]:
    """Choose the resumed ring order around the dead wires.

    Returns ``(order, extra_shrunk)``: a cyclic order of (a subset of)
    the survivors in which no down pair is adjacent, plus the ranks
    that had to be shrunk because no such order exists (rings of 2 or
    3 cannot separate a pair). The search is a deterministic
    backtracking walk — rank counts here are single digits.
    """
    order = [r for r in survivors]
    pairs = {tuple(sorted(p)) for p in down_pairs
             if p[0] in order and p[1] in order}
    extra: Set[int] = set()
    while True:
        found = _separating_order(order, pairs)
        if found is not None:
            return found, extra
        # no order separates some pair: shrink the higher endpoint of
        # the first (deterministic) unavoidable pair and retry
        victim = max(sorted(pairs)[0])
        extra.add(victim)
        order = [r for r in order if r != victim]
        pairs = {p for p in pairs if victim not in p}
        if not order:
            raise UnrecoverableError(
                "down links shrunk the ring to nothing"
            )


def _separating_order(ranks: List[int],
                      pairs: Set[Tuple[int, int]]) -> Optional[List[int]]:
    """A cyclic order of ``ranks`` with no pair adjacent, preferring
    the original order (identity when nothing is cut); None if no
    order exists."""
    if not pairs:
        return list(ranks)
    n = len(ranks)
    if n == 1:
        return list(ranks)
    if n == 2:
        return None  # both orders make the pair adjacent

    def bad(a, b):
        return tuple(sorted((a, b))) in pairs

    # fix the first element (cyclic symmetry), try permutations in
    # lexicographic order of the original ranking — deterministic
    head, rest = ranks[0], ranks[1:]
    for perm in itertools.permutations(rest):
        order = [head] + list(perm)
        if any(bad(order[i], order[(i + 1) % n]) for i in range(n)):
            continue
        return order
    return None


def heir_of(rank: int, survivors, n: int) -> int:
    """The nearest surviving successor of ``rank`` on the original
    ring — the rank that inherits its duties (and reads its WAL).

    THE inheritance rule: :meth:`Communicator.heirs` delegates here so
    the simulator's recovery and the runtime bridge's shrink map can
    never drift apart.
    """
    survivors = set(survivors)
    for step in range(1, n + 1):
        cand = (rank + step) % n
        if cand in survivors:
            return cand
    raise UnrecoverableError(f"no surviving heir for rank {rank}")


# ---------------------------------------------------------------------------
# Healing a collective: run_with_recovery
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AttemptRecord:
    """What one attempt did and how it ended."""

    ring: Tuple[int, ...]
    verdict: str            # "completed" | "resumed-from-log" | error name
    detail: str = ""
    failed_ranks: Tuple[int, ...] = ()
    replayed_chunks: int = 0
    skipped_chunks: int = 0


@dataclasses.dataclass
class RecoveryOutcome:
    """The end state of a recovered collective."""

    protocol: str
    n: int
    recovered: bool
    survivors: Tuple[int, ...]
    results: Dict[int, Dict]
    expected: Dict[int, Dict]
    attempts: List[AttemptRecord]

    @property
    def ok(self) -> bool:
        """Recovered AND every survivor's result is identical to the
        fault-free run's."""
        return self.recovered and all(
            self.results.get(g) == self.expected[g]
            for g in self.survivors
        )

    @property
    def replayed_chunks(self) -> int:
        """Chunks moved by resume passes (not the first attempt)."""
        return sum(a.replayed_chunks for a in self.attempts[1:])

    @property
    def fault_trail(self) -> List[str]:
        return [a.verdict for a in self.attempts]


def run_with_recovery(
    protocol: str,
    n: int,
    plan: Optional[F.FaultPlan],
    strategy_seed: int = 0,
    chunks: int = 5,
    max_attempts: int = 5,
    followup_plans: Sequence[Optional[F.FaultPlan]] = (),
    membership=None,
    recorder=None,
) -> RecoveryOutcome:
    """Run one ring collective under a fault plan and heal it to
    completion.

    Attempt 1 runs the real protocol over the full ring (verified
    transport + progress logging). Each detected failure is classified
    (shrink / re-route / transient retry, see the module docstring)
    and the collective resumes, replaying only undelivered chunks.
    ``followup_plans[k]`` injects a fresh fault plan into resume
    attempt ``k+2`` (ring-local rank indices) — the double-fault
    torture tests. A resumed run that completes with results different
    from the fault-free run raises :class:`faults.SilentCorruption`;
    exhausting ``max_attempts`` raises :class:`UnrecoverableError`.

    ``membership`` (a
    :class:`~smi_tpu_torch.parallel.membership.MembershipView`) makes
    failure knowledge *proactive* instead of purely error-parsed:
    ranks the phi-accrual detector has already confirmed dead are
    shrunk out **before the first attempt** — the collective never
    even tries the ring that would deadlock — and each later attempt
    re-consults the view, unioning its dead set with whatever the
    raised error's state dump names. The error-parsing path is
    unchanged when no view is given.

    ``recorder`` (duck-typed flight recorder,
    :class:`smi_tpu.obs.events.FlightRecorder`) rides into every
    attempt's simulator — wire-level events — and each recovery
    transition emits a ``ctl.recover`` control-plane event (tick =
    attempt number, reason = the attempt verdict), so a healed run's
    history shows WHY it took the attempts it took.
    """
    inputs = canonical_inputs(protocol, n, chunks)
    expected = expected_results(protocol, n, inputs, chunks)
    logs = {r: ProgressLog(r, contribution=inputs[r]) for r in range(n)}
    survivors: List[int] = list(range(n))
    down_pairs: Set[Tuple[int, int]] = set()
    attempts: List[AttemptRecord] = []
    current_plan: Optional[F.FaultPlan] = plan
    followups = list(followup_plans)

    pre_shrunk = False
    for attempt in range(max_attempts):
        first = attempt == 0
        if membership is not None:
            known_dead = {
                r for r in survivors if r in membership.dead
            }
            if known_dead:
                pre_shrunk = pre_shrunk or first
                survivors = [
                    r for r in survivors if r not in known_dead
                ]
                if not survivors:
                    raise UnrecoverableError(
                        f"{protocol}: membership confirmed every rank "
                        f"dead", attempts, annihilated=True,
                    )
                attempts.append(AttemptRecord(
                    ring=tuple(survivors),
                    verdict="membership-shrink",
                    detail=(
                        f"detector confirmed {sorted(known_dead)} dead "
                        f"before any attempt"
                        if first else
                        f"detector confirmed {sorted(known_dead)} dead"
                    ),
                    failed_ranks=tuple(sorted(known_dead)),
                ))
        # a membership pre-shrink makes even attempt 1 a RESUME pass:
        # the dead ranks' logged contributions must be served by their
        # heirs, which the fresh-run construction does not do
        fresh = first and not pre_shrunk
        ring, extra = plan_ring(survivors, down_pairs, n)
        if extra:
            survivors = [r for r in survivors if r not in extra]
            ring = [r for r in ring if r not in extra]
        total = sum(len(expected[g]) for g in survivors)
        done = total - sum(
            len(logs[g].missing(expected[g])) for g in survivors
        )
        if not fresh and done == total:
            # resume after the last chunk: every survivor's log is
            # already complete — nothing to replay, no network pass
            attempts.append(AttemptRecord(
                ring=tuple(ring), verdict="resumed-from-log",
                detail="all chunks already delivered",
                replayed_chunks=0, skipped_chunks=done,
            ))
            break
        if len(ring) == 1:
            _assemble_single(protocol, ring[0], logs, expected, n)
            attempts.append(AttemptRecord(
                ring=tuple(ring), verdict="completed",
                detail="single survivor: assembled locally from WALs",
                replayed_chunks=len(expected[ring[0]]),
                skipped_chunks=done,
            ))
            break
        gens, moved = _build_attempt(
            protocol, ring, survivors, logs, inputs, expected,
            n, chunks, fresh,
        )
        entries_before = sum(len(logs[g].entries) for g in survivors)
        # keep known-dead wires enforced in resumed attempts (mapped
        # to the ring's local indices): a buggy re-route then fails
        # loudly as a deadlock instead of silently using a dead link
        effective_plan = current_plan
        if down_pairs and not fresh:
            local = frozenset(
                (ring.index(a), ring.index(b))
                for a, b in down_pairs if a in ring and b in ring
            )
            if local:
                base = current_plan if current_plan is not None \
                    else F.FaultPlan()
                effective_plan = dataclasses.replace(
                    base, down_links=frozenset(base.down_links) | local
                )
        try:
            C.RingSimulator(
                gens, C.Strategy(strategy_seed + attempt),
                faults=effective_plan, recorder=recorder,
            ).run()
        except F.DETECTED_ERRORS as e:
            failed = failed_ranks_of(e, ring)
            # `fresh`, not `first`: the simulator applies plan indices
            # to ring-local slots, and after a membership pre-shrink
            # attempt 1's ring is already a subset — booking the
            # local pair as global would blame the wrong wire
            newly_down = _down_pairs_of(current_plan, ring, fresh)
            # a failed attempt books only what it actually DELIVERED
            # before the fault (the log delta), never its planned
            # replay size — the retry re-moves the rest and would
            # otherwise double-count
            delivered = sum(
                len(logs[g].entries) for g in survivors
            ) - entries_before
            attempts.append(AttemptRecord(
                ring=tuple(ring), verdict=type(e).__name__,
                detail=str(e).splitlines()[0],
                failed_ranks=tuple(sorted(failed)),
                replayed_chunks=0 if fresh else delivered,
            ))
            if recorder is not None:
                recorder.emit(
                    "ctl.recover", attempt, protocol=protocol,
                    reason=type(e).__name__,
                    failed=str(sorted(failed)),
                )
            if failed:
                survivors = [r for r in survivors if r not in failed]
                if not survivors:
                    raise UnrecoverableError(
                        f"{protocol}: every rank crash-stopped",
                        attempts, annihilated=True,
                    )
            if newly_down:
                for pair in newly_down:
                    _check_cut_routable(n, pair, survivors)
                down_pairs |= newly_down
            # transient faults are consumed by the retry; permanent
            # topology damage now lives in survivors/down_pairs
            current_plan = followups.pop(0) if followups else None
            continue
        attempts.append(AttemptRecord(
            ring=tuple(ring), verdict="completed",
            detail="" if fresh else "resume pass",
            replayed_chunks=0 if fresh else moved,
            skipped_chunks=0 if fresh else done,
        ))
        if recorder is not None and not fresh:
            recorder.emit("ctl.recover", attempt, protocol=protocol,
                          reason="resume-completed")
        break
    else:
        raise UnrecoverableError(
            f"{protocol} n={n}: no clean attempt within "
            f"{max_attempts} tries", attempts,
        )

    results = {
        g: {k: logs[g].entries[k] for k in expected[g]
            if k in logs[g].entries}
        for g in survivors
    }
    outcome = RecoveryOutcome(
        protocol=protocol, n=n,
        recovered=True,
        survivors=tuple(survivors),
        results=results, expected=expected, attempts=attempts,
    )
    if not outcome.ok:
        raise F.SilentCorruption(
            f"{protocol} n={n}: recovery completed with wrong results "
            f"under {plan!r}: trail {outcome.fault_trail}"
        )
    return outcome


def _down_pairs_of(plan: Optional[F.FaultPlan], ring: Sequence[int],
                   first: bool) -> Set[Tuple[int, int]]:
    """Global down pairs a plan declares (attempt-1 plans are global;
    follow-up plans index the resumed ring)."""
    if plan is None:
        return set()
    pairs = set()
    for a, b in plan.down_links:
        if first:
            pairs.add(tuple(sorted((a, b))))
        else:
            pairs.add(tuple(sorted((ring[a % len(ring)],
                                    ring[b % len(ring)]))))
    return pairs


# ---------------------------------------------------------------------------
# Attempt construction: first run + resume passes
# ---------------------------------------------------------------------------


def _owners(survivors: Sequence[int], n: int) -> Dict[int, int]:
    """origin rank -> surviving executor (itself, or its heir)."""
    return {
        o: (o if o in survivors else heir_of(o, survivors, n))
        for o in range(n)
    }


def _wrap(gen, me_local: int, log: ProgressLog, item_of: Callable):
    """Framing outside, logging inside: outputs are logged in
    delivered (unwrapped) form, payloads framed on the wire."""
    return C.verified_steps(logged_steps(gen, log, item_of), me_local)


def _build_attempt(protocol, ring, survivors, logs, inputs, expected,
                   n, chunks, first):
    """Generators for one attempt and the number of chunks it moves.

    First attempt: the genuine protocol over the full ring. Resume
    attempts: delivery protocols run a recovery ring pass carrying
    only the union of undelivered items (each served by its owner);
    reduction protocols restart from logged inputs with dead ranks'
    contributions folded into their heirs'.
    """
    if first:
        if protocol == "all_gather":
            gens = [
                _wrap(C.all_gather_rank(j, len(ring), inputs[g]),
                      j, logs[g], _item_of_fn(protocol, g))
                for j, g in enumerate(ring)
            ]
            return gens, n * n
        if protocol == "neighbour_stream":
            gens = [
                _wrap(C.neighbour_stream_rank(j, len(ring),
                                              list(inputs[g])),
                      j, logs[g], _item_of_fn(protocol, g))
                for j, g in enumerate(ring)
            ]
            return gens, n * chunks
        if protocol == "all_reduce":
            gens = [
                _wrap(C.all_reduce_rank(j, len(ring), inputs[g],
                                        lambda a, b: a | b),
                      j, logs[g], _item_of_fn(protocol, g))
                for j, g in enumerate(ring)
            ]
            return gens, n
        if protocol == "reduce_scatter":
            gens = [
                _wrap(C.reduce_scatter_rank(j, len(ring),
                                            list(inputs[g]),
                                            lambda a, b: a | b),
                      j, logs[g], _item_of_fn(protocol, g))
                for j, g in enumerate(ring)
            ]
            return gens, n * n
        raise ValueError(f"unknown protocol {protocol!r}")

    owners = _owners(survivors, n)
    if protocol in ITEM_PROTOCOLS:
        # union of items some survivor is still missing, each served
        # once by its origin's executor over a recovery all_gather
        union = frozenset().union(
            *(logs[g].missing(expected[g]) for g in survivors)
        ) if survivors else frozenset()
        bundles = {g: [] for g in survivors}
        for key in sorted(union, key=repr):
            origin = key if protocol == "all_gather" else key[0]
            payload = (inputs[origin] if protocol == "all_gather"
                       else key)
            bundles[owners[origin]].append((key, payload))

        def bundle_item(me_global):
            def item(_key, bundle):
                for k, p in bundle:
                    logs[me_global].record(k, p)
                return None  # recorded inline; nothing else to log
            return item

        gens = [
            _wrap(C.all_gather_rank(j, len(ring),
                                    tuple(bundles[g])),
                  j, logs[g], bundle_item(g))
            for j, g in enumerate(ring)
        ]
        return gens, len(union)

    # reduction protocols: restart from durable inputs, heirs fold the
    # dead ranks' logged contributions into their own
    folded: Dict[int, object] = {}
    for o in range(n):
        executor = owners[o]
        contribution = logs[o].contribution
        if protocol == "all_reduce":
            prev = folded.get(executor, frozenset())
            folded[executor] = prev | contribution
        else:  # reduce_scatter: fold per-destination blocks
            prev = folded.get(
                executor, tuple(frozenset() for _ in range(n))
            )
            folded[executor] = tuple(
                p | b for p, b in zip(prev, contribution)
            )
    if protocol == "all_reduce":
        gens = [
            _wrap(C.all_reduce_rank(j, len(ring), folded[g],
                                    lambda a, b: a | b),
                  j, logs[g], _item_of_fn(protocol, g))
            for j, g in enumerate(ring)
        ]
        return gens, len(ring)
    # reduce_scatter over the resumed ring: local block k targets the
    # survivor at ring position k (dead destinations need no output)
    gens = []
    for j, g in enumerate(ring):
        blocks = [folded[g][ring[k]] for k in range(len(ring))]
        gens.append(
            _wrap(C.reduce_scatter_rank(j, len(ring), blocks,
                                        lambda a, b: a | b),
                  j, logs[g], _item_of_fn(protocol, g, survivors=ring))
        )
    return gens, len(ring)


def _assemble_single(protocol, g, logs, expected, n):
    """A ring of one: every origin's executor is the lone survivor, so
    the result assembles locally from the durable WALs — the deepest
    shrink the model supports."""
    if protocol == "all_gather":
        for o in range(n):
            logs[g].record(o, logs[o].contribution)
    elif protocol == "neighbour_stream":
        for key in logs[g].missing(expected[g]):
            logs[g].record(key, key)
    elif protocol == "all_reduce":
        total = frozenset().union(
            *(logs[o].contribution for o in range(n))
        )
        logs[g].record(0, total)
    elif protocol == "reduce_scatter":
        block = frozenset().union(
            *(logs[o].contribution[g] for o in range(n))
        )
        logs[g].record(g, block)
    else:
        raise ValueError(f"unknown protocol {protocol!r}")


# ---------------------------------------------------------------------------
# Runtime bridge: shrink a live communicator after a detected failure
# ---------------------------------------------------------------------------


def recover_communicator(comm, error_or_ranks):
    """ULFM shrink for the runtime layer: build the surviving
    communicator after a detected failure.

    ``error_or_ranks`` is either an iterable of failed global ranks or
    a caught error carrying a per-rank state dump
    (:class:`~credits.DeadlockError`,
    :class:`~smi_tpu_torch.utils.watchdog.WatchdogTimeout`) — the stalled
    ranks are extracted with :func:`failed_ranks_of`. Returns
    ``(shrunk_comm, heirs)`` where ``heirs`` maps each failed rank to
    the survivor inheriting its duties (its progress log, its logged
    contribution — :meth:`Communicator.heirs`). Raises ``ValueError``
    when the failure names no ranks (nothing actionable to shrink) —
    a transient fault should be retried, not shrunk.
    """
    if isinstance(error_or_ranks, BaseException):
        failed = failed_ranks_of(error_or_ranks)
    else:
        failed = set(error_or_ranks)
    if not failed:
        raise ValueError(
            "failure names no crash-stopped ranks; retry the "
            "collective instead of shrinking"
        )
    return comm.shrink(failed), comm.heirs(failed)


# ---------------------------------------------------------------------------
# Chaos soak: seeded campaigns + delta-debugged reproducers
# ---------------------------------------------------------------------------


def random_chaos_plan(n: int, seed: int, max_faults: int = 2,
                      classes: Sequence[str] = F.FAULT_CLASSES
                      ) -> F.FaultPlan:
    """A deterministic multi-fault plan: 1..max_faults random faults
    drawn (with class repetition allowed) from ``classes``."""
    rng = random.Random(f"chaos:{n}:{seed}:{max_faults}")
    count = rng.randint(1, max_faults)
    parts = []
    for k in range(count):
        cls = classes[rng.randrange(len(classes))]
        parts.extend(
            F.FaultPlan.random(cls, n, rng.randrange(1 << 30)).faults()
        )
    return F.FaultPlan.of(parts)


def _run_cell(protocol: str, n: int, plan: F.FaultPlan,
              strategy_seed: int, chunks: int = 4
              ) -> Tuple[Optional[RecoveryOutcome], Optional[str]]:
    """One chaos cell: (outcome, None) when it heals clean, else
    (None, one-line reason)."""
    try:
        outcome = run_with_recovery(
            protocol, n, plan, strategy_seed=strategy_seed,
            chunks=chunks,
        )
    except F.SilentCorruption as e:
        return None, f"SilentCorruption: {e}"
    except UnrecoverableError as e:
        if e.annihilated:
            return None, "annihilated"
        return None, f"UnrecoverableError: {e}"
    except Exception as e:  # anything unclassified is a harness bug
        return None, f"{type(e).__name__}: {e}"
    if not outcome.ok:
        return None, "completed with wrong results"
    return outcome, None


def cell_fails(protocol: str, n: int, plan: F.FaultPlan,
               strategy_seed: int, chunks: int = 4) -> Optional[str]:
    """The chaos failure predicate: None when the cell heals clean,
    else a one-line reason (the delta-debugger minimizes against
    this)."""
    return _run_cell(protocol, n, plan, strategy_seed, chunks)[1]


def minimize_plan(plan: F.FaultPlan,
                  fails: Callable[[F.FaultPlan], object]
                  ) -> F.FaultPlan:
    """Delta-debug a failing plan down to a minimal reproducer.

    Greedy ddmin over individual faults: repeatedly drop any fault
    whose removal keeps ``fails`` truthy, until the plan is 1-minimal
    (every remaining fault is necessary). Deterministic — the
    predicate must be (and :func:`cell_fails` is, per seed).
    """
    faults = list(plan.faults())
    changed = True
    while changed and len(faults) > 1:
        changed = False
        for i in range(len(faults)):
            candidate = faults[:i] + faults[i + 1:]
            if fails(F.FaultPlan.of(candidate)):
                faults = candidate
                changed = True
                break
    return F.FaultPlan.of(faults)


def chaos_campaign(
    seed: int,
    protocols: Sequence[str] = F.PROTOCOLS,
    ns: Sequence[int] = (2, 3, 4, 5),
    trials: int = 3,
    max_faults: int = 2,
    chunks: int = 4,
) -> Dict:
    """Run a seeded randomized fault campaign over every protocol and
    ring size; delta-debug any failing cell to a minimal reproducer.

    Returns the JSON-able campaign report: per-outcome histogram, the
    failures with their minimized plans, and ``ok`` /
    ``silent_corruptions`` for the CLI's exit code. Deterministic per
    ``seed`` — a red campaign reproduces from its report alone.
    """
    outcomes: Dict[str, int] = {}
    failures: List[Dict] = []
    cells = 0
    replayed_total = 0
    for protocol in protocols:
        for n in ns:
            for trial in range(trials):
                cells += 1
                # cross-process deterministic (never hash(): PYTHONHASHSEED)
                cell_seed = random.Random(
                    f"{seed}:{protocol}:{n}:{trial}"
                ).randrange(1 << 31)
                plan = random_chaos_plan(n, cell_seed,
                                         max_faults=max_faults)
                outcome, reason = _run_cell(protocol, n, plan,
                                            cell_seed, chunks)
                if reason is None:
                    key = ("healed" if len(outcome.attempts) > 1
                           else "tolerated")
                    outcomes[key] = outcomes.get(key, 0) + 1
                    replayed_total += outcome.replayed_chunks
                    continue
                if reason == "annihilated":
                    # every rank crash-stopped: a NAMED end state with
                    # nobody left to recover onto, not a harness bug
                    outcomes["annihilated"] = (
                        outcomes.get("annihilated", 0) + 1
                    )
                    continue
                outcomes["failed"] = outcomes.get("failed", 0) + 1
                minimal = minimize_plan(
                    plan,
                    lambda p: cell_fails(protocol, n, p, cell_seed,
                                         chunks)
                    not in (None, "annihilated"),
                )
                failures.append({
                    "protocol": protocol, "n": n, "trial": trial,
                    "cell_seed": cell_seed, "reason": reason,
                    "plan": plan.describe(),
                    "minimal_plan": minimal.describe(),
                })
    silent = sum(
        1 for f in failures if f["reason"].startswith("SilentCorruption")
    )
    return {
        "seed": seed,
        "protocols": list(protocols),
        "ns": list(ns),
        "trials": trials,
        "max_faults": max_faults,
        "cells": cells,
        "outcomes": outcomes,
        "replayed_chunks": replayed_total,
        "failures": failures,
        "silent_corruptions": silent,
        "ok": not failures,
    }
