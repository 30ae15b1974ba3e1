"""Elastic membership: phi-accrual failure detection, epochs, regrow.

PyTorch counterpart of :mod:`smi_tpu.parallel.membership`, kept in step
with it line for line: the detector, the views and the soaks are host
tools (pure Python, and numpy float64 for the soak's data plane), and
the same seed gives the same report, byte for byte, in both packages.
The ring and pod planners and :meth:`MembershipView.failure_set` need
``networkx`` (through :mod:`smi_tpu_torch.parallel.routing`), imported
only where they run.

PR 1/2 recover *reactively*: a rank is declared dead only when some
operation deadlocks on it (simulator :class:`~credits.DeadlockError`)
or a watchdog budget expires — by which point every survivor has
already burned a full timeout, and the only way forward is to shrink.
This module adds the two standard production pieces on top
(PAPERS.md):

- a **phi-accrual failure detector** (Hayashibara et al., SRDS'04):
  every rank heartbeats on a deterministic step clock; the detector
  keeps a sliding window of inter-arrival times per rank and computes
  ``phi = -log10(P(a heartbeat this late is still coming))`` under a
  normal model of the window. ``phi`` is a *suspicion level*, not a
  binary verdict: crossing :data:`SUSPECT_PHI` emits
  :class:`SuspectRank` (drain new work away from the rank, keep it in
  the ring), crossing :data:`DEAD_PHI` emits :class:`ConfirmedDead`
  (feed :class:`~smi_tpu_torch.parallel.routing.FailureSet`/recovery and
  shrink) — *before* any watchdog fires, because the detector's
  evidence accrues continuously instead of waiting out one fixed
  budget. A heartbeat from a suspected rank clears the suspicion
  (:class:`SuspicionCleared`): a rank that is alive-but-silent
  (:class:`~smi_tpu_torch.parallel.faults.StalledHeartbeat`) is suspected,
  never killed.
- **epoch-numbered membership** with *regrow* — the inverse of
  :meth:`Communicator.shrink`: a recovered rank re-admits under a new
  epoch and a new incarnation number, the ring re-plans via the
  existing :func:`~smi_tpu_torch.parallel.recovery.plan_ring` /
  :func:`~smi_tpu_torch.parallel.routing.grid_topology` machinery, and any
  traffic still tagged with an old epoch raises
  :class:`StaleEpochError` naming the sender, its stale epoch, and the
  current one — the dead incarnation's packets can never be silently
  folded into the regrown job.

Everything here is pure Python and clock-deterministic (the step clock
is the credits simulator's event count, never wall time), so the
elastic kill→detect→shrink→restore→regrow soak
(:func:`run_elastic_cell` / :func:`elastic_campaign`, the
JAX package's ``smi-tpu chaos --elastic``) replays bit-identically per seed.
The runtime bridge — :meth:`Communicator.regrow` — lives in
:mod:`smi_tpu_torch.parallel.mesh` and delegates its ring validation here.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from smi_tpu_torch.parallel import faults as F

#: Detector thresholds (phi is -log10 of the probability the heartbeat
#: is merely late): suspect at phi >= 4 — a 1-in-10^4 late arrival —
#: and confirm dead at phi >= 8. docs/robustness.md quotes both
#: (drift-guarded by tests/test_perf_docs.py).
SUSPECT_PHI = 4.0
DEAD_PHI = 8.0

#: Nominal heartbeat period in step-clock ticks; the elastic soak
#: advances the clock by one period per job iteration.
HEARTBEAT_INTERVAL = 10

#: Confirmation grace: a suspect is only confirmed dead once it has
#: stayed suspected (phi never dipping below the suspect threshold)
#: for four full heartbeat periods. Suspicion is cheap and reversible
#: (drain new work); death is not (shrink + restore) — the grace is
#: what lets an alive-but-silent rank (``StalledHeartbeat``) be
#: suspected and cleared without ever being killed, while a genuine
#: crash still confirms within ~5-6 periods, far inside any watchdog
#: budget. Four periods, not two: the observable silence of a silent-
#: but-alive rank is its *window* plus up to one period of phase on
#: each side (the last heartbeat before the window and the first
#: scheduled one after it), so the grace must absorb ~2 periods of
#: phase beyond the calibrated window or a healthy rank's clearing
#: beat can lose the race to the confirm poll.
CONFIRM_GRACE_TICKS = 4 * HEARTBEAT_INTERVAL

#: Sliding window of inter-arrival samples per rank.
WINDOW = 32

#: Variance floor (ticks). A perfectly regular simulated heartbeat has
#: zero sample variance; the floor keeps phi finite and calibrated:
#: with mean ~10 and sigma 1, phi crosses the suspect threshold about
#: 4 ticks after a heartbeat was due.
MIN_STD = 1.0


class StaleEpochError(RuntimeError):
    """Traffic tagged with a mismatched membership epoch.

    Raised loudly at the first validation point — never silently
    dropped, never folded into the current epoch's state. Carries the
    sending ``rank``, the ``stale`` epoch it claimed, and the
    ``current`` epoch of the validating view. The wording names the
    party at fault: an OLDER tag means the sender is a superseded
    incarnation (re-join via regrow); a NEWER tag means the
    *validator* missed a membership change (split view) — sending the
    operator to regrow the healthy side would be exactly backwards.
    """

    def __init__(self, rank: int, stale: int, current: int,
                 what: str = "message"):
        if stale > current:
            msg = (
                f"future-epoch {what} from rank {rank}: tagged epoch "
                f"{stale} but this view is at epoch {current} — split "
                f"view: the RECEIVER missed a membership change and "
                f"must resynchronize before trusting its own epoch"
            )
        else:
            msg = (
                f"stale-epoch {what} from rank {rank}: tagged epoch "
                f"{stale} but membership is at epoch {current} — the "
                f"sender is a superseded incarnation and must re-join "
                f"via regrow()"
            )
        super().__init__(msg)
        self.rank = rank
        self.stale = stale
        self.current = current


#: Environment knob for the quorum fraction (the ``default_deadline``
#: discipline: explicit argument outranks the environment, the
#: environment outranks the built-in, malformed values raise loudly).
#: A fraction ``f`` means an actuation needs strictly MORE than ``f``
#: of the members reachable — ``floor(f*n) + 1`` ranks — so the
#: built-in 0.5 is the strict majority and no two disjoint quorums can
#: ever coexist (any valid f >= 0.5 keeps that intersection property,
#: which is the whole point: two sides of a partition can never both
#: fence an actuation in the same epoch).
QUORUM_FRACTION_ENV = "SMI_TPU_QUORUM_FRACTION"

#: Built-in quorum fraction: strict majority.
DEFAULT_QUORUM_FRACTION = 0.5


def quorum_fraction(explicit: Optional[float] = None) -> float:
    """Resolve the quorum fraction: explicit argument over
    ``$SMI_TPU_QUORUM_FRACTION`` over the built-in strict majority.
    Malformed or out-of-range values raise ``ValueError`` loudly —
    a silently-defaulted quorum is a silently-broken safety rail."""
    raw: object = explicit
    source = "quorum fraction"
    if raw is None:
        env = os.environ.get(QUORUM_FRACTION_ENV, "").strip()
        if not env:
            return DEFAULT_QUORUM_FRACTION
        raw = env
        source = f"${QUORUM_FRACTION_ENV}"
    try:
        value = float(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{source} must be a number in [0.5, 1.0), got {raw!r}"
        ) from None
    if not math.isfinite(value):
        raise ValueError(
            f"{source} must be finite, got {value!r}"
        )
    if not 0.5 <= value < 1.0:
        raise ValueError(
            f"{source} must be in [0.5, 1.0) (below 0.5 two disjoint "
            f"quorums could coexist — the split-brain the fence "
            f"exists to prevent; 1.0 would need n+1 of n ranks), "
            f"got {value!r}"
        )
    return value


def quorum_size(n: int, fraction: Optional[float] = None) -> int:
    """Ranks needed to fence an actuation over an ``n``-member view:
    strictly more than the resolved fraction of the members."""
    if n < 1:
        raise ValueError(f"quorum over an empty view is meaningless, n={n}")
    return int(math.floor(quorum_fraction(fraction) * n)) + 1


class QuorumLostError(RuntimeError):
    """An actuation was attempted from a side of the view that cannot
    reach a quorum of the members — the minority side of a partition.

    Raised loudly at the fencing point, never deferred: the minority
    must PARK (stop accepting new streams, stop mutating shared state)
    and rejoin via the :class:`StaleEpochError` straggler rail once
    the partition heals. Carries the acting ``rank`` (or -1 for the
    control plane itself), the ``reachable`` member set the actor
    could muster, and the ``needed`` quorum size.
    """

    def __init__(self, rank: int, reachable, needed: int,
                 what: str = "actuation"):
        reachable = frozenset(reachable)
        super().__init__(
            f"quorum lost for {what}: rank {rank} reaches only "
            f"{sorted(reachable)} ({len(reachable)} of the {needed} "
            f"needed) — minority side of a partition must park, not "
            f"actuate"
        )
        self.rank = rank
        self.reachable = reachable
        self.needed = needed


@dataclasses.dataclass(frozen=True)
class FencingToken:
    """Proof-of-quorum an actuator must present before mutating shared
    state (epoch bumps, scale in/out, migration cutover, placement
    writes).

    Minted by :func:`mint_fencing_token` only when the minter reaches
    a quorum of the current members, and pinned to the epoch it was
    minted under: a token outlives its epoch the moment membership
    moves, so a partitioned minority holding a stale token is rejected
    on the SAME :class:`StaleEpochError` rail a superseded incarnation
    is — fencing is epoch discipline, not a second mechanism.
    """

    epoch: int
    quorum_set: FrozenSet[int]


@dataclasses.dataclass(frozen=True)
class QuorumDecision:
    """Structured record of one fencing decision — the ``ctl.quorum``
    event's payload (epoch, quorum set, verdict), so Perfetto traces
    and the flight recorder show WHY an actuation was allowed or
    refused next to the blame verdicts that motivated it."""

    epoch: int
    quorum: Tuple[int, ...]
    verdict: str  # "minted" | "granted" | "denied" | "stale"

    def as_fields(self) -> Dict[str, object]:
        return {
            "epoch": self.epoch,
            "quorum": ",".join(str(r) for r in self.quorum),
            "verdict": self.verdict,
        }


def _observe_quorum(view: "MembershipView", decision: QuorumDecision,
                    rank: int) -> None:
    recorder = getattr(view, "_recorder", None)
    if recorder is not None:
        recorder.emit("ctl.quorum", view.epoch, rank=rank,
                      **decision.as_fields())


def mint_fencing_token(view: "MembershipView",
                       reachable: Optional[Sequence[int]] = None,
                       fraction: Optional[float] = None,
                       rank: int = -1,
                       what: str = "actuation") -> FencingToken:
    """Mint a :class:`FencingToken` for the current epoch, or raise
    :class:`QuorumLostError` if ``reachable`` (the members the minter
    can currently hear; default: all of them — the healthy fast path)
    falls short of the quorum. Every decision — grant or denial — is
    observed as a ``ctl.quorum`` event when the view has a recorder.
    """
    members = frozenset(view.members)
    if reachable is None:
        quorum = members
    else:
        quorum = frozenset(reachable) & members
    needed = quorum_size(len(members), fraction)
    if len(quorum) < needed:
        _observe_quorum(
            view, QuorumDecision(view.epoch, tuple(sorted(quorum)),
                                 "denied"), rank,
        )
        raise QuorumLostError(rank, quorum, needed, what=what)
    token = FencingToken(epoch=view.epoch, quorum_set=quorum)
    _observe_quorum(
        view, QuorumDecision(view.epoch, tuple(sorted(quorum)),
                             "minted"), rank,
    )
    return token


def check_fencing_token(view: "MembershipView",
                        token: Optional[FencingToken],
                        rank: int = -1,
                        fraction: Optional[float] = None,
                        what: str = "actuation") -> FencingToken:
    """Validate (or mint, when ``token`` is None — the backward-
    compatible healthy path, trivially quorate over the full member
    set) the fencing token guarding an actuation.

    A token from an older epoch is a straggler from before a
    membership change and is rejected as :class:`StaleEpochError` —
    the same rail, deliberately. A current-epoch token whose quorum
    set no longer covers a quorum of the members (possible only if
    the caller forged or filtered it) raises
    :class:`QuorumLostError`. Returns the validated token."""
    if token is None:
        return mint_fencing_token(view, fraction=fraction, rank=rank,
                                  what=what)
    if token.epoch != view.epoch:
        _observe_quorum(
            view, QuorumDecision(token.epoch,
                                 tuple(sorted(token.quorum_set)),
                                 "stale"), rank,
        )
        raise StaleEpochError(rank, token.epoch, view.epoch,
                              what=f"fencing token for {what}")
    members = frozenset(view.members)
    quorum = frozenset(token.quorum_set) & members
    needed = quorum_size(len(members), fraction)
    if len(quorum) < needed:
        _observe_quorum(
            view, QuorumDecision(token.epoch, tuple(sorted(quorum)),
                                 "denied"), rank,
        )
        raise QuorumLostError(rank, quorum, needed, what=what)
    _observe_quorum(
        view, QuorumDecision(token.epoch, tuple(sorted(quorum)),
                             "granted"), rank,
    )
    return token


@dataclasses.dataclass(frozen=True)
class SuspectRank:
    """phi crossed :data:`SUSPECT_PHI`: stop routing new work to the
    rank, keep it in the ring — it may just be slow or silent."""

    rank: int
    phi: float
    step: int


@dataclasses.dataclass(frozen=True)
class SuspicionCleared:
    """A suspected rank heartbeated again: it was alive-but-silent."""

    rank: int
    step: int


@dataclasses.dataclass(frozen=True)
class ConfirmedDead:
    """phi crossed :data:`DEAD_PHI`: treat as crash-stopped — feed the
    FailureSet, shrink, restore. A later heartbeat from this
    incarnation is stale-epoch traffic, not a resurrection."""

    rank: int
    phi: float
    step: int


class StepClock:
    """Deterministic integer clock — the credits simulator's event
    count, never wall time. Everything downstream of it (phi, the
    elastic soak, the campaign reports) replays bit-identically."""

    def __init__(self, start: int = 0):
        self._now = int(start)

    def now(self) -> int:
        return self._now

    def advance(self, ticks: int = 1) -> int:
        if ticks < 0:
            raise ValueError(f"clock cannot run backwards ({ticks})")
        self._now += int(ticks)
        return self._now


def _phi_from(elapsed: float, mean: float, std: float) -> float:
    """phi = -log10(P(interval > elapsed)) under Normal(mean, std)."""
    std = max(std, MIN_STD)
    p_later = 0.5 * math.erfc((elapsed - mean) / (std * math.sqrt(2.0)))
    if p_later <= 0.0:
        return float("inf")
    return -math.log10(p_later)


class PhiAccrualDetector:
    """The phi-accrual failure detector over a :class:`StepClock`.

    Call :meth:`heartbeat` as arrivals land and :meth:`poll` once per
    scheduling decision; ``poll`` returns the *transitions* since the
    last call (:class:`SuspectRank` / :class:`SuspicionCleared` /
    :class:`ConfirmedDead`), each at most once per episode. Ranks with
    fewer than two arrivals are in bootstrap and never suspected —
    there is no interval distribution to accrue against yet.
    """

    def __init__(self, clock: StepClock, ranks: Sequence[int],
                 suspect_phi: float = SUSPECT_PHI,
                 dead_phi: float = DEAD_PHI,
                 window: int = WINDOW,
                 confirm_grace: int = CONFIRM_GRACE_TICKS):
        if dead_phi <= suspect_phi:
            raise ValueError(
                f"dead_phi {dead_phi} must exceed suspect_phi "
                f"{suspect_phi}: suspicion is the milder verdict"
            )
        self.clock = clock
        self.suspect_phi = suspect_phi
        self.dead_phi = dead_phi
        self.window = window
        self.confirm_grace = confirm_grace
        self._last: Dict[int, int] = {}
        self._intervals: Dict[int, List[int]] = {r: [] for r in ranks}
        self.suspected: Set[int] = set()
        self._suspected_at: Dict[int, int] = {}
        self.dead: Set[int] = set()

    def heartbeat(self, rank: int) -> None:
        if rank not in self._intervals:
            raise ValueError(f"unknown rank {rank}")
        if rank in self.dead:
            # the detector's verdict is monotone; resurrection is the
            # membership layer's regrow decision, not a heartbeat's
            return
        now = self.clock.now()
        prev = self._last.get(rank)
        if prev is not None:
            samples = self._intervals[rank]
            samples.append(now - prev)
            if len(samples) > self.window:
                del samples[: len(samples) - self.window]
        self._last[rank] = now

    def phi(self, rank: int) -> float:
        samples = self._intervals.get(rank)
        if not samples or rank not in self._last:
            return 0.0  # bootstrap: no distribution to accrue against
        elapsed = self.clock.now() - self._last[rank]
        mean = sum(samples) / len(samples)
        var = sum((s - mean) ** 2 for s in samples) / len(samples)
        return _phi_from(elapsed, mean, math.sqrt(var))

    def poll(self) -> List:
        """Transitions since the last poll, in rank order.

        Death is two-phase: a rank must first cross the suspect
        threshold, then stay suspected for :attr:`confirm_grace` ticks
        with phi at or above the dead threshold — so a brief silence
        is suspected and cleared, never killed, and no rank can jump
        from healthy to dead in one poll.
        """
        out: List = []
        now = self.clock.now()
        for rank in sorted(self._intervals):
            if rank in self.dead:
                continue
            phi = self.phi(rank)
            if rank in self.suspected:
                if phi < self.suspect_phi:
                    self.suspected.discard(rank)
                    self._suspected_at.pop(rank, None)
                    out.append(SuspicionCleared(rank, now))
                elif (phi >= self.dead_phi
                      and now - self._suspected_at[rank]
                      >= self.confirm_grace):
                    self.suspected.discard(rank)
                    self._suspected_at.pop(rank, None)
                    self.dead.add(rank)
                    out.append(ConfirmedDead(rank, phi, now))
            elif phi >= self.suspect_phi:
                self.suspected.add(rank)
                self._suspected_at[rank] = now
                out.append(SuspectRank(rank, phi, now))
        return out

    def forget(self, rank: int) -> None:
        """Drop a rank's history — called on regrow so the re-admitted
        incarnation bootstraps fresh instead of inheriting the dead
        incarnation's silence."""
        self.dead.discard(rank)
        self.suspected.discard(rank)
        self._suspected_at.pop(rank, None)
        self._last.pop(rank, None)
        self._intervals[rank] = []


@dataclasses.dataclass
class MembershipView:
    """Epoch-numbered view of who is in the job.

    Every change of composition — a confirmed death, a regrow — bumps
    ``epoch``; traffic carries the epoch it was sent under and
    :meth:`validate` rejects anything stale with
    :class:`StaleEpochError`. ``incarnation[r]`` counts how many times
    rank ``r`` has been admitted, so a regrown rank is distinguishable
    from its dead predecessor even within one process.
    """

    n: int
    epoch: int = 0
    members: Set[int] = dataclasses.field(default_factory=set)
    incarnation: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: (epoch, kind, rank) history — the campaign report's audit trail.
    transitions: List[Tuple[int, str, int]] = dataclasses.field(
        default_factory=list
    )

    def __post_init__(self):
        if not self.members:
            self.members = set(range(self.n))
        if not self.incarnation:
            self.incarnation = {r: 0 for r in range(self.n)}

    @property
    def dead(self) -> Set[int]:
        return set(range(self.n)) - self.members

    def attach_recorder(self, recorder) -> "MembershipView":
        """Attach a flight recorder (duck-typed,
        :class:`smi_tpu.obs.events.FlightRecorder`): every epoch bump
        — shrink or regrow — emits a ``ctl.shrink`` / ``ctl.regrow``
        control-plane event stamped with the new epoch. Deliberately
        an instance attribute, NOT a dataclass field: the model
        checker fingerprints views by their fields, and an attached
        recorder must never split behaviourally-identical states.
        Returns ``self`` for chaining."""
        self._recorder = recorder
        return self

    def _observe(self, kind: str, rank: int, reason: str) -> None:
        recorder = getattr(self, "_recorder", None)
        if recorder is not None:
            recorder.emit(kind, self.epoch, rank=rank,
                          epoch=self.epoch, reason=reason)

    def confirm_dead(self, rank: int) -> int:
        """Remove a rank under a new epoch; returns the new epoch."""
        if rank not in self.members:
            raise ValueError(f"rank {rank} is not a member")
        if len(self.members) == 1:
            raise ValueError(
                f"cannot remove rank {rank}: it is the last member"
            )
        self.members.discard(rank)
        self.epoch += 1
        self.transitions.append((self.epoch, "dead", rank))
        self._observe("ctl.shrink", rank, "confirmed-dead")
        return self.epoch

    def regrow(self, rank: int) -> int:
        """Re-admit a recovered rank under a new epoch + incarnation.

        The inverse of shrink. The caller is responsible for restoring
        the rank's application state (checkpoint manifest) and
        re-planning the ring (:func:`plan_regrow_ring`) before routing
        traffic to it. Returns the new epoch.
        """
        if rank in self.members:
            raise ValueError(f"rank {rank} is already a member")
        if not 0 <= rank < self.n:
            raise ValueError(f"rank {rank} out of range for n={self.n}")
        self.members.add(rank)
        self.incarnation[rank] += 1
        self.epoch += 1
        self.transitions.append((self.epoch, "regrow", rank))
        self._observe("ctl.regrow", rank, "rejoin")
        return self.epoch

    def scale_in(self, rank: int, reason: str = "demand") -> int:
        """Park a healthy rank under a new epoch — capacity scale-in.

        Same composition change as :meth:`confirm_dead` (the epoch is
        the safety rail either way) but booked as a ``scale-in``
        transition and observed as a ``ctl.scale`` event: an operator
        reading the audit trail must be able to tell a deliberate
        capacity decision from a death. Returns the new epoch.
        """
        if rank not in self.members:
            raise ValueError(f"rank {rank} is not a member")
        if len(self.members) == 1:
            raise ValueError(
                f"cannot scale in rank {rank}: it is the last member"
            )
        self.members.discard(rank)
        self.epoch += 1
        self.transitions.append((self.epoch, "scale-in", rank))
        recorder = getattr(self, "_recorder", None)
        if recorder is not None:
            recorder.emit("ctl.scale", self.epoch, rank=rank,
                          epoch=self.epoch, direction="in", reason=reason)
        return self.epoch

    def scale_out(self, rank: int, reason: str = "demand") -> int:
        """Re-admit a parked rank under a new epoch + incarnation —
        capacity scale-out, the inverse of :meth:`scale_in`. Booked as
        a ``scale-out`` transition / ``ctl.scale`` event so demand
        actuation and failure recovery stay distinguishable in the
        audit trail. Returns the new epoch."""
        if rank in self.members:
            raise ValueError(f"rank {rank} is already a member")
        if not 0 <= rank < self.n:
            raise ValueError(f"rank {rank} out of range for n={self.n}")
        self.members.add(rank)
        self.incarnation[rank] += 1
        self.epoch += 1
        self.transitions.append((self.epoch, "scale-out", rank))
        recorder = getattr(self, "_recorder", None)
        if recorder is not None:
            recorder.emit("ctl.scale", self.epoch, rank=rank,
                          epoch=self.epoch, direction="out", reason=reason)
        return self.epoch

    def migrate_cutover(self, src: int, dst: int,
                        tenant: str = "",
                        token: Optional[FencingToken] = None) -> int:
        """Bump the epoch for a live-migration lane switch.

        Membership does not change — both ranks stay members — but the
        epoch must move so stragglers still addressed to the source
        lane are rejected as :class:`StaleEpochError` instead of being
        folded into the destination silently (the same rail a failover
        uses, chosen on purpose). The cutover is a fenced actuation:
        ``token`` (minted trivially from the full member set when
        None) must prove quorum under the CURRENT epoch or the switch
        refuses — a partitioned minority can never cut a migration
        over both ways. Returns the new epoch.
        """
        check_fencing_token(self, token, rank=dst,
                            what=f"migration cutover {src}->{dst}")
        for r, role in ((src, "source"), (dst, "destination")):
            if r not in self.members:
                raise ValueError(
                    f"migration {role} rank {r} is not a member"
                )
        if src == dst:
            raise ValueError(
                f"migration source and destination are both rank {src}"
            )
        self.epoch += 1
        self.transitions.append((self.epoch, "migrate", dst))
        recorder = getattr(self, "_recorder", None)
        if recorder is not None:
            recorder.emit("ctl.migrate", self.epoch, rank=dst,
                          epoch=self.epoch, src=src, dst=dst,
                          state="cutover", tenant=tenant)
        return self.epoch

    def validate(self, rank: int, epoch: int, what: str = "message") -> None:
        """Reject traffic from a mismatched epoch or a non-member (the
        error's wording distinguishes stale sender from split view)."""
        if epoch != self.epoch:
            raise StaleEpochError(rank, epoch, self.epoch, what=what)
        if rank not in self.members:
            raise StaleEpochError(rank, epoch, self.epoch,
                                  what=f"{what} from a non-member")

    def failure_set(self, topology=None):
        """The routing :class:`~smi_tpu_torch.parallel.routing.FailureSet`
        for the current dead set — dead ranks' devices go down but
        keep their rank slots, exactly the shape degraded routing
        expects. ``topology`` defaults to the 1-D ring of ``n``."""
        from smi_tpu_torch.parallel.routing import FailureSet, grid_topology

        topo = topology if topology is not None else grid_topology(1, self.n)
        return FailureSet(
            devices=frozenset(topo.devices[r] for r in sorted(self.dead))
        )


def route_owner(view: MembershipView, rank: int,
                n: Optional[int] = None) -> Optional[int]:
    """The member currently serving ``rank``'s duties: the rank itself
    while it is a member, else its heir among the current members
    (:func:`~smi_tpu_torch.parallel.recovery.heir_of` — nearest surviving
    successor), else ``None`` when nobody survives. The single
    authority for "who owns rank r now", shared by the elastic soak's
    block ownership and the serving front-end's tenant failover."""
    from smi_tpu_torch.parallel.recovery import heir_of

    n = view.n if n is None else n
    members = view.members
    if rank in members:
        return rank
    if not members:
        return None
    return heir_of(rank, members, n)


def plan_regrow_ring(view: MembershipView,
                     down_pairs: Sequence[Tuple[int, int]] = ()
                     ) -> List[int]:
    """The ring order after a membership change, re-derived through the
    existing machinery: :func:`~smi_tpu_torch.parallel.recovery.plan_ring`
    orders the members around any down wires, and the 1-D
    :func:`~smi_tpu_torch.parallel.routing.grid_topology` with the dead
    ranks' devices excluded must still route every member pair (a
    regrow that would strand a member raises
    :class:`~smi_tpu_torch.parallel.routing.RouteCutError` naming the cut).
    """
    from smi_tpu_torch.parallel.recovery import plan_ring
    from smi_tpu_torch.parallel.routing import (
        build_routing_context,
        check_all_pairs_routable,
        grid_topology,
    )

    members = sorted(view.members)
    order, extra = plan_ring(members, down_pairs, view.n)
    if extra:
        raise ValueError(
            f"regrow ring cannot separate down pairs {sorted(down_pairs)} "
            f"without shrinking {sorted(extra)}; shrink first"
        )
    cut = view.failure_set()
    topo = grid_topology(1, view.n)
    ctx = build_routing_context(topo, excluded=cut)
    check_all_pairs_routable(ctx, [topo.devices[r] for r in order])
    return order


def shrink_pod(view: MembershipView, detector, rank: int,
               reason: str = "demand",
               token: Optional[FencingToken] = None) -> int:
    """Capacity scale-in actuator: park ``rank`` out of the serving
    pod. The step-clock analog of ``Communicator.shrink_pod``, driven
    by *demand* instead of death: the epoch bumps (``scale-in``
    transition + ``ctl.scale`` event), the post-shrink ring is
    validated routable (:func:`plan_regrow_ring` — a scale-in that
    would strand a member raises instead of landing), and the phi
    detector forgets the rank so a deliberately-parked rank can never
    accrue suspicion while silent. A fenced actuation: ``token``
    (minted trivially from the full member set when None) must prove
    quorum under the current epoch (:func:`check_fencing_token`) or
    the scale-in refuses loudly. Returns the new epoch."""
    check_fencing_token(view, token, rank=rank,
                        what=f"scale-in of rank {rank}")
    epoch = view.scale_in(rank, reason=reason)
    plan_regrow_ring(view)
    if detector is not None:
        detector.forget(rank)
    return epoch


def regrow_pod(view: MembershipView, detector, rank: int,
               reason: str = "demand",
               token: Optional[FencingToken] = None) -> int:
    """Capacity scale-out actuator: re-admit a parked rank (the
    inverse of :func:`shrink_pod`). Epoch bumps under a ``scale-out``
    transition, the grown ring is validated routable, and the detector
    forgets the rank so the fresh incarnation bootstraps its heartbeat
    history clean (the :meth:`MembershipView.regrow` discipline).
    Fenced exactly like :func:`shrink_pod`: no quorum token, no
    capacity change. Returns the new epoch."""
    check_fencing_token(view, token, rank=rank,
                        what=f"scale-out of rank {rank}")
    epoch = view.scale_out(rank, reason=reason)
    plan_regrow_ring(view)
    if detector is not None:
        detector.forget(rank)
    return epoch


# ---------------------------------------------------------------------------
# Pod-of-slices membership: two-tier rings, heirs, elastic soak
# ---------------------------------------------------------------------------


def pod_heir_of(rank: int, survivors, slices: int, per_slice: int) -> int:
    """The pod inheritance rule: a dead rank's duties pass to its
    nearest surviving successor ON ITS SLICE RING first (the heir can
    read the shard over ICI and the slice ring re-closes locally);
    only when the whole slice is dead does inheritance cross to the
    global successor — the flat-fallback shape where DCN is already
    being paid. Degenerates to :func:`~recovery.heir_of` at one
    slice."""
    from smi_tpu_torch.parallel.recovery import heir_of

    n = slices * per_slice
    surv = set(survivors)
    s, i = divmod(rank, per_slice)
    for step in range(1, per_slice):
        cand = s * per_slice + (i + step) % per_slice
        if cand in surv:
            return cand
    return heir_of(rank, surv, n)


@dataclasses.dataclass(frozen=True)
class PodRingPlan:
    """The executable ring layout after a pod membership change.

    ``hierarchical`` layouts carry one (possibly shrunk) ring per
    surviving slice plus the cross-slice leader ring; the
    ``flat_ring`` fallback (any slice annihilated, or a single
    surviving slice) is the one-ring-over-survivors shape every
    collective can always run."""

    slice_rings: Tuple[Tuple[int, ...], ...] = ()
    cross_ring: Tuple[int, ...] = ()
    flat_ring: Optional[Tuple[int, ...]] = None

    @property
    def hierarchical(self) -> bool:
        return self.flat_ring is None


def plan_pod_rings(view: MembershipView, slices: int,
                   per_slice: int) -> PodRingPlan:
    """Ring layout for the current members of a (slices, per_slice)
    pod, validated against the pod topology with the dead devices
    excluded (the same :func:`~routing.check_all_pairs_routable`
    discipline as :func:`plan_regrow_ring` — a plan that would strand
    a member raises :class:`~routing.RouteCutError` naming the cut).

    - a dead RANK shrinks its slice ring: the slice keeps ringing
      over its survivors, the cross ring connects each surviving
      slice's leader (lowest surviving rank), and the hierarchical
      protocol stays on;
    - a dead SLICE (no survivors in some slice) — or a pod reduced to
      one surviving slice — falls back to the flat ring over all
      survivors: with a tier gone there is nothing to tier over.
    """
    from smi_tpu_torch.parallel.routing import (
        FailureSet,
        build_routing_context,
        check_all_pairs_routable,
        pod_topology,
    )

    n = slices * per_slice
    if view.n != n:
        raise ValueError(
            f"view over {view.n} ranks does not match the "
            f"{slices}x{per_slice} pod"
        )
    members = sorted(view.members)
    topo = pod_topology(slices, per_slice)
    cut = FailureSet(
        devices=frozenset(topo.devices[r] for r in sorted(view.dead))
    )
    ctx = build_routing_context(topo, excluded=cut)
    check_all_pairs_routable(ctx, [topo.devices[r] for r in members])
    per = [
        tuple(r for r in members if r // per_slice == s)
        for s in range(slices)
    ]
    live = [ring for ring in per if ring]
    if len(live) < len(per) or len(live) < 2:
        return PodRingPlan(flat_ring=tuple(members))
    return PodRingPlan(
        slice_rings=tuple(live),
        cross_ring=tuple(ring[0] for ring in live),
    )


def run_pod_cell(
    slices: int,
    per_slice: int,
    kill: str,
    seed: int,
    iterations: int = 18,
    cadence: int = 3,
    rows_per_rank: int = 3,
    width: int = 8,
    checkpoint_dir: Optional[str] = None,
) -> Dict:
    """One pod elastic soak cell: the sharded Jacobi job on a
    (slices, per_slice) pod healed through a seeded kill.

    ``kill="rank"`` crash-stops one seeded rank (its slice ring
    shrinks, the plan stays hierarchical); ``kill="slice"`` crash-
    stops a whole seeded slice (the plan must fall back to the flat
    ring over the survivors). Either way: shrink under new epochs,
    restore ALL state from the last complete manifest and replay the
    tail, reject the dead incarnation's stale-epoch traffic loudly,
    regrow under a fresh epoch with the hierarchical plan restored,
    and finish bit-identical to the fault-free run. Deterministic per
    ``(shape, kill, seed)``.
    """
    import numpy as np

    from smi_tpu_torch.parallel.checkpoint import CheckpointStore

    if kill not in ("rank", "slice"):
        raise ValueError(f"kill must be 'rank' or 'slice', got {kill!r}")
    if slices < 2 or per_slice < 1:
        raise ValueError(
            f"pod soak needs >= 2 slices (got {slices}x{per_slice})"
        )
    n = slices * per_slice
    rng = random.Random(f"pod:{slices}x{per_slice}:{kill}:{seed}")
    view = MembershipView(n)
    grid0 = _initial_grid(n * rows_per_rank, width)
    blocks = {
        r: grid0[r * rows_per_rank:(r + 1) * rows_per_rank].copy()
        for r in range(n)
    }
    store = CheckpointStore(checkpoint_dir) if checkpoint_dir else None

    if kill == "rank":
        victims = [rng.randrange(n)]
    else:
        s = rng.randrange(slices)
        victims = list(range(s * per_slice, (s + 1) * per_slice))
    dies_at = 2 + rng.randrange(3)
    rejoins_at = dies_at + 4 + rng.randrange(3)

    report: Dict = {
        "slices": slices, "per_slice": per_slice, "kill": kill,
        "seed": seed, "victims": victims, "dies_at": dies_at,
        "rejoins_at": rejoins_at, "iterations": iterations,
        "shrinks": 0, "regrows": 0, "restores": 0, "checkpoints": 0,
        "replayed_iterations": 0, "stale_epoch_rejections": 0,
        "stale_epoch_leaks": 0, "plan_modes": [], "verdict": "ok",
    }

    def owners_now() -> Dict[int, Optional[int]]:
        members = view.members
        return {
            r: (r if r in members
                else pod_heir_of(r, members, slices, per_slice)
                if members else None)
            for r in range(n)
        }

    def checkpoint() -> None:
        if store is not None:
            store.save(it, blocks, epoch=view.epoch)
            report["checkpoints"] += 1

    it = 0
    checkpoint()
    killed = False
    death_epoch = view.epoch
    while it < iterations:
        if not killed and it == dies_at:
            death_epoch = view.epoch
            for r in victims:
                view.confirm_dead(r)
                report["shrinks"] += 1
            plan = plan_pod_rings(view, slices, per_slice)
            report["plan_modes"].append(
                "hierarchical" if plan.hierarchical else "flat"
            )
            want_hier = kill == "rank" and per_slice > 1
            if plan.hierarchical != want_hier:
                report["verdict"] = (
                    f"{kill} kill planned "
                    f"{'hierarchical' if plan.hierarchical else 'flat'}"
                    f", wanted "
                    f"{'hierarchical' if want_hier else 'flat'}"
                )
                return report
            if store is not None:
                restored = store.restore()
                if restored is None:
                    report["verdict"] = "no complete manifest to restore"
                    return report
                step, shards, _epoch = restored
                for r, payload in shards.items():
                    blocks[r] = payload
                report["restores"] += 1
                report["replayed_iterations"] += it - step
                it = step
            killed = True
            continue
        if killed and victims and it == rejoins_at:
            # the dead incarnation presents its pre-shrink epoch: the
            # gate must reject it loudly, never fold it in
            for r in victims:
                try:
                    view.validate(r, death_epoch, what="rejoin request")
                    report["stale_epoch_leaks"] += 1
                except StaleEpochError:
                    report["stale_epoch_rejections"] += 1
            checkpoint()  # regrow barrier: newcomers restore this state
            for r in victims:
                view.regrow(r)
                report["regrows"] += 1
            plan = plan_pod_rings(view, slices, per_slice)
            report["plan_modes"].append(
                "hierarchical" if plan.hierarchical else "flat"
            )
            if not plan.hierarchical and per_slice > 1:
                report["verdict"] = "regrown pod did not restore tiering"
                return report
            if store is not None:
                restored = store.restore()
                step, shards, _epoch = restored
                for r in victims:
                    blocks[r] = shards[r]
            # one straggler packet from the dead incarnation arrives
            # AFTER the regrow: reject, never fold in
            for r in victims:
                try:
                    view.validate(r, view.epoch - 1,
                                  what="straggler halo")
                    report["stale_epoch_leaks"] += 1
                except StaleEpochError:
                    report["stale_epoch_rejections"] += 1
            victims = []
        owners = owners_now()
        blocks = _jacobi_sweep(blocks, owners, view, n)
        it += 1
        if it % cadence == 0:
            checkpoint()

    final = np.concatenate([blocks[r] for r in range(n)])
    want = _fault_free_grid(grid0, iterations)
    problems = []
    if not np.array_equal(final, want):
        problems.append("silent corruption: final grid differs")
    if report["stale_epoch_leaks"]:
        problems.append("stale-epoch traffic accepted")
    if problems:
        report["verdict"] = "; ".join(problems)
    report["epoch"] = view.epoch
    report["members"] = sorted(view.members)
    return report


def pod_campaign(
    seed: int,
    shapes: Sequence[Tuple[int, int]] = ((2, 2), (2, 3), (3, 2)),
    trials: int = 2,
    iterations: int = 18,
    cadence: int = 3,
    checkpoint_root: Optional[str] = None,
) -> Dict:
    """Seeded pod soak: kill-one-rank AND kill-one-slice cells over
    several (slices, per_slice) shapes, gated like the elastic
    campaign on zero silent corruption and zero stale-epoch leaks."""
    import os
    import tempfile

    outcomes: Dict[str, int] = {}
    failures: List[Dict] = []
    cells = 0
    stale_rejections = 0
    for slices, per_slice in shapes:
        for kill in ("rank", "slice"):
            for trial in range(trials):
                cells += 1
                cell_seed = random.Random(
                    f"pod:{seed}:{slices}x{per_slice}:{kill}:{trial}"
                ).randrange(1 << 31)
                with tempfile.TemporaryDirectory(
                    dir=checkpoint_root
                ) as ckpt:
                    report = run_pod_cell(
                        slices, per_slice, kill, cell_seed,
                        iterations=iterations, cadence=cadence,
                        checkpoint_dir=os.path.join(ckpt, "shards"),
                    )
                stale_rejections += report["stale_epoch_rejections"]
                if report["verdict"] != "ok":
                    outcomes["failed"] = outcomes.get("failed", 0) + 1
                    failures.append({
                        "slices": slices, "per_slice": per_slice,
                        "kill": kill, "trial": trial,
                        "cell_seed": cell_seed,
                        "verdict": report["verdict"],
                    })
                    continue
                key = f"regrown-{kill}"
                outcomes[key] = outcomes.get(key, 0) + 1
    silent = sum(
        1 for f in failures if "silent corruption" in f["verdict"]
    )
    stale_leaks = sum(
        1 for f in failures if "stale-epoch" in f["verdict"]
    )
    return {
        "seed": seed,
        "shapes": [list(s) for s in shapes],
        "trials": trials,
        "cells": cells,
        "outcomes": outcomes,
        "failures": failures,
        "silent_corruptions": silent,
        "stale_epoch_leaks": stale_leaks,
        "stale_epoch_rejections": stale_rejections,
        "ok": not failures,
    }


# ---------------------------------------------------------------------------
# The elastic soak: kill -> detect -> shrink -> restore -> regrow
# ---------------------------------------------------------------------------

#: Watchdog budget in clock ticks the detector must beat: the PR-1
#: deadline layer would declare the job hung only after this long with
#: no progress. phi-accrual confirms within ~one heartbeat period.
WATCHDOG_TICKS = 12 * HEARTBEAT_INTERVAL


@dataclasses.dataclass
class _EpochMessage:
    """A halo slab on the elastic job's wire, epoch-tagged."""

    src: int
    epoch: int
    payload: object


def _jacobi_sweep(blocks: Dict[int, "object"], owners: Dict[int, int],
                  view: MembershipView, n: int):
    """One global Jacobi sweep over per-rank row blocks.

    Every block's top/bottom halo rows travel as epoch-tagged messages
    validated by the membership view — the soak's data plane. Math is
    the models' reference update (``models.stencil.reference_stencil``)
    split by row block: Dirichlet boundary rows held, interior cells
    averaging their four neighbours. Owners compute dead ranks' blocks
    (heir inheritance), so the global grid is identical to the
    fault-free run's no matter the membership.
    """
    import numpy as np

    def rows_of(r):
        return blocks[r]

    new: Dict[int, object] = {}
    for r in range(n):
        owner = owners[r]
        if owner is None:
            raise RuntimeError(f"block {r} has no live owner")
        block = rows_of(r)
        up = None if r == 0 else _EpochMessage(
            owners[r - 1], view.epoch, rows_of(r - 1)[-1]
        )
        down = None if r == n - 1 else _EpochMessage(
            owners[r + 1], view.epoch, rows_of(r + 1)[0]
        )
        for msg in (up, down):
            if msg is not None:
                view.validate(msg.src, msg.epoch, what="halo slab")
        h, w = block.shape
        padded = np.zeros((h + 2, w), dtype=block.dtype)
        padded[1:-1] = block
        padded[0] = up.payload if up is not None else block[0]
        padded[-1] = down.payload if down is not None else block[-1]
        avg = 0.25 * (
            padded[:-2, 1:-1] + padded[2:, 1:-1]
            + padded[1:-1, :-2] + padded[1:-1, 2:]
        )
        out = block.copy()
        interior_top = 1 if r == 0 else 0
        interior_bot = h - 1 if r == n - 1 else h
        out[interior_top:interior_bot, 1:-1] = (
            avg[interior_top:interior_bot]
        )
        new[r] = out
    return new


def _initial_grid(x: int, y: int):
    """Hot-top-edge Jacobi start (``models.stencil.initial_grid`` in
    float64, inlined so the soak never imports the model stack)."""
    import numpy as np

    g = np.zeros((x, y), dtype=np.float64)
    g[0, :] = 1.0
    return g


def _fault_free_grid(grid0, iterations: int):
    """Serial Jacobi yardstick — the exact update of
    ``models.stencil.reference_stencil``, term order included, so the
    healed run's bit-identity claim is against the models' math."""
    g = grid0.copy()
    for _ in range(iterations):
        avg = 0.25 * (
            g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:]
        )
        g[1:-1, 1:-1] = avg
    return g


def run_elastic_cell(
    n: int,
    plan: F.FaultPlan,
    seed: int,
    iterations: int = 24,
    cadence: int = 4,
    rows_per_rank: int = 3,
    width: int = 8,
    checkpoint_dir: Optional[str] = None,
) -> Dict:
    """One elastic soak cell: a sharded Jacobi job under an elastic
    fault plan, healed end to end.

    The job runs ``iterations`` sweeps of the reference Jacobi update
    over ``n`` per-rank row blocks, checkpointing every ``cadence``
    iterations (sharded CRC-framed shards + atomic manifest,
    :mod:`smi_tpu_torch.parallel.checkpoint`). Heartbeats tick on the step
    clock with seeded jitter; the phi-accrual detector drives:

    - :class:`~faults.FlappingRank` — the rank stops heartbeating and
      computing at ``dies_at``; the job *stalls* (a real collective
      would block) while phi accrues; ``ConfirmedDead`` must land
      before :data:`WATCHDOG_TICKS` of stall, then the survivors
      shrink (epoch bump), heirs inherit the dead block, ALL state
      restores from the last complete manifest, and the tail replays.
      At ``rejoins_at`` the rank's new incarnation first presents its
      old epoch — rejected loudly (:class:`StaleEpochError`, counted)
      — then regrows under a fresh epoch (ring re-planned via
      :func:`plan_regrow_ring`), restores from the manifest the
      survivors cut at the regrow barrier, and finishes in place.
    - :class:`~faults.StalledHeartbeat` — the rank computes but its
      heartbeats go silent for ``silent_for`` ticks: it must be
      *suspected* and then cleared, never confirmed dead, and the job
      must neither shrink nor restore.

    Exit gate per cell: the final global grid is bit-identical to the
    fault-free run's, and every stale-epoch injection was rejected
    loudly. Deterministic per ``(n, plan, seed)``.
    """
    import numpy as np

    from smi_tpu_torch.parallel.checkpoint import CheckpointStore

    if rows_per_rank < 1 or width < 3:
        raise ValueError("grid too small for a Jacobi block per rank")
    rng = random.Random(f"elastic:{n}:{seed}")
    clock = StepClock()
    detector = PhiAccrualDetector(clock, range(n))
    view = MembershipView(n)
    grid0 = _initial_grid(n * rows_per_rank, width)
    blocks = {
        r: grid0[r * rows_per_rank:(r + 1) * rows_per_rank].copy()
        for r in range(n)
    }
    store = CheckpointStore(checkpoint_dir) if checkpoint_dir else None

    flaps = {f.rank: f for f in plan.flapping_ranks}
    silences = {f.rank: f for f in plan.stalled_heartbeats}

    def owners_now() -> Dict[int, Optional[int]]:
        return {r: route_owner(view, r, n) for r in range(n)}

    report: Dict = {
        "n": n, "seed": seed, "plan": plan.describe(),
        "iterations": iterations, "cadence": cadence,
        "suspected": [], "confirmed": [], "cleared": [],
        "shrinks": 0, "regrows": 0, "restores": 0,
        "stale_epoch_rejections": 0, "stale_epoch_leaks": 0,
        "checkpoints": 0, "replayed_iterations": 0,
        "watchdog_fired": False, "detect_ticks": None,
        "verdict": "ok",
    }

    it = 0
    next_beat = clock.now()

    def all_beat() -> None:
        """Every live, non-silenced member heartbeats on schedule."""
        nonlocal next_beat
        if clock.now() < next_beat:
            return
        for r in sorted(view.members):
            flap = flaps.get(r)
            if flap is not None and flap.dies_at <= it:
                continue  # dead: no heartbeat, no compute
            sil = silences.get(r)
            if sil is not None and (
                sil.from_tick <= clock.now()
                < sil.from_tick + sil.silent_for
            ):
                continue  # alive but silent: the suspect-only fault
            detector.heartbeat(r)
        next_beat = clock.now() + HEARTBEAT_INTERVAL + rng.randrange(-1, 2)

    def tick(ticks: int) -> List:
        """Advance the clock in 2-tick poll steps (heartbeats land on
        their own schedule) and collect detector transitions."""
        out: List = []
        left = ticks
        while left > 0:
            step = min(2, left)
            clock.advance(step)
            left -= step
            all_beat()
            out.extend(detector.poll())
        return out

    def checkpoint() -> None:
        if store is None:
            return
        store.save(it, blocks, epoch=view.epoch)
        report["checkpoints"] += 1

    # bootstrap the inter-arrival window before any fault can land
    for _ in range(4):
        for tr in tick(HEARTBEAT_INTERVAL):
            raise RuntimeError(f"transition during bootstrap: {tr}")
    checkpoint()

    stall_started: Optional[int] = None
    pending_dead: Optional[int] = None
    while it < iterations:
        # a dead member blocks the sweep: the job stalls while phi
        # accrues — this is the window the detector must close before
        # the watchdog would
        dead_member = next(
            (r for r in sorted(view.members)
             if r in flaps and flaps[r].dies_at <= it), None,
        )
        if dead_member is not None:
            if stall_started is None:
                stall_started = clock.now()
            for tr in tick(2):
                if isinstance(tr, SuspectRank):
                    report["suspected"].append(tr.rank)
                elif isinstance(tr, ConfirmedDead):
                    report["confirmed"].append(tr.rank)
                    pending_dead = tr.rank
            stalled_for = clock.now() - stall_started
            if pending_dead is None and stalled_for > WATCHDOG_TICKS:
                report["watchdog_fired"] = True
                report["verdict"] = (
                    f"watchdog beat the detector for rank {dead_member}"
                )
                return report
            if pending_dead is None:
                continue
            # detect -> shrink -> restore -> replay the tail
            report["detect_ticks"] = stalled_for
            view.confirm_dead(pending_dead)
            report["shrinks"] += 1
            plan_regrow_ring(view)  # survivors must still ring up
            if store is not None:
                restored = store.restore()
                if restored is None:
                    report["verdict"] = "no complete manifest to restore"
                    return report
                step, shards, _epoch = restored
                for r, payload in shards.items():
                    blocks[r] = payload
                report["restores"] += 1
                report["replayed_iterations"] += it - step
                it = step
            pending_dead = None
            stall_started = None
            continue

        # regrow: a flapped rank whose rejoin time arrived. (A rank
        # that died but is not yet CONFIRMED is still a member — the
        # first check skips it and the stall branch above keeps
        # running until the detector rules.)
        for r, flap in sorted(flaps.items()):
            if r in view.members or flap.rejoins_at > it:
                continue
            # the old incarnation announces itself under its old epoch
            try:
                view.validate(r, 0, what="rejoin request")
                report["stale_epoch_leaks"] += 1
            except StaleEpochError:
                report["stale_epoch_rejections"] += 1
            # survivors cut a barrier checkpoint so the newcomer
            # restores the *current* state, then admit it
            checkpoint()
            view.regrow(r)
            # fresh incarnation, fresh bootstrap: no off-schedule beat
            # here — an immediate beat would seed a tiny first interval
            # and make the next normal gap look like silence
            detector.forget(r)
            report["regrows"] += 1
            plan_regrow_ring(view)
            if store is not None:
                restored = store.restore()
                step, shards, _epoch = restored
                blocks[r] = shards[r]
            del flaps[r]
            # one straggler packet from the dead incarnation arrives
            # AFTER the regrow: it must be rejected, never folded in
            try:
                view.validate(r, view.epoch - 1, what="straggler halo")
                report["stale_epoch_leaks"] += 1
            except StaleEpochError:
                report["stale_epoch_rejections"] += 1

        owners = owners_now()
        blocks = _jacobi_sweep(blocks, owners, view, n)
        it += 1
        for tr in tick(HEARTBEAT_INTERVAL):
            if isinstance(tr, SuspectRank):
                report["suspected"].append(tr.rank)
            elif isinstance(tr, SuspicionCleared):
                report["cleared"].append(tr.rank)
            elif isinstance(tr, ConfirmedDead):
                report["verdict"] = (
                    f"rank {tr.rank} confirmed dead while computing"
                )
                return report
        if it % cadence == 0:
            checkpoint()

    final = np.concatenate([blocks[r] for r in range(n)])
    want = _fault_free_grid(grid0, iterations)
    problems = []
    if not np.array_equal(final, want):
        problems.append("silent corruption: final grid differs")
    if report["stale_epoch_leaks"]:
        problems.append("stale-epoch traffic accepted")
    if problems:
        # both gate violations must survive into the verdict — the
        # campaign counts each by substring, and one masking the other
        # would understate the headline silent-corruption figure
        report["verdict"] = "; ".join(problems)
    report["epoch"] = view.epoch
    report["members"] = sorted(view.members)
    return report


def random_elastic_plan(n: int, seed: int) -> F.FaultPlan:
    """A deterministic single-fault elastic plan: one FlappingRank or
    one StalledHeartbeat, seeded."""
    rng = random.Random(f"elastic-plan:{n}:{seed}")
    cls = F.ELASTIC_FAULT_CLASSES[
        rng.randrange(len(F.ELASTIC_FAULT_CLASSES))
    ]
    return F.FaultPlan.random(cls, n, rng.randrange(1 << 30))


def elastic_campaign(
    seed: int,
    ns: Sequence[int] = (2, 3, 4),
    trials: int = 2,
    iterations: int = 18,
    cadence: int = 3,
    checkpoint_root: Optional[str] = None,
) -> Dict:
    """Seeded elastic soak: kill/detect/shrink/restore/regrow cells
    over several ring sizes, with the same zero-silent-corruption,
    zero-stale-epoch exit gate the base chaos campaign enforces.

    Each cell runs :func:`run_elastic_cell` with a seeded
    :func:`random_elastic_plan`; checkpoints land under
    ``checkpoint_root`` (a fresh tempdir per cell when None).
    Deterministic per ``seed`` — the report reproduces from its JSON
    alone via ``smi-tpu chaos --elastic --seed N``.
    """
    import os
    import tempfile

    outcomes: Dict[str, int] = {}
    failures: List[Dict] = []
    cells = 0
    detect_ticks: List[int] = []
    stale_rejections = 0
    for n in ns:
        for trial in range(trials):
            cells += 1
            cell_seed = random.Random(
                f"elastic:{seed}:{n}:{trial}"
            ).randrange(1 << 31)
            plan = random_elastic_plan(n, cell_seed)
            with tempfile.TemporaryDirectory(
                dir=checkpoint_root
            ) as ckpt:
                report = run_elastic_cell(
                    n, plan, cell_seed, iterations=iterations,
                    cadence=cadence,
                    checkpoint_dir=os.path.join(ckpt, "shards"),
                )
            stale_rejections += report["stale_epoch_rejections"]
            if report["verdict"] != "ok":
                outcomes["failed"] = outcomes.get("failed", 0) + 1
                failures.append({
                    "n": n, "trial": trial, "cell_seed": cell_seed,
                    "plan": plan.describe(),
                    "verdict": report["verdict"],
                })
                continue
            if report["detect_ticks"] is not None:
                detect_ticks.append(report["detect_ticks"])
            key = ("regrown" if report["regrows"]
                   else "suspected-cleared" if report["cleared"]
                   else "healed")
            outcomes[key] = outcomes.get(key, 0) + 1
    silent = sum(
        1 for f in failures if "silent corruption" in f["verdict"]
    )
    stale_leaks = sum(
        1 for f in failures if "stale-epoch" in f["verdict"]
    )
    return {
        "seed": seed,
        "ns": list(ns),
        "trials": trials,
        "cells": cells,
        "outcomes": outcomes,
        "failures": failures,
        "silent_corruptions": silent,
        "stale_epoch_leaks": stale_leaks,
        "stale_epoch_rejections": stale_rejections,
        "max_detect_ticks": max(detect_ticks) if detect_ticks else None,
        "watchdog_budget_ticks": WATCHDOG_TICKS,
        "ok": not failures,
    }
