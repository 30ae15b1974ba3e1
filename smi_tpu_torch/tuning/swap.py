"""Epoch-guarded hot swap of one plan-cache entry: the PlanSwap machine.

The port's copy of :mod:`smi_tpu.tuning.swap`, pure Python and name for
name. The membership layer, the serving tier and the model checker this
text cites are the JAX package's; the port has none of them yet, and
the machine's arcs are the same.

The online tuner (:mod:`smi_tpu_torch.tuning.online`) decides *that* a plan
should change; this module owns *how* it changes while a job is live —
with exactly the discipline the membership layer applies to a
rank change, because a plan change is just as able to corrupt a run
mid-flight as a membership change is:

``idle`` → ``proposed`` → ``quiescing`` → ``swapped`` →
``committed`` | ``rolled_back``

- **propose** — the rival entry and its evidence (sample count, win
  margin) are staged; the proposal snapshots the *drain set*: the
  identities of the in-flight streams planned under the entry being
  retired. Nothing is installed yet.
- **quiesce** — the caller (serving front-end, model-checker world,
  offline replay) drains the drain set. New traffic keeps using the
  old entry; it is re-planned onto the new epoch at swap time.
- **swap** — only legal from ``quiescing``: the new entry lands in the
  plan cache with a **bumped ``revision``** (so a late-arriving
  offline sweep merge can never silently resurrect the retired plan)
  and the **plan epoch** bumps. From here, any traffic presenting the
  old plan epoch must be rejected with a loud :class:`StalePlanError`
  — the JAX package's ``parallel.membership.StaleEpochError``
  discipline applied to plans.
- **commit / rollback** — commit finalizes; rollback restores the
  pre-proposal entry. A pre-swap rollback installed nothing, so it
  restores nothing; a post-swap rollback re-installs the old entry
  under a *further* epoch bump (epochs are monotone — the restore is
  itself a plan change the data path renegotiates). Either way, zero
  lost-accepted: the cache always holds a servable entry for the key.

The machine is exhaustively verified by the JAX package's model checker
(``smi-tpu lint --model`` — the ``retune=1`` scope drives this REAL
class through every interleaving; properties ``plan-epoch-safety``
and ``swap-lost-accepted``), and the ``swap_without_quiesce`` /
``rollback_discards_entry`` mutants prove both properties can fail.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional

from smi_tpu_torch.tuning.cache import CacheEntry, PlanCache
from smi_tpu_torch.tuning.plan import PlanKey

#: The swap machine's states, in arc order. docs/tuning.md's state
#: diagram quotes every one (drift-guarded by tests/test_perf_docs.py).
SWAP_STATES = ("idle", "proposed", "quiescing", "swapped",
               "committed", "rolled_back")

#: States from which a new proposal may start (a finished swap resets
#: the machine for the next arc).
_PROPOSABLE = ("idle", "committed", "rolled_back")


class PlanSwapError(RuntimeError):
    """An illegal swap-machine transition — loudly named, never a
    silently skipped step (skipping quiesce is exactly the bug the
    model checker's mutant reinstates)."""


class StalePlanError(PlanSwapError):
    """Traffic presented a retired plan epoch after a swap.

    Names the plan key, the stale epoch the sender carried, and the
    current epoch — the plan-tier mirror of
    JAX package's ``parallel.membership.StaleEpochError``: rejected
    loudly, counted, never folded in.
    """

    def __init__(self, key_sig: str, stale: int, current: int,
                 what: str = ""):
        super().__init__(
            f"stale plan epoch {stale} presented for plan {key_sig}"
            + (f" ({what})" if what else "")
            + f": current plan epoch is {current} — traffic planned "
            f"under a retired entry is rejected, never folded in"
        )
        self.key = key_sig
        self.stale = stale
        self.current = current
        self.what = what


@dataclasses.dataclass
class SwapProposal:
    """One staged plan change: the entry being retired, its rival, the
    evidence that justified the proposal, and the drain set (stream
    identities in flight under the old entry at proposal time)."""

    key: PlanKey
    old: Optional[CacheEntry]
    new: CacheEntry
    evidence: Dict[str, object]
    drain: FrozenSet[int] = frozenset()


class PlanSwap:
    """The propose → quiesce → swap → commit/rollback machine for ONE
    plan-cache key. The caller owns the in-flight census (who is in
    the drain set, whether it has drained) and the clock; this class
    owns the state discipline, the epoch, and the cache writes."""

    def __init__(self, cache: PlanCache, key: PlanKey):
        self.cache = cache
        self.key = key
        #: monotone plan epoch for this key: bumps on every install
        #: (swap AND post-swap rollback) — never regresses
        self.plan_epoch = 0
        self.state = "idle"
        self.proposal: Optional[SwapProposal] = None
        #: caller-stamped quiesce start (step-clock tick), for
        #: quiesce-timeout rollbacks
        self.quiesce_started: Optional[int] = None
        self.committed_swaps = 0
        self.rolled_back_swaps = 0
        self.last_rollback_reason = ""

    # -- plumbing -------------------------------------------------------

    def _expect(self, *states: str) -> None:
        if self.state not in states:
            raise PlanSwapError(
                f"plan swap for {self.key.signature()} is in state "
                f"{self.state!r}; this transition requires "
                f"{' or '.join(repr(s) for s in states)}"
            )

    def in_flight(self) -> bool:
        return self.state in ("proposed", "quiescing", "swapped")

    def active_entry(self) -> Optional[CacheEntry]:
        return self.cache.lookup(self.key)

    # -- the arc --------------------------------------------------------

    def propose(self, new_entry: CacheEntry,
                evidence: Optional[Dict[str, object]] = None,
                drain: FrozenSet[int] = frozenset()) -> SwapProposal:
        self._expect(*_PROPOSABLE)
        self.proposal = SwapProposal(
            key=self.key, old=self.cache.lookup(self.key),
            new=new_entry, evidence=dict(evidence or {}),
            drain=frozenset(drain),
        )
        self.state = "proposed"
        self.quiesce_started = None
        return self.proposal

    def quiesce(self, now: Optional[int] = None) -> None:
        self._expect("proposed")
        self.state = "quiescing"
        self.quiesce_started = now

    def swap(self) -> CacheEntry:
        """Install the proposal's entry (revision-bumped) and bump the
        plan epoch. Only legal from ``quiescing`` — the CALLER owns
        the drain census, and installing with old-plan traffic still
        in flight is exactly the defect the model checker's
        ``swap_without_quiesce`` mutant reinstates."""
        self._expect("quiescing")
        prop = self.proposal
        old_rev = prop.old.revision if prop.old is not None else 0
        installed = dataclasses.replace(
            prop.new, revision=max(old_rev, prop.new.revision) + 1
        )
        self.cache.put(self.key, installed, keep_best=False)
        prop.new = installed
        self.plan_epoch += 1
        self.state = "swapped"
        return installed

    def commit(self) -> None:
        self._expect("swapped")
        self.state = "committed"
        self.committed_swaps += 1

    def rollback(self, reason: str = "") -> None:
        """Abort the arc. Pre-swap nothing was installed, so nothing
        moves; post-swap the pre-proposal entry is re-installed under
        a FURTHER epoch bump (monotone — the restore is itself a plan
        change). Either way the key keeps a servable entry: zero
        lost-accepted across the abort."""
        self._expect("proposed", "quiescing", "swapped")
        if self.state == "swapped":
            if self.proposal.old is not None:
                self.cache.put(self.key, self.proposal.old,
                               keep_best=False)
            else:
                self.cache.entries.pop(self.key.signature(), None)
            self.plan_epoch += 1
        self.state = "rolled_back"
        self.rolled_back_swaps += 1
        self.last_rollback_reason = reason

    # -- the stale gate -------------------------------------------------

    def validate(self, plan_epoch: int, what: str = "") -> None:
        """The data-path stale gate: traffic stamped with a plan epoch
        other than the current one raises :class:`StalePlanError`
        naming the key, the stale stamp, and the current epoch."""
        if plan_epoch != self.plan_epoch:
            raise StalePlanError(
                self.key.signature(), plan_epoch, self.plan_epoch,
                what=what,
            )
