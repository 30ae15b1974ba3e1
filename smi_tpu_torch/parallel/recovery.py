"""Recovery's runtime bridge: failed ranks, heirs, ring re-planning.

PyTorch counterpart of the runtime half of
:mod:`smi_tpu.parallel.recovery`. After a detected failure — a
:class:`~smi_tpu_torch.utils.watchdog.WatchdogTimeout` whose state dump
names stalled ranks, or a set of ranks the caller names — the job goes
on ULFM-style on the survivors: :func:`recover_communicator` shrinks the
communicator and names each failed rank's **heir**, the nearest
surviving successor on the ring, which takes over its duties (its
progress log, its logged contribution). :func:`plan_ring` re-orders a
ring so that no down wire joins two neighbours, and
:func:`_check_cut_routable` holds such a cut against the routing layer.

The progress logs, the recovery driver over the fault simulator and the
chaos campaigns are not ported yet; this module imports neither.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Set, Tuple


class UnrecoverableError(RuntimeError):
    """Recovery exhausted its attempts or its survivors.

    Carries the attempt trail so an operator sees every verdict on the
    way down. ``annihilated`` marks the one *expected* unrecoverable
    shape — every rank crash-stopped, nobody left to shrink onto."""

    def __init__(self, message: str, attempts=None,
                 annihilated: bool = False):
        super().__init__(message)
        self.attempts = attempts or []
        self.annihilated = annihilated


def failed_ranks_of(error, survivors: Optional[Sequence[int]] = None
                    ) -> Set[int]:
    """Crash-stopped ranks named by a detected failure.

    Reads the per-rank protocol-state dump a
    :class:`~smi_tpu_torch.utils.watchdog.WatchdogTimeout` carries
    (``.state``): every rank the dump marks ``"stalled"``. ``survivors``
    maps the dump's ring-local indices back to global ranks on resumed
    rings.
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
    :class:`~smi_tpu_torch.parallel.routing.FailureSet`, and asserts
    every surviving pair still routes around it — raising
    :class:`~smi_tpu_torch.parallel.routing.RouteCutError` (naming the
    cut) when the failure isolates someone. The logical ring re-order of
    :func:`plan_ring` is only legal because the physical ring still
    connects the survivors. Needs ``networkx``.
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
    ring — the rank that inherits its duties (and reads its log).
    :meth:`~smi_tpu_torch.parallel.mesh.Communicator.heirs` delegates
    here, so there is one inheritance rule."""
    survivors = set(survivors)
    for step in range(1, n + 1):
        cand = (rank + step) % n
        if cand in survivors:
            return cand
    raise UnrecoverableError(f"no surviving heir for rank {rank}")


def recover_communicator(comm, error_or_ranks):
    """ULFM shrink for the runtime layer: build the surviving
    communicator after a detected failure.

    ``error_or_ranks`` is either an iterable of failed ranks or a caught
    error carrying a per-rank state dump (a
    :class:`~smi_tpu_torch.utils.watchdog.WatchdogTimeout`) — the
    stalled ranks are extracted with :func:`failed_ranks_of`. Returns
    ``(shrunk_comm, heirs)`` where ``heirs`` maps each failed rank to
    the survivor inheriting its duties (:meth:`Communicator.heirs`).
    ``shrunk_comm`` is the caller's communicator in the survivors' world
    (:meth:`Communicator.shrink`), so a failed rank cannot ask. Raises
    ``ValueError`` when the failure names no ranks (nothing actionable
    to shrink) — a transient fault should be retried, not shrunk.
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
