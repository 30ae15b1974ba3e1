"""Load-aware tenant placement for the serving front-end.

The port's copy of :mod:`smi_tpu.serving.placement`, kept in step
with it line for line (pure Python).

Since r8 a tenant's home rank has been ``crc32(tenant) % n`` — blind,
but deterministic and uniform in expectation. This module makes
placement a *decision* without giving up determinism:

- :func:`tenant_base_rank` — the crc32 rule, moved here as the single
  authority (the front-end re-exports it). It remains the DEFAULT and
  the tie-break: a :class:`PlacementMap` that is unarmed, or armed but
  seeing equal load everywhere, places byte-identically to r8.
- :class:`PlacementMap` — a sticky tenant→base-rank map. When armed,
  a NEW tenant lands on the least-loaded current member, load measured
  from the shipped metrics registry gauges (wire-lane occupancy +
  credit-stall ticks — the same signals the blame engine convicts
  with). Already-placed tenants never move implicitly: routing
  stability is what the epoch machinery's stale gates are sized for,
  so only an explicit migration (:mod:`smi_tpu_torch.serving.elasticity`)
  re-pins a tenant.

Ties resolve *toward* crc32: if the tenant's crc32 home is among the
least-loaded members it wins outright; otherwise the nearest successor
of the home rank (mod ``n``) among the least-loaded wins — the
``heir_of`` direction, so the choice is stable under membership
changes and independent of dict iteration order.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, Iterable, Optional


def tenant_base_rank(tenant: str, n: int) -> int:
    """Deterministic tenant -> home rank (stable across runs): the
    untuned placement rule and the armed map's tie-break."""
    return zlib.crc32(f"tenant:{tenant}".encode()) % n


class PlacementMap:
    """Sticky tenant→base-rank placement with optional load awareness.

    ``place(tenant, members, load)`` returns the tenant's base rank:

    - a tenant seen before keeps its pin (failover around a currently
      dead base stays ``route_owner``'s job, exactly as before);
    - a new tenant under an UNARMED map gets :func:`tenant_base_rank`
      — byte-identical to the r8 rule, pinned so a later arming can
      never retroactively move it;
    - a new tenant under an ARMED map gets the least-loaded member,
      crc32 as the tie-break.

    ``load`` is a callable ``rank -> float`` (lower = freer); the
    front-end feeds it from the metrics registry. The map never reads
    metrics itself so it stays trivially testable and picklable.
    """

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"placement needs n >= 1 ranks, got {n}")
        self.n = n
        self.armed = False
        self._pins: Dict[str, int] = {}
        #: (tenant, base, reason) audit trail — "crc32" | "load" |
        #: "migrate"; the campaign report quotes it.
        self.decisions: list = []
        #: (tenant, base, token_epoch) — pins written under a quorum
        #: fencing token (the partition-tolerance audit trail).
        self.fenced_pins: list = []

    def pin(self, tenant: str, rank: int, reason: str = "migrate",
            token=None) -> None:
        """Explicitly re-pin a tenant (the migration commit path).

        ``token`` is the :class:`~smi_tpu_torch.parallel.membership.FencingToken`
        under which the write was authorised. The map records it in a
        separate audit trail (``fenced_pins``) rather than widening the
        ``decisions`` tuples — quorum *checking* is the minting caller's
        job (``check_fencing_token`` against the live view); the map only
        has to make the provenance auditable.
        """
        if not 0 <= rank < self.n:
            raise ValueError(
                f"cannot pin tenant {tenant!r} to rank {rank}: out of "
                f"range for n={self.n}"
            )
        self._pins[tenant] = rank
        self.decisions.append((tenant, rank, reason))
        if token is not None:
            self.fenced_pins.append((tenant, rank, token.epoch))

    def base_of(self, tenant: str) -> Optional[int]:
        """The tenant's pinned base, or None if never placed."""
        return self._pins.get(tenant)

    def residents(self) -> Dict[int, int]:
        """rank -> count of tenants pinned there. The migration
        destination's tie-break: instantaneous lane occupancy reads 0
        between bursts, so ties resolve toward the rank with the
        fewest tenants parked on it — the one with standing headroom,
        not the one momentarily idle."""
        out: Dict[int, int] = {}
        for rank in self._pins.values():
            out[rank] = out.get(rank, 0) + 1
        return out

    def place(self, tenant: str, members: Iterable[int],
              load: Optional[Callable[[int], float]] = None) -> int:
        """The tenant's base rank (pinning it on first sight)."""
        pinned = self._pins.get(tenant)
        if pinned is not None:
            return pinned
        home = tenant_base_rank(tenant, self.n)
        if not self.armed or load is None:
            self._pins[tenant] = home
            self.decisions.append((tenant, home, "crc32"))
            return home
        ranks = sorted(members)
        if not ranks:
            raise ValueError(
                f"cannot place tenant {tenant!r}: no members"
            )
        best = min(load(r) for r in ranks)
        candidates = [r for r in ranks if load(r) == best]
        if home in candidates:
            choice = home
        else:
            # nearest successor of the crc32 home among the least
            # loaded — the heir_of direction, membership-stable
            choice = min(candidates,
                         key=lambda r: ((r - home) % self.n, r))
        reason = "crc32" if choice == home else "load"
        self._pins[tenant] = choice
        self.decisions.append((tenant, choice, reason))
        return choice

    def report(self) -> dict:
        """Deterministic summary for campaign reports."""
        by_reason: Dict[str, int] = {}
        for _, _, reason in self.decisions:
            by_reason[reason] = by_reason.get(reason, 0) + 1
        return {
            "armed": self.armed,
            "tenants": len(self._pins),
            "decisions": {k: by_reason[k] for k in sorted(by_reason)},
            "fenced_pins": len(self.fenced_pins),
        }
