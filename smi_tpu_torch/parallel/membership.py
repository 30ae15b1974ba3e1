"""Elastic membership: the epoch gate and the failure detector's settings.

PyTorch counterpart of part of :mod:`smi_tpu.parallel.membership`. Every
composition change of a communicator — :meth:`~smi_tpu_torch.parallel.
mesh.Communicator.shrink` and :meth:`~smi_tpu_torch.parallel.mesh.
Communicator.regrow` — bumps its membership epoch, and traffic tagged
with another epoch raises :class:`StaleEpochError` naming the sender,
its epoch and the current one
(:meth:`~smi_tpu_torch.parallel.mesh.Communicator.validate_epoch`), so a
dead incarnation's packets are never folded into the regrown job.

The phi-accrual detector's thresholds are here too, because
:func:`smi_tpu_torch.parallel.checkpoint.elastic_env_config` reports
them. The detector itself, :class:`MembershipView` and the pod campaigns
are not ported yet.
"""

from __future__ import annotations

#: Detector thresholds (phi is -log10 of the probability the heartbeat
#: is merely late): suspect at phi >= 4 — a 1-in-10^4 late arrival —
#: and confirm dead at phi >= 8.
SUSPECT_PHI = 4.0
DEAD_PHI = 8.0

#: Nominal heartbeat period in step-clock ticks; the elastic soak
#: advances the clock by one period per job iteration.
HEARTBEAT_INTERVAL = 10

#: Confirmation grace: a suspect is only confirmed dead once it has
#: stayed suspected (phi never dipping below the suspect threshold)
#: for four full heartbeat periods. Suspicion is cheap and reversible
#: (drain new work); death is not (shrink + restore). The observable
#: silence of a silent-but-alive rank is its window plus up to one
#: period of phase on each side, so the grace absorbs two periods of
#: phase beyond the calibrated window.
CONFIRM_GRACE_TICKS = 4 * HEARTBEAT_INTERVAL


class StaleEpochError(RuntimeError):
    """Traffic tagged with a mismatched membership epoch.

    Raised loudly at the first validation point — never silently
    dropped, never folded into the current epoch's state. Carries the
    sending ``rank``, the ``stale`` epoch it claimed, and the
    ``current`` epoch of the validating view. The wording names the
    party at fault: an OLDER tag means the sender is a superseded
    incarnation (re-join via regrow); a NEWER tag means the
    *validator* missed a membership change (split view).
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
