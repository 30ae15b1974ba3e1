"""Runtime deadlines: a stuck dispatch becomes a named error.

PyTorch counterpart of :mod:`smi_tpu.utils.watchdog`, of which
:class:`Deadline` and :class:`WatchdogTimeout` are ported. A deadline is
threaded through channel transfers and ring-tier collectives and checked
cooperatively at each dispatch step (every collective launch, every ring
hop): the next host-side step after the budget is spent raises instead of
issuing more work. A kernel that is already spinning is bounded on the
device, where every flag wait traps after ten seconds.

The JAX package attaches a per-rank mirror of the credit protocol's state
to a ring-tier timeout; that mirror is not ported yet, so a deadline here
carries a state dump only when the caller gives a ``state_provider``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class WatchdogTimeout(TimeoutError):
    """A deadline expired. ``state_dump`` is the provider's text (or
    None); ``elapsed`` and ``budget`` are seconds. ``state`` is the
    structured per-rank dump (``{rank: {"state": ...}}``) when the raiser
    has one: :func:`smi_tpu_torch.parallel.recovery.failed_ranks_of`
    reads the ranks it marks ``"stalled"`` from it."""

    def __init__(self, message: str, state_dump: Optional[str] = None,
                 elapsed: Optional[float] = None,
                 budget: Optional[float] = None,
                 state: Optional[dict] = None):
        if state_dump:
            message = f"{message}\n{state_dump}"
        super().__init__(message)
        self.state_dump = state_dump
        self.elapsed = elapsed
        self.budget = budget
        self.state = state


class Deadline:
    """A monotonic time budget shared across the steps of one operation.

    Construct once at the entry point and pass down: each dispatch step
    calls :meth:`check`. ``seconds=None`` never expires.
    ``state_provider`` is a zero-argument callable whose text is attached
    to the timeout.
    """

    def __init__(self, seconds: Optional[float],
                 state_provider: Optional[Callable[[], str]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if seconds is not None and seconds < 0:
            raise ValueError(f"deadline must be >= 0, got {seconds}")
        self.budget = seconds
        self.state_provider = state_provider
        self._clock = clock
        self._start = clock()

    def elapsed(self) -> float:
        return self._clock() - self._start

    def remaining(self) -> Optional[float]:
        """Seconds left (None = unbounded; never negative)."""
        if self.budget is None:
            return None
        return max(0.0, self.budget - self.elapsed())

    def expired(self) -> bool:
        return self.budget is not None and self.elapsed() >= self.budget

    def check(self, context: str = "") -> None:
        """Raise :class:`WatchdogTimeout` if the budget is spent."""
        if not self.expired():
            return
        dump = None
        if self.state_provider is not None:
            try:
                dump = self.state_provider()
            except Exception as e:  # the dump must never mask the timeout
                dump = f"(state dump unavailable: {type(e).__name__}: {e})"
        where = f" during {context}" if context else ""
        raise WatchdogTimeout(
            f"deadline of {self.budget:.3g}s exceeded{where} "
            f"(elapsed {self.elapsed():.3g}s)",
            state_dump=dump, elapsed=self.elapsed(), budget=self.budget,
        )
