"""Runtime deadlines: a stuck dispatch becomes a named error.

PyTorch counterpart of :mod:`smi_tpu.utils.watchdog`. A :class:`Deadline`
is threaded through channel transfers and ring-tier collectives and
checked cooperatively at each dispatch step (every collective launch,
every ring hop): the next host-side step after the budget is spent raises
instead of issuing more work. :func:`run_with_deadline` hard-bounds
blocking host work (the readback of :func:`smi_tpu_torch.utils.tracing.
timed`): the call runs in a worker thread that is abandoned on expiry. A
kernel that is already spinning is bounded on the device, where every
flag wait of the ring kernels traps after ten seconds.

Every timeout carries a *state dump* when a provider is given; the ring
tier attaches :func:`smi_tpu_torch.parallel.faults.mirror_state_provider`
(:meth:`Deadline.with_provider`), so a ring collective that times out
reports the per-rank state of its credit protocol — which wait each rank
parks at when no remote traffic completes — as text and, structured, on
:attr:`WatchdogTimeout.state`, where
:func:`smi_tpu_torch.parallel.recovery.failed_ranks_of` reads the
stalled ranks.

No torch import at module load: the module is usable from the
pure-Python protocol layer as well.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time
from typing import Any, Callable, Optional

#: Environment knob: a default watchdog budget (seconds) applied when
#: callers construct :func:`default_deadline`. Unset/empty = no default
#: watchdog (zero overhead on the healthy path).
WATCHDOG_ENV = "SMI_WATCHDOG_SECS"


class WatchdogTimeout(TimeoutError):
    """A deadline expired; carries the protocol-state dump if known.

    ``state_dump`` is the formatted per-rank dump (or None); ``elapsed``
    and ``budget`` are seconds. ``state`` is the STRUCTURED per-rank
    dump (the :meth:`credits.RingSimulator.state_dump` dict) when the
    provider supplied one — the machine-readable payload
    :func:`smi_tpu_torch.parallel.recovery.failed_ranks_of` extracts
    crash-stopped ranks from to drive a ULFM-style shrink.
    """

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


def _attach_recorder_tail(error: BaseException, recorder) -> None:
    """Bounded flight-recorder tail onto a timeout in flight
    (duck-typed: any object with ``tail()``): ``error.recorder_tail``
    always, and a ``flight_recorder`` entry inside the structured
    ``state`` dict when the error carries one. Never raises."""
    if recorder is None:
        return
    try:
        tail = recorder.tail()
        error.recorder_tail = tail
        state = getattr(error, "state", None)
        if isinstance(state, dict):
            state.setdefault("flight_recorder", tail)
    except Exception:
        pass


def _provided(state_provider):
    """(text, structured) from a provider — a provider may return a bare
    string, or a ``(str, dict)`` pair whose dict rides the error's
    ``state`` attribute for programmatic recovery. A failing provider
    becomes the text: the dump must never mask the timeout."""
    if state_provider is None:
        return None, None
    try:
        dump = state_provider()
    except Exception as e:
        return f"(state dump unavailable: {type(e).__name__}: {e})", None
    if isinstance(dump, tuple) and len(dump) == 2:
        return dump
    return dump, None


class Deadline:
    """A monotonic time budget shared across the steps of one operation.

    Construct once at the entry point and pass down: each dispatch step
    calls :meth:`check` (or reads :meth:`remaining` for a blocking
    wait's own timeout). ``seconds=None`` never expires.
    ``state_provider`` is a zero-argument callable returning the dump to
    attach on expiry (e.g. ``faults.mirror_state_provider("reduce",
    n)``). ``recorder`` is an optional flight recorder (any object with
    ``tail()``): an expiring deadline then carries its bounded event
    tail next to the protocol mirror.
    """

    def __init__(self, seconds: Optional[float],
                 state_provider: Optional[Callable[[], str]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 recorder=None):
        if seconds is not None and seconds < 0:
            raise ValueError(f"deadline must be >= 0, got {seconds}")
        self.budget = seconds
        self.state_provider = state_provider
        self.recorder = recorder
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

    def _dump(self):
        """(text, structured) from this deadline's provider."""
        return _provided(self.state_provider)

    def check(self, context: str = "") -> None:
        """Raise :class:`WatchdogTimeout` if the budget is spent."""
        if not self.expired():
            return
        where = f" during {context}" if context else ""
        text, state = self._dump()
        error = WatchdogTimeout(
            f"deadline of {self.budget:.3g}s exceeded{where} "
            f"(elapsed {self.elapsed():.3g}s)",
            state_dump=text, state=state,
            elapsed=self.elapsed(), budget=self.budget,
        )
        _attach_recorder_tail(error, self.recorder)
        raise error

    def with_provider(self, state_provider: Callable[[], str]) -> "Deadline":
        """Same running clock, different dump source — lets inner layers
        attach their own protocol mirror without restarting the budget."""
        d = Deadline.__new__(Deadline)
        d.budget = self.budget
        d.state_provider = state_provider
        d.recorder = self.recorder
        d._clock = self._clock
        d._start = self._start
        return d


def default_deadline(
    state_provider: Optional[Callable[[], str]] = None,
) -> Optional[Deadline]:
    """A :class:`Deadline` from ``$SMI_WATCHDOG_SECS``, or None.

    Unset, empty, and non-positive values all mean "no watchdog" —
    ``SMI_WATCHDOG_SECS=0`` is off, not an instantly-expired budget. A
    malformed or non-finite value is a loud error naming the knob and
    the value: a typo silently disabling the watchdog would undo the
    operator's intent without a trace.
    """
    raw = os.environ.get(WATCHDOG_ENV, "").strip()
    if not raw:
        return None
    try:
        seconds = float(raw)
    except ValueError:
        raise ValueError(
            f"${WATCHDOG_ENV} must be a number of seconds (watchdog "
            f"budget; 0 or negative disables), got {raw!r}"
        ) from None
    if not math.isfinite(seconds):
        # NaN never compares expired; +inf never fires — both would
        # silently disable the watchdog (0 is the explicit off switch)
        raise ValueError(
            f"${WATCHDOG_ENV} must be a finite number of seconds "
            f"(watchdog budget; 0 or negative disables), got {raw!r}"
        )
    if seconds <= 0:
        return None
    return Deadline(seconds, state_provider=state_provider)


def _caller_cuda_event():
    """An event recorded on the caller's current CUDA stream, or None
    when CUDA was never initialised in this process (a CPU run)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream())
    return event


def run_with_deadline(
    fn: Callable[[], Any],
    seconds: Optional[float],
    state_provider: Optional[Callable[[], str]] = None,
    context: str = "",
    recorder=None,
) -> Any:
    """Run ``fn()`` with a hard time budget.

    The call runs in a daemon worker thread; on expiry the caller gets a
    :class:`WatchdogTimeout` (with the state dump) while the worker is
    abandoned — a hung device call cannot be cancelled from Python, but
    the host stops waiting on it. ``seconds=None`` runs inline (no
    thread, no overhead). Exceptions from ``fn`` propagate unchanged.

    Wrap the blocking readback, not the launches: the worker's current
    CUDA stream is not the caller's (a rank thread of a ``LocalWorld``
    queues on a stream of its own), so the caller records an event on
    its current stream here and the worker waits on it before ``fn``
    runs — the copy then reads what the caller's kernels wrote.

    The worker is a *daemon* thread on purpose: a non-daemon thread is
    joined at interpreter exit, so an abandoned hung call would stall
    process shutdown — the exact hang the watchdog exists to bound.
    """
    if seconds is None:
        return fn()
    results: "queue.Queue" = queue.Queue(maxsize=1)
    ready = _caller_cuda_event()

    def worker() -> None:
        try:
            if ready is not None:
                ready.synchronize()
            results.put(("ok", fn()))
        except BaseException as e:  # deliver, don't die silently
            results.put(("err", e))

    start = time.monotonic()
    thread = threading.Thread(
        target=worker, name="smi-watchdog-worker", daemon=True
    )
    thread.start()
    try:
        kind, value = results.get(timeout=seconds)
    except queue.Empty:
        dump, state = _provided(state_provider)
        where = f" during {context}" if context else ""
        error = WatchdogTimeout(
            f"hard watchdog of {seconds:.3g}s exceeded{where} — the "
            f"device call did not complete (worker thread abandoned)",
            state_dump=dump, state=state,
            elapsed=time.monotonic() - start, budget=seconds,
        )
        _attach_recorder_tail(error, recorder)
        raise error from None
    if kind == "err":
        raise value
    return value
