"""Profiling and timing: the counterpart of :mod:`smi_tpu.utils.tracing`.

The reference measures with kernel-event futures
(``bandwidth_benchmark.cpp:144-162``) and wall-clock helpers
(``include/utils/utils.hpp:10-23``). On the card the device-side story is
``torch.profiler`` (CUPTI): a Chrome trace of the host's calls and the
card's kernels, which Perfetto or ``chrome://tracing`` opens.

- :func:`trace` — context manager writing a trace file into a directory.
- :func:`annotate` — a named region on the trace's timeline (and an NVTX
  range on CUDA).
- :func:`timed` — wall-clock timing of a callable with completion forced
  by reading its result back to the host, returning (result, seconds);
  optionally bounded by a watchdog and fed to a sample sink.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (the host, and the card when there is
    one) and write its Chrome trace into ``log_dir`` as
    ``trace-<pid>-<ns>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named timeline region: ``with annotate("halo-exchange"): ...``."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def _read_back(value) -> None:
    if torch.is_tensor(value):
        value.cpu()
    elif isinstance(value, (list, tuple)):
        for v in value:
            _read_back(v)
    elif isinstance(value, dict):
        for v in value.values():
            _read_back(v)


def timed(
    fn: Callable[[], Any],
    deadline_s: Optional[float] = None,
    state_provider: Optional[Callable[[], str]] = None,
    sink=None,
    op: str = "timed",
    payload_bytes: Optional[float] = None,
    tenant: Optional[str] = None,
) -> Tuple[Any, float]:
    """Run ``fn`` and return (result, elapsed seconds), with completion
    forced by a host readback of every tensor in the result: queued CUDA
    work returns before it has run, so a bare call times the enqueue.

    ``deadline_s`` arms a hard watchdog
    (:func:`smi_tpu_torch.utils.watchdog.run_with_deadline`) around the
    readback: a device hang becomes a ``WatchdogTimeout`` — carrying the
    ``state_provider``'s protocol-state dump when one is given (e.g.
    :func:`smi_tpu_torch.parallel.faults.mirror_state_provider`) —
    instead of a stuck host. Defaults to ``$SMI_WATCHDOG_SECS`` when
    unset. ``fn()`` itself runs in the caller's thread, on the caller's
    stream; only the readback crosses into the watchdog's worker.

    ``sink`` receives the measurement: an object with a ``record(op,
    seconds, payload_bytes=, tenant=)`` method (the online tuner,
    :class:`smi_tpu_torch.tuning.online.OnlineTuner`), or any plain
    callable taking ``(op, seconds)``. ``op`` / ``payload_bytes`` /
    ``tenant`` label the sample. A sink's failure propagates: a
    measurement pipeline that silently drops samples would corrupt every
    decision made on them.
    """
    from smi_tpu_torch.utils import watchdog as _watchdog

    if deadline_s is None:
        default = _watchdog.default_deadline()
        deadline_s = default.budget if default is not None else None

    t0 = time.perf_counter()
    result = fn()
    _watchdog.run_with_deadline(
        lambda: _read_back(result), deadline_s,
        state_provider=state_provider, context="timed() readback",
    )
    elapsed = time.perf_counter() - t0
    if sink is not None:
        record = getattr(sink, "record", None)
        if record is not None:
            record(op, elapsed, payload_bytes=payload_bytes,
                   tenant=tenant)
        else:
            sink(op, elapsed)
    return result, elapsed
