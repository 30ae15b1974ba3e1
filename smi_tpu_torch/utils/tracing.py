"""Profiling and timing: the counterpart of :mod:`smi_tpu.utils.tracing`.

The reference measures with kernel-event futures
(``bandwidth_benchmark.cpp:144-162``) and wall-clock helpers
(``include/utils/utils.hpp:10-23``). On the card the device-side story is
``torch.profiler`` (CUPTI): a Chrome trace of the host's calls and the
card's kernels on one clock, which Perfetto or ``chrome://tracing``
opens.

- :func:`trace` — context manager writing a trace file into a directory;
  it records every thread, the rank threads of a ``LocalWorld`` too.
- :func:`annotate` — a named span on the trace's timeline while a
  profiler runs, on any thread; with none running, one read of the
  profiler's global flag and a shared null context.
- :func:`timed` — wall-clock timing of a callable with completion forced
  by reading its result back to the host, returning (result, seconds);
  optionally bounded by a watchdog and fed to a sample sink.

The port's spans, one at each layer boundary (names are fixed: the
benchmark's readers match them):

- ``smi.stencil.solve`` / ``.pass`` / ``.sweep`` / ``.launch`` — a
  stencil function's call, each k-sweep pass, each remainder sweep, and
  the ctypes entry of a stencil kernel with its status check;
- ``smi.halo.phase1`` / ``.phase2`` (corner-complete exchange: the side
  columns moved and waited for; the extended rows built and issued),
  ``smi.halo.start`` (one-phase exchange) and ``smi.halo.finish`` (the
  wait, both forms): siblings, never nested, so their sum is the halo's
  host time;
- ``smi.world.run`` (the caller of ``LocalWorld.run``), ``smi.world.rank``
  (each rank thread), ``smi.world.rendezvous.<call>`` with its children
  ``smi.world.arrive`` (this rank's stream sync and wait for the others),
  ``smi.world.lead`` (the leader's joint work) and ``smi.world.release``;
- ``smi.collective.<name>`` — each public collective;
- ``smi.ring.launch`` — the ring tier's one launch for the whole world;
- ``smi.train.step`` with its children ``smi.train.forward``,
  ``.backward`` and ``.update`` — one call of a ``make_train_step``
  step (``models/transformer.py``);
- ``smi.attn.sliding`` / ``smi.attn.full`` — a block's attention from
  its norm to its gate, by the layer's kind (windowed or not);
- ``smi.moe.route`` / ``.dispatch`` / ``.experts`` / ``.combine`` — the
  expert layer's phases (``models/moe.py``), siblings, never nested;
  the dispatch holds the layer's one device->host read;
- ``smi.lm.head`` — a language model's final norm, head and loss;
- ``smi.host.gc.gen<N>`` — a garbage-collection pass of generation N.

A checkpointed layer opens its spans again when the backward recomputes
it.

In Perfetto a device idle stretch lies under the span open on the host
at that time; a rank's ``smi.world.arrive`` is its wait for the slowest
rank. Spans carry no arguments (the Chrome trace drops them): a rank
span belongs to the ``smi.world.run`` whose interval holds it.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Any, Callable, Iterator, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

#: what :func:`annotate` returns while no profiler runs
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (the host, every thread of it, and the
    card when there is one) and write its Chrome trace into ``log_dir``
    as ``trace-<pid>-<ns>.json``. A default profile records no host
    operation of a thread started after it began, and ``LocalWorld.run``
    starts its rank threads anew on every call."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=config) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """Named timeline span: ``with annotate("smi.halo.phase1"): ...``.

    Reads ``torch.autograd.profiler._is_profiler_enabled``, which any
    running ``torch.profiler.profile`` sets for every thread (the
    thread-local ``torch._C._autograd._profiler_enabled()`` reads False
    on a thread started after the profiler). Off, it returns a shared
    null context: ``record_function`` alone costs microseconds a call.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


#: the garbage collector's open span, if any (collections never nest)
_gc_span: list = []


def _gc_callback(phase: str, info: dict) -> None:
    """A ``smi.host.gc.gen<N>`` span around each collection that starts
    while a profiler runs."""
    if phase == "start":
        if _autograd_profiler._is_profiler_enabled:
            span = torch.profiler.record_function(
                f"smi.host.gc.gen{info['generation']}")
            span.__enter__()
            _gc_span.append(span)
    elif _gc_span:
        _gc_span.pop().__exit__(None, None, None)


gc.callbacks.append(_gc_callback)


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
