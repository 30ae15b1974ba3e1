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
  by reading its result back to the host, returning (result, seconds).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator, Tuple

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


def timed(fn: Callable[[], Any]) -> Tuple[Any, float]:
    """Run ``fn`` and return (result, elapsed seconds), with completion
    forced by a host readback of every tensor in the result: queued CUDA
    work returns before it has run, so a bare call times the enqueue."""
    t0 = time.perf_counter()
    result = fn()
    _read_back(result)
    return result, time.perf_counter() - t0
