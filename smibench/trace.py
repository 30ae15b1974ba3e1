"""The traced sub-window: ``torch.profiler`` over a fixed count of
solves, read back from its Chrome trace into plain intervals.

The trace file goes to a temporary directory under ``$TMPDIR`` and is
deleted once read. Device operations are the trace's kernels, copies and
sets; host operations are the CPU-side events (operators, CUDA runtime
calls, the harness's own ``smibench.*`` annotations) of every thread.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

from smibench import yardstick

#: the annotation the harness puts around each traced solve
SOLVE_SPAN = "smibench.solve"

DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATEGORIES = frozenset({"cpu_op", "cuda_runtime", "cuda_driver",
                             "user_annotation"})

#: entries a breakdown list keeps
BREAKDOWN_ENTRIES = 10


@dataclasses.dataclass
class Trace:
    """What the traced sub-window shows, in seconds on one clock."""

    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        return [(max(s, lo), min(e, hi)) for _, s, e in self.device_ops
                if e > lo and s < hi]

    @property
    def busy_s(self) -> float:
        return yardstick.union_seconds(self.device_intervals())

    def idle_pct(self) -> Optional[float]:
        """The share of the window in which no device operation ran, in
        %; None when the trace shows no device work."""
        busy = self.busy_s
        if busy <= 0 or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - busy / self.window_s)

    def ops_named(self, name: str) -> List[Tuple[str, float, float]]:
        """Device operations of the kernel function ``name`` (its
        unqualified name, as in ``void (anonymous namespace)::name<16>(
        ...)``)."""
        pattern = re.compile(r"(?:^|[\s:])" + re.escape(name) + r"[<(]")
        return [op for op in self.device_ops if pattern.search(op[0])]

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the longest
        idle gaps named by the innermost host operation open at their
        middle."""
        by_name: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        gaps = yardstick.idle_gaps(self.device_intervals(), *self.window)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[self.host_activity((s + e) / 2), e - s]
                 for s, e in gaps[:BREAKDOWN_ENTRIES]]
        return {"device_ops": [[n, t] for n, t in top[:BREAKDOWN_ENTRIES]],
                "idle_gaps": named}

    def host_activity(self, t: float) -> str:
        """The shortest host operation open at ``t`` other than the
        solve span itself; when none is, the Python code after the last
        one that ended."""
        ops = [op for op in self.host_ops if op[0] != SOLVE_SPAN]
        open_ops = [(e - s, name) for name, s, e in ops if s <= t <= e]
        if open_ops:
            return min(open_ops)[1]
        ended = [(e, name) for name, s, e in ops if e < t]
        return f"Python after {max(ended)[1]}" if ended else "Python"


def parse_chrome_trace(events: List[dict]) -> Trace:
    """A :class:`Trace` from the ``traceEvents`` of a Chrome trace: the
    window runs from the second solve span's start (the first carries
    the profiler's own start-up) to the last one's end; with one span,
    over that span."""
    device, host, spans = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        name = str(ev.get("name", ""))
        if cat in DEVICE_CATEGORIES:
            device.append((name, s, e))
        elif cat in HOST_CATEGORIES:
            host.append((name, s, e))
            if name == SOLVE_SPAN:
                spans.append((s, e))
    if not spans:
        raise ValueError(f"the trace holds no {SOLVE_SPAN!r} span")
    spans.sort()
    window = (spans[min(1, len(spans) - 1)][0], max(e for _, e in spans))
    return Trace(device, host, window)


class Profiler:
    """``torch.profiler`` over CPU and, on a card, CUDA activity; read
    with :meth:`trace` once stopped."""

    def __init__(self, cuda: bool):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def trace(self) -> Trace:
        with tempfile.TemporaryDirectory(prefix="smibench-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return parse_chrome_trace(events)


def span(name: str):
    """A profiler annotation (a no-op when no profiler runs)."""
    import torch

    return torch.profiler.record_function(name)
