"""One run of one cell: set-up, a closed-loop window of solves, the
traced sub-window, the check against the plain reference, the result.

A *solve* is one call of the cell's entry into the program, ended by a
synchronise of the card; the next is issued when the last returns. The
window runs from the first timed solve's start until the first solve
that ends at or after ``seconds``; its rates are the work of every solve
in it over its whole wall. A traced run profiles the window's first
``trace_solves`` solves; the output judged is the last solve's and one
drawn by the seed from the solves after the traced ones.

:func:`run_cell` takes the device: the command line hands it the card
and refuses to run without one; the tests hand it the CPU at tiny sizes.
"""

from __future__ import annotations

import dataclasses
import math
import random
import sys
import time
from typing import Dict, List, Optional

from smibench import spec
from smibench import trace as tracing


@dataclasses.dataclass
class Run:
    """What a metric's reader sees of a run."""

    workload: dict
    config: dict
    facts: dict              # the cell's shapes as the driver set them up
    work: Dict[str, float]   # work of one solve, by unit
    setup_s: float
    walls: List[float]       # every timed solve's wall, in order
    window_s: float
    counters: Dict[str, int]
    trace: Optional[tracing.Trace]

    @property
    def solves(self) -> int:
        return len(self.walls)

    def total(self, unit: str) -> Optional[float]:
        """The work of every solve in the window, or None when a solve
        of this cell does no work of ``unit``."""
        per = self.work.get(unit)
        return None if per is None else per * self.solves


def _merged(base: dict, override: Optional[dict]) -> dict:
    out = dict(base)
    out.update(override or {})
    return out


def _device_block(device, chips: int, trace: Optional[tracing.Trace]):
    import torch

    if device.type == "cuda":
        info = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips)),
        }
    else:
        info = {"platform": device.type, "kind": device.type, "count": 1,
                "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None,
             overrides: Optional[dict] = None,
             program: str = "port") -> dict:
    """One run of ``cell`` on ``device``: the result line as a dict.

    ``overrides`` (tests only) replaces keys of the configuration
    (``"config"``) and of the traffic (``"traffic"``); ``program``
    ``"control"`` puts the cell's lower-precision reference in the
    program's place."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    overrides = overrides or {}
    bench = spec.benchmark()
    entry = spec.cell_entry(bench, cell)
    workload = spec.workload(cell)
    config = _merged(spec.config(entry["config"]), overrides.get("config"))
    traffic = _merged(workload["traffic"], overrides.get("traffic"))
    readers = {m["name"]: spec.load_module("metrics", m["name"])
               for m in spec.metrics_for(bench, cell, trace)}
    driver = spec.load_module("drivers", entry["config"])

    subject = driver.Cell(config, traffic, seed, device, program=program)
    subject.warm()
    cuda = device.type == "cuda"
    sampler = random.Random(seed)
    kept, out = None, None
    walls: List[float] = []
    failed = 0
    traced = 0   # solves in the traced sub-window
    trace_solves = int(workload["trace_solves"]) if trace else 0
    profiler = tracing.Profiler(cuda) if trace else None

    subject.reset_counters()
    if profiler is not None:
        profiler.start()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    end = t0
    while True:
        # while a solve runs the harness holds no output but the kept one
        # (set-up's warm solves hold none), so that the trace shows no
        # allocation of its own
        out = None
        start = time.perf_counter()
        try:
            with tracing.span(tracing.SOLVE_SPAN):
                out = subject.solve()
        except Exception as exc:  # the run reports it as a failed solve
            print(f"solve {len(walls)} failed: {exc!r}", file=sys.stderr)
            failed += 1
            end = time.perf_counter()
            break
        end = time.perf_counter()
        walls.append(end - start)
        if profiler is not None and not traced:   # nothing kept yet
            if len(walls) == trace_solves:
                profiler.stop()
                traced = len(walls)
        elif sampler.random() * (len(walls) - traced) < 1.0:
            kept = out   # drawn uniformly from the untraced solves
        if end >= deadline:
            break
    if profiler is not None and not traced:   # fewer solves than asked
        profiler.stop()
    window_s = end - t0
    setup_s = t0 - t_start
    counters = subject.counters()

    trace_record = None
    if profiler is not None:
        trace_record = profiler.trace()
    info = _device_block(device, int(entry["chips"]), trace_record)

    # the program's state goes before the reference runs; the reference
    # makes its own inputs from the seed and judges the kept output and
    # the last one
    outputs = [o for o in (kept, out) if o is not None]
    if kept is out:
        outputs = outputs[:1]
    del kept, out
    subject.release()
    readings = subject.compare(outputs) if outputs else {}
    del outputs
    limits = workload["limits"]
    checks = {name: {"value": value, "limit": limits.get(name)}
              for name, value in readings.items()}
    correct = (
        failed == 0 and bool(checks)
        and all(c["limit"] is not None and not math.isnan(c["value"])
                and c["value"] <= c["limit"] for c in checks.values())
    )

    run = Run(workload, config, subject.facts, subject.work, setup_s, walls,
              window_s, counters, trace_record)
    metrics = {}
    for m in spec.metrics_for(bench, cell, trace):
        value = readers[m["name"]].read(run) if walls else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(walls) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": info,
    }
    if trace_record is not None:
        result["breakdown"] = trace_record.breakdown()
    result["checks"] = checks
    return result
