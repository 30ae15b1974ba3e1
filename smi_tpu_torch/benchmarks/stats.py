"""Benchmark statistics and result files.

The port's own copy of :mod:`smi_tpu.benchmarks.stats` (pure Python
there too), byte for byte in what it prints and writes. Reference parity:
every reference benchmark prints mean/stddev and a 99% confidence
interval and appends a ``.dat`` result line
(``microbenchmarks/host/bandwidth_benchmark.cpp:176-211``,
``latency_benchmark.cpp:158-175``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, List, Optional

#: two-sided 99% z quantile, as used by the reference hosts
Z99 = 2.576


@dataclasses.dataclass
class Measurement:
    name: str
    unit: str
    samples: List[float]
    config: dict = dataclasses.field(default_factory=dict)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples)

    @property
    def stddev(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        m = self.mean
        var = sum((s - m) ** 2 for s in self.samples) / (len(self.samples) - 1)
        return math.sqrt(var)

    @property
    def ci99(self) -> float:
        """Half-width of the 99% confidence interval of the mean."""
        if len(self.samples) < 2:
            return 0.0
        return Z99 * self.stddev / math.sqrt(len(self.samples))

    def summary(self) -> str:
        return (
            f"{self.name}: mean {self.mean:.6g} {self.unit}, "
            f"stddev {self.stddev:.3g}, 99% CI ±{self.ci99:.3g} "
            f"({len(self.samples)} runs)"
        )

    def write_dat(self, directory: str) -> str:
        """Append a ``.dat`` result line (reference result-file analog)
        plus a JSON sidecar for machines."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{self.name}.dat")
        with open(path, "a") as f:
            f.write(
                f"{self.mean:.9g} {self.stddev:.9g} {self.ci99:.9g} "
                f"{len(self.samples)}\n"
            )
        with open(os.path.join(directory, f"{self.name}.json"), "w") as f:
            json.dump(
                {
                    "name": self.name,
                    "unit": self.unit,
                    "mean": self.mean,
                    "stddev": self.stddev,
                    "ci99": self.ci99,
                    "samples": self.samples,
                    "config": self.config,
                },
                f,
                indent=2,
            )
        return path


def timed_samples(
    fn: Callable[[], None], runs: int, warmup: int = 1
) -> List[float]:
    """Seconds per call over ``runs`` timed executions.

    ``fn`` must force completion itself: a device-to-host readback of
    its result (:func:`smi_tpu_torch.benchmarks.micro.force_readback`),
    since CUDA work is queued and returns before it has run.
    """
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out
