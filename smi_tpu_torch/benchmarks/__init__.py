"""Communication microbenchmarks and the application benchmarks.

PyTorch counterpart of :mod:`smi_tpu.benchmarks`, after SMI's
``microbenchmarks/``: bandwidth, latency, injection rate, the four
collectives, multi-collective overlap, the rank pipeline and its double
rail (``microbenchmarks/CMakeLists.txt:8-27``), the chunked allreduce's
overlap, and the reference's example applications. Each follows the
reference hosts' pattern: timed runs → mean/stddev/99% CI → ``.dat``
file, with the same metric formulas, on the ranks of a
:class:`~smi_tpu_torch.parallel.local.LocalWorld`.

Run ``python -m smi_tpu_torch.benchmarks <name>`` (see ``--help``). On a
CPU world the numbers exercise the code path, not the card.
``import smi_tpu_torch`` does not load this package.
"""

from smi_tpu_torch.benchmarks.micro import BENCHMARKS, run_benchmark

__all__ = ["BENCHMARKS", "run_benchmark"]
