"""The port's per-op report: ``smi_tpu_torch/utils/report.py``.

``tests/test_report.py``'s cases on the port: the report covers every
port of a program once (a push/pop pair is one channel), at the asked
count, and the table names every op and the rank count. The JAX report
prices XLA's compiled executable; the port's runs each op once on an
8-rank CPU ``LocalWorld`` and tabulates launches, bytes (every rank's
input read once and output written once), the launched kernels'
registers and shared memory from the build log, and a bound at the
H100's 3.35 TB/s. The entries' ``(op, port, dtype, count)`` are the JAX
report's; the ring tier's outputs equal the default tier's; on CPU
tensors nothing launches, and a ptxas log in the build's format fills
the figure columns.
"""

import pytest
import torch

from smi_tpu.ops.operations import (
    Broadcast as JBroadcast,
    Gather as JGather,
    Pop as JPop,
    Push as JPush,
    Reduce as JReduce,
    Scatter as JScatter,
)
from smi_tpu.ops.program import Program as JProgram
from smi_tpu.ops.types import SmiDtype as JDtype, SmiOp as JOp
from smi_tpu.utils import report as jreport
from smi_tpu_torch.kernels import _build
from smi_tpu_torch.ops.operations import (
    Broadcast,
    Gather,
    Pop,
    Push,
    Reduce,
    Scatter,
)
from smi_tpu_torch.ops.program import Program
from smi_tpu_torch.ops.types import SmiDtype, SmiOp
from smi_tpu_torch.parallel.local import LocalWorld
from smi_tpu_torch.utils.report import (
    HBM_BYTES_PER_S,
    format_report,
    program_report,
)


def _program(P, D, O, ops):
    Push_, Pop_, Bcast_, Reduce_, Scatter_, Gather_ = ops
    return P([
        Push_(port=0, dtype=D.FLOAT, buffer_size=32),
        Pop_(port=0, dtype=D.FLOAT, buffer_size=32),
        Bcast_(port=1, dtype=D.INT),
        Reduce_(port=2, dtype=D.FLOAT, op=O.MAX),
        Scatter_(port=3, dtype=D.FLOAT),
        Gather_(port=4, dtype=D.FLOAT),
    ])


@pytest.fixture(scope="module")
def full_program():
    return _program(Program, SmiDtype, SmiOp,
                    (Push, Pop, Broadcast, Reduce, Scatter, Gather))


@pytest.fixture(scope="module")
def world8():
    return LocalWorld(8, device="cpu")


@pytest.mark.parametrize("backend", ["ring", "xla"])
def test_program_report_covers_every_port(world8, full_program, backend):
    report = program_report(full_program, world8, count=64, backend=backend)
    entries = {(e["op"], e["port"]) for e in report["operations"]}
    # the push/pop pair is one channel, reported once
    assert entries == {
        ("push", 0), ("broadcast", 1), ("reduce", 2),
        ("scatter", 3), ("gather", 4),
    }
    assert report["comm_size"] == 8 and report["backend"] == backend
    for e in report["operations"]:
        assert e["count"] == 64
        # CPU tensors run the plain versions: nothing launches
        assert e["kernels"] == {} and e["launches"] == 0
        assert e["bytes"] > 0
        assert e["predicted_us"] == round(
            e["bytes"] / HBM_BYTES_PER_S * 1e6, 4)


def test_entries_match_the_jax_report(comm8, world8, full_program):
    jprog = _program(JProgram, JDtype, JOp,
                     (JPush, JPop, JBroadcast, JReduce, JScatter, JGather))
    want = jreport.program_report(jprog, comm8, count=64)
    got = program_report(full_program, world8, count=64)
    key = lambda r: [(e["op"], e["port"], e["dtype"], e["count"])  # noqa
                     for e in r["operations"]]
    assert key(got) == key(want)
    assert (got["comm_size"], got["count"]) == (want["comm_size"],
                                                 want["count"])


def test_bytes_are_every_rank_in_and_out_once(world8, full_program):
    got = {e["op"]: e["bytes"] for e in
           program_report(full_program, world8, count=64)["operations"]}
    n, f32 = 8, 4
    assert got["push"] == 2 * n * 64 * f32
    assert got["broadcast"] == 2 * n * 64 * 4          # int32
    assert got["reduce"] == 2 * n * 64 * f32
    # scatter: n*count in, count out; gather: count in, n*count out
    assert got["scatter"] == n * (n * 64 + 64) * f32
    assert got["gather"] == n * (64 + n * 64) * f32


def test_format_report_tabulates(world8, full_program):
    report = program_report(full_program, world8, count=64)
    text = format_report(report)
    assert "8 ranks" in text
    for op in ("push", "broadcast", "reduce", "scatter", "gather"):
        assert op in text
    header = text.splitlines()[1].split()
    assert header == ["op", "port", "dtype", "launches", "bytes", "regs",
                      "smem", "hbm_pred_us"]
    # no build log: the figure columns print '-'
    assert all(line.split()[5:7] == ["-", "-"]
               for line in text.splitlines()[2:])


def test_ring_tier_results_equal_the_default_tier(world8):
    """The report's ops, run on both tiers, return the same tensors."""
    from smi_tpu_torch.utils.report import _op_call

    for op in (Push(port=0, dtype=SmiDtype.FLOAT, buffer_size=32),
               Broadcast(port=1, dtype=SmiDtype.INT),
               Reduce(port=2, dtype=SmiDtype.FLOAT, op=SmiOp.MAX)):
        outs = {}
        for backend in ("xla", "ring"):
            call, elems, dt = _op_call(op, 96, backend)
            outs[backend] = world8.run(lambda c: call(
                c, (torch.arange(elems(8)) % 7 + c.rank).to(dt)))
        for a, b in zip(outs["xla"], outs["ring"]):
            assert torch.equal(a, b)


def test_figures_come_from_the_build_log(world8, full_program, monkeypatch):
    """With a ptxas log, each launched kernel's most registers and
    static shared memory fill the columns (launches stubbed as the card
    would count them)."""
    import smi_tpu_torch.utils.report as rep

    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113reduce_kernelIfLi1ELb0EEEvNS_6ParamsE' for "
        "'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_113reduce_kernelIfLi1ELb0EEEvNS_6ParamsE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers, 0 bytes smem, "
        "400 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_123neighbour_stream_kernelENS_6ParamsEi' for "
        "'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_123neighbour_stream_kernelENS_6ParamsEi",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 2 barriers, 0 bytes smem, "
        "400 bytes cmem[0]",
    ])
    monkeypatch.setattr(_build, "build_log",
                        lambda name: log if name == "ring" else "")
    assert rep._kernel_figures("ring_all_reduce") == {"registers": 56,
                                                      "smem": 0}
    assert rep._kernel_figures("ring_neighbour_stream") == {
        "registers": 40, "smem": 0}
    assert rep._kernel_figures("flash_fused") == {"registers": None,
                                                  "smem": None}
    report = {"comm_size": 8, "count": 64, "backend": "ring",
              "operations": [{"op": "reduce", "port": 2, "dtype": "float",
                              "launches": 1, "bytes": 4096,
                              "predicted_us": 0.0012,
                              "figures": {"ring_all_reduce": rep.
                                          _kernel_figures(
                                              "ring_all_reduce")}}]}
    row = format_report(report).splitlines()[2].split()
    assert row == ["reduce", "2", "float", "1", "4096", "56", "0", "0.0012"]
