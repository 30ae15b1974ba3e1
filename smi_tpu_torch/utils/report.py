"""Per-op reports of a routed program: the ``aoc -report`` analog.

PyTorch counterpart of :mod:`smi_tpu.utils.report`. Reference parity:
the reference runs the FPGA toolchain in analysis mode before anyone
commits to a full bitstream build — ``aoc -rtl -report`` for area/Fmax
inspection (the reference's ``CMakeLists.txt:113-118``). The JAX module
compiles each manifest op and tabulates XLA's cost and memory analyses.
The port has no compiler of programs to ask: each op runs once, as its
runtime call, on a :class:`~smi_tpu_torch.parallel.local.LocalWorld` of
``comm_size`` rank threads, and the report tabulates what that run
launched and what it had to move:

- ``kernels``: launches of each hand-written kernel
  (``_build.reset_launches`` / ``LAUNCHES``; none on CPU tensors, where
  the wrappers run their plain versions, nor on the default tier);
- ``bytes``: every rank's input read once and output written once, the
  byte bound ``PERF.md`` uses for the ring kernels;
- ``registers`` / ``smem``: per launched kernel, the most registers a
  thread and bytes of static shared memory over its instances, from the
  ``-Xptxas -v`` build log (None without one);
- ``predicted_us``: ``bytes`` at the H100's memory rate, 3.35 TB/s — a
  bound, never a measurement, and never a TPU price.
"""

from __future__ import annotations

from typing import Optional

import torch

from smi_tpu_torch.ops.operations import (
    Broadcast,
    Gather,
    Pop,
    Push,
    Reduce,
    Scatter,
)
from smi_tpu_torch.ops.types import dtype_to_torch

#: default message length per reported operation (elements)
REPORT_COUNT = 4096

#: memory rate of the H100 SXM (bytes a second): the predicted column's
#: denominator
HBM_BYTES_PER_S = 3.35e12


def _op_call(op, count: int, backend: str):
    """``(fn(comm, x), elements a rank, torch dtype)`` realizing one
    manifest op on a rank."""
    from smi_tpu_torch.parallel import collectives
    from smi_tpu_torch.parallel.channels import P2PChannel

    dt = dtype_to_torch(op.dtype)
    if isinstance(op, (Push, Pop)):
        def p2p(comm, x):
            ch = P2PChannel(
                comm=comm, port=op.port, src=0, dst=comm.size - 1,
                count=count, dtype=op.dtype, buffer_size=op.buffer_size,
            )
            return ch.transfer(x, backend=backend)
        return p2p, lambda n: count, dt
    if isinstance(op, Broadcast):
        return (lambda comm, x: collectives.bcast(
            x, comm, root=0, port=op.port, backend=backend),
            lambda n: count, dt)
    if isinstance(op, Reduce):
        return (lambda comm, x: collectives.reduce(
            x, comm, op=op.op, root=0, port=op.port, backend=backend),
            lambda n: count, dt)
    if isinstance(op, Scatter):
        return (lambda comm, x: collectives.scatter(
            x, comm, root=0, port=op.port, backend=backend),
            lambda n: n * count, dt)
    if isinstance(op, Gather):
        return (lambda comm, x: collectives.gather(
            x, comm, root=0, port=op.port, backend=backend),
            lambda n: count, dt)
    raise ValueError(f"unreportable operation type {type(op).__name__}")


def _kernel_figures(kernel: str) -> dict:
    """The most registers a thread and static shared memory over
    ``kernel``'s instances in its source's build log (None each when
    there is no log)."""
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.parallel import aot

    figs = aot.kernel_resources(_build.build_log(_build.source_of(kernel)))
    mine = []
    for mangled, f in figs.items():
        named = aot.instance_kernel(mangled)
        if named is None:
            continue
        name = named[0]
        if name == "ring_reduce":
            rs = named[1]["rs"] == "1"
            name = ("ring_reduce_scatter" if rs
                    else ("ring_all_reduce", "ring_all_reduce_chunked"))
        if kernel == name or (isinstance(name, tuple) and kernel in name):
            mine.append(f)
    if not mine:
        return {"registers": None, "smem": None}
    return {"registers": max(f["registers"] for f in mine),
            "smem": max(f["smem"] for f in mine)}


def program_report(
    program,
    world,
    count: int = REPORT_COUNT,
    backend: str = "ring",
) -> dict:
    """Per-operation report of a routed program on ``world``.

    Each manifest operation runs once as its runtime call over every
    rank of ``world`` (``backend="ring"``, the tier whose calls are the
    hand-written kernels, by default; ``"xla"`` launches none), and its
    launches, bytes and kernel figures are tabulated."""
    from smi_tpu_torch.kernels import _build

    seen_p2p_ports = set()
    ops_out = []
    for op in program.operations:
        if isinstance(op, (Push, Pop)):
            # a push/pop pair is ONE channel; report it once per port
            if op.port in seen_p2p_ports:
                continue
            seen_p2p_ports.add(op.port)
        call, elems, dt = _op_call(op, count, backend)
        n = world.size

        def rank_input(rank):
            x = torch.arange(elems(n), dtype=torch.float64) % 97 + rank
            return x.to(dt).to(world.device)

        inputs = [rank_input(r) for r in range(n)]
        _build.reset_launches()
        outs = world.run(lambda c: call(c, inputs[c.rank]))
        if world.device.type == "cuda":
            torch.cuda.synchronize(world.device)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        moved = sum(t.numel() * t.element_size()
                    for t in list(inputs) + list(outs))
        ops_out.append({
            "op": type(op).__name__.lower(),
            "port": op.port,
            "dtype": op.dtype.value,
            "count": count,
            "kernels": launched,
            "launches": sum(launched.values()),
            "bytes": moved,
            "figures": {k: _kernel_figures(k) for k in sorted(launched)},
            "predicted_us": round(moved / HBM_BYTES_PER_S * 1e6, 4),
        })
    return {
        "backend": backend,
        "comm_size": world.size,
        "count": count,
        "device": str(world.device),
        "operations": ops_out,
    }


def _most(entry: dict, key: str) -> Optional[int]:
    got = [f[key] for f in entry.get("figures", {}).values()
           if f[key] is not None]
    return max(got) if got else None


def format_report(report: dict) -> str:
    """Human-readable table (the ``aoc`` report's summary screen). The
    JAX table's columns where they carry; ``flops`` becomes the kernel
    ``launches``, ``code``/``temp`` the launched kernels' most
    ``regs`` a thread and static ``smem``, and ``ici_pred_us`` the
    ``hbm_pred_us`` bound at 3.35 TB/s."""
    lines = [
        f"program report — {report['comm_size']} ranks, "
        f"{report['count']} elements/op, backend={report['backend']}",
        f"{'op':<10} {'port':>4} {'dtype':<7} {'launches':>12} "
        f"{'bytes':>14} {'regs':>10} {'smem':>10} {'hbm_pred_us':>12}",
    ]
    for e in report["operations"]:
        regs, smem = _most(e, "registers"), _most(e, "smem")
        lines.append(
            f"{e['op']:<10} {e['port']:>4} {e['dtype']:<7} "
            f"{e['launches']:>12} "
            f"{e['bytes']:>14} "
            f"{regs if regs is not None else '-':>10} "
            f"{smem if smem is not None else '-':>10} "
            f"{e['predicted_us']:>12}"
        )
    return "\n".join(lines)
