"""The microbenchmark suite.

PyTorch counterpart of :mod:`smi_tpu.benchmarks.micro`. Metric formulas
follow the reference hosts (SURVEY §6), as there:

- ``bandwidth``: payload bits / transfer time, two concurrent channels
  (``bandwidth_benchmark.cpp:188-194``, ``bandwidth_0.cl:14-33``);
- ``latency``: mean RTT/2 of a 1-element ping-pong
  (``latency_0.cl:10-12``, ``latency_benchmark.cpp:158-175``);
- ``injection``: time per 1-element message, back-to-back
  (``injection_rate_benchmark.cpp:150-171``);
- ``broadcast``/``reduce``/``scatter``/``gather``: N-element rooted
  collective time vs root placement (``broadcast_benchmark.cpp`` etc.);
- ``multi_collectives``: overlapped vs serialized broadcasts on distinct
  ports (``multi_collectives.cl:1-12``);
- ``pipeline``: R ring hops, rendezvous (chunked) vs eager
  (``pipeline.cl:9-34``; eager variants
  ``microbenchmarks/CMakeLists.txt:16-17``);
- ``overlap``: the chunked pipelined allreduce against the unchunked one.

The world stands in for the mesh: where a JAX benchmark runs
``jit(shard_map(shard_fn))`` on the mesh-level communicator, the port's
runs the same per-rank body on every rank of a
:class:`~smi_tpu_torch.parallel.local.LocalWorld` in one
:meth:`~smi_tpu_torch.parallel.local.LocalWorld.run` (``lax.scan`` loops
are Python loops inside it). A timed sample is the host wall of one such
call, with completion forced by reading every rank's result back to the
host (``run`` has already synchronised each rank's stream).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Optional

import torch

from smi_tpu_torch.benchmarks.stats import Measurement, timed_samples
from smi_tpu_torch.parallel import collectives as coll
from smi_tpu_torch.parallel.channels import (
    P2PChannel,
    ring_shift,
    stream_concurrent,
)


def force_readback(fn: Callable[[], list]) -> Callable[[], None]:
    """Wrap ``fn`` (a world's run) so each call copies every rank's
    result to the host: the call ends when the device work has."""

    def run():
        for out in fn():
            out.cpu()

    return run


def _timed(world, body, runs: int):
    """Seconds per ``world.run(body)`` over ``runs`` timed calls."""
    return timed_samples(force_readback(lambda: world.run(body)), runs)


def _ones(world, n: int, dtype=torch.float32) -> torch.Tensor:
    return torch.ones(n, dtype=dtype, device=world.device)


def bench_bandwidth(
    world, size_kb: int = 512, runs: int = 10, repeats: int = 4,
    rendezvous: bool = False, buffer_size: int = 2048,
    backend: str = "xla",
) -> Measurement:
    """Two concurrent P2P channels rank0→rank1; payload Gbit/s.

    ``rendezvous=True`` moves each message in bounded
    ``buffer_size``-element chunks (the reference's credit protocol,
    asynchronicity degree 2048 as in ``bandwidth_0.cl:14``);
    ``False`` is the eager variant (``bandwidth_eager``,
    ``microbenchmarks/CMakeLists.txt:26``).
    """
    n = max(1, size_kb * 1024 // 4 // 2)  # floats per channel
    x = _ones(world, n)

    def body(comm):
        ch0 = P2PChannel(comm=comm, port=0, src=0, dst=1, count=n,
                         dtype="float", rendezvous=rendezvous,
                         buffer_size=buffer_size)
        ch1 = P2PChannel(comm=comm, port=1, src=0, dst=1, count=n,
                         dtype="float", rendezvous=rendezvous,
                         buffer_size=buffer_size)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(repeats):
            if rendezvous:
                # lockstep chunking keeps the two channels concurrent
                a, b = stream_concurrent((ch0, ch1), (x, x * 2),
                                         backend=backend)
            else:
                a = ch0.transfer(x, backend=backend)
                b = ch1.transfer(x * 2, backend=backend)
            total = total + torch.sum(a) + torch.sum(b)
        return total[None]

    samples = _timed(world, body, runs)
    bytes_moved = 2 * n * 4 * repeats
    gbits = [bytes_moved * 8 / t / 1e9 for t in samples]
    name = "bandwidth" if rendezvous else "bandwidth-eager"
    return Measurement(name, "Gbit/s", gbits,
                       {"size_kb": size_kb, "channels": 2,
                        "repeats": repeats, "rendezvous": rendezvous,
                        "backend": backend})


def bench_bandwidth_eager(world, size_kb: int = 512, runs: int = 10,
                          repeats: int = 4, backend: str = "xla"):
    return bench_bandwidth(world, size_kb, runs, repeats, rendezvous=False,
                           backend=backend)


def bench_bandwidth_rendezvous(world, size_kb: int = 512, runs: int = 10,
                               repeats: int = 4, backend: str = "xla"):
    return bench_bandwidth(world, size_kb, runs, repeats, rendezvous=True,
                           backend=backend)


def bench_latency(
    world, pingpongs: int = 100, runs: int = 10, backend: str = "xla",
) -> Measurement:
    """1-element ping-pong rank0↔rank1; half round trip in usec."""
    x = torch.zeros(1, dtype=torch.int32, device=world.device)

    def body(comm):
        fwd = P2PChannel(comm=comm, port=0, src=0, dst=1, count=1,
                         dtype="int", rendezvous=False)
        bwd = P2PChannel(comm=comm, port=1, src=1, dst=0, count=1,
                         dtype="int", rendezvous=False)
        carry = x
        for _ in range(pingpongs):
            there = fwd.transfer(carry, backend=backend)
            carry = bwd.transfer(there + 1, backend=backend)
        return carry[None]

    samples = _timed(world, body, runs)
    usecs = [t / (2 * pingpongs) * 1e6 for t in samples]
    return Measurement("latency", "usec", usecs,
                       {"pingpongs": pingpongs, "backend": backend})


def bench_injection(
    world, messages: int = 100, runs: int = 10, backend: str = "xla",
) -> Measurement:
    """Back-to-back 1-element sends; per-message overhead in usec."""
    x = _ones(world, 1, torch.int32)

    def body(comm):
        ch = P2PChannel(comm=comm, port=0, src=0, dst=1, count=1,
                        dtype="int", rendezvous=False)
        carry = x
        for _ in range(messages):
            carry = ch.transfer(carry, backend=backend) + carry
        return carry[None]

    samples = _timed(world, body, runs)
    usecs = [t / messages * 1e6 for t in samples]
    return Measurement("injection", "usec/msg", usecs,
                       {"messages": messages, "backend": backend})


def _bench_collective(
    name: str, world, elements: int, root: int, runs: int,
    op: Optional[str] = None, backend: str = "xla",
) -> Measurement:
    size = world.size
    x = _ones(world, elements)

    def body(comm):
        mine = x + comm.rank
        if name == "broadcast":
            out = coll.bcast(mine, comm, root=root, port=0,
                             backend=backend)
        elif name == "reduce":
            out = coll.reduce(mine, comm, op=op or "add", root=root,
                              port=0, backend=backend)
        elif name == "scatter":
            out = coll.scatter(x.repeat(size) + comm.rank, comm, root=root,
                               port=0, backend=backend)
        else:  # gather
            out = coll.gather(mine, comm, root=root, port=0,
                              backend=backend)
        return torch.sum(out)[None]

    samples = _timed(world, body, runs)
    usecs = [t * 1e6 for t in samples]
    return Measurement(
        f"{name}-root{root}", "usec", usecs,
        {"elements": elements, "root": root, "ranks": size, "op": op,
         "backend": backend},
    )


def bench_broadcast(world, elements: int = 65536, root: int = 0,
                    runs: int = 10, backend: str = "xla"):
    return _bench_collective("broadcast", world, elements, root, runs,
                             backend=backend)


def bench_reduce(world, elements: int = 65536, root: int = 0, runs: int = 10,
                 op: str = "add", backend: str = "xla"):
    return _bench_collective("reduce", world, elements, root, runs, op=op,
                             backend=backend)


def bench_scatter(world, elements: int = 8192, root: int = 0, runs: int = 10,
                  backend: str = "xla"):
    return _bench_collective("scatter", world, elements, root, runs,
                             backend=backend)


def bench_gather(world, elements: int = 8192, root: int = 0, runs: int = 10,
                 backend: str = "xla"):
    return _bench_collective("gather", world, elements, root, runs,
                             backend=backend)


def bench_multi_collectives(
    world, elements: int = 16384, runs: int = 10, backend: str = "xla",
) -> Measurement:
    """Overlap benefit: 3 independent broadcasts on distinct ports vs 3
    serialized ones (data-dependent chain)."""
    r1, r2 = 1 % world.size, 2 % world.size  # stay valid on tiny worlds
    x = _ones(world, elements)

    def overlapped(comm):
        a = coll.bcast(x, comm, root=0, port=0, backend=backend)
        b = coll.bcast(x * 2, comm, root=r1, port=1, backend=backend)
        c = coll.bcast(x * 3, comm, root=r2, port=2, backend=backend)
        return (torch.sum(a) + torch.sum(b) + torch.sum(c))[None]

    def serialized(comm):
        a = coll.bcast(x, comm, root=0, port=0, backend=backend)
        b = coll.bcast(a * 2, comm, root=r1, port=0,
                       backend=backend)  # depends on a
        c = coll.bcast(b * 3, comm, root=r2, port=0, backend=backend)
        return torch.sum(c)[None]

    results = {}
    for tag, body in (("overlapped", overlapped), ("serialized", serialized)):
        results[tag] = [t * 1e6 for t in _timed(world, body, runs)]
    # report the overlapped time; serialized mean lands in config
    return Measurement("multi_collectives", "usec", results["overlapped"],
                       {"elements": elements, "backend": backend,
                        "serialized_mean_usec":
                            sum(results["serialized"]) / runs})


def bench_pipeline(
    world, elements: int = 4096, rounds: int = 16, runs: int = 10,
    rendezvous: bool = True, backend: str = "xla",
) -> Measurement:
    """Ring pipeline: every rank forwards to rank+1 for R rounds."""
    x = _ones(world, elements)

    def body(comm):
        carry = x
        for _ in range(rounds):
            if rendezvous:
                # bounded in-flight: move in default-depth chunks
                chunk = 112  # 16 packets of float
                n_chunks = max(1, elements // chunk)
                parts = carry[: n_chunks * chunk].reshape(n_chunks, -1)
                shifted = torch.stack([ring_shift(part, comm,
                                                  backend=backend)
                                       for part in parts])
                out = torch.cat(
                    [shifted.reshape(-1),
                     ring_shift(carry[n_chunks * chunk:], comm,
                                backend=backend)]
                ) if elements % chunk else shifted.reshape(-1)
            else:
                out = ring_shift(carry, comm, backend=backend)
            carry = out + 1.0
        return torch.sum(carry)[None]

    samples = _timed(world, body, runs)
    usecs = [t / rounds * 1e6 for t in samples]
    name = "pipeline" if rendezvous else "pipeline-eager"
    return Measurement(name, "usec/round", usecs,
                       {"elements": elements, "rounds": rounds,
                        "rendezvous": rendezvous, "backend": backend})


def bench_pipeline_double_rail(
    world, elements: int = 4096, rounds: int = 16, runs: int = 10,
    backend: str = "xla",
) -> Measurement:
    """Ring pipeline with the payload split into two messages per hop.

    Reference ``pipeline_double_rail.cl`` splits each hop's payload over
    both QSFP rails. The card has no user-visible rail either, so, as in
    the JAX package, each hop is two *independent* shifts and the
    comparison against :func:`bench_pipeline` measures what the split
    costs or gains.
    """
    half = elements // 2
    x = _ones(world, elements)

    def body(comm):
        carry = x
        for _ in range(rounds):
            a = ring_shift(carry[:half], comm, backend=backend)  # rail 0
            b = ring_shift(carry[half:], comm, backend=backend)  # rail 1
            carry = torch.cat([a, b]) + 1.0
        return torch.sum(carry)[None]

    samples = _timed(world, body, runs)
    usecs = [t / rounds * 1e6 for t in samples]
    return Measurement("pipeline-double-rail", "usec/round", usecs,
                       {"elements": elements, "rounds": rounds, "rails": 2,
                        "backend": backend})


def bench_overlap(
    world, size_kb: int = 256, chunks: int = 4, repeats: int = 2,
    runs: int = 10, sweep_kb: tuple = (16, 64, 256), backend: str = "xla",
) -> Measurement:
    """Overlap efficiency of the chunked pipelined allreduce.

    Times a chain of ``repeats`` allreduce+compute steps twice — once
    unchunked (bulk-synchronous: all compute waits for the whole
    payload) and once with ``chunks=`` pipeline chunks — across a
    payload sweep. The reported samples are the unchunked/chunked time
    ratios at ``size_kb`` (>1 = the pipeline hid communication);
    ``config["sweep"]`` carries the per-size mean seconds for both
    variants. On the ``"ring"`` tier the chunked allreduce is one launch
    of the chunked ring kernel, on the ``"xla"`` tier ``chunks``
    collectives of the transport. ``config["overlap_report"]`` is None:
    the JAX package fills it from the compiled XLA executable
    (``smi_tpu.parallel.traffic.overlap_report``), and the port has no
    executable to parse.
    """
    if size_kb not in sweep_kb:
        sweep_kb = tuple(sweep_kb) + (size_kb,)
    scale = 1.0 / world.size

    def make(x, n_chunks: int):
        def body(comm):
            carry = x
            for _ in range(repeats):
                y = coll.allreduce(carry, comm, backend=backend,
                                   chunks=n_chunks)
                # the compute a pipelined schedule can hide: depends
                # only on the carry, not on this step's collective
                carry = y * scale + carry * 0.5
            return torch.sum(carry)[None]

        return body

    sweep = {}
    ratio_samples = None
    for kb in sweep_kb:
        x = _ones(world, max(1, kb * 1024 // 4))
        base = _timed(world, make(x, 1), runs)
        chunked = _timed(world, make(x, chunks), runs)
        sweep[kb] = {
            "unchunked_mean_s": sum(base) / len(base),
            "chunked_mean_s": sum(chunked) / len(chunked),
        }
        if kb == size_kb:
            ratio_samples = [b / c for b, c in zip(base, chunked)]
    return Measurement(
        "overlap", "x", ratio_samples,
        {"size_kb": size_kb, "chunks": chunks, "repeats": repeats,
         "backend": backend, "sweep": sweep, "overlap_report": None},
    )


BENCHMARKS: Dict[str, Callable] = {
    "bandwidth": bench_bandwidth_rendezvous,
    "bandwidth_eager": bench_bandwidth_eager,
    "latency": bench_latency,
    "injection": bench_injection,
    "broadcast": bench_broadcast,
    "reduce": bench_reduce,
    "scatter": bench_scatter,
    "gather": bench_gather,
    "multi_collectives": bench_multi_collectives,
    "pipeline": bench_pipeline,
    "pipeline_double_rail": bench_pipeline_double_rail,
    "overlap": bench_overlap,
}

# application-level benchmarks join the same registry
from smi_tpu_torch.benchmarks.apps import APP_BENCHMARKS  # noqa: E402

BENCHMARKS.update(APP_BENCHMARKS)


def run_benchmark(name: str, world, out_dir: Optional[str] = None,
                  **params) -> Measurement:
    """Run benchmark ``name`` on ``world``, print its summary and, with
    ``out_dir``, append its ``.dat`` line and write its ``.json``."""
    if name not in BENCHMARKS:
        raise KeyError(
            f"unknown benchmark {name!r}; have {sorted(BENCHMARKS)}"
        )
    fn = BENCHMARKS[name]
    sig = inspect.signature(fn)
    if "backend" in params and "backend" not in sig.parameters:
        # benchmarks without backend tiers (the app benchmarks) reject
        # the kwarg; dropping backend='xla' is harmless (it IS the
        # default tier), but a requested non-default tier must never be
        # silently substituted with an xla measurement
        dropped = params.pop("backend")
        if dropped != "xla":
            raise ValueError(
                f"benchmark {name!r} has no backend tiers; refusing to "
                f"record backend={dropped!r} as an xla measurement"
            )
    m = fn(world, **params)
    backend = params.get("backend", "xla")
    if backend != "xla" and not m.name.endswith(f"-{backend}"):
        # result files are keyed by name; a ring run must never
        # clobber the xla run's .dat/.json in a shared out-dir
        m = dataclasses.replace(m, name=f"{m.name}-{backend}")
    print(m.summary())
    if out_dir:
        m.write_dat(out_dir)
    return m
