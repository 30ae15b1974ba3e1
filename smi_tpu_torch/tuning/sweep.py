"""Measured-sweep layer: refine the analytic winner on the device.

The port's copy of the collective sweeps of :mod:`smi_tpu.tuning.sweep`
(the ATLAS move, PAPERS.md): enumerate the candidate configurations the
cost model ranked, *time them* with the harness the microbenchmark suite
trusts (:func:`smi_tpu_torch.benchmarks.micro.force_readback` around a
``LocalWorld.run``, :func:`smi_tpu_torch.benchmarks.stats.timed_samples`'
warmup + repeat discipline), and return the winners as plan-cache
entries. What is timed is the host wall of one ``LocalWorld.run`` of the
port's collective on every rank: what a user of the transport pays.

Each sweep takes the :class:`~smi_tpu_torch.parallel.local.LocalWorld`
to run on: one on the card, or one of CPU threads (the numbers then
describe the CPU). Entries are keyed by the *measured* device kind (the
world's device), so a CPU sweep can never shadow an H100 or v5e entry.
``record``, when given, receives one ``(kb, candidate, us)`` row per
timed candidate.

Not ported yet: ``sweep_flash`` (the Hopper flash kernels compile one
tile pair per dtype, head dim and form, so there is no candidate set to
sweep) and ``sweep_stencil`` (it needs the JAX package's
``analysis/perf.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from smi_tpu_torch.tuning import cost_model as cm
from smi_tpu_torch.tuning.cache import CacheEntry, PlanCache
from smi_tpu_torch.tuning.engine import _collective_topology
from smi_tpu_torch.tuning.plan import (
    PlanKey,
    normalize_device_kind,
    payload_bucket,
)


def _measure(world, body, runs: int) -> float:
    """Mean seconds of one ``world.run(body)`` via the micro.py
    harness."""
    from smi_tpu_torch.benchmarks.micro import force_readback
    from smi_tpu_torch.benchmarks.stats import timed_samples

    samples = timed_samples(force_readback(lambda: world.run(body)), runs)
    return sum(samples) / len(samples)


def world_device_kind(world, device_kind: Optional[str] = None) -> str:
    """The normalized kind of the device ``world`` runs on (``"cpu"``
    for a CPU world), unless ``device_kind`` names one."""
    if device_kind:
        return normalize_device_kind(device_kind)
    if world.device.type == "cuda":
        import torch

        return normalize_device_kind(torch.cuda.get_device_name(world.device))
    return normalize_device_kind(world.device.type)


def _ones(world, elems: int):
    import torch

    return torch.ones(elems, dtype=torch.float32, device=world.device)


def _summed(call):
    """A rank body whose result is one element: the readback forces
    completion without copying the payload to the host."""
    return lambda c: call(c).sum().reshape(1)


def _note(record, verbose, kb, name, secs) -> None:
    if record is not None:
        record.append((kb, name, secs * 1e6))
    if verbose:
        print(f"  {kb:>7} KiB {name:>16}: {secs * 1e6:.1f} us")


def sweep_allreduce(
    world,
    sizes_kb: Sequence[int] = (64, 256, 1024, 4096),
    chunk_candidates: Sequence[int] = (1, 2, 4),
    runs: int = 5,
    device_kind: Optional[str] = None,
    verbose: bool = False,
    record: Optional[list] = None,
) -> PlanCache:
    """Time ring vs rs+ag (x chunk counts) per payload size; return the
    winners as a mergeable :class:`PlanCache`, keyed ``n{n}``.

    Also distills the measured ring/rs+ag crossover into the
    ``rs_ag_min_bytes`` threshold entry, consumed by
    ``collectives.rs_ag_min_bytes``.
    """
    from smi_tpu_torch.parallel import collectives as coll

    n = world.size
    dk = world_device_kind(world, device_kind)
    topo = cm.TopologySpec(n=n)
    cache = PlanCache()
    rs_ag_wins = []   # payload bytes where the decomposition measured best

    for kb in sizes_kb:
        elems = max(n, (kb * 1024 // 4) // n * n)  # rs+ag-eligible
        payload_bytes = elems * 4
        x = _ones(world, elems)
        results = []
        for algo, rs_ag in (("ring", False), ("rs_ag", True)):
            for chunks in chunk_candidates:
                secs = _measure(world, _summed(
                    lambda c: coll.allreduce(x, c, rs_ag=rs_ag,
                                             chunks=chunks)), runs)
                results.append((secs, algo, chunks))
                _note(record, verbose, kb, f"{algo} chunks={chunks}", secs)
        secs, algo, chunks = min(results)
        if algo == "rs_ag":
            rs_ag_wins.append(payload_bytes)
        key = PlanKey("all_reduce", payload_bucket(payload_bytes),
                      "float32", dk, _collective_topology(topo))
        cache.put(key, CacheEntry(
            {"algorithm": algo, "chunks": chunks},
            cost_us=secs * 1e6,
            provenance=f"sweep:allreduce:{kb}KiB:n{n}",
        ))

    if rs_ag_wins and n > 2:
        # the SMALLEST payload the decomposition won at; skipped on
        # n <= 2 rings, where rs+ag cannot win (same volume, twice the
        # steps) and any "win" is timing noise
        cache.put(
            PlanKey("all_reduce", "threshold", "", dk, "any"),
            CacheEntry(
                {"rs_ag_min_bytes": int(min(rs_ag_wins))},
                cost_us=None,
                provenance=f"sweep:allreduce-crossover:n{n}",
            ),
        )
    return cache


def sweep_allreduce_hierarchical(
    world,
    sizes_kb: Sequence[int] = (64, 256, 1024, 4096),
    runs: int = 5,
    device_kind: Optional[str] = None,
    verbose: bool = False,
    record: Optional[list] = None,
) -> PlanCache:
    """Time flat vs two-tier allreduce per payload on a hybrid
    multi-slice world; persist the winners per (slices, payload bucket)
    and distill the measured crossover into the ``hier_threshold``
    entry. The flat side runs whatever form the rs+ag gate picks under
    the engine in force, and a flat win's entry names that form, so the
    entry stays one of the three candidates."""
    from smi_tpu_torch.ops.types import SmiOp
    from smi_tpu_torch.parallel import collectives as coll

    topo = cm.topology_from_comm(world)
    if not topo.hierarchical_eligible:
        raise ValueError(
            f"the hierarchical sweep needs a multi-slice hybrid world "
            f"(LocalWorld(shape, ('dcn', ...))); got axes "
            f"{world.axis_names} with sizes {world.shape}"
        )
    n, inner, outer = topo.n, topo.inner, topo.outer
    dk = world_device_kind(world, device_kind)
    cache = PlanCache()
    hier_wins = []   # payload bytes where the two-tier form measured best

    for kb in sizes_kb:
        elems = max(inner, (kb * 1024 // 4) // inner * inner)
        payload_bytes = elems * 4
        x = _ones(world, elems)
        results = []
        for hierarchical in (False, True):
            secs = _measure(world, _summed(
                lambda c: coll.allreduce(x, c, hierarchical=hierarchical)),
                runs)
            results.append((secs, hierarchical))
            _note(record, verbose, kb,
                  "hierarchical" if hierarchical else "flat", secs)
        secs, hierarchical = min(results)
        if hierarchical:
            hier_wins.append(payload_bytes)
            algo = "hierarchical"
        else:
            algo = ("rs_ag" if coll._use_rs_ag(x, world.comms[0], SmiOp.ADD,
                                               None)
                    else "ring")
        key = PlanKey("all_reduce", payload_bucket(payload_bytes),
                      "float32", dk, _collective_topology(topo))
        cache.put(key, CacheEntry(
            {"algorithm": algo},
            cost_us=secs * 1e6,
            provenance=f"sweep:allreduce-hier:{kb}KiB:"
                       f"{outer}x{inner}",
        ))

    if hier_wins:
        cache.put(
            PlanKey("all_reduce", "hier_threshold", "", dk,
                    f"dcn{outer}"),
            CacheEntry(
                {"hier_min_bytes": int(min(hier_wins))},
                cost_us=None,
                provenance=f"sweep:hier-crossover:{outer}x{inner}",
            ),
        )
    return cache


def sweep_allreduce_precision(
    world,
    sizes_kb: Sequence[int] = (64, 256, 1024, 4096),
    runs: int = 5,
    device_kind: Optional[str] = None,
    verbose: bool = False,
    record: Optional[list] = None,
) -> PlanCache:
    """Time the allreduce wire precisions (f32/bf16/int8/topk) per
    payload size; persist the winners per (slices, payload bucket) and
    distill the measured dense/lossy crossover into the
    ``precision_threshold`` entry. Runs on a flat or a hybrid world.
    The residuals of the lossy forms' error feedback are dropped
    before and after."""
    from smi_tpu_torch.parallel import collectives as coll

    topo = cm.topology_from_comm(world)
    n = topo.n
    inner = topo.inner or n
    outer = (topo.outer or 0) if topo.hierarchical_eligible else 0
    dk = world_device_kind(world, device_kind)
    cache = PlanCache()
    lossy_wins = []   # (payload bytes, precision) the lossy form won at

    coll.error_feedback_reset()
    for kb in sizes_kb:
        elems = max(inner, (kb * 1024 // 4) // inner * inner)
        payload_bytes = elems * 4
        x = _ones(world, elems)
        results = []
        for precision in cm.ALLREDUCE_PRECISIONS:
            secs = _measure(world, _summed(
                lambda c: coll.allreduce(x, c, precision=precision)), runs)
            results.append((secs, precision))
            _note(record, verbose, kb, precision, secs)
        secs, precision = min(results)
        if precision != "f32":
            lossy_wins.append((payload_bytes, precision))
        key = PlanKey("all_reduce", payload_bucket(payload_bytes),
                      "float32", dk, _collective_topology(topo))
        cache.put(key, CacheEntry(
            {"precision": precision},
            cost_us=secs * 1e6,
            provenance=f"sweep:allreduce-precision:{kb}KiB:"
                       + (f"{outer}x{inner}" if outer else f"n{n}"),
        ))
    coll.error_feedback_reset()

    if lossy_wins:
        min_bytes, precision = min(lossy_wins)
        cache.put(
            PlanKey("all_reduce", "precision_threshold", "", dk,
                    f"dcn{outer}" if outer else "flat"),
            CacheEntry(
                {"precision_min_bytes": int(min_bytes),
                 "precision": precision},
                cost_us=None,
                provenance=f"sweep:precision-crossover:"
                           + (f"{outer}x{inner}" if outer else f"n{n}"),
            ),
        )
    return cache


def sweep_alltoall(
    world,
    sizes_kb: Sequence[int] = (64, 256, 1024, 4096),
    runs: int = 5,
    device_kind: Optional[str] = None,
    verbose: bool = False,
    record: Optional[list] = None,
) -> PlanCache:
    """Time the all-to-all candidates per payload size and persist the
    winners as per-bucket ``algorithm`` entries. Candidates are
    structural: pairwise always, Bruck only on power-of-two rank counts
    (skipped WITH a printed line otherwise), hierarchical only on a
    hybrid multi-slice world."""
    from smi_tpu_torch.parallel import collectives as coll

    topo = cm.topology_from_comm(world)
    n = topo.n
    dk = world_device_kind(world, device_kind)
    algos = ["pairwise"]
    if n >= 2 and not (n & (n - 1)):
        algos.append("bruck")
    elif verbose:
        print(f"  bruck: skipped (n={n} is not a power of two)")
    if topo.hierarchical_eligible:
        algos.append("hierarchical")
    cache = PlanCache()

    for kb in sizes_kb:
        elems = max(n, (kb * 1024 // 4) // n * n)  # divisible by n
        payload_bytes = elems * 4
        x = _ones(world, elems)
        results = []
        for algorithm in algos:
            secs = _measure(world, _summed(
                lambda c: coll.all_to_all(x, c, algorithm=algorithm)), runs)
            results.append((secs, algorithm))
            _note(record, verbose, kb, algorithm, secs)
        secs, algorithm = min(results)
        key = PlanKey("all_to_all", payload_bucket(payload_bytes),
                      "float32", dk, _collective_topology(topo))
        cache.put(key, CacheEntry(
            {"algorithm": algorithm},
            cost_us=secs * 1e6,
            provenance=f"sweep:alltoall:{kb}KiB:n{n}",
        ))
    return cache
