"""The port's spans (``smi_tpu_torch.utils.tracing.annotate``): where they
open, how they nest, what they cost with no profiler running, and that
``trace()`` records the rank threads of a ``LocalWorld``."""

import gc
import json
import threading
from collections import Counter

import pytest
import torch

from smi_tpu_torch.kernels import stencil_temporal as kt
from smi_tpu_torch.ops.types import SmiOp
from smi_tpu_torch.parallel import collectives
from smi_tpu_torch.parallel.local import LocalWorld
from smi_tpu_torch.parallel.mesh import make_communicator
from smi_tpu_torch.utils import tracing


def _profiled(fn):
    """The ``smi.*`` events of ``fn()`` under a CPU ``torch.profiler``,
    as ``(name, start_us, end_us)``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("smi.")]


def _traced(tmp_path, fn):
    """The ``smi.*`` events of ``fn()`` under :func:`tracing.trace`, from
    its Chrome trace file, as ``(name, tid, start_us, end_us)``."""
    with tracing.trace(str(tmp_path)):
        fn()
    (path,) = tmp_path.glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
            for e in events
            if e.get("ph") == "X" and str(e.get("name")).startswith("smi.")]


def _within(inner, outer):
    return outer[-2] <= inner[-2] and inner[-1] <= outer[-1]


def _solve_64():
    """A 64x64 solve on a 1x1 CPU communicator: depth 4, nine sweeps,
    so two k-sweep passes and one remainder sweep."""
    comm = make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                             device="cpu")
    fn = kt.make_temporal_stencil_fn(comm, 9, 64, 64, depth=4)
    block = torch.rand(64, 64, generator=torch.Generator().manual_seed(0))
    return fn(block)


def test_stencil_solve_spans_and_their_halo_children():
    events = _profiled(_solve_64)
    counts = Counter(name for name, _, _ in events)
    assert counts["smi.stencil.solve"] == 1
    assert counts["smi.stencil.pass"] == 2
    assert counts["smi.stencil.sweep"] == 1
    # on the CPU the kernels' plain versions run: no launch
    assert counts["smi.stencil.launch"] == 0
    (solve,) = [e for e in events if e[0] == "smi.stencil.solve"]
    steps = [e for e in events if e[0] in ("smi.stencil.pass",
                                           "smi.stencil.sweep")]
    halos = [e for e in events if e[0].startswith("smi.halo.")]
    assert all(_within(step, solve) for step in steps)
    # every halo span lies in exactly one step; none wraps another
    for h in halos:
        assert sum(_within(h, step) for step in steps) == 1
        assert not any(o is not h and _within(o, h) for o in halos)
    for step in steps:
        inside = sorted((e for e in halos if _within(e, step)),
                        key=lambda e: e[1])
        expected = (["smi.halo.phase1", "smi.halo.phase2",
                     "smi.halo.finish"] if step[0] == "smi.stencil.pass"
                    else ["smi.halo.start", "smi.halo.finish"])
        assert [e[0] for e in inside] == expected


def test_world_all_reduce_spans_on_four_rank_threads(tmp_path):
    world = LocalWorld(4, device="cpu")
    events = _traced(tmp_path, lambda: world.run(
        lambda c: c.all_reduce(torch.ones(4), SmiOp.ADD)))
    (run,) = [e for e in events if e[0] == "smi.world.run"]
    ranks = [e for e in events if e[0] == "smi.world.rank"]
    assert len(ranks) == 4 and len({e[1] for e in ranks}) == 4
    assert all(_within(r, run) for r in ranks)
    meets = [e for e in events if e[0] == "smi.world.rendezvous.all_reduce"]
    assert len(meets) == 4 and {e[1] for e in meets} == {e[1] for e in ranks}
    for meet in meets:
        (rank,) = [r for r in ranks if r[1] == meet[1]]
        assert _within(meet, rank)
        children = Counter(e[0] for e in events
                           if e[1] == meet[1] and e is not meet
                           and _within(e, meet))
        assert children["smi.world.arrive"] == 1
        assert children["smi.world.release"] == 1
    leads = [e for e in events if e[0] == "smi.world.lead"]
    assert len(leads) == 1
    assert any(e[1] == leads[0][1] and _within(leads[0], e) for e in meets)


COLLECTIVES = {
    "bcast": lambda x, c: collectives.bcast(x, c),
    "reduce": lambda x, c: collectives.reduce(x, c),
    "allreduce": lambda x, c: collectives.allreduce(x, c),
    "scatter": lambda x, c: collectives.scatter(x, c),
    "gather": lambda x, c: collectives.gather(x, c),
    "all_to_all": lambda x, c: collectives.all_to_all(
        x, c, algorithm="pairwise"),
    "allreduce_hierarchical": collectives.allreduce_hierarchical,
    "bcast_hierarchical": collectives.bcast_hierarchical,
    "reduce_hierarchical": collectives.reduce_hierarchical,
    "alltoall_hierarchical": collectives.alltoall_hierarchical,
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_each_collective_opens_its_span_on_every_rank(tmp_path, name):
    world = LocalWorld((2, 2), ("dcn", "ici"), device="cpu")
    call = COLLECTIVES[name]
    events = _traced(tmp_path, lambda: world.run(
        lambda c: call(torch.arange(8.0), c)))
    spans = [e for e in events if e[0] == f"smi.collective.{name}"]
    assert len({e[1] for e in spans}) == 4
    meets = [e for e in events if e[0].startswith("smi.world.rendezvous.")]
    assert meets and all(any(_within(m, s) for s in spans) for m in meets)


def test_annotate_off_is_the_shared_null_context(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.annotate("smi.any") is tracing.annotate("smi.other")
    with tracing.annotate("smi.any"):
        pass
    _solve_64()   # every span of the stencil path, none entered
    gc.collect()  # nor the collector's


def test_the_global_profiler_flag_exists_and_follows_the_profiler():
    """The spans read this flag: a torch without it would drop them."""
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    seen = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        # a thread started after the profiler sees the flag too
        t = threading.Thread(
            target=lambda: seen.append(tracing.annotate("smi.x")))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert seen and seen[0] is not tracing.annotate("smi.x")


def test_garbage_collection_under_the_profiler_is_a_span():
    events = _profiled(gc.collect)
    assert "smi.host.gc.gen2" in [e[0] for e in events]
