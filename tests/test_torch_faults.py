"""The port's fault layer and watchdogs: the reference's matrix, and parity.

``smi_tpu_torch/parallel/faults.py`` is the port's copy of the JAX
package's fault plans, verdict harness and state-machine mirror, and
``smi_tpu_torch/utils/watchdog.py`` its watchdog. The first part carries
over the CPU cases of ``tests/test_faults.py`` against the port: the
fault matrix (every ring protocol x fault class x seed ends tolerated or
detected by name, never silently corrupt), the watchdog layer, and
routing around random link cuts. The control-plane backoff cases live in
``tests/test_torch_bootstrap.py`` and the communicator's shrink in
``tests/test_torch_elastic.py``.

The second part holds the port to the JAX package with the tolerance
"equal": verdicts, state dumps and error texts of the same plans; every
``mirror_stall_dump`` for n = 2..8; and the watchdog's protocol mirror
on every ring-tier deadline — an expired ``Deadline`` on an 8-rank CPU
``LocalWorld`` raises the ``WatchdogTimeout`` a JAX communicator over
the eight CPU devices raises, ``.state`` and ``.state_dump`` alike.
Then ``timed``'s watchdog and sink hooks, fed to the online tuner.
"""

import dataclasses

import numpy as np
import pytest
import torch

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.parallel import collectives as jcoll
from smi_tpu.parallel import credits as JC
from smi_tpu.parallel import faults as JF
from smi_tpu.utils import watchdog as JW
from smi_tpu_torch.parallel import collectives as coll
from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.parallel import faults as F
from smi_tpu_torch.parallel import recovery as R
from smi_tpu_torch.utils import watchdog as W

pytestmark = pytest.mark.faults

SEEDS = range(4)
NS = [2, 3, 5]


# ---------------------------------------------------------------------------
# The exhaustive fault matrix: protocols x fault classes x seeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("fault_class", F.FAULT_CLASSES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fault_matrix_cell(protocol, fault_class, n, seed):
    """Every cell ends tolerated or detected-with-a-name; a cell that
    completed with corrupt delivery raises SilentCorruption and fails.
    The verdict is deterministic per (protocol, fault_class, n, seed)."""
    plan = F.FaultPlan.random(fault_class, n, seed)
    verdict = F.run_under_faults(protocol, n, plan, C.Strategy(seed))
    assert verdict.kind in ("tolerated", "detected")
    again = F.run_under_faults(protocol, n, plan, C.Strategy(seed))
    assert (verdict.kind, verdict.error_name) == (again.kind, again.error_name)
    if verdict.detected:
        assert verdict.error_name in (
            "ClobberError", "DeadlockError", "CreditLeakError",
            "IntegrityError",
        )
        if fault_class in F.INTEGRITY_FAULT_CLASSES:
            # wire damage must surface as the framing's named error
            assert verdict.error_name == "IntegrityError"
        if isinstance(verdict.error, C.DeadlockError):
            # the detection names where every rank stood
            assert verdict.error.state is not None
            assert "rank 0" in str(verdict.error)


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("seed", SEEDS)
def test_delayed_dma_always_tolerated(protocol, n, seed):
    """Delay is not loss: the credit protocol is proven correct under
    arbitrary landing order, so a slow DMA must never break delivery."""
    plan = F.FaultPlan.random("delayed_dma", n, seed)
    verdict = F.run_under_faults(protocol, n, plan, C.Strategy(seed))
    assert verdict.tolerated


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("n", [3, 5])
def test_first_grant_drop_deadlocks(protocol, n):
    """Dropping the very first credit grant of rank 0 starves its
    upstream writer on every protocol — deterministically detected as a
    deadlock whose dump shows the blocked wait."""
    plan = F.FaultPlan.single(F.DroppedGrant(0, nth=0))
    for seed in SEEDS:
        verdict = F.run_under_faults(protocol, n, plan, C.Strategy(seed))
        assert verdict.detected
        assert isinstance(verdict.error, C.DeadlockError)
        assert "blocked" in str(verdict.error)


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
def test_duplicated_grant_never_silent(protocol):
    """A surplus credit must surface as a clobber (the race it enables)
    or as the leaked count at exit — across many schedules, never as a
    clean pass with wrong data."""
    plan = F.FaultPlan.single(F.DuplicatedGrant(1, nth=0))
    kinds = set()
    for seed in range(12):
        for strat in (C.Strategy(seed), C.DelayDmaStrategy(seed),
                      C.FavourRankStrategy(1, seed)):
            verdict = F.run_under_faults(protocol, 4, plan, strat)
            if verdict.detected:
                kinds.add(verdict.error_name)
    assert kinds <= {"ClobberError", "CreditLeakError", "DeadlockError"}
    assert kinds  # the fault is visible under at least one schedule


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("n", [3, 4])
def test_stalled_rank_detected_with_dump(protocol, n):
    """A crash-stopped rank must deadlock its neighbours; the dump names
    the stalled rank so an operator knows whom to shrink away."""
    plan = F.FaultPlan.single(F.StalledRank(1, after=0))
    verdict = F.run_under_faults(protocol, n, plan, C.Strategy(0))
    assert verdict.detected
    assert isinstance(verdict.error, C.DeadlockError)
    assert verdict.error.state[1]["state"] == "stalled"


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("n", [3, 5])
def test_down_link_detected(protocol, n):
    """A dead wire between ring neighbours starves the barrier/credit
    exchange — detected as a deadlock on every seed, with any lost DMAs
    listed as undeliverable in the dump."""
    plan = F.FaultPlan.single(F.DownLink(0, 1))
    for seed in SEEDS:
        verdict = F.run_under_faults(protocol, n, plan, C.Strategy(seed))
        assert verdict.detected
        assert isinstance(verdict.error, C.DeadlockError)


def test_empty_plan_is_healthy():
    """An empty FaultPlan is behaviourally identical to no plan: the
    healthy fuzzer harnesses pass unchanged through the fault path."""
    plan = F.FaultPlan()
    assert plan.empty
    for seed in range(6):
        C.simulate_all_gather(4, C.Strategy(seed), faults=plan)
        C.simulate_all_reduce(4, C.Strategy(seed), faults=plan)
        C.simulate_reduce_scatter(4, C.Strategy(seed), faults=plan)
        C.simulate_neighbour_stream(4, 5, C.Strategy(seed), faults=plan)
        C.simulate_all_gather(4, C.DelayDmaStrategy(seed), faults=plan)


def test_random_plans_are_deterministic():
    assert F.FaultPlan.random("down_link", 5, 3) == F.FaultPlan.random(
        "down_link", 5, 3
    )
    assert F.FaultPlan.random("stalled_rank", 5, 3) != F.FaultPlan.random(
        "stalled_rank", 5, 4
    ) or True  # different seeds may collide on tiny domains; no assert


def test_unknown_fault_class_rejected():
    with pytest.raises(ValueError, match="unknown fault class"):
        F.FaultPlan.random("cosmic_ray", 4, 0)


def test_deadlock_dump_shape():
    """The state dump is structured: per-rank entries plus inflight /
    undeliverable / semaphore sections — the payload the runtime
    watchdog forwards."""
    plan = F.FaultPlan.single(F.DownLink(0, 1))
    with pytest.raises(C.DeadlockError) as e:
        C.simulate_neighbour_stream(3, 4, C.Strategy(0), faults=plan)
    state = e.value.state
    assert set(range(3)) <= set(k for k in state if isinstance(k, int))
    assert "undeliverable" in state and "sems" in state
    text = C.format_state_dump(state)
    assert "rank 0" in text and "rank 2" in text


# ---------------------------------------------------------------------------
# Watchdog layer
# ---------------------------------------------------------------------------


def test_deadline_expires_with_mirror_dump():
    d = W.Deadline(0.0, state_provider=F.mirror_state_provider("reduce", 4))
    with pytest.raises(W.WatchdogTimeout) as e:
        d.check("ring reduce over 4 ranks")
    msg = str(e.value)
    assert "ring reduce over 4 ranks" in msg
    assert "protocol mirror" in msg and "rank 0" in msg


def test_deadline_unbounded_never_expires():
    d = W.Deadline(None)
    assert d.remaining() is None and not d.expired()
    d.check("anything")  # no raise


def test_default_deadline_env(monkeypatch):
    monkeypatch.delenv(W.WATCHDOG_ENV, raising=False)
    assert W.default_deadline() is None
    monkeypatch.setenv(W.WATCHDOG_ENV, "0")  # 0 means OFF, not instant
    assert W.default_deadline() is None
    monkeypatch.setenv(W.WATCHDOG_ENV, "2.5")
    d = W.default_deadline()
    assert d is not None and d.budget == 2.5


@pytest.mark.parametrize("raw,outcome", [
    ("", None),            # empty = unset = no watchdog
    ("   ", None),         # whitespace-only = unset
    ("0", None),           # zero = off, not an instantly-expired budget
    ("0.0", None),
    ("-5", None),          # negative = off (documented)
    ("-0.01", None),
    ("2.5", 2.5),          # well-formed budgets construct Deadlines
    ("  30  ", 30.0),      # surrounding whitespace tolerated
    ("1e-3", 1e-3),
    ("abc", "raise"),      # malformed must be LOUD, never a silent off
    ("2.5s", "raise"),
    ("1,5", "raise"),
    ("nan", "raise"),      # NaN parses as float but is not a budget
    ("NaN", "raise"),
    ("inf", "raise"),      # a watchdog that never fires = silent off
    ("-inf", "raise"),
    ("Infinity", "raise"),
])
def test_default_deadline_env_matrix(monkeypatch, raw, outcome):
    """The $SMI_WATCHDOG_SECS parse matrix: unset/empty/zero/negative
    mean OFF, numbers mean budgets, and anything malformed raises a
    named error citing the knob and the bad value — the
    SMI_TPU_RS_AG_MIN_BYTES discipline (a typo must not silently
    disable the watchdog)."""
    monkeypatch.setenv(W.WATCHDOG_ENV, raw)
    if outcome == "raise":
        with pytest.raises(ValueError) as e:
            W.default_deadline()
        msg = str(e.value)
        assert W.WATCHDOG_ENV in msg
        assert raw.strip() in msg
    elif outcome is None:
        assert W.default_deadline() is None
    else:
        d = W.default_deadline()
        assert d is not None and d.budget == outcome


def test_run_with_deadline_times_out():
    import time as _time

    with pytest.raises(W.WatchdogTimeout) as e:
        W.run_with_deadline(
            lambda: _time.sleep(30), 0.05,
            state_provider=lambda: "dump-text", context="unit test",
        )
    assert "dump-text" in str(e.value)
    assert e.value.budget == 0.05


def test_run_with_deadline_passes_result_and_errors():
    assert W.run_with_deadline(lambda: 42, 1.0) == 42
    assert W.run_with_deadline(lambda: 42, None) == 42
    with pytest.raises(KeyError):
        W.run_with_deadline(lambda: {}[0], 1.0)


def test_mirror_stall_dump_all_protocols():
    """The mirror parks every rank at a remote wait — by construction no
    rank can be runnable when no DMA ever lands."""
    for protocol in F.PROTOCOLS:
        dump = F.mirror_stall_dump(protocol, 4)
        states = {dump[r]["state"] for r in range(4)}
        assert states <= {"blocked", "finished"}
        assert "blocked" in states


# ---------------------------------------------------------------------------
# Degraded-mode routing: random link cuts on 1-D / 2-D tori
# ---------------------------------------------------------------------------

import random as _random

from smi_tpu_torch.parallel.routing import (
    FailureSet,
    Link,
    NoRouteFound,
    RouteCutError,
    build_routing_context,
    egress_link_toward,
    egress_tables,
    grid_topology,
    ingress_table,
)


def _random_cut(topo, rng, k):
    """k distinct wire endpoints, each naming one physical link."""
    endpoints = sorted(
        topo.connections, key=lambda e: (e[0].key, e[1])
    )
    picked = rng.sample(endpoints, min(k, len(endpoints)))
    return FailureSet(links=frozenset(picked))


@pytest.mark.parametrize("shape", [(1, 4), (1, 6), (2, 3), (3, 3), (2, 4)])
@pytest.mark.parametrize("seed", range(6))
def test_random_cuts_route_or_name_the_cut(shape, seed):
    """Property: under a random link cut on a torus, every pair either
    gets a valid route that avoids the cut, or raises a RouteCutError
    naming the cut — never a bogus route and never a bare failure."""
    rng = _random.Random(f"{shape}:{seed}")
    topo = grid_topology(*shape)
    ctx = build_routing_context(topo)
    program = topo.mapping.programs[0]
    cut = _random_cut(topo, rng, rng.randint(1, 3))
    degraded = build_routing_context(topo, excluded=cut)
    for dev in topo.devices:
        try:
            tables = egress_tables(dev, ctx, program, excluded=cut)
        except RouteCutError as e:
            assert e.cut == cut
            continue
        # routable: following the degraded tables' first hops must
        # reach every destination without ever crossing a cut wire
        for dst in topo.devices:
            if dst == dev:
                continue
            link_idx, peer = egress_link_toward(
                dev, dst, degraded, program, tables=tables
            )
            assert not cut.wire_down(
                Link(dev, link_idx),
                Link(peer, topo.connections[(dev, link_idx)][1]),
            ), f"route {dev}->{dst} uses a cut wire"


@pytest.mark.parametrize("shape", [(1, 4), (3, 3)])
def test_full_isolation_names_the_cut(shape):
    """Cutting every wire of one device must name that exact cut for
    routes to it, and leave the others routable among themselves."""
    topo = grid_topology(*shape)
    ctx = build_routing_context(topo)
    program = topo.mapping.programs[0]
    victim = topo.devices[0]
    links = frozenset(
        (dev, li) for (dev, li) in topo.connections if dev == victim
    )
    cut = FailureSet(links=links)
    with pytest.raises(RouteCutError) as e:
        egress_tables(topo.devices[1], ctx, program, excluded=cut)
    assert e.value.cut == cut
    assert str(victim) in str(e.value)


def test_never_routable_is_not_a_cut():
    """A topology with no wires at all raises plain NoRouteFound (the
    pair never routed), not RouteCutError."""
    topo = grid_topology(1, 3, wrap=False)
    # remove the middle: 0-1 and 1-2 wires both cut isolates everything
    topo.connections.clear()
    ctx = build_routing_context(
        topo, excluded=FailureSet(links=frozenset())
    )
    program = topo.mapping.programs[0]
    with pytest.raises(NoRouteFound) as e:
        egress_tables(topo.devices[0], ctx, program)
    assert not isinstance(e.value, RouteCutError)


def test_down_device_keeps_rank_space():
    """A down device loses its wires but keeps its rank slot: table
    shapes for survivors are unchanged and routes transit around it."""
    topo = grid_topology(3, 3)
    ctx = build_routing_context(topo)
    program = topo.mapping.programs[0]
    victim = topo.devices[4]  # the centre of the 3x3 torus
    cut = FailureSet(devices=frozenset({victim}))
    src = topo.devices[0]
    healthy_tables = egress_tables(src, ctx, program)
    try:
        egress_tables(src, ctx, program, excluded=cut)
        pytest.fail("routing TO the down device should be cut")
    except RouteCutError:
        pass
    # route the survivors' pairs individually: all routable, shape kept
    degraded = build_routing_context(topo, excluded=cut)
    for dst in topo.devices:
        if dst in (src, victim):
            continue
        link_idx, peer = egress_link_toward(src, dst, degraded)
        assert peer != victim
    t = next(iter(healthy_tables.values()))
    assert t.n_ranks == len(topo.devices)


def test_ingress_table_for_down_link_rejected():
    topo = grid_topology(1, 4)
    ctx = build_routing_context(topo)
    program = topo.mapping.programs[0]
    dev = topo.devices[0]
    cut = FailureSet(links=frozenset({(dev, 0)}))
    with pytest.raises(RouteCutError):
        ingress_table(Link(dev, 0), ctx, program, excluded=cut)
    # other links of the same device are unaffected
    ingress_table(Link(dev, 2), ctx, program, excluded=cut)


# ---------------------------------------------------------------------------
# Parity with the JAX package: verdicts, dumps and texts
# ---------------------------------------------------------------------------


def plain(value):
    """A state dump with each package's frames as (class name, fields),
    so two packages' dumps compare field by field."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__, plain(dataclasses.astuple(value)))
    if isinstance(value, dict):
        return {plain(k): plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(plain(v) for v in value)
    return value


def verdict_of(mod_f, mod_c, protocol, n, plan_args, seed, verified=True):
    """(kind, error type, text, state) of one run under a random plan of
    the given class in one package."""
    plan = mod_f.FaultPlan.random(*plan_args)
    verdict = mod_f.run_under_faults(protocol, n, plan, mod_c.Strategy(seed),
                                     verified=verified)
    error = verdict.error
    return (verdict.kind, verdict.error_name,
            None if error is None else str(error),
            plain(getattr(error, "state", None)), repr(plan),
            plan.describe())


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("fault_class", F.FAULT_CLASSES)
@pytest.mark.parametrize("n", [3, 5])
def test_fault_verdicts_dumps_and_texts_match_jax(protocol, fault_class, n):
    for seed in range(3):
        port = verdict_of(F, C, protocol, n, (fault_class, n, seed), seed)
        want = verdict_of(JF, JC, protocol, n, (fault_class, n, seed), seed)
        assert port == want


@pytest.mark.parametrize("protocol", F.PROTOCOLS)
@pytest.mark.parametrize("fault_class",
                         ["bit_flip_payload", "truncated_dma"])
def test_bare_transport_corruption_reads_the_same(fault_class, protocol):
    """Without the framing a tamper completes silently corrupt (or is
    never issued) in both packages alike, with the same text."""
    def outcome(mod_f, mod_c, seed):
        plan = mod_f.FaultPlan.random(fault_class, 4, seed)
        try:
            return mod_f.run_under_faults(protocol, 4, plan,
                                          mod_c.Strategy(0),
                                          verified=False).kind
        except mod_f.SilentCorruption as e:
            return str(e)

    got = [outcome(F, C, seed) for seed in range(3)]
    assert got == [outcome(JF, JC, seed) for seed in range(3)]
    assert any(g != "tolerated" for g in got)


@pytest.mark.parametrize("n", range(2, 9))
@pytest.mark.parametrize("protocol", sorted(set(F.PROTOCOLS)
                                            | set(F.FAMILY_PROTOCOL)))
def test_mirror_stall_dump_matches_jax(protocol, n):
    assert F.mirror_stall_dump(protocol, n) == JF.mirror_stall_dump(
        protocol, n)
    for structured in (False, True):
        assert F.mirror_state_provider(protocol, n, structured=structured)() \
            == JF.mirror_state_provider(protocol, n, structured=structured)()


def test_the_fault_registries_match_jax():
    for name in ("PROTOCOLS", "FAULT_CLASSES", "INTEGRITY_FAULT_CLASSES",
                 "ELASTIC_FAULT_CLASSES", "SERVING_FAULT_CLASSES",
                 "DCN_FAULT_CLASSES", "PARTITION_FAULT_CLASSES",
                 "FAMILY_PROTOCOL", "POD_PROTOCOLS", "ALLTOALL_PROTOCOLS",
                 "QUANTIZED_PROTOCOLS"):
        assert getattr(F, name) == getattr(JF, name), name
    assert [c.__name__ for c in F.DETECTED_ERRORS] == [
        c.__name__ for c in JF.DETECTED_ERRORS]
    # the channels' IntegrityError is one the harness classifies
    assert st.IntegrityError in F.DETECTED_ERRORS


def test_a_failing_mirror_never_masks_the_timeout():
    for mod_f, mod_w in ((F, W), (JF, JW)):
        provider = mod_f.mirror_state_provider("no_such_protocol", 4,
                                               structured=True)
        with pytest.raises(mod_w.WatchdogTimeout) as e:
            mod_w.Deadline(0.0, state_provider=provider).check("x")
        assert e.value.state is None
        assert "state mirror unavailable" in e.value.state_dump


# ---------------------------------------------------------------------------
# The protocol mirror on every ring-tier deadline (the repaired fault)
# ---------------------------------------------------------------------------

#: family -> (the mirror's protocol, a call of the port on a rank's
#: communicator, the same call of the JAX package on its communicator)
FAMILIES = {
    "bcast": ("all_reduce",
              lambda x, c, d: coll.bcast(x, c, root=5, backend="ring",
                                         deadline=d),
              lambda x, c, d: jcoll.bcast(x, c, root=5, backend="ring",
                                          deadline=d)),
    "reduce": ("all_reduce",
               lambda x, c, d: coll.reduce(x, c, backend="ring", deadline=d),
               lambda x, c, d: jcoll.reduce(x, c, backend="ring",
                                            deadline=d)),
    "allreduce": ("all_reduce",
                  lambda x, c, d: coll.allreduce(x, c, backend="ring",
                                                 deadline=d),
                  lambda x, c, d: jcoll.allreduce(x, c, backend="ring",
                                                  deadline=d)),
    "scatter": ("reduce_scatter",
                lambda x, c, d: coll.scatter(x, c, backend="ring",
                                             deadline=d),
                lambda x, c, d: jcoll.scatter(x, c, backend="ring",
                                              deadline=d)),
    "gather": ("all_gather",
               lambda x, c, d: coll.gather(x, c, backend="ring", deadline=d),
               lambda x, c, d: jcoll.gather(x, c, backend="ring",
                                            deadline=d)),
    "transfer": ("neighbour_stream",
                 lambda x, c, d: st.P2PChannel(
                     comm=c, port=0, src=0, dst=3, count=8).transfer(
                         x, backend="ring", deadline=d),
                 lambda x, c, d: smi.P2PChannel(
                     comm=c, port=0, src=0, dst=3, count=8).transfer(
                         x, backend="ring", deadline=d)),
    "stream": ("neighbour_stream",
               lambda x, c, d: st.P2PChannel(
                   comm=c, port=0, src=0, dst=3, count=8).stream(
                       x, backend="ring", deadline=d),
               lambda x, c, d: smi.P2PChannel(
                   comm=c, port=0, src=0, dst=3, count=8).stream(
                       x, backend="ring", deadline=d)),
}


@pytest.fixture(scope="module")
def world8():
    return st.LocalWorld(8, device="cpu")


def port_timeouts(world, call):
    """Each rank's WatchdogTimeout from ``call`` under an expired
    deadline (every rank of the world raises before dispatching)."""
    def rank(c):
        x = torch.arange(8, dtype=torch.float32)
        with pytest.raises(W.WatchdogTimeout) as e:
            call(x, c, W.Deadline(0.0))
        return e.value

    return world.run(rank)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_an_expired_ring_deadline_carries_the_jax_mirror(world8, comm8,
                                                         family):
    """The port's timeout holds the protocol mirror that the JAX
    package's holds for the same family: ``.state`` equal, dict for
    dict, and ``.state_dump`` equal, text for text. Before the mirror
    was attached, the port's ``.state`` was None and its text bare."""
    protocol, port_call, jax_call = FAMILIES[family]
    with pytest.raises(JW.WatchdogTimeout) as want:
        jax_call(np.arange(8, dtype=np.float32), comm8, JW.Deadline(0.0))
    want = want.value
    assert want.state == F.mirror_stall_dump(protocol, 8)
    for got in port_timeouts(world8, port_call):
        assert got.state == want.state
        assert got.state_dump == want.state_dump
        assert f"protocol mirror [{protocol}, n=8]" in str(got)
        assert got.budget == 0.0
        # the error a recovery bridge reads: the same verdict as JAX's —
        # a bare hang names no crash-stopped rank, so nothing is shrunk
        assert R.failed_ranks_of(got) == set() == \
            R.failed_ranks_of(want)
        with pytest.raises(ValueError, match="retry the collective"):
            st.recover_communicator(world8.comms[0], got)


def test_a_dump_that_names_a_stalled_rank_shrinks_the_world(world8):
    """A ring-tier timeout whose mirror is joined by the simulator's
    diagnosis (rank 5 crash-stopped) shrinks the world to the seven
    survivors with rank 6 as the heir."""
    (got, *_) = port_timeouts(world8, FAMILIES["allreduce"][1])
    with pytest.raises(C.DeadlockError) as dead:
        C.simulate_all_reduce(
            8, C.Strategy(0),
            faults=F.FaultPlan.single(F.StalledRank(5, after=3)))
    got.state.update(dead.value.state)
    small, heirs = st.recover_communicator(world8.comms[0], got)
    assert heirs == {5: 6}
    assert small.size == 7 and list(small.world.parent_ranks) == [
        0, 1, 2, 3, 4, 6, 7]


def test_a_live_deadline_dispatches_and_keeps_its_clock(world8):
    """An unexpired deadline passes through with the mirror attached:
    the collective runs, and the inner deadline shares the caller's
    clock."""
    d = W.Deadline(3600.0)
    inner = d.with_provider(F.mirror_state_provider("reduce", 8))
    assert inner.budget == d.budget and inner._start == d._start
    out = world8.run(lambda c: coll.allreduce(
        torch.full((8,), float(c.rank)), c, backend="ring", deadline=d))
    assert all(torch.equal(o, torch.full((8,), 28.0)) for o in out)


def test_watchdog_surface_matches_jax():
    assert W.WATCHDOG_ENV == JW.WATCHDOG_ENV
    for mod in (W, JW):
        d = mod.Deadline(0.0, state_provider=lambda: ("text", {0: {}}))
        with pytest.raises(mod.WatchdogTimeout) as e:
            d.check("ctx")
        assert e.value.state == {0: {}} and e.value.state_dump == "text"

    class Recorder:
        def tail(self):
            return {"events": [], "total_events": 0, "dropped_events": 0}

    for mod in (W, JW):
        d = mod.Deadline(0.0, recorder=Recorder()).with_provider(
            lambda: ("t", {}))
        with pytest.raises(mod.WatchdogTimeout) as e:
            d.check()
        assert e.value.recorder_tail == Recorder().tail()
        assert e.value.state["flight_recorder"] == Recorder().tail()


# ---------------------------------------------------------------------------
# timed: the readback watchdog and the sample sink (the repaired fault)
# ---------------------------------------------------------------------------


class HangsOnReadback(torch.Tensor):
    """A tensor whose host readback never returns: the device hang a
    watchdog exists to bound."""

    def cpu(self, *args, **kwargs):
        import time as _time

        _time.sleep(30)


def test_timed_watchdog():
    from smi_tpu_torch.utils.tracing import timed

    result, secs = timed(lambda: 7)
    assert result == 7 and secs >= 0
    hung = torch.zeros(4).as_subclass(HangsOnReadback)
    with pytest.raises(W.WatchdogTimeout) as e:
        timed(lambda: hung, deadline_s=0.05,
              state_provider=F.mirror_state_provider("allreduce", 4,
                                                     structured=True))
    assert "timed() readback" in str(e.value)
    assert e.value.state == F.mirror_stall_dump("all_reduce", 4)


def test_timed_takes_its_default_deadline_from_the_environment(monkeypatch):
    from smi_tpu_torch.utils.tracing import timed

    hung = torch.zeros(4).as_subclass(HangsOnReadback)
    monkeypatch.setenv(W.WATCHDOG_ENV, "0.05")
    with pytest.raises(W.WatchdogTimeout):
        timed(lambda: [hung])
    monkeypatch.setenv(W.WATCHDOG_ENV, "soon")
    with pytest.raises(ValueError, match=W.WATCHDOG_ENV):
        timed(lambda: 1)


def test_timed_runs_fn_in_the_callers_thread():
    import threading

    from smi_tpu_torch.utils.tracing import timed

    seen = []
    timed(lambda: seen.append(threading.current_thread()), deadline_s=5.0)
    assert seen == [threading.current_thread()]


def test_timed_feeds_the_online_tuner_as_a_direct_record():
    """``timed(sink=tuner, op=, payload_bytes=, tenant=)`` is the online
    tuner's documented feed (``tuning/online.py``): it records the same
    sample a direct ``record`` call does. Before the hooks,
    ``timed(sink=...)`` raised TypeError."""
    from smi_tpu_torch.tuning.online import OnlineTuner
    from smi_tpu_torch.utils.tracing import timed

    fed, direct = OnlineTuner(), OnlineTuner()
    x = torch.arange(1024, dtype=torch.float32)
    result, secs = timed(lambda: x * 2, deadline_s=60.0, sink=fed,
                         op="all_reduce", payload_bytes=4096.0,
                         tenant="tenant-a")
    assert torch.equal(result, x * 2)
    direct.record("all_reduce", secs, payload_bytes=4096.0,
                  tenant="tenant-a")
    assert fed.samples_ingested == direct.samples_ingested == 1
    assert fed.cells == direct.cells


def test_timed_calls_a_plain_sink_and_lets_its_failure_through():
    from smi_tpu_torch.utils.tracing import timed

    calls = []
    timed(lambda: 1, sink=lambda op, s: calls.append((op, s)), op="probe")
    assert [c[0] for c in calls] == ["probe"]

    def broken(op, s):
        raise RuntimeError("sink down")

    with pytest.raises(RuntimeError, match="sink down"):
        timed(lambda: 1, sink=broken)


def test_run_with_deadline_reads_back_after_the_callers_work():
    """The hard watchdog runs inline without a budget and in a worker
    with one; both return what ``fn`` returns."""
    x = torch.arange(16.0)
    assert torch.equal(W.run_with_deadline(lambda: x.cpu(), None), x)
    assert torch.equal(W.run_with_deadline(lambda: x.cpu(), 10.0), x)
    assert W._caller_cuda_event() is None  # no CUDA in this process
