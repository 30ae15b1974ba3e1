"""The port's degraded-mode communicator against the JAX package's.

``shrink``, ``regrow``, ``shrink_pod`` and ``regrow_pod`` on an 8-rank
``LocalWorld`` (and its ``(2, 4)`` hybrid form) against the JAX
``Communicator`` on the same excluded and readmit sets: the members in
original rank order, the axis names, the shape, the epoch and every
error text. Then the recovery bridge (``heir_of``, ``plan_ring``,
``failed_ranks_of``, ``recover_communicator``) over every excluded set
of an 8-ring, the epoch gate, the survivors' collectives on a thread
world, and a 4-process gloo group from which one rank drops out."""

import dataclasses
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.parallel import membership as jmembership
from smi_tpu.parallel import recovery as jrecovery
from smi_tpu.parallel import routing as jrouting
from smi_tpu.utils import watchdog as jwatchdog
from smi_tpu_torch.parallel import membership as tmembership
from smi_tpu_torch.parallel import recovery as trecovery
from smi_tpu_torch.parallel import routing as trouting

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_gloo_worker  # noqa: E402


@pytest.fixture(scope="module")
def flat_world():
    return st.LocalWorld(8, device="cpu")


@pytest.fixture(scope="module")
def pod_world():
    return st.LocalWorld((2, 4), ("dcn", "ici"), device="cpu")


@pytest.fixture(scope="module")
def jax_pod(eight_devices):
    return smi.make_hybrid_communicator(n_slices=2, devices=eight_devices)


def jax_view(comm):
    """(members as original ranks, axis names, shape, epoch) of a JAX
    communicator over the first eight CPU devices."""
    return ([d.id for d in comm.mesh.devices.flat], tuple(comm.axis_names),
            tuple(comm.mesh.shape[a] for a in comm.axis_names), comm.epoch)


def port_view(comm, world):
    """The same of the port: the members are the ranks of ``world`` that
    the communicator's world was made of (``parent_ranks``)."""
    members = (list(range(world.size)) if comm.world is world
               else list(comm.world.parent_ranks))
    return members, tuple(comm.axis_names), tuple(comm.shape), comm.epoch


def both(jcomm, world, change, stays):
    """``change`` on the JAX communicator and on a rank of ``world`` that
    is among ``stays`` (rank 0 when none is): each side's view, or the
    error's type and text."""
    out = []
    member = next((c for c in world.comms if c.rank in stays),
                  world.comms[0])
    for comm, view in ((jcomm, jax_view),
                       (member, lambda c: port_view(c, world))):
        try:
            out.append(view(change(comm)))
        except (ValueError, trouting.RouteCutError,
                jrouting.RouteCutError) as e:
            out.append((type(e).__name__, str(e)))
    return out


SHRINK_SETS = [set(), {5}, {0}, {7}, {0, 7}, {1, 2, 3}, {0, 2, 4, 6},
               set(range(1, 8)), set(range(8)), {8}, {-1, 3}]


@pytest.mark.parametrize("excluded", SHRINK_SETS, ids=str)
def test_shrink_matches_jax(comm8, flat_world, excluded):
    stays = set(range(8)) - excluded
    jax_side, port_side = both(comm8, flat_world,
                               lambda c: c.shrink(excluded), stays)
    assert port_side == jax_side


REGROWS = [({5}, {5}, None), ({1, 2}, {2}, None), ({1, 2}, {1, 2}, 7),
           ({0, 3, 6}, {3}, 4), ({1}, {3}, None), ({1}, set(), None),
           ({9}, {9}, None)]


@pytest.mark.parametrize("excluded,readmit,epoch", REGROWS, ids=str)
def test_regrow_matches_jax(comm8, flat_world, excluded, readmit, epoch):
    stays = set(range(8)) - (excluded - readmit)
    jax_side, port_side = both(
        comm8, flat_world,
        lambda c: c.regrow(excluded, readmit, epoch=epoch), stays)
    assert port_side == jax_side


POD_SHRINKS = [set(), {4, 5, 6, 7}, {0, 1, 2, 3}, {5}, {0, 4}, {1, 4, 5, 6, 7},
               set(range(8)), {11}]


@pytest.mark.parametrize("excluded", POD_SHRINKS, ids=str)
def test_shrink_pod_matches_jax(jax_pod, pod_world, excluded):
    stays = set(range(8)) - excluded
    jax_side, port_side = both(jax_pod, pod_world,
                               lambda c: c.shrink_pod(excluded), stays)
    assert port_side == jax_side


POD_REGROWS = [({4, 5, 6, 7}, {4, 5, 6, 7}, None),
               ({4, 5, 6, 7, 1}, {1}, None),
               ({4, 5, 6, 7, 1}, {4}, None),
               ({0, 1, 2, 3}, {0, 1, 2, 3}, 9),
               ({2}, {5}, None)]


@pytest.mark.parametrize("excluded,readmit,epoch", POD_REGROWS, ids=str)
def test_regrow_pod_matches_jax(jax_pod, pod_world, excluded, readmit,
                                epoch):
    stays = set(range(8)) - (excluded - readmit)
    jax_side, port_side = both(
        jax_pod, pod_world,
        lambda c: c.regrow_pod(excluded, readmit, epoch=epoch), stays)
    assert port_side == jax_side


@pytest.mark.parametrize("what", ["shrink_pod", "regrow_pod"])
def test_pod_changes_refuse_a_flat_communicator_alike(comm8, flat_world,
                                                      what):
    args = ({1},) if what == "shrink_pod" else ({1}, {1})
    texts = []
    for comm in (comm8, flat_world.comms[0]):
        with pytest.raises(ValueError) as e:
            getattr(comm, what)(*args)
        texts.append(str(e.value))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("still_dead,readmit", [({2, 6}, {5}), ({6}, {2})])
def test_regrow_with_a_topology_checks_routes_like_jax(comm8, flat_world,
                                                       still_dead, readmit):
    """A ring topology on the communicator: a regrow that leaves two
    dead devices splits the ring and raises the same RouteCutError; one
    dead device leaves it routable."""
    excluded = still_dead | readmit
    jcomm = dataclasses.replace(comm8, topology=jrouting.grid_topology(1, 8))
    tworld = flat_world
    member = next(c for c in tworld.comms if c.rank not in still_dead)
    tcomm = dataclasses.replace(member,
                                topology=trouting.grid_topology(1, 8))
    try:
        want = jax_view(jcomm.regrow(excluded, readmit))
    except jrouting.RouteCutError as e:
        want = str(e)
        with pytest.raises(trouting.RouteCutError) as got:
            tcomm.regrow(excluded, readmit)
        assert str(got.value) == want and len(still_dead) == 2
        assert str(got.value.cut) == str(e.cut)
        return
    assert port_view(tcomm.regrow(excluded, readmit), tworld) == want


def test_shrink_drops_the_topology_and_keeps_the_epoch_chain(flat_world):
    comm = dataclasses.replace(flat_world.comms[0],
                               topology=trouting.grid_topology(1, 8))
    small = comm.shrink({5})
    assert small.topology is None and small.epoch == 1
    smaller = small.world.shrink({0})
    assert smaller.epoch == 2 and smaller.parent_ranks == tuple(range(1, 7))
    assert comm.shrink(set()) is comm


def test_member_worlds_are_made_once(flat_world):
    """Every survivor's ``shrink`` returns a rank of one new world, the
    host's ``world.shrink`` the same world; an excluded rank that asks
    is refused by name."""
    got = flat_world.run(lambda c: None if c.rank == 5
                         else c.shrink({5}))
    worlds = {id(c.world) for c in got if c is not None}
    assert len(worlds) == 1
    world7 = flat_world.shrink({5})
    assert id(world7) in worlds and world7.size == 7 and world7.epoch == 1
    assert [c.rank for c in got if c is not None] == list(range(7))
    with pytest.raises(ValueError, match="rank 5 is excluded"):
        flat_world.comms[5].shrink({5})
    with pytest.raises(ValueError, match="no survivors"):
        flat_world.shrink(range(8))
    assert flat_world.regrow({5}, {5}).parent_ranks == tuple(range(8))
    assert flat_world.regrow({5}, {5}).epoch == 2


@pytest.mark.parametrize("backend", ["xla", "ring"])
def test_survivors_all_reduce_to_the_plain_sum(flat_world, backend):
    """8 -> 7: the survivors' all-reduce (inside the parent's run, and on
    the survivors' own world) is the plain sum of their inputs."""
    xs = [torch.arange(12, dtype=torch.float32) * (r + 1) for r in range(8)]
    want = sum(xs[r] for r in range(8) if r != 5)

    def survivor(c):
        if c.rank == 5:
            return None
        return st.allreduce(xs[c.rank], c.shrink({5}), backend=backend)

    for out in flat_world.run(survivor):
        assert out is None or torch.equal(out, want)
    world7 = flat_world.shrink({5})
    outs = world7.run(lambda c: st.allreduce(
        xs[world7.parent_ranks[c.rank]], c, backend=backend))
    assert all(torch.equal(o, want) for o in outs)
    back = flat_world.regrow({5}, {5})
    outs = back.run(lambda c: st.allreduce(xs[c.rank], c, backend=backend))
    assert all(torch.equal(o, sum(xs)) for o in outs)


def test_smi_context_shrink_drops_the_deadline(flat_world):
    ctx = st.SmiContext(flat_world.comms[0], backend="ring",
                        deadline=st.Deadline(30.0))
    small = ctx.shrink({3})
    assert small.comm.size == 7 and small.comm.epoch == 1
    assert small.deadline is None and small.backend == "ring"


@pytest.mark.parametrize("excluded", [set(s) for n in range(1, 8)
                                      for s in itertools.combinations(
                                          range(8), n)], ids=str)
def test_heirs_and_recovery_match_jax(comm8, flat_world, excluded):
    """Every excluded set of an 8-ring (but the full one): the heirs, the
    shrunk size and epoch of ``recover_communicator`` from a set and from
    a timeout's state dump, and ``failed_ranks_of`` with a survivors
    map."""
    assert flat_world.comms[0].heirs(excluded) == comm8.heirs(excluded)
    survivors = [r for r in range(8) if r not in excluded]
    for r in excluded:
        assert trecovery.heir_of(r, survivors, 8) == \
            jrecovery.heir_of(r, survivors, 8)
    state = {r: {"state": "stalled" if r in excluded else "running"}
             for r in range(8)}
    state["flight_recorder"] = []
    terr = st.WatchdogTimeout("late", state=state)
    jerr = jwatchdog.WatchdogTimeout("late", state=state)
    assert trecovery.failed_ranks_of(terr) == \
        jrecovery.failed_ranks_of(jerr) == excluded
    ring_map = list(range(10, 18))
    assert trecovery.failed_ranks_of(terr, ring_map) == \
        jrecovery.failed_ranks_of(jerr, ring_map)
    member = flat_world.comms[survivors[0]]
    tsmall, theirs = st.recover_communicator(member, terr)
    jsmall, jheirs = smi.recover_communicator(comm8, jerr)
    assert theirs == jheirs
    assert port_view(tsmall, flat_world)[1:] == jax_view(jsmall)[1:]
    assert port_view(tsmall, flat_world)[0] == jax_view(jsmall)[0]


def test_recovery_refusals_match_jax(comm8, flat_world):
    texts = []
    for comm, recover, timeout in (
            (comm8, smi.recover_communicator, jwatchdog.WatchdogTimeout),
            (flat_world.comms[0], st.recover_communicator,
             st.WatchdogTimeout)):
        got = []
        for failure in (set(), timeout("late"),
                        timeout("late", state={1: {"state": "running"}})):
            with pytest.raises(ValueError) as e:
                recover(comm, failure)
            got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            comm.heirs(range(8))
        got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            comm.heirs({8})
        got.append(str(e.value))
        texts.append(got)
    assert texts[0] == texts[1]
    assert trecovery.failed_ranks_of(ValueError("no dump")) == set()


@pytest.mark.parametrize("down", [
    [], [(0, 1)], [(0, 1), (4, 5)], [(0, 1), (1, 2), (2, 3)],
    [(r, (r + 1) % 8) for r in range(8)], [(0, 4), (1, 5), (2, 6)],
], ids=str)
def test_plan_ring_matches_jax(down):
    for n_dead in range(0, 7):
        survivors = list(range(n_dead, 8))
        try:
            want = jrecovery.plan_ring(survivors, down, 8)
        except jrecovery.UnrecoverableError as e:
            with pytest.raises(trecovery.UnrecoverableError) as got:
                trecovery.plan_ring(survivors, down, 8)
            assert str(got.value) == str(e)
            continue
        assert trecovery.plan_ring(survivors, down, 8) == want


@pytest.mark.parametrize("pair,survivors", [
    ((0, 1), range(8)), ((3, 4), [0, 1, 2, 3, 4, 5]), ((7, 0), range(8)),
    ((2, 5), range(8)), ((1, 2), [0, 1, 2]),
])
def test_cut_routable_check_matches_jax(pair, survivors):
    outcomes = []
    for mod, routing in ((jrecovery, jrouting), (trecovery, trouting)):
        try:
            mod._check_cut_routable(8, pair, list(survivors))
            outcomes.append("ok")
        except routing.RouteCutError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_two_cut_wires_isolate_a_survivor_alike():
    outcomes = []
    for mod, routing in ((jrecovery, jrouting), (trecovery, trouting)):
        topo = routing.grid_topology(1, 8)
        cut = routing.FailureSet(links=frozenset(
            {(topo.devices[2], 0), (topo.devices[3], 0)}))
        ctx = routing.build_routing_context(topo, excluded=cut)
        with pytest.raises(routing.RouteCutError) as e:
            routing.check_all_pairs_routable(ctx)
        outcomes.append(str(e.value))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("stale,current,what", [
    (0, 1, "message"), (3, 1, "frame"), (1, 2, "checkpoint")])
def test_stale_epoch_texts_match_jax(flat_world, stale, current, what):
    want = jmembership.StaleEpochError(4, stale, current, what=what)
    got = st.StaleEpochError(4, stale, current, what=what)
    assert str(got) == str(want)
    assert (got.rank, got.stale, got.current) == (4, stale, current)
    comm = dataclasses.replace(flat_world.comms[0], epoch=current)
    with pytest.raises(st.StaleEpochError) as e:
        comm.validate_epoch(4, stale, what=what)
    assert str(e.value) == str(want)
    comm.validate_epoch(4, current)


def test_detector_settings_are_the_jax_ones():
    for name in ("SUSPECT_PHI", "DEAD_PHI", "HEARTBEAT_INTERVAL",
                 "CONFIRM_GRACE_TICKS"):
        assert getattr(tmembership, name) == getattr(jmembership, name)


def test_gloo_survivors_shrink_without_the_dropped_rank():
    """Four processes; rank 2 drops out after the group is up and takes
    no further part. The survivors shrink it away — their group formed
    among themselves, every peer mapped to its process rank — and their
    collectives equal a thread world's shrunk the same way."""
    x = np.random.RandomState(16).randint(-50, 50, (4, 12)).astype(
        np.float32)
    reports = torch_gloo_worker.run_group(torch_gloo_worker.run_shrink, 4,
                                          (x, 2))
    assert reports[2] is None
    world3 = st.LocalWorld(4, device="cpu").shrink({2})
    want = world3.run(lambda c: torch_gloo_worker.shrink_suite(
        c, torch.from_numpy(x[world3.parent_ranks[c.rank]])))
    for new, old in enumerate(world3.parent_ranks):
        assert reports[old]["membership"] == (new, 3, 1, (0, 1, 3), True)
        for name, value in want[new].items():
            np.testing.assert_array_equal(reports[old][name], value.numpy(),
                                          err_msg=f"rank {old}: {name}")
