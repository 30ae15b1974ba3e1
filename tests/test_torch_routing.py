"""The port's routing layer against the JAX package's, table for table.

Every topology that ``tests/test_routing.py`` pins (the reference's CKS
and CKR byte cases among them), the ring and torus fixtures, and the
degraded contexts of :class:`FailureSet` cuts are built in both packages
from the same description; the egress and ingress tables must serialize
to the same bytes, and every error must carry the same text."""

import dataclasses
import types

import pytest

import smi_tpu_torch as st
from smi_tpu.ops import operations as jops
from smi_tpu.ops import program as jprogram
from smi_tpu.ops import serialization as jser
from smi_tpu.parallel import routing as jrouting
from smi_tpu.tuning import cost_model as jcm
from smi_tpu_torch.ops import operations as tops
from smi_tpu_torch.ops import program as tprogram
from smi_tpu_torch.ops import serialization as tser
from smi_tpu_torch.parallel import routing as trouting
from smi_tpu_torch.tuning import cost_model as tcm

PACKAGES = {
    "jax": types.SimpleNamespace(routing=jrouting, ops=jops,
                                 program=jprogram, ser=jser),
    "torch": types.SimpleNamespace(routing=trouting, ops=tops,
                                   program=tprogram, ser=tser),
}

DOUBLE_RAIL = {
    ("N1:F0", 1): ("N1:F1", 0),
    ("N1:F0", 3): ("N1:F1", 2),
    ("N1:F1", 1): ("N2:F0", 0),
    ("N1:F1", 3): ("N2:F0", 2),
    ("N2:F0", 1): ("N2:F1", 0),
    ("N2:F0", 3): ("N2:F1", 2),
    ("N2:F1", 1): ("N1:F0", 0),
    ("N2:F1", 3): ("N1:F0", 2),
}

DOUBLE_RAIL2 = {
    ("N:F0", 1): ("N:F1", 0), ("N:F0", 3): ("N:F1", 2),
    ("N:F1", 1): ("N:F2", 0), ("N:F1", 3): ("N:F2", 2),
    ("N:F2", 1): ("N:F3", 0), ("N:F2", 3): ("N:F3", 2),
    ("N:F3", 1): ("N:F4", 0), ("N:F3", 3): ("N:F4", 2),
    ("N:F4", 1): ("N:F5", 0), ("N:F4", 3): ("N:F5", 2),
    ("N:F5", 1): ("N:F0", 0), ("N:F5", 3): ("N:F0", 2),
}

#: name -> (connections, program ops as (kind, port), program keywords):
#: each topology of tests/test_routing.py
FILE_TOPOLOGIES = {
    "cks_table_1": ({("NA:0", 1): ("NB:0", 1), ("NA:0", 3): ("NB:0", 3)},
                    [("push", 0), ("push", 1)], {}),
    "cks_table_2": ({("NA:0", 0): ("NB:0", 0), ("NA:0", 3): ("NB:0", 3)},
                    [("push", 0), ("push", 1)], {}),
    "double_rail": (DOUBLE_RAIL,
                    [("push", 0), ("pop", 0), ("push", 1), ("pop", 1)], {}),
    "double_rail2": (DOUBLE_RAIL2,
                     [("push", 0), ("pop", 0), ("push", 1), ("pop", 1)], {}),
    "ckr_table": ({("na:0", 0): ("nb:0", 0)},
                  [("push", 0), ("pop", 1), ("push", 2), ("pop", 3),
                   ("pop", 4)], {}),
    "parallel_wires": ({("A:00", 0): ("B:00", 0), ("A:00", 2): ("B:00", 2)},
                       [("push", p) for p in range(4)],
                       {"p2p_rendezvous": False}),
    "one_wire": ({("NA:0", 1): ("NB:0", 1)}, [("push", 0), ("pop", 0)], {}),
    "chain": ({("NA:0", 1): ("NB:0", 0), ("NB:0", 1): ("NC:0", 0)},
              [("push", 0)], {}),
}

#: name -> builder(routing module): the grid, ring and pod fixtures
GRID_TOPOLOGIES = {
    "ring8": lambda r: r.grid_topology(1, 8),
    "torus2x4": lambda r: r.grid_topology(2, 4),
    "mesh3x3": lambda r: r.grid_topology(3, 3, wrap=False),
    "pod2x2": lambda r: r.pod_topology(2, 2),
    "pod2x4": lambda r: r.pod_topology(2, 4),
}


def program_of(pkg, ops, **kw):
    kinds = {"push": pkg.ops.Push, "pop": pkg.ops.Pop}
    return pkg.program.Program([kinds[k](p) for k, p in ops], **kw)


def file_topology(pkg, name):
    """``tests/test_routing.py``'s ``make_topology`` in package ``pkg``."""
    connections, ops, kw = FILE_TOPOLOGIES[name]
    program = program_of(pkg, ops, **kw)
    device = pkg.program.Device
    conn, devs = {}, set()
    for (a, la), (b, lb) in connections.items():
        da, db = device.parse(a), device.parse(b)
        conn[(da, la)] = (db, lb)
        conn[(db, lb)] = (da, la)
        devs.update([da, db])
    mapping = pkg.program.ProgramMapping(
        programs=[program], device_to_program={d: program for d in devs})
    return pkg.ser.Topology(connections=conn, mapping=mapping)


def topology(pkg, name):
    if name in FILE_TOPOLOGIES:
        return file_topology(pkg, name)
    return GRID_TOPOLOGIES[name](pkg.routing)


def tables_bytes(pkg, topo, excluded=None):
    """Every device's egress and ingress tables as serialized bytes,
    keyed ``(kind, rank, link)``, or the error text of the first table
    that cannot be built."""
    r = pkg.routing
    ctx = r.build_routing_context(topo)
    out = {}
    try:
        for device in ctx.devices:
            program = topo.mapping.program_for(device)
            rank = ctx.rank_of(device)
            if excluded is None or device not in excluded.devices:
                egress = r.egress_tables(device, ctx, program,
                                         excluded=excluded)
                for link in ctx.links(device):
                    out[("cks", rank, link.index)] = r.serialize_table(
                        egress[link].flat())
            for link in ctx.links(device):
                try:
                    out[("ckr", rank, link.index)] = r.serialize_table(
                        r.ingress_table(link, ctx, program,
                                        excluded=excluded).flat())
                except r.RouteCutError as e:
                    out[("ckr", rank, link.index)] = ("cut", str(e))
    except r.NoRouteFound as e:
        return (type(e).__name__, str(e))
    return out


def failure_set(pkg, topo, links=(), devices=()):
    """A FailureSet of ``(rank, link)`` endpoints and whole ranks."""
    devs = topo.devices
    return pkg.routing.FailureSet(
        links=frozenset((devs[r], i) for r, i in links),
        devices=frozenset(devs[r] for r in devices))


@pytest.mark.parametrize("name", sorted(FILE_TOPOLOGIES) +
                         sorted(GRID_TOPOLOGIES))
def test_tables_are_byte_identical(name):
    got = tables_bytes(PACKAGES["torch"], topology(PACKAGES["torch"], name))
    want = tables_bytes(PACKAGES["jax"], topology(PACKAGES["jax"], name))
    assert got == want
    assert isinstance(got, dict) and got


@pytest.mark.parametrize("name", ["cks_table_1", "double_rail",
                                  "ckr_table", "torus2x4"])
def test_written_table_files_are_byte_identical(tmp_path, name):
    for pkg in ("jax", "torch"):
        ns = PACKAGES[pkg]
        ns.routing.write_routing_tables(tmp_path / pkg, topology(ns, name))
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "torch").iterdir())
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def test_reference_cks_table_1_bytes_in_the_port():
    """The reference's own matrix for test_cks_table_1, in the port."""
    topo = file_topology(PACKAGES["torch"], "cks_table_1")
    ctx = trouting.build_routing_context(topo)
    fa = tprogram.Device("NA", 0)
    tables = trouting.egress_tables(fa, ctx, topo.mapping.program_for(fa))
    # QSFP = 0, CKR = 1, a->b = 2 + sibling index (routing_table.py:25-63)
    assert [trouting.serialize_table(tables[trouting.Link(fa, i)].flat())
            for i in range(4)] == [bytes([1, 1, 2, 2]), bytes([1, 1, 0, 4]),
                                   bytes([1, 1, 3, 3]), bytes([1, 1, 0, 0])]


def test_reference_ckr_table_bytes_in_the_port():
    topo = file_topology(PACKAGES["torch"], "ckr_table")
    ctx = trouting.build_routing_context(topo)
    dev = tprogram.Device("na", 0)
    program = topo.mapping.program_for(dev)
    assert [trouting.serialize_table(trouting.ingress_table(
        trouting.Link(dev, i), ctx, program).flat()) for i in range(4)] == [
        bytes([0, 3, 4, 0, 0, 5, 1, 0, 2, 0]),
        bytes([0, 3, 1, 0, 0, 1, 4, 0, 2, 0]),
        bytes([0, 3, 1, 0, 0, 1, 2, 0, 4, 0]),
        bytes([0, 4, 1, 0, 0, 1, 2, 0, 3, 0])]


@pytest.mark.parametrize("connections,ops", [
    ({("N0:0", 0): ("N0:1", 0), ("N1:0", 0): ("N1:2", 1)}, [("push", 0)]),
    ({("N0:F0", 0): ("N0:F1", 0), ("N1:F0", 0): ("N1:F2", 1)}, []),
])
def test_no_route_between_partitions_names_the_same_pair(connections, ops):
    texts = []
    for pkg in ("jax", "torch"):
        ns = PACKAGES[pkg]
        FILE_TOPOLOGIES["_islands"] = (connections, ops, {})
        try:
            topo = file_topology(ns, "_islands")
        finally:
            del FILE_TOPOLOGIES["_islands"]
        ctx = ns.routing.build_routing_context(topo)
        device = ctx.devices[0]
        with pytest.raises(ns.routing.NoRouteFound) as e:
            ns.routing.egress_tables(device, ctx,
                                     topo.mapping.program_for(device))
        texts.append(str(e.value))
    assert texts[0] == texts[1]


#: (topology, cut links as (rank, link), dead ranks)
CUTS = [
    ("ring8", [(0, 0)], []),
    ("ring8", [(0, 0), (4, 0)], []),
    ("ring8", [], [3]),
    ("ring8", [], [2, 6]),
    ("torus2x4", [(1, 0), (1, 2)], []),
    ("torus2x4", [], [5]),
    ("mesh3x3", [(4, 0), (4, 1), (4, 2)], []),
    ("mesh3x3", [(0, 0), (0, 2)], []),
    ("pod2x4", [(0, 2), (0, 3)], []),
    ("pod2x2", [], [0, 1]),
]


@pytest.mark.parametrize("name,links,dead", CUTS)
def test_degraded_tables_and_cut_texts_are_identical(name, links, dead):
    results = []
    for pkg in ("jax", "torch"):
        ns = PACKAGES[pkg]
        topo = topology(ns, name)
        cut = failure_set(ns, topo, links, dead)
        ctx = ns.routing.build_routing_context(topo, excluded=cut)
        alive = [d for i, d in enumerate(topo.devices) if i not in dead]
        try:
            ns.routing.check_all_pairs_routable(ctx, alive)
            routable = "ok"
        except ns.routing.RouteCutError as e:
            routable = ("cut", str(e), str(e.cut))
        results.append((str(cut), cut.empty, routable,
                        tables_bytes(ns, topo, excluded=cut)))
    assert results[0] == results[1]


def test_failure_set_reads_the_same():
    for pkg in ("jax", "torch"):
        r = PACKAGES[pkg].routing
        assert str(r.FailureSet()) == "(none)" and r.FailureSet().empty
    jtopo = topology(PACKAGES["jax"], "torus2x4")
    ttopo = topology(PACKAGES["torch"], "torus2x4")
    for links, dead in [([(0, 1), (3, 2)], []), ([], [1, 7]),
                        ([(2, 0)], [4])]:
        jcut = failure_set(PACKAGES["jax"], jtopo, links, dead)
        tcut = failure_set(PACKAGES["torch"], ttopo, links, dead)
        assert str(tcut) == str(jcut)
        for a in range(8):
            for b in range(8):
                for i in range(4):
                    ja = jrouting.Link(jtopo.devices[a], i)
                    jb = jrouting.Link(jtopo.devices[b], (i + 1) % 4)
                    ta = trouting.Link(ttopo.devices[a], i)
                    tb = trouting.Link(ttopo.devices[b], (i + 1) % 4)
                    assert tcut.wire_down(ta, tb) == jcut.wire_down(ja, jb)
    assert issubclass(trouting.RouteCutError, trouting.NoRouteFound)


def test_degraded_context_needs_its_topology():
    texts = []
    for pkg in ("jax", "torch"):
        r = PACKAGES[pkg].routing
        ctx = dataclasses.replace(
            r.build_routing_context(r.grid_topology(1, 4)), topology=None)
        with pytest.raises(ValueError) as e:
            r.degraded_context(ctx, r.FailureSet())
        texts.append(str(e.value))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("n", range(1, 17))
def test_alltoall_pairwise_schedule_is_the_jax_one(n):
    assert trouting.alltoall_pairwise_schedule(n) == \
        jrouting.alltoall_pairwise_schedule(n)


def test_alltoall_schedule_refuses_zero_ranks_alike():
    texts = []
    for r in (jrouting, trouting):
        with pytest.raises(ValueError) as e:
            r.alltoall_pairwise_schedule(0)
        texts.append(str(e.value))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("name,ports", [("chain", None),
                                        ("parallel_wires", range(4)),
                                        ("double_rail", range(2)),
                                        ("torus2x4", None)])
def test_egress_link_toward_agrees(name, ports):
    answers = []
    for pkg in ("jax", "torch"):
        ns = PACKAGES[pkg]
        topo = topology(ns, name)
        ctx = ns.routing.build_routing_context(topo)
        got = []
        for a in ctx.devices:
            for b in ctx.devices:
                if a == b:
                    continue
                if ports is None:
                    link, peer = ns.routing.egress_link_toward(a, b, ctx)
                    got.append((str(a), str(b), link, str(peer)))
                    continue
                program = topo.mapping.program_for(a)
                for p in ports:
                    link, peer = ns.routing.egress_link_toward(
                        a, b, ctx, program=program, port=p)
                    got.append((str(a), str(b), p, link, str(peer)))
        answers.append(got)
    assert answers[0] == answers[1] and answers[0]


def test_sibling_index_and_its_refusal_agree():
    for s in range(4):
        for t in range(4):
            if s != t:
                assert trouting.sibling_index(s, t) == \
                    jrouting.sibling_index(s, t)
    with pytest.raises(ValueError, match="itself"):
        trouting.sibling_index(1, 1)


def test_configuration_errors_name_the_same_fault():
    texts = []
    for pkg in ("jax", "torch"):
        ns = PACKAGES[pkg]
        program = program_of(ns, [("push", 0)], num_streams=8)
        a, b = ns.program.Device("A", 0), ns.program.Device("B", 0)
        topo = ns.ser.Topology(
            connections={(a, 0): (b, 0), (b, 0): (a, 0)},
            mapping=ns.program.ProgramMapping(
                programs=[program], device_to_program={a: program,
                                                       b: program}))
        ctx = ns.routing.build_routing_context(topo)
        got = []
        for call in (lambda: ns.routing.egress_tables(a, ctx, program),
                     lambda: ns.routing.ingress_table(
                         ns.routing.Link(a, 0), ctx, program)):
            with pytest.raises(ValueError) as e:
                call()
            got.append(str(e.value))
        ghost = ns.program.Device("GHOST", 0)
        plain = program_of(ns, [("push", 0)])
        unmapped = ns.ser.Topology(
            connections={(a, 0): (ghost, 0), (ghost, 0): (a, 0)},
            mapping=ns.program.ProgramMapping(
                programs=[plain], device_to_program={a: plain}))
        with pytest.raises(KeyError) as e:
            ns.routing.build_routing_context(unmapped)
        got.append(str(e.value))
        texts.append(got)
    assert texts[0] == texts[1]


@pytest.mark.parametrize("slices", [1, 2, 4, 3])
def test_pod_slice_partition_agrees(slices):
    answers = []
    for r in (jrouting, trouting):
        topo = r.pod_topology(2, 4)
        try:
            answers.append([[str(d) for d in part]
                            for part in r.pod_slice_partition(topo, slices)])
        except ValueError as e:
            answers.append(str(e))
    assert answers[0] == answers[1]
    assert trouting.POD_DCN_LINK_INDICES == jrouting.POD_DCN_LINK_INDICES


@pytest.mark.parametrize("nrow,ncol", [(0, 4), (2, 0)])
def test_grid_and_pod_refusals_agree(nrow, ncol):
    for build in ("grid_topology", "pod_topology"):
        texts = []
        for r in (jrouting, trouting):
            with pytest.raises(ValueError) as e:
                getattr(r, build)(nrow, ncol)
            texts.append(str(e.value))
        assert texts[0] == texts[1]


def test_topology_from_routing_is_the_jax_spec():
    for build in (lambda r: r.grid_topology(2, 4),
                  lambda r: r.pod_topology(3, 2)):
        got = tcm.topology_from_routing(build(trouting))
        want = jcm.topology_from_routing(build(jrouting))
        assert (got.n, got.inner, got.outer) == (want.n, want.inner,
                                                 want.outer)


def test_mesh_from_topology_keeps_it_and_names_each_rank_program():
    """``mesh_from_topology`` keeps the topology on the communicator (a
    one-device file here: the CPU has one process), and
    ``program_of_rank`` answers as the JAX communicator does on every
    rank of a 2x4 torus."""
    one = file_topology(PACKAGES["torch"], "one_wire")
    one = dataclasses.replace(one, mapping=tprogram.ProgramMapping(
        programs=one.mapping.programs,
        device_to_program={one.devices[0]: one.mapping.programs[0]}),
        connections={})
    comm = st.mesh_from_topology(one, device="cpu")
    assert comm.topology is one and comm.size == 1
    assert comm.program_of_rank(0) is one.mapping.programs[0]
    assert st.make_communicator(device="cpu").program_of_rank(0) is None

    import smi_tpu as smi

    jtopo = jrouting.grid_topology(2, 4)
    jcomm = dataclasses.replace(smi.make_communicator(1), topology=jtopo)
    ttopo = trouting.grid_topology(2, 4)
    tcomm = dataclasses.replace(
        st.LocalWorld(8, device="cpu").comms[0], topology=ttopo)
    for r in range(8):
        jp, tp = jcomm.program_of_rank(r), tcomm.program_of_rank(r)
        assert [(type(o).__name__, o.port) for o in tp.operations] == \
            [(type(o).__name__, o.port) for o in jp.operations]
