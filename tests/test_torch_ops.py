"""The port's own copy of the operation/program model gives the same
outputs as the JAX package's: the cases of ``tests/test_types.py``,
``tests/test_program.py`` and ``tests/test_parse.py``, each run through
both packages' modules and compared (values as JSON-able data, errors by
their class name)."""

import json
import types

import pytest
import torch

import smi_tpu.ops.operations as jax_operations
import smi_tpu.ops.program as jax_program
import smi_tpu.ops.serialization as jax_serialization
import smi_tpu.ops.types as jax_types
import smi_tpu_torch.ops.operations as port_operations
import smi_tpu_torch.ops.program as port_program
import smi_tpu_torch.ops.serialization as port_serialization
import smi_tpu_torch.ops.types as port_types

JAX = types.SimpleNamespace(t=jax_types, o=jax_operations, p=jax_program,
                            s=jax_serialization)
PORT = types.SimpleNamespace(t=port_types, o=port_operations, p=port_program,
                             s=port_serialization)

TOPOLOGY = {
    "fpgas": {
        "fpga-0001:acl0": "rank0",
        "fpga-0001:acl1": "rank1",
        "fpga-0002:acl0": "rank1",
    },
    "connections": {
        "fpga-0001:acl0:ch2": "fpga-0001:acl1:ch3",
        "fpga-0001:acl0:ch1": "fpga-0002:acl0:ch0",
    },
}


def _plain(value):
    """A value of either package as comparable plain data."""
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {str(_plain(k)): _plain(v) for k, v in value.items()}
    if hasattr(value, "value") and hasattr(type(value), "__members__"):
        return value.value
    if hasattr(value, "node") and hasattr(value, "index"):
        return f"{value.node}:{value.index}"
    return value


def _five_ops(m):
    o = m.o
    return m.p.Program([o.Push(0), o.Pop(0), o.Push(1), o.Push(2), o.Pop(2)])


def _topology(m, **kw):
    o = m.o
    progs = {"rank0": m.p.Program([o.Push(0)]),
             "rank1": m.p.Program([o.Pop(0)])}
    return m.s.parse_topology_file(json.dumps(TOPOLOGY),
                                   **(kw or {"programs": progs}))


def _round_trip(m):
    o = m.o
    ops = [o.Push(0, "float", buffer_size=100), o.Pop(1, "double"),
           o.Reduce(2, "int", op=m.t.SmiOp.MAX), o.Broadcast(3, "char")]
    wire = [m.s.serialize_operation(op) for op in ops]
    assert [m.s.parse_operation(w) for w in wire] == ops
    return wire


def _program_round_trip(m):
    o = m.o
    prog = m.p.Program([o.Push(0, "float"), o.Pop(1, "short", buffer_size=64)],
                       consecutive_reads=5, max_ranks=16,
                       p2p_rendezvous=False)
    wire = m.s.serialize_program(prog)
    back = m.s.parse_program(wire)
    assert back.operations == prog.operations
    return [json.loads(wire) if isinstance(wire, str) else wire,
            back.consecutive_reads, back.max_ranks, back.p2p_rendezvous]


def _mapping(m):
    o = m.o
    pa, pb = m.p.Program([o.Push(0)]), m.p.Program([o.Pop(0)])
    d = {m.p.Device("b", 0): pb, m.p.Device("a", 1): pa,
         m.p.Device("a", 0): pa}
    mapping = m.p.ProgramMapping(programs=[pa, pb], device_to_program=d)
    return [[str(x) for x in mapping.devices],
            mapping.rank_of(m.p.Device("b", 0))]


def _bad_connections(m):
    bad = dict(TOPOLOGY)
    bad["connections"] = {"a:0:ch0": "b:0:ch0", "c:0:ch1": "b:0:ch0"}
    return m.s.parse_topology_file(json.dumps(bad), ignore_programs=True)


PROBES = {
    # tests/test_types.py
    "elements_per_packet": lambda m: [
        m.t.elements_per_packet(d)
        for d in ("int", "float", "double", "char", "short")],
    "packet_constants": lambda m: [m.t.PACKET_PAYLOAD_BYTES,
                                   m.t.PACKET_TOTAL_BYTES, m.t.DTYPE_SIZE],
    "buffer_size_rounding": lambda m: [
        m.t.buffer_size_to_packets(n, d)
        for n, d in ((1, "float"), (7, "float"), (57, "float"),
                     (2048, "double"), (8 * 28, "char"))],
    "buffer_size_nonpositive": lambda m: m.t.buffer_size_to_packets(
        0, "float"),
    "dtype_parse": lambda m: [m.t.SmiDtype.parse("float"),
                              m.t.SmiDtype.parse(m.t.SmiDtype.INT)],
    "dtype_parse_unknown": lambda m: m.t.SmiDtype.parse("complex"),
    "reduce_op_parse": lambda m: [m.t.SmiOp.parse(o)
                                  for o in ("add", "max", "min")],
    "message_kinds": lambda m: {k.name: k.value for k in m.t.MessageKind},
    # tests/test_program.py
    "round_robin": lambda m: [m.p.round_robin(list(range(10)), 0, 4),
                              m.p.round_robin(list(range(10)), 3, 4)],
    "duplicate_push_port": lambda m: m.p.Program([m.o.Push(0), m.o.Push(0)]),
    "duplicate_collective_port": lambda m: m.p.Program(
        [m.o.Broadcast(2), m.o.Broadcast(2)]),
    "push_pop_same_port": lambda m: m.p.Program(
        [m.o.Push(0), m.o.Pop(0)]).logical_port_count,
    "push_broadcast_same_port": lambda m: m.p.Program(
        [m.o.Push(0), m.o.Broadcast(0)]),
    "collectives_distinct_ports": lambda m: m.p.Program(
        [m.o.Broadcast(0), m.o.Reduce(1), m.o.Scatter(2),
         m.o.Gather(3)]).logical_port_count,
    "logical_port_count": lambda m: m.p.Program(
        [m.o.Push(0), m.o.Pop(5)]).logical_port_count,
    "allocation_round_robin": lambda m: sorted(
        (list(k), v) for k, v in m.p.allocate_ports(
            [m.o.Push(i) for i in range(6)], num_streams=4
        ).stream_of.items()),
    "allocation_reference_deal": lambda m: [
        _five_ops(m).stream_allocations(s) for s in range(4)],
    "allocation_lookup": lambda m: sorted(
        (list(k), v) for k, v in _five_ops(m).allocation.items()),
    "allocation_eager": lambda m: sorted(
        (list(k), v) for k, v in m.p.Program(
            [m.o.Push(0), m.o.Pop(0)],
            p2p_rendezvous=False).allocation.items()),
    "allocation_order_free": lambda m: (
        m.p.allocate_ports([m.o.Push(3), m.o.Push(1), m.o.Push(2)])
        == m.p.allocate_ports([m.o.Push(1), m.o.Push(2), m.o.Push(3)])),
    "stream_of_collectives": lambda m: [
        m.p.Program([m.o.Broadcast(i) for i in range(6)]).stream_of(
            m.o.Broadcast(i), m.o.OUT_DATA) for i in range(6)],
    "accumulation_lanes": lambda m: [
        m.o.Reduce(0, d).accumulation_lanes
        for d in ("float", "double", "int")],
    "pipeline_depth_packets": lambda m: [
        m.o.pipeline_depth_packets(b, d)
        for b, d in ((None, "float"), (2048, "float"), (16, "double"),
                     (1, "char"))],
    "device_parse": lambda m: [m.p.Device.parse("node-1:3"),
                               m.p.Device.parse("fpga-0001:acl1")],
    "device_parse_no_colon": lambda m: m.p.Device.parse("no-colon"),
    "program_mapping_rank_order": _mapping,
    "empty_program_port_count": lambda m: m.p.Program(
        []).logical_port_count,
    "program_find": lambda m: [
        _five_ops(m).find("push", 2) is not None,
        _five_ops(m).find("pop", 1) is None],
    # tests/test_parse.py
    "operation_round_trip": _round_trip,
    "program_round_trip": _program_round_trip,
    "reduce_defaults_to_add": lambda m: m.s.parse_operation(
        {"type": "reduce", "port": 1, "data_type": "float"}).op,
    "unknown_type": lambda m: m.s.parse_operation(
        {"type": "sendrecv", "port": 0}),
    "topology_devices": lambda m: [str(d) for d in _topology(m).devices],
    "topology_connections": lambda m: sorted(
        ([str(k[0]), k[1]], [str(v[0]), v[1]])
        for k, v in _topology(m).connections.items()),
    "topology_neighbours": lambda m: [
        [ch, str(dev), peer] for ch, dev, peer in
        _topology(m).neighbours(m.p.Device("fpga-0001", 0))],
    "topology_rank_of": lambda m: [
        _topology(m).mapping.rank_of(d) for d in _topology(m).devices],
    "topology_missing_program": lambda m: _topology(m, programs={}),
    "topology_ignore_programs": lambda m: len(
        _topology(m, ignore_programs=True).devices),
    "topology_duplicate_endpoint": _bad_connections,
    "nested_reduce_args": lambda m: m.s.parse_operation(
        {"type": "reduce", "port": 2, "data_type": "float",
         "args": {"op_type": "max"}}).op,
    "missing_data_type": lambda m: m.s.parse_operation(
        {"type": "push", "port": 0}).dtype,
}


def _outcome(probe, modules):
    try:
        return ("value", _plain(probe(modules)))
    except (ValueError, KeyError, TypeError) as exc:
        return ("error", type(exc).__name__)


@pytest.mark.parametrize("name", sorted(PROBES))
def test_both_packages_give_the_same_output(name):
    got, want = _outcome(PROBES[name], PORT), _outcome(PROBES[name], JAX)
    assert got == want
    if name.endswith(("nonpositive", "unknown", "_port", "no_colon",
                      "unknown_type", "missing_program",
                      "duplicate_endpoint")) and "same_port" not in name:
        assert got[0] == "error"


def test_push_broadcast_conflict_is_an_error():
    assert _outcome(PROBES["push_broadcast_same_port"], PORT) == (
        "error", "PortConflict")
    assert issubclass(port_program.PortConflict, ValueError)


@pytest.mark.parametrize("name,want", [
    ("int", torch.int32), ("float", torch.float32),
    ("double", torch.float64), ("char", torch.int8),
    ("short", torch.int16),
])
def test_dtype_to_torch(name, want):
    import jax.numpy as jnp

    assert port_types.dtype_to_torch(name) is want
    assert jnp.dtype(jax_types.dtype_to_jnp(name)).itemsize == want.itemsize
    assert port_types.DTYPE_SIZE[port_types.SmiDtype.parse(name)] \
        == want.itemsize
