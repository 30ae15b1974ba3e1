"""The port's P2P channels against the JAX package's, both tiers.

One suite of channel moves (dtypes, multi-hop receivers, buffer sizes,
the eager protocol, streamed consumers and reductions, ring shifts, MPMD
``select``) runs once through ``smi_tpu`` on the 8-device fake mesh and
once through the port on an 8-rank CPU ``LocalWorld``, on the same
payloads, per backend (the JAX ring tier in Pallas TPU interpret mode).
Moves are pure routing, so every result is compared exactly; a streamed
f32 sum folds chunk by chunk in the same order in both packages, and is
held at ``rtol=1e-6`` only because ``jnp.sum`` and ``torch.sum`` may add
one chunk's elements in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import smi_tpu as smi
import smi_tpu_torch as st
from smi_tpu.ops.types import dtype_to_jnp

N = 8
BACKENDS = ["xla", "ring"]
COUNT = 400


def _payload(n, dtype):
    # mod-ranged pattern so int8 does not overflow
    return (np.arange(n) % 100).astype(np.dtype(dtype_to_jnp(dtype)))


#: name -> (kind, channel keywords, dtype); every channel carries COUNT
#: elements of ``_payload`` scaled by the sender's rank + 1
SUITE = {
    "transfer 0->1 float": ("transfer", dict(src=0, dst=1), "float"),
    "transfer 0->4 int": ("transfer", dict(src=0, dst=4), "int"),
    "transfer 2->7 double": ("transfer", dict(src=2, dst=7), "double"),
    "transfer 5->3 char": ("transfer", dict(src=5, dst=3), "char"),
    "transfer 7->0 short": ("transfer", dict(src=7, dst=0), "short"),
    "stream 1->4 buffer 7": ("stream", dict(src=1, dst=4, buffer_size=7),
                             "float"),
    "stream 0->1 buffer 33": ("stream", dict(src=0, dst=1, buffer_size=33),
                              "float"),
    "stream 6->2 buffer 2048": ("stream", dict(src=6, dst=2,
                                               buffer_size=2048), "int"),
    "stream eager 3->5": ("stream", dict(src=3, dst=5, buffer_size=7,
                                         rendezvous=False), "float"),
    "stream reads 3": ("stream", dict(src=0, dst=7, buffer_size=7,
                                      consecutive_reads=3), "float"),
    "sum consumer 1->4": ("consume", dict(src=1, dst=4, buffer_size=7),
                          "float"),
    "sum consumer eager": ("consume", dict(src=4, dst=1, buffer_size=7,
                                           rendezvous=False), "int"),
    "stream_reduce add": ("reduce:add", dict(src=0, dst=2, buffer_size=7),
                          "float"),
    "stream_reduce max": ("reduce:max", dict(src=0, dst=2, buffer_size=7),
                          "float"),
    "stream_reduce min int": ("reduce:min", dict(src=3, dst=6,
                                                 buffer_size=7), "int"),
}
F32_SUMS = {"sum consumer 1->4", "stream_reduce add"}
#: the cases the JAX ring tier runs too (every hop of every case is an
#: interpreted kernel there, so the fake mesh runs a subset; the port's
#: ring tier runs them all and is held to its xla tier besides)
JAX_RING = ("transfer 0->1 float", "transfer 5->3 char",
            "transfer 7->0 short", "stream 0->1 buffer 33",
            "sum consumer 1->4")


def _names(backend, package):
    return JAX_RING if (backend, package) == ("ring", "jax") else tuple(SUITE)


def _suite_fn(names, open_channel, scale, zeros, sum_of, kernel_dtype):
    """The named cases for either package: ``open_channel(ctx, **kw)``,
    ``scale(x, rank)`` the sender's payload, ``zeros(dtype)`` a zero
    carry, ``sum_of(chunk)`` a chunk's sum."""
    def fn(ctx, *payloads):
        data = dict(zip(("float", "int", "double", "char", "short"),
                        payloads))
        outs = []
        for port, name in enumerate(names):
            kind, kw, dtype = SUITE[name]
            kw = dict(kw)
            extra = {k: kw.pop(k) for k in ("rendezvous",
                                            "consecutive_reads")
                     if k in kw}
            ch = open_channel(ctx, port=port, count=COUNT, dtype=dtype,
                              extra=extra, **kw)
            x = scale(data[dtype], ctx.rank())
            if kind == "transfer":
                outs.append(ctx.transfer(ch, x))
            elif kind == "stream":
                outs.append(ctx.stream(ch, x)[0])
            elif kind == "consume":
                _, total = ctx.stream(
                    ch, x, consumer=lambda c, chunk: c + sum_of(chunk),
                    init_carry=zeros(kernel_dtype(dtype)))
                outs.append(total[None])
            else:
                _, total = ctx.stream_reduce(ch, x, op=kind.split(":")[1])
                outs.append(total[None])
        return tuple(outs)
    return fn


def _payloads():
    return [_payload(COUNT, d)
            for d in ("float", "int", "double", "char", "short")]


def _jax_suite(comm8, backend):
    def open_channel(ctx, extra, **kw):
        return smi.P2PChannel(comm=ctx.comm, **kw, **extra)

    names = _names(backend, "jax")
    fn = _suite_fn(
        names, open_channel,
        lambda x, rank: x * (rank.astype(x.dtype) + 1),
        lambda dtype: jnp.zeros((), dtype),
        lambda chunk: jnp.sum(chunk, dtype=chunk.dtype), dtype_to_jnp)
    app = smi.smi_kernel(comm8, in_specs=P(), out_specs=P("smi"),
                         backend=backend)(fn)
    outs = app(*[jnp.asarray(p) for p in _payloads()])
    return {name: np.asarray(o).reshape(N, -1)
            for name, o in zip(names, outs)}


def _port_suite(backend):
    def open_channel(ctx, extra, **kw):
        return st.P2PChannel(comm=ctx.comm, **kw, **extra)

    fn = _suite_fn(
        tuple(SUITE), open_channel, lambda x, rank: x * (rank + 1),
        lambda dtype: torch.zeros((), dtype=dtype),
        lambda chunk: chunk.sum(dtype=chunk.dtype), st.dtype_to_torch)
    world = st.LocalWorld(N, device="cpu")
    app = st.smi_kernel(world, in_specs=None, out_specs="smi",
                        backend=backend)(fn)
    outs = app(*_payloads())
    return {name: o.numpy().reshape(N, -1) for name, o in zip(SUITE, outs)}


@pytest.fixture(scope="module")
def suites(comm8):
    return {b: (_port_suite(b), _jax_suite(comm8, b)) for b in BACKENDS}


@pytest.mark.parametrize("backend,name", [
    (b, name) for b in BACKENDS for name in _names(b, "jax")
])
def test_channel_matches_the_jax_package(suites, backend, name):
    got, want = (s[name] for s in suites[backend])
    assert got.shape == want.shape and got.dtype == want.dtype
    if name in F32_SUMS:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_messages_arrive_at_dst_and_nowhere_else(suites, backend):
    got = suites[backend][0]
    for name, (kind, kw, dtype) in SUITE.items():
        sent = _payload(COUNT, dtype) * (kw["src"] + 1)
        if kind in ("transfer", "stream"):
            np.testing.assert_array_equal(got[name][kw["dst"]], sent)
            assert not got[name][np.arange(N) != kw["dst"]].any(), name
        elif kind == "consume":
            np.testing.assert_allclose(got[name][kw["dst"], 0],
                                       sent.astype(np.float64).sum(),
                                       rtol=1e-6)
            assert not got[name][np.arange(N) != kw["dst"]].any(), name
    np.testing.assert_allclose(got["stream_reduce add"][2, 0],
                               _payload(COUNT, "float").sum(), rtol=1e-6)
    assert got["stream_reduce max"][2, 0] == 99
    assert got["stream_reduce min int"][6, 0] == 0


def test_ring_tier_equals_xla_tier(suites):
    for name in SUITE:
        np.testing.assert_array_equal(suites["ring"][0][name],
                                      suites["xla"][0][name])


@pytest.mark.parametrize("backend", BACKENDS)
def test_ring_shift_and_mpmd_select_match(comm8, backend):
    x = np.random.default_rng(5).normal(size=(4, 3)).astype(np.float32)

    def jax_fn(ctx, v):
        mine = v + ctx.rank().astype(v.dtype)
        picked = ctx.select([lambda a: a * 3.0,
                             lambda a: jnp.zeros_like(a)], mine)
        return (smi.parallel.channels.ring_shift(
                    mine, ctx.comm, offset=1, backend=backend)[None],
                smi.parallel.channels.ring_shift(
                    mine, ctx.comm, offset=-3, backend=backend)[None],
                picked[None])

    def port_fn(ctx, v):
        mine = v + ctx.rank()
        picked = ctx.select([lambda a: a * 3.0,
                             lambda a: torch.zeros_like(a)], mine)
        return (st.ring_shift(mine, ctx.comm, offset=1,
                              backend=backend)[None],
                st.ring_shift(mine, ctx.comm, offset=-3,
                              backend=backend)[None],
                picked[None])

    want = smi.smi_kernel(comm8, in_specs=P(), out_specs=P("smi"))(jax_fn)(
        jnp.asarray(x))
    got = st.smi_kernel(st.LocalWorld(N, device="cpu"), in_specs=None,
                        out_specs="smi")(port_fn)(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy()[1], x + 0)   # from rank 0
    np.testing.assert_array_equal(got[1].numpy()[0], x + 3)   # from rank 3
    np.testing.assert_array_equal(got[2].numpy()[0], 3 * x)
    assert not got[2].numpy()[1:].any()


def test_program_knobs_reach_the_channel(comm8):
    """``open_channel`` takes rendezvous, burst width and buffer size from
    the program, in both packages alike."""
    def program(m):
        return m.Program([m.Push(0, "float", 64), m.Pop(0, "float", 64)],
                         p2p_rendezvous=False, consecutive_reads=3)

    jch = smi.SmiContext(comm8, program=program(smi)).open_channel(
        port=0, src=0, dst=1, count=COUNT)
    world = st.LocalWorld(N, device="cpu")
    pch = st.SmiContext(world.comms[0], program=program(st)).open_channel(
        port=0, src=0, dst=1, count=COUNT)
    for name in ("rendezvous", "consecutive_reads", "buffer_size",
                 "chunk_elements", "port", "count"):
        assert getattr(pch, name) == getattr(jch, name), name
    assert pch.dtype.value == jch.dtype.value == "float"
    assert pch.rendezvous is False and pch.buffer_size == 64


# ---- schedules and descriptors, no device ------------------------------


@pytest.mark.parametrize("count,buffer_size,reads,dtype", [
    (400, 7, 1, "float"), (400, 7, 4, "float"), (400, 7, 8, "float"),
    (1000, 33, 2, "double"), (10, 2048, 8, "int"), (1, None, 8, "char"),
    (4096, 1, 3, "short"), (399, 57, 5, "float"),
])
def test_burst_schedule_and_chunk_elements_match(comm8, count, buffer_size,
                                                 reads, dtype):
    kw = dict(port=0, src=0, dst=1, count=count, dtype=dtype,
              buffer_size=buffer_size, consecutive_reads=reads)
    jch = smi.P2PChannel(comm=comm8, **kw)
    pch = st.P2PChannel(comm=st.LocalWorld(N, device="cpu").comms[0], **kw)
    assert pch.burst_schedule() == jch.burst_schedule()
    assert pch.chunk_elements == jch.chunk_elements
    assert sum(pch.burst_schedule()) == count


def test_burst_schedule_reference_values():
    comm = st.LocalWorld(N, device="cpu").comms[0]
    base = dict(comm=comm, port=0, src=0, dst=1, count=400, dtype="float",
                buffer_size=7)  # chunk = 8 packets = 56 elements
    assert st.P2PChannel(consecutive_reads=1, **base).burst_schedule() \
        == [56] * 7 + [8]
    assert st.P2PChannel(consecutive_reads=4, **base).burst_schedule() \
        == [224, 56, 56, 56, 8]


@pytest.mark.parametrize("src,dst", [(0, 1), (0, 4), (0, 5), (2, 7), (7, 0),
                                     (5, 3), (6, 2)])
def test_hops_take_the_shorter_way_round(comm8, src, dst):
    kw = dict(port=0, src=src, dst=dst, count=4)
    pch = st.P2PChannel(comm=st.LocalWorld(N, device="cpu").comms[0], **kw)
    assert pch._hops() == smi.P2PChannel(comm=comm8, **kw)._hops()


@pytest.mark.parametrize("port", [0, 1, 3, 4, 9])
def test_ring_stream_slot_of_a_port(comm8, port):
    kw = dict(port=port, src=0, dst=1, count=4)
    pch = st.P2PChannel(comm=st.LocalWorld(N, device="cpu").comms[0], **kw)
    assert pch._ring_stream() == smi.P2PChannel(
        comm=comm8, **kw)._ring_stream() == port % st.RING_STREAMS


@pytest.mark.parametrize("kw,match", [
    (dict(src=1, dst=1), "src and dst must differ"),
    (dict(src=0, dst=8), "dst=8 out of range"),
    (dict(src=-1, dst=2), "src=-1 out of range"),
    (dict(src=0, dst=1, count=0), "count must be positive"),
    (dict(src=0, dst=1, consecutive_reads=0), "consecutive_reads"),
    (dict(src=0, dst=1, dtype="complex"), "unknown SMI dtype"),
])
def test_channel_descriptor_errors(comm8, kw, match):
    base = dict(port=0, count=4)
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        st.P2PChannel(comm=st.LocalWorld(N, device="cpu").comms[0], **base)
    with pytest.raises(ValueError, match=match):
        smi.P2PChannel(comm=comm8, **base)


def test_channel_call_errors():
    world = st.LocalWorld(2, device="cpu")

    def run(fn):
        return world.run(lambda c: fn(st.P2PChannel(
            comm=c, port=0, src=0, dst=1, count=8)))

    with pytest.raises(ValueError, match="message length 5"):
        run(lambda ch: ch.transfer(torch.zeros(5)))
    with pytest.raises(ValueError, match="message length 9"):
        run(lambda ch: ch.stream(torch.zeros(9)))
    with pytest.raises(ValueError, match="unknown backend"):
        run(lambda ch: ch.transfer(torch.zeros(8), backend="nccl"))
    with pytest.raises(ValueError, match="lanes must be"):
        run(lambda ch: ch.stream_reduce(torch.zeros(8), lanes=0))
    with pytest.raises(st.WatchdogTimeout, match="port-0 channel"):
        run(lambda ch: ch.transfer(torch.zeros(8),
                                   deadline=st.Deadline(0.0)))
    with pytest.raises(st.WatchdogTimeout, match="stream on port-0"):
        run(lambda ch: ch.stream(torch.zeros(8), backend="ring",
                                 deadline=st.Deadline(0.0)))
    # a transfer casts to the channel's dtype, as the JAX package does
    out = run(lambda ch: ch.transfer(np.arange(8)))
    assert out[1].dtype == torch.float32
    assert torch.equal(out[1], torch.arange(8.0))


def test_stream_lanes_change_only_the_association():
    world = st.LocalWorld(2, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(11).normal(size=600).astype(np.float32))

    def total(lanes):
        return world.run(lambda c: st.P2PChannel(
            comm=c, port=0, src=0, dst=1, count=600,
            buffer_size=7).stream_reduce(x, lanes=lanes)[1])[1]

    one, four = total(1), total(None)
    assert torch.allclose(one, four, rtol=1e-5)
    assert torch.allclose(four, x.sum(), rtol=1e-5)


# ---- stream_concurrent --------------------------------------------------


#: count, buffer size, consecutive reads, (src, dst) of each channel: a
#: burst tail and an element tail; one burst; channels that hop apart
CONCURRENT = [
    (400, 7, 3, ((0, 1), (0, 1))),
    (120, 33, 8, ((2, 5), (6, 1))),
    (250, 7, 2, ((3, 4), (5, 4), (7, 1))),
]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("count,buffer_size,reads,pairs", CONCURRENT)
def test_stream_concurrent_matches_the_jax_package(comm8, backend, count,
                                                   buffer_size, reads, pairs):
    from smi_tpu.parallel.channels import stream_concurrent as jax_concurrent

    # integer-valued: the scaling is exact in either package
    x = np.random.default_rng(count).integers(-50, 50, count).astype(
        np.float32)

    def body(make_channel, concurrent, scale):
        def fn(ctx, v):
            channels = [make_channel(comm=ctx.comm, port=p, src=s, dst=d,
                                     count=count, buffer_size=buffer_size,
                                     consecutive_reads=reads)
                        for p, (s, d) in enumerate(pairs)]
            datas = [scale(v, ctx, p) for p in range(len(pairs))]
            return tuple(o[None] for o in concurrent(channels, datas,
                                                     backend=backend))
        return fn

    want = smi.smi_kernel(comm8, in_specs=P(), out_specs=P("smi"))(body(
        smi.P2PChannel, jax_concurrent,
        lambda v, ctx, p: v * (p + 1) + ctx.rank().astype(v.dtype)))(
        jnp.asarray(x))
    got = st.smi_kernel(st.LocalWorld(N, device="cpu"), in_specs=None,
                        out_specs="smi")(body(
        st.P2PChannel, st.stream_concurrent,
        lambda v, ctx, p: v * (p + 1) + ctx.rank()))(x)
    for p, ((src, dst), g, w) in enumerate(zip(pairs, got, want)):
        g = g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g[dst], x * (p + 1) + src)
        assert not g[np.arange(N) != dst].any()


def test_stream_concurrent_errors():
    world = st.LocalWorld(2, device="cpu")

    def run(fn):
        return world.run(lambda c: fn([
            st.P2PChannel(comm=c, port=0, src=0, dst=1, count=8),
            st.P2PChannel(comm=c, port=1, src=0, dst=1, count=9),
            st.P2PChannel(comm=c, port=2, src=0, dst=1, count=8),
        ]))

    with pytest.raises(ValueError, match="one data array per channel"):
        run(lambda chs: st.stream_concurrent(chs[:2], [torch.zeros(8)]))
    with pytest.raises(ValueError, match="equal message/chunk/burst"):
        run(lambda chs: st.stream_concurrent(
            chs[:2], [torch.zeros(8), torch.zeros(9)]))
    with pytest.raises(ValueError, match="message length 5"):
        run(lambda chs: st.stream_concurrent(
            [chs[0], chs[2]], [torch.zeros(8), torch.zeros(5)]))
    assert run(lambda chs: st.stream_concurrent([], [])) == [(), ()]


# ---- verified transfers and tenant ports ---------------------------------


from smi_tpu.parallel.channels import (  # noqa: E402
    FrameCheck as JaxFrameCheck,
    open_tenant_channel as jax_open_tenant_channel,
    tenant_stream_port as jax_tenant_stream_port,
)


def _checksum_payload(dtype, count, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int":
        return rng.integers(-(1 << 31), (1 << 31) - 1, count,
                            dtype=np.int64).astype(np.int32)
    return (rng.normal(size=count) * 1e3).astype(np.float32)


@pytest.mark.parametrize("dtype,torch_dtype", [
    ("float", torch.float32), ("float", torch.bfloat16), ("int", torch.int32),
    ("double", torch.float64), ("short", torch.int16), ("char", torch.int8)])
@pytest.mark.parametrize("count,buffer_size", [
    (1, None), (7, 1), (301, 5), (999, 33), (4097, None), (507 * 3, 2048)])
def test_chunk_checksums_equal_the_jax_package(comm8, dtype, torch_dtype,
                                               count, buffer_size):
    """The same bits in, the same int32 vector out: floats by their raw
    bits, wrapped int32 arithmetic, odd counts padded with zeros."""
    x = _checksum_payload("int" if dtype in ("int", "short", "char")
                          else "float", count, count)
    tx = torch.from_numpy(x).to(torch_dtype)
    if torch_dtype == torch.bfloat16:
        jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
        smi_dtype = "float"  # the channel's dtype; the payload is bf16
    else:
        jx = jnp.asarray(tx.numpy())
        smi_dtype = dtype
    jch = smi.P2PChannel(comm=comm8, port=0, src=0, dst=1, count=count,
                         dtype=smi_dtype, buffer_size=buffer_size)
    world = st.LocalWorld(N, device="cpu")
    pch = st.P2PChannel(world.comms[0], port=0, src=0, dst=1, count=count,
                        dtype=smi_dtype, buffer_size=buffer_size)
    if torch_dtype == torch.bfloat16:
        jch = _bf16_channel(jch)
        pch = _bf16_channel(pch)
    want = np.asarray(jch.chunk_checksums(jx))
    got = pch.chunk_checksums(tx)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _bf16_channel(ch):
    """The channel with its payload dtype overridden to bfloat16 (SMI
    names no bf16 dtype; the checksum reads a bf16 payload's bits)."""
    cls = type(ch)
    attr = "jnp_dtype" if hasattr(ch, "jnp_dtype") else "torch_dtype"
    value = jnp.bfloat16 if attr == "jnp_dtype" else torch.bfloat16
    sub = type(cls.__name__, (cls,), {attr: property(lambda self: value)})
    return sub(**{f: getattr(ch, f) for f in ch.__dataclass_fields__})


def _jax_verified(comm, count, src, dst, backend, buffer_size):
    @smi.smi_kernel(comm, in_specs=P(),
                    out_specs=(P("smi"), (P("smi"), P("smi"), P("smi"))),
                    backend=backend)
    def app(ctx, x):
        ch = smi.P2PChannel(comm=comm, port=0, src=src, dst=dst,
                            count=count, buffer_size=buffer_size)
        received, check = ch.transfer_verified(x, backend=backend)
        return received[None], tuple(c[None] for c in check)

    x = np.arange(count, dtype=np.float32) * 0.5 - 7.0
    out, check = app(x)
    return x, np.asarray(out), tuple(np.asarray(c) for c in check)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["transfer", "stream"])
def test_verified_moves_match_the_jax_package(comm8, backend, kind):
    count, src, dst, buffer_size = 300, 0, 3, 17
    x, want_out, (want_exp, want_got, want_at) = _jax_verified(
        comm8, count, src, dst, backend, buffer_size)
    world = st.LocalWorld(N, device="cpu")

    def on_rank(c):
        ch = st.P2PChannel(c, port=0, src=src, dst=dst, count=count,
                           buffer_size=buffer_size)
        if kind == "transfer":
            received, check = ch.transfer_verified(torch.from_numpy(x),
                                                   backend=backend)
            carry = None
        else:
            received, carry, check = ch.stream_verified(
                torch.from_numpy(x), consumer=lambda c_, chunk: c_ + 1,
                init_carry=0, backend=backend)
        ch.verify_frames(check)
        return received, carry, check

    outs = world.run(on_rank)
    np.testing.assert_array_equal(np.stack([o[0].numpy() for o in outs]),
                                  want_out)
    for r, (_, carry, check) in enumerate(outs):
        np.testing.assert_array_equal(check.expected.numpy(), want_exp[r])
        np.testing.assert_array_equal(check.got.numpy(), want_got[r])
        assert int(check.at_dst) == int(want_at[r]) == int(r == dst)
        if kind == "stream":   # the consumer ran once a chunk
            assert carry == -(-count // _chunk(count, buffer_size))


def _chunk(count, buffer_size):
    world = st.LocalWorld(2, device="cpu")
    ch = st.P2PChannel(world.comms[0], port=0, src=0, dst=1, count=count,
                       buffer_size=buffer_size)
    return min(ch.chunk_elements, count)


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_corrupted_chunk_is_named_as_in_the_jax_package(comm8, backend):
    count, src, dst, buffer_size = 300, 0, 3, 17
    x, out, (exp, got, at) = _jax_verified(comm8, count, src, dst, backend,
                                           buffer_size)
    jch = smi.P2PChannel(comm=comm8, port=0, src=src, dst=dst, count=count,
                         buffer_size=buffer_size)
    world = st.LocalWorld(N, device="cpu")
    received = world.run(lambda c: st.P2PChannel(
        c, port=0, src=src, dst=dst, count=count,
        buffer_size=buffer_size).transfer_verified(
            torch.from_numpy(x), backend=backend))
    pch = st.P2PChannel(world.comms[0], port=0, src=src, dst=dst,
                        count=count, buffer_size=buffer_size)
    data, check = received[dst]
    tampered = data.clone()
    tampered.view(torch.int32)[137] ^= 1 << 9    # one bit, mid-message
    bad = st.FrameCheck(check.expected, pch.chunk_checksums(tampered),
                        check.at_dst)
    with pytest.raises(st.IntegrityError) as err_p:
        pch.verify_frames(bad, context="unit test")
    jtampered = out[dst].copy()
    jtampered.view(np.int32)[137] ^= 1 << 9
    with pytest.raises(smi.IntegrityError) as err_j:
        jch.verify_frames(JaxFrameCheck(
            exp[dst], np.asarray(jch.chunk_checksums(jtampered)), at[dst]),
            context="unit test")
    got_e, want_e = err_p.value, err_j.value
    assert str(got_e) == str(want_e)
    for field in ("rank", "src", "seq", "expected", "got", "kind"):
        assert getattr(got_e, field) == getattr(want_e, field), field
    assert got_e.seq == 137 // _chunk(count, buffer_size)
    assert (got_e.kind, got_e.src, got_e.rank) == ("checksum", src, dst)
    # a rank other than dst holds zeros and never raises
    pch.verify_frames(st.FrameCheck(check.expected, check.got,
                                    torch.tensor(0)))


def test_truncation_and_a_swap_are_caught():
    count, buffer_size = 300, 17
    world = st.LocalWorld(4, device="cpu")
    x = torch.arange(count, dtype=torch.float32)
    outs = world.run(lambda c: st.P2PChannel(
        c, port=0, src=0, dst=2, count=count,
        buffer_size=buffer_size).transfer_verified(x))
    ch = st.P2PChannel(world.comms[0], port=0, src=0, dst=2, count=count,
                       buffer_size=buffer_size)
    data, check = outs[2]
    chunk = _chunk(count, buffer_size)
    truncated = data.clone()
    truncated[chunk:] = 0.0
    with pytest.raises(st.IntegrityError) as err:
        ch.verify_frames(st.FrameCheck(check.expected,
                                       ch.chunk_checksums(truncated),
                                       check.at_dst))
    assert err.value.seq == 1 and "further chunk(s)" in str(err.value)
    swapped = data.clone()
    swapped[:chunk], swapped[chunk:2 * chunk] = (data[chunk:2 * chunk],
                                                 data[:chunk])
    with pytest.raises(st.IntegrityError) as err:
        ch.verify_frames(st.FrameCheck(check.expected,
                                       ch.chunk_checksums(swapped),
                                       check.at_dst))
    assert err.value.seq == 0


@pytest.mark.parametrize("tenant,seq", [
    ("alice", 0), ("alice", 1), ("bob", 0), ("", 7), ("tenant-β", 12345)])
def test_tenant_ports_match_the_jax_package(comm8, tenant, seq):
    port = st.tenant_stream_port(tenant, seq)
    assert port == jax_tenant_stream_port(tenant, seq)
    assert 0 <= port < st.parallel.channels.TENANT_PORT_SPACE
    world = st.LocalWorld(N, device="cpu")
    ch = st.open_tenant_channel(world.comms[0], tenant, seq, src=1, dst=6,
                                count=40, buffer_size=9,
                                consecutive_reads=2)
    jch = jax_open_tenant_channel(comm8, tenant, seq, src=1, dst=6,
                                  count=40, buffer_size=9,
                                  consecutive_reads=2)
    assert (ch.port, ch._ring_stream(), ch.chunk_elements,
            ch.burst_schedule()) == (jch.port, jch._ring_stream(),
                                     jch.chunk_elements,
                                     jch.burst_schedule())


def test_tenant_port_rejects_a_negative_sequence():
    with pytest.raises(ValueError, match="stream_seq"):
        st.tenant_stream_port("alice", -1)
