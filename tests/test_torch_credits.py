"""The port's credit protocol: the reference's schedule fuzz, and parity.

``smi_tpu_torch/parallel/credits.py`` is the port's copy of the JAX
package's protocol specification and schedule fuzzer. The first part
carries over the CPU cases of ``tests/test_credits.py`` against the
port's module: random, adversarial and exhaustive schedules of every
ring protocol and composite, and the mutations the fuzzer must catch.
The second part runs the same seeds through both packages and holds
the port to the JAX package's answers, with the tolerance "equal": every
scheduler choice, every rank's outputs, every state dump, every error
text, the exhaustive schedule counts and the wire-tier wall clocks.
"""

import pytest

from smi_tpu.parallel import credits as J
from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.parallel import errors as E

NS = [2, 3, 5, 8]
SEEDS = range(12)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("seed", SEEDS)
def test_all_gather_random_schedules(n, seed):
    C.simulate_all_gather(n, C.Strategy(seed))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("seed", SEEDS)
def test_all_reduce_random_schedules(n, seed):
    C.simulate_all_reduce(n, C.Strategy(seed))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("seed", SEEDS)
def test_reduce_scatter_random_schedules(n, seed):
    C.simulate_reduce_scatter(n, C.Strategy(seed))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("seed", SEEDS)
def test_neighbour_stream_random_schedules(n, direction, seed):
    C.simulate_neighbour_stream(n, 5, C.Strategy(seed), direction=direction)


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_adversarial_delayed_dmas(n, seed):
    """DMAs land as late as possible — maximal clobber window."""
    C.simulate_all_gather(n, C.DelayDmaStrategy(seed))
    C.simulate_all_reduce(n, C.DelayDmaStrategy(seed))
    C.simulate_reduce_scatter(n, C.DelayDmaStrategy(seed))
    C.simulate_neighbour_stream(n, 6, C.DelayDmaStrategy(seed))


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_adversarial_favoured_rank(n, seed):
    """One rank races ahead while the others lag — the fast-writer /
    slow-consumer scenario the credits exist for."""
    for fav in range(n):
        C.simulate_all_gather(n, C.FavourRankStrategy(fav, seed))
        C.simulate_neighbour_stream(n, 6, C.FavourRankStrategy(fav, seed))


@pytest.mark.parametrize("name,make", [
    ("neighbour_stream_n2c2", lambda: [
        C.neighbour_stream_rank(r, 2, [(r, c) for c in range(2)])
        for r in range(2)
    ]),
    ("neighbour_stream_n2c3", lambda: [
        C.neighbour_stream_rank(r, 2, [(r, c) for c in range(3)])
        for r in range(2)
    ]),
    ("all_gather_n2", lambda: [
        C.all_gather_rank(r, 2, f"c{r}") for r in range(2)
    ]),
    ("all_reduce_n2", lambda: [
        C.all_reduce_rank(r, 2, frozenset([r]), lambda a, b: a | b)
        for r in range(2)
    ]),
    ("reduce_scatter_n2", lambda: [
        C.reduce_scatter_rank(
            r, 2, [frozenset([(r, b)]) for b in range(2)], lambda a, b: a | b
        )
        for r in range(2)
    ]),
])
def test_exhaustive_tiny_configs(name, make):
    """Every scheduler interleaving (communication-boundary granularity)
    of the two-rank protocols passes all invariants."""
    explored = C.explore_all_schedules(make, max_schedules=500_000)
    assert explored > 50  # genuinely many distinct schedules


def test_mutation_no_credits_is_caught_fuzzed():
    """Disabling flow control must produce a detectable violation under
    adversarial schedules — proof the harness can see the race."""
    caught = 0
    for seed in range(60):
        for fav in range(3):
            try:
                C.simulate_neighbour_stream(
                    3, 8, C.FavourRankStrategy(fav, seed), flow_control=False
                )
            except C.ProtocolError:
                caught += 1
    assert caught > 0


def test_mutation_no_credits_all_gather_corrupts():
    """all_gather without credits: an overtaking landing corrupts the
    gathered payload (caught as clobber or as wrong output)."""
    caught = 0
    for seed in range(60):
        for fav in range(3):
            try:
                C.simulate_all_gather(
                    3, C.FavourRankStrategy(fav, seed), flow_control=False
                )
            except C.ProtocolError:
                caught += 1
    assert caught > 0


def test_deadlock_detection_works():
    """A rank waiting on a credit nobody grants must be reported as a
    deadlock, not an infinite loop."""

    def stuck_rank():
        yield ("wait", C.SEM_CREDIT, 0, 1)

    with pytest.raises(C.DeadlockError):
        C.RingSimulator([stuck_rank()], C.Strategy(0)).run()


def test_credit_leak_detection_works():
    """A dangling semaphore count at exit must be reported."""

    def leaky_rank():
        yield ("signal", 0, C.SEM_CREDIT, 0, 1)

    with pytest.raises(C.CreditLeakError):
        C.RingSimulator([leaky_rank()], C.Strategy(0)).run()


# ---------------------------------------------------------------------------
# Concurrent multi-stream composites: the 4-direction ring halo exchange
# and the burst-interleaved stream_concurrent schedule (the configs
# __graft_entry__.dryrun_multichip executes), fuzzed as composite
# per-rank programs with shared scratch and per-stream barrier domains.
# Reference: the strict-depth emulator exercising interacting channels
# (test/mixed/mixed.cl:15-27, multi_collectives.cl:1-12).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4), (3, 3)])
@pytest.mark.parametrize("seed", range(8))
def test_halo_4dir_random_schedules(mesh, seed):
    """Four ring-tier shifts on distinct barrier domains: no clobber, no
    deadlock, no leak, correct per-stream delivery."""
    C.simulate_halo_exchange(*mesh, C.Strategy(seed))


@pytest.mark.parametrize("seed", range(8))
def test_halo_4dir_adversarial(seed):
    C.simulate_halo_exchange(3, 3, C.DelayDmaStrategy(seed), chunks=2)
    for grp in ([0, 1, 2], [2, 4, 6], [3, 4, 5]):
        C.simulate_halo_exchange(
            3, 3, C.FavourSetStrategy(grp, seed), chunks=2
        )


@pytest.mark.parametrize("n", [4, 5, 8])
@pytest.mark.parametrize("seed", range(8))
def test_stream_concurrent_random_schedules(n, seed):
    """Burst-interleaved opposite-direction streams on distinct port
    domains (the stream_concurrent(backend='ring') schedule)."""
    C.simulate_stream_concurrent(n, C.Strategy(seed))


@pytest.mark.parametrize("seed", range(6))
def test_stream_concurrent_adversarial(seed):
    C.simulate_stream_concurrent(5, C.DelayDmaStrategy(seed), bursts=3)
    for lag in range(5):
        grp = [r for r in range(5) if r != lag]
        C.simulate_stream_concurrent(
            5, C.FavourSetStrategy(grp, seed), bursts=3
        )


def test_mutation_halo_shared_cross_axis_domain_clobbers():
    """A row-ring stream SHARING a barrier domain with a column-ring
    stream lets a rank satisfy its barrier with the other ring's
    signals, enter early, and clobber scratch a neighbour is still
    consuming — the exact hazard the per-direction domains
    (halo.py streams 0-3) exist to prevent."""
    caught = 0
    for seed in range(30):
        strats = [C.Strategy(seed), C.DelayDmaStrategy(seed)] + [
            C.FavourRankStrategy(f, seed) for f in range(9)
        ]
        for strat in strats:
            try:
                C.simulate_halo_exchange(
                    3, 3, strat, chunks=3, domains=(0, 1, 1, 3)
                )
            except C.ProtocolError:
                caught += 1
    assert caught > 0


def test_same_ring_shared_domain_is_counting_safe():
    """Negative result, pinned deliberately: instances that all ride
    ONE ring (same neighbour set) may share a barrier domain without
    violating any invariant — the pooled counter still bounds
    inter-rank skew to less than one instance, because entering
    instance k needs 2(k+1) cumulative signals and the two neighbours
    have sent at most their own entry counts. The distinct domains the
    runtime still assigns (channels.py::_ring_stream) are required by
    Mosaic's collective_id contract and by CROSS-ring composites (see
    the cross-axis mutation above), not by this schedule semantics."""
    for seed in range(10):
        C.simulate_stream_concurrent(
            5, C.Strategy(seed), bursts=3, domains=(0, 0)
        )
        for lag in range(5):
            grp = [r for r in range(5) if r != lag]
            C.simulate_stream_concurrent(
                5, C.FavourSetStrategy(grp, seed), bursts=3,
                domains=(0, 0),
            )


def test_mutation_misordered_program_deadlocks_loudly():
    """One rank running its burst's channels in swapped order (the
    divergent-MPMD ordering bug): with DISTINCT domains the misordered
    barrier deadlocks loudly on every schedule."""
    for seed in range(10):
        with pytest.raises(C.DeadlockError):
            C.simulate_stream_concurrent(
                4, C.Strategy(seed), swap_order_rank=1
            )


def test_mutation_misordered_program_shared_domain_clobbers():
    """The same ordering bug with a SHARED domain: the pooled barrier
    lets the misordered rank through, and the failure degrades to the
    silent-on-hardware scratch clobber — which the fuzzer still sees."""
    kinds = set()
    for seed in range(20):
        try:
            C.simulate_stream_concurrent(
                4, C.Strategy(seed), domains=(0, 0), swap_order_rank=1
            )
        except C.ProtocolError as e:
            kinds.add(type(e).__name__)
    assert "ClobberError" in kinds


def test_mutation_wrong_logical_ids_is_caught():
    """The round-3 subset-axis bug, reinstated: identity device ids on
    rings spanning a SUBSET of the mesh axes cross-signal other rings'
    ranks. The fuzzer sees it as clobbers and deadlocks — the same
    failure the interpret tier reported as semaphore corruption."""
    kinds = set()
    caught = 0
    for seed in range(10):
        strats = [C.Strategy(seed), C.DelayDmaStrategy(seed)] + [
            C.FavourRankStrategy(f, seed) for f in range(8)
        ]
        for strat in strats:
            try:
                C.simulate_halo_exchange(2, 4, strat, wrong_ids=True)
            except C.ProtocolError as e:
                kinds.add(type(e).__name__)
                caught += 1
    assert caught > 0
    assert "ClobberError" in kinds


def test_mutation_overgranting_leaks():
    """Dropping the kernels' final-grant suppression (``c + 2 < total``,
    ring.py) leaves surplus credits at exit — the composite harness
    reports the leak on every schedule."""

    def overgrant_rank(me, n, chunks, direction=1):
        dst = (me + direction) % n
        upstream = (me - direction) % n
        yield from C._barrier_steps(me, n)
        for c, chunk in enumerate(chunks):
            slot = c % 2
            if c >= 2:
                yield ("wait", C.SEM_CREDIT, slot, 1)
            yield ("dma", dst, slot, chunk, slot, slot)
            yield ("wait", C.SEM_RECV, slot, 1)
            arrived = yield ("read_slot", slot)
            yield ("output", c, arrived)
            yield ("signal", upstream, C.SEM_CREDIT, slot, 1)
            yield ("wait", C.SEM_SEND, slot, 1)

    for seed in range(10):
        gens = [
            C.chain_programs(
                C.instance_steps(
                    overgrant_rank(g, 4, [(g, k) for k in range(4)]),
                    domain=0, instance=0,
                )
            )
            for g in range(4)
        ]
        with pytest.raises(C.CreditLeakError):
            C.RingSimulator(gens, C.Strategy(seed)).run()


def test_exhaustive_tiny_concurrent_composite():
    """EVERY scheduler interleaving (communication-boundary granularity)
    of the smallest concurrent composite — a 2-rank ring running two
    back-to-back streams on distinct barrier domains with shared
    scratch — passes all invariants. (The 2x2 halo's 4-instance
    composite is beyond exhaustive reach; the random/adversarial
    sweeps above cover it.)"""

    def make():
        progs = []
        for g in range(2):
            subs = []
            for stream, direction in ((0, 1), (1, -1)):
                labels = [((g, stream), k) for k in range(2)]
                subs.append(C.instance_steps(
                    C.neighbour_stream_rank(
                        g, 2, labels, direction=direction
                    ),
                    domain=stream, instance=stream,
                ))
            progs.append(C.chain_programs(*subs))
        return progs

    explored = C.explore_all_schedules(make, max_schedules=400_000)
    assert explored > 1000  # genuinely many distinct schedules


# ---------------------------------------------------------------------------
# Parity with the JAX package: the same seed, the same answers
# ---------------------------------------------------------------------------


def traced(mod, make_strategy):
    """A strategy of ``mod`` that records every (choices, pick) it made:
    the schedule itself, which two packages must share choice for
    choice."""
    base = make_strategy(mod)

    class Traced(type(base)):
        def pick(self, choices):
            chosen = super().pick(choices)
            self.trace.append((tuple(choices), chosen))
            return chosen

    strategy = Traced.__new__(Traced)
    strategy.__dict__.update(base.__dict__)
    strategy.trace = []
    return strategy


def outcome(mod, run, make_strategy):
    """(schedule, result or error type and text, the error's state) of
    one run under a traced strategy of ``mod``."""
    strategy = traced(mod, make_strategy)
    try:
        result, error = run(mod, strategy), None
    except mod.ProtocolError as e:
        result, error = None, (type(e).__name__, str(e),
                               getattr(e, "state", None))
    return strategy.trace, result, error


def assert_same(run, make_strategy):
    port = outcome(C, run, make_strategy)
    want = outcome(J, run, make_strategy)
    assert port[0] == want[0]  # every scheduler choice
    assert port[1:] == want[1:]
    return port


STRATEGIES = {
    "random": lambda m: m.Strategy(5),
    "delay": lambda m: m.DelayDmaStrategy(3),
    "favour1": lambda m: m.FavourRankStrategy(1, 7),
    "set": lambda m: m.FavourSetStrategy({0, 1}, 2),
}

RUNS = {
    "all_gather": lambda m, s: m.simulate_all_gather(5, s),
    "all_reduce": lambda m, s: m.simulate_all_reduce(5, s),
    "reduce_scatter": lambda m, s: m.simulate_reduce_scatter(5, s),
    "neighbour_stream": lambda m, s: m.simulate_neighbour_stream(
        4, 6, s, direction=-1),
    "all_reduce_chunked": lambda m, s: m.simulate_all_reduce_chunked(
        4, 3, s),
    "allreduce_pod": lambda m, s: m.simulate_allreduce_pod(
        2, 3, s, costs=m.default_tier_costs(4096.0, per_slice=3)),
    "all_reduce_quantized": lambda m, s: m.simulate_all_reduce_quantized(
        2, 2, s, verified=True,
        costs=m.default_tier_costs(4096.0, per_slice=2)),
    "all_reduce_sparse": lambda m, s: m.simulate_all_reduce_sparse(
        4, s, verified=True, costs=m.default_tier_costs(1024.0)),
    "all_to_all": lambda m, s: m.simulate_all_to_all(
        4, s, costs=m.default_tier_costs(512.0)),
    "all_to_all_bruck": lambda m, s: m.simulate_all_to_all(
        4, s, variant="bruck", costs=m.default_tier_costs(512.0)),
    "all_to_all_pod": lambda m, s: m.simulate_all_to_all_pod(
        2, 2, s, costs=m.default_tier_costs(512.0, per_slice=2)),
    "halo": lambda m, s: m.simulate_halo_exchange(2, 4, s, chunks=2),
    "stream_concurrent": lambda m, s: m.simulate_stream_concurrent(5, s),
    "tenant_streams": lambda m, s: m.simulate_tenant_streams(
        4, s, [3, 1, 2]),
    "verified_all_gather": lambda m, s: m.simulate_all_gather(
        4, s, verified=True),
    # the mutations: the same schedule must break the same way
    "no_credits_stream": lambda m, s: m.simulate_neighbour_stream(
        3, 8, s, flow_control=False),
    "no_credits_all_gather": lambda m, s: m.simulate_all_gather(
        3, s, flow_control=False),
    "shared_halo_domain": lambda m, s: m.simulate_halo_exchange(
        2, 2, s, domains=(0, 0, 0, 0)),
    "misordered_program": lambda m, s: m.simulate_stream_concurrent(
        4, s, domains=(0, 1), swap_order_rank=1),
    "wrong_ids": lambda m, s: m.simulate_halo_exchange(
        2, 4, s, wrong_ids=True),
}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("run", sorted(RUNS))
def test_schedules_results_and_errors_match_jax(run, strategy):
    assert_same(RUNS[run], STRATEGIES[strategy])


def test_the_mutations_break_in_both_packages_alike():
    """Over the mutation tests' own seeds the port meets the same error
    at the same choice, so the parity above covers failing runs too."""
    broken = 0
    for seed in range(20):
        for fav in range(3):
            _, _, error = assert_same(
                RUNS["no_credits_stream"],
                lambda m: m.FavourRankStrategy(fav, seed))
            broken += error is not None
    assert broken > 0


@pytest.mark.parametrize("n", range(2, 9))
@pytest.mark.parametrize("protocol", ["all_gather", "all_reduce",
                                      "reduce_scatter", "neighbour_stream"])
def test_a_deadlocked_simulator_dumps_the_jax_state(protocol, n):
    """A generator that waits forever at rank n-1 deadlocks its
    neighbours: the dump and the error's text are the JAX package's."""
    def gens(m):
        out = {
            "all_gather": lambda r: m.all_gather_rank(r, n, f"c{r}"),
            "all_reduce": lambda r: m.all_reduce_rank(
                r, n, frozenset([r]), lambda a, b: a | b),
            "reduce_scatter": lambda r: m.reduce_scatter_rank(
                r, n, [frozenset([(r, b)]) for b in range(n)],
                lambda a, b: a | b),
            "neighbour_stream": lambda r: m.neighbour_stream_rank(
                r, n, [(r, c) for c in range(3)]),
        }[protocol]
        programs = [out(r) for r in range(n - 1)]

        def stuck():
            yield ("wait", m.SEM_CREDIT, 0, 1)

        return programs + [stuck()]

    def run(m, strategy):
        sim = m.RingSimulator(gens(m), strategy)
        try:
            sim.run()
        finally:
            dumps.setdefault(m, sim.state_dump())

    dumps = {}
    _, _, error = assert_same(run, lambda m: m.Strategy(n))
    assert error[0] == "DeadlockError"
    assert dumps[C] == dumps[J]
    assert C.format_state_dump(dumps[C]) == J.format_state_dump(dumps[J])


@pytest.mark.parametrize("name", [
    "neighbour_stream_n2c2", "neighbour_stream_n2c3", "all_gather_n2",
    "all_reduce_n2", "reduce_scatter_n2",
])
def test_exhaustive_counts_match_jax(name):
    def make(m):
        return {
            "neighbour_stream_n2c2": lambda: [
                m.neighbour_stream_rank(r, 2, [(r, c) for c in range(2)])
                for r in range(2)],
            "neighbour_stream_n2c3": lambda: [
                m.neighbour_stream_rank(r, 2, [(r, c) for c in range(3)])
                for r in range(2)],
            "all_gather_n2": lambda: [
                m.all_gather_rank(r, 2, f"c{r}") for r in range(2)],
            "all_reduce_n2": lambda: [
                m.all_reduce_rank(r, 2, frozenset([r]), lambda a, b: a | b)
                for r in range(2)],
            "reduce_scatter_n2": lambda: [
                m.reduce_scatter_rank(
                    r, 2, [frozenset([(r, b)]) for b in range(2)],
                    lambda a, b: a | b)
                for r in range(2)],
        }[name]

    port = C.explore_all_schedules(make(C), max_schedules=500_000)
    want = J.explore_all_schedules(make(J), max_schedules=500_000)
    assert int(port) == int(want)
    assert port.to_json() == want.to_json()


def test_a_truncated_exploration_reports_the_jax_coverage():
    def make(m):
        return lambda: [m.neighbour_stream_rank(r, 3, [(r, 0), (r, 1)])
                        for r in range(3)]

    with pytest.warns(RuntimeWarning, match="truncated") as caught:
        port = C.explore_all_schedules(make(C), max_schedules=300,
                                       allow_budget=True)
        want = J.explore_all_schedules(make(J), max_schedules=300,
                                       allow_budget=True)
    assert port.to_json() == want.to_json()
    assert port.to_json()["truncated"]
    assert str(caught[0].message) == str(caught[1].message)
    with pytest.raises(C.ProtocolError) as e:
        C.explore_all_schedules(make(C), max_schedules=300)
    with pytest.raises(J.ProtocolError) as w:
        J.explore_all_schedules(make(J), max_schedules=300)
    assert str(e.value) == str(w.value)


@pytest.mark.parametrize("case", [
    ("pod", (2, 4, 1 << 20)), ("pod", (4, 2, 4096.0)),
    ("quantized", (2, 4, 1 << 20, "int8")),
    ("quantized", (2, 2, 65536.0, "bf16")),
    ("alltoall", (2, 4, 65536.0)), ("alltoall", (2, 2, 512.0)),
    ("variants", (8, 512.0)), ("variants", (4, 1 << 20)),
], ids=str)
def test_wallclock_comparisons_match_jax(case):
    name, args = case
    fn = {"pod": "pod_wallclock_comparison",
          "quantized": "quantized_wallclock_comparison",
          "alltoall": "alltoall_wallclock_comparison",
          "variants": "alltoall_variant_wallclocks"}[name]
    assert getattr(C, fn)(*args, seed=3) == getattr(J, fn)(*args, seed=3)


def test_tier_costs_are_the_cost_models_rates():
    """The port prices the wire tiers from its own cost model, which
    keeps the JAX package's rates: the same model, field for field."""
    port = C.default_tier_costs(4096.0, per_slice=4, ici_bytes=64.0)
    want = J.default_tier_costs(4096.0, per_slice=4, ici_bytes=64.0)
    assert C.dataclasses.asdict(port) == J.dataclasses.asdict(want)


def test_registries_and_frames_match_jax():
    assert C.all_protocol_registries() == J.all_protocol_registries()
    assert C.registered_protocols() == J.registered_protocols()
    for args in [(0, 0, True, "x"), (3, 9, False, frozenset({1, 2})),
                 (1, 2, True, ("slice", 1))]:
        assert C.frame_crc(*args) == J.frame_crc(*args)
        assert C.dataclasses.astuple(C.make_frame(*args)) == \
            J.dataclasses.astuple(J.make_frame(*args))


def test_one_set_of_protocol_errors():
    """The simulator raises the classes the verified channels raise."""
    assert C.ProtocolError is E.ProtocolError
    assert C.IntegrityError is E.IntegrityError
    for name in ("ClobberError", "DeadlockError", "CreditLeakError"):
        assert issubclass(getattr(C, name), E.ProtocolError)
        assert [c.__name__ for c in getattr(C, name).__mro__] == [
            c.__name__ for c in getattr(J, name).__mro__]
