"""The port's static protocol verifier: the reference's cases, and parity.

``smi_tpu_torch/analysis/verifier.py`` and ``mutants.py`` are the port's
copies of the JAX package's static verifier (happens-before analysis
over one symbolic replay per rank) and its protocol mutants; both are
pure Python. The first part carries over the verifier cases of
``tests/test_analysis.py`` against the port: the clean matrix, the
differential harness against the port's exhaustive fuzzer, the
exploration-coverage cases and the divergence diagnostics (the CLI
cases need the JAX package's ``__main__`` and stay there). The second
part runs both packages on the same protocols with the tolerance
"equal": ``lint_all`` reports and every mutant's findings byte-equal
as sorted-key JSON.
"""

import json
import re

import pytest

from smi_tpu import analysis as JA
from smi_tpu_torch import analysis as A
from smi_tpu_torch.parallel import credits as C

pytestmark = pytest.mark.lint

def _exhaust(make, budget=500_000):
    """Exhaustively fuzz; return ("clean", count) or (error name, err)."""
    try:
        count = C.explore_all_schedules(make, max_schedules=budget)
        assert not count.truncated, "space unexpectedly beyond budget"
        return ("clean", count)
    except C.ProtocolError as e:
        return (type(e).__name__, e)


def _blocked_ranks(state: dict) -> set:
    return {r for r, entry in state.items()
            if isinstance(r, int) and entry["state"] == "blocked"}


# ---------------------------------------------------------------------------
# 1. Clean matrix
# ---------------------------------------------------------------------------


CLEAN_CASES = [
    (protocol, shape)
    for protocol, shapes in sorted(A.DEFAULT_SHAPES.items())
    for shape in shapes
]


@pytest.mark.parametrize("protocol,shape", CLEAN_CASES,
                         ids=[f"{p}-{sorted(s.items())}"
                              for p, s in CLEAN_CASES])
def test_clean_protocols_verify(protocol, shape):
    report = A.verify_protocol(protocol, **shape)
    assert report.ok, report.describe()
    assert report.checks == A.CHECKS  # all four ran
    assert report.events > 0


def test_larger_instances_stay_polynomial():
    """The whole point over the fuzzer: n=8 is seconds of DFS but
    instant statically."""
    for protocol in ("all_gather", "all_reduce", "reduce_scatter"):
        assert A.verify_protocol(protocol, n=8).ok
    assert A.verify_protocol("allreduce_pod", n=8, slices=2).ok
    assert A.verify_protocol("all_reduce_chunked", n=4, chunks=4).ok


# ---------------------------------------------------------------------------
# 2. Differential harness: static verdict == exhaustive-fuzz verdict
# ---------------------------------------------------------------------------

#: Spaces small enough for the DFS to exhaust (minutes would be a bug).
EXHAUSTIBLE = [
    ("all_gather", {"n": 2}),
    ("all_reduce", {"n": 2}),
    ("reduce_scatter", {"n": 2}),
    ("neighbour_stream", {"n": 2, "chunks": 2}),
    ("neighbour_stream", {"n": 2, "chunks": 3}),
    ("all_reduce_chunked", {"n": 2, "chunks": 2}),
    ("all_to_all", {"n": 2}),
    ("all_to_all_bruck", {"n": 2}),
    ("all_to_all_pod", {"n": 2, "slices": 2}),
]


@pytest.mark.parametrize("protocol,shape", EXHAUSTIBLE,
                         ids=[f"{p}-{sorted(s.items())}"
                              for p, s in EXHAUSTIBLE])
def test_differential_clean(protocol, shape):
    """Static and exhaustive-dynamic agree on every healthy protocol."""
    static = A.verify_generators(
        lambda: A.build_generators(protocol, **shape),
        protocol=protocol, shape=shape,
    )
    verdict, detail = _exhaust(
        lambda: A.build_generators(protocol, **shape)
    )
    assert static.ok and verdict == "clean", (
        f"static={static.describe()} dynamic={verdict}: {detail}"
    )
    assert detail > 1  # the space was genuinely explored


#: (mutant, protocol, shape). The acceptance matrix: each mutant class
#: must fail BOTH tiers with the right diagnostic on every exhaustible
#: space.
MUTANT_CASES = [
    (mutant, protocol, shape)
    for mutant in ("dropped_wait", "reused_slot", "unbalanced_grant",
                   "late_grant")
    for protocol, shape in [
        ("all_gather", {"n": 2}),
        ("all_reduce", {"n": 2}),
        ("reduce_scatter", {"n": 2}),
        ("neighbour_stream", {"n": 2, "chunks": 3}),
        ("all_reduce_chunked", {"n": 2, "chunks": 2}),
    ]
    # late_grant delays the grant past the next wait; neighbour_stream's
    # next wait is its own (immediately satisfied) SEND wait, so the
    # reorder is harmless there — and BOTH tiers must agree it is
    if not (mutant == "late_grant" and protocol == "neighbour_stream")
]


@pytest.mark.parametrize("mutant,protocol,shape", MUTANT_CASES,
                         ids=[f"{m}-{p}-{sorted(s.items())}"
                              for m, p, s in MUTANT_CASES])
def test_differential_mutants(mutant, protocol, shape):
    """Each mutant fails both tiers with matching named events."""
    static = A.verify_generators(
        lambda: A.mutant_generators(protocol, mutant=mutant, **shape),
        protocol=protocol, shape=shape,
    )
    verdict, detail = _exhaust(
        lambda: A.mutant_generators(protocol, mutant=mutant, **shape)
    )
    assert not static.ok, f"{mutant} not caught statically"
    kinds = {f.check for f in static.findings}

    if mutant == "dropped_wait":
        assert "deadlock" in kinds and "credit-conservation" in kinds
        assert verdict == "DeadlockError"
        deadlock = next(f for f in static.findings
                        if f.check == "deadlock")
        # the static chain and the dynamic dump name the same blocked set
        static_ranks = {e.rank for e in deadlock.events}
        assert static_ranks == _blocked_ranks(detail.state)
        # the starved wait is named first, as a wait primitive
        assert deadlock.events[0].primitive[0] == "wait"
    elif mutant == "late_grant":
        assert "deadlock" in kinds
        assert verdict == "DeadlockError"
        deadlock = next(f for f in static.findings
                        if f.check == "deadlock")
        assert "cycle" in deadlock.message
        assert {e.rank for e in deadlock.events} <= _blocked_ranks(
            detail.state
        )
    elif mutant == "reused_slot":
        assert "slot-race" in kinds
        assert verdict in ("ClobberError", "ProtocolError")
        races = {(f.rank, f.slot) for f in static.findings
                 if f.check == "slot-race"}
        if verdict == "ClobberError":
            m = re.search(r"rank (\d+) slot (\d+)", str(detail))
            assert m, str(detail)
            assert (int(m.group(1)), int(m.group(2))) in races
    elif mutant == "unbalanced_grant":
        assert "credit-conservation" in kinds
        assert verdict in ("CreditLeakError", "ClobberError")
        leak = next(f for f in static.findings
                    if f.check == "credit-conservation")
        assert leak.got > leak.expected  # a surplus, not a deficit
        if verdict == "CreditLeakError":
            # the dynamic leak names the exact same semaphore domain
            assert repr(leak.domain) in str(detail)


POD_SHAPE = {"n": 4, "slices": 2}


def test_pod_mutants_beyond_exhaustive_reach():
    """The pod's space cannot be exhausted, but the deterministic
    mutant classes deadlock on the FIRST DFS schedule and the racy one
    falls to an adversarial sweep — while the verifier convicts all
    three statically in milliseconds."""
    for mutant, expected in (("dropped_wait", "deadlock"),
                            ("late_grant", "deadlock"),
                            ("unbalanced_grant", "credit-conservation")):
        static = A.verify_generators(
            lambda: A.mutant_generators("allreduce_pod", mutant=mutant,
                                        **POD_SHAPE),
            protocol="allreduce_pod", shape=POD_SHAPE,
        )
        assert expected in {f.check for f in static.findings}, mutant
    # dynamic cross-check: every schedule of the deadlock mutants hangs
    for mutant in ("dropped_wait", "late_grant"):
        with pytest.raises(C.DeadlockError):
            C.RingSimulator(
                A.mutant_generators("allreduce_pod", mutant=mutant,
                                    **POD_SHAPE),
                C.Strategy(0),
            ).run()
    # the race needs an adversarial interleaving — sweep until caught
    static = A.verify_generators(
        lambda: A.mutant_generators("allreduce_pod",
                                    mutant="reused_slot", **POD_SHAPE),
        protocol="allreduce_pod", shape=POD_SHAPE,
    )
    races = {(f.rank, f.slot) for f in static.findings
             if f.check == "slot-race"}
    assert races
    caught = None
    for seed in range(40):
        strategies = [C.Strategy(seed), C.DelayDmaStrategy(seed)] + [
            C.FavourRankStrategy(f, seed) for f in range(4)
        ]
        for strategy in strategies:
            try:
                C.RingSimulator(
                    A.mutant_generators("allreduce_pod",
                                        mutant="reused_slot",
                                        **POD_SHAPE),
                    strategy,
                ).run()
            except C.ProtocolError as e:
                caught = e
                break
        if caught:
            break
    assert caught is not None, "fuzzer never saw the aliased-slot race"
    m = re.search(r"rank (\d+) slot (\d+)", str(caught))
    if m:  # a clobber names the slot; wrong delivery does not
        assert (int(m.group(1)), int(m.group(2))) in races


def test_wire_lane_differential():
    """A protocol that consumes frames out of send order — properly
    semaphored, hence race- and deadlock-free — must be convicted by
    the wire-lane check exactly where the verified-transport framing
    raises IntegrityError(kind='sequence') dynamically."""

    def make():
        def sender():
            yield ("dma", 1, 0, "a", 0, 0)
            yield ("dma", 1, 1, "b", 1, 1)
            yield ("wait", C.SEM_SEND, 0, 1)
            yield ("wait", C.SEM_SEND, 1, 1)

        def receiver():
            yield ("wait", C.SEM_RECV, 1, 1)
            arrived = yield ("read_slot", 1)
            yield ("output", 1, arrived)
            yield ("wait", C.SEM_RECV, 0, 1)
            arrived = yield ("read_slot", 0)
            yield ("output", 0, arrived)

        return [sender(), receiver()]

    static = A.verify_generators(make, protocol="swapped-consumption")
    lanes = [f for f in static.findings if f.check == "wire-lane"]
    assert lanes, static.describe()
    assert lanes[0].expected == 0 and lanes[0].got == 1
    # no other check fires: the defect is PURELY a framing-order one
    assert {f.check for f in static.findings} == {"wire-lane"}

    # dynamic: the same program under verified-transport framing
    with pytest.raises(C.IntegrityError) as err:
        C.RingSimulator(
            [C.verified_steps(g, r) for r, g in enumerate(make())],
            C.Strategy(0),
        ).run()
    assert err.value.kind == "sequence"
    assert err.value.expected == lanes[0].expected
    assert err.value.got == lanes[0].got


def test_nondeterministic_sequences_are_rejected():
    """The one-yield-per-primitive assumption is checked, not trusted:
    a factory whose ranks trace differently across two replays is an
    AnalysisError, never a silent wrong verdict."""
    calls = {"k": 0}

    def make():
        calls["k"] += 1
        extra = calls["k"] % 2 == 0

        def rank():
            yield ("output", 0, "x")
            if extra:
                yield ("output", 1, "y")

        return [rank()]

    with pytest.raises(A.AnalysisError, match="diverges at step"):
        A.verify_generators(make)


def test_payload_dependent_control_flow_is_rejected():
    """A generator that BRANCHES on a read payload is not
    schedule-independent even if both replays happen to agree — the
    symbolic token raises the moment it is observed (compared,
    truth-tested, or hashed), never letting the double-trace
    mis-verify such a protocol."""

    def branching():
        def rank():
            arrived = yield ("read_slot", 0)
            if arrived == "real-payload":
                yield ("wait", 1, 0, 1)
            yield ("output", 0, arrived)

        return [rank()]

    with pytest.raises(A.AnalysisError, match="payload"):
        A.verify_generators(branching)

    def truth_testing():
        def rank():
            arrived = yield ("read_slot", 0)
            if arrived:
                yield ("output", 0, arrived)

        return [rank()]

    with pytest.raises(A.AnalysisError, match="payload"):
        A.verify_generators(truth_testing)

    # union-combining stays legal — it is how every registered
    # reduction folds arrivals without observing them
    def combining():
        def rank():
            yield ("write_slot", 0, frozenset([0]))
            arrived = yield ("read_slot", 0)
            yield ("output", 0, arrived | frozenset([1]))

        return [rank()]

    assert A.verify_generators(combining).ok


def test_finding_coordinates_are_exact():
    """Diagnostics name the exact (rank, step, primitive) coordinates:
    re-tracing the mutant's sequences must find the named primitive at
    the named step."""
    shape = {"n": 2}
    static = A.verify_generators(
        lambda: A.mutant_generators("all_reduce", mutant="dropped_wait",
                                    **shape),
        protocol="all_reduce", shape=shape,
    )
    seqs = [A.symbolic_events(g) for g in A.mutant_generators(
        "all_reduce", mutant="dropped_wait", **shape)]
    for finding in static.findings:
        for event in finding.events:
            action = seqs[event.rank][event.step]
            if event.primitive[0] == "dma-land":
                assert action[0] == "dma"
            else:
                assert event.primitive[0] == action[0]


# ---------------------------------------------------------------------------
# 3. explore_all_schedules coverage (the "no silent caps" satellite)
# ---------------------------------------------------------------------------


def test_truncated_exploration_warns_and_reports_coverage():
    def make():
        return A.build_generators("all_reduce", n=3)

    with pytest.warns(RuntimeWarning, match="truncated the space"):
        count = C.explore_all_schedules(make, max_schedules=10,
                                        allow_budget=True)
    assert count == 10  # still the plain int it always was
    assert count.explored == 10
    assert count.truncated
    assert count.frontier > 0
    assert count.estimated_total >= count.explored + count.frontier


def test_complete_exploration_reports_full_coverage():
    import warnings

    def make():
        return A.build_generators("all_reduce", n=2)

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a complete run must NOT warn
        count = C.explore_all_schedules(make, max_schedules=500_000,
                                        allow_budget=True)
    assert count > 1
    assert not count.truncated
    assert count.frontier == 0
    assert count.estimated_total == count.explored == int(count)


def test_without_allow_budget_still_raises():
    def make():
        return A.build_generators("all_reduce", n=3)

    with pytest.raises(C.ProtocolError, match="budget"):
        C.explore_all_schedules(make, max_schedules=10)




def test_verifier_divergence_names_rank_step_primitive():
    """PR-10 satellite: a nondeterministic factory is rejected with
    the first diverging (rank, step, primitive) pair named — not a
    bare 'sequences differ'."""
    calls = {"k": 0}

    def make():
        calls["k"] += 1
        extra = calls["k"] % 2 == 0

        def rank0():
            yield ("output", 0, "x")

        def rank1():
            yield ("output", 0, "x")
            if extra:
                yield ("write_slot", 3, "y")

        return [rank0(), rank1()]

    with pytest.raises(A.AnalysisError) as err:
        A.verify_generators(make, protocol="diverging")
    msg = str(err.value)
    assert "rank 1" in msg
    assert "step 1" in msg
    assert "write_slot" in msg
    assert "end of sequence" in msg
    assert "diverging" in msg


def test_verifier_divergence_names_rank_count_mismatch():
    calls = {"k": 0}

    def make():
        calls["k"] += 1

        def rank():
            yield ("output", 0, "x")

        return [rank() for _ in range(1 + calls["k"] % 2)]

    with pytest.raises(A.AnalysisError, match="rank sequences"):
        A.verify_generators(make)



# ---------------------------------------------------------------------------
# Parity with the JAX package: the same protocols, the same reports
# ---------------------------------------------------------------------------


def _canon(payload) -> str:
    return json.dumps(payload, sort_keys=True, default=str)


def test_lint_all_json_equals_the_jax_package_s():
    """Every registered protocol over ``DEFAULT_SHAPES``: the port's
    ``lint --json`` payload and text byte-equal to the JAX package's."""
    assert A.DEFAULT_SHAPES == JA.DEFAULT_SHAPES
    assert A.CHECKS == JA.CHECKS and A.MAX_LINT_N == JA.MAX_LINT_N
    ours, theirs = A.lint_all(), JA.lint_all()
    assert _canon(A.reports_to_json(ours)) == \
        _canon(JA.reports_to_json(theirs))
    assert A.render_reports(ours) == JA.render_reports(theirs)


MUTANT_GRID = [
    (mutant, protocol, shape)
    for mutant in A.MUTANTS
    for protocol, shapes in sorted(A.DEFAULT_SHAPES.items())
    for shape in shapes
]


@pytest.mark.parametrize("mutant,protocol,shape", MUTANT_GRID,
                         ids=[f"{m}-{p}-{sorted(s.items())}"
                              for m, p, s in MUTANT_GRID])
def test_mutant_findings_equal_the_jax_package_s(mutant, protocol, shape):
    """Each protocol mutant at each default shape: the same findings,
    named by the same events, in both packages (or the same refusal)."""
    assert A.MUTANTS == JA.MUTANTS

    def verdict(pkg):
        try:
            report = pkg.verify_generators(
                lambda: pkg.mutant_generators(protocol, mutant=mutant,
                                              **shape),
                protocol=protocol, shape=shape,
            )
        except (ValueError, pkg.AnalysisError) as e:
            return f"{type(e).__name__}: {e}"
        return _canon(report.to_json()) + "\n" + report.describe()

    assert verdict(A) == verdict(JA)


def test_symbolic_events_equal_the_jax_package_s():
    """The symbolic replay itself: every rank's event sequence of every
    registered protocol at its default shapes, step for step."""
    for protocol, shapes in sorted(A.DEFAULT_SHAPES.items()):
        for shape in shapes:
            ours = [A.symbolic_events(g)
                    for g in A.build_generators(protocol, **shape)]
            theirs = [JA.symbolic_events(g)
                      for g in JA.build_generators(protocol, **shape)]
            assert repr(ours) == repr(theirs), (protocol, shape)
