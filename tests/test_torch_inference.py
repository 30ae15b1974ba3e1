"""The port's streaming inference: the reference's cases, and parity.

``smi_tpu_torch/serving/inference.py`` is the port's copy of the JAX
package's disaggregated prefill/decode engine (pure Python over one
serving front end: content-addressed KV payloads, a CRC-chained token
readout, KV-shard handoffs through ``pack_shard``), and
``traced_kv_dataflow`` runs the same decode fold as the port's
``allreduce`` on a world of ranks. The first part carries over
``tests/test_inference.py`` against the port: all of it but the infer
scope's clean exhaustion (``tests/test_torch_model_scopes.py`` runs the
same scope on the port) and the traced cases, which the port holds
below against the JAX function's tokens, not its HLO (the port compiles
none; the reference's lint case fails on the JAX side). The second part
runs the same seeds through both packages with the tolerance "equal":
every cell, campaign and selftest report as sorted-key JSON, the
engine's generation digests and audit trail, and every KV handoff blob
byte for byte; ``traced_kv_dataflow``'s tokens on an 8-rank CPU
``LocalWorld`` ``array_equal`` to the JAX function's on the 8 CPU
devices.
"""

import pytest

from smi_tpu_torch import analysis as A
from smi_tpu_torch.parallel import credits as C
from smi_tpu_torch.parallel import faults as F
from smi_tpu_torch.serving.campaign import (
    INFER_CELLS,
    MODEL_GATES,
    infer_campaign,
    infer_selftest,
    inference_fields,
    replay_model_trace,
    run_infer_kill_decode_cell,
    run_infer_kill_prefill_cell,
    run_infer_saturate_cell,
    run_infer_scale_in_cell,
    run_infer_smoke_cell,
)
from smi_tpu_torch.serving.elasticity import ElasticityController
from smi_tpu_torch.serving.frontend import ServingFrontend
from smi_tpu_torch.serving.inference import (
    InferenceEngine,
    decode_ranks_for,
    decode_token,
    kv_payload,
    traced_kv_dataflow,
)

from torch_serving_parity import BlobCapture, canon

pytestmark = pytest.mark.inference

#: The r20 infer scope (the last DEFAULT_SCOPES entry) and its two
#: seeded mutants — pinned by name so a registry edit fails loudly.
INFER_SCOPE = A.DEFAULT_SCOPES[-1]
INFER_MUTANTS = ("decode_failover_without_kv_handoff",
                 "stale_kv_after_cutover")


# ---------------------------------------------------------------------------
# 1. Deterministic building blocks
# ---------------------------------------------------------------------------


def test_decode_ranks_split_is_upper_half():
    assert decode_ranks_for(2) == (1,)
    assert decode_ranks_for(4) == (2, 3)
    assert decode_ranks_for(5) == (2, 3, 4)
    assert decode_ranks_for(8) == (4, 5, 6, 7)
    with pytest.raises(ValueError):
        decode_ranks_for(1)


def test_token_readout_is_placement_independent():
    """decode_token folds ONLY the KV payloads and the accepted
    prefix — no rank, no epoch, no clock — so a generation resumed on
    a failover heir is bit-identical by construction."""
    kv = tuple(kv_payload("t0", 0, c) for c in range(4))
    a = []
    b = []
    for _ in range(3):
        a.append(decode_token(kv, a))
        b.append(decode_token(kv, b))
    assert a == b
    # a different shard SET is a different generation
    other = tuple(kv_payload("t1", 0, c) for c in range(4))
    assert decode_token(other, []) != decode_token(kv, [])


def test_engine_rejects_bad_shapes():
    fe = ServingFrontend(4, seed=0, check_deadlines=False)
    eng = InferenceEngine(fe, seed=0)
    with pytest.raises(ValueError, match="QoS"):
        eng.submit("t0", "bulk")
    with pytest.raises(ValueError, match="gen_len"):
        eng.submit("t0", "interactive", gen_len=-1)
    with pytest.raises(ValueError, match="decode rank"):
        eng.submit("t0", "interactive", decode_rank=0)  # a prefill rank
    with pytest.raises(ValueError):
        InferenceEngine(ServingFrontend(4, seed=0,
                                        check_deadlines=False),
                        decode_ranks=(0, 1, 2, 3))  # no prefill left


# ---------------------------------------------------------------------------
# 2. Lifecycle + degenerate shapes
# ---------------------------------------------------------------------------


def _run(eng, ticks):
    for _ in range(ticks):
        eng.step()
    eng.drain()


def test_no_fault_lifecycle_reaches_done_bit_identically():
    digests = []
    for _ in range(2):  # same seed twice -> byte-identical digests
        fe = ServingFrontend(4, seed=7, check_deadlines=False)
        eng = InferenceEngine(fe, seed=7)
        for i in range(6):
            eng.submit(f"t{i % 3}", "interactive", gen_len=8)
        _run(eng, 120)
        rep = eng.report()
        assert rep["states"]["done"] == 6, rep["states"]
        assert rep["kv_handoffs_committed"] == 0
        assert rep["replayed_prefills"] == 0
        assert rep["lost_accepted_tokens"] == 0
        assert all(r.ttft is not None for r in eng.requests)
        digests.append(eng.generation_digest())
    assert digests[0] == digests[1]


def test_single_decode_rank_shape_completes():
    """n=2 is the smallest disaggregated shape: one prefill rank, one
    decode rank, no failover headroom — the engine must still serve."""
    fe = ServingFrontend(2, seed=0, check_deadlines=False)
    eng = InferenceEngine(fe, seed=0)
    assert eng.prefill_ranks == (0,)
    assert eng.decode_ranks == (1,)
    for i in range(3):
        eng.submit("t0", "interactive", gen_len=4)
    _run(eng, 80)
    assert eng.report()["states"]["done"] == 3


def test_zero_token_generation_is_done_at_transport():
    """gen_len=0: the KV lands, nothing is generated, nothing is
    delivered, and the shards retire immediately — done, not stuck."""
    fe = ServingFrontend(4, seed=0, check_deadlines=False)
    eng = InferenceEngine(fe, seed=0)
    req = eng.submit("t0", "interactive", gen_len=0)
    _run(eng, 40)
    assert req.state == "done"
    assert req.tokens == []
    assert eng.generation_digest()[req.key] == ()
    # residency retired: nothing for a failover to move
    assert not any(inv for inv in eng.residents.values())


def test_decode_death_with_empty_shard_set_moves_nothing():
    """The empty-handoff degenerate: the dead decode rank holds NO
    residents (its only generation already delivered), so the confirm
    fires the failover path over an empty inventory — zero committed
    handoffs, zero crashes, zero loss."""
    fe = ServingFrontend(4, seed=0, check_deadlines=False)
    eng = InferenceEngine(fe, seed=0)
    req = eng.submit("t0", "interactive", gen_len=2,
                     decode_rank=2)
    for _ in range(40):
        eng.step()
    assert req.state == "done"
    assert not eng.residents[2]
    fe.kill(2)
    _run(eng, 80)
    committed = [h for h in eng.handoffs if h["state"] == "committed"]
    assert committed == []
    assert eng.lost_accepted_tokens == 0
    assert fe.report()["lost_accepted"] == 0


# ---------------------------------------------------------------------------
# 3. The seeded chaos-cell matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,runner", INFER_CELLS,
                         ids=[nm for nm, _ in INFER_CELLS])
def test_infer_cell_is_green(name, runner):
    report = runner(seed=0)
    assert report["ok"], f"{name}: {report['verdict']}"


def test_kill_decode_cell_commits_exactly_one_failover_handoff():
    report = run_infer_kill_decode_cell(n=4, seed=3, duration=200)
    assert report["ok"], report["verdict"]
    inf = report["inference"]
    committed = [h for h in inf["handoffs"]
                 if h["state"] == "committed"]
    assert len(committed) == 1
    assert committed[0]["kind"] == "failover"
    assert committed[0]["reason"] == f"failover:rank{report['victim']}"
    assert inf["replayed_prefills"] == 0
    assert inf["lost_accepted_tokens"] == 0
    assert report["digest_intersection"] > 0


def test_kill_prefill_cell_replays_and_never_hands_off():
    report = run_infer_kill_prefill_cell(n=4, seed=3, duration=200)
    assert report["ok"], report["verdict"]
    inf = report["inference"]
    assert inf["replayed_prefills"] >= 1
    # the paths are never confused: no failover-kind handoff, and no
    # handoff of any kind touching the dead prefill rank
    assert not [h for h in inf["handoffs"]
                if h["kind"] == "failover"
                or report["victim"] in (h["src"], h["dst"])]
    assert report["digest_intersection"] > 0


def test_saturate_cell_hands_off_on_blame_not_membership():
    report = run_infer_saturate_cell(n=4, seed=0)
    assert report["ok"], report["verdict"]
    inf = report["inference"]
    sat = report["saturated"]
    assert any(b["reason"] == f"backpressure:rank{sat}"
               for b in inf["blame_triggers"])
    first = [h for h in inf["handoffs"]
             if h["state"] == "committed"][0]
    assert first["kind"] == "handoff"
    assert first["reason"] == f"blame:backpressure:rank{sat}"
    assert report["confirmed"] == []  # saturation is not death


def test_partition_cell_aborts_loudly_and_loses_nothing():
    report = run_infer_partition_handoff_cell_default()
    inf = report["inference"]
    aborted = [h for h in inf["handoffs"]
               if h["kind"] == "handoff" and h["state"] == "aborted"]
    assert len(aborted) == 1
    assert aborted[0]["abort_reason"] in ("membership-change",
                                          "quorum-lost")
    assert inf["lost_accepted_tokens"] == 0
    assert report["partition"]["split_brain_incidents"] == 0
    assert report["partition"]["heal_rejoins"] >= 1


def run_infer_partition_handoff_cell_default():
    from smi_tpu_torch.serving.campaign import (
        run_infer_partition_handoff_cell,
    )

    report = run_infer_partition_handoff_cell(n=4, seed=0)
    assert report["ok"], report["verdict"]
    return report


def test_infer_campaign_is_green_and_selftest_matches():
    report = infer_campaign(seed=0, n=4)
    assert report["ok"], report["failures"]
    assert set(report["outcomes"]) == {nm for nm, _ in INFER_CELLS}
    assert report["lost_accepted_tokens"] == 0
    st = infer_selftest(seed=0)
    assert st["ok"], st["verdict"]
    assert st["cell"] == "infer-kill-decode"


@pytest.mark.slow
@pytest.mark.parametrize("n", [4, 8])
def test_infer_campaign_seed_sweep(n):
    """The long soak: 16 seeds x both pod shapes, every cell green,
    zero lost accepted tokens anywhere."""
    for seed in range(16):
        report = infer_campaign(seed=seed, n=n)
        assert report["ok"], (seed, n, report["failures"])
        assert report["lost_accepted_tokens"] == 0


# ---------------------------------------------------------------------------
# 4. The scale-in victim discipline (unit tier)
# ---------------------------------------------------------------------------


def test_scale_in_victim_refuses_resident_decode_ranks():
    """The controller's victim scan reads the engine's published
    inventory duck-typed: the highest rank holds residents -> skipped;
    the next empty rank is taken; with EVERY candidate resident, no
    victim at all."""
    ctrl = ElasticityController(spares=0, sustain_in=30)
    fe = ServingFrontend(5, seed=0, check_deadlines=False,
                         elasticity=ctrl)
    fe.kv_shard_residents = {4: {("t0", 0): 3}}
    assert ctrl._scale_in_victim() == 3
    fe.kv_shard_residents = {4: {("t0", 0): 3}, 3: {("t1", 0): 2},
                             2: {("t2", 0): 1}, 1: {("t3", 0): 1},
                             0: {("t4", 0): 1}}
    assert ctrl._scale_in_victim() is None
    # an engine-less front-end has no inventory: census rules alone
    ctrl2 = ElasticityController(spares=0, sustain_in=30)
    fe2 = ServingFrontend(5, seed=0, check_deadlines=False,
                          elasticity=ctrl2)
    assert ctrl2._scale_in_victim() == 4


def test_scale_in_cell_exercises_the_discipline():
    report = run_infer_scale_in_cell(n=5, seed=0)
    assert report["ok"], report["verdict"]
    victims = {r for _, d, r in report["scale_ins"] if d == "in"}
    assert victims
    assert not victims & set(report["inference"]["decode_ranks"])


# ---------------------------------------------------------------------------
# 5. The model tier: infer scope + mutants + campaign replay
# ---------------------------------------------------------------------------



@pytest.mark.model
@pytest.mark.parametrize("mutant", INFER_MUTANTS)
def test_infer_mutants_convicted_by_exactly_their_property(mutant):
    assert mutant in A.MODEL_MUTANTS
    report = A.check_scope(
        INFER_SCOPE, world_factory=A.model_mutant_world(mutant),
        mutant=mutant,
    )
    assert not report.ok, f"{mutant} survived the infer scope"
    assert {f.property for f in report.findings} == {
        A.MODEL_MUTANT_PROPERTY[mutant]
    }
    finding = report.findings[0]
    assert finding.trace, "a conviction must carry its trace"
    # BFS minimality: no strict prefix of the trace already violates
    world = A.model_mutant_world(mutant)(INFER_SCOPE)
    from smi_tpu_torch.analysis.properties import check_state

    for action in finding.trace[:-1]:
        world.apply(tuple(action))
        assert not check_state(world), "a shorter trace convicts"
    world.apply(tuple(finding.trace[-1]))
    assert {p for p, _ in check_state(world)} == {finding.property}


@pytest.mark.model
@pytest.mark.parametrize("mutant", INFER_MUTANTS)
def test_infer_counterexamples_replay_through_campaign_gates(mutant):
    """The model's conviction is not a model artifact: the trace
    re-executes through the REAL gate/membership/WAL objects and the
    campaign names the violation in its own MODEL_GATES vocabulary."""
    report = A.check_scope(
        INFER_SCOPE, world_factory=A.model_mutant_world(mutant),
        mutant=mutant,
    )
    finding = report.findings[0]
    replay = replay_model_trace(INFER_SCOPE, finding.trace,
                                mutant=mutant)
    assert not replay["ok"]
    expected = MODEL_GATES[A.MODEL_MUTANT_PROPERTY[mutant]]
    assert expected in replay["verdict"], replay["verdict"]
    # the same trace on the CLEAN world replays green
    clean = replay_model_trace(INFER_SCOPE, finding.trace[:1])
    assert clean["ok"], clean["verdict"]


# ---------------------------------------------------------------------------
# 6. KV transport framed vs bare (the wire A/B)
# ---------------------------------------------------------------------------


@pytest.mark.faults
@pytest.mark.parametrize("nth", [0, 2])
def test_kv_frame_bitflip_is_named_on_framed_transport(nth):
    """neighbour_stream is the wire shape a KV shard rides (point to
    point, chunked, CRC+seq framed): damage in flight is an
    IntegrityError naming source, kind, and sequence."""
    plan = F.FaultPlan(bit_flips=(F.BitFlipPayload(src=0, nth=nth),))
    verdict = F.run_under_faults("neighbour_stream", 2, plan, chunks=4)
    assert verdict.detected
    assert isinstance(verdict.error, C.IntegrityError)
    assert verdict.error.kind == "checksum"
    assert verdict.error.src == 0


@pytest.mark.faults
def test_kv_frame_bitflip_is_silent_on_bare_transport():
    plan = F.FaultPlan(bit_flips=(F.BitFlipPayload(src=0, nth=1),))
    with pytest.raises(F.SilentCorruption):
        F.run_under_faults("neighbour_stream", 2, plan, chunks=4,
                           verified=False)


# ---------------------------------------------------------------------------
# 7. The traced execution variant, on a world of ranks
# ---------------------------------------------------------------------------


def _world_dataflow(n, **kwargs):
    import torch

    from smi_tpu_torch.parallel.local import LocalWorld

    outs = LocalWorld(n, device="cpu").run(
        lambda c: traced_kv_dataflow(c, **kwargs))
    tokens = [t for t, _ in outs]
    for t in tokens[1:]:
        assert torch.equal(t, tokens[0])   # every rank holds the tokens
    assert len({record for _, record in outs}) == 1
    return tokens[0], outs[0][1]


def _closed_form(n, requests, kv_chunks, gen_len):
    """The tokens in float64: ``chip_smoke.py``'s ``kv_closed_form``, the
    oracle phase 37 holds the card's tokens to, held here to the JAX
    function's tokens."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.kv_closed_form(n, requests, kv_chunks, gen_len)


def test_traced_kv_dataflow_equals_the_jax_function_s_tokens(comm8):
    import numpy as np

    from smi_tpu.serving.inference import traced_kv_dataflow as jax_flow

    tokens, record = _world_dataflow(8, requests=2, kv_chunks=8,
                                     gen_len=3)
    want, _hlo = jax_flow(comm8, requests=2, kv_chunks=8, gen_len=3)
    assert tokens.shape == (3, 2) and tokens.dtype.is_floating_point
    assert np.array_equal(tokens.numpy(), np.asarray(want))
    assert np.array_equal(tokens.numpy(), _closed_form(8, 2, 8, 3))
    again, _ = _world_dataflow(8, requests=2, kv_chunks=8, gen_len=3)
    assert np.array_equal(again.numpy(), tokens.numpy())
    # the record names each decode step's fold, in order
    lines = record.splitlines()
    assert len(lines) == 3
    assert all(line.startswith("all-reduce f32[2] ") for line in lines)
    assert [line.rsplit("step=", 1)[1] for line in lines] == ["0", "1", "2"]


def test_traced_kv_dataflow_rejects_undivisible_shards(comm8):
    from smi_tpu.serving.inference import traced_kv_dataflow as jax_flow

    with pytest.raises(ValueError, match="divide") as ours:
        _world_dataflow(8, requests=2, kv_chunks=3)
    with pytest.raises(ValueError) as theirs:
        jax_flow(comm8, requests=2, kv_chunks=3)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n,requests,kv_chunks,gen_len", [
    (1, 3, 4, 2), (2, 2, 4, 2), (4, 5, 8, 4), (8, 2, 8, 0)])
def test_traced_kv_dataflow_shapes_on_smaller_worlds(n, requests,
                                                     kv_chunks, gen_len):
    import numpy as np

    tokens, record = _world_dataflow(n, requests=requests,
                                     kv_chunks=kv_chunks, gen_len=gen_len)
    assert tuple(tokens.shape) == (gen_len, requests)
    assert np.array_equal(tokens.numpy(),
                          _closed_form(n, requests, kv_chunks, gen_len))
    assert len(record.splitlines()) == gen_len


def test_traced_kv_dataflow_ring_tier_equals_the_default_tier():
    """On CPU tensors the ring wrappers run their plain versions at the
    world's rendezvous: the same integers, the same tokens."""
    import torch

    default, _ = _world_dataflow(8, requests=4, kv_chunks=8, gen_len=3)
    ring, record = _world_dataflow(8, requests=4, kv_chunks=8, gen_len=3,
                                   backend="ring")
    assert torch.equal(ring, default)
    assert all("backend=ring" in line for line in record.splitlines())


# ---------------------------------------------------------------------------
# 8. The bench provenance field
# ---------------------------------------------------------------------------


def test_inference_fields_shape_for_bench():
    fields = inference_fields(seed=0)
    assert set(fields) == {
        "requests", "done", "prefill_chunks_per_tick",
        "tokens_per_tick", "kv_handoffs_committed",
        "kv_handoffs_aborted", "replayed_prefills",
        "lost_accepted_tokens", "ttft_p99", "ok",
    }
    assert fields["ok"] is True
    assert fields["done"] > 0
    assert fields["kv_handoffs_committed"] == 0
    assert fields["lost_accepted_tokens"] == 0


# ---------------------------------------------------------------------------
# 9. Parity with the JAX package: the same seeds, the same reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", [nm for nm, _ in INFER_CELLS])
def test_infer_cell_equals_the_jax_package_s(monkeypatch, name, seed):
    from smi_tpu.serving import campaign as JC

    blobs = BlobCapture(monkeypatch)
    ours = dict(INFER_CELLS)[name](seed=seed)
    theirs = dict(JC.INFER_CELLS)[name](seed=seed)
    assert canon(ours) == canon(theirs)
    blobs.assert_equal(at_least=0)


def test_kv_handoff_blobs_equal_the_jax_package_s(monkeypatch):
    """The kill-decode and saturate cells hand KV shards off: every
    packed blob (header, pickled payload, CRC) is the same bytes."""
    from smi_tpu.serving import campaign as JC
    from smi_tpu_torch.serving import campaign as SC

    blobs = BlobCapture(monkeypatch)
    for cell in ("run_infer_kill_decode_cell", "run_infer_saturate_cell"):
        ours = getattr(SC, cell)(n=4, seed=3)
        assert canon(ours) == canon(getattr(JC, cell)(n=4, seed=3))
    blobs.assert_equal(at_least=2)


@pytest.mark.parametrize("kwargs", [
    dict(seed=0, n=4), dict(seed=5, n=5), dict(seed=1, n=4, trials=2)],
    ids=["n4", "n5", "two-trials"])
def test_infer_campaign_equals_the_jax_package_s(kwargs):
    from smi_tpu.serving import campaign as JC

    ours = infer_campaign(**kwargs)
    assert ours["ok"], ours["failures"]
    assert canon(ours) == canon(JC.infer_campaign(**kwargs))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_infer_selftest_and_fields_equal_the_jax_package_s(seed):
    from smi_tpu.serving import campaign as JC

    assert canon(infer_selftest(seed=seed)) == canon(JC.infer_selftest(
        seed=seed))
    assert canon(inference_fields(seed=seed)) == canon(
        JC.inference_fields(seed=seed))


def test_engine_run_equals_the_jax_package_s(monkeypatch):
    """One engine driven by hand in both packages, a decode rank killed
    mid-generation: the same report, generation digests, handoff audit
    trail and front-end report."""
    from smi_tpu.serving import frontend as JFE
    from smi_tpu.serving import inference as JI

    blobs = BlobCapture(monkeypatch)
    runs = []
    for fe_cls, eng_cls in ((ServingFrontend, InferenceEngine),
                            (JFE.ServingFrontend, JI.InferenceEngine)):
        fe = fe_cls(4, seed=7, check_deadlines=False)
        eng = eng_cls(fe, seed=7)
        for i in range(6):
            eng.submit(f"t{i % 3}", "interactive", gen_len=8)
        for tick in range(120):
            if tick == 12:
                fe.kill(3)
            eng.step()
        eng.drain()
        runs.append(canon({
            "report": eng.report(),
            "digest": sorted(map(list, eng.generation_digest().items())),
            "handoffs": eng.handoffs,
            "frontend": fe.report(),
        }))
    assert runs[0] == runs[1]
    blobs.assert_equal(at_least=1)


@pytest.mark.parametrize("tenant,seq", [("t0", 0), ("tenant-7", 12)])
def test_kv_payload_and_token_readout_equal_the_jax_package_s(tenant,
                                                             seq):
    from smi_tpu.serving import inference as JI

    kv = tuple(kv_payload(tenant, seq, c) for c in range(5))
    assert kv == tuple(JI.kv_payload(tenant, seq, c) for c in range(5))
    ours, theirs = [], []
    for _ in range(6):
        ours.append(decode_token(kv, ours))
        theirs.append(JI.decode_token(kv, theirs))
    assert ours == theirs
    assert decode_ranks_for(7) == JI.decode_ranks_for(7)


@pytest.mark.model
@pytest.mark.parametrize("mutant", INFER_MUTANTS)
def test_infer_counterexample_replay_equals_the_jax_package_s(mutant):
    from smi_tpu.serving import campaign as JC

    report = A.check_scope(
        INFER_SCOPE, world_factory=A.model_mutant_world(mutant),
        mutant=mutant,
    )
    trace = [list(a) for a in report.findings[0].trace]
    ours = replay_model_trace(INFER_SCOPE.to_json(), trace, mutant=mutant)
    assert canon(ours) == canon(JC.replay_model_trace(
        INFER_SCOPE.to_json(), trace, mutant=mutant))

