"""The port's demand elasticity: the reference's cases, and parity.

``smi_tpu_torch/serving/elasticity.py`` and ``placement.py`` are the
port's copies of the JAX package's autoscaling controller (the
``$SMI_TPU_AUTOSCALE`` / ``$SMI_TPU_SCALE_COOLDOWN`` /
``$SMI_TPU_SCALE_BURN_THRESHOLD`` knobs, the hysteresis band, cooldown
and victim discipline, the blame-driven migration trigger) and its
load-aware placement map. The first part carries over
``tests/test_elasticity.py`` against the port, whole. The second part
runs both packages with the tolerance "equal": the knobs' values and
error texts, placements, the campaign cells' reports and front-end
state as sorted-key JSON, and the migration arc's handoff blobs byte
for byte.
"""

import types

import pytest

from smi_tpu_torch.obs.spans import BlameVerdict
from smi_tpu_torch.serving.campaign import (
    MIN_FLASH_CROWD_DURATION,
    autoscale_selftest,
    run_flash_crowd_cell,
    run_migrate_under_kill_cell,
    run_migration_cell,
)
from smi_tpu_torch.serving.elasticity import (
    AUTOSCALE_ENV,
    SCALE_BURN_ENV,
    SCALE_BURN_THRESHOLD,
    SCALE_COOLDOWN_ENV,
    SCALE_COOLDOWN_TICKS,
    ElasticityController,
    autoscale_enabled,
    scale_burn_threshold,
    scale_cooldown_ticks,
)
from smi_tpu_torch.serving.frontend import ServingFrontend
from smi_tpu_torch.serving.placement import PlacementMap, tenant_base_rank

from torch_serving_parity import BlobCapture, canon, frontend_state

pytestmark = pytest.mark.elasticity


# ---------------------------------------------------------------------------
# Env knobs: the default_deadline loudness discipline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw,expected", [
    (None, False),          # unset = off
    ("", False),
    ("0", False),
    ("false", False),
    ("no", False),
    ("off", False),
    ("1", True),
    ("true", True),
    ("yes", True),
    ("ON", True),           # case-insensitive
])
def test_autoscale_env_parse_matrix(monkeypatch, raw, expected):
    if raw is None:
        monkeypatch.delenv(AUTOSCALE_ENV, raising=False)
    else:
        monkeypatch.setenv(AUTOSCALE_ENV, raw)
    assert autoscale_enabled() is expected


@pytest.mark.parametrize("raw", ["2", "maybe", "enabled", "y", "-1"])
def test_autoscale_env_garbage_is_loud(monkeypatch, raw):
    monkeypatch.setenv(AUTOSCALE_ENV, raw)
    with pytest.raises(ValueError, match=AUTOSCALE_ENV):
        autoscale_enabled()


@pytest.mark.parametrize("raw,expected", [
    (None, SCALE_COOLDOWN_TICKS),   # unset = built-in
    ("", SCALE_COOLDOWN_TICKS),
    ("1", 1),
    ("64", 64),
    (" 32 ", 32),                    # whitespace tolerated
    ("128", 128),
])
def test_scale_cooldown_env_parse_matrix(monkeypatch, raw, expected):
    if raw is None:
        monkeypatch.delenv(SCALE_COOLDOWN_ENV, raising=False)
    else:
        monkeypatch.setenv(SCALE_COOLDOWN_ENV, raw)
    assert scale_cooldown_ticks() == expected


@pytest.mark.parametrize("raw", ["0", "-5", "abc", "1.5"])
def test_scale_cooldown_env_garbage_is_loud(monkeypatch, raw):
    monkeypatch.setenv(SCALE_COOLDOWN_ENV, raw)
    with pytest.raises(ValueError, match=SCALE_COOLDOWN_ENV):
        scale_cooldown_ticks()


@pytest.mark.parametrize("raw,expected", [
    (None, SCALE_BURN_THRESHOLD),   # unset = built-in
    ("", SCALE_BURN_THRESHOLD),
    ("1.0", 1.0),
    ("0.5", 0.5),
    ("2", 2.0),
    ("1e1", 10.0),
])
def test_scale_burn_env_parse_matrix(monkeypatch, raw, expected):
    if raw is None:
        monkeypatch.delenv(SCALE_BURN_ENV, raising=False)
    else:
        monkeypatch.setenv(SCALE_BURN_ENV, raw)
    assert scale_burn_threshold() == expected


@pytest.mark.parametrize("raw", ["0", "-1", "inf", "nan", "hot"])
def test_scale_burn_env_garbage_is_loud(monkeypatch, raw):
    monkeypatch.setenv(SCALE_BURN_ENV, raw)
    with pytest.raises(ValueError, match=SCALE_BURN_ENV):
        scale_burn_threshold()


def test_env_outranks_builtin_but_argument_outranks_env(monkeypatch):
    monkeypatch.setenv(SCALE_COOLDOWN_ENV, "7")
    monkeypatch.setenv(SCALE_BURN_ENV, "3.5")
    ctrl = ElasticityController(spares=0)
    assert ctrl.cooldown == 7
    assert ctrl.burn_threshold == 3.5
    ctrl = ElasticityController(spares=0, cooldown=9,
                                burn_threshold=0.5)
    assert ctrl.cooldown == 9
    assert ctrl.burn_threshold == 0.5


# ---------------------------------------------------------------------------
# Controller discipline
# ---------------------------------------------------------------------------


def bound(n=4, **kwargs):
    """A controller bound to a fresh idle front-end."""
    kwargs.setdefault("spares", 0)
    ctrl = ElasticityController(**kwargs)
    fe = ServingFrontend(n, seed=0, elasticity=ctrl)
    return ctrl, fe


def test_constructor_validation():
    with pytest.raises(ValueError, match="spares"):
        ElasticityController(spares=-1)
    with pytest.raises(ValueError, match="sustain"):
        ElasticityController(sustain_out=0)
    with pytest.raises(ValueError, match="burn_fraction"):
        ElasticityController(burn_fraction=1.0)
    with pytest.raises(ValueError, match="cooldown"):
        ElasticityController(cooldown=0)
    with pytest.raises(ValueError, match="burn_threshold"):
        ElasticityController(burn_threshold=-2.0)


def test_bind_parks_spares_highest_ranks_and_arms_placement():
    ctrl = ElasticityController(spares=1)
    fe = ServingFrontend(4, seed=0, elasticity=ctrl)
    assert ctrl.parked == {3}
    assert sorted(fe.view.members) == [0, 1, 2]
    assert fe.placement.armed
    with pytest.raises(RuntimeError, match="already bound"):
        ctrl.bind(fe)


def test_bind_never_parks_below_the_floor():
    ctrl = ElasticityController(spares=5)
    fe = ServingFrontend(4, seed=0, elasticity=ctrl)
    assert sorted(fe.view.members) == [0, 1]  # floor = 2 held
    assert ctrl.parked == {2, 3}


def test_step_unbound_is_loud():
    ctrl = ElasticityController(spares=0)
    with pytest.raises(RuntimeError, match="not bound"):
        ctrl.step(0)


def test_hysteresis_band_resets_both_sustain_counters():
    ctrl, _fe = bound()
    ctrl._pressure = lambda: False
    ctrl._burn = lambda: ctrl.burn_threshold * 2  # hot
    ctrl.step(0)
    assert (ctrl.hot_ticks, ctrl.cold_ticks) == (1, 0)
    ctrl._burn = lambda: ctrl.burn_threshold * 0.5  # inside the band
    ctrl.step(1)
    assert (ctrl.hot_ticks, ctrl.cold_ticks) == (0, 0)
    ctrl._burn = lambda: 0.0  # cold
    ctrl.step(2)
    assert (ctrl.hot_ticks, ctrl.cold_ticks) == (0, 1)
    ctrl._burn = lambda: ctrl.burn_threshold * 0.5  # band again
    ctrl.step(3)
    assert (ctrl.hot_ticks, ctrl.cold_ticks) == (0, 0)


def test_queue_pressure_alone_counts_as_hot():
    ctrl, _fe = bound()
    ctrl._burn = lambda: 0.0
    ctrl._pressure = lambda: True
    ctrl.step(0)
    assert ctrl.hot_ticks == 1


def test_cooldown_separates_actuations():
    ctrl, _fe = bound(spares=1, sustain_out=1, sustain_in=1,
                      cooldown=50)
    ctrl._pressure = lambda: False
    ctrl._burn = lambda: ctrl.burn_threshold * 2
    ctrl.step(10)  # scale-out fires
    assert ctrl.scale_events == [(10, "out", 3)]
    assert ctrl.parked == set()
    ctrl._burn = lambda: 0.0
    for now in range(11, 60):  # cold, but inside the cooldown
        ctrl.step(now)
    assert ctrl.scale_events == [(10, "out", 3)]
    ctrl.step(60)  # cooldown elapsed: scale-in may fire
    assert ctrl.scale_events == [(10, "out", 3), (60, "in", 3)]
    assert ctrl.parked == {3}


def test_scale_in_victim_skips_residents_killed_and_floor():
    ctrl, fe = bound()
    assert ctrl._scale_in_victim() == 3
    # a resident stream destined to rank 3 protects it
    fe.active.append(types.SimpleNamespace(dst=3))
    assert ctrl._scale_in_victim() == 2
    fe.active.clear()
    # a killed rank is never the victim
    fe.killed.add(3)
    assert ctrl._scale_in_victim() == 2
    fe.killed.clear()
    # the floor blocks everything at n=2
    ctrl2, _fe2 = bound(n=2)
    assert ctrl2._scale_in_victim() is None


def test_scale_in_victim_skips_migration_parties():
    ctrl, fe = bound()
    fe._migration = {"src": 3, "dst": 2, "state": "draining"}
    assert ctrl._scale_in_victim() == 1
    fe._migration = None
    assert ctrl._scale_in_victim() == 3


# ---------------------------------------------------------------------------
# The migration trigger
# ---------------------------------------------------------------------------


def test_offer_blame_wants_a_structured_verdict():
    ctrl, _fe = bound()
    with pytest.raises(TypeError, match="BlameVerdict"):
        ctrl.offer_blame("credit.stall -> wire:rank0", "t0")


def test_offer_blame_ignores_non_wire_verdicts():
    ctrl, fe = bound()
    home = fe._route_new("t0", record=False)
    assert not ctrl.offer_blame(
        BlameVerdict("consumer", home, "consume.wait", 0.9), "t0")
    assert not ctrl.offer_blame(
        BlameVerdict("wire", None, "credit.stall", 0.9), "t0")
    assert ctrl.migrations_requested == 0
    assert getattr(fe, "_migration", None) is None


def test_offer_blame_ignores_a_verdict_for_someone_elses_rank():
    ctrl, fe = bound()
    home = fe._route_new("t0", record=False)
    other = next(r for r in sorted(fe.view.members) if r != home)
    assert not ctrl.offer_blame(
        BlameVerdict("wire", other, "credit.stall", 0.9), "t0")
    assert ctrl.migrations_requested == 0


def test_offer_blame_requests_a_migration_off_the_convicted_rank():
    ctrl, fe = bound()
    home = fe._route_new("t0", record=False)
    verdict = BlameVerdict("wire", home, "credit.stall", 0.66)
    assert ctrl.offer_blame(verdict, "t0")
    assert ctrl.migrations_requested == 1
    mig = fe._migration
    assert mig["tenant"] == "t0"
    assert mig["src"] == home
    assert mig["dst"] != home
    assert mig["reason"] == f"blame:wire:rank{home}"
    # one migration at a time: a second offer is refused
    assert not ctrl.offer_blame(verdict, "t0")
    assert ctrl.migrations_requested == 1


# ---------------------------------------------------------------------------
# Load-aware placement
# ---------------------------------------------------------------------------


def test_unarmed_placement_is_byte_identical_to_crc32():
    pm = PlacementMap(4)
    for t in ("t0", "t1", "alpha"):
        assert pm.place(t, [0, 1, 2, 3]) == tenant_base_rank(t, 4)


def test_armed_placement_routes_to_least_loaded():
    pm = PlacementMap(4)
    pm.armed = True
    load = {0: 5.0, 1: 0.0, 2: 3.0, 3: 9.0}.get
    choice = pm.place("t0", [0, 1, 2, 3], load)
    assert choice == 1
    # sticky: the pin survives a later load change
    assert pm.place("t0", [0, 1, 2, 3], {1: 99.0}.get) == 1


def test_armed_placement_ties_resolve_toward_crc32_home():
    pm = PlacementMap(4)
    pm.armed = True
    flat = lambda r: 0.0  # noqa: E731
    for t in ("t0", "t7", "zeta"):
        assert pm.place(t, [0, 1, 2, 3], flat) == \
            tenant_base_rank(t, 4)


def test_residents_counts_pins_per_rank():
    pm = PlacementMap(4)
    pm.pin("a", 1)
    pm.pin("b", 1)
    pm.pin("c", 3)
    assert pm.residents() == {1: 2, 3: 1}
    with pytest.raises(ValueError, match="out of"):
        pm.pin("d", 4)


# ---------------------------------------------------------------------------
# The seeded campaign cells (tier-1 at the pinned seed)
# ---------------------------------------------------------------------------


def test_flash_crowd_cell_capacity_follows_the_load():
    r = run_flash_crowd_cell(n=4, seed=0)
    assert r["ok"], r["verdict"]
    el = r["elasticity"]
    assert el["scale_outs"] >= 1 and el["scale_ins"] >= 1
    outs = [t for t, d, _ in el["events"] if d == "out"]
    ins = [t for t, d, _ in el["events"] if d == "in"]
    assert min(ins) > min(outs)  # out under the crowd, in after it
    assert len(el["parked"]) >= 1
    for mig in el["migrations"]:
        assert mig["state"] == "committed"
        assert mig["reason"].startswith("blame:wire:rank")
    # every page the crowd caused unlatched by the end
    for cls in r["health"]["classes"].values():
        assert not cls["breached"]


def test_migration_cell_is_bit_identical_to_its_control():
    r = run_migration_cell(n=4, seed=0)
    assert r["ok"], r["verdict"]
    assert r["digest_match"]
    assert r["digest_divergent"] == 0
    assert r["digest_common"] >= 1
    assert r["blame_offer"]["offered"]
    migs = r["elasticity"]["migrations"]
    assert [m["state"] for m in migs] == ["committed"]
    assert migs[0]["streams"] >= 1
    assert r["stale_epoch_rejections"] >= 1


def test_migrate_under_kill_cell_aborts_loudly():
    r = run_migrate_under_kill_cell(n=4, seed=0)
    assert r["ok"], r["verdict"]
    migs = r["elasticity"]["migrations"]
    assert [m["state"] for m in migs] == ["aborted"]
    assert migs[0]["abort_reason"] == "membership-change"
    assert r["confirmed"] == [r["src"]]
    assert r["lost_accepted"] == 0


def test_autoscale_selftest_is_green():
    r = autoscale_selftest()
    assert r["ok"], r["verdict"]


@pytest.mark.parametrize("kwargs,match", [
    (dict(duration=100), "minimum"),
    (dict(crowd_factor=1), "flash crowd"),
    (dict(spares=0), "spares"),
    (dict(spares=3), "spares"),
])
def test_flash_crowd_cell_shape_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        run_flash_crowd_cell(n=4, **kwargs)


def test_migration_cell_shape_validation():
    with pytest.raises(ValueError, match="minimum"):
        run_migration_cell(n=4, duration=10)
    with pytest.raises(ValueError, match="tenants"):
        run_migration_cell(n=4, tenants=4)
    with pytest.raises(ValueError, match="stall_at"):
        run_migrate_under_kill_cell(n=4, stall_at=80, migrate_at=70)


# ---------------------------------------------------------------------------
# The wide sweep (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("seed", range(16))
def test_elasticity_cells_sweep(n, seed):
    for cell in (run_flash_crowd_cell, run_migration_cell,
                 run_migrate_under_kill_cell):
        r = cell(n=n, seed=seed)
        assert r["ok"], (cell.__name__, n, seed, r["verdict"])


# ---------------------------------------------------------------------------
# Parity with the JAX package: the same knobs, seeds and reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env,raw", [
    (AUTOSCALE_ENV, r) for r in ("", "1", "ON", "no", "2", "maybe")
] + [
    (SCALE_COOLDOWN_ENV, r) for r in ("", " 32 ", "0", "abc", "1.5")
] + [
    (SCALE_BURN_ENV, r) for r in ("", "1e1", "0.5", "inf", "nan", "hot")
])
def test_knobs_read_as_the_jax_package_s(monkeypatch, env, raw):
    """Each knob gives the JAX package's value, or raises its error
    text."""
    from smi_tpu.serving import elasticity as JE
    from smi_tpu_torch.serving import elasticity as E

    reader = {AUTOSCALE_ENV: "autoscale_enabled",
              SCALE_COOLDOWN_ENV: "scale_cooldown_ticks",
              SCALE_BURN_ENV: "scale_burn_threshold"}[env]
    assert (E.AUTOSCALE_ENV, E.SCALE_COOLDOWN_ENV, E.SCALE_BURN_ENV) == \
        (JE.AUTOSCALE_ENV, JE.SCALE_COOLDOWN_ENV, JE.SCALE_BURN_ENV)
    monkeypatch.setenv(env, raw)
    results = []
    for module in (E, JE):
        try:
            results.append(("value", getattr(module, reader)()))
        except ValueError as exc:
            results.append(("error", str(exc)))
    assert results[0] == results[1]


def test_controller_constants_and_refusals_are_the_jax_package_s():
    from smi_tpu.serving import elasticity as JE
    from smi_tpu_torch.serving import elasticity as E

    for name in ("MIN_SERVING_RANKS", "SCALE_BURN_THRESHOLD",
                 "SCALE_COOLDOWN_TICKS", "SCALE_IN_BURN_FRACTION",
                 "SCALE_IN_SUSTAIN_TICKS", "SCALE_OUT_SUSTAIN_TICKS"):
        assert getattr(E, name) == getattr(JE, name), name
    for kwargs in (dict(spares=-1), dict(sustain_out=0),
                   dict(burn_fraction=1.0), dict(cooldown=0),
                   dict(burn_threshold=-2.0)):
        with pytest.raises(ValueError) as ours:
            E.ElasticityController(**kwargs)
        with pytest.raises(ValueError) as theirs:
            JE.ElasticityController(**kwargs)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n", [2, 4, 7])
def test_placement_equals_the_jax_package_s(n):
    from smi_tpu.serving import placement as JP

    tenants = [f"t{i}" for i in range(12)] + ["alpha", "zeta", ""]
    assert [tenant_base_rank(t, n) for t in tenants] == \
        [JP.tenant_base_rank(t, n) for t in tenants]
    ours, theirs = PlacementMap(n), JP.PlacementMap(n)
    ours.armed = theirs.armed = True
    load = {r: float((r * 7) % 5) for r in range(n)}.get
    live = list(range(n))
    assert [ours.place(t, live, load) for t in tenants] == \
        [theirs.place(t, live, load) for t in tenants]
    assert ours.residents() == theirs.residents()


@pytest.mark.parametrize("cell,kwargs", [
    ("run_flash_crowd_cell", dict(n=4, seed=0)),
    ("run_flash_crowd_cell", dict(n=5, seed=3)),
    ("run_migration_cell", dict(n=4, seed=0)),
    ("run_migration_cell", dict(n=6, seed=2)),
    ("run_migrate_under_kill_cell", dict(n=4, seed=0)),
    ("run_migrate_under_kill_cell", dict(n=4, seed=5)),
], ids=["crowd", "crowd-n5", "migration", "migration-n6", "kill",
        "kill-5"])
def test_elasticity_cell_equals_the_jax_package_s(monkeypatch, cell,
                                                  kwargs):
    from smi_tpu.serving import campaign as JC
    from smi_tpu_torch.serving import campaign as SC

    blobs = BlobCapture(monkeypatch)
    ours, fe = getattr(SC, cell)(return_frontend=True, **kwargs)
    theirs, jfe = getattr(JC, cell)(return_frontend=True, **kwargs)
    assert ours["ok"], ours["verdict"]
    assert canon(ours) == canon(theirs)
    assert frontend_state(fe) == frontend_state(jfe)
    # every migration that reached its handoff packed the same blob
    blobs.assert_equal(at_least=1 if cell == "run_migration_cell" else 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_autoscale_selftest_equals_the_jax_package_s(seed):
    from smi_tpu.serving import campaign as JC

    assert canon(autoscale_selftest(seed=seed)) == canon(
        JC.autoscale_selftest(seed=seed))

