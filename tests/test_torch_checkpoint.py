"""The port's checkpoints against the JAX package's, byte for byte.

``pack_shard`` gives the JAX bytes for the same numpy payload (a tensor
is stored as its CPU array), so a store written by either package
restores in the other; every store case of ``tests/test_checkpoint.py``
holds in the port with the same error texts; ``run_iterative`` replays
a crashed run bit-identically; and the checkpointed Jacobi and K-means
drivers on CPU worlds resume bit-identically and agree with the JAX
drivers on the same inputs."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import smi_tpu_torch as st
from smi_tpu.parallel import checkpoint as J
from smi_tpu_torch.models import kmeans as tkmeans
from smi_tpu_torch.models import stencil as tstencil
from smi_tpu_torch.parallel import checkpoint as T

PAYLOADS = [
    np.arange(12, dtype=np.float64).reshape(3, 4) / 7,
    np.arange(8, dtype=np.int64),
    np.full((2, 3), 0.1, dtype=np.float32),
    np.zeros((0, 4), dtype=np.int32),
    np.array(3.5, dtype=np.float32),
    {0: (1, 2), "k": [1.5]},
    (1, "two", 3.0),
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=lambda p: type(p).__name__
                         + str(getattr(p, "shape", "")))
def test_pack_shard_bytes_are_the_jax_bytes(payload):
    got = T.pack_shard(3, 17, payload)
    assert got == J.pack_shard(3, 17, payload)
    rank, step, back, crc = T.unpack_shard(got[0])
    assert (rank, step, crc) == (3, 17, got[1])
    if isinstance(payload, np.ndarray):
        assert back.dtype == payload.dtype
        np.testing.assert_array_equal(back, payload)
    else:
        assert back == payload and type(back) is type(payload)


def test_a_tensor_is_stored_as_its_numpy_array():
    x = torch.arange(10, dtype=torch.float32).reshape(2, 5) / 3
    assert T.pack_shard(0, 1, x) == J.pack_shard(0, 1, x.numpy())
    _, _, back, _ = T.unpack_shard(T.pack_shard(0, 1, x)[0])
    assert isinstance(back, np.ndarray)
    np.testing.assert_array_equal(back, x.numpy())


def _shards(step):
    return {r: np.full(3, step * 10 + r, dtype=np.int64) for r in range(3)}


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_a_store_restores_in_the_other_package(tmp_path, writer, reader):
    store = writer.CheckpointStore(str(tmp_path))
    store.save(0, _shards(0), epoch=0)
    store.save(4, {**_shards(4), 3: {"means": (1, 2)}}, epoch=2)
    step, shards, epoch = reader.CheckpointStore(str(tmp_path)).restore()
    assert (step, epoch) == (4, 2)
    assert shards[3] == {"means": (1, 2)}
    np.testing.assert_array_equal(shards[2], np.full(3, 42))


def test_both_packages_write_the_same_files(tmp_path):
    for name, mod in (("jax", J), ("torch", T)):
        store = mod.CheckpointStore(str(tmp_path / name), keep=2)
        for step in (0, 3, 6):
            store.save(step, _shards(step), epoch=step // 3)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "torch")) and files
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


# -- tests/test_checkpoint.py's store cases, in the port -----------------


def test_shard_roundtrip_is_type_exact(tmp_path):
    d = str(tmp_path)
    arr = np.arange(12, dtype=np.float64).reshape(3, 4) / 7
    name, crc = T.write_shard(d, 2, 5, arr)
    rank, step, got, rcrc = T.read_shard(os.path.join(d, name))
    assert (rank, step) == (2, 5) and rcrc == crc
    assert got.dtype == arr.dtype and np.array_equal(got, arr)
    state = {0: (1, 2), "k": [1.5]}
    T.write_shard(d, 0, 1, state)
    _, _, payload, _ = T.read_shard(os.path.join(d, T.shard_name(0, 1)))
    assert payload == state and isinstance(payload[0], tuple)
    assert T.shard_name(3, 12) == J.shard_name(3, 12)


def _damaged(tmp_path, mod, damage):
    """Write one shard with ``mod``, damage its bytes, read it back: the
    CheckpointIntegrityError's text and fields."""
    d = str(tmp_path / mod.__name__)
    mod.write_shard(d, 1, 3, np.ones(4))
    path = os.path.join(d, mod.shard_name(1, 3))
    blob = bytearray(open(path, "rb").read())
    open(path, "wb").write(damage(blob))
    with pytest.raises(mod.CheckpointIntegrityError) as e:
        mod.read_shard(path)
    err = e.value
    return (str(err).replace(d, "<dir>"), err.rank, err.step, err.expected,
            err.got)


@pytest.mark.parametrize("damage", [
    lambda b: bytes(b[:-2] + bytes([b[-2] ^ 0xFF]) + b[-1:]),
    lambda b: bytes(b[:-5]),
    lambda b: b"no header here",
    lambda b: b"{not json\n" + bytes(b),
], ids=["bit-rot", "torn", "no-header", "bad-header"])
def test_damaged_shards_are_named_alike(tmp_path, damage):
    got = _damaged(tmp_path, T, damage)
    assert got == _damaged(tmp_path, J, damage)
    assert "(rank" in got[0] or "header" in got[0]


def test_write_atomic_leaves_no_temp_files(tmp_path):
    path = str(tmp_path / "x" / "file.bin")
    T.write_atomic(path, b"payload")
    assert open(path, "rb").read() == b"payload"
    assert sorted(os.listdir(tmp_path / "x")) == ["file.bin"]
    T.write_atomic(str(tmp_path / "y.bin"), b"1")
    os.replace(str(tmp_path / "y.bin"), str(tmp_path / "z.bin"))
    open(tmp_path / "t.tmp", "wb").write(b"2")
    T.fsync_rename(str(tmp_path / "t.tmp"), str(tmp_path / "y.bin"))
    assert open(tmp_path / "y.bin", "rb").read() == b"2"


def test_store_restores_latest_complete(tmp_path):
    store = T.CheckpointStore(str(tmp_path))
    store.save(0, _shards(0), epoch=0)
    store.save(4, _shards(4), epoch=1)
    step, shards, epoch = store.restore()
    assert (step, epoch) == (4, 1)
    assert np.array_equal(shards[2], np.full(3, 42))
    assert store.latest_step() == 4


def test_store_falls_back_past_incomplete_newest(tmp_path):
    store = T.CheckpointStore(str(tmp_path))
    store.save(2, _shards(2))
    store.save(6, _shards(6))
    os.unlink(str(tmp_path / T.shard_name(1, 6)))
    step, shards, _ = store.restore()
    assert step == 2 and np.array_equal(shards[1], np.full(3, 21))


def test_store_raises_on_corrupt_existing_shard(tmp_path):
    store = T.CheckpointStore(str(tmp_path))
    store.save(1, _shards(1))
    path = str(tmp_path / T.shard_name(0, 1))
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 1
    open(path, "wb").write(bytes(blob))
    with pytest.raises(T.CheckpointIntegrityError):
        store.restore()


def test_store_refuses_a_shard_of_another_rank(tmp_path):
    texts = []
    for mod in (J, T):
        d = tmp_path / mod.__name__
        store = mod.CheckpointStore(str(d))
        store.save(5, _shards(5))
        os.replace(str(d / mod.shard_name(2, 5)),
                   str(d / mod.shard_name(1, 5)))
        with pytest.raises(mod.CheckpointIntegrityError) as e:
            store.restore()
        texts.append(str(e.value).replace(str(d), "<dir>"))
    assert texts[0] == texts[1]


def test_store_falls_back_past_mixed_generation_shards(tmp_path):
    store = T.CheckpointStore(str(tmp_path))
    store.save(2, _shards(2))
    store.save(8, _shards(8))
    T.write_shard(str(tmp_path), 1, 8, np.full(3, 999, dtype=np.int64))
    step, shards, _ = store.restore()
    assert step == 2 and np.array_equal(shards[1], np.full(3, 21))


def test_run_iterative_resume_keeps_the_restored_epoch(tmp_path):
    store = T.CheckpointStore(str(tmp_path))
    T.run_iterative(torch.zeros(2), lambda s: s + 1, 4, store=store,
                    cadence=2, epoch=3)
    assert store.restore()[2] == 3
    T.run_iterative(torch.zeros(2), lambda s: s + 1, 8, store=store,
                    cadence=2, unshard_fn=lambda sh: torch.from_numpy(sh[0]))
    step, shards, epoch = store.restore()
    assert step == 8 and epoch == 3
    assert np.array_equal(shards[0], np.full(2, 8.0, dtype=np.float32))


def test_store_ignores_torn_manifest(tmp_path):
    store = T.CheckpointStore(str(tmp_path))
    store.save(3, _shards(3))
    (tmp_path / "manifest-00000009.json").write_text('{"step": 9')
    assert store.restore()[0] == 3


def test_store_prunes_beyond_keep(tmp_path):
    store = T.CheckpointStore(str(tmp_path), keep=2)
    for step in (0, 2, 4, 6):
        store.save(step, _shards(step))
    assert len(store.manifests()) == 2
    assert store.restore()[0] == 6
    assert not os.path.exists(str(tmp_path / T.shard_name(0, 0)))


def test_store_refusals_match_jax(tmp_path):
    texts = []
    for mod in (J, T):
        d = tmp_path / mod.__name__
        store = mod.CheckpointStore(str(d))
        store.save(1, _shards(1))
        path = store.manifests()[0]
        payload = json.load(open(path))
        got = []
        for broken in ({**payload, "schema_version": 99},
                       {**payload, "shards": {}}, [1, 2]):
            with pytest.raises(mod.CheckpointError) as e:
                mod.Manifest.from_json(broken, "manifest.json")
            got.append(str(e.value))
        with pytest.raises(mod.CheckpointError) as e:
            mod.CheckpointStore(str(d)).save(0, {})
        got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            mod.CheckpointStore(str(d), keep=0)
        got.append(str(e.value))
        assert mod.CheckpointStore(str(d / "nope")).restore() is None
        texts.append(got)
    assert texts[0] == texts[1]
    manifest = T.Manifest.from_json(payload, "m.json")
    assert manifest.to_json() == payload


# -- run_iterative ---------------------------------------------------------


class _Crash(RuntimeError):
    pass


def _crashing(step_fn, at):
    calls = {"n": 0}

    def fn(state):
        if calls["n"] == at:
            raise _Crash(f"crash at iteration {at}")
        calls["n"] += 1
        return step_fn(state)

    return fn


def test_run_iterative_restores_and_replays_only_the_tail(tmp_path):
    def step(s):
        return s * 1.0000001 + 1.0   # rounding-sensitive on purpose

    state0 = torch.linspace(0.0, 1.0, 8)
    want, _ = T.run_iterative(state0.clone(), step, 10, store=None)
    store = T.CheckpointStore(str(tmp_path))
    with pytest.raises(_Crash):
        T.run_iterative(state0.clone(), _crashing(step, 7), 10,
                        store=store, cadence=3)
    assert store.latest_step() == 6
    got, start = T.run_iterative(
        state0.clone(), step, 10, store=store, cadence=3,
        unshard_fn=lambda sh: torch.from_numpy(sh[0]))
    assert start == 6 and torch.equal(got, want)


def test_run_iterative_refusals_match_jax(tmp_path):
    texts = []
    for mod in (J, T):
        store = mod.CheckpointStore(str(tmp_path / mod.__name__))
        mod.run_iterative(np.zeros(2), lambda s: s + 1, 6, store=store,
                          cadence=2)
        got = []
        with pytest.raises(mod.CheckpointError) as e:
            mod.run_iterative(np.zeros(2), lambda s: s + 1, 3, store=store)
        got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            mod.run_iterative(0, lambda s: s, 1, cadence=0)
        got.append(str(e.value))
        texts.append(got)
    assert texts[0] == texts[1]


@pytest.mark.parametrize("directory,cadence", [
    (None, None), ("/tmp/ckpt", None), ("/tmp/ckpt", "12"),
    ("/tmp/ckpt", "banana"), ("/tmp/ckpt", "0"), ("  ", "3")])
def test_elastic_env_config_matches_jax(monkeypatch, directory, cadence):
    for name, value in ((T.DIR_ENV, directory), (T.CADENCE_ENV, cadence)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    answers = []
    for mod in (J, T):
        try:
            answers.append(mod.elastic_env_config())
        except mod.CheckpointError as e:
            answers.append(str(e))
    assert answers[0] == answers[1]


# -- the checkpointed drivers ---------------------------------------------


@contextlib.contextmanager
def crash_on_sweep(at):
    """``models.stencil.make_stencil_fn``'s sweeps raise ``_Crash`` from
    the ``at``-th call of each (a crash mid-run)."""
    real = tstencil.make_stencil_fn

    def make(comm, iterations, **kw):
        fn, calls = real(comm, iterations, **kw), [0]

        def sweep(block):
            calls[0] += 1
            if calls[0] > at:
                raise _Crash(f"crash at iteration {at}")
            return fn(block)

        return sweep

    tstencil.make_stencil_fn = make
    try:
        yield
    finally:
        tstencil.make_stencil_fn = real


def _grid(h, w):
    g = st.initial_grid(h, w)
    g[:, -1] = 2.0
    return g


@pytest.mark.parametrize("shape", [(2, 4), (1, 1)])
def test_run_jacobi_resumes_bit_identically(tmp_path, comm8, shape):
    """Crash at iteration 5 of 7 with cadence 2, resume: equal to the
    uninterrupted run, to the JAX driver and to the serial reference;
    one band a process row in the store."""
    from smi_tpu.parallel.mesh import make_communicator

    grid = _grid(16, 16)
    if shape == (1, 1):
        comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                    device="cpu")
    else:
        comm = st.LocalWorld(shape, ("sx", "sy"), device="cpu")
    want = T.run_jacobi(grid, 7, comm=comm)
    store = T.CheckpointStore(str(tmp_path))
    with crash_on_sweep(5), pytest.raises(_Crash):
        T.run_jacobi(grid, 7, comm=comm, store=store, cadence=2)
    assert store.latest_step() == 4
    got = T.run_jacobi(grid, 7, comm=comm, store=store, cadence=2)
    assert torch.equal(got, want)
    _, shards, _ = store.restore()
    assert sorted(shards) == list(range(shape[0]))
    assert shards[0].shape == (16 // shape[0], 16)
    jcomm = make_communicator(shape=shape, axis_names=("jx", "jy"),
                              devices=comm8.mesh.devices.flat[:8])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.run_jacobi(grid, 7, comm=jcomm)))
    np.testing.assert_array_equal(got.numpy(),
                                  st.reference_stencil(grid, 7))


def test_run_jacobi_restores_a_jax_store(tmp_path, comm8):
    """A store the JAX driver wrote at iteration 4 resumes in the port to
    the JAX driver's own result."""
    from smi_tpu.parallel.mesh import make_communicator

    grid = _grid(16, 16)
    jcomm = make_communicator(shape=(2, 4), axis_names=("jx", "jy"),
                              devices=comm8.mesh.devices.flat[:8])
    J.run_jacobi(grid, 4, comm=jcomm, store=J.CheckpointStore(
        str(tmp_path)), cadence=2)
    got = T.run_jacobi(grid, 9, comm=st.LocalWorld((2, 4), ("sx", "sy"),
                                                   device="cpu"),
                       store=T.CheckpointStore(str(tmp_path)), cadence=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        J.run_jacobi(grid, 9, comm=jcomm)))


def test_run_jacobi_refuses_what_it_cannot_drive():
    with pytest.raises(ValueError, match="not divisible"):
        T.run_jacobi(_grid(15, 16), 1, comm=st.LocalWorld(
            (2, 4), ("sx", "sy"), device="cpu"))
    grid_of_processes = st.Communicator(shape=(2, 1), axis_names=("sx", "sy"),
                                        rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="grid of processes"):
        T.run_jacobi(_grid(16, 16), 1, comm=grid_of_processes)


@contextlib.contextmanager
def crash_on_update(at):
    """``models.kmeans.make_kmeans_fn``'s updates raise ``_Crash`` from
    the ``at``-th call."""
    real = tkmeans.make_kmeans_fn

    def make(world, iterations, **kw):
        fn, calls = real(world, iterations, **kw), [0]

        def update(points, means):
            calls[0] += 1
            if calls[0] > at:
                raise _Crash(f"crash at iteration {at}")
            return fn(points, means)

        return update

    tkmeans.make_kmeans_fn = make
    try:
        yield
    finally:
        tkmeans.make_kmeans_fn = real


@pytest.mark.parametrize("backend", ["xla", "ring"])
def test_run_kmeans_resumes_bit_identically(tmp_path, comm8, backend):
    """Crash at iteration 4 of 6, resume: equal to the uninterrupted run;
    on the collective-library tier equal to the JAX driver too (the ring
    tier sums in ring order: within the port's k-means tolerance), and
    within it of the serial reference; the means are the rank-0
    shard."""
    rng = np.random.RandomState(0)
    points = rng.randn(64, 4).astype(np.float32)
    means0 = points[:3].copy()
    world = st.LocalWorld(8, device="cpu")
    want = T.run_kmeans(points, means0, 6, comm=world, backend=backend)
    store = T.CheckpointStore(str(tmp_path))
    with crash_on_update(4), pytest.raises(_Crash):
        T.run_kmeans(points, means0, 6, comm=world, store=store, cadence=2,
                     backend=backend)
    assert store.latest_step() == 4
    got = T.run_kmeans(points, means0, 6, comm=world.comms[3], store=store,
                       cadence=2, backend=backend)
    assert torch.equal(got, want)
    _, shards, _ = store.restore()
    np.testing.assert_array_equal(shards[0], got.numpy())
    jax_means = np.asarray(J.run_kmeans(points, means0, 6, comm=comm8))
    if backend == "xla":
        np.testing.assert_array_equal(got.numpy(), jax_means)
    np.testing.assert_allclose(got.numpy(), jax_means, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               st.reference_kmeans(points, means0, 6),
                               rtol=1e-4, atol=1e-4)


def test_run_kmeans_after_a_shrink_resumes_on_the_survivors(tmp_path):
    """8 ranks checkpoint the means; rank 5 is lost; the survivors'
    world restores them and runs on: the result is the uninterrupted
    run's (the update is the same on any rank count, up to rounding)."""
    rng = np.random.RandomState(1)
    points = rng.randn(56 * 4, 2).astype(np.float32)
    means0 = points[:4].copy()
    world = st.LocalWorld(8, device="cpu")
    store = T.CheckpointStore(str(tmp_path))
    T.run_kmeans(points, means0, 3, comm=world, store=store, cadence=3)
    small, heirs = st.recover_communicator(world.comms[0], {5})
    assert heirs == {5: 6} and small.epoch == 1
    with pytest.raises(st.StaleEpochError):
        small.validate_epoch(6, 0)
    got = T.run_kmeans(points, means0, 6, comm=small.world, store=store,
                       cadence=3, backend="ring")
    np.testing.assert_allclose(got.numpy(),
                               st.reference_kmeans(points, means0, 6),
                               rtol=1e-4, atol=1e-4)
    assert store.restore()[0] == 6
    with pytest.raises(ValueError, match="not divisible"):
        T.run_kmeans(points[:-1], means0, 1, comm=small.world)


def test_the_drivers_default_to_the_card():
    """Without ``comm`` the drivers build their world on CUDA, and on a
    host without it they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default would run")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.run_jacobi(_grid(16, 16), 1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.run_kmeans(np.zeros((16, 2), np.float32),
                     np.zeros((2, 2), np.float32), 1)
    got = T.run_jacobi(_grid(16, 16), 2, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  st.reference_stencil(_grid(16, 16), 2))
