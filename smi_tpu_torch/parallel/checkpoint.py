"""Sharded application checkpoints: CRC-framed shards, atomic manifests.

PyTorch counterpart of :mod:`smi_tpu.parallel.checkpoint`, byte for
byte: the SCR half of the elastic runtime (Moody et al., "Design,
Modeling, and Evaluation of a Scalable Multi-level Checkpointing
System", SC'10). Long iterative jobs (Jacobi, K-means) periodically
persist **per-rank shards** so a crash at iteration *i* restores from the
latest *complete* checkpoint and replays only the tail — never from
iteration 0, never from a torn write.

Durability discipline:

- every file is written to a temp name in the same directory,
  ``fsync``\\ ed, then atomically renamed into place — a reader never
  observes a half-written shard or manifest;
- every shard carries CRC framing: a JSON header naming
  ``(rank, step, nbytes, crc)`` followed by the raw payload bytes. A
  shard whose payload hashes differently from its header — bit rot,
  torn write that survived rename, wrong file — raises
  :class:`CheckpointIntegrityError` naming rank, step, and expected
  vs got, never deserializes into garbage state;
- the **manifest** (``manifest-<step>.json``, schema-versioned) lists
  every shard with its CRC and is written *after* all shards land, so
  a manifest's existence certifies a complete checkpoint. Restore
  scans manifests newest-first and takes the first whose shards all
  verify — a crash between shard writes leaves the previous manifest
  intact and authoritative.

A tensor payload is stored as its CPU numpy array (and restores as
one), so the bytes are the JAX package's for the same values and a
store written by either package restores in the other.

:func:`run_iterative` is the generic driver; :func:`run_jacobi` and
:func:`run_kmeans` wrap the port's two HPC models with it. Both are
bit-identical under crash/restore because each iteration is the same
per-step function applied to restored state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import zlib
from typing import Callable, Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

#: Default checkpoint cadence (iterations between checkpoints). Env
#: overrides:
CADENCE_ENV = "SMI_TPU_CHECKPOINT_CADENCE"
DIR_ENV = "SMI_TPU_CHECKPOINT_DIR"
DEFAULT_CADENCE = 8


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or restored."""


class CheckpointIntegrityError(CheckpointError):
    """A shard's payload does not hash to its framed CRC.

    Mirrors :class:`~smi_tpu_torch.parallel.errors.IntegrityError` for
    data at rest: names the ``rank``, ``step``, and ``expected`` vs ``got``
    CRCs so corruption is debuggable, and guarantees damaged state is
    never silently restored."""

    def __init__(self, message: str, rank: Optional[int] = None,
                 step: Optional[int] = None, expected=None, got=None):
        super().__init__(message)
        self.rank = rank
        self.step = step
        self.expected = expected
        self.got = got


def fsync_rename(tmp_path: str, final_path: str) -> None:
    """The durability idiom of every persistent artifact here: flush
    + fsync the temp file's contents, atomically rename it into place,
    then fsync the directory so the rename itself is durable."""
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp_path, final_path)
    dfd = os.open(os.path.dirname(final_path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    except OSError:
        pass  # some filesystems refuse directory fsync; rename landed
    finally:
        os.close(dfd)


def write_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via temp file + fsync + rename."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    dfd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


# ---------------------------------------------------------------------------
# Shard framing (CRC + seq, at rest)
# ---------------------------------------------------------------------------


def _encode_payload(payload) -> Tuple[bytes, dict]:
    """Serialize one shard payload. ndarrays round-trip exactly
    (dtype + shape + raw bytes); everything else goes through pickle —
    the JAX package's encoding. A tensor is stored as its CPU numpy
    array. JSON would silently mutate containers on restore (tuples
    become lists, int dict keys become strings), and a resumed run whose
    state changed *type* diverges from the fault-free run, which is
    the exact silent divergence this layer exists to prevent."""
    import numpy as np
    import torch

    if torch.is_tensor(payload):
        payload = payload.detach().cpu().numpy()
    if isinstance(payload, np.ndarray):
        return payload.tobytes(order="C"), {
            "kind": "ndarray",
            "dtype": str(payload.dtype),
            "shape": list(payload.shape),
        }
    import pickle

    return pickle.dumps(payload), {"kind": "pickle"}


def _decode_payload(data: bytes, meta: dict):
    if meta.get("kind") == "ndarray":
        import numpy as np

        return np.frombuffer(
            data, dtype=np.dtype(meta["dtype"])
        ).reshape(meta["shape"]).copy()
    if meta.get("kind") == "pickle":
        import pickle

        return pickle.loads(data)
    raise CheckpointIntegrityError(
        f"shard payload kind {meta.get('kind')!r} is unknown to this "
        f"build"
    )


def shard_name(rank: int, step: int) -> str:
    return f"shard-step{step:08d}-rank{rank}.bin"


def pack_shard(rank: int, step: int, payload) -> Tuple[bytes, int]:
    """Frame one shard in memory; returns ``(blob, crc)``.

    The exact bytes :func:`write_shard` puts on disk — a JSON header
    line framing the payload's length and CRC, then the payload. Split
    out so the framing is usable as a *transport*: a live-migration
    handoff ships a tenant's in-flight stream state through this
    discipline (pack → move → :func:`unpack_shard`) without touching a
    filesystem, and torn or bit-flipped state is rejected exactly like
    a damaged checkpoint at rest.
    """
    data, meta = _encode_payload(payload)
    crc = zlib.crc32(data) & 0xFFFFFFFF
    header = dict(
        meta, rank=rank, step=step, nbytes=len(data), crc=crc,
        schema_version=SCHEMA_VERSION,
    )
    return json.dumps(header, sort_keys=True).encode() + b"\n" + data, crc


def unpack_shard(blob: bytes, origin: str = "<memory>"):
    """Verify + decode a framed shard blob; returns
    ``(rank, step, payload, crc)``. ``origin`` names the blob's source
    in errors (a file path, a migration handoff, ...).

    Raises :class:`CheckpointIntegrityError` on a CRC or length
    mismatch — a damaged shard names itself instead of deserializing.
    """
    nl = blob.find(b"\n")
    if nl < 0:
        raise CheckpointIntegrityError(
            f"shard {origin!r} has no header line (torn or foreign file)"
        )
    try:
        header = json.loads(blob[:nl].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointIntegrityError(
            f"shard {origin!r} header is not JSON: {e}"
        ) from e
    data = blob[nl + 1:]
    rank, step = header.get("rank"), header.get("step")
    if len(data) != header.get("nbytes"):
        raise CheckpointIntegrityError(
            f"shard {origin!r} (rank {rank}, step {step}) payload is "
            f"{len(data)} bytes but the header framed "
            f"{header.get('nbytes')} (torn write)",
            rank=rank, step=step,
            expected=header.get("nbytes"), got=len(data),
        )
    crc = zlib.crc32(data) & 0xFFFFFFFF
    if crc != header.get("crc"):
        raise CheckpointIntegrityError(
            f"shard {origin!r} (rank {rank}, step {step}): payload "
            f"hashes to {crc:#010x} but the header framed "
            f"{header.get('crc'):#010x} (corrupted at rest)",
            rank=rank, step=step, expected=header.get("crc"), got=crc,
        )
    return rank, step, _decode_payload(data, header), crc


def write_shard(directory: str, rank: int, step: int,
                payload) -> Tuple[str, int]:
    """Write one CRC-framed shard atomically; returns its filename and
    the framed CRC (so the manifest can quote it without re-encoding
    the payload)."""
    blob, crc = pack_shard(rank, step, payload)
    name = shard_name(rank, step)
    write_atomic(os.path.join(directory, name), blob)
    return name, crc


def read_shard(path: str):
    """Read + verify one shard; returns ``(rank, step, payload, crc)``
    (``crc`` is the framed checksum, for callers holding an external
    record of what this shard should be — the manifest).

    Raises :class:`CheckpointIntegrityError` on a CRC or length
    mismatch — a damaged shard names itself instead of deserializing.
    """
    with open(path, "rb") as f:
        blob = f.read()
    return unpack_shard(blob, origin=path)


# ---------------------------------------------------------------------------
# Manifests + the store
# ---------------------------------------------------------------------------

_MANIFEST_RE = re.compile(r"^manifest-(\d+)\.json$")


@dataclasses.dataclass
class Manifest:
    """One complete checkpoint's table of contents."""

    step: int
    epoch: int
    shards: Dict[int, Dict]  # rank -> {"file": ..., "crc": ...}

    def to_json(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "step": self.step,
            "epoch": self.epoch,
            "shards": {str(r): s for r, s in sorted(self.shards.items())},
        }

    @staticmethod
    def from_json(payload: object, path: str) -> "Manifest":
        if not isinstance(payload, dict):
            raise CheckpointError(
                f"manifest {path!r} must be a JSON object"
            )
        version = payload.get("schema_version")
        if version != SCHEMA_VERSION:
            raise CheckpointError(
                f"manifest {path!r} schema_version {version!r} does "
                f"not match this build's {SCHEMA_VERSION}; refusing to "
                f"reinterpret checkpoint layout across schema changes"
            )
        shards = payload.get("shards")
        if not isinstance(shards, dict) or not shards:
            raise CheckpointError(
                f"manifest {path!r} has no shard table"
            )
        return Manifest(
            step=int(payload["step"]),
            epoch=int(payload.get("epoch", 0)),
            shards={int(r): dict(s) for r, s in shards.items()},
        )


class CheckpointStore:
    """A directory of CRC-framed shards + atomic versioned manifests."""

    def __init__(self, directory: str, keep: int = 2):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep

    def save(self, step: int, shards: Dict[int, object],
             epoch: int = 0) -> str:
        """Persist one complete checkpoint: all shards first, the
        manifest last (its rename is the commit point). Returns the
        manifest path. Old checkpoints beyond ``keep`` are pruned
        after the new manifest is durable."""
        if not shards:
            raise CheckpointError("refusing to checkpoint zero shards")
        table: Dict[int, Dict] = {}
        for rank in sorted(shards):
            name, crc = write_shard(self.directory, rank, step,
                                    shards[rank])
            table[rank] = {"file": name, "crc": crc}
        manifest = Manifest(step=step, epoch=epoch, shards=table)
        path = os.path.join(self.directory, f"manifest-{step:08d}.json")
        write_atomic(
            path, (json.dumps(manifest.to_json(), indent=2,
                              sort_keys=True) + "\n").encode(),
        )
        self._prune()
        return path

    def manifests(self) -> List[str]:
        """Manifest paths, newest step first."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        found = []
        for name in names:
            m = _MANIFEST_RE.match(name)
            if m:
                found.append((int(m.group(1)), name))
        return [
            os.path.join(self.directory, name)
            for _, name in sorted(found, reverse=True)
        ]

    def restore(self) -> Optional[Tuple[int, Dict[int, object], int]]:
        """``(step, shards, epoch)`` from the latest manifest whose
        shards all exist and verify; None when no checkpoint is
        complete. An incomplete or damaged newest checkpoint falls
        back to the previous one — the SCR recovery rule. Two kinds of
        shard trouble are distinguished: a shard that fails its OWN
        framed CRC is bit rot and is raised, never skipped; a shard
        that self-verifies but does not match the CRC the manifest
        recorded belongs to a *different generation* of the same step
        (an interrupted re-save overwrote it after the manifest
        committed) — that manifest is incomplete, and restore falls
        back rather than silently mixing generations."""
        for path in self.manifests():
            try:
                with open(path) as f:
                    manifest = Manifest.from_json(json.load(f), path)
            except (OSError, json.JSONDecodeError):
                continue  # torn manifest never renamed in: not a commit
            shards: Dict[int, object] = {}
            complete = True
            for rank, entry in manifest.shards.items():
                spath = os.path.join(self.directory, entry["file"])
                if not os.path.exists(spath):
                    complete = False
                    break
                srank, sstep, payload, crc = read_shard(spath)
                if srank != rank or sstep != manifest.step:
                    raise CheckpointIntegrityError(
                        f"shard {spath!r} frames (rank {srank}, step "
                        f"{sstep}) but manifest {path!r} expects "
                        f"(rank {rank}, step {manifest.step})",
                        rank=rank, step=manifest.step,
                        expected=(rank, manifest.step),
                        got=(srank, sstep),
                    )
                if crc != entry.get("crc"):
                    # self-consistent shard, wrong generation: an
                    # interrupted re-save of this step overwrote it —
                    # the manifest no longer describes a complete
                    # checkpoint
                    complete = False
                    break
                shards[rank] = payload
            if complete:
                return manifest.step, shards, manifest.epoch
        return None

    def latest_step(self) -> Optional[int]:
        restored = self.restore()
        return None if restored is None else restored[0]

    def _prune(self) -> None:
        for path in self.manifests()[self.keep:]:
            try:
                with open(path) as f:
                    manifest = Manifest.from_json(json.load(f), path)
                for entry in manifest.shards.values():
                    try:
                        os.unlink(
                            os.path.join(self.directory, entry["file"])
                        )
                    except OSError:
                        pass
                os.unlink(path)
            except (OSError, json.JSONDecodeError, CheckpointError):
                pass  # pruning is best-effort; restore stays correct


# ---------------------------------------------------------------------------
# Iterative drivers
# ---------------------------------------------------------------------------


def run_iterative(
    state,
    step_fn: Callable,
    iterations: int,
    store: Optional[CheckpointStore] = None,
    cadence: int = DEFAULT_CADENCE,
    shard_fn: Optional[Callable] = None,
    unshard_fn: Optional[Callable] = None,
    resume: bool = True,
    epoch: Optional[int] = None,
):
    """Run ``state = step_fn(state)`` for ``iterations`` steps with
    periodic sharded checkpoints.

    ``shard_fn(state) -> {rank: payload}`` splits the state for the
    store and ``unshard_fn(shards) -> state`` reassembles it (both
    default to a single rank-0 shard). With ``resume`` and a complete
    manifest in the store, the run restores the latest checkpointed
    state and **replays only the tail** — iteration ``k`` of a resumed
    run applies the same ``step_fn`` to the same state as iteration
    ``k`` of an uninterrupted run, so results are bit-identical.
    ``epoch`` stamps the manifests; when omitted, a resumed run keeps
    the restored manifest's epoch (the membership audit field must not
    regress to 0 just because the resuming caller did not restate it).
    Returns ``(state, start_iteration)``.
    """
    if cadence < 1:
        raise ValueError(f"cadence must be >= 1, got {cadence}")
    shard_fn = shard_fn or (lambda s: {0: s})
    unshard_fn = unshard_fn or (lambda shards: shards[0])
    start = 0
    if store is not None and resume:
        restored = store.restore()
        if restored is not None:
            start, shards, saved_epoch = restored
            if start > iterations:
                raise CheckpointError(
                    f"checkpoint is at iteration {start} but the run "
                    f"only asks for {iterations}"
                )
            state = unshard_fn(shards)
            if epoch is None:
                epoch = saved_epoch
    epoch = 0 if epoch is None else epoch
    if store is not None and start == 0:
        store.save(0, shard_fn(state), epoch=epoch)
    for it in range(start, iterations):
        state = step_fn(state)
        done = it + 1
        if store is not None and (
            done % cadence == 0 or done == iterations
        ):
            store.save(done, shard_fn(state), epoch=epoch)
    return state, start


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        value = int(raw)
    except ValueError as e:
        raise CheckpointError(
            f"${name}={raw!r} is not an integer"
        ) from e
    if value < 1:
        raise CheckpointError(f"${name}={value} must be >= 1")
    return value


def elastic_env_config() -> Optional[Dict]:
    """The env-driven elastic configuration, or None when disabled.

    ``$SMI_TPU_CHECKPOINT_DIR`` enables checkpointing for the
    iterative drivers and the bench provenance field;
    ``$SMI_TPU_CHECKPOINT_CADENCE`` overrides :data:`DEFAULT_CADENCE`.
    Malformed values raise loudly (:class:`CheckpointError`) — a typo
    must not silently disable durability.
    """
    directory = os.environ.get(DIR_ENV, "").strip()
    if not directory:
        return None
    from smi_tpu_torch.parallel import membership as M

    return {
        "dir": directory,
        "cadence": _env_int(CADENCE_ENV) or DEFAULT_CADENCE,
        "detector": {
            "suspect_phi": M.SUSPECT_PHI,
            "dead_phi": M.DEAD_PHI,
            "heartbeat_interval": M.HEARTBEAT_INTERVAL,
            "confirm_grace_ticks": M.CONFIRM_GRACE_TICKS,
        },
    }


def run_jacobi(
    grid,
    iterations: int,
    comm=None,
    store: Optional[CheckpointStore] = None,
    cadence: int = DEFAULT_CADENCE,
    px: int = 2,
    py: int = 4,
    device=None,
):
    """The Jacobi model under the checkpointing driver.

    One sweep of the port's stencil (``models.stencil.make_stencil_fn(
    comm, 1)``) per iteration; the grid is sharded into the store one
    row-band per process-grid row, as in the JAX package. ``comm`` is a
    :class:`~smi_tpu_torch.parallel.local.LocalWorld` (every rank a
    thread on one device; the default is the ``(px, py)`` world
    ``("sx", "sy")`` on ``device``) or a one-rank ``(1, 1)``
    communicator. A crash at iteration *i* restores from the latest
    complete manifest and replays only the tail — bit-identical to the
    uninterrupted run, because every iteration is the same sweep applied
    to the same state. Returns the global grid, a float32 tensor on the
    device.
    """
    import numpy as np
    import torch

    from smi_tpu_torch.models.stencil import make_stencil_fn
    from smi_tpu_torch.parallel.local import LocalWorld

    if comm is None:
        comm = LocalWorld((px, py), ("sx", "sy"), device=device)
    world = comm if isinstance(comm, LocalWorld) else None
    if world is None and comm.size != 1:
        raise ValueError(
            f"run_jacobi drives a LocalWorld or a one-rank communicator; "
            f"got a {comm.shape} grid of processes"
        )
    px, py = tuple(comm.shape)
    dev = comm.device
    host = np.asarray(grid.cpu() if torch.is_tensor(grid) else grid,
                      dtype=np.float32)
    rows, cols = host.shape
    if rows % px or cols % py:
        raise ValueError(
            f"grid {host.shape} not divisible by process grid {(px, py)}"
        )
    band, width = rows // px, cols // py

    def blocks_of(bands):
        """Row-major blocks (one a rank) of the bands, on the device."""
        return [torch.from_numpy(np.ascontiguousarray(
            bands[r][:, c * width:(c + 1) * width])).to(dev)
            for r in range(px) for c in range(py)]

    def shard(blocks):
        return {r: torch.cat(blocks[r * py:(r + 1) * py], dim=1)
                for r in range(px)}

    def unshard(shards):
        return blocks_of([np.asarray(shards[r]) for r in range(px)])

    if world is None:
        sweep = make_stencil_fn(comm, 1)

        def step(blocks):
            return [sweep(blocks[0])]
    else:
        sweeps = [make_stencil_fn(c, 1) for c in world.comms]

        def step(blocks):
            return world.run(lambda c: sweeps[c.rank](blocks[c.rank]))

    state, _start = run_iterative(
        blocks_of([host[r * band:(r + 1) * band] for r in range(px)]),
        step, iterations, store=store, cadence=cadence, shard_fn=shard,
        unshard_fn=unshard,
    )
    return torch.cat([b for b in shard(state).values()], dim=0)


def run_kmeans(
    points,
    init_means,
    iterations: int,
    comm=None,
    store: Optional[CheckpointStore] = None,
    cadence: int = DEFAULT_CADENCE,
    device=None,
    backend: str = "xla",
):
    """The K-means model under the checkpointing driver.

    The iterated state is the replicated means (the points are static
    input); one update of the port's model (``models.kmeans.
    make_kmeans_fn(world, 1)``) per iteration, the means checkpointed as
    the rank-0 shard. ``comm`` is a
    :class:`~smi_tpu_torch.parallel.local.LocalWorld` or a rank of one
    (the default is 8 ranks on ``device``); ``backend="ring"`` runs the
    model's collectives on the ring kernels. Crash/restore replays only
    the tail, bit-identically. Returns the means, a tensor on the
    world's device.
    """
    import numpy as np
    import torch

    from smi_tpu_torch.models.kmeans import make_kmeans_fn
    from smi_tpu_torch.parallel.local import LocalWorld

    if comm is None:
        world = LocalWorld(8, device=device)
    else:
        world = (comm if isinstance(comm, LocalWorld)
                 else getattr(comm, "world", None))
    if world is None:
        raise ValueError(
            "run_kmeans drives a LocalWorld (or a rank of one); got a "
            "rank of a grid of processes"
        )
    pts = torch.as_tensor(np.asarray(points)).to(world.device)
    if pts.shape[0] % world.size:
        raise ValueError(
            f"point count {pts.shape[0]} not divisible by {world.size} "
            f"ranks"
        )
    fn = make_kmeans_fn(world, 1, backend=backend)

    state, _start = run_iterative(
        torch.as_tensor(np.asarray(init_means)).to(world.device),
        lambda means: fn(pts, means),
        iterations,
        store=store,
        cadence=cadence,
        shard_fn=lambda m: {0: m},
        unshard_fn=lambda shards: torch.from_numpy(
            np.asarray(shards[0])).to(world.device),
    )
    return state
