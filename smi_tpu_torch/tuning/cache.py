"""Persistent plan cache: versioned JSON, schema-validated, mergeable.

The port's copy of :mod:`smi_tpu.tuning.cache`, with the same schema
and the same :data:`CACHE_ENV`, so a cache file written by either
package loads in the other with equal entries. The ATLAS half of the
plan engine (PAPERS.md): measured-best configs survive the process that
measured them. One cache file holds entries for any number of device
kinds/topologies (the key carries both), so one file can serve a TPU
fleet and an H100 host without one shadowing the other:

- **versioned** — ``schema_version`` is checked on load; a mismatch is
  a loud :class:`PlanCacheError`, never a silent reinterpretation of
  old knobs under new semantics.
- **schema-validated** — every entry must carry a knob dict and a
  well-formed cost; junk entries name themselves on load.
- **mergeable** — :meth:`PlanCache.merge` keeps, per key, the entry
  with the *better measured cost* (lower ``cost_us``); a measured
  entry always beats an unmeasured one, and between two unmeasured
  entries the incoming one wins (newer sweep metadata).

Cost unit is microseconds-per-op (lower is better) — the one scalar
every sweep and the analytic model both speak, so merge order is total.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, Optional

from smi_tpu_torch.tuning.plan import PlanKey

SCHEMA_VERSION = 1

#: Environment variable naming the user's persistent cache file; the
#: engine merges it over the shipped seeded cache at load.
CACHE_ENV = "SMI_TPU_PLAN_CACHE"


class PlanCacheError(ValueError):
    """Malformed or version-mismatched plan-cache payload."""


@dataclasses.dataclass
class CacheEntry:
    """Measured-best knobs for one :class:`PlanKey`."""

    knobs: Dict[str, object]
    cost_us: Optional[float] = None     # lower is better; None = seeded
    provenance: str = ""                # e.g. "sweep:2026-08-03" or
    #                                     "seeded:PERF.json:<metric>" or
    #                                     "live:retune:samples=N:..."
    #: Monotonic staleness counter, bumped on every online swap
    #: install (:meth:`smi_tpu_torch.tuning.swap.PlanSwap.swap`). A higher
    #: revision ALWAYS wins a merge regardless of measured cost: a
    #: late-arriving offline sweep (revision 0, possibly with a
    #: better-looking ``cost_us`` measured under yesterday's traffic)
    #: can no longer silently resurrect a plan the live tuner just
    #: retired. Revision-0 vs revision-0 keeps the original
    #: best-measured-cost merge rules byte-for-byte.
    revision: int = 0

    def better_than(self, other: Optional["CacheEntry"]) -> bool:
        if other is None:
            return True
        if self.revision != other.revision:
            # staleness outranks cost: the live tuner's bumped
            # revision reflects the CURRENT traffic; the older
            # revision's measurement, however good, priced a
            # distribution that no longer exists
            return self.revision > other.revision
        if self.cost_us is None:
            # unmeasured never displaces measured; vs unmeasured the
            # incoming entry wins (merge order: other.merge(self))
            return other.cost_us is None
        if other.cost_us is None:
            return True
        return self.cost_us < other.cost_us

    def to_json(self) -> dict:
        out: dict = {"knobs": dict(self.knobs)}
        if self.cost_us is not None:
            out["cost_us"] = self.cost_us
        if self.provenance:
            out["provenance"] = self.provenance
        if self.revision:
            # absent when 0: pre-revision cache files stay byte-stable
            out["revision"] = self.revision
        return out

    @staticmethod
    def from_json(sig: str, payload: object) -> "CacheEntry":
        if not isinstance(payload, dict) or not isinstance(
            payload.get("knobs"), dict
        ):
            raise PlanCacheError(
                f"plan-cache entry {sig!r} is not "
                f"{{'knobs': {{...}}, ...}}: {payload!r}"
            )
        cost = payload.get("cost_us")
        if cost is not None and not isinstance(cost, (int, float)):
            raise PlanCacheError(
                f"plan-cache entry {sig!r} has non-numeric cost_us "
                f"{cost!r}"
            )
        revision = payload.get("revision", 0)
        if (not isinstance(revision, int) or isinstance(revision, bool)
                or revision < 0):
            raise PlanCacheError(
                f"plan-cache entry {sig!r} has a malformed revision "
                f"{revision!r} (want an integer >= 0)"
            )
        return CacheEntry(
            knobs=dict(payload["knobs"]),
            cost_us=None if cost is None else float(cost),
            provenance=str(payload.get("provenance", "")),
            revision=revision,
        )


@dataclasses.dataclass
class PlanCache:
    entries: Dict[str, CacheEntry] = dataclasses.field(default_factory=dict)

    def lookup(self, key: PlanKey) -> Optional[CacheEntry]:
        return self.entries.get(key.signature())

    def put(self, key: PlanKey, entry: CacheEntry,
            keep_best: bool = True) -> bool:
        """Insert; with ``keep_best`` an existing better-measured entry
        survives. Returns whether ``entry`` landed."""
        sig = key.signature()
        if keep_best and not entry.better_than(self.entries.get(sig)):
            return False
        self.entries[sig] = entry
        return True

    def merge(self, other: "PlanCache") -> "PlanCache":
        """Per-key best-measured union of two caches (see module doc
        for the tie rules). Returns ``self`` for chaining."""
        for sig, entry in other.entries.items():
            if entry.better_than(self.entries.get(sig)):
                self.entries[sig] = entry
        return self

    # -- serialization --------------------------------------------------
    def to_json(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "entries": {
                sig: e.to_json() for sig, e in sorted(self.entries.items())
            },
        }

    @staticmethod
    def from_json(payload: object) -> "PlanCache":
        if not isinstance(payload, dict):
            raise PlanCacheError(
                f"plan cache must be a JSON object, got "
                f"{type(payload).__name__}"
            )
        version = payload.get("schema_version")
        if version != SCHEMA_VERSION:
            raise PlanCacheError(
                f"plan-cache schema_version {version!r} does not match "
                f"this build's {SCHEMA_VERSION}; refusing to "
                f"reinterpret tuned knobs across schema changes — "
                f"re-run `smi-tpu tune` to regenerate the cache"
            )
        raw = payload.get("entries", {})
        if not isinstance(raw, dict):
            raise PlanCacheError("plan-cache 'entries' must be an object")
        entries = {}
        for sig, e in raw.items():
            PlanKey.from_signature(sig)   # validates key shape loudly
            entries[sig] = CacheEntry.from_json(sig, e)
        return PlanCache(entries=entries)

    def save(self, path: str) -> str:
        """Write the cache crash-safely: temp file + fsync + atomic
        rename (:func:`_write_atomic`), so a crash mid-save leaves the
        previous cache intact — a fleet host can never load a
        half-written entries table as its tuning truth."""
        payload = json.dumps(self.to_json(), indent=2, sort_keys=True)
        _write_atomic(path, (payload + "\n").encode())
        return path

    @staticmethod
    def load(path: str) -> "PlanCache":
        with open(path) as f:
            try:
                payload = json.load(f)
            except json.JSONDecodeError as e:
                raise PlanCacheError(
                    f"plan cache {path!r} is not valid JSON: {e}"
                ) from e
        return PlanCache.from_json(payload)


def _write_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via temp file + fsync + rename (the
    JAX package's ``parallel/checkpoint.write_atomic``)."""
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


def default_cache_path() -> Optional[str]:
    """The user cache file: $SMI_TPU_PLAN_CACHE when set, else the
    conventional per-user location."""
    env = os.environ.get(CACHE_ENV, "").strip()
    if env:
        return env
    home = os.path.expanduser("~")
    if home and home != "/":
        return os.path.join(home, ".cache", "smi_tpu", "plans.json")
    return None
