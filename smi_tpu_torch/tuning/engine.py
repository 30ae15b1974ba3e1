"""The plan engine: cache -> analytic model -> heuristic, never erroring.

The port's copy of :mod:`smi_tpu.tuning.engine`, name for name. One
object answers every "which knob value here?" question the collectives
and kernels used to answer with frozen constants. Resolution order per
knob:

1. **cache** — a measured entry in the persistent plan cache (the
   shipped seeded cache, :mod:`smi_tpu_torch.tuning.seeded`, merged
   with the user's ``$SMI_TPU_PLAN_CACHE`` file). Measurement always has
   the last word: on an H100 the seeded entries are the card's own
   sweeps.
2. **model** — the deterministic alpha-beta / roofline ranking
   (:mod:`smi_tpu_torch.tuning.cost_model`, v5e prices that only rank).
   It decides only where it is *confident* (payload at least
   :data:`RS_AG_MODEL_MARGIN` x away from its own crossover) and only
   when no explicit threshold override (env or cache) is in force.
3. **heuristic** — the frozen defaults (``RS_AG_MIN_BYTES``, flat,
   dense, pairwise, ``chunks=1``; the kernels' own tile plans).

Consultation goes through the ``planned_*`` module functions, which
swallow *every* exception into the heuristic answer — a corrupt cache
file costs tuning, never a call.

The engine is process-global (:func:`get_engine`) and shared by the rank
threads of a :class:`~smi_tpu_torch.parallel.local.LocalWorld`: every
rank consults it separately, so a rank that branched differently would
deadlock the rendezvous. Its memo is read, computed and written under
one lock, so every rank gets the one answer the first consult stored.
Tests swap the engine with :func:`set_engine` and restore with
``set_engine(None)``. Device kinds come from
``torch.cuda.get_device_name`` (``"cpu"`` without CUDA, the JAX
package's CPU kind), and dtypes are keyed by their JAX names
(:func:`dtype_name`), so both packages read one cache file alike.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Dict, Optional, Tuple

from smi_tpu_torch.tuning import cost_model as cm
from smi_tpu_torch.tuning.cache import CACHE_ENV, PlanCache, default_cache_path
from smi_tpu_torch.tuning.plan import (
    Candidate,
    Plan,
    PlanKey,
    normalize_device_kind,
    payload_bucket,
)
from smi_tpu_torch.tuning.seeded import seeded_cache

#: Model-confidence margin for call-time algorithm decisions: the
#: model may decide only when the payload is at least this factor away
#: from its own ring/rs+ag crossover. Inside the band the measured
#: threshold default decides. With the calibrated DEFAULT_ALPHA_S the
#: confident decisions provably agree with the 1 MiB heuristic, so
#: enabling the model layer cannot change an untuned program.
RS_AG_MODEL_MARGIN = 4.0

#: Model-confidence margin for the two-tier gate: the model may engage
#: (or veto) the hierarchical form only when its modeled advantage over
#: the best flat form is at least this factor (either direction).
#: Inside the band the conservative answer — today's flat path — wins
#: until a sweep has measured the crossover. Single-slice topologies
#: are never eligible at all, which is what keeps the untuned
#: single-slice byte-identity invariant trivially intact.
HIER_MODEL_MARGIN = 4.0

#: Model-confidence margin for the all-to-all algorithm gate (same
#: discipline): an unmeasured model ranking may pick Bruck or the
#: two-tier form only when its modeled advantage over the pairwise
#: default is at least this factor. Inside the band the fused
#: pairwise all-to-all runs — at the pinned n=8 acceptance shape
#: the pairwise/Bruck ratio is (n-1)/log2(n) ~ 2.3, inside the band,
#: so an untuned call runs the explicit pairwise form.
ALLTOALL_MODEL_MARGIN = 4.0


def dtype_name(dtype) -> str:
    """The cache's name of a dtype: the JAX package's (``"float32"``,
    ``"bfloat16"``, ``"int8"``), never ``str(torch.float32)``'s
    ``"torch.float32"``, which no cache entry would match."""
    return str(dtype).removeprefix("torch.")


def _valid_flash_block(v) -> bool:
    """A flash tile target the kernels can actually use: a positive
    multiple of the widest sublane tile (16 rows bf16), bounded well
    above any real extent. Anything else is value-junk that would make
    ``_pick_block`` find no divisor and fail the call (kept from the
    JAX package; the port's flash kernels further take only the pair
    they compile)."""
    return (
        isinstance(v, int) and not isinstance(v, bool)
        and 16 <= v <= (1 << 16) and v % 16 == 0
    )


def _collective_topology(topo: cm.TopologySpec) -> str:
    if topo.hierarchical_eligible:
        return f"n{topo.n}:dcn{topo.outer}"
    return f"n{topo.n}"


def cache_entry_layer(entry) -> str:
    """The explain-surface layer of a cache hit: ``"live"`` when the
    entry was written by the online retuner (its ``live:`` provenance
    names the sample count and win margin — the env -> cache -> live
    -> model -> heuristic ladder), else ``"cache"``."""
    provenance = str(getattr(entry, "provenance", "") or "")
    return "live" if provenance.startswith("live:") else "cache"


def _cache_hit_rationale(hit) -> Tuple[str, str]:
    """(layer, rationale line) for one algorithm cache hit — the ONE
    rendering both collective plan surfaces share, so the live-tier
    presentation cannot drift between them."""
    layer = cache_entry_layer(hit)
    if layer == "live":
        # an online-won entry names its sample count and win margin
        # (the provenance the retuner stamped at swap)
        return layer, (f"live retune entry ({hit.provenance}, "
                       f"revision {hit.revision})")
    return layer, (
        f"cache entry ({hit.provenance or 'measured sweep'}"
        + (f", {hit.cost_us:.1f} us" if hit.cost_us is not None
           else "") + ")"
    )


class PlanEngine:
    def __init__(
        self,
        cache: Optional[PlanCache] = None,
        link: Optional[cm.LinkModel] = None,
        device_kind: Optional[str] = None,
    ):
        self.cache = cache if cache is not None else _load_default_cache()
        self.link = link or cm.LinkModel()
        self._device_kind = (
            normalize_device_kind(device_kind) if device_kind else None
        )
        self._memo: Dict[tuple, object] = {}
        # re-entrant: a compute may consult another memoized knob
        self._lock = threading.RLock()

    # -- device identity -------------------------------------------------
    def device_kind(self) -> str:
        """Normalized local device kind (lazy; ``"unknown"`` when no
        backend is reachable — such hosts simply never hit seeded
        device-keyed entries)."""
        if self._device_kind is None:
            self._device_kind = _detect_device_kind()
        return self._device_kind

    def _memoized(self, key: tuple, compute):
        # under the lock throughout: concurrent rank threads asking the
        # same question all get the one stored answer
        with self._lock:
            if key in self._memo:
                return self._memo[key]
            value = compute()
            if len(self._memo) >= 4096:   # memo bound
                self._memo.clear()
            self._memo[key] = value
            return value

    # -- collectives -----------------------------------------------------
    def allreduce_plan(
        self,
        payload_bytes: int,
        topo: cm.TopologySpec,
        dtype: str = "float32",
        device_kind: Optional[str] = None,
    ) -> Plan:
        """Full (algorithm, chunks) plan for an ADD allreduce — the
        ``tune``/``--explain`` entry: the model ranking is applied
        outright when no cache entry exists (the deterministic-CPU
        acceptance surface; the *call-time* gate is
        :meth:`use_rs_ag`)."""
        dk = normalize_device_kind(device_kind or self.device_kind())
        key = PlanKey("all_reduce", payload_bucket(payload_bytes), dtype,
                      dk, _collective_topology(topo))
        cands = cm.allreduce_candidates(payload_bytes, topo,
                                        link=self.link)
        knobs: Dict[str, object] = {}
        decided: Dict[str, str] = {}
        rationale = []
        hit = self.cache.lookup(key)
        if hit is not None and "algorithm" in hit.knobs:
            layer, why = _cache_hit_rationale(hit)
            knobs["algorithm"] = hit.knobs["algorithm"]
            decided["algorithm"] = layer
            rationale.append(why)
            cands = [
                Candidate(c.name, c.knobs, c.modeled_us,
                          hit.cost_us if c.knobs.get("algorithm")
                          == hit.knobs["algorithm"] else None, c.note)
                for c in cands
            ]
        else:
            knobs["algorithm"] = cands[0].knobs["algorithm"]
            decided["algorithm"] = "model"
            xover = cm.rs_ag_crossover_bytes(topo.n, self.link)
            rationale.append(
                f"alpha-beta ranking (ring/rs+ag crossover at "
                f"{xover:.0f} B for n={topo.n})"
            )
        chunks, chunks_layer = self.collective_chunks(
            "all_reduce", payload_bytes, topo.n, dtype, device_kind=dk
        )
        knobs["chunks"] = chunks
        decided["chunks"] = chunks_layer
        threshold, thr_layer = self.rs_ag_threshold(device_kind=dk)
        knobs["rs_ag_min_bytes"] = threshold
        decided["rs_ag_min_bytes"] = thr_layer
        if topo.hierarchical_eligible:
            hier, hier_layer = self.use_hierarchical(
                payload_bytes, topo, dtype
            )
            knobs["hierarchical"] = hier
            decided["hierarchical"] = hier_layer
            thr = self.hier_threshold(topo.outer or 0)
            if thr is not None:
                rationale.append(
                    f"two-tier gate: measured flat/hierarchical "
                    f"crossover at {thr[0]} B for dcn{topo.outer} "
                    f"(plan cache)"
                )
            else:
                advantage = cm.hierarchical_advantage(
                    payload_bytes, topo, link=self.link
                )
                rationale.append(
                    f"two-tier gate: modeled advantage "
                    f"{advantage:.2f}x over best flat (engages "
                    f"outside the {HIER_MODEL_MARGIN:g}x confidence "
                    f"band only)"
                )
        pcands = cm.allreduce_precision_candidates(
            payload_bytes, topo, dtype=dtype, link=self.link
        )
        p, p_layer = self.use_precision(payload_bytes, topo, dtype)
        if (hit is not None and "precision" in hit.knobs
                and p == str(hit.knobs["precision"])):
            pcands = cm.CandidateSet(
                [
                    Candidate(c.name, c.knobs, c.modeled_us,
                              hit.cost_us if c.name == p else None,
                              c.note)
                    for c in pcands
                ],
                pcands.excluded,
            )
        knobs["precision"] = p
        decided["precision"] = p_layer
        if p_layer in ("model", "heuristic"):
            rationale.append(
                f"wire precision: dense f32 — the model may propose a "
                f"lossy width only past "
                f"{cm.PRECISION_MODEL_MARGIN:g}x modeled advantage, "
                f"a bar the byte ratio alone cannot clear; int8/topk "
                f"reach the auto path through a measured sweep "
                f"crossover or an explicit pin"
            )
        for dropped in pcands.excluded:
            rationale.append(
                f"excluded {dropped.name}: {dropped.note}"
            )
        cands = list(cands) + list(pcands)
        return Plan(key=key, knobs=knobs, decided_by=decided,
                    candidates=cands, rationale=rationale)

    def rs_ag_threshold(
        self, device_kind: Optional[str] = None
    ) -> Tuple[int, str]:
        """(bytes, layer) of the rs+ag switch tier: plan-cache entry
        when one exists, else the built-in heuristic constant. The env
        override (``SMI_TPU_RS_AG_MIN_BYTES``) is applied by the
        caller (``collectives.rs_ag_min_bytes``) — an explicit user
        setting outranks every engine layer."""
        dk = normalize_device_kind(device_kind or self.device_kind())

        def compute():
            for kind in (dk, "unknown"):
                hit = self.cache.lookup(
                    PlanKey("all_reduce", "threshold", "", kind, "any")
                )
                if hit is not None and "rs_ag_min_bytes" in hit.knobs:
                    return int(hit.knobs["rs_ag_min_bytes"]), "cache"
            from smi_tpu_torch.parallel.collectives import RS_AG_MIN_BYTES

            return int(RS_AG_MIN_BYTES), "heuristic"

        return self._memoized(("rs_ag_threshold", dk), compute)

    def use_rs_ag(
        self,
        payload_bytes: int,
        topo: cm.TopologySpec,
        dtype: str = "float32",
        threshold: Optional[int] = None,
        threshold_layer: str = "env",
    ) -> Tuple[bool, str]:
        """Call-time algorithm gate for an *eligible* ADD allreduce.

        ``threshold`` given = an explicit override (env var) — it
        decides ALONE: not even a measured cache entry may outrank the
        operator's word (the env path exists precisely to pin the
        bit-exact single-psum form regardless of what a sweep found).
        Otherwise: per-bucket cache entry, then the model where
        confident, then the resolved threshold tier.
        """
        dk = self.device_kind()

        def compute():
            if threshold is not None:
                return payload_bytes >= threshold, threshold_layer
            key = PlanKey("all_reduce", payload_bucket(payload_bytes),
                          dtype, dk, _collective_topology(topo))
            hit = self.cache.lookup(key)
            if hit is not None and "algorithm" in hit.knobs:
                return hit.knobs["algorithm"] == "rs_ag", "cache"
            thr, thr_layer = self.rs_ag_threshold()
            if thr_layer == "heuristic":
                # no explicit tier in force: the model decides where
                # it is confidently away from its own crossover
                xover = cm.rs_ag_crossover_bytes(topo.n, self.link)
                if payload_bytes >= RS_AG_MODEL_MARGIN * xover:
                    return True, "model"
                if payload_bytes <= xover / RS_AG_MODEL_MARGIN:
                    return False, "model"
            return payload_bytes >= thr, thr_layer

        # exact bytes, not the bucket: the threshold/model comparisons
        # are exact, so a bucket-wide memo would be first-call-wins
        # for payloads straddling a crossover inside one bucket
        return self._memoized(
            ("use_rs_ag", payload_bytes, topo, dtype,
             threshold, threshold_layer, dk),
            compute,
        )

    def hier_threshold(
        self, outer: int, device_kind: Optional[str] = None
    ) -> Optional[Tuple[int, str]]:
        """(bytes, "cache") of the measured flat/hierarchical
        crossover for an ``outer``-slice pod, or ``None`` when no
        sweep has persisted one. Written by
        ``sweep.sweep_allreduce_hierarchical`` per (device kind,
        slice count) — the ATLAS discipline: the crossover is a
        measured artifact, not a frozen constant."""
        dk = normalize_device_kind(device_kind or self.device_kind())

        def compute():
            for kind in (dk, "unknown"):
                hit = self.cache.lookup(
                    PlanKey("all_reduce", "hier_threshold", "", kind,
                            f"dcn{outer}")
                )
                if hit is not None and "hier_min_bytes" in hit.knobs:
                    return int(hit.knobs["hier_min_bytes"]), "cache"
            return None

        return self._memoized(("hier_threshold", outer, dk), compute)

    def use_hierarchical(
        self,
        payload_bytes: int,
        topo: cm.TopologySpec,
        dtype: str = "float32",
        min_slices: Optional[int] = None,
        min_slices_layer: str = "env",
    ) -> Tuple[bool, str]:
        """Call-time gate for the two-tier allreduce on an *eligible*
        payload (ADD, hybrid multi-slice communicator, divisible
        leading dim — structural eligibility is the caller's check).

        ``min_slices`` given = the explicit ``$SMI_TPU_HIER_MIN_SLICES``
        override — it decides ALONE (not even a measured cache entry
        outranks the operator's word), mirroring the rs+ag env
        semantics. Otherwise: per-bucket cache entry, then the
        measured crossover threshold, then the model where its
        advantage is confidently (:data:`HIER_MODEL_MARGIN`) away
        from parity, then the conservative flat default.
        """
        dk = self.device_kind()

        def compute():
            if not topo.hierarchical_eligible:
                return False, "heuristic"
            if min_slices is not None:
                return (topo.outer or 0) >= min_slices, min_slices_layer
            key = PlanKey("all_reduce", payload_bucket(payload_bytes),
                          dtype, dk, _collective_topology(topo))
            hit = self.cache.lookup(key)
            if hit is not None and "algorithm" in hit.knobs:
                return hit.knobs["algorithm"] == "hierarchical", "cache"
            thr = self.hier_threshold(topo.outer or 0)
            if thr is not None:
                return payload_bytes >= thr[0], "cache"
            advantage = cm.hierarchical_advantage(
                payload_bytes, topo, link=self.link
            )
            if advantage >= HIER_MODEL_MARGIN:
                return True, "model"
            if advantage and advantage <= 1.0 / HIER_MODEL_MARGIN:
                return False, "model"
            return False, "heuristic"

        # keyed on EXACT bytes: the threshold/model branches compare
        # exact payloads, so a bucket-wide memo would be
        # first-call-wins for every other payload in the bucket
        return self._memoized(
            ("use_hier", payload_bytes, topo, dtype,
             min_slices, min_slices_layer, dk),
            compute,
        )

    def precision_threshold(
        self, outer: int, device_kind: Optional[str] = None
    ) -> Optional[Tuple[int, str, str]]:
        """(bytes, precision, "cache") of the measured dense/lossy
        wire-width crossover for an ``outer``-slice pod (0 = flat), or
        ``None`` when no sweep has persisted one. Written by
        ``sweep.sweep_allreduce_precision`` per (device kind, slice
        count) — the ATLAS discipline applied to the wire width: a
        lossy precision reaches the auto path only through a
        measurement, never through the model alone."""
        dk = normalize_device_kind(device_kind or self.device_kind())

        def compute():
            for kind in (dk, "unknown"):
                hit = self.cache.lookup(
                    PlanKey("all_reduce", "precision_threshold", "",
                            kind, f"dcn{outer}" if outer else "flat")
                )
                if (hit is not None
                        and "precision_min_bytes" in hit.knobs
                        and "precision" in hit.knobs):
                    return (int(hit.knobs["precision_min_bytes"]),
                            str(hit.knobs["precision"]), "cache")
            return None

        return self._memoized(("precision_threshold", outer, dk),
                              compute)

    def use_precision(
        self,
        payload_bytes: int,
        topo: cm.TopologySpec,
        dtype: str = "float32",
        op: str = "add",
        precision: Optional[str] = None,
        precision_layer: str = "env",
    ) -> Tuple[str, str]:
        """Call-time wire-precision gate for
        ``collectives.allreduce(precision=None)``.

        ``precision`` given = an explicit override (the ``precision=``
        pin or the ``$SMI_TPU_ALLREDUCE_PRECISION`` env var) — it
        decides ALONE; eligibility (ADD op, floating dtype) is the
        CALLER's loud error, never a silent f32 fallback. Otherwise:
        per-bucket cache entry (skipped with a fall-through when it
        names a precision this op/dtype cannot run — a cache written
        for one call site must not error another), then the measured
        crossover threshold, then the model — which may propose a
        lossy width only past :data:`cm.PRECISION_MODEL_MARGIN`, a
        margin chosen to EQUAL the int8 byte ratio so the modeled
        advantage (strictly below it; the alphas are unchanged) can
        never clear it: the model alone never flips numerics. Then
        the heuristic: dense f32, byte-for-byte the untuned lowering.
        """
        dk = self.device_kind()

        def compute():
            if precision is not None:
                return precision, precision_layer
            key = PlanKey("all_reduce", payload_bucket(payload_bytes),
                          dtype, dk, _collective_topology(topo))
            hit = self.cache.lookup(key)
            if hit is not None and "precision" in hit.knobs:
                p = str(hit.knobs["precision"])
                if (p in cm.ALLREDUCE_PRECISIONS
                        and cm.precision_ineligibility(
                            p, op, dtype, payload_bytes) is None):
                    return p, cache_entry_layer(hit)
            outer = ((topo.outer or 0)
                     if topo.hierarchical_eligible else 0)
            thr = self.precision_threshold(outer)
            if thr is not None:
                min_bytes, p, _layer = thr
                if (payload_bytes >= min_bytes
                        and p in cm.ALLREDUCE_PRECISIONS
                        and cm.precision_ineligibility(
                            p, op, dtype, payload_bytes) is None):
                    return p, "cache"
                return "f32", "cache"
            # the model rung — provably inert by construction (the
            # margin equals int8's 4x byte-ratio bound, and the
            # advantage is strictly below the ratio), kept so the
            # ladder stays uniform and the explain surface can say WHY
            # the model never decides here. topk is not consulted: its
            # 8x byte ratio EXCEEDS the margin, and sparsification
            # drops coordinates outright — it reaches the wire only
            # through a measured crossover or an explicit pin
            for p in ("int8", "bf16"):
                if cm.precision_ineligibility(
                        p, op, dtype, payload_bytes) is not None:
                    continue
                advantage = cm.precision_advantage(
                    payload_bytes, topo, p, link=self.link
                )
                if advantage >= cm.PRECISION_MODEL_MARGIN:
                    return p, "model"
            return "f32", "heuristic"

        return self._memoized(
            ("use_precision", payload_bytes, topo, dtype, op,
             precision, precision_layer, dk),
            compute,
        )

    def _alltoall_structural(self, algorithm: str,
                             topo: cm.TopologySpec) -> bool:
        """Can this shape run the algorithm at all? (Bruck needs a
        power-of-two rank count, the two-tier form a multi-slice pod;
        pairwise runs anywhere.)"""
        if algorithm == "bruck":
            return topo.n >= 1 and not (topo.n & (topo.n - 1))
        if algorithm == "hierarchical":
            return topo.hierarchical_eligible
        return algorithm == "pairwise"

    def use_alltoall(
        self,
        payload_bytes: int,
        topo: cm.TopologySpec,
        dtype: str = "float32",
        algorithm: Optional[str] = None,
        algorithm_layer: str = "env",
    ) -> Tuple[str, str]:
        """Call-time algorithm gate for ``all_to_all(algorithm=None)``.

        ``algorithm`` given = an explicit override (the
        ``$SMI_TPU_ALLTOALL_ALGO`` env var) — it decides ALONE, and a
        structurally impossible request (Bruck on a non-power-of-two
        ring, hierarchical off-pod) is the CALLER's loud error, never
        a silent fallback. Otherwise: per-bucket cache entry (skipped
        with a fall-through when it names an algorithm this shape
        cannot run — a cache written on one topology must not error a
        call on another), then the model where its advantage is
        confidently (:data:`ALLTOALL_MODEL_MARGIN`) away from the
        pairwise default, then pairwise — the fused single collective,
        byte-for-byte what an untuned program compiles.
        """
        dk = self.device_kind()

        def compute():
            if algorithm is not None:
                return algorithm, algorithm_layer
            key = PlanKey("all_to_all", payload_bucket(payload_bytes),
                          dtype, dk, _collective_topology(topo))
            hit = self.cache.lookup(key)
            if (hit is not None and "algorithm" in hit.knobs
                    and self._alltoall_structural(
                        str(hit.knobs["algorithm"]), topo)):
                return str(hit.knobs["algorithm"]), "cache"
            if topo.hierarchical_eligible:
                advantage = cm.alltoall_advantage(
                    payload_bytes, topo, link=self.link
                )
                if advantage >= ALLTOALL_MODEL_MARGIN:
                    return "hierarchical", "model"
            if topo.n >= 2 and not (topo.n & (topo.n - 1)):
                # the flat-form comparison also applies ON a pod when
                # the two-tier form did not confidently win: price the
                # flat candidates at the tier that gates their lockstep
                # steps there (DCN — the alltoall_candidates rule)
                flat_link = (cm.dcn_link_model()
                             if topo.hierarchical_eligible
                             else self.link)
                pairwise = cm.pairwise_alltoall_us(
                    payload_bytes, topo.n, flat_link
                )
                bruck = cm.bruck_alltoall_us(
                    payload_bytes, topo.n, flat_link
                )
                if bruck * ALLTOALL_MODEL_MARGIN <= pairwise:
                    return "bruck", "model"
            return "pairwise", "heuristic"

        # exact payload, not the bucket (the use_rs_ag discipline): a
        # bucket-wide memo would be first-call-wins across a model
        # crossover inside one pow2 bucket
        return self._memoized(
            ("use_alltoall", payload_bytes, topo, dtype,
             algorithm, algorithm_layer, dk),
            compute,
        )

    def alltoall_plan(
        self,
        payload_bytes: int,
        topo: cm.TopologySpec,
        dtype: str = "float32",
        device_kind: Optional[str] = None,
    ) -> Plan:
        """Full algorithm plan for an all-to-all — the ``tune
        --explain all_to_all`` entry: all three candidates priced,
        structurally excluded ones named with the reason (no silent
        caps), the deciding layer per knob."""
        dk = normalize_device_kind(device_kind or self.device_kind())
        key = PlanKey("all_to_all", payload_bucket(payload_bytes),
                      dtype, dk, _collective_topology(topo))
        cands = cm.alltoall_candidates(payload_bytes, topo,
                                       link=self.link)
        knobs: Dict[str, object] = {}
        decided: Dict[str, str] = {}
        rationale = []
        hit = self.cache.lookup(key)
        if (hit is not None and "algorithm" in hit.knobs
                and self._alltoall_structural(
                    str(hit.knobs["algorithm"]), topo)):
            layer, why = _cache_hit_rationale(hit)
            knobs["algorithm"] = hit.knobs["algorithm"]
            decided["algorithm"] = layer
            rationale.append(why)
            cands = cm.CandidateSet(
                [Candidate(c.name, c.knobs, c.modeled_us,
                           hit.cost_us if c.knobs.get("algorithm")
                           == hit.knobs["algorithm"] else None, c.note)
                 for c in cands],
                cands.excluded,
            )
        else:
            algo, layer = self.use_alltoall(payload_bytes, topo, dtype)
            knobs["algorithm"] = algo
            decided["algorithm"] = layer
            rationale.append(
                f"alpha-beta ranking (pairwise {topo.n - 1} alphas vs "
                f"Bruck log2(n) aggregate steps; model engages only "
                f"outside the {ALLTOALL_MODEL_MARGIN:g}x confidence "
                f"band — inside it the fused pairwise collective "
                f"compiles byte-identically)"
            )
        for dropped in cands.excluded:
            rationale.append(f"excluded {dropped.name}: {dropped.note}")
        return Plan(key=key, knobs=knobs, decided_by=decided,
                    candidates=list(cands), rationale=rationale)

    def collective_chunks(
        self,
        family: str,
        payload_bytes: int,
        n: int,
        dtype: str = "float32",
        device_kind: Optional[str] = None,
    ) -> Tuple[int, str]:
        """(chunks, layer) for a collective whose caller left
        ``chunks=None``: cache entry, else today's unchunked default.
        (The pipeline model's chunk suggestion is advisory — shown by
        ``--explain``, applied only once a sweep has measured it.)"""
        dk = normalize_device_kind(device_kind or self.device_kind())

        def compute():
            key = PlanKey(family, payload_bucket(payload_bytes), dtype,
                          dk, f"n{n}")
            hit = self.cache.lookup(key)
            if hit is not None and "chunks" in hit.knobs:
                return max(1, int(hit.knobs["chunks"])), "cache"
            return 1, "heuristic"

        return self._memoized(
            ("chunks", family, payload_bucket(payload_bytes), n, dtype,
             dk),
            compute,
        )

    # -- kernels ---------------------------------------------------------
    def flash_blocks(
        self,
        dtype: str,
        windowed: bool,
        device_kind: Optional[str] = None,
    ) -> Optional[Tuple[int, int, str]]:
        """(block_q, block_k, layer) for the flash forward tiles, or
        ``None`` when no cache entry exists — the kernel then keeps its
        measured-constant heuristics (which the seeded v5e entries
        reproduce exactly, so hardware behavior is unchanged until a
        sweep says otherwise)."""
        dk = normalize_device_kind(device_kind or self.device_kind())

        def compute():
            key = PlanKey("flash_fwd", "window" if windowed else "causal",
                          dtype, dk, "chip")
            hit = self.cache.lookup(key)
            if hit is not None and {"block_q", "block_k"} <= set(hit.knobs):
                bq, bk = hit.knobs["block_q"], hit.knobs["block_k"]
                if _valid_flash_block(bq) and _valid_flash_block(bk):
                    return int(bq), int(bk), "cache"
                # value-junk in a schema-valid entry: the kernel's
                # a schema-valid entry with junk values: the
                # heuristics apply instead (a broken cache costs
                # tuning, never a call)
            return None

        return self._memoized(("flash", dtype, windowed, dk), compute)

    def flash_plan(
        self,
        dtype: str = "bfloat16",
        windowed: bool = False,
        s: int = 8192,
        d: int = 128,
        device_kind: Optional[str] = None,
    ) -> Plan:
        """Explain-surface flash plan: the Hopper forward kernel's own
        tile plan (:func:`smi_tpu_torch.kernels.flash._plan`) as the
        heuristic tier, a cache entry only where it names the pair that
        kernel compiles (:func:`smi_tpu_torch.kernels.flash.
        fwd_plan_explained`'s rule), next to the model's VMEM-gated
        candidate ranking (the v5e's; advisory)."""
        dk = normalize_device_kind(device_kind or self.device_kind())
        key = PlanKey("flash_fwd", "window" if windowed else "causal",
                      dtype, dk, "chip")
        cands = cm.flash_block_candidates(s, d, dtype, windowed)
        picked = self.flash_blocks(dtype, windowed, device_kind=dk)
        import torch

        from smi_tpu_torch.kernels import flash as _flash

        heur = _flash._plan(d, getattr(torch, dtype, None))
        if picked is not None and heur is not None and picked[:2] == heur:
            bq, bk, layer = picked
            rationale = ["measured cache entry, the tile pair the Hopper "
                         "kernel compiles"]
        else:
            bq, bk = heur if heur is not None else (None, None)
            layer = "heuristic"
            rationale = [
                f"the Hopper forward kernel's own plan at D={d} "
                f"(kernels/flash._plan; model ranking shown is the "
                f"v5e's, advisory)"
                if heur is not None else
                f"the Hopper forward kernel has no instantiation for "
                f"{dtype} at D={d}"
            ]
            if picked is not None:
                rationale.append(
                    f"cache entry bq{picked[0]}/bk{picked[1]} names no "
                    f"tile pair the Hopper kernels compile; the kernel's "
                    f"own plan applies"
                )
        # no silent caps: VMEM-rejected targets are named with their
        # failing footprint (tune --explain prints rationale lines), so
        # a shorter candidate table never reads as the full search space
        for dropped in getattr(cands, "excluded", ()):
            rationale.append(f"excluded {dropped.name}: {dropped.note}")
        return Plan(
            key=key,
            knobs={"block_q": bq, "block_k": bk},
            decided_by={"block_q": layer, "block_k": layer},
            candidates=list(cands),
            rationale=rationale,
        )

    def stencil_depth(
        self,
        extent: int = 8192,
        dtype: str = "float32",
        device_kind: Optional[str] = None,
    ) -> Tuple[Optional[int], str]:
        """(depth, layer) for the temporal stencil: seeded/swept cache
        entry, else ``None`` + heuristic (``pick_temporal_depth``)."""
        dk = normalize_device_kind(device_kind or self.device_kind())
        hit = self.cache.lookup(
            PlanKey("stencil_temporal", str(extent), dtype, dk, "chip")
        )
        if hit is not None and "depth" in hit.knobs:
            return int(hit.knobs["depth"]), "cache"
        return None, "heuristic"

    def stencil_pipeline_knobs(
        self,
        extent: int = 8192,
        dtype: str = "float32",
        device_kind: Optional[str] = None,
    ) -> Optional[Tuple[Dict[str, object], str]]:
        """(knobs, layer) for the explicit-DMA stencil pipeline, or
        ``None`` when no cache entry exists — callers then take the
        cost model's best feasible candidate (which the seeded entry
        reproduces, so behavior is unchanged until a sweep disagrees)."""
        dk = normalize_device_kind(device_kind or self.device_kind())

        def compute():
            hit = self.cache.lookup(
                PlanKey("stencil_pipeline", str(extent), dtype, dk,
                        "chip")
            )
            wanted = {"algorithm", "depth", "stripe",
                      "compute_dtype", "buffering"}
            if hit is not None and wanted <= set(hit.knobs):
                return dict(hit.knobs), cache_entry_layer(hit)
            return None

        return self._memoized(("stencil_pipeline", extent, dtype, dk),
                              compute)

    def stencil_pipeline_plan(
        self,
        h: int = 8192,
        w: int = 8192,
        dtype: str = "float32",
        device_kind: Optional[str] = None,
    ) -> Plan:
        """Explain-surface stencil plan: the cached (seeded or swept)
        pipeline knobs next to the model's full depth x stripe x
        compute-dtype ranking, VMEM exclusions named, plus every
        legacy tier's fallback decision (the r18 no-silent-caps fix:
        the ``_pick_*`` pickers now explain a ``None``)."""
        dk = normalize_device_kind(device_kind or self.device_kind())
        key = PlanKey("stencil_pipeline", str(h), dtype, dk, "chip")
        cands = cm.stencil_pipeline_candidates(h, w, dtype)
        picked = self.stencil_pipeline_knobs(h, dtype, device_kind=dk)
        if picked is not None:
            knobs, layer = picked
            hit = self.cache.lookup(key)
            _, line = _cache_hit_rationale(hit)
            rationale = [line]
        elif len(cands):
            best = cands[0]
            knobs, layer = dict(best.knobs), "model"
            rationale = [
                "no cache entry for this device kind; the model's "
                "best-priced feasible candidate applies until swept"
            ]
        else:
            knobs, layer = {"algorithm": "unfused"}, "heuristic"
            rationale = [
                f"no feasible pipeline candidate at {h}x{w} "
                f"dtype={dtype}; the unfused jacobi path applies"
            ]
        for dropped in getattr(cands, "excluded", ()):
            rationale.append(f"excluded {dropped.name}: {dropped.note}")
        # the port's tiers' picker verdicts: why a shape would (not)
        # fall back, one line each, never a silent None
        from smi_tpu_torch.kernels import stencil_pipeline as _kpipe
        from smi_tpu_torch.kernels import stencil_temporal as _ktemporal

        depth = int(knobs.get("depth", 8) or 8)
        t_plan = _ktemporal._plan(h, w, depth)
        for tier, note in (
            ("pipeline", _kpipe.pick_pipeline_stripe_explained(
                h, w, depth)[1]),
            ("temporal", f"stripe {t_plan[0]}, band {t_plan[1]}"
             if t_plan is not None else
             f"no stripe and band at depth {depth} fit a {h}x{w} block"),
            ("fused", "any f32 block, one launch a sweep"),
        ):
            rationale.append(f"{tier} tier: {note}")
        return Plan(
            key=key,
            knobs=knobs,
            decided_by={k: layer for k in knobs},
            candidates=list(cands),
            rationale=rationale,
        )

    # -- explain ---------------------------------------------------------
    def explain_text(
        self,
        op: str,
        n: int = 8,
        dtype: str = "float32",
        sizes_kb: Tuple[int, ...] = (4, 64, 1024, 16384),
        slices: Optional[int] = None,
    ) -> str:
        """The explain payload (``SmiContext.explain_plan``; the JAX
        package's ``smi-tpu tune --explain OP``): candidate tables
        with modeled vs measured costs and the deciding layer per knob.
        Deterministic on CPU — no devices are touched beyond reading
        the local device kind. ``slices >= 2`` models a multi-slice
        pod: the all_reduce table then prices all THREE candidates
        (flat ring / rs+ag / hierarchical) and names the two-tier
        gate's deciding layer."""
        op = op.replace("-", "_")
        if op in ("all_reduce", "allreduce"):
            if slices is not None and slices > 1:
                if n % slices:
                    raise ValueError(
                        f"n={n} ranks do not split into {slices} slices"
                    )
                topo = cm.TopologySpec(n=n, inner=n // slices,
                                       outer=slices)
                where = (f"{slices} slices x {n // slices} "
                         f"ranks (ICI x DCN pod)")
            else:
                topo = cm.TopologySpec(n=n)
                where = f"n={n} ranks"
            parts = [
                f"all_reduce over {where}, dtype={dtype}, device "
                f"kind '{self.device_kind()}'"
            ]
            for kb in sizes_kb:
                parts.append(
                    self.allreduce_plan(kb * 1024, topo, dtype).explain()
                )
            return "\n\n".join(parts)
        if op in ("all_to_all", "alltoall"):
            if slices is not None and slices > 1:
                if n % slices:
                    raise ValueError(
                        f"n={n} ranks do not split into {slices} slices"
                    )
                topo = cm.TopologySpec(n=n, inner=n // slices,
                                       outer=slices)
                where = (f"{slices} slices x {n // slices} "
                         f"ranks (ICI x DCN pod)")
            else:
                topo = cm.TopologySpec(n=n)
                where = f"n={n} ranks"
            parts = [
                f"all_to_all over {where}, dtype={dtype}, device "
                f"kind '{self.device_kind()}'"
            ]
            for kb in sizes_kb:
                parts.append(
                    self.alltoall_plan(kb * 1024, topo, dtype).explain()
                )
            return "\n\n".join(parts)
        if op == "flash_fwd":
            return "\n\n".join(
                self.flash_plan(dtype=dt, windowed=w).explain()
                for dt in ("bfloat16", "float32")
                for w in (False, True)
            )
        if op in ("stencil", "stencil_pipeline"):
            return self.stencil_pipeline_plan(dtype=dtype).explain()
        if op == "stencil_temporal":
            depth, layer = self.stencil_depth()
            via = ("plan cache" if layer == "cache"
                   else "pick_temporal_depth heuristic")
            return (
                f"plan stencil_temporal|8192|float32|"
                f"{self.device_kind()}|chip\n"
                f"  depth = {depth!r}  [{layer}] ({via})"
            )
        if op in ("ring_all_reduce", "ring"):
            chunks, layer = self.collective_chunks(
                "ring_all_reduce", 1 << 20, n, dtype
            )
            return (
                f"plan ring_all_reduce|{payload_bucket(1 << 20)}|{dtype}"
                f"|{self.device_kind()}|n{n}\n"
                f"  chunks = {chunks}  [{layer}]"
            )
        raise ValueError(
            f"unknown op {op!r}; explainable ops: all_reduce, "
            f"all_to_all, flash_fwd, stencil, stencil_temporal, "
            f"ring_all_reduce"
        )


# ---------------------------------------------------------------------------
# Process-global engine + never-erroring call-time entry points
# ---------------------------------------------------------------------------

_ENGINE: Optional[PlanEngine] = None
_ENGINE_LOCK = threading.Lock()


def _detect_device_kind() -> str:
    """The local device kind: the first CUDA card's name when CUDA is
    available, else ``"cpu"`` (the JAX package's kind on the CPU).
    ``torch.cuda.is_available()`` creates no CUDA context."""
    try:
        import torch

        if torch.cuda.is_available():
            return normalize_device_kind(torch.cuda.get_device_name(0))
        return "cpu"
    except Exception:
        return "unknown"


def _load_default_cache() -> PlanCache:
    """Shipped seeded cache, with the user's cache file (when present)
    merged over it. A malformed user file costs tuning, not a call:
    it is reported once as a warning and skipped."""
    cache = seeded_cache()
    path = default_cache_path()
    try:
        if path and os.path.exists(path):
            cache.merge(PlanCache.load(path))
    except Exception as e:
        warnings.warn(
            f"ignoring unreadable plan cache at {path!r} "
            f"({type(e).__name__}: {e}); rerun the sweeps "
            f"(smi_tpu_torch.tuning.sweep) to regenerate it, or unset "
            f"${CACHE_ENV}",
            stacklevel=2,
        )
    return cache


def get_engine() -> PlanEngine:
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = PlanEngine()
        return _ENGINE


def set_engine(engine: Optional[PlanEngine]) -> None:
    """Install (or with ``None`` reset) the process-global engine —
    the test seam, and how a sweep activates a fresh cache."""
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = engine


def planned_flash_blocks(
    dtype: str, windowed: bool
) -> Optional[Tuple[int, int]]:
    """Call-time flash consult: (bq, bk) from the cache, or ``None``
    (keep the kernel's heuristics). Never raises."""
    try:
        got = get_engine().flash_blocks(dtype, windowed)
        return None if got is None else (got[0], got[1])
    except Exception:
        return None


def planned_stencil_pipeline(
    extent: int = 8192, dtype: str = "float32",
) -> Optional[Dict[str, object]]:
    """Call-time stencil-pipeline consult: the cached knob dict
    (algorithm/depth/stripe/compute_dtype/buffering), or ``None``
    (callers keep their defaults). Never raises."""
    try:
        got = get_engine().stencil_pipeline_knobs(extent, dtype)
        return None if got is None else dict(got[0])
    except Exception:
        return None


def planned_chunks(
    family: str, payload_bytes: int, n: int, dtype: str
) -> int:
    """Call-time chunks consult for a ``chunks=None`` caller. Never
    raises; the heuristic answer is 1 (unchunked)."""
    try:
        return get_engine().collective_chunks(
            family, payload_bytes, n, dtype
        )[0]
    except Exception:
        return 1


def planned_hierarchical(
    payload_bytes: int,
    n: int,
    inner: int,
    outer: int,
    dtype: str,
    min_slices: Optional[int] = None,
) -> bool:
    """Call-time two-tier gate for an eligible ADD allreduce on a
    hybrid multi-slice communicator. ``min_slices`` carries the
    explicit ``$SMI_TPU_HIER_MIN_SLICES`` override. Never raises; the
    fallback is today's flat path (False)."""
    try:
        return get_engine().use_hierarchical(
            payload_bytes,
            cm.TopologySpec(n=n, inner=inner, outer=outer),
            dtype,
            min_slices=min_slices,
        )[0]
    except Exception:
        return False if min_slices is None else outer >= min_slices


def planned_alltoall(
    payload_bytes: int,
    n: int,
    inner: int,
    outer: int,
    dtype: str,
    algorithm: Optional[str] = None,
) -> str:
    """Call-time all-to-all algorithm consult. ``algorithm`` carries
    the explicit ``$SMI_TPU_ALLTOALL_ALGO`` override. Never raises; the
    fallback is the fused pairwise collective — byte-for-byte what an
    explicit ``algorithm='pairwise'`` call compiles."""
    try:
        return get_engine().use_alltoall(
            payload_bytes,
            cm.TopologySpec(
                n=n,
                inner=inner if outer and outer > 1 else None,
                outer=outer if outer and outer > 1 else None,
            ),
            dtype,
            algorithm=algorithm,
        )[0]
    except Exception:
        return "pairwise" if algorithm is None else algorithm


def planned_precision(
    payload_bytes: int,
    n: int,
    inner: int,
    outer: int,
    dtype: str,
    precision: Optional[str] = None,
) -> str:
    """Call-time wire-precision consult for an eligible ADD allreduce.
    ``precision`` carries an explicit override (the ``precision=`` pin
    or ``$SMI_TPU_ALLREDUCE_PRECISION``) — it decides ALONE. Never
    raises; the fallback is dense f32, byte-for-byte the untuned
    lowering."""
    try:
        return get_engine().use_precision(
            payload_bytes,
            cm.TopologySpec(
                n=n,
                inner=inner if outer and outer > 1 else None,
                outer=outer if outer and outer > 1 else None,
            ),
            dtype,
            precision=precision,
        )[0]
    except Exception:
        return "f32" if precision is None else precision


def planned_rs_ag(
    payload_bytes: int,
    n: int,
    dtype: str,
    threshold: Optional[int] = None,
) -> bool:
    """Call-time rs+ag gate for an eligible ADD allreduce. ``threshold``
    carries an explicit env override. Never raises; the fallback is the
    built-in constant comparison."""
    try:
        return get_engine().use_rs_ag(
            payload_bytes, cm.TopologySpec(n=n), dtype,
            threshold=threshold,
        )[0]
    except Exception:
        from smi_tpu_torch.parallel.collectives import RS_AG_MIN_BYTES

        thr = RS_AG_MIN_BYTES if threshold is None else threshold
        return payload_bytes >= thr
