"""The shipped default plan cache: measured-best configs, by device kind.

The port's copy of :mod:`smi_tpu.tuning.seeded`, plus the H100's own
entries.

- **v5e** (``"tpu v5 lite"``): the JAX package's entries verbatim, each
  citing the ``PERF.json`` metric whose sweep produced it. They can
  never match on an H100 (the key carries the device kind); they are
  here so the port's engine answers as the JAX package's does for the
  same device kind.
- **H100** (:data:`SEEDED_H100_DEVICE_KIND`): the routing knobs the
  card's own collective sweeps (:mod:`smi_tpu_torch.tuning.sweep`, run
  by ``chip_smoke.py`` phase 32 on a ``LocalWorld``) measured: the
  per-bucket allreduce and all-to-all ``algorithm`` (and ``chunks`` where
  a chunked form measured faster) of an 8-rank world and of a ``(2, 4)``
  ``("dcn", "ici")`` hybrid world, f32, 64 KiB to 4 MiB a rank, and
  the crossover entries a sweep distilled. Each entry's provenance
  names ``PERF.md`` and the card's name and power limit. No
  ``precision`` entry is seeded: a lossy wire width reached by an
  untuned call would change results, not only speed, so the precision
  sweep's table stays in ``PERF.md``.

Seeded v5e costs are microseconds per timed rep, derived from each
metric's committed differential timing ``[r, 4r, t_r, t_4r]`` as
``(t_4r - t_r) / (4r - r) * 1e6``; the H100 entries carry the sweep's
mean host wall of one ``LocalWorld.run`` in microseconds.
"""

from __future__ import annotations

from smi_tpu_torch.tuning.cache import CacheEntry, PlanCache
from smi_tpu_torch.tuning.plan import PlanKey

#: the device kind every v5e entry is keyed to (normalized form of
#: PERF.json's "TPU v5 lite0" / jax's device_kind "TPU v5 lite")
SEEDED_DEVICE_KIND = "tpu v5 lite"

#: the device kind of the H100 entries: ``torch.cuda.get_device_name()``
#: of an "NVIDIA H100 80GB HBM3", normalized (trailing digits stripped)
SEEDED_H100_DEVICE_KIND = "nvidia h100 80gb hbm"

#: where the H100 entries were measured, as ``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader`` printed it
SEEDED_H100_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

#: the H100 entries: ``(op, detail, dtype, topology, knobs, cost_us,
#: sweep)``, from ``chip_smoke.py`` phase 32 (PERF.md section 5): each
#: point's winner by the mean of the run's two sweeps (2 x 5 timed runs
#: of one ``LocalWorld.run``), and its mean in microseconds. The flat
#: forms won every point: one ring allreduce (unchunked; rs+ag, the
#: chunked forms and the two-tier form lost everywhere, so no threshold
#: entry), and the pairwise all-to-all.
SEEDED_H100_ENTRIES = tuple(
    (op, f"pow2:{bucket}", "float32", topology, {"algorithm": algorithm},
     cost_us, f"{sweep}:{1 << (bucket - 10)}KiB:{topology}")
    for op, topology, algorithm, sweep, costs in (
        ("all_reduce", "n8", "ring", "sweep_allreduce",
         (10201.2, 11556.85, 9167.6, 8124.1)),
        ("all_reduce", "n8:dcn2", "ring", "sweep_allreduce_hierarchical",
         (10411.9, 11916.85, 9777.95, 10028.8)),
        ("all_to_all", "n8", "pairwise", "sweep_alltoall",
         (8020.05, 8595.5, 7957.1, 8159.05)),
        ("all_to_all", "n8:dcn2", "pairwise", "sweep_alltoall",
         (9757.4, 10011.3, 9850.0, 8460.65)),
    )
    for bucket, cost_us in zip((16, 18, 20, 22), costs)
)

#: knob values drift-guarded against PERF.json configs
SEEDED_FLASH_BF16_BLOCKS = (1024, 1024)       # flash_vs_stock_swept
SEEDED_FLASH_BF16_WINDOW_BLOCKS = (1024, 512)
SEEDED_FLASH_F32_BLOCKS = (512, 512)
SEEDED_STENCIL_DEPTH = 16                     # stencil_temporal_gcells
SEEDED_RS_AG_MIN_BYTES = 1 << 20              # the HLO-verified switch

#: r18 explicit-DMA pipeline winner at the canonical 8192^2 block: the
#: 3-slot rotation with depth 8 / stripe 128 / f32 compute. Overlap
#: inverts the temporal depth knee — once the stripe stream hides
#: behind compute, the shallower depth's smaller recompute apron wins
#: (cost_model.stencil_pipeline_candidates; the un-pipelined temporal
#: entry above keeps its measured depth-16 knee untouched).
SEEDED_STENCIL_PIPELINE_KNOBS = {
    "algorithm": "pipeline", "depth": 8, "stripe": 128,
    "compute_dtype": "float32", "buffering": 3,
}


def _us(timing) -> float:
    """Per-rep microseconds of a PERF.json differential timing row."""
    r, r4, t_r, t_r4 = timing
    return (t_r4 - t_r) / (r4 - r) * 1e6


def seeded_cache() -> PlanCache:
    """A fresh copy of the shipped default cache (callers may merge
    user sweeps over it without aliasing)."""
    dk = SEEDED_DEVICE_KIND
    cache = PlanCache()

    bq, bk = SEEDED_FLASH_BF16_BLOCKS
    cache.put(
        PlanKey("flash_fwd", "causal", "bfloat16", dk, "chip"),
        CacheEntry(
            {"block_q": bq, "block_k": bk},
            cost_us=_us([256, 512, 0.3992, 0.6978]),
            provenance="seeded:PERF.json:flash_attn_fwd_s8192_bf16"
                       "+flash_vs_stock_swept",
        ),
    )
    bq, bk = SEEDED_FLASH_BF16_WINDOW_BLOCKS
    cache.put(
        PlanKey("flash_fwd", "window", "bfloat16", dk, "chip"),
        CacheEntry(
            {"block_q": bq, "block_k": bk},
            cost_us=_us([256, 512, 1.4007, 2.7085]),
            provenance="seeded:PERF.json:"
                       "flash_attn_fwd_s32768_bf16_window4096",
        ),
    )
    bq, bk = SEEDED_FLASH_F32_BLOCKS
    cache.put(
        PlanKey("flash_fwd", "causal", "float32", dk, "chip"),
        CacheEntry(
            {"block_q": bq, "block_k": bk},
            cost_us=_us([64, 256, 0.4386, 1.4499]),
            provenance="seeded:PERF.json:flash_attn_fwd_s8192_f32",
        ),
    )
    cache.put(
        PlanKey("stencil_temporal", "8192", "float32", dk, "chip"),
        CacheEntry(
            {"depth": SEEDED_STENCIL_DEPTH},
            cost_us=_us([16, 64, 1.1119, 4.2417]),
            provenance="seeded:PERF.json:stencil_temporal_gcells",
        ),
    )
    cache.put(
        PlanKey("stencil_pipeline", "8192", "float32", dk, "chip"),
        CacheEntry(
            dict(SEEDED_STENCIL_PIPELINE_KNOBS),
            cost_us=None,
            provenance="seeded:cost_model.stencil_pipeline_candidates"
                       ":8192 (proxy-sweep winner; unmeasured until a"
                       " TPU runs `smi-tpu tune --ops stencil`)",
        ),
    )
    cache.put(
        PlanKey("all_reduce", "threshold", "", dk, "any"),
        CacheEntry(
            {"rs_ag_min_bytes": SEEDED_RS_AG_MIN_BYTES},
            cost_us=None,
            provenance="seeded:collectives.RS_AG_MIN_BYTES "
                       "(HLO-verified switch test)",
        ),
    )
    for (op, detail, dtype, topology, knobs, cost_us,
         sweep) in SEEDED_H100_ENTRIES:
        cache.put(
            PlanKey(op, detail, dtype, SEEDED_H100_DEVICE_KIND, topology),
            CacheEntry(
                dict(knobs), cost_us=cost_us,
                provenance=f"seeded:PERF.md:chip_smoke phase 32:{sweep} "
                           f"({SEEDED_H100_CARD})",
            ),
        )
    return cache
