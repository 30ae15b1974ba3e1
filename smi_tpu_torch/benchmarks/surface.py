"""Single-card performance surface of the H100 port: every metric one card
can measure, each beside its roofline.

PyTorch counterpart of :mod:`smi_tpu.benchmarks.surface`, with its nine
sections (``SECTIONS``) and, at the same shapes, its metric names, units
and ``config`` keys: flash forward, training, long-context and
whole-model training points; flash against the materialised tier
(``ratio``) and against PyTorch's stock attention (``stock``); the
stencil tiers, roll chains and on-chip applications.

Roofline model (NVIDIA H100 SXM data sheet, dense rates at 700 W):

- ``PEAK_BF16`` = 989 TFLOP/s: tensor cores with bf16 operands.
- ``PEAK_HBM`` = 3.35 TB/s device-memory bandwidth.
- ``PEAK_F32_EFFECTIVE`` = 67 TFLOP/s: f32 outside the tensor cores. The
  port's f32 flash kernels run their products as CUDA-core FMAs, so this
  is the reachable f32 peak; f32 points are also reported against the
  bf16 peak, as in the JAX package's schema.

A card may be set below 700 W: the artifact's header carries
``nvidia-smi``'s name and power limit beside the peaks.

Output: one JSON line per metric (the ``bench.py`` schema plus a
``roofline`` object) and a combined artifact, by default under
``build/surface/`` of the checkout. The root ``PERF.json`` is the JAX
package's TPU evidence and is never written here.

Run on the card: ``python -m smi_tpu_torch.benchmarks.surface [--quick]
[--only SECTION ...] [-o PATH] [--fresh]``. ``--cpu`` runs every section
on the CPU at the tiny ``CPU_SHAPES``, for tests and rehearsal: its
records carry no roofline, since a CPU time is no card metric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Optional, Tuple

import torch

PEAK_BF16 = 989e12
PEAK_HBM = 3.35e12
PEAK_F32_EFFECTIVE = 67e12

#: Jacobi cell-sweep arithmetic: 3 adds and 1 multiply
STENCIL_ESSENTIAL_FLOPS = 4

#: the timing harness's depth: runs per point and the least time
#: difference to trust; a smoke run may cut both
RUNS = 3
MIN_DELTA = 1.0

#: where the artifact goes by default, inside the checkout
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "surface"


@dataclasses.dataclass(frozen=True)
class Shapes:
    """Every section's shapes. The defaults are the JAX package's
    (``smi_tpu/benchmarks/surface.py``); ``--quick`` halves the training,
    ratio, stock, stencil and GESUMMV sizes and keeps two forward points,
    as there."""

    heads: int = 8
    head_dim: int = 128
    #: (S, dtype) forward points
    fwd: Tuple = ((4096, "f32"), (8192, "f32"), (8192, "bf16"),
                  (16384, "bf16"))
    train_seq: int = 8192
    window: int = 4096
    #: long-context forward rungs: (S, windowed, kv_heads)
    longcontext_fwd: Tuple = (
        (32768, False, 8), (32768, True, 8), (65536, True, 8),
        (131072, True, 8), (262144, True, 1), (524288, True, 1),
        (1048576, True, 1),
    )
    #: long-context training rungs: (S, kv_heads, rep-chain column)
    longcontext_train: Tuple = (
        (32768, 8, True), (65536, 8, True), (131072, 8, True),
        (262144, 1, True), (524288, 1, False),
    )
    #: from this length the rep chain recomputes each rep (its saved
    #: residuals would not fit), and the step chain takes single steps
    remat_from: int = 65536
    single_step_from: int = 524288
    embed: int = 1024
    #: whole-model rows: (S, windowed, layers)
    model: Tuple = ((8192, False, 1), (32768, True, 1), (8192, True, 1),
                    (8192, True, 4), (32768, True, 4))
    ratio_seq: int = 4096
    stock_seq: int = 8192
    stencil: int = 8192
    #: roll chains: (rows, cols) and the two chain lengths
    roll: Tuple = (512, 2048)
    roll_lengths: Tuple = (1024, 4096)
    gesummv: int = 8192
    kmeans_points: int = 1 << 20


#: the JAX package's shapes, run on the card
CARD_SHAPES = Shapes()

#: tiny shapes for ``--cpu``: every section's code path in seconds
CPU_SHAPES = Shapes(
    heads=2, head_dim=16,
    fwd=((16, "f32"), (32, "f32"), (32, "bf16"), (64, "bf16")),
    train_seq=32, window=8,
    longcontext_fwd=((32, False, 2), (32, True, 2), (64, True, 2),
                     (128, True, 2), (256, True, 1), (512, True, 1),
                     (1024, True, 1)),
    longcontext_train=((32, 2, True), (64, 2, True), (128, 2, True),
                       (256, 1, True), (512, 1, False)),
    remat_from=64, single_step_from=512,
    embed=32,
    model=((32, False, 1), (128, True, 1), (32, True, 1), (32, True, 4),
           (128, True, 4)),
    ratio_seq=32, stock_seq=64, stencil=32, roll=(16, 256),
    roll_lengths=(8, 32), gesummv=64, kmeans_points=1024,
)

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class Bench:
    """What every section runs on: the device, its shapes, the generator
    its inputs come from (seeded 0), and the one-rank communicators."""

    def __init__(self, device, shapes: Shapes = CARD_SHAPES, seed: int = 0):
        from smi_tpu_torch.parallel.mesh import make_communicator

        self.device = torch.device(device)
        self.shapes = shapes
        #: a record's roofline shares are card metrics: none on the CPU
        #: (the meta device's dry run keeps them, to check their keys)
        self.rooflines = self.device.type != "cpu"
        # the meta device (a dry run: shapes, no data) has no generator
        self.gen = (torch.Generator(device=self.device).manual_seed(seed)
                    if self.device.type in ("cpu", "cuda") else None)
        self.sp = make_communicator(shape=(1,), axis_names=("sp",),
                                    device=self.device)
        self.grid = make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                      device=self.device)
        self.grid2d = make_communicator(shape=(1, 1),
                                        axis_names=("sx", "sy"),
                                        device=self.device)

    def randn(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=dtype)

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def result(self, metric, value, unit, config, roofline=None) -> dict:
        return _result(metric, value, unit, config,
                       roofline if self.rooflines else None)


def _mfu_roofline(tflops: float, dtype_name: str) -> dict:
    """Roofline ratios for a TFLOP/s metric: always vs the bf16 peak,
    plus the reachable f32 peak for f32 points."""
    roofline = {"mfu_vs_bf16_peak": tflops * 1e12 / PEAK_BF16,
                "peak_bf16_tflops": PEAK_BF16 / 1e12}
    if dtype_name == "f32":
        roofline["mfu_vs_f32_effective_peak"] = (
            tflops * 1e12 / PEAK_F32_EFFECTIVE
        )
        roofline["peak_f32_effective_tflops"] = PEAK_F32_EFFECTIVE / 1e12
    return roofline


def _done(t: torch.Tensor) -> float:
    """Wait for ``t`` and read it back (``.item()`` synchronises)."""
    return float(t.float().sum().item())


def _timed(fn, runs: Optional[int] = None):
    """Best-of-N wall time of ``fn()`` (must block on the result)."""
    fn()  # warm: first-call costs (allocation, kernel build)
    return min(_one(fn) for _ in range(RUNS if runs is None else runs))


def _one(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def diff_rate(make_fn, work_per_rep: float, r1: int = 1, factor: int = 4,
              min_delta: Optional[float] = None, runs: Optional[int] = None,
              max_reps: int = 512):
    """Differential throughput: work / (t(r2) - t(r1)).

    Every call pays a fixed cost (launches, the readback, host work)
    beside the work it times. Timing two rep counts and dividing the
    *extra* work by the *extra* time cancels every fixed cost. Rep counts
    escalate geometrically until the delta reaches ``min_delta`` seconds
    (``MIN_DELTA`` by default; ``runs`` defaults to ``RUNS``).

    ``make_fn(r)`` must return a nullary callable running ``r`` reps and
    blocking on the result. Returns ``(rate, (r1, r2, t1, t2))``.

    ``max_reps`` caps the rep count BEFORE a chain is ever built: some
    harnesses grow per-rep state with ``r`` (a grad-of-reps chain saves
    every rep's residuals), so "time it first, notice the cap after"
    could run out of device memory on the way to the cap.
    """
    # this guard is EAGER: it fires before make_fn is ever called, so a
    # degenerate computed cap fails before any allocation
    if r1 >= max_reps:
        raise ValueError(
            f"diff_rate needs r1 < max_reps to escalate (got r1={r1}, "
            f"max_reps={max_reps}); a same-rep pair has zero work delta "
            f"and would silently record a 0-rate measurement"
        )
    min_delta = MIN_DELTA if min_delta is None else min_delta
    t1 = _timed(make_fn(r1), runs)
    while True:
        r2 = min(r1 * factor, max_reps)
        t2 = _timed(make_fn(r2), runs)
        if t2 - t1 >= min_delta or r2 >= max_reps:
            rate = (r2 - r1) * work_per_rep / max(t2 - t1, 1e-9)
            return rate, (r1, r2, round(t1, 4), round(t2, 4))
        r1, t1 = r2, t2


def _result(metric, value, unit, config, roofline=None):
    rec = {
        "metric": metric,
        "value": round(float(value), 4),
        "unit": unit,
        "config": config,
    }
    if roofline:
        rec["roofline"] = {
            k: round(float(v), 4) for k, v in roofline.items()
        }
    print(json.dumps(rec), flush=True)
    return rec


def _attention_flops(s: int, h: int, d: int, causal: bool,
                     train: bool) -> float:
    """Matmul FLOPs of one attention application.

    Forward: QKᵀ and PV, 2·S²·H·D each. Backward (flash2 recompute):
    five S²-shaped matmuls (scores recompute, dV, dP, dQ, dK). Causal
    halves the live area.
    """
    matmuls = 7 if train else 2
    flops = matmuls * 2 * s * s * h * d
    return flops / 2 if causal else flops


def _grads(fn, q, k, v):
    """``(dq, dk, dv)`` of ``sum(fn(q, k, v)**2)`` in f32."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    loss = (fn(q, k, v).float() ** 2).sum()
    return torch.autograd.grad(loss, (q, k, v))


# ---------------------------------------------------------------------------
# Flash attention: forward / train MFU, tier ratios, stock comparison
# ---------------------------------------------------------------------------


def flash_forward_points(b: Bench, quick: bool = False):
    """Flash forward at several (S, dtype) points with MFU."""
    from smi_tpu_torch.models.ring_attention import make_ring_attention_fn

    h, d = b.shapes.heads, b.shapes.head_dim
    points = b.shapes.fwd[:2] if quick else b.shapes.fwd
    out = []
    for s, name in points:
        q, k, v = (b.randn((s, h, d), _DTYPES[name]) for _ in range(3))

        def make_fn(r, _q=q, _k=k, _v=v):
            fn = make_ring_attention_fn(b.sp, causal=True, use_flash=True,
                                        reps=r)
            return lambda: _done(fn(_q, _k, _v))

        work = _attention_flops(s, h, d, causal=True, train=False)
        rate, trace = diff_rate(make_fn, work)
        tflops = rate / 1e12
        out.append(b.result(
            f"flash_attn_fwd_s{s}_{name}", tflops, "TFLOP/s",
            {"S": s, "H": h, "D": d, "dtype": name, "causal": True,
             "timing": trace},
            _mfu_roofline(tflops, name),
        ))
    return out


def flash_train_point(b: Bench, quick: bool = False):
    """Forward+backward (the flash tier's autograd) throughput and MFU."""
    from smi_tpu_torch.models.ring_attention import make_ring_attention_fn

    s = b.shapes.train_seq // (2 if quick else 1)
    h, d = b.shapes.heads, b.shapes.head_dim
    out = []
    for name in (("f32",) if quick else ("f32", "bf16")):
        q, k, v = (b.randn((s, h, d), _DTYPES[name]) for _ in range(3))

        def make_fn(r, _q=q, _k=k, _v=v):
            fn = make_ring_attention_fn(b.sp, causal=True, reps=r)
            return lambda: _done(_grads(fn, _q, _k, _v)[0])

        work = _attention_flops(s, h, d, causal=True, train=True)
        # the grad chain saves every rep's (q, out, stats): cap it
        cap = 256 if name == "bf16" else 128
        rate, trace = diff_rate(make_fn, work, max_reps=cap)
        tflops = rate / 1e12
        tokens = rate / work * s
        out.append(b.result(
            f"flash_attn_train_tflops_{name}", tflops, "TFLOP/s",
            {"S": s, "H": h, "D": d, "dtype": name, "causal": True,
             "timing": trace},
            _mfu_roofline(tflops, name),
        ))
        out.append(b.result(
            f"flash_attn_train_tokens_{name}", tokens / 1e6, "Mtoken/s",
            {"S": s, "H": h, "D": d, "dtype": name},
        ))
    return out


def longcontext_points(b: Bench, quick: bool = False):
    """The long-context ladder on one card: full causal at the first
    rung, the sliding-window forward at every length (grouped-query K/V
    from the fifth rung up), and training through the flash backward,
    one harness for every row: chained SGD steps (forward, backward and
    an in-place update), with the older rep chain (grad of chained reps)
    as a secondary column where its saved residuals fit."""
    from smi_tpu_torch.models.ring_attention import make_ring_attention_fn

    if quick:
        return []
    sh = b.shapes
    h, d, w = sh.heads, sh.head_dim, sh.window
    bf16 = torch.bfloat16
    out = []
    for s, windowed, h_kv in sh.longcontext_fwd:
        window = w if windowed else None
        q = b.randn((s, h, d), bf16)
        k, v = (b.randn((s, h_kv, d), bf16) for _ in range(2))

        def make_fn(r, _w=window, _q=q, _k=k, _v=v):
            fn = make_ring_attention_fn(b.sp, causal=True, use_flash=True,
                                        reps=r, window=_w)
            return lambda: _done(fn(_q, _k, _v))

        # full causal: S²/2 live area; windowed: ~S·window
        if window is None:
            work = _attention_flops(s, h, d, causal=True, train=False)
        else:
            work = 2 * 2 * s * window * h * d
        rate, trace = diff_rate(make_fn, work)
        tag = "causal" if window is None else f"window{window}"
        if h_kv != h:
            tag = f"gqa{h // h_kv}_{tag}"
        out.append(b.result(
            f"flash_attn_fwd_s{s}_bf16_{tag}", rate / 1e12, "TFLOP/s",
            {"S": s, "H": h, "D": d, "kv_heads": h_kv, "dtype": "bf16",
             "window": window, "timing": trace},
            {"mfu_vs_bf16_peak": rate / PEAK_BF16},
        ))
        del q, k, v

    for s, h_kv, rep_chain in sh.longcontext_train:
        q0 = b.randn((s, h, d), bf16)
        k0, v0 = (b.randn((s, h_kv, d), bf16) for _ in range(2))
        attn = make_ring_attention_fn(b.sp, causal=True, use_flash=True,
                                      window=w)

        def make_steps(r, _q0=q0, _k0=k0, _v0=v0, _attn=attn):
            def run():
                q, k, v = _q0, _k0, _v0
                for _ in range(r):
                    dq, dk, dv = _grads(_attn, q, k, v)
                    q = q - 1e-6 * dq.to(q.dtype)
                    k = k - 1e-6 * dk.to(k.dtype)
                    v = v - 1e-6 * dv.to(v.dtype)
                return _done(q)
            return run

        # short rows take many cheap steps to fill the timing window;
        # the longest row's single step already takes long
        r1, factor, cap = ((1, 3, 6) if s >= sh.single_step_from
                           else (4, 4, 256))
        rate, trace = diff_rate(make_steps, s, r1=r1, factor=factor,
                                max_reps=cap)
        tag = "" if h_kv == h else f"_gqa{h // h_kv}"
        cfg = {"S": s, "H": h, "D": d, "kv_heads": h_kv, "dtype": "bf16",
               "window": w, "harness": "step-chain", "timing": trace}

        if rep_chain:
            def make_train(r, _s=s, _q=q0, _k=k0, _v=v0):
                fn = make_ring_attention_fn(
                    b.sp, causal=True, reps=r, window=w,
                    remat_reps=_s >= sh.remat_from,
                )
                return lambda: _done(_grads(fn, _q, _k, _v)[0])

            rc_rate, rc_trace = diff_rate(make_train, s)
            cfg["rep_chain_mtokens"] = round(rc_rate / 1e6, 4)
            cfg["rep_chain_timing"] = rc_trace

        out.append(b.result(
            f"flash_attn_train_tokens_s{s}{tag}_window{w}_bf16",
            rate / 1e6, "Mtoken/s", cfg,
        ))
        del q0, k0, v0
    return out


def flash_vs_jnp(b: Bench, quick: bool = False):
    """Flash tier speedup over the plain (materialised) tier."""
    from smi_tpu_torch.models.ring_attention import make_ring_attention_fn

    s = b.shapes.ratio_seq // (2 if quick else 1)
    h, d = b.shapes.heads, b.shapes.head_dim
    q, k, v = (b.randn((s, h, d)) for _ in range(3))
    rates = {}
    for use_flash in (True, False):
        def make_fn(r, _uf=use_flash):
            fn = make_ring_attention_fn(b.sp, causal=True, use_flash=_uf,
                                        reps=r)
            return lambda: _done(fn(q, k, v))

        rates[use_flash], _ = diff_rate(make_fn, 1.0)
    return [b.result(
        "flash_vs_jnp_speedup", rates[True] / rates[False], "x",
        {"S": s, "H": h, "D": d, "dtype": "f32", "causal": True},
    )]


#: the SDPA backends the swept stock row picks the best of
STOCK_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def flash_vs_stock(b: Bench, quick: bool = False):
    """Our flash kernel vs PyTorch's stock attention
    (``torch.nn.functional.scaled_dot_product_attention``), same shapes.

    Two rows: ``flash_vs_stock_default`` is SDPA at PyTorch's own choice
    of backend; ``flash_vs_stock_swept`` is SDPA at the best of its
    flash, memory-efficient and cuDNN backends, each forced in turn
    (``torch.nn.attention.sdpa_kernel``), the kernel-vs-kernel row. SDPA
    has no block sizes to sweep, so the swept row's ``block_q_kmajor_k``
    names the winning backend. A backend that refuses the shape is left
    out with its reason logged. SDPA is a yardstick the port's attention
    never calls.
    """
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from smi_tpu_torch.models.ring_attention import make_ring_attention_fn

    s = b.shapes.stock_seq // (2 if quick else 1)
    h, d = b.shapes.heads, b.shapes.head_dim
    q, k, v = (b.randn((s, h, d), torch.bfloat16) for _ in range(3))
    work = _attention_flops(s, h, d, causal=True, train=False)

    def make_ours(r):
        fn = make_ring_attention_fn(b.sp, causal=True, use_flash=True,
                                    reps=r)
        return lambda: _done(fn(q, k, v))

    rate_ours, trace_ours = diff_rate(make_ours, work)

    # stock layout is (batch, heads, seq, head_dim)
    qb, kb, vb = (t.transpose(0, 1)[None].contiguous() for t in (q, k, v))

    def make_stock(r, backend=None):
        def run():
            forced = (sdpa_kernel([getattr(SDPBackend, backend)])
                      if backend else contextlib.nullcontext())
            with forced:
                # the output is the next query, so the calls are
                # loop-carried, as in the JAX harness
                qi = qb
                for _ in range(r):
                    qi = F.scaled_dot_product_attention(
                        qi, kb, vb, is_causal=True).to(qb.dtype)
            return _done(qi)
        return run

    rate_stock, trace_stock = diff_rate(make_stock, work)
    out = [b.result(
        "flash_vs_stock_default", rate_ours / rate_stock, "x",
        {"S": s, "H": h, "D": d, "dtype": "bf16", "causal": True,
         "note": ">1 means ours is faster; stock is SDPA at PyTorch's "
                 "default backend choice — see flash_vs_stock_swept for "
                 "the best backend",
         "timing_ours": trace_ours, "timing_stock": trace_stock},
        {"ours_tflops": rate_ours / 1e12,
         "stock_tflops": rate_stock / 1e12,
         "mfu_ours_vs_bf16_peak": rate_ours / PEAK_BF16},
    )]
    if quick:
        return out

    # fixed rep pairs per backend; the best backend wins
    def pair_rate(mk, r1=64, r2=256):
        t1 = _timed(mk(r1))
        t2 = _timed(mk(r2))
        return (r2 - r1) * work / max(t2 - t1, 1e-9), (r1, r2,
                                                       round(t1, 4),
                                                       round(t2, 4))

    best = (0.0, None, None)
    for backend in STOCK_BACKENDS:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                r, tr = pair_rate(lambda n, _b=backend: make_stock(n, _b))
            except RuntimeError as exc:
                reasons = "; ".join(str(w.message) for w in caught)
                print(f"stock sweep: {backend} refuses S={s} H={h} D={d} "
                      f"bf16 causal: {str(exc).splitlines()[0]}"
                      f"{' (' + reasons + ')' if reasons else ''}",
                      file=sys.stderr, flush=True)
                continue
        if r > best[0]:
            best = (r, backend, tr)
    rate_swept, swept_cfg, trace_swept = best
    if swept_cfg is None:
        raise RuntimeError(f"no SDPA backend takes S={s} H={h} D={d} bf16 "
                           f"causal on {b.device}")
    out.append(b.result(
        "flash_vs_stock_swept", rate_ours / rate_swept, "x",
        {"S": s, "H": h, "D": d, "dtype": "bf16", "causal": True,
         "note": ">1 means ours is faster; stock is SDPA at its best "
                 "backend, forced (the kernel-vs-kernel row)",
         "block_q_kmajor_k": swept_cfg,
         "timing_ours": trace_ours, "timing_stock": trace_swept},
        {"ours_tflops": rate_ours / 1e12,
         "stock_swept_tflops": rate_swept / 1e12},
    ))
    return out


def roll_chain_points(b: Bench, quick: bool = False):
    """Isolated shift rates: chains of dependent whole-array shifts by
    one, each step a warp shuffle and a select of every element in
    registers, with nothing else in the kernel (``kernels/roll.py``).

    The port's stencil kernels take a horizontal neighbour by exactly
    such a shuffle (``csrc/stencil_wavefront.cuh``), so this prices the
    access their bound leaves out. Two chain lengths (R and R/4) per
    axis, each timed differentially over data-dependently chained
    launches; the per-element rate comes from the R-difference, where
    per-launch device-memory traffic and launch overhead cancel.

    Two variants per axis. ``ilp=1`` is ONE chain over the whole array;
    ``ilp=2`` runs TWO independent chains over half-height arrays (the
    same elements a step) in one launch, each line of each chain on a
    warp of its own: twice the independent shuffles in flight on the
    card, the throughput pin.
    """
    from smi_tpu_torch.kernels.roll import roll_chain

    if quick:
        return []
    rows, cols = b.shapes.roll
    elems = rows * cols
    r_lo, r_hi = b.shapes.roll_lengths

    def measure(metric, body, ilp):
        """Chain ``body`` ``ilp`` independent ways over half-height
        arrays and return the ps/elem row from the R-differential."""
        n_rows = rows // ilp
        xs0 = tuple(b.randn((n_rows, cols)) for _ in range(ilp))

        def make_fn_for(R):
            def make_fn(r):
                def run():
                    xs = xs0
                    for _ in range(r):
                        xs = roll_chain(xs, R, body)
                    return sum(_done(x) for x in xs)
                return run
            return make_fn

        per_rep = {}
        traces = {}
        for R in (r_lo, r_hi):
            rate, trace = diff_rate(
                make_fn_for(R), 1.0, r1=4, factor=4, max_reps=1024
            )
            per_rep[R], traces[R] = 1.0 / rate, trace
        ps = (per_rep[r_hi] - per_rep[r_lo]) / (
            (r_hi - r_lo) * elems
        ) * 1e12
        return b.result(
            metric, ps, "ps/elem",
            {"rows": n_rows, "cols": cols, "chains": ilp,
             "chain_lengths": [r_lo, r_hi],
             "per_rep_s": {str(k): round(v, 6)
                           for k, v in per_rep.items()},
             "timing": traces[r_hi]},
        )

    out = [
        measure(f"roll_chain_{body}{'' if ilp == 1 else f'_ilp{ilp}'}"
                "_ps_per_elem", body, ilp)
        for body in ("lane", "sublane")
        for ilp in (1, 2)
    ]
    # Harness floor: the same chain with an add of 1.0 on the same
    # registers in the same loop: subtracting it from the roll rates
    # isolates the shuffle and the select.
    out.append(measure("roll_chain_baseline_add_ps_per_elem", "add", 1))
    return out


def model_train_point(b: Bench, quick: bool = False):
    """Whole-model training throughput: the transformer block (QKV/O +
    MLP matmuls + ring attention + layernorms + SGD) in mixed precision,
    at S=8192 full causal and at 32k tokens with the sliding window, and
    the 4-block stack (per-block activation checkpointing)."""
    from smi_tpu_torch.models import transformer as tf

    if quick:
        return []
    sh = b.shapes
    e, h, d = sh.embed, sh.heads, sh.head_dim
    out = []
    for s, windowed, layers in sh.model:
        window = sh.window if windowed else None
        cfg = tf.BlockConfig(embed=e, heads=h, head_dim=d,
                             compute_dtype="bfloat16", window=window)
        model = (tf.TransformerBlock(cfg, device=b.device) if layers == 1
                 else tf.TransformerStack(cfg, layers, device=b.device))
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        x = b.randn((1, s, e))

        def make_fn(r, _cfg=cfg, _model=model, _start=start, _x=x,
                    _layers=layers):
            step = tf.make_train_step(b.grid, _cfg, layers=_layers)

            def run():
                # every run starts from the same parameters, as the JAX
                # harness's functional steps do
                with torch.no_grad():
                    for n, p in _model.named_parameters():
                        p.copy_(_start[n])
                loss = None
                for _ in range(r):
                    loss = step(_model, _x, _x)
                return _done(loss)

            return run

        rate, trace = diff_rate(make_fn, s)
        # block FLOPs per token, fwd+bwd (x3): QKV (2*E*3HD) + O (2*HD*E)
        # + MLP (2*2*ratio*E^2) + attention per token (4*S*H*D/2 causal,
        # the exact causal average; 4*window*H*D windowed, the
        # full-window upper bound)
        matmul = (2 * e * 3 * h * d + 2 * h * d * e
                  + 4 * cfg.mlp_ratio * e * e)
        attn = 4 * window * h * d if window else 4 * s * h * d / 2
        # fwd+bwd = 3x fwd flops per layer; per-block recompute re-runs
        # each forward once more under the backward (4x) for layers > 1
        passes = 3 if layers == 1 else 4
        tflops = rate * layers * passes * (matmul + attn) / 1e12
        tag = "" if window is None else f"_s{s}_window{window}"
        if layers > 1:
            tag += f"_l{layers}"
        out.append(b.result(
            f"transformer_train_tokens{tag}_bf16", rate / 1e6,
            "Mtoken/s",
            {"S": s, "embed": e, "H": h, "D": d, "compute": "bf16",
             "window": window, "layers": layers, "timing": trace},
            {"approx_tflops": tflops,
             "mfu_vs_bf16_peak": tflops * 1e12 / PEAK_BF16},
        ))
        del model, start, x
    return out


# ---------------------------------------------------------------------------
# Stencil tiers + roofline
# ---------------------------------------------------------------------------


def stencil_roofline(cells_per_sec: float, depth: int) -> dict:
    """Both roofline views of a stencil rate.

    Device-memory model: one pass reads and writes the grid once for
    ``depth`` sweeps, 8 bytes / (cell·sweep·depth). f32 model: 4 flops
    per cell-sweep (3 adds, 1 multiply) over the card's f32 peak.
    """
    hbm_bytes_per_sec = cells_per_sec * 8.0 / max(depth, 1)
    essential = cells_per_sec * STENCIL_ESSENTIAL_FLOPS
    return {
        "vs_hbm_roofline": hbm_bytes_per_sec / PEAK_HBM,
        "vs_f32_roofline": essential / PEAK_F32_EFFECTIVE,
        "essential_gflops": essential / 1e9,
        "depth": depth,
    }


def stencil_tiers(b: Bench, quick: bool = False):
    """Fused (1 sweep/pass) vs temporal (k sweeps/pass) kernel tiers."""
    from smi_tpu_torch.kernels.stencil import make_fused_stencil_fn
    from smi_tpu_torch.kernels.stencil_temporal import (
        make_temporal_stencil_fn,
        pick_temporal_depth,
    )

    size = b.shapes.stencil // (2 if quick else 1)
    # the hot-top-edge initial grid, made on the device
    grid = torch.zeros((size, size), device=b.device)
    grid[0] = 1.0
    out = []
    rates = {}

    depth = pick_temporal_depth(size, size, torch.float32, 256)
    tiers = [("fused", lambda it: make_fused_stencil_fn(
        b.grid2d, it, size, size), 1)]
    if depth is not None:
        tiers.append(
            ("temporal",
             lambda it: make_temporal_stencil_fn(
                 b.grid2d, it, size, size, depth=depth), depth)
        )
    for name, make, k in tiers:
        # iterations are the rep knob; keep them multiples of the depth
        def make_fn(r, _make=make, _k=k):
            fn = _make(r * _k * 8)
            return lambda: _done(fn(grid))

        rate, trace = diff_rate(make_fn, size * size * k * 8)
        rates[name] = rate
        out.append(b.result(
            f"stencil_{name}_gcells", rate / 1e9, "Gcell/s",
            {"size": size, "depth": k, "timing": trace},
            stencil_roofline(rate, k),
        ))
    if len(rates) == 2:
        out.append(b.result(
            "stencil_temporal_vs_fused", rates["temporal"] / rates["fused"],
            "x", {"size": size, "depth": depth},
        ))
    return out


# ---------------------------------------------------------------------------
# On-chip application workloads
# ---------------------------------------------------------------------------


def onchip_apps(b: Bench, quick: bool = False):
    """Single-card GESUMMV (device-memory-bound matvec) and K-means."""
    from smi_tpu_torch.models import kmeans, onchip
    from smi_tpu_torch.parallel.local import LocalWorld

    out = []
    n = b.shapes.gesummv // (2 if quick else 1)
    a = b.rand((n, n))
    bm = b.rand((n, n))
    x = b.rand((n,))
    gfn = onchip.make_gesummv_onchip_fn(1.5, 0.5)

    def make_gesummv(r):
        def run():
            xi = x
            for _ in range(r):
                y = gfn(a, bm, xi)
                xi = y / y.abs().max()  # keep magnitudes bounded
            return _done(xi)
        return run

    rate, trace = diff_rate(make_gesummv, 4 * n * n, r1=4, factor=4)
    gflops = rate / 1e9
    # two matvecs: read both matrices once → 8 B/cell → flops/byte = 0.5
    hbm_bound = PEAK_HBM * (4 * n * n) / (8 * n * n) / 1e9
    out.append(b.result(
        "gesummv_onchip_gflops", gflops, "GFLOP/s",
        {"n": n, "timing": trace},
        {"vs_hbm_roofline": gflops / hbm_bound,
         "hbm_roofline_gflops": hbm_bound},
    ))
    del a, bm, x

    points, k, dims = b.shapes.kmeans_points, 8, 2
    pts = b.rand((points, dims))
    init = pts[:k].clone()
    world = LocalWorld(1, device=b.device)

    def make_kmeans(r):
        kfn = kmeans.make_kmeans_fn(world, iterations=r * 10)
        return lambda: _done(kfn(pts, init))

    rate, trace = diff_rate(make_kmeans, points * 10)
    out.append(b.result(
        "kmeans_mpoint_iters", rate / 1e6,
        "Mpoint-iter/s",
        {"points": points, "k": k, "dims": dims, "timing": trace},
    ))
    return out


# ---------------------------------------------------------------------------

SECTIONS = {
    "fwd": flash_forward_points,
    "longcontext": longcontext_points,
    "train": flash_train_point,
    "model": model_train_point,
    "ratio": flash_vs_jnp,
    "stock": flash_vs_stock,
    "tiers": stencil_tiers,
    "rolls": roll_chain_points,
    "apps": onchip_apps,
}


def card_header() -> dict:
    """The card's name (``torch.cuda.get_device_name``) and the peaks
    with ``nvidia-smi``'s name and power limit beside them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return {
        "device": torch.cuda.get_device_name(0),
        "rooflines": {
            "peak_bf16_tflops": PEAK_BF16 / 1e12,
            "peak_hbm_gbps": PEAK_HBM / 1e9,
            "peak_f32_effective_tflops": PEAK_F32_EFFECTIVE / 1e12,
            "source": "NVIDIA H100 SXM data sheet, dense, at 700 W",
            "nvidia_smi": smi,
        },
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="smaller shapes (smoke/CI)")
    p.add_argument("-o", "--output", default=None,
                   help=f"artifact path (default {OUT_DIR}/PERF.json, with "
                        f"_quick and _cpu in the name under --quick and "
                        f"--cpu)")
    p.add_argument("--only", nargs="*", default=None, choices=list(SECTIONS),
                   help="subset of the sections")
    p.add_argument("--fresh", action="store_true",
                   help="overwrite the output instead of merging by "
                        "metric name (a partial --only/--quick run must "
                        "not clobber the rest of the artifact)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU at the tiny CPU_SHAPES (tests and "
                        "rehearsal; no rooflines)")
    args = p.parse_args(argv)
    if args.output is None:
        name = ("PERF" + ("_quick" if args.quick else "")
                + ("_cpu" if args.cpu else "") + ".json")
        args.output = str(OUT_DIR / name)

    if args.cpu:
        bench = Bench("cpu", CPU_SHAPES)
        header = {"device": "cpu", "rooflines": None}
    else:
        from smi_tpu_torch.parallel.mesh import resolve_device

        bench = Bench(resolve_device(), CARD_SHAPES)
        header = card_header()
    selected = args.only or list(SECTIONS)
    results = []
    for name in selected:
        results.extend(SECTIONS[name](bench, quick=args.quick))
    payload = dict(header, metrics=results)
    if not args.fresh and os.path.exists(args.output):
        # merge: fresh measurements replace same-named metrics, every
        # other row (and extra keys) survives
        with open(args.output) as f:
            old = json.load(f)
        fresh = {m["metric"] for m in results}
        kept = [m for m in old.get("metrics", [])
                if m["metric"] not in fresh]
        merged = dict(old)
        merged.update(payload)
        merged["metrics"] = kept + results
        payload = merged
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
