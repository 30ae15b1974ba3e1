#!/usr/bin/env python3
"""Drive smi_tpu_torch's main path once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``; without a card it exits non-zero
and prints no result. The phases:

1. the device, with the card's name and power limit from ``nvidia-smi``;
2. the build of every CUDA kernel of the path from ``smi_tpu_torch/kernels/csrc``;
3. the single-sweep kernel against its plain PyTorch version on the card
   (``array_equal``): 8192x8192 with zero halos, and a 4096x2048 block
   with random halos at a nonzero offset inside an 8192x8192 grid;
4. the k-sweep kernel against its plain version, at k=8 and k=16 on the
   same two shapes, with random corner-complete halos on the second;
5. the main path at full width — the 8192x8192 f32 Jacobi stencil on a
   1x1 rank grid through ``make_communicator``, ``pick_temporal_depth``
   and ``make_temporal_stencil_fn`` with 16*k+3 sweeps, so the remainder
   runs on the single-sweep kernel — held ``array_equal`` to the plain
   PyTorch stencil on the card; then the same path on a 4096x2048 grid,
   the reference's per-rank block on its 2x4 grid, with the launch
   counts set to 0 before each run and read after it, and both kernels
   launched in each; then 1024x1024 against the numpy serial reference;
6. each kernel's time at the main path's shapes (CUDA events), beside its
   bound, its plain version's time and a PyTorch yardstick.

Then ring attention's forward (``smi_tpu_torch/kernels/csrc/flash_fwd.cu``,
built in phase 2 with the stencil sources), with TF32 off throughout:

7. the fused flash kernel against its plain version on the card, at the
   widths of the JAX package's attention rows (H=8, D=128): S=8192 causal
   in f32 and bf16, S=4096 non-causal f32, and S=32768 with one K/V head
   and a 4096 window in bf16;
8. the carried flash kernel against its plain version: one rank's steps
   of a 4-rank ring over S=8192 (2048 rows at q_off=6144) from a carry of
   an earlier fold, on a past block, the diagonal block and a future
   block (which must return the carry ``array_equal``), in f32 and bf16,
   and the GQA 8:1 window-4096 case at the window's edge;
9. the main path at full width: ``make_communicator(shape=(1,),
   axis_names=("sp",))`` and ``make_ring_attention_fn`` with ``use_flash``
   at its default, at the four shapes of phase 7, each held to float64
   ``reference_attention_rows`` on 256 rows (the first and the last among
   them), each run making one fused launch and no carried launch;
10. an emulated 4-rank ring over S=8192 in one process, causal f32, causal
   bf16 and GQA 8:1 window 4096 bf16: ``make_ring_attention_fn`` runs on
   each rank's shards with ``ring_shift`` stood in by a shift that hands
   each rank its left neighbour's block, so the ring schedule itself
   runs; each rank's output equals its rows of the fused output, in 16
   carried launches per ring;
11. each flash kernel's time at those shapes beside its bound, its plain
   version's time and ``scaled_dot_product_attention``'s.

Bars: f32 out/acc within 2e-5 (``rtol = atol``); m and l within 1e-5 in
either dtype (both sides add exact products in f32); bf16 out/acc by the
worst row's relative error ``||got - want|| / ||want||``, within 1e-2,
and each bf16 kernel check also reads a control (the plain version with
one live key tile dropped), which must land above that bar.

Any failure raises and exits non-zero. The line before the last is the
per-kernel JSON record; the last line is the device JSON.
"""

import json
import math
import subprocess
import sys
import time

SEED = 1234
N = 8192                  # the reference's hardware grid (models/stencil.py)
BLOCK = (4096, 2048)      # one rank's block of 8192^2 on the 2x4 grid
BLOCK_AT = (4096, 6144)   # its offset: the bottom-right rank, on two edges
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at 700 W
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
HEADS, HEAD_DIM = 8, 128    # the JAX package's attention rows (PERF.json)
SEQ, SEQ_LONG, WINDOW = 8192, 32768, 4096
RING = 4                    # the emulated ring's ranks


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import stencil as kstencil
    from smi_tpu_torch.kernels import stencil_temporal as ktemporal

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float32)

    # ---- 1. device ---------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[1 device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")
    log(smi_line)

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    _build.build_kernels()
    log(f"[2 build] {_build.SOURCES} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  {name}: {line.strip()}")

    max_err = {}   # (kernel, shape, depth) -> max abs err of its check

    def expect_equal(what, key, got, want):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err[key] = max(max_err.get(key, 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel != plain, max abs err {err}")
        log(f"  {what}: array_equal (max abs err {err})")

    bh, bw = BLOCK
    r0, c0 = BLOCK_AT

    # ---- 3. single-sweep kernel vs its plain version -----------------
    log("[3 sweep kernel vs plain]")
    x = rand(N, N)
    z_row, z_col = torch.zeros(1, N, device=dev), torch.zeros(N, 1, device=dev)
    args = (x, z_row, z_row, z_col, z_col, 0, 0, N, N)
    expect_equal(f"{N}x{N} zero halos", ("sweep", (N, N), 1),
                 kstencil.fused_sweep(*args), kstencil.fused_sweep_plain(*args))
    xb = rand(bh, bw)
    args_b = (xb, rand(1, bw), rand(1, bw), rand(bh, 1), rand(bh, 1),
              r0, c0, N, N)
    expect_equal(f"{bh}x{bw} at {BLOCK_AT} random halos",
                 ("sweep", BLOCK, 1),
                 kstencil.fused_sweep(*args_b),
                 kstencil.fused_sweep_plain(*args_b))

    # ---- 4. k-sweep kernel vs its plain version ----------------------
    log("[4 k-sweep kernel vs plain]")
    for k in (8, 16):
        zt = torch.zeros(k, N + 2 * k, device=dev)
        zs = torch.zeros(N, k, device=dev)
        args = (x, zt, zt, zs, zs, 0, 0, N, N, k)
        expect_equal(f"{N}x{N} k={k} zero halos, tile "
                     f"{ktemporal._plan(N, N, k)}",
                     ("temporal", (N, N), k),
                     ktemporal.temporal_sweeps(*args),
                     ktemporal.temporal_sweeps_plain(*args))
        args_b = (xb, rand(k, bw + 2 * k), rand(k, bw + 2 * k),
                  rand(bh, k), rand(bh, k), r0, c0, N, N, k)
        expect_equal(f"{bh}x{bw} at {BLOCK_AT} k={k} random halos, tile "
                     f"{ktemporal._plan(bh, bw, k)}",
                     ("temporal", BLOCK, k),
                     ktemporal.temporal_sweeps(*args_b),
                     ktemporal.temporal_sweeps_plain(*args_b))
    del x, xb, args, args_b

    # ---- 5. the main path at full width ------------------------------
    log("[5 main path]")
    comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"))
    depth = st.pick_temporal_depth(N, N, torch.float32, 256)
    if depth is None:
        raise AssertionError(f"no temporal depth for {N}x{N}")
    iters = 16 * depth + 3

    def drive(h, w):
        """The main path on an (h, w) grid: the launches it made."""
        g = st.initial_grid(h, w)
        g[:, -1] = 2.0
        block = st.block_from_numpy(g, comm)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = st.make_temporal_stencil_fn(comm, iters, h, w,
                                          depth=depth)(block)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        log(f"  {h}x{w} on {comm.device} grid {comm.shape}, depth {depth}, "
            f"{iters} sweeps: {wall * 1e3:.3f} ms host wall, "
            f"launches {launches}")
        if tuple(out.shape) != (h, w) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"main path output is not a finite "
                                 f"{(h, w)} grid")
        for name in ("stencil_sweep", "stencil_temporal"):
            n = launches[name]
            if n <= 0:
                raise AssertionError(f"kernel {name} was not launched on "
                                     f"the {h}x{w} main path")
        plain = st.make_stencil_fn(comm, iters)(block)
        torch.cuda.synchronize()
        if not torch.equal(out, plain):
            err = (out - plain).abs().max().item()
            raise AssertionError(f"{h}x{w} main path != plain stencil, max "
                                 f"abs err {err}")
        log(f"  {h}x{w}: array_equal to the plain torch stencil on the card")
        return launches

    launches = {(N, N): drive(N, N), BLOCK: drive(bh, bw)}
    small = st.initial_grid(1024, 1024)
    small[:, -1] = 2.0
    out_s = st.make_temporal_stencil_fn(comm, iters, 1024, 1024,
                                        depth=depth)(
        st.block_from_numpy(small, comm))
    if not np.array_equal(st.grid_to_numpy(out_s, comm),
                          st.reference_stencil(small, iters)):
        raise AssertionError("1024x1024 main path != numpy reference_stencil")
    log(f"  1024x1024: array_equal to the numpy reference_stencil")
    del out_s

    # ---- 6. times ----------------------------------------------------
    log("[6 times]")

    def time_ms(fn, reps):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def bound(h, w, k, halo_elems):
        nbytes = 4 * (2 * h * w + halo_elems)
        ops = 4 * h * w * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    torch.backends.cudnn.allow_tf32 = False
    cross = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                          [0.0, 0.25, 0.0]], device=dev).view(1, 1, 3, 3)

    records = []
    x = rand(N, N)
    args = (x, z_row, z_row, z_col, z_col, 0, 0, N, N)
    ms = time_ms(lambda: kstencil.fused_sweep(*args), 50)
    plain_ms = time_ms(lambda: kstencil.fused_sweep_plain(*args), 10)
    x4 = x.view(1, 1, N, N)
    lib_ms = time_ms(lambda: F.conv2d(x4, cross, padding=1), 20)
    b_ms, b_by = bound(N, N, 1, 4 * N)
    log(f"  sweep {N}x{N}: {ms:.4f} ms ({N * N / ms * 1e3:.4g} cells/s), "
        f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
        f"conv2d interior-average yardstick {lib_ms:.4f} ms")
    records.append({
        "name": f"stencil_sweep {N}x{N}", "route": "cuda",
        "source": "smi_tpu_torch/kernels/csrc/stencil_sweep.cu",
        "replaces": "smi_tpu/kernels/stencil.py:74",
        "launches": launches[(N, N)]["stencil_sweep"],
        "max_abs_err": max_err[("sweep", (N, N), 1)], "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    })
    for (h, w), replaces in (((N, N), "smi_tpu/kernels/stencil_temporal.py:385"),
                             (BLOCK, "smi_tpu/kernels/stencil_temporal.py:195")):
        k = depth
        xt = x[:h, :w].contiguous()
        zt = torch.zeros(k, w + 2 * k, device=dev)
        zs = torch.zeros(h, k, device=dev)
        args = (xt, zt, zt, zs, zs, 0, 0, h, w, k)
        ms = time_ms(lambda: ktemporal.temporal_sweeps(*args), 20)
        plain_ms = time_ms(lambda: ktemporal.temporal_sweeps_plain(*args), 3)
        b_ms, b_by = bound(h, w, k, 2 * k * (w + 2 * k) + 2 * h * k)
        log(f"  temporal {h}x{w} k={k} tile {ktemporal._plan(h, w, k)}: "
            f"{ms:.4f} ms ({h * w * k / ms * 1e3:.4g} cell-sweeps/s), "
            f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms")
        records.append({
            "name": f"stencil_temporal {h}x{w} k={k}", "route": "cuda",
            "source": "smi_tpu_torch/kernels/csrc/stencil_temporal.cu",
            "replaces": replaces,
            "launches": launches[(h, w)]["stencil_temporal"],
            "max_abs_err": max_err[("temporal", (h, w), k)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })

    # the depth picker's choice on this card: time per sweep at k=8 too
    for k in (8, 16):
        zt = torch.zeros(k, N + 2 * k, device=dev)
        zs = torch.zeros(N, k, device=dev)
        args = (x, zt, zt, zs, zs, 0, 0, N, N, k)
        ms = time_ms(lambda: ktemporal.temporal_sweeps(*args), 20)
        log(f"  depth {k} at {N}x{N}: {ms:.4f} ms per pass, "
            f"{ms / k:.5f} ms per sweep")

    records += flash_phases(dev, gen, time_ms, max_err)

    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


FLASH_SRC = "smi_tpu_torch/kernels/csrc/flash_fwd.cu"
REPLACES = {"flash_fused": "smi_tpu/kernels/flash.py:492",
            "flash_block": "smi_tpu/kernels/flash.py:436"}
F32_TOL, STAT_TOL = 2e-5, 1e-5   # f32 out/acc; m and l in either dtype
BF16_ROW_REL = 1e-2   # bf16 out/acc: worst per-row relative error
CONTROL_TILE = 64     # keys a control drops: one bf16 key tile


def live_pairs(s_q, s_k, q_off, k_off, causal, window=None):
    """Query-key pairs the mask leaves live: the work a forward needs
    (4·D operations each), counted from the global positions."""
    import numpy as np

    q_pos = q_off + np.arange(s_q, dtype=np.int64)
    lo = np.full_like(q_pos, k_off)
    hi = np.full_like(q_pos, k_off + s_k - 1)
    if causal:
        hi = np.minimum(hi, q_pos)
    if window is not None:
        lo = np.maximum(lo, q_pos - (window - 1))
    return int(np.clip(hi - lo + 1, 0, None).sum())


class EmulatedShift:
    """``ring_shift`` for one process that plays each rank of an n-rank
    ring in turn. Every rank runs the same steps, so a rank receives the
    block its left neighbour holds: the shard of the origin just before
    the one handed in. The handed-in block is found by value among the
    ranks' head-major K and V shards."""

    def __init__(self, blocks, n):
        self.blocks, self.n, self.calls = blocks, n, 0

    def __call__(self, x, comm, offset=1, axis_name=None, backend="xla"):
        import torch

        self.calls += 1
        for shards in self.blocks:
            for origin, t in enumerate(shards):
                if t.shape == x.shape and torch.equal(t, x):
                    return shards[(origin - offset) % self.n]
        raise AssertionError("ring_shift was handed a block no rank holds")


def flash_phases(dev, gen, time_ms, max_err):
    """Phases 7-11: ring attention's forward. Returns the flash kernels'
    records for the kernels line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import flash as kflash
    from smi_tpu_torch.models import ring_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    scale = 1.0 / math.sqrt(HEAD_DIM)

    def heads(h, s, dtype):
        return torch.randn((h, s, HEAD_DIM), generator=gen, device=dev,
                           dtype=f32).to(dtype)

    def seq(s, h, dtype):
        return torch.randn((s, h, HEAD_DIM), generator=gen, device=dev,
                           dtype=f32).to(dtype)

    def note(key, got, want):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        max_err[key] = max(max_err.get(key, 0.0), err)
        return err

    def expect_close(what, key, got, want, tol):
        """|got - want| <= tol + tol*|want| everywhere, as
        ``np.testing.assert_allclose(rtol=tol, atol=tol)``."""
        err = note(key, got, want)
        diff = (got.float() - want.float()).abs()
        bad = int((diff > tol + tol * want.float().abs()).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} element(s) outside {tol}, "
                                 f"max abs err {err}")
        log(f"  {what}: within {tol} (max abs err {err:.3g})")

    def row_rel(got, want):
        """Worst ||got - want|| / ||want|| over the rows (last axis)."""
        got, want = got.float(), want.float()
        err = (got - want).norm(dim=-1)
        ref = want.norm(dim=-1)
        return torch.where(ref > 0, err / ref, err).max().item()

    def expect_rows(what, key, got, want, control=None):
        """bf16 out/acc: every row within BF16_ROW_REL of the plain
        version; a ``control`` (the plain version with one live key tile
        dropped) must read above the bar, or the bar is blind."""
        err = note(key, got, want)
        rel = row_rel(got, want)
        if rel > BF16_ROW_REL:
            raise AssertionError(f"{what}: worst row relative error {rel} "
                                 f"above {BF16_ROW_REL} (max abs err {err})")
        msg = (f"  {what}: worst row rel err {rel:.3g} <= {BF16_ROW_REL} "
               f"(max abs err {err:.3g})")
        if control is not None:
            ctl = row_rel(control, want)
            if ctl <= BF16_ROW_REL:
                raise AssertionError(f"{what}: the control reads {ctl}, "
                                     f"inside the bar {BF16_ROW_REL}")
            msg += f"; control, one key tile dropped: {ctl:.3g}"
        log(msg)

    def dropped_tile(q, k, v, carry, q_off, k_off, causal, window):
        """The plain fold with the middle key tile left out: what a
        kernel that skipped one live tile would return."""
        j0 = k.shape[1] // 2 // CONTROL_TILE * CONTROL_TILE
        for lo, hi in ((0, j0), (j0 + CONTROL_TILE, k.shape[1])):
            if lo < hi:
                carry = kflash.flash_block_attend_plain(
                    q, k[:, lo:hi], v[:, lo:hi], *carry, q_off, k_off + lo,
                    causal, scale, window=window)
        return carry

    def check_state(what, key, dtype, got, want, parts, control=None):
        """m and l at the f32 statistics bar; out/acc at F32_TOL in f32,
        by rows in bf16."""
        for part, a, b in zip(parts, got, want):
            name = f"{what} {part}"
            if part in ("m", "l"):
                expect_close(name, key, a, b, STAT_TOL)
            elif dtype == f32:
                expect_close(name, key, a, b, F32_TOL)
            else:
                expect_rows(name, key, a, b, control)

    # ---- 7. fused kernel vs its plain version -------------------------
    log("[7 fused flash kernel vs plain]")
    fused_cases = [
        (f"S={SEQ} causal f32", SEQ, HEADS, f32, True, None),
        (f"S={SEQ} causal bf16", SEQ, HEADS, bf16, True, None),
        (f"S={SEQ // 2} non-causal f32", SEQ // 2, HEADS, f32, False, None),
        (f"S={SEQ_LONG} GQA 8:1 window {WINDOW} bf16", SEQ_LONG, 1, bf16,
         True, WINDOW),
    ]
    fused_inputs = {}
    for name, s, h_kv, dtype, causal, window in fused_cases:
        q, k, v = heads(HEADS, s, dtype), heads(h_kv, s, dtype), \
            heads(h_kv, s, dtype)
        fused_inputs[name] = (q, k, v, causal, window)
        args = (q, k, v, 0, 0, causal, scale)
        got = kflash.flash_attend_fused(*args, window=window)
        want = kflash.flash_attend_fused_plain(*args, window=window)
        control = None
        if dtype == bf16:
            _, l_c, acc_c = dropped_tile(
                q, k, v, kflash.fresh_state(HEADS, s, HEAD_DIM, dev), 0, 0,
                causal, window)
            control = ra._flash_finalize(acc_c, l_c, dtype)
        check_state(name, ("flash_fused", name), dtype, got, want,
                    ("out", "m", "l"), control)
        del got, want, control

    # ---- 8. carried kernel vs its plain version -----------------------
    log(f"[8 carried flash kernel vs plain] one rank's steps of a "
        f"{RING}-rank ring over S={SEQ}")
    s_loc = SEQ // RING
    q_off = (RING - 1) * s_loc
    ring_cases = [   # the emulated rings of phase 10
        (f"S={SEQ} causal f32", f32, HEADS, None),
        (f"S={SEQ} causal bf16", bf16, HEADS, None),
        (f"S={SEQ} GQA 8:1 window {WINDOW} bf16", bf16, 1, WINDOW),
    ]
    block_cases = []   # (name, its ring, the carry's k_off, k_off)
    for ring in ring_cases:
        ring_name, window = ring[0], ring[3]
        if window is None:
            block_cases += [
                (f"past block k_off={s_loc} {ring_name}", ring, 0, s_loc),
                (f"diagonal k_off={q_off} {ring_name}", ring, 0, q_off),
                (f"future k_off={SEQ} {ring_name}", ring, 0, SEQ),
            ]
        else:
            block_cases.append((f"window edge k_off={s_loc} {ring_name}",
                                ring, 2 * s_loc, s_loc))
    block_inputs = {}
    for name, (ring_name, dtype, h_kv, window), carry_off, k_off in \
            block_cases:
        key = ("flash_block", ring_name)
        q = heads(HEADS, s_loc, dtype)
        k, v = heads(h_kv, s_loc, dtype), heads(h_kv, s_loc, dtype)
        carry = kflash.flash_block_attend_plain(
            q, k, v, *kflash.fresh_state(HEADS, s_loc, HEAD_DIM, dev),
            q_off, carry_off, True, scale, window=window)
        args = (q, k, v, *carry, q_off, k_off, True, scale)
        block_inputs[name] = (args, window)
        got = kflash.flash_block_attend(*args, window=window)
        if k_off >= SEQ:
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, carry)):
                raise AssertionError(f"{name}: the carry changed")
            max_err[key] = max(max_err.get(key, 0.0), 0.0)
            log(f"  {name}: the carry came back array_equal")
            continue
        want = kflash.flash_block_attend_plain(*args, window=window)
        control = None
        if dtype == bf16:
            control = dropped_tile(q, k, v, carry, q_off, k_off, True,
                                   window)[2]
        check_state(name, key, dtype, got, want, ("m", "l", "acc"), control)
        del got, want, control

    # ---- 9. the main path at full width -------------------------------
    log("[9 ring attention main path]")
    comm = st.make_communicator(shape=(1,), axis_names=("sp",))
    main_launches = {}
    for name, s, h_kv, dtype, causal, window in fused_cases:
        q, k, v = seq(s, HEADS, dtype), seq(s, h_kv, dtype), \
            seq(s, h_kv, dtype)
        fn = st.make_ring_attention_fn(comm, causal=causal, window=window)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn(q, k, v)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        main_launches[name] = launches
        log(f"  {name} on {comm.device}: {wall * 1e3:.3f} ms host wall, "
            f"launches {launches}")
        if launches["flash_fused"] != 1 or launches["flash_block"] != 0:
            raise AssertionError(f"{name}: expected one fused launch and no "
                                 f"carried launch, got {launches}")
        if (tuple(out.shape) != (s, HEADS, HEAD_DIM) or out.dtype != dtype
                or not bool(torch.isfinite(out).all())):
            raise AssertionError(f"{name}: output is not a finite "
                                 f"{(s, HEADS, HEAD_DIM)} {dtype} tensor")
        rows = np.unique(np.linspace(0, s - 1, 256).astype(np.int64))
        group = HEADS // h_kv
        qn, kn, vn = (x.float().cpu().numpy() for x in (q, k, v))
        ref = torch.from_numpy(ra.reference_attention_rows(
            qn, np.repeat(kn, group, axis=1), np.repeat(vn, group, axis=1),
            rows, causal=causal, window=window))
        got = out[torch.from_numpy(rows).to(dev)].double().cpu()
        what = (f"{name} vs float64 reference on {len(rows)} rows "
                f"(first {rows[0]}, last {rows[-1]})")
        if dtype == f32:
            expect_close(what, ("main", name), got, ref, F32_TOL)
        else:
            expect_rows(what, ("main", name), got, ref)
        del qn, kn, vn, ref, out

    # ---- 10. the emulated ring ----------------------------------------
    log(f"[10 emulated {RING}-rank ring: make_ring_attention_fn on each "
        f"rank's shards in one process, ring_shift stood in]")
    ring_runs = {}
    for ring_name, dtype, h_kv, window in ring_cases:
        q, k, v = seq(SEQ, HEADS, dtype), seq(SEQ, h_kv, dtype), \
            seq(SEQ, h_kv, dtype)
        whole = st.make_ring_attention_fn(comm, causal=True,
                                          window=window)(q, k, v)
        shards = [[x[r * s_loc:(r + 1) * s_loc] for r in range(RING)]
                  for x in (q, k, v)]
        shift = EmulatedShift(
            [[x.transpose(0, 1).contiguous() for x in shards[i]]
             for i in (1, 2)], RING)
        calls = []

        def recorded(*args, **kw):
            calls.append((args, kw))
            return kflash.flash_block_attend(*args, **kw)

        real = ra.ring_shift, ra.flash_block_attend
        ra.ring_shift, ra.flash_block_attend = shift, recorded
        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            outs = [st.make_ring_attention_fn(
                        st.Communicator(shape=(RING,), axis_names=("sp",),
                                        rank=r, device=dev),
                        causal=True, window=window)(
                        *(shards[i][r] for i in range(3)))
                    for r in range(RING)]
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        finally:
            ra.ring_shift, ra.flash_block_attend = real
        log(f"  {ring_name}: launches {launches}, {shift.calls} shifts")
        if (launches["flash_block"] != RING * RING
                or launches["flash_fused"] != 0
                or shift.calls != 2 * RING * (RING - 1)):
            raise AssertionError(f"{ring_name}: expected {RING * RING} "
                                 f"carried launches and "
                                 f"{2 * RING * (RING - 1)} shifts, got "
                                 f"{launches}, {shift.calls}")
        for r, o in enumerate(outs):
            what = f"rank {r} vs its rows of the fused output"
            rows = whole[r * s_loc:(r + 1) * s_loc]
            if dtype == f32:
                expect_close(what, ("ring", ring_name), o, rows, F32_TOL)
            else:
                expect_rows(what, ("ring", ring_name), o, rows)
        ring_runs[ring_name] = (launches["flash_block"], calls)
        del q, k, v, whole, shards, shift, outs

    # ---- 11. times ----------------------------------------------------
    log("[11 flash times]")

    def reps_for(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return max(3, min(50, int(0.3 / max(time.perf_counter() - t0,
                                            1e-4))))

    def timed(fn, min_reps=1):
        return time_ms(fn, max(min_reps, reps_for(fn)))

    def bound(ops, nbytes, dtype):
        t_ops = ops / (F32_FLOPS if dtype == f32 else BF16_FLOPS) * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    def block_work(args, window):
        """Operations and bytes of one carried fold: q/k/v are read only
        where a pair is live; the f32 carry is read and written."""
        q, k = args[0], args[1]
        h, s_q, d = q.shape
        pairs = live_pairs(s_q, k.shape[1], args[6], args[7], args[8],
                           window)
        carry = 4 * 2 * (2 * h * s_q + h * s_q * d)
        qkv = q.element_size() * (q.numel() + 2 * k.numel())
        return 4 * h * d * pairs, carry + (qkv if pairs else 0)

    def sdpa(q, k, v, causal, window):
        """One ``scaled_dot_product_attention`` call on (1, H, S, D), its
        time and the aten op it dispatched to; None where it fails."""
        s = q.shape[1]
        kw = {"is_causal": causal}
        if window is not None:
            pos = torch.arange(s, device=dev)
            keep = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - WINDOW))
            kw = {"attn_mask": keep}
        if k.shape[0] != q.shape[0]:
            kw["enable_gqa"] = True

        def call():
            return F.scaled_dot_product_attention(
                q[None], k[None], v[None], **kw)

        try:
            call()
            torch.cuda.synchronize()
        except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
            return None, f"none ({type(exc).__name__}: {str(exc)[:120]})"
        backend = "not identified"
        try:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                call()
                torch.cuda.synchronize()
            ops = sorted({e.key for e in prof.key_averages()
                          if "attention" in e.key and "aten::_" in e.key})
            backend = ", ".join(ops) or backend
        except Exception as exc:  # the profiler is a label, not a check
            backend = f"not identified ({type(exc).__name__})"
        return timed(call), backend

    records = []
    for name, (q, k, v, causal, window) in fused_inputs.items():
        h, s, d = q.shape
        item = q.element_size()
        pairs = live_pairs(s, s, 0, 0, causal, window)
        b_ms, b_by = bound(4 * h * d * pairs,
                           item * (2 * h * s * d + 2 * k.numel())
                           + 2 * 4 * h * s, q.dtype)
        args = (q, k, v, 0, 0, causal, scale)
        ms = timed(lambda: kflash.flash_attend_fused(*args, window=window))
        plain_ms = time_ms(
            lambda: kflash.flash_attend_fused_plain(*args, window=window), 2)
        lib_ms, backend = sdpa(q, k, v, causal, window)
        tflops = 4 * h * d * pairs / ms / 1e9
        log(f"  fused {name}: {ms:.4f} ms ({tflops:.4g} TFLOP/s), bound "
            f"{b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms "
            f"[{backend}]")
        records.append({
            "name": f"flash_fused {name} H={h} D={d}", "route": "cuda",
            "source": FLASH_SRC, "replaces": REPLACES["flash_fused"],
            "launches": main_launches[name]["flash_fused"],
            "max_abs_err": max_err[("flash_fused", name)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
        })
    for name, (args, window) in block_inputs.items():
        ops, nbytes = block_work(args, window)
        b_ms, b_by = bound(ops, nbytes, args[0].dtype)
        ms = timed(lambda: kflash.flash_block_attend(*args, window=window))
        plain_ms = time_ms(
            lambda: kflash.flash_block_attend_plain(*args, window=window), 2)
        log(f"  carried step, {name}: {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), plain {plain_ms:.4f} ms")
    for ring_name, dtype, h_kv, window in ring_cases:
        launches, calls = ring_runs[ring_name]
        work = [block_work(a, kw.get("window")) for a, kw in calls]
        b_ms, b_by = bound(sum(w[0] for w in work), sum(w[1] for w in work),
                           dtype)
        ms = timed(lambda: [kflash.flash_block_attend(*a, **kw)
                            for a, kw in calls])
        plain_ms = time_ms(lambda: [kflash.flash_block_attend_plain(*a, **kw)
                                    for a, kw in calls], 2)
        log(f"  carried, the {len(calls)} folds of the {RING}-rank ring "
            f"{ring_name}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), plain "
            f"{plain_ms:.4f} ms, no library call folds into a carry")
        records.append({
            "name": f"flash_block {RING}-rank ring {ring_name} H={HEADS} "
                    f"D={HEAD_DIM} ({len(calls)} folds)",
            "route": "cuda", "source": FLASH_SRC,
            "replaces": REPLACES["flash_block"], "launches": launches,
            "max_abs_err": max_err[("flash_block", ring_name)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    return records


if __name__ == "__main__":
    sys.exit(main())
