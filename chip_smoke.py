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
10. an emulated 4-rank ring over S=8192, causal f32, causal bf16 and GQA
   8:1 window 4096 bf16: one thread per rank runs
   ``make_ring_attention_fn`` on its shards, with ``ring_shift`` stood in
   by a shift that swaps blocks between the threads at a barrier, so the
   ring schedule itself runs; each rank's output equals its rows of the
   fused output, in 16 carried launches per ring;
11. each flash kernel's time at those shapes beside its bound, its plain
   version's time and ``scaled_dot_product_attention``'s.

Then training (``smi_tpu_torch/kernels/csrc/flash_bwd.cu``, also built in
phase 2):

12. each backward kernel (dq; dk and dv) against its plain version, from
   a fused forward's statistics and a random dout: the four shapes of
   phase 7 and the 4-layer stack's S=32768 window-4096 attention; one
   rank's steps of the 4-rank rings (2048 rows at q_off=6144): past,
   diagonal and future blocks (the future block's gradients must be
   zeros, ``array_equal``) in f32 and bf16, and the GQA window edge;
13. the ring's backward: on the 1-rank ring, autograd through
   ``make_ring_attention_fn``'s default tier (one launch of each kernel)
   against the kernels' plain versions and, up to S=8192, against
   autograd through the plain tier; the three rings of phase 10 with
   ``_flash_forward`` and ``_flash_ring_backward`` run by one thread per
   rank, each rank's gradients equal to its rows of the 1-rank ones, in
   16 launches of each backward kernel per ring; and ``remat_reps``;
14. the main path at full width: ``make_train_step`` on a 1x1 ``(dp,
   sp)`` grid, ``BlockConfig(embed=1024, heads=8, head_dim=128)``, B=1,
   S=8192, causal, 1 layer, bf16 compute (3 steps; the loss falls; 1
   fused, 1 dq and 1 dk/dv launch per step) and f32 compute, each
   parameter's gradient against the plain tier's (``use_flash=False``);
   host wall, tokens/s and the attention kernels' share of the step;
15. the 4-layer stack at S=32768, window 4096, bf16, per-block recompute:
   3 steps, the loss falls, 8 fused, 4 dq and 4 dk/dv launches per
   step, the peak of ``torch.cuda.max_memory_allocated``;
16. each backward kernel's time at the shapes of phases 12-15 beside its
   bound, its plain version's time and the backward of
   ``scaled_dot_product_attention`` (forward plus backward less forward).

Then the explicit-copy stencil pipeline
(``smi_tpu_torch/kernels/csrc/stencil_pipeline.cu``, also built in phase 2):

17. the pipeline kernel against its plain version, ``torch.equal``: the
   8192x8192 extended state with zero halos and the 4096x2048 block at
   ``BLOCK_AT`` with random corner-complete halos, at k = 8, 16 and 32,
   in f32 and bf16, with buffering 1 and 3;
18. the path at full width: ``make_communicator(shape=(1, 1))`` and
   ``make_pipeline_stencil_fn`` on 8192x8192 with 16*k+3 sweeps at each
   k, f32 and bf16, the launch counts set to 0 before each run and read
   after it (both ``stencil_pipeline`` and ``stencil_sweep`` launched);
   f32 ``torch.equal`` to the plain torch stencil, bf16 to the same path
   on the kernels' plain versions, and bf16's largest difference to f32
   printed; then 1024x1024 at k=16 against the numpy serial reference;
19. one pass's time at 8192x8192, k = 8, 16 and 32, beside its bound,
   its plain version's time and the temporal kernel's at the same depth
   (no single PyTorch call does k sweeps), and buffering 1 against 3 at
   one window shape: the overlap the ring buys.

Then the Streaming Message Interface on the ring tier
(``smi_tpu_torch/kernels/csrc/ring.cu``, also built in phase 2), every
rank a thread of a ``LocalWorld`` on the one card, 8 ranks unless said:

20. each ring kernel ``torch.equal`` to its plain version on every rank,
   every credit domain drained (credits granted = received = consumed),
   and unequal to the plain version without rank 1's contribution:
   all-reduce of 1,048,576 f32 a rank (ADD) and int32 (MAX), all-gather
   of 512 KiB a rank, reduce-scatter of 8 x 512 KiB a rank, the
   neighbour stream of 512 KiB in 16 chunks in both directions, of 507
   chunks of 2072 elements against the ring's direction (the channel's
   shape in phase 21), and of one-chunk 2048- and 4096-element slabs on
   the ``sx`` and ``sy`` sub-rings of the 2x4 world, every line of an
   axis in one launch, on stream slots 0-3 (the halo's shapes in phase
   23); the four at 2 and 3 ranks at a width-130 payload in f32, bf16 and int8 and at
   1000 elements; and without flow control where nothing can be
   overwritten (2 ranks; a stream of two chunks);
21. the SMI API through ``smi_kernel(world, backend="ring")``: bcast,
   reduce (ADD, MAX), allreduce, scatter and gather at root 5 on
   1,048,576 floats a rank, a transfer 0->5 (three hops the short way
   round) and a stream 5->6 with a summing consumer and ``buffer_size=
   2048``, two collectives on ports of different flag domains back to
   back; each result equal to numpy (f32 ADD within 1e-6 relative),
   zeros off-root, and equal to the same call with ``backend="xla"``
   (exactly, but for f32 ADD: another association); the launch counts
   set to 0 before and held to the calls made;
22. ``make_kmeans_fn`` on 8 ranks (65,536 points, k=8, 2 dims, 10
   iterations, 40 all-reduce launches) against ``reference_kmeans``
   (rtol 1e-3, atol 1e-4) and ``make_gesummv_fn`` on 2 ranks (n=1024,
   alpha 1.5, beta 0.5) against ``reference_gesummv`` (rtol 2e-3;
   ``torch.matmul`` in full f32);
23. the 8192x8192 stencil on the 2x4 world (4096x2048 a rank), 8 sweeps
   with ``backend="ring"``: 32 neighbour-stream launches, each playing
   every line of its axis; ``torch.equal`` to ``backend="xla"`` and to
   the plain stencil on the 1x1 grid;
24. each ring kernel's time (CUDA events around the one grid) at phase
   20's first shapes beside its bound (all ranks' inputs read once and
   outputs written once, over the memory rate; the bytes the ring
   schedule moves on top of that are logged), its plain version's time
   and one stacked PyTorch call that computes the same values and that
   the port never calls.

Then the chunked ring all-reduce (``smi_ring_all_reduce_chunked`` in
``ring.cu``) and SMI's benchmark suite on the port:

25. the chunked kernel ``torch.equal`` to its plain version and to the
   unchunked kernel on every rank, every chunk's credit domain drained,
   and unequal to the plain version without rank 1's contribution: 8
   ranks at 1,048,576 f32 a rank as (1024, 1024) with chunks 2, 4 and 8
   (ADD), int32 MAX and bf16 ADD at chunks 4, the overlap benchmark's
   1-D 65,536, 16,384 and 4,096 f32 at chunks 4 (its sweep; the last one
   block a rank), 1000 rows at chunks 3 (zero-row padding);
   2 and 3 ranks at width 130 in f32, bf16 and int8; the ``sx`` and
   ``sy`` sub-rings of the 2x4 world, each axis in one launch;
26. every benchmark of ``smi_tpu_torch.benchmarks`` through
   ``run_benchmark`` on an 8-rank world, the micro benchmarks under
   ``xla`` and ``ring``, the application benchmarks under ``xla`` (each
   verifies its result first), at the JAX defaults' widths with fewer
   runs (``SUITE_RUNS``) and a shallower pipeline, ping-pong and message
   chain (``SUITE_CUTS``); the launch counts set to 0 before ``overlap``
   on ``ring`` and read after it (the chunked kernel must have run); per
   ring benchmark the host wall beside its kernels' event time; then
   every distinct ring launch the suite made (kernel, shape, dtype, op,
   direction, axis, stream slot) held again on random inputs against its
   plain version by phase 20's check (the chunked ones by phase 25's),
   since the suite's own inputs are ones, alike on every rank;
27. the chunked kernel's time at 4 MiB a rank, chunks 2, 4 and 8 (CUDA
   events around the one grid), beside the unchunked kernel's on the
   same payload, its bound (all ranks' inputs and outputs once), its
   plain version's time and ``torch.stack(xs).sum(0)``.

Bars: f32 out/acc/gradients within 2e-5 (``rtol = atol``); m and l within
1e-5 in either dtype (both sides add exact products in f32); bf16
out/acc/gradients by the worst row's relative error ``||got - want|| /
||want||``, within 1e-2, and each bf16 kernel check also reads a control
(the plain version with one live 64-row tile dropped), which must land
above that bar. bf16 gradient rows whose reference norm is at most 1e-3
of the median row's (0 in exact arithmetic) are left out of the reading
and counted. The train step's gradients are held per parameter by
``||g - g'|| / ||g'||``: 1e-2 in bf16, with the plain tier less one key
tile as the control, which must read above it on ``wqkv`` and ``wo``;
2e-5 in f32. Autograd through the plain tier rounds dP to bf16 (the
backward of its cast) where the kernels keep it in f32, so bf16
gradients are held to it per tensor at 1e-2, and to the kernels' plain
versions by rows.

Any failure raises and exits non-zero. The line before the last is the
per-kernel JSON record; the last line is the device JSON.
"""

import contextlib
import json
import math
import re
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
        lines = [line.strip() for line in _build.build_log(name).splitlines()
                 if ("registers" in line or "spill" in line
                     or "entry function" in line)]
        entries = sum("entry function" in line for line in lines)
        if entries <= 8:
            for line in lines:
                log(f"  {name}: {line}")
            continue
        # a source of many template instances: the extremes
        found = {key: [int(m) for line in lines
                       for m in re.findall(pattern, line)]
                 for key, pattern in (
                     ("registers", r"Used (\d+) registers"),
                     ("stack", r"(\d+) bytes stack frame"),
                     ("spill stores", r"(\d+) bytes spill stores"),
                     ("spill loads", r"(\d+) bytes spill loads"))}
        log(f"  {name}: {entries} entry functions; registers "
            f"{min(found['registers'])}-{max(found['registers'])}, stack "
            f"frame at most {max(found['stack'])} bytes, spill stores at "
            f"most {max(found['spill stores'])} bytes, spill loads at most "
            f"{max(found['spill loads'])} bytes")

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

    records += flash_phases(dev, gen, max_err)
    records += backward_phases(dev, gen, max_err)
    records += pipeline_phases(dev, gen)
    ring_records, ring_check = ring_phases(dev, gen)
    records += ring_records
    records += suite_phases(dev, gen, ring_check)

    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0




def time_ms(fn, reps):
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after three
    warm-up calls."""
    import torch

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


def timed(fn, min_reps=1):
    """:func:`time_ms` over about 0.3 s of calls (3 to 50)."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(0.3 / max(time.perf_counter() - t0, 1e-4))))
    return time_ms(fn, max(min_reps, reps))


def flash_bound(ops, nbytes, bf16):
    """The least time of ``ops`` operations and ``nbytes`` bytes of
    device memory at the data sheet's rates: ``(ms, what binds)``."""
    t_ops = ops / (BF16_FLOPS if bf16 else F32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def live_pairs(s_q, s_k, q_off, k_off, causal, window=None):
    """Query-key pairs the mask leaves live, counted from the global
    positions: the work of a forward (4·D operations each) and of the
    backward kernels (6·D for dq, 8·D for dk/dv)."""
    import numpy as np

    q_pos = q_off + np.arange(s_q, dtype=np.int64)
    lo = np.full_like(q_pos, k_off)
    hi = np.full_like(q_pos, k_off + s_k - 1)
    if causal:
        hi = np.minimum(hi, q_pos)
    if window is not None:
        lo = np.maximum(lo, q_pos - (window - 1))
    return int(np.clip(hi - lo + 1, 0, None).sum())


def sdpa_kwargs(q, k, causal, window):
    """``scaled_dot_product_attention``'s arguments for head-major
    ``(H, S, D)`` q/k: ``is_causal``, or the boolean-mask form for a
    window, and ``enable_gqa`` for grouped K/V heads."""
    import torch

    kw = {"is_causal": causal}
    if window is not None:
        pos = torch.arange(q.shape[1], device=q.device)
        kw = {"attn_mask": (pos[None, :] <= pos[:, None])
              & (pos[None, :] > pos[:, None] - window)}
    if k.shape[0] != q.shape[0]:
        kw["enable_gqa"] = True
    return kw


def aten_ops(call, word):
    """The ``aten::_`` ops whose names hold ``word`` that ``call``
    dispatched to, by the profiler's CPU trace: a label, not a check."""
    import torch

    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
            torch.cuda.synchronize()
        ops = sorted({e.key for e in prof.key_averages()
                      if word in e.key and "aten::_" in e.key})
        return ", ".join(ops) or "not identified"
    except Exception as exc:  # the profiler is a label, not a check
        return f"not identified ({type(exc).__name__})"


def device_profile(call):
    """``call`` once under ``torch.profiler`` with CUDA activity: the
    kernels' device time by name from the trace, or None where the trace
    shows no device time. A reading for the breakdown, not a check."""
    import torch

    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
        return by_name or None
    except Exception as exc:  # a reading, not a check
        log(f"  profiler: no device trace ({type(exc).__name__}: {exc})")
        return None


def sdpa_failed(exc):
    import torch

    torch.cuda.empty_cache()
    return None, f"none ({type(exc).__name__}: {str(exc)[:120]})"


def sdpa_forward(q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call on (1, H, S, D): its time
    and the aten op it dispatched to; None where it fails."""
    import torch
    import torch.nn.functional as F

    kw = sdpa_kwargs(q, k, causal, window)

    def call():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              **kw)

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
        return sdpa_failed(exc)
    return timed(call), aten_ops(call, "attention")


def sdpa_backward(q, k, v, dout, causal, window):
    """``scaled_dot_product_attention``'s backward (dq, dk and dv at once)
    on (1, H, S, D): forward plus backward less forward, and the aten ops
    of the backward; None where it fails."""
    import torch
    import torch.nn.functional as F

    kw = sdpa_kwargs(q, k, causal, window)
    leaves = [x[None].detach().clone().requires_grad_() for x in (q, k, v)]
    grad = dout[None]

    def forward():
        return F.scaled_dot_product_attention(*leaves, **kw)

    def both():
        for t in leaves:
            t.grad = None
        forward().backward(grad)

    try:
        both()
        torch.cuda.synchronize()
    except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
        return sdpa_failed(exc)
    ms = timed(both) - timed(forward)
    return ms, aten_ops(both, "backward")


FLASH_SRC = "smi_tpu_torch/kernels/csrc/flash_fwd.cu"
BWD_SRC = "smi_tpu_torch/kernels/csrc/flash_bwd.cu"
REPLACES = {"flash_fused": "smi_tpu/kernels/flash.py:492",
            "flash_block": "smi_tpu/kernels/flash.py:436",
            "flash_bwd_dq": "smi_tpu/kernels/flash.py:735",
            "flash_bwd_dkdv": "smi_tpu/kernels/flash.py:873"}
F32_TOL, STAT_TOL = 2e-5, 1e-5   # f32 out/acc/grads; m and l in either dtype
BF16_ROW_REL = 1e-2   # bf16 out/acc/grads: worst per-row relative error
CONTROL_TILE = 64     # rows a control drops: one bf16 key tile
#: bf16 gradient rows whose reference norm is at most this times the
#: median row's are left out of the worst-row reading: their gradient is
#: 0 in exact arithmetic (causal query row 0: dP = delta, so dq = 0)
GRAD_FLOOR = 1e-3

#: the 1-rank shapes: (name, S, H_kv, dtype, causal, window)
FUSED_CASES = [
    (f"S={SEQ} causal f32", SEQ, HEADS, "float32", True, None),
    (f"S={SEQ} causal bf16", SEQ, HEADS, "bfloat16", True, None),
    (f"S={SEQ // 2} non-causal f32", SEQ // 2, HEADS, "float32", False,
     None),
    (f"S={SEQ_LONG} GQA 8:1 window {WINDOW} bf16", SEQ_LONG, 1, "bfloat16",
     True, WINDOW),
]
#: the 4-layer stack's attention (PERF.json's `_l4` row: no GQA)
STACK_CASE = (f"S={SEQ_LONG} window {WINDOW} bf16", SEQ_LONG, HEADS,
              "bfloat16", True, WINDOW)
#: the emulated 4-rank rings over S=SEQ: (name, dtype, H_kv, window)
RING_CASES = [
    (f"S={SEQ} causal f32", "float32", HEADS, None),
    (f"S={SEQ} causal bf16", "bfloat16", HEADS, None),
    (f"S={SEQ} GQA 8:1 window {WINDOW} bf16", "bfloat16", 1, WINDOW),
]

EMBED = 1024          # PERF.json's transformer rows: E=1024, H=8, D=128
STACK = 4             # the `_l4` rows' depth
LR = {1: 1e-3, STACK: 1e-4}   # by depth: the loss falls over 3 steps
#: ||g - g'|| / ||g'|| of each parameter's gradient, the train step
#: against the plain tier's; the control must read above the bf16 bar
STEP_BAR = {"bfloat16": 1e-2, "float32": 2e-5}


class Bars:
    """The checks shared by the phases: each records the largest absolute
    error of its kernel's checks in ``max_err`` and raises when a reading
    is outside its bar."""

    def __init__(self, max_err):
        self.max_err = max_err

    def note(self, key, got, want):
        import torch

        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if key is not None:
            self.max_err[key] = max(self.max_err.get(key, 0.0), err)
        return err

    def close(self, what, key, got, want, tol):
        """|got - want| <= tol + tol*|want| everywhere, as
        ``np.testing.assert_allclose(rtol=tol, atol=tol)``."""
        err = self.note(key, got, want)
        diff = (got.float() - want.float()).abs()
        bad = int((diff > tol + tol * want.float().abs()).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} element(s) outside {tol}, "
                                 f"max abs err {err}")
        log(f"  {what}: within {tol} (max abs err {err:.3g})")

    @staticmethod
    def row_rel(got, want, floor=None):
        """Worst ||got - want|| / ||want|| over the rows (last axis), and
        how many rows a ``floor`` left out: those with ||want|| at most
        ``floor`` times the median row norm. Without a floor a row with
        ||want|| = 0 reads its absolute error."""
        import torch

        got, want = got.float(), want.float()
        err = (got - want).norm(dim=-1)
        ref = want.norm(dim=-1)
        if floor is None:
            return torch.where(ref > 0, err / ref, err).max().item(), 0
        keep = ref > floor * ref.median()
        return (err[keep] / ref[keep]).max().item(), int((~keep).sum())

    def rows(self, what, key, got, want, control=None, bar=None,
             floor=None):
        """bf16: every row within ``bar`` (BF16_ROW_REL) of the plain
        version; a ``control`` (the plain version with one live tile
        dropped) must read above the bar, or the bar is blind."""
        bar = BF16_ROW_REL if bar is None else bar
        err = self.note(key, got, want)
        rel, excluded = self.row_rel(got, want, floor)
        if rel > bar:
            raise AssertionError(f"{what}: worst row relative error {rel} "
                                 f"above {bar} (max abs err {err})")
        msg = (f"  {what}: worst row rel err {rel:.3g} <= {bar} "
               f"(max abs err {err:.3g}")
        msg += (f"; {excluded} of {got[..., 0].numel()} row(s) under the "
                f"floor)" if floor else ")")
        if control is not None:
            ctl, _ = self.row_rel(control, want, floor)
            if ctl <= bar:
                raise AssertionError(f"{what}: the control reads {ctl}, "
                                     f"inside the bar {bar}")
            msg += f"; control, one tile dropped: {ctl:.3g}"
        log(msg)

    def grads(self, what, keys, dtype, got, want, controls=None):
        """dq, dk, dv: f32 at F32_TOL everywhere, bf16 by the worst row
        above the GRAD_FLOOR, each beside its control."""
        import torch

        for i, (name, a, b) in enumerate(zip(("dq", "dk", "dv"), got,
                                             want)):
            key = keys[min(i, len(keys) - 1)]
            if dtype == torch.float32:
                self.close(f"{what} {name}", key, a, b, F32_TOL)
            else:
                self.rows(f"{what} {name}", key, a, b,
                          None if controls is None else controls[i],
                          floor=GRAD_FLOOR)


class ThreadRing:
    """An n-rank ring played by n threads of one process, one per rank, so
    the ring code itself runs on the card. :meth:`shift` stands in for
    ``ring_shift``: each rank leaves its block in its slot, the ranks meet
    at a barrier, each takes the block of the rank ``offset`` places to
    its left, and they meet again before a slot is reused. Every rank
    makes the same shifts in the same order, as on a real ring."""

    def __init__(self, n):
        import threading

        self.n, self.calls = n, 0
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=600)
        self.lock = threading.Lock()

    def shift(self, x, comm, offset=1, axis_name=None, backend="xla"):
        r = comm.coords[comm._axis(axis_name or comm.axis_names[0])]
        self.slots[r] = x
        self.barrier.wait()
        got = self.slots[(r - offset) % self.n]
        self.barrier.wait()
        with self.lock:
            self.calls += 1
        return got

    def run(self, fn):
        """``fn(rank)`` on every rank's thread; the results in rank order.
        A failure aborts the barrier, so no rank waits for ever, and is
        raised here."""
        import threading

        out, errors = [None] * self.n, []

        def body(r):
            try:
                out[r] = fn(r)
            except BaseException as exc:  # raised again below
                errors.append(exc)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            first = [e for e in errors
                     if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or errors)[0]
        return out


@contextlib.contextmanager
def patched(module, **attrs):
    """Set ``module``'s attributes for the ``with`` block, then put the
    old ones back."""
    old = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(module, name, value)


def recording(fn, calls):
    """``fn`` that also appends each call's arguments to ``calls``."""
    def wrapped(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)
    return wrapped


def flash_phases(dev, gen, max_err):
    """Phases 7-11: ring attention's forward. Returns the flash kernels'
    records for the kernels line."""
    import numpy as np
    import torch

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

    bars = Bars(max_err)
    expect_close, expect_rows = bars.close, bars.rows

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
    fused_inputs = {}
    for name, s, h_kv, dt, causal, window in FUSED_CASES:
        dtype = getattr(torch, dt)
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
    block_cases = []   # (name, its ring, the carry's k_off, k_off)
    for ring in RING_CASES:
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
    for name, (ring_name, dt, h_kv, window), carry_off, k_off in \
            block_cases:
        dtype = getattr(torch, dt)
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
    for name, s, h_kv, dt, causal, window in FUSED_CASES:
        dtype = getattr(torch, dt)
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
        f"rank's shards, one thread per rank, ring_shift stood in]")
    ring_runs = {}
    for ring_name, dt, h_kv, window in RING_CASES:
        dtype = getattr(torch, dt)
        q, k, v = seq(SEQ, HEADS, dtype), seq(SEQ, h_kv, dtype), \
            seq(SEQ, h_kv, dtype)
        whole = st.make_ring_attention_fn(comm, causal=True,
                                          window=window)(q, k, v)
        ring = ThreadRing(RING)
        calls = []

        def rank(r):
            rows = slice(r * s_loc, (r + 1) * s_loc)
            return st.make_ring_attention_fn(
                st.Communicator(shape=(RING,), axis_names=("sp",), rank=r,
                                device=dev),
                causal=True, window=window)(q[rows], k[rows], v[rows])

        with patched(ra, ring_shift=ring.shift,
                     flash_block_attend=recording(
                         kflash.flash_block_attend, calls)):
            torch.cuda.synchronize()
            _build.reset_launches()
            outs = ring.run(rank)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        log(f"  {ring_name}: launches {launches}, {ring.calls} shifts")
        if (launches["flash_block"] != RING * RING
                or launches["flash_fused"] != 0
                or ring.calls != 2 * RING * (RING - 1)):
            raise AssertionError(f"{ring_name}: expected {RING * RING} "
                                 f"carried launches and "
                                 f"{2 * RING * (RING - 1)} shifts, got "
                                 f"{launches}, {ring.calls}")
        for r, o in enumerate(outs):
            what = f"rank {r} vs its rows of the fused output"
            rows = whole[r * s_loc:(r + 1) * s_loc]
            if dtype == f32:
                expect_close(what, ("ring", ring_name), o, rows, F32_TOL)
            else:
                expect_rows(what, ("ring", ring_name), o, rows)
        ring_runs[ring_name] = (launches["flash_block"], calls)
        del q, k, v, whole, outs

    # ---- 11. times ----------------------------------------------------
    log("[11 flash times]")

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

    records = []
    for name, (q, k, v, causal, window) in fused_inputs.items():
        h, s, d = q.shape
        item = q.element_size()
        pairs = live_pairs(s, s, 0, 0, causal, window)
        b_ms, b_by = flash_bound(4 * h * d * pairs,
                                 item * (2 * h * s * d + 2 * k.numel())
                                 + 2 * 4 * h * s, q.dtype == bf16)
        args = (q, k, v, 0, 0, causal, scale)
        ms = timed(lambda: kflash.flash_attend_fused(*args, window=window))
        plain_ms = time_ms(
            lambda: kflash.flash_attend_fused_plain(*args, window=window), 2)
        lib_ms, backend = sdpa_forward(q, k, v, causal, window)
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
        b_ms, b_by = flash_bound(ops, nbytes, args[0].dtype == bf16)
        ms = timed(lambda: kflash.flash_block_attend(*args, window=window))
        plain_ms = time_ms(
            lambda: kflash.flash_block_attend_plain(*args, window=window), 2)
        log(f"  carried step, {name}: {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), plain {plain_ms:.4f} ms")
    for ring_name, dt, h_kv, window in RING_CASES:
        launches, calls = ring_runs[ring_name]
        work = [block_work(a, kw.get("window")) for a, kw in calls]
        b_ms, b_by = flash_bound(sum(w[0] for w in work),
                                 sum(w[1] for w in work), dt == "bfloat16")
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


def backward_phases(dev, gen, max_err):
    """Phases 12-16: the flash backward kernels, the ring's backward and
    the transformer's train step. Returns the backward kernels' records
    for the kernels line."""
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import flash as kflash
    from smi_tpu_torch.models import ring_attention as ra

    f32, bf16 = torch.float32, torch.bfloat16
    scale = 1.0 / math.sqrt(HEAD_DIM)
    bars = Bars(max_err)
    s_loc = SEQ // RING
    q_off = (RING - 1) * s_loc

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=f32).to(dtype)

    def kernels(args, window):
        return (kflash.flash_block_backward_dq(*args, window=window),
                *kflash.flash_block_backward_dkdv(*args, window=window))

    def plain(args, window):
        return (kflash.flash_block_backward_dq_plain(*args, window=window),
                *kflash.flash_block_backward_dkdv_plain(*args,
                                                        window=window))

    def dropped(args, window):
        """The plain versions with one live 64-row tile left out: dq
        without the middle key tile, dk and dv without the middle query
        tile. What a kernel that skipped a live tile would return."""
        q, k, v, dout, m, linv, delta, qo, ko, causal, sc = args
        s_q, s_k = q.shape[1], k.shape[1]
        kj = s_k // 2 // CONTROL_TILE * CONTROL_TILE
        qj = s_q // 2 // CONTROL_TILE * CONTROL_TILE
        dq = dk = dv = 0
        for lo, hi in ((0, kj), (kj + CONTROL_TILE, s_k)):
            if lo < hi:
                dq = dq + kflash.flash_block_backward_dq_plain(
                    q, k[:, lo:hi], v[:, lo:hi], dout, m, linv, delta, qo,
                    ko + lo, causal, sc, window=window)
        for lo, hi in ((0, qj), (qj + CONTROL_TILE, s_q)):
            if lo < hi:
                a, b = kflash.flash_block_backward_dkdv_plain(
                    q[:, lo:hi], k, v, dout[:, lo:hi], m[..., lo:hi],
                    linv[..., lo:hi], delta[..., lo:hi], qo + lo, ko,
                    causal, sc, window=window)
                dk, dv = dk + a, dv + b
        return dq, dk, dv

    def keys(name):
        return (("flash_bwd_dq", name), ("flash_bwd_dkdv", name))

    # ---- 12. backward kernels vs their plain versions -----------------
    log("[12 flash backward kernels vs plain] from a fused forward's "
        "statistics and a random dout")
    bwd_inputs = {}   # 1-rank shape -> (args, window)
    for name, s, h_kv, dt, causal, window in FUSED_CASES + [STACK_CASE]:
        dtype = getattr(torch, dt)
        q = randn(HEADS, s, HEAD_DIM, dtype=dtype)
        k, v = (randn(h_kv, s, HEAD_DIM, dtype=dtype) for _ in range(2))
        dout = randn(HEADS, s, HEAD_DIM, dtype=dtype)
        out, m, l = kflash.flash_attend_fused(q, k, v, 0, 0, causal, scale,
                                              window=window)
        args = (q, k, v, dout, m, *kflash.backward_rows(out, l, dout), 0, 0,
                causal, scale)
        bwd_inputs[name] = (args, window)
        got = kernels(args, window)
        want = plain(args, window)
        control = dropped(args, window) if dtype == bf16 else None
        bars.grads(name, keys(name), dtype, got, want, control)
        del out, got, want, control

    ring_steps = {}   # ring -> the steps' (args, window), for the record
    for ring_name, dt, h_kv, window in RING_CASES:
        dtype = getattr(torch, dt)
        q = randn(HEADS, s_loc, HEAD_DIM, dtype=dtype)
        dout = randn(HEADS, s_loc, HEAD_DIM, dtype=dtype)
        k_all, v_all = (randn(h_kv, SEQ, HEAD_DIM, dtype=dtype)
                        for _ in range(2))
        out, m, l = kflash.flash_attend_fused(q, k_all, v_all, q_off, 0,
                                              True, scale, window=window)
        rows = kflash.backward_rows(out, l, dout)
        steps = ([("past block", s_loc), ("diagonal", q_off),
                  ("future", SEQ)] if window is None
                 else [("window edge", s_loc)])
        for step_name, k_off in steps:
            what = f"{step_name} k_off={k_off} of the ring {ring_name}"
            if k_off < SEQ:
                k, v = (x[:, k_off:k_off + s_loc].contiguous()
                        for x in (k_all, v_all))
            else:
                k, v = (randn(h_kv, s_loc, HEAD_DIM, dtype=dtype)
                        for _ in range(2))
            args = (q, k, v, dout, m, *rows, q_off, k_off, True, scale)
            got = kernels(args, window)
            if k_off >= SEQ:
                torch.cuda.synchronize()
                nonzero = [int(torch.count_nonzero(t)) for t in got]
                if any(nonzero):
                    raise AssertionError(f"{what}: nonzero gradients "
                                         f"{nonzero}")
                for key in keys(ring_name):
                    max_err[key] = max(max_err.get(key, 0.0), 0.0)
                log(f"  {what}: dq, dk and dv array_equal to zeros")
                continue
            control = dropped(args, window) if dtype == bf16 else None
            bars.grads(what, keys(ring_name), dtype, got,
                       plain(args, window), control)
            ring_steps.setdefault(ring_name, []).append((args, window))
            del got, control

    # ---- 13. the ring's backward --------------------------------------
    log("[13 ring attention backward]")
    comm = st.make_communicator(shape=(1,), axis_names=("sp",))

    def seq(s, h, dtype):
        return randn(s, h, HEAD_DIM, dtype=dtype)

    def ring_grads(q, k, v, w, causal, window, **kw):
        """Autograd's q/k/v gradients of sum(out * w) on the 1-rank ring."""
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = st.make_ring_attention_fn(comm, causal=causal, window=window,
                                        **kw)(*leaves)
        (out.float() * w).sum().backward()
        return [t.grad for t in leaves]

    def plain_backward(q, k, v, w, causal, window):
        """The same gradients from the kernels' plain versions, forward
        and backward, without autograd: the oracle where autograd through
        the plain tier would hold H·S² probabilities."""
        qT, kT, vT = (x.transpose(0, 1).contiguous() for x in (q, k, v))
        out, m, l = kflash.flash_attend_fused_plain(qT, kT, vT, 0, 0, causal,
                                                    scale, window=window)
        doutT = w.transpose(0, 1).to(q.dtype).contiguous()
        args = (qT, kT, vT, doutT, m, *kflash.backward_rows(out, l, doutT),
                0, 0, causal, scale)
        return [g.transpose(0, 1).to(x.dtype)
                for g, x in zip(plain(args, window), (q, k, v))]

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    main_launches = {}
    for name, s, h_kv, dt, causal, window in FUSED_CASES:
        dtype = getattr(torch, dt)
        q, k, v = seq(s, HEADS, dtype), seq(s, h_kv, dtype), \
            seq(s, h_kv, dtype)
        w = seq(s, HEADS, f32)
        torch.cuda.synchronize()
        _build.reset_launches()
        got = ring_grads(q, k, v, w, causal, window)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        main_launches[name] = launches
        log(f"  1-rank {name}: launches {launches}")
        want_counts = {"flash_fused": 1, "flash_block": 0,
                       "flash_bwd_dq": 1, "flash_bwd_dkdv": 1}
        if any(launches[n] != c for n, c in want_counts.items()):
            raise AssertionError(f"{name}: expected {want_counts}, got "
                                 f"{launches}")
        for g, x in zip(got, (q, k, v)):
            if (g.shape != x.shape or g.dtype != x.dtype
                    or not bool(torch.isfinite(g).all())):
                raise AssertionError(f"{name}: a gradient is not a finite "
                                     f"{tuple(x.shape)} {x.dtype} tensor")
        bars.grads(f"1-rank {name} vs the plain versions", (None,), dtype,
                   got, plain_backward(q, k, v, w, causal, window))
        if s <= SEQ:
            # autograd through the plain tier rounds dP to bf16 (the
            # backward of its cast); the kernels, like the reference's
            # custom VJP, keep dP in f32: bf16 is held per tensor
            want = ring_grads(q, k, v, w, causal, window, use_flash=False)
            if dtype == f32:
                bars.grads(f"1-rank {name} vs the plain tier's autograd",
                           (None,), dtype, got, want)
            else:
                for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                    r = rel(a, b)
                    worst, excl = Bars.row_rel(a, b, GRAD_FLOOR)
                    if r > STEP_BAR["bfloat16"]:
                        raise AssertionError(
                            f"{name} {gname} vs the plain tier's autograd: "
                            f"||g - g'|| / ||g'|| = {r}")
                    log(f"  1-rank {name} {gname} vs the plain tier's "
                        f"autograd: ||g - g'||/||g'|| {r:.3g} <= "
                        f"{STEP_BAR['bfloat16']} (worst row {worst:.3g}, "
                        f"{excl} row(s) under the floor)")
            del want
        del q, k, v, w, got

    ring_runs = {}
    shifts = 2 * RING * (RING - 1) * 2 + 2 * RING * RING
    for ring_name, dt, h_kv, window in RING_CASES:
        dtype = getattr(torch, dt)
        q, k, v = seq(SEQ, HEADS, dtype), seq(SEQ, h_kv, dtype), \
            seq(SEQ, h_kv, dtype)
        w = seq(SEQ, HEADS, f32)
        whole = ring_grads(q, k, v, w, True, window)
        ring = ThreadRing(RING)
        calls = {"flash_bwd_dq": [], "flash_bwd_dkdv": []}

        def rank(r):
            """One rank's forward and backward: the ring functions the
            flash tier's autograd.Function calls, on this rank's shards."""
            c = st.Communicator(shape=(RING,), axis_names=("sp",), rank=r,
                                device=dev)
            rows = slice(r * s_loc, (r + 1) * s_loc)
            out, m, l = ra._flash_forward(q[rows], k[rows], v[rows], c, True,
                                          "sp", window)
            return ra._flash_ring_backward(q[rows], k[rows], v[rows], out, m,
                                           l, w[rows], c, True, "sp", window)

        with patched(ra, ring_shift=ring.shift,
                     flash_block_backward_dq=recording(
                         kflash.flash_block_backward_dq,
                         calls["flash_bwd_dq"]),
                     flash_block_backward_dkdv=recording(
                         kflash.flash_block_backward_dkdv,
                         calls["flash_bwd_dkdv"])):
            torch.cuda.synchronize()
            _build.reset_launches()
            grads = ring.run(rank)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        log(f"  emulated {RING}-rank ring {ring_name}: launches {launches}, "
            f"{ring.calls} shifts")
        n2 = RING * RING
        if (launches["flash_bwd_dq"] != n2 or launches["flash_bwd_dkdv"] != n2
                or launches["flash_block"] != n2
                or launches["flash_fused"] != 0 or ring.calls != shifts):
            raise AssertionError(f"{ring_name}: expected {n2} launches of "
                                 f"each backward kernel and {shifts} "
                                 f"shifts, got {launches}, {ring.calls}")
        for r, g in enumerate(grads):
            rows = slice(r * s_loc, (r + 1) * s_loc)
            bars.grads(f"rank {r} vs its rows of the 1-rank gradients",
                       (None,), dtype, g, [x[rows] for x in whole])
        ring_runs[ring_name] = (launches, calls)
        del q, k, v, w, whole, grads

    q, k, v = (seq(s_loc, HEADS, f32) for _ in range(3))
    w = seq(s_loc, HEADS, f32)
    saved = ring_grads(q, k, v, w, True, None, reps=2)
    remat = ring_grads(q, k, v, w, True, None, reps=2, remat_reps=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(saved, remat))
    bars.grads(f"remat_reps, 2 reps S={s_loc} f32, vs saved residuals "
               f"(array_equal: {same})", (None,), f32, remat, saved)
    del q, k, v, w, saved, remat

    # ---- 14. the train step at full width -----------------------------
    grid = st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"))

    def train(cfg, params, x, y, layers, steps, use_flash=None):
        """``steps`` of ``make_train_step`` from fresh weights: the losses,
        the first step's gradients, each step's launches and host wall."""
        model = st.params_from_numpy(params, cfg)
        step = st.make_train_step(grid, cfg, lr=LR[layers],
                                  use_flash=use_flash, layers=layers)
        losses, counts, walls, grads = [], [], [], None
        for i in range(steps):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            loss = float(step(model, x, y))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(dict(_build.LAUNCHES))
            losses.append(loss)
            if i == 0:
                grads = {n: p.grad.clone()
                         for n, p in model.named_parameters()}
        return losses, grads, counts, walls, (model, step)

    def expect_steps(what, losses, counts, layers):
        want = {"flash_fused": 2 * layers if layers > 1 else 1,
                "flash_block": 0, "flash_bwd_dq": layers,
                "flash_bwd_dkdv": layers}
        for i, c in enumerate(counts):
            if any(c[n] != k for n, k in want.items()):
                raise AssertionError(f"{what} step {i}: expected {want}, "
                                     f"got {c}")
        if not all(math.isfinite(x) for x in losses) or not all(
                b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"{what}: the loss does not fall: {losses}")
        log(f"  {what}: losses {losses}, each step's launches {want}")

    def drop_key_tile():
        """The plain tier with the middle key tile of every fold left out:
        the control of the train step's gradients."""
        real = kflash.flash_block_attend_plain

        def fold(q, k, v, m, l, acc, qo, ko, causal, sc, precision=None,
                 window=None):
            j0 = k.shape[1] // 2 // CONTROL_TILE * CONTROL_TILE
            carry = (m, l, acc)
            for lo, hi in ((0, j0), (j0 + CONTROL_TILE, k.shape[1])):
                if lo < hi:
                    carry = real(q, k[:, lo:hi], v[:, lo:hi], *carry, qo,
                                 ko + lo, causal, sc, window=window)
            return carry
        return patched(ra, flash_block_attend_plain=fold)

    def attention_share(model, step, x, y):
        """One step with a CUDA event pair around every flash launch: the
        kernels' event time by name and the step's, on the one stream."""
        real, pairs = kflash._launch, []

        def launch(kernel, *args):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            real(kernel, *args)
            b.record()
            pairs.append((kernel, a, b))

        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with patched(kflash, _launch=launch):
            torch.cuda.synchronize()
            a.record()
            step(model, x, y)
            b.record()
            torch.cuda.synchronize()
        per = {}
        for kernel, s0, s1 in pairs:
            per[kernel] = per.get(kernel, 0.0) + s0.elapsed_time(s1)
        return per, a.elapsed_time(b)

    def report(what, tokens, walls, live, x, y):
        """The step's host wall and tokens/s, the three flash kernels'
        share of one step's event time, and one step's device trace."""
        per, step_ms = attention_share(*live, x, y)
        wall = sum(walls[1:]) / len(walls[1:])
        attn = sum(per.values())
        log(f"  {what}: {wall * 1e3:.3f} ms host wall per step (steps 2-"
            f"{len(walls)}), {tokens / wall:.6g} tokens/s; instrumented step "
            f"{step_ms:.3f} ms of events, attention kernels {attn:.3f} ms "
            f"({100 * attn / step_ms:.1f} %): "
            + ", ".join(f"{n} {t:.3f} ms" for n, t in sorted(per.items())))
        model, step = live
        trace = device_profile(lambda: step(model, x, y))
        if trace is not None:
            busy = sum(trace.values())
            kinds = {"flash kernels": 0.0, "matrix products": 0.0,
                     "elementwise, reductions, copies": 0.0}
            for n, t in trace.items():
                kind = ("flash kernels" if "flash_" in n else
                        "matrix products" if any(w in n.lower() for w in (
                            "gemm", "nvjet", "xmma", "cutlass")) else
                        "elementwise, reductions, copies")
                kinds[kind] += t
            top = sorted(trace.items(), key=lambda kv: -kv[1])[:8]
            log(f"  {what}, one step under the profiler: kernels busy "
                f"{busy:.3f} ms on the card, {100 * busy / (wall * 1e3):.1f} "
                f"% of the host wall per step ({len(trace)} kernel names): "
                + ", ".join(f"{k} {t:.3f} ms" for k, t in kinds.items())
                + "; most time: " + "; ".join(f"{n[:60]} {t:.3f} ms"
                                              for n, t in top))
        return wall

    log(f"[14 train step: E={EMBED}, H={HEADS}, D={HEAD_DIM}, B=1, S={SEQ}, "
        f"causal, 1 layer, on a 1x1 (dp, sp) grid]")
    step_counts = {}
    x, y = randn(1, SEQ, EMBED), randn(1, SEQ, EMBED)
    for cd in ("bfloat16", "float32"):
        cfg = st.BlockConfig(embed=EMBED, heads=HEADS, head_dim=HEAD_DIM,
                             compute_dtype=cd)
        params = st.init_params(cfg, seed=SEED)
        steps = 3 if cd == "bfloat16" else 1
        losses, grads, counts, walls, live = train(cfg, params, x, y, 1,
                                                   steps)
        expect_steps(f"{cd} compute, flash tier", losses, counts, 1)
        _, want, _, _, _ = train(cfg, params, x, y, 1, 1, use_flash=False)
        control = None
        if cd == "bfloat16":
            step_counts[1] = counts[0]
            with drop_key_tile():
                _, control, _, _, _ = train(cfg, params, x, y, 1, 1,
                                            use_flash=False)
        bar = STEP_BAR[cd]
        for n, g in grads.items():
            r = rel(g, want[n])
            if r > bar:
                raise AssertionError(f"{cd} step: {n}'s gradient reads "
                                     f"{r} against the plain tier, above "
                                     f"{bar}")
            msg = f"  {cd} {n}: ||g - g'||/||g'|| {r:.3g} <= {bar}"
            if control is not None:
                c = rel(control[n], want[n])
                # the attention's own weights must see a dropped key tile
                if n in ("wqkv", "wo") and c <= bar:
                    raise AssertionError(f"{n}: the control reads {c}, "
                                         f"inside the bar {bar}")
                msg += f"; control, one key tile dropped: {c:.3g}"
            log(msg)
        if cd == "bfloat16":
            wall_1 = report(f"{cd} step", SEQ, walls, live, x, y)
        del grads, want, control, live

    # ---- 15. the 4-layer stack ----------------------------------------
    log(f"[15 {STACK}-layer stack: S={SEQ_LONG}, window {WINDOW}, bf16, "
        f"per-block recompute]")
    cfg = st.BlockConfig(embed=EMBED, heads=HEADS, head_dim=HEAD_DIM,
                         window=WINDOW, compute_dtype="bfloat16")
    x, y = randn(1, SEQ_LONG, EMBED), randn(1, SEQ_LONG, EMBED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, _, counts, walls, live = train(
        cfg, st.init_stack_params(cfg, STACK, seed=SEED), x, y, STACK, 3)
    peak = torch.cuda.max_memory_allocated()
    expect_steps(f"{STACK}-layer stack", losses, counts, STACK)
    step_counts[STACK] = counts[0]
    log(f"  torch.cuda.max_memory_allocated over the 3 steps: {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    wall_4 = report(f"{STACK}-layer stack step", SEQ_LONG, walls, live,
                    x, y)
    del x, y, live

    # ---- 16. times ----------------------------------------------------
    log("[16 flash backward times]")

    def work(kernel, args, window):
        """Operations and bytes of one backward launch: the inputs are
        read only where a pair is live; the f32 gradients are written."""
        q, k = args[0], args[1]
        h, s_q, d = q.shape
        pairs = live_pairs(s_q, k.shape[1], args[7], args[8], args[9],
                           window)
        ins = q.element_size() * (2 * q.numel() + 2 * k.numel()) \
            + 3 * 4 * h * s_q
        dq = kernel == "flash_bwd_dq"
        outs = 4 * (q.numel() if dq else 2 * k.numel())
        return (6 if dq else 8) * d * h * pairs, outs + (ins if pairs else 0)

    fns = {"flash_bwd_dq": (kflash.flash_block_backward_dq,
                            kflash.flash_block_backward_dq_plain),
           "flash_bwd_dkdv": (kflash.flash_block_backward_dkdv,
                              kflash.flash_block_backward_dkdv_plain)}
    records = []

    def record(kernel, name, err_key, launches, calls, lib_ms):
        ops = nbytes = 0
        for args, window in calls:
            o, b = work(kernel, args, window)
            ops, nbytes = ops + o, nbytes + b
        b_ms, b_by = flash_bound(ops, nbytes,
                                 calls[0][0][0].dtype == bf16)
        fn, fn_plain = fns[kernel]
        ms = timed(lambda: [fn(*a, window=w) for a, w in calls])
        plain_ms = time_ms(lambda: [fn_plain(*a, window=w)
                                    for a, w in calls], 1)
        log(f"  {kernel} {name}: {ms:.4f} ms ({ops / ms / 1e9:.4g} TFLOP/s), "
            f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
            f"launches on its main path {launches}")
        records.append({
            "name": f"{kernel} {name}", "route": "cuda", "source": BWD_SRC,
            "replaces": REPLACES[kernel], "launches": launches,
            "max_abs_err": max_err[(kernel, err_key)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
        })

    for name, s, h_kv, dt, causal, window in FUSED_CASES + [STACK_CASE]:
        args, _ = bwd_inputs[name]
        q, k, v, dout = args[:4]
        lib_ms, backend = sdpa_backward(q, k, v, dout, causal, window)
        log(f"  {name}: sdpa backward (dq, dk and dv) "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms "
            f"[{backend}]")
        if name == STACK_CASE[0]:
            path, counts = f"[{STACK}-layer stack step]", step_counts[STACK]
        elif name == f"S={SEQ} causal bf16":
            path, counts = "[train step]", step_counts[1]
        else:
            path, counts = "[1-rank ring backward]", main_launches[name]
        for kernel in fns:
            record(kernel, f"{name} H={HEADS} D={HEAD_DIM} {path}", name,
                   counts[kernel], [(args, window)], lib_ms)
    for ring_name, dt, h_kv, window in RING_CASES:
        launches, calls = ring_runs[ring_name]
        for kernel in fns:
            steps = [(a, kw.get("window")) for a, kw in calls[kernel]]
            record(kernel, f"{ring_name} [{RING}-rank ring, "
                   f"{len(steps)} steps, H={HEADS} D={HEAD_DIM}]", ring_name,
                   launches[kernel], steps, None)
    log(f"  train step {SEQ / wall_1:.6g} tokens/s, {STACK}-layer stack "
        f"{SEQ_LONG / wall_4:.6g} tokens/s (host wall, steps 2-3)")
    return records


PIPE_SRC = "smi_tpu_torch/kernels/csrc/stencil_pipeline.cu"
PIPE_REPLACES = "smi_tpu/kernels/stencil_pipeline.py:185"
PIPE_DEPTHS = (8, 16, 32)


def pipeline_phases(dev, gen):
    """Phases 17-19: the explicit-copy stencil pipeline. Returns its
    records for the kernels line."""
    import numpy as np
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import stencil as kstencil
    from smi_tpu_torch.kernels import stencil_pipeline as kpipe
    from smi_tpu_torch.kernels import stencil_temporal as ktemporal

    dtypes = kpipe.COMPUTE_DTYPES
    max_err = {}   # (compute dtype, depth) -> max abs err of its checks

    def extended(h, w, k, halos):
        """A random ``(h+2k, w+2k)`` extended state; zeros in its border
        unless ``halos`` (random corner-complete halos)."""
        ext = torch.rand((h + 2 * k, w + 2 * k), generator=gen, device=dev)
        if not halos:
            ext[:k], ext[h + k:] = 0.0, 0.0
            ext[:, :k], ext[:, w + k:] = 0.0, 0.0
        return ext

    # ---- 17. the pipeline kernel vs its plain version -----------------
    log("[17 pipeline kernel vs plain] torch.equal, every depth, dtype and "
        "buffering")
    for k in PIPE_DEPTHS:
        for (h, w), at, halos in (((N, N), (0, 0), False),
                                  (BLOCK, BLOCK_AT, True)):
            ext = extended(h, w, k, halos)
            for cd in dtypes:
                want = kpipe.pipeline_sweeps_plain(ext, *at, N, N, k, cd)
                for buffering in (1, kpipe.PIPELINE_SLOTS):
                    got = kpipe.pipeline_sweeps(ext, *at, N, N, k,
                                                compute_dtype=cd,
                                                buffering=buffering)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    max_err[(cd, k)] = max(max_err.get((cd, k), 0.0), err)
                    what = (f"{h}x{w} at {at} k={k} {cd} buffering "
                            f"{buffering}, {'random' if halos else 'zero'} "
                            f"halos, plan {kpipe._plan(h, w, k, buffering)}")
                    if not torch.equal(got, want):
                        raise AssertionError(f"{what}: kernel != plain, max "
                                             f"abs err {err}")
                    log(f"  {what}: torch.equal")
                del want, got
            del ext

    # ---- 18. the path at full width -----------------------------------
    log("[18 pipeline main path] make_pipeline_stencil_fn on a 1x1 grid")
    comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"))

    @contextlib.contextmanager
    def plain_kernels():
        """The path with both kernel wrappers on their plain versions."""
        def sweeps(ext, row0, col0, gh, gw, depth, stripe=None,
                   compute_dtype="float32", buffering=3, out=None):
            h, w = ext.shape[0] - 2 * depth, ext.shape[1] - 2 * depth
            interior = out[depth:depth + h, depth:depth + w]
            interior.copy_(kpipe.pipeline_sweeps_plain(
                ext, row0, col0, gh, gw, depth, compute_dtype))
            return interior

        with patched(kpipe, pipeline_sweeps=sweeps), \
                patched(kstencil, fused_sweep=kstencil.fused_sweep_plain):
            yield

    g = st.initial_grid(N, N)
    g[:, -1] = 2.0
    block = st.block_from_numpy(g, comm)
    launches = {}
    for k in PIPE_DEPTHS:
        iters = 16 * k + 3
        outs = {}
        for cd in dtypes:
            fn = st.make_pipeline_stencil_fn(comm, iters, N, N, depth=k,
                                             compute_dtype=cd)
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            out = fn(block)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            made = dict(_build.LAUNCHES)
            launches[(cd, k)] = made["stencil_pipeline"]
            log(f"  {N}x{N} k={k} {cd}, {iters} sweeps: {wall * 1e3:.3f} ms "
                f"host wall ({N * N * iters / wall:.4g} cells/s), launches "
                f"{made}")
            if made["stencil_pipeline"] <= 0 or made["stencil_sweep"] <= 0:
                raise AssertionError(f"k={k} {cd}: the path did not launch "
                                     f"both stencil_pipeline and "
                                     f"stencil_sweep: {made}")
            if (tuple(out.shape) != (N, N) or out.dtype != torch.float32
                    or not bool(torch.isfinite(out).all())):
                raise AssertionError(f"k={k} {cd}: not a finite {N}x{N} "
                                     f"f32 grid")
            if cd == "float32":
                want, against = (st.make_stencil_fn(comm, iters)(block),
                                 "the plain torch stencil")
            else:
                with plain_kernels():
                    _build.reset_launches()
                    want = fn(block)
                    if any(_build.LAUNCHES.values()):
                        raise AssertionError("the plain path launched a "
                                             "kernel")
                against = "the same path on the plain versions"
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                err = (out - want).abs().max().item()
                raise AssertionError(f"k={k} {cd}: path != {against}, max "
                                     f"abs err {err}")
            log(f"  k={k} {cd}: torch.equal to {against}")
            outs[cd] = out
            del want
        log(f"  k={k}: bf16 path vs f32 path, max abs diff "
            f"{(outs['bfloat16'] - outs['float32']).abs().max().item()}")
        del outs
    small = st.initial_grid(1024, 1024)
    small[:, -1] = 2.0
    iters = 16 * 16 + 3
    out_s = st.make_pipeline_stencil_fn(comm, iters, 1024, 1024, depth=16)(
        st.block_from_numpy(small, comm))
    if not np.array_equal(st.grid_to_numpy(out_s, comm),
                          st.reference_stencil(small, iters)):
        raise AssertionError("1024x1024 pipeline path != numpy "
                             "reference_stencil")
    log(f"  1024x1024 k=16, {iters} sweeps: array_equal to the numpy "
        f"reference_stencil")
    del block, out_s

    # ---- 19. times -----------------------------------------------------
    log(f"[19 pipeline times] {N}x{N}, one pass (CUDA events)")

    def launch(ext, out, k, cd, buffering, stripe, band):
        """One launch at an explicit plan (the overlap measurement: both
        bufferings at one window shape); not counted."""
        _build.check(kpipe.KERNEL, _build.entry(kpipe.KERNEL)(
            ext.data_ptr(), out.data_ptr(), N, N, 0, 0, N, N, k, stripe,
            band, int(cd == "bfloat16"), buffering,
            torch.cuda.current_stream().cuda_stream))

    records = []
    for k in PIPE_DEPTHS:
        ext = extended(N, N, k, False)
        out = torch.empty_like(ext)
        nbytes = 4 * (ext.numel() + N * N)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * N * N * k / F32_FLOPS * 1e3
        b_ms, b_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")
        zt = torch.zeros(k, N + 2 * k, device=dev)
        zs = torch.zeros(N, k, device=dev)
        xt = ext[k:k + N, k:k + N].contiguous()
        targs = (xt, zt, zt, zs, zs, 0, 0, N, N, k)
        temporal_ms = time_ms(lambda: ktemporal.temporal_sweeps(*targs), 20)
        stripe, band = kpipe._plan(N, N, k, kpipe.PIPELINE_SLOTS)
        sync_plan = kpipe._plan(N, N, k, 1)
        for cd in dtypes:
            ms = time_ms(lambda: kpipe.pipeline_sweeps(
                ext, 0, 0, N, N, k, compute_dtype=cd, out=out), 20)
            sync_same = time_ms(lambda: launch(ext, out, k, cd, 1, stripe,
                                               band), 20)
            ring_same = time_ms(lambda: launch(ext, out, k, cd, 3, stripe,
                                               band), 20)
            sync_own = time_ms(lambda: kpipe.pipeline_sweeps(
                ext, 0, 0, N, N, k, compute_dtype=cd, buffering=1, out=out),
                20)
            plain_ms = time_ms(lambda: kpipe.pipeline_sweeps_plain(
                ext, 0, 0, N, N, k, cd), 3)
            log(f"  k={k} {cd}: ring {ms:.4f} ms per pass (stripe {stripe}, "
                f"band {band}; {N * N * k / ms * 1e3:.4g} cell-sweeps/s), "
                f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
                f"temporal kernel at k={k} {temporal_ms:.4f} ms; at the "
                f"ring's window: buffering 1 {sync_same:.4f} ms, buffering 3 "
                f"{ring_same:.4f} ms (sync/ring {sync_same / ring_same:.4f}); "
                f"buffering 1 at its own plan {sync_plan}: {sync_own:.4f} "
                f"ms; no single PyTorch call does k sweeps (library none)")
            records.append({
                "name": f"stencil_pipeline {N}x{N} k={k} {cd}",
                "route": "cuda", "source": PIPE_SRC,
                "replaces": PIPE_REPLACES, "launches": launches[(cd, k)],
                "max_abs_err": max_err[(cd, k)], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            })
        del ext, out, xt
    return records


RING_SRC = "smi_tpu_torch/kernels/csrc/ring.cu"
RING_REPLACES = {"ring_neighbour_stream": "smi_tpu/kernels/ring.py:838",
                 "ring_all_gather": "smi_tpu/kernels/ring.py:388",
                 "ring_all_reduce": "smi_tpu/kernels/ring.py:495",
                 "ring_reduce_scatter": "smi_tpu/kernels/ring.py:718"}
RING_KERNELS = tuple(RING_REPLACES)
SMI_RANKS = 8             # the reference's 8-device cluster
SMI_ELEMS = 1 << 20       # 4 MiB of f32 a rank: the priced all-reduce payload
HALF_MIB = 1 << 17        # 512 KiB of f32: the microbenchmarks' message
STREAM_CHUNKS = 16
API_ROOT = 5


def ring_phases(dev, gen):
    """Phases 20-24: the SMI API on the ring tier, eight ranks on the
    card. Returns the ring kernels' records for the kernels line, and
    phase 20's check of one launch against its plain version."""
    import numpy as np
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring

    f32, i32 = torch.float32, torch.int32
    worlds = {}

    def world(n):
        if n not in worlds:
            worlds[n] = st.LocalWorld(n)
        return worlds[n]

    def rnd(shape, dtype):
        if dtype.is_floating_point:
            return torch.rand(shape, generator=gen, device=dev,
                              dtype=f32).add_(0.5).to(dtype)
        # nonzero, so that dropping even a 1-element input shows
        v = torch.randint(-100, 99, shape, generator=gen, device=dev,
                          dtype=i32)
        return (v + (v >= 0)).to(dtype)

    # what each kernel is called with, and its plain version per ring
    calls = {
        "ring_all_reduce": (
            lambda x, c, kw: kring.ring_all_reduce(x, c, **kw),
            lambda xs, kw: kring.ring_all_reduce_plain(
                xs, kw.get("op", "add"))),
        "ring_all_gather": (
            lambda x, c, kw: kring.ring_all_gather(x, c, **kw),
            lambda xs, kw: kring.ring_all_gather_plain(xs)),
        "ring_reduce_scatter": (
            lambda x, c, kw: kring.ring_reduce_scatter(x, c, **kw),
            lambda xs, kw: kring.ring_reduce_scatter_plain(
                xs, kw.get("op", "add"))),
        "ring_neighbour_stream": (
            lambda x, c, kw: kring.neighbour_stream(x, c, **kw),
            lambda xs, kw: kring.neighbour_stream_plain(
                xs, kw.get("direction", 1))),
    }
    max_err = {k: 0.0 for k in RING_KERNELS}
    checked = [0]

    def check(kernel, n, shape, dtype, w=None, **kw):
        """One launch against the plain version: equal on every rank,
        every credit domain drained, and the plain version less rank 1's
        contribution not equal. ``w`` is the world (a flat ring of ``n``
        by default); with ``axis_name`` in ``kw`` the launch plays every
        line of that axis and the plain version runs once a line."""
        w = w or world(n)
        n = w.size
        xs = [rnd(shape, dtype) for _ in range(n)]
        call, plain_ring = calls[kernel]
        got = w.run(lambda c: call(xs[c.rank], c, kw))
        record = kring.last_record(w)
        plain_kw = {k: v for k, v in kw.items()
                    if k in ("op", "direction")}
        lines = w.lines(kw.get("axis_name"))

        def plain(xs, plain_kw):
            outs = [None] * n
            for line in lines:
                for r, out in zip(line, plain_ring([xs[r] for r in line],
                                                   plain_kw)):
                    outs[r] = out
            return outs

        want = plain(xs, plain_kw)
        what = (f"{kernel} {len(lines)} ring(s) of {len(lines[0])} "
                f"{tuple(shape)} {str(dtype)[6:]} {kw or ''}")
        for r in range(n):
            err = (got[r].double() - want[r].double()).abs().max().item()
            max_err[kernel] = max(max_err[kernel], err)
            if not torch.equal(got[r], want[r]):
                raise AssertionError(f"{what}: rank {r} kernel != plain, "
                                     f"max abs err {err}")
        if not kring.drained(record):
            raise AssertionError(
                f"{what}: credits did not drain: granted "
                f"{int(record['granted'].sum())}, consumed "
                f"{int(record['consumed'].sum())}, received "
                f"{int(record['credits_received'].sum())}")
        dropped = list(xs)
        dropped[1] = torch.zeros_like(xs[1])
        control = plain(dropped, plain_kw)
        if all(torch.equal(got[r], control[r]) for r in range(n)):
            raise AssertionError(f"{what}: equal to the plain version "
                                 f"without rank 1's contribution")
        checked[0] += 1
        return (f"{what}: equal on {n} ranks, {record['blocks']} blocks a "
                f"rank, credits granted = consumed = "
                f"{int(record['granted'].sum())}")

    # ---- 20. each ring kernel vs its plain version --------------------
    log("[20 ring kernels vs plain]")
    n = SMI_RANKS
    full = [
        ("ring_all_reduce", (SMI_ELEMS,), f32, {}),
        ("ring_all_reduce", (SMI_ELEMS,), i32, {"op": "max"}),
        ("ring_all_gather", (HALF_MIB,), f32, {}),
        ("ring_reduce_scatter", (n * HALF_MIB,), f32, {}),
        ("ring_neighbour_stream", (STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS),
         f32, {}),
        ("ring_neighbour_stream", (STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS),
         f32, {"direction": -1, "stream": 1}),
    ]
    for kernel, shape, dtype, kw in full:
        log("  " + check(kernel, n, shape, dtype, **kw))
    # the shapes the main path gives the stream kernel: the channel's 507
    # chunks of 2072 elements against the ring's direction, and the
    # stencil's one-chunk halo slabs on the sub-rings of the 2x4 world,
    # every line of an axis in one launch, on stream slots 0-3
    log("  " + check("ring_neighbour_stream", n, (507, 2072), f32,
                     direction=-1))
    w24 = st.LocalWorld((2, 4), ("sx", "sy"))
    for axis, width, slots in (("sx", 2048, (0, 1)), ("sy", 4096, (2, 3))):
        for direction, slot in zip((1, -1), slots):
            log("  " + check("ring_neighbour_stream", 8, (1, width), f32,
                             w=w24, axis_name=axis, direction=direction,
                             stream=slot))
    for m in (2, 3):
        small = []
        for dtype in (f32, torch.bfloat16, torch.int8):
            small += [
                ("ring_all_reduce", (3, 130), dtype, {}),
                ("ring_all_gather", (3, 130), dtype, {}),
                ("ring_reduce_scatter", (2 * m, 130), dtype, {"op": "min"}),
                ("ring_neighbour_stream", (5, 130), dtype, {}),
                ("ring_neighbour_stream", (5, 130), dtype,
                 {"direction": -1}),
            ]
        small += [
            ("ring_all_reduce", (1000,), f32, {"op": "max"}),
            ("ring_all_gather", (1000,), f32, {}),
            ("ring_reduce_scatter", (m, 1000), f32, {}),
            ("ring_neighbour_stream", (4, 250), f32, {}),
        ]
        for kernel, shape, dtype, kw in small:
            check(kernel, m, shape, dtype, **kw)
        log(f"  n={m}: {len(small)} cases (width 130 in f32, bf16 and "
            f"int8, both directions, 1000 elements) equal and drained")
    # without credits only what cannot be overwritten is safe: one step
    # (n=2), and a stream of two chunks, one a slot
    for kernel, m, shape in (("ring_all_reduce", 2, (SMI_ELEMS,)),
                             ("ring_all_gather", 2, (HALF_MIB,)),
                             ("ring_reduce_scatter", 2, (2 * HALF_MIB,)),
                             ("ring_neighbour_stream", n, (2, HALF_MIB // 2))):
        log("  " + check(kernel, m, shape, f32, flow_control=False))
    log(f"  {checked[0]} launches checked, each with its "
        f"dropped-contribution control unequal")

    launches = {k: 0 for k in RING_KERNELS}

    def counted(what, expect):
        """Read the launch counts of a path just driven; each must be
        what the path's calls add up to."""
        got = {k: _build.LAUNCHES[k] for k in RING_KERNELS}
        log(f"  {what}: launches {got}")
        if got != expect:
            raise AssertionError(f"{what}: launches {got}, expected "
                                 f"{expect}")
        for k, v in got.items():
            launches[k] += v

    # ---- 21. the SMI API at full width --------------------------------
    log("[21 SMI API through smi_kernel, 8 ranks]")
    w8 = world(n)
    rng = np.random.default_rng(SEED)
    x_np = (rng.random(n * SMI_ELEMS, dtype=np.float32) + 0.5)
    xi_np = rng.integers(-1000, 1000, n * SMI_ELEMS, dtype=np.int32)
    per = x_np.reshape(n, SMI_ELEMS)
    per_i = xi_np.reshape(n, SMI_ELEMS)

    def api(backend):
        @st.smi_kernel(w8, in_specs="smi", out_specs="smi", backend=backend)
        def run(ctx, x, xi):
            ch = ctx.open_channel(port=0, src=0, dst=API_ROOT,
                                  count=SMI_ELEMS, dtype="float")
            ch_s = ctx.open_channel(port=1, src=API_ROOT, dst=API_ROOT + 1,
                                    count=SMI_ELEMS, dtype="float",
                                    buffer_size=2048)
            streamed, total = ctx.stream(
                ch_s, x, consumer=lambda c, chunk: c + chunk.sum(),
                init_carry=torch.zeros((), device=x.device))
            return (
                ctx.bcast(x, root=API_ROOT),
                ctx.reduce(x, op="add", root=API_ROOT),
                ctx.reduce(xi, op="max", root=API_ROOT),
                ctx.allreduce(x),
                ctx.allreduce(xi),
                ctx.scatter(x, root=API_ROOT),
                ctx.gather(x[:HALF_MIB], root=API_ROOT)[None],
                ctx.transfer(ch, x),
                streamed, total[None],
                # two collectives back to back in different flag domains
                ctx.bcast(xi, root=1, port=1),
                ctx.reduce(xi, op="min", root=2, port=2),
            )
        return run

    names = ("bcast", "reduce add", "reduce max", "allreduce f32",
             "allreduce i32", "scatter", "gather", "transfer", "stream",
             "stream total", "bcast port 1", "reduce min port 2")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ring_out = api("ring")(x_np, xi_np)
    wall = time.perf_counter() - t0
    counted(f"ring tier ({wall * 1e3:.1f} ms host wall)",
            {"ring_all_reduce": 7, "ring_reduce_scatter": 1,
             "ring_all_gather": 1, "ring_neighbour_stream": 4})
    xla_out = api("xla")(x_np, xi_np)
    if any(_build.LAUNCHES[k] != launches[k] for k in RING_KERNELS):
        raise AssertionError("the xla tier launched a ring kernel")

    def rows(t):
        return t.reshape(n, -1)

    def zeros_off(what, t, root):
        for r in range(n):
            if r != root and bool(rows(t)[r].any()):
                raise AssertionError(f"{what}: rank {r} is not zeros")

    def dev_of(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def expect(what, got, want, rtol=0.0):
        want = dev_of(want)
        if rtol:
            ok = torch.allclose(got, want, rtol=rtol, atol=0.0)
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(
                f"{what} != numpy, max abs err "
                f"{(got.double() - want.double()).abs().max().item()}")

    ring = dict(zip(names, ring_out))
    xla = dict(zip(names, xla_out))
    sum64 = per.astype(np.float64).sum(0)
    for r in range(n):
        expect(f"bcast rank {r}", rows(ring["bcast"])[r], per[API_ROOT])
        expect(f"allreduce f32 rank {r}", rows(ring["allreduce f32"])[r],
               sum64.astype(np.float32), rtol=1e-6)
        expect(f"allreduce i32 rank {r}", rows(ring["allreduce i32"])[r],
               per_i.sum(0, dtype=np.int32))
        expect(f"scatter rank {r}", rows(ring["scatter"])[r],
               per[API_ROOT][r * HALF_MIB:(r + 1) * HALF_MIB])
        expect(f"bcast port 1 rank {r}", rows(ring["bcast port 1"])[r],
               per_i[1])
    expect("reduce add at root", rows(ring["reduce add"])[API_ROOT],
           sum64.astype(np.float32), rtol=1e-6)
    expect("reduce max at root", rows(ring["reduce max"])[API_ROOT],
           per_i.max(0))
    expect("reduce min at root", rows(ring["reduce min port 2"])[2],
           per_i.min(0))
    expect("gather at root", rows(ring["gather"])[API_ROOT],
           per[:, :HALF_MIB].reshape(-1))
    expect("transfer at dst", rows(ring["transfer"])[API_ROOT], per[0])
    expect("stream at dst", rows(ring["stream"])[API_ROOT + 1],
           per[API_ROOT])
    expect("stream consumer at dst", ring["stream total"][API_ROOT + 1],
           np.float32(per[API_ROOT].astype(np.float64).sum()), rtol=1e-5)
    for what, root in (("reduce add", API_ROOT), ("reduce max", API_ROOT),
                       ("gather", API_ROOT), ("transfer", API_ROOT),
                       ("stream", API_ROOT + 1),
                       ("reduce min port 2", 2)):
        zeros_off(what, ring[what], root)
    for what in names:
        if what in ("reduce add", "allreduce f32", "stream total"):
            # another association of the same f32 sum
            if not torch.allclose(ring[what], xla[what], rtol=1e-6,
                                  atol=0.0):
                raise AssertionError(f"{what}: ring and xla tiers differ "
                                     f"beyond 1e-6")
        elif not torch.equal(ring[what], xla[what]):
            raise AssertionError(f"{what}: ring tier != xla tier")
    log(f"  12 results equal to numpy (f32 ADD within 1e-6 relative), "
        f"zeros off-root, and to the xla tier (exactly but for f32 ADD); "
        f"transfer 0->{API_ROOT} made 3 hops in direction -1, stream "
        f"{API_ROOT}->{API_ROOT + 1} moved "
        f"{-(-SMI_ELEMS // 2072)} chunks of 2072 elements in one launch")
    del ring, xla, ring_out, xla_out

    # ---- 22. the applications ----------------------------------------
    log("[22 k-means on 8 ranks, GESUMMV on 2]")
    points, k, dims, iters = 65536, 8, 2, 10
    prng = np.random.RandomState(0)
    pts = prng.rand(points, dims).astype(np.float32)
    init = pts[:k].copy()
    kmeans = st.make_kmeans_fn(w8, iters, backend="ring")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    means = kmeans(pts, init)
    torch.cuda.synchronize()
    kmeans_wall = time.perf_counter() - t0
    counted(f"k-means {points} points k={k} {iters} iterations "
            f"({kmeans_wall * 1e3:.1f} ms host wall, "
            f"{points * iters / kmeans_wall:.4g} point-iterations/s)",
            {"ring_all_reduce": 4 * iters, "ring_reduce_scatter": 0,
             "ring_all_gather": 0, "ring_neighbour_stream": 0})
    np.testing.assert_allclose(means.cpu().numpy(),
                               st.reference_kmeans(pts, init, iters),
                               rtol=1e-3, atol=1e-4)
    log("  k-means within rtol 1e-3, atol 1e-4 of reference_kmeans")
    size = 1024
    grng = np.random.RandomState(0)
    a = grng.rand(size, size).astype(np.float32)
    b = grng.rand(size, size).astype(np.float32)
    xv = grng.rand(size).astype(np.float32)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for torch.matmul")
    gesummv = st.make_gesummv_fn(world(2), size, 1.5, 0.5, buffer_size=2048,
                                 backend="ring")
    _build.reset_launches()
    y = gesummv(np.stack([a, b]), xv)
    counted(f"GESUMMV n={size}",
            {"ring_all_reduce": 0, "ring_reduce_scatter": 0,
             "ring_all_gather": 0, "ring_neighbour_stream": 1})
    np.testing.assert_allclose(y.cpu().numpy(),
                               st.reference_gesummv(a, b, xv, 1.5, 0.5),
                               rtol=2e-3)
    log("  GESUMMV within rtol 2e-3 of reference_gesummv (torch.matmul "
        "in full f32: TF32 off)")

    # ---- 23. the stencil across ranks on the card ---------------------
    log("[23 8192x8192 stencil on the 2x4 world]")
    sweeps = 8
    grid = st.initial_grid(N, N)
    grid[:, -1] = 2.0
    grid[N // 2, :] = 0.5

    def stencil(backend):
        blocks = w24.run(lambda c: st.make_stencil_fn(
            c, sweeps, backend=backend)(st.block_from_numpy(grid, c)))
        return torch.cat([torch.cat(blocks[r * 4:(r + 1) * 4], dim=1)
                          for r in range(2)], dim=0)

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ring_grid = stencil("ring")
    wall = time.perf_counter() - t0
    counted(f"{sweeps} sweeps, backend ring ({wall * 1e3:.1f} ms host wall)",
            {"ring_all_reduce": 0, "ring_reduce_scatter": 0,
             "ring_all_gather": 0, "ring_neighbour_stream": 4 * sweeps})
    log("  four shifts a sweep, one launch each: a launch plays every "
        "line of its axis at once (the two sy rings of four ranks, or "
        "the four sx rings of two)")
    xla_grid = stencil("xla")
    if not torch.equal(ring_grid, xla_grid):
        raise AssertionError("2x4 stencil: ring tier != xla tier")
    del xla_grid
    comm11 = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"))
    one = st.make_stencil_fn(comm11, sweeps)(st.block_from_numpy(grid,
                                                                  comm11))
    torch.cuda.synchronize()
    if not torch.equal(ring_grid, one):
        raise AssertionError(
            f"2x4 stencil over the ring tier != the 1x1 plain stencil, max "
            f"abs err {(ring_grid - one).abs().max().item()}")
    log("  torch.equal to backend xla and to the 1x1 plain stencil")
    del ring_grid, one

    # ---- 24. times -----------------------------------------------------
    log("[24 ring kernel times, 8 ranks]")
    records = []

    def kernel_ms(fn, reps=10):
        times = []
        for _ in range(reps + 2):
            w8.run(fn)
            times.append(kring.last_record(w8)["ms"])
        return sum(times[2:]) / reps   # two warm-up launches

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    p_ar, p_half = 4 * SMI_ELEMS, 4 * HALF_MIB
    timed_cases = [
        # kernel, name, shape, bytes of all ranks' inputs and outputs
        # (each once: the bound), bytes the ring schedule moves in device
        # memory (ring.cu's note; logged, not a bound), library call
        ("ring_all_reduce", f"n={n} {SMI_ELEMS} f32 add", (SMI_ELEMS,),
         n * 2 * p_ar, n * (3 * n - 1) * p_ar,
         lambda xs: torch.stack(xs).sum(0)),
        ("ring_all_gather", f"n={n} {HALF_MIB} f32 a rank", (HALF_MIB,),
         n * (1 + n) * p_half, n * 4 * n * p_half,
         lambda xs: torch.cat(xs)),
        # rank r's block is a view of the stacked sum: [r*c:(r+1)*c]
        ("ring_reduce_scatter", f"n={n} {n}x{HALF_MIB} f32 a rank",
         (n * HALF_MIB,), n * (n + 1) * p_half,
         n * (3 * n - 1) * p_half,
         lambda xs: torch.stack(xs).sum(0).chunk(n)),
        ("ring_neighbour_stream",
         f"n={n} {HALF_MIB} f32 in {STREAM_CHUNKS} chunks",
         (STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS), n * 2 * p_half,
         n * 4 * p_half, lambda xs: torch.roll(torch.stack(xs), 1, 0)),
    ]
    for kernel, name, shape, io_bytes, sched_bytes, library in timed_cases:
        xs = [rnd(shape, f32) for _ in range(n)]
        call, plain = calls[kernel]
        ms = kernel_ms(lambda c: call(xs[c.rank], c, {}))
        plain_ms = time_ms(lambda: plain(xs, {}), 5)
        lib_ms = time_ms(lambda: library(xs), 20)
        b_ms = bound(io_bytes)
        log(f"  {kernel} {name}: {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({io_bytes / 1e6:.1f} MB: all ranks' inputs and outputs "
            f"once), {ms / b_ms:.1f}x; the ring schedule moves "
            f"{sched_bytes / 1e6:.1f} MB in device memory "
            f"({sched_bytes / ms / 1e9:.4g} TB/s); plain {plain_ms:.4f} "
            f"ms, stacked library call {lib_ms:.4f} ms; launches on "
            f"phases 21-23: {launches[kernel]}")
        records.append({
            "name": f"{kernel} {name}", "route": "cuda", "source": RING_SRC,
            "replaces": RING_REPLACES[kernel],
            "launches": launches[kernel], "max_abs_err": max_err[kernel],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": "bytes", "library_ms": lib_ms,
        })
    # one collective through the API, host wall: the rendezvous' cost
    xs = [rnd((SMI_ELEMS,), f32) for _ in range(n)]
    t0 = time.perf_counter()
    for _ in range(5):
        w8.run(lambda c: st.allreduce(xs[c.rank], c, backend="ring"))
    api_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"  one allreduce of {SMI_ELEMS} f32 a rank through LocalWorld.run: "
        f"{api_ms:.3f} ms host wall ({n * 4 * SMI_ELEMS / api_ms / 1e6:.4g} "
        f"GB/s payload bytes x ranks); k-means "
        f"{points * iters / kmeans_wall:.4g} point-iterations/s")
    return records, check


CHUNKED_REPLACES = "smi_tpu/kernels/ring.py:542"
#: phase 26: timed runs per benchmark, and the depth cut from the JAX
#: defaults (pingpongs and messages 100, rounds 16); widths stay
SUITE_RUNS = 3
SUITE_CUTS = {"latency": {"pingpongs": 20}, "injection": {"messages": 20},
              "pipeline": {"rounds": 4}, "pipeline_double_rail": {"rounds": 4}}


def suite_phases(dev, gen, ring_check):
    """Phases 25-27: the chunked ring all-reduce and the benchmark suite
    on eight ranks of the card; ``ring_check`` is phase 20's check of one
    ring launch. Returns the chunked kernel's records."""
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.benchmarks.micro import BENCHMARKS, run_benchmark
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring

    f32, kernel = torch.float32, "ring_all_reduce_chunked"
    n = SMI_RANKS
    worlds = {}

    def world(m):
        if m not in worlds:
            worlds[m] = st.LocalWorld(m)
        return worlds[m]

    def rnd(shape, dtype):
        if dtype.is_floating_point:
            return torch.rand(shape, generator=gen, device=dev,
                              dtype=f32).add_(0.5).to(dtype)
        return torch.randint(-100, 100, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)

    max_err = [0.0]

    def check(w, shape, dtype, chunks, op="add", axis=None):
        """One chunked launch against its plain version and the unchunked
        kernel, per line of ``axis``: equal on every rank, every credit
        domain drained, the control without rank 1 unequal."""
        xs = [rnd(shape, dtype) for _ in range(w.size)]
        before = _build.LAUNCHES[kernel]
        got = w.run(lambda c: kring.ring_all_reduce(
            xs[c.rank], c, axis, op=op, chunks=chunks))
        record = kring.last_record(w)
        if _build.LAUNCHES[kernel] != before + 1:
            raise AssertionError(f"{kernel}: not one launch")
        unchunked = w.run(lambda c: kring.ring_all_reduce(xs[c.rank], c,
                                                          axis, op=op))

        def plain(ys):
            outs = [None] * w.size
            for line in w.lines(axis):
                for r, o in zip(line, kring.ring_all_reduce_chunked_plain(
                        [ys[r] for r in line], chunks, op)):
                    outs[r] = o
            return outs

        want = plain(xs)
        what = (f"{len(w.lines(axis))} ring(s) of {len(w.lines(axis)[0])} "
                f"{tuple(shape)} {str(dtype)[6:]} {op} chunks={chunks}")
        for r in range(w.size):
            err = (got[r].double() - want[r].double()).abs().max().item()
            max_err[0] = max(max_err[0], err)
            if not torch.equal(got[r], want[r]):
                raise AssertionError(f"{what}: rank {r} kernel != plain, "
                                     f"max abs err {err}")
            if not torch.equal(got[r], unchunked[r]):
                raise AssertionError(f"{what}: rank {r} != the unchunked "
                                     f"kernel")
        if not kring.drained(record):
            raise AssertionError(f"{what}: credits did not drain: {record}")
        if record["chunks"] != min(chunks, shape[0]):
            raise AssertionError(f"{what}: {record['chunks']} chunks ran")
        dropped = list(xs)
        dropped[1] = torch.zeros_like(xs[1])
        control = plain(dropped)
        if all(torch.equal(got[r], control[r]) for r in range(w.size)):
            raise AssertionError(f"{what}: equal to the plain version "
                                 f"without rank 1's contribution")
        return (f"{what}: equal to plain and unchunked on {w.size} ranks, "
                f"{record['chunks']} x {record['blocks']} credit domains a "
                f"rank drained, {int(record['granted'].sum())} credits")

    # ---- 25. the chunked kernel vs its plain version -------------------
    log("[25 chunked ring all-reduce vs plain and unchunked]")
    side = int(SMI_ELEMS ** 0.5)   # SMI_ELEMS as (1024, 1024)
    for shape, dtype, chunks, op in (
            ((side, side), f32, 2, "add"), ((side, side), f32, 4, "add"),
            ((side, side), f32, 8, "add"),
            ((side, side), torch.int32, 4, "max"),
            ((side, side), torch.bfloat16, 4, "add"),
            ((65536,), f32, 4, "add"), ((16384,), f32, 4, "add"),
            ((4096,), f32, 4, "add"), ((1000, 256), f32, 3, "add")):
        log("  " + check(world(n), shape, dtype, chunks, op))
    small = 0
    for m in (2, 3):
        for dtype in (f32, torch.bfloat16, torch.int8):
            for chunks, op in ((2, "add"), (3, "min")):
                check(world(m), (5, 130), dtype, chunks, op)
                small += 1
    log(f"  n=2 and 3: {small} cases (5 x 130 in f32, bf16 and int8, "
        f"chunks 2 ADD with a pad row and 3 MIN) equal and drained")
    w24 = st.LocalWorld((2, 4), ("sx", "sy"))
    for axis in ("sx", "sy"):
        log("  " + check(w24, (9, 2048), f32, 4, axis=axis))

    # ---- 26. the benchmark suite on the card ---------------------------
    log(f"[26 the benchmark suite, {n} ranks, {SUITE_RUNS} runs each]")
    w8 = world(n)
    event_ms = [0.0]
    launch = kring._launch

    shapes = {}   # every distinct ring launch of the suite, replayed below

    def timed_launch(*args, **kwargs):
        # the grid's event time, summed: the rendezvous synchronises the
        # world's stream right after, so waiting here costs nothing
        launch(*args, **kwargs)
        kernel_, w, axis, stream, xs, _, _, extra, flow = args[:9]
        key = (kernel_, axis, stream, tuple(xs[0].shape), xs[0].dtype,
               tuple(extra), flow)
        shapes[key] = shapes.get(key, 0) + 1
        begin, end = w.ring_state[("stream", stream)]["events"]
        end.synchronize()
        event_ms[0] += begin.elapsed_time(end)

    launches = {}
    t_suite = time.perf_counter()
    kring._launch = timed_launch
    try:
        for backend in ("xla", "ring"):
            for name in sorted(BENCHMARKS):
                if name.startswith("app_") and backend == "ring":
                    continue
                params = dict(SUITE_CUTS.get(name, {}), runs=SUITE_RUNS)
                torch.cuda.synchronize()
                _build.reset_launches()
                event_ms[0] = 0.0
                t0 = time.perf_counter()
                m = run_benchmark(name, w8, backend=backend, **params)
                wall = (time.perf_counter() - t0) * 1e3
                got = {k: v for k, v in _build.LAUNCHES.items() if v}
                extra = {k: m.config[k] for k in ("sweep",
                                                  "serialized_mean_usec")
                         if k in m.config}
                if extra:
                    log(f"    {m.name}: {extra}")
                if backend == "ring":
                    log(f"    {m.name}: {wall:.1f} ms host wall for the "
                        f"benchmark, ring kernels {event_ms[0]:.3f} ms of "
                        f"events ({100 * event_ms[0] / wall:.2f} %), "
                        f"launches {got}")
                    if not got:
                        raise AssertionError(f"{m.name}: no ring kernel "
                                             f"ran")
                elif any(k.startswith("ring_") for k in got):
                    raise AssertionError(f"{m.name}: the xla tier "
                                         f"launched a ring kernel")
                else:
                    log(f"    {m.name}: {wall:.1f} ms host wall for the "
                        f"benchmark, its verification included")
                if name == "overlap" and backend == "ring":
                    launches = dict(_build.LAUNCHES)
                    if launches[kernel] <= 0:
                        raise AssertionError("overlap on ring: the chunked "
                                             "kernel was not launched")
    finally:
        kring._launch = launch
    log(f"  the suite: {time.perf_counter() - t_suite:.1f} s; overlap on "
        f"ring made {launches[kernel]} chunked and "
        f"{launches['ring_all_reduce']} unchunked launches")
    # the suite's inputs are ones and ranks alike; each launch shape it
    # made is held again on random inputs against its plain version
    ops = {code: op.name.lower() for op, code in kring.OP_CODES.items()}
    for (kernel_, axis, stream, shape, dtype, extra,
         flow), count in sorted(shapes.items(), key=str):
        if kernel_ == kernel:
            what = check(w8, shape, dtype, shape[0], ops[extra[0]], axis)
        else:
            kw = {"axis_name": axis, "stream": stream, "flow_control": flow}
            if kernel_ in ("ring_all_reduce", "ring_reduce_scatter"):
                kw["op"] = ops[extra[0]]
            if kernel_ == "ring_neighbour_stream":
                kw["direction"] = extra[1]
            what = ring_check(kernel_, n, shape, dtype, w=w8, **kw)
        log(f"    {count} launches of the suite: {what}")
    log(f"  {len(shapes)} launch shapes of the suite's ring tier equal to "
        f"their plain versions on random inputs")

    # ---- 27. times -------------------------------------------------------
    log("[27 chunked ring all-reduce times, 8 ranks]")
    records = []

    def kernel_ms(fn, reps=10):
        times = []
        for _ in range(reps + 2):
            w8.run(fn)
            times.append(kring.last_record(w8)["ms"])
        return sum(times[2:]) / reps   # two warm-up launches

    xs = [rnd((side, side), f32) for _ in range(n)]
    io_bytes = n * 2 * 4 * SMI_ELEMS
    b_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    lib_ms = time_ms(lambda: torch.stack(xs).sum(0), 20)
    for chunks in (2, 4, 8):
        base_ms = kernel_ms(lambda c: kring.ring_all_reduce(xs[c.rank], c))
        ms = kernel_ms(lambda c: kring.ring_all_reduce(xs[c.rank], c,
                                                       chunks=chunks))
        plain_ms = time_ms(
            lambda: kring.ring_all_reduce_chunked_plain(xs, chunks), 5)
        log(f"  chunks={chunks}: {ms:.4f} ms, unchunked {base_ms:.4f} ms "
            f"({base_ms / ms:.3f}x), bound {b_ms:.4f} ms ({io_bytes / 1e6:.1f}"
            f" MB: all ranks' inputs and outputs once), {ms / b_ms:.1f}x; "
            f"plain {plain_ms:.4f} ms, stacked library call {lib_ms:.4f} "
            f"ms; launches on overlap's ring run: {launches[kernel]}")
        records.append({
            "name": f"{kernel} n={n} {side}x{side} f32 add chunks={chunks}",
            "route": "cuda", "source": RING_SRC,
            "replaces": CHUNKED_REPLACES, "launches": launches[kernel],
            "max_abs_err": max_err[0], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": lib_ms,
        })
    return records


if __name__ == "__main__":
    sys.exit(main())
