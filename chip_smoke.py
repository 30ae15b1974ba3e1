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

Any failure raises and exits non-zero. The line before the last is the
per-kernel JSON record; the last line is the device JSON.
"""

import json
import subprocess
import sys
import time

SEED = 1234
N = 8192                  # the reference's hardware grid (models/stencil.py)
BLOCK = (4096, 2048)      # one rank's block of 8192^2 on the 2x4 grid
BLOCK_AT = (4096, 6144)   # its offset: the bottom-right rank, on two edges
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at 700 W
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores


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
    log(f"[2 build] {sorted(_build.LAUNCHES)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in sorted(_build.LAUNCHES):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
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
        for name, n in launches.items():
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

    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
