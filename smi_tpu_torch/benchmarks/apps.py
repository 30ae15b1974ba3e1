"""Application benchmarks: the reference's example workloads, timed.

PyTorch counterpart of :mod:`smi_tpu.benchmarks.apps`. Reference hosts
time their kernels and verify results in the same run
(``examples/host/stencil_smi.cpp:316-340``, ``gesummv_smi.cpp``,
``kmeans_smi.cpp``); these do the same — each measurement verifies the
payload against the serial reference before reporting, at the JAX
package's tolerances. Each runs on the ranks of a
:class:`~smi_tpu_torch.parallel.local.LocalWorld` (or a world made from
it on the same device) and has no ring tier, as there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smi_tpu_torch.benchmarks.stats import Measurement, timed_samples
from smi_tpu_torch.parallel.local import LocalWorld

#: ring attention's training benchmark holds the flash tier's gradients
#: to the plain tier's autograd on a prefix of its timed inputs of at most
#: this many tokens a rank, as the JAX package does (the plain tier stores
#: per-step quadratic probabilities)
VERIFY_SEQ_PER_RANK = 2048


def _readback(outs) -> None:
    for out in outs:
        out.cpu()


def _grid_for(world: LocalWorld) -> LocalWorld:
    """Factor a world's ranks into a 2-D ``(px, n/px)`` world on the same
    device."""
    n = world.size
    px = max(d for d in range(1, int(n**0.5) + 1) if n % d == 0)
    return LocalWorld((px, n // px), ("sx", "sy"), device=world.device)


def bench_stencil(world: LocalWorld, size: int = 1024, iterations: int = 32,
                  runs: int = 5) -> Measurement:
    """Distributed Jacobi throughput (cells/s); verified once vs serial."""
    from smi_tpu_torch.convert import block_from_numpy
    from smi_tpu_torch.kernels import stencil_temporal as kt
    from smi_tpu_torch.models import stencil

    world2d = _grid_for(world)
    px, py = world2d.shape
    if size % px or size % py:
        raise ValueError(
            f"grid {size}x{size} not divisible by process grid "
            f"({px}, {py}); pick a size divisible by both"
        )
    h, w = size // px, size // py
    depth = kt.pick_temporal_depth(h, w, torch.float32, iterations)
    g = stencil.initial_grid(size, size)
    blocks = world2d.run(lambda c: block_from_numpy(g, c))

    def body(comm):
        if depth is not None:
            fn = kt.make_temporal_stencil_fn(comm, iterations, size, size,
                                             depth=depth)
        else:
            fn = stencil.make_stencil_fn(comm, iterations)
        return fn(blocks[comm.rank])

    out = world2d.run(body)
    grid = torch.cat([torch.cat(out[r * py:(r + 1) * py], dim=1)
                      for r in range(px)], dim=0)
    ref = stencil.reference_stencil(g, iterations)
    np.testing.assert_allclose(grid.cpu().numpy(), ref, rtol=1e-5,
                               atol=1e-5)

    samples = timed_samples(
        lambda: _readback(world2d.run(lambda c: torch.sum(body(c))[None])),
        runs)
    rates = [size * size * iterations / t / 1e9 for t in samples]
    return Measurement(
        "app-stencil", "Gcell/s", rates,
        {"size": size, "iterations": iterations, "mesh": f"{px}x{py}"},
    )


def bench_gesummv(world: LocalWorld, n: int = 1024,
                  runs: int = 5) -> Measurement:
    """2-rank GESUMMV GFLOP/s (2 matvecs = 4n² flops); verified. Runs on
    a 2-rank world on the world's device."""
    from smi_tpu_torch.models import gesummv

    if world.size < 2:
        raise ValueError(
            "app_gesummv is the 2-rank MPMD workload "
            "(gesummv_rank{0,1}.cl); it needs at least 2 ranks"
        )
    world2 = LocalWorld(2, device=world.device)
    rng = np.random.RandomState(0)
    a = rng.rand(n, n).astype(np.float32)
    b = rng.rand(n, n).astype(np.float32)
    x = rng.rand(n).astype(np.float32)
    ab = torch.from_numpy(np.stack([a, b])).to(world.device)
    xt = torch.from_numpy(x).to(world.device)
    fn = gesummv.make_gesummv_fn(world2, n, 1.5, 0.5)

    out = fn(ab, xt).cpu().numpy()
    ref = gesummv.reference_gesummv(a, b, x, 1.5, 0.5)
    np.testing.assert_allclose(out, ref, rtol=2e-3)

    samples = timed_samples(lambda: torch.sum(fn(ab, xt)).item(), runs)
    rates = [4 * n * n / t / 1e9 for t in samples]
    return Measurement("app-gesummv", "GFLOP/s", rates, {"n": n})


def bench_kmeans(world: LocalWorld, points: int = 65536, k: int = 8,
                 dims: int = 2, iterations: int = 10,
                 runs: int = 5) -> Measurement:
    """Data-parallel K-means iteration rate; verified vs serial."""
    from smi_tpu_torch.models import kmeans

    points -= points % world.size
    rng = np.random.RandomState(0)
    pts = rng.rand(points, dims).astype(np.float32)
    init = pts[:k].copy()
    fn = kmeans.make_kmeans_fn(world, iterations=iterations)
    pts_t = torch.from_numpy(pts).to(world.device)
    init_t = torch.from_numpy(init).to(world.device)

    out = fn(pts_t, init_t).cpu().numpy()
    ref = kmeans.reference_kmeans(pts, init, iterations)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)

    samples = timed_samples(lambda: torch.sum(fn(pts_t, init_t)).item(),
                            runs)
    rates = [points * iterations / t / 1e6 for t in samples]
    return Measurement(
        "app-kmeans", "Mpoint-iters/s", rates,
        {"points": points, "k": k, "dims": dims,
         "iterations": iterations},
    )


def _default_seq_per_rank(world: LocalWorld) -> int:
    """1024 on the card; 128 on a CPU world, where a step at 8k global
    tokens of the plain tier takes long."""
    return 1024 if world.device.type == "cuda" else 128


def _attention_inputs(world: LocalWorld, seq_per_rank: int, heads: int,
                      head_dim: int):
    """Global float32 ``(S, H, D)`` q, k, v from ``RandomState(0)``, as
    the JAX benchmark makes them, and each rank's shards of them."""
    s = world.size * seq_per_rank
    rng = np.random.RandomState(0)
    qkv = [rng.randn(s, heads, head_dim).astype(np.float32)
           for _ in range(3)]
    return qkv, _shards(world, qkv)


def _shards(world: LocalWorld, arrays):
    """Each rank's sequence shards of the global ``arrays``."""
    from smi_tpu_torch.convert import sequence_shard_from_numpy

    return world.run(lambda c: [sequence_shard_from_numpy(a, c)
                                for a in arrays])


def bench_ring_attention(
    world: LocalWorld, seq_per_rank: Optional[int] = None, heads: int = 8,
    head_dim: int = 128, runs: int = 5, causal: bool = True,
    precision=None, reps: int = 8, window: Optional[int] = None,
) -> Measurement:
    """Sequence-parallel attention throughput (global tokens/s).

    The long-context workload: each rank holds ``seq_per_rank`` tokens
    and K/V blocks circulate the ring (``models/ring_attention.py``; the
    flash kernels on the card, the plain tier on the CPU). Float32 with
    TF32 off, verified at the JAX package's HIGHEST tolerance (5e-4) on a
    sampled subset of query rows against the float64 reference (full
    verification is O(S²) host memory). ``precision`` is accepted for
    the JAX signature: only full float32 is ported. Each timed sample
    chains ``reps`` applications (output fed back as the next query).
    """
    from smi_tpu_torch.models import ring_attention as ra

    if precision not in (None, "HIGHEST"):
        raise ValueError(
            f"precision={precision!r}: the port runs attention in full "
            f"float32 (HIGHEST) only"
        )
    if torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("TF32 is on for torch.matmul; attention's bar "
                         "is full float32")
    if seq_per_rank is None:
        seq_per_rank = _default_seq_per_rank(world)
    s = world.size * seq_per_rank
    (q, k, v), shards = _attention_inputs(world, seq_per_rank, heads,
                                          head_dim)

    def attend(reps_):
        def body(comm):
            fn = ra.make_ring_attention_fn(comm, causal=causal, reps=reps_,
                                           window=window)
            return fn(*shards[comm.rank])
        return body

    out = torch.cat(world.run(attend(1))).cpu().numpy()
    idx = np.linspace(0, s - 1, num=min(s, 128), dtype=np.int64)
    ref = ra.reference_attention_rows(q, k, v, idx, causal=causal,
                                      window=window)
    np.testing.assert_allclose(out[idx], ref, rtol=5e-4, atol=5e-4)

    chained = attend(reps)
    samples = timed_samples(
        lambda: _readback(world.run(lambda c: torch.sum(chained(c))[None])),
        runs)
    rates = [reps * s / t / 1e6 for t in samples]
    return Measurement(
        "app-ring-attention", "Mtoken/s", rates,
        {"seq": s, "seq_per_rank": seq_per_rank, "heads": heads,
         "head_dim": head_dim, "causal": causal, "ranks": world.size,
         "precision": "HIGHEST", "reps": reps, "window": window},
    )


def _flash_grads(comm, q, k, v, causal, window, reps):
    """Gradients of ``sum(fn(q, k, v) ** 2)`` for ``fn`` the flash tier
    chained ``reps`` times, by the chain rule written out: each rep's
    ``_flash_forward`` (its residuals kept), then ``_flash_ring_backward``
    in reverse, dq of one rep the output gradient of the one before.
    Autograd would run every rank's backward on the card's one autograd
    thread, where the ring's rendezvous cannot fill; this runs each
    rank's on its own thread, on the same kernels."""
    from smi_tpu_torch.models import ring_attention as ra

    axis = comm.axis_names[0]
    saved, cur = [], q
    for _ in range(reps):
        out, m, l = ra._flash_forward(cur, k, v, comm, causal, axis, window)
        saved.append((cur, out, m, l))
        cur = out
    dout, dk, dv = 2 * cur, 0, 0
    for q_i, out, m, l in reversed(saved):
        dout, dk_i, dv_i = ra._flash_ring_backward(
            q_i, k, v, out, m, l, dout, comm, causal, axis, window)
        dk, dv = dk + dk_i, dv + dv_i
    return dout, dk, dv


def _autograd_grads(comm, q, k, v, causal, window, reps):
    """The same gradients by autograd through the default tier (on a CPU
    world each rank's backward runs on its own thread)."""
    from smi_tpu_torch.models import ring_attention as ra

    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    fn = ra.make_ring_attention_fn(comm, causal=causal, reps=reps,
                                   window=window)
    loss = torch.sum(fn(q, k, v) ** 2)
    return torch.autograd.grad(loss, (q, k, v))


def bench_ring_attention_train(
    world: LocalWorld, seq_per_rank: Optional[int] = None, heads: int = 8,
    head_dim: int = 128, runs: int = 5, causal: bool = True,
    reps: int = 4, window: Optional[int] = None,
) -> Measurement:
    """Training-step throughput: forward + backward tokens/s.

    On the card the flash tier: its gradients (:func:`_flash_grads`, each
    rank on its own thread) are first held at 5e-4 to autograd through
    the plain tier on a CPU world of the same ranks, on the first
    ``n * min(seq_per_rank, VERIFY_SEQ_PER_RANK)`` tokens of the timed
    inputs, as the JAX package verifies; on a CPU world the tier is the
    plain one and autograd runs (nothing to verify, as in the JAX
    package). Timed samples chain ``reps`` fwd+bwd pairs (the gradient
    of a ``reps``-chained loss).
    """
    from smi_tpu_torch.models import ring_attention as ra

    if seq_per_rank is None:
        seq_per_rank = _default_seq_per_rank(world)
    n = world.size
    s = n * seq_per_rank
    flash = ra._use_flash_default(world.comms[0], seq_per_rank, heads,
                                  head_dim, torch.float32)
    if flash and head_dim not in ra.HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim}: the flash kernels take "
                         f"{ra.HEAD_DIMS}")
    grads = _flash_grads if flash else _autograd_grads

    qkv, shards = _attention_inputs(world, seq_per_rank, heads, head_dim)
    if flash:
        prefix = [a[:n * min(seq_per_rank, VERIFY_SEQ_PER_RANK)]
                  for a in qkv]
        on_card = _shards(world, prefix)
        cpu_world = LocalWorld(n, device="cpu")
        on_cpu = _shards(cpu_world, prefix)
        got = world.run(lambda c: _flash_grads(
            c, *on_card[c.rank], causal, window, 1))
        want = cpu_world.run(lambda c: _autograd_grads(
            c, *on_cpu[c.rank], causal, window, 1))
        for r in range(n):
            for a, b, nm in zip(got[r], want[r], ("dq", "dk", "dv")):
                np.testing.assert_allclose(
                    a.cpu().numpy(), b.numpy(), rtol=5e-4, atol=5e-4,
                    err_msg=f"rank {r} {nm}")
        del got, want, on_card, on_cpu

    samples = timed_samples(
        lambda: _readback(world.run(lambda c: torch.sum(grads(
            c, *shards[c.rank], causal, window, reps)[0])[None])),
        runs)
    rates = [reps * s / t / 1e6 for t in samples]
    return Measurement(
        "app-ring-attention-train", "Mtoken/s", rates,
        {"seq": s, "seq_per_rank": seq_per_rank, "heads": heads,
         "head_dim": head_dim, "causal": causal, "ranks": n,
         "reps": reps, "window": window},
    )


APP_BENCHMARKS = {
    "app_stencil": bench_stencil,
    "app_gesummv": bench_gesummv,
    "app_kmeans": bench_kmeans,
    "app_ring_attention": bench_ring_attention,
    "app_ring_attention_train": bench_ring_attention_train,
}
