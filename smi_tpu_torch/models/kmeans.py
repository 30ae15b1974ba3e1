"""Distributed K-means: data-parallel clustering with in-loop collectives.

PyTorch counterpart of :mod:`smi_tpu.models.kmeans`. SPMD over the ranks
of a world, each owning a shard of the points; every iteration runs
``SMI_Reduce`` of the per-cluster coordinate sums on port 0,
``SMI_Bcast`` of the new means on port 1, ``SMI_Reduce`` of the counts on
port 2 and ``SMI_Bcast`` on port 3 — collectives embedded in a compute
loop. The assignment step and the one-hot sums are plain
``torch.matmul``s in full float32, as XLA's are there; the four rooted
collectives keep their reference ports, and with ``backend="ring"`` each
is one launch of the ring all-reduce kernel in its port's flag domain.
"""

from __future__ import annotations

import numpy as np
import torch

from smi_tpu_torch.parallel import collectives as coll
from smi_tpu_torch.parallel.context import smi_kernel
from smi_tpu_torch.parallel.mesh import Communicator


def assign_points(points: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment via one matmul.

    ``argmin_k ||p - m_k||^2 = argmin_k (||m_k||^2 - 2 p.m_k)`` — the
    ``||p||^2`` term is constant per point and dropped. The product runs
    in full float32 (TF32 is off for ``torch.matmul`` by default): a
    ~1e-3 relative error is enough to flip borderline assignments,
    diverging from the serial reference.
    """
    dots = torch.matmul(points, means.T)  # (n, K)
    m2 = torch.sum(means * means, dim=1)  # (K,)
    return torch.argmin(m2[None, :] - 2.0 * dots, dim=1)


def kmeans_iteration(points: torch.Tensor, means: torch.Tensor,
                     comm: Communicator, root: int = 0,
                     backend: str = "xla") -> torch.Tensor:
    """One distributed K-means update, reference collective for
    collective."""
    k = means.shape[0]
    assign = assign_points(points, means)
    onehot = torch.nn.functional.one_hot(assign, k).to(points.dtype)
    local_sums = torch.matmul(onehot.T, points)  # (K, D)
    local_counts = torch.sum(onehot, dim=0)  # (K,)

    # Reduce partial sums to the root (port 0), counts on port 2; the
    # root recomputes means and broadcasts them (ports 1, 3).
    sums = coll.reduce(local_sums, comm, op="add", root=root, port=0,
                       backend=backend)
    counts = coll.reduce(local_counts, comm, op="add", root=root, port=2,
                         backend=backend)
    new_means = sums / torch.clamp(counts, min=1.0)[:, None]
    new_means = coll.bcast(new_means, comm, root=root, port=1,
                           backend=backend)
    coll.bcast(counts, comm, root=root, port=3, backend=backend)
    return new_means


def make_kmeans_fn(world, iterations: int, root: int = 0,
                   backend: str = "xla"):
    """Distributed K-means on a 1-D world: ``fn(points, means0)`` shards
    the global points over the ranks, replicates the initial means, and
    returns the final means."""
    axis = world.axis_names[0]

    @smi_kernel(world, in_specs=(axis, None), out_specs=None,
                backend=backend)
    def fn(ctx, points, means):
        for _ in range(iterations):
            means = kmeans_iteration(points, means, ctx.comm, root=root,
                                     backend=ctx.backend)
        return means

    return fn


def run_kmeans(points: np.ndarray, init_means: np.ndarray, iterations: int,
               world=None, device=None, backend: str = "xla") -> torch.Tensor:
    if world is None:
        from smi_tpu_torch.parallel.local import LocalWorld

        world = LocalWorld(8, device=device)
    if points.shape[0] % world.size:
        raise ValueError(
            f"point count {points.shape[0]} not divisible by {world.size} "
            f"ranks"
        )
    return make_kmeans_fn(world, iterations, backend=backend)(
        np.asarray(points), np.asarray(init_means))


def reference_kmeans(points: np.ndarray, init_means: np.ndarray,
                     iterations: int) -> np.ndarray:
    """Serial reference implementing the identical update rule."""
    points = np.asarray(points, dtype=np.float64)
    means = np.asarray(init_means, dtype=np.float64)
    k = means.shape[0]
    for _ in range(iterations):
        d2 = ((points[:, None, :] - means[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(1)
        sums = np.zeros_like(means)
        counts = np.zeros(k)
        for j in range(k):
            mask = assign == j
            counts[j] = mask.sum()
            sums[j] = points[mask].sum(0)
        means = sums / np.maximum(counts, 1.0)[:, None]
    return means
