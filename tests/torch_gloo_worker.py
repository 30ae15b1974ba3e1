"""One rank of a gloo process group driving smi_tpu_torch on CPU tensors.

Spawned by ``tests/test_torch_halo.py`` (the stencil: :func:`run`),
``tests/test_torch_stencil_pipeline.py`` (the pipeline tier:
:func:`run_pipeline`), ``tests/test_torch_ring_attention.py`` (ring
attention: :func:`run_attention`), ``tests/test_torch_transformer.py``
(the train step: :func:`run_train_step`) and
``tests/test_torch_collectives.py`` (the SMI collectives and channels on
the collective-library tier: :func:`run_collectives`) and
``tests/test_torch_alltoall.py`` (the all-to-all family, the hybrid
communicator's collectives and verified transfers: :func:`run_surface`)
and ``tests/test_torch_elastic.py`` (a rank drops out and the survivors
shrink: :func:`run_shrink`) through :func:`run_group`; it imports
torch and the port, never jax, so each child starts quickly. Every rank
checks its own halo slabs against slices of the zero-padded global grid;
rank 0 reports the gathered results of the distributed stencil tiers on
``results``. In the attention and training groups every rank reports its
own shards and gradients.
"""

import multiprocessing as mp
import queue
import socket
import time
import traceback
from datetime import timedelta

import numpy as np

#: wall-clock budget of one spawned group, well inside the 300 s watchdog
JOIN_TIMEOUT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(target, world: int, args, timeout: float = JOIN_TIMEOUT_S):
    """Spawn ``world`` ranks of ``target(rank, world, port, *args,
    results)``, collect every rank's report, join them all. Returns
    ``{rank: payload}``; raises AssertionError when a rank fails, does
    not report in time or exits non-zero."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target,
                         args=(r, world, port, *args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        reports = {}
        deadline = time.monotonic() + timeout
        while len(reports) < world:
            left = deadline - time.monotonic()
            try:
                rank, status, payload = results.get(timeout=max(left, 1))
            except queue.Empty:
                raise AssertionError(
                    f"{world - len(reports)} rank(s) did not report within "
                    f"{timeout} s") from None
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{payload}")
            reports[rank] = payload
        for p in procs:
            p.join(timeout=30)
        assert [p.exitcode for p in procs] == [0] * world
        return reports
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def expected_slabs(g: np.ndarray, coords, block_shape, depth: int):
    """What a non-wrapping exchange must deliver to the rank at
    ``coords``: slices of the global grid padded with ``depth`` zeros."""
    d = depth
    h, w = block_shape
    r0, c0 = coords[0] * h, coords[1] * w
    gp = np.pad(g, d)
    return {
        "top": gp[r0:r0 + d, c0 + d:c0 + d + w],
        "bottom": gp[r0 + h + d:r0 + h + 2 * d, c0 + d:c0 + d + w],
        "left": gp[r0 + d:r0 + d + h, c0:c0 + d],
        "right": gp[r0 + d:r0 + d + h, c0 + w + d:c0 + w + 2 * d],
        "corner_top": gp[r0:r0 + d, c0:c0 + w + 2 * d],
        "corner_bottom": gp[r0 + h + d:r0 + h + 2 * d, c0:c0 + w + 2 * d],
    }


def _check(name, got, want):
    got = got.numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"{name}: got {got!r}, want {want!r}")


def _check_halos(comm, g, block, depth):
    import smi_tpu_torch as st

    want = expected_slabs(g, comm.coords, tuple(block.shape), depth)
    halos = st.halo_exchange_2d(block, comm, depth=depth)
    split = st.halo_exchange_finish(
        st.halo_exchange_start(block, comm, depth=depth))
    corners = st.halo_exchange_2d_corners(block, comm, depth=depth)
    for side in ("top", "bottom", "left", "right"):
        _check(f"d={depth} {side}", getattr(halos, side), want[side])
        _check(f"d={depth} split {side}", getattr(split, side), want[side])
    _check(f"d={depth} corner top", corners.top, want["corner_top"])
    _check(f"d={depth} corner bottom", corners.bottom, want["corner_bottom"])
    _check(f"d={depth} corner left", corners.left, want["left"])
    _check(f"d={depth} corner right", corners.right, want["right"])


def _init_gloo(rank, world, port):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=timedelta(seconds=60),
    )


def run(rank, world, port, shape, grid, halo_grid, iterations, depth,
        results):
    """Initialise gloo, check the halos of ``halo_grid``, run the stencil
    tiers on ``grid``, report."""
    try:
        import torch.distributed as dist

        import smi_tpu_torch as st

        _init_gloo(rank, world, port)
        try:
            comm = st.make_communicator(shape=shape, axis_names=("sx", "sy"),
                                        device="cpu")
            gh, gw = grid.shape
            probe = st.block_from_numpy(halo_grid, comm)
            for d in (1, 2, depth):
                _check_halos(comm, halo_grid, probe, d)
            # ring=True wraps: rank (r, c) receives (r-1 mod px, c)'s block
            px, py = comm.axis_sizes
            rx, cy = comm.coords
            h, w = probe.shape
            src = ((rx - 1) % px) * h, cy * w
            _check("ring shift", st.shift_along(probe, comm, "sx", +1,
                                                ring=True),
                   halo_grid[src[0]:src[0] + h, src[1]:src[1] + w])

            block = st.block_from_numpy(grid, comm)
            out = {}
            tiers = {
                "plain": st.make_stencil_fn(comm, iterations),
                "overlapped": st.make_stencil_fn(comm, iterations,
                                                 overlap=True),
                "fused": st.make_fused_stencil_fn(comm, iterations, gh, gw),
                "temporal": st.make_temporal_stencil_fn(
                    comm, iterations, gh, gw, depth=depth),
            }
            for name, fn in tiers.items():
                out[name] = st.grid_to_numpy(fn(block), comm)
            out["run_stencil"] = st.run_stencil(
                grid, iterations, comm=comm).numpy()
            if rank == 0:
                results.put((rank, "ok", out))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        if rank != 0:
            results.put((rank, "ok", None))
    except BaseException:  # report every failure to the parent, then exit
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_pipeline(rank, world, port, shape, grid, iterations, depth,
                 results):
    """Initialise gloo, run the pipeline tier on ``grid`` in both compute
    dtypes (the halos refreshed into each rank's extended border), and
    report the gathered grids from rank 0."""
    try:
        import torch.distributed as dist

        import smi_tpu_torch as st

        _init_gloo(rank, world, port)
        try:
            comm = st.make_communicator(shape=shape, axis_names=("sx", "sy"),
                                        device="cpu")
            gh, gw = grid.shape
            block = st.block_from_numpy(grid, comm)
            out = {
                cd: st.grid_to_numpy(st.make_pipeline_stencil_fn(
                    comm, iterations, gh, gw, depth=depth,
                    compute_dtype=cd)(block), comm)
                for cd in ("float32", "bfloat16")
            }
            results.put((rank, "ok", out if rank == 0 else None))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:  # report every failure to the parent, then exit
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_attention(rank, world, port, q, k, v, window, w, results):
    """Initialise gloo, run both ring-attention tiers on a ``world``-rank
    ``sp`` ring over the global float32 ``(S, H, D)`` q/k/v, check
    ``ring_shift`` by 1, -1 and 2, report this rank's output shards and
    its gradients of ``sum(out * w)``."""
    try:
        import torch.distributed as dist

        import smi_tpu_torch as st

        _init_gloo(rank, world, port)
        try:
            comm = st.make_communicator(shape=(world,), axis_names=("sp",),
                                        device="cpu")
            qs, ks, vs = (st.sequence_shard_from_numpy(x, comm)
                          for x in (q, k, v))
            s_local = qs.shape[0]
            for offset in (1, -1, 2):
                src = (rank - offset) % world
                _check(f"ring_shift offset {offset}",
                       st.ring_shift(ks, comm, offset=offset),
                       k[src * s_local:(src + 1) * s_local])
            ws = st.sequence_shard_from_numpy(w, comm)
            out = {}
            for name, use_flash in (("flash", True), ("plain", False)):
                fn = st.make_ring_attention_fn(comm, causal=True,
                                               window=window,
                                               use_flash=use_flash)
                leaves = [x.clone().requires_grad_() for x in (qs, ks, vs)]
                shard = fn(*leaves)
                (shard * ws).sum().backward()
                out[name] = shard.detach().numpy()
                out[f"{name} gathered"] = st.sequence_to_numpy(shard, comm)
                out[f"{name} grads"] = [t.grad.numpy() for t in leaves]
            results.put((rank, "ok", out))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:  # report every failure to the parent, then exit
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_train_step(rank, world, port, shape, config, params, x, y, lr,
                   results):
    """Initialise gloo, take one train step on a ``shape`` (dp, sp) grid
    with the flash tier (its kernels' plain versions on CPU tensors) from
    the float32 ``params`` on the global ``(B, S, E)`` data, report the
    loss, this rank's summed gradients and its updated parameters."""
    try:
        import torch.distributed as dist

        import smi_tpu_torch as st

        _init_gloo(rank, world, port)
        try:
            comm = st.make_communicator(shape=shape,
                                        axis_names=("dp", "sp"),
                                        device="cpu")
            model = st.params_from_numpy(params, config, device="cpu")
            step = st.make_train_step(comm, config, lr=lr, use_flash=True)
            loss = step(model, st.data_shard_from_numpy(x, comm),
                        st.data_shard_from_numpy(y, comm))
            results.put((rank, "ok", {
                "loss": float(loss),
                "grads": {n: p.grad.numpy()
                          for n, p in model.weights().items()},
                "params": st.params_to_numpy(model),
            }))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:  # report every failure to the parent, then exit
        results.put((rank, "error", traceback.format_exc()))
        raise


def collective_suite(comm, x):
    """The rooted collectives and a channel on the ``"xla"`` tier, on
    this rank's ``(8, 3)`` float32 ``x``: ``{name: tensor}``. Runs on any
    communicator of four ranks (a gloo group here, a ``LocalWorld`` in
    the test that holds the two against each other)."""
    import torch

    import smi_tpu_torch as st

    ctx = st.SmiContext(comm)
    ch = ctx.open_channel(port=0, src=0, dst=3, count=8, dtype="float")
    ch_s = ctx.open_channel(port=1, src=1, dst=2, count=8, dtype="float",
                            buffer_size=1)
    flat = x[:, 0].contiguous()
    streamed, total = ctx.stream(ch_s, flat,
                                 consumer=lambda c, chunk: c + chunk.sum(),
                                 init_carry=torch.zeros(()))
    return {
        "bcast": ctx.bcast(x, root=2),
        "reduce add": ctx.reduce(x, op="add", root=1),
        "reduce max": ctx.reduce(x, op="max", root=3, chunks=2),
        "allreduce": ctx.allreduce(x),
        "scatter": ctx.scatter(x, root=0),
        "gather": ctx.gather(x, root=3),
        "gather chunked": ctx.gather(x, all_ranks=True, chunks=3),
        "transfer": ctx.transfer(ch, flat),
        "stream": streamed,
        "stream total": total,
        "ring_shift": ctx.ring_shift(x, offset=1),
    }


def run_collectives(rank, world, port, x, results):
    """Initialise gloo, run :func:`collective_suite` on this rank's row
    of ``x``, report the results as numpy arrays."""
    try:
        import torch
        import torch.distributed as dist

        import smi_tpu_torch as st

        _init_gloo(rank, world, port)
        try:
            comm = st.make_communicator(world, device="cpu")
            out = collective_suite(comm, torch.from_numpy(x[rank]))
            results.put((rank, "ok", {k: v.numpy() for k, v in out.items()}))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:  # report every failure to the parent, then exit
        results.put((rank, "error", traceback.format_exc()))
        raise


def surface_suite(flat, hybrid, x):
    """The all-to-all family, the hybrid grid's collectives and the
    verified transfer on this rank's ``(16, 3)`` float32 ``x``: ``{name:
    tensor}``. ``flat`` is a 1-D communicator of four ranks, ``hybrid``
    the ``(2, 2)`` grid ``("dcn", "ici")`` over the same ranks (gloo
    groups here, ``LocalWorld`` ranks in the test that holds the two
    against each other)."""
    import torch

    import smi_tpu_torch as st

    xi = (x * 100).to(torch.int32)
    ch = st.P2PChannel(flat, port=3, src=1, dst=3, count=16,
                       buffer_size=5)
    received, check = ch.transfer_verified(x[:, 0].contiguous())
    ch.verify_frames(check)
    return {
        "pairwise": st.all_to_all(x, flat, algorithm="pairwise"),
        "bruck": st.all_to_all(x, flat, algorithm="bruck"),
        "bruck int": st.all_to_all(xi, flat, algorithm="bruck"),
        "hierarchical": st.all_to_all(x, hybrid, algorithm="hierarchical"),
        "hierarchical bf16": st.all_to_all(x.to(torch.bfloat16), hybrid,
                                           algorithm="hierarchical"),
        "allreduce rs_ag": st.allreduce(xi, flat, rs_ag=True),
        "allreduce hierarchical": st.allreduce(xi, hybrid,
                                               hierarchical=True),
        "allreduce hierarchical max": st.allreduce(x, hybrid, op="max",
                                                   hierarchical=True),
        "bcast hierarchical": st.bcast(x, hybrid, root=2,
                                       hierarchical=True),
        "reduce hierarchical": st.reduce(xi, hybrid, root=1,
                                         hierarchical=True),
        "verified received": received,
        "verified expected": check.expected,
        "verified got": check.got,
    }


def run_surface(rank, world, port, x, results):
    """Initialise gloo, build the flat and the hybrid communicator, run
    :func:`surface_suite` on this rank's row of ``x``, report the results
    as numpy arrays (bf16 widened to f32)."""
    try:
        import torch
        import torch.distributed as dist

        import smi_tpu_torch as st

        _init_gloo(rank, world, port)
        try:
            flat = st.make_communicator(world, device="cpu")
            hybrid = st.make_hybrid_communicator(n_slices=2, device="cpu")
            out = surface_suite(flat, hybrid, torch.from_numpy(x[rank]))
            results.put((rank, "ok", {
                k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in out.items()}))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:  # report every failure to the parent, then exit
        results.put((rank, "error", traceback.format_exc()))
        raise


def shrink_suite(comm, x):
    """The collectives of a shrunk communicator on this rank's ``(12,)``
    float32 ``x``: ``{name: tensor}`` — the all-reduce, a ring shift and
    a channel transfer (point-to-point, peers by process rank), a bcast,
    a reduce and an all-to-all."""
    import smi_tpu_torch as st

    ch = st.P2PChannel(comm, port=0, src=2, dst=0, count=x.shape[0])
    return {
        "allreduce": st.allreduce(x, comm),
        "allreduce max": st.allreduce(x, comm, op="max"),
        "ring shift": st.ring_shift(x, comm),
        "transfer": ch.transfer(x),
        "bcast": st.bcast(x, comm, root=1),
        "reduce": st.reduce(x, comm, root=2),
        "all_to_all": st.all_to_all(x, comm),
    }


def run_shrink(rank, world, port, x, dropped, results):
    """Initialise gloo and a ``world``-rank communicator; rank
    ``dropped`` then drops out and takes no further part, while the
    survivors shrink it away (twice: the second call must give the same
    groups) and run :func:`shrink_suite` on this rank's row of ``x``.
    Reports the shrunk rank, size, epoch and process ranks beside the
    results."""
    try:
        import torch
        import torch.distributed as dist

        import smi_tpu_torch as st

        _init_gloo(rank, world, port)
        comm = st.make_communicator(world, device="cpu")
        if rank == dropped:
            results.put((rank, "ok", None))
            return
        try:
            shrunk = comm.shrink({dropped})
            again = comm.shrink({dropped})
            out = {k: v.numpy() for k, v in shrink_suite(
                shrunk, torch.from_numpy(x[rank])).items()}
            out["membership"] = (shrunk.rank, shrunk.size, shrunk.epoch,
                                 shrunk.process_ranks,
                                 again.groups is shrunk.groups)
            results.put((rank, "ok", out))
            dist.barrier(group=shrunk.groups[None])
        finally:
            dist.destroy_process_group()
    except BaseException:  # report every failure to the parent, then exit
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_host_module(rank, world, port, build_dir, results):
    """Initialise gloo and bootstrap this rank through the generated host
    module in ``build_dir`` (``SmiInit_app`` over ``build_dir/smi-routes``);
    report the communicator's rank and size, the program's port count and
    the sum over the group of ``rank + 1``."""
    try:
        import importlib.util
        import os

        import torch
        import torch.distributed as dist

        import smi_tpu_torch as st

        _init_gloo(rank, world, port)
        try:
            spec = importlib.util.spec_from_file_location(
                "smi_generated_host",
                os.path.join(build_dir, "smi_generated_host.py"))
            host = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(host)
            comm, prog = host.SmiInit_app(
                rank=rank, ranks=world,
                routing_dir=os.path.join(build_dir, "smi-routes"),
                device="cpu")
            got = st.allreduce(torch.tensor([float(rank + 1)]), comm)
            results.put((rank, "ok", {
                "rank": comm.rank, "size": comm.size,
                "ports": prog.logical_port_count, "sum": float(got[0])}))
        finally:
            dist.destroy_process_group()
    except BaseException:  # report every failure to the parent, then exit
        results.put((rank, "error", traceback.format_exc()))
        raise
