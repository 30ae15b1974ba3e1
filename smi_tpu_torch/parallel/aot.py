"""Ahead-of-card verification: prove the multi-chip surface builds and fits.

PyTorch counterpart of :mod:`smi_tpu.parallel.aot`. The JAX module
compiles the multi-chip surface against abstract TPU topologies through
Mosaic and the SPMD partitioner, so toolchain rejections surface before
anyone owns a pod (reference: ``aoc`` builds emulator-tested kernels to
bitstreams with no FPGA attached, ``CMakeLists.txt:159-196``). The
port's kernels are CUDA C++ built by ``nvcc``, and what the card can
refuse is a launch: too much shared memory, too many registers, or a
cooperative grid larger than the blocks it holds at once. So here:

1. :func:`build_sources` builds every source of
   :data:`~smi_tpu_torch.kernels._build.SOURCES` for ``sm_90a`` (nvcc,
   no card) and :func:`kernel_resources` reads each kernel instance's
   registers, spills and static shared memory from the ``-Xptxas -v``
   log;
2. :func:`surface_cases` names, for every case of the JAX surface
   (``smi_tpu/parallel/aot.py:1002`` ``surface_cases``, ``:1015``
   ``hybrid_cases``) at the same extents (a topology name is read as its
   rank count: ``v5e:2x4`` is 8 ranks on the ``(2, 4)`` grid, ``v5e:4x4``
   16, ``v5e:2x4*2`` two slices of 8), the launches the port makes for
   it. Ring-tier cases are run once on a CPU
   :class:`~smi_tpu_torch.parallel.local.LocalWorld` at their shapes and
   every ring call is recorded; the flash and stencil cases, too large
   to run here, are planned by the kernels' own pure plan functions
   (``flash._plan``/``_bwd_plan``, ``stencil_temporal._plan``,
   ``stencil_pipeline._plan``, ``roll.plan``, ``ring.launch_plan``);
3. :func:`check_surface` holds each launch to the card's limits: 227 KB
   of shared memory a block, 64 K registers an SM (255 a thread), 1024
   threads a block, at least one resident block, and for the ring
   tier's cooperative grid no more blocks than are resident at once
   (computed from the ptxas figures; on a card the runtime's own count,
   :func:`runtime_blocks_per_sm`, must agree).

Cases the JAX surface runs on XLA collectives (the ``xla_*`` comparison
column, the hierarchical allreduce, GESUMMV and K-means) run on the
port's default tier, which launches no hand-written kernel: their
reports say so with an empty launch list. No v5e figure (VMEM, ICI
rate) appears here. ``python -m smi_tpu_torch aot-verify`` drives it.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import re
from typing import Callable, Dict, List, Optional, Tuple

#: the JAX module's default topology name; read here as 8 ranks on (2, 4)
DEFAULT_TOPOLOGY = "v5e:2x4"

#: dynamic + static shared memory one H100 block may use (227 KB)
SMEM_BYTES_LIMIT = 232_448
#: shared memory of an SM, and what the runtime reserves a block
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_SMEM = 1024
#: registers of an SM (four partitions of 16 K) and of one thread
SM_REGISTERS = 65_536
PARTITION_REGISTERS = 16_384
MAX_THREAD_REGISTERS = 255
MAX_BLOCK_THREADS = 1024
MAX_SM_WARPS = 64
MAX_SM_BLOCKS = 32
#: SMs of the H100 SXM; a card's own count is asked where there is one
H100_SMS = 132


class NvccNotFound(RuntimeError):
    """No ``nvcc``: the CUDA sources cannot be built, so nothing is
    verified (never a silent pass)."""


class LaunchDoesNotFit(RuntimeError):
    """A planned launch exceeds a limit of the card."""


# ---------------------------------------------------------------------------
# Topology names
# ---------------------------------------------------------------------------


def parse_topology(topology: str):
    """``"v5e:2x4*2"`` -> ``("v5e:2x4", {"num_slices": 2})``."""
    if "*" in topology:
        name, s = topology.split("*", 1)
        return name, {"num_slices": int(s)}
    return topology, {}


def topology_ranks(topology: str) -> int:
    """Ranks of a topology name: the product of its extents times its
    slices (``v5e:2x4`` 8, ``v5e:4x4`` 16, ``v5e:2x4*2`` 16)."""
    name, kwargs = parse_topology(topology)
    m = re.fullmatch(r"[\w-]+:(\d+(?:x\d+)*)", name)
    if m is None:
        raise ValueError(
            f"topology {topology!r} is not <kind>:<A>x<B>[*slices] "
            f"(e.g. v5e:2x4)"
        )
    n = math.prod(int(e) for e in m.group(1).split("x"))
    return n * kwargs.get("num_slices", 1)


def is_multislice(topology: str) -> bool:
    return parse_topology(topology)[1].get("num_slices", 1) > 1


def slice_partition(topology: str) -> Dict[int, int]:
    """``{rank: slice}``: ranks split evenly into the topology's slices
    in rank order (the hybrid world's ``("dcn", "ici")`` layout)."""
    n = topology_ranks(topology)
    slices = parse_topology(topology)[1].get("num_slices", 1)
    per = n // slices
    return {r: r // per for r in range(n)}


def grid2d(n: int):
    """Near-square 2-D factorization of a power-of-two extent:
    8 -> (2, 4), 16 -> (4, 4), 32 -> (4, 8)."""
    px = 1
    while px * px * 4 <= n:
        px *= 2
    if n % px:
        raise ValueError(f"cannot factor {n} devices into a 2-D grid")
    return px, n // px


# ---------------------------------------------------------------------------
# The build and its ptxas figures
# ---------------------------------------------------------------------------


def build_sources(names=None) -> Dict[str, float]:
    """Build every named source (default: all) for ``sm_90a`` without
    loading it; raises :class:`NvccNotFound` without ``nvcc``. Returns
    the wall seconds each new build waited for."""
    from smi_tpu_torch.kernels import _build

    try:
        _build.find_nvcc()
    except RuntimeError as e:
        raise NvccNotFound(str(e)) from e
    return _build.build_kernels(names, load=False)


#: a kernel instance's mangled name -> the kernel (``_build.LAUNCHES``
#: names) it serves, and its template parameters
_INSTANCE_PATTERNS = (
    (re.compile(r"neighbour_stream_kernel"), "ring_neighbour_stream"),
    (re.compile(r"all_gather_kernel"), "ring_all_gather"),
    (re.compile(r"reduce_kernelI(?P<t>[a-z]|13__nv_bfloat16)"
                r"Li(?P<op>\d)ELb(?P<rs>[01])E"), "ring_reduce"),
    (re.compile(r"flash_(?P<dt>bf16|f32)_kernelILi(?P<d>\d+)"
                r"ELb(?P<carried>[01])E"), "flash_fwd"),
    (re.compile(r"flash_(?P<which>dq|dkdv)_(?P<dt>bf16|f32)_kernelILi"
                r"(?P<d>\d+)E"), "flash_bwd"),
    (re.compile(r"temporal_kernelILi(?P<k>\d+)E"), "stencil_temporal"),
    (re.compile(r"pipeline_kernelILi(?P<k>\d+)ELb(?P<bf16>[01])E"),
     "stencil_pipeline"),
    (re.compile(r"sweep_kernel"), "stencil_sweep"),
    (re.compile(r"roll_chain_kernelILb(?P<rotate>[01])ELi(?P<regs>\d+)E"),
     "roll_chain"),
)

#: mangled element types of the ring's reduce instances
_RING_TYPE = {"i": "int32", "f": "float32", "d": "float64", "a": "int8",
              "s": "int16", "13__nv_bfloat16": "bfloat16"}


def instance_kernel(mangled: str) -> Optional[Tuple[str, dict]]:
    """``(kernel, params)`` of one ``__global__`` instance, or None.
    ``kernel`` is a ``_build.LAUNCHES`` name (``ring_reduce`` stands for
    the all-reduce, its chunked form and the reduce-scatter)."""
    for pattern, kernel in _INSTANCE_PATTERNS:
        m = pattern.search(mangled)
        if m is None:
            continue
        params = m.groupdict()
        if kernel == "ring_reduce":
            params["t"] = _RING_TYPE[params["t"]]
        if kernel == "flash_fwd":
            kernel = ("flash_block" if params.pop("carried") == "1"
                      else "flash_fused")
        if kernel == "flash_bwd":
            kernel = f"flash_bwd_{params.pop('which')}"
        return kernel, params
    return None


def kernel_resources(log_text: str) -> Dict[str, dict]:
    """Each ``__global__`` instance's figures from an ``-Xptxas -v`` log:
    ``{mangled: {"registers", "smem" (static bytes), "spill" (stores,
    loads), "stack"}}``. Non-entry functions (their own stack frames)
    are left out."""
    info: Dict[str, dict] = {}
    current = None
    for line in log_text.splitlines():
        m = re.search(r"(?:entry function|Function properties for)\s+'?"
                      r"([\w$]+)'?", line)
        if m:
            current = m.group(1)
            info.setdefault(current, {})
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if spill:
            info[current]["stack"] = int(spill.group(1))
            info[current]["spill"] = (int(spill.group(2)),
                                      int(spill.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            info[current]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            info[current]["smem"] = int(smem.group(1)) if smem else 0
    return {k: v for k, v in info.items() if "registers" in v}


def source_resources(names=None) -> Dict[str, Dict[str, dict]]:
    """:func:`kernel_resources` of each built source's log."""
    from smi_tpu_torch.kernels import _build

    names = list(_build.SOURCES) if names is None else list(names)
    return {n: kernel_resources(_build.build_log(n)) for n in names}


# ---------------------------------------------------------------------------
# Occupancy
# ---------------------------------------------------------------------------


def warp_registers(registers: int) -> int:
    """Registers a warp is allocated: 32 threads' worth, in units of
    256."""
    return -(-registers * 32 // 256) * 256


def blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads using ``registers`` a thread and
    ``smem`` bytes of shared memory (static and dynamic) that one H100
    SM holds at once: a warp's registers come from one partition of
    16 K, shared memory is the SM's less 1 KB reserved a block, and an
    SM holds at most 64 warps and 32 blocks."""
    warps = -(-threads // 32)
    by_regs = 4 * (PARTITION_REGISTERS // warp_registers(max(1, registers)))
    by_regs //= warps
    by_smem = SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM)
    return max(0, min(by_regs, by_smem, MAX_SM_WARPS // warps,
                      MAX_SM_BLOCKS))


#: the C entry's kernel codes of :func:`runtime_blocks_per_sm`
_RING_CODES = {"ring_neighbour_stream": 0, "ring_all_gather": 1,
               "ring_all_reduce": 2, "ring_all_reduce_chunked": 2,
               "ring_reduce_scatter": 3}


def runtime_blocks_per_sm(kernel: str, dtype: str = "float32",
                          op: int = 0) -> int:
    """The runtime's count of ``kernel``'s blocks an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, asked of the card
    through ``ring.cu``); needs a card."""
    import torch

    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring

    codes = {str(t).replace("torch.", ""): c
             for t, c in kring.DTYPE_CODES.items()}
    fn = _build.library("ring").smi_ring_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.cuda.current_device()):
        status = fn(_RING_CODES[kernel], codes[dtype], op,
                    ctypes.byref(out))
    _build.check(f"{kernel} occupancy", status)
    return out.value


# ---------------------------------------------------------------------------
# The surface's launches
# ---------------------------------------------------------------------------

_F32 = 4


def _ring_launch(kernel: str, dtype: str, unit_bytes: int, ranks: int,
                 chunks: int = 1, op: int = 0) -> dict:
    from smi_tpu_torch.kernels import ring as kring

    slice_bytes = (kring.STREAM_SLICE_BYTES
                   if kernel == "ring_neighbour_stream" else kring.SLICE_BYTES)
    per_chunk, per_rank = kring.launch_plan(unit_bytes, ranks, chunks,
                                            slice_bytes)
    return {"kernel": kernel, "dtype": dtype, "op": op, "chunks": chunks,
            "unit_bytes": unit_bytes, "ranks": ranks, "threads": 256,
            "blocks": per_rank * ranks, "dynamic_smem": 0,
            "cooperative": True}


_REDUCE_KERNELS = ("ring_all_reduce", "ring_all_reduce_chunked",
                   "ring_reduce_scatter")


@contextlib.contextmanager
def _recording():
    """Record every ring-tier call made on rank 0 of a CPU world: the
    launch the card would make for it."""
    from smi_tpu_torch.kernels import ring as kring

    calls = []
    real = kring._run

    def run(kernel, x, comm, axis_name, stream, flow_control, params, plain,
            out_shape, unit_elems, extra, chunks=1):
        if comm.rank == 0:
            # the reduce kernels' first own argument is the op's code
            op = extra[0] if kernel in _REDUCE_KERNELS else 0
            calls.append((kernel, str(x.dtype).replace("torch.", ""),
                          unit_elems * x.element_size(),
                          comm.world.size, chunks, int(op)))
        return real(kernel, x, comm, axis_name, stream, flow_control,
                    params, plain, out_shape, unit_elems, extra, chunks)

    kring._run = run
    try:
        yield calls
    finally:
        kring._run = real


def _recorded(shape, axis_names, body) -> Callable[[], List[dict]]:
    """A case run once on a CPU world of ``shape``: the distinct ring
    launches it made, in order."""
    def plan():
        import torch

        from smi_tpu_torch.parallel.local import LocalWorld

        world = LocalWorld(shape, axis_names, device="cpu")
        gen = torch.Generator().manual_seed(0)
        with _recording() as calls:
            world.run(lambda c: body(c, gen))
        seen, out = set(), []
        for kernel, dtype, unit, ranks, chunks, op in calls:
            key = (kernel, dtype, unit, ranks, chunks, op)
            if key not in seen:
                seen.add(key)
                out.append(_ring_launch(kernel, dtype, unit, ranks, chunks,
                                        op))
        return out
    return plan


def _ones(c, shape, dtype="float32"):
    import torch

    return torch.ones(shape, dtype=getattr(torch, dtype)) * (c.rank + 1)


def _ring_cases(topology: str):
    """The four ring kernels x flow control, at the JAX cases' payloads
    (chunk 16, width 256)."""
    from smi_tpu_torch.kernels import ring as kring

    n = topology_ranks(topology)
    chunk, width = 16, 256
    for fc in (True, False):
        tag = "fc" if fc else "nofc"
        yield f"ring_all_gather_{tag}", _recorded(
            n, None, lambda c, g, fc=fc: kring.ring_all_gather(
                _ones(c, (chunk, width)), c, flow_control=fc))
        yield f"ring_all_reduce_{tag}", _recorded(
            n, None, lambda c, g, fc=fc: kring.ring_all_reduce(
                _ones(c, (width,)), c, flow_control=fc, chunks=1))
        yield f"ring_reduce_scatter_{tag}", _recorded(
            n, None, lambda c, g, fc=fc: kring.ring_reduce_scatter(
                _ones(c, (n * chunk, width)), c, flow_control=fc))
        yield f"neighbour_stream_{tag}", _recorded(
            n, None, lambda c, g, fc=fc: kring.neighbour_stream(
                _ones(c, (4, 8, width)), c, flow_control=fc))


def _ring_dtype_cases(topology: str):
    """The ring kernels at the non-f32 payload dtypes of the JAX
    surface (``_ring_dtype_cases``)."""
    from smi_tpu_torch.kernels import ring as kring

    n = topology_ranks(topology)
    yield "ring_all_reduce_bf16", _recorded(
        n, None, lambda c, g: kring.ring_all_reduce(
            _ones(c, (256,), "bfloat16"), c, chunks=1))
    yield "ring_all_gather_int32", _recorded(
        n, None, lambda c, g: kring.ring_all_gather(
            _ones(c, (16, 256), "int32"), c))
    yield "neighbour_stream_bf16", _recorded(
        n, None, lambda c, g: kring.neighbour_stream(
            _ones(c, (4, 8, 256), "bfloat16"), c))
    yield "neighbour_stream_int8", _recorded(
        n, None, lambda c, g: kring.neighbour_stream(
            _ones(c, (4, 8, 256), "int8"), c))
    yield "ring_all_reduce_int16", _recorded(
        n, None, lambda c, g: kring.ring_all_reduce(
            _ones(c, (256,), "int16"), c, chunks=1))


def _subset_ring_cases(topology: str):
    """A ring over one axis of the 2-D world, and one over both."""
    from smi_tpu_torch.kernels import ring as kring

    shape = grid2d(topology_ranks(topology))
    yield "ring_all_reduce_subset_axis", _recorded(
        shape, ("mx", "my"), lambda c, g: kring.ring_all_reduce(
            _ones(c, (256,)), c, "my", chunks=1))
    yield "ring_all_gather_two_axis", _recorded(
        shape, ("mx", "my"), lambda c, g: kring.ring_all_gather(
            _ones(c, (16, 256)), c))


def _flash_launches(heads: int, kv_heads: int, s: int, d: int,
                    dtype: str) -> List[dict]:
    """The forward and backward flash launches of one ring fold on
    ``s`` local tokens (every fold of the ring has this shape)."""
    import torch

    from smi_tpu_torch.kernels import flash as kflash

    dt = getattr(torch, dtype)
    threads = 384 if dt == torch.bfloat16 else 256
    plan = kflash._plan(d, dt)
    if plan is None:
        raise LaunchDoesNotFit(f"flash forward has no plan for head dim {d} "
                               f"{dtype}")
    out = []
    blocks = -(-s // plan[0]) * heads
    for kernel in (kflash.KERNEL_FUSED, kflash.KERNEL_BLOCK):
        out.append({"kernel": kernel, "dtype": dtype, "d": d,
                    "threads": threads, "blocks": blocks,
                    "dynamic_smem": kflash.smem_bytes(d, dt),
                    "cooperative": False})
    for kernel in (kflash.KERNEL_BWD_DQ, kflash.KERNEL_BWD_DKDV):
        bplan = kflash._bwd_plan(kernel, d, dt, s_k=s, h_kv=kv_heads)
        if bplan is None:
            raise LaunchDoesNotFit(f"{kernel} has no plan for head dim {d} "
                                   f"{dtype}")
        split = (kernel == kflash.KERNEL_BWD_DKDV
                 and bplan != kflash._bwd_tiles(kernel, d, dt))
        out.append({"kernel": kernel, "dtype": dtype, "d": d,
                    "threads": threads,
                    "blocks": kflash.bwd_blocks(kernel, bplan, heads,
                                                kv_heads, s, s, d),
                    "dynamic_smem": kflash.bwd_smem_bytes(kernel, d, dt,
                                                          split),
                    "cooperative": False})
    return out


def _transformer_cases(topology: str):
    """The flash (dp, sp) train steps at the JAX cases' configs: causal
    MHA bf16 at 4096 tokens a rank, windowed GQA at 8192, and the
    1M-token sequence-parallel rung."""
    dp, sp = grid2d(topology_ranks(topology))
    yield "train_step_mha_bf16", lambda: _flash_launches(
        4, 4, 4096, 128, "bfloat16")
    yield "train_step_gqa_window_bf16", lambda: _flash_launches(
        8, 1, 8192, 128, "bfloat16")
    yield "train_step_1m_sp", lambda: _flash_launches(
        8, 1, 1048576 // sp, 128, "bfloat16")


def _no_kernel(name: str):
    """A case whose port runs on the default tier: no hand kernel."""
    return name, lambda: []


def _hierarchical_case(topology: str):
    yield _no_kernel("allreduce_hierarchical")
    yield _no_kernel("allreduce_flat")


def _xla_tier_cases(topology: str):
    for name in ("xla_all_gather", "xla_all_reduce", "xla_reduce_scatter",
                 "xla_neighbour_shift"):
        yield _no_kernel(name)


def _composite_ring_cases(topology: str):
    """Several ring kernel instances in one program: the 4-direction
    halo (with and without corners), two concurrent streams, a multi-hop
    P2P transfer, the rooted reduce and gather."""
    from smi_tpu_torch.parallel import collectives
    from smi_tpu_torch.parallel.channels import P2PChannel, stream_concurrent
    from smi_tpu_torch.parallel.halo import (
        halo_exchange_2d,
        halo_exchange_2d_corners,
    )

    n = topology_ranks(topology)
    px, py = grid2d(n)
    block = (512 // px, 1024 // py)
    yield "halo_ring_4dir", _recorded(
        (px, py), ("sx", "sy"), lambda c, g: halo_exchange_2d(
            _ones(c, block), c, depth=1, backend="ring"))
    yield "halo_ring_corners", _recorded(
        (px, py), ("sx", "sy"), lambda c, g: halo_exchange_2d_corners(
            _ones(c, block), c, depth=1, backend="ring"))

    def concurrent(c, g):
        chans = [P2PChannel(comm=c, port=0, src=0, dst=2, count=1024,
                            buffer_size=256, consecutive_reads=2),
                 P2PChannel(comm=c, port=1, src=1, dst=3, count=1024,
                            buffer_size=256, consecutive_reads=2)]
        x = _ones(c, (1024,))
        return stream_concurrent(chans, (x, x), backend="ring")

    yield "stream_concurrent_ring", _recorded(n, None, concurrent)
    yield "p2p_transfer_ring_multihop", _recorded(
        n, None, lambda c, g: P2PChannel(
            comm=c, port=2, src=0, dst=3, count=2048, buffer_size=512,
        ).transfer(_ones(c, (2048,)), backend="ring"))
    yield "reduce_ring_rooted", _recorded(
        n, None, lambda c, g: collectives.reduce(
            _ones(c, (256,)), c, op="max", root=3, port=0, backend="ring",
            chunks=1))
    yield "gather_ring_rooted", _recorded(
        n, None, lambda c, g: collectives.gather(
            _ones(c, (16, 256)), c, root=5, port=1, backend="ring"))


def _sweep_launch(h: int, w: int) -> dict:
    return {"kernel": "stencil_sweep", "threads": 256,
            "blocks": -(-w // 32) * -(-h // 8), "dynamic_smem": 0,
            "cooperative": False}


def _app_cases(topology: str):
    """The reference applications at the JAX cases' shapes: the 8192²
    stencil on the process grid (plain, temporal and over the ring),
    GESUMMV and K-means (default tier)."""
    import torch

    from smi_tpu_torch.convert import block_from_numpy
    from smi_tpu_torch.kernels import stencil_temporal as kt
    from smi_tpu_torch.models import stencil

    px, py = grid2d(topology_ranks(topology))
    h, w = 8192 // px, 8192 // py
    yield f"app_stencil_8192_{px}x{py}", lambda: [_sweep_launch(h, w)]

    def temporal():
        depth = kt.pick_temporal_depth(h, w, torch.float32, 16) or 8
        stripe, band = kt._plan(h, w, depth)
        launches = [{"kernel": "stencil_temporal", "k": depth,
                     "threads": kt.threads(band, depth),
                     "blocks": -(-w // band) * -(-h // stripe),
                     "dynamic_smem": kt.window_bytes(band, depth),
                     "cooperative": False}]
        if 16 % depth:
            launches.append(_sweep_launch(h, w))
        return launches

    yield f"app_stencil_temporal_8192_{px}x{py}", temporal

    grid = stencil.initial_grid(1024, 2048)
    ring_plan = _recorded(
        (px, py), ("sx", "sy"), lambda c, g: stencil.make_stencil_fn(
            c, 2, backend="ring")(block_from_numpy(grid, c)))
    yield f"app_stencil_ring_{px}x{py}", lambda: (
        ring_plan() + [_sweep_launch(1024 // px, 2048 // py)])
    yield _no_kernel("app_gesummv_4096")
    yield _no_kernel("app_kmeans_512k")


def _port_cases(topology: str):
    """Launches of the port's kernels that the JAX surface has no case
    for: the stencil pipeline at the 8192² block of the process grid
    (f32 and bf16 compute) and the surface's roll-chain probe."""
    from smi_tpu_torch.kernels import roll
    from smi_tpu_torch.kernels import stencil_pipeline as kp
    from smi_tpu_torch.kernels import stencil_temporal as kt

    px, py = grid2d(topology_ranks(topology))
    h, w = 8192 // px, 8192 // py

    def pipeline():
        out = []
        for depth in (8, 16, 32):
            plan = kp._plan(h, w, depth)
            if plan is None:
                continue
            stripe, band = plan
            for bf16 in ("0", "1"):
                out.append({"kernel": "stencil_pipeline", "k": depth,
                            "bf16": bf16,
                            "threads": kt.threads(band, depth),
                            "blocks": None,
                            "dynamic_smem": kp.pipeline_smem_bytes(
                                stripe, band, depth),
                            "cooperative": False})
        return out

    yield f"port_stencil_pipeline_8192_{px}x{py}", pipeline

    def rolls():
        out = []
        for rows, cols in ((512, 2048), (4096, 8), (8, 4096)):
            for body in ("lane", "sublane", "add"):
                p = roll.plan(rows, cols, 2, body)
                out.append({"kernel": "roll_chain", "regs": str(p["regs"]),
                            "rotate": "0" if body == "add" else "1",
                            "threads": 32 * p["warps"],
                            "blocks": p["blocks"], "dynamic_smem": 0,
                            "cooperative": False})
        return out

    yield "port_roll_chain_surface", rolls


def surface_cases(topology: str = DEFAULT_TOPOLOGY):
    """All (name, plan) pairs of the multi-chip surface: each plan
    returns the case's launches."""
    yield from _ring_cases(topology)
    yield from _ring_dtype_cases(topology)
    yield from _subset_ring_cases(topology)
    yield from _transformer_cases(topology)
    yield from _hierarchical_case(topology)
    yield from _composite_ring_cases(topology)
    yield from _app_cases(topology)
    yield from _xla_tier_cases(topology)
    yield from _port_cases(topology)


def hybrid_cases(topology: str):
    """The case subset for a multi-slice topology (the JAX package's:
    the hierarchical allreduce against its flat comparison)."""
    yield from _hierarchical_case(topology)


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def _matches(launch: dict, kernel: str, params: dict) -> bool:
    """Whether an instance of ``kernel`` with ``params`` serves
    ``launch``."""
    want = launch["kernel"]
    if kernel == "ring_reduce":
        if want not in ("ring_all_reduce", "ring_all_reduce_chunked",
                        "ring_reduce_scatter"):
            return False
        return (params["rs"] == ("1" if want == "ring_reduce_scatter"
                                 else "0")
                and params["t"] == launch["dtype"]
                and int(params["op"]) == launch["op"])
    if kernel != want:
        return False
    if "dt" in params and params["dt"] != (
            "bf16" if launch["dtype"] == "bfloat16" else "f32"):
        return False
    for key in ("d", "k", "bf16", "regs", "rotate"):
        if key in params and key in launch and str(launch[key]) != params[key]:
            return False
    return True


def check_launch(launch: dict, resources: Dict[str, Dict[str, dict]],
                 sms: int = H100_SMS, runtime: bool = False) -> dict:
    """``launch`` with the figures of the instances that serve it (the
    largest where several do); raises :class:`LaunchDoesNotFit` naming
    the limit it breaks."""
    from smi_tpu_torch.kernels import _build

    source = _build.source_of(launch["kernel"])
    found = []
    for mangled, figs in resources.get(source, {}).items():
        named = instance_kernel(mangled)
        if named is not None and _matches(launch, *named):
            found.append((mangled, figs))
    if not found:
        raise LaunchDoesNotFit(
            f"{launch['kernel']}: no instance in {source}.cu's build log "
            f"serves {launch}"
        )
    regs = max(f["registers"] for _, f in found)
    static = max(f["smem"] for _, f in found)
    spill = max(sum(f.get("spill", (0, 0))) for _, f in found)
    smem = static + launch["dynamic_smem"]
    threads = launch["threads"]
    warps = -(-threads // 32)
    per_sm = blocks_per_sm(regs, threads, smem)
    out = dict(launch, source=f"{source}.cu",
               instances=sorted(m for m, _ in found), registers=regs,
               static_smem=static, spill_bytes=spill, smem=smem,
               block_registers=warps * warp_registers(regs),
               blocks_per_sm=per_sm)
    problems = []
    if smem > SMEM_BYTES_LIMIT:
        problems.append(f"{smem} B of shared memory > {SMEM_BYTES_LIMIT}")
    if regs > MAX_THREAD_REGISTERS:
        problems.append(f"{regs} registers a thread > {MAX_THREAD_REGISTERS}")
    if out["block_registers"] > SM_REGISTERS:
        problems.append(f"{out['block_registers']} registers a block > "
                        f"{SM_REGISTERS}")
    if threads > MAX_BLOCK_THREADS:
        problems.append(f"{threads} threads a block > {MAX_BLOCK_THREADS}")
    if per_sm < 1:
        problems.append("no block of it fits an SM")
    if launch["cooperative"]:
        out["resident_blocks"] = sms * per_sm
        if runtime:
            got = runtime_blocks_per_sm(launch["kernel"], launch["dtype"],
                                        launch["op"])
            out["runtime_blocks_per_sm"] = got
            if got != per_sm:
                problems.append(f"the runtime holds {got} blocks an SM, the "
                                f"ptxas figures say {per_sm}")
        if launch["blocks"] > out["resident_blocks"]:
            problems.append(f"cooperative grid of {launch['blocks']} blocks "
                            f"> {out['resident_blocks']} resident")
    if problems:
        raise LaunchDoesNotFit(f"{launch['kernel']}: " + "; ".join(problems))
    return out


def check_case(launches: List[dict], resources, sms: int = H100_SMS,
               runtime: bool = False) -> dict:
    """One case's report: its checked launches and their totals."""
    checked = [check_launch(l, resources, sms, runtime) for l in launches]
    return {
        "kernels": sorted({l["kernel"] for l in checked}),
        "launches": checked,
        "memory": {
            "smem_bytes_max": max((l["smem"] for l in checked), default=0),
            "registers_max": max((l["registers"] for l in checked),
                                 default=0),
        },
        "tier": "cuda" if checked else "default (no hand-written kernel)",
    }


def cases_for(topology: str):
    """The case generator for ``topology``: :func:`hybrid_cases` for a
    multi-slice one, else :func:`surface_cases`."""
    return hybrid_cases if is_multislice(topology) else surface_cases


def check_surface(
    topology: str = DEFAULT_TOPOLOGY,
    verbose: bool = False,
    cases=None,
    runtime: Optional[bool] = None,
) -> Dict[str, dict]:
    """Build every source and check every launch of the surface for a
    topology; return ``{case: report}``. Raises :class:`NvccNotFound`
    without ``nvcc`` and :class:`LaunchDoesNotFit` on the first launch
    that breaks a limit. ``runtime`` (default: whether a card is there)
    also asks the card how many of each ring kernel's blocks an SM
    holds and requires the ptxas-derived count to agree."""
    import torch

    cases = cases_for(topology) if cases is None else cases
    sms = H100_SMS
    if torch.cuda.is_available():
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    if runtime is None:
        runtime = torch.cuda.is_available()
    build_sources()
    resources = source_resources()
    reports = {}
    for name, plan in cases(topology):
        if verbose:
            print(f"  aot-check {name} ...", flush=True)
        reports[name] = check_case(plan(), resources, sms, runtime)
    return reports
