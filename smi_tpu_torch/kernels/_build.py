"""Build, load and launch the package's CUDA kernels; the card they run on.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
libraries go to ``build/torch_kernels/`` beside the package, keyed by a
hash of the source, the ``csrc/*.cuh`` headers it includes and the flags,
so a changed source or header builds anew and an unchanged one loads at
once. All sources compile at the same time, one
``nvcc`` each. A source may export several kernels (``flash_fwd.cu``
exports the fused and the carried flash forward); each kernel has its
own launch count (``flash_bwd.cu`` exports the two backward kernels,
``ring.cu`` the five ring kernels, ``roll_chain.cu`` the surface's
roll-chain probe, ``attn_glue.cu`` the afmoe attention glue's two
forward and two backward kernels, ``residual_norm.cu`` the afmoe
residual junction's forward and backward).

Nothing here runs on import: the first :func:`library` call builds. A
missing ``nvcc`` raises; there is no fallback to the plain versions.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when it is not 0 — a launch the driver refused (too
much shared memory, a bad grid) never runs and no later synchronise
would report it. Every wrapper launches through :func:`launch`, which
checks and then counts.

The H100's limits (:data:`SMS`, :data:`SMEM_BYTES_LIMIT`, ...) and the
one occupancy model (:func:`blocks_per_sm`) live here too: the plans
and the ahead-of-card check read them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory, spills: in the log
)

#: sources whose bar is a tolerance, not bit identity: built with FMA
#: contraction (the stencil sources keep ``-fmad=false``)
FMA_SOURCES = frozenset({"flash_fwd", "flash_bwd"})

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(kernel: str) -> None:
    """Add one to ``kernel``'s launch count; wrappers call it right after
    a launch that CUDA accepted (threads may launch at once)."""
    with _count_lock:
        LAUNCHES[kernel] += 1


def find_nvcc() -> str:
    """The ``nvcc`` to build with; raises when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under $CUDA_HOME/bin or "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built"
        )
    return nvcc


def nvcc_flags(name: str) -> tuple:
    """The flags ``csrc/<name>.cu`` builds with."""
    if name in FMA_SOURCES:
        return tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
    return NVCC_FLAGS


def nvcc_command(nvcc: str, source: Path, output: Path) -> List[str]:
    """``source``'s build with its flags; ``-I csrc/`` finds the shared
    headers wherever the source lies (an earlier copy under
    ``build/probe/``, say)."""
    return [nvcc, *nvcc_flags(source.stem), "-I", str(CSRC), "-o",
            str(output), str(source)]


def included_headers(source: Path) -> List[Path]:
    """The ``csrc/`` headers ``source`` includes by a quoted
    ``#include``, directly or through another of them."""
    found: List[Path] = []
    todo = [source]
    while todo:
        text = todo.pop().read_text()
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text,
                              re.MULTILINE):
            header = CSRC / name
            if header.is_file() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, the
    headers it includes and the flags."""
    source = CSRC / f"{name}.cu"
    key = source.read_bytes()
    for header in included_headers(source):
        key += b"\0" + header.name.encode() + b"\0" + header.read_bytes()
    digest = hashlib.sha256(
        key + "\0".join(nvcc_flags(name)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names=None, load: bool = True) -> Dict[str, float]:
    """Compile every named source that is not built yet, all at once,
    and load each (``load=False`` only compiles: neither a card nor the
    CUDA driver is needed). Returns the wall seconds each build waited for."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        todo = [n for n in names if not load or n not in _libs]
        pending = {}
        started = time.perf_counter()
        for name in todo:
            out = library_path(name)
            if out.is_file():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = nvcc_command(find_nvcc(), CSRC / f"{name}.cu", tmp)
            pending[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        waited = {}
        failures = []
        for name, (proc, tmp, out) in pending.items():
            log, _ = proc.communicate()
            waited[name] = time.perf_counter() - started
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("nvcc failed for " + "\n".join(failures))
        for name in todo if load else ():
            _libs[name] = _declare(name, ctypes.CDLL(str(library_path(name))))
        return waited


def build_log(name: str) -> str:
    """What ``nvcc`` printed for the current build of ``name``, or ''
    when it was loaded from an earlier build without a log."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        build_kernels([name])
    return _libs[name]


class Entry(NamedTuple):
    """A C entry point: the ``csrc/`` source (without ``.cu``) that
    exports it, its symbol and its argument types."""

    source: str
    symbol: str
    argtypes: list


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: each kernel's C entry point
SIGNATURES = {
    "stencil_sweep": Entry(
        "stencil_sweep", "smi_stencil_sweep",
        # x, top, bottom, left, right, out, h, w, row0, col0, gh, gw, stream
        [_P] * 6 + [_I] * 6 + [_P],
    ),
    "stencil_temporal": Entry(
        "stencil_temporal", "smi_stencil_temporal",
        # x, top, bottom, left, right, out, h, w, row0, col0, gh, gw,
        # depth, tile_h, tile_w, stream
        [_P] * 6 + [_I] * 9 + [_P],
    ),
    "stencil_pipeline": Entry(
        "stencil_pipeline", "smi_stencil_pipeline",
        # ext, out, h, w, row0, col0, gh, gw, depth, stripe, band, bf16,
        # buffering, stream
        [_P] * 2 + [_I] * 11 + [_P],
    ),
    "flash_fused": Entry(
        "flash_fwd", "smi_flash_fused",
        # q, k, v, out, m, l, dtype, h, h_kv, s_q, s_k, d, d_v, q_off,
        # k_off, causal, window, scale, block_q, block_k, stream
        [_P] * 6 + [_I] * 11 + [_F] + [_I] * 2 + [_P],
    ),
    "flash_block": Entry(
        "flash_fwd", "smi_flash_block",
        # q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, dtype, h,
        # h_kv, s_q, s_k, d, d_v, q_off, k_off, causal, window, scale,
        # block_q, block_k, stream
        [_P] * 9 + [_I] * 11 + [_F] + [_I] * 2 + [_P],
    ),
    "flash_bwd_dq": Entry(
        "flash_bwd", "smi_flash_bwd_dq",
        # q, k, v, dout, m, linv, delta, dq, dtype, h, h_kv, s_q, s_k, d,
        # d_v, q_off, k_off, causal, window, scale, block_q, block_k,
        # stream
        [_P] * 8 + [_I] * 11 + [_F] + [_I] * 2 + [_P],
    ),
    "flash_bwd_dkdv": Entry(
        "flash_bwd", "smi_flash_bwd_dkdv",
        # q, k, v, dout, m, linv, delta, dk, dv, dtype, h, h_kv, s_q, s_k,
        # d, d_v, q_off, k_off, causal, window, scale, block_q, block_k,
        # stream
        [_P] * 9 + [_I] * 11 + [_F] + [_I] * 2 + [_P],
    ),
    # the ring kernels share: table, ranks, n, elems, slot_stride,
    # dtype ... flow_control, blocks, stream
    "ring_neighbour_stream": Entry(
        "ring", "smi_ring_neighbour_stream",
        # ... dtype, chunks, direction, flow_control, blocks, stream
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 5 + [_P],
    ),
    "ring_all_gather": Entry(
        "ring", "smi_ring_all_gather",
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 3 + [_P],
    ),
    "ring_all_reduce": Entry(
        "ring", "smi_ring_all_reduce",
        # ... dtype, op, flow_control, blocks, stream
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 4 + [_P],
    ),
    "ring_reduce_scatter": Entry(
        "ring", "smi_ring_reduce_scatter",
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 4 + [_P],
    ),
    "ring_all_reduce_chunked": Entry(
        "ring", "smi_ring_all_reduce_chunked",
        # ... dtype, op, chunks, flow_control, blocks, stream
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 5 + [_P],
    ),
    "roll_chain": Entry(
        "roll_chain", "smi_roll_chain",
        # ins, outs, chains, rows, cols, length, body, regs, warps,
        # stream
        [_P] * 2 + [_I] * 7 + [_P],
    ),
    "attn_prologue": Entry(
        "attn_glue", "smi_attn_prologue",
        # qkv, q_w, k_w, cos, sin, q, k, v, batch, seq, heads, kv_heads,
        # head_dim, eps, stream
        [_P] * 8 + [_I] * 5 + [_F] + [_P],
    ),
    "attn_prologue_bwd": Entry(
        "attn_glue", "smi_attn_prologue_bwd",
        # qkv, q_w, k_w, cos, sin, dq, dk, dv, dqkv, partial, dw, batch,
        # seq, heads, kv_heads, head_dim, blocks, eps, stream
        [_P] * 11 + [_I] * 6 + [_F] + [_P],
    ),
    "attn_epilogue": Entry(
        "attn_glue", "smi_attn_epilogue",
        # attn, gate, out, batch, seq, heads, head_dim, stream
        [_P] * 3 + [_I] * 4 + [_P],
    ),
    "attn_epilogue_bwd": Entry(
        "attn_glue", "smi_attn_epilogue_bwd",
        # attn, gate, dout, dattn, dgate, batch, seq, heads, head_dim,
        # stream
        [_P] * 5 + [_I] * 4 + [_P],
    ),
    "residual_norm": Entry(
        "residual_norm", "smi_residual_norm",
        # x, out, w0, w1, y0, y1, rstd, form, yn_bf16, rows, width, eps,
        # stream
        [_P] * 7 + [_I] * 4 + [_F] + [_P],
    ),
    "residual_norm_bwd": Entry(
        "residual_norm", "smi_residual_norm_bwd",
        # x, out, w0, w1, rstd, dres, dy, dx, dout, partial, dw, form,
        # yn_bf16, rows, width, blocks, stream
        [_P] * 11 + [_I] * 5 + [_P],
    ),
}

#: the flash kernels' split form (queries and keys 192 wide, values
#: 128: ``kernels/flash.py``'s ``SPLIT_HEAD_DIMS``): the same entries,
#: each with a launch count of its own
SIGNATURES.update({f"{name}_192x128": SIGNATURES[name] for name in (
    "flash_fused", "flash_block", "flash_bwd_dq", "flash_bwd_dkdv")})

#: the runtime's occupancy queries
#: (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), by the source
#: they ask about: the stencil queries return the blocks an SM holds or
#: minus a CUDA error; the ring's returns the error and writes the count
#: through its last argument
QUERIES = {
    # depth, band
    "stencil_temporal": Entry(
        "stencil_temporal", "smi_stencil_temporal_blocks_per_sm", [_I] * 2),
    # depth, stripe, band, bf16, buffering
    "stencil_pipeline": Entry(
        "stencil_pipeline", "smi_stencil_pipeline_blocks_per_sm", [_I] * 5),
    # kernel code, dtype code, op, out
    "ring": Entry("ring", "smi_ring_blocks_per_sm",
                  [_I] * 3 + [ctypes.POINTER(_I)]),
}


def source_of(kernel: str) -> str:
    """The ``csrc/`` source (without ``.cu``) that exports ``kernel``."""
    return SIGNATURES[kernel].source


#: every source, each built into one library
SOURCES = sorted({e.source for e in SIGNATURES.values()})

#: kernel name -> launches made through its wrapper (the plain CPU
#: versions launch nothing and count nothing)
LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}


def _declare(source: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for e in (*SIGNATURES.values(), *QUERIES.values()):
        if e.source == source:
            fn = getattr(lib, e.symbol)
            fn.argtypes = e.argtypes
            fn.restype = ctypes.c_int
    return lib


def entry(kernel: str):
    """The declared C entry point of ``kernel``."""
    return getattr(library(source_of(kernel)), SIGNATURES[kernel].symbol)


def check(name: str, status: int) -> None:
    """Raise when a launch returned a CUDA error."""
    if status != 0:
        raise RuntimeError(
            f"{name} kernel launch failed with cudaError {status}"
        )


def launch(kernel: str, device, *args, stream: Optional[int] = None) -> None:
    """One launch of ``kernel`` on ``device``: its entry point on
    ``args`` (a tensor passes its data pointer) and ``stream`` (a
    ``cudaStream_t``; the device's current stream when None), then
    :func:`check`, then :func:`count_launch`."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(device):
        if stream is None:
            stream = torch.cuda.current_stream().cuda_stream
        status = entry(kernel)(*args, stream)
    check(kernel, status)
    count_launch(kernel)


def check_operand(what: str, name: str, t, dtype, shape) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape``, contiguous
    and, on a card, 16-byte aligned: what a kernel reading it in 16-byte
    vectors takes."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")


def check_device(what: str, device, has_instance: bool, wanted: str) -> None:
    """Raise unless ``device`` is the CPU (where the plain versions run)
    or a card on which the kernel has an instance for the operands
    (``has_instance``; ``wanted`` names what was asked for)."""
    if device.type == "cuda" and not has_instance:
        raise ValueError(f"{what}: no kernel for {wanted}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no kernel for {device}")


def fixed_grid(units: int, blocks_per_sm: int) -> int:
    """Blocks of a backward that sums its norm weights' gradients without
    atomics (``csrc/row_glue.cuh``): ``blocks_per_sm`` on each of the
    :data:`SMS` SMs, or one a unit of work where there are fewer. The
    blocks stride over the units, so which rows each block sums, and the
    order of every sum, are fixed by the row count: a step repeats bit
    for bit."""
    return min(units, blocks_per_sm * SMS)


def runtime_blocks_per_sm(source: str, *args) -> int:
    """The runtime's count of blocks an SM holds at once, asked through
    ``source``'s query in :data:`QUERIES` (needs a card); raises on a
    CUDA error."""
    query = QUERIES[source]
    fn = getattr(library(source), query.symbol)
    if len(args) < len(query.argtypes):   # the count comes back by pointer
        out = ctypes.c_int(0)
        check(f"{source} occupancy", fn(*args, ctypes.byref(out)))
        return out.value
    blocks = fn(*args)
    check(f"{source} occupancy", max(0, -blocks))
    return blocks


# ---------------------------------------------------------------------------
# The card: the H100 SXM's limits, which the plans and the checks read
# ---------------------------------------------------------------------------

#: streaming multiprocessors; where a card is there, its own count is asked
SMS = 132
#: shared memory (dynamic and static) one block may use (227 KB), an SM's,
#: and what the runtime reserves a block
SMEM_BYTES_LIMIT = 232_448
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_SMEM = 1024
#: registers of a partition (four an SM, a warp's all in one), of an SM,
#: and of one thread at most
PARTITION_REGISTERS = 16_384
SM_PARTITIONS = 4
SM_REGISTERS = SM_PARTITIONS * PARTITION_REGISTERS
MAX_THREAD_REGISTERS = 255
MAX_BLOCK_THREADS = 1024
MAX_SM_WARPS = 64
MAX_SM_BLOCKS = 32


def warp_registers(registers: int) -> int:
    """Registers a warp is allocated: 32 threads' worth, in units of
    256."""
    return -(-registers * 32 // 256) * 256


def blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads using ``registers`` a thread and
    ``smem`` bytes of shared memory (static and dynamic) that one SM
    holds at once (0 when none fits): a warp's registers come from one
    partition, shared memory is the SM's less what is reserved a block,
    and an SM holds at most :data:`MAX_SM_WARPS` warps and
    :data:`MAX_SM_BLOCKS` blocks."""
    warps = -(-threads // 32)
    by_regs = SM_PARTITIONS * (PARTITION_REGISTERS
                               // warp_registers(max(1, registers)))
    by_regs //= warps
    by_smem = SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM)
    return max(0, min(by_regs, by_smem, MAX_SM_WARPS // warps,
                      MAX_SM_BLOCKS))
