"""Build and load the package's CUDA kernels.

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
roll-chain probe).

Nothing here runs on import: the first :func:`library` call builds. A
missing ``nvcc`` raises; there is no fallback to the plain versions.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when it is not 0 — a launch the driver refused (too
much shared memory, a bad grid) never runs and no later synchronise
would report it.
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
from typing import Dict, List

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


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C signature of each kernel's entry point: (symbol, argument types)
SIGNATURES = {
    "stencil_sweep": (
        "smi_stencil_sweep",
        # x, top, bottom, left, right, out, h, w, row0, col0, gh, gw, stream
        [_P] * 6 + [_I] * 6 + [_P],
    ),
    "stencil_temporal": (
        "smi_stencil_temporal",
        # x, top, bottom, left, right, out, h, w, row0, col0, gh, gw,
        # depth, tile_h, tile_w, stream
        [_P] * 6 + [_I] * 9 + [_P],
    ),
    "stencil_pipeline": (
        "smi_stencil_pipeline",
        # ext, out, h, w, row0, col0, gh, gw, depth, stripe, band, bf16,
        # buffering, stream
        [_P] * 2 + [_I] * 11 + [_P],
    ),
    "flash_fused": (
        "smi_flash_fused",
        # q, k, v, out, m, l, dtype, h, h_kv, s_q, s_k, d, q_off, k_off,
        # causal, window, scale, block_q, block_k, stream
        [_P] * 6 + [_I] * 10 + [_F] + [_I] * 2 + [_P],
    ),
    "flash_block": (
        "smi_flash_block",
        # q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, dtype, h,
        # h_kv, s_q, s_k, d, q_off, k_off, causal, window, scale, block_q,
        # block_k, stream
        [_P] * 9 + [_I] * 10 + [_F] + [_I] * 2 + [_P],
    ),
    "flash_bwd_dq": (
        "smi_flash_bwd_dq",
        # q, k, v, dout, m, linv, delta, dq, dtype, h, h_kv, s_q, s_k, d,
        # q_off, k_off, causal, window, scale, block_q, block_k, stream
        [_P] * 8 + [_I] * 10 + [_F] + [_I] * 2 + [_P],
    ),
    "flash_bwd_dkdv": (
        "smi_flash_bwd_dkdv",
        # q, k, v, dout, m, linv, delta, dk, dv, dtype, h, h_kv, s_q, s_k,
        # d, q_off, k_off, causal, window, scale, block_q, block_k, stream
        [_P] * 9 + [_I] * 10 + [_F] + [_I] * 2 + [_P],
    ),
    # the ring kernels share: table, ranks, n, elems, slot_stride,
    # dtype ... flow_control, blocks, stream
    "ring_neighbour_stream": (
        "smi_ring_neighbour_stream",
        # ... dtype, chunks, direction, flow_control, blocks, stream
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 5 + [_P],
    ),
    "ring_all_gather": (
        "smi_ring_all_gather",
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 3 + [_P],
    ),
    "ring_all_reduce": (
        "smi_ring_all_reduce",
        # ... dtype, op, flow_control, blocks, stream
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 4 + [_P],
    ),
    "ring_reduce_scatter": (
        "smi_ring_reduce_scatter",
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 4 + [_P],
    ),
    "ring_all_reduce_chunked": (
        "smi_ring_all_reduce_chunked",
        # ... dtype, op, chunks, flow_control, blocks, stream
        [_P] + [_I] * 2 + [_L] * 2 + [_I] * 5 + [_P],
    ),
    "roll_chain": (
        "smi_roll_chain",
        # ins, outs, chains, rows, cols, length, body, regs, warps,
        # stream
        [_P] * 2 + [_I] * 7 + [_P],
    ),
}

#: kernels whose entry point lives in a source of another name
_SOURCE_OF = {"flash_fused": "flash_fwd", "flash_block": "flash_fwd",
              "flash_bwd_dq": "flash_bwd", "flash_bwd_dkdv": "flash_bwd",
              "ring_neighbour_stream": "ring", "ring_all_gather": "ring",
              "ring_all_reduce": "ring", "ring_reduce_scatter": "ring",
              "ring_all_reduce_chunked": "ring"}


def source_of(kernel: str) -> str:
    """The ``csrc/`` source (without ``.cu``) that exports ``kernel``."""
    return _SOURCE_OF.get(kernel, kernel)


#: every source, each built into one library
SOURCES = sorted({source_of(k) for k in SIGNATURES})

#: kernel name -> launches made through its wrapper (the plain CPU
#: versions launch nothing and count nothing)
LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}


def _declare(source: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for kernel, (symbol, argtypes) in SIGNATURES.items():
        if source_of(kernel) == source:
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def entry(kernel: str):
    """The declared C entry point of ``kernel``."""
    return getattr(library(source_of(kernel)), SIGNATURES[kernel][0])


def check(name: str, status: int) -> None:
    """Raise when a launch returned a CUDA error."""
    if status != 0:
        raise RuntimeError(
            f"{name} kernel launch failed with cudaError {status}"
        )
