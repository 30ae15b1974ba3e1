"""ctypes bindings for the native host runtime + manifest tool driver.

PyTorch counterpart of :mod:`smi_tpu.utils.native`, over the same
native pieces, which mirror the reference's C++ host layer:

- ``libsmi_runtime.so`` — timers and binary routing-table IO
  (``include/utils/smi_utils.hpp``, ``include/utils/utils.hpp``);
- ``smi-manifest`` — the source-rewriter-equivalent analysis tool
  (``source-rewriter/``), driven as a subprocess exactly as the
  reference's codegen drives its Clang tool (``codegen/rewrite.py:36-57``).
  Its import-alias grammar skips the module path, so
  ``from smi_tpu_torch import Push as P`` reads as it does for
  ``smi_tpu``.

Both come from ``native/`` at the repository root: the binaries under
``native/build/`` where they load and run on this machine, else a build
of ``native/manifest/*.cpp`` and ``native/runtime/*.cpp`` with
``native/Makefile``'s flags into ``build/native/`` (made once, at first
use; ``native/`` itself is never written). The runtime's entry points
keep the JAX module's pure-Python fallbacks for when neither is there;
:func:`native_available` says which one is in use. This is host code:
no tensor and no kernel goes through it.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Sequence

from smi_tpu_torch.ops.operations import SmiOperation, make_operation

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
#: the committed binaries, built on another machine
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
#: where this machine's own build goes when those do not load
LOCAL_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_RUNTIME_NAME = "libsmi_runtime.so"
_MANIFEST_NAME = "smi-manifest"

#: ``native/Makefile``'s flags
CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC")
_SOURCES = {
    _RUNTIME_NAME: (("-shared",), ("runtime/smi_runtime.cpp",)),
    _MANIFEST_NAME: ((), ("manifest/main.cpp", "manifest/scanner.cpp")),
}

_lock = threading.Lock()
_lib = None
_tool: Optional[str] = None
#: artifact name -> why the local build was refused or failed
build_errors: dict = {}


def _build_local(name: str) -> Optional[str]:
    """Build ``name`` from ``native/``'s sources into
    :data:`LOCAL_BUILD_DIR`; its path, or None (the reason in
    :data:`build_errors`)."""
    out = os.path.join(LOCAL_BUILD_DIR, name)
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    extra, sources = _SOURCES[name]
    paths = [os.path.join(_NATIVE_DIR, s) for s in sources]
    if cxx is None or not all(os.path.exists(p) for p in paths):
        build_errors[name] = ("no C++ compiler" if cxx is None
                              else "native sources missing")
        return None
    os.makedirs(LOCAL_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXXFLAGS, *extra, *paths, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        build_errors[name] = proc.stderr.strip()
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = None
        committed = os.path.join(_BUILD_DIR, _RUNTIME_NAME)
        for path in (committed, None):
            if path is None:
                path = _build_local(_RUNTIME_NAME)
            if path is None or not os.path.exists(path):
                continue
            try:
                lib = ctypes.CDLL(path)
                break
            except OSError as e:
                build_errors[path] = str(e)
        if lib is None:
            return None
        lib.smi_runtime_version.restype = ctypes.c_char_p
        lib.smi_time_usecs.restype = ctypes.c_int64
        lib.smi_time_nsecs.restype = ctypes.c_int64
        lib.smi_load_routing_table.restype = ctypes.c_int32
        lib.smi_load_routing_table.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ]
        lib.smi_store_routing_table.restype = ctypes.c_int32
        lib.smi_store_routing_table.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ]
        lib.smi_bootstrap_rank.restype = ctypes.c_int32
        lib.smi_bootstrap_rank.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        _lib = lib
        return lib


def _runs(path: str) -> bool:
    try:
        return subprocess.run([path, "--help"], capture_output=True,
                              timeout=60).returncode == 0
    except OSError:
        return False


def manifest_tool() -> Optional[str]:
    """The ``smi-manifest`` binary that runs here, or None."""
    global _tool
    if _tool is not None:
        return _tool
    with _lock:
        if _tool is None:
            committed = os.path.join(_BUILD_DIR, _MANIFEST_NAME)
            if os.path.exists(committed) and _runs(committed):
                _tool = committed
            else:
                local = _build_local(_MANIFEST_NAME)
                if local is not None and _runs(local):
                    _tool = local
        return _tool


def native_available() -> bool:
    """True when the native runtime is in use, False when the
    pure-Python fallbacks are."""
    return _load() is not None


def manifest_tool_available() -> bool:
    return manifest_tool() is not None


def runtime_version() -> str:
    lib = _load()
    if lib is None:
        return "python-fallback"
    return lib.smi_runtime_version().decode()


def time_usecs() -> int:
    """Monotonic microseconds (``utils.hpp:10-16`` parity)."""
    lib = _load()
    if lib is None:
        return time.monotonic_ns() // 1000
    return lib.smi_time_usecs()


def time_nsecs() -> int:
    lib = _load()
    if lib is None:
        return time.monotonic_ns()
    return lib.smi_time_nsecs()


def load_routing_table(directory: str, kind: str, rank: int,
                       channel: int) -> List[int]:
    """Read one binary table file (``smi_utils.hpp:24-39`` parity)."""
    lib = _load()
    if lib is None:
        path = os.path.join(directory, f"{kind}-rank{rank}-channel{channel}")
        with open(path, "rb") as f:
            return list(f.read())
    cap = 1 << 20
    buf = (ctypes.c_uint8 * cap)()
    n = lib.smi_load_routing_table(
        directory.encode(), kind.encode(), rank, channel, buf, cap
    )
    if n < 0:
        raise FileNotFoundError(
            f"native load of {kind}-rank{rank}-channel{channel} in "
            f"{directory} failed (code {n})"
        )
    return list(buf[:n])


def store_routing_table(directory: str, kind: str, rank: int, channel: int,
                        entries: Sequence[int]) -> None:
    lib = _load()
    data = bytes(entries)
    if lib is None:
        path = os.path.join(directory, f"{kind}-rank{rank}-channel{channel}")
        with open(path, "wb") as f:
            f.write(data)
        return
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    rc = lib.smi_store_routing_table(
        directory.encode(), kind.encode(), rank, channel, buf, len(data)
    )
    if rc != 0:
        raise IOError(f"native store of routing table failed (code {rc})")


def bootstrap_rank(directory: str, rank: int, channels: int = 4,
                   max_ranks: int = 8) -> int:
    """Validate a rank's table set; returns the logical port count.

    The native runtime's ``SmiInit`` analog (``host_hlslib.cl:20-38``):
    all 2×channels tables must exist and agree on the port count.
    """
    lib = _load()
    if lib is None:
        ports = None
        for c in range(channels):
            try:
                cks = load_routing_table(directory, "cks", rank, c)
                ckr = load_routing_table(directory, "ckr", rank, c)
            except FileNotFoundError as e:
                # match the native path's contract: missing tables are a
                # bootstrap ValueError, not an IO error
                raise ValueError(
                    f"bootstrap failed for rank {rank} in {directory}: {e}"
                ) from e
            if not cks or len(cks) % max_ranks:
                raise ValueError(f"bad cks table for rank {rank} ch {c}")
            p = len(cks) // max_ranks
            if len(ckr) != 2 * p:
                raise ValueError(f"bad ckr table for rank {rank} ch {c}")
            if ports is None:
                ports = p
            elif ports != p:
                raise ValueError("inconsistent port counts across tables")
        return ports or 0
    rc = lib.smi_bootstrap_rank(directory.encode(), rank, channels, max_ranks)
    if rc < 0:
        raise ValueError(
            f"bootstrap failed for rank {rank} in {directory} (code {rc})"
        )
    return rc


def extract_manifest(paths: Sequence[str],
                     p2p_rendezvous: bool = True,
                     validate: bool = True) -> List[SmiOperation]:
    """Run the native manifest tool over user sources.

    Returns the discovered operations; raises ``RuntimeError`` with the
    tool's diagnostics on validation failure (port conflicts,
    non-constant ports — the errors the reference rewriter pipeline
    surfaces at build time).
    """
    tool = manifest_tool()
    if tool is None:
        raise FileNotFoundError(
            f"{os.path.join(_BUILD_DIR, _MANIFEST_NAME)} does not run here "
            f"and could not be built into {LOCAL_BUILD_DIR}: "
            f"{build_errors.get(_MANIFEST_NAME, 'unknown reason')}"
        )
    cmd = [tool]
    if not p2p_rendezvous:
        cmd.append("--no-rendezvous")
    if not validate:
        cmd.append("--no-validate")
    cmd.extend(paths)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "smi-manifest failed:\n" + proc.stderr.strip()
        )
    ops = []
    for line in proc.stdout.splitlines():
        line = line.strip()
        if not line:
            continue
        data = json.loads(line)
        kwargs = {}
        if data["type"] == "reduce":
            kwargs["op"] = data.get("args", {}).get("op_type", "add")
        ops.append(
            make_operation(
                data["type"], port=data["port"],
                dtype=data.get("data_type", "int"),
                buffer_size=data.get("buffer_size"), **kwargs,
            )
        )
    return ops
