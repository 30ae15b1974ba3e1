"""Explicit-copy stencil pipeline: k sweeps per pass on a TMA + mbarrier ring.

PyTorch counterpart of :mod:`smi_tpu.kernels.stencil_pipeline`. There the
block lives in HBM and a three-slot VMEM rotation carries row stripes,
every move an explicit DMA against a semaphore slot: the fetch of stripe
i+1, the k sweeps of stripe i and the write-back of stripe i-1 are in
flight at once. Here ``csrc/stencil_pipeline.cu`` does the same on
Hopper: the Tensor Memory Accelerator (TMA) copies each stripe of a column
band's window into one of three shared-memory slots and reports to that
slot's ``mbarrier``, the block's threads carry the k sweeps down the rows
as they arrive (the row wavefront of ``csrc/stencil_wavefront.cuh``), and
TMA stores write finished stripes back while the next are fetched and
swept.

The state stays in an extended ``(H + 2k, W + 2k)`` f32 layout across
passes, as the reference keeps its ``(H + 2k, W + 256)`` one: the block
in the interior, its corner-complete k-deep halos in the border. Each
pass refreshes only that border (O(k·(H+W)) bytes, in place) and every
window copy carries its own aprons, so the halo refresh is fused into the
stripe stream. Two extended buffers, the input and the output of a pass,
swap between passes.

Knobs, as in the JAX package: ``depth`` (sweeps per pass), ``stripe``
(rows a copy carries), ``compute_dtype`` (``"float32"``, bit-identical to
the serial reference, or ``"bfloat16"``: each neighbour rounded to bf16,
the centre and the sum kept in f32) and ``buffering`` (3, the ring; 1,
the synchronous control). The state is f32 only. ``interpret=`` has no
counterpart.

:func:`pipeline_sweeps` launches the kernel for a CUDA tensor and calls
:func:`pipeline_sweeps_plain`, the same function in PyTorch ops, only for
a CPU tensor.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Optional, Tuple

import torch

from smi_tpu_torch.kernels import _build
from smi_tpu_torch.kernels import stencil as kstencil
from smi_tpu_torch.kernels import stencil_temporal as ktemporal
from smi_tpu_torch.kernels.stencil import block_origin, global_boundary_mask
from smi_tpu_torch.parallel.halo import (
    halo_exchange_2d_corners_finish,
    halo_exchange_2d_corners_start,
)
from smi_tpu_torch.parallel.mesh import Communicator

KERNEL = "stencil_pipeline"

#: slots of the shipped ring: fetch, compute and write-back each own one;
#: 1 is the synchronous control
PIPELINE_SLOTS = 3

#: compute dtypes of the sweep arithmetic; the state is always f32
COMPUTE_DTYPES = ("float32", "bfloat16")

#: the longest edge of a TMA box, in elements
TMA_BOX_MAX = 256

#: the narrowest band the planner takes (output columns a block)
MIN_BAND = 32

#: the kernel's launch bound (``kMaxThreads`` in the C entry)
MAX_THREADS = 256

#: columns a thread owns at the register depths (``columns`` in
#: ``csrc/stencil_wavefront.cuh``'s one-group form: every level in each
#: thread); any other depth runs the generic loop, one column a thread
REGISTER_COLUMNS = {8: 4, 16: 4, 32: 2}

#: the rows a copy carries when the caller names no stripe: the least
#: shared memory a slot can take, and still two copies ahead of the sweeps
DEFAULT_STRIPE = 8

#: output rows a block streams at most (``kRunRows`` in the C entry)
RUN_ROWS = 128

#: shared-memory alignment of every region (TMA wants 128 B)
SLOT_ALIGN = 128

#: rows of a boundary column's input a block keeps for bf16 holds
#: (``kKeepRing`` in ``csrc/stencil_wavefront.cuh``)
KEEP_RING = 128


def columns(depth: int) -> int:
    """Columns a thread owns at ``depth``."""
    return REGISTER_COLUMNS.get(depth, 1)


def window_threads(band: int, depth: int) -> int:
    """Threads of a block: one level group covering the window of
    ``band`` columns and its aprons, :func:`columns` a thread."""
    return ktemporal.window_threads(band, depth, columns(depth))


def _aligned(floats: int) -> int:
    return -(-4 * floats // SLOT_ALIGN) * SLOT_ALIGN


def pipeline_smem_bytes(stripe: int, band: int, depth: int,
                        buffering: int = PIPELINE_SLOTS) -> int:
    """Shared memory of one block, each region rounded up to
    :data:`SLOT_ALIGN`: ``buffering`` slots of a ``stripe``-row chunk of
    the window, two staging buffers of ``stripe`` output rows, the
    mbarriers, the sweeps' scratch and the bf16 holds' input values, plus
    the slack to align the first. The counterpart of the JAX package's
    ``pipeline_vmem_bytes``; the CUDA launcher computes the same."""
    width = window_threads(band, depth) * columns(depth)
    return (_aligned(buffering * stripe * width)
            + _aligned(2 * stripe * band)
            + _aligned(2 * PIPELINE_SLOTS)
            + _aligned(ktemporal.scratch_floats(band, depth, 1,
                                                columns(depth)))
            + _aligned(2 * width + 2 * KEEP_RING)
            + SLOT_ALIGN)


def _stores(band: int) -> int:
    """TMA stores a staging buffer takes: boxes of at most
    :data:`TMA_BOX_MAX` columns, as many as the band needs."""
    return -(-band // TMA_BOX_MAX)


def _band_fits(band: int, depth: int) -> bool:
    """The C entry's rules for a band: its window within the launch
    bound, and equal store boxes of whole 16-byte rows."""
    boxes = _stores(band)
    return (window_threads(band, depth) <= MAX_THREADS
            and band % boxes == 0 and band // boxes % 4 == 0)


def _area_ratio(h: int, w: int, depth: int, band: int) -> Fraction:
    """Window cells swept per output cell: every band's window (a warp of
    columns at a time) over the rows plus a 2k-row apron for each run of
    at most :data:`RUN_ROWS` rows, the fewest runs the C entry cuts."""
    width = window_threads(band, depth) * columns(depth)
    runs = -(-h // RUN_ROWS)
    return Fraction(-(-w // band) * width * (h + runs * 2 * depth), h * w)


@functools.lru_cache(maxsize=256)
def _plan(h: int, w: int, depth: int, buffering: int = PIPELINE_SLOTS,
          stripe: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """``(stripe, band)`` for an ``(h, w)`` block, or None.

    The reference's domain: ``depth`` a multiple of 8, ``w`` of 128, the
    stripe an 8-aligned divisor of ``h`` (:data:`DEFAULT_STRIPE` unless
    named). Hopper's limits: the stripe within the TMA box and the block's
    shared memory within a block's. The band is the even split of ``w``
    (rounded up to whole store boxes) that sweeps the fewest window
    columns; on a tie, the fewer bands. The C entry spreads each band's
    stripes over as many blocks as fill the card.
    """
    if depth < 8 or depth % 8 or w < 128 or w % 128 or h < 8:
        return None
    t = DEFAULT_STRIPE if stripe is None else stripe
    if t < 8 or t % 8 or h % t or t > TMA_BOX_MAX:
        return None
    c = columns(depth)
    best = None
    for n in range(32, min(MAX_THREADS, ktemporal.MAX_WIDTH // c) + 1, 32):
        widest = n * c - 2 * depth
        if widest < MIN_BAND:
            continue
        count, band = ktemporal.even_bands(w, widest)
        band = -(-band // (4 * _stores(band))) * 4 * _stores(band)
        if (band > widest or not _band_fits(band, depth)
                or pipeline_smem_bytes(t, band, depth,
                                       buffering) > _build.SMEM_BYTES_LIMIT):
            continue
        key = (_area_ratio(h, w, depth, band), count)
        if best is None or key < best[0]:
            best = (key, band)
    return None if best is None else (t, best[1])


def pick_pipeline_stripe_explained(
    h: int, w: int, depth: int, buffering: int = PIPELINE_SLOTS,
) -> Tuple[Optional[int], str]:
    """``(stripe, note)``: the planned stripe and its band, or ``(None,
    reason)`` naming exactly why the shape is refused."""
    if depth < 8 or depth % 8:
        return None, (
            f"depth {depth} is not a multiple of 8 (the reference's "
            f"sublane-aligned depths)"
        )
    if w < 128 or w % 128:
        return None, (
            f"w={w} is not a multiple of 128 (the reference's lane-aligned "
            f"widths, which keep every extended row a multiple of 16 B, "
            f"as TMA needs)"
        )
    plan = _plan(h, w, depth, buffering)
    if plan is None:
        if h % DEFAULT_STRIPE:
            return None, (
                f"no 8-aligned stripe divides h={h} (the rows a copy "
                f"carries, whole stripes a block)"
            )
        return None, (
            f"no window of a {MIN_BAND}-column band or wider at depth "
            f"{depth} fits {buffering} slot(s) of {DEFAULT_STRIPE} rows, "
            f"two staging buffers and the sweeps' scratch in the "
            f"{_build.SMEM_BYTES_LIMIT} B of shared memory a block may use"
        )
    t, band = plan
    slots = f"{buffering} slot{'s' if buffering > 1 else ''}"
    return t, (
        f"stripe {t}, band {band} ({slots}, "
        f"{pipeline_smem_bytes(t, band, depth, buffering)} B of shared "
        f"memory, {float(_area_ratio(h, w, depth, band)):.4g} window "
        f"cells per output cell)"
    )


def _pick_pipeline_stripe(h: int, w: int, depth: int,
                          buffering: int = PIPELINE_SLOTS) -> Optional[int]:
    return pick_pipeline_stripe_explained(h, w, depth, buffering)[0]


def pipeline_supported(
    h: int, w: int, dtype, depth: int,
    stripe: Optional[int] = None,
    compute_dtype: str = "float32",
    buffering: int = PIPELINE_SLOTS,
) -> bool:
    """True when the pipeline kernel can run this block shape."""
    return (
        dtype == torch.float32
        and compute_dtype in COMPUTE_DTYPES
        and buffering in (1, PIPELINE_SLOTS)
        and _plan(h, w, depth, buffering, stripe) is not None
    )


def _check_pass(h: int, w: int, dtype, depth: int, stripe: Optional[int],
                compute_dtype: str, buffering: int) -> Tuple[int, int]:
    """The ``(stripe, band)`` of a pass, or a ValueError naming why the
    pass is refused."""
    if dtype != torch.float32:
        raise ValueError(f"stencil pipeline: the state must be float32, "
                         f"got {dtype}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"stencil pipeline: compute_dtype "
                         f"{compute_dtype!r} is not one of {COMPUTE_DTYPES}")
    if buffering not in (1, PIPELINE_SLOTS):
        raise ValueError(f"stencil pipeline: buffering must be 1 or "
                         f"{PIPELINE_SLOTS}, got {buffering}")
    plan = _plan(h, w, depth, buffering, stripe)
    if plan is None:
        if stripe is not None and _plan(h, w, depth, buffering) is not None:
            note = (f"requested stripe {stripe} is not an 8-aligned divisor "
                    f"of h={h} within the {TMA_BOX_MAX}-row TMA box whose "
                    f"slots fit shared memory")
        else:
            _, note = pick_pipeline_stripe_explained(h, w, depth, buffering)
        raise ValueError(f"stencil pipeline unsupported for block ({h}, {w}) "
                         f"at depth {depth}: {note}")
    return plan


def pipeline_sweeps_plain(ext: torch.Tensor, row0: int, col0: int, gh: int,
                          gw: int, depth: int,
                          compute_dtype: str = "float32") -> torch.Tensor:
    """``depth`` sweeps in PyTorch ops over the extended state: the
    kernel's plain version. Returns the new ``(H, W)`` block.

    The outer ring of ``ext`` is never written; sweep s leaves every cell
    at least s+1 rings deep exact, so after ``depth`` sweeps the block
    is. bf16 rounds each neighbour (round to nearest even) and keeps the
    centre and the sum in f32."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not one of "
                         f"{COMPUTE_DTYPES}")
    k = depth
    h, w = ext.shape[0] - 2 * k, ext.shape[1] - 2 * k
    boundary = global_boundary_mask((h + 2 * k - 2, w + 2 * k - 2),
                                    row0 - k + 1, col0 - k + 1, gh, gw,
                                    ext.device)
    a = ext
    for _ in range(k):
        n = a if compute_dtype == "float32" else a.to(torch.bfloat16).float()
        avg = 0.25 * (n[:-2, 1:-1] + n[2:, 1:-1] + n[1:-1, :-2]
                      + n[1:-1, 2:])
        nxt = a.clone()
        nxt[1:-1, 1:-1] = torch.where(boundary, a[1:-1, 1:-1], avg)
        a = nxt
    return a[k:k + h, k:k + w].contiguous()


def pipeline_sweeps(ext: torch.Tensor, row0: int, col0: int, gh: int,
                    gw: int, depth: int, stripe: Optional[int] = None,
                    compute_dtype: str = "float32",
                    buffering: int = PIPELINE_SLOTS,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``depth`` fused sweeps over the extended state ``ext``, an
    ``(H + 2k, W + 2k)`` f32 tensor holding the block (global offset
    ``(row0, col0)`` in a ``(gh, gw)`` grid) with its corner-complete
    halos in the border.

    Writes the new block into the interior of ``out``, a second extended
    buffer (allocated when None; its border is not written) and returns
    that interior, a view. Launches the CUDA kernel for a CUDA tensor."""
    k = depth
    if not torch.is_tensor(ext) or ext.dim() != 2:
        raise ValueError("pipeline_sweeps: ext must be a 2-D tensor")
    h, w = ext.shape[0] - 2 * k, ext.shape[1] - 2 * k
    stripe, band = _check_pass(h, w, ext.dtype, k, stripe, compute_dtype,
                               buffering)
    if out is None:
        out = torch.empty_like(ext)
    if (out.shape != ext.shape or out.dtype != ext.dtype
            or out.device != ext.device):
        raise ValueError(f"pipeline_sweeps: out must be a {tuple(ext.shape)} "
                         f"{ext.dtype} tensor on {ext.device}")
    if not (ext.is_contiguous() and out.is_contiguous()):
        raise ValueError("pipeline_sweeps: ext and out must be contiguous")
    if ext.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pipeline_sweeps: no kernel for {ext.device}")
    if out.untyped_storage().data_ptr() == ext.untyped_storage().data_ptr():
        raise ValueError("pipeline_sweeps: out must not share ext's "
                         "storage (windows read their neighbours' aprons)")
    interior = out[k:k + h, k:k + w]
    if ext.device.type == "cpu":
        interior.copy_(pipeline_sweeps_plain(ext, row0, col0, gh, gw, k,
                                             compute_dtype))
        return interior
    _build.launch(KERNEL, ext.device, ext.data_ptr(), out.data_ptr(), h, w,
                  row0, col0, gh, gw, k, stripe, band,
                  int(compute_dtype == "bfloat16"), buffering)
    return interior


def _extend(block: torch.Tensor, depth: int) -> torch.Tensor:
    """A new ``(H + 2k, W + 2k)`` extended state: ``block`` in the
    interior, zeros in the border."""
    k = depth
    h, w = block.shape
    ext = block.new_zeros((h + 2 * k, w + 2 * k))
    ext[k:k + h, k:k + w] = block
    return ext


def _refresh_halos(ext: torch.Tensor, comm: Communicator,
                   depth: int) -> None:
    """Write this pass's corner-complete ``depth``-deep halos into the
    border of the extended state, in place. The side columns land while
    the vertical transfers fly, as in the JAX package's split form."""
    k = depth
    h, w = ext.shape[0] - 2 * k, ext.shape[1] - 2 * k
    exchange = halo_exchange_2d_corners_start(ext[k:k + h, k:k + w], comm,
                                              depth=k)
    ext[k:k + h, :k] = exchange.left
    ext[k:k + h, k + w:] = exchange.right
    halos = halo_exchange_2d_corners_finish(exchange)
    ext[:k] = halos.top
    ext[k + h:] = halos.bottom


def _pipeline_pass_ext(ext: torch.Tensor, out: torch.Tensor,
                       comm: Communicator, origin: Tuple[int, int], gh: int,
                       gw: int, depth: int, stripe: Optional[int],
                       compute_dtype: str, buffering: int) -> torch.Tensor:
    """One pass: the halo refresh into ``ext``'s border (in place), then
    one launch that writes ``out``'s interior; returns that interior."""
    _refresh_halos(ext, comm, depth)
    return pipeline_sweeps(ext, *origin, gh, gw, depth, stripe,
                           compute_dtype, buffering, out=out)


def pipeline_pass(block: torch.Tensor, comm: Communicator, gh: int, gw: int,
                  depth: int = 8, stripe: Optional[int] = None,
                  compute_dtype: str = "float32",
                  buffering: int = PIPELINE_SLOTS) -> torch.Tensor:
    """``depth`` fused sweeps over a plain ``(H, W)`` block, one pipeline
    pass; ``block`` itself is not written."""
    h, w = block.shape
    _check_pass(h, w, block.dtype, depth, stripe, compute_dtype, buffering)
    ext = _extend(block, depth)
    row0, col0, _, _ = block_origin(block, comm)
    return _pipeline_pass_ext(ext, torch.empty_like(ext), comm, (row0, col0),
                              gh, gw, depth, stripe, compute_dtype,
                              buffering).contiguous()


def make_pipeline_stencil_fn(comm: Communicator, iterations: int, gh: int,
                             gw: int, depth: int = 8,
                             stripe: Optional[int] = None,
                             compute_dtype: str = "float32",
                             buffering: int = PIPELINE_SLOTS):
    """``fn(block)``: ``iterations`` sweeps on this rank's block.

    Same contract as ``make_temporal_stencil_fn``: the state stays in the
    extended layout across the ``iterations // depth`` pipeline passes
    (one kernel read and one write per pass, the two buffers swapped),
    and the remainder runs on the single-sweep fused kernel."""
    full, rem = divmod(iterations, depth)
    k = depth

    def fn(block: torch.Tensor) -> torch.Tensor:
        if full:
            h, w = block.shape
            _check_pass(h, w, block.dtype, k, stripe, compute_dtype,
                        buffering)
            row0, col0, _, _ = block_origin(block, comm)
            a = _extend(block, k)
            b = torch.empty_like(a)
            for _ in range(full):
                _pipeline_pass_ext(a, b, comm, (row0, col0), gh, gw, k,
                                   stripe, compute_dtype, buffering)
                a, b = b, a
            block = a[k:k + h, k:k + w].contiguous()
        for _ in range(rem):
            block = kstencil.jacobi_step_block_fused(block, comm, gh, gw)
        return block

    return fn
