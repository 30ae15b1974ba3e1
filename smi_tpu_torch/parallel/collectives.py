"""Rooted collectives: Bcast, Reduce, Scatter, Gather.

PyTorch counterpart of :mod:`smi_tpu.parallel.collectives`. Reference
semantics kept: every collective takes an arbitrary *root* rank and a
logical *port*; Reduce supports ADD/MAX/MIN; only the root observes
Reduce/Gather results (zeros elsewhere), and rank r receives slice r of
the root's Scatter buffer.

Two implementation tiers per collective (``backend=``):

- ``"xla"`` (default, named as in the JAX package): one collective of
  the communicator's transport — ``torch.distributed``, or the rendezvous
  of a ``LocalWorld``;
- ``"ring"``: the explicit-schedule tier, the hand-written ring kernels
  with credit flow control (:mod:`smi_tpu_torch.kernels.ring`).

Rooted-ness is expressed by masking, as there: a broadcast is an
all-reduce of the value masked to the root (off-root ranks contribute
zeros), a scatter is a reduce-scatter of the masked buffer, and rooted
results are zeroed off-root. ``rank`` is a Python int here, so a mask is
a branch, not a ``where``.

``chunks=`` splits the payload along the leading axis into independent
per-chunk collectives plus a reassembly — pure payload splitting, so the
result is bit-identical to the unchunked call. On the ring tier the
chunks of a scatter or a gather are a sequence of launches on one stream
slot, and a chunked bcast or reduce (and so allreduce) is one launch of
the chunked all-reduce kernel, every chunk on its own slot pair.
``chunks=None`` means one collective.

The JAX package's algorithm knobs, each resolved in the same order:

- a large ADD ``allreduce`` on the ``"xla"`` tier takes the bandwidth-
  optimal reduce-scatter + all-gather form (``rs_ag=``; by default at
  :data:`RS_AG_MIN_BYTES` a rank, or ``$SMI_TPU_RS_AG_MIN_BYTES``);
- ``hierarchical=`` takes the two-tier composition on a hybrid
  ``("dcn", "ici")`` grid: combine within the slice, cross the slow tier
  once with combined data (by default only at the slice count
  ``$SMI_TPU_HIER_MIN_SLICES`` names);
- ``precision=`` narrows a float ADD ``allreduce``'s contribution to
  bf16, int8 or top-k before either tier runs, with error feedback per
  call site and rank;
- :func:`all_to_all` in its pairwise, Bruck and two-tier forms, all pure
  routing.

Where no pin and no environment variable decides, each knob asks the
plan engine (:mod:`smi_tpu_torch.tuning`) at the JAX package's place in
its ladder: a measured plan-cache entry for this device kind, payload
bucket and topology (on an H100, the card's own sweeps), then the
alpha-beta model where it is confident, then the heuristic (the byte
threshold for rs+ag; flat, dense, pairwise and one chunk otherwise).
Every rank asks alike and gets the engine's one answer. A consult never
raises: a broken cache costs tuning, never a call.
"""

from __future__ import annotations

import math
import os
import sys
import threading
from typing import Optional, Tuple, Union

import torch

from smi_tpu_torch.kernels import ring as _kring
from smi_tpu_torch.kernels.ring import check_chunks as _check_chunks
from smi_tpu_torch.ops.types import SmiOp
from smi_tpu_torch.parallel.backend import check_backend
from smi_tpu_torch.parallel.mesh import Communicator
from smi_tpu_torch.tuning import cost_model as cm
from smi_tpu_torch.tuning import engine as _engine
from smi_tpu_torch.tuning.engine import dtype_name
from smi_tpu_torch.utils.watchdog import Deadline


def _check_deadline(deadline: Optional[Deadline], family: str,
                    comm: Communicator) -> None:
    """Ring-tier watchdog gate: an expired deadline raises
    ``WatchdogTimeout`` before the collective is dispatched, carrying the
    protocol's per-rank state mirror
    (:func:`smi_tpu_torch.parallel.faults.mirror_state_provider`) as text
    and, structured, on ``.state`` — so the caller can hand the error
    straight to :func:`smi_tpu_torch.parallel.recovery.
    recover_communicator` for a shrink-and-retry."""
    if deadline is None:
        return
    from smi_tpu_torch.parallel.faults import mirror_state_provider

    deadline.with_provider(
        mirror_state_provider(family, comm.size, structured=True)
    ).check(f"ring {family} over {comm.size} ranks")


def _stream_for(port: Optional[int], program, family: str) -> int:
    """Stream slot of a collective's port — the runtime consumer of the
    program model's port->stream deal (``ops/program.py``): ring
    collectives on distinct streams use distinct flag domains, so they
    cannot disturb each other.

    With a program, a declared stream slot beyond the ring tier's domain
    count is a loud error. Without a program the port wraps modulo the
    domain count (nothing declares which collectives may run at once, so
    ports >= RING_STREAMS may alias; declare a program for the
    guarantee).
    """
    from smi_tpu_torch.ops.operations import OUT_DATA

    if port is None:
        return 0
    if program is not None:
        op = program.find(family, port)
        if op is not None:
            stream = program.stream_of(op, OUT_DATA)
            if stream >= _kring.RING_STREAMS:
                raise ValueError(
                    f"{family} port {port} was dealt to stream {stream}, "
                    f"beyond the ring tier's {_kring.RING_STREAMS} flag "
                    f"domains; reduce the program's num_streams or the "
                    f"concurrent-collective count"
                )
            return stream
    return port % _kring.RING_STREAMS


def _is_root(comm: Communicator, root: int) -> bool:
    if not (0 <= root < comm.size):
        raise ValueError(
            f"root={root} out of range for comm size {comm.size}"
        )
    return comm.rank == root


def _masked(x: torch.Tensor, keep: bool) -> torch.Tensor:
    return x if keep else torch.zeros_like(x)


# ---------------------------------------------------------------------------
# The algorithm knobs and their gates
# ---------------------------------------------------------------------------

#: Bytes a rank at or above which an ADD ``allreduce`` on the ``"xla"``
#: tier takes reduce-scatter + all-gather: each link then carries
#: ``2(n-1)/n`` of the payload. The decomposition reassociates the sum,
#: so it is gated on size (and on ``rs_ag=``), never applied to small
#: payloads silently.
RS_AG_MIN_BYTES = 1 << 20

#: Explicit byte-count override of the rs+ag switch (the operator's
#: word; a malformed value is a loud error).
RS_AG_ENV = "SMI_TPU_RS_AG_MIN_BYTES"

#: Explicit slice-count override of the hierarchical allreduce gate: an
#: eligible allreduce on a hybrid grid of at least this many slices
#: takes the two-tier form. Malformed values are a loud error.
HIER_MIN_SLICES_ENV = "SMI_TPU_HIER_MIN_SLICES"

#: Explicit algorithm override for :func:`all_to_all`.
ALLTOALL_ALGO_ENV = "SMI_TPU_ALLTOALL_ALGO"

#: The algorithms :func:`all_to_all` accepts.
ALLTOALL_ALGORITHMS = ("pairwise", "bruck", "hierarchical")

#: Explicit wire-precision override for :func:`allreduce`.
ALLREDUCE_PRECISION_ENV = "SMI_TPU_ALLREDUCE_PRECISION"

#: The wire precisions :func:`allreduce` accepts: dense f32 (the
#: default), bf16, int8 (symmetric scale and cast) and top-k.
ALLREDUCE_PRECISIONS = ("f32", "bf16", "int8", "topk")

#: The share of a contribution's elements that ``precision="topk"``
#: keeps (the largest by magnitude).
SPARSE_TOPK_DENSITY = 1.0 / 16.0

#: Error-feedback residuals of the lossy precisions, keyed by call site,
#: precision, shape, dtype and rank: what this call's rounding dropped is
#: added to the next contribution of the same key, so the bias of
#: repeated quantised reductions decays. The rank is in the key because
#: a ``LocalWorld``'s rank threads share this module and call sites.
_ERROR_FEEDBACK: dict = {}
_ERROR_FEEDBACK_MAX_SITES = 256
_ERROR_FEEDBACK_LOCK = threading.Lock()


def _env_int(name: str, what: str) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"${name} must be an integer {what}, got "
                         f"{raw!r}") from None


def _env_choice(name: str, choices) -> Optional[str]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    if raw not in choices:
        raise ValueError(f"${name} must be one of {choices}, got {raw!r}")
    return raw


def _hier_env_min_slices() -> Optional[int]:
    """$SMI_TPU_HIER_MIN_SLICES as an int, None when unset; loud on a
    malformed value or one below 2."""
    value = _env_int(HIER_MIN_SLICES_ENV, "slice count")
    if value is not None and value < 2:
        raise ValueError(
            f"${HIER_MIN_SLICES_ENV} must be >= 2 (a pod tiers over "
            f"at least two slices; set a large value to pin the flat "
            f"form), got {value}"
        )
    return value


def _rs_ag_env_bytes() -> Optional[int]:
    """$SMI_TPU_RS_AG_MIN_BYTES as an int, None when unset; loud on a
    malformed or negative value."""
    value = _env_int(RS_AG_ENV, "byte count")
    if value is not None and value < 0:
        raise ValueError(f"${RS_AG_ENV} must be >= 0, got {value}")
    return value


def rs_ag_min_bytes() -> int:
    """The resolved rs+ag switch: ``$SMI_TPU_RS_AG_MIN_BYTES`` when set,
    else the plan cache's measured/seeded threshold entry for this
    device kind, else :data:`RS_AG_MIN_BYTES`. Never raises."""
    env = _rs_ag_env_bytes()
    if env is not None:
        return env
    try:
        return int(_engine.get_engine().rs_ag_threshold()[0])
    except Exception:
        return RS_AG_MIN_BYTES


def _check_precision_eligible(precision: str, x: torch.Tensor, op: SmiOp,
                              source: str) -> None:
    """A lossy pin on a MAX/MIN or integer allreduce is a loud error,
    never a silent dense fallback. ``source`` names who asked."""
    if precision == "f32":
        return
    if op is not SmiOp.ADD:
        raise ValueError(
            f"{source} needs an ADD allreduce — compensated rounding "
            f"is defined only for additive reduction; got op "
            f"{op.name} (drop the precision pin or the op)"
        )
    if not x.dtype.is_floating_point:
        raise ValueError(
            f"{source} needs a floating-point payload — quantizing an "
            f"integer reduction silently changes its semantics; got "
            f"dtype {x.dtype} (drop the precision pin or cast)"
        )


def _resolve_precision(precision: Optional[str], x: torch.Tensor,
                       comm: Communicator, op: SmiOp) -> str:
    """The wire precision of one allreduce: an explicit ``precision=``
    decides alone (checked loudly), then the env override (the same
    checks), then the auto path: ineligible ops and dtypes stay dense
    silently, else the plan engine's ladder — measured cache entry ->
    measured crossover threshold -> model (inert: its margin equals the
    int8 byte ratio) -> dense f32. Never raises."""
    if precision is not None:
        if precision not in ALLREDUCE_PRECISIONS:
            raise ValueError(
                f"precision must be one of {ALLREDUCE_PRECISIONS}, "
                f"got {precision!r}"
            )
        _check_precision_eligible(precision, x, op,
                                  f"precision={precision!r}")
        return precision
    env = _env_choice(ALLREDUCE_PRECISION_ENV, ALLREDUCE_PRECISIONS)
    if env is not None:
        _check_precision_eligible(
            env, x, op, f"${ALLREDUCE_PRECISION_ENV}={env!r}"
        )
        return env
    if op is not SmiOp.ADD or x.dim() == 0 or not x.dtype.is_floating_point:
        return "f32"
    topo = cm.topology_from_comm(comm)
    try:
        return _engine.planned_precision(
            x.numel() * x.element_size(), topo.n, topo.inner or 1,
            topo.outer or 0, dtype_name(x.dtype))
    except Exception:
        return "f32"


def _quantize(y: torch.Tensor, precision: str) -> torch.Tensor:
    """Scale-and-cast of one lossy precision, applied to the local
    contribution before the collective: bf16 rounds to bfloat16 and back;
    int8 rounds onto 127 levels a side of the largest magnitude; topk
    keeps the elements at least as large in magnitude as the k-th largest
    (k = ``ceil(size * SPARSE_TOPK_DENSITY)``) and zeros the rest, and is
    the identity where k covers every element."""
    if precision == "bf16":
        return y.to(torch.bfloat16).to(y.dtype)
    if precision == "int8":
        peak = y.abs().max().to(torch.float32)
        # a divisor on the tensor's device (a fill, no copy from the
        # host): CUDA divides by a host scalar as a multiply by its
        # reciprocal
        scale = peak / torch.full_like(peak, 127.0)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(y.to(torch.float32) / scale),
                        -127.0, 127.0)
        return (q * scale).to(y.dtype)
    if precision == "topk":
        size = y.numel()
        if size == 0:
            return y
        k = max(1, int(math.ceil(size * SPARSE_TOPK_DENSITY)))
        if k >= size:
            return y
        magnitude = y.to(torch.float32).abs()
        threshold = torch.topk(magnitude.reshape(-1), k).values[-1]
        return torch.where(magnitude >= threshold, y, torch.zeros_like(y))
    raise ValueError(f"no lossy lowering for precision {precision!r}")


def _error_feedback_key(precision: str, x: torch.Tensor,
                        rank: int) -> tuple:
    """The first frame outside this module (the caller's allreduce call
    site), the precision, shape and dtype, and the rank."""
    frame = sys._getframe(1)
    while frame is not None and frame.f_code.co_filename == __file__:
        frame = frame.f_back
    site = (("<unknown>", 0) if frame is None
            else (frame.f_code.co_filename, frame.f_lineno))
    return site + (precision, tuple(x.shape), str(x.dtype), rank)


def _compensated_quantize(x: torch.Tensor, precision: str,
                          rank: int = 0) -> torch.Tensor:
    """:func:`_quantize` with error feedback: the residual the last call
    of this key dropped is added before rounding, and this call's is
    stored. The port always runs eagerly, so it compensates from a call
    site's second call on (the JAX package does only outside a trace)."""
    key = _error_feedback_key(precision, x, rank)
    with _ERROR_FEEDBACK_LOCK:
        residual = _ERROR_FEEDBACK.get(key)
    y = x if residual is None else x + residual
    q = _quantize(y, precision)
    with _ERROR_FEEDBACK_LOCK:
        if (key not in _ERROR_FEEDBACK
                and len(_ERROR_FEEDBACK) >= _ERROR_FEEDBACK_MAX_SITES):
            _ERROR_FEEDBACK.clear()   # a bound on sites, not an LRU
        _ERROR_FEEDBACK[key] = y - q
    return q


def error_feedback_reset() -> None:
    """Drop every stored error-feedback residual (also the right call
    after a topology or model-state reset)."""
    with _ERROR_FEEDBACK_LOCK:
        _ERROR_FEEDBACK.clear()


def _use_rs_ag(x: torch.Tensor, comm: Communicator, op: SmiOp,
               rs_ag: Optional[bool]) -> bool:
    """Whether an allreduce takes reduce-scatter + all-gather. Eligible:
    ADD, a leading dim that the comm size divides, a row a rank. The
    decision is ``rs_ag`` when given, else ``$SMI_TPU_RS_AG_MIN_BYTES``
    alone when set, else the plan engine's gate (measured cache entry
    -> confident model -> the resolved threshold, :func:`rs_ag_min_bytes`);
    with the engine unreachable, the plain :data:`RS_AG_MIN_BYTES`
    comparison."""
    if op is not SmiOp.ADD or x.dim() == 0:
        if rs_ag:
            raise ValueError(
                "rs_ag=True needs an ADD allreduce over an array payload"
            )
        return False
    eligible = x.shape[0] % comm.size == 0 and x.shape[0] >= comm.size
    if rs_ag is not None:
        if rs_ag and not eligible:
            raise ValueError(
                f"rs_ag=True needs leading dim divisible by comm size "
                f"{comm.size}; got shape {tuple(x.shape)}"
            )
        return rs_ag
    if not eligible:
        return False
    payload = x.numel() * x.element_size()
    env = _rs_ag_env_bytes()   # loud on malformed — before the engine
    try:
        return _engine.planned_rs_ag(payload, comm.size, dtype_name(x.dtype),
                                     threshold=env)
    except Exception:
        return payload >= (RS_AG_MIN_BYTES if env is None else env)


def _use_hierarchical(x: torch.Tensor, comm: Communicator, op: SmiOp,
                      hierarchical: Optional[bool],
                      rs_ag: Optional[bool],
                      chunks: Optional[int] = None) -> bool:
    """Whether an allreduce takes the two-tier form. Eligible: ADD on a
    hybrid grid of at least two slices whose leading dim the slice size
    divides. The decision is ``hierarchical`` when given (True checked
    loudly, and in conflict with any ``rs_ag`` pin), else flat when
    ``rs_ag`` or an explicit ``chunks`` pipeline is pinned, else the
    slice count against ``$SMI_TPU_HIER_MIN_SLICES`` alone when set, else
    the plan engine's gate (measured cache entry -> measured crossover
    -> confident model -> flat). Never raises past the loud checks."""
    if hierarchical and rs_ag is not None:
        if rs_ag:
            raise ValueError(
                "hierarchical=True and rs_ag=True are competing "
                "decompositions of one allreduce — pick one (the "
                "hierarchical form already reduce-scatters within the "
                "slice)"
            )
        raise ValueError(
            "hierarchical=True conflicts with rs_ag=False: rs_ag="
            "False pins the single bit-exact all-reduce, which the "
            "two-tier decomposition would reassociate — drop one pin"
        )
    topo = cm.topology_from_comm(comm)
    eligible = topo.hierarchical_eligible
    inner = topo.inner or 1
    if hierarchical:
        if not eligible:
            raise ValueError(
                f"hierarchical=True needs a multi-slice hybrid "
                f"communicator (a 2-axis grid with a 'dcn' outer "
                f"axis of >= 2 slices); got axes {comm.axis_names} "
                f"with sizes {comm.axis_sizes}"
            )
        if op is SmiOp.ADD:
            if x.dim() == 0 or x.shape[0] % inner:
                raise ValueError(
                    f"hierarchical=True needs a leading dim divisible "
                    f"by the inner (ICI) axis size {inner}; got shape "
                    f"{tuple(x.shape)}"
                )
        return True
    if hierarchical is not None or rs_ag is not None:
        return False
    if chunks is not None and chunks != 1:
        return False
    if (op is not SmiOp.ADD or not eligible or x.dim() == 0
            or x.shape[0] % inner or x.shape[0] < inner):
        return False
    min_slices = _hier_env_min_slices()   # loud on malformed — first
    if min_slices is not None:
        return topo.outer >= min_slices
    try:
        return _engine.planned_hierarchical(
            x.numel() * x.element_size(), topo.n, inner, topo.outer,
            dtype_name(x.dtype))
    except Exception:
        return False


def _resolve_chunks(chunks: Optional[int], x: torch.Tensor,
                    comm: Communicator, family: str) -> int:
    """The chunk count of a collective: an explicit int, checked and
    used as is (``chunks=1`` is one collective, not "ask the engine"),
    else the plan cache's entry for this family, payload bucket, dtype,
    device kind and rank count, else 1. Never raises past the check."""
    if chunks is not None:
        return _check_chunks(chunks)
    try:
        payload = x.numel() * x.element_size() if x.dim() else 0
        return _check_chunks(_engine.planned_chunks(
            family, payload, comm.size, dtype_name(x.dtype)))
    except Exception:
        return 1


# ---------------------------------------------------------------------------
# Chunked software pipelining
# ---------------------------------------------------------------------------


def _chunk_bounds(total: int, chunks: int):
    """Balanced contiguous split of ``[0, total)`` into at most
    ``chunks`` non-empty ranges (``np.array_split``'s law: the first
    ``total % k`` chunks get one extra element). ``chunks`` beyond
    ``total`` clamps — a chunk is at least one element."""
    k = max(1, min(chunks, total))
    q, r = divmod(total, k)
    bounds, start = [], 0
    for i in range(k):
        size = q + (1 if i < r else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def _pipelined(x: torch.Tensor, chunks: int, emit) -> torch.Tensor:
    """Emit one collective per leading-axis chunk and reassemble.
    Identity transform for ``chunks=1``, scalars, and 1-row payloads."""
    if chunks <= 1 or x.dim() == 0 or x.shape[0] <= 1:
        return emit(x)
    bounds = _chunk_bounds(x.shape[0], chunks)
    if len(bounds) <= 1:
        return emit(x)
    return torch.cat([emit(x[s:e]) for s, e in bounds], dim=0)


def _reassemble_rank_major(pieces, bounds, size: int) -> torch.Tensor:
    """Rank-major reassembly of per-chunk tiled gathers.

    Each ``pieces[i]`` is a ``(size * n_i, ...)`` gather of chunk ``i``
    (rank-interleaved chunk-major); the unchunked layout wants rank
    ``r``'s full contribution contiguous, i.e. the concatenation of its
    slice of every chunk's gather. Shared by both gather tiers so the
    two epilogues cannot diverge.
    """
    rows = []
    for r in range(size):
        for piece, (s, e) in zip(pieces, bounds):
            ni = e - s
            rows.append(piece[r * ni:(r + 1) * ni])
    return torch.cat(rows, dim=0)


def _chunked_gather(x: torch.Tensor, size: int, chunks: int, gather_one):
    """Tiled all-gather in leading-axis chunks, ``gather_one(piece)``
    each, reassembled rank-major: bit-identical to one gather."""
    total = x.shape[0] if x.dim() else 1
    bounds = (_chunk_bounds(total, chunks)
              if chunks > 1 and x.dim() else [(0, total)])
    if len(bounds) <= 1:
        return gather_one(x)
    pieces = [gather_one(x[s:e]) for s, e in bounds]
    return _reassemble_rank_major(pieces, bounds, size)


def _chunked_scatter(x: torch.Tensor, size: int, chunks: int, scatter_one):
    """Tiled reduce-scatter in chunks of the per-destination block.

    ``x`` is ``(size * count, ...)``; chunking splits the ``count`` dim
    (NOT the raw leading dim — a naive split would misalign the
    rank-interleaved destination blocks) and scatters each column range
    with ``scatter_one``; results concatenate back in block order.
    """
    count = x.shape[0] // size
    bounds = _chunk_bounds(count, chunks) if chunks > 1 else [(0, count)]
    if len(bounds) <= 1:
        return scatter_one(x)
    xu = x.reshape((size, count) + tuple(x.shape[1:]))
    parts = [
        scatter_one(xu[:, s:e].reshape((size * (e - s),)
                                       + tuple(x.shape[1:])))
        for s, e in bounds
    ]
    return torch.cat(parts, dim=0)


def _rs_ag_allreduce(x: torch.Tensor, comm: Communicator,
                     chunks: int) -> torch.Tensor:
    """Bandwidth-optimal ADD all-reduce: reduce-scatter, then all-gather,
    over the whole grid. A chunked one pipelines both phases per column
    range of the ``(size, count)`` view."""
    size = comm.size
    count = x.shape[0] // size
    tail = tuple(x.shape[1:])
    bounds = _chunk_bounds(count, chunks) if chunks > 1 else [(0, count)]
    xu = x.reshape((size, count) + tail)
    gathered = []
    for s, e in bounds:
        piece = xu[:, s:e].reshape((size * (e - s),) + tail)
        shard = comm.reduce_scatter(piece, SmiOp.ADD)
        gathered.append(comm.all_gather(shard).reshape(
            (size, e - s) + tail))
    out = gathered[0] if len(gathered) == 1 else torch.cat(gathered, dim=1)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def bcast(x: torch.Tensor, comm: Communicator, root: int = 0,
          port: Optional[int] = None, backend: str = "xla",
          program=None, deadline: Optional[Deadline] = None,
          chunks: Optional[int] = None,
          hierarchical: Optional[bool] = None) -> torch.Tensor:
    """One-to-all: every rank returns the root's ``x``.

    Reference: ``SMI_Bcast``. A single masked all-reduce whose only
    non-zero contribution is the root's value; under ``backend="ring"``
    it circulates around the explicit credit-controlled ring.
    ``hierarchical=True`` takes the two-tier slice-leader tree on a
    hybrid grid (:func:`bcast_hierarchical`, bit-identical); rooted
    collectives keep the flat form by default.
    """
    check_backend(backend)
    if hierarchical:
        _check_hierarchical_rooted(backend, chunks, "bcast")
        return bcast_hierarchical(x, comm, root=root)
    chunks = _resolve_chunks(chunks, x, comm, "broadcast")
    contrib = _masked(x, _is_root(comm, root))
    if backend == "ring":
        _check_deadline(deadline, "broadcast", comm)
        return _kring.ring_all_reduce(
            contrib, comm, op=SmiOp.ADD,
            stream=_stream_for(port, program, "broadcast"), chunks=chunks,
        )
    # on this tier the port is metadata only
    return _pipelined(contrib, chunks,
                      lambda piece: comm.all_reduce(piece, SmiOp.ADD))


def reduce(x: torch.Tensor, comm: Communicator,
           op: Union[str, SmiOp] = SmiOp.ADD, root: int = 0,
           port: Optional[int] = None, all_ranks: bool = False,
           backend: str = "xla", program=None,
           deadline: Optional[Deadline] = None,
           chunks: Optional[int] = None,
           hierarchical: Optional[bool] = None) -> torch.Tensor:
    """All-to-one reduction with ADD/MAX/MIN.

    Reference: ``SMI_Reduce``: every rank contributes, only the root
    receives the result (zeros elsewhere here). With ``all_ranks=True``
    behaves as an allreduce (no masking) — the fused Reduce+Bcast idiom
    of kmeans without the second collective. ``backend="ring"`` runs the
    circulating-partial ring kernel. ``hierarchical=True`` combines
    within each slice of a hybrid grid first, then crosses the slow tier
    once with the slice partials (:func:`reduce_hierarchical`).
    """
    check_backend(backend)
    op = SmiOp.parse(op)
    if hierarchical:
        _check_hierarchical_rooted(backend, chunks, "reduce")
        return reduce_hierarchical(x, comm, op=op, root=root,
                                   all_ranks=all_ranks)
    chunks = _resolve_chunks(chunks, x, comm, "reduce")
    root_here = _is_root(comm, root)
    if backend == "ring":
        _check_deadline(deadline, "reduce", comm)
        out = _kring.ring_all_reduce(
            x, comm, op=op, stream=_stream_for(port, program, "reduce"),
            chunks=chunks,
        )
    else:
        out = _pipelined(x, chunks, lambda p: comm.all_reduce(p, op))
    return out if all_ranks else _masked(out, root_here)


def allreduce(x: torch.Tensor, comm: Communicator,
              op: Union[str, SmiOp] = SmiOp.ADD,
              backend: str = "xla", program=None,
              deadline: Optional[Deadline] = None,
              chunks: Optional[int] = None,
              rs_ag: Optional[bool] = None,
              hierarchical: Optional[bool] = None,
              precision: Optional[str] = None) -> torch.Tensor:
    """Reduce + Bcast in one collective.

    Four algorithm knobs, as in the JAX package: ``chunks`` pipelines the
    payload (bit-identical); ``rs_ag`` forces the reduce-scatter +
    all-gather form on or off (by default it runs from
    :func:`rs_ag_min_bytes` a rank, ADD only); ``hierarchical`` takes the
    two-tier form on a hybrid grid (:func:`allreduce_hierarchical`; by
    default only where ``$SMI_TPU_HIER_MIN_SLICES`` asks for it);
    ``precision`` narrows a float ADD contribution
    (:data:`ALLREDUCE_PRECISIONS`) before either tier runs, with error
    feedback per call site and rank (:func:`_compensated_quantize`), and
    is loud on an ineligible op or dtype. Both decompositions reassociate
    a float sum (ints stay exact). ``rs_ag`` and ``hierarchical`` are
    compositions of the ``"xla"`` tier: forcing one on the ring tier is an
    error.
    """
    check_backend(backend)
    op = SmiOp.parse(op)
    resolved_precision = _resolve_precision(precision, x, comm, op)
    if resolved_precision != "f32":
        x = _compensated_quantize(x, resolved_precision, comm.rank)
    if backend != "xla":
        # a forced decomposition must never be silently dropped
        if rs_ag:
            raise ValueError(
                "rs_ag=True is an XLA-tier decomposition; the ring tier "
                "runs the circulating-partial kernel — drop rs_ag or use "
                "backend='xla'"
            )
        if hierarchical:
            raise ValueError(
                "hierarchical=True is an XLA-tier composition; the ring "
                "tier runs the circulating-partial kernel — drop "
                "hierarchical or use backend='xla'"
            )
    elif _use_hierarchical(x, comm, op, hierarchical, rs_ag, chunks):
        if chunks is not None and chunks != 1:
            raise ValueError(
                "chunks= does not compose with the hierarchical "
                "allreduce (its three phases are already a pipeline); "
                "drop chunks or pin hierarchical=False"
            )
        return allreduce_hierarchical(x, comm, op=op)
    chunks = _resolve_chunks(chunks, x, comm, "all_reduce")
    if backend == "xla" and _use_rs_ag(x, comm, op, rs_ag):
        return _rs_ag_allreduce(x, comm, chunks)
    return reduce(x, comm, op=op, all_ranks=True, backend=backend,
                  program=program, deadline=deadline, chunks=chunks)


# ---------------------------------------------------------------------------
# Two-tier collectives on a hybrid ("dcn", "ici") grid
# ---------------------------------------------------------------------------


def _check_hierarchical_rooted(backend: str, chunks: Optional[int],
                               family: str) -> None:
    if backend != "xla":
        raise ValueError(
            "hierarchical=True is an XLA-tier composition; drop "
            "it or use backend='xla'"
        )
    if chunks is not None and chunks != 1:
        raise ValueError(
            f"chunks= does not compose with the hierarchical "
            f"{family}; drop chunks or hierarchical"
        )


def _hier_axes(comm: Communicator, inner: Optional[str],
               outer: Optional[str]) -> Tuple[str, str]:
    """The (outer, inner) tier axes of a hybrid grid: the grid's two
    axes in order by default."""
    if len(comm.axis_names) != 2 and (inner is None or outer is None):
        raise ValueError(
            "a hierarchical collective needs a 2-axis communicator or "
            "explicit inner=/outer= axis names"
        )
    outer = outer if outer is not None else comm.axis_names[0]
    inner = inner if inner is not None else comm.axis_names[1]
    if inner == outer:
        raise ValueError(
            f"inner and outer tiers must be distinct axes, got "
            f"{inner!r} for both"
        )
    for name in (inner, outer):
        if name not in comm.axis_names:
            raise ValueError(
                f"axis {name!r} not in mesh axes {comm.axis_names}"
            )
    return outer, inner


def allreduce_hierarchical(x: torch.Tensor, comm: Communicator,
                           op: Union[str, SmiOp] = SmiOp.ADD,
                           inner: Optional[str] = None,
                           outer: Optional[str] = None) -> torch.Tensor:
    """Two-tier allreduce: reduce-scatter within the slice (``inner``),
    reduce the shards across slices (``outer``: each shard crosses the
    slow tier once, at 1/per_slice of the volume), all-gather within the
    slice. MAX/MIN have no scatter form: they reduce over ``inner``, then
    ``outer``. ``x``'s leading dim must be divisible by the inner axis
    size for ADD."""
    outer, inner = _hier_axes(comm, inner, outer)
    op = SmiOp.parse(op)
    if op is not SmiOp.ADD:
        return comm.all_reduce(comm.all_reduce(x, op, inner), op, outer)
    inner_size = comm.shape[comm._axis(inner)]
    if x.dim() == 0 or x.shape[0] % inner_size != 0:
        raise ValueError(
            f"leading dim {x.shape[0] if x.dim() else '()'} not "
            f"divisible by inner axis size {inner_size}"
        )
    shard = comm.reduce_scatter(x, SmiOp.ADD, inner)
    shard = comm.all_reduce(shard, SmiOp.ADD, outer)
    return comm.all_gather(shard, inner)


def bcast_hierarchical(x: torch.Tensor, comm: Communicator, root: int = 0,
                       inner: Optional[str] = None,
                       outer: Optional[str] = None) -> torch.Tensor:
    """Two-tier one-to-all: the root's value is shared within its slice
    (a masked sum over ``inner``), then crosses the slow tier once per
    position (a sum over ``outer``). Pure routing: bit-identical to the
    flat bcast for every dtype."""
    outer, inner = _hier_axes(comm, inner, outer)
    contrib = _masked(x, _is_root(comm, root))
    return comm.all_reduce(comm.all_reduce(contrib, SmiOp.ADD, inner),
                           SmiOp.ADD, outer)


def reduce_hierarchical(x: torch.Tensor, comm: Communicator,
                        op: Union[str, SmiOp] = SmiOp.ADD,
                        root: int = 0, all_ranks: bool = False,
                        inner: Optional[str] = None,
                        outer: Optional[str] = None) -> torch.Tensor:
    """Two-tier all-to-one: each slice combines over ``inner``, then the
    slice partials cross ``outer`` once; masked to the root unless
    ``all_ranks``. ADD reassociates the sum (ints exact), MAX/MIN are
    exact."""
    outer, inner = _hier_axes(comm, inner, outer)
    op = SmiOp.parse(op)
    out = comm.all_reduce(comm.all_reduce(x, op, inner), op, outer)
    return out if all_ranks else _masked(out, _is_root(comm, root))


def scatter(x: torch.Tensor, comm: Communicator, root: int = 0,
            port: Optional[int] = None, backend: str = "xla",
            program=None, deadline: Optional[Deadline] = None,
            chunks: Optional[int] = None) -> torch.Tensor:
    """Root distributes contiguous slices; rank r returns slice r.

    Reference: ``SMI_Scatter``. ``x`` must have leading dimension ``size
    * count`` (valid at root). The root's masked buffer goes through one
    reduce-scatter, so each rank receives only its own slice.
    ``backend="ring"`` uses the ring reduce-scatter kernel; its chunks
    are launches in program order on one stream slot.
    """
    check_backend(backend)
    chunks = _resolve_chunks(chunks, x, comm, "scatter")
    size = comm.size
    if x.dim() == 0 or x.shape[0] % size != 0:
        raise ValueError(
            f"scatter buffer leading dim "
            f"{x.shape[0] if x.dim() else '()'} not divisible by comm "
            f"size {size}"
        )
    contrib = _masked(x, _is_root(comm, root))
    if backend == "ring":
        _check_deadline(deadline, "scatter", comm)
        stream = _stream_for(port, program, "scatter")
        return _chunked_scatter(
            contrib, size, chunks,
            lambda piece: _kring.ring_reduce_scatter(
                piece, comm, op=SmiOp.ADD, stream=stream),
        )
    return _chunked_scatter(
        contrib, size, chunks,
        lambda piece: comm.reduce_scatter(piece, SmiOp.ADD),
    )


def gather(x: torch.Tensor, comm: Communicator, root: int = 0,
           port: Optional[int] = None, all_ranks: bool = False,
           backend: str = "xla", program=None,
           deadline: Optional[Deadline] = None,
           chunks: Optional[int] = None) -> torch.Tensor:
    """Root collects contiguous slices; returns ``size * count`` at root.

    Reference: ``SMI_Gather``. One all-gather, masked off-root (or kept
    everywhere with ``all_ranks=True``). ``backend="ring"`` forwards
    chunks neighbour to neighbour around the explicit ring.
    """
    check_backend(backend)
    chunks = _resolve_chunks(chunks, x, comm, "gather")
    size = comm.size
    root_here = _is_root(comm, root)
    if backend == "ring":
        _check_deadline(deadline, "gather", comm)
        stream = _stream_for(port, program, "gather")
        out = _chunked_gather(
            x, size, chunks,
            lambda piece: _kring.ring_all_gather(piece, comm,
                                                  stream=stream),
        )
    else:
        out = _chunked_gather(x, size, chunks, comm.all_gather)
    return out if all_ranks else _masked(out, root_here)


# ---------------------------------------------------------------------------
# All-to-all
# ---------------------------------------------------------------------------


def _bruck_all_to_all(x: torch.Tensor, comm: Communicator) -> torch.Tensor:
    """Bruck's log-step all-to-all over ``permute`` rounds: a local
    rotation puts the block destined ``(me + i) % n`` at index ``i``,
    round ``k`` forwards every index with bit ``k`` set to rank
    ``me + 2^k``, and the inverse rotation restores source order. Pure
    routing, ``log2 n`` rounds of ``n/2`` blocks; ``n`` must be a power
    of two (checked by the caller)."""
    size = comm.size
    count = x.shape[0] // size
    tail = tuple(x.shape[1:])
    xu = x.reshape((size, count) + tail)
    me = comm.rank
    idx = torch.arange(size, device=x.device)
    buf = xu[(idx + me) % size]
    hop = 1
    while hop < size:
        # the indices with bit ``hop`` set, in order: a view of buf
        sent = buf.view((size // (2 * hop), 2, hop, count) + tail)[:, 1]
        perm = [(s, (s + hop) % size) for s in range(size)]
        moved = comm.permute(sent.reshape((size // 2, count) + tail), perm)
        sent.copy_(moved.view(sent.shape))
        hop <<= 1
    return buf[(me - idx) % size].reshape(x.shape)


def alltoall_hierarchical(x: torch.Tensor, comm: Communicator,
                          inner: Optional[str] = None,
                          outer: Optional[str] = None) -> torch.Tensor:
    """Two-tier all-to-all on a hybrid grid. The block from ``(s, i)`` to
    ``(t, j)`` first moves within slice ``s`` to position ``j``, then
    crosses the slow tier once inside column ``j``, bundled with the
    other blocks for slice ``t``: a rank sends ``outer - 1`` messages
    across the slow tier in place of ``(outer - 1) * inner``. Pure
    routing: bit-identical to the flat all-to-all for every dtype.
    ``x``'s leading dim must be ``comm.size * count``."""
    outer, inner = _hier_axes(comm, inner, outer)
    m = comm.shape[comm._axis(outer)]
    k = comm.shape[comm._axis(inner)]
    n = m * k
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(
            f"all_to_all buffer leading dim {tuple(x.shape)} not "
            f"divisible by comm size {n}"
        )
    count = x.shape[0] // n
    tail = tuple(x.shape[1:])
    xu = x.reshape((m, k, count) + tail)
    # phase A (inner): bundle by destination position j, one m*count
    # bundle to slice-mate j
    a = torch.movedim(xu, 1, 0).reshape((k * m * count,) + tail)
    a = comm.all_to_all(a, inner)
    # now [source position][destination slice]: regroup by slice
    au = a.reshape((k, m, count) + tail)
    b = torch.movedim(au, 1, 0).reshape((m * k * count,) + tail)
    # phase B (outer): one k-block bundle per destination slice
    b = comm.all_to_all(b, outer)
    # received [source slice][source position]: rank-major sources
    return b.reshape(x.shape)


def all_to_all(x: torch.Tensor, comm: Communicator,
               algorithm: Optional[str] = None,
               port: Optional[int] = None, backend: str = "xla",
               program=None) -> torch.Tensor:
    """Every rank scatters one block per destination and gathers one
    block per source: ``x``'s leading dim is ``size * count`` (block
    ``r``, rows ``[r*count, (r+1)*count)``, goes to rank ``r``), and the
    result holds the received blocks in source order. The traffic shape
    of MoE expert dispatch, a distributed shuffle and k-means
    reassignment.

    ``algorithm``: ``"pairwise"`` (one all-to-all of the transport),
    ``"bruck"`` (``log2 n`` permute rounds; power-of-two rank counts
    only, anything else a loud error) or ``"hierarchical"`` (the two-tier
    form on a hybrid grid). All three are pure routing and bit-identical.
    ``None`` takes ``$SMI_TPU_ALLTOALL_ALGO`` (loud when malformed and on
    a shape it cannot run), else the plan engine's ladder (a measured
    cache entry this shape can run, then the model where confidently
    away from parity, then ``"pairwise"``).
    The JAX package's credits simulator (``all_to_all_rank``,
    ``all_to_all_bruck_rank`` and ``all_to_all_pod_rank`` in
    ``smi_tpu/parallel/credits.py``) is the wire-level spec of the
    three. The ring tier has no all-to-all kernel, so
    ``backend="ring"`` is a loud error; on this tier the port is
    metadata only.
    """
    check_backend(backend)
    if backend != "xla":
        raise ValueError(
            "all_to_all has no ring-tier kernel yet (the credits "
            "simulator is the executable wire-level reference); use "
            "backend='xla'"
        )
    size = comm.size
    if x.dim() == 0 or x.shape[0] % size or x.shape[0] < size:
        raise ValueError(
            f"all_to_all buffer leading dim {tuple(x.shape)} not "
            f"divisible by comm size {size}"
        )
    algo = algorithm
    if algo is not None:
        if algo not in ALLTOALL_ALGORITHMS:
            raise ValueError(
                f"unknown all_to_all algorithm {algo!r}; known: "
                f"{ALLTOALL_ALGORITHMS}"
            )
    else:
        algo = _env_choice(ALLTOALL_ALGO_ENV, ALLTOALL_ALGORITHMS)
        if algo is None:
            topo = cm.topology_from_comm(comm)
            try:
                algo = _engine.planned_alltoall(
                    x.numel() * x.element_size(), topo.n,
                    topo.inner or topo.n, topo.outer or 1,
                    dtype_name(x.dtype))
            except Exception:
                algo = "pairwise"
    if algo == "bruck":
        if size & (size - 1):
            raise ValueError(
                f"algorithm='bruck' needs a power-of-two comm size, "
                f"got {size} — drop the pin or use pairwise"
            )
        return _bruck_all_to_all(x, comm)
    if algo == "hierarchical":
        return alltoall_hierarchical(x, comm)
    return comm.all_to_all(x)
