"""Multi-host control plane: process bootstrap from a hostfile.

PyTorch counterpart of :mod:`smi_tpu.parallel.bootstrap`. MPI is the
reference's control plane — process launch via the generated hostfile
(``codegen/common.py:15-19``), rank/size from ``MPI_Comm_rank/size``,
host barriers and bulk staging — and the data plane never touches it.
Here the control plane is ``torch.distributed``'s process group, set up
through its TCP store on the coordinator, and the data plane is the
ranks' collectives.

One deliberate difference from the JAX package: a JAX process owns every
chip of its host, so there one process runs per distinct node; a process
of the port drives one card (:func:`~smi_tpu_torch.parallel.mesh.
make_communicator` takes card ``rank % device_count``), so here one
process runs per hostfile LINE (one per rank), and ``num_processes`` is
the line count. Typical launch (any launcher that sets a process id)::

    opts = distributed_options("smi-routes/hostfile", process_id=my_id)
    init_distributed(opts)          # torch.distributed.init_process_group
    comm = make_communicator()      # one rank per process, one card each

The hostfile is the one the JAX package's ``route`` command writes: one
line per rank, host node first, ``#`` comments after.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import time
from typing import Callable, List, Optional, Union

DEFAULT_COORDINATOR_PORT = 8476

#: Retry/backoff defaults for coordinator connection (see
#: :func:`init_distributed`): total deadline, first backoff, cap, and
#: the ± jitter fraction applied to every sleep.
DEFAULT_INIT_DEADLINE_S = 300.0
DEFAULT_INITIAL_BACKOFF_S = 1.0
DEFAULT_MAX_BACKOFF_S = 30.0
DEFAULT_BACKOFF_JITTER = 0.25


class HostfileError(ValueError):
    """A hostfile failed validation; the message says how to fix it."""


class BootstrapTimeout(TimeoutError):
    """Coordinator connection did not succeed within the deadline."""


_RANK_RE = re.compile(r"\brank\s*(\d+)\s*$")


def parse_hostfile(text: str) -> List[str]:
    """Hostfile lines → ordered node list (one entry per rank).

    Mirrors the JAX package's writer (``write_nodefile``): node name
    first, optional ``# device, rankN`` comment. Validation is strict —
    a malformed hostfile must fail *here*, before a launcher grabs a
    pod and hangs on a bad node list:

    - an empty (or comments-only) file raises :class:`HostfileError`;
    - a node entry containing whitespace (two tokens on one line)
      raises — the writer never emits it, it is a hand-edit gone wrong;
    - when rank comments are present, duplicate or non-contiguous rank
      numbers raise (a duplicated rank would silently double-assign a
      process id).

    CRLF line endings and trailing whitespace are tolerated (hostfiles
    get scp'd through Windows-touched tooling).
    """
    nodes: List[str] = []
    ranks: List[Optional[int]] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line, _, comment = raw.partition("#")
        line = line.strip()  # also eats the \r of CRLF files
        if not line:
            continue
        if len(line.split()) != 1:
            raise HostfileError(
                f"hostfile line {lineno}: expected one node name, got "
                f"{line!r} (one rank per line, node first, '#' comments)"
            )
        match = _RANK_RE.search(comment.strip())
        nodes.append(line)
        ranks.append(int(match.group(1)) if match else None)
    if not nodes:
        raise HostfileError(
            "hostfile lists no nodes (empty or comments-only); expected "
            "one line per rank, e.g. 'node-a  # node-a:0, rank0'"
        )
    annotated = [r for r in ranks if r is not None]
    if annotated:
        dupes = sorted({r for r in annotated if annotated.count(r) > 1})
        if dupes:
            raise HostfileError(
                f"hostfile assigns rank(s) {dupes} more than once; each "
                f"rank comment must be unique"
            )
        # even a partially annotated file must not name impossible
        # ranks (a mangled comment on a hand-edited file). Combined
        # with the duplicate check this also forces fully annotated
        # files to be exactly the contiguous set 0..n-1.
        out_of_range = sorted(r for r in annotated if r >= len(nodes))
        if out_of_range:
            raise HostfileError(
                f"hostfile rank comment(s) {out_of_range} out of range "
                f"for {len(nodes)} listed rank(s); ranks must be "
                f"0..{len(nodes) - 1} — regenerate with "
                f"`python -m smi_tpu route`"
            )
    return nodes


@dataclasses.dataclass(frozen=True)
class DistributedOptions:
    """Arguments for the process group's initialisation, derived from
    the hostfile: one process per hostfile line (per rank, one card
    each), coordinator on the first node."""

    coordinator_address: str
    num_processes: int
    process_id: int

    def __post_init__(self):
        if not (0 <= self.process_id < self.num_processes):
            raise ValueError(
                f"process_id {self.process_id} out of range for "
                f"{self.num_processes} processes"
            )


def distributed_options(
    hostfile: Union[str, os.PathLike],
    process_id: Optional[int] = None,
    coordinator_port: int = DEFAULT_COORDINATOR_PORT,
) -> DistributedOptions:
    """Derive the multi-host bootstrap arguments from a hostfile.

    ``hostfile`` is a path or the raw text. Every line (rank) becomes a
    process, in file order: a process of the port drives one card, where
    the JAX package makes one process of each distinct node (whose
    process owns all of the node's chips). The coordinator is the first
    node. ``process_id`` defaults to, in order: ``$SMI_PROCESS_ID``,
    then 0.
    """
    text = hostfile
    if os.path.exists(str(hostfile)):
        with open(hostfile) as f:
            text = f.read()
    nodes = parse_hostfile(str(text))  # raises HostfileError when empty
    if process_id is None:
        process_id = int(os.environ.get("SMI_PROCESS_ID", "0"))
    return DistributedOptions(
        coordinator_address=f"{nodes[0]}:{coordinator_port}",
        num_processes=len(nodes),
        process_id=process_id,
    )


def backoff_schedule(
    initial_backoff_s: float = DEFAULT_INITIAL_BACKOFF_S,
    max_backoff_s: float = DEFAULT_MAX_BACKOFF_S,
    jitter: float = DEFAULT_BACKOFF_JITTER,
    seed: Optional[int] = None,
):
    """Yield sleep durations: exponential growth, capped, ± jitter.

    Jitter decorrelates the retry storms of many hosts restarting at
    once (every rank of a preempted pod reconnects together; without
    jitter they hammer the coordinator in lockstep). ``seed`` makes the
    schedule reproducible for tests; the default seeds from process
    entropy. The generator is infinite — the *caller* owns the total
    deadline.
    """
    rng = random.Random(seed)
    delay = initial_backoff_s
    while True:
        yield max(0.0, delay * (1.0 + jitter * (2.0 * rng.random() - 1.0)))
        delay = min(delay * 2.0, max_backoff_s)


def _init_process_group(coordinator_address: str, num_processes: int,
                        process_id: int,
                        initialization_timeout: float) -> None:
    """``torch.distributed.init_process_group`` over the coordinator's TCP
    store: NCCL when CUDA is available, gloo otherwise."""
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=initialization_timeout),
    )


def init_distributed(
    opts: DistributedOptions,
    total_deadline_s: float = DEFAULT_INIT_DEADLINE_S,
    initial_backoff_s: float = DEFAULT_INITIAL_BACKOFF_S,
    max_backoff_s: float = DEFAULT_MAX_BACKOFF_S,
    jitter: float = DEFAULT_BACKOFF_JITTER,
    initialize: Optional[Callable[..., None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    seed: Optional[int] = None,
) -> None:
    """Initialise the process group with retry, backoff, and a deadline.

    A coordinator that is still booting (or a transiently unroutable
    path) would fail the whole job, and a *hung* connect would stall it
    for ever. Here every attempt gets a per-attempt timeout (the
    remaining budget, ``initialization_timeout=``), failures back off
    exponentially with jitter (:func:`backoff_schedule`), and the total
    budget is a hard deadline: on expiry a :class:`BootstrapTimeout` names the
    coordinator, the attempt count, and the last error. The default
    ``initialize`` is ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator>`` with ``timeout=`` the remaining budget.

    A pool of one process skips initialisation entirely, as in the JAX
    package: there is nobody to wait for. ``initialize`` (called with
    ``coordinator_address``, ``num_processes``, ``process_id`` and, when
    it takes it, ``initialization_timeout``), ``sleep`` and ``clock`` are
    injectable for tests, with the JAX package's calls.
    """
    if opts.num_processes <= 1:
        return
    if initialize is None:
        initialize = _init_process_group

    # probe ONCE whether the initializer takes initialization_timeout=
    # (an injected one may not) — probing per attempt would double every
    # call and make a genuine TypeError from a real bug
    # indistinguishable from the signature gap
    import inspect

    try:
        params = inspect.signature(initialize).parameters
        supports_timeout = "initialization_timeout" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in params.values()
        )
    except (TypeError, ValueError):  # no introspectable signature
        supports_timeout = True

    start = clock()
    attempts = 0
    last_error: Optional[BaseException] = None
    delays = backoff_schedule(
        initial_backoff_s, max_backoff_s, jitter, seed
    )
    while True:
        remaining = total_deadline_s - (clock() - start)
        if remaining <= 0:
            break
        attempts += 1
        kwargs = dict(
            coordinator_address=opts.coordinator_address,
            num_processes=opts.num_processes,
            process_id=opts.process_id,
        )
        if supports_timeout:
            # each attempt gets the REMAINING budget: a hung connect
            # cannot eat more than the total deadline
            kwargs["initialization_timeout"] = max(1, int(remaining))
        try:
            initialize(**kwargs)
            return
        except TypeError as e:
            if supports_timeout and "initialization_timeout" in str(e):
                # signature introspection lied (e.g. a wrapper): drop
                # the kwarg for all further attempts
                supports_timeout = False
                continue
            last_error = e
        except Exception as e:
            last_error = e
        delay = next(delays)
        remaining = total_deadline_s - (clock() - start)
        if remaining <= 0:
            break
        sleep(min(delay, remaining))
    raise BootstrapTimeout(
        f"could not connect to coordinator {opts.coordinator_address} as "
        f"process {opts.process_id}/{opts.num_processes} within "
        f"{total_deadline_s:.3g}s ({attempts} attempts); last error: "
        f"{type(last_error).__name__ if last_error else 'none'}: "
        f"{last_error}"
    )
