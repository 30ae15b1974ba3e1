"""The SMI operation taxonomy.

Reference parity: ``codegen/ops.py:24-210``. Every communication primitive a
program uses is declared (or discovered by the manifest tool) as one
``SmiOperation`` carrying its logical *port*, element *dtype*, and tuning
knobs. The collection of operations is what the reference calls a per-rank
*program*; here it drives:

- validation (port uniqueness per operation family,
  ``codegen/program.py:37-50``),
- assignment of logical ports onto *streams* — the counterpart of the
  reference's four physical QSFP channels (``codegen/program.py:53-80``) —
  which decides which concurrent collectives may overlap and which ring
  direction a P2P port prefers,
- chunking/pipelining depth for streamed transfers (the ``buffer_size`` /
  "asynchronicity degree" knob, ``codegen/ops.py:42-54``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional, Type, Union

from smi_tpu_torch.ops.types import (
    SmiDtype,
    SmiOp,
    buffer_size_to_packets,
    elements_per_packet,
)

#: Stream-usage classes. The reference distinguishes the four per-op hardware
#: FIFO groups ``{cks,ckr}_{data,control}`` (``codegen/ops.py:30-37``); here
#: the same four keys name *virtual streams*: out/in × payload/flow-control.
OUT_DATA = "out_data"
OUT_CTRL = "out_ctrl"
IN_DATA = "in_data"
IN_CTRL = "in_ctrl"
ALL_STREAM_KEYS = (OUT_DATA, OUT_CTRL, IN_DATA, IN_CTRL)

#: Default pipelining depth (in packets) when a channel does not specify an
#: asynchronicity degree — matches the reference's default channel depth
#: (``codegen/ops.py:42-54``).
DEFAULT_BUFFER_PACKETS = 16


def pipeline_depth_packets(buffer_size: Optional[int], dtype) -> int:
    """In-flight chunk budget for a channel: the declared asynchronicity
    degree rounded as the reference rounds it, or the default depth.

    Single source of truth for both the program model and the runtime
    channel implementation."""
    if buffer_size is None:
        return DEFAULT_BUFFER_PACKETS
    return buffer_size_to_packets(buffer_size, dtype)


@dataclasses.dataclass(frozen=True)
class SmiOperation:
    """One declared communication op at a logical port.

    Subclasses define ``NAME`` (the JSON/manifest tag) and ``STREAMS`` (which
    virtual streams the op occupies — used by the port allocator to spread
    concurrent ops across streams the way the reference round-robins hardware
    ports across its 4 QSFP channels).
    """

    port: int
    dtype: SmiDtype = SmiDtype.FLOAT
    buffer_size: Optional[int] = None  # elements; None = default depth

    NAME: str = dataclasses.field(default="op", init=False, repr=False)
    STREAMS: FrozenSet[str] = dataclasses.field(
        default=frozenset(), init=False, repr=False
    )

    def __post_init__(self):
        if self.port < 0:
            raise ValueError(f"port must be non-negative, got {self.port}")
        object.__setattr__(self, "dtype", SmiDtype.parse(self.dtype))

    @property
    def pipeline_packets(self) -> int:
        """In-flight chunk budget for streamed transfers."""
        return pipeline_depth_packets(self.buffer_size, self.dtype)

    @property
    def elements_per_chunk(self) -> int:
        return elements_per_packet(self.dtype)

    def streams(self, rendezvous: bool = True) -> FrozenSet[str]:
        """Virtual streams this op occupies (``codegen/ops.py:82-92``:
        P2P ops drop their flow-control stream under the eager protocol)."""
        del rendezvous
        return self.STREAMS

    # Identity used for validation: ops conflict if same family+port.
    @property
    def family(self) -> str:
        return self.NAME


@dataclasses.dataclass(frozen=True)
class Push(SmiOperation):
    """P2P send endpoint (``include/smi/push.h``, ``templates/push.cl``)."""

    NAME = "push"
    STREAMS = frozenset({OUT_DATA, IN_CTRL})  # data out, credits back in

    def streams(self, rendezvous: bool = True) -> FrozenSet[str]:
        return self.STREAMS if rendezvous else frozenset({OUT_DATA})


@dataclasses.dataclass(frozen=True)
class Pop(SmiOperation):
    """P2P receive endpoint (``include/smi/pop.h``, ``templates/pop.cl``)."""

    NAME = "pop"
    STREAMS = frozenset({IN_DATA, OUT_CTRL})

    def streams(self, rendezvous: bool = True) -> FrozenSet[str]:
        return self.STREAMS if rendezvous else frozenset({IN_DATA})


@dataclasses.dataclass(frozen=True)
class Broadcast(SmiOperation):
    """One-to-all (``include/smi/bcast.h``, ``templates/bcast.cl``)."""

    NAME = "broadcast"
    STREAMS = frozenset(ALL_STREAM_KEYS)


@dataclasses.dataclass(frozen=True)
class Reduce(SmiOperation):
    """All-to-one reduction (``include/smi/reduce.h``, ``templates/reduce.cl``)."""

    op: SmiOp = SmiOp.ADD
    NAME = "reduce"
    STREAMS = frozenset(ALL_STREAM_KEYS)

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "op", SmiOp.parse(self.op))

    @property
    def accumulation_lanes(self) -> int:
        """Latency-hiding accumulation width.

        The reference masks FP-add pipeline latency with a shift register of
        4 partial accumulators for float/double (``codegen/ops.py:110-141``,
        ``templates/reduce.cl:63-70``). Here it is the number of partial accumulators of
        a streamed reduction (``P2PChannel.stream_reduce``).
        """
        return 4 if self.dtype in (SmiDtype.FLOAT, SmiDtype.DOUBLE) else 1


@dataclasses.dataclass(frozen=True)
class Scatter(SmiOperation):
    """Root distributes contiguous slices (``include/smi/scatter.h``)."""

    NAME = "scatter"
    STREAMS = frozenset(ALL_STREAM_KEYS)


@dataclasses.dataclass(frozen=True)
class Gather(SmiOperation):
    """Root collects contiguous slices (``include/smi/gather.h``)."""

    NAME = "gather"
    STREAMS = frozenset(ALL_STREAM_KEYS)


OP_REGISTRY: Dict[str, Type[SmiOperation]] = {
    cls.NAME: cls for cls in (Push, Pop, Broadcast, Reduce, Scatter, Gather)
}

#: Families whose ports share one namespace: a Push and a Pop at the same
#: port are two ends of one channel and therefore *not* a conflict, but two
#: Pushes at one port are (``codegen/program.py:37-50``).
P2P_FAMILIES = ("push", "pop")
COLLECTIVE_FAMILIES = ("broadcast", "reduce", "scatter", "gather")


def make_operation(name: str, port: int, dtype: Union[str, SmiDtype] = "float",
                   buffer_size: Optional[int] = None, **kwargs) -> SmiOperation:
    """Construct an op by manifest tag (used by serialization + C++ manifest)."""
    try:
        cls = OP_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown operation {name!r}; expected one of {sorted(OP_REGISTRY)}"
        ) from None
    return cls(port=port, dtype=dtype, buffer_size=buffer_size, **kwargs)
