"""Data types, reduce operations, and message-framing constants.

Reference parity: ``include/smi/data_types.h`` (dtype enum),
``include/smi/reduce_operations.h`` (ADD/MAX/MIN),
``include/smi/network_message.h:15-37`` (packet framing),
``include/smi/operation_type.h`` (op-type tags).

Here there is no 32-byte wire packet — whole buffers move — but the framing constants are kept because the programming model exposes
them: the "asynchronicity degree" (buffer size) of a channel is specified in
*elements* and internally rounded to whole packets in the reference
(``codegen/rewrite.py:26-33``); here the identical math determines the chunk
count used for pipelined (scan-based / double-buffered) streaming, so a
program written against the reference's tuning knobs behaves the same.
"""

from __future__ import annotations

import enum
from typing import Union


class SmiDtype(enum.Enum):
    """Element types a channel can carry (``include/smi/data_types.h:10-16``)."""

    INT = "int"
    FLOAT = "float"
    DOUBLE = "double"
    CHAR = "char"
    SHORT = "short"

    @classmethod
    def parse(cls, value: Union[str, "SmiDtype"]) -> "SmiDtype":
        if isinstance(value, SmiDtype):
            return value
        try:
            return cls(value)
        except ValueError:
            raise ValueError(
                f"unknown SMI dtype {value!r}; expected one of "
                f"{[d.value for d in cls]}"
            ) from None


#: Bytes per element, as on the reference wire format
#: (``include/smi/network_message.h:27-37``).
DTYPE_SIZE = {
    SmiDtype.INT: 4,
    SmiDtype.FLOAT: 4,
    SmiDtype.DOUBLE: 8,
    SmiDtype.CHAR: 1,
    SmiDtype.SHORT: 2,
}

#: Reference packet framing: 32 B packet = 28 B payload + 4 B header
#: (``include/smi/network_message.h:15-23``, ``codegen/ops.py:21``).
PACKET_PAYLOAD_BYTES = 28
PACKET_TOTAL_BYTES = 32


def elements_per_packet(dtype: Union[str, SmiDtype]) -> int:
    """How many elements fit one reference packet (``codegen/ops.py:59-61``)."""
    return PACKET_PAYLOAD_BYTES // DTYPE_SIZE[SmiDtype.parse(dtype)]


def buffer_size_to_packets(buffer_size_elements: int, dtype: Union[str, SmiDtype]) -> int:
    """Convert a user buffer size in elements to whole packets.

    Mirrors ``codegen/rewrite.py:26-33``: round up to packets, then round the
    packet count up to a multiple of 8 (the reference's credit-batch quantum,
    ``templates/pop.cl:35-51``). The result is used here as the pipelining
    depth (number of in-flight chunks) of a streamed channel.
    """
    if buffer_size_elements <= 0:
        raise ValueError(f"buffer size must be positive, got {buffer_size_elements}")
    epp = elements_per_packet(dtype)
    packets = -(-buffer_size_elements // epp)  # ceil div
    return -(-packets // 8) * 8


def dtype_to_torch(dtype: Union[str, SmiDtype]):
    """Map an SMI dtype to the torch dtype used on the device."""
    import torch

    return {
        SmiDtype.INT: torch.int32,
        SmiDtype.FLOAT: torch.float32,
        SmiDtype.DOUBLE: torch.float64,
        SmiDtype.CHAR: torch.int8,
        SmiDtype.SHORT: torch.int16,
    }[SmiDtype.parse(dtype)]


class SmiOp(enum.Enum):
    """Reduction operators (``include/smi/reduce_operations.h``)."""

    ADD = "add"
    MAX = "max"
    MIN = "min"

    @classmethod
    def parse(cls, value: Union[str, "SmiOp"]) -> "SmiOp":
        if isinstance(value, SmiOp):
            return value
        return cls(value)


SMI_ADD = SmiOp.ADD
SMI_MAX = SmiOp.MAX
SMI_MIN = SmiOp.MIN


class MessageKind(enum.Enum):
    """Packet op-type tags (``include/smi/operation_type.h:11-19``).

    Only DATA survives here — SYNCH (rendezvous credits) lives in the ring
    kernels' flag words — but the tags are preserved in the model so
    manifests and traces stay comparable with the reference.
    """

    DATA = 0
    CONTROL = 1
    SYNCH = 3
