"""The transport's protocol errors.

:class:`IntegrityError` is what the verified transport
(:meth:`~smi_tpu_torch.parallel.channels.P2PChannel.verify_frames`)
raises for a damaged chunk. The classes keep the JAX package's bases,
fields and constructor (``smi_tpu/parallel/credits.py``), so a handler
written for one package catches the other's errors alike.
"""

from typing import Optional


class ProtocolError(AssertionError):
    """A transport broke its wire protocol."""


class IntegrityError(ProtocolError):
    """The verified-transport framing caught a corrupted, truncated, or
    missequenced chunk.

    Carries enough to debug the wire: the receiving ``rank``, the
    claimed source ``src``, the frame's sequence number ``seq``, the
    detection ``kind`` (``"checksum"`` or ``"sequence"``), and the
    ``expected`` vs ``got`` values (CRCs for a checksum miss, sequence
    numbers for a reorder). Payload corruption must surface here, never
    as silently wrong delivery.
    """

    def __init__(self, message: str, rank: Optional[int] = None,
                 src: Optional[int] = None, seq: Optional[int] = None,
                 expected=None, got=None, kind: Optional[str] = None):
        super().__init__(message)
        self.rank = rank
        self.src = src
        self.seq = seq
        self.expected = expected
        self.got = got
        self.kind = kind
