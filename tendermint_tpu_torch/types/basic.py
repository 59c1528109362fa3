"""Enums, BlockID, PartSetHeader and timestamps, trimmed to sign-bytes.

Counterpart of ``tendermint_tpu/types/basic.py``: timestamps are integer
nanoseconds since the Unix epoch (Go time.Time semantics: zero value is
0001-01-01T00:00:00Z).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..wire.proto import encode_uvarint, encode_varint_signed

GO_ZERO_TIME_SECONDS = -62135596800
GO_ZERO_TIME_NS = GO_ZERO_TIME_SECONDS * 1_000_000_000
NS = 1_000_000_000


def encode_timestamp(ns: int) -> bytes:
    """google.protobuf.Timestamp{seconds=1, nanos=2}; floor division keeps
    nanos in [0, 1e9) for pre-epoch times."""
    seconds, nanos = divmod(ns, NS)
    out = b""
    if seconds:
        out = b"\x08" + encode_varint_signed(seconds)
    if nanos:
        out += b"\x10" + encode_uvarint(nanos)
    return out


class BlockIDFlag(enum.IntEnum):
    """types.proto BlockIDFlag"""

    ABSENT = 1
    COMMIT = 2
    NIL = 3


class SignedMsgType(enum.IntEnum):
    """types.proto SignedMsgType"""

    UNKNOWN = 0
    PREVOTE = 1
    PRECOMMIT = 2
    PROPOSAL = 32


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.part_set_header.is_zero()
