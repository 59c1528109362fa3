"""Deterministic protobuf encoding, trimmed to what sign-bytes need.

Counterpart of ``tendermint_tpu/wire/proto.py``: gogoproto proto3
emission rules (scalar fields omitted when zero, nil message fields
omitted, non-nullable embedded messages always emitted).
"""

from __future__ import annotations

import struct

WT_VARINT = 0
WT_FIXED64 = 1
WT_BYTES = 2

_U64_MASK = (1 << 64) - 1


def encode_uvarint(n: int) -> bytes:
    """Unsigned LEB128 varint."""
    if n < 0:
        raise ValueError("uvarint cannot encode negative values")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_varint_signed(n: int) -> bytes:
    """Protobuf int32/int64 encoding: negatives as 64-bit two's complement."""
    return encode_uvarint(n & _U64_MASK)


def _tag(field: int, wire_type: int) -> bytes:
    return encode_uvarint((field << 3) | wire_type)


class ProtoWriter:
    """Accumulates protobuf fields; proto3 zero-value omission by default."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def varint(self, field: int, value: int, omit_zero: bool = True) -> "ProtoWriter":
        if value == 0 and omit_zero:
            return self
        self._buf += _tag(field, WT_VARINT)
        self._buf += encode_varint_signed(value)
        return self

    def sfixed64(self, field: int, value: int, omit_zero: bool = True) -> "ProtoWriter":
        if value == 0 and omit_zero:
            return self
        self._buf += _tag(field, WT_FIXED64)
        self._buf += struct.pack("<q", value)
        return self

    def bytes_(self, field: int, value: bytes, omit_empty: bool = True) -> "ProtoWriter":
        if not value and omit_empty:
            return self
        self._buf += _tag(field, WT_BYTES)
        self._buf += encode_uvarint(len(value))
        self._buf += value
        return self

    def string(self, field: int, value: str, omit_empty: bool = True) -> "ProtoWriter":
        return self.bytes_(field, value.encode("utf-8"), omit_empty)

    def message(self, field: int, encoded: bytes | None, always: bool = False) -> "ProtoWriter":
        """Embedded message.  None = nil pointer (omitted unless `always`);
        b"" = present-but-empty message (tag + length 0).  `always=True`
        mirrors gogoproto nullable=false emission."""
        if encoded is None and not always:
            return self
        body = encoded or b""
        self._buf += _tag(field, WT_BYTES)
        self._buf += encode_uvarint(len(body))
        self._buf += body
        return self

    def bytes_out(self) -> bytes:
        return bytes(self._buf)


def encode_delimited(msg: bytes) -> bytes:
    """Varint-length-prefixed message — the framing of sign-bytes."""
    return encode_uvarint(len(msg)) + msg
