"""Canonical vote sign-bytes, byte-compatible with the reference.

Counterpart of ``tendermint_tpu/types/canonical.py``: CanonicalVote per
proto/tendermint/types/canonical.proto (sfixed64 height/round, zero
BlockID omitted, timestamp always emitted), varint-length-delimited.
"""

from __future__ import annotations

from ..wire.proto import ProtoWriter, encode_delimited
from .basic import BlockID, SignedMsgType, encode_timestamp


def _canonical_block_id(block_id: BlockID) -> bytes | None:
    """CanonicalBlockID{hash=1, part_set_header=2 non-nullable}; nil when
    the blockID is zero (nil votes)."""
    if block_id.is_zero():
        return None
    psh = (
        ProtoWriter()
        .varint(1, block_id.part_set_header.total)
        .bytes_(2, block_id.part_set_header.hash)
        .bytes_out()
    )
    return ProtoWriter().bytes_(1, block_id.hash).message(2, psh, always=True).bytes_out()


def vote_sign_bytes_raw(
    chain_id: str,
    msg_type: SignedMsgType,
    height: int,
    round_: int,
    block_id: BlockID,
    timestamp_ns: int,
) -> bytes:
    """Delimited CanonicalVote{type=1, height=2 sfixed64, round=3 sfixed64,
    block_id=4, timestamp=5 (always), chain_id=6}."""
    w = (
        ProtoWriter()
        .varint(1, int(msg_type))
        .sfixed64(2, height)
        .sfixed64(3, round_)
        .message(4, _canonical_block_id(block_id))
        .message(5, encode_timestamp(timestamp_ns), always=True)
        .string(6, chain_id)
    )
    return encode_delimited(w.bytes_out())
