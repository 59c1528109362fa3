"""Commit and CommitSig: the aggregated precommit evidence for a block.

Counterpart of ``tendermint_tpu/types/commit.py`` (reference
types/block.go CommitSig :603, VoteSignBytes :815), trimmed to what
commit verification reads.  Sign-bytes come from the pure-Python
template path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..wire.proto import ProtoWriter, encode_uvarint
from .basic import (
    GO_ZERO_TIME_NS,
    BlockID,
    BlockIDFlag,
    SignedMsgType,
    encode_timestamp,
)
from .canonical import _canonical_block_id


@dataclass
class CommitSig:
    block_id_flag: BlockIDFlag
    validator_address: bytes = b""
    timestamp_ns: int = GO_ZERO_TIME_NS
    signature: bytes = b""

    @classmethod
    def absent_sig(cls) -> "CommitSig":
        return cls(block_id_flag=BlockIDFlag.ABSENT)

    def absent(self) -> bool:
        return self.block_id_flag == BlockIDFlag.ABSENT

    def for_block(self) -> bool:
        return self.block_id_flag == BlockIDFlag.COMMIT


@dataclass
class Commit:
    height: int
    round: int
    block_id: BlockID
    signatures: list[CommitSig] = field(default_factory=list)

    def _sign_bytes_templates(self, chain_id: str):
        """Within one commit the canonical vote bytes differ per signature
        only by BlockID flavour (COMMIT vs NIL/ABSENT) and timestamp, so
        fields 1-4 and field 6 are built once and reused.  Keyed on every
        field the prefix bytes depend on, so a mutated Commit never
        serves stale bytes."""
        key = (
            chain_id,
            self.height,
            self.round,
            self.block_id.hash,
            self.block_id.part_set_header.total,
            self.block_id.part_set_header.hash,
        )
        tpl = getattr(self, "_sb_tpl", None)
        if tpl is not None and tpl[0] == key:
            return tpl[1]

        def prefix(block_id: BlockID) -> bytes:
            return (
                ProtoWriter()
                .varint(1, int(SignedMsgType.PRECOMMIT))
                .sfixed64(2, self.height)
                .sfixed64(3, self.round)
                .message(4, _canonical_block_id(block_id))
                .bytes_out()
            )

        out = (
            prefix(self.block_id),
            prefix(BlockID()),
            ProtoWriter().string(6, chain_id).bytes_out(),
        )
        self._sb_tpl = (key, out)
        return out

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Validator idx's canonical precommit bytes (reference
        block.go:815)."""
        cs = self.signatures[idx]
        pre_block, pre_nil, suffix = self._sign_bytes_templates(chain_id)
        pre = pre_block if cs.block_id_flag == BlockIDFlag.COMMIT else pre_nil
        ts = encode_timestamp(cs.timestamp_ns)
        body = pre + b"\x2a" + encode_uvarint(len(ts)) + ts + suffix
        return encode_uvarint(len(body)) + body

    def vote_sign_bytes_batch(self, chain_id: str, idxs) -> list[bytes]:
        """Every selected validator's canonical precommit bytes."""
        return [self.vote_sign_bytes(chain_id, i) for i in idxs]
