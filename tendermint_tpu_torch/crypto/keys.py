"""Ed25519 key objects (Go-style 64-byte private key = seed || pubkey).

Counterpart of ``tendermint_tpu/crypto/keys.py``: address =
SHA-256(pubkey)[:20].  Signing is pure Python through the fixed-base
table of ``crypto/ed25519.py``, byte-identical to RFC 8032.
"""

from __future__ import annotations

from . import ed25519 as _ed
from . import tmhash

PUB_KEY_SIZE = 32
PRIV_KEY_SIZE = 64


class PubKey:
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def bytes_(self) -> bytes:
        return self._bytes

    def address(self) -> bytes:
        return tmhash.sum_truncated(self._bytes)

    def __eq__(self, other) -> bool:
        return isinstance(other, PubKey) and other._bytes == self._bytes

    def __hash__(self) -> int:
        return hash(self._bytes)

    def __repr__(self) -> str:
        return f"PubKey(ed25519:{self._bytes.hex()[:16]}…)"


class PrivKey:
    __slots__ = ("_seed", "_pub")

    def __init__(self, data: bytes):
        """Accepts a 64-byte Go-style key (seed||pub) or a 32-byte seed."""
        if len(data) == PRIV_KEY_SIZE:
            seed = data[:32]
        elif len(data) == 32:
            seed = data
        else:
            raise ValueError("ed25519 privkey must be 32 or 64 bytes")
        self._seed = bytes(seed)
        self._pub = _ed.pubkey_from_seed(self._seed)
        if len(data) == PRIV_KEY_SIZE and data[32:] != self._pub:
            raise ValueError("privkey pubkey suffix mismatch")

    def bytes_(self) -> bytes:
        return self._seed + self._pub

    def sign(self, msg: bytes) -> bytes:
        return _ed.sign(self._seed, msg, pub=self._pub)

    def pub_key(self) -> PubKey:
        return PubKey(self._pub)
