"""The 20-byte truncated SHA-256 used for addresses."""

import hashlib

TRUNCATED_SIZE = 20


def sum_truncated(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:TRUNCATED_SIZE]
