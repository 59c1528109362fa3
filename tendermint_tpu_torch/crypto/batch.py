"""Batch signature verification: every commit-verification surface
collects its signatures here and verifies them in one call.

Counterpart of ``tendermint_tpu/crypto/batch.py``.  Backends:
  * "torch" — ``TorchBatchVerifier``: the whole batch in one launch of the
              verify CUDA kernel of the field layout ``TM_CUDA_FIELD_IMPL``
              selects (``ops/ed25519_torch``), or its plain PyTorch
              version for ``device="cpu"``; with ``TM_CUDA_RLC=1``,
              through the RLC batch equation instead.
  * "cpu"   — ``CPUBatchVerifier``: the pure ZIP-215 reference, one
              signature at a time.
A batch holding a 33-byte secp256k1 key raises ``NotImplementedError``:
secp256k1 verification is not ported yet, and such a row is never
silently rejected.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from .. import knobs
from ..ops import ed25519_torch
from . import ed25519 as _ed

SECP256K1_PUB_SIZE = 33


def _pub_bytes(pub) -> bytes:
    return pub.bytes_() if hasattr(pub, "bytes_") else bytes(pub)


@runtime_checkable
class BatchVerifier(Protocol):
    def add(self, pub_key, msg: bytes, sig: bytes) -> None: ...

    def count(self) -> int: ...

    def verify(self) -> tuple[bool, list[bool]]:
        """Returns (all_valid, per-item validity).  Resets the batch."""
        ...


class _BaseBatch:
    def __init__(self) -> None:
        self._pubs: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []

    def add(self, pub_key, msg: bytes, sig: bytes) -> None:
        self._pubs.append(_pub_bytes(pub_key))
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(sig))

    def count(self) -> int:
        return len(self._pubs)

    def _take(self):
        batch = (self._pubs, self._msgs, self._sigs)
        self._pubs, self._msgs, self._sigs = [], [], []
        return batch

    def verify(self) -> tuple[bool, list[bool]]:
        pubs, msgs, sigs = self._take()
        if not pubs:
            return False, []
        oks = _split_verify(pubs, msgs, sigs, self._ed_batch)
        return all(oks), oks

    def _ed_batch(self, pubs, msgs, sigs) -> list[bool]:
        raise NotImplementedError


def _split_verify(pubs, msgs, sigs, ed_batch_fn) -> list[bool]:
    """Key-type routing for a batch: key-byte length is the discriminator
    (ed25519 pubs are 32 bytes, secp256k1 compressed pubs 33).  The whole
    batch goes through `ed_batch_fn` in one call; a key of any other
    length is not a known encoding and comes out False there."""
    if any(len(p) == SECP256K1_PUB_SIZE for p in pubs):
        raise NotImplementedError("secp256k1 verification is not ported")
    return [bool(v) for v in ed_batch_fn(pubs, msgs, sigs)]


class CPUBatchVerifier(_BaseBatch):
    """Sequential host loop over the pure ZIP-215 reference."""

    def _ed_batch(self, pubs, msgs, sigs) -> list[bool]:
        return [_ed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]


class TorchBatchVerifier(_BaseBatch):
    """One verify kernel launch verifies the entire batch.

    ``TM_CUDA_FIELD_IMPL``, ``TM_CUDA_FE_MXU`` and ``TM_CUDA_BASE_MXU``,
    read at every call (``ed25519_torch.default_impl``,
    ``_resolve_optin``), choose the kernel: the field layout, whether f32
    multiplies on the tensor cores and whether [s]B takes the tensor-core
    comb.  ``TM_CUDA_RLC=1``, read at every call, routes the batch through
    the RLC batch equation (``ed25519_torch.verify_batch_rlc``: one launch
    of the RLC kernel of the layout and multiply resolved for this call,
    and the per-row kernel of the same choice only if the equation fails),
    the counterpart of ``TM_TPU_RLC``.  The verdicts are the same either
    way.

    ``device`` None means ``cuda``; with no CUDA device that raises
    rather than running on the CPU.  ``device="cpu"`` runs the kernels'
    plain PyTorch versions."""

    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = device

    def _ed_batch(self, pubs, msgs, sigs) -> list[bool]:
        if knobs.read("TM_CUDA_RLC") == "1":
            return list(ed25519_torch.verify_batch_rlc(pubs, msgs, sigs, device=self.device))
        return list(ed25519_torch.verify_batch(pubs, msgs, sigs, device=self.device))


def new_batch_verifier(backend: str = "torch", device=None) -> BatchVerifier:
    if backend == "torch":
        return TorchBatchVerifier(device=device)
    if backend == "cpu":
        return CPUBatchVerifier()
    raise ValueError(f"unknown batch-verifier backend {backend!r}")
