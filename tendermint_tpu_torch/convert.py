"""Carry state across from the JAX package in its numpy form.

The port imports nothing of ``tendermint_tpu``; a caller holding that
package's arrays hands them over as numpy and gets the port's objects.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto.keys import PubKey
from .ops import kernels
from .types.validator import Validator, ValidatorSet

_JAX_LIMB_BITS = 17
_COMB_LIMB_BITS = {"int64": 17, "f32": 5}  # the layouts a float32 comb table holds exactly


def _int_from_limbs(limbs, bits: int = _JAX_LIMB_BITS) -> int:
    return sum(int(v) << (bits * i) for i, v in enumerate(limbs))


def tables_from_jax(x, y, z, t) -> torch.Tensor:
    """The four int64 [64, 16, 15] limb arrays (X, Y, Z, T) of the JAX
    package's ``_Core(fe25519)._fixed_base_tables`` -> the
    ``ed25519_verify`` kernel's table, int64 [64, 16, 4, 5] on the CPU."""
    coords = [np.asarray(c) for c in (x, y, z, t)]
    for c in coords:
        if c.shape != (64, 16, 15):
            raise ValueError(f"expected [64, 16, 15] limb arrays, got {c.shape}")
    rows = [[tuple(_int_from_limbs(c[i, j]) for c in coords) for j in range(16)]
            for i in range(64)]
    return torch.as_tensor(kernels.table_from_points(rows))


def comb_table_from_jax(table, impl: str) -> torch.Tensor:
    """The JAX package's comb table ``_Core(fe)._fixed_base_tables256``,
    float32 [32, 256, 4 * NLIMBS] in the limbs of `impl` ("int64" or
    "f32"; its packed limbs are past float32's exact range) -> the comb
    kernels' byte table, uint8 [32, 128, 256] on the CPU."""
    if impl not in _COMB_LIMB_BITS:
        raise ValueError(f"no exact comb table in the {impl!r} layout")
    bits = _COMB_LIMB_BITS[impl]
    limbs = np.asarray(table).astype(np.int64)
    nl = 255 // bits
    if limbs.shape != (32, 256, 4 * nl):
        raise ValueError(f"expected a [32, 256, {4 * nl}] table, got {limbs.shape}")
    rows = [[tuple(_int_from_limbs(limbs[i, j, c * nl:(c + 1) * nl], bits) for c in range(4))
             for j in range(256)] for i in range(32)]
    return torch.as_tensor(kernels.comb_table_from_points(rows))


def validator_set_from_numpy(pubs, powers) -> ValidatorSet:
    """A validator set from ed25519 public keys uint8 [N, 32] and voting
    powers int64 [N]."""
    pubs = np.asarray(pubs, dtype=np.uint8)
    powers = np.asarray(powers, dtype=np.int64)
    if pubs.ndim != 2 or pubs.shape[1] != 32 or powers.shape != (pubs.shape[0],):
        raise ValueError("expected pubs uint8 [N, 32] and powers int64 [N]")
    return ValidatorSet([Validator(PubKey(row.tobytes()), int(p))
                         for row, p in zip(pubs, powers)])
