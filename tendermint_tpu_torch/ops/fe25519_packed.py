"""GF(2^255-19) field and edwards25519 point arithmetic in the PACKED
layout: 10 limbs at the mixed radix 25.5 in int64 tensors.

The plain PyTorch version of the ``ed25519_verify_packed`` kernel's field
and point layer (``csrc/fe_packed.cuh``) and the counterpart, limb for
limb, of ``tendermint_tpu/ops/fe25519_packed.py``, which the JAX
package's ``auto`` field promotes on an accelerator when the packed
program passes its golden-batch check.

Limb i holds bits [w_i, w_i + 26 - (i % 2)) of the value, w_i =
ceil(25.5 i): widths 26, 25, 26, ...  10 x 25.5 = 255, so the wrap at
2^255 folds with a bare x19.  A product a_i * b_j with i and j both odd
has weight w_i + w_j = w_{i+j} + 1 and enters column i + j doubled.

Bounds (as in the JAX module): reduced limbs are < 2^26.01; fe_sub adds
2p and fe_neg 4p in limb form, so no limb is ever negative; fe_mul needs
max|a_i| * max|b_j| <= 2^54.9 (worst folded column < 2^63) and fe_sq
reduced inputs only, which is why the point formulas square x + y with
fe_mul and put ``rounds=2`` partial carries exactly where the JAX
formulas put them.  fe_carry(rounds=3) reduces any non-negative int64
column; rounds=2 any column <= 2^44.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto import ed25519 as _ref
from . import fe25519, kernels
from .fe25519 import Pt, pt_select  # noqa: F401  (the same struct and select)

NLIMBS = 10
LIMB_WIDTHS = tuple(26 - (i % 2) for i in range(NLIMBS))
LIMB_WEIGHTS = tuple((51 * i + 1) // 2 for i in range(NLIMBS))  # ceil(25.5 i)
_MASKS = tuple((1 << w) - 1 for w in LIMB_WIDTHS)
DTYPE = torch.int64

P = _ref.P


def limbs_from_int(v: int) -> np.ndarray:
    return np.array([(v >> LIMB_WEIGHTS[i]) & _MASKS[i] for i in range(NLIMBS)],
                    dtype=np.int64)


def int_from_limbs(a) -> int:
    a = np.asarray(a)
    return sum(int(a[..., i]) << LIMB_WEIGHTS[i] for i in range(NLIMBS))


# ---------------------------------------------------------------------------
# Constants (limb form), one copy per device
# ---------------------------------------------------------------------------

P_LIMBS = limbs_from_int(P)
_PAIR = np.arange(NLIMBS)[:, None] + np.arange(NLIMBS)[None, :]
_ODD_ODD = (np.arange(NLIMBS)[:, None] % 2) & (np.arange(NLIMBS)[None, :] % 2)
_CONSTS = {
    "2P": 2 * P_LIMBS,  # borrow headroom for one reduced subtrahend
    "4P": 4 * P_LIMBS,
    "ONE": limbs_from_int(1),
    "ZERO": limbs_from_int(0),
    "D": limbs_from_int(_ref.D),
    "D2": limbs_from_int(2 * _ref.D % P),
    "SQRT_M1": limbs_from_int(_ref.SQRT_M1),
    "WIDTHS": np.array(LIMB_WIDTHS, dtype=np.int64),
    "MASKS": np.array(_MASKS, dtype=np.int64),
    "CARRY_W": np.array([19] + [1] * (NLIMBS - 1), dtype=np.int64),
    "CARRY_FROM": np.roll(np.arange(NLIMBS), 1),
    # limb pair (i, j) lands in column (i + j) mod 10, doubled when both
    # are odd and times 19 past the 2^255 wrap: the JAX module's folded
    # columns (its _DBL_ODD and _fold_cols) as one weight per pair
    "COL_INDEX": (_PAIR % NLIMBS).reshape(-1),
    "COL_WEIGHT": ((1 + _ODD_ODD) * np.where(_PAIR >= NLIMBS, 19, 1)).reshape(-1),
}
assert int_from_limbs(_CONSTS["2P"]) == 2 * P and int_from_limbs(_CONSTS["4P"]) == 4 * P


@functools.cache
def const(name: str, device: torch.device) -> torch.Tensor:
    """A named limb constant as an int64 tensor on `device`."""
    return torch.as_tensor(_CONSTS[name], device=device)


def _c(name: str, like: torch.Tensor) -> torch.Tensor:
    return const(name, like.device)


def limbs_of_bits(bits255: torch.Tensor) -> torch.Tensor:
    """[..., 255] LE bits -> [..., 10] limbs: each limb its own slice of
    its own width (the radix is mixed, so no uniform reshape)."""
    outs = []
    for lo, w in zip(LIMB_WEIGHTS, LIMB_WIDTHS):
        weights = torch.as_tensor(1 << np.arange(w, dtype=np.int64), device=bits255.device)
        outs.append((bits255[..., lo:lo + w].to(torch.int64) * weights).sum(-1))
    return torch.stack(outs, dim=-1)


# ---------------------------------------------------------------------------
# Field ops (all take/return [..., 10] int64)
# ---------------------------------------------------------------------------

def fe_carry(c: torch.Tensor, rounds: int = 3) -> torch.Tensor:
    """Carry-propagate by relaxation with per-limb widths: each round moves
    every limb's overflow one limb up at once (the top limb's re-enters
    limb 0 x19).  rounds=3 reduces any non-negative int64 column, rounds=2
    any column <= 2^44."""
    widths, masks = _c("WIDTHS", c), _c("MASKS", c)
    w, src = _c("CARRY_W", c), _c("CARRY_FROM", c)
    for _ in range(rounds):
        c = (c & masks) + (c >> widths).index_select(-1, src) * w
    return c


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product (100 limb products, odd x odd doubled), folded at
    2^255 and carried.  Contract: max|a_i| * max|b_j| <= 2^54.9."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (NLIMBS * NLIMBS,))
    cols = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    cols.index_add_(-1, _c("COL_INDEX", a), prod * _c("COL_WEIGHT", a))
    return fe_carry(cols, rounds=3)


def fe_sq(a: torch.Tensor) -> torch.Tensor:
    """a^2 on reduced inputs.  Its columns are the JAX squaring's (diagonal
    once, cross terms doubled), so its limbs are too."""
    return fe_mul(a, a)


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod p), non-negative limbs; b must be reduced."""
    return a + _c("2P", a) - b


def fe_neg(a: torch.Tensor) -> torch.Tensor:
    """-a (mod p) for limbs <= 4p limb-wise; callers re-carry."""
    return _c("4P", a) - a


def fe_pow_p58(a: torch.Tensor) -> torch.Tensor:
    """a^((p-5)/8), the chain of ``fe25519.pow_p58_chain``."""
    return fe25519.pow_p58_chain(a, fe_mul, fe_sq)


def _fe_carry_exact(c: torch.Tensor) -> torch.Tensor:
    """Sequential ripple with per-limb widths (plus one 19-fold re-entry
    into limbs 0 and 1).  Used only by fe_canonical."""
    outs = []
    carry = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for i in range(NLIMBS):
        v = c[..., i] + carry
        carry = v >> LIMB_WIDTHS[i]
        outs.append(v & _MASKS[i])
    c0 = outs[0] + 19 * carry
    outs[1] = outs[1] + (c0 >> LIMB_WIDTHS[0])
    outs[0] = c0 & _MASKS[0]
    return torch.stack(outs, dim=-1)


def fe_canonical(a: torch.Tensor) -> torch.Tensor:
    """The canonical representative in [0, p); non-negative limbs < 2^57."""
    a = _fe_carry_exact(_fe_carry_exact(_fe_carry_exact(a)))
    borrow = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    outs = []
    for i in range(NLIMBS):
        v = a[..., i] - int(P_LIMBS[i]) - borrow
        borrow = (v < 0).to(torch.int64)
        outs.append(v + (borrow << LIMB_WIDTHS[i]))
    keep = (borrow == 1)[..., None]  # underflow => a < p => keep a
    return torch.where(keep, a, torch.stack(outs, dim=-1))


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(fe_canonical(a) == fe_canonical(b), dim=-1)


def fe_is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(fe_canonical(a) == 0, dim=-1)


# ---------------------------------------------------------------------------
# Byte encodings and the fe_ops_packed part check
# ---------------------------------------------------------------------------

def fe_from_bytes(rows: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 32] -> limbs of the low 255 bits."""
    return limbs_of_bits(fe25519.bits_of(rows)[..., :255])


def fe_to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Limbs -> canonical 32-byte little-endian encoding, uint8 [..., 32]."""
    c = fe_canonical(a)
    bits = torch.cat([(c[..., i:i + 1] >> torch.arange(w, device=a.device)) & 1
                      for i, w in enumerate(LIMB_WIDTHS)], dim=-1)
    return fe25519.bytes_of_bits(bits)


def fe_ops(a_rows: torch.Tensor, b_rows: torch.Tensor):
    """Plain version of the ``fe_ops_packed`` kernel: canonical a*b, a^2
    and a^((p-5)/8) of 255-bit encodings, each uint8 [N, 32]."""
    a, b = fe_from_bytes(a_rows), fe_from_bytes(b_rows)
    return fe_to_bytes(fe_mul(a, b)), fe_to_bytes(fe_sq(a)), fe_to_bytes(fe_pow_p58(a))


def fe_ops_rows(a_rows: torch.Tensor, b_rows: torch.Tensor):
    """The ``fe_ops_packed`` kernel for CUDA tensors, ``fe_ops`` for CPU
    tensors."""
    if a_rows.is_cuda:
        return kernels.fe_ops_packed(a_rows, b_rows)
    return fe_ops(a_rows, b_rows)


# ---------------------------------------------------------------------------
# Point ops — extended coordinates (X, Y, Z, T), T = XY/Z
# ---------------------------------------------------------------------------

def pt_identity(shape, device: torch.device) -> Pt:
    def c(name):
        return const(name, device).expand(tuple(shape) + (NLIMBS,))

    return Pt(c("ZERO"), c("ONE"), c("ONE"), c("ZERO"))


def pt_add(p: Pt, q: Pt) -> Pt:
    """Unified, complete a=-1 addition with the JAX module's two rounds=2
    partial carries (the first subtrahend and f), which keep every
    product inside the pairwise 2^54.9 contract."""
    a = fe_mul(fe_carry(fe_sub(p.y, p.x), rounds=2), fe_sub(q.y, q.x))
    b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x))
    c = fe_mul(fe_mul(p.t, q.t), _c("D2", p.t))
    d = fe_mul(p.z, q.z)
    d2 = fe_add(d, d)
    e = fe_sub(b, a)
    f = fe_carry(fe_sub(d2, c), rounds=2)
    g = fe_add(d2, c)
    h = fe_add(b, a)
    return Pt(fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


def pt_dbl(p: Pt) -> Pt:
    return pt_dbl_n(p, 1)


def pt_dbl_n(p: Pt, k: int) -> Pt:
    """k chained doublings, T only on the last.  (x + y)^2 goes through
    fe_mul (its operand is past fe_sq's reduced-only contract); e and f
    get rounds=2 partial carries."""
    if k < 1:
        raise ValueError("pt_dbl_n needs k >= 1")
    x, y, z = p.x, p.y, p.z
    for i in range(k):
        a = fe_sq(x)
        b = fe_sq(y)
        c = fe_sq(z)
        c = fe_add(c, c)
        h = fe_add(a, b)
        xy = fe_add(x, y)
        e = fe_carry(fe_sub(h, fe_mul(xy, xy)), rounds=2)
        g = fe_sub(a, b)
        f = fe_carry(fe_add(c, g), rounds=2)
        if i == k - 1:
            return Pt(fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))
        x, y, z = fe_mul(e, f), fe_mul(g, h), fe_mul(f, g)


def pt_neg(p: Pt) -> Pt:
    # re-carry: negated coordinates feed fe_sub, which needs reduced inputs
    return Pt(fe_carry(fe_neg(p.x)), p.y, p.z, fe_carry(fe_neg(p.t)))


def pt_is_identity(p: Pt) -> torch.Tensor:
    """X == 0 and Y == Z (projective identity test)."""
    return fe_is_zero(p.x) & fe_eq(p.y, p.z)
