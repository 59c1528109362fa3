"""GF(2^255-19) field and edwards25519 point arithmetic on int64 tensors.

The plain PyTorch version of the field and point layer: counterpart of
``tendermint_tpu/ops/fe25519.py``, the 15 x 17-bit int64 limb layout that
the JAX package's ``auto`` field resolves to on the CPU, so the CPU tests
can hold each function here against the JAX function of the same name.
Field elements are ``[..., 15]`` int64 tensors on any device.  On the card
the same arithmetic runs inside the ``ed25519_verify`` kernel
(``csrc/ed25519_verify.cu``, 5 x 51-bit limbs); ``fe_ops`` below holds that
kernel's field functions against these.

Bounds (why int64 never overflows), as in the JAX module:
  * reduced limbs are < 2^17.2 (post-carry invariant);
  * adds/subs produce limbs < 2^20 (fe_sub/fe_neg add 2p/4p in limb form
    to stay non-negative);
  * a product column is <= 15 terms of a_i*b_j plus <= 14 folded terms
    * 19, inputs < 2^20  =>  column < 281 * 2^40 < 2^49.
The plain version relies on ``>>`` being arithmetic on negative int64
values, as jnp's is.

The addition law is the unified a=-1 extended-coordinates formula,
complete for every curve point — small-order and doubling inputs
included, which ZIP-215 verification requires.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto import ed25519 as _ref
from . import kernels

NLIMBS = 15
LIMB_BITS = 17
MASK = (1 << LIMB_BITS) - 1
DTYPE = torch.int64

P = _ref.P


def limbs_from_int(v: int) -> np.ndarray:
    return np.array([(v >> (LIMB_BITS * i)) & MASK for i in range(NLIMBS)], dtype=np.int64)


def int_from_limbs(a) -> int:
    a = np.asarray(a)
    return sum(int(a[..., i]) << (LIMB_BITS * i) for i in range(NLIMBS))


# ---------------------------------------------------------------------------
# Constants (limb form), one copy per device
# ---------------------------------------------------------------------------

P_LIMBS = limbs_from_int(P)
_CONSTS = {
    "2P": 2 * P_LIMBS,  # borrow headroom for one reduced subtrahend
    "4P": 4 * P_LIMBS,
    "ONE": limbs_from_int(1),
    "ZERO": limbs_from_int(0),
    "D": limbs_from_int(_ref.D),
    "D2": limbs_from_int(2 * _ref.D % P),
    "SQRT_M1": limbs_from_int(_ref.SQRT_M1),
    # a limb's carry moves one limb up; the top limb's re-enters limb 0 x19
    "CARRY_W": np.array([19] + [1] * (NLIMBS - 1), dtype=np.int64),
    "CARRY_FROM": np.roll(np.arange(NLIMBS), 1),
}
# limb pair (i, j) lands in product column i + j; a column at or past
# 2^255 folds down 15 limbs, times 19
_COL = (np.arange(NLIMBS)[:, None] + np.arange(NLIMBS)[None, :]).reshape(-1)
_CONSTS["COL_INDEX"] = _COL % NLIMBS
_CONSTS["COL_WEIGHT"] = np.where(_COL >= NLIMBS, 19, 1)


@functools.cache
def const(name: str, device: torch.device) -> torch.Tensor:
    """A named limb constant as an int64 tensor on `device`."""
    return torch.as_tensor(_CONSTS[name], device=device)


def _c(name: str, like: torch.Tensor) -> torch.Tensor:
    return const(name, like.device)


# ---------------------------------------------------------------------------
# Field ops (all take/return [..., 15] int64)
# ---------------------------------------------------------------------------

def fe_carry(c: torch.Tensor, rounds: int = 4) -> torch.Tensor:
    """Carry-propagate columns (each < 2^57) to reduced form (< 2^17.3).

    Each round moves every limb's overflow one limb up at once (the
    2^255-weight top overflow re-enters limb 0 as x19): limbs shrink to
    <= 2^17 + 19*C/2^17 per round, so 4 rounds take 2^57 -> < 2^17.3, and
    3 rounds suffice for C <= 2^52.6 (fe_mul's folded columns)."""
    w, src = _c("CARRY_W", c), _c("CARRY_FROM", c)
    for _ in range(rounds):
        c = (c & MASK) + (c >> LIMB_BITS).index_select(-1, src) * w
    return c


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product, folded at 2^255 and carried.  Inputs < 2^20.

    Every limb product a_i*b_j is summed into column i+j, and a column
    at or past 2^255 into column i+j-15 times 19: the same folded integer
    columns (< 2^52.6) as the JAX module's ``_fold_cols``, so the limbs
    after 3 carry rounds are the same too."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (NLIMBS * NLIMBS,))
    cols = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    cols.index_add_(-1, _c("COL_INDEX", a), prod * _c("COL_WEIGHT", a))
    return fe_carry(cols, rounds=3)


def fe_sq(a: torch.Tensor) -> torch.Tensor:
    """a^2.  The columns equal the JAX squaring's (diagonal once, cross
    terms doubled), so the limbs do too."""
    return fe_mul(a, a)


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod p), non-negative limbs; b must be reduced (< 2^17.2)."""
    return a + _c("2P", a) - b


def fe_neg(a: torch.Tensor) -> torch.Tensor:
    """-a (mod p); valid for limbs < 2^19 (4p headroom)."""
    return _c("4P", a) - a


def pow_p58_chain(a: torch.Tensor, mul, sq) -> torch.Tensor:
    """a^((p-5)/8) = a^(2^252 - 3), the sqrt-ratio exponent, by the
    addition chain every field layout shares: 251 squarings and 11
    multiplies through that layout's `mul` and `sq`."""
    def pow2k(v, k):
        for _ in range(k):
            v = sq(v)
        return v

    z2 = sq(a)
    z8 = pow2k(z2, 2)
    z9 = mul(z8, a)
    z11 = mul(z9, z2)
    z22 = sq(z11)
    z_5_0 = mul(z22, z9)  # a^(2^5-1)
    z_10_0 = mul(pow2k(z_5_0, 5), z_5_0)  # a^(2^10-1)
    z_20_0 = mul(pow2k(z_10_0, 10), z_10_0)
    z_40_0 = mul(pow2k(z_20_0, 20), z_20_0)
    z_50_0 = mul(pow2k(z_40_0, 10), z_10_0)
    z_100_0 = mul(pow2k(z_50_0, 50), z_50_0)
    z_200_0 = mul(pow2k(z_100_0, 100), z_100_0)
    z_250_0 = mul(pow2k(z_200_0, 50), z_50_0)
    return mul(pow2k(z_250_0, 2), a)  # a^(2^252-3)


def fe_pow_p58(a: torch.Tensor) -> torch.Tensor:
    return pow_p58_chain(a, fe_mul, fe_sq)


def _fe_carry_exact(c: torch.Tensor) -> torch.Tensor:
    """Sequential full ripple: limbs strictly < 2^17 afterwards (plus one
    19-fold re-entry).  Used only by fe_canonical."""
    outs = []
    carry = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for i in range(NLIMBS):
        v = c[..., i] + carry
        carry = v >> LIMB_BITS
        outs.append(v & MASK)
    c0 = outs[0] + 19 * carry
    c1 = outs[1] + (c0 >> LIMB_BITS)
    outs[0] = c0 & MASK
    outs[1] = c1
    return torch.stack(outs, dim=-1)


def fe_canonical(a: torch.Tensor) -> torch.Tensor:
    """Freeze to the canonical representative in [0, p)."""
    a = _fe_carry_exact(_fe_carry_exact(_fe_carry_exact(a)))
    # conditional subtract p (branchless borrow chain)
    borrow = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    outs = []
    for i in range(NLIMBS):
        v = a[..., i] - int(P_LIMBS[i]) - borrow
        borrow = (v < 0).to(torch.int64)
        outs.append(v + (borrow << LIMB_BITS))
    sub = torch.stack(outs, dim=-1)
    keep = (borrow == 1)[..., None]  # underflow => a < p => keep a
    return torch.where(keep, a, sub)


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical equality; bool [...]."""
    return torch.all(fe_canonical(a) == fe_canonical(b), dim=-1)


def fe_is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(fe_canonical(a) == 0, dim=-1)


# ---------------------------------------------------------------------------
# Byte encodings (255-bit little-endian field elements)
# ---------------------------------------------------------------------------

_LIMB_WEIGHTS = 1 << np.arange(LIMB_BITS, dtype=np.int64)


def bits_of(rows: torch.Tensor) -> torch.Tensor:
    """uint8 [..., B] -> [..., 8B] bits (LE bit order)."""
    b = (rows[..., :, None].to(torch.int64) >> torch.arange(8, device=rows.device)) & 1
    return b.reshape(rows.shape[:-1] + (8 * rows.shape[-1],))


def bytes_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 255] LE bits -> uint8 [..., 32] (bit 255 clear)."""
    bits = torch.nn.functional.pad(bits, (0, 1)).reshape(bits.shape[:-1] + (32, 8))
    return (bits << torch.arange(8, device=bits.device)).sum(-1).to(torch.uint8)


def limbs_of_bits(bits255: torch.Tensor) -> torch.Tensor:
    """[..., 255] LE bits -> [..., 15] limbs."""
    shaped = bits255.reshape(bits255.shape[:-1] + (NLIMBS, LIMB_BITS))
    return (shaped * torch.as_tensor(_LIMB_WEIGHTS, device=bits255.device)).sum(-1)


def fe_from_bytes(rows: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 32] -> limbs of the low 255 bits (bit 255 dropped; the
    value may be >= p, which the arithmetic tolerates)."""
    return limbs_of_bits(bits_of(rows)[..., :255])


def fe_to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Limbs -> canonical 32-byte little-endian encoding, uint8 [..., 32]."""
    c = fe_canonical(a)
    bits = (c[..., :, None] >> torch.arange(LIMB_BITS, device=a.device)) & 1
    return bytes_of_bits(bits.reshape(a.shape[:-1] + (NLIMBS * LIMB_BITS,)))


def fe_ops(a_rows: torch.Tensor, b_rows: torch.Tensor):
    """Plain version of the ``fe_ops`` kernel: from 255-bit encodings a, b
    (uint8 [N, 32]), the canonical a*b, a^2 and a^((p-5)/8), each
    uint8 [N, 32]."""
    a = fe_from_bytes(a_rows)
    b = fe_from_bytes(b_rows)
    return fe_to_bytes(fe_mul(a, b)), fe_to_bytes(fe_sq(a)), fe_to_bytes(fe_pow_p58(a))


def fe_ops_rows(a_rows: torch.Tensor, b_rows: torch.Tensor):
    """The ``fe_ops`` kernel for CUDA tensors, its plain version
    (``fe_ops``) for CPU tensors."""
    if a_rows.is_cuda:
        return kernels.fe_ops(a_rows, b_rows)
    return fe_ops(a_rows, b_rows)


# ---------------------------------------------------------------------------
# Point ops — extended coordinates (X, Y, Z, T), T = XY/Z
# ---------------------------------------------------------------------------

class Pt:
    """Plain struct of four [..., 15] limb tensors."""

    __slots__ = ("x", "y", "z", "t")

    def __init__(self, x, y, z, t):
        self.x, self.y, self.z, self.t = x, y, z, t

    def astuple(self):
        return (self.x, self.y, self.z, self.t)


def pt_identity(shape, device: torch.device) -> Pt:
    def c(name):
        return const(name, device).expand(tuple(shape) + (NLIMBS,))

    return Pt(c("ZERO"), c("ONE"), c("ONE"), c("ZERO"))


def pt_add(p: Pt, q: Pt) -> Pt:
    """Unified, complete a=-1 extended addition (add-2008-hwcd-3 shape)."""
    a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x))
    b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x))
    c = fe_mul(fe_mul(p.t, q.t), _c("D2", p.t))
    d = fe_mul(p.z, q.z)
    d2 = fe_add(d, d)
    e = fe_sub(b, a)
    f = fe_sub(d2, c)
    g = fe_add(d2, c)
    h = fe_add(b, a)
    return Pt(fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


def pt_dbl(p: Pt) -> Pt:
    """Dedicated doubling (dbl-2008-hwcd, RFC 8032's point_double for
    a=-1): complete for every curve point, identity included."""
    return pt_dbl_n(p, 1)


def pt_dbl_n(p: Pt, k: int) -> Pt:
    """k chained doublings; the extended T coordinate is computed only on
    the last (dbl-2008-hwcd reads just X, Y, Z)."""
    if k < 1:
        raise ValueError("pt_dbl_n needs k >= 1")
    x, y, z = p.x, p.y, p.z
    for i in range(k):
        a = fe_sq(x)
        b = fe_sq(y)
        c = fe_sq(z)
        c = fe_add(c, c)
        h = fe_add(a, b)
        e = fe_sub(h, fe_sq(fe_add(x, y)))  # -2XY
        g = fe_sub(a, b)
        f = fe_add(c, g)
        if i == k - 1:
            return Pt(fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))
        x, y, z = fe_mul(e, f), fe_mul(g, h), fe_mul(f, g)


def pt_neg(p: Pt) -> Pt:
    # re-carry: negated coordinates feed fe_sub, which needs reduced inputs
    return Pt(fe_carry(fe_neg(p.x)), p.y, p.z, fe_carry(fe_neg(p.t)))


def pt_select(bit: torch.Tensor, p1: Pt, p0: Pt) -> Pt:
    """bit ? p1 : p0, elementwise over the batch; bit shape [...]."""
    m = bit.to(torch.bool)[..., None]
    return Pt(*(torch.where(m, c1, c0) for c1, c0 in zip(p1.astuple(), p0.astuple())))


def pt_is_identity(p: Pt) -> torch.Tensor:
    """X == 0 and Y == Z (projective identity test)."""
    return fe_is_zero(p.x) & fe_eq(p.y, p.z)
