"""GF(2^255-19) field and edwards25519 point arithmetic on float32 tensors:
51 signed limbs of 5 bits.

The plain PyTorch version of the f32 kernels' field and point layer
(``csrc/fe_f32.cuh``, ``csrc/fe_f32_mma.cuh``) and the counterpart, limb
for limb, of ``tendermint_tpu/ops/fe25519_f32.py``, its matrix-unit
fe_mul (``_fe_mul_mxu``) included: ``fe_mul_mxu`` contracts the product
tensor against the incidence matrix (``inc_matrix``), and ``MXU`` is this
layout with that multiply, the field object of ``_Core("f32",
fe_mxu=True)``.  Both multiplies give the same columns, so the same limbs.

Every operation is a float32 multiply, add or floor, exact because every
intermediate is an integer of magnitude at most 2^24.  255 = 51 x 5, so
the wrap at 2^255 folds with a bare x19.  Limbs are signed: fe_sub is a
bare a - b, and floor()-based carries keep each low limb in [0, 32) for
either sign.

Bounds (as in the JAX module): reduced limbs lie in [-20, 51]; fe_mul
needs |a|_inf * |b|_inf <= 17,641 (worst folded column 951 products);
fe_sq needs |a|_inf <= 63, which is why the point formulas square x + y
(up to 102) with fe_mul and give f a 3-round partial carry;
fe_carry(rounds=6) reduces any |c| <= 2^24, rounds=3 any |c| <= 204.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

from ..crypto import ed25519 as _ref
from . import fe25519, kernels
from .fe25519 import Pt, pt_select  # noqa: F401  (the same struct and select)

NLIMBS = 51
LIMB_BITS = 5
RADIX = float(1 << LIMB_BITS)
INV_RADIX = 1.0 / RADIX
DTYPE = torch.float32

P = _ref.P


def limbs_from_int(v: int) -> np.ndarray:
    return np.array([(v >> (LIMB_BITS * i)) & 31 for i in range(NLIMBS)], dtype=np.float32)


def int_from_limbs(a) -> int:
    a = np.asarray(a)
    return sum(int(a[..., i]) << (LIMB_BITS * i) for i in range(NLIMBS))


# ---------------------------------------------------------------------------
# Constants (limb form), one copy per device
# ---------------------------------------------------------------------------

P_LIMBS = limbs_from_int(P)
# 4p with every limb >= 52 (124, limb 0 52): added before canonicalisation
# so the exact ripple runs on non-negative limbs
_V4P = np.full(NLIMBS, 124.0, dtype=np.float32)
_V4P[0] = 52.0
assert int_from_limbs(_V4P) == 4 * P
_PAIR = (np.arange(NLIMBS)[:, None] + np.arange(NLIMBS)[None, :]).reshape(-1)
_CONSTS = {
    "ONE": limbs_from_int(1),
    "ZERO": limbs_from_int(0),
    "D": limbs_from_int(_ref.D),
    "D2": limbs_from_int(2 * _ref.D % P),
    "SQRT_M1": limbs_from_int(_ref.SQRT_M1),
    "V4P": _V4P,
    "CARRY_W": np.array([19.0] + [1.0] * (NLIMBS - 1), dtype=np.float32),
    "CARRY_FROM": np.roll(np.arange(NLIMBS), 1),
    # limb pair (i, j) lands in column (i + j) mod 51, times 19 past the
    # 2^255 wrap: the JAX module's _mul_cols and _fold_cols as one weight
    "COL_INDEX": _PAIR % NLIMBS,
    "COL_WEIGHT": np.where(_PAIR >= NLIMBS, 19.0, 1.0).astype(np.float32),
}


def inc_matrix() -> np.ndarray:
    """[51 * 51, 51] incidence matrix (the JAX module's ``_inc_matrix``):
    product (i, j), row 51 i + j, lands in column (i + j) mod 51, with
    weight 19 past the 2^255 wrap and 1 below it."""
    m = np.zeros((NLIMBS * NLIMBS, NLIMBS), dtype=np.float32)
    m[np.arange(NLIMBS * NLIMBS), _CONSTS["COL_INDEX"]] = _CONSTS["COL_WEIGHT"]
    return m


_CONSTS["INC"] = inc_matrix()


@functools.cache
def const(name: str, device: torch.device) -> torch.Tensor:
    """A named limb constant (float32, or int64 for an index) on `device`."""
    return torch.as_tensor(_CONSTS[name], device=device)


def _c(name: str, like: torch.Tensor) -> torch.Tensor:
    return const(name, like.device)


_LIMB_WEIGHTS = (1 << np.arange(LIMB_BITS)).astype(np.float32)


def limbs_of_bits(bits255: torch.Tensor) -> torch.Tensor:
    """[..., 255] LE bits -> [..., 51] limbs in [0, 32)."""
    shaped = bits255.reshape(bits255.shape[:-1] + (NLIMBS, LIMB_BITS)).to(DTYPE)
    return (shaped * torch.as_tensor(_LIMB_WEIGHTS, device=bits255.device)).sum(-1)


# ---------------------------------------------------------------------------
# Field ops (all take/return [..., 51] float32)
# ---------------------------------------------------------------------------

def fe_carry(c: torch.Tensor, rounds: int = 6) -> torch.Tensor:
    """Carry by floor-division relaxation: each round moves every limb's
    overflow one limb up at once (the top limb's re-enters limb 0 x19);
    floor keeps each low limb in [0, 32) whatever its sign.  rounds=6
    reduces |c| <= 2^24, rounds=3 reduces |c| <= 204."""
    w, src = _c("CARRY_W", c), _c("CARRY_FROM", c)
    for _ in range(rounds):
        hi = torch.floor(c * INV_RADIX)
        c = (c - hi * RADIX) + hi.index_select(-1, src) * w
    return c


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product (2,601 limb products), folded at 2^255 and
    carried.  Contract: |a|_inf * |b|_inf <= 17,641, so every partial sum
    of a column is an integer below 2^24 and the float32 sums are exact
    in any order."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (NLIMBS * NLIMBS,))
    cols = torch.zeros(a.shape, dtype=DTYPE, device=a.device)
    cols.index_add_(-1, _c("COL_INDEX", a), prod * _c("COL_WEIGHT", a))
    return fe_carry(cols, rounds=6)


def fe_mul_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The matrix-unit formulation (the JAX ``_fe_mul_mxu``; plain version
    of the ``fe_mul_mma`` kernel): the [..., 2601] product tensor times the
    constant incidence matrix [2601, 51], then 6 carry rounds.  A float32
    matmul, exact under fe_mul's contract: every product and every partial
    sum of a column is an integer below 2^24 (on the card torch keeps a
    float32 matmul in full float32 unless TF32 is allowed).  The same
    columns as ``fe_mul``, so the same limbs."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (NLIMBS * NLIMBS,))
    return fe_carry(torch.matmul(prod, _c("INC", a)), rounds=6)


def fe_mul_mxu_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``fe_mul_mma`` kernel for CUDA tensors (limbs float32 [N, 51]),
    ``fe_mul_mxu`` for CPU tensors."""
    if a.is_cuda:
        return kernels.fe_mul_mma(a, b)
    return fe_mul_mxu(a, b)


def mxu_high_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool [N]: the rows of a ``fe_mul_mma`` call whose Toeplitz operand
    (a, unless b's largest |limb| is the smaller) has a limb outside
    [-128, 127], so that the kernel also runs the mma of its high byte."""
    a_max, b_max = a.abs().amax(-1), b.abs().amax(-1)
    t = torch.where((b_max < a_max)[..., None], b, a)
    return ((t < -128) | (t > 127)).any(-1)


def fe_sq(a: torch.Tensor) -> torch.Tensor:
    """a^2 for |a|_inf <= 63.  Its columns are the JAX squaring's
    (diagonal once, cross terms doubled), so its limbs are too."""
    return fe_mul(a, a)


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def fe_neg(a: torch.Tensor) -> torch.Tensor:
    return -a


def fe_pow_p58(a: torch.Tensor, mul=fe_mul) -> torch.Tensor:
    """a^((p-5)/8), the chain of ``fe25519.pow_p58_chain``."""
    return fe25519.pow_p58_chain(a, mul, fe_sq)


def _fe_carry_exact(c: torch.Tensor) -> torch.Tensor:
    """Sequential ripple on non-negative limbs: limbs < 32 afterwards but
    for the x19 top-carry re-entry into limbs 0 and 1.  Used only by
    fe_canonical."""
    outs = []
    carry = torch.zeros(c.shape[:-1], dtype=DTYPE, device=c.device)
    for i in range(NLIMBS):
        v = c[..., i] + carry
        carry = torch.floor(v * INV_RADIX)
        outs.append(v - carry * RADIX)
    c0 = outs[0] + 19.0 * carry
    k0 = torch.floor(c0 * INV_RADIX)
    outs[0] = c0 - k0 * RADIX
    outs[1] = outs[1] + k0
    return torch.stack(outs, dim=-1)


def fe_canonical(a: torch.Tensor) -> torch.Tensor:
    """The canonical representative in [0, p), for |limbs| <= 52: add the
    all-positive 4p, ripple three times, subtract p where it fits."""
    a = _fe_carry_exact(_fe_carry_exact(_fe_carry_exact(a + _c("V4P", a))))
    borrow = torch.zeros(a.shape[:-1], dtype=DTYPE, device=a.device)
    outs = []
    for i in range(NLIMBS):
        v = a[..., i] - float(P_LIMBS[i]) - borrow
        borrow = (v < 0).to(DTYPE)
        outs.append(v + borrow * RADIX)
    keep = (borrow == 1.0)[..., None]  # underflow => a < p => keep a
    return torch.where(keep, a, torch.stack(outs, dim=-1))


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(fe_canonical(a) == fe_canonical(b), dim=-1)


def fe_is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(fe_canonical(a) == 0, dim=-1)


# ---------------------------------------------------------------------------
# Byte encodings and the fe_ops_f32 part check
# ---------------------------------------------------------------------------

def fe_from_bytes(rows: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 32] -> limbs of the low 255 bits."""
    return limbs_of_bits(fe25519.bits_of(rows)[..., :255])


def fe_to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Limbs -> canonical 32-byte little-endian encoding, uint8 [..., 32]."""
    c = fe_canonical(a).to(torch.int64)
    bits = (c[..., :, None] >> torch.arange(LIMB_BITS, device=a.device)) & 1
    return fe25519.bytes_of_bits(bits.reshape(a.shape[:-1] + (NLIMBS * LIMB_BITS,)))


def fe_ops(a_rows: torch.Tensor, b_rows: torch.Tensor):
    """Plain version of the ``fe_ops_f32`` kernel: canonical a*b, a^2 and
    a^((p-5)/8) of 255-bit encodings, each uint8 [N, 32]."""
    a, b = fe_from_bytes(a_rows), fe_from_bytes(b_rows)
    return fe_to_bytes(fe_mul(a, b)), fe_to_bytes(fe_sq(a)), fe_to_bytes(fe_pow_p58(a))


def fe_ops_rows(a_rows: torch.Tensor, b_rows: torch.Tensor):
    """The ``fe_ops_f32`` kernel for CUDA tensors, ``fe_ops`` for CPU
    tensors."""
    if a_rows.is_cuda:
        return kernels.fe_ops_f32(a_rows, b_rows)
    return fe_ops(a_rows, b_rows)


# ---------------------------------------------------------------------------
# Point ops — extended coordinates (X, Y, Z, T), T = XY/Z
# ---------------------------------------------------------------------------

def pt_identity(shape, device: torch.device) -> Pt:
    def c(name):
        return const(name, device).expand(tuple(shape) + (NLIMBS,))

    return Pt(c("ZERO"), c("ONE"), c("ONE"), c("ZERO"))


def pt_add(p: Pt, q: Pt, mul=fe_mul) -> Pt:
    """Unified, complete a=-1 addition, its products by `mul`.  With
    reduced inputs, f = d2 - c (up to 153) gets a 3-round partial carry,
    so every product meets the fe_mul contract; the worst is g*h = 153 *
    102 = 15,606."""
    a = mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x))
    b = mul(fe_add(p.y, p.x), fe_add(q.y, q.x))
    c = mul(mul(p.t, q.t), _c("D2", p.t))
    d = mul(p.z, q.z)
    d2 = fe_add(d, d)
    e = fe_sub(b, a)
    f = fe_carry(fe_sub(d2, c), rounds=3)
    g = fe_add(d2, c)
    h = fe_add(b, a)
    return Pt(mul(e, f), mul(g, h), mul(f, g), mul(e, h))


def pt_dbl(p: Pt, mul=fe_mul) -> Pt:
    return pt_dbl_n(p, 1, mul)


def pt_dbl_n(p: Pt, k: int, mul=fe_mul) -> Pt:
    """k chained doublings, T only on the last, the products by `mul`.
    (x + y)^2 goes through the multiply (operand up to 102, past fe_sq's
    63); f = 2c + g (up to 204) gets the 3-round partial carry."""
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
        e = fe_sub(h, mul(xy, xy))
        g = fe_sub(a, b)
        f = fe_carry(fe_add(c, g), rounds=3)
        if i == k - 1:
            return Pt(mul(e, f), mul(g, h), mul(f, g), mul(e, h))
        x, y, z = mul(e, f), mul(g, h), mul(f, g)


def pt_neg(p: Pt) -> Pt:
    # signed limbs: negation is free and keeps magnitudes
    return Pt(-p.x, p.y, p.z, -p.t)


def pt_is_identity(p: Pt) -> torch.Tensor:
    """X == 0 and Y == Z (projective identity test)."""
    return fe_is_zero(p.x) & fe_eq(p.y, p.z)


# ---------------------------------------------------------------------------
# This layout with the matrix-unit fe_mul, as one field object
# ---------------------------------------------------------------------------

_SHARED = ("NLIMBS", "DTYPE", "Pt", "const", "limbs_of_bits", "int_from_limbs",
           "fe_from_bytes", "fe_to_bytes", "fe_carry", "fe_add", "fe_sub", "fe_neg", "fe_sq",
           "fe_canonical", "fe_eq", "fe_is_zero", "pt_identity", "pt_neg", "pt_is_identity")

MXU = types.SimpleNamespace(
    **{name: globals()[name] for name in _SHARED},
    fe_mul=fe_mul_mxu,
    fe_pow_p58=functools.partial(fe_pow_p58, mul=fe_mul_mxu),
    pt_add=functools.partial(pt_add, mul=fe_mul_mxu),
    pt_dbl=functools.partial(pt_dbl, mul=fe_mul_mxu),
    pt_dbl_n=functools.partial(pt_dbl_n, mul=fe_mul_mxu),
)
"""The f32 layout whose fe_mul is ``fe_mul_mxu`` (squarings keep
``fe_sq``, as in the JAX module): what ``_Core("f32", fe_mxu=True)``
computes with, the plain version of the kernels on ``csrc/fe_f32_mma.cuh``."""
