"""Pure-Python Ed25519: RFC 8032 signing, ZIP-215 verification.

Counterpart of ``tendermint_tpu/crypto/ed25519.py``: the semantics oracle
the port's plain versions and CUDA kernels are tested against.

ZIP-215 rules (https://zips.z.cash/zip-0215):
  1. ``s`` must be canonical: 0 <= s < L.
  2. Point encodings for A and R are decoded permissively: y is taken
     mod p (y >= p accepted), small-order points are accepted, and
     x = 0 with sign bit 1 is accepted as -0 = 0.
  3. The cofactored equation [8][s]B == [8]R + [8][k]A holds, with
     k = SHA-512(R || A || M) mod L.

Signing and key derivation go through a fixed-base table of
[j * 16^i]B (64 windows x 16 digits, the same table the verify kernel
reads): 63 additions per scalar multiple instead of ~253 doublings.
The signatures are byte-identical to RFC 8032's.
"""

from __future__ import annotations

import functools
import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

NWINDOWS = 64  # scalars < 2^256 as 64 little-endian radix-16 digits

_BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int) -> int | None:
    """x with x^2 = (y^2-1)/(d y^2+1); the principal root, or None."""
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    x = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    vx2 = v * x % P * x % P
    if vx2 == u:
        return x
    if vx2 == (-u) % P:
        return x * SQRT_M1 % P
    return None


_BX = _recover_x(_BY)
if _BX & 1:
    _BX = P - _BX

# Extended homogeneous coordinates (X, Y, Z, T), T = XY/Z.
Point = tuple[int, int, int, int]
IDENTITY: Point = (0, 1, 1, 0)
BASE: Point = (_BX, _BY, 1, _BX * _BY % P)


def pt_add(p: Point, q: Point) -> Point:
    """Unified addition for a=-1 twisted Edwards (complete)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 % P * t2 % P * D % P
    dd = 2 * z1 % P * z2 % P
    e = b - a
    f = dd - c
    g = dd + c
    h = b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def pt_double(p: Point) -> Point:
    return pt_add(p, p)


def pt_neg(p: Point) -> Point:
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def pt_equal(p: Point, q: Point) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def scalar_mult(k: int, p: Point) -> Point:
    """Double-and-add, MSB first.  Not constant-time (reference only)."""
    acc = IDENTITY
    for i in reversed(range(k.bit_length())):
        acc = pt_double(acc)
        if (k >> i) & 1:
            acc = pt_add(acc, p)
    return acc


@functools.cache
def base_point_table() -> tuple[tuple[Point, ...], ...]:
    """[j * 16^i]B for i in 0..63, j in 0..15, as big-int extended
    coordinates — built exactly as ``ed25519_jax._base_point_table``."""
    rows = []
    g = BASE
    for _i in range(NWINDOWS):
        rows.append(tuple(scalar_mult(j, g) for j in range(16)))
        g = scalar_mult(16, g)
    return tuple(rows)


@functools.cache
def base_point_table256() -> tuple[tuple[Point, ...], ...]:
    """[j * 256^i]B for i in 0..31, j in 0..255, the w=8 comb's table (a
    signature's 32 s bytes are its radix-256 digits), built by additions
    and doublings exactly as ``ed25519_jax._base_point_table256``."""
    rows = []
    g = BASE
    for _i in range(32):
        row = [IDENTITY]
        for _j in range(255):
            row.append(pt_add(row[-1], g))
        rows.append(tuple(row))
        for _ in range(8):
            g = pt_double(g)
    return tuple(rows)


def scalar_mult_base(k: int) -> Point:
    """[k]B for 0 <= k < 2^256 from the fixed-base table: one addition
    per radix-16 digit, no doublings."""
    if not 0 <= k < 1 << 256:
        raise ValueError("scalar out of range")
    table = base_point_table()
    acc = table[0][k & 15]
    for i in range(1, NWINDOWS):
        acc = pt_add(acc, table[i][(k >> (4 * i)) & 15])
    return acc


def encode_point(p: Point) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x = x * zi % P
    y = y * zi % P
    enc = y | ((x & 1) << 255)
    return enc.to_bytes(32, "little")


def decode_point_zip215(b: bytes) -> Point | None:
    """Permissive ZIP-215 decompression.  None if not on the curve."""
    if len(b) != 32:
        return None
    full = int.from_bytes(b, "little")
    sign = full >> 255
    y = (full & ((1 << 255) - 1)) % P  # y >= p accepted, reduced
    x = _recover_x(y)
    if x is None:
        return None
    if (x & 1) != sign:
        x = P - x if x != 0 else 0  # -0 = 0: x=0/sign=1 accepted
    return (x, y, 1, x * y % P)


# ---------------------------------------------------------------------------
# RFC 8032 keygen / sign
# ---------------------------------------------------------------------------

def _clamp(h32: bytes) -> int:
    a = int.from_bytes(h32, "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def pubkey_from_seed(seed: bytes) -> bytes:
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    return encode_point(scalar_mult_base(_clamp(h[:32])))


def sign(seed: bytes, msg: bytes, pub: bytes | None = None) -> bytes:
    """Deterministic RFC 8032 signature; seed is the 32-byte private
    seed.  `pub` may pass the seed's public key to skip re-deriving it."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h[:32])
    prefix = h[32:]
    if pub is None:
        pub = encode_point(scalar_mult_base(a))
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = encode_point(scalar_mult_base(r))
    k = compute_k(R, pub, msg)
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


# ---------------------------------------------------------------------------
# ZIP-215 verification
# ---------------------------------------------------------------------------

def compute_k(r_bytes: bytes, pub: bytes, msg: bytes) -> int:
    return int.from_bytes(hashlib.sha512(r_bytes + pub + msg).digest(), "little") % L


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 single-signature verification (reference semantics)."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    r_bytes, s_bytes = sig[:32], sig[32:]
    s = int.from_bytes(s_bytes, "little")
    if s >= L:
        return False
    a_pt = decode_point_zip215(pub)
    r_pt = decode_point_zip215(r_bytes)
    if a_pt is None or r_pt is None:
        return False
    k = compute_k(r_bytes, pub, msg)
    # [8]([s]B - [k]A - R) == identity
    q = pt_add(scalar_mult_base(s), pt_add(pt_neg(scalar_mult(k, a_pt)), pt_neg(r_pt)))
    q8 = pt_double(pt_double(pt_double(q)))
    return pt_equal(q8, IDENTITY)


# ---------------------------------------------------------------------------
# Adversarial-vector helpers (small-order / non-canonical encodings)
# ---------------------------------------------------------------------------

def eight_torsion_points() -> list[Point]:
    """The 8-torsion subgroup, found by clearing the prime factor from a
    point outside the prime-order subgroup."""
    pts = [IDENTITY]
    y = 2
    gen = None
    while gen is None:
        cand = _recover_x(y)
        if cand is not None:
            p0 = (cand, y, 1, cand * y % P)
            t = scalar_mult(L, p0)
            if not pt_equal(t, IDENTITY):
                gen = t
        y += 1
    cur = gen
    while not pt_equal(cur, IDENTITY):
        if not any(pt_equal(cur, q) for q in pts):
            pts.append(cur)
        cur = pt_add(cur, gen)
    extras = [(0, P - 1, 1, 0), (SQRT_M1, 0, 1, 0), (P - SQRT_M1, 0, 1, 0)]
    for e in extras:
        if not any(pt_equal(e, q) for q in pts):
            pts.append(e)
    out = []
    for q in pts:
        for r in pts:
            c = pt_add(q, r)
            if not any(pt_equal(c, z) for z in out):
                out.append(c)
    return out


def noncanonical_encodings(p: Point) -> list[bytes]:
    """All serializations of `p` accepted by ZIP-215: canonical encoding,
    flipped sign bit when x == 0, and y+p when y < 19 (fits in 255 bits)."""
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    encs = []
    for sign_bit in (0, 1):
        if sign_bit != (x & 1) and x != 0:
            continue
        for yy in ([y, y + P] if y + P < (1 << 255) else [y]):
            encs.append((yy | (sign_bit << 255)).to_bytes(32, "little"))
    return encs
