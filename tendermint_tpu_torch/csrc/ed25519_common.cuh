// Field and point arithmetic of GF(2^255 - 19) and edwards25519, shared by
// the kernels of this directory (ed25519_verify.cu, ed25519_rlc.cu).
//
// Replaces the device functions of tendermint_tpu/ops/fe25519.py (the
// 15 x 17-bit int64 field of the JAX package) and `_Core.decompress` of
// tendermint_tpu/ops/ed25519_jax.py.
//
// Field elements are 5 limbs of 51 bits in uint64 with 128-bit
// accumulation (the curve25519 "donna-64" layout).  Bounds: fe_mul and
// fe_sq take limbs < 2^54 and return limbs < 2^51 + 2^13; fe_sub and
// fe_neg add 4p in limb form and return weakly reduced limbs; fe_add of
// two reduced values stays < 2^53.  Every formula keeps its multiplier
// inputs under 2^54.
//
// Everything here also compiles as plain C++ (without __CUDACC__), so
// each kernel source has a host build that runs the same arithmetic on
// the CPU; with TM_COUNT_FIELD_OPS that build counts the field
// multiplies and squarings (tm_take_field_op_counts).

#ifndef TM_ED25519_COMMON_CUH
#define TM_ED25519_COMMON_CUH

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TM_DEV __device__ __forceinline__
#else
#define TM_DEV static inline
#endif

#if defined(TM_COUNT_FIELD_OPS) && !defined(__CUDACC__)
static uint64_t tm_count_mul, tm_count_sq;
#define TM_COUNT(c) (++(c))
#else
#define TM_COUNT(c) ((void)0)
#endif

typedef uint64_t u64;
typedef unsigned __int128 u128;

#define MASK51 ((u64(1) << 51) - 1)

struct fe {
    u64 v[5];
};

struct pt {
    fe x, y, z, t;
};

// ---------------------------------------------------------------------------
// Constants (5 x 51-bit limbs)
// ---------------------------------------------------------------------------

TM_DEV fe fe_zero() { fe r = {{0, 0, 0, 0, 0}}; return r; }
TM_DEV fe fe_one() { fe r = {{1, 0, 0, 0, 0}}; return r; }
TM_DEV fe fe_d() {
    fe r = {{0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL,
             0x739c663a03cbbULL, 0x52036cee2b6ffULL}};
    return r;
}
TM_DEV fe fe_d2() {
    fe r = {{0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL,
             0x6738cc7407977ULL, 0x2406d9dc56dffULL}};
    return r;
}
TM_DEV fe fe_sqrtm1() {
    fe r = {{0x61b274a0ea0b0ULL, 0x0d5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL,
             0x78595a6804c9eULL, 0x2b8324804fc1dULL}};
    return r;
}

// 4p in limb form: 4*(2^51 - 19), then 4*(2^51 - 1)
#define FOUR_P0 0x1fffffffffffb4ULL
#define FOUR_PI 0x1ffffffffffffcULL

// ---------------------------------------------------------------------------
// Field arithmetic, GF(2^255 - 19)
// ---------------------------------------------------------------------------

// Weak reduction: any limbs < 2^64 -> limbs < 2^51 + 2^18.
TM_DEV fe fe_reduce(fe a) {
    u64 c0 = a.v[0] >> 51, c1 = a.v[1] >> 51, c2 = a.v[2] >> 51;
    u64 c3 = a.v[3] >> 51, c4 = a.v[4] >> 51;
    fe r;
    r.v[0] = (a.v[0] & MASK51) + c4 * 19;
    r.v[1] = (a.v[1] & MASK51) + c0;
    r.v[2] = (a.v[2] & MASK51) + c1;
    r.v[3] = (a.v[3] & MASK51) + c2;
    r.v[4] = (a.v[4] & MASK51) + c3;
    return r;
}

TM_DEV fe fe_add(const fe& a, const fe& b) {
    fe r;
    for (int i = 0; i < 5; ++i) r.v[i] = a.v[i] + b.v[i];
    return r;
}

// a - b + 4p, weakly reduced; b's limbs must be < 2^53 - 76.
TM_DEV fe fe_sub(const fe& a, const fe& b) {
    fe r;
    r.v[0] = a.v[0] + FOUR_P0 - b.v[0];
    for (int i = 1; i < 5; ++i) r.v[i] = a.v[i] + FOUR_PI - b.v[i];
    return fe_reduce(r);
}

TM_DEV fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

TM_DEV u128 mul64(u64 a, u64 b) { return (u128)a * b; }

// Carry five 128-bit columns into limbs < 2^51 + 2^13.  Column 4 holds no
// x19 terms, so its carry-out times 19 fits in 64 bits.
TM_DEV fe fe_carry_cols(u128 c0, u128 c1, u128 c2, u128 c3, u128 c4) {
    fe r;
    c1 += (u64)(c0 >> 51);
    r.v[0] = (u64)c0 & MASK51;
    c2 += (u64)(c1 >> 51);
    r.v[1] = (u64)c1 & MASK51;
    c3 += (u64)(c2 >> 51);
    r.v[2] = (u64)c2 & MASK51;
    c4 += (u64)(c3 >> 51);
    r.v[3] = (u64)c3 & MASK51;
    u64 carry = (u64)(c4 >> 51);
    r.v[4] = (u64)c4 & MASK51;
    r.v[0] += carry * 19;
    r.v[1] += r.v[0] >> 51;
    r.v[0] &= MASK51;
    return r;
}

// Schoolbook product with the 2^255 = 19 fold; limbs < 2^54 in.
TM_DEV fe fe_mul(const fe& a, const fe& b) {
    TM_COUNT(tm_count_mul);
    const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
    const u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
    const u64 b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19, b4_19 = b4 * 19;
    u128 c0 = mul64(a0, b0) + mul64(a4, b1_19) + mul64(a3, b2_19) + mul64(a2, b3_19) + mul64(a1, b4_19);
    u128 c1 = mul64(a1, b0) + mul64(a0, b1) + mul64(a4, b2_19) + mul64(a3, b3_19) + mul64(a2, b4_19);
    u128 c2 = mul64(a2, b0) + mul64(a1, b1) + mul64(a0, b2) + mul64(a4, b3_19) + mul64(a3, b4_19);
    u128 c3 = mul64(a3, b0) + mul64(a2, b1) + mul64(a1, b2) + mul64(a0, b3) + mul64(a4, b4_19);
    u128 c4 = mul64(a4, b0) + mul64(a3, b1) + mul64(a2, b2) + mul64(a1, b3) + mul64(a0, b4);
    return fe_carry_cols(c0, c1, c2, c3, c4);
}

// Squaring: 15 limb products instead of 25 (cross terms doubled).
TM_DEV fe fe_sq(const fe& a) {
    TM_COUNT(tm_count_sq);
    const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
    const u64 a3_19 = a3 * 19, a4_19 = a4 * 19;
    u128 c0 = mul64(a0, a0) + 2 * (mul64(a1, a4_19) + mul64(a2, a3_19));
    u128 c1 = mul64(a3, a3_19) + 2 * (mul64(a0, a1) + mul64(a2, a4_19));
    u128 c2 = mul64(a1, a1) + 2 * (mul64(a0, a2) + mul64(a4, a3_19));
    u128 c3 = mul64(a4, a4_19) + 2 * (mul64(a0, a3) + mul64(a1, a2));
    u128 c4 = mul64(a2, a2) + 2 * (mul64(a0, a4) + mul64(a1, a3));
    return fe_carry_cols(c0, c1, c2, c3, c4);
}

TM_DEV fe fe_pow2k(fe a, int k) {
    for (int i = 0; i < k; ++i) a = fe_sq(a);
    return a;
}

// a^((p-5)/8) = a^(2^252 - 3): 251 squarings, 11 multiplies.
TM_DEV fe fe_pow_p58(const fe& a) {
    fe z2 = fe_sq(a);
    fe z8 = fe_pow2k(z2, 2);
    fe z9 = fe_mul(z8, a);
    fe z11 = fe_mul(z9, z2);
    fe z22 = fe_sq(z11);
    fe z_5_0 = fe_mul(z22, z9);
    fe z_10_0 = fe_mul(fe_pow2k(z_5_0, 5), z_5_0);
    fe z_20_0 = fe_mul(fe_pow2k(z_10_0, 10), z_10_0);
    fe z_40_0 = fe_mul(fe_pow2k(z_20_0, 20), z_20_0);
    fe z_50_0 = fe_mul(fe_pow2k(z_40_0, 10), z_10_0);
    fe z_100_0 = fe_mul(fe_pow2k(z_50_0, 50), z_50_0);
    fe z_200_0 = fe_mul(fe_pow2k(z_100_0, 100), z_100_0);
    fe z_250_0 = fe_mul(fe_pow2k(z_200_0, 50), z_50_0);
    return fe_mul(fe_pow2k(z_250_0, 2), a);
}

// The canonical representative in [0, p), each limb < 2^51.
TM_DEV fe fe_canonical(fe a) {
    a = fe_reduce(a);  // value < 2^255 + 2^18 < 2p
    u64 q = (a.v[0] + 19) >> 51;  // q = 1 iff value >= p
    q = (a.v[1] + q) >> 51;
    q = (a.v[2] + q) >> 51;
    q = (a.v[3] + q) >> 51;
    q = (a.v[4] + q) >> 51;
    a.v[0] += 19 * q;
    a.v[1] += a.v[0] >> 51;
    a.v[0] &= MASK51;
    a.v[2] += a.v[1] >> 51;
    a.v[1] &= MASK51;
    a.v[3] += a.v[2] >> 51;
    a.v[2] &= MASK51;
    a.v[4] += a.v[3] >> 51;
    a.v[3] &= MASK51;
    a.v[4] &= MASK51;  // drops 2^255, completing the subtraction of p
    return a;
}

TM_DEV bool fe_eq(const fe& a, const fe& b) {
    fe ca = fe_canonical(a), cb = fe_canonical(b);
    u64 d = 0;
    for (int i = 0; i < 5; ++i) d |= ca.v[i] ^ cb.v[i];
    return d == 0;
}

TM_DEV bool fe_is_zero(const fe& a) {
    fe c = fe_canonical(a);
    return (c.v[0] | c.v[1] | c.v[2] | c.v[3] | c.v[4]) == 0;
}

TM_DEV u64 load_le64(const uint8_t* p) {
    u64 w = 0;
    for (int i = 7; i >= 0; --i) w = (w << 8) | p[i];
    return w;
}

// The low 255 bits of a 32-byte little-endian encoding (bit 255 dropped;
// the value may be >= p, which the arithmetic tolerates).
TM_DEV fe fe_frombytes(const uint8_t* p) {
    u64 w0 = load_le64(p), w1 = load_le64(p + 8), w2 = load_le64(p + 16), w3 = load_le64(p + 24);
    fe r;
    r.v[0] = w0 & MASK51;
    r.v[1] = ((w0 >> 51) | (w1 << 13)) & MASK51;
    r.v[2] = ((w1 >> 38) | (w2 << 26)) & MASK51;
    r.v[3] = ((w2 >> 25) | (w3 << 39)) & MASK51;
    r.v[4] = (w3 >> 12) & MASK51;
    return r;
}

TM_DEV void fe_tobytes(uint8_t* out, const fe& a) {
    fe c = fe_canonical(a);
    u64 w[4];
    w[0] = c.v[0] | (c.v[1] << 51);
    w[1] = (c.v[1] >> 13) | (c.v[2] << 38);
    w[2] = (c.v[2] >> 26) | (c.v[3] << 25);
    w[3] = (c.v[3] >> 39) | (c.v[4] << 12);
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j) out[8 * i + j] = (uint8_t)(w[i] >> (8 * j));
}

// ---------------------------------------------------------------------------
// Point arithmetic: extended coordinates (X, Y, Z, T), T = XY/Z, a = -1
// ---------------------------------------------------------------------------

TM_DEV pt pt_identity() {
    pt r = {fe_zero(), fe_one(), fe_one(), fe_zero()};
    return r;
}

// Unified, complete addition (add-2008-hwcd-3 with 2d): right for every
// pair of curve points, identity, doubling and small-order inputs included.
TM_DEV pt pt_add(const pt& p, const pt& q) {
    fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
    fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
    fe c = fe_mul(fe_mul(p.t, q.t), fe_d2());
    fe d = fe_mul(p.z, q.z);
    fe d2 = fe_add(d, d);
    fe e = fe_sub(b, a);
    fe f = fe_sub(d2, c);
    fe g = fe_add(d2, c);
    fe h = fe_add(b, a);
    pt r = {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
    return r;
}

// Doubling (dbl-2008-hwcd, complete for every point).  It reads only X, Y,
// Z; with_t=false skips T = E*H for a result that is only doubled again.
TM_DEV pt pt_dbl(const pt& p, bool with_t) {
    fe a = fe_sq(p.x);
    fe b = fe_sq(p.y);
    fe c = fe_sq(p.z);
    c = fe_add(c, c);
    fe h = fe_add(a, b);
    fe e = fe_sub(h, fe_sq(fe_add(p.x, p.y)));  // -2XY
    fe g = fe_sub(a, b);
    fe f = fe_add(c, g);
    pt r;
    r.x = fe_mul(e, f);
    r.y = fe_mul(g, h);
    r.z = fe_mul(f, g);
    r.t = with_t ? fe_mul(e, h) : fe_zero();
    return r;
}

TM_DEV pt pt_neg(const pt& p) {
    pt r = {fe_neg(p.x), p.y, p.z, fe_neg(p.t)};
    return r;
}

// X == 0 and Y == Z: the projective identity test.
TM_DEV bool pt_is_identity(const pt& p) { return fe_is_zero(p.x) && fe_eq(p.y, p.z); }

// Permissive (ZIP-215) decompression of a 32-byte encoding: y >= p is
// accepted and reduced, x = 0 with sign 1 is accepted, the sign flip is
// taken on the canonical x.  Returns whether the point is on the curve.
TM_DEV bool decompress(pt& out, const uint8_t* enc) {
    const fe one = fe_one();
    fe y = fe_frombytes(enc);
    u64 sign = enc[31] >> 7;
    fe yy = fe_sq(y);
    fe u = fe_sub(yy, one);
    fe v = fe_reduce(fe_add(fe_mul(yy, fe_d()), one));
    fe v3 = fe_mul(fe_sq(v), v);
    fe v7 = fe_mul(fe_sq(v3), v);
    fe t = fe_pow_p58(fe_mul(u, v7));
    fe x = fe_mul(fe_mul(u, v3), t);  // candidate sqrt(u/v)
    fe vx2 = fe_mul(v, fe_sq(x));
    bool is_pos = fe_eq(vx2, u);
    bool is_neg = fe_eq(vx2, fe_neg(u));
    fe xi = fe_mul(x, fe_sqrtm1());
    if (is_neg) x = xi;
    fe cx = fe_canonical(x);
    x = ((cx.v[0] & 1) != sign) ? fe_neg(cx) : cx;
    fe yr = fe_canonical(y);
    out.x = x;
    out.y = yr;
    out.z = one;
    out.t = fe_mul(x, yr);
    return is_pos || is_neg;
}

TM_DEV int nibble(const uint8_t* scalar, int i) { return (scalar[i >> 1] >> ((i & 1) * 4)) & 15; }

#if defined(TM_COUNT_FIELD_OPS) && !defined(__CUDACC__)
// The multiplies and squarings counted since the last call; resets both.
static void tm_take_field_op_counts(uint64_t* mul_sq) {
    mul_sq[0] = tm_count_mul;
    mul_sq[1] = tm_count_sq;
    tm_count_mul = tm_count_sq = 0;
}
#endif

#endif  // TM_ED25519_COMMON_CUH
