// Field and point arithmetic of GF(2^255 - 19) and edwards25519 in 5 x
// 51-bit limbs, and the field-agnostic curve pipeline every verify kernel
// of this directory is built from (ed25519_verify.cu, ed25519_rlc.cuh,
// ed25519_verify_packed.cu, ed25519_verify_f32.cu,
// ed25519_verify_f32_mma.cu).
//
// Replaces the device functions of tendermint_tpu/ops/fe25519.py (the
// 15 x 17-bit int64 field of the JAX package) and `_Core.decompress`,
// `_scalarmul_base`, `_scalarmul_var` and `verify_core` of
// tendermint_tpu/ops/ed25519_jax.py.
//
// Field elements are 5 limbs of 51 bits in uint64 with 128-bit
// accumulation (the curve25519 "donna-64" layout).  Bounds: fe_mul and
// fe_sq take limbs < 2^54 and return limbs < 2^51 + 2^13; fe_sub and
// fe_neg add 4p in limb form and return weakly reduced limbs; fe_add of
// two reduced values stays < 2^53.  Every formula keeps its multiplier
// inputs under 2^54.
//
// The curve pipeline (decompress, the fixed-base and variable-base
// scalar multiples, the verdict) is written once, as templates over the
// field element E, like the JAX package's `_Core(fe)`: each layout
// (struct fe here, fp in fe_packed.cuh, ff in fe_f32.cuh) supplies, as
// overloads on E, fe_add, fe_sub, fe_neg, fe_mul, fe_sq, fe_carry (its
// default weak reduction), fe_canonical, fe_eq, fe_is_zero, fe_is_odd
// and fe_tobytes; as overloads on point<E>, pt_add, pt_dbl, pt_neg and
// pt_is_identity (each layout keeps its JAX module's formulas); and, in
// field<E>, its limb type, limb count, constants and byte unpacking.
//
// Everything here also compiles as plain C++ (without __CUDACC__), so
// each kernel source has a host build that runs the same arithmetic on
// the CPU; with TM_COUNT_FIELD_OPS that build counts the field
// multiplies and squarings (tm_take_field_op_counts).
//
// The pipeline calls every field operation of a row unconditionally, for
// any input: decompress selects its square root, the ladders select table
// entries by index, and the verdict ANDs flags computed before it.  So the
// same code serves a warp-collective fe_mul (collective_mul).

#ifndef TM_ED25519_COMMON_CUH
#define TM_ED25519_COMMON_CUH

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TM_DEV __device__ __forceinline__
#define TM_DEVM __device__ __forceinline__  // a static member function
#define TM_NOINLINE static __device__ __noinline__  // one copy per source
#else
#define TM_DEV static inline
#define TM_DEVM inline
#define TM_NOINLINE static
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

// A point in extended coordinates (X, Y, Z, T), T = XY/Z, a = -1.
template <class E>
struct point {
    E x, y, z, t;
};
typedef point<fe> pt;

// Per layout: the limb type and count, the constants and the unpacking
// of a 32-byte little-endian encoding (its low 255 bits).
template <class E>
struct field;

// Whether E's fe_mul is warp-collective (the tensor-core product of
// fe_f32_mma.cuh): every lane of a warp must then call every fe_mul
// together, so a kernel on E runs rows past N as dummy rows to the end and
// keeps each field operation out of data-dependent branches (a select is
// fine).  The pipeline below never branches around a multiply; rlc_fold,
// which adds on part of a warp, asserts that its E is not collective.
template <class E>
struct collective_mul {
    enum { value = 0 };
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

template <class E>
TM_DEV E fe_pow2k(E a, int k) {
    for (int i = 0; i < k; ++i) a = fe_sq(a);
    return a;
}

// a^((p-5)/8) = a^(2^252 - 3): 251 squarings, 11 multiplies, in any layout.
template <class E>
TM_DEV E fe_pow_p58(const E& a) {
    E z2 = fe_sq(a);
    E z8 = fe_pow2k(z2, 2);
    E z9 = fe_mul(z8, a);
    E z11 = fe_mul(z9, z2);
    E z22 = fe_sq(z11);
    E z_5_0 = fe_mul(z22, z9);
    E z_10_0 = fe_mul(fe_pow2k(z_5_0, 5), z_5_0);
    E z_20_0 = fe_mul(fe_pow2k(z_10_0, 10), z_10_0);
    E z_40_0 = fe_mul(fe_pow2k(z_20_0, 20), z_20_0);
    E z_50_0 = fe_mul(fe_pow2k(z_40_0, 10), z_10_0);
    E z_100_0 = fe_mul(fe_pow2k(z_50_0, 50), z_50_0);
    E z_200_0 = fe_mul(fe_pow2k(z_100_0, 100), z_100_0);
    E z_250_0 = fe_mul(fe_pow2k(z_200_0, 50), z_50_0);
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

TM_DEV fe fe_carry(const fe& a) { return fe_reduce(a); }

TM_DEV bool fe_is_odd(const fe& canonical) { return canonical.v[0] & 1; }

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

// The 255-bit value's four little-endian 64-bit words, bit 255 dropped.
TM_DEV void load_words255(u64 w[4], const uint8_t* p) {
    for (int i = 0; i < 4; ++i) w[i] = load_le64(p + 8 * i);
    w[3] &= ~(u64(1) << 63);
}

// Bits [lo, lo + width) of the words (width <= 32).
TM_DEV u64 bits_at(const u64 w[4], int lo, int width) {
    int i = lo >> 6, sh = lo & 63;
    u64 v = w[i] >> sh;
    if (sh + width > 64) v |= w[i + 1] << (64 - sh);
    return v & ((u64(1) << width) - 1);
}

// Adds v << lo into the words (v < 2^32, the words' bits there clear).
TM_DEV void put_bits(u64 w[4], int lo, u64 v) {
    int i = lo >> 6, sh = lo & 63;
    w[i] |= v << sh;
    if (sh && i < 3) w[i + 1] |= v >> (64 - sh);
}

TM_DEV void store_words(uint8_t* out, const u64 w[4]) {
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j) out[8 * i + j] = (uint8_t)(w[i] >> (8 * j));
}

template <>
struct field<fe> {
    typedef u64 limb;
    enum { N = 5 };
    static TM_DEVM fe zero() { return fe_zero(); }
    static TM_DEVM fe one() { return fe_one(); }
    static TM_DEVM fe d() { return fe_d(); }
    static TM_DEVM fe sqrtm1() { return fe_sqrtm1(); }
    static TM_DEVM fe frombytes(const uint8_t* p) { return fe_frombytes(p); }
};

// D, 2D and sqrt(-1) as the words of their canonical encodings, for the
// layouts that unpack their constants from words.
#define TM_D_WORDS {0x75eb4dca135978a3ULL, 0x00700a4d4141d8abULL, 0x8cc740797779e898ULL, 0x52036cee2b6ffe73ULL}
#define TM_D2_WORDS {0xebd69b9426b2f159ULL, 0x00e0149a8283b156ULL, 0x198e80f2eef3d130ULL, 0x2406d9dc56dffce7ULL}
#define TM_SQRTM1_WORDS {0xc4ee1b274a0ea0b0ULL, 0x2f431806ad2fe478ULL, 0x2b4d00993dfbd7a7ULL, 0x2b8324804fc1df0bULL}

// ---------------------------------------------------------------------------
// Point arithmetic: extended coordinates (X, Y, Z, T), T = XY/Z, a = -1
// ---------------------------------------------------------------------------

template <class E>
TM_DEV point<E> pt_identity() {
    point<E> r = {field<E>::zero(), field<E>::one(), field<E>::one(), field<E>::zero()};
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

// ---------------------------------------------------------------------------
// The curve pipeline, in any layout
// ---------------------------------------------------------------------------

// Permissive (ZIP-215) decompression of a 32-byte encoding, the JAX
// package's `_Core.decompress` step for step: y >= p is accepted and
// reduced, x = 0 with sign 1 is accepted, the sign flip is taken on the
// canonical x.  Returns whether the point is on the curve.
template <class E>
TM_DEV bool decompress(point<E>& out, const uint8_t* enc) {
    const E one = field<E>::one();
    E y = field<E>::frombytes(enc);
    bool sign = enc[31] >> 7;
    E yy = fe_sq(y);
    E u = fe_sub(yy, one);
    E v = fe_carry(fe_add(fe_mul(yy, field<E>::d()), one));
    E v3 = fe_mul(fe_sq(v), v);
    E v7 = fe_mul(fe_sq(v3), v);
    E t = fe_pow_p58(fe_mul(u, v7));
    E x = fe_mul(fe_mul(u, v3), t);  // candidate sqrt(u/v)
    E vx2 = fe_mul(v, fe_sq(x));
    bool is_pos = fe_eq(vx2, u);
    bool is_neg = fe_eq(vx2, fe_carry(fe_neg(fe_canonical(u))));
    E xi = fe_mul(x, field<E>::sqrtm1());
    if (is_neg) x = xi;
    E cx = fe_canonical(x);
    x = fe_is_odd(cx) != sign ? fe_carry(fe_neg(cx)) : cx;
    E yr = fe_canonical(y);
    out.x = x;
    out.y = yr;
    out.z = one;
    out.t = fe_mul(x, yr);
    return is_pos || is_neg;
}

TM_DEV int nibble(const uint8_t* scalar, int i) { return (scalar[i >> 1] >> ((i & 1) * 4)) & 15; }

// Entry (window i, digit j) of a fixed-base table [64][16][4][N] of the
// layout's limbs: [j * 16^i]B as X, Y, Z, T.
template <class E>
TM_DEV point<E> table_entry(const typename field<E>::limb* table, int i, int j) {
    const int n = field<E>::N;
    const typename field<E>::limb* e = table + (size_t)((i * 16 + j) * 4) * n;
    point<E> r;
    for (int l = 0; l < n; ++l) {
        r.x.v[l] = e[l];
        r.y.v[l] = e[n + l];
        r.z.v[l] = e[2 * n + l];
        r.t.v[l] = e[3 * n + l];
    }
    return r;
}

// [s]B: one addition per radix-16 digit, no doublings.
template <class E>
TM_DEV point<E> scalarmul_base(const typename field<E>::limb* table, const uint8_t* s) {
    point<E> acc = table_entry<E>(table, 0, nibble(s, 0));
    for (int i = 1; i < 64; ++i) acc = pt_add(acc, table_entry<E>(table, i, nibble(s, i)));
    return acc;
}

// [k](-A) by 4-bit fixed windows: 16 multiples of -A (14 additions), then
// 63 x (4 doublings + 1 addition), most significant digit first.
template <class E>
TM_DEV point<E> scalarmul_var(const uint8_t* k, const point<E>& neg_a) {
    point<E> tbl[16];
    tbl[0] = pt_identity<E>();
    tbl[1] = neg_a;
    for (int j = 2; j < 16; ++j) tbl[j] = pt_add(tbl[j - 1], neg_a);
    point<E> acc = tbl[nibble(k, 63)];
    for (int i = 62; i >= 0; --i) {
        acc = pt_dbl(acc, false);
        acc = pt_dbl(acc, false);
        acc = pt_dbl(acc, false);
        acc = pt_dbl(acc, true);
        acc = pt_add(acc, tbl[nibble(k, i)]);
    }
    return acc;
}

// [8]([s]B + [k](-A) - R) == O, from [s]B, A and R.
template <class E>
TM_DEV bool verdict(const point<E>& sb, const point<E>& a_pt, const point<E>& r_pt,
                    const uint8_t* k) {
    point<E> w = pt_add(sb, scalarmul_var(k, pt_neg(a_pt)));
    point<E> q = pt_add(w, pt_neg(r_pt));
    q = pt_dbl(q, false);
    q = pt_dbl(q, false);
    q = pt_dbl(q, false);
    return pt_is_identity(q);
}

// One row: valid && A, R on the curve && [8]([s]B + [k](-A) - R) == O.
template <class E>
TM_DEV bool verify_row(const uint8_t* pub, const uint8_t* r, const uint8_t* s, const uint8_t* k,
                       bool valid, const typename field<E>::limb* table) {
    point<E> a_pt, r_pt;
    bool ok_a = decompress(a_pt, pub);
    bool ok_r = decompress(r_pt, r);
    bool id = verdict(scalarmul_base<E>(table, s), a_pt, r_pt, k);
    return valid && ok_a && ok_r && id;
}

// The same row with [s]B given (by the comb, base_comb.cuh).
template <class E>
TM_DEV bool verify_row_from_base(const point<E>& sb, const uint8_t* pub, const uint8_t* r,
                                 const uint8_t* k, bool valid) {
    point<E> a_pt, r_pt;
    bool ok_a = decompress(a_pt, pub);
    bool ok_r = decompress(r_pt, r);
    bool id = verdict(sb, a_pt, r_pt, k);
    return valid && ok_a && ok_r && id;
}

// The fe_ops part check: canonical a*b, a^2 and a^((p-5)/8).
template <class E>
TM_DEV void fe_ops_row(const uint8_t* a_enc, const uint8_t* b_enc, uint8_t* out_mul,
                       uint8_t* out_sq, uint8_t* out_p58) {
    E a = field<E>::frombytes(a_enc), b = field<E>::frombytes(b_enc);
    fe_tobytes(out_mul, fe_mul(a, b));
    fe_tobytes(out_sq, fe_sq(a));
    fe_tobytes(out_p58, fe_pow_p58(a));
}

// ---------------------------------------------------------------------------
// Per-row kernels and their launchers, in any layout (one thread per row)
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

#define TM_THREADS 64

static int blocks_for(int n) { return (n + TM_THREADS - 1) / TM_THREADS; }

// A thread past N runs row 0 as a dummy to the end and stores nothing, so
// that every lane of a warp takes part in a collective fe_mul.
template <class E>
static __global__ void verify_kernel(const uint8_t* __restrict__ pub, const uint8_t* __restrict__ r,
                                     const uint8_t* __restrict__ s, const uint8_t* __restrict__ k,
                                     const uint8_t* __restrict__ valid,
                                     const typename field<E>::limb* __restrict__ table,
                                     uint8_t* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const size_t o = (size_t)(live ? i : 0) * 32;
    const bool ok = verify_row<E>(pub + o, r + o, s + o, k + o, valid[live ? i : 0] != 0, table);
    if (live) out[i] = ok ? 1 : 0;
}

template <class E>
static __global__ void fe_ops_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                                     uint8_t* __restrict__ out_mul, uint8_t* __restrict__ out_sq,
                                     uint8_t* __restrict__ out_p58, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    size_t o = (size_t)i * 32;
    fe_ops_row<E>(a + o, b + o, out_mul + o, out_sq + o, out_p58 + o);
}

template <class E>
static int launch_verify(const void* pub, const void* r, const void* s, const void* k,
                         const void* valid, const void* table, void* out, int n, void* stream) {
    if (n > 0)
        verify_kernel<E><<<blocks_for(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)pub, (const uint8_t*)r, (const uint8_t*)s, (const uint8_t*)k,
            (const uint8_t*)valid, (const typename field<E>::limb*)table, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}

template <class E>
static int launch_fe_ops(const void* a, const void* b, void* out_mul, void* out_sq,
                         void* out_p58, int n, void* stream) {
    if (n > 0)
        fe_ops_kernel<E><<<blocks_for(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)a, (const uint8_t*)b, (uint8_t*)out_mul, (uint8_t*)out_sq,
            (uint8_t*)out_p58, n);
    return (int)cudaGetLastError();
}

#else  // host build: the same rows, one after another, on the CPU

template <class E>
static void host_verify(const uint8_t* pub, const uint8_t* r, const uint8_t* s, const uint8_t* k,
                        const uint8_t* valid, const void* table, uint8_t* out, int n) {
    for (int i = 0; i < n; ++i) {
        size_t o = (size_t)i * 32;
        out[i] = verify_row<E>(pub + o, r + o, s + o, k + o, valid[i] != 0,
                               (const typename field<E>::limb*)table) ? 1 : 0;
    }
}

template <class E>
static void host_fe_ops(const uint8_t* a, const uint8_t* b, uint8_t* out_mul, uint8_t* out_sq,
                        uint8_t* out_p58, int n) {
    for (int i = 0; i < n; ++i) {
        size_t o = (size_t)i * 32;
        fe_ops_row<E>(a + o, b + o, out_mul + o, out_sq + o, out_p58 + o);
    }
}

#endif  // __CUDACC__

#if defined(TM_COUNT_FIELD_OPS) && !defined(__CUDACC__)
// The multiplies and squarings counted since the last call; resets both.
static void tm_take_field_op_counts(uint64_t* mul_sq) {
    mul_sq[0] = tm_count_mul;
    mul_sq[1] = tm_count_sq;
    tm_count_mul = tm_count_sq = 0;
}
#endif

#endif  // TM_ED25519_COMMON_CUH
