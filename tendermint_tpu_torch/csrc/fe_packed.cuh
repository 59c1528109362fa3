// GF(2^255 - 19) and edwards25519 in the PACKED layout: 10 limbs at the
// mixed radix 25.5 (widths 26, 25, 26, ...; limb i at bit ceil(25.5 i)),
// the ref10 / donna-32 shape, in 32-bit registers.
//
// Replaces tendermint_tpu/ops/fe25519_packed.py (its fe_carry :133,
// _fold_cols :153, fe_mul :167, fe_sq :183, fe_canonical :264, pt_add
// :313, pt_dbl :333, pt_dbl_n :355), limb for limb: every function
// computes the JAX function's limbs, so the JAX module's bound ledger
// holds here unchanged.
//
//   * Limbs are never negative: fe_sub adds 2p and fe_neg 4p in limb form
//     (unsigned columns would underflow otherwise).  Every limb stays
//     below 2^29, so a limb is a uint32.
//   * fe_mul: 100 products of 32 x 32 -> 64 bits (one IMAD.WIDE.U32 each)
//     summed in 64-bit columns.  A product a_i * b_j with i and j both odd
//     has weight w_{i+j} + 1 and enters column i + j doubled (the JAX
//     module's _DBL_ODD): b's odd limbs are doubled for the odd rows.
//     Columns 10..18 fold into 0..8 times 19 (2^255 = 19).  The pairwise
//     contract max|a_i| * max|b_j| <= 2^54.9 keeps every folded column
//     below 2^63.
//   * fe_sq: 55 products, for reduced inputs only; the point formulas
//     square x + y with fe_mul.
//   * fe_carry is the JAX relaxation: per round every limb's overflow
//     moves one limb up at once (the top one re-enters limb 0 x19).
//     rounds=3 reduces any column < 2^63, rounds=2 any column <= 2^44;
//     the point formulas use rounds=2 exactly where the JAX ones do
//     (pt_add: the first subtrahend and f; pt_dbl: e and f).

#ifndef TM_FE_PACKED_CUH
#define TM_FE_PACKED_CUH

#include "ed25519_common.cuh"

#define TM_PK_N 10

struct fp {
    uint32_t v[TM_PK_N];
};

TM_DEV int pk_width(int i) { return 26 - (i & 1); }
TM_DEV int pk_weight(int i) { return (51 * i + 1) / 2; }
TM_DEV uint32_t pk_mask(int i) { return (1u << pk_width(i)) - 1; }
// Limb i of p: 2^26 - 19, then 2^25 - 1, 2^26 - 1, ...
TM_DEV uint32_t pk_p(int i) { return pk_mask(i) - (i == 0 ? 18u : 0u); }

TM_DEV fp fp_from_words(const u64 w[4]) {
    fp r;
    for (int i = 0; i < TM_PK_N; ++i) r.v[i] = (uint32_t)bits_at(w, pk_weight(i), pk_width(i));
    return r;
}

TM_DEV fp fp_small(uint32_t v0) {
    fp r;
    for (int i = 0; i < TM_PK_N; ++i) r.v[i] = 0;
    r.v[0] = v0;
    return r;
}

template <>
struct field<fp> {
    typedef uint32_t limb;
    enum { N = TM_PK_N };
    static TM_DEVM fp zero() { return fp_small(0); }
    static TM_DEVM fp one() { return fp_small(1); }
    static TM_DEVM fp d() {
        const u64 w[4] = TM_D_WORDS;
        return fp_from_words(w);
    }
    static TM_DEVM fp d2() {
        const u64 w[4] = TM_D2_WORDS;
        return fp_from_words(w);
    }
    static TM_DEVM fp sqrtm1() {
        const u64 w[4] = TM_SQRTM1_WORDS;
        return fp_from_words(w);
    }
    static TM_DEVM fp frombytes(const uint8_t* p) {
        u64 w[4];
        load_words255(w, p);
        return fp_from_words(w);
    }
};

// ---------------------------------------------------------------------------
// Field ops
// ---------------------------------------------------------------------------

// The JAX fe_carry(c, rounds) on 64-bit columns.
TM_DEV fp pk_carry_cols(u64 c[TM_PK_N], int rounds) {
    for (int r = 0; r < rounds; ++r) {
        u64 hi[TM_PK_N];
        for (int i = 0; i < TM_PK_N; ++i) {
            hi[i] = c[i] >> pk_width(i);
            c[i] &= pk_mask(i);
        }
        c[0] += 19 * hi[TM_PK_N - 1];
        for (int i = 1; i < TM_PK_N; ++i) c[i] += hi[i - 1];
    }
    fp out;
    for (int i = 0; i < TM_PK_N; ++i) out.v[i] = (uint32_t)c[i];
    return out;
}

TM_DEV fp fe_carry(const fp& a, int rounds) {
    u64 c[TM_PK_N];
    for (int i = 0; i < TM_PK_N; ++i) c[i] = a.v[i];
    return pk_carry_cols(c, rounds);
}

TM_DEV fp fe_carry(const fp& a) { return fe_carry(a, 3); }

TM_DEV fp fe_add(const fp& a, const fp& b) {
    fp r;
    for (int i = 0; i < TM_PK_N; ++i) r.v[i] = a.v[i] + b.v[i];
    return r;
}

// a - b + 2p; b must be reduced.
TM_DEV fp fe_sub(const fp& a, const fp& b) {
    fp r;
    for (int i = 0; i < TM_PK_N; ++i) r.v[i] = a.v[i] + 2 * pk_p(i) - b.v[i];
    return r;
}

// 4p - a, for limbs <= 4p limb-wise; callers re-carry.
TM_DEV fp fe_neg(const fp& a) {
    fp r;
    for (int i = 0; i < TM_PK_N; ++i) r.v[i] = 4 * pk_p(i) - a.v[i];
    return r;
}

// Folds columns 10..18 into 0..8 (x19) and carries (rounds=3).
TM_DEV fp pk_fold(u64 cols[2 * TM_PK_N - 1]) {
    for (int k = 0; k < TM_PK_N - 1; ++k) cols[k] += 19 * cols[k + TM_PK_N];
    return pk_carry_cols(cols, 3);
}

TM_DEV fp fe_mul(const fp& a, const fp& b) {
    TM_COUNT(tm_count_mul);
    uint32_t b2[TM_PK_N];  // odd limbs doubled, for the odd rows
    for (int j = 0; j < TM_PK_N; ++j) b2[j] = b.v[j] << (j & 1);
    u64 cols[2 * TM_PK_N - 1];
    for (int k = 0; k < 2 * TM_PK_N - 1; ++k) cols[k] = 0;
    for (int i = 0; i < TM_PK_N; ++i) {
        const uint32_t* row = (i & 1) ? b2 : b.v;
        for (int j = 0; j < TM_PK_N; ++j) cols[i + j] += (u64)a.v[i] * row[j];
    }
    return pk_fold(cols);
}

// Diagonal once, cross terms doubled (and odd x odd doubled again).
TM_DEV fp fe_sq(const fp& a) {
    TM_COUNT(tm_count_sq);
    uint32_t a2[TM_PK_N], a2_odd2[TM_PK_N];
    for (int j = 0; j < TM_PK_N; ++j) {
        a2[j] = a.v[j] << 1;
        a2_odd2[j] = a2[j] << (j & 1);
    }
    u64 cols[2 * TM_PK_N - 1];
    for (int k = 0; k < 2 * TM_PK_N - 1; ++k) cols[k] = 0;
    for (int i = 0; i < TM_PK_N; ++i) {
        cols[2 * i] += (u64)a.v[i] * ((i & 1) ? a2[i] : a.v[i]);
        const uint32_t* row = (i & 1) ? a2_odd2 : a2;
        for (int j = i + 1; j < TM_PK_N; ++j) cols[i + j] += (u64)a.v[i] * row[j];
    }
    return pk_fold(cols);
}

// The JAX _fe_carry_exact: sequential ripple, then one x19 re-entry.
TM_DEV void pk_carry_exact(int64_t c[TM_PK_N]) {
    int64_t carry = 0;
    for (int i = 0; i < TM_PK_N; ++i) {
        int64_t v = c[i] + carry;
        carry = v >> pk_width(i);
        c[i] = v & pk_mask(i);
    }
    int64_t c0 = c[0] + 19 * carry;
    c[1] += c0 >> pk_width(0);
    c[0] = c0 & pk_mask(0);
}

// The canonical representative in [0, p); non-negative limbs < 2^57.
TM_DEV fp fe_canonical(const fp& a) {
    int64_t c[TM_PK_N], sub[TM_PK_N];
    for (int i = 0; i < TM_PK_N; ++i) c[i] = a.v[i];
    pk_carry_exact(c);
    pk_carry_exact(c);
    pk_carry_exact(c);
    int64_t borrow = 0;
    for (int i = 0; i < TM_PK_N; ++i) {
        int64_t v = c[i] - pk_p(i) - borrow;
        borrow = v < 0;
        sub[i] = v + (borrow << pk_width(i));
    }
    fp r;
    for (int i = 0; i < TM_PK_N; ++i) r.v[i] = (uint32_t)(borrow ? c[i] : sub[i]);
    return r;
}

TM_DEV bool fe_eq(const fp& a, const fp& b) {
    fp ca = fe_canonical(a), cb = fe_canonical(b);
    uint32_t d = 0;
    for (int i = 0; i < TM_PK_N; ++i) d |= ca.v[i] ^ cb.v[i];
    return d == 0;
}

TM_DEV bool fe_is_zero(const fp& a) {
    fp c = fe_canonical(a);
    uint32_t d = 0;
    for (int i = 0; i < TM_PK_N; ++i) d |= c.v[i];
    return d == 0;
}

TM_DEV bool fe_is_odd(const fp& canonical) { return canonical.v[0] & 1; }

TM_DEV void fe_tobytes(uint8_t* out, const fp& a) {
    fp c = fe_canonical(a);
    u64 w[4] = {0, 0, 0, 0};
    for (int i = 0; i < TM_PK_N; ++i) put_bits(w, pk_weight(i), c.v[i]);
    store_words(out, w);
}

// ---------------------------------------------------------------------------
// Point ops: the JAX module's formulas and partial carries
// ---------------------------------------------------------------------------

TM_DEV point<fp> pt_add(const point<fp>& p, const point<fp>& q) {
    fp a = fe_mul(fe_carry(fe_sub(p.y, p.x), 2), fe_sub(q.y, q.x));
    fp b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
    fp c = fe_mul(fe_mul(p.t, q.t), field<fp>::d2());
    fp d = fe_mul(p.z, q.z);
    fp d2 = fe_add(d, d);
    fp e = fe_sub(b, a);
    fp f = fe_carry(fe_sub(d2, c), 2);
    fp g = fe_add(d2, c);
    fp h = fe_add(b, a);
    point<fp> r = {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
    return r;
}

// (x + y)^2 by fe_mul: its operand is past fe_sq's reduced-only contract.
TM_DEV point<fp> pt_dbl(const point<fp>& p, bool with_t) {
    fp a = fe_sq(p.x);
    fp b = fe_sq(p.y);
    fp c = fe_sq(p.z);
    c = fe_add(c, c);
    fp h = fe_add(a, b);
    fp xy = fe_add(p.x, p.y);
    fp e = fe_carry(fe_sub(h, fe_mul(xy, xy)), 2);
    fp g = fe_sub(a, b);
    fp f = fe_carry(fe_add(c, g), 2);
    point<fp> r;
    r.x = fe_mul(e, f);
    r.y = fe_mul(g, h);
    r.z = fe_mul(f, g);
    r.t = with_t ? fe_mul(e, h) : field<fp>::zero();
    return r;
}

// Re-carried: negated coordinates feed fe_sub, which needs reduced inputs.
TM_DEV point<fp> pt_neg(const point<fp>& p) {
    point<fp> r = {fe_carry(fe_neg(p.x)), p.y, p.z, fe_carry(fe_neg(p.t))};
    return r;
}

TM_DEV bool pt_is_identity(const point<fp>& p) { return fe_is_zero(p.x) && fe_eq(p.y, p.z); }

#endif  // TM_FE_PACKED_CUH
