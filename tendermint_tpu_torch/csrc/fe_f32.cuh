// GF(2^255 - 19) and edwards25519 on the FP32 pipe: 51 signed limbs of 5
// bits in float.
//
// Replaces tendermint_tpu/ops/fe25519_f32.py: fe_carry :105, _fold_cols
// :123, _mul_cols :135, fe_mul :221, fe_sq :231, fe_pow_p58 :263,
// _fe_carry_exact :281, fe_canonical :298, pt_add :350, pt_dbl :370,
// pt_dbl_n :391, limb for limb: every function computes the JAX
// function's limbs, so the JAX module's bound ledger holds here
// unchanged.  Its matrix-unit fe_mul (_fe_mul_mxu :202) is fe_f32_mma.cuh.
//
// The element is ff_t<M>: everything here is written once for both
// multiplies, and only fe_mul differs.  ff = ff_t<0> multiplies on the
// FP32 pipe (below); ffm = ff_t<1> on the tensor cores (fe_f32_mma.cuh),
// and every lane of a warp must then call each fe_mul together.  The
// calls below find the fe_mul of their element by argument-dependent
// lookup when the template is instantiated.
//
// Exact because every intermediate is an integer of magnitude at most
// 2^24, where float arithmetic is exact:
//   * fe_mul needs |a|_inf * |b|_inf <= 17,641 (a folded column is at most
//     951 products), fe_sq needs |a|_inf <= 63.  The point formulas keep
//     to that as the JAX ones do: (x + y)^2 (operand up to 102) goes
//     through fe_mul, and f gets a 3-round partial carry.  Using fe_sq
//     there, or dropping a carry, would pass 2^24 silently.
//   * Carries use floorf, never a cast to int: truncation toward zero
//     gives other limbs for negative columns, and the reduced band
//     [0, 32) rests on floor.
//   * The build uses no --use_fast_math.  nvcc contracts a * b + c into
//     FFMA, which is harmless here: every operand and every partial sum
//     is an exact integer below 2^24, so a fused and an unfused result are
//     the same integer.
//
// What bounds it: FFMA, 2,601 per multiply and 1,326 per squaring, at 128
// per SM per clock.  A point is 204 floats and a product's columns 102,
// so one thread per signature spills to local memory; the multiply, the
// squaring, the canonical form and the point formulas are out-of-line
// functions, which keeps the code (and the build) small.  Limbs across
// the lanes of a warp (a warp per signature) is later work.

#ifndef TM_FE_F32_CUH
#define TM_FE_F32_CUH

#include <math.h>

#include "ed25519_common.cuh"

#define TM_F_N 51

template <int M>
struct ff_t {
    float v[TM_F_N];
};
typedef ff_t<0> ff;

template <int M>
TM_DEV ff_t<M> ff_from_words(const u64 w[4]) {
    ff_t<M> r;
    for (int i = 0; i < TM_F_N; ++i) r.v[i] = (float)bits_at(w, 5 * i, 5);
    return r;
}

template <int M>
TM_DEV ff_t<M> ff_small(float v0) {
    ff_t<M> r;
    for (int i = 0; i < TM_F_N; ++i) r.v[i] = 0.f;
    r.v[0] = v0;
    return r;
}

template <int M>
struct field<ff_t<M> > {
    typedef float limb;
    enum { N = TM_F_N };
    static TM_DEVM ff_t<M> zero() { return ff_small<M>(0.f); }
    static TM_DEVM ff_t<M> one() { return ff_small<M>(1.f); }
    static TM_DEVM ff_t<M> d() {
        const u64 w[4] = TM_D_WORDS;
        return ff_from_words<M>(w);
    }
    static TM_DEVM ff_t<M> d2() {
        const u64 w[4] = TM_D2_WORDS;
        return ff_from_words<M>(w);
    }
    static TM_DEVM ff_t<M> sqrtm1() {
        const u64 w[4] = TM_SQRTM1_WORDS;
        return ff_from_words<M>(w);
    }
    static TM_DEVM ff_t<M> frombytes(const uint8_t* p) {
        u64 w[4];
        load_words255(w, p);
        return ff_from_words<M>(w);
    }
};

// ---------------------------------------------------------------------------
// Field ops
// ---------------------------------------------------------------------------

// The JAX fe_carry: per round every limb's overflow, floor(c / 32), moves
// one limb up at once (the top one re-enters limb 0 x19).  rounds=6
// reduces |c| <= 2^24, rounds=3 reduces |c| <= 204.
template <int M>
TM_DEV ff_t<M> fe_carry(ff_t<M> c, int rounds) {
    for (int r = 0; r < rounds; ++r) {
        float hi[TM_F_N];
#pragma unroll
        for (int i = 0; i < TM_F_N; ++i) {
            hi[i] = floorf(c.v[i] * 0.03125f);
            c.v[i] -= hi[i] * 32.f;
        }
        c.v[0] += 19.f * hi[TM_F_N - 1];
#pragma unroll
        for (int i = 1; i < TM_F_N; ++i) c.v[i] += hi[i - 1];
    }
    return c;
}

template <int M>
TM_DEV ff_t<M> fe_carry(const ff_t<M>& c) { return fe_carry(c, 6); }

template <int M>
TM_DEV ff_t<M> fe_add(const ff_t<M>& a, const ff_t<M>& b) {
    ff_t<M> r;
    for (int i = 0; i < TM_F_N; ++i) r.v[i] = a.v[i] + b.v[i];
    return r;
}

template <int M>
TM_DEV ff_t<M> fe_sub(const ff_t<M>& a, const ff_t<M>& b) {
    ff_t<M> r;
    for (int i = 0; i < TM_F_N; ++i) r.v[i] = a.v[i] - b.v[i];
    return r;
}

template <int M>
TM_DEV ff_t<M> fe_neg(const ff_t<M>& a) {
    ff_t<M> r;
    for (int i = 0; i < TM_F_N; ++i) r.v[i] = -a.v[i];
    return r;
}

// Schoolbook product on the FP32 pipe: column k < 51 is lo_k + 19 hi_k,
// lo_k the products at k and hi_k those at k + 51 (past the 2^255 wrap),
// then 6 carry rounds.
TM_NOINLINE ff fe_mul(const ff& a, const ff& b) {
    TM_COUNT(tm_count_mul);
    ff r;
#pragma unroll
    for (int k = 0; k < TM_F_N; ++k) {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int i = 0; i <= k; ++i) lo += a.v[i] * b.v[k - i];
#pragma unroll
        for (int i = k + 1; i < TM_F_N; ++i) hi += a.v[i] * b.v[k + TM_F_N - i];
        r.v[k] = lo + 19.f * hi;
    }
    return fe_carry(r, 6);
}

// Column k of a^2: the diagonal once, the cross terms a_i * 2a_j (i < j).
TM_DEV float sq_col(const float* a, const float* a2, int k) {
    float acc = (k & 1) ? 0.f : a[k >> 1] * a[k >> 1];
#pragma unroll
    for (int i = k >= TM_F_N ? k - TM_F_N + 1 : 0; 2 * i < k; ++i) acc += a[i] * a2[k - i];
    return acc;
}

// On the FP32 pipe for both elements (the JAX fe_sq has no matrix-unit
// form).
template <int M>
TM_NOINLINE ff_t<M> fe_sq(const ff_t<M>& a) {
    TM_COUNT(tm_count_sq);
    float a2[TM_F_N];
#pragma unroll
    for (int i = 0; i < TM_F_N; ++i) a2[i] = a.v[i] + a.v[i];
    ff_t<M> r;
#pragma unroll
    for (int k = 0; k < TM_F_N; ++k)
        r.v[k] = sq_col(a.v, a2, k) + 19.f * (k + TM_F_N <= 2 * TM_F_N - 2
                                                  ? sq_col(a.v, a2, k + TM_F_N) : 0.f);
    return fe_carry(r, 6);
}

// The JAX _fe_carry_exact: sequential ripple on non-negative limbs, then
// one x19 re-entry into limbs 0 and 1.
TM_DEV void ff_carry_exact(float c[TM_F_N]) {
    float carry = 0.f;
    for (int i = 0; i < TM_F_N; ++i) {
        float v = c[i] + carry;
        carry = floorf(v * 0.03125f);
        c[i] = v - carry * 32.f;
    }
    float c0 = c[0] + 19.f * carry;
    float k0 = floorf(c0 * 0.03125f);
    c[0] = c0 - k0 * 32.f;
    c[1] += k0;
}

// The canonical representative in [0, p) for |limbs| <= 52: add the
// all-positive 4p (limb 0 52, the others 124), ripple three times, and
// subtract p where it fits.
template <int M>
TM_NOINLINE ff_t<M> fe_canonical(const ff_t<M>& a) {
    float c[TM_F_N], sub[TM_F_N];
    for (int i = 0; i < TM_F_N; ++i) c[i] = a.v[i] + (i ? 124.f : 52.f);
    ff_carry_exact(c);
    ff_carry_exact(c);
    ff_carry_exact(c);
    float borrow = 0.f;
    for (int i = 0; i < TM_F_N; ++i) {
        float v = c[i] - (i ? 31.f : 13.f) - borrow;  // the limbs of p
        borrow = v < 0.f ? 1.f : 0.f;
        sub[i] = v + borrow * 32.f;
    }
    ff_t<M> r;
    for (int i = 0; i < TM_F_N; ++i) r.v[i] = borrow == 1.f ? c[i] : sub[i];
    return r;
}

template <int M>
TM_DEV bool fe_eq(const ff_t<M>& a, const ff_t<M>& b) {
    ff_t<M> ca = fe_canonical(a), cb = fe_canonical(b);
    bool eq = true;
    for (int i = 0; i < TM_F_N; ++i) eq &= ca.v[i] == cb.v[i];
    return eq;
}

template <int M>
TM_DEV bool fe_is_zero(const ff_t<M>& a) {
    ff_t<M> c = fe_canonical(a);
    bool zero = true;
    for (int i = 0; i < TM_F_N; ++i) zero &= c.v[i] == 0.f;
    return zero;
}

template <int M>
TM_DEV bool fe_is_odd(const ff_t<M>& canonical) { return (int)canonical.v[0] & 1; }

template <int M>
TM_DEV void fe_tobytes(uint8_t* out, const ff_t<M>& a) {
    ff_t<M> c = fe_canonical(a);
    u64 w[4] = {0, 0, 0, 0};
    for (int i = 0; i < TM_F_N; ++i) put_bits(w, 5 * i, (u64)(int)c.v[i]);
    store_words(out, w);
}

// ---------------------------------------------------------------------------
// Point ops: the JAX module's formulas and partial carries
// ---------------------------------------------------------------------------

// With reduced inputs (|limbs| <= 51) f = d2 - c (up to 153) gets a
// 3-round carry; the worst product is then g*h = 153 * 102 = 15,606.
template <int M>
TM_NOINLINE point<ff_t<M> > pt_add(const point<ff_t<M> >& p, const point<ff_t<M> >& q) {
    typedef ff_t<M> E;
    E a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
    E b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
    E c = fe_mul(fe_mul(p.t, q.t), field<E>::d2());
    E d = fe_mul(p.z, q.z);
    E d2 = fe_add(d, d);
    E e = fe_sub(b, a);
    E f = fe_carry(fe_sub(d2, c), 3);
    E g = fe_add(d2, c);
    E h = fe_add(b, a);
    point<E> r = {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
    return r;
}

// (x + y)^2 by fe_mul (operand up to 102, past fe_sq's 63); f = 2c + g (up
// to 204) gets the 3-round carry.  `with_t` is the same in every lane.
template <int M>
TM_NOINLINE point<ff_t<M> > pt_dbl(const point<ff_t<M> >& p, bool with_t) {
    typedef ff_t<M> E;
    E a = fe_sq(p.x);
    E b = fe_sq(p.y);
    E c = fe_sq(p.z);
    c = fe_add(c, c);
    E h = fe_add(a, b);
    E xy = fe_add(p.x, p.y);
    E e = fe_sub(h, fe_mul(xy, xy));
    E g = fe_sub(a, b);
    E f = fe_carry(fe_add(c, g), 3);
    point<E> r;
    r.x = fe_mul(e, f);
    r.y = fe_mul(g, h);
    r.z = fe_mul(f, g);
    r.t = with_t ? fe_mul(e, h) : field<E>::zero();
    return r;
}

// Signed limbs: negation is free and keeps magnitudes.
template <int M>
TM_DEV point<ff_t<M> > pt_neg(const point<ff_t<M> >& p) {
    point<ff_t<M> > r = {fe_neg(p.x), p.y, p.z, fe_neg(p.t)};
    return r;
}

template <int M>
TM_DEV bool pt_is_identity(const point<ff_t<M> >& p) {
    return fe_is_zero(p.x) && fe_eq(p.y, p.z);
}

#endif  // TM_FE_F32_CUH
