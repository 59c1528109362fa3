// The f32 layout (51 signed 5-bit limbs in float, fe_f32.cuh) with its
// field multiply on the tensor cores: the element ffm = ff_t<1>, which
// shares every function of fe_f32.cuh but fe_mul.
//
// Replaces `_fe_mul_mxu` of tendermint_tpu/ops/fe25519_f32.py (:202, with
// `_inc_matrix` :183, chosen by `_use_mxu` :159): the [2601] limb-product
// tensor contracted against the constant [2601, 51] incidence matrix
// (weight 1, or 19 past the 2^255 wrap), then fe_carry(rounds=6).  Here
// the limb products themselves are formed inside integer mma: the
// unfolded columns c_k = sum_i T_{k-i} x_i (k = 0..100) are a Toeplitz
// matrix of one operand T times the other operand x, the fold c_k + 19
// c_{k+51} is taken in int32, and fe_carry(rounds=6) follows as before.
// The columns are the JAX ones, so the limbs are too.
//
// Operand contract and split.  fe_mul needs |a|_inf * |b|_inf <= 17,641.
// Each row puts on the Toeplitz side T the operand whose largest |limb|
// is the smaller (a on a tie; the product commutes, and the choice moves
// data only), so |T|_inf <= 132.  Every value v splits into signed bytes
// v = 256 hi + lo, lo in [-128, 127], hi = (v + 128) >> 8: x's hi lies in
// [-69, 69], T's in [-1, 1].  The mma is mma.sync.m16n8k32 with s8
// operands and s32 accumulators: c = 256 (Tlo.xhi) + Tlo.xlo, and where a
// row of the warp has a T limb outside [-128, 127] (133 x -132, say; never
// in the point formulas, whose worst product 153 x 102 puts 102 on T) the
// warp also runs the mma of T's high byte (a warp-uniform __any_sync), c
// += 256 (256 Thi.xhi + Thi.xlo).  Every sum is an exact integer, a
// folded column at most 951 x 17,641 < 2^24 in magnitude, converted to
// float only after the fold.  No TF32, FP16 or BF16: a TF32 significand
// cannot hold a product, and a float split would be exact only by
// argument, the assumption that failed on the TPU.
//
// The mma of one row.  M is 16 rows m of the Toeplitz tile, A[m][j] =
// T_{m-j}, over one K window j in [-48, 15] (two k32 steps).  N holds x
// shifted: B column n = 2s + h is byte h (lo, hi) of x_{j + sigma_s}, so
// D[m][n] is byte h's part of column m + sigma_s.  Two n8 tiles of four
// shifts each: tile 0 sigma = 0, 16, 32, 48 gives c_0..c_63 from all 16
// rows, tile 1 sigma = 60, 72, 84, 96 gives c_64..c_111 from rows 4..15
// (rows 0..3 there would need j < -48 and are not stored).  Every
// product T_{k-i} x_i of the 101 columns falls in that window, so a row
// is 2 tiles x 2 k-steps = 4 mma (8 with the high-byte step): 128 mma per
// warp per multiply, where the direct layout (M the 101 columns in 7 m16
// tiles, x in one N column) would take 11 (352), and 14 of the 16 N
// columns do work (2 of 8 there).  The lane (g, t) of D holds both bytes of a column, so it
// recombines them itself; K is ordered so that a lane's 16 j-values are
// consecutive (slot 4t + q + 16r of k-step ks is j = -48 + 16t + 8ks + 4r
// + q) and its A words are six consecutive words of one staged plane.
//
// Warp-collective.  The 32 lanes of a warp each hold one signature; every
// lane must call every fe_mul, so kernels on ffm run rows past N as dummy
// rows and keep every field operation out of data-dependent branches
// (collective_mul<ffm>); the one branch, around the high-byte mma, turns
// on a warp-uniform value.  Each lane stages its row in the warp's shared
// memory as signed-byte planes (mma_stage): T's low and high bytes
// reversed, R[p] = T_{63-p}, and x's low and high bytes, X[p] = x_{p-48},
// zero-padded so that every fragment word is a load: A's six words are
// seven aligned 32-bit loads and six funnel shifts (one per lane-fixed
// byte offset), B's a 16-byte load (tile 0) and four 32-bit loads (tile
// 1).  Then the warp walks its 32 rows two at a time, the two rows' mma
// interleaved, and each lane writes its four recombined columns of a row
// over that row's planes, which no lane reads again (one __syncwarp
// orders them).  Last each lane reads its own 112 columns back
// (26 16-byte loads), folds, converts and carries.  Shared memory: 496
// bytes a row, 15,872 a warp; blocks are at most TM_MMA_WARPS warps.
//
// The reckoning, per warp per multiply (32 rows), issued per lane:
//   mma 128 (4 a row); loads 32 x (7 + 1 + 4) = 384 LDS for fragments,
//   26 LDS.128 back; stores 30 STS.128 of staging, 32 x 4 STS of columns;
//   PRMT 104 of packing and funnel shifts 32 x 6; the int32 fold 51 IMAD
//   (x19) and 32 x 4 recombines, 51 I2F; choosing T 102 FMNMX and 204
//   FSEL, encoding 102 FADD; the FFMA carry, 6 rounds x 51 limbs x 4
//   (FMUL, FRND, FFMA, FADD) = 1,224: about 3,600 in all, against the FFMA
//   multiply's 2,601 products and the same carry.  No limb product is
//   formed outside an mma (the earlier mma multiply formed its 2,601 a
//   lane with IMAD and used the mma only to sum).  The longest dependent
//   chain of a row is load, shift, mma, mma (the second k-step
//   accumulates), recombine, store, about 100 clocks; the rows are
//   independent, so the walk takes two at once.  The alternative, wgmma with a warpgroup sharing the Toeplitz
//   tiles: wgmma multiplies a 64-row A by a B in shared memory that all
//   64 rows share, but here both operands differ in every row
//   (signature), so nothing is shared: one row's T fills 16 of A's 64
//   rows, and a row takes 2 wgmma.m64n16k32, four times the operations
//   of its 4 mma (4.2 M int8 operations a warp's multiply against 1.05 M),
//   plus a fence and a B descriptor a row, with four warps waiting on
//   each.  A folded 64-row circulant (c_k + 19 c_{k+51} in the matrix)
//   would put 19 T in the A operand, past s8 for |T| >= 7: a second split
//   of every entry, twice the mma of this design.
//
// What bounds it now: latency.  The int8 operations the mma issue (32,768
// a row) at the data sheet's 1,979 TOP/s are below the verify kernels'
// FFMA squarings (1,326 a squaring), but on the card a warp runs alone on
// its scheduler and a multiply is about 3,600 mostly dependent
// instructions (staging, the walk, the carry); PERF.md section 6 has the
// kernels' times on an H100 against the FFMA kernels'.  fe_sq stays on
// the FP32 pipe (the JAX fe_sq has no matrix-unit form).
//
// Build: as every source, at ptxas's default level.  The warp's lanes
// meet only in shared memory, each cross-lane read after a __syncwarp
// that follows the write, and every mma, vote and __syncwarp is reached
// by the whole warp; benchmarks/ptxas_levels.py builds the source at
// ptxas -O0 to -O3 and holds every build's kernels to the reference.
//
// The host build (no __CUDACC__) stages the same planes (mma_stage) and
// sums the Toeplitz columns from them in a plain loop per row, with the
// high-byte step and the int32 fold (mma_columns); with
// TM_COUNT_FIELD_OPS it counts the multiplies that needed the high-byte
// step and the largest |limb| of each side.  tm_host_fe_mul_mma_warp runs
// the warp's walk itself, lane by lane, with the fragment words of
// mma_a_words / mma_b_words and an mma of the PTX fragment layout.

#ifndef TM_FE_F32_MMA_CUH
#define TM_FE_F32_MMA_CUH

#include <string.h>

#include "fe_f32.cuh"

typedef ff_t<1> ffm;

template <>
struct collective_mul<ffm> {
    enum { value = 1 };
};

#define TM_MMA_WARPS 2       // warps per block of every kernel on ffm (each source asserts it)
#define TM_MMA_ROW_BYTES 496 // one row's planes, then its columns; 124 words: no bank conflict
#define TM_MMA_T_LO 0        // R = T reversed, low bytes: 80 bytes, T_{63-p}
#define TM_MMA_T_HI 80       // its high bytes
#define TM_MMA_X_LO 160      // X = x from p = 48, low bytes: 160 bytes, x_{p-48}
#define TM_MMA_X_HI 320      // its high bytes
#define TM_MMA_PAIR 2        // rows the walk takes at once
// fe_mul's static shared memory, 31,744 bytes, leaves a block 16 KB of the
// 48 KB a block may hold statically (the RLC buckets launch keeps 8 KB)
static_assert(TM_MMA_WARPS * 32 * TM_MMA_ROW_BYTES <= 32 * 1024, "fe_mul's staging outgrew a block");

#ifdef __CUDACC__
TM_DEV uint32_t tm_prmt(uint32_t x, uint32_t y, uint32_t s) { return __byte_perm(x, y, s); }
TM_DEV uint32_t tm_shr64(uint32_t lo, uint32_t hi, int sh) { return __funnelshift_r(lo, hi, sh); }
TM_DEV uint32_t tm_f2u(float f) { return __float_as_uint(f); }
TM_DEV uint32_t tm_ld32(const uint8_t* p) { return *(const uint32_t*)p; }
TM_DEV uint4 tm_ld128(const uint8_t* p) { return *(const uint4*)p; }
TM_DEV void tm_st128(uint8_t* p, uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
    *(uint4*)p = make_uint4(x, y, z, w);
}
#else
struct uint4 {
    uint32_t x, y, z, w;
};
TM_DEV uint32_t tm_prmt(uint32_t x, uint32_t y, uint32_t s) {
    const uint64_t v = ((uint64_t)y << 32) | x;
    uint32_t r = 0;
    for (int i = 0; i < 4; ++i) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 255) << (8 * i);
    return r;
}
TM_DEV uint32_t tm_shr64(uint32_t lo, uint32_t hi, int sh) {
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> (sh & 31));
}
TM_DEV uint32_t tm_f2u(float f) {
    uint32_t u;
    memcpy(&u, &f, 4);
    return u;
}
TM_DEV uint32_t tm_ld32(const uint8_t* p) {
    uint32_t u;
    memcpy(&u, p, 4);
    return u;
}
TM_DEV uint4 tm_ld128(const uint8_t* p) {
    uint4 u;
    memcpy(&u, p, 16);
    return u;
}
TM_DEV void tm_st128(uint8_t* p, uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
    const uint32_t v[4] = {x, y, z, w};
    memcpy(p, v, 16);
}
#endif

// A limb's bytes: the float bits of v + 2^23 + 2^22 + 128 are 0x4b400000 +
// v + 128 (exact for |v| < 2^22), so byte 0 is lo + 128 and byte 1 is hi.
#define TM_MMA_ENC 12583040.0f

// Stages one row: T's planes (reversed) and x's (forward), zero-padded,
// from a and b.  Returns whether T has a limb outside [-128, 127] (its
// high bytes are not all zero); *t_max and *x_max get each side's largest
// |limb|.
TM_DEV bool mma_stage(uint8_t* row, const ffm& a, const ffm& b, float* t_max, float* x_max) {
    float pa[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};  // four short chains
#pragma unroll
    for (int l = 0; l < TM_F_N; ++l) {
        pa[l & 3] = fmaxf(pa[l & 3], fabsf(a.v[l]));
        pb[l & 3] = fmaxf(pb[l & 3], fabsf(b.v[l]));
    }
    const float ma = fmaxf(fmaxf(pa[0], pa[1]), fmaxf(pa[2], pa[3]));
    const float mb = fmaxf(fmaxf(pb[0], pb[1]), fmaxf(pb[2], pb[3]));
    const bool swap = mb < ma;
    *t_max = swap ? mb : ma;
    *x_max = swap ? ma : mb;
    uint32_t tlo[16], thi[16], xlo[16], xhi[16];  // group G of limbs 4G..4G+3 (limb 51 is 0)
    uint32_t high = 0;
#pragma unroll
    for (int G = 0; G < 13; ++G) {
        uint32_t tu[4], xu[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int l = 4 * G + q;
            const float av = l < TM_F_N ? a.v[l] : 0.f, bv = l < TM_F_N ? b.v[l] : 0.f;
            tu[q] = tm_f2u((swap ? bv : av) + TM_MMA_ENC);
            xu[q] = tm_f2u((swap ? av : bv) + TM_MMA_ENC);
        }
        // bytes [u0.b0, u1.b0, u0.b1, u1.b1] and [u2.b0, u3.b0, u2.b1, u3.b1]
        const uint32_t t01 = tm_prmt(tu[0], tu[1], 0x5140), t23 = tm_prmt(tu[2], tu[3], 0x5140);
        const uint32_t x01 = tm_prmt(xu[0], xu[1], 0x5140), x23 = tm_prmt(xu[2], xu[3], 0x5140);
        tlo[G] = tm_prmt(t01, t23, 0x0145) ^ 0x80808080u;  // limbs 4G+3 .. 4G, lowest byte first
        thi[G] = tm_prmt(t01, t23, 0x2367);
        xlo[G] = tm_prmt(x01, x23, 0x5410) ^ 0x80808080u;  // limbs 4G .. 4G+3
        xhi[G] = tm_prmt(x01, x23, 0x7632);
        high |= thi[G];
    }
    // R word w holds group 15 - w (words 3..15); X word w group w - 12 (12..24)
    uint8_t* const planes[2] = {row + TM_MMA_T_LO, row + TM_MMA_T_HI};
    const uint32_t* const rev[2] = {tlo, thi};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t* s = rev[h];
        tm_st128(planes[h], 0, 0, 0, s[12]);
        tm_st128(planes[h] + 16, s[11], s[10], s[9], s[8]);
        tm_st128(planes[h] + 32, s[7], s[6], s[5], s[4]);
        tm_st128(planes[h] + 48, s[3], s[2], s[1], s[0]);
        tm_st128(planes[h] + 64, 0, 0, 0, 0);
    }
    uint8_t* const xplanes[2] = {row + TM_MMA_X_LO, row + TM_MMA_X_HI};
    const uint32_t* const fwd[2] = {xlo, xhi};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t* s = fwd[h];
        uint8_t* p = xplanes[h];
        for (int i = 0; i < 3; ++i) tm_st128(p + 16 * i, 0, 0, 0, 0);
        tm_st128(p + 48, s[0], s[1], s[2], s[3]);
        tm_st128(p + 64, s[4], s[5], s[6], s[7]);
        tm_st128(p + 80, s[8], s[9], s[10], s[11]);
        tm_st128(p + 96, s[12], 0, 0, 0);
        for (int i = 7; i < 10; ++i) tm_st128(p + 16 * i, 0, 0, 0, 0);
    }
    return high != 0;
}

// The A fragments of lane (g, t), k-steps 0 and 1, from a T plane: A[m][j]
// = T_{m-j} = R[15 - m + 16t + 8ks + 4r + q] for row m = g (registers 0,
// 2) or g + 8 (1, 3), half r = 0 (0, 1) or 1 (2, 3).  Those are the six
// words at o = 7 - g + 16t: row g + 8 words 2ks + r, row g words 2 + 2ks
// + r.
TM_DEV void mma_a_words(const uint8_t* plane, int g, int t, uint32_t a[2][4]) {
    const int o = 7 - g + 16 * t;
    const uint8_t* p = plane + (o & ~3);
    const int sh = 8 * (o & 3);
    uint32_t w[7], v[6];
#pragma unroll
    for (int i = 0; i < 7; ++i) w[i] = tm_ld32(p + 4 * i);
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = tm_shr64(w[i], w[i + 1], sh);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
        a[ks][0] = v[2 + 2 * ks];
        a[ks][1] = v[2 * ks];
        a[ks][2] = v[3 + 2 * ks];
        a[ks][3] = v[1 + 2 * ks];
    }
}

// The B fragments of lane (g, t): column g is byte g & 1 of x shifted by
// sigma (tile 0: 16 (g >> 1); tile 1: 60 + 12 (g >> 1)); register r of
// k-step ks holds x_{j + sigma} for j = -48 + 16t + 8ks + 4r + q, at X[16t
// + sigma + 8ks + 4r + q].
TM_DEV void mma_b_words(const uint8_t* row, int g, int t, uint32_t b[2][2][2]) {
    const uint8_t* x = row + ((g & 1) ? TM_MMA_X_HI : TM_MMA_X_LO) + 16 * t;
    const uint4 v = tm_ld128(x + 16 * (g >> 1));
    const uint8_t* x1 = x + 60 + 12 * (g >> 1);
    b[0][0][0] = v.x;
    b[0][0][1] = v.y;
    b[0][1][0] = v.z;
    b[0][1][1] = v.w;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int r = 0; r < 2; ++r) b[1][ks][r] = tm_ld32(x1 + 8 * ks + 4 * r);
}

// Lane (g, t)'s accumulators of both tiles into the row's columns:
// accumulator q is row g (+ 8 for q >= 2), column 2t + (q & 1), i.e. byte
// q & 1 of column m + sigma_t; tile 1 keeps rows m >= 4 only: its rows
// 0..3 go to columns 112..115, past the row's columns, so that every lane
// stores without a branch.  d is the low-byte side of T, e its high
// byte's (all zero without that step).
TM_DEV void mma_put(int* cols, int g, int t, const int d[2][4], const int e[2][4]) {
#pragma unroll
    for (int tile = 0; tile < 2; ++tile) {
        const int sigma = tile ? 60 + 12 * t : 16 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = g + 8 * h;
            const int c = (d[tile][2 * h + 1] + e[tile][2 * h] + e[tile][2 * h + 1] * 256) * 256 +
                          d[tile][2 * h];
            cols[tile && m < 4 ? 112 + m : m + sigma] = c;
        }
    }
}

// Columns c_0..c_101 of a row (int32) to its limbs: c_k + 19 c_{k+51},
// then float and 6 carry rounds.
TM_DEV ffm mma_columns(const int* c) {
    ffm r;
#pragma unroll
    for (int k = 0; k < TM_F_N; ++k) r.v[k] = (float)(c[k] + 19 * c[k + TM_F_N]);
    return fe_carry(r, 6);
}

#ifdef __CUDACC__

TM_DEV void mma_s8(int acc[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One row's fragment words: A of T's low bytes, of its high bytes (only
// with the high-byte step), and B.
struct mma_frags {
    uint32_t a[2][4], ah[2][4], b[2][2][2];
};

TM_DEV void mma_load(mma_frags& f, const uint8_t* row, int g, int t, bool high) {
    mma_a_words(row + TM_MMA_T_LO, g, t, f.a);
    if (high) mma_a_words(row + TM_MMA_T_HI, g, t, f.ah);  // warp-uniform
    mma_b_words(row, g, t, f.b);
}

// a * b for the 32 lanes of the warp at once; every lane must call it.
TM_NOINLINE ffm fe_mul(const ffm& a, const ffm& b) {
    __shared__ __align__(16) uint8_t rows[TM_MMA_WARPS][32][TM_MMA_ROW_BYTES];
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    uint8_t(*w)[TM_MMA_ROW_BYTES] = rows[threadIdx.x >> 5];
    float t_max, x_max;
    __syncwarp();  // the previous call's lanes have read their columns
    const bool high = __any_sync(0xffffffffu, mma_stage(w[lane], a, b, &t_max, &x_max));
    __syncwarp();
#pragma unroll 1
    for (int r = 0; r < 32; r += TM_MMA_PAIR) {  // rows in pairs: one row's mma hide the other's
        mma_frags f[TM_MMA_PAIR];
        int d[TM_MMA_PAIR][2][4] = {}, e[TM_MMA_PAIR][2][4] = {};
#pragma unroll
        for (int p = 0; p < TM_MMA_PAIR; ++p) mma_load(f[p], w[r + p], g, t, high);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int tile = 0; tile < 2; ++tile)
#pragma unroll
                for (int p = 0; p < TM_MMA_PAIR; ++p)
                    mma_s8(d[p][tile], f[p].a[ks], f[p].b[tile][ks][0], f[p].b[tile][ks][1]);
        if (high) {  // warp-uniform
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
#pragma unroll
                for (int tile = 0; tile < 2; ++tile)
#pragma unroll
                    for (int p = 0; p < TM_MMA_PAIR; ++p)
                        mma_s8(e[p][tile], f[p].ah[ks], f[p].b[tile][ks][0], f[p].b[tile][ks][1]);
        }
        __syncwarp();  // every lane has loaded these rows' planes
#pragma unroll
        for (int p = 0; p < TM_MMA_PAIR; ++p) mma_put((int*)w[r + p], g, t, d[p], e[p]);
    }
    __syncwarp();
    int c[104];
#pragma unroll
    for (int i = 0; i < 26; ++i) {
        const uint4 v = tm_ld128(w[lane] + 16 * i);
        c[4 * i] = (int)v.x;
        c[4 * i + 1] = (int)v.y;
        c[4 * i + 2] = (int)v.z;
        c[4 * i + 3] = (int)v.w;
    }
    return mma_columns(c);
}

#else  // host build: the same planes, the Toeplitz columns as a plain loop

#ifdef TM_COUNT_FIELD_OPS
static uint64_t tm_count_mul_high;  // multiplies whose T needed the high-byte step
static float tm_max_t, tm_max_x;    // the largest |limb| seen on each side

// Since the last call: the multiplies that needed the high-byte step, and
// the largest |limb| on the Toeplitz side and on the other; resets them.
extern "C" void tm_host_fe_mul_mma_stats(double* high_tmax_xmax) {
    high_tmax_xmax[0] = (double)tm_count_mul_high;
    high_tmax_xmax[1] = tm_max_t;
    high_tmax_xmax[2] = tm_max_x;
    tm_count_mul_high = 0;
    tm_max_t = tm_max_x = 0.f;
}
#endif

TM_DEV int mma_byte(const uint8_t* row, int plane, int p) { return (int8_t)row[plane + p]; }

TM_NOINLINE ffm fe_mul(const ffm& a, const ffm& b) {
    TM_COUNT(tm_count_mul);
    uint8_t row[TM_MMA_ROW_BYTES];
    float t_max, x_max;
    const bool high = mma_stage(row, a, b, &t_max, &x_max);
#ifdef TM_COUNT_FIELD_OPS
    tm_count_mul_high += high;
    tm_max_t = t_max > tm_max_t ? t_max : tm_max_t;
    tm_max_x = x_max > tm_max_x ? x_max : tm_max_x;
#endif
    int c[2 * TM_F_N];
    for (int k = 0; k < 2 * TM_F_N; ++k) {
        int dlo = 0, dhi = 0, elo = 0, ehi = 0;  // T_{k-i} = R[63 - k + i], x_i = X[48 + i]
        for (int i = k >= TM_F_N ? k - TM_F_N + 1 : 0; i <= k && i < TM_F_N; ++i) {
            const int tl = mma_byte(row, TM_MMA_T_LO, 63 - k + i);
            dlo += tl * mma_byte(row, TM_MMA_X_LO, 48 + i);
            dhi += tl * mma_byte(row, TM_MMA_X_HI, 48 + i);
            if (high) {
                const int th = mma_byte(row, TM_MMA_T_HI, 63 - k + i);
                elo += th * mma_byte(row, TM_MMA_X_LO, 48 + i);
                ehi += th * mma_byte(row, TM_MMA_X_HI, 48 + i);
            }
        }
        c[k] = (dhi + elo + ehi * 256) * 256 + dlo;  // c_101 has no product: 0
    }
    return mma_columns(c);
}

// The warp's walk on the host: rows in warps of 32 (lanes past n run row
// 0), each lane's fragment words from mma_a_words / mma_b_words, the mma
// by the PTX fragment layout of m16n8k32 with s8 operands (A register r:
// row g + 8 (r & 1), k 4t + q + 16 (r >> 1); B register r: column g, k 4t
// + q + 16r; accumulator q: row g + 8 (q >> 1), column 2t + (q & 1)), and
// mma_put / mma_columns as on the card.
static void mma_emulate(int acc[32][4], const uint32_t a[32][4], const uint32_t b[32][2]) {
    int A[16][32], B[32][8];
    for (int lane = 0; lane < 32; ++lane) {
        const int g = lane >> 2, t = lane & 3;
        for (int q = 0; q < 4; ++q) {
            for (int r = 0; r < 4; ++r)
                A[g + 8 * (r & 1)][4 * t + q + 16 * (r >> 1)] = (int8_t)(a[lane][r] >> (8 * q));
            for (int r = 0; r < 2; ++r) B[4 * t + q + 16 * r][g] = (int8_t)(b[lane][r] >> (8 * q));
        }
    }
    for (int lane = 0; lane < 32; ++lane) {
        const int g = lane >> 2, t = lane & 3;
        for (int q = 0; q < 4; ++q) {
            const int m = g + 8 * (q >> 1), n = 2 * t + (q & 1);
            for (int k = 0; k < 32; ++k) acc[lane][q] += A[m][k] * B[k][n];
        }
    }
}

static void host_fe_mul_mma_warp(const float* x, const float* y, float* out, int n) {
    for (int base = 0; base < n; base += 32) {
        static uint8_t rows[32][TM_MMA_ROW_BYTES];
        bool high = false;
        for (int lane = 0; lane < 32; ++lane) {
            const size_t o = (size_t)(base + lane < n ? base + lane : 0) * TM_F_N;
            ffm p, q;
            for (int l = 0; l < TM_F_N; ++l) {
                p.v[l] = x[o + l];
                q.v[l] = y[o + l];
            }
            float t_max, x_max;
            high |= mma_stage(rows[lane], p, q, &t_max, &x_max);
        }
        for (int r = 0; r < 32; ++r) {
            uint32_t fa[2][32][4], fh[2][32][4], fb[2][2][32][2];
            for (int lane = 0; lane < 32; ++lane) {
                uint32_t a[2][4], ah[2][4], b[2][2][2];
                mma_a_words(rows[r] + TM_MMA_T_LO, lane >> 2, lane & 3, a);
                mma_a_words(rows[r] + TM_MMA_T_HI, lane >> 2, lane & 3, ah);
                mma_b_words(rows[r], lane >> 2, lane & 3, b);
                for (int ks = 0; ks < 2; ++ks) {
                    memcpy(fa[ks][lane], a[ks], sizeof a[ks]);
                    memcpy(fh[ks][lane], ah[ks], sizeof ah[ks]);
                    for (int tile = 0; tile < 2; ++tile)
                        memcpy(fb[tile][ks][lane], b[tile][ks], sizeof b[tile][ks]);
                }
            }
            int d[2][32][4] = {}, e[2][32][4] = {};
            for (int tile = 0; tile < 2; ++tile)
                for (int ks = 0; ks < 2; ++ks) {
                    mma_emulate(d[tile], fa[ks], fb[tile][ks]);
                    if (high) mma_emulate(e[tile], fh[ks], fb[tile][ks]);
                }
            for (int lane = 0; lane < 32; ++lane) {
                int dl[2][4], el[2][4];
                for (int tile = 0; tile < 2; ++tile)
                    for (int q = 0; q < 4; ++q) {
                        dl[tile][q] = d[tile][lane][q];
                        el[tile][q] = e[tile][lane][q];
                    }
                int cols[TM_MMA_ROW_BYTES / 4];
                memcpy(cols, rows[r], sizeof cols);
                mma_put(cols, lane >> 2, lane & 3, dl, el);
                memcpy(rows[r], cols, sizeof cols);
            }
        }
        for (int lane = 0; lane < 32 && base + lane < n; ++lane) {
            int c[104];
            memcpy(c, rows[lane], sizeof c);
            const ffm r = mma_columns(c);
            for (int l = 0; l < TM_F_N; ++l) out[(size_t)(base + lane) * TM_F_N + l] = r.v[l];
        }
    }
}

#endif  // __CUDACC__

#endif  // TM_FE_F32_MMA_CUH
