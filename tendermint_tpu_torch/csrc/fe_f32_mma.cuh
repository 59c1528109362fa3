// The f32 layout (51 signed 5-bit limbs in float, fe_f32.cuh) with its
// field multiply on the tensor cores: the element ffm = ff_t<1>, which
// shares every function of fe_f32.cuh but fe_mul.
//
// Replaces `_fe_mul_mxu` of tendermint_tpu/ops/fe25519_f32.py (:202, with
// `_inc_matrix` :183, chosen by `_use_mxu` :159): the [2601] limb-product
// tensor contracted against the constant [2601, 51] incidence matrix
// (weight 1, or 19 past the 2^255 wrap), then fe_carry(rounds=6).  On
// the card that contraction is an integer mma; the columns are the ones
// the FP32 schoolbook of fe_f32.cuh sums, so the limbs are too.
//
// Exact by construction.  Under fe_mul's contract (|a|_inf * |b|_inf <=
// 17,641) a product p = a_i * b_j splits into two signed bytes, p = 256 hi
// + lo with lo in [-128, 127] and hi = (p + 128) >> 8 in [-69, 69].  Both
// go through mma.sync.m16n8k32 with s8 operands and s32 accumulators, and
// a column is 256 * sum(hi w) + sum(lo w) in int32, at most 951 * 17,641 <
// 2^24 in magnitude, then converted to float.  No TF32, FP16 or BF16: a
// TF32 significand cannot hold a product, and a 16-bit float split with
// float accumulators would be exact only by argument, the assumption that
// failed on the TPU.
//
// Warp-collective.  The 32 lanes of a warp each hold one signature's
// operands and compute their 32 products together: every lane must call
// every fe_mul, so kernels on ffm run rows past N as dummy rows and keep
// every field operation out of data-dependent branches
// (collective_mul<ffm>).  Per call each lane stages its limbs as int16 in
// shared memory; each lane then forms the A fragments of its rows (g, g +
// 8, g + 16, g + 24 for lane 4 g + t) from the staged limbs, and builds
// the B fragment, the incidence matrix, from its fragment coordinates in
// registers.  The 32 x 56 int32 result tile goes back through shared
// memory to the owner lanes.  Shared memory per warp: 7,344 bytes of
// operands and 7,296 of results; blocks are at most TM_MMA_WARPS warps.
//
// K order.  The contraction's rows are taken in column order, k = 51 c +
// t for product t of column c (a_t * b_j, j = (c - t) mod 51), a
// permutation of `_inc_matrix`'s rows 51 i + j.  A k32 step then meets at
// most two columns, so one or two n8 tiles of the incidence matrix are
// non-zero and only those are multiplied: 82 k32 steps, 88 (step, tile)
// pairs, 4 mma each (two m16 tiles, hi and lo) = 352 mma per fe_mul per
// warp.
//
// What bounds it: forming the products.  The 2,601 products per lane are
// the FP32 schoolbook's; here each also costs two shared-memory half
// loads (four rows per 64-bit load), an IMAD and a byte permute, and the
// mma replaces only the FFMA sums.  So this multiply is slower than the
// FFMA one, by design a right kernel first; fe_sq stays on the FP32 pipe
// (the JAX fe_sq has no matrix-unit form).
//
// The host build (no __CUDACC__) runs the same split, K order and
// incidence weights as a plain loop per row; the fragment layout itself
// is held on the card by the part kernel fe_mul_mma against its plain
// version.

#ifndef TM_FE_F32_MMA_CUH
#define TM_FE_F32_MMA_CUH

#include "fe_f32.cuh"

typedef ff_t<1> ffm;

template <>
struct collective_mul<ffm> {
    enum { value = 1 };
};

#define TM_MMA_CHUNKS ((TM_F_N * TM_F_N + 31) / 32)  // 82 k32 steps
#define TM_MMA_WARPS 2  // warps per block of every kernel on ffm (each source asserts it)
#define TM_MMA_OP_STRIDE 36     // int16 per staged limb: 32 rows, padded
#define TM_MMA_COL_STRIDE 57    // int32 per row of the result tile

// Product t of column c: b's limb j and the incidence weight w.
TM_DEV int mma_term(int c, int t, int* w) {
    *w = t <= c ? 1 : 19;
    return t <= c ? c - t : c - t + TM_F_N;
}

#ifdef __CUDACC__

TM_DEV void mma_s8(int acc[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

TM_DEV int lo16(uint32_t w) { return (int)(int16_t)(w & 0xffffu); }
TM_DEV int hi16(uint32_t w) { return (int)w >> 16; }

// acc [m][hi, lo][q] of n8 tile nt into the result tile: accumulator q
// holds row 16 m + g (+ 8 for q >= 2), column 8 nt + 2 t + (q & 1).
TM_DEV void mma_flush(int* cols, int nt, int g, int t, const int acc[2][2][4]) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
            cols[(16 * m + g + 8 * (q >> 1)) * TM_MMA_COL_STRIDE + 8 * nt + 2 * t + (q & 1)] =
                256 * acc[m][0][q] + acc[m][1][q];
}

// a * b for the 32 lanes of the warp at once; every lane must call it.
// Fragments (PTX ISA, mma.m16n8k32 with 8-bit operands): lane = 4 g + t;
// A register r holds row g (r = 0, 2) or g + 8 (r = 1, 3), k 4t..4t+3
// (+16 for r >= 2), the lowest k in the lowest byte; B register r holds
// column g, k 4t..4t+3 (+16 for r = 1).  Lane slot s (0..7) is the k
// 32 step + 4 t + (s & 3) + 16 (s >> 2), tracked as its (column, term).
TM_NOINLINE ffm fe_mul(const ffm& a, const ffm& b) {
    __shared__ __align__(16) int16_t ops[TM_MMA_WARPS][2][TM_F_N * TM_MMA_OP_STRIDE];
    __shared__ int cols[TM_MMA_WARPS][32 * TM_MMA_COL_STRIDE];
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    int16_t* sa = ops[threadIdx.x >> 5][0];
    int16_t* sb = ops[threadIdx.x >> 5][1];
    int* sc = cols[threadIdx.x >> 5];
    // row r at position 4 (r & 7) + (r >> 3): lane 4 g + t reads its four
    // rows g, g + 8, g + 16, g + 24 as one 64-bit load per limb
    const int pos = 4 * (lane & 7) + (lane >> 3);
    __syncwarp();
#pragma unroll
    for (int l = 0; l < TM_F_N; ++l) {
        sa[l * TM_MMA_OP_STRIDE + pos] = (int16_t)a.v[l];
        sb[l * TM_MMA_OP_STRIDE + pos] = (int16_t)b.v[l];
    }
    __syncwarp();
    int col[8], term[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        col[s] = 0;
        term[s] = 4 * t + (s & 3) + 16 * (s >> 2);
    }
    int acc[2][2][2][4] = {};  // [this tile, the next][m][hi, lo][q]
    int cur = 0;
#pragma unroll 1
    for (int ch = 0; ch < TM_MMA_CHUNKS; ++ch) {
        const int nt_lo = (32 * ch) / TM_F_N / 8;
        const int nt_hi = min(TM_F_N - 1, (32 * ch + 31) / TM_F_N) / 8;
        if (nt_lo != cur) {  // warp-uniform: the step left tile `cur` behind
            mma_flush(sc, cur, g, t, acc[0]);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        acc[0][m][h][q] = acc[1][m][h][q];
                        acc[1][m][h][q] = 0;
                    }
            cur = nt_lo;
        }
        int prod[4][8];              // [row g, g + 8, g + 16, g + 24][slot] of p + 128
        uint32_t bw[2][2] = {};      // [tile nt_lo, nt_hi][B register]
#pragma unroll
        for (int s = 0; s < 8; ++s) {
            const bool real = col[s] < TM_F_N;  // k < 2601
            int w;
            const int j = mma_term(col[s], term[s], &w);
            const uint2 av = *(const uint2*)(sa + (real ? term[s] : 0) * TM_MMA_OP_STRIDE + 4 * g);
            const uint2 bv = *(const uint2*)(sb + (real ? j : 0) * TM_MMA_OP_STRIDE + 4 * g);
            prod[0][s] = lo16(av.x) * lo16(bv.x) + 128;
            prod[1][s] = hi16(av.x) * hi16(bv.x) + 128;
            prod[2][s] = lo16(av.y) * lo16(bv.y) + 128;
            prod[3][s] = hi16(av.y) * hi16(bv.y) + 128;
            const int shift = 8 * (s & 3);
            if (real && col[s] == 8 * nt_lo + g) bw[0][s >> 2] |= (uint32_t)w << shift;
            if (real && col[s] == 8 * nt_hi + g) bw[1][s >> 2] |= (uint32_t)w << shift;
            term[s] += 32;  // the slot's k in the next step
            if (term[s] >= TM_F_N) {
                term[s] -= TM_F_N;
                ++col[s];
            }
        }
        // hi = byte 1 of p + 128, lo = byte 0 of p as s8 (byte 0 of p + 128,
        // top bit flipped); packed four k to a register, lowest k lowest
        uint32_t fhi[4][2], flo[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int* p = prod[r] + 4 * h;
                const uint32_t t01 = __byte_perm(p[0], p[1], 0x5140);
                const uint32_t t23 = __byte_perm(p[2], p[3], 0x5140);
                flo[r][h] = __byte_perm(t01, t23, 0x5410) ^ 0x80808080u;
                fhi[r][h] = __byte_perm(t01, t23, 0x7632);
            }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
            const uint32_t ahi[4] = {fhi[2 * m][0], fhi[2 * m + 1][0], fhi[2 * m][1],
                                     fhi[2 * m + 1][1]};
            const uint32_t alo[4] = {flo[2 * m][0], flo[2 * m + 1][0], flo[2 * m][1],
                                     flo[2 * m + 1][1]};
            mma_s8(acc[0][m][0], ahi, bw[0][0], bw[0][1]);
            mma_s8(acc[0][m][1], alo, bw[0][0], bw[0][1]);
            if (nt_hi != nt_lo) {  // warp-uniform
                mma_s8(acc[1][m][0], ahi, bw[1][0], bw[1][1]);
                mma_s8(acc[1][m][1], alo, bw[1][0], bw[1][1]);
            }
        }
    }
    mma_flush(sc, cur, g, t, acc[0]);
    __syncwarp();
    ffm r;
#pragma unroll
    for (int l = 0; l < TM_F_N; ++l) r.v[l] = (float)sc[lane * TM_MMA_COL_STRIDE + l];
    return fe_carry(r, 6);
}

#else  // host build: the same split, K order and weights, one row

TM_NOINLINE ffm fe_mul(const ffm& a, const ffm& b) {
    TM_COUNT(tm_count_mul);
    ffm r;
    for (int c = 0; c < TM_F_N; ++c) {
        int hi = 0, lo = 0;
        for (int t = 0; t < TM_F_N; ++t) {
            int w;
            const int j = mma_term(c, t, &w);
            const int q = (int)a.v[t] * (int)b.v[j] + 128;
            hi += (int8_t)(uint8_t)(q >> 8) * w;
            lo += (int8_t)(uint8_t)((q & 255) ^ 128) * w;
        }
        r.v[c] = (float)(256 * hi + lo);
    }
    return fe_carry(r, 6);
}

#endif  // __CUDACC__

#endif  // TM_FE_F32_MMA_CUH
