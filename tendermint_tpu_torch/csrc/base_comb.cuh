// [s]B by a w=8 comb whose per-window selection runs on the tensor cores,
// for Hopper (sm_90a): included by ed25519_verify.cu (5 x 51-bit limbs,
// kernel ed25519_verify_comb) and ed25519_verify_f32.cu (51 x 5-bit float
// limbs, kernels ed25519_verify_f32_comb and, with the tensor-core fe_mul,
// ed25519_verify_f32_mma_comb), and the part kernel comb_select.
//
// Replaces `_Core._scalarmul_base_mxu` of tendermint_tpu/ops/ed25519_jax.py
// (:328): the signature's 32 s bytes are its radix-256 digits; window w
// selects [s_w * 256^w]B from a shared 256-entry table as a one-hot
// [rows, 256] x table [256, entry] product, and 31 complete additions sum
// the 32 selections (63 for the radix-16 table of scalarmul_base).
//
// Exact by construction.  The table holds each entry as the canonical
// encodings of X, Y, Z and T, 128 bytes, and the product is the integer
// mma (u8 x u8, s32 accumulators, m16n8k32): a one-hot row has one 1, so
// every output is one table byte, exactly, and the bytes are repacked to
// the kernel's limbs afterwards.  The limbs themselves could not go
// through the tensor cores: the 51-bit limbs are exact in no tensor type,
// and fp16 (11 significant bits) would hold only the f32 layout's 5-bit
// limbs.  One byte table serves every layout.  Layout [32 windows][128
// bytes][256 digits] (1 MiB): for each byte the 256 digits are
// contiguous, so the B operand (four consecutive digits of one byte) is
// one aligned 32-bit load.
//
// Per window a warp selects for its 32 rows (one signature per lane): two
// m16 tiles x 16 n8 tiles x 8 k32 steps = 256 mma.sync.  The warp runs the
// mma together, so every lane takes part in every window: a row past N
// takes digit 0, and no lane returns before the comb is done.  The 32 x
// 128-byte result tile is staged through shared memory (4 KiB per warp),
// not held in registers; each lane then reads its own row.  Bound: the
// field additions after the selection, as in the radix-16 path (the mma
// is about 1% of the row's work); the table is read from L2/L1 by every
// warp.
//
// The host build (no __CUDACC__) replaces the mma by a plain gather of
// the same byte table, so the host tests hold the table, the repacking
// and the 32-window comb; the tensor-core selection itself is held on the
// card, exhaustively, by comb_select.

#ifndef TM_BASE_COMB_CUH
#define TM_BASE_COMB_CUH

#include "ed25519_common.cuh"

#define TM_COMB_WINDOWS 32
#define TM_COMB_BYTES 128  // X | Y | Z | T, 32 canonical bytes each
#define TM_COMB_DIGITS 256

// The point whose canonical X, Y, Z, T encodings are e[0..127].
template <class E>
TM_DEV point<E> point_from_bytes(const uint8_t* e) {
    point<E> r = {field<E>::frombytes(e), field<E>::frombytes(e + 32),
                  field<E>::frombytes(e + 64), field<E>::frombytes(e + 96)};
    return r;
}

#ifdef __CUDACC__

// Four u8 elements of one one-hot row: byte x of the word is 1 when the
// row's digit is at that column (x in [0, 4)).
TM_DEV uint32_t one_hot_word(int x) { return (unsigned)x < 4u ? 1u << (8 * x) : 0u; }

TM_DEV void mma_u8(int acc[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                   uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The warp's selection in one window: lane l's `digit` picks its row's
// 128 bytes of `window` ([128][256] u8) into tile[l * 128 ...].  Every
// lane of the warp must call it.  Fragments (PTX ISA, mma.m16n8k32 with
// .u8): lane = 4 g + t; A register q holds row g (q = 0, 2) or g + 8
// (q = 1, 3), columns 4t..4t+3 (+16 for q >= 2); B register q holds
// column g, rows 4t..4t+3 (+16 for q = 1); accumulator q holds row g
// (q < 2) or g + 8, column 2t + (q & 1).
TM_DEV void comb_select_tile(const uint8_t* __restrict__ window, int digit, uint8_t* tile) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    int row_digit[2][2];  // [m tile][row g, row g + 8]
#pragma unroll
    for (int m = 0; m < 2; ++m) {
        row_digit[m][0] = __shfl_sync(0xffffffffu, digit, 16 * m + g);
        row_digit[m][1] = __shfl_sync(0xffffffffu, digit, 16 * m + g + 8);
    }
#pragma unroll 1
    for (int nt = 0; nt < TM_COMB_BYTES / 8; ++nt) {
        int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
        const uint8_t* column = window + (size_t)(8 * nt + g) * TM_COMB_DIGITS + 4 * t;
#pragma unroll
        for (int ks = 0; ks < TM_COMB_DIGITS / 32; ++ks) {
            const uint32_t b0 = *(const uint32_t*)(column + 32 * ks);
            const uint32_t b1 = *(const uint32_t*)(column + 32 * ks + 16);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const int lo = 32 * ks + 4 * t;
                mma_u8(acc[m], one_hot_word(row_digit[m][0] - lo),
                       one_hot_word(row_digit[m][1] - lo), one_hot_word(row_digit[m][0] - lo - 16),
                       one_hot_word(row_digit[m][1] - lo - 16), b0, b1);
            }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
            uint8_t* row = tile + (16 * m + g) * TM_COMB_BYTES + 8 * nt + 2 * t;
            row[0] = (uint8_t)acc[m][0];
            row[1] = (uint8_t)acc[m][1];
            row[8 * TM_COMB_BYTES] = (uint8_t)acc[m][2];
            row[8 * TM_COMB_BYTES + 1] = (uint8_t)acc[m][3];
        }
    }
    __syncwarp();
}

#endif  // __CUDACC__

// The 128 bytes `digit` selects in `window`: on the card by the warp's
// tensor-core product (every lane of the warp calls this, in step; `tile`
// is the warp's 4 KiB of shared memory), on the host by a gather.
// Returns a pointer to them.
TM_DEV const uint8_t* comb_select(const uint8_t* window, int digit, uint8_t* tile) {
#ifdef __CUDACC__
    __syncwarp();  // the lanes are done reading the previous window's tile
    comb_select_tile(window, digit, tile);
    return tile + (threadIdx.x & 31) * TM_COMB_BYTES;
#else
    for (int b = 0; b < TM_COMB_BYTES; ++b) tile[b] = window[(size_t)b * TM_COMB_DIGITS + digit];
    return tile;
#endif
}

// [s]B, sum over w < 32 of [s_w * 256^w]B: 31 complete additions.  `live`
// false selects digit 0 in every window (a row past N, on the card).
template <class E>
TM_DEV point<E> scalarmul_base_comb(const uint8_t* table, const uint8_t* s, bool live,
                                    uint8_t* tile) {
    point<E> acc;
    for (int w = 0; w < TM_COMB_WINDOWS; ++w) {
        const uint8_t* entry = comb_select(table + (size_t)w * TM_COMB_BYTES * TM_COMB_DIGITS,
                                           live ? s[w] : 0, tile);
        point<E> sel = point_from_bytes<E>(entry);
        acc = w ? pt_add(acc, sel) : sel;
    }
    return acc;
}

// ---------------------------------------------------------------------------
// Kernels and launchers (64 threads, two whole warps, per block)
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

template <class E>
static __global__ void verify_comb_kernel(const uint8_t* __restrict__ pub,
                                          const uint8_t* __restrict__ r,
                                          const uint8_t* __restrict__ s,
                                          const uint8_t* __restrict__ k,
                                          const uint8_t* __restrict__ valid,
                                          const uint8_t* __restrict__ table,
                                          uint8_t* __restrict__ out, int n) {
    __shared__ uint8_t tiles[TM_THREADS / 32][32 * TM_COMB_BYTES];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const size_t o = (size_t)(live ? i : 0) * 32;
    point<E> sb = scalarmul_base_comb<E>(table, s + o, live, tiles[threadIdx.x / 32]);
    // a row past N runs to the end as a dummy (row 0): a collective fe_mul
    // (collective_mul) needs every lane
    const bool ok = verify_row_from_base(sb, pub + o, r + o, k + o, valid[live ? i : 0] != 0);
    if (live) out[i] = ok ? 1 : 0;
}

static __global__ void comb_select_kernel(const uint8_t* __restrict__ s,
                                          const uint8_t* __restrict__ table,
                                          uint8_t* __restrict__ out, int n) {
    __shared__ uint8_t tiles[TM_THREADS / 32][32 * TM_COMB_BYTES];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    for (int w = 0; w < TM_COMB_WINDOWS; ++w) {
        const uint8_t* entry = comb_select(table + (size_t)w * TM_COMB_BYTES * TM_COMB_DIGITS,
                                           live ? s[(size_t)i * 32 + w] : 0,
                                           tiles[threadIdx.x / 32]);
        if (live)
            for (int b = 0; b < TM_COMB_BYTES; ++b)
                out[((size_t)i * TM_COMB_WINDOWS + w) * TM_COMB_BYTES + b] = entry[b];
    }
}

template <class E>
static int launch_verify_comb(const void* pub, const void* r, const void* s, const void* k,
                              const void* valid, const void* table, void* out, int n,
                              void* stream) {
    if (n > 0)
        verify_comb_kernel<E><<<blocks_for(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)pub, (const uint8_t*)r, (const uint8_t*)s, (const uint8_t*)k,
            (const uint8_t*)valid, (const uint8_t*)table, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}

static int launch_comb_select(const void* s, const void* table, void* out, int n, void* stream) {
    if (n > 0)
        comb_select_kernel<<<blocks_for(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)s, (const uint8_t*)table, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}

#else  // host build

template <class E>
static void host_verify_comb(const uint8_t* pub, const uint8_t* r, const uint8_t* s,
                             const uint8_t* k, const uint8_t* valid, const uint8_t* table,
                             uint8_t* out, int n) {
    uint8_t entry[TM_COMB_BYTES];
    for (int i = 0; i < n; ++i) {
        size_t o = (size_t)i * 32;
        point<E> sb = scalarmul_base_comb<E>(table, s + o, true, entry);
        out[i] = verify_row_from_base(sb, pub + o, r + o, k + o, valid[i] != 0) ? 1 : 0;
    }
}

static void host_comb_select(const uint8_t* s, const uint8_t* table, uint8_t* out, int n) {
    uint8_t entry[TM_COMB_BYTES];
    for (int i = 0; i < n; ++i)
        for (int w = 0; w < TM_COMB_WINDOWS; ++w) {
            const uint8_t* e = comb_select(table + (size_t)w * TM_COMB_BYTES * TM_COMB_DIGITS,
                                           s[(size_t)i * 32 + w], entry);
            for (int b = 0; b < TM_COMB_BYTES; ++b)
                out[((size_t)i * TM_COMB_WINDOWS + w) * TM_COMB_BYTES + b] = e[b];
        }
}

#endif  // __CUDACC__

#endif  // TM_BASE_COMB_CUH
