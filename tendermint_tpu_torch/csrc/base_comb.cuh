// [s]B by a w=8 comb whose per-window selection is a gather, for Hopper
// (sm_90a): included by ed25519_verify.cu (5 x 51-bit limbs, kernel
// ed25519_verify_comb) and ed25519_verify_f32.cu (51 x 5-bit float limbs,
// kernels ed25519_verify_f32_comb and, with the tensor-core fe_mul,
// ed25519_verify_f32_mma_comb), and the part kernel comb_select.
//
// Replaces `_Core._scalarmul_base_mxu` of tendermint_tpu/ops/ed25519_jax.py
// (:328): the signature's 32 s bytes are its radix-256 digits; window w
// selects [s_w * 256^w]B from a shared 256-entry table, and 31 complete
// additions sum the 32 selections (63 for the radix-16 table of
// scalarmul_base).  The TPU selects by a one-hot [rows, 256] x table
// product on its matrix unit because it has no fast gather; on this card
// a gather is the native operation, so each lane reads its own entry.
//
// The table holds each entry as the canonical encodings of X, Y, Z and T,
// 128 bytes, entry-contiguous: [32 windows][256 digits][128 bytes] (1 MiB),
// the JAX table's own order.  One byte table serves every layout: the
// bytes are unpacked to the kernel's limbs after the load.
//
// What bounds it.  The selection moves bytes and does no arithmetic: per
// row 32 entries of 128 bytes, read from a 1 MiB table that stays in
// L2 (at a given window every warp reads the same 32 KiB).  comb_select,
// which writes every entry out, is bound by its 4 KiB of output a row.
// Inside the verify kernels the field additions after the selection bound
// the comb, as in the radix-16 path.  So: each lane loads its entry as
// eight 16-byte words through the read-only path (__ldg), with no
// tensor-core product, no shared memory and no warp-collective step; the
// host build runs the same gather.  In comb_select_kernel consecutive
// threads move consecutive 16-byte words of the output (four to a
// thread, loads first), so a warp stores four entries of one row at
// neighbouring addresses.

#ifndef TM_BASE_COMB_CUH
#define TM_BASE_COMB_CUH

#include <string.h>

#include "ed25519_common.cuh"

#define TM_COMB_WINDOWS 32
#define TM_COMB_BYTES 128  // X | Y | Z | T, 32 canonical bytes each
#define TM_COMB_DIGITS 256
#define TM_COMB_WORDS (TM_COMB_BYTES / 16)
#define TM_COMB_SELECT_THREADS 256  // comb_select_kernel's block
#define TM_COMB_SELECT_STEPS 4      // 16-byte words a thread of comb_select_kernel moves

#ifdef __CUDACC__
typedef uint4 tm_word16;
#define TM_LDG(p) __ldg(p)
#else
struct tm_word16 {
    uint32_t x, y, z, w;
};
#define TM_LDG(p) (*(p))
#endif

// Word c (of 8) of the entry `digit` selects in window w.
TM_DEV tm_word16 comb_word(const uint8_t* table, int w, int digit, int c) {
    const tm_word16* entry = reinterpret_cast<const tm_word16*>(
        table + ((size_t)w * TM_COMB_DIGITS + digit) * TM_COMB_BYTES);
    return TM_LDG(entry + c);
}

// The 128 bytes `digit` selects in window w, into `out`.
TM_DEV void comb_select(const uint8_t* table, int w, int digit, uint8_t* out) {
    for (int c = 0; c < TM_COMB_WORDS; ++c) {
        const tm_word16 word = comb_word(table, w, digit, c);
        memcpy(out + 16 * c, &word, 16);
    }
}

// The point whose canonical X, Y, Z, T encodings are e[0..127].
template <class E>
TM_DEV point<E> point_from_bytes(const uint8_t* e) {
    point<E> r = {field<E>::frombytes(e), field<E>::frombytes(e + 32),
                  field<E>::frombytes(e + 64), field<E>::frombytes(e + 96)};
    return r;
}

// [s]B, sum over w < 32 of [s_w * 256^w]B: 31 complete additions.
template <class E>
TM_DEV point<E> scalarmul_base_comb(const uint8_t* table, const uint8_t* s) {
    point<E> acc;
#pragma unroll 1
    for (int w = 0; w < TM_COMB_WINDOWS; ++w) {
        uint8_t entry[TM_COMB_BYTES];
        comb_select(table, w, s[w], entry);
        const point<E> sel = point_from_bytes<E>(entry);
        acc = w ? pt_add(acc, sel) : sel;
    }
    return acc;
}

// One row, as verify_row of ed25519_common.cuh with [s]B by the comb.
template <class E>
TM_DEV bool verify_row_comb(const uint8_t* table, const uint8_t* pub, const uint8_t* r,
                            const uint8_t* s, const uint8_t* k, bool valid) {
    point<E> a_pt, r_pt;
    const bool ok_a = decompress(a_pt, pub);
    const bool ok_r = decompress(r_pt, r);
    const bool id = verdict(scalarmul_base_comb<E>(table, s), a_pt, r_pt, k);
    return valid && ok_a && ok_r && id;
}

// ---------------------------------------------------------------------------
// Kernels and launchers
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

// TM_THREADS per block, as the radix-16 verify kernels: their registers
// set it.  A row past N runs row 0 as a dummy to the end, as a collective
// fe_mul (collective_mul) needs every lane.
template <class E>
static __global__ void verify_comb_kernel(const uint8_t* __restrict__ pub,
                                          const uint8_t* __restrict__ r,
                                          const uint8_t* __restrict__ s,
                                          const uint8_t* __restrict__ k,
                                          const uint8_t* __restrict__ valid,
                                          const uint8_t* __restrict__ table,
                                          uint8_t* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const size_t o = (size_t)(live ? i : 0) * 32;
    const bool ok = verify_row_comb<E>(table, pub + o, r + o, s + o, k + o,
                                       valid[live ? i : 0] != 0);
    if (live) out[i] = ok ? 1 : 0;
}

// Word q of out [N][32][128] is word q % 8 of row q / 256's entry in
// window (q / 8) % 32.  A block moves TM_COMB_SELECT_STEPS runs of
// TM_COMB_SELECT_THREADS consecutive words; each thread loads its words
// first, then stores them.
static __global__ void __launch_bounds__(TM_COMB_SELECT_THREADS)
comb_select_kernel(const uint8_t* __restrict__ s, const uint8_t* __restrict__ table,
                   uint8_t* __restrict__ out, int n) {
    const size_t words = (size_t)n * TM_COMB_WINDOWS * TM_COMB_WORDS;
    const size_t first = (size_t)blockIdx.x * TM_COMB_SELECT_STEPS * TM_COMB_SELECT_THREADS;
    tm_word16 got[TM_COMB_SELECT_STEPS];
#pragma unroll
    for (int k = 0; k < TM_COMB_SELECT_STEPS; ++k) {
        const size_t q = first + (size_t)k * TM_COMB_SELECT_THREADS + threadIdx.x;
        if (q < words) {
            const size_t i = q / (TM_COMB_WINDOWS * TM_COMB_WORDS);
            const int w = (int)(q / TM_COMB_WORDS) % TM_COMB_WINDOWS;
            got[k] = comb_word(table, w, s[i * TM_COMB_WINDOWS + w], (int)(q % TM_COMB_WORDS));
        }
    }
#pragma unroll
    for (int k = 0; k < TM_COMB_SELECT_STEPS; ++k) {
        const size_t q = first + (size_t)k * TM_COMB_SELECT_THREADS + threadIdx.x;
        if (q < words) reinterpret_cast<tm_word16*>(out)[q] = got[k];
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
    if (n > 0) {
        const size_t per_block = (size_t)TM_COMB_SELECT_STEPS * TM_COMB_SELECT_THREADS;
        const size_t words = (size_t)n * TM_COMB_WINDOWS * TM_COMB_WORDS;
        comb_select_kernel<<<(unsigned)((words + per_block - 1) / per_block),
                             TM_COMB_SELECT_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)s, (const uint8_t*)table, (uint8_t*)out, n);
    }
    return (int)cudaGetLastError();
}

#else  // host build

template <class E>
static void host_verify_comb(const uint8_t* pub, const uint8_t* r, const uint8_t* s,
                             const uint8_t* k, const uint8_t* valid, const uint8_t* table,
                             uint8_t* out, int n) {
    for (int i = 0; i < n; ++i) {
        size_t o = (size_t)i * 32;
        out[i] = verify_row_comb<E>(table, pub + o, r + o, s + o, k + o, valid[i] != 0) ? 1 : 0;
    }
}

static void host_comb_select(const uint8_t* s, const uint8_t* table, uint8_t* out, int n) {
    for (int i = 0; i < n; ++i)
        for (int w = 0; w < TM_COMB_WINDOWS; ++w)
            comb_select(table, w, s[(size_t)i * 32 + w],
                        out + ((size_t)i * TM_COMB_WINDOWS + w) * TM_COMB_BYTES);
}

#endif  // __CUDACC__

#endif  // TM_BASE_COMB_CUH
