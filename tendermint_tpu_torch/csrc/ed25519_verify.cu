// Batched ZIP-215 Ed25519 verification for Hopper (sm_90a), in 5 x 51-bit
// limbs.
//
// Replaces the XLA program `_Core.verify_core` of
// tendermint_tpu/ops/ed25519_jax.py (impl "int64"), together with the
// field and point arithmetic of tendermint_tpu/ops/fe25519.py it is built
// from and its `_Core.decompress` (both in ed25519_common.cuh), and, with
// `base_mxu`, its `_scalarmul_base_mxu` (base_comb.cuh).  Five kernels:
//
//   ed25519_verify       the main path: one verdict per signature.
//   ed25519_verify_comb  the same with [s]B by the w=8 comb
//                        (TM_CUDA_BASE_MXU=1).
//   fe_ops               part check: a*b, a^2, a^((p-5)/8) for field elements.
//   decompress           part check: permissive point decompression.
//   comb_select          part check: the comb's selection (a gather) alone.
//
// What bounds it: integer multiplies.  Per signature the kernel does about
// 2,100 field multiplies and 1,500 squarings (two decompressions, 63
// fixed-base additions, the [k](-A) ladder), each 25 (15 for a square)
// 51x51-bit limb products on the 32-bit integer multiply-add pipe.  It
// moves 129 bytes per signature plus one 160 KiB table, so memory is not
// the bound.  Design for now: one thread per signature and no shared
// state between threads, so each warp runs 32 independent verifies; the
// fixed-base table is read straight from global memory (L2/L1-resident,
// every input is public so no constant-time select is needed); the
// 16-entry table of multiples of -A is per-thread local memory.  Shared
// memory tables, several lanes per signature and shared doublings are
// later work.
//
// The device functions also compile as plain C++ (without __CUDACC__):
// the host build at the end of this file runs the same rows on the CPU,
// and with TM_COUNT_FIELD_OPS it counts the field multiplies and squarings
// of one row, the counts the bound in ops/kernels.py is computed from.
//
//   g++ -x c++ -O1 -shared -fPIC -DTM_COUNT_FIELD_OPS ed25519_verify.cu

#include "ed25519_common.cuh"
#include "base_comb.cuh"

TM_DEV bool decompress_row(const uint8_t* enc, uint8_t* out_xy) {
    pt p;
    bool ok = decompress(p, enc);
    fe_tobytes(out_xy, p.x);
    fe_tobytes(out_xy + 32, p.y);
    return ok;
}

// ---------------------------------------------------------------------------
// Kernels and their C entry points (one thread per row)
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

__global__ void decompress_kernel(const uint8_t* __restrict__ enc, uint8_t* __restrict__ xy,
                                  uint8_t* __restrict__ ok, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    ok[i] = decompress_row(enc + (size_t)i * 32, xy + (size_t)i * 64) ? 1 : 0;
}

extern "C" int tm_ed25519_verify(const void* pub, const void* r, const void* s, const void* k,
                                 const void* valid, const void* table, void* out, int n,
                                 void* stream) {
    return launch_verify<fe>(pub, r, s, k, valid, table, out, n, stream);
}

extern "C" int tm_ed25519_verify_comb(const void* pub, const void* r, const void* s,
                                      const void* k, const void* valid, const void* table,
                                      void* out, int n, void* stream) {
    return launch_verify_comb<fe>(pub, r, s, k, valid, table, out, n, stream);
}

extern "C" int tm_fe_ops(const void* a, const void* b, void* out_mul, void* out_sq, void* out_p58,
                         int n, void* stream) {
    return launch_fe_ops<fe>(a, b, out_mul, out_sq, out_p58, n, stream);
}

extern "C" int tm_decompress(const void* enc, void* xy, void* ok, int n, void* stream) {
    if (n > 0)
        decompress_kernel<<<blocks_for(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)enc, (uint8_t*)xy, (uint8_t*)ok, n);
    return (int)cudaGetLastError();
}

extern "C" int tm_comb_select(const void* s, const void* table, void* out, int n, void* stream) {
    return launch_comb_select(s, table, out, n, stream);
}

#else  // host build: the same rows, one after another, on the CPU

extern "C" void tm_host_ed25519_verify(const uint8_t* pub, const uint8_t* r, const uint8_t* s,
                                       const uint8_t* k, const uint8_t* valid,
                                       const uint64_t* table, uint8_t* out, int n) {
    host_verify<fe>(pub, r, s, k, valid, table, out, n);
}

extern "C" void tm_host_ed25519_verify_comb(const uint8_t* pub, const uint8_t* r,
                                            const uint8_t* s, const uint8_t* k,
                                            const uint8_t* valid, const uint8_t* table,
                                            uint8_t* out, int n) {
    host_verify_comb<fe>(pub, r, s, k, valid, table, out, n);
}

extern "C" void tm_host_fe_ops(const uint8_t* a, const uint8_t* b, uint8_t* out_mul,
                               uint8_t* out_sq, uint8_t* out_p58, int n) {
    host_fe_ops<fe>(a, b, out_mul, out_sq, out_p58, n);
}

extern "C" void tm_host_decompress(const uint8_t* enc, uint8_t* xy, uint8_t* ok, int n) {
    for (int i = 0; i < n; ++i) ok[i] = decompress_row(enc + (size_t)i * 32, xy + (size_t)i * 64);
}

extern "C" void tm_host_comb_select(const uint8_t* s, const uint8_t* table, uint8_t* out, int n) {
    host_comb_select(s, table, out, n);
}

#ifdef TM_COUNT_FIELD_OPS
// The multiplies and squarings counted since the last call; resets both.
extern "C" void tm_host_field_op_counts(uint64_t* mul_sq) { tm_take_field_op_counts(mul_sq); }
#endif

#endif  // __CUDACC__
