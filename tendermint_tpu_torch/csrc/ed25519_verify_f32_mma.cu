// Batched ZIP-215 Ed25519 verification for Hopper (sm_90a) on the f32
// layout with its field multiply on the tensor cores (fe_f32_mma.cuh).
//
// Replaces the XLA program `_Core.verify_core` of
// tendermint_tpu/ops/ed25519_jax.py with impl "f32" (:529) in its
// TM_TPU_FE_MXU configuration: the f32 field whose fe_mul is
// `_fe_mul_mxu` (tendermint_tpu/ops/fe25519_f32.py:202), the f32 rung of
// the JAX package's `auto` ladder, and, with `base_mxu`, its
// `_scalarmul_base_mxu` (ed25519_jax.py:328, base_comb.cuh; the JAX
// package grants the two together on f32).  The curve pipeline is
// ed25519_common.cuh's, instantiated on ffm.  Three kernels:
//
//   ed25519_verify_f32_mma       one verdict per signature.
//   ed25519_verify_f32_mma_comb  the same with [s]B by the tensor-core
//                                comb.
//   fe_mul_mma                   part check: the mma fe_mul alone, on raw
//                                limbs [N][51] (any within its contract).
//
// What bounds it: forming the limb products.  Per signature about 2,400
// multiplies, each 2,601 products on the IMAD pipe summed by 352 int8
// mma per warp, and 1,300 FFMA squarings (1,326 products).  One thread
// per signature, 32 to a warp, every lane through every multiply (rows
// past N as dummies); points in local memory as in ed25519_verify_f32.cu.
//
//   g++ -x c++ -O1 -shared -fPIC -DTM_COUNT_FIELD_OPS ed25519_verify_f32_mma.cu

#include "ed25519_common.cuh"
#include "fe_f32_mma.cuh"
#include "base_comb.cuh"

// One row of the fe_mul_mma part check: raw limbs in, carried limbs out.
TM_DEV void fe_mul_mma_row(const float* a, const float* b, float* out) {
    ffm x, y;
    for (int l = 0; l < TM_F_N; ++l) {
        x.v[l] = a[l];
        y.v[l] = b[l];
    }
    const ffm r = fe_mul(x, y);
    for (int l = 0; l < TM_F_N; ++l) out[l] = r.v[l];
}

#ifdef __CUDACC__

static_assert(TM_THREADS <= 32 * TM_MMA_WARPS,
              "a block of the verify kernels on ffm overruns fe_mul's shared staging");

// A thread past N multiplies row 0 with its warp and stores nothing.
static __global__ void fe_mul_mma_kernel(const float* __restrict__ a,
                                         const float* __restrict__ b, float* __restrict__ out,
                                         int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const size_t o = (size_t)(live ? i : 0) * TM_F_N;
    float got[TM_F_N];
    fe_mul_mma_row(a + o, b + o, got);
    if (live)
        for (int l = 0; l < TM_F_N; ++l) out[o + l] = got[l];
}

extern "C" int tm_ed25519_verify_f32_mma(const void* pub, const void* r, const void* s,
                                         const void* k, const void* valid, const void* table,
                                         void* out, int n, void* stream) {
    return launch_verify<ffm>(pub, r, s, k, valid, table, out, n, stream);
}

extern "C" int tm_ed25519_verify_f32_mma_comb(const void* pub, const void* r, const void* s,
                                              const void* k, const void* valid,
                                              const void* table, void* out, int n,
                                              void* stream) {
    return launch_verify_comb<ffm>(pub, r, s, k, valid, table, out, n, stream);
}

extern "C" int tm_fe_mul_mma(const void* a, const void* b, void* out, int n, void* stream) {
    if (n > 0)
        fe_mul_mma_kernel<<<blocks_for(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)a, (const float*)b, (float*)out, n);
    return (int)cudaGetLastError();
}

#else  // host build: the same rows, one after another, on the CPU

extern "C" void tm_host_ed25519_verify_f32_mma(const uint8_t* pub, const uint8_t* r,
                                               const uint8_t* s, const uint8_t* k,
                                               const uint8_t* valid, const float* table,
                                               uint8_t* out, int n) {
    host_verify<ffm>(pub, r, s, k, valid, table, out, n);
}

extern "C" void tm_host_ed25519_verify_f32_mma_comb(const uint8_t* pub, const uint8_t* r,
                                                    const uint8_t* s, const uint8_t* k,
                                                    const uint8_t* valid, const uint8_t* table,
                                                    uint8_t* out, int n) {
    host_verify_comb<ffm>(pub, r, s, k, valid, table, out, n);
}

extern "C" void tm_host_fe_mul_mma(const float* a, const float* b, float* out, int n) {
    for (int i = 0; i < n; ++i)
        fe_mul_mma_row(a + (size_t)i * TM_F_N, b + (size_t)i * TM_F_N, out + (size_t)i * TM_F_N);
}

#ifdef TM_COUNT_FIELD_OPS
// The multiplies and squarings counted since the last call; resets both.
extern "C" void tm_host_field_op_counts(uint64_t* mul_sq) { tm_take_field_op_counts(mul_sq); }
#endif

#endif  // __CUDACC__
