// Batched ZIP-215 Ed25519 verification for Hopper (sm_90a) on the FP32
// pipe: 51 signed 5-bit limbs in float (fe_f32.cuh).
//
// Replaces the XLA program `_Core.verify_core` of
// tendermint_tpu/ops/ed25519_jax.py with impl "f32" (:529, in its
// TM_TPU_FE_MXU=0 configuration), the field and point arithmetic of
// tendermint_tpu/ops/fe25519_f32.py it is built from, and, with
// `base_mxu`, its `_scalarmul_base_mxu` (:328, base_comb.cuh).  The curve
// pipeline is ed25519_common.cuh's, instantiated on the f32 field with
// the FFMA multiply; ed25519_verify_f32_mma.cu has the same kernels with
// the tensor-core one (TM_TPU_FE_MXU's configuration).  Three kernels:
//
//   ed25519_verify_f32       one verdict per signature.
//   ed25519_verify_f32_comb  the same with [s]B by the tensor-core comb
//                            (TM_CUDA_BASE_MXU=1).
//   fe_ops_f32               part check: a*b, a^2, a^((p-5)/8).
//
// What bounds it: FFMA.  Per signature about 2,400 multiplies (2,601
// products each) and 1,300 squarings (1,326), about 7.9 million FFMA, at
// 128 per SM per clock; 129 bytes per signature plus the 835 KiB table
// [64][16][4][51] of float limbs, read by digit.  One thread per
// signature; its points live mostly in local memory (see fe_f32.cuh).
//
//   g++ -x c++ -O1 -shared -fPIC -DTM_COUNT_FIELD_OPS ed25519_verify_f32.cu

#include "ed25519_common.cuh"
#include "fe_f32.cuh"
#include "base_comb.cuh"

#ifdef __CUDACC__

extern "C" int tm_ed25519_verify_f32(const void* pub, const void* r, const void* s,
                                     const void* k, const void* valid, const void* table,
                                     void* out, int n, void* stream) {
    return launch_verify<ff>(pub, r, s, k, valid, table, out, n, stream);
}

extern "C" int tm_ed25519_verify_f32_comb(const void* pub, const void* r, const void* s,
                                          const void* k, const void* valid, const void* table,
                                          void* out, int n, void* stream) {
    return launch_verify_comb<ff>(pub, r, s, k, valid, table, out, n, stream);
}

extern "C" int tm_fe_ops_f32(const void* a, const void* b, void* out_mul, void* out_sq,
                             void* out_p58, int n, void* stream) {
    return launch_fe_ops<ff>(a, b, out_mul, out_sq, out_p58, n, stream);
}

#else  // host build: the same rows, one after another, on the CPU

extern "C" void tm_host_ed25519_verify_f32(const uint8_t* pub, const uint8_t* r, const uint8_t* s,
                                           const uint8_t* k, const uint8_t* valid,
                                           const float* table, uint8_t* out, int n) {
    host_verify<ff>(pub, r, s, k, valid, table, out, n);
}

extern "C" void tm_host_ed25519_verify_f32_comb(const uint8_t* pub, const uint8_t* r,
                                                const uint8_t* s, const uint8_t* k,
                                                const uint8_t* valid, const uint8_t* table,
                                                uint8_t* out, int n) {
    host_verify_comb<ff>(pub, r, s, k, valid, table, out, n);
}

extern "C" void tm_host_fe_ops_f32(const uint8_t* a, const uint8_t* b, uint8_t* out_mul,
                                   uint8_t* out_sq, uint8_t* out_p58, int n) {
    host_fe_ops<ff>(a, b, out_mul, out_sq, out_p58, n);
}

#ifdef TM_COUNT_FIELD_OPS
// The multiplies and squarings counted since the last call; resets both.
extern "C" void tm_host_field_op_counts(uint64_t* mul_sq) { tm_take_field_op_counts(mul_sq); }
#endif

#endif  // __CUDACC__
