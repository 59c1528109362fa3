// Batched ZIP-215 Ed25519 verification for Hopper (sm_90a) in the packed
// layout: 10 limbs at the mixed radix 25.5 (fe_packed.cuh).
//
// Replaces the XLA program `_Core.verify_core` of
// tendermint_tpu/ops/ed25519_jax.py with impl "packed" (:529), and the
// field and point arithmetic of tendermint_tpu/ops/fe25519_packed.py it is
// built from.  The curve pipeline (decompress, [s]B from the radix-16
// table, the [k](-A) ladder, the verdict) is ed25519_common.cuh's,
// instantiated on the packed field.  Two kernels:
//
//   ed25519_verify_packed  one verdict per signature.
//   fe_ops_packed          part check: a*b, a^2, a^((p-5)/8).
//
// What bounds it: integer multiplies, as ed25519_verify: per signature
// about 2,400 multiplies (100 products each) and 1,300 squarings (55),
// one 32 x 32 -> 64-bit IMAD.WIDE.U32 per product; 129 bytes per
// signature plus the 80 KiB table [64][16][4][10] of uint32 limbs (the
// JAX module's limbs), read from global memory by digit.  One thread per
// signature, as ed25519_verify.  The comb is not offered in this layout,
// as in the JAX package.
//
//   g++ -x c++ -O1 -shared -fPIC -DTM_COUNT_FIELD_OPS ed25519_verify_packed.cu

#include "ed25519_common.cuh"
#include "fe_packed.cuh"

#ifdef __CUDACC__

extern "C" int tm_ed25519_verify_packed(const void* pub, const void* r, const void* s,
                                        const void* k, const void* valid, const void* table,
                                        void* out, int n, void* stream) {
    return launch_verify<fp>(pub, r, s, k, valid, table, out, n, stream);
}

extern "C" int tm_fe_ops_packed(const void* a, const void* b, void* out_mul, void* out_sq,
                                void* out_p58, int n, void* stream) {
    return launch_fe_ops<fp>(a, b, out_mul, out_sq, out_p58, n, stream);
}

#else  // host build: the same rows, one after another, on the CPU

extern "C" void tm_host_ed25519_verify_packed(const uint8_t* pub, const uint8_t* r,
                                              const uint8_t* s, const uint8_t* k,
                                              const uint8_t* valid, const uint32_t* table,
                                              uint8_t* out, int n) {
    host_verify<fp>(pub, r, s, k, valid, table, out, n);
}

extern "C" void tm_host_fe_ops_packed(const uint8_t* a, const uint8_t* b, uint8_t* out_mul,
                                      uint8_t* out_sq, uint8_t* out_p58, int n) {
    host_fe_ops<fp>(a, b, out_mul, out_sq, out_p58, n);
}

#ifdef TM_COUNT_FIELD_OPS
// The multiplies and squarings counted since the last call; resets both.
extern "C" void tm_host_field_op_counts(uint64_t* mul_sq) { tm_take_field_op_counts(mul_sq); }
#endif

#endif  // __CUDACC__
