// Device probes for Hopper (sm_90a): saturating chains of one operation
// each, timed by tendermint_tpu_torch/benchmarks/roofline_probe.py to
// measure what a pipe of the card sustains.
//
// Replaces the two Pallas kernels of benchmarks/roofline_probe.py
// (`run_pallas`, :378) and the XLA chain programs of its `run_chain`
// (:229).  Three kernel templates, each instance an extern "C" kernel so
// that its SASS is found by name:
//
//   op_chain_<kind>     a chain of x = (x * y) & mask, x = (x + y) & mask or
//                       x = x * y, one thread per element (op_chain_body).
//                       pl_i32mul (:399, pallas_call :417: int32, mask 255)
//                       launches op_chain_i32mul through tm_op_chain, the
//                       instance of run_chain's kinds floor and i32mul;
//                       op_chain_i64mul and op_chain_i64add are int64 with
//                       mask 2^17 - 1, op_chain_f32mul float32 (:240-281).
//   pl_femul8_<layout>  a chain of the 32 x 8-bit schoolbook field multiply
//                       (fe_mul8), one thread per lane: limb-major [32, N]
//                       (`mul8_lm` :432, kernel :449, pallas_call :463) or
//                       row-major [N, 32] (run_chain's "femul8", `_fe_mul8`
//                       :191).  Loads are coalesced across lanes in the
//                       limb-major layout, the TPU kernel's.
//   fe_mul_chain        a chain of the 5 x 51-bit fe_mul of
//                       ed25519_common.cuh, the port's production int64
//                       multiply, one thread per row [N, 5] (the counterpart
//                       of run_chain's "femul17" :284, which chains the JAX
//                       package's 15 x 17-bit fe_mul).
//
// What bounds them: by design, the pipe their chain step runs on (the
// integer multiply-add, logical or FP32 pipe); the inputs are read and the
// output written once per launch.  Each thread's chain is serial, so a
// warp waits on the latency of every step, and the card needs many warps
// in flight per scheduler to fill a pipe: the probes run at shapes of
// several waves.  The mask is a kernel argument, not a constant: with
// `& 255` known, the compiler may drop the inner masks (only the low bits
// of a product are demanded) and hoist y^k out of the loop, and the chain
// would measure nothing.  op_chain's loop is unrolled OP_CHAIN_UNROLL
// steps at a time (one counter update and branch per 16 steps); the field
// chains run one multiply per loop iteration.  All integer arithmetic
// stays within the probes' input bounds (op_chain: x, y <= mask;
// fe_mul8: limbs < 2^10, columns < 2^30.3; fe_mul: limbs < 2^54), so no
// signed intermediate overflows.
//
// The device functions also compile as plain C++ (without __CUDACC__):
// the host build at the end of this file runs the same chains on the CPU.
//
//   g++ -x c++ -O1 -shared -fPIC probes.cu

#include "ed25519_common.cuh"

#define OP_CHAIN_UNROLL 16
#define NL8 32

enum { OP_MUL_MASK = 0, OP_ADD_MASK = 1, OP_MUL = 2 };

template <class T, int OP>
TM_DEV T chain_step(T x, T y, T mask) {
    if constexpr (OP == OP_MUL_MASK) {
        return (x * y) & mask;
    } else if constexpr (OP == OP_ADD_MASK) {
        return (x + y) & mask;
    } else {
        return x * y;
    }
}

template <class T, int OP>
TM_DEV T op_chain_body(T x, T y, T mask, int chain) {
    int c = 0;
#pragma unroll 1
    for (; c + OP_CHAIN_UNROLL <= chain; c += OP_CHAIN_UNROLL) {
#pragma unroll
        for (int k = 0; k < OP_CHAIN_UNROLL; ++k) x = chain_step<T, OP>(x, y, mask);
    }
#pragma unroll 1
    for (; c < chain; ++c) x = chain_step<T, OP>(x, y, mask);
    return x;
}

// fe_mul8 in place: a <- a * b, limbs of 8 bits (2^256 = 38 mod p).  The
// 63 product columns in registers, the high 31 folded down x38, then six
// carry rounds of h = c >> 8, c = (c & 255) + h of the limb below (38 h[31]
// into limb 0): the JAX function's limbs exactly.
TM_DEV void fe_mul8(int32_t a[NL8], const int32_t b[NL8]) {
    int32_t cols[2 * NL8 - 1];
#pragma unroll
    for (int k = 0; k < 2 * NL8 - 1; ++k) cols[k] = 0;
#pragma unroll
    for (int i = 0; i < NL8; ++i) {
#pragma unroll
        for (int j = 0; j < NL8; ++j) cols[i + j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < NL8 - 1; ++i) cols[i] += 38 * cols[NL8 + i];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
        int32_t h[NL8];
#pragma unroll
        for (int k = 0; k < NL8; ++k) h[k] = cols[k] >> 8;
        cols[0] = (cols[0] & 255) + 38 * h[NL8 - 1];
#pragma unroll
        for (int k = 1; k < NL8; ++k) cols[k] = (cols[k] & 255) + h[k - 1];
    }
#pragma unroll
    for (int k = 0; k < NL8; ++k) a[k] = cols[k];
}

// Limb k of lane i: limb-major [32, n] or row-major [n, 32].
template <bool LIMB_MAJOR>
TM_DEV size_t limb_at(int k, size_t i, size_t n) {
    return LIMB_MAJOR ? (size_t)k * n + i : i * NL8 + k;
}

template <bool LIMB_MAJOR>
TM_DEV void femul8_lane(const int32_t* x, const int32_t* y, int32_t* out, size_t i, size_t n,
                        int chain) {
    int32_t a[NL8], b[NL8];
#pragma unroll
    for (int k = 0; k < NL8; ++k) {
        a[k] = x[limb_at<LIMB_MAJOR>(k, i, n)];
        b[k] = y[limb_at<LIMB_MAJOR>(k, i, n)];
    }
#pragma unroll 1
    for (int c = 0; c < chain; ++c) fe_mul8(a, b);
#pragma unroll
    for (int k = 0; k < NL8; ++k) out[limb_at<LIMB_MAJOR>(k, i, n)] = a[k];
}

TM_DEV void fe_mul_chain_row(const uint64_t* x, const uint64_t* y, uint64_t* out, size_t i,
                             int chain) {
    fe a, b;
    for (int k = 0; k < 5; ++k) {
        a.v[k] = x[i * 5 + k];
        b.v[k] = y[i * 5 + k];
    }
#pragma unroll 1
    for (int c = 0; c < chain; ++c) a = fe_mul(a, b);
    for (int k = 0; k < 5; ++k) out[i * 5 + k] = a.v[k];
}

// tm_op_chain's kind codes
enum { KIND_I32MUL = 0, KIND_I64MUL = 1, KIND_I64ADD = 2, KIND_F32MUL = 3 };

#ifdef __CUDACC__

#define TM_PROBE_THREADS 256

static int probe_blocks(int n) { return (n + TM_PROBE_THREADS - 1) / TM_PROBE_THREADS; }

#define TM_OP_CHAIN_KERNEL(name, T, OP)                                                     \
    extern "C" __global__ void name(const T* __restrict__ x, const T* __restrict__ y,       \
                                    T* __restrict__ out, T mask, int n, int chain) {        \
        const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;                    \
        if (i < (size_t)n) out[i] = op_chain_body<T, OP>(x[i], y[i], mask, chain);          \
    }

TM_OP_CHAIN_KERNEL(op_chain_i32mul, int32_t, OP_MUL_MASK)
TM_OP_CHAIN_KERNEL(op_chain_i64mul, int64_t, OP_MUL_MASK)
TM_OP_CHAIN_KERNEL(op_chain_i64add, int64_t, OP_ADD_MASK)
TM_OP_CHAIN_KERNEL(op_chain_f32mul, float, OP_MUL)

#define TM_FEMUL8_KERNEL(name, LIMB_MAJOR)                                                  \
    extern "C" __global__ void name(const int32_t* __restrict__ x,                          \
                                    const int32_t* __restrict__ y, int32_t* __restrict__ out, \
                                    int n, int chain) {                                     \
        const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;                    \
        if (i < (size_t)n) femul8_lane<LIMB_MAJOR>(x, y, out, i, (size_t)n, chain);          \
    }

TM_FEMUL8_KERNEL(pl_femul8_limb_major, true)
TM_FEMUL8_KERNEL(pl_femul8_row_major, false)

extern "C" __global__ void fe_mul_chain(const uint64_t* __restrict__ x,
                                        const uint64_t* __restrict__ y,
                                        uint64_t* __restrict__ out, int n, int chain) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < (size_t)n) fe_mul_chain_row(x, y, out, i, chain);
}

extern "C" int tm_op_chain(const void* x, const void* y, void* out, int n, int chain, int kind,
                           long long mask, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const int blocks = probe_blocks(n);
    switch (kind) {
        case KIND_I32MUL:
            op_chain_i32mul<<<blocks, TM_PROBE_THREADS, 0, s>>>(
                (const int32_t*)x, (const int32_t*)y, (int32_t*)out, (int32_t)mask, n, chain);
            break;
        case KIND_I64MUL:
            op_chain_i64mul<<<blocks, TM_PROBE_THREADS, 0, s>>>(
                (const int64_t*)x, (const int64_t*)y, (int64_t*)out, (int64_t)mask, n, chain);
            break;
        case KIND_I64ADD:
            op_chain_i64add<<<blocks, TM_PROBE_THREADS, 0, s>>>(
                (const int64_t*)x, (const int64_t*)y, (int64_t*)out, (int64_t)mask, n, chain);
            break;
        case KIND_F32MUL:
            op_chain_f32mul<<<blocks, TM_PROBE_THREADS, 0, s>>>(
                (const float*)x, (const float*)y, (float*)out, 0.0f, n, chain);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int tm_pl_femul8(const void* x, const void* y, void* out, int n, int chain,
                            int limb_major, void* stream) {
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        if (limb_major)
            pl_femul8_limb_major<<<probe_blocks(n), TM_PROBE_THREADS, 0, s>>>(
                (const int32_t*)x, (const int32_t*)y, (int32_t*)out, n, chain);
        else
            pl_femul8_row_major<<<probe_blocks(n), TM_PROBE_THREADS, 0, s>>>(
                (const int32_t*)x, (const int32_t*)y, (int32_t*)out, n, chain);
    }
    return (int)cudaGetLastError();
}

extern "C" int tm_fe_mul_chain(const void* x, const void* y, void* out, int n, int chain,
                               void* stream) {
    if (n > 0)
        fe_mul_chain<<<probe_blocks(n), TM_PROBE_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint64_t*)x, (const uint64_t*)y, (uint64_t*)out, n, chain);
    return (int)cudaGetLastError();
}

#else  // host build: the same chains, one element after another, on the CPU

extern "C" int tm_host_op_chain(const void* x, const void* y, void* out, int n, int chain,
                                int kind, long long mask) {
    for (int i = 0; i < n; ++i) {
        switch (kind) {
            case KIND_I32MUL:
                ((int32_t*)out)[i] = op_chain_body<int32_t, OP_MUL_MASK>(
                    ((const int32_t*)x)[i], ((const int32_t*)y)[i], (int32_t)mask, chain);
                break;
            case KIND_I64MUL:
                ((int64_t*)out)[i] = op_chain_body<int64_t, OP_MUL_MASK>(
                    ((const int64_t*)x)[i], ((const int64_t*)y)[i], (int64_t)mask, chain);
                break;
            case KIND_I64ADD:
                ((int64_t*)out)[i] = op_chain_body<int64_t, OP_ADD_MASK>(
                    ((const int64_t*)x)[i], ((const int64_t*)y)[i], (int64_t)mask, chain);
                break;
            case KIND_F32MUL:
                ((float*)out)[i] = op_chain_body<float, OP_MUL>(
                    ((const float*)x)[i], ((const float*)y)[i], 0.0f, chain);
                break;
            default:
                return 1;
        }
    }
    return 0;
}

extern "C" void tm_host_pl_femul8(const int32_t* x, const int32_t* y, int32_t* out, int n,
                                  int chain, int limb_major) {
    for (int i = 0; i < n; ++i) {
        if (limb_major)
            femul8_lane<true>(x, y, out, i, n, chain);
        else
            femul8_lane<false>(x, y, out, i, n, chain);
    }
}

extern "C" void tm_host_fe_mul_chain(const uint64_t* x, const uint64_t* y, uint64_t* out, int n,
                                     int chain) {
    for (int i = 0; i < n; ++i) fe_mul_chain_row(x, y, out, i, chain);
}

#endif  // __CUDACC__
