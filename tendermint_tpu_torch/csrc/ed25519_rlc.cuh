// The cofactored random-linear-combination (RLC) batch equation for Hopper
// (sm_90a), in every field layout:
//
//   [8]( [c]B - sum_i [z_i k_i](A_i) - sum_i [z_i](R_i) ) == O,
//   c = sum_i z_i s_i mod L, z_i random 128-bit.
//
// Two kernels, each a template over the field element E (5 x 51-bit fe,
// packed fp, f32 ff, or f32 with the tensor-core fe_mul ffm), as
// ed25519_common.cuh's pipeline is:
//
//   ed25519_rlc  replaces `_Core.verify_core_rlc` of
//                tendermint_tpu/ops/ed25519_jax.py:422, the program
//                `_compiled_rlc(n, impl)` (:701) builds for impl int64
//                (entry ed25519_rlc), packed (ed25519_rlc_packed), f32
//                (ed25519_rlc_f32) and f32 with the matrix-unit fe_mul
//                (ed25519_rlc_f32_mma).  Each block of TM_RLC_THREADS
//                rows, one thread per row, writes one lane: its rows'
//                part of sum_i [z_i k_i](-A_i) + [z_i](-R_i), as X, Y, Z,
//                T in E's limbs.  Each row also gets prevalid = valid &&
//                A, R on the curve.
//   rlc_fold     replaces `_pt_reduce_to_lanes(acc, 128)` (:390, called at
//                :516): folds the lanes pairwise to at most 128, in the
//                same pairing, so the host's big-int finish stays short
//                (entries rlc_fold, rlc_fold_packed, rlc_fold_f32).
//                Blocks run in no order and cannot carry the accumulator
//                between them, so the fold is a pass of its own: one
//                block, levels separated by __syncthreads.  The f32 lanes
//                of both f32 kernels fold with the FFMA fe_mul: the two
//                multiplies give the same limbs, and the fold takes about
//                0.14 ms on 157 lanes (H100).
//
// The host adds the lanes, adds [c]B and applies the [8] (finalize_rlc in
// ops/ed25519_torch.py).  The lanes of all blocks add up to the JAX
// program's one accumulator because doubling distributes over the sum.
//
// Per row: decompress A and R, then 16-entry tables of -A and -R (14
// complete additions each; [zk](-A), never [L-zk]A, which differs on
// points with a torsion part).  A row that is not prevalid selects digit
// 0, the identity, in every window.  Per window w = 63..0 each thread
// writes its row's term tblA[zk_w] (+ tblR[z_w] for w < 32: z has 32
// digits) to shared memory; the block sums the terms by a tree of
// complete additions, and thread 0 keeps the block's accumulator by
// Horner's rule, acc = [16]acc + sum.  A row past N runs row 0 with
// prevalid false, so it adds the identity.
//
// Every lane of a warp takes part in each addition its warp makes, as the
// warp-collective fe_mul (fe_f32_mma.cuh) needs, in every layout (a warp
// spends the same issue slots on masked lanes): at a tree level the lanes
// of an active warp that add nothing add their own slot to itself and
// discard the sum, and all of warp 0 runs the Horner step on the same
// values, thread 0 keeping it.  Warps with no lane to add sit the level
// out.
//
// What bounds it: the field multiplies, as in the verify kernels.  The
// design trades the per-row doubling ladder (252 doublings a row) for a
// serial chain per block of 64 x (4 doublings + log2(64) tree levels + 1
// addition), which one thread's latency sets; more rows per thread, a
// bucket method and fewer tree levels are later work.  Memory per thread:
// the two tables, 32 points in local memory (160 bytes each in 5 x 51 or
// packed limbs, 816 in f32); shared memory: one point per thread for the
// tree, dynamic (52,224 bytes for f32, past the 48 KiB a static array may
// take).
//
// This header holds the kernels as templates; ed25519_rlc.cu instantiates
// them for the 5 x 51-bit and packed layouts, ed25519_rlc_f32.cu for f32
// with either multiply (two sources, so that nvcc builds them at once).
// Like ed25519_verify.cu it compiles as plain C++ without __CUDACC__; the
// host entry points (TM_RLC_ENTRY, TM_FOLD_ENTRY) run the same device
// functions over the same block partition, serially, on the CPU.

#ifndef TM_ED25519_RLC_CUH
#define TM_ED25519_RLC_CUH

#include "ed25519_common.cuh"

#define TM_RLC_THREADS 64    // rows per block of ed25519_rlc, one lane per block
#define TM_RLC_MAX_LANES 128  // rlc_fold's target width
#define TM_RLC_FOLD_THREADS 128

// The 16 multiples [0..15]p (14 additions).
template <class E>
TM_DEV void table16(point<E>* tbl, const point<E>& p) {
    tbl[0] = pt_identity<E>();
    tbl[1] = p;
    for (int j = 2; j < 16; ++j) tbl[j] = pt_add(tbl[j - 1], p);
}

template <class E>
struct rlc_tables {
    point<E> a[16];  // [j](-A)
    point<E> r[16];  // [j](-R)
};

// Decompress A and R and build their tables; returns prevalid.
template <class E>
TM_DEV bool rlc_row_prepare(rlc_tables<E>& tbl, const uint8_t* pub, const uint8_t* r,
                            bool valid) {
    point<E> a_pt, r_pt;
    bool ok_a = decompress(a_pt, pub);
    bool ok_r = decompress(r_pt, r);
    table16(tbl.a, pt_neg(a_pt));
    table16(tbl.r, pt_neg(r_pt));
    return valid && ok_a && ok_r;
}

// The row's term in window w: [zk_w](-A), plus [z_w](-R) for w < 32.
template <class E>
TM_DEV point<E> rlc_row_term(const rlc_tables<E>& tbl, const uint8_t* zk, const uint8_t* z,
                             bool live, int w) {
    point<E> term = tbl.a[live ? nibble(zk, w) : 0];
    if (w < 32) term = pt_add(term, tbl.r[live ? nibble(z, w) : 0]);
    return term;
}

// acc = [16]acc + sum: 4 doublings (T only on the last), 1 addition.
template <class E>
TM_DEV point<E> rlc_horner(const point<E>& acc, const point<E>& sum) {
    point<E> a = pt_dbl(acc, false);
    a = pt_dbl(a, false);
    a = pt_dbl(a, false);
    a = pt_dbl(a, true);
    return pt_add(a, sum);
}

// Lane layout: X, Y, Z, T, field<E>::N limbs each, as the fixed-base table.
template <class E>
TM_DEV point<E> lane_load(const typename field<E>::limb* lanes, int i) {
    const int n = field<E>::N;
    const typename field<E>::limb* e = lanes + (size_t)i * 4 * n;
    point<E> r;
    for (int l = 0; l < n; ++l) {
        r.x.v[l] = e[l];
        r.y.v[l] = e[n + l];
        r.z.v[l] = e[2 * n + l];
        r.t.v[l] = e[3 * n + l];
    }
    return r;
}

template <class E>
TM_DEV void lane_store(typename field<E>::limb* lanes, int i, const point<E>& p) {
    const int n = field<E>::N;
    typename field<E>::limb* e = lanes + (size_t)i * 4 * n;
    for (int l = 0; l < n; ++l) {
        e[l] = p.x.v[l];
        e[n + l] = p.y.v[l];
        e[2 * n + l] = p.z.v[l];
        e[3 * n + l] = p.t.v[l];
    }
}

// ---------------------------------------------------------------------------
// Kernels and their C entry points
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

extern __shared__ __align__(16) unsigned char tm_rlc_terms[];  // point<E>[TM_RLC_THREADS]

template <class E>
__global__ void __launch_bounds__(TM_RLC_THREADS)
ed25519_rlc_kernel(const uint8_t* __restrict__ pub, const uint8_t* __restrict__ r,
                   const uint8_t* __restrict__ zk, const uint8_t* __restrict__ z,
                   const uint8_t* __restrict__ valid, typename field<E>::limb* __restrict__ lanes,
                   uint8_t* __restrict__ prevalid, int n) {
    point<E>* terms = reinterpret_cast<point<E>*>(tm_rlc_terms);
    const int tid = threadIdx.x;
    const int i = blockIdx.x * TM_RLC_THREADS + tid;
    const bool real = i < n;
    const size_t row = real ? i : 0;
    rlc_tables<E> tbl;
    const bool live =
        rlc_row_prepare(tbl, pub + row * 32, r + row * 32, valid[row] != 0) && real;
    if (real) prevalid[i] = live ? 1 : 0;
    point<E> acc = pt_identity<E>();
    for (int w = 63; w >= 0; --w) {
        terms[tid] = rlc_row_term(tbl, zk + row * 32, z + row * 16, live, w);
        __syncthreads();
        // tree: level s adds terms[t + s] into terms[t] for t < s; reads
        // and writes of one level never touch the same slot twice, and a
        // lane that only keeps its warp company reads its own slot (>= s)
        for (int s = TM_RLC_THREADS / 2; s > 0; s >>= 1) {
            const bool adds = tid < s;
            if ((tid & ~31) < s) {
                const point<E> sum = pt_add(terms[tid], terms[adds ? tid + s : tid]);
                if (adds) terms[tid] = sum;
            }
            __syncthreads();
        }
        if (tid < 32) {
            // all of warp 0 runs the step on the same sum, thread 0 keeps
            // it; read before the step: thread 0 writes terms[0] next
            const point<E> sum = terms[0];
            acc = rlc_horner(acc, sum);
        }
    }
    if (tid == 0) lane_store<E>(lanes, blockIdx.x, acc);
}

// One block folds `in` (n lanes) into `work` until at most
// TM_RLC_MAX_LANES remain: per level, lane i += lane i + m for i < m = n/2,
// and an odd last lane moves to m.
template <class E>
__global__ void __launch_bounds__(TM_RLC_FOLD_THREADS)
rlc_fold_kernel(const typename field<E>::limb* __restrict__ in,
                typename field<E>::limb* __restrict__ work, int n) {
    static_assert(!collective_mul<E>::value, "rlc_fold's lanes add on part of a warp");
    const int tid = threadIdx.x;
    for (int i = tid; i < n; i += blockDim.x) lane_store<E>(work, i, lane_load<E>(in, i));
    __syncthreads();
    while (n > TM_RLC_MAX_LANES) {
        const int m = n / 2;
        for (int i = tid; i < m; i += blockDim.x)
            lane_store<E>(work, i, pt_add(lane_load<E>(work, i), lane_load<E>(work, i + m)));
        __syncthreads();
        if ((n & 1) && tid == 0) lane_store<E>(work, m, lane_load<E>(work, 2 * m));
        __syncthreads();
        n = m + (n & 1);
    }
}

template <class E>
static int launch_rlc(const void* pub, const void* r, const void* zk, const void* z,
                      const void* valid, void* lanes, void* prevalid, int n, void* stream) {
    if (n > 0) {
        const int smem = TM_RLC_THREADS * (int)sizeof(point<E>);
        const cudaError_t err = cudaFuncSetAttribute(
            ed25519_rlc_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        ed25519_rlc_kernel<E><<<(n + TM_RLC_THREADS - 1) / TM_RLC_THREADS, TM_RLC_THREADS, smem,
                                (cudaStream_t)stream>>>(
            (const uint8_t*)pub, (const uint8_t*)r, (const uint8_t*)zk, (const uint8_t*)z,
            (const uint8_t*)valid, (typename field<E>::limb*)lanes, (uint8_t*)prevalid, n);
    }
    return (int)cudaGetLastError();
}

template <class E>
static int launch_rlc_fold(const void* lanes, void* work, int n, void* stream) {
    if (n > 0)
        rlc_fold_kernel<E><<<1, TM_RLC_FOLD_THREADS, 0, (cudaStream_t)stream>>>(
            (const typename field<E>::limb*)lanes, (typename field<E>::limb*)work, n);
    return (int)cudaGetLastError();
}

#define TM_RLC_ENTRY(name, E)                                                                \
    extern "C" int tm_##name(const void* pub, const void* r, const void* zk, const void* z,  \
                             const void* valid, void* lanes, void* prevalid, int n,           \
                             void* stream) {                                                  \
        return launch_rlc<E>(pub, r, zk, z, valid, lanes, prevalid, n, stream);               \
    }
#define TM_FOLD_ENTRY(name, E)                                                      \
    extern "C" int tm_##name(const void* lanes, void* work, int n, void* stream) {  \
        return launch_rlc_fold<E>(lanes, work, n, stream);                          \
    }

#else  // host build: the same blocks, one after another, on the CPU

#include <stdlib.h>

// Returns 0, or -1 if the tables could not be allocated.
template <class E>
static int host_rlc(const uint8_t* pub, const uint8_t* r, const uint8_t* zk, const uint8_t* z,
                    const uint8_t* valid, typename field<E>::limb* lanes, uint8_t* prevalid,
                    int n) {
    rlc_tables<E>* tbl = (rlc_tables<E>*)malloc(sizeof(rlc_tables<E>) * TM_RLC_THREADS);
    point<E>* terms = (point<E>*)malloc(sizeof(point<E>) * TM_RLC_THREADS);
    if (tbl == NULL || terms == NULL) {
        free(tbl);
        free(terms);
        return -1;
    }
    bool live[TM_RLC_THREADS];
    const int blocks = (n + TM_RLC_THREADS - 1) / TM_RLC_THREADS;
    for (int b = 0; b < blocks; ++b) {
        for (int t = 0; t < TM_RLC_THREADS; ++t) {
            const int i = b * TM_RLC_THREADS + t;
            if (i >= n) continue;
            live[t] = rlc_row_prepare(tbl[t], pub + (size_t)i * 32, r + (size_t)i * 32,
                                      valid[i] != 0);
            prevalid[i] = live[t] ? 1 : 0;
        }
        point<E> acc = pt_identity<E>();
        for (int w = 63; w >= 0; --w) {
            for (int t = 0; t < TM_RLC_THREADS; ++t) {
                const int i = b * TM_RLC_THREADS + t;
                terms[t] = i < n ? rlc_row_term(tbl[t], zk + (size_t)i * 32, z + (size_t)i * 16,
                                                live[t], w)
                                 : pt_identity<E>();
            }
            for (int s = TM_RLC_THREADS / 2; s > 0; s >>= 1)
                for (int t = 0; t < s; ++t) terms[t] = pt_add(terms[t], terms[t + s]);
            acc = rlc_horner(acc, terms[0]);
        }
        lane_store<E>(lanes, b, acc);
    }
    free(tbl);
    free(terms);
    return 0;
}

// Folds `in` (n lanes) into `work` (room for n); returns the lanes left.
template <class E>
static int host_rlc_fold(const typename field<E>::limb* in, typename field<E>::limb* work,
                         int n) {
    for (int i = 0; i < n; ++i) lane_store<E>(work, i, lane_load<E>(in, i));
    while (n > TM_RLC_MAX_LANES) {
        const int m = n / 2;
        for (int i = 0; i < m; ++i)
            lane_store<E>(work, i, pt_add(lane_load<E>(work, i), lane_load<E>(work, i + m)));
        if (n & 1) lane_store<E>(work, m, lane_load<E>(work, 2 * m));
        n = m + (n & 1);
    }
    return n;
}

#define TM_RLC_ENTRY(name, E)                                                                  \
    extern "C" int tm_host_##name(const uint8_t* pub, const uint8_t* r, const uint8_t* zk,     \
                                  const uint8_t* z, const uint8_t* valid,                      \
                                  typename field<E>::limb* lanes, uint8_t* prevalid, int n) {  \
        return host_rlc<E>(pub, r, zk, z, valid, lanes, prevalid, n);                          \
    }
#define TM_FOLD_ENTRY(name, E)                                                              \
    extern "C" int tm_host_##name(const typename field<E>::limb* in,                        \
                                  typename field<E>::limb* work, int n) {                   \
        return host_rlc_fold<E>(in, work, n);                                               \
    }

#ifdef TM_COUNT_FIELD_OPS
// The multiplies and squarings counted since the last call; resets both.
extern "C" void tm_host_field_op_counts(uint64_t* mul_sq) { tm_take_field_op_counts(mul_sq); }
#endif

#endif  // __CUDACC__

#endif  // TM_ED25519_RLC_CUH
