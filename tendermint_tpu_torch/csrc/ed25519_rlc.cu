// The cofactored random-linear-combination (RLC) batch equation for Hopper
// (sm_90a):
//
//   [8]( [c]B - sum_i [z_i k_i](A_i) - sum_i [z_i](R_i) ) == O,
//   c = sum_i z_i s_i mod L, z_i random 128-bit.
//
// Two kernels:
//
//   ed25519_rlc  replaces `_Core.verify_core_rlc` of
//                tendermint_tpu/ops/ed25519_jax.py:422.  Each block of
//                TM_RLC_THREADS rows, one thread per row, writes one lane:
//                its rows' part of sum_i [z_i k_i](-A_i) + [z_i](-R_i).
//                Each row also gets prevalid = valid && A, R on the curve.
//   rlc_fold     replaces `_pt_reduce_to_lanes(acc, 128)` (:390, called at
//                :516): folds the lanes pairwise to at most 128, in the
//                same pairing, so the host's big-int finish stays short.
//                Blocks run in no order and cannot carry the accumulator
//                between them, so the fold is a pass of its own: one
//                block, levels separated by __syncthreads.
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
// Horner's rule, acc = [16]acc + sum.  Rows past N add the identity.
//
// What bounds it: integer multiplies, as in ed25519_verify.  The design
// trades the per-row doubling ladder (252 doublings a row) for a serial
// chain per block of 64 x (4 doublings + log2(64) tree levels + 1
// addition), which one thread's latency sets; more rows per thread, a
// bucket method and fewer tree levels are later work.  Memory per thread:
// the two tables, 32 points of 160 bytes in local memory; shared memory:
// one point per thread for the tree.
//
// Like ed25519_verify.cu this file compiles as plain C++ without
// __CUDACC__; the host entry points at the end run the same device
// functions over the same block partition, serially, on the CPU.
//
//   g++ -x c++ -O1 -shared -fPIC -DTM_COUNT_FIELD_OPS ed25519_rlc.cu

#include "ed25519_common.cuh"

#define TM_RLC_THREADS 64    // rows per block of ed25519_rlc, one lane per block
#define TM_RLC_MAX_LANES 128  // rlc_fold's target width
#define TM_RLC_FOLD_THREADS 128

// The 16 multiples [0..15]p (14 additions).
TM_DEV void table16(pt* tbl, const pt& p) {
    tbl[0] = pt_identity<fe>();
    tbl[1] = p;
    for (int j = 2; j < 16; ++j) tbl[j] = pt_add(tbl[j - 1], p);
}

struct rlc_tables {
    pt a[16];  // [j](-A)
    pt r[16];  // [j](-R)
};

// Decompress A and R and build their tables; returns prevalid.
TM_DEV bool rlc_row_prepare(rlc_tables& tbl, const uint8_t* pub, const uint8_t* r, bool valid) {
    pt a_pt, r_pt;
    bool ok_a = decompress(a_pt, pub);
    bool ok_r = decompress(r_pt, r);
    table16(tbl.a, pt_neg(a_pt));
    table16(tbl.r, pt_neg(r_pt));
    return valid && ok_a && ok_r;
}

// The row's term in window w: [zk_w](-A), plus [z_w](-R) for w < 32.
TM_DEV pt rlc_row_term(const rlc_tables& tbl, const uint8_t* zk, const uint8_t* z, bool live,
                       int w) {
    pt term = tbl.a[live ? nibble(zk, w) : 0];
    if (w < 32) term = pt_add(term, tbl.r[live ? nibble(z, w) : 0]);
    return term;
}

// acc = [16]acc + sum: 4 doublings (T only on the last), 1 addition.
TM_DEV pt rlc_horner(const pt& acc, const pt& sum) {
    pt a = pt_dbl(acc, false);
    a = pt_dbl(a, false);
    a = pt_dbl(a, false);
    a = pt_dbl(a, true);
    return pt_add(a, sum);
}

// Lane layout: X, Y, Z, T, 5 limbs each (20 words), as the fixed-base table.
TM_DEV pt lane_load(const u64* lanes, int i) {
    const u64* e = lanes + (size_t)i * 20;
    pt r;
    for (int l = 0; l < 5; ++l) {
        r.x.v[l] = e[l];
        r.y.v[l] = e[5 + l];
        r.z.v[l] = e[10 + l];
        r.t.v[l] = e[15 + l];
    }
    return r;
}

TM_DEV void lane_store(u64* lanes, int i, const pt& p) {
    u64* e = lanes + (size_t)i * 20;
    for (int l = 0; l < 5; ++l) {
        e[l] = p.x.v[l];
        e[5 + l] = p.y.v[l];
        e[10 + l] = p.z.v[l];
        e[15 + l] = p.t.v[l];
    }
}

// ---------------------------------------------------------------------------
// Kernels and their C entry points
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

__global__ void __launch_bounds__(TM_RLC_THREADS)
ed25519_rlc_kernel(const uint8_t* __restrict__ pub, const uint8_t* __restrict__ r,
                   const uint8_t* __restrict__ zk, const uint8_t* __restrict__ z,
                   const uint8_t* __restrict__ valid, u64* __restrict__ lanes,
                   uint8_t* __restrict__ prevalid, int n) {
    __shared__ pt terms[TM_RLC_THREADS];
    const int tid = threadIdx.x;
    const int i = blockIdx.x * TM_RLC_THREADS + tid;
    const bool real = i < n;
    rlc_tables tbl;
    bool live = false;
    if (real) {
        live = rlc_row_prepare(tbl, pub + (size_t)i * 32, r + (size_t)i * 32, valid[i] != 0);
        prevalid[i] = live ? 1 : 0;
    }
    pt acc = pt_identity<fe>();
    for (int w = 63; w >= 0; --w) {
        terms[tid] = real ? rlc_row_term(tbl, zk + (size_t)i * 32, z + (size_t)i * 16, live, w)
                          : pt_identity<fe>();
        __syncthreads();
        // tree: level s adds terms[t + s] into terms[t] for t < s; reads
        // and writes of one level never touch the same slot twice
        for (int s = TM_RLC_THREADS / 2; s > 0; s >>= 1) {
            if (tid < s) terms[tid] = pt_add(terms[tid], terms[tid + s]);
            __syncthreads();
        }
        // only thread 0 reads terms[0] from here until it writes it again
        if (tid == 0) acc = rlc_horner(acc, terms[0]);
    }
    if (tid == 0) lane_store(lanes, blockIdx.x, acc);
}

// One block folds `in` (n lanes) into `work` until at most
// TM_RLC_MAX_LANES remain: per level, lane i += lane i + m for i < m = n/2,
// and an odd last lane moves to m.
__global__ void __launch_bounds__(TM_RLC_FOLD_THREADS)
rlc_fold_kernel(const u64* __restrict__ in, u64* __restrict__ work, int n) {
    const int tid = threadIdx.x;
    for (int i = tid; i < n; i += blockDim.x) lane_store(work, i, lane_load(in, i));
    __syncthreads();
    while (n > TM_RLC_MAX_LANES) {
        const int m = n / 2;
        for (int i = tid; i < m; i += blockDim.x)
            lane_store(work, i, pt_add(lane_load(work, i), lane_load(work, i + m)));
        __syncthreads();
        if ((n & 1) && tid == 0) lane_store(work, m, lane_load(work, 2 * m));
        __syncthreads();
        n = m + (n & 1);
    }
}

extern "C" int tm_ed25519_rlc(const void* pub, const void* r, const void* zk, const void* z,
                              const void* valid, void* lanes, void* prevalid, int n,
                              void* stream) {
    if (n > 0)
        ed25519_rlc_kernel<<<(n + TM_RLC_THREADS - 1) / TM_RLC_THREADS, TM_RLC_THREADS, 0,
                             (cudaStream_t)stream>>>(
            (const uint8_t*)pub, (const uint8_t*)r, (const uint8_t*)zk, (const uint8_t*)z,
            (const uint8_t*)valid, (u64*)lanes, (uint8_t*)prevalid, n);
    return (int)cudaGetLastError();
}

extern "C" int tm_rlc_fold(const void* lanes, void* work, int n, void* stream) {
    if (n > 0)
        rlc_fold_kernel<<<1, TM_RLC_FOLD_THREADS, 0, (cudaStream_t)stream>>>(
            (const u64*)lanes, (u64*)work, n);
    return (int)cudaGetLastError();
}

#else  // host build: the same blocks, one after another, on the CPU

#include <stdlib.h>

// Returns 0, or -1 if the tables could not be allocated.
extern "C" int tm_host_ed25519_rlc(const uint8_t* pub, const uint8_t* r, const uint8_t* zk,
                                   const uint8_t* z, const uint8_t* valid, uint64_t* lanes,
                                   uint8_t* prevalid, int n) {
    rlc_tables* tbl = (rlc_tables*)malloc(sizeof(rlc_tables) * TM_RLC_THREADS);
    if (tbl == NULL) return -1;
    bool live[TM_RLC_THREADS];
    pt terms[TM_RLC_THREADS];
    const int blocks = (n + TM_RLC_THREADS - 1) / TM_RLC_THREADS;
    for (int b = 0; b < blocks; ++b) {
        for (int t = 0; t < TM_RLC_THREADS; ++t) {
            const int i = b * TM_RLC_THREADS + t;
            if (i >= n) continue;
            live[t] = rlc_row_prepare(tbl[t], pub + (size_t)i * 32, r + (size_t)i * 32,
                                      valid[i] != 0);
            prevalid[i] = live[t] ? 1 : 0;
        }
        pt acc = pt_identity<fe>();
        for (int w = 63; w >= 0; --w) {
            for (int t = 0; t < TM_RLC_THREADS; ++t) {
                const int i = b * TM_RLC_THREADS + t;
                terms[t] = i < n ? rlc_row_term(tbl[t], zk + (size_t)i * 32, z + (size_t)i * 16,
                                                live[t], w)
                                 : pt_identity<fe>();
            }
            for (int s = TM_RLC_THREADS / 2; s > 0; s >>= 1)
                for (int t = 0; t < s; ++t) terms[t] = pt_add(terms[t], terms[t + s]);
            acc = rlc_horner(acc, terms[0]);
        }
        lane_store(lanes, b, acc);
    }
    free(tbl);
    return 0;
}

// Folds `in` (n lanes) into `work` (room for n); returns the lanes left.
extern "C" int tm_host_rlc_fold(const uint64_t* in, uint64_t* work, int n) {
    for (int i = 0; i < n; ++i) lane_store(work, i, lane_load(in, i));
    while (n > TM_RLC_MAX_LANES) {
        const int m = n / 2;
        for (int i = 0; i < m; ++i)
            lane_store(work, i, pt_add(lane_load(work, i), lane_load(work, i + m)));
        if (n & 1) lane_store(work, m, lane_load(work, 2 * m));
        n = m + (n & 1);
    }
    return n;
}

#ifdef TM_COUNT_FIELD_OPS
// The multiplies and squarings counted since the last call; resets both.
extern "C" void tm_host_field_op_counts(uint64_t* mul_sq) { tm_take_field_op_counts(mul_sq); }
#endif

#endif  // __CUDACC__
