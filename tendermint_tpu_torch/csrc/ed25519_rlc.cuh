// The cofactored random-linear-combination (RLC) batch equation for Hopper
// (sm_90a), in every field layout:
//
//   [8]( [c]B - sum_i [z_i k_i](A_i) - sum_i [z_i](R_i) ) == O,
//   c = sum_i z_i s_i mod L, z_i random 128-bit.
//
// ed25519_rlc replaces `_Core.verify_core_rlc` of
// tendermint_tpu/ops/ed25519_jax.py:422, the program `_compiled_rlc(n,
// impl)` (:701) builds for impl int64 (entry ed25519_rlc), packed
// (ed25519_rlc_packed), f32 (ed25519_rlc_f32) and f32 with the matrix-unit
// fe_mul (ed25519_rlc_f32_mma): a template over the field element E, as
// ed25519_common.cuh's pipeline is.  It writes 64 lanes, one per window
// (TM_RLC_WINDOWS), whose sum is sum_i [z_i k_i](-A_i) + [z_i](-R_i)
// ([zk](-A), never [L-zk]A, which differs on points with a torsion part),
// as X, Y, Z, T in E's limbs, and prevalid = valid && A, R on the curve
// per row.  The host adds
// the lanes, adds [c]B and applies the [8] (finalize_rlc in
// ops/ed25519_torch.py).
//
// rlc_fold replaces `_pt_reduce_to_lanes(acc, 128)` (:390): it folds
// lanes pairwise to at most 128 in the JAX pairing, one block, levels
// separated by __syncthreads.  ed25519_rlc writes 64 lanes, so the RLC
// path no longer needs it; it stays as a ported kernel (entries rlc_fold,
// rlc_fold_packed, rlc_fold_f32).
//
// The schedule: a bucket (Pippenger) method over the whole batch, radix
// 16.  z*k < L has 63 nibbles (the 64th is 0) and z 32, so window w holds
// digit w of every row's z*k against -A_i and, for w < 32, digit w of z
// against -R_i; a row that is not prevalid contributes nothing (the
// identity).  Window w's sum is sum_j j * B_wj over the buckets j = 1..15,
// B_wj the sum of the points whose digit there is j, and the result is
// sum_w [16^w] (window w's sum).  Three launches:
//
//   0. points   one thread per point (A_i, then R_i): decompress, store
//               -A_i, -R_i and the on-curve flag into scratch, and the
//               point's digits as 96 planes of N bytes (64 of z*k, 32 of
//               z), so that a warp reads one digit of 32 rows at once.
//   1. buckets  one warp per task (window w, bucket j, split r of at most
//               16,384 rows): it scans the split's digits, eight steps of
//               32 rows at a time with every load in flight at once,
//               queues the points whose digit is j in a ring in shared
//               memory and, each time 32 are queued, every lane adds one,
//               so the lanes share a bucket's points evenly whatever the
//               digits' skew; then a tree over the lanes (shuffles) gives
//               B, and [j]B by double-and-add (j is the same in every
//               lane).  An empty task writes the identity and skips all
//               point work.
//   2. windows  one warp per window: the lanes sum the window's task
//               values, a tree over the lanes, then 4w doublings; lane w
//               of the output.  It also writes prevalid.
//
// Reckoning at N = 10,000 (point operations; a field operation is a
// multiply or squaring, an addition 9 multiplies, a doubling 7-8):
//   * per-row verify: ~420 point operations a row in one thread, a chain
//     of ~3,700 field operations;
//   * the Straus scheme this replaces (a block of 64 rows walks 64
//     windows: a term per row, a tree over the block's terms, Horner
//     [16]acc + sum in warp 0 alone): 60 additions a row for the two
//     16-entry tables and the R terms, 63 a row for the trees, 1.23
//     million additions in all, and a chain of 64 x (6 tree levels + 4
//     doublings + 1 addition) = 704 point operations (~6,000 field
//     operations), most of it in one warp while the other waits;
//   * the same scheme split by windows: the same 1.24 million additions
//     (the tables stay), and each split's partial sums still need their
//     [16^w] afterwards, so the chain keeps its ~250 doublings;
//   * this bucket method: ~90 additions a row (one per nonzero digit, no
//     tables), ~0.9 million in all, plus [j] (at most 6 operations) for
//     each of the 64 x 15 = 960 tasks and 8,064 doublings in the windows'
//     launch.  Chain: a decompression (275 field operations); a task of
//     window w < 32 (~1,250 points, 39 additions a lane) + 5 tree levels
//     + [j], ~50 point operations; then 5 tree levels and 248 doublings
//     in window 62: ~2,500 field operations, 0.7 of the per-row verify's.
//     The 248 doublings are the floor of any method: [16^62] must reach
//     window 62's sum.
//
// What bounds it on this card: latency.  The buckets kernel in 5 x 51-bit
// limbs holds 248 registers a thread, so an SM keeps 8 of its warps, and
// 960 tasks at 10,000 rows are one round of them: more, smaller tasks
// (the splits of 2,048 rows first tried) only repeat each task's tree and
// [j].  Then the windows' doubling chain, which only its length sets.
// The design gives every warp work for its whole run: no block has a
// phase in which one warp runs while another waits (the buckets' and the
// windows' warps are independent; their trees are within a warp), and a
// bucket's points are shared evenly by its lanes.  Nothing is kept in
// per-thread tables: the points live in scratch that the wrapper
// allocates (torch.empty), and no launch uses dynamic shared memory.
// Under the warp-collective fe_mul (ffm) every lane calls every field
// operation: the branches around point operations (a full batch queued,
// the task empty, the digit j, the window empty) are the same in every
// lane of a warp, and lanes with nothing to add add the identity.
//
// This header holds the kernels as templates; ed25519_rlc.cu instantiates
// them for the 5 x 51-bit and packed layouts, ed25519_rlc_f32.cu for f32
// with either multiply (two sources, so that nvcc builds them at once).
// Like ed25519_verify.cu it compiles as plain C++ without __CUDACC__; the
// host entry points (TM_RLC_ENTRY, TM_FOLD_ENTRY) run the same device
// functions over the same tasks, lanes and trees, serially, on the CPU.

#ifndef TM_ED25519_RLC_CUH
#define TM_ED25519_RLC_CUH

#include "ed25519_common.cuh"

#define TM_RLC_WINDOWS 64     // radix-16 digits of z*k; the output has a lane per window
#define TM_RLC_Z_WINDOWS 32   // radix-16 digits of z
#define TM_RLC_PLANES (TM_RLC_WINDOWS + TM_RLC_Z_WINDOWS)
#define TM_RLC_BUCKETS 15     // digits 1..15; digit 0 adds nothing
#ifndef TM_RLC_SPLIT_ROWS
#define TM_RLC_SPLIT_ROWS 16384  // rows per bucket task, at most (ops/kernels.RLC_SPLIT_ROWS)
#endif
#define TM_RLC_SCAN_STEPS 8    // rows a lane reads before the warp queues them
#define TM_RLC_RING 1024  // a warp's queue, a power of 2 above twice 31 + 32 x TM_RLC_SCAN_STEPS
#define TM_RLC_POINT_THREADS 64
#define TM_RLC_TASK_WARPS 2   // warps per block of the buckets launch
#define TM_RLC_MAX_LANES 128  // rlc_fold's target width
#define TM_RLC_FOLD_THREADS 128

#ifdef __CUDACC__
#define TM_HOST_DEV __host__ __device__ __forceinline__
#else
#define TM_HOST_DEV static inline
#endif

TM_HOST_DEV int rlc_splits(int n) {
    return n > TM_RLC_SPLIT_ROWS ? (n + TM_RLC_SPLIT_ROWS - 1) / TM_RLC_SPLIT_ROWS : 1;
}
TM_HOST_DEV int rlc_tasks(int n) { return TM_RLC_WINDOWS * TM_RLC_BUCKETS * rlc_splits(n); }

// Task g: window w, digit j and rows [lo, hi); a window's tasks are
// consecutive.
struct rlc_task {
    int w, j, lo, hi;
};

TM_DEV rlc_task rlc_task_of(int g, int n) {
    const int splits = rlc_splits(n), per = TM_RLC_BUCKETS * splits;
    const int rem = g % per, r = rem % splits;
    rlc_task t = {g / per, 1 + rem / splits, (int)((long long)r * n / splits),
                  (int)((long long)(r + 1) * n / splits)};
    return t;
}

// Point p of the batch (A_p for p < n, else R_{p-n}): -P into `neg`, and
// its digits into the planes (z*k's for A, z's for R).  Returns whether P
// is on the curve.
template <class E>
TM_DEV bool rlc_point(point<E>& neg, uint8_t* planes, const uint8_t* pub, const uint8_t* r,
                      const uint8_t* zk, const uint8_t* z, int p, int n, bool store) {
    const bool is_r = p >= n;
    const int row = is_r ? p - n : p;
    point<E> pt;
    const bool ok = decompress(pt, (is_r ? r : pub) + (size_t)row * 32);
    neg = pt_neg(pt);
    if (store) {
        if (is_r)
            for (int w = 0; w < TM_RLC_Z_WINDOWS; ++w)
                planes[(size_t)(TM_RLC_WINDOWS + w) * n + row] = nibble(z + (size_t)row * 16, w);
        else
            for (int w = 0; w < TM_RLC_WINDOWS; ++w)
                planes[(size_t)w * n + row] = nibble(zk + (size_t)row * 32, w);
    }
    return ok;
}

TM_DEV bool rlc_prevalid(const uint8_t* valid, const uint8_t* okf, int i, int n) {
    return valid[i] && okf[i] && okf[n + i];
}

// [j]b for a digit j in 1..15, most significant bit first; T is formed
// only where an addition or the end follows.
template <class E>
TM_DEV point<E> rlc_times_digit(const point<E>& b, int j) {
    int top = 3;
    while (!((j >> top) & 1)) --top;
    point<E> v = b;
    for (int bit = top - 1; bit >= 0; --bit) {
        const bool add = (j >> bit) & 1;
        v = pt_dbl(v, add || bit == 0);
        if (add) v = pt_add(v, b);
    }
    return v;
}

// Point layout in scratch and in the lanes: X, Y, Z, T, field<E>::N limbs
// each.
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

#define TM_FULL_MASK 0xffffffffu

// Lane + s's point (a lane past 31 keeps its own).
template <class E>
TM_DEV point<E> pt_shfl_down(const point<E>& p, int s) {
    point<E> r;
    for (int l = 0; l < field<E>::N; ++l) {
        r.x.v[l] = __shfl_down_sync(TM_FULL_MASK, p.x.v[l], s);
        r.y.v[l] = __shfl_down_sync(TM_FULL_MASK, p.y.v[l], s);
        r.z.v[l] = __shfl_down_sync(TM_FULL_MASK, p.z.v[l], s);
        r.t.v[l] = __shfl_down_sync(TM_FULL_MASK, p.t.v[l], s);
    }
    return r;
}

// Launch 0: a thread per point; threads past 2N run point 0 as dummies
// and store nothing (every lane calls a collective fe_mul).
template <class E>
__global__ void __launch_bounds__(TM_RLC_POINT_THREADS)
rlc_points_kernel(const uint8_t* __restrict__ pub, const uint8_t* __restrict__ r,
                  const uint8_t* __restrict__ zk, const uint8_t* __restrict__ z,
                  typename field<E>::limb* __restrict__ pts, uint8_t* __restrict__ okf,
                  uint8_t* __restrict__ planes, int n) {
    const int t = blockIdx.x * TM_RLC_POINT_THREADS + threadIdx.x;
    const bool real = t < 2 * n;
    point<E> neg;
    const bool ok = rlc_point(neg, planes, pub, r, zk, z, real ? t : 0, n, real);
    if (real) {
        lane_store<E>(pts, t, neg);
        okf[t] = ok ? 1 : 0;
    }
}

// Launch 1: a warp per task; see the header note.
template <class E>
__global__ void __launch_bounds__(32 * TM_RLC_TASK_WARPS)
rlc_buckets_kernel(const uint8_t* __restrict__ valid, const uint8_t* __restrict__ okf,
                   const uint8_t* __restrict__ planes,
                   const typename field<E>::limb* __restrict__ pts,
                   typename field<E>::limb* __restrict__ vals, int* __restrict__ cnt, int n) {
    __shared__ int ring[TM_RLC_TASK_WARPS][TM_RLC_RING];
    const int lane = threadIdx.x & 31;
    const int g = blockIdx.x * TM_RLC_TASK_WARPS + (threadIdx.x >> 5);
    if (g >= rlc_tasks(n)) return;  // a whole warp
    int* q = ring[threadIdx.x >> 5];
    const rlc_task task = rlc_task_of(g, n);
    point<E> acc = pt_identity<E>();
    bool full = false;  // a batch of 32 was taken: every lane holds a sum
    int head = 0, tail = 0;  // points taken from the queue, and queued
    for (int plane = 0; plane < (task.w < TM_RLC_Z_WINDOWS ? 2 : 1); ++plane) {
        const uint8_t* digits = planes + (size_t)(plane ? TM_RLC_WINDOWS + task.w : task.w) * n;
        const int first = plane ? n : 0;  // -R_i is point n + i
        for (int i0 = task.lo; i0 < task.hi; i0 += 32 * TM_RLC_SCAN_STEPS) {
            // every load of the steps is made before any is used (& does
            // not short-circuit), so their latencies overlap
            bool hits[TM_RLC_SCAN_STEPS];
#pragma unroll
            for (int k = 0; k < TM_RLC_SCAN_STEPS; ++k) {
                const int i = i0 + 32 * k + lane;
                const int c = i < task.hi ? i : task.lo;
                hits[k] = (i < task.hi) & (digits[c] == task.j) & (valid[c] != 0) &
                          (okf[c] != 0) & (okf[n + c] != 0);
            }
#pragma unroll
            for (int k = 0; k < TM_RLC_SCAN_STEPS; ++k) {
                const unsigned ballot = __ballot_sync(TM_FULL_MASK, hits[k]);
                if (hits[k])
                    q[(tail + __popc(ballot & ((1u << lane) - 1u))) & (TM_RLC_RING - 1)] =
                        first + i0 + 32 * k + lane;
                tail += __popc(ballot);
            }
            __syncwarp();
            while (tail - head >= 32) {  // the same in every lane
                const point<E> x = lane_load<E>(pts, q[(head + lane) & (TM_RLC_RING - 1)]);
                head += 32;
                acc = full ? pt_add(acc, x) : x;
                full = true;
            }
        }
    }
    const int count = tail;
    if (count == 0) {
        if (lane == 0) {
            lane_store<E>(vals, g, pt_identity<E>());
            cnt[g] = 0;
        }
        return;
    }
    if (tail > head) {  // the last batch is short: lanes past it add the identity
        const int rest = tail - head;
        const point<E> x = lane < rest ? lane_load<E>(pts, q[(head + lane) & (TM_RLC_RING - 1)])
                                       : pt_identity<E>();
        acc = full ? pt_add(acc, x) : x;
    }
    // lanes 0 .. m - 1 hold sums; lane 0 ends with B
    const int m = count < 32 ? count : 32;
    for (int s = 1; s < m; s <<= 1) {
        const point<E> other = pt_shfl_down(acc, s);
        const point<E> sum = pt_add(acc, other);
        if ((lane & (2 * s - 1)) == 0 && lane + s < m) acc = sum;
    }
    const point<E> v = rlc_times_digit(acc, task.j);
    if (lane == 0) {
        lane_store<E>(vals, g, v);
        cnt[g] = count;
    }
}

// Launch 2: a warp per window w; lane 0 writes lane w.  The warps also
// write prevalid.
template <class E>
__global__ void __launch_bounds__(32)
rlc_windows_kernel(const uint8_t* __restrict__ valid, const uint8_t* __restrict__ okf,
                   const typename field<E>::limb* __restrict__ vals, const int* __restrict__ cnt,
                   typename field<E>::limb* __restrict__ lanes, uint8_t* __restrict__ prevalid,
                   int n) {
    const int w = blockIdx.x, lane = threadIdx.x;
    for (int i = w * 32 + lane; i < n; i += TM_RLC_WINDOWS * 32)
        prevalid[i] = rlc_prevalid(valid, okf, i, n) ? 1 : 0;
    const int per = TM_RLC_BUCKETS * rlc_splits(n), g0 = w * per;
    point<E> acc = pt_identity<E>();
    bool have = false;
    for (int k0 = 0; k0 < per; k0 += 32) {
        const int k = k0 + lane;
        const bool real = k < per && cnt[g0 + k] > 0;
        const point<E> x = real ? lane_load<E>(vals, g0 + k) : pt_identity<E>();
        if (k0 == 0) {
            acc = x;
        } else {
            const point<E> sum = pt_add(acc, x);
            if (real) acc = have ? sum : x;
        }
        have = have || real;
    }
    if (!__any_sync(TM_FULL_MASK, have)) {  // an empty window
        if (lane == 0) lane_store<E>(lanes, w, pt_identity<E>());
        return;
    }
    for (int s = 1; s < 32; s <<= 1) {
        const point<E> other = pt_shfl_down(acc, s);
        const bool other_has = __shfl_down_sync(TM_FULL_MASK, (int)have, s) != 0;
        const point<E> sum = pt_add(acc, other);
        if ((lane & (2 * s - 1)) == 0 && other_has) {
            acc = have ? sum : other;
            have = true;
        }
    }
    for (int d = 0; d < 4 * w; ++d) acc = pt_dbl(acc, d == 4 * w - 1);
    if (lane == 0) lane_store<E>(lanes, w, acc);
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

// Launch `stage` (0, 1, 2) of ed25519_rlc; the scratch comes from the
// caller: pts [2N] points, okf [2N] bytes, planes [96 N] bytes, vals
// [rlc_tasks(N)] points, cnt [rlc_tasks(N)] ints.
template <class E>
static int launch_rlc(int stage, const void* pub, const void* r, const void* zk, const void* z,
                      const void* valid, void* lanes, void* prevalid, void* pts, void* okf,
                      void* planes, void* vals, void* cnt, int n, void* stream) {
    typedef typename field<E>::limb limb;
    cudaStream_t st = (cudaStream_t)stream;
    if (n > 0 && stage == 0)
        rlc_points_kernel<E><<<(2 * n + TM_RLC_POINT_THREADS - 1) / TM_RLC_POINT_THREADS,
                               TM_RLC_POINT_THREADS, 0, st>>>(
            (const uint8_t*)pub, (const uint8_t*)r, (const uint8_t*)zk, (const uint8_t*)z,
            (limb*)pts, (uint8_t*)okf, (uint8_t*)planes, n);
    else if (n > 0 && stage == 1)
        rlc_buckets_kernel<E><<<(rlc_tasks(n) + TM_RLC_TASK_WARPS - 1) / TM_RLC_TASK_WARPS,
                                32 * TM_RLC_TASK_WARPS, 0, st>>>(
            (const uint8_t*)valid, (const uint8_t*)okf, (const uint8_t*)planes,
            (const limb*)pts, (limb*)vals, (int*)cnt, n);
    else if (n > 0 && stage == 2)
        rlc_windows_kernel<E><<<TM_RLC_WINDOWS, 32, 0, st>>>(
            (const uint8_t*)valid, (const uint8_t*)okf, (const limb*)vals, (const int*)cnt,
            (limb*)lanes, (uint8_t*)prevalid, n);
    return (int)cudaGetLastError();
}

template <class E>
static int launch_rlc_fold(const void* lanes, void* work, int n, void* stream) {
    if (n > 0)
        rlc_fold_kernel<E><<<1, TM_RLC_FOLD_THREADS, 0, (cudaStream_t)stream>>>(
            (const typename field<E>::limb*)lanes, (typename field<E>::limb*)work, n);
    return (int)cudaGetLastError();
}

#define TM_RLC_ENTRY(name, E)                                                               \
    extern "C" int tm_##name(int stage, const void* pub, const void* r, const void* zk,     \
                             const void* z, const void* valid, void* lanes, void* prevalid, \
                             void* pts, void* okf, void* planes, void* vals, void* cnt,     \
                             int n, void* stream) {                                         \
        return launch_rlc<E>(stage, pub, r, zk, z, valid, lanes, prevalid, pts, okf,        \
                             planes, vals, cnt, n, stream);                                 \
    }
#define TM_FOLD_ENTRY(name, E)                                                      \
    extern "C" int tm_##name(const void* lanes, void* work, int n, void* stream) {  \
        return launch_rlc_fold<E>(lanes, work, n, stream);                          \
    }

#else  // host build: the same tasks, lanes and trees, one after another, on the CPU

#include <stdlib.h>

// The lanes' sums of one warp: lane l (< 32) holds acc[l] where has[l];
// a tree over them, as the card's shuffles pair them.  Returns whether
// any lane had one; acc[0] is then the sum.
template <class E>
static bool host_lane_tree(point<E>* acc, bool* has) {
    for (int s = 1; s < 32; s <<= 1)
        for (int l = 0; l < 32; l += 2 * s)
            if (has[l + s]) {
                acc[l] = has[l] ? pt_add(acc[l], acc[l + s]) : acc[l + s];
                has[l] = true;
            }
    return has[0];
}

// Returns 0, or -1 if the scratch could not be allocated.
template <class E>
static int host_rlc(const uint8_t* pub, const uint8_t* r, const uint8_t* zk, const uint8_t* z,
                    const uint8_t* valid, typename field<E>::limb* lanes, uint8_t* prevalid,
                    int n) {
    if (n <= 0) return 0;
    const int tasks = rlc_tasks(n);
    point<E>* pts = (point<E>*)malloc(sizeof(point<E>) * 2 * n);
    point<E>* vals = (point<E>*)malloc(sizeof(point<E>) * tasks);
    point<E>* acc = (point<E>*)malloc(sizeof(point<E>) * 32);
    int* cnt = (int*)malloc(sizeof(int) * tasks);
    uint8_t* okf = (uint8_t*)malloc(2 * (size_t)n);
    uint8_t* planes = (uint8_t*)malloc((size_t)TM_RLC_PLANES * n);
    int status = -1;
    if (pts && vals && acc && cnt && okf && planes) {
        status = 0;
        for (int p = 0; p < 2 * n; ++p)  // launch 0
            okf[p] = rlc_point(pts[p], planes, pub, r, zk, z, p, n, true) ? 1 : 0;
        for (int g = 0; g < tasks; ++g) {  // launch 1: entry e goes to lane e % 32
            const rlc_task task = rlc_task_of(g, n);
            int count = 0;
            for (int plane = 0; plane < (task.w < TM_RLC_Z_WINDOWS ? 2 : 1); ++plane) {
                const uint8_t* digits =
                    planes + (size_t)(plane ? TM_RLC_WINDOWS + task.w : task.w) * n;
                for (int i = task.lo; i < task.hi; ++i) {
                    if (digits[i] != task.j || !rlc_prevalid(valid, okf, i, n)) continue;
                    const point<E>& x = pts[(plane ? n : 0) + i];
                    acc[count % 32] = count >= 32 ? pt_add(acc[count % 32], x) : x;
                    ++count;
                }
            }
            bool has[32];
            for (int l = 0; l < 32; ++l) has[l] = l < count;
            vals[g] = host_lane_tree(acc, has) ? rlc_times_digit(acc[0], task.j)
                                               : pt_identity<E>();
            cnt[g] = count;
        }
        const int per = TM_RLC_BUCKETS * rlc_splits(n);
        for (int w = 0; w < TM_RLC_WINDOWS; ++w) {  // launch 2
            bool has[32] = {false};
            for (int k = 0; k < per; ++k) {
                if (cnt[w * per + k] == 0) continue;
                const int l = k % 32;
                acc[l] = has[l] ? pt_add(acc[l], vals[w * per + k]) : vals[w * per + k];
                has[l] = true;
            }
            point<E> sum = pt_identity<E>();
            if (host_lane_tree(acc, has)) {
                sum = acc[0];
                for (int d = 0; d < 4 * w; ++d) sum = pt_dbl(sum, d == 4 * w - 1);
            }
            lane_store<E>(lanes, w, sum);
        }
        for (int i = 0; i < n; ++i) prevalid[i] = rlc_prevalid(valid, okf, i, n) ? 1 : 0;
    }
    free(pts);
    free(vals);
    free(acc);
    free(cnt);
    free(okf);
    free(planes);
    return status;
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
