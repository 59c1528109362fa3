// Batched ZIP-215 Ed25519 verification for Hopper (sm_90a).
//
// Replaces the XLA program `_Core.verify_core` of
// tendermint_tpu/ops/ed25519_jax.py, together with the field and point
// arithmetic of tendermint_tpu/ops/fe25519.py it is built from and its
// `_Core.decompress` (both in ed25519_common.cuh).  Three kernels:
//
//   ed25519_verify  the main path: one verdict per signature.
//   fe_ops          part check: a*b, a^2, a^((p-5)/8) for field elements.
//   decompress      part check: permissive point decompression.
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

// Entry (window i, digit j) of the fixed-base table [64][16][4][5]:
// [j * 16^i]B as X, Y, Z, T limbs.
TM_DEV pt table_entry(const u64* table, int i, int j) {
    const u64* e = table + (size_t)((i * 16 + j) * 4) * 5;
    pt r;
    for (int l = 0; l < 5; ++l) {
        r.x.v[l] = e[l];
        r.y.v[l] = e[5 + l];
        r.z.v[l] = e[10 + l];
        r.t.v[l] = e[15 + l];
    }
    return r;
}

// [s]B: one addition per radix-16 digit, no doublings.
TM_DEV pt scalarmul_base(const u64* table, const uint8_t* s) {
    pt acc = table_entry(table, 0, nibble(s, 0));
    for (int i = 1; i < 64; ++i) acc = pt_add(acc, table_entry(table, i, nibble(s, i)));
    return acc;
}

// [k](-A) by 4-bit fixed windows: 16 multiples of -A (14 additions), then
// 63 x (4 doublings + 1 addition), most significant digit first.
TM_DEV pt scalarmul_var(const uint8_t* k, const pt& neg_a) {
    pt tbl[16];
    tbl[0] = pt_identity();
    tbl[1] = neg_a;
    for (int j = 2; j < 16; ++j) tbl[j] = pt_add(tbl[j - 1], neg_a);
    pt acc = tbl[nibble(k, 63)];
    for (int i = 62; i >= 0; --i) {
        acc = pt_dbl(acc, false);
        acc = pt_dbl(acc, false);
        acc = pt_dbl(acc, false);
        acc = pt_dbl(acc, true);
        acc = pt_add(acc, tbl[nibble(k, i)]);
    }
    return acc;
}

// One row: valid && A, R on the curve && [8]([s]B + [k](-A) - R) == O.
TM_DEV bool verify_row(const uint8_t* pub, const uint8_t* r, const uint8_t* s, const uint8_t* k,
                       bool valid, const u64* table) {
    pt a_pt, r_pt;
    bool ok_a = decompress(a_pt, pub);
    bool ok_r = decompress(r_pt, r);
    pt w = pt_add(scalarmul_base(table, s), scalarmul_var(k, pt_neg(a_pt)));
    pt q = pt_add(w, pt_neg(r_pt));
    q = pt_dbl(q, false);
    q = pt_dbl(q, false);
    q = pt_dbl(q, false);
    return valid && ok_a && ok_r && pt_is_identity(q);
}

TM_DEV void fe_ops_row(const uint8_t* a_enc, const uint8_t* b_enc, uint8_t* out_mul,
                       uint8_t* out_sq, uint8_t* out_p58) {
    fe a = fe_frombytes(a_enc), b = fe_frombytes(b_enc);
    fe_tobytes(out_mul, fe_mul(a, b));
    fe_tobytes(out_sq, fe_sq(a));
    fe_tobytes(out_p58, fe_pow_p58(a));
}

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

#define TM_THREADS 64

__global__ void ed25519_verify_kernel(const uint8_t* __restrict__ pub, const uint8_t* __restrict__ r,
                                      const uint8_t* __restrict__ s, const uint8_t* __restrict__ k,
                                      const uint8_t* __restrict__ valid, const u64* __restrict__ table,
                                      uint8_t* __restrict__ out, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    size_t o = (size_t)i * 32;
    out[i] = verify_row(pub + o, r + o, s + o, k + o, valid[i] != 0, table) ? 1 : 0;
}

__global__ void fe_ops_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                              uint8_t* __restrict__ out_mul, uint8_t* __restrict__ out_sq,
                              uint8_t* __restrict__ out_p58, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    size_t o = (size_t)i * 32;
    fe_ops_row(a + o, b + o, out_mul + o, out_sq + o, out_p58 + o);
}

__global__ void decompress_kernel(const uint8_t* __restrict__ enc, uint8_t* __restrict__ xy,
                                  uint8_t* __restrict__ ok, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    ok[i] = decompress_row(enc + (size_t)i * 32, xy + (size_t)i * 64) ? 1 : 0;
}

static int blocks_for(int n) { return (n + TM_THREADS - 1) / TM_THREADS; }

extern "C" int tm_ed25519_verify(const void* pub, const void* r, const void* s, const void* k,
                                 const void* valid, const void* table, void* out, int n,
                                 void* stream) {
    if (n > 0)
        ed25519_verify_kernel<<<blocks_for(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)pub, (const uint8_t*)r, (const uint8_t*)s, (const uint8_t*)k,
            (const uint8_t*)valid, (const u64*)table, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int tm_fe_ops(const void* a, const void* b, void* out_mul, void* out_sq, void* out_p58,
                         int n, void* stream) {
    if (n > 0)
        fe_ops_kernel<<<blocks_for(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)a, (const uint8_t*)b, (uint8_t*)out_mul, (uint8_t*)out_sq,
            (uint8_t*)out_p58, n);
    return (int)cudaGetLastError();
}

extern "C" int tm_decompress(const void* enc, void* xy, void* ok, int n, void* stream) {
    if (n > 0)
        decompress_kernel<<<blocks_for(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)enc, (uint8_t*)xy, (uint8_t*)ok, n);
    return (int)cudaGetLastError();
}

#else  // host build: the same rows, one after another, on the CPU

extern "C" void tm_host_ed25519_verify(const uint8_t* pub, const uint8_t* r, const uint8_t* s,
                                       const uint8_t* k, const uint8_t* valid,
                                       const uint64_t* table, uint8_t* out, int n) {
    for (int i = 0; i < n; ++i) {
        size_t o = (size_t)i * 32;
        out[i] = verify_row(pub + o, r + o, s + o, k + o, valid[i] != 0, table) ? 1 : 0;
    }
}

extern "C" void tm_host_fe_ops(const uint8_t* a, const uint8_t* b, uint8_t* out_mul,
                               uint8_t* out_sq, uint8_t* out_p58, int n) {
    for (int i = 0; i < n; ++i) {
        size_t o = (size_t)i * 32;
        fe_ops_row(a + o, b + o, out_mul + o, out_sq + o, out_p58 + o);
    }
}

extern "C" void tm_host_decompress(const uint8_t* enc, uint8_t* xy, uint8_t* ok, int n) {
    for (int i = 0; i < n; ++i) ok[i] = decompress_row(enc + (size_t)i * 32, xy + (size_t)i * 64);
}

#ifdef TM_COUNT_FIELD_OPS
// The multiplies and squarings counted since the last call; resets both.
extern "C" void tm_host_field_op_counts(uint64_t* mul_sq) { tm_take_field_op_counts(mul_sq); }
#endif

#endif  // __CUDACC__
