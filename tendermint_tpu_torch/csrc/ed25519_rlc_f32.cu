// The RLC batch equation's kernels in the f32 layout: ed25519_rlc_f32
// (FFMA multiply), ed25519_rlc_f32_mma (the tensor-core multiply of
// fe_f32_mma.cuh, warp-collective) and rlc_fold_f32, which folds the
// lanes of both with the FFMA multiply (the same limbs).  The templates of
// ed25519_rlc.cuh, which says what they replace and what bounds them.
//
//   g++ -x c++ -O1 -shared -fPIC -DTM_COUNT_FIELD_OPS ed25519_rlc_f32.cu

#include "ed25519_rlc.cuh"
#include "fe_f32.cuh"
#include "fe_f32_mma.cuh"

static_assert(TM_RLC_POINT_THREADS <= 32 * TM_MMA_WARPS && TM_RLC_TASK_WARPS <= TM_MMA_WARPS,
              "a block of ed25519_rlc_f32_mma overruns fe_mul's shared staging");

TM_RLC_ENTRY(ed25519_rlc_f32, ff)
TM_RLC_ENTRY(ed25519_rlc_f32_mma, ffm)
TM_FOLD_ENTRY(rlc_fold_f32, ff)
