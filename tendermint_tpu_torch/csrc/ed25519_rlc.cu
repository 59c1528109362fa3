// The RLC batch equation's kernels in 5 x 51-bit limbs (ed25519_rlc,
// rlc_fold) and in the packed layout (ed25519_rlc_packed,
// rlc_fold_packed): the templates of ed25519_rlc.cuh, which says what they
// replace and what bounds them.
//
//   g++ -x c++ -O1 -shared -fPIC -DTM_COUNT_FIELD_OPS ed25519_rlc.cu

#include "ed25519_rlc.cuh"
#include "fe_packed.cuh"

TM_RLC_ENTRY(ed25519_rlc, fe)
TM_RLC_ENTRY(ed25519_rlc_packed, fp)
TM_FOLD_ENTRY(rlc_fold, fe)
TM_FOLD_ENTRY(rlc_fold_packed, fp)
