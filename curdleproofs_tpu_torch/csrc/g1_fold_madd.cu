// g1_fold_madd: the Pippenger bucket fold with the complete mixed add.  For
// each slot s, accumulate the T resident bases that the plan assigns to it;
// dead rows (liveness bit 0: input infinities and the plan's sentinel) keep
// the accumulator.
//
// Replaces the TPU kernel `g1_fold_rows_madd_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:446, launch `_fold_packed_call` :420, body
// `_g1_fold_rows_madd_kernel` :398 -> `_k_g1_madd` :115).  The TPU caller
// materialises the gathered bases ([12, T, S] twice); this kernel gathers
// from the resident [P | -P | inf] bases itself.
//
// Bound: integer multiplies.  Each live row is one mixed add of 11 field
// products (6600 32-bit multiplies) against 100 bytes gathered.  Design, the
// repack and the slot loop it shares with g1_fold_packed.cu: g1_fold.cuh
// (row step `cc::MaddRow`).
#include "g1_fold.cuh"

// pts: scratch of n_ext x 24 words from the caller
extern "C" int cp_g1_fold_madd(const void* ext_px, const void* ext_py,
                               const void* ext_zb, const void* plan,
                               int64_t n_ext, int t_rows, int64_t s_pad,
                               void* pts, void* ox, void* oy, void* oz,
                               void* stream) {
  return g1_fold_launch<cc::MaddRow>(ext_px, ext_py, ext_zb, plan, n_ext,
                                     t_rows, s_pad, pts, ox, oy, oz, stream);
}
