// g1_fold_packed: the Pippenger bucket fold with the complete add.  For each
// slot s, accumulate the T resident bases that the plan assigns to it, z
// rebuilt from the liveness bit (Montgomery one, or 0), every row through
// the add, dead rows too: the complete add returns the same point for
// P + infinity but not the same projective representative, so the output
// differs from the mixed-add fold's.
//
// Replaces the TPU kernel `g1_fold_rows_packed_pallas` (curdleproofs_tpu/ops/
// pallas_kernels.py:439, launch `_fold_packed_call` :420, body
// `_g1_fold_rows_packed_kernel` :381 -> `_k_g1_add` :90), the fold that the
// reference's `CURDLEPROOFS_MADD=0` switch selects.
//
// Bound: integer multiplies, counted as the least work that writes the same
// words: 11 field products a live row (the mixed add writes the complete
// add's words there, as tests/test_torch_fq_core.py holds), 3 a dead row
// of the ingest's form (0 : +-1 : 0), 600 32-bit multiplies a product,
// against 100 bytes gathered a row.  Design: the repack, the slot loop and
// the row step `cc::FullRow` (the scale of dead rows, the warp's vote) in
// g1_fold.cuh.
#include "g1_fold.cuh"

// pts: scratch of n_ext x 24 words from the caller
extern "C" int cp_g1_fold_packed(const void* ext_px, const void* ext_py,
                                 const void* ext_zb, const void* plan,
                                 int64_t n_ext, int t_rows, int64_t s_pad,
                                 void* pts, void* ox, void* oy, void* oz,
                                 void* stream) {
  return g1_fold_launch<cc::FullRow>(ext_px, ext_py, ext_zb, plan, n_ext,
                                     t_rows, s_pad, pts, ox, oy, oz, stream);
}
