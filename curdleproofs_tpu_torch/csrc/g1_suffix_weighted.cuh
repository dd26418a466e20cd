// The per-lane chain of the bucket reduction's inner step
// (g1_suffix_weighted.cu), on the carry-chain field core fq_cc.cuh.  Outside
// nvcc's device pass this compiles on the C twin of the core, so a host
// harness runs the chain the kernel runs (tests/test_torch_fq_core.py).
#pragma once

#include "fq_cc.cuh"

namespace cc {

// Lane `lane` of [24, Cb, WG] bucket rows (x, y, z; limb row stride Cb * WG,
// bucket j of the lane at column j * WG + lane): from the highest bucket
// down, suf = suf + P_j, then w = w + suf, in the order of the TPU kernel
// (`_g1_suffix_weighted_kernel`), so the sums are its projective
// representatives.  Afterwards total = sum_j P_j, weighted = sum_j (j+1) P_j.
// Each P_j is loaded just before its add: the loop carries two points.
CC_HD void suffix_weighted_lane(const uint32_t* x, const uint32_t* y,
                                const uint32_t* z, int cb, int64_t wg,
                                int64_t lane, Proj& total, Proj& weighted) {
  const int64_t stride = (int64_t)cb * wg;
  Proj suf = proj_infinity();
  Proj w = proj_infinity();
#pragma unroll 1
  for (int j = cb - 1; j >= 0; --j) {
    const int64_t col = (int64_t)j * wg + lane;
    const Proj p{load16(x, stride, col), load16(y, stride, col),
                 load16(z, stride, col)};
    suf = g1_add(suf, p);
    w = g1_add(w, suf);
  }
  total = suf;
  weighted = w;
}

}  // namespace cc
