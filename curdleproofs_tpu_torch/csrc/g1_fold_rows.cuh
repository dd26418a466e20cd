// The lane loop of g1_fold_rows.cu, CC_HD so that tests/test_torch_fq_core.py
// runs it on the C twin of fq_cc.cuh.
#pragma once

#include "fq_cc.cuh"

namespace cc {

// column `lane` of [24, T, S] rows x, y, z: from infinity, the complete add
// of every row t = 0..T-1 in order, z = 0 rows too
CC_HD Proj fold_rows_lane(const uint32_t* x, const uint32_t* y,
                          const uint32_t* z, int t_rows, int64_t s,
                          int64_t lane) {
  const int64_t stride = (int64_t)t_rows * s;  // between limb rows
  Proj acc = proj_infinity();
  for (int t = 0; t < t_rows; ++t) {
    const int64_t off = (int64_t)t * s;
    acc = g1_add(acc, Proj{load16(x + off, stride, lane),
                           load16(y + off, stride, lane),
                           load16(z + off, stride, lane)});
  }
  return acc;
}

}  // namespace cc
