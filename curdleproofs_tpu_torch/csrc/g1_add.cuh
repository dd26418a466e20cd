// The complete add at narrow widths, as a group of lanes a point runs it
// (g1_add.cu's group entries), on the group schedule of g1_group.cuh: the
// add's twelve products as two levels of six (cc::add_group), the words of
// cc::g1_add.  Templates over the exchange, so that the host C++ harness
// (tests/test_torch_narrow.py) runs the very field operations the kernels
// run, on fq_cc.cuh's C twin.
#pragma once

#include "g1_group.cuh"

namespace cc {

// the point at column `col` of [24, n] limb rows x, y, z
CC_HD Proj load_point(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                      int64_t n, int64_t col) {
  return Proj{load16(x, n, col), load16(y, n, col), load16(z, n, col)};
}

// Store p at column `col` of [24, n] rows ox, oy, oz: the role that gets
// coordinate c stores it (a level's rounds of three; a role past the three
// stores nothing); `store` false (a group past the last point) stores
// nothing.
template <class Ex>
CC_HD void store_point_group(Ex& ex, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                             int64_t n, int64_t col, bool store,
                             const Proj& p) {
  constexpr int G = Ex::G;
#pragma unroll
  for (int j = 0; j < (3 + G - 1) / G; ++j) {
#pragma unroll 1
    for (int i = 0; i < Ex::HERE; ++i) {
      const int k = j * G + ex.role(i);
      if (store && k < 3)
        store16(k == 0 ? ox : k == 1 ? oy : oz, n, col, coord(p, k));
    }
  }
}

// out[col] = p[col] + q[col]
template <class Ex>
CC_HD void add_flat_group(Ex& ex, const uint32_t* x1, const uint32_t* y1,
                          const uint32_t* z1, const uint32_t* x2,
                          const uint32_t* y2, const uint32_t* z2,
                          uint32_t* ox, uint32_t* oy, uint32_t* oz, int64_t n,
                          int64_t col, bool store) {
  const Proj p = load_point(x1, y1, z1, n, col);
  const Proj q = load_point(x2, y2, z2, n, col);
  PointCoord qc{q};
  store_point_group(ex, ox, oy, oz, n, col, store, add_group(ex, p, qc));
}

// One round of the masked suffix scan at column `col`, out of place:
// out[col] = v[col] + v[col + stride] where col + stride < n and the keys
// agree, else v[col].  The test is the group's own: a group that keeps its
// point does no arithmetic (its lanes must exchange with each other alone).
template <class Ex>
CC_HD void add_scan_group(Ex& ex, const uint32_t* x, const uint32_t* y,
                          const uint32_t* z, const int64_t* key,
                          int64_t stride, int64_t n, uint32_t* ox,
                          uint32_t* oy, uint32_t* oz, int64_t col,
                          bool store) {
  const int64_t j = col + stride;
  Proj r = load_point(x, y, z, n, col);
  if (j < n && key[j] == key[col]) {
    const Proj q = load_point(x, y, z, n, j);
    PointCoord qc{q};
    r = add_group(ex, r, qc);
  }
  store_point_group(ex, ox, oy, oz, n, col, store, r);
}

}  // namespace cc
