// g1_ladder: the batched scalar multiplications of the all-device backend
// on BLS12-381 G1, by the GLV split and signed 4-bit windows
// (g1_ladder.cuh).
//
// Replaces the JAX package's jitted ladders `batch_mul_jit`,
// `batch_mul_each_jit` and `fold_jit` (curdleproofs_tpu/ops/msm.py:73-75,
// bodies `batch_mul_kernel` :36, `batch_mul_each_kernel` :51, `fold_kernel`
// :66): there each call is one XLA program, a `lax.scan` of 255 steps of a
// doubling, a complete add and a select.  Three entries:
//   cp_g1_batch_mul       k * P_i, one scalar for all lanes
//   cp_g1_batch_mul_each  k_i * P_i, one scalar a lane
//   cp_g1_fold            L_i + k * R_i, one scalar (the add after the
//                         scalar multiplication, left first, as
//                         `fold_kernel`)
// each taking the scalars as the wrapper's GLV halves ([2, 5] words, or
// [2, 5, n]): run-time arguments of one kernel (branches uniform across a
// warp), so that its code, and nvcc's time, holds each operation of the
// chain once.
//
// Bound: integer multiplies.  The 255-step ladder was up to 5,100 products
// a point in one chain (a doubling is 8 products, an add 12), and at the
// protocol's widths (124-252 points, one or two blocks) that chain set the
// time: one warp on a scheduler issues a product in ~1.1 us.  The split
// halves the doublings (k1, k2 < 2^129: 128 a half, against 254), and the
// windows cut the adds to one a nonzero digit (at most 33 a half) and the
// table's 7; a half's chain is ~84 + 1,024 + ~31 x 12 ~ 1,480 products.
// Design: two threads a point, one a half, each with its own table in
// shared memory (P's, or phi(P)'s, one product away), joined by a warp
// shuffle of the odd thread's point and one complete add: the shortest
// chain, for the narrow launches of the protocol.  (One thread a point by
// Shamir's trick, the doublings shared, does ~35% less work a point and
// was faster from 16,384 points on an H100, but no caller sends that
// many; PERF.md records both.)  A table is 8 points (1,152 bytes) a
// thread, interleaved a column a thread so that every lane's read is
// conflict-free whichever digit it holds; the per-point entry's lanes each
// read their own halves (a coalesced word a lane; a digit is five of their
// bits), and a lane whose digit is 0 skips the add.
#include <cuda_runtime.h>

#include "g1_ladder.cuh"

constexpr int LADDER_THREADS = 32;  // a block's tables: 36,864 bytes

// uniform: one scalar ([2, 5] words) or one a lane ([2, 5, n]); lx
// non-null: the fold.  Threads 2i and 2i + 1 run point i's two halves.
__global__ void __launch_bounds__(LADDER_THREADS)
g1_ladder_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ z,
                 const uint32_t* __restrict__ halves,
                 const uint32_t* __restrict__ lx,
                 const uint32_t* __restrict__ ly,
                 const uint32_t* __restrict__ lz, uint32_t* __restrict__ ox,
                 uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                 int64_t n, bool uniform) {
  __shared__ uint32_t tabs[cc::GLV_TABLE * cc::POINT_WORDS * LADDER_THREADS];
  const int64_t t = (int64_t)blockIdx.x * LADDER_THREADS + threadIdx.x;
  const int64_t lane = t >> 1;
  // a pair past the last point computes the last point's halves (its
  // warp's shuffle needs every lane) and stores nothing
  const int64_t col = lane < n ? lane : n - 1;
  cc::Digits d1, d2;
  cc::glv_streams(uniform, halves, n, col, d1, d2);
  const int top = cc::glv_top(uniform, d1, d2);
  const cc::Table tab{tabs + threadIdx.x, LADDER_THREADS};
  const bool second = t & 1;
  cc::Proj p{cc::load16(x, n, col), cc::load16(y, n, col),
             cc::load16(z, n, col)};
  if (second) p = cc::glv_phi(p);
  cc::glv_table(tab, p);
  // this thread's half, built by value (a select of d1 or d2 by reference
  // puts both in local memory: a 48-byte stack frame)
  const cc::Digits mine{second ? d2.half : d1.half, d1.stride, d1.col};
  cc::Proj r = cc::glv_chain(tab, mine, top);
  cc::Proj b;  // the odd thread's half joins the even thread's
#pragma unroll
  for (int i = 0; i < cc::NL; ++i) {
    b.x.v[i] = __shfl_down_sync(0xffffffffu, r.x.v[i], 1);
    b.y.v[i] = __shfl_down_sync(0xffffffffu, r.y.v[i], 1);
    b.z.v[i] = __shfl_down_sync(0xffffffffu, r.z.v[i], 1);
  }
  if (second || lane >= n) return;
  r = cc::g1_add(r, b);
  if (lx != nullptr) {
    const cc::Proj l{cc::load16(lx, n, lane), cc::load16(ly, n, lane),
                     cc::load16(lz, n, lane)};
    r = cc::g1_add(l, r);
  }
  cc::store16(ox, n, lane, r.x);
  cc::store16(oy, n, lane, r.y);
  cc::store16(oz, n, lane, r.z);
}

static int launch(const void* x, const void* y, const void* z,
                  const void* halves, const void* lx, const void* ly,
                  const void* lz, void* ox, void* oy, void* oz, int64_t n,
                  bool uniform, void* stream) {
  const unsigned blocks =
      (unsigned)((2 * n + LADDER_THREADS - 1) / LADDER_THREADS);
  g1_ladder_kernel<<<blocks, LADDER_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (const uint32_t*)halves, (const uint32_t*)lx, (const uint32_t*)ly,
      (const uint32_t*)lz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n,
      uniform);
  return (int)cudaGetLastError();
}

extern "C" int cp_g1_batch_mul(const void* x, const void* y, const void* z,
                               const void* halves, void* ox, void* oy,
                               void* oz, int64_t n, void* stream) {
  return launch(x, y, z, halves, nullptr, nullptr, nullptr, ox, oy, oz, n,
                true, stream);
}

extern "C" int cp_g1_batch_mul_each(const void* x, const void* y,
                                    const void* z, const void* halves,
                                    void* ox, void* oy, void* oz, int64_t n,
                                    void* stream) {
  return launch(x, y, z, halves, nullptr, nullptr, nullptr, ox, oy, oz, n,
                false, stream);
}

extern "C" int cp_g1_fold(const void* lx, const void* ly, const void* lz,
                          const void* x, const void* y, const void* z,
                          const void* halves, void* ox, void* oy, void* oz,
                          int64_t n, void* stream) {
  return launch(x, y, z, halves, lx, ly, lz, ox, oy, oz, n, true, stream);
}
