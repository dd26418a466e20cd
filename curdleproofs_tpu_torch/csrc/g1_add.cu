// g1_add: batched complete projective addition on BLS12-381 G1 (RCB16
// algorithm 7, a = 0), and one round of the masked suffix scans built on it.
//
// Replaces the TPU kernel `g1_add_pallas_flat` (curdleproofs_tpu/ops/
// pallas_kernels.py:282, launched by `_g1_add_pallas_padded` :311, body
// `_g1_add_kernel` :254 -> `_k_g1_add` :90).  The TPU wrapper pads the batch
// to its 512-lane granule; here any width launches as it is.  The second
// entry, g1_add_scan_kernel, is that kernel with its caller's gather and
// select folded in (the slot merge and the suffix over chunks of the bucket
// reduction, curdleproofs_tpu/ops/msm_device.py:506-515 and :567-579).
//
// Bound: integer multiplies.  12 field products = 7200 32-bit multiplies a
// lane against 6 x 96 bytes read and 3 x 96 written.
//
// Each entry comes in two hand-written designs; the wrapper picks one by
// width (`kernels.add_uses_group`):
// - wide launches (the 626k MSM's 1,835,520 slots, the table's multiples):
//   one thread per lane, both points and every temporary in registers,
//   coalesced loads of the [24, N] limb rows; the field core is fq_cc.cuh
//   (carry chains, one wide multiply-add a 32x32 product), as in the bucket
//   fold (g1_add_kernel, g1_add_scan_kernel).
// - narrow launches (the protocol's slot merges and chunk suffixes, 32-512
//   lanes; the reduction tail's doubling chain): there the card is nearly
//   empty and a lane's chain of 12 dependent products (~1.1 us each: a
//   product's carry chains are ordered) sets the time.  A group of ADD_G
//   lanes a point runs the add as two levels of six independent products
//   (g1_add.cuh over g1_group.cuh), exchanged by shuffles: 2 product
//   latencies a launch (g1_add_group_kernel, g1_add_scan_group_kernel).
#include <cuda_runtime.h>

#include "g1_add.cuh"

// two blocks of 128 an SM: ptxas takes 210 registers (214 in the scan entry)
// and spills nothing.  Three blocks fit 168 registers with 16 bytes of spill
// (48 in the scan entry): faster at 1,835,520 lanes, slower at 2^16.  Blocks
// of 64 or 32 threads were no faster at 512 and 32,768 lanes (PERF.md).
constexpr int ADD_THREADS = 128;
constexpr int ADD_MIN_BLOCKS = 2;
constexpr int ADD_G = 8;            // lanes a point in the group entries
constexpr int GROUP_THREADS = 128;  // 16 points a block

__global__ void __launch_bounds__(ADD_THREADS, ADD_MIN_BLOCKS)
g1_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
              const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
              const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
              uint32_t* __restrict__ oz, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (lane >= n) return;
  const cc::Proj p{cc::load16(x1, n, lane), cc::load16(y1, n, lane),
                   cc::load16(z1, n, lane)};
  const cc::Proj q{cc::load16(x2, n, lane), cc::load16(y2, n, lane),
                   cc::load16(z2, n, lane)};
  const cc::Proj r = cc::g1_add(p, q);
  cc::store16(ox, n, lane, r.x);
  cc::store16(oy, n, lane, r.y);
  cc::store16(oz, n, lane, r.z);
}

// One Hillis-Steele round over [24, n] points v, out of place:
//   out[i] = v[i] + v[i + stride]  where i + stride < n and key[i + stride]
//            == key[i],  else v[i],
// so every lane reads the previous round's points.  A warp whose lanes all
// keep their point does no arithmetic.
__global__ void __launch_bounds__(ADD_THREADS, ADD_MIN_BLOCKS)
g1_add_scan_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ z,
                   const int64_t* __restrict__ key, int64_t stride, int64_t n,
                   uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                   uint32_t* __restrict__ oz) {
  const int64_t lane = (int64_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (lane >= n) return;
  const int64_t j = lane + stride;
  cc::Proj r{cc::load16(x, n, lane), cc::load16(y, n, lane),
             cc::load16(z, n, lane)};
  if (j < n && key[j] == key[lane]) {
    const cc::Proj q{cc::load16(x, n, j), cc::load16(y, n, j),
                     cc::load16(z, n, j)};
    r = cc::g1_add(r, q);
  }
  cc::store16(ox, n, lane, r.x);
  cc::store16(oy, n, lane, r.y);
  cc::store16(oz, n, lane, r.z);
}

// The group entries: lanes ADD_G p .. ADD_G p + ADD_G - 1 run point p.  A
// group past the last point runs the last one again and stores nothing; a
// warp wholly past it returns.
__device__ __forceinline__ bool group_lane(int64_t n, int64_t& col,
                                           bool& store, int& role,
                                           uint32_t& mask) {
  const int64_t t = (int64_t)blockIdx.x * GROUP_THREADS + threadIdx.x;
  if ((t & ~(int64_t)31) / ADD_G >= n) return false;
  const int64_t pt = t / ADD_G;
  col = pt < n ? pt : n - 1;
  store = pt < n;
  role = (int)(t % ADD_G);
  mask = cc::group_mask((int)(threadIdx.x & 31), ADD_G);
  return true;
}

__global__ void __launch_bounds__(GROUP_THREADS)
g1_add_group_kernel(const uint32_t* __restrict__ x1,
                    const uint32_t* __restrict__ y1,
                    const uint32_t* __restrict__ z1,
                    const uint32_t* __restrict__ x2,
                    const uint32_t* __restrict__ y2,
                    const uint32_t* __restrict__ z2, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                    int64_t n) {
  int64_t col;
  bool store;
  int role;
  uint32_t mask;
  if (!group_lane(n, col, store, role, mask)) return;
  cc::ShuffleExchange<ADD_G> ex{role, {}, mask};
  cc::add_flat_group(ex, x1, y1, z1, x2, y2, z2, ox, oy, oz, n, col, store);
}

__global__ void __launch_bounds__(GROUP_THREADS)
g1_add_scan_group_kernel(const uint32_t* __restrict__ x,
                         const uint32_t* __restrict__ y,
                         const uint32_t* __restrict__ z,
                         const int64_t* __restrict__ key, int64_t stride,
                         int64_t n, uint32_t* __restrict__ ox,
                         uint32_t* __restrict__ oy, uint32_t* __restrict__ oz) {
  int64_t col;
  bool store;
  int role;
  uint32_t mask;
  if (!group_lane(n, col, store, role, mask)) return;
  cc::ShuffleExchange<ADD_G> ex{role, {}, mask};
  cc::add_scan_group(ex, x, y, z, key, stride, n, ox, oy, oz, col, store);
}

static unsigned blocks_for(int64_t n) {
  return (unsigned)((n + ADD_THREADS - 1) / ADD_THREADS);
}

extern "C" int cp_g1_add(const void* x1, const void* y1, const void* z1,
                         const void* x2, const void* y2, const void* z2,
                         void* ox, void* oy, void* oz, int64_t n, void* stream) {
  g1_add_kernel<<<blocks_for(n), ADD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int cp_g1_add_scan(const void* x, const void* y, const void* z,
                              const void* key, int64_t stride, int64_t n,
                              void* ox, void* oy, void* oz, void* stream) {
  g1_add_scan_kernel<<<blocks_for(n), ADD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (const int64_t*)key, stride, n, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz);
  return (int)cudaGetLastError();
}

static unsigned group_blocks_for(int64_t n) {
  return (unsigned)((n * ADD_G + GROUP_THREADS - 1) / GROUP_THREADS);
}

extern "C" int cp_g1_add_group(const void* x1, const void* y1, const void* z1,
                               const void* x2, const void* y2, const void* z2,
                               void* ox, void* oy, void* oz, int64_t n,
                               void* stream) {
  g1_add_group_kernel<<<group_blocks_for(n), GROUP_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int cp_g1_add_scan_group(const void* x, const void* y,
                                    const void* z, const void* key,
                                    int64_t stride, int64_t n, void* ox,
                                    void* oy, void* oz, void* stream) {
  g1_add_scan_group_kernel<<<group_blocks_for(n), GROUP_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (const int64_t*)key, stride, n, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz);
  return (int)cudaGetLastError();
}
