// What local_sweep.cu and hetcor_sweep.cu share: constants, the launch plan
// their wrappers compute in Python, list and panel staging, the triangular
// (t, s) table index, and the cross-thread minimum by (value, colex rank).
//
// Routes (the Python plans in ops/kernels/{local,hetcor}_sweep.py choose one
// per launch from the level and the bucket width d, and the launchers below
// refuse a plan whose shared memory does not cover the route's layout):
//   DIRECT        level 1: no (d, d) panel in shared memory; every test reads
//                 its panel entries straight from global memory through the
//                 read-only path, several narrow nodes share one CTA;
//   TABLE         levels 2-3, one CTA per node: the panel(s), and every
//                 quantity of a (t, s) step that does not depend on y as one
//                 float4 per (t, s), are built once per node (level 2) or
//                 once per largest element u (level 3) between barriers; the
//                 (t, y) pairs are then spread over all threads;
//   ROWS_STAGED   levels 2-3 past the TABLE limit: one thread per slot y,
//   ROWS_L2       per-(u, t) rows rebuilt between two barriers; the panel in
//   ROWS_SCRATCH  shared memory, or read through L2, or (with the per-slot
//                 rows too wide for shared memory, any level) rows in global
//                 scratch.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>

namespace sweep {

constexpr float RHO_BIG = 2.0f;
constexpr float MARGIN_BIG = 3.0e38f;
constexpr int SMEM_OPT_IN = 232448;

enum Route {
  ROUTE_DIRECT = 0,
  ROUTE_TABLE = 1,
  ROUTE_ROWS_STAGED = 2,
  ROUTE_ROWS_L2 = 3,
  ROUTE_ROWS_SCRATCH = 4,
};

// The launch plan, as the wrapper's Python `plan(l, d)` returns it.
struct Plan {
  int route;
  int threads;        // per CTA, a multiple of 32
  int nodes_per_cta;  // > 1 only on ROUTE_DIRECT with d <= 128
  int ctas_per_node;  // y-blocks per node (grid.y)
  int smem_bytes;     // dynamic shared memory
};

__device__ __forceinline__ float rinv(float x) {
  // rsqrt(|1 - x*x|) of the JAX sweeps
  return 1.0f / sqrtf(fabsf(1.0f - x * x));
}

// first table entry of row t in the triangular (t, s < t) layout
__device__ __forceinline__ int tri(int t) { return (t * (t - 1)) >> 1; }

// Gather the rows a < dx of a node's local panel into shared memory, one
// warp per row with the lanes along the neighbour list: neighbours of an LD
// block are near-consecutive columns, so a warp's loads fall in few sectors.
__device__ __forceinline__ void stage_panel(float* pan, int ld,
                                            const float* __restrict__ src,
                                            long long vp, const int* nb,
                                            int dx) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int a = threadIdx.x >> 5; a < dx; a += nwarps) {
    const float* row = src + (long long)nb[a] * vp;
    for (int b = lane; b < dx; b += 32) pan[a * ld + b] = __ldg(row + nb[b]);
  }
}

// (value, colex rank) keys: rho is never negative, so its float bits order
// as an unsigned integer; the rank (u, t, s) sits below it, so an unsigned
// minimum over keys picks the least rho and, among bitwise equal rhos, the
// lowest colex rank, whichever thread arrives first. The initial key unpacks
// to (RHO_BIG, 0, 0, 0), the value of a slot that no test won.
constexpr int RANK_BITS = 10;  // TABLE widths stay below 1 << RANK_BITS
__device__ __forceinline__ unsigned long long rho_key(float rho, int u, int t, int s) {
  const unsigned rank = ((unsigned)u << (2 * RANK_BITS)) | ((unsigned)t << RANK_BITS) | (unsigned)s;
  return ((unsigned long long)__float_as_uint(rho) << 32) | rank;
}
__device__ __forceinline__ unsigned long long rho_key_init() {
  return (unsigned long long)__float_as_uint(RHO_BIG) << 32;
}

// Margins may be negative: the usual order-preserving map of float bits onto
// unsigned integers, and back.
__device__ __forceinline__ unsigned margin_key(float m) {
  const unsigned b = __float_as_uint(m);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float margin_of_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Whether the card can launch the plan at width d, given the shared memory
// its route's layout needs (negative: the route cannot run this level).
inline bool plan_fits(const Plan& p, int d, long long need) {
  return need >= 0 && need <= p.smem_bytes && p.smem_bytes <= SMEM_OPT_IN &&
         p.threads >= 32 && p.threads <= 1024 && p.threads % 32 == 0 &&
         p.ctas_per_node >= 1 &&
         (p.route == ROUTE_TABLE || (long long)p.ctas_per_node * p.threads >= d);
}

// Opt in to the plan's dynamic shared memory; returns the cudaError_t.
template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace sweep
