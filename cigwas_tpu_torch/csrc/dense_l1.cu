// Dense level-1 sweeps of the two skeletons on NVIDIA Hopper (sm_90a): for
// an x-row slab against a y-column slab of a (vp, vp) correlation panel,
// every pair (x, y) is tested against every single conditioning variable s
// that is a neighbour of x (G[x, s]), s != x, s != y:
//   dense_l1:        the minimum over s of |rho_{xy|s}| and the smallest s
//                    that attains it;
//   hetcor_dense_l1: the minimum over the s allowed by the time index
//                    (t_s <= max(t_x, t_y)) of the margin
//                    |rho_{xy|s}| - tanh(th / sqrt(mean_ess({x, y, s}) - 4)),
//                    mean_ess the mean of the per-pair ESS N over the three
//                    pairs, NaN entries left out.
// |rho_{xy|s}| = |c_xy (R_xs R_sy) - P_xs P_sy| with R = 1 / sqrt(|1 - C^2|)
// and P = C R, both computed by the caller (the same PyTorch operations as
// the plain version's), so a test is five operations.
//
// Not one of the Pallas kernels: the JAX package computes this sweep with a
// plain XLA tiled loop (`cigwas_tpu/ops/pcorr.py` `_level1_dense_padded`,
// `_hetcor1_dense_padded`; the engines' `_level1_rows`, `_hetcor1_rows`,
// `_dense1_ring_body`, `_hetcor1_ring_body` in `cigwas_tpu/parallel/
// sharded.py`), which XLA fuses into the min without materialising the
// (tile, vp, vp) cube. Eager PyTorch writes that cube; this kernel does not.
//
// Layout: a warp owns one x row and YPL * 32 consecutive y (lane + 32 k). It
// walks the s axis 32 at a time: each lane loads one mask byte of its row
// (and R_xs, P_xs), a ballot gives the live s, and the warp visits them in
// ascending order, R_xs / P_xs broadcast by shuffle. The y side comes as
// column slabs, RT[s, y] = R[s, y0 + y] (and P, and N transposed), so the
// values a live s needs for the warp's y are consecutive: each lane's loads
// are coalesced with its neighbours', and the warps of a CTA, whose x rows
// are neighbours in the panel and share most of their s, meet the same rows
// in L1. What bounds it on the 11k block: the L2-to-SM traffic of those rows
// (R and P of every live s for every 128 y of every x row, ~1 KB a time),
// not the five operations of a test.
// A strict < from the initial RHO_BIG keeps the smallest s on ties and lets
// no NaN or infinite test win, which is the plain version's "non-finite ->
// RHO_BIG, first minimum". Margins take the same strict < from MARGIN_BIG
// over the finite values.
//
// Arithmetic: the operations of `level1_local_sweep_pre` and
// `hetcor1_local_sweep_pre` (cigwas_tpu_torch/ops/pcorr.py) on the same panel
// entries (C[x, y], C[x, s], C[s, y], and N[x, y], N[x, s], N[y, s]) in their
// order, so the dense route and the neighbour-list route give the same bits
// for the same (x, y, s), symmetric panel or not; the ESS terms add (x, y) +
// (x, s) + (y, s); the threshold is tanhf(th / sqrtf(mean - 4)) as in
// hetcor_sweep.cu. Build with -fmad=false and without fast math. The plain
// PyTorch versions are cigwas_tpu_torch/ops/kernels/dense_l1.py
// `dense_l1_plain` and `hetcor_dense_l1_plain`.

#include "sweep_common.cuh"

namespace {

using namespace sweep;

constexpr int TX = 8;        // x rows per CTA, one warp each
constexpr int YPL_RHO = 4;   // y per lane: dense_l1
constexpr int YPL_HET = 4;   // y per lane: hetcor_dense_l1

// nan_to_num of a raw ESS entry and its 0/1 count (hetcor_sweep.cu's)
__device__ __forceinline__ float ess_val(float n) {
  return isnan(n) ? 0.0f : fminf(fmaxf(n, -FLT_MAX), FLT_MAX);
}
__device__ __forceinline__ float ess_cnt(float n) { return isnan(n) ? 0.0f : 1.0f; }

template <bool HET, int YPL>
__global__ void __launch_bounds__(32 * TX)
dense_l1_kernel(const float* __restrict__ C_x, const float* __restrict__ R_x,
                const float* __restrict__ P_x, const unsigned char* __restrict__ G_x,
                const float* __restrict__ N_x, const float* __restrict__ RT_y,
                const float* __restrict__ PT_y, const float* __restrict__ NT_y,
                const int* __restrict__ t_ix, long long vp, int nx, int ny, long long x0,
                long long y0, float th, float* __restrict__ out, int* __restrict__ s_out) {
  const int lane = threadIdx.x & 31;
  const int xi = blockIdx.y * TX + (threadIdx.x >> 5);  // row of the x slab
  if (xi >= nx) return;                                 // a whole warp
  const long long xg = x0 + xi;                         // its variable
  const int yb = blockIdx.x * (32 * YPL);               // first y of the warp
  const long long xoff = (long long)xi * vp;

  float cxy[YPL], nxy[YPL], tpair[YPL], best[YPL];
  int arg[YPL];
  bool yok[YPL];
  const float tx = HET ? (float)__ldg(t_ix + xg) : 0.0f;
#pragma unroll
  for (int k = 0; k < YPL; ++k) {
    const int yl = yb + lane + 32 * k;
    yok[k] = yl < ny;
    cxy[k] = yok[k] ? __ldg(C_x + xoff + y0 + yl) : 0.0f;
    nxy[k] = (HET && yok[k]) ? __ldg(N_x + xoff + y0 + yl) : 0.0f;
    tpair[k] = (HET && yok[k]) ? fmaxf(tx, (float)__ldg(t_ix + y0 + yl)) : 0.0f;
    best[k] = HET ? MARGIN_BIG : RHO_BIG;
    arg[k] = 0;
  }

  for (long long s0 = 0; s0 < vp; s0 += 32) {
    const long long s = s0 + lane;
    const bool live = s < vp && s != xg && G_x[xoff + s] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (mask == 0) continue;  // the same for the whole warp
    const float rx = live ? __ldg(R_x + xoff + s) : 0.0f;
    const float px = live ? __ldg(P_x + xoff + s) : 0.0f;
    const float nxs = (HET && live) ? __ldg(N_x + xoff + s) : 0.0f;
    const float ts = (HET && live) ? (float)__ldg(t_ix + s) : 0.0f;
    for (unsigned m = mask; m; m &= m - 1) {  // live s of this x row, ascending
      const int j = __ffs(m) - 1;
      const float Rxs = __shfl_sync(0xffffffffu, rx, j);
      const float Pxs = __shfl_sync(0xffffffffu, px, j);
      const float Nxs = HET ? __shfl_sync(0xffffffffu, nxs, j) : 0.0f;
      const float Ts = HET ? __shfl_sync(0xffffffffu, ts, j) : 0.0f;
      const long long sg = s0 + j;
      const long long row = sg * ny;
#pragma unroll
      for (int k = 0; k < YPL; ++k) {
        const int yl = yb + lane + 32 * k;
        if (!yok[k] || sg == y0 + yl) continue;
        const float rho =
            fabsf(cxy[k] * (Rxs * __ldg(RT_y + row + yl)) - Pxs * __ldg(PT_y + row + yl));
        if (HET) {
          // (x, y) + (x, s) + (y, s)
          const float nys = __ldg(NT_y + row + yl);
          float tot = ess_val(nxy[k]), cnt = ess_cnt(nxy[k]);
          tot = tot + ess_val(Nxs);
          cnt = cnt + ess_cnt(Nxs);
          tot = tot + ess_val(nys);
          cnt = cnt + ess_cnt(nys);
          const float m_ = rho - tanhf(th / sqrtf(tot / cnt - 4.0f));
          if (!(Ts > tpair[k]) && fabsf(m_) <= FLT_MAX && m_ < best[k]) best[k] = m_;
        } else if (rho < best[k]) {  // NaN or infinite never passes
          best[k] = rho;
          arg[k] = (int)sg;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < YPL; ++k) {
    const int yl = yb + lane + 32 * k;
    if (!yok[k]) continue;
    out[(long long)xi * ny + yl] = best[k];
    if (!HET) s_out[(long long)xi * ny + yl] = arg[k];
  }
}

template <bool HET, int YPL>
int launch(const float* C_x, const float* R_x, const float* P_x, const unsigned char* G_x,
           const float* N_x, const float* RT_y, const float* PT_y, const float* NT_y,
           const int* t_ix, long long vp, int nx, int ny, long long x0, long long y0,
           float th, int threads, int rows_per_cta, int cols_per_cta, float* out, int* s_out,
           void* stream) {
  if (nx <= 0 || ny <= 0) return 0;
  // the plan must be the one this build was compiled for
  if (threads != 32 * TX || rows_per_cta != TX || cols_per_cta != 32 * YPL ||
      x0 < 0 || y0 < 0 || x0 + nx > vp || y0 + ny > vp)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ny + 32 * YPL - 1) / (32 * YPL), (nx + TX - 1) / TX);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dense_l1_kernel<HET, YPL><<<grid, 32 * TX, 0, static_cast<cudaStream_t>(stream)>>>(
      C_x, R_x, P_x, G_x, N_x, RT_y, PT_y, NT_y, t_ix, vp, nx, ny, x0, y0, th, out, s_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x slab: C_x, R_x, P_x (nx, vp) f32 and G_x (nx, vp) bool, rows x0 .. x0 +
// nx - 1 of C, R, P and the adjacency; y slab: RT_y, PT_y (vp, ny) f32, the
// columns y0 .. y0 + ny - 1 of R and P (RT_y[s, j] = R[s, y0 + j]); all
// contiguous on the device. Writes rho (nx, ny) f32 and s (nx, ny) int32:
// RHO_BIG and 0 where no s is valid. The plan (threads, x rows and y per
// CTA) comes from the wrapper's `plan`; one that this build does not serve
// is cudaErrorInvalidValue.
int dense_l1_launch(const float* C_x, const float* R_x, const float* P_x,
                    const unsigned char* G_x, const float* RT_y, const float* PT_y,
                    long long vp, int nx, int ny, long long x0, long long y0, int threads,
                    int rows_per_cta, int cols_per_cta, float* rho, int* s, void* stream) {
  return launch<false, YPL_RHO>(C_x, R_x, P_x, G_x, nullptr, RT_y, PT_y, nullptr, nullptr, vp,
                                nx, ny, x0, y0, 0.0f, threads, rows_per_cta, cols_per_cta, rho,
                                s, stream);
}

// The same slabs plus the raw per-pair ESS: N_x (nx, vp), the x rows of N,
// and NT_y (vp, ny), NT_y[s, j] = N[y0 + j, s]; the time index t_ix (vp,)
// int32; th the scalar |Phi^-1(alpha / 2)|. Writes the margin (nx, ny) f32:
// MARGIN_BIG where no s is valid.
int hetcor_dense_l1_launch(const float* C_x, const float* R_x, const float* P_x,
                           const unsigned char* G_x, const float* N_x, const float* RT_y,
                           const float* PT_y, const float* NT_y, const int* t_ix, long long vp,
                           int nx, int ny, long long x0, long long y0, float th, int threads,
                           int rows_per_cta, int cols_per_cta, float* margin, void* stream) {
  return launch<true, YPL_HET>(C_x, R_x, P_x, G_x, N_x, RT_y, PT_y, NT_y, t_ix, vp, nx, ny, x0,
                               y0, th, threads, rows_per_cta, cols_per_cta, margin, nullptr,
                               stream);
}

}  // extern "C"
