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
// dense_l1 is bound by bytes: the y columns of R and P in the rows of every
// s live for some x row of the slab. On an LD block those s are the band
// around the slab's rows, each live in many rows, and far chance edges,
// each live in one to a few rows of the slab (at the 11k block a 32-row
// group's live s are held by 2 of its rows on average). A pre-pass
// (`live_lists_kernel`, a warp per x row, 16 mask bytes a lane at a time)
// reads the masks once per launch and writes each row's live s (s != x) in
// ascending order. A CTA of the sweep (`dense_l1_kernel`) owns 32
// neighbouring x rows and 128 y, a warp a row, 4 y a lane (lane + 32 k);
// the warp walks its row's list in ascending s, 32 at a time (R_xs, P_xs
// loaded a lane each, broadcast by shuffle), with the y loads of U
// consecutive s in flight together and nothing but the test in the loop.
// The 32 rows are tested together, so an s that several of them hold can
// reach all but the first from L1 (measured faster than 8 or 16 rows at a
// time), and the grid runs the x CTAs of one y segment together, so an s
// live in rows of several CTAs can come from DRAM once and from L2 for the
// others. Every s is visited in ascending order, so a strict < from the
// initial RHO_BIG keeps the smallest s on ties and lets no NaN or infinite
// test win, which is the plain version's "non-finite -> RHO_BIG, first
// minimum". Copying the s
// that several of a CTA's rows hold into shared memory first, once per CTA,
// was measured slower: with 32 rows a CTA (chunks of the rows' union, or of
// the s >= 2 rows share beside a direct pass for the rest, double-buffered
// by cp.async) a staged s serves two rows on average, too few to hide the
// copy behind; with 128 rows a CTA and 64 y (the band s, held by >= 3 of
// them, at most 192, staged; the rest read directly) it was slower still,
// its pre-pass and its sweep both, also on a band alone, where the direct
// reads of warps testing neighbouring rows together meet in L1. So the
// sweep reads every y segment straight from global memory.
//
// hetcor_dense_l1 is bound by operations, and by the instructions that
// issue them: the threshold of a test is an IEEE division, sqrtf, a
// division and tanhf, and the y side is three arrays. Its live s are few
// and shared (at the 10k input most s of an 8-row group are held by most
// of its rows), so there the chunks pay: a pre-pass
// (`group_lists_kernel`, a CTA per group of 8 x rows) writes the union of
// the group's live s and each row's bit per union entry; a CTA of the sweep
// (`hetcor_dense_l1_kernel`) owns one group and 64 y and walks the union in
// chunks of 32 s, the next chunk's R, P and N copied into shared memory by
// cp.async while the warps test the current one; a warp owns a row, 2 y a
// lane, and walks its set bits in ascending s. The time index is
// tested before any arithmetic. A test whose ESS sums (tot, cnt) equal
// those of the triple (N_xy, N_xy, N_xy) takes that triple's threshold,
// computed once per row and slot: the threshold depends on tot and cnt
// alone, so the bits are the same (a summary-statistic panel gives every
// marker pair one ESS, so this is most tests). The others go to a per-warp
// queue in shared memory and are evaluated 32 at a time, one a lane, into
// per-slot minima kept as order-preserving integer keys (sweep_common.cuh's
// margin_key: a min over finite margins does not depend on the order).
// Margins take the strict < from MARGIN_BIG over the finite values.
//
// Arithmetic: the operations of `level1_local_sweep_pre` and
// `hetcor1_local_sweep_pre` (cigwas_tpu_torch/ops/pcorr.py) on the same panel
// entries (C[x, y], C[x, s], C[s, y], and N[x, y], N[x, s], N[y, s]) in their
// order, so the dense route and the neighbour-list route give the same bits
// for the same (x, y, s), symmetric panel or not: the y side comes as column
// slabs, RT[s, y] = R[s, y0 + y] (and P, and N transposed); the ESS terms add
// (x, y) + (x, s) + (y, s); the threshold is tanhf(th / sqrtf(mean - 4)) as
// in hetcor_sweep.cu. Build with -fmad=false and without fast math. The
// plain PyTorch versions are cigwas_tpu_torch/ops/kernels/dense_l1.py
// `dense_l1_plain` and `hetcor_dense_l1_plain`.

#include "sweep_common.cuh"

#include <type_traits>

namespace {

using namespace sweep;

constexpr int WARPS = 8;  // per CTA, the hetcor sweep and the dense pre-pass
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
// dense_l1's sweep: a warp per row, y a lane, live s in flight
constexpr int D_ROWS = 32, D_THREADS = 32 * D_ROWS, D_YPL = 4;
constexpr int D_COLS = 32 * D_YPL, D_U = 2;
// hetcor_dense_l1: rows a warp holds, y a lane, union entries a chunk, the
// queue; its pre-pass's CTA and mask segments (16 bytes) a thread
constexpr int H_ROWS_PER_WARP = 1, H_ROWS = WARPS * H_ROWS_PER_WARP, H_YPL = 2;
constexpr int H_COLS = 32 * H_YPL, H_CH = 32, H_QCAP = 32 + 32 * H_YPL;
constexpr int H_SLOTS = H_ROWS_PER_WARP * H_COLS;  // a warp's (row, y) pairs
constexpr int PREP_THREADS = 1024, SEGS = 16;
constexpr long long VP_MAX = 16LL * SEGS * PREP_THREADS;

// hetcor's dynamic shared memory: two chunks of R, P, N; each warp's queue,
// slot minima (keys) and N_xy. The wrapper's `plan` computes the same.
constexpr int H_SMEM = 2 * 3 * H_CH * H_COLS * 4 + WARPS * (16 * H_QCAP + 8 * H_SLOTS);

struct Slabs {
  const float* C_x;
  const float* R_x;
  const float* P_x;
  const unsigned char* G_x;
  const float* N_x;
  const float* RT_y;
  const float* PT_y;
  const float* NT_y;
  const int* t_ix;
  long long vp;
  int nx, ny;
  long long x0, y0;
  float th;
};

// nan_to_num of a raw ESS entry and its 0/1 count (hetcor_sweep.cu's)
__device__ __forceinline__ float ess_val(float n) {
  return isnan(n) ? 0.0f : fminf(fmaxf(n, -FLT_MAX), FLT_MAX);
}
__device__ __forceinline__ float ess_cnt(float n) { return isnan(n) ? 0.0f : 1.0f; }

// Bit i of the result: byte i of x is not 0.
__device__ __forceinline__ unsigned byte_flags(unsigned x) {
  return ((x & 0xffu) != 0) | (((x >> 8) & 0xffu) != 0) << 1 | (((x >> 16) & 0xffu) != 0) << 2 |
         ((x >> 24) != 0) << 3;
}

// Live flags of the 16 mask bytes of segment `seg` of a row, bit i for s =
// 16 seg + i (one uint4 where vec, else a byte at a time up to vp), without
// the row's own x.
__device__ __forceinline__ unsigned seg_flags(const unsigned char* g, long long seg, long long vp,
                                              long long xg, bool vec) {
  const long long s0 = 16 * seg;
  unsigned bits = 0;
  if (vec) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(g + s0));
    bits = byte_flags(q.x) | byte_flags(q.y) << 4 | byte_flags(q.z) << 8 | byte_flags(q.w) << 12;
  } else {
    for (int b = 0; b < 16 && s0 + b < vp; ++b) bits |= (unsigned)(__ldg(g + s0 + b) != 0) << b;
  }
  if (xg >= s0 && xg < s0 + 16) bits &= ~(1u << (xg - s0));
  return bits;
}

__device__ __forceinline__ bool mask_vec(const Slabs& a) {
  return a.vp % 16 == 0 && (reinterpret_cast<unsigned long long>(a.G_x) & 15) == 0;
}

// --- dense_l1 -------------------------------------------------------------

// The pre-pass, a warp per x row: its live s (G_x[x, s] != 0, s != x) in
// ascending order into lst (nx, vp) and their number into n_live; each lane
// a contiguous run of 16-byte segments, counted, scanned across the warp,
// then read again (from L1) and written.
__global__ void __launch_bounds__(THREADS)
live_lists_kernel(const Slabs a, int* __restrict__ lst, int* __restrict__ n_live) {
  const int lane = threadIdx.x & 31;
  const int xi = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (xi >= a.nx) return;  // a whole warp
  const long long vp = a.vp, xg = a.x0 + xi, xoff = (long long)xi * vp;
  const unsigned char* g = a.G_x + xoff;
  const bool vec = mask_vec(a);
  const long long nseg = (vp + 15) / 16, per = (nseg + 31) / 32;
  const long long w0 = min(nseg, per * lane), w1 = min(nseg, w0 + per);
  int mine = 0;
#pragma unroll 4
  for (long long i = w0; i < w1; ++i) mine += __popc(seg_flags(g, i, vp, xg, vec));
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  int at = incl - mine;
  int* out = lst + xoff;
  for (long long i = w0; i < w1; ++i)
    for (unsigned b = seg_flags(g, i, vp, xg, vec); b; b &= b - 1)
      out[at++] = (int)(16 * i + __ffs(b) - 1);
  if (lane == 31) n_live[xi] = incl;
}

// One x row of the slab against the CTA's y segment, by one warp (FULLY:
// the segment lies wholly inside the y slab, so no lane tests a y past it).
template <bool FULLY>
__device__ __forceinline__ void rho_row(const Slabs& a, const int* __restrict__ lst,
                                        const int* __restrict__ n_live, int xi, int yb,
                                        float* __restrict__ out, int* __restrict__ s_out) {
  const int lane = threadIdx.x & 31;
  const long long xoff = (long long)xi * a.vp;
  const int ny = a.ny;
  // the lane's first y of R and P: the row of s starts s * 4 ny bytes on
  const char* rbase = reinterpret_cast<const char*>(a.RT_y + yb + lane);
  const char* pbase = reinterpret_cast<const char*>(a.PT_y + yb + lane);
  const unsigned row_bytes = 4u * (unsigned)ny;
  float cxy[D_YPL], best[D_YPL];
  int arg[D_YPL], yg[D_YPL];
  bool yok[D_YPL];
#pragma unroll
  for (int k = 0; k < D_YPL; ++k) {
    const int yl = yb + lane + 32 * k;
    yok[k] = FULLY || yl < ny;
    yg[k] = (int)(a.y0 + yl);
    cxy[k] = yok[k] ? __ldg(a.C_x + xoff + yg[k]) : 0.0f;
    best[k] = RHO_BIG;
    arg[k] = 0;
  }
  const int n = __ldg(n_live + xi);
  for (int c = 0; c < n; c += 32) {  // 32 live s of the row, ascending
    const int j = c + lane;
    const bool has = j < n;
    const int sj = has ? __ldg(lst + xoff + j) : 0;
    const float rxj = has ? __ldg(a.R_x + xoff + sj) : 0.0f;
    const float pxj = has ? __ldg(a.P_x + xoff + sj) : 0.0f;
    const int m = min(32, n - c);
    // G consecutive live s from e0: their y values loaded together, then
    // tested in ascending s
    auto group = [&](auto g, int e0) {
      constexpr int G = decltype(g)::value;
      float vr[G][D_YPL], vq[G][D_YPL];
      int se[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        se[u] = __shfl_sync(FULL, sj, e0 + u);
        const unsigned long long off = (unsigned long long)(unsigned)se[u] * row_bytes;
        const float* r = reinterpret_cast<const float*>(rbase + off);
        const float* p = reinterpret_cast<const float*>(pbase + off);
#pragma unroll
        for (int k = 0; k < D_YPL; ++k) {
          vr[u][k] = yok[k] ? __ldg(r + 32 * k) : 0.0f;
          vq[u][k] = yok[k] ? __ldg(p + 32 * k) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float Rxs = __shfl_sync(FULL, rxj, e0 + u);
        const float Pxs = __shfl_sync(FULL, pxj, e0 + u);
#pragma unroll
        for (int k = 0; k < D_YPL; ++k) {
          const float rho = fabsf(cxy[k] * (Rxs * vr[u][k]) - Pxs * vq[u][k]);
          // NaN or infinite never passes the strict <
          const bool win = yok[k] && se[u] != yg[k] && rho < best[k];
          best[k] = win ? rho : best[k];
          arg[k] = win ? se[u] : arg[k];
        }
      }
    };
    int e0 = 0;
    for (; e0 + D_U <= m; e0 += D_U) group(std::integral_constant<int, D_U>{}, e0);
    for (; e0 < m; ++e0) group(std::integral_constant<int, 1>{}, e0);
  }
#pragma unroll
  for (int k = 0; k < D_YPL; ++k) {
    if (!yok[k]) continue;
    const long long o = (long long)xi * ny + yb + lane + 32 * k;
    out[o] = best[k];
    s_out[o] = arg[k];
  }
}

__global__ void __launch_bounds__(D_THREADS, 1)
dense_l1_kernel(const Slabs a, const int* __restrict__ lst, const int* __restrict__ n_live,
                float* __restrict__ out, int* __restrict__ s_out) {
  const int xi = blockIdx.x * D_ROWS + (threadIdx.x >> 5);
  const int yb = blockIdx.y * D_COLS;
  if (xi >= a.nx) return;  // a whole warp
  if (yb + D_COLS <= a.ny)
    rho_row<true>(a, lst, n_live, xi, yb, out, s_out);
  else
    rho_row<false>(a, lst, n_live, xi, yb, out, s_out);
}

// --- hetcor_dense_l1 ------------------------------------------------------

// Exclusive prefix of v over the CTA's threads (NW warps), in thread order,
// and the total. `tot` holds a word per warp.
template <int NW>
__device__ __forceinline__ int block_exclusive_scan(int v, int* tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  int base = 0;
  total = 0;
  for (int i = 0; i < NW; ++i) {
    const int t = tot[i];
    if (i < warp) base += t;
    total += t;
  }
  return base + incl - v;
}

// The pre-pass, a CTA per group of H_ROWS x rows, each thread a contiguous
// run of (at most SEGS) 16-byte mask segments: the union of the rows' live
// s (G_x[x, s] != 0, s != x) in ascending order into ulist (groups, vp),
// its size into unum, for each row a bit per union entry it holds into bits
// (nx, (vp + 31) / 32; zeroed by the launcher).
__global__ void __launch_bounds__(PREP_THREADS)
group_lists_kernel(const Slabs a, int* __restrict__ ulist, int* __restrict__ unum,
                   unsigned* __restrict__ bits) {
  __shared__ int tot[PREP_THREADS / 32];
  const int g = blockIdx.x, tid = threadIdx.x;
  const int r0 = g * H_ROWS, nr = min(H_ROWS, a.nx - r0);
  const long long vp = a.vp, words = (vp + 31) / 32;
  const bool vec = mask_vec(a);
  const long long nseg = (vp + 15) / 16, per = (nseg + PREP_THREADS - 1) / PREP_THREADS;
  const long long seg0 = min(nseg, per * tid);
  unsigned uf[SEGS];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < SEGS; ++i) {
    uf[i] = 0;
    if (i < per && seg0 + i < nseg)
      for (int r = 0; r < nr; ++r)
        uf[i] |= seg_flags(a.G_x + (long long)(r0 + r) * vp, seg0 + i, vp, a.x0 + r0 + r, vec);
    mine += __popc(uf[i]);
  }
  int total;
  int base = block_exclusive_scan<PREP_THREADS / 32>(mine, tot, total);
  int* ul = ulist + (long long)g * vp;
#pragma unroll
  for (int i = 0; i < SEGS; ++i) {
    if (i >= per || seg0 + i >= nseg) continue;
    const long long s0 = 16 * (seg0 + i);
    for (unsigned b = uf[i]; b; b &= b - 1) {
      const int bit = __ffs(b) - 1;
      ul[base + __popc(uf[i] & ((1u << bit) - 1))] = (int)(s0 + bit);
    }
    for (int r = 0; r < nr; ++r) {
      const long long xoff = (long long)(r0 + r) * vp;
      for (unsigned b = seg_flags(a.G_x + xoff, seg0 + i, vp, a.x0 + r0 + r, vec); b;
           b &= b - 1) {
        const int bit = __ffs(b) - 1;
        const int at = base + __popc(uf[i] & ((1u << bit) - 1));
        atomicOr(bits + (r0 + r) * words + (at >> 5), 1u << (at & 31));
      }
    }
    base += __popc(uf[i]);
  }
  if (tid == 0) unum[g] = total;
}

// Evaluate queued tests Q[0 .. cnt - 1] (cnt <= 32), one a lane, in full,
// into the warp's slot minima. A test is (slot, rho, N_xs, N_ys).
__device__ __forceinline__ void evaluate(const float4* Q, int cnt, const float* nxys,
                                         unsigned* bkey, float th, int lane) {
  if (lane < cnt) {
    const float4 q = Q[lane];
    const int slot = __float_as_int(q.x);
    const float nxy = nxys[slot];
    // (x, y) + (x, s) + (y, s)
    float tot = ess_val(nxy), c = ess_cnt(nxy);
    tot = tot + ess_val(q.z);
    c = c + ess_cnt(q.z);
    tot = tot + ess_val(q.w);
    c = c + ess_cnt(q.w);
    const float m = q.y - tanhf(th / sqrtf(tot / c - 4.0f));
    if (fabsf(m) <= FLT_MAX) atomicMin(bkey + slot, margin_key(m));
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS, 4)
hetcor_dense_l1_kernel(const Slabs a, const int* __restrict__ ulist, const int* __restrict__ unum,
                       const unsigned* __restrict__ bits, float* __restrict__ out) {
  constexpr int R = H_ROWS_PER_WARP, K = H_YPL, COLS = H_COLS, CH = H_CH;
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // two chunks of (3, CH, COLS)
  char* after = reinterpret_cast<char*>(st + 2 * 3 * CH * COLS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int g = blockIdx.y, yb = blockIdx.x * COLS, ny = a.ny;
  const long long vp = a.vp, words = (vp + 31) / 32;
  const int nu = __ldg(unum + g);
  const int* ul = ulist + (long long)g * vp;
  float4* Q = reinterpret_cast<float4*>(after) + warp * H_QCAP;
  unsigned* bkey = reinterpret_cast<unsigned*>(after + WARPS * 16 * H_QCAP) + warp * H_SLOTS;
  float* nxys =
      reinterpret_cast<float*>(after + WARPS * (16 * H_QCAP + 4 * H_SLOTS)) + warp * H_SLOTS;

  // the warp's rows: the group's rows warp, warp + 8, ... (H_ROWS_PER_WARP)
  int xi[R], yg[K];
  bool rok[R], yok[K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    xi[r] = g * H_ROWS + r * WARPS + warp;
    rok[r] = xi[r] < a.nx;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    yok[k] = yb + lane + 32 * k < ny;
    yg[k] = (int)(a.y0 + yb + lane + 32 * k);
  }
  // per (row, y): the minimum, C_xy, the time index of the pair, and the
  // ESS triple (N_xy, N_xy, N_xy)'s term, sums and threshold, which every
  // test whose sums equal them shares bit for bit
  float best[R][K], cxy[R][K], tpair[R][K], exy[R][K], ecy[R][K], totc[R][K], cntc[R][K],
      Tc[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long xoff = (long long)xi[r] * vp;
    const float tx = rok[r] ? (float)__ldg(a.t_ix + a.x0 + xi[r]) : 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool ok = rok[r] && yok[k];
      const float nxy = ok ? __ldg(a.N_x + xoff + yg[k]) : 0.0f;
      best[r][k] = MARGIN_BIG;
      cxy[r][k] = ok ? __ldg(a.C_x + xoff + yg[k]) : 0.0f;
      tpair[r][k] = ok ? fmaxf(tx, (float)__ldg(a.t_ix + yg[k])) : 0.0f;
      exy[r][k] = ess_val(nxy);
      ecy[r][k] = ess_cnt(nxy);
      totc[r][k] = (exy[r][k] + exy[r][k]) + exy[r][k];
      cntc[r][k] = (ecy[r][k] + ecy[r][k]) + ecy[r][k];
      Tc[r][k] = tanhf(a.th / sqrtf(totc[r][k] / cntc[r][k] - 4.0f));
      bkey[r * COLS + lane + 32 * k] = margin_key(MARGIN_BIG);
      nxys[r * COLS + lane + 32 * k] = nxy;
    }
  }
  int qn = 0;
  __syncwarp();

  // copy the y values of chunk c (union entries c CH ..) into buffer buf
  const bool vec4 = ny % 4 == 0 && ((reinterpret_cast<unsigned long long>(a.RT_y) |
                                     reinterpret_cast<unsigned long long>(a.PT_y) |
                                     reinterpret_cast<unsigned long long>(a.NT_y)) & 15) == 0;
  auto stage = [&](int c, int buf) {
    float* dst = st + buf * 3 * CH * COLS;
    const int n = min(CH, nu - c * CH);
    const int step = vec4 ? 4 : 1;
    for (int i = tid; i < CH * COLS / step; i += THREADS) {
      const int p = i / (COLS / step), y = step * (i % (COLS / step));
      if (p < n && yb + y < ny) {
        const long long off = (long long)__ldg(ul + c * CH + p) * ny + yb + y;
        cp_async(dst + (0 * CH + p) * COLS + y, a.RT_y + off, 4 * step);
        cp_async(dst + (1 * CH + p) * COLS + y, a.PT_y + off, 4 * step);
        cp_async(dst + (2 * CH + p) * COLS + y, a.NT_y + off, 4 * step);
      }
    }
    cp_async_commit();
  };

  const int nch = (nu + CH - 1) / CH;
  if (nch > 0) stage(0, 0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sb = st + (c & 1) * 3 * CH * COLS;
    const int j = c * CH + lane;
    const int sj = j < nu ? __ldg(ul + j) : 0;
    const float tsj = j < nu ? (float)__ldg(a.t_ix + sj) : 0.0f;
    unsigned rb[R];
    float rx[R], px[R], nxs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rb[r] = rok[r] ? __ldg(bits + xi[r] * words + c) : 0u;  // the same for the warp
      const bool live = (rb[r] >> lane) & 1u;
      const long long xs = (long long)xi[r] * vp + sj;
      rx[r] = live ? __ldg(a.R_x + xs) : 0.0f;
      px[r] = live ? __ldg(a.P_x + xs) : 0.0f;
      nxs[r] = live ? __ldg(a.N_x + xs) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (unsigned b = rb[r]; b; b &= b - 1) {  // the row's s of the chunk, ascending
        const int e = __ffs(b) - 1;
        const int s = __shfl_sync(FULL, sj, e);
        const float Rxs = __shfl_sync(FULL, rx[r], e);
        const float Pxs = __shfl_sync(FULL, px[r], e);
        const float Nxs = __shfl_sync(FULL, nxs[r], e);
        const float Ts = __shfl_sync(FULL, tsj, e);
        const float exs = ess_val(Nxs), ecs = ess_cnt(Nxs);
        bool ok[K], miss[K], any = false;
        float rho[K], nys[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float ry = sb[(0 * CH + e) * COLS + lane + 32 * k];
          const float py = sb[(1 * CH + e) * COLS + lane + 32 * k];
          nys[k] = sb[(2 * CH + e) * COLS + lane + 32 * k];
          ok[k] = yok[k] && s != yg[k] && !(Ts > tpair[r][k]);  // time index first
          rho[k] = fabsf(cxy[r][k] * (Rxs * ry) - Pxs * py);
          // (x, y) + (x, s) + (y, s)
          const float tot = (exy[r][k] + exs) + ess_val(nys[k]);
          const float cnt = (ecy[r][k] + ecs) + ess_cnt(nys[k]);
          miss[k] = !(tot == totc[r][k] && cnt == cntc[r][k]);
          const float mg = rho[k] - Tc[r][k];
          const bool win = ok[k] && !miss[k] && fabsf(mg) <= FLT_MAX && mg < best[r][k];
          best[r][k] = win ? mg : best[r][k];
          any = any || (ok[k] && miss[k]);
        }
        if (__any_sync(FULL, any)) {  // queue for the full threshold
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const bool need = ok[k] && miss[k];
            const unsigned bl = __ballot_sync(FULL, need);
            if (need)
              Q[qn + __popc(bl & lt)] =
                  make_float4(__int_as_float(r * COLS + lane + 32 * k), rho[k], Nxs, nys[k]);
            qn += __popc(bl);
          }
#pragma unroll 1
          while (qn >= 32) {
            qn -= 32;
            __syncwarp();
            evaluate(Q + qn, 32, nxys, bkey, a.th, lane);
            __syncwarp();
          }
        }
      }
    }
    __syncthreads();  // the buffer is free for chunk c + 2
  }

  __syncwarp();
  if (qn > 0) evaluate(Q, qn, nxys, bkey, a.th, lane);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!rok[r] || !yok[k]) continue;
      out[(long long)xi[r] * ny + yb + lane + 32 * k] =
          fminf(best[r][k], margin_of_key(bkey[r * COLS + lane + 32 * k]));
    }
  }
}

// The slabs within the panel, and a panel the pre-passes serve.
bool slabs_ok(const Slabs& a) {
  return a.vp <= VP_MAX && a.x0 >= 0 && a.y0 >= 0 && a.x0 + a.nx <= a.vp &&
         a.y0 + a.ny <= a.vp;
}

}  // namespace

extern "C" {

// x slab: C_x, R_x, P_x (nx, vp) f32 and G_x (nx, vp) bool, rows x0 .. x0 +
// nx - 1 of C, R, P and the adjacency; y slab: RT_y, PT_y (vp, ny) f32, the
// columns y0 .. y0 + ny - 1 of R and P (RT_y[s, j] = R[s, y0 + j]); all
// contiguous on the device. Scratch from the wrapper: lst (nx, vp) and
// n_live (nx,) int32. Writes rho (nx, ny) f32 and s (nx, ny) int32: RHO_BIG
// and 0 where no s is valid. The plan (threads, x rows and y per CTA,
// shared memory) comes from the wrapper's `plan`; one that this build does
// not serve is cudaErrorInvalidValue. Two launches on the stream: the
// pre-pass and the sweep.
int dense_l1_launch(const float* C_x, const float* R_x, const float* P_x,
                    const unsigned char* G_x, const float* RT_y, const float* PT_y,
                    long long vp, int nx, int ny, long long x0, long long y0, int threads,
                    int rows_per_cta, int cols_per_cta, int smem_bytes, int* lst, int* n_live,
                    float* rho, int* s, void* stream) {
  const Slabs a{C_x, R_x, P_x, G_x, nullptr, RT_y, PT_y, nullptr, nullptr,
                vp,  nx,  ny,  x0,  y0,      0.0f};
  if (nx <= 0 || ny <= 0) return 0;
  const dim3 grid((nx + D_ROWS - 1) / D_ROWS, (ny + D_COLS - 1) / D_COLS);
  if (threads != D_THREADS || rows_per_cta != D_ROWS || cols_per_cta != D_COLS ||
      smem_bytes != 0 || !slabs_ok(a) || grid.y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  live_lists_kernel<<<(nx + WARPS - 1) / WARPS, THREADS, 0, st>>>(a, lst, n_live);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dense_l1_kernel<<<grid, D_THREADS, 0, st>>>(a, lst, n_live, rho, s);
  return (int)cudaGetLastError();
}

// The same slabs plus the raw per-pair ESS: N_x (nx, vp), the x rows of N,
// and NT_y (vp, ny), NT_y[s, j] = N[y0 + j, s]; the time index t_ix (vp,)
// int32; th the scalar |Phi^-1(alpha / 2)|. Scratch: ulist (groups, vp),
// unum (groups,) int32 and bits (nx, (vp + 31) / 32) uint32. Writes the
// margin (nx, ny) f32:
// MARGIN_BIG where no s is valid. Three launches: the bits' memset, the
// pre-pass, the sweep.
int hetcor_dense_l1_launch(const float* C_x, const float* R_x, const float* P_x,
                           const unsigned char* G_x, const float* N_x, const float* RT_y,
                           const float* PT_y, const float* NT_y, const int* t_ix, long long vp,
                           int nx, int ny, long long x0, long long y0, float th, int threads,
                           int rows_per_cta, int cols_per_cta, int smem_bytes, int* ulist,
                           int* unum, unsigned* bits, float* margin, void* stream) {
  const Slabs a{C_x, R_x, P_x, G_x, N_x, RT_y, PT_y, NT_y, t_ix, vp, nx, ny, x0, y0, th};
  if (nx <= 0 || ny <= 0) return 0;
  const int groups = (nx + H_ROWS - 1) / H_ROWS;
  const dim3 grid((ny + H_COLS - 1) / H_COLS, groups);
  if (threads != THREADS || rows_per_cta != H_ROWS || cols_per_cta != H_COLS ||
      smem_bytes != H_SMEM || !slabs_ok(a) || grid.y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bits, 0, 4 * (size_t)nx * ((vp + 31) / 32), st);
  if (err != cudaSuccess) return (int)err;
  group_lists_kernel<<<groups, PREP_THREADS, 0, st>>>(a, ulist, unum, bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(hetcor_dense_l1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  hetcor_dense_l1_kernel<<<grid, THREADS, smem_bytes, st>>>(a, ulist, unum, bits, margin);
  return (int)cudaGetLastError();
}

}  // extern "C"
