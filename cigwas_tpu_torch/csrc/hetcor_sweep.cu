// Hetcor levels 1-3 of the summary-statistic skeleton on NVIDIA Hopper
// (sm_90a): for each node x with ascending neighbour list nbrs[x] and degree
// deg[x], gather the local panels of the correlations C and of the per-pair
// effective sample sizes N (Cb = C[nbrs, nbrs], qb = C[x, nbrs], Nb, nr
// likewise) and return for every neighbour slot y the minimum margin
//     |pcorr(x, y | S)| - tanh(th / sqrt(mean_ess({x, y} u S) - l - 3))
// over the conditioning sets S of size l (1, 2 or 3) drawn from x's other
// neighbours whose time index does not exceed max(t_x, t_y). mean_ess is the
// mean of N over all variable pairs of the test, NaN entries left out. The
// edge x - y goes where the margin is negative.
//
// Replaces the TPU kernel cigwas_tpu/ops/pallas/panel_gather.py
// `_rowgather2_kernel` (via `_rowgather2_core`) together with the XLA
// consumers it feeds in one dispatch (`hetcor{1,2,3}_local_sweep_pre`): that
// kernel gathers both panels by row DMA and one-hot matmuls with a parallel
// NaN-count product; here the indexed loads are exact, the NaN count is
// isnan() of the staged raw N, and the panels never reach device memory.
//
// What bounds it: operations. Every test is the recursion of
// local_sweep.cu (a dozen f32 operations, one sqrt, one division) plus the
// ESS mean (up to ten adds and ten counts), a division, a sqrt, a division
// and a tanh. The design is local_sweep.cu's: one CTA per (node, block of y
// slots), one thread per slot y; both (d, d) panels staged in shared memory
// with row stride d + 1 while they fit the 232,448-byte opt-in limit
// (d <= 166), read through the L2 cache above that; the quantities of a
// (u, t) step that do not depend on y computed once per CTA into shared
// rows. Tests whose rho is invalid or whose conditioning set is later in
// time skip the threshold arithmetic.
//
// Arithmetic mirrors the JAX sweeps op for op and in their association order
// (`pcorr._hetcor1_local_core`, `_hetcor_pair_margin`, `_hetcor3_local_core`):
// level 1 uses the pre-scaled form |q (Rq Rc) - Pq Pc|, levels 2-3 the
// recursion; the ESS terms add left to right in the JAX order; every rsqrt
// is 1.0f / sqrtf(x). Build with -fmad=false and without fast math. The plain
// PyTorch version is cigwas_tpu_torch/ops/pcorr.py `hetcor_local_sweep_plain`.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr float RHO_BIG = 2.0f;
constexpr float MARGIN_BIG = 3.0e38f;
constexpr int SMEM_OPT_IN = 232448;
// per-slot rows: neighbour index, q, raw N[x, .], time index, and up to 9
// aux rows (level 3)
constexpr int WORK_ROWS = 13;

__device__ __forceinline__ float rinv(float x) {
  // rsqrt(|1 - x*x|) of the JAX sweeps
  return 1.0f / sqrtf(fabsf(1.0f - x * x));
}

// nan_to_num of a raw ESS entry and its 0/1 count
__device__ __forceinline__ float ess_val(float n) {
  return isnan(n) ? 0.0f : fminf(fmaxf(n, -FLT_MAX), FLT_MAX);
}
__device__ __forceinline__ float ess_cnt(float n) { return isnan(n) ? 0.0f : 1.0f; }
__device__ __forceinline__ void ess_add(float n, float& tot, float& cnt) {
  tot = tot + ess_val(n);
  cnt = cnt + ess_cnt(n);
}

template <int L>
__device__ __forceinline__ float ess_threshold(float th, float tot, float cnt) {
  const float mean = tot / cnt;
  if (L == 1) return tanhf(th / sqrtf(mean - 4.0f));
  return tanhf(th / sqrtf((mean - (float)L) - 3.0f));
}

template <bool STAGED>
struct Panels {
  const float* pc;  // shared (d, d + 1) panels when STAGED
  const float* pn;
  int ld;
  const float* C;  // global (vp, vp) panels otherwise
  const float* N;
  long long vp;
  const int* nb;
  __device__ __forceinline__ float c(int a, int b) const {
    if (STAGED) return pc[a * ld + b];
    return __ldg(C + (long long)nb[a] * vp + nb[b]);
  }
  __device__ __forceinline__ float n(int a, int b) const {
    if (STAGED) return pn[a * ld + b];
    return __ldg(N + (long long)nb[a] * vp + nb[b]);
  }
};

// per-node rows shared by the three sweeps
struct Rows {
  const float* q;    // C[x, nb]
  const float* nrw;  // raw N[x, nb]
  const float* tn;   // time index of nb, as float
  float t_x;
  float th;
};

template <bool STAGED>
__device__ void hsweep1(const Panels<STAGED>& P, const Rows& R, float* aux,
                        int d, int dx, int y, bool live, float& best) {
  float* Rq = aux;
  float* Pq = aux + d;
  for (int s = threadIdx.x; s < dx; s += blockDim.x) {
    const float r = rinv(R.q[s]);
    Rq[s] = r;
    Pq[s] = R.q[s] * r;
  }
  __syncthreads();
  if (!live) return;
  const float qy = R.q[y];
  const float nxy = R.nrw[y];
  const float t_pair = fmaxf(R.t_x, R.tn[y]);
  for (int s = 0; s < dx; ++s) {
    if (s == y || R.tn[s] > t_pair) continue;
    const float c = P.c(s, y);
    const float rc = rinv(c);
    const float rho = fabsf(qy * (Rq[s] * rc) - Pq[s] * (c * rc));
    // (x, y) + (x, s) + (y, s)
    float tot = ess_val(nxy), cnt = ess_cnt(nxy);
    ess_add(R.nrw[s], tot, cnt);
    ess_add(P.n(y, s), tot, cnt);
    const float m = rho - ess_threshold<1>(R.th, tot, cnt);
    // a NaN or infinite margin never counts
    if (fabsf(m) <= FLT_MAX && m < best) best = m;
  }
}

template <bool STAGED>
__device__ void hsweep2(const Panels<STAGED>& P, const Rows& R, float* aux,
                        int d, int dx, int y, bool live, float& best) {
  float* rowC = aux;
  float* rowR = aux + d;
  float* rowQ2 = aux + 2 * d;
  float* rowRQ2 = aux + 3 * d;
  float* rowN = aux + 4 * d;  // raw N[t, s]
  const float nxy = live ? R.nrw[y] : 0.0f;
  const float t_pair = live ? fmaxf(R.t_x, R.tn[y]) : 0.0f;
  for (int t = 1; t < dx; ++t) {
    const float qt = R.q[t];
    const float rqt = rinv(qt);
    __syncthreads();
    for (int s = threadIdx.x; s < t; s += blockDim.x) {
      const float c = P.c(t, s);
      const float r = rinv(c);
      const float q2 = (R.q[s] - qt * c) * (rqt * r);  // pcorr(x, s | t)
      rowC[s] = c;
      rowR[s] = r;
      rowQ2[s] = q2;
      rowRQ2[s] = rinv(q2);
      rowN[s] = P.n(t, s);
    }
    __syncthreads();
    if (!live || y == t) continue;
    const float cty = P.c(t, y);
    const float rty = rinv(cty);
    const float q2ty = (R.q[y] - qt * cty) * (rqt * rty);  // pcorr(x, y | t)
    const float nxt = R.nrw[t];
    const float nyt = P.n(y, t);
    const float tnt = R.tn[t];
    for (int s = 0; s < t; ++s) {
      if (s == y) continue;
      const float T2 = (P.c(y, s) - cty * rowC[s]) * (rty * rowR[s]);
      const float rho = fabsf(q2ty - rowQ2[s] * T2) * (rowRQ2[s] * rinv(T2));
      if (!(rho < RHO_BIG)) continue;  // NaN, infinite or out of range
      if (fmaxf(fmaxf(R.tn[s], tnt), -1.0f) > t_pair) continue;
      // (x,y) + (x,s) + (x,t) + (y,s) + (y,t) + (t,s); the empty base adds 0
      float tot = ess_val(nxy), cnt = ess_cnt(nxy);
      ess_add(R.nrw[s], tot, cnt);
      ess_add(nxt, tot, cnt);
      ess_add(P.n(y, s), tot, cnt);
      ess_add(nyt, tot, cnt);
      ess_add(rowN[s], tot, cnt);
      const float th_test = ess_threshold<2>(R.th, tot, cnt);
      if (!(fabsf(th_test) <= FLT_MAX)) continue;
      const float m = rho - th_test;
      if (m < best) best = m;
    }
  }
}

template <bool STAGED>
__device__ void hsweep3(const Panels<STAGED>& P, const Rows& R, float* aux,
                        int d, int dx, int y, bool live, float& best) {
  float* CU = aux;
  float* RU = aux + d;
  float* Q1 = aux + 2 * d;
  float* NU = aux + 3 * d;  // raw N[a, u]
  float* rowT = aux + 4 * d;
  float* rowR = aux + 5 * d;
  float* rowQ2 = aux + 6 * d;
  float* rowRQ2 = aux + 7 * d;
  float* rowN = aux + 8 * d;  // raw N[t, s]
  const float nxy = live ? R.nrw[y] : 0.0f;
  const float t_pair = live ? fmaxf(R.t_x, R.tn[y]) : 0.0f;
  for (int u = 2; u < dx; ++u) {
    const float qu = R.q[u];
    const float rqu = rinv(qu);
    __syncthreads();
    // condition the panel on u: T1[a][b] = (Cb[a][b] - cu[a] cu[b]) Ru[a] Ru[b]
    for (int a = threadIdx.x; a < dx; a += blockDim.x) {
      const float c = P.c(u, a);
      const float r = rinv(c);
      CU[a] = c;
      RU[a] = r;
      Q1[a] = (R.q[a] - qu * c) * (rqu * r);  // pcorr(x, a | u)
      NU[a] = P.n(a, u);
    }
    __syncthreads();
    const bool yok = live && y != u;
    const float cuy = yok ? CU[y] : 0.0f;
    const float ruy = yok ? RU[y] : 0.0f;
    const float q1y = yok ? Q1[y] : 0.0f;
    const float nyu = yok ? NU[y] : 0.0f;
    const float nxu = R.nrw[u];
    const float t_base = R.tn[u];
    for (int t = 1; t < u; ++t) {
      const float cut = CU[t];
      const float rut = RU[t];
      const float q1t = Q1[t];
      const float rq1t = rinv(q1t);
      __syncthreads();
      for (int s = threadIdx.x; s < t; s += blockDim.x) {
        const float T = (P.c(t, s) - cut * CU[s]) * (rut * RU[s]);
        const float r = rinv(T);
        const float q2 = (Q1[s] - q1t * T) * (rq1t * r);
        rowT[s] = T;
        rowR[s] = r;
        rowQ2[s] = q2;
        rowRQ2[s] = rinv(q2);
        rowN[s] = P.n(t, s);
      }
      __syncthreads();
      if (!yok || y == t) continue;
      const float tty = (P.c(t, y) - cut * cuy) * (rut * ruy);
      const float rty = rinv(tty);
      const float q2ty = (q1y - q1t * tty) * (rq1t * rty);
      const float nxt = R.nrw[t];
      const float nyt = P.n(y, t);
      const float ntu = NU[t];
      const float tnt = R.tn[t];
      for (int s = 0; s < t; ++s) {
        if (s == y) continue;
        const float tys = (P.c(y, s) - cuy * CU[s]) * (ruy * RU[s]);
        const float T2 = (tys - tty * rowT[s]) * (rty * rowR[s]);
        const float rho = fabsf(q2ty - rowQ2[s] * T2) * (rowRQ2[s] * rinv(T2));
        if (!(rho < RHO_BIG)) continue;
        if (fmaxf(fmaxf(R.tn[s], tnt), t_base) > t_pair) continue;
        // (x,y) + (x,s) + (x,t) + (y,s) + (y,t) + (t,s), then the base
        // element's (x,u) + (y,u) + (s,u) + (t,u)
        float tot = ess_val(nxy), cnt = ess_cnt(nxy);
        ess_add(R.nrw[s], tot, cnt);
        ess_add(nxt, tot, cnt);
        ess_add(P.n(y, s), tot, cnt);
        ess_add(nyt, tot, cnt);
        ess_add(rowN[s], tot, cnt);
        ess_add(nxu, tot, cnt);
        ess_add(nyu, tot, cnt);
        ess_add(NU[s], tot, cnt);
        ess_add(ntu, tot, cnt);
        const float th_test = ess_threshold<3>(R.th, tot, cnt);
        if (!(fabsf(th_test) <= FLT_MAX)) continue;
        const float m = rho - th_test;
        if (m < best) best = m;
      }
    }
  }
}

// STAGED: both panels in shared memory. WORK_GLOBAL: the per-slot rows live
// in the caller's global scratch (only for widths whose rows alone overflow
// shared memory, d > 4470).
template <int L, bool STAGED, bool WORK_GLOBAL>
__global__ void hetcor_sweep_kernel(const float* __restrict__ C,
                                    const float* __restrict__ N,
                                    const int* __restrict__ t_ix, long long vp,
                                    const int* __restrict__ node_ixs,
                                    const int* __restrict__ nbrs,
                                    const int* __restrict__ deg, int d,
                                    float th, float* __restrict__ scratch,
                                    float* __restrict__ margin_out) {
  extern __shared__ float smem[];
  const long long node = blockIdx.x;
  const int y = blockIdx.y * blockDim.x + threadIdx.x;
  const int dx = min(max(deg[node], 0), d);
  float* work = smem;
  if (WORK_GLOBAL) {
    work = scratch + (node * gridDim.y + blockIdx.y) * (long long)WORK_ROWS * d;
  }
  int* nb = reinterpret_cast<int*>(work);
  float* q = work + d;
  float* nrw = work + 2 * d;
  float* tn = work + 3 * d;
  float* aux = work + 4 * d;
  float* pc = work + WORK_ROWS * d;
  float* pn = pc + d * (d + 1);

  float best = MARGIN_BIG;
  // CTA-uniform: pad-only blocks skip straight to the MARGIN_BIG write
  if ((int)(blockIdx.y * blockDim.x) < dx) {
    const int* row_nbrs = nbrs + node * d;
    for (int a = threadIdx.x; a < dx; a += blockDim.x) nb[a] = row_nbrs[a];
    __syncthreads();
    const int x = node_ixs[node];
    const long long xrow = (long long)x * vp;
    for (int a = threadIdx.x; a < dx; a += blockDim.x) {
      q[a] = __ldg(C + xrow + nb[a]);
      nrw[a] = __ldg(N + xrow + nb[a]);
      tn[a] = (float)__ldg(t_ix + nb[a]);
    }
    if (STAGED) {
      for (int i = threadIdx.x; i < dx * dx; i += blockDim.x) {
        const int a = i / dx;
        const int b = i - a * dx;
        const long long off = (long long)nb[a] * vp + nb[b];
        pc[a * (d + 1) + b] = __ldg(C + off);
        pn[a * (d + 1) + b] = __ldg(N + off);
      }
    }
    __syncthreads();
    const Panels<STAGED> P{pc, pn, d + 1, C, N, vp, nb};
    const Rows R{q, nrw, tn, (float)__ldg(t_ix + x), th};
    const bool live = y < dx;
    if (L == 1) hsweep1(P, R, aux, d, dx, y, live, best);
    if (L == 2) hsweep2(P, R, aux, d, dx, y, live, best);
    if (L == 3) hsweep3(P, R, aux, d, dx, y, live, best);
  }
  if (y < d) margin_out[node * d + y] = best;
}

template <int L, bool STAGED, bool WORK_GLOBAL>
int launch(const float* C, const float* N, const int* t_ix, long long vp,
           const int* node_ixs, const int* nbrs, const int* deg, int nt, int d,
           float th, float* scratch, float* margin, int threads, int nyb,
           size_t smem, cudaStream_t stream) {
  auto kernel = hetcor_sweep_kernel<L, STAGED, WORK_GLOBAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)nt, (unsigned)nyb), threads, smem, stream>>>(
      C, N, t_ix, vp, node_ixs, nbrs, deg, d, th, scratch, margin);
  return (int)cudaGetLastError();
}

template <int L>
int launch_level(const float* C, const float* N, const int* t_ix, long long vp,
                 const int* node_ixs, const int* nbrs, const int* deg, int nt,
                 int d, float th, float* scratch, float* margin, int threads,
                 int nyb, cudaStream_t stream) {
  const size_t work = (size_t)WORK_ROWS * d * sizeof(float);
  const size_t staged = work + 2 * (size_t)d * (d + 1) * sizeof(float);
  if (staged <= SMEM_OPT_IN)
    return launch<L, true, false>(C, N, t_ix, vp, node_ixs, nbrs, deg, nt, d,
                                  th, scratch, margin, threads, nyb, staged,
                                  stream);
  if (work <= SMEM_OPT_IN)
    return launch<L, false, false>(C, N, t_ix, vp, node_ixs, nbrs, deg, nt, d,
                                   th, scratch, margin, threads, nyb, work,
                                   stream);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  return launch<L, false, true>(C, N, t_ix, vp, node_ixs, nbrs, deg, nt, d, th,
                                scratch, margin, threads, nyb, 0, stream);
}

}  // namespace

extern "C" {

// Threads per CTA and CTAs per node for width d: at most 128 slots a CTA,
// split evenly and rounded up to whole warps.
void hetcor_sweep_geometry(int d, int* threads, int* nyb) {
  const int n = (d + 127) / 128;
  const int per = (d + n - 1) / n;
  *nyb = n;
  *threads = ((per + 31) / 32) * 32;
}

// Floats of global scratch a launch needs (0 unless d > 4470).
long long hetcor_sweep_scratch_floats(int nt, int d) {
  if ((size_t)WORK_ROWS * d * sizeof(float) <= SMEM_OPT_IN) return 0;
  int threads, nyb;
  hetcor_sweep_geometry(d, &threads, &nyb);
  return (long long)nt * nyb * WORK_ROWS * d;
}

// C, N (vp, vp) f32; t_ix (vp,), node_ixs (nt,), nbrs (nt, d), deg (nt,)
// int32, all contiguous on the device. Writes margin (nt, d) f32; pad slots
// y >= deg and slots with no valid test get 3.0e38. Returns the cudaError_t
// of the launch.
int hetcor_sweep_launch(const float* C, const float* N, const int* t_ix,
                        long long vp, const int* node_ixs, const int* nbrs,
                        const int* deg, int nt, int d, int l, float th,
                        float* scratch, float* margin, void* stream) {
  if (nt <= 0 || d <= 0) return 0;
  int threads, nyb;
  hetcor_sweep_geometry(d, &threads, &nyb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (l) {
    case 1:
      return launch_level<1>(C, N, t_ix, vp, node_ixs, nbrs, deg, nt, d, th,
                             scratch, margin, threads, nyb, st);
    case 2:
      return launch_level<2>(C, N, t_ix, vp, node_ixs, nbrs, deg, nt, d, th,
                             scratch, margin, threads, nyb, st);
    case 3:
      return launch_level<3>(C, N, t_ix, vp, node_ixs, nbrs, deg, nt, d, th,
                             scratch, margin, threads, nyb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
