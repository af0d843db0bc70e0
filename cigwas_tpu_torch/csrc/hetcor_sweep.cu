// Hetcor levels 1-3 of the summary-statistic skeleton on NVIDIA Hopper
// (sm_90a): for each node x with ascending neighbour list nbrs[x] and degree
// deg[x], take the local panels of the correlations C and of the per-pair
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
// isnan() of the raw N, and the panels never reach device memory.
//
// What bounds it: instruction issue. Every test is the recursion of
// local_sweep.cu (a dozen f32 operations, one sqrt, one division) plus the
// ESS mean (up to ten adds and ten counts), a division, a sqrt, a division
// and a tanh, all IEEE: about a hundred instructions and long dependent
// chains, so the card needs many resident warps with every lane on a test.
// The routes are local_sweep.cu's (sweep_common.cuh):
//  * level 1 (ROUTE_DIRECT) stages no (d, d) panel. A test reads C[s, y] and
//    N[y, s], each once. With the lanes along y the first is one panel row
//    (few sectors) but the second is 32 rows; N is not assumed symmetric.
//    So a warp takes 32 slots y times 32 sets s at a time: it loads the
//    32 x 32 tile of N with the lanes along s into its own 4 KB of shared
//    memory, then tests with the lanes along y, reading the tile transposed
//    (row stride 33). Shared memory is five rows per node plus the warps'
//    tiles, about 20 KB a CTA of four warps, so an SM holds 11 CTAs where
//    the staged panels allowed one;
//  * levels 2-3 (ROUTE_TABLE, one CTA per node, d <= 119 / 106): both
//    panels staged once, the y-free values of every (t, s) as one float4
//    built before one barrier (per node, or per largest element u), the
//    (t, y) pairs dealt to all threads, N(t, s) read from the staged panel;
//    threads meet per y in a shared minimum over order-preserving keys;
//  * wider buckets (ROUTE_ROWS_*): one thread per slot y, per-(u, t) rows
//    between two barriers; both panels in shared memory (d <= 166), read
//    through L2 above, per-slot rows in global scratch past d = 4470.
// Tests whose rho is invalid or whose conditioning set is later in time skip
// the threshold arithmetic (at level 1 they are computed and discarded, so
// that a warp's loads stay unconditional).
//
// Arithmetic mirrors the JAX sweeps op for op and in their association order
// (`pcorr._hetcor1_local_core`, `_hetcor_pair_margin`, `_hetcor3_local_core`):
// level 1 uses the pre-scaled form |q (Rq Rc) - Pq Pc|, levels 2-3 the
// recursion; the ESS terms add left to right in the JAX order; every rsqrt
// is 1.0f / sqrtf(x). Build with -fmad=false and without fast math. The plain
// PyTorch version is cigwas_tpu_torch/ops/pcorr.py `hetcor_local_sweep_plain`.

#include "sweep_common.cuh"

namespace {

using namespace sweep;

// per-slot rows of the ROWS routes: neighbour index, q, raw N[x, .], time
// index, and up to 9 aux rows (level 3)
constexpr int WORK_ROWS = 13;
// per-node rows of ROUTE_DIRECT: list, Rq, Pq, raw N[x, .], time index
constexpr int DIRECT_ROWS = 5;
constexpr int TILE = 32 * 33;  // floats of a warp's transposing tile
__host__ __device__ constexpr int table_rows(int l) { return l == 2 ? 6 : 11; }

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

// One test of levels 2-3 against the running minimum of its slot: rho must
// be valid and the set allowed by the time index before any threshold
// arithmetic is spent. The ESS terms add left to right in the JAX order:
// (x,y) + (x,s) + (x,t) + (y,s) + (y,t) + (t,s), then at level 3 the base
// element's (x,u) + (y,u) + (s,u) + (t,u); the empty base of level 2 adds 0.
struct PairEss {
  float nxy, nxt, nyt;       // raw N of the pairs that do not hold s
  float nxu, nyu, ntu;       // level 3 only
  float t_rest, t_pair;      // max time index of {t, u} (-1 for none); of {x, y}
};
template <int L>
__device__ __forceinline__ void offer_margin(float rho, float th, const PairEss& e, float tns,
                                             float nxs, float nys, float nts, float nsu,
                                             float& best) {
  if (!(rho < RHO_BIG)) return;  // NaN, infinite or out of range
  if (fmaxf(tns, e.t_rest) > e.t_pair) return;
  float tot = ess_val(e.nxy), cnt = ess_cnt(e.nxy);
  ess_add(nxs, tot, cnt);
  ess_add(e.nxt, tot, cnt);
  ess_add(nys, tot, cnt);
  ess_add(e.nyt, tot, cnt);
  ess_add(nts, tot, cnt);
  if (L == 3) {
    ess_add(e.nxu, tot, cnt);
    ess_add(e.nyu, tot, cnt);
    ess_add(nsu, tot, cnt);
    ess_add(e.ntu, tot, cnt);
  }
  const float th_test = ess_threshold<L>(th, tot, cnt);
  if (!(fabsf(th_test) <= FLT_MAX)) return;
  const float m = rho - th_test;
  if (m < best) best = m;
}

// ---- ROUTE_DIRECT: level 1 ------------------------------------------------

__global__ void hsweep1_direct_kernel(const float* __restrict__ C,
                                      const float* __restrict__ N,
                                      const int* __restrict__ t_ix, long long vp,
                                      const int* __restrict__ node_ixs,
                                      const int* __restrict__ nbrs,
                                      const int* __restrict__ deg, int nt, int d,
                                      int npc, float th,
                                      float* __restrict__ margin_out) {
  extern __shared__ float smem[];
  // thread -> (node g of this CTA, slot y): narrow nodes share the CTA, a
  // wide node spreads over gridDim.y CTAs
  const int ypc = gridDim.y == 1 ? d : (int)blockDim.x;
  const int g = threadIdx.x / ypc;
  const int y = blockIdx.y * blockDim.x + (threadIdx.x - g * ypc);
  const long long node0 = (long long)blockIdx.x * npc;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < npc * d; i += blockDim.x) {
    const int g2 = i / d;
    const int a = i - g2 * d;
    const long long node2 = node0 + g2;
    if (node2 >= nt || a >= min(max(deg[node2], 0), d)) continue;
    float* rows = smem + g2 * DIRECT_ROWS * d;
    const int v = nbrs[node2 * d + a];
    const long long off = (long long)node_ixs[node2] * vp + v;
    const float qv = __ldg(C + off);
    const float r = rinv(qv);
    reinterpret_cast<int*>(rows)[a] = v;
    rows[d + a] = r;
    rows[2 * d + a] = qv * r;
    rows[3 * d + a] = __ldg(N + off);
    rows[4 * d + a] = (float)__ldg(t_ix + v);
  }
  __syncthreads();

  const long long node = node0 + g;
  const bool mine = g < npc && node < nt && y < d;
  const int dx = mine ? min(max(deg[node], 0), d) : 0;
  const bool live = y < dx;
  const int rbase = mine ? g * DIRECT_ROWS * d : 0;
  const float* rows = smem + rbase;
  const int* nb = reinterpret_cast<const int*>(rows);
  const float* Rq = rows + d;
  const float* Pq = rows + 2 * d;
  const float* nrw = rows + 3 * d;
  const float* tn = rows + 4 * d;
  float* tile = smem + npc * DIRECT_ROWS * d + (threadIdx.x >> 5) * TILE;

  // what the other lanes need of this lane to load its row of the N tile
  const int my_dx = live ? dx : 0;
  const long long my_row = live ? (long long)nb[y] * vp : 0;
  float qy = 0.0f, nxy_v = 0.0f, nxy_c = 0.0f, t_pair = 0.0f;
  const float* col = C;
  if (live) {
    const int x = node_ixs[node];
    const long long off = (long long)x * vp + nb[y];
    qy = __ldg(C + off);
    const float nxy = nrw[y];
    nxy_v = ess_val(nxy);
    nxy_c = ess_cnt(nxy);
    t_pair = fmaxf((float)__ldg(t_ix + x), tn[y]);
    col = C + nb[y];
  }
  float best = MARGIN_BIG;
  const int s_max = __reduce_max_sync(0xffffffffu, my_dx);
  for (int s0 = 0; s0 < s_max; s0 += 32) {
    // N[y_i, s0 + lane] for the warp's 32 slots y_i: lanes along s
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const long long row_i = __shfl_sync(0xffffffffu, my_row, i);
      const int rbase_i = __shfl_sync(0xffffffffu, rbase, i);
      const int dx_i = __shfl_sync(0xffffffffu, my_dx, i);
      if (s0 + lane < dx_i)
        tile[i * 33 + lane] =
            __ldg(N + row_i + reinterpret_cast<const int*>(smem + rbase_i)[s0 + lane]);
    }
    __syncwarp();
    const int n_s = min(32, my_dx - s0);  // <= 0 for lanes that are done
#pragma unroll 4
    for (int j = 0; j < n_s; ++j) {
      const int s = s0 + j;
      // the diagonal entry C[y, y] = 1 of the discarded test s == y would
      // send the whole warp down the slow path of 1 / sqrt(0): replace it
      const float c = s == y ? 0.5f : __ldg(col + (long long)nb[s] * vp);
      const float rc = rinv(c);
      const float rho = fabsf(qy * (Rq[s] * rc) - Pq[s] * (c * rc));
      // (x, y) + (x, s) + (y, s)
      float tot = nxy_v, cnt = nxy_c;
      ess_add(nrw[s], tot, cnt);
      ess_add(tile[lane * 33 + j], tot, cnt);
      const float m = rho - ess_threshold<1>(th, tot, cnt);
      // a NaN or infinite margin never counts
      if (s != y && !(tn[s] > t_pair) && fabsf(m) <= FLT_MAX && m < best) best = m;
    }
    __syncwarp();
  }
  if (mine) margin_out[node * d + y] = best;
}

// ---- ROUTE_TABLE: levels 2-3, one CTA per node -------------------------------

// Shared memory, in floats: the float4 table of d (d - 1) / 2 entries, the
// panels of C and N (row stride d + 1), at level 3 the u-conditioned panel,
// the rows (one of them the d keys).
__host__ __device__ constexpr long long table_floats(int l, int d) {
  return 2LL * d * (d - 1) + (long long)l * d * (d + 1) + (long long)table_rows(l) * d;
}

template <int L>
__global__ void hsweep_table_kernel(const float* __restrict__ C,
                                    const float* __restrict__ N,
                                    const int* __restrict__ t_ix, long long vp,
                                    const int* __restrict__ node_ixs,
                                    const int* __restrict__ nbrs,
                                    const int* __restrict__ deg, int d, float th,
                                    float* __restrict__ margin_out) {
  extern __shared__ float4 smem4[];
  const long long node = blockIdx.x;
  const int dx = min(max(deg[node], 0), d);
  const int ld = d + 1;
  const int ntri = (d * (d - 1)) >> 1;
  float4* tab = smem4;
  float* P = reinterpret_cast<float*>(smem4 + ntri);
  float* Np = P + d * ld;
  float* T1 = Np + (L == 3 ? d * ld : 0);  // level 3: the panel given u
  float* rows = T1 + d * ld;
  int* nb = reinterpret_cast<int*>(rows);
  float* q = rows + d;
  float* rq = rows + 2 * d;   // rinv(q)
  float* nrw = rows + 3 * d;  // raw N[x, .]
  float* tn = rows + 4 * d;
  unsigned* key = reinterpret_cast<unsigned*>(rows + 5 * d);
  float* CU = rows + 6 * d;  // level 3 only, per u
  float* RU = rows + 7 * d;
  float* Q1 = rows + 8 * d;
  float* RQ1 = rows + 9 * d;
  float* NU = rows + 10 * d;  // raw N[a, u]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int a = threadIdx.x; a < d; a += blockDim.x) key[a] = margin_key(MARGIN_BIG);
  if (dx > L) {  // CTA-uniform: a node without a test writes the sentinels
    const int* row_nbrs = nbrs + node * d;
    for (int a = threadIdx.x; a < dx; a += blockDim.x) nb[a] = row_nbrs[a];
    __syncthreads();
    const int x = node_ixs[node];
    const long long xrow = (long long)x * vp;
    const float t_x = (float)__ldg(t_ix + x);
    for (int a = threadIdx.x; a < dx; a += blockDim.x) {
      const float v = __ldg(C + xrow + nb[a]);
      q[a] = v;
      rq[a] = rinv(v);
      nrw[a] = __ldg(N + xrow + nb[a]);
      tn[a] = (float)__ldg(t_ix + nb[a]);
    }
    stage_panel(P, ld, C, vp, nb, dx);
    stage_panel(Np, ld, N, vp, nb, dx);
    __syncthreads();

    if (L == 2) {
      for (int t = 1 + warp; t < dx; t += nwarps) {
        const float qt = q[t];
        const float rqt = rq[t];
        for (int s = lane; s < t; s += 32) {
          const float c = P[t * ld + s];
          const float r = rinv(c);
          const float q2 = (q[s] - qt * c) * (rqt * r);  // pcorr(x, s | t)
          tab[tri(t) + s] = make_float4(c, r, q2, rinv(q2));
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < dx * dx; i += blockDim.x) {
        const int t = i / dx;
        const int y = i - t * dx;
        if (t == 0 || y == t) continue;
        const float cty = P[t * ld + y];
        const float rty = rinv(cty);
        const float q2ty = (q[y] - q[t] * cty) * (rq[t] * rty);  // pcorr(x, y | t)
        const PairEss e{nrw[y], nrw[t], Np[y * ld + t], 0.0f, 0.0f, 0.0f,
                        fmaxf(tn[t], -1.0f), fmaxf(t_x, tn[y])};
        const float* Py = P + y * ld;
        const float* Ny = Np + y * ld;
        const float* Nt = Np + t * ld;
        const float4* row = tab + tri(t);
        float best = MARGIN_BIG;
        for (int s = 0; s < t; ++s) {
          if (s == y) continue;
          const float4 r = row[s];
          const float T2 = (Py[s] - cty * r.x) * (rty * r.y);
          const float rho = fabsf(q2ty - r.z * T2) * (r.w * rinv(T2));
          offer_margin<2>(rho, th, e, tn[s], nrw[s], Ny[s], Nt[s], 0.0f, best);
        }
        if (best < MARGIN_BIG) atomicMin(&key[y], margin_key(best));
      }
    } else {
      for (int u = 2; u < dx; ++u) {
        __syncthreads();  // the pairs of the previous u are done with T1, tab
        const float qu = q[u];
        const float rqu = rq[u];
        for (int a = threadIdx.x; a < dx; a += blockDim.x) {
          const float c = P[u * ld + a];
          const float r = rinv(c);
          const float q1 = (q[a] - qu * c) * (rqu * r);  // pcorr(x, a | u)
          CU[a] = c;
          RU[a] = r;
          Q1[a] = q1;
          RQ1[a] = rinv(q1);
          NU[a] = Np[a * ld + u];
        }
        __syncthreads();
        // condition the panel on u: T1[a][b] = (Cb[a][b] - cu[a] cu[b]) Ru[a] Ru[b];
        // the pairs read rows t < u whole and columns s < u of every row
        for (int a = warp; a < dx; a += nwarps) {
          const float ca = CU[a];
          const float ra = RU[a];
          const int nb_ = a < u ? dx : u;
          for (int b = lane; b < nb_; b += 32)
            T1[a * ld + b] = (P[a * ld + b] - ca * CU[b]) * (ra * RU[b]);
        }
        for (int t = 1 + warp; t < u; t += nwarps) {
          const float cut = CU[t];
          const float rut = RU[t];
          const float q1t = Q1[t];
          const float rq1t = RQ1[t];
          for (int s = lane; s < t; s += 32) {
            const float T = (P[t * ld + s] - cut * CU[s]) * (rut * RU[s]);
            const float r = rinv(T);
            const float q2 = (Q1[s] - q1t * T) * (rq1t * r);
            tab[tri(t) + s] = make_float4(T, r, q2, rinv(q2));
          }
        }
        __syncthreads();
        const float nxu = nrw[u];
        const float t_base = tn[u];
        for (int i = threadIdx.x; i < u * dx; i += blockDim.x) {
          const int t = i / dx;
          const int y = i - t * dx;
          if (t == 0 || y == t || y == u) continue;
          const float tty = T1[t * ld + y];
          const float rty = rinv(tty);
          const float q2ty = (Q1[y] - Q1[t] * tty) * (RQ1[t] * rty);
          const PairEss e{nrw[y], nrw[t], Np[y * ld + t], nxu, NU[y], NU[t],
                          fmaxf(tn[t], t_base), fmaxf(t_x, tn[y])};
          const float* Ty = T1 + y * ld;
          const float* Ny = Np + y * ld;
          const float* Nt = Np + t * ld;
          const float4* row = tab + tri(t);
          float best = MARGIN_BIG;
          for (int s = 0; s < t; ++s) {
            if (s == y) continue;
            const float4 r = row[s];
            const float T2 = (Ty[s] - tty * r.x) * (rty * r.y);
            const float rho = fabsf(q2ty - r.z * T2) * (r.w * rinv(T2));
            offer_margin<3>(rho, th, e, tn[s], nrw[s], Ny[s], Nt[s], NU[s], best);
          }
          if (best < MARGIN_BIG) atomicMin(&key[y], margin_key(best));
        }
      }
    }
  }
  __syncthreads();
  for (int y = threadIdx.x; y < d; y += blockDim.x)
    margin_out[node * d + y] = margin_of_key(key[y]);
}

// ---- ROUTE_ROWS_*: one thread per slot y, rows rebuilt per (u, t) ----------

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
    }
    __syncthreads();
    if (!live || y == t) continue;
    const float cty = P.c(t, y);
    const float rty = rinv(cty);
    const float q2ty = (R.q[y] - qt * cty) * (rqt * rty);  // pcorr(x, y | t)
    const PairEss e{nxy, R.nrw[t], P.n(y, t), 0.0f, 0.0f, 0.0f,
                    fmaxf(R.tn[t], -1.0f), t_pair};
    for (int s = 0; s < t; ++s) {
      if (s == y) continue;
      const float T2 = (P.c(y, s) - cty * rowC[s]) * (rty * rowR[s]);
      const float rho = fabsf(q2ty - rowQ2[s] * T2) * (rowRQ2[s] * rinv(T2));
      offer_margin<2>(rho, R.th, e, R.tn[s], R.nrw[s], P.n(y, s), P.n(t, s), 0.0f, best);
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
      }
      __syncthreads();
      if (!yok || y == t) continue;
      const float tty = (P.c(t, y) - cut * cuy) * (rut * ruy);
      const float rty = rinv(tty);
      const float q2ty = (q1y - q1t * tty) * (rq1t * rty);
      const PairEss e{nxy, R.nrw[t], P.n(y, t), nxu, nyu, NU[t],
                      fmaxf(R.tn[t], t_base), t_pair};
      for (int s = 0; s < t; ++s) {
        if (s == y) continue;
        const float tys = (P.c(y, s) - cuy * CU[s]) * (ruy * RU[s]);
        const float T2 = (tys - tty * rowT[s]) * (rty * rowR[s]);
        const float rho = fabsf(q2ty - rowQ2[s] * T2) * (rowRQ2[s] * rinv(T2));
        offer_margin<3>(rho, R.th, e, R.tn[s], R.nrw[s], P.n(y, s), P.n(t, s), NU[s], best);
      }
    }
  }
}

// STAGED: both panels in shared memory (never at level 1). WORK_GLOBAL: the
// per-slot rows live in the caller's global scratch.
template <int L, bool STAGED, bool WORK_GLOBAL>
__global__ void hsweep_rows_kernel(const float* __restrict__ C,
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
      stage_panel(pc, d + 1, C, vp, nb, dx);
      stage_panel(pn, d + 1, N, vp, nb, dx);
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

struct Args {
  const float* C;
  const float* N;
  const int* t_ix;
  long long vp;
  const int* node_ixs;
  const int* nbrs;
  const int* deg;
  int nt, d;
  float th;
  float* scratch;
  float* margin;
  cudaStream_t stream;
};

template <int L, bool STAGED, bool WORK_GLOBAL>
int launch_rows(const Args& a, const Plan& p) {
  auto kernel = hsweep_rows_kernel<L, STAGED, WORK_GLOBAL>;
  const int err = allow_smem(kernel, p.smem_bytes);
  if (err != 0) return err;
  kernel<<<dim3((unsigned)a.nt, (unsigned)p.ctas_per_node), p.threads, p.smem_bytes, a.stream>>>(
      a.C, a.N, a.t_ix, a.vp, a.node_ixs, a.nbrs, a.deg, a.d, a.th, a.scratch, a.margin);
  return (int)cudaGetLastError();
}

template <int L>
int launch_table(const Args& a, const Plan& p) {
  auto kernel = hsweep_table_kernel<L>;
  const int err = allow_smem(kernel, p.smem_bytes);
  if (err != 0) return err;
  kernel<<<(unsigned)a.nt, p.threads, p.smem_bytes, a.stream>>>(
      a.C, a.N, a.t_ix, a.vp, a.node_ixs, a.nbrs, a.deg, a.d, a.th, a.margin);
  return (int)cudaGetLastError();
}

int launch_direct(const Args& a, const Plan& p) {
  const int err = allow_smem(hsweep1_direct_kernel, p.smem_bytes);
  if (err != 0) return err;
  const unsigned groups = (unsigned)((a.nt + p.nodes_per_cta - 1) / p.nodes_per_cta);
  hsweep1_direct_kernel<<<dim3(groups, (unsigned)p.ctas_per_node), p.threads, p.smem_bytes,
                          a.stream>>>(a.C, a.N, a.t_ix, a.vp, a.node_ixs, a.nbrs, a.deg,
                                      a.nt, a.d, p.nodes_per_cta, a.th, a.margin);
  return (int)cudaGetLastError();
}

// Shared memory the route's layout needs; -1 for a plan the route cannot run.
long long smem_needed(int l, int d, const Plan& p) {
  const long long rows = (long long)WORK_ROWS * d * sizeof(float);
  switch (p.route) {
    case ROUTE_DIRECT:
      if (l != 1 || p.nodes_per_cta < 1) return -1;
      if (p.ctas_per_node == 1 ? p.nodes_per_cta * d > p.threads : p.nodes_per_cta != 1)
        return -1;
      return ((long long)p.nodes_per_cta * DIRECT_ROWS * d + (long long)(p.threads / 32) * TILE) *
             (long long)sizeof(float);
    case ROUTE_TABLE:
      if (l < 2 || p.ctas_per_node != 1) return -1;
      return table_floats(l, d) * (long long)sizeof(float);
    case ROUTE_ROWS_STAGED:
      return l == 1 ? -1 : rows + 2LL * d * (d + 1) * sizeof(float);
    case ROUTE_ROWS_L2:
      return rows;
    case ROUTE_ROWS_SCRATCH:
      return 0;
    default:
      return -1;
  }
}

template <int L>
int launch_level(const Args& a, const Plan& p) {
  switch (p.route) {
    case ROUTE_DIRECT:
      return launch_direct(a, p);
    case ROUTE_TABLE:
      if (L == 1) return (int)cudaErrorInvalidValue;
      return launch_table<(L == 1 ? 2 : L)>(a, p);
    case ROUTE_ROWS_STAGED:
      if (L == 1) return (int)cudaErrorInvalidValue;
      return launch_rows<(L == 1 ? 2 : L), true, false>(a, p);
    case ROUTE_ROWS_L2:
      return launch_rows<L, false, false>(a, p);
    default:
      if (a.scratch == nullptr) return (int)cudaErrorInvalidValue;
      return launch_rows<L, false, true>(a, p);
  }
}

}  // namespace

extern "C" {

// C, N (vp, vp) f32; t_ix (vp,), node_ixs (nt,), nbrs (nt, d), deg (nt,)
// int32, all contiguous on the device. The plan (route, threads,
// nodes_per_cta, ctas_per_node, smem_bytes) comes from the wrapper's
// `plan(l, d)`; scratch holds nt * ctas_per_node * 13 * d floats on
// ROUTE_ROWS_SCRATCH, else null. Writes margin (nt, d) f32; pad slots
// y >= deg and slots with no valid test get 3.0e38. Returns the cudaError_t
// of the launch; a plan that does not fit its route is cudaErrorInvalidValue.
int hetcor_sweep_launch(const float* C, const float* N, const int* t_ix,
                        long long vp, const int* node_ixs, const int* nbrs,
                        const int* deg, int nt, int d, int l, float th,
                        int route, int threads, int nodes_per_cta,
                        int ctas_per_node, int smem_bytes, float* scratch,
                        float* margin, void* stream) {
  if (nt <= 0 || d <= 0) return 0;
  const Plan p{route, threads, nodes_per_cta, ctas_per_node, smem_bytes};
  if (l < 1 || l > 3 || !plan_fits(p, d, smem_needed(l, d, p)))
    return (int)cudaErrorInvalidValue;
  const Args a{C, N, t_ix, vp, node_ixs, nbrs, deg, nt, d, th, scratch, margin,
               static_cast<cudaStream_t>(stream)};
  switch (l) {
    case 1:
      return launch_level<1>(a, p);
    case 2:
      return launch_level<2>(a, p);
    default:
      return launch_level<3>(a, p);
  }
}

}  // extern "C"
