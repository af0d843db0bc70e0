// The hetcor skeleton's combinatorial scan (levels >= 4; levels 1-3 where the
// route is forced) on NVIDIA Hopper (sm_90a). One launch takes a node tile's
// gathered local panels (C_x, N_x (nt, d, d), c_row, n_row, t_nbrs (nt, d),
// t_x, deg (nt,)) and one wave of conditioning sets: combos (nch, K, l)
// colex positions into each node's neighbour list, of which the first
// left[c, node] of chunk c are that node's. It returns for every node x and
// neighbour slot y the minimum over those sets S of
//     |pcorr(x, y | S)| - tanh(th / sqrt(mean_ess({x, y} u S) - l - 3))
// where S holds no variable later in time than max(t_x, t_y); 3.0e38 where
// no test is valid. The skeleton removes x - y where the margin is negative.
//
// Replaces no TPU kernel: the JAX package scans its chunks in plain XLA
// (`cigwas_tpu/ops/pcorr.py` `level_scan_hetcor_pre`, one-hot matmuls and a
// batched LU inverse per 512-set chunk), and so did the port, one chunk at a
// time: about a thousand small PyTorch operations a chunk at level 9, each a
// host dispatch and a launch of microseconds. What the reference does instead
// (`hetcor-cuPC-S.cu` `cal_Indepl4_ess` .. `cal_Indepl14_ess`) is one kernel
// a level that enumerates sets, factors the conditioning block and tests
// every neighbour; this is that design.
//
// What bounds it: instruction issue and dependent latency, not bytes. A set
// costs a Gauss-Jordan inversion of its l x l block (~2 l^3 operations, l
// steps of a warp-wide pivot search) shared by the set's d tests, each ~2 l^2
// operations plus the ESS mean and a tanh; at l = 9, d = 18 about 500 f32
// operations a set. Design:
//  * grid (nt, ctas_per_node): the sets of a node are dealt to the warps of
//    its CTAs, a set a warp at a time; a CTA stages its node's panels in
//    shared memory at row stride d + 1 with the row, the ESS row and the
//    time indices of x's neighbours (wider panels, past d = 106-109, are
//    read through L2, and the warps' minima then live in global scratch);
//  * a set: lane i < l holds row i of [M2 | I] in registers; each step finds
//    the pivot by a warp argmax over the unused rows, broadcasts the pivot
//    row by shuffles and eliminates it from every other row, without row
//    swaps; the pivot rows' right halves over their pivots are the inverse,
//    written to the warp's tile in shared memory. l <= 3 uses the closed
//    form of `_inv_unrolled` in every lane;
//  * then the lanes take the neighbours y (one each at d <= 32, looping
//    above), every lane holding the set's S-S and x-S ESS sums, and keep a
//    running minimum per y in the warp's own row;
//  * the warps' minima meet per CTA, and each CTA takes its minima into the
//    output by an atomic minimum (the caller fills it with 3.0e38 first). A
//    minimum is exact in any order, so the result does not depend on how
//    the sets were dealt or on the order in which the CTAs finish.
//
// Arithmetic is the plain version's op for op and in its order
// (`cigwas_tpu_torch/ops/pcorr.py` `level_scan_hetcor_pre`, `_pivoted_inverse`,
// `_inv_unrolled`): the ESS terms S-S (i over l, j < i), x-S, y-S, x-y; H01,
// H00 and H11 summed from 0 in index order; 1 / sqrt for every rsqrt. Build
// with -fmad=false and without fast math; margins then equal the plain
// version's run on the card bit for bit.

#include "sweep_common.cuh"

namespace {

using namespace sweep;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_L = 14;

struct ScanArgs {
  const float* C_x;        // (nt, d, d)
  const float* c_row;      // (nt, d)
  const float* N_x;        // (nt, d, d) raw: NaN = no estimate
  const float* n_row;      // (nt, d)
  const float* t_nbrs;     // (nt, d)
  const float* t_x;        // (nt,)
  const int* deg;          // (nt,)
  const long long* combos; // (nch, K, l)
  const long long* left;   // (nch, nt)
  int nt, d, K;
  long long nsets;         // nch * K
  float th;
  int staged;              // panels, rows and minima in shared memory
  float* mins;             // (nt, ctas_per_node, warps, d) unless staged
  float* out;              // (nt, d), filled with MARGIN_BIG by the caller
};

// nan_to_num of a raw ESS entry and its 0/1 count
__device__ __forceinline__ float ess_val(float n) {
  return isnan(n) ? 0.0f : fminf(fmaxf(n, -FLT_MAX), FLT_MAX);
}
__device__ __forceinline__ float ess_cnt(float n) { return isnan(n) ? 0.0f : 1.0f; }

// *p = min(*p, v) for floats that are not NaN: floats without the sign bit
// order as their bits do as signed ints, those with it (-0 included) as
// their bits do as unsigned ints in reverse, above every float without it
__device__ __forceinline__ void atomic_min_float(float* p, float v) {
  if (!signbit(v))
    atomicMin(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

// floats of shared memory: per warp the inverse's l x l tile; staged, also
// both panels at row stride d + 1, three rows and per warp a row of minima
__host__ __device__ inline long long scan_smem_floats(int l, int d, int warps, int staged) {
  return (long long)warps * l * l +
         (staged ? 2LL * d * (d + 1) + 3LL * d + (long long)warps * d : 0LL);
}

// The l x l inverse of the set's block by Gauss-Jordan with partial pivoting,
// rows kept in place (`_pivoted_inverse`). Lane i < L holds row i; `mine` is
// lane i's variable S_i. Writes the inverse to inv (row-major) and returns
// false where a pivot is zero or no row is left to pivot (singular block).
template <int L>
__device__ __forceinline__ bool pivoted_inverse(const float* Cp, int ld, const int (&s)[L],
                                                int mine, int lane, float* inv) {
  float ra[L], rb[L];
  const bool row = lane < L;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    ra[j] = row ? Cp[(long long)mine * ld + s[j]] : 0.0f;
    rb[j] = (j == lane) ? 1.0f : 0.0f;
  }
  bool used = false;
  float my_pk = 1.0f;
  int my_k = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    float v = (row && !used) ? fabsf(ra[k]) : -1.0f;
    if (!(v >= 0.0f)) v = -1.0f;  // a NaN is never a pivot
    int p = lane;
    // warp argmax of (v, lowest lane): a total order, so every lane agrees
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(FULL, v, off);
      const int p2 = __shfl_xor_sync(FULL, p, off);
      if (v2 > v || (v2 == v && p2 < p)) {
        v = v2;
        p = p2;
      }
    }
    if (!(v > 0.0f)) return false;  // warp-uniform
    const float pk = __shfl_sync(FULL, ra[k], p);
    const float f = ra[k] / pk;
    const bool elim = lane != p;
#pragma unroll
    for (int j = k + 1; j < L; ++j) {
      const float apj = __shfl_sync(FULL, ra[j], p);
      if (elim) ra[j] = ra[j] - f * apj;
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float bpj = __shfl_sync(FULL, rb[j], p);
      if (elim) rb[j] = rb[j] - f * bpj;
    }
    if (!elim) {
      used = true;
      my_pk = pk;
      my_k = k;
    }
  }
  if (row) {
#pragma unroll
    for (int j = 0; j < L; ++j) inv[my_k * L + j] = rb[j] / my_pk;
  }
  __syncwarp();
  return true;
}

// The closed-form inverse of `_inv_unrolled` (l <= 3), term for term.
template <int L>
__device__ __forceinline__ void inv_unrolled(const float (&m)[L][L], float (&v)[L][L]) {
  if constexpr (L == 1) {
    v[0][0] = 1.0f / m[0][0];
  } else if constexpr (L == 2) {
    const float det = m[0][0] * m[1][1] - m[0][1] * m[1][0];
    v[0][0] = m[1][1] / det;
    v[0][1] = -m[0][1] / det;
    v[1][0] = -m[1][0] / det;
    v[1][1] = m[0][0] / det;
  } else {
    const float c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1];
    const float c01 = m[0][2] * m[2][1] - m[0][1] * m[2][2];
    const float c02 = m[0][1] * m[1][2] - m[0][2] * m[1][1];
    const float c10 = m[1][2] * m[2][0] - m[1][0] * m[2][2];
    const float c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0];
    const float c12 = m[0][2] * m[1][0] - m[0][0] * m[1][2];
    const float c20 = m[1][0] * m[2][1] - m[1][1] * m[2][0];
    const float c21 = m[0][1] * m[2][0] - m[0][0] * m[2][1];
    const float c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0];
    const float det = m[0][0] * c00 + m[1][0] * c01 + m[2][0] * c02;
    v[0][0] = c00 / det; v[0][1] = c01 / det; v[0][2] = c02 / det;
    v[1][0] = c10 / det; v[1][1] = c11 / det; v[1][2] = c12 / det;
    v[2][0] = c20 / det; v[2][1] = c21 / det; v[2][2] = c22 / det;
  }
}

struct NodeRows {
  const float* Cp;    // the node's C panel: shared memory or global
  const float* Np;    // its raw N panel
  int ld;             // their row stride
  const float* crow;  // C[x, .], raw N[x, .] and the time index of the
  const float* nrow;  // neighbours: shared memory or global
  const float* tn;
  float t_x;
  int dx;             // min(deg, d)
};

// Every test of one set against the warp's running minima wmin (d,).
template <int L>
__device__ void scan_set(const NodeRows& R, const long long* combo, int d, float th,
                         float* inv, float* wmin, int lane) {
  int mine = 0;
  if (lane < L) {
    const long long v = combo[lane];
    mine = (int)(v < 0 ? 0 : (v > d - 1 ? d - 1 : v));
  }
  int s[L];
#pragma unroll
  for (int i = 0; i < L; ++i) s[i] = __shfl_sync(FULL, mine, i);
  float cx[L];
#pragma unroll
  for (int i = 0; i < L; ++i) cx[i] = R.crow[s[i]];

  // the inverse of M2 = C[S, S] and t = M2^-1 C[S, x]
  float t[L];
  float vi[L <= 3 ? L : 1][L <= 3 ? L : 1];
  if constexpr (L <= 3) {
    float m[L][L];
#pragma unroll
    for (int i = 0; i < L; ++i)
#pragma unroll
      for (int j = 0; j < L; ++j) m[i][j] = R.Cp[(long long)s[i] * R.ld + s[j]];
    inv_unrolled<L>(m, vi);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < L; ++j) acc = acc + vi[i][j] * cx[j];
      t[i] = acc;
    }
  } else {
    if (!pivoted_inverse<L>(R.Cp, R.ld, s, mine, lane, inv)) return;
    float tm = 0.0f;
    if (lane < L) {
#pragma unroll
      for (int j = 0; j < L; ++j) tm = tm + inv[lane * L + j] * cx[j];
    }
#pragma unroll
    for (int i = 0; i < L; ++i) t[i] = __shfl_sync(FULL, tm, i);
  }
  float acc0 = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i) acc0 = acc0 + cx[i] * t[i];
  const float h00 = 1.0f - acc0;

  // the set's own ESS terms (S-S, then x-S) and its latest time index
  float sSS = 0.0f, cSS = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const float n = R.Np[(long long)s[i] * R.ld + s[j]];
      sSS = sSS + ess_val(n);
      cSS = cSS + ess_cnt(n);
    }
  float sxS = 0.0f, cxS = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const float n = R.nrow[s[i]];
    sxS = sxS + ess_val(n);
    cxS = cxS + ess_cnt(n);
  }
  float tS = R.tn[s[0]];
#pragma unroll
  for (int i = 1; i < L; ++i) tS = fmaxf(tS, R.tn[s[i]]);

  for (int y = lane; y < R.dx; y += 32) {
    bool in_s = false;
#pragma unroll
    for (int i = 0; i < L; ++i) in_s = in_s || s[i] == y;
    if (in_s) continue;
    float r[L];
#pragma unroll
    for (int i = 0; i < L; ++i) r[i] = R.Cp[(long long)s[i] * R.ld + y];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < L; ++i) acc = acc + r[i] * t[i];
    const float h01 = R.crow[y] - acc;
    float acc2 = 0.0f;
#pragma unroll
    for (int i = 0; i < L; ++i)
#pragma unroll
      for (int j = 0; j < L; ++j) {
        float mij;
        if constexpr (L <= 3) mij = vi[i][j];
        else mij = inv[i * L + j];
        acc2 = acc2 + (r[i] * mij) * r[j];
      }
    const float h11 = 1.0f - acc2;
    const float rho = fabsf(h01) * (1.0f / sqrtf(fabsf(h00 * h11)));
    if (!(rho < RHO_BIG)) continue;  // NaN, infinite or out of range
    if (tS > fmaxf(R.t_x, R.tn[y])) continue;
    float syS = 0.0f, cyS = 0.0f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const float n = R.Np[(long long)s[i] * R.ld + y];
      syS = syS + ess_val(n);
      cyS = cyS + ess_cnt(n);
    }
    const float nxy = R.nrow[y];
    const float tot = ((sSS + sxS) + syS) + ess_val(nxy);
    const float cnt = ((cSS + cxS) + cyS) + ess_cnt(nxy);
    const float th_test = tanhf(th / sqrtf((tot / cnt - (float)L) - 3.0f));
    if (!(fabsf(th_test) <= FLT_MAX)) continue;
    const float m = rho - th_test;
    if (m < wmin[y]) wmin[y] = m;
  }
}

template <int L>
__global__ void __launch_bounds__(256) hetcor_scan_kernel(ScanArgs a) {
  extern __shared__ float smem[];
  const long long node = blockIdx.x;
  const int d = a.d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long dd = (long long)d * d;
  const float* Cg = a.C_x + node * dd;
  const float* Ng = a.N_x + node * dd;
  const float* crow_g = a.c_row + node * d;
  const float* nrow_g = a.n_row + node * d;
  const float* tn_g = a.t_nbrs + node * d;

  NodeRows R;
  float* tiles = smem;  // the warps' inverse tiles
  float* mins;          // the warps' rows of running minima
  int bad = 0;
  if (a.staged) {
    float* Cs = smem;
    float* Ns = Cs + d * (d + 1);
    float* rows = Ns + d * (d + 1);
    for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
      const int r = e / d;
      const int c = e - r * d;
      const float v = Cg[e];
      bad |= !isfinite(v);
      Cs[r * (d + 1) + c] = v;
      Ns[r * (d + 1) + c] = Ng[e];
    }
    for (int y = threadIdx.x; y < d; y += blockDim.x) {
      rows[y] = crow_g[y];
      rows[d + y] = nrow_g[y];
      rows[2 * d + y] = tn_g[y];
    }
    R = NodeRows{Cs, Ns, d + 1, rows, rows + d, rows + 2 * d};
    tiles = rows + 3 * d;
    mins = tiles + warps * L * L;
  } else {
    for (long long e = threadIdx.x; e < dd; e += blockDim.x) bad |= !isfinite(__ldg(Cg + e));
    R = NodeRows{Cg, Ng, d, crow_g, nrow_g, tn_g};
    mins = a.mins + (node * gridDim.y + blockIdx.y) * warps * d;
  }
  for (int y = threadIdx.x; y < d; y += blockDim.x) bad |= !isfinite(crow_g[y]);
  float* inv = tiles + warp * L * L;
  float* wmin = mins + (long long)warp * d;
  for (int y = lane; y < d; y += 32) wmin[y] = MARGIN_BIG;
  // a non-finite entry of the C panel or row: no test of this node counts
  // (the JAX package's one-hot selections smear it into every test)
  bad = __syncthreads_or(bad);
  R.t_x = a.t_x[node];
  R.dx = min(a.deg[node], d);

  if (!bad) {
    const long long stride = (long long)gridDim.y * warps;
    for (long long g = (long long)blockIdx.y * warps + warp; g < a.nsets; g += stride) {
      const long long c = g / a.K;
      const long long k = g - c * a.K;
      if (k >= a.left[c * a.nt + node]) continue;  // warp-uniform
      scan_set<L>(R, a.combos + g * L, d, a.th, inv, wmin, lane);
    }
  }
  __syncthreads();

  // the CTA's minimum over its warps, taken into the node's minimum
  for (int y = threadIdx.x; y < d; y += blockDim.x) {
    float m = MARGIN_BIG;
    for (int w = 0; w < warps; ++w) {
      const float v = mins[(long long)w * d + y];
      m = v < m ? v : m;
    }
    if (m < MARGIN_BIG) atomic_min_float(a.out + node * d + y, m);
  }
}

template <int L>
int launch(const ScanArgs& a, int threads, int ctas_per_node, int smem_bytes,
           cudaStream_t stream) {
  const int err = allow_smem(hetcor_scan_kernel<L>, smem_bytes);
  if (err != 0) return err;
  hetcor_scan_kernel<L><<<dim3(a.nt, ctas_per_node), threads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C_x, N_x (nt, d, d), c_row, n_row, t_nbrs (nt, d), t_x (nt,) f32; deg
// (nt,) int32; combos (nch, K, l), left (nch, nt) int64; all contiguous on the
// device. The plan (threads, ctas_per_node, staged, smem_bytes) comes from the
// wrapper's `scan_plan` and `scan_ctas_per_node`; mins holds nt *
// ctas_per_node * threads / 32 * d floats unless staged, where it may be
// null. margin (nt, d) f32, filled with MARGIN_BIG by the caller, takes the
// minima. Returns the cudaError_t of the launch; a plan that does not fit is
// cudaErrorInvalidValue.
int hetcor_scan_launch(const float* C_x, const float* c_row, const float* N_x,
                       const float* n_row, const float* t_nbrs, const float* t_x,
                       const int* deg, const long long* combos, const long long* left,
                       int nt, int d, int nch, int K, int l, float th, int threads,
                       int ctas_per_node, int staged, int smem_bytes, float* mins,
                       float* margin, void* stream) {
  if (nt <= 0 || d <= 0) return 0;
  const int warps = threads / 32;
  const long long need = 4 * scan_smem_floats(l, d, warps, staged);
  if (l < 1 || l > MAX_L || threads < 32 || threads > 256 || threads % 32 != 0 ||
      ctas_per_node < 1 || ctas_per_node > 65535 || need > smem_bytes ||
      smem_bytes > SMEM_OPT_IN || nch < 0 || K < 1 || (!staged && mins == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanArgs a{C_x, c_row, N_x, n_row, t_nbrs, t_x, deg, combos, left, nt, d, K,
                   (long long)nch * K, th, staged, mins, margin};
  switch (l) {
    case 1: return launch<1>(a, threads, ctas_per_node, smem_bytes, st);
    case 2: return launch<2>(a, threads, ctas_per_node, smem_bytes, st);
    case 3: return launch<3>(a, threads, ctas_per_node, smem_bytes, st);
    case 4: return launch<4>(a, threads, ctas_per_node, smem_bytes, st);
    case 5: return launch<5>(a, threads, ctas_per_node, smem_bytes, st);
    case 6: return launch<6>(a, threads, ctas_per_node, smem_bytes, st);
    case 7: return launch<7>(a, threads, ctas_per_node, smem_bytes, st);
    case 8: return launch<8>(a, threads, ctas_per_node, smem_bytes, st);
    case 9: return launch<9>(a, threads, ctas_per_node, smem_bytes, st);
    case 10: return launch<10>(a, threads, ctas_per_node, smem_bytes, st);
    case 11: return launch<11>(a, threads, ctas_per_node, smem_bytes, st);
    case 12: return launch<12>(a, threads, ctas_per_node, smem_bytes, st);
    case 13: return launch<13>(a, threads, ctas_per_node, smem_bytes, st);
    default: return launch<14>(a, threads, ctas_per_node, smem_bytes, st);
  }
}

}  // extern "C"
