// Local-panel gather on NVIDIA Hopper (sm_90a): for each node x with
// neighbour list nb[x] (d entries; a pad slot j >= deg[x] reads as x itself,
// whatever it holds), copy
//     Cb[x][j][k] = C[nb[x][j]][nb[x][k]]      (nt, d, d)
//     qb[x][k]    = C[x][nb[x][k]]             (nt, d)
// bit for bit, NaN payloads included; with a second matched panel N the same
// offsets also give Nb and nr in the same launch. N is not assumed
// symmetric, so every entry is read where the lists say.
//
// Replaces the TPU kernels cigwas_tpu/ops/pallas/panel_gather.py
// `_window_kernel` (one panel, via `_gather_core`) and `_rowgather2_kernel`
// (two panels, via `_rowgather2_core`). Those move 128-aligned windows or
// whole rows by DMA and pick the entries with one-hot matmuls, with a
// parallel NaN-count product, because Mosaic cannot index values; an indexed
// load does all of that here, for every width and every span.
//
// What bounds it: bytes. There is no arithmetic; every output element is
// written once, and every read moves a whole 32-byte sector from L2 to the
// SM, of which LD-clustered lists use about half, so that some three bytes
// cross L2 for each byte of output. TMA does not apply: a scattered 4-byte
// gather has no box to describe. What the design does about it (ROUTE_ROWS):
//   - a node's output is d + 1 rows of d elements: row -1 is qb (source row
//     x), row j is Cb[j] (source row nb[j]). A warp owns whole rows, takes
//     the row's base nb[j] * vp once, and its lanes run along k in groups of
//     four: four scattered loads a panel (eight with two panels) are started
//     before any store, and each panel gets one 128-bit store where
//     d % 4 == 0 (Cb + node * d * d and qb + node * d are 16-byte aligned
//     exactly then); other widths take the same loop with scalar stores;
//   - no division or modulo in the loops: a lane's (row, group) within the
//     warp is found once per thread;
//   - rows narrower than a warp share it (32 / ceil(d / 4) rows a pass), and
//     narrow nodes share a CTA, a warp per node, as level 1 of the sweeps
//     does; a wide node spreads runs of rows over CTAs, each run long enough
//     (8 rows or more) to repay staging the node's list;
//   - a CTA stages its nodes' lists once in shared memory, pad slots
//     remapped; beyond the opt-in limit it reads them through the cache.
// The launch plan (route, threads, nodes per CTA, rows per CTA, staging,
// shared bytes) comes from plan() in ops/kernels/panel_gather.py; the
// launcher refuses one that does not fit. Offsets are 64-bit: a 50k-variable
// panel overflows int32.

#include <cuda_runtime.h>

namespace {

constexpr int ROUTE_ROWS = 0;
constexpr int SMEM_OPT_IN = 232448;  // dynamic shared memory a CTA may opt in to
constexpr int SMEM_DEFAULT = 49152;  // above this the kernel must opt in

struct Args {
  const float* C;
  const float* N;
  long long vp;
  const int* node_ixs;
  const int* nbrs;
  const int* deg;
  int nt;
  int d;
  float* Cb;
  float* qb;
  float* Nb;
  float* nr;
};

// One node's list as the copy loops read it: staged in shared memory (pad
// slots already hold the node) or through the cache with the remap applied.
template <bool STAGED>
struct List {
  const int* p;  // STAGED: shared, else the node's row of nbrs
  int dg;
  int x;
  __device__ __forceinline__ int at(int a) const {
    if (STAGED) return p[a];
    return a < dg ? __ldg(p + a) : x;
  }
};

// Rows [r_first, r_end) in steps of r_step of one node, this lane's share of
// each: groups of four along k starting at 4 * lane_g, 4 * lanes_row apart.
template <bool TWO, bool STAGED, bool VEC>
__device__ __forceinline__ void copy_rows(const Args& a, long long node,
                                          const List<STAGED>& nb, int r_first,
                                          int r_end, int r_step, int lane_g,
                                          int lanes_row) {
  const int d = a.d;
  for (int r = r_first; r < r_end; r += r_step) {
    const long long src = (long long)(r < 0 ? nb.x : nb.at(r)) * a.vp;
    const float* crow = a.C + src;
    const float* nrow = TWO ? a.N + src : nullptr;
    const long long dst = r < 0 ? node * d : (node * d + r) * (long long)d;
    float* cout = (r < 0 ? a.qb : a.Cb) + dst;
    float* nout = TWO ? (r < 0 ? a.nr : a.Nb) + dst : nullptr;
    if (VEC) {
      for (int k = 4 * lane_g; k < d; k += 4 * lanes_row) {
        int i0, i1, i2, i3;
        if (STAGED) {
          const int4 ix = *reinterpret_cast<const int4*>(nb.p + k);
          i0 = ix.x, i1 = ix.y, i2 = ix.z, i3 = ix.w;
        } else {
          i0 = nb.at(k), i1 = nb.at(k + 1), i2 = nb.at(k + 2), i3 = nb.at(k + 3);
        }
        float4 c, n;
        c.x = __ldg(crow + i0), c.y = __ldg(crow + i1), c.z = __ldg(crow + i2), c.w = __ldg(crow + i3);
        if (TWO)
          n.x = __ldg(nrow + i0), n.y = __ldg(nrow + i1), n.z = __ldg(nrow + i2), n.w = __ldg(nrow + i3);
        *reinterpret_cast<float4*>(cout + k) = c;
        if (TWO) *reinterpret_cast<float4*>(nout + k) = n;
      }
    } else {
      // lanes one element apart, four elements a lane in flight
      for (int k = lane_g; k < d; k += 4 * lanes_row) {
        float c[4], n[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kk = k + u * lanes_row;
          if (kk < d) {
            const int ix = nb.at(kk);
            c[u] = __ldg(crow + ix);
            if (TWO) n[u] = __ldg(nrow + ix);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kk = k + u * lanes_row;
          if (kk < d) {
            cout[kk] = c[u];
            if (TWO) nout[kk] = n[u];
          }
        }
      }
    }
  }
}

// grid: ceil(nt / npc) CTAs of npc whole nodes (npc > 1), or nt * cpn CTAs,
// node-major, each a run of rows_cta rows of one node (row -1 first).
template <bool TWO, bool STAGED, bool VEC>
__global__ void panel_rows_kernel(Args a, int npc, int rows_cta, int cpn) {
  extern __shared__ __align__(16) int nb_s[];
  const int d = a.d;
  const int d4 = (d + 3) & ~3;  // stride of a staged list: 16-byte aligned
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // a lane's place within its warp, once per thread
  const int groups = VEC ? d >> 2 : d;
  const int lanes_row = groups < 32 ? groups : 32;
  const int rows_pass = 32 / lanes_row;
  const int lane_row = lane / lanes_row;
  const int lane_g = lane - lane_row * lanes_row;

  long long node0;
  int n_nodes, row0, row1;
  if (npc > 1) {
    node0 = (long long)blockIdx.x * npc;
    n_nodes = (int)min((long long)npc, a.nt - node0);
    row0 = -1, row1 = d;
  } else {
    node0 = blockIdx.x / (unsigned)cpn;
    const int part = (int)(blockIdx.x - (unsigned)node0 * (unsigned)cpn);
    n_nodes = 1;
    row0 = part * rows_cta - 1;
    row1 = min(row0 + rows_cta, d);
  }
  if (STAGED) {
    // a warp per node where nodes share the CTA, else every thread
    const int first = npc > 1 ? lane : (int)threadIdx.x;
    const int step = npc > 1 ? 32 : (int)blockDim.x;
    for (int i = npc > 1 ? warp : 0; i < n_nodes; i += warps) {
      const long long node = node0 + i;
      const int* row = a.nbrs + node * d;
      const int x = a.node_ixs[node], dg = a.deg[node];
      for (int s = first; s < d4; s += step)
        nb_s[i * d4 + s] = s < dg ? row[s] : x;
    }
    __syncthreads();
  }
  if (lane_row >= rows_pass) return;  // lanes_row does not divide 32
  if (npc > 1) {
    for (int i = warp; i < n_nodes; i += warps) {
      const long long node = node0 + i;
      const List<STAGED> nb{STAGED ? nb_s + i * d4 : a.nbrs + node * d,
                            a.deg[node], a.node_ixs[node]};
      copy_rows<TWO, STAGED, VEC>(a, node, nb, row0 + lane_row, row1, rows_pass,
                                  lane_g, lanes_row);
    }
  } else {
    const List<STAGED> nb{STAGED ? nb_s : a.nbrs + node0 * d, a.deg[node0],
                          a.node_ixs[node0]};
    copy_rows<TWO, STAGED, VEC>(a, node0, nb, row0 + warp * rows_pass + lane_row,
                                row1, warps * rows_pass, lane_g, lanes_row);
  }
}

template <typename K>
cudaError_t opt_in(K kernel, int smem_bytes) {
  if (smem_bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

template <bool TWO, bool STAGED, bool VEC>
int launch_rows(const Args& a, int threads, int npc, int rows_cta, int cpn,
                unsigned grid, int smem_bytes, cudaStream_t stream) {
  auto kernel = panel_rows_kernel<TWO, STAGED, VEC>;
  cudaError_t err = opt_in(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem_bytes, stream>>>(a, npc, rows_cta, cpn);
  return (int)cudaGetLastError();
}

template <bool TWO>
int launch(const Args& a, int route, int threads, int npc, int rows_cta,
           int staged, int smem_bytes, cudaStream_t stream) {
  const int d = a.d;
  const int d4 = (d + 3) & ~3;
  // a plan that does not fit is refused, never repaired
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || npc < 1 ||
      rows_cta < 1 || smem_bytes < 0 || smem_bytes > SMEM_OPT_IN)
    return (int)cudaErrorInvalidValue;
  if (route != ROUTE_ROWS) return (int)cudaErrorInvalidValue;
  if (npc > 1 && rows_cta < d + 1) return (int)cudaErrorInvalidValue;
  if ((long long)smem_bytes < (staged ? 4LL * npc * d4 : 0))
    return (int)cudaErrorInvalidValue;
  const int cpn = npc > 1 ? 1 : (d + rows_cta) / rows_cta;  // ceil((d + 1) / rows_cta)
  const long long ctas =
      npc > 1 ? ((long long)a.nt + npc - 1) / npc : (long long)a.nt * cpn;
  if (ctas > 2147483647LL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)ctas;
  const bool vec = d % 4 == 0;
#define ROWS(S, V) \
  launch_rows<TWO, S, V>(a, threads, npc, rows_cta, cpn, grid, smem_bytes, stream)
  if (staged) return vec ? ROWS(true, true) : ROWS(true, false);
  return vec ? ROWS(false, true) : ROWS(false, false);
#undef ROWS
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// C (and N, or null for one panel) (vp, vp) f32; node_ixs (nt,), nbrs (nt, d)
// int32 with every entry in [0, vp), deg (nt,) int32 (slots j >= deg read as
// the node), all contiguous on the device and 16-byte aligned. Writes Cb
// (nt, d, d), qb (nt, d) and, with N, Nb and nr of the same shapes. The plan
// (route, threads, nodes_per_cta, rows_per_cta, staged, smem_bytes) is
// plan() of ops/kernels/panel_gather.py; one that does not fit, or
// a grid beyond 2^31 - 1 CTAs, is refused with cudaErrorInvalidValue.
// Returns the cudaError_t of the launch.
int panel_gather_launch(const float* C, const float* N, long long vp,
                        const int* node_ixs, const int* nbrs, const int* deg,
                        int nt, int d, int route, int threads, int nodes_per_cta,
                        int rows_per_cta, int staged, int smem_bytes, float* Cb,
                        float* qb, float* Nb, float* nr, void* stream) {
  if (nt <= 0 || d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{C, N, vp, node_ixs, nbrs, deg, nt, d, Cb, qb, Nb, nr};
  if (N != nullptr)
    return launch<true>(a, route, threads, nodes_per_cta, rows_per_cta, staged,
                        smem_bytes, st);
  return launch<false>(a, route, threads, nodes_per_cta, rows_per_cta, staged,
                       smem_bytes, st);
}

// A kernel that does nothing, one warp: what a launch alone costs.
int panel_gather_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
