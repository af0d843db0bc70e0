// Local-panel gather on NVIDIA Hopper (sm_90a): for each node x with
// neighbour list nb[x] (d entries; a pad slot j >= deg[x] reads as x itself,
// whatever it holds), copy
//     Cb[x][j][k] = C[nb[x][j]][nb[x][k]]      (nt, d, d)
//     qb[x][k]    = C[x][nb[x][k]]             (nt, d)
// bit for bit, NaN payloads included; with a second matched panel N the same
// offsets also give Nb and nr in the same launch.
//
// Replaces the TPU kernels cigwas_tpu/ops/pallas/panel_gather.py
// `_window_kernel` (one panel, via `_gather_core`) and `_rowgather2_kernel`
// (two panels, via `_rowgather2_core`). Those move 128-aligned windows or
// whole rows by DMA and pick the entries with one-hot matmuls, with a
// parallel NaN-count product, because Mosaic cannot index values; an indexed
// load does all of that here, for every width and every span.
//
// What bounds it: bytes. Every output element is written once (coalesced
// along k) and read once from a scattered address; there is no arithmetic.
// One CTA copies a run of CHUNK consecutive elements of one node's flattened
// (d, d) panel, so a wide node spreads over many SMs and a narrow one costs
// one small CTA; the node's indices are staged in shared memory when they fit
// and read through the cache otherwise. Offsets are 64-bit: a 50k-variable
// panel overflows int32.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;          // panel elements per CTA
constexpr int STAGE_MAX = 12288;     // indices that fit the 48 KB static limit

template <bool TWO, bool STAGED>
__global__ void panel_gather_kernel(const float* __restrict__ C,
                                    const float* __restrict__ N, long long vp,
                                    const int* __restrict__ node_ixs,
                                    const int* __restrict__ nbrs,
                                    const int* __restrict__ deg, int d,
                                    unsigned chunks, float* __restrict__ Cb,
                                    float* __restrict__ qb,
                                    float* __restrict__ Nb,
                                    float* __restrict__ nr) {
  extern __shared__ int nb_s[];
  const long long node = blockIdx.x / chunks;
  const unsigned chunk = blockIdx.x % chunks;
  const int* row = nbrs + node * d;
  const int x = node_ixs[node];
  const int dg = deg[node];
  if (STAGED) {
    for (int a = threadIdx.x; a < d; a += blockDim.x)
      nb_s[a] = a < dg ? row[a] : x;
    __syncthreads();
  }
  auto nb = [&](int a) -> int {
    if (STAGED) return nb_s[a];
    return a < dg ? row[a] : x;
  };
  const long long dd = (long long)d * d;
  const long long e0 = (long long)chunk * CHUNK;
  const long long e1 = min(e0 + CHUNK, dd);
  const long long out = node * dd;
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const int j = (int)(e / d);
    const int k = (int)(e - (long long)j * d);
    const long long off = (long long)nb(j) * vp + nb(k);
    Cb[out + e] = C[off];
    if (TWO) Nb[out + e] = N[off];
  }
  if (chunk == 0) {
    const long long xrow = (long long)x * vp;
    for (int k = threadIdx.x; k < d; k += blockDim.x) {
      qb[node * d + k] = C[xrow + nb(k)];
      if (TWO) nr[node * d + k] = N[xrow + nb(k)];
    }
  }
}

template <bool TWO>
int launch(const float* C, const float* N, long long vp, const int* node_ixs,
           const int* nbrs, const int* deg, int nt, int d, float* Cb, float* qb,
           float* Nb, float* nr, cudaStream_t stream) {
  // one-dimensional grid: node-major, then the node's chunks
  const long long chunks = ((long long)d * d + CHUNK - 1) / CHUNK;
  if (chunks * nt > 2147483647LL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(chunks * nt);
  if (d <= STAGE_MAX) {
    panel_gather_kernel<TWO, true><<<grid, THREADS, (size_t)d * sizeof(int), stream>>>(
        C, N, vp, node_ixs, nbrs, deg, d, (unsigned)chunks, Cb, qb, Nb, nr);
  } else {
    panel_gather_kernel<TWO, false><<<grid, THREADS, 0, stream>>>(
        C, N, vp, node_ixs, nbrs, deg, d, (unsigned)chunks, Cb, qb, Nb, nr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C (and N, or null for one panel) (vp, vp) f32; node_ixs (nt,), nbrs (nt, d)
// int32 with every entry in [0, vp), deg (nt,) int32 (slots j >= deg read as
// the node), all contiguous on the device. Writes Cb
// (nt, d, d), qb (nt, d) and, with N, Nb and nr of the same shapes. A launch
// holds at most 2^31 - 1 CTAs (nt * ceil(d * d / 4096)); more is refused with
// cudaErrorInvalidValue. Returns the cudaError_t of the launch.
int panel_gather_launch(const float* C, const float* N, long long vp,
                        const int* node_ixs, const int* nbrs, const int* deg,
                        int nt, int d, float* Cb, float* qb, float* Nb,
                        float* nr, void* stream) {
  if (nt <= 0 || d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N != nullptr)
    return launch<true>(C, N, vp, node_ixs, nbrs, deg, nt, d, Cb, qb, Nb, nr,
                        st);
  return launch<false>(C, N, vp, node_ixs, nbrs, deg, nt, d, Cb, qb, Nb, nr,
                       st);
}

}  // extern "C"
