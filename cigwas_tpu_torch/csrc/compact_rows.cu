// Row compaction of a bool adjacency on NVIDIA Hopper (sm_90a): for each
// row index r = rows[i] of the (n, n) bool matrix G, write
//     nbrs[i][0 .. d)  the first d columns c with G[r][c] set, ascending,
//                      pad slots (past the row's count) 0
//     deg[i]           the count of set columns of the whole row
// so that the neighbour lists of a level's sweep are built on the device
// from the adjacency that stays there, with nothing of (n, n) size besides
// G itself.
//
// No TPU kernel: the JAX package compacts with an ascending sort of
// where(G, iota, n) along rows, which takes an (n, n) int32 key array and
// the sort's outputs; a warp per row needs neither.
//
// What bounds it: bytes, G's rows read once (n bytes a row) and d + 1
// words written. The design:
//   - one warp per row; each lane takes 16 consecutive columns a pass, a
//     16-byte load where every row starts 16-byte aligned (n % 16 == 0 and
//     G aligned, which the launcher checks), else 16 byte loads; the next
//     pass's load is issued before this pass's ballots;
//   - a lane turns its 16 bytes into a 16-bit mask of set columns; the
//     exclusive prefix of the lanes' counts (each 0..16, five bits) comes
//     from five __ballot_sync bit planes and __popc, the pass's total from
//     the same ballots, so the warp never synchronises otherwise;
//   - each lane writes its set columns at the warp's running count plus its
//     prefix, ascending within the lane by __ffs, while the slot is below d.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS_PER_CTA = 8;
constexpr int COLS_PER_LANE = 16;
constexpr int COLS_PER_PASS = 32 * COLS_PER_LANE;

// 4-bit mask of the nonzero bytes of w (bit k for byte k)
__device__ __forceinline__ unsigned byte_mask(unsigned w) {
  const unsigned m = __vcmpne4(w, 0u) & 0x08040201u;  // byte k keeps bit k alone
  return (m * 0x01010101u) >> 24;                      // the four bytes summed, no carry
}

template <bool VEC>
__global__ void __launch_bounds__(32 * WARPS_PER_CTA)
compact_rows_kernel(const unsigned char* __restrict__ G, long long n,
                    const int* __restrict__ rows, int nr, int d,
                    int* __restrict__ nbrs, int* __restrict__ deg) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (i >= nr) return;  // whole warps leave together
  const unsigned char* row = G + (long long)rows[i] * n;
  int* out = nbrs + i * (long long)d;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;  // set columns of the passes before, the same in every lane
  // VEC: the next pass's 16 bytes are loaded before this pass's ballots, so
  // that each warp keeps two loads in flight (n % 16 == 0: a lane's 16
  // columns lie all in the row or all out)
  uint4 next = make_uint4(0, 0, 0, 0);
  if (VEC && COLS_PER_LANE * lane < n)
    next = __ldg(reinterpret_cast<const uint4*>(row + COLS_PER_LANE * lane));
  for (long long base = 0; base < n; base += COLS_PER_PASS) {
    const long long c0 = base + (long long)COLS_PER_LANE * lane;
    unsigned mask = 0;
    if (VEC) {
      const uint4 v = next;  // zero where c0 >= n
      next = c0 + COLS_PER_PASS < n
                 ? __ldg(reinterpret_cast<const uint4*>(row + c0 + COLS_PER_PASS))
                 : make_uint4(0, 0, 0, 0);
      mask = byte_mask(v.x) | byte_mask(v.y) << 4 | byte_mask(v.z) << 8
             | byte_mask(v.w) << 12;
    } else {
#pragma unroll
      for (int k = 0; k < COLS_PER_LANE; ++k)
        if (c0 + k < n && row[c0 + k]) mask |= 1u << k;
    }
    const int c = __popc(mask);
    int before = 0, total = 0;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const unsigned plane = __ballot_sync(0xffffffffu, (c >> b) & 1);
      before += __popc(plane & below) << b;
      total += __popc(plane) << b;
    }
    for (int slot = count + before; mask && slot < d; ++slot) {
      out[slot] = (int)(c0 + __ffs(mask) - 1);
      mask &= mask - 1;
    }
    count += total;
  }
  for (int slot = count + lane; slot < d; slot += 32) out[slot] = 0;
  if (lane == 0) deg[i] = count;
}

}  // namespace

extern "C" {

// G (n, n) bool (one byte each, 0 or 1) contiguous on the device; rows (nr,)
// int32 in [0, n); writes nbrs (nr, d) and deg (nr,) int32. A grid beyond
// 2^31 - 1 CTAs or a width d < 1 is refused with cudaErrorInvalidValue.
// Returns the cudaError_t of the launch.
int compact_rows_launch(const unsigned char* G, long long n, const int* rows, int nr, int d,
                        int* nbrs, int* deg, void* stream) {
  if (nr <= 0) return 0;
  if (d < 1) return (int)cudaErrorInvalidValue;
  const long long ctas = (nr + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
  if (ctas > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % COLS_PER_LANE == 0
                   && reinterpret_cast<unsigned long long>(G) % 16 == 0;
  if (vec)
    compact_rows_kernel<true><<<(unsigned)ctas, 32 * WARPS_PER_CTA, 0, st>>>(
        G, n, rows, nr, d, nbrs, deg);
  else
    compact_rows_kernel<false><<<(unsigned)ctas, 32 * WARPS_PER_CTA, 0, st>>>(
        G, n, rows, nr, d, nbrs, deg);
  return (int)cudaGetLastError();
}

}  // extern "C"
