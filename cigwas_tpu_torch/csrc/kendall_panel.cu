// Kendall tau-b npn correlations of a block's markers on NVIDIA Hopper
// (sm_90a), straight from the packed 2-bit genotypes:
//     out[i][j] = sin(pi/2 * tau_b(i, j))   for markers i, j < m,
// tau_b from the 3x3 contingency table of the genotype values {0, 1, 2} of
// markers i and j over the samples where both are called.
//
// Replaces no Pallas kernel: the JAX package builds these tables with XLA's
// int8 `dot` of decoded one-hots (`cigwas_tpu/ops/corr.py`), and the port
// did the same through `torch._int_mm` (cuBLAS) over a (3 m, n) int8 one-hot
// decoded into device memory, a product of every row stripe against every
// marker, int32 counts added over sample chunks and ~40 float32 passes.
//
// What bounds it: int8 tensor-core operations. The counts of the distinct
// pairs are 3 m (3 m + 1) n multiply-adds at 1,979 TOP/s; the bytes are the
// packed codes, 2 bits a sample. The design:
//   - persistent: one CTA an SM walks the 64-marker tile pairs (I, J) with
//     I <= J; the counts are symmetric, so the lower triangle of tiles is
//     never computed, and its values are written from the upper one's;
//   - a producer thread keeps PS stages of packed bytes in flight (TMA, a
//     64-row x 32-byte box of the I tile and one of the J tile a stage of
//     128 samples, mbarrier completion); rows past m and bytes past the row
//     come back as zeros;
//   - a decoder warpgroup expands the J tile's codes into the int8 one-hot
//     B operand in shared memory (192 rows: channel b of marker j is row
//     64 b + j; K-major, no swizzle), codes of samples >= n set no channel;
//     the one-hot never reaches device memory;
//   - consumer warpgroup a (a = 0, 1, 2) expands channel a of the I tile's
//     codes straight into wgmma's A register fragment and accumulates
//     m64 n192 k32 s8 products in 96 int32 registers a thread: the counts
//     of (I channel a, J channel b) for every marker pair of the tiles;
//   - after the K loop over all samples, consumers 1 and 2 stage their
//     counts in shared memory and consumer 0 holds the nine counts of each
//     pair, converts them to float32 and writes out[i][j] from them and,
//     off the diagonal of tiles, out[j][i] from the transposed nine, each
//     in the plain version's order of operations (`_kendall_from_counts`):
//     no count matrix reaches device memory.
// The arithmetic repeats the plain version bit for bit: exact integer
// counts, IEEE division and sqrtf (no fast math, -fmad=false), p, q, t and
// u summed left to right, sinf(1.5707964f * tau).
//
// Channels follow `geno_onehot`: codes 11 / 10 / 00 (values 0 / 1 / 2) are
// channels 0 / 1 / 2; 01 (missing) sets none.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                 // markers a tile
constexpr int NB = 3 * TILE;             // one-hot rows of a J tile: wgmma's n
constexpr int KS = 128;                  // samples a stage
constexpr int KB = KS / 4;               // packed bytes of a row a stage
constexpr int HS = 4;                    // one-hot stages
constexpr int PS = 7;                    // packed stages
constexpr int LEAD = PS - HS;            // stages loaded ahead of the decode
constexpr int CONSUMERS = 3;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ACC = NB / 2;              // int32 accumulators a consumer thread
constexpr int ONEHOT_BYTES = NB * KS;
constexpr int PACK_BYTES = TILE * KB;
constexpr uint32_t LBO = 128;            // bytes between core matrices along K
constexpr uint32_t SBO = 128 * (KS / 16);  // bytes between 8-row groups along n
constexpr uint32_t EVEN = 0x55555555u;

struct Smem {
  uint8_t onehot[HS][ONEHOT_BYTES];
  uint8_t pack_i[PS][PACK_BYTES];
  uint8_t pack_j[PS][PACK_BYTES];
  int staged[CONSUMERS - 1][ACC][128];
  uint64_t tma_full[PS];
  uint64_t dec_full[HS];
  uint64_t empty[HS];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // + the base's alignment to 1 KiB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// K-major operand without swizzle: 8-row x 16-byte core matrices, LBO
// apart along K, SBO apart along n
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | (uint64_t)(LBO >> 4) << 16
         | (uint64_t)(SBO >> 4) << 32;
}

template <int A>
__device__ __forceinline__ uint32_t channel(uint32_t x) {
  // a 1 at bit 2k where sample k of the word holds channel A
  if (A == 0) return x & (x >> 1) & EVEN;   // 11
  if (A == 1) return (x >> 1) & ~x & EVEN;  // 10
  return ~(x | (x >> 1)) & EVEN;            // 00
}

// the bits 0, 2, 4, 6 of b (b < 256) as the bytes 0..3 of a word, 0 or 1 each
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  return (b * 0x41041u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t byte_of(uint32_t x, uint32_t sel) {
  return __byte_perm(x, 0u, sel);  // sel = 0x4440 | k: byte k of x in byte 0, zeros above
}

__device__ __forceinline__ void pair_of(int p, int tiles, int& I, int& J) {
  I = 0;
  while (p >= tiles - I) {
    p -= tiles - I;
    ++I;
  }
  J = I + p;
}

__device__ __forceinline__ void fence_acc(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n192k32(int (&d)[96], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
      "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
      "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
      "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// sin(pi/2 tau_b) from the nine counts s[3 a + b] = #(row marker in channel
// a, column marker in channel b), in `_kendall_from_counts`' order
__device__ __forceinline__ float npn_from_counts(const float (&s)[9]) {
  const float p = s[0] * (s[4] + s[5] + s[7] + s[8]) + s[1] * (s[5] + s[8])
                  + s[3] * (s[7] + s[8]) + s[4] * s[8];
  const float q = s[1] * (s[3] + s[6]) + s[2] * (s[3] + s[4] + s[6] + s[7]) + s[4] * s[6]
                  + s[5] * (s[6] + s[7]);
  const float t = s[0] * (s[1] + s[2]) + s[1] * s[2] + s[3] * (s[4] + s[5]) + s[4] * s[5]
                  + s[6] * (s[7] + s[8]) + s[7] * s[8];
  const float u = s[0] * (s[3] + s[6]) + s[1] * (s[4] + s[7]) + s[2] * (s[5] + s[8])
                  + s[3] * s[6] + s[4] * s[7] + s[5] * s[8];
  const float tau = (p - q) / sqrtf((p + q + t) * (p + q + u));
  return sinf(1.5707964f * tau);
}

// out[gi][gj] from the counts of (gi, gj) and, where both, out[gj][gi] from
// their transpose
__device__ __noinline__ void write_pair(float* out, long long ldc, int gi, int gj, bool both,
                                        int c0, int c1, int c2, int c3, int c4, int c5, int c6,
                                        int c7, int c8) {
  const float s[9] = {(float)c0, (float)c1, (float)c2, (float)c3, (float)c4,
                      (float)c5, (float)c6, (float)c7, (float)c8};
  out[(long long)gi * ldc + gj] = npn_from_counts(s);
  if (both) {
    const float st[9] = {s[0], s[3], s[6], s[1], s[4], s[7], s[2], s[5], s[8]};
    out[(long long)gj * ldc + gi] = npn_from_counts(st);
  }
}

struct Params {
  int m, n, tiles, pairs, nk;
  float* out;
  long long ldc;
};

// The producer thread and the decoder warpgroup (threads 384..511).
__device__ void decoder(Smem& sm, const CUtensorMap* map, const Params& P) {
  const int tid = threadIdx.x - 128 * CONSUMERS;
  const bool leader = tid == 0;
  const int mine = P.pairs > (int)blockIdx.x ? (P.pairs - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * P.nk;
  // the load cursor: step ls is stage lk of tile pair lp
  int ls = 0, lk = 0, lp = blockIdx.x, lI = 0, lJ = 0;
  if (mine) pair_of(lp, P.tiles, lI, lJ);
  auto issue = [&]() {
    const int slot = ls % PS;
    mbar_expect_tx(&sm.tma_full[slot], 2 * PACK_BYTES);
    tma_load_2d(sm.pack_i[slot], map, &sm.tma_full[slot], lk * KB, lI * TILE);
    tma_load_2d(sm.pack_j[slot], map, &sm.tma_full[slot], lk * KB, lJ * TILE);
    ++ls;
    if (++lk == P.nk) {
      lk = 0;
      lp += gridDim.x;
      if (lp < P.pairs) pair_of(lp, P.tiles, lI, lJ);
    }
  };
  if (leader)
    while (ls < total && ls < LEAD) issue();
  int k = 0;  // the decoded step's stage within its tile
  for (int s = 0; s < total; ++s) {
    const int h = s % HS, pk = s % PS;
    // the one-hot slot and the packed slot LEAD steps on are free once the
    // consumers are done with step s - HS
    mbar_wait(&sm.empty[h], ((s / HS) & 1) ^ 1);
    if (leader && ls < total) issue();
    mbar_wait(&sm.tma_full[pk], (s / PS) & 1);
    const uint8_t* src = sm.pack_j[pk];
    uint8_t* dst = sm.onehot[h];
#pragma unroll
    for (int pass = 0; pass < (TILE * KB / 4) / 128; ++pass) {
      const int q = pass * 128 + tid;
      const int r = q & 7;                                    // row within a core matrix
      const int c = ((q >> 3) & 3) | ((q >> 8) << 2);         // 16-sample chunk
      const int g = (q >> 5) & 7;                             // 8-marker group
      const int j = 8 * g + r;
      const uint32_t x = *reinterpret_cast<const uint32_t*>(src + j * KB + 4 * c);
      const int left = P.n - (k * KS + 16 * c);               // samples of the word < n
      const uint32_t valid = left >= 16 ? EVEN : left <= 0 ? 0u : ((1u << (2 * left)) - 1u) & EVEN;
      const uint32_t ch[3] = {channel<0>(x) & valid, channel<1>(x) & valid,
                              channel<2>(x) & valid};
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const uint4 v = make_uint4(spread4(byte_of(ch[b], 0x4440)), spread4(byte_of(ch[b], 0x4441)),
                                   spread4(byte_of(ch[b], 0x4442)), spread4(byte_of(ch[b], 0x4443)));
        // one-hot row 64 b + j: core group 8 b + g, row r, chunk c
        *reinterpret_cast<uint4*>(dst + (8 * b + g) * SBO + c * LBO + 16 * r) = v;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&sm.dec_full[h]);
    if (++k == P.nk) k = 0;
  }
}

// channel A of the I tile's codes in rows r0 and r0 + 8 of a stage as
// wgmma's A fragments of its four k32 steps: step q's samples 32 q + 4 t ..
// + 3 are byte t of word 2 q, and 32 q + 16 + 4 t .. byte t of word 2 q + 1
template <int A>
__device__ __forceinline__ void build_a(const uint8_t* pack, int r0, uint32_t sel,
                                        uint32_t (&a)[16]) {
  const uint4* rowa = reinterpret_cast<const uint4*>(pack + r0 * KB);
  const uint4* rowb = reinterpret_cast<const uint4*>(pack + (r0 + 8) * KB);
  const uint4 xa0 = rowa[0], xa1 = rowa[1], xb0 = rowb[0], xb1 = rowb[1];
  const uint32_t xa[8] = {xa0.x, xa0.y, xa0.z, xa0.w, xa1.x, xa1.y, xa1.z, xa1.w};
  const uint32_t xb[8] = {xb0.x, xb0.y, xb0.z, xb0.w, xb1.x, xb1.y, xb1.z, xb1.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[4 * q + 0] = spread4(byte_of(channel<A>(xa[2 * q]), sel));
    a[4 * q + 1] = spread4(byte_of(channel<A>(xb[2 * q]), sel));
    a[4 * q + 2] = spread4(byte_of(channel<A>(xa[2 * q + 1]), sel));
    a[4 * q + 3] = spread4(byte_of(channel<A>(xb[2 * q + 1]), sel));
  }
}

// One stage of a consumer: channel A of the stage's I codes into wgmma's A
// fragments, the four k32 products against the stage's one-hot, then the
// stage's slots released. (Building the next stage's fragments while the
// products run needs 16 more registers a thread: at the 128 that 512
// threads leave, that spilled and ran 1% slower.)
template <int A>
__device__ __forceinline__ void run_stage(Smem& sm, int (&d)[ACC], int s, int r0, uint32_t sel,
                                          int lane) {
  const int h = s % HS, pk = s % PS;
  mbar_wait(&sm.tma_full[pk], (s / PS) & 1);
  uint32_t a[16];
  build_a<A>(sm.pack_i[pk], r0, sel, a);
  mbar_wait(&sm.dec_full[h], (s / HS) & 1);
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wgmma_m64n192k32(d, a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3],
                     smem_desc(sm.onehot[h] + q * 2 * LBO));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
  __syncwarp();
  if (lane == 0) mbar_arrive(&sm.empty[h]);
}

// Consumer warpgroup A (threads 128 A .. 128 A + 127).
template <int A>
__device__ void consumer(Smem& sm, const Params& P) {
  const int tid = threadIdx.x - 128 * A;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t sel = 0x4440u | (uint32_t)t;
  const int r0 = 16 * warp + g;  // the thread's rows of the I tile: r0, r0 + 8
  int d[ACC];
  int s = 0;
  if (A == 0) named_arrive(2, 128 * CONSUMERS);  // the staging area starts free
  for (int p = blockIdx.x; p < P.pairs; p += gridDim.x) {
    int I, J;
    pair_of(p, P.tiles, I, J);
#pragma unroll
    for (int i = 0; i < ACC; ++i) d[i] = 0;
    for (int k = 0; k < P.nk; ++k) run_stage<A>(sm, d, s++, r0, sel, lane);
    // epilogue: accumulator k of a thread holds the counts of I row
    // r0 + 8 ((k >> 1) & 1), J column n = 8 (k >> 2) + 2 t + (k & 1), that
    // is J channel n / 64 and marker n % 64
    if (A != 0) {
      named_sync(2, 128 * CONSUMERS);
#pragma unroll
      for (int i = 0; i < ACC; ++i) sm.staged[A - 1][i][tid] = d[i];
      named_arrive(1, 128 * CONSUMERS);
    } else {
      named_sync(1, 128 * CONSUMERS);
      const bool both = I != J;
#pragma unroll
      for (int jc = 0; jc < 8; ++jc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gi = I * TILE + r0 + 8 * (e >> 1);
          const int gj = J * TILE + 8 * jc + 2 * t + (e & 1);
          const int k0 = 4 * jc + e, k1 = k0 + 32, k2 = k0 + 64;  // J channels 0, 1, 2
          if (gi < P.m && gj < P.m)
            write_pair(P.out, P.ldc, gi, gj, both, d[k0], d[k1], d[k2],
                       sm.staged[0][k0][tid], sm.staged[0][k1][tid], sm.staged[0][k2][tid],
                       sm.staged[1][k0][tid], sm.staged[1][k1][tid], sm.staged[1][k2][tid]);
        }
      }
      if (p + (int)gridDim.x < P.pairs) named_arrive(2, 128 * CONSUMERS);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
kendall_int8_panel_kernel(const __grid_constant__ CUtensorMap map, const Params P) {
  extern __shared__ uint8_t raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    for (int i = 0; i < PS; ++i) mbar_init(&sm.tma_full[i], 1);
    for (int i = 0; i < HS; ++i) {
      mbar_init(&sm.dec_full[i], 4);              // a decoder warp each
      mbar_init(&sm.empty[i], 4 * CONSUMERS);     // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    decoder(sm, &map, P);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    if (wg == 0)
      consumer<0>(sm, P);
    else if (wg == 1)
      consumer<1>(sm, P);
    else
      consumer<2>(sm, P);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda the process has loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

}  // namespace

extern "C" {

// codes (m, ld) uint8 on the device, row-major: the packed 2-bit genotypes
// of m markers, LSB-first, the first ceil(n / 4) bytes of each row read;
// ld a multiple of 16 and codes 16-byte aligned (TMA's rules). Writes
// out[i * ldc + j] for i, j < m (float32); nothing else of out. A shape
// or an alignment the kernel does not take is cudaErrorInvalidValue; no
// cuTensorMapEncodeTiled in libcuda, cudaErrorNotSupported. Returns the
// cudaError_t of the launch.
int kendall_panel_launch(const unsigned char* codes, long long m, long long ld, long long n,
                         float* out, long long ldc, void* stream) {
  if (m <= 0) return 0;
  const long long nbytes = (n + 3) / 4;
  if (n <= 0 || n > (1LL << 30) || m > (1LL << 30) || ld < nbytes || ld % 16 != 0
      || reinterpret_cast<uintptr_t>(codes) % 16 != 0 || ldc < m)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)nbytes, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {KB, TILE};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<unsigned char*>(codes), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
      != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kendall_int8_panel_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Params P;
  P.m = (int)m;
  P.n = (int)n;
  P.tiles = (int)((m + TILE - 1) / TILE);
  P.pairs = P.tiles * (P.tiles + 1) / 2;
  P.nk = (int)((n + KS - 1) / KS);
  P.out = out;
  P.ldc = ldc;
  const int grid = P.pairs < sms ? P.pairs : sms;
  kendall_int8_panel_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
