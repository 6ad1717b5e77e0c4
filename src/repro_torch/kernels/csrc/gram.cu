// K1: fused shifted Gram  G = A^T A + c_eff I  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py::_gram_kernel
// (gram_kernel_call).  A is (m, n); G is (n, n) row-major f32 with f32
// sums.  Two kernels, one per route (the wrapper, kernels/gram.py, picks
// the route from A's dtype and shape before the launch), and one shared
// shift epilogue:
//
// * gram_tiles (route "simt"): f32 A, row-major with row stride lda.
//   Every product and sum is a true f32 FFMA (no TF32: the f32 kappa
//   envelope assumes f32 products).  Bound on the H100: operations, G's
//   upper triangle is m n (n + 1) flops: 26 ms at m = n = 11,999 at the
//   67 TFLOP/s f32 rate outside the tensor cores.  Design: one block per
//   128 x 128 tile of the upper triangle (an off-diagonal tile is also
//   written mirrored); the TPU's sequential k grid axis is an in-block
//   loop over 16-row chunks of A, double-buffered in shared memory with
//   the next chunk prefetched into registers; 256 threads with 8 x 8 f32
//   register tiles fed by conflict-free float4 shared-memory reads; every
//   global load coalesced along n, ragged edges masked.
//
// * gram_bf16 (route "wgmma"): bf16 A, row-major or column-major, with a
//   leading dimension that is a multiple of 8 elements and a 16-byte
//   aligned base (the wrapper stages any other A once).  bf16 products
//   summed in f32 on the tensor cores.  Bound: operations, m n (n + 1)
//   flops at the 989 TFLOP/s bf16 rate: 1.75 ms at 11,999^2.  Design:
//     - one block per 128 x 256 tile (i0, j0) of G that holds an element
//       of the upper triangle (i0 <= j0 + 128): the product of two column
//       blocks of the one tensor A, (A[k, i0 + :128])^T A[k, j0 + :256];
//       tiles are visited in groups of 8 tile rows, column by column, so
//       concurrent blocks share their column blocks of A in L2;
//     - a 4-stage ring of 64-deep stages loaded by TMA with the 128-byte
//       swizzle from one tensor map over A (64 x 64 boxes; one producer
//       warp): for row-major A both operands are MN-major (the transpose
//       bits), for column-major A both are K-major; the ragged k and n
//       edges are TMA's zero fill;
//     - on a tile that straddles the diagonal (i0 = j0 or j0 + 128) the
//       A operand is a slice of the B tile already in shared memory, so
//       only the 256 columns are loaded;
//     - two consumer warpgroups each multiply a 64 x 256 half with wgmma
//       m64n256k16, one wgmma group kept in flight while the previous
//       stage is released (as K3's bf16 route);
//     - epilogue: the upper-triangle part of the tile (col >= row) is
//       stored straight from the registers; the tile is then staged
//       transposed through the (drained) ring and every element with
//       col > row is written to G[col][row] as whole coalesced rows, so G
//       is exactly symmetric.
//
// Shift clamp, global semantics (the engine's zolo._clamp_shift): a
// positive c is raised to >= 8 eps(f32) max_i G[i][i] over the WHOLE
// diagonal.  The Pallas kernel clamped against its own 256 x 256 tile,
// which agrees only for n <= 256; here blocks run in parallel, so a
// one-block epilogue kernel (gram_shift) reduces the diagonal after the
// tiles are done and then adds c_eff.  c == 0 and negative c are added
// unchanged.  It runs only when the caller passes a shift (c != NULL).

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 128;    // output tile edge
constexpr int kChunk = 16;    // rows of A per pipeline stage
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLoads = kChunk * kTile / kThreads;  // 8 per operand

__device__ __forceinline__ void load_chunk(const float* __restrict__ a, int m,
                                           int n, long long lda, int k0,
                                           int c0, int tid, float* reg) {
  const int col = c0 + (tid % kTile);
  const int row0 = tid / kTile;
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int row = k0 + row0 + 2 * q;
    reg[q] = (row < m && col < n) ? a[row * lda + col] : 0.0f;
  }
}

__device__ __forceinline__ void store_chunk(float (*s)[kTile], int tid,
                                            const float* reg) {
  const int col = tid % kTile;
  const int row0 = tid / kTile;
#pragma unroll
  for (int q = 0; q < kLoads; ++q) s[row0 + 2 * q][col] = reg[q];
}

__global__ void __launch_bounds__(kThreads)
gram_tiles(const float* __restrict__ a, float* __restrict__ g, int m, int n,
           long long lda, int tiles) {
  // linear block index -> (bi, bj), bi <= bj, row-major over the upper
  // triangle of the tiles x tiles tile grid
  int rem = blockIdx.x;
  int bi = 0;
  while (rem >= tiles - bi) {
    rem -= tiles - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;

  __shared__ __align__(16) float sa[2][kChunk][kTile];
  __shared__ __align__(16) float sb[2][kChunk][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / 16;  // rows    ty*4 .. +3 and 64 + ty*4 .. +3

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float ra[kLoads], rb[kLoads];
  const int chunks = (m + kChunk - 1) / kChunk;
  if (chunks > 0) {
    load_chunk(a, m, n, lda, 0, i0, tid, ra);
    load_chunk(a, m, n, lda, 0, j0, tid, rb);
    store_chunk(sa[0], tid, ra);
    store_chunk(sb[0], tid, rb);
  }
  __syncthreads();

  for (int kc = 0; kc < chunks; ++kc) {
    const int buf = kc & 1;
    const bool more = kc + 1 < chunks;
    if (more) {  // prefetch the next chunk while this one is multiplied
      load_chunk(a, m, n, lda, (kc + 1) * kChunk, i0, tid, ra);
      load_chunk(a, m, n, lda, (kc + 1) * kChunk, j0, tid, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sb[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      // the other buffer was last read in iteration kc - 1, which every
      // thread finished before the barrier that closed it
      store_chunk(sa[buf ^ 1], tid, ra);
      store_chunk(sb[buf ^ 1], tid, rb);
    }
    __syncthreads();
  }

  const bool mirror = bi != bj;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col >= n) continue;
      g[(long long)row * n + col] = acc[i][j];
      if (mirror) g[(long long)col * n + row] = acc[i][j];
    }
  }
}

// One block: c_eff from the global max diagonal, then G[i][i] += c_eff.
__global__ void __launch_bounds__(1024)
gram_shift(float* __restrict__ g, int n, const float* __restrict__ c) {
  __shared__ float part[32];
  float mx = -FLT_MAX;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    mx = fmaxf(mx, g[(long long)i * n + i]);
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = mx;
  __syncthreads();  // every diagonal read is done before any write below
  if (threadIdx.x < 32) {
    mx = threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : -FLT_MAX;
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (threadIdx.x == 0) part[0] = mx;
  }
  __syncthreads();
  const float cv = *c;
  const float floor_ = 8.0f * FLT_EPSILON * fmaxf(part[0], 0.0f);
  const float ce = cv > 0.0f ? fmaxf(cv, floor_) : cv;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    g[(long long)i * n + i] += ce;
}


// Route "simt": the tiles, then the shift epilogue when c != NULL.
int launch_f32(const float* a, float* g, int m, int n, long long lda,
               const float* c, cudaStream_t s) {
  if (n <= 0) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  const int blocks = tiles * (tiles + 1) / 2;
  gram_tiles<<<blocks, kThreads, 0, s>>>(a, g, m, n, lda, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || c == nullptr) return static_cast<int>(err);
  gram_shift<<<1, 1024, 0, s>>>(g, n, c);
  return static_cast<int>(cudaGetLastError());
}

// ---- route "wgmma": bf16 on the tensor cores --------------------------------

constexpr int kBM = 128;  // tile rows of G: two consumer warpgroups of 64
constexpr int kBN = 256;  // tile columns of G: one m64n256 per warpgroup
constexpr int kRatio = kBN / kBM;
constexpr int kBK = 64;   // rows of A (the reduction) per stage: 128 bytes
                          // of bf16, one swizzle row
constexpr int kBox = 64;  // the tensor map's box: 64 x 64 bf16, 8 KB
constexpr int kBoxBytes = kBox * kBK * 2;
constexpr int kWgStages = 4;
constexpr int kABytes = kBM * kBK * 2;           // 16 KB
constexpr int kBBytes = kBN * kBK * 2;           // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;   // 48 KB
constexpr int kWgThreads = 288;  // warps 0-7: two consumer warpgroups;
                                 // warp 8: the TMA producer
constexpr int kConsumers = 256;
constexpr int kGroupRows = 8;    // tile rows per L2 group
constexpr int kMirrorLd = kBM + 4;  // floats a staged column of the tile:
                                    // conflict-free fragment stores
constexpr int kWgSmem = kWgStages * kStageBytes + 2 * kWgStages * 8 + 1024;
static_assert(kBN * kMirrorLd * 4 <= kWgStages * kStageBytes,
              "the transposed tile is staged in the drained ring");

// rows of tile column bj inside row group g: tile (bi, bj) holds an
// element of the upper triangle iff bi kBM <= bj kBN + kBN - 1, i.e.
// bi < (bj + 1) kRatio
__device__ __forceinline__ int group_rows(int g, int bj, int tiles_m) {
  const int lo = g * kGroupRows;
  const int hi = min(min(lo + kGroupRows, tiles_m), (bj + 1) * kRatio);
  return max(hi - lo, 0);
}

// block id -> (bi, bj): the needed tiles in groups of kGroupRows tile rows,
// column by column inside a group, so that concurrent blocks share column
// blocks of A in L2.  A group's first columns are cut by the triangle
// (fewer rows), the rest hold all of its rows.
__device__ __forceinline__ void tile_of(int id, int tiles_m, int tiles_n,
                                        int& bi, int& bj) {
  int rem = id;
  for (int g = 0; g * kGroupRows < tiles_m; ++g) {
    const int lo = g * kGroupRows;
    const int rows = min(kGroupRows, tiles_m - lo);
    int col = lo / kRatio;  // the first column with a row in this group
    for (; col < tiles_n; ++col) {
      const int c = group_rows(g, col, tiles_m);
      if (c == rows) break;
      if (rem < c) {
        bi = lo + rem;
        bj = col;
        return;
      }
      rem -= c;
    }
    const int full = (tiles_n - col) * rows;
    if (rem < full) {
      bi = lo + rem % rows;
      bj = col + rem / rows;
      return;
    }
    rem -= full;
  }
  bi = bj = 0;  // not reached: the grid holds exactly the needed tiles
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// K_MAJOR: A is column-major (A[k][i] at a + i lda + k): both wgmma
// operands are K-major.  Else A is row-major and both are MN-major.
template <bool K_MAJOR>
__global__ void __launch_bounds__(kWgThreads, 1)
gram_bf16(const __grid_constant__ CUtensorMap ta, float* __restrict__ g,
          int m, int n, int tiles_m, int tiles_n) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // swizzled tiles need 1,024-byte alignment
  const uint32_t smem0 = smem_u32(wg_smem);
  const uint32_t base = (smem0 + 1023u) & ~1023u;
  const uint32_t bars = base + kWgStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kWgStages + s); };

  int bi, bj;
  tile_of(blockIdx.x, tiles_m, tiles_n, bi, bj);
  const int i0 = bi * kBM;  // G rows i0 .. + 127: A's columns i0 ..
  const int j0 = bj * kBN;  // G columns j0 .. + 255: A's columns j0 ..
  // the A operand's columns lie inside the B tile's (i0 - j0 is 0 or 128)
  const bool inside = i0 >= j0;
  const int ktiles = (m + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 8) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kWgStages;
        if (kt >= kWgStages) mbar_wait(empty(s), (kt / kWgStages - 1) & 1);
        mbar_expect_tx(full(s), inside ? kBBytes : kStageBytes);
        const uint32_t a_dst = base + s * kStageBytes;
        const uint32_t b_dst = a_dst + kABytes;
        const int k0 = kt * kBK;
        // box c: 64 columns of A (i0 + 64 c ..) by 64 rows (k0 ..); as
        // MN-major k rows of 128 bytes, as K-major column rows of 128 bytes
        if (!inside) {
#pragma unroll
          for (int c = 0; c < kBM / kBox; ++c) {
            if (K_MAJOR)
              tma_load_2d(a_dst + kBoxBytes * c, &ta, full(s), k0,
                          i0 + kBox * c);
            else
              tma_load_2d(a_dst + kBoxBytes * c, &ta, full(s),
                          i0 + kBox * c, k0);
          }
        }
#pragma unroll
        for (int c = 0; c < kBN / kBox; ++c) {
          if (K_MAJOR)
            tma_load_2d(b_dst + kBoxBytes * c, &ta, full(s), k0,
                        j0 + kBox * c);
          else
            tma_load_2d(b_dst + kBoxBytes * c, &ta, full(s), j0 + kBox * c,
                        k0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies G rows i0 + 64 wg .. + 63, whose A
  // operand is the 8 KB box (i0 - j0) / 64 + wg of the B tile when inside
  const int wg = warp / 4;
  const uint32_t a_off =
      (inside ? kABytes + ((i0 - j0) / kBox) * kBoxBytes : 0) +
      wg * kBoxBytes;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kWgStages;
    mbar_wait(full(s), (kt / kWgStages) & 1);
    const uint32_t a_s = base + s * kStageBytes + a_off;
    const uint32_t b_s = base + s * kStageBytes + kABytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (K_MAJOR) {
        wgmma_ss_n256<0, 0>(acc, desc_sw128(a_s + kk * 32, 16, 1024),
                            desc_sw128(b_s + kk * 32, 16, 1024), 1);
      } else {
        wgmma_ss_n256<1, 1>(acc, desc_sw128(a_s + kk * 2048, kBoxBytes, 1024),
                            desc_sw128(b_s + kk * 2048, kBoxBytes, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done ...
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % kWgStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // (1) the tile's upper-triangle part (col >= row), from the registers
  const int w4 = warp % 4;
  const int r_loc = 64 * wg + 16 * w4 + lane / 4;  // + 8 h
  const int c_loc = 2 * (lane % 4);                // + 8 j + e
  const bool pairs = (n % 2) == 0;  // then (row, even col) is 8-byte aligned
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = j0 + 8 * j + c_loc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + r_loc + 8 * h;
      if (row >= n) continue;
      float* dst = g + static_cast<long long>(row) * n + col;
      const float v0 = acc[4 * j + 2 * h];
      const float v1 = acc[4 * j + 2 * h + 1];
      if (pairs && col >= row && col + 1 < n) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (col >= row && col < n) dst[0] = v0;
        if (col + 1 >= row && col + 1 < n) dst[1] = v1;
      }
    }
  }

  // (2) the mirror: every element with col > row goes to G[col][row].  The
  // tile is staged transposed (t[c][r], kMirrorLd floats a column) in the
  // ring, which no wgmma and no TMA load touches any more once every
  // consumer is past its last wait
  consumer_sync();
  float* t = reinterpret_cast<float*>(wg_smem + (base - smem0));
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t[(8 * j + c_loc + e % 2) * kMirrorLd + r_loc + 8 * (e / 2)] =
          acc[4 * j + e];
  consumer_sync();
  // warp w writes G rows j0 + c for c = w, w + 8, ...: 128 consecutive
  // floats of row j0 + c (columns i0 ..) a row, 32 a store instruction
  for (int c = warp; c < kBN; c += kConsumers / 32) {
    const int grow = j0 + c;
    if (grow >= n) break;
    float* dst = g + static_cast<long long>(grow) * n + i0;
#pragma unroll
    for (int q = 0; q < kBM / 32; ++q) {
      const int r = lane + 32 * q;
      if (i0 + r < n && grow > i0 + r) dst[r] = t[c * kMirrorLd + r];
    }
  }
}

template <bool K_MAJOR>
int launch_bf16(const CUtensorMap& ta, float* g, int m, int n,
                const float* c, cudaStream_t s) {
  auto kern = gram_bf16<K_MAJOR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_m = (n + kBM - 1) / kBM;
  const int tiles_n = (n + kBN - 1) / kBN;
  long long blocks = 0;
  for (int bj = 0; bj < tiles_n; ++bj)
    blocks += (bj + 1) * kRatio < tiles_m ? (bj + 1) * kRatio : tiles_m;
  kern<<<static_cast<unsigned>(blocks), kWgThreads, kWgSmem, s>>>(
      ta, g, m, n, tiles_m, tiles_n);
  err = cudaGetLastError();
  if (err != cudaSuccess || c == nullptr) return static_cast<int>(err);
  gram_shift<<<1, 1024, 0, s>>>(g, n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Both launch on `stream`,
// allocate nothing, do not synchronise, and return a cudaError_t code (0
// on success).  g: (n, n) f32, written in full; c: device pointer to one
// f32 shift, or NULL for no shift.

// Route "simt": f32 a (m, n) with row stride lda >= n.
extern "C" int zolo_gram_f32(const void* a, void* g, int m, int n,
                             long long lda, const void* c, void* stream) {
  return launch_f32(static_cast<const float*>(a), static_cast<float*>(g), m,
                    n, lda, static_cast<const float*>(c),
                    static_cast<cudaStream_t>(stream));
}

// Route "wgmma": bf16 a (m, n), m, n >= 1.  a_col = 0: row-major (a[k, i]
// at a + k lda + i, lda >= n); a_col = 1: column-major (a[k, i] at
// a + i lda + k, lda >= m).  lda is a multiple of 8 and a is 16-byte
// aligned.
extern "C" int zolo_gram_bf16_wgmma(const void* a, int a_col, long long lda,
                                    void* g, int m, int n, const void* c,
                                    void* stream) {
  if (m <= 0 || n <= 0 || lda % 8 || lda < (a_col ? m : n) ||
      reinterpret_cast<uintptr_t>(a) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta;
  const uint64_t stride[1] = {static_cast<uint64_t>(lda) * 2};
  const uint32_t box[2] = {kBox, kBox};
  // innermost first: along a row of the storage, then across rows
  const uint64_t dims[2] = {static_cast<uint64_t>(a_col ? m : n),
                            static_cast<uint64_t>(a_col ? n : m)};
  const int err = hopper::encode_bf16_map(&ta, a, 2, dims, stride, box);
  if (err) return err;
  float* gp = static_cast<float*>(g);
  const float* cp = static_cast<const float*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a_col ? launch_bf16<true>(ta, gp, m, n, cp, st)
               : launch_bf16<false>(ta, gp, m, n, cp, st);
}
