// K1: fused shifted Gram  G = A^T A + c_eff I  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py::_gram_kernel
// (gram_kernel_call).  A is (m, n); G is (n, n) row-major f32 with f32
// sums.  Two kernels, one per route (the wrapper, kernels/gram.py, picks
// the route from A's dtype before the launch), and one shared shift
// epilogue:
//
// * gram_slices (route "simt"): f32 A, row-major or column-major.  Every
//   product and sum is a true f32 FFMA (no TF32: the f32 kappa envelope
//   assumes f32 products).  Bound on the H100: operations, G's upper
//   triangle is m n (n + 1) flops: 26 ms at m = n = 11,999 at the 67
//   TFLOP/s f32 rate outside the tensor cores.  Design: one block per
//   (TILE x TILE tile of the upper triangle, slice of m); an off-diagonal
//   tile is also written mirrored.  The wrapper's rule
//   (kernels/gram.py::gram_split) picks S <= 8 slices of m, each a whole
//   number of 16-row chunks, in order: S = 1 on 128-wide tiles where the
//   upper triangle alone fills the card (the large solves, n = 11,999 and
//   n = 4,096), S > 1 on 64-wide tiles where it would leave the 132 SMs
//   under two resident waves (ZoloMuon's n <= ~2,900, and a narrow G,
//   n = 64).  Grid (tile pairs, S); for S > 1 the S blocks of one tile form
//   a thread-block cluster (1, S, 1).  The TPU's sequential k grid axis is
//   an in-block loop over the slice's 16-row chunks, double-buffered in
//   shared memory with the next chunk prefetched into registers; (TILE /
//   8)^2 threads of 8 x 8 outputs (4 conflict-free float4 shared loads per
//   64 FFMAs at either edge: 256 threads at 128^2, 64 at 64^2).  A is read
//   as it lies: row-major along n (a float4 of 4 columns), column-major
//   along k (A[k][i] at a + i lda + k, a float4 of 4 rows of one column,
//   four threads a column's 16 chunk rows; the CholeskyQR2 second pass
//   hands K1 Q1 and Q2 as transposed views); float4 loads where the
//   leading dimension is a multiple of 4 and the base 16-byte aligned,
//   else masked scalar loads of the same addresses (a row-major A at n =
//   11,999; the wrapper copies a column-major one row-major at S = 1,
//   where the scalar column loads measured slower than the copy), every
//   warp's loads coalesced, ragged edges masked.  S > 1: each block parks
//   its partial tile in shared memory (over the drained pipeline buffers)
//   and after a cluster barrier sums 1/S of the tile across the cluster's
//   distributed shared memory in rank (= slice) order, writing it and its
//   mirror.  No float atomics: G is bitwise the same from launch to
//   launch, and exactly symmetric (a diagonal tile's (r, c) and (c, r)
//   partials are the same FFMAs in the same order).  Launch bounds (256,
//   2) at 128^2 and (64, 8) at 64^2 fix the blocks an SM holds, which the
//   rule's wave count assumes (zolo_gram_f32_resident reads it back on the
//   card).
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
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 16;    // rows of A per pipeline stage

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


// ---- route "simt": f32 on the FFMA units, split over m -----------------------

constexpr int kMaxCluster = 8;  // portable cluster size: slices of one tile

// One block per (tile pair, slice): (TILE / 8)^2 threads, each summing an
// 8 x 8 register tile (rows ty*4 .. +3 and TILE/2 + ty*4 .. +3, columns
// likewise with tx), so every k step is 4 float4 shared loads for 64 FFMAs
// at either tile edge.  A chunk is 16 rows of A's TILE columns per operand,
// loaded as float4s: row-major along n (a float4 of 4 columns), column-major
// along k (a float4 of 4 rows of one column).
template <int TILE>
struct SliceShape {
  static constexpr int kThreads = (TILE / 8) * (TILE / 8);
  static constexpr int kVecs = 4 * TILE / kThreads;  // float4s a chunk
  static constexpr int kRowPass = kThreads / (TILE / 4);  // rows a pass
  static constexpr int kColPass = kThreads / 4;  // columns a pass
  static constexpr int kPipe = 2 * 2 * kChunk * TILE;     // floats: sa, sb
  static constexpr int kPart = TILE * TILE;               // floats: a tile
  static constexpr int kSmem = 4 * (kPipe > kPart ? kPipe : kPart);
  static constexpr int kResident = TILE == 128 ? 2 : 8;   // blocks an SM
};

// rows k0 .. k0 + 15 (below k_end) of A's columns c0 .. c0 + TILE - 1 into
// registers, 4 a float4 (vector loads where `vec` says A's leading
// dimension and base allow them and the 4 lie inside A; masked scalars at
// the ragged edges)
template <int TILE, bool COL>
__device__ __forceinline__ void slice_load(const float* __restrict__ a,
                                           int n, long long lda, int k0,
                                           int k_end, int c0, int tid,
                                           bool vec, float4* reg) {
  using S = SliceShape<TILE>;
#pragma unroll
  for (int q = 0; q < S::kVecs; ++q) {
    float v[4];
    if constexpr (!COL) {
      const int row = k0 + tid / (TILE / 4) + S::kRowPass * q;
      const int col = c0 + 4 * (tid % (TILE / 4));
      const float* src = a + row * lda + col;
      if (vec && row < k_end && col + 3 < n) {
        reg[q] = *reinterpret_cast<const float4*>(src);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (row < k_end && col + e < n) ? src[e] : 0.0f;
    } else {
      const int col = c0 + tid / 4 + S::kColPass * q;
      const int k = k0 + 4 * (tid % 4);
      const float* src = a + col * lda + k;
      if (vec && col < n && k + 3 < k_end) {
        reg[q] = *reinterpret_cast<const float4*>(src);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (col < n && k + e < k_end) ? src[e] : 0.0f;
    }
    reg[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// the registers of slice_load into one [kChunk][TILE] buffer
template <int TILE, bool COL>
__device__ __forceinline__ void slice_store(float* s, int tid,
                                            const float4* reg) {
  using S = SliceShape<TILE>;
#pragma unroll
  for (int q = 0; q < S::kVecs; ++q) {
    if constexpr (!COL) {
      *reinterpret_cast<float4*>(
          &s[(tid / (TILE / 4) + S::kRowPass * q) * TILE +
             4 * (tid % (TILE / 4))]) = reg[q];
    } else {
      const int col = tid / 4 + S::kColPass * q;
      const int k = 4 * (tid % 4);
      s[k * TILE + col] = reg[q].x;
      s[(k + 1) * TILE + col] = reg[q].y;
      s[(k + 2) * TILE + col] = reg[q].z;
      s[(k + 3) * TILE + col] = reg[q].w;
    }
  }
}

// grid (tile pairs of the upper triangle, S slices); for S > 1 launched as
// clusters of (1, S, 1), so a cluster is one tile's S slices, rank = slice
template <int TILE, bool COL>
__global__ void __launch_bounds__(SliceShape<TILE>::kThreads,
                                  SliceShape<TILE>::kResident)
gram_slices(const float* __restrict__ a, float* __restrict__ g, int m, int n,
            long long lda, int tiles, int rows_per, int vec) {
  using S = SliceShape<TILE>;
  constexpr int kHalf = TILE / 2;
  extern __shared__ __align__(16) float sm[];
  float* sa = sm;                        // [2][kChunk][TILE]
  float* sb = sm + 2 * kChunk * TILE;    // [2][kChunk][TILE]

  int rem = blockIdx.x;
  int bi = 0;
  while (rem >= tiles - bi) {
    rem -= tiles - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;
  const int k_lo = blockIdx.y * rows_per;
  const int k_hi = min(m, k_lo + rows_per);

  const int tid = threadIdx.x;
  const int tx = tid % (TILE / 8);  // columns tx*4 .. +3, kHalf + tx*4 ..
  const int ty = tid / (TILE / 8);  // rows    ty*4 .. +3, kHalf + ty*4 ..

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra[S::kVecs], rb[S::kVecs];
  const int chunks = k_hi > k_lo ? (k_hi - k_lo + kChunk - 1) / kChunk : 0;
  if (chunks > 0) {
    slice_load<TILE, COL>(a, n, lda, k_lo, k_hi, i0, tid, vec, ra);
    slice_load<TILE, COL>(a, n, lda, k_lo, k_hi, j0, tid, vec, rb);
    slice_store<TILE, COL>(sa, tid, ra);
    slice_store<TILE, COL>(sb, tid, rb);
  }
  __syncthreads();

  for (int kc = 0; kc < chunks; ++kc) {
    const int buf = kc & 1;
    const bool more = kc + 1 < chunks;
    if (more) {  // prefetch the next chunk while this one is multiplied
      const int k0 = k_lo + (kc + 1) * kChunk;
      slice_load<TILE, COL>(a, n, lda, k0, k_hi, i0, tid, vec, ra);
      slice_load<TILE, COL>(a, n, lda, k0, k_hi, j0, tid, vec, rb);
    }
    const float* ca = sa + buf * kChunk * TILE;
    const float* cb = sb + buf * kChunk * TILE;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&ca[kk * TILE + ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&ca[kk * TILE + kHalf + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&cb[kk * TILE + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&cb[kk * TILE + kHalf + tx * 4]);
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
      slice_store<TILE, COL>(sa + (buf ^ 1) * kChunk * TILE, tid, ra);
      slice_store<TILE, COL>(sb + (buf ^ 1) * kChunk * TILE, tid, rb);
    }
    __syncthreads();
  }

  const bool mirror = bi != bj;
  if (gridDim.y == 1) {  // one slice: the block's sums are G's values
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = i0 + (i < 4 ? ty * 4 + i : kHalf + ty * 4 + (i - 4));
      if (row >= n) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j0 + (j < 4 ? tx * 4 + j : kHalf + tx * 4 + (j - 4));
        if (col >= n) continue;
        g[(long long)row * n + col] = acc[i][j];
        if (mirror) g[(long long)col * n + row] = acc[i][j];
      }
    }
    return;
  }

  // S > 1: park the partial tile over the drained pipeline buffers (the
  // loop's last barrier closed every read of them)
  float* part = sm;  // [TILE][TILE]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i < 4 ? ty * 4 + i : kHalf + ty * 4 + (i - 4);
    *reinterpret_cast<float4*>(&part[r * TILE + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&part[r * TILE + kHalf + tx * 4]) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every slice's partial tile is in place
  const int slices = gridDim.y;
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int kUnits = TILE * TILE / 4;  // float4s of a tile
  const int lo = rank * kUnits / slices;
  const int hi = (rank + 1) * kUnits / slices;
  for (int u = lo + tid; u < hi; u += S::kThreads) {
    // this share of the tile, summed over the slices in rank order
    float4 v = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0))[u];
    for (int s = 1; s < slices; ++s) {
      const float4 w = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, s))[u];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int row = i0 + u / (TILE / 4);
    if (row >= n) continue;
    const int col0 = j0 + (u % (TILE / 4)) * 4;
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + e;
      if (col >= n) continue;
      g[(long long)row * n + col] = vv[e];
      if (mirror) g[(long long)col * n + row] = vv[e];
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int TILE, bool COL>
cudaError_t set_slices_smem() {
  constexpr int bytes = SliceShape<TILE>::kSmem;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(gram_slices<TILE, COL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Route "simt": the tiles in S slices, then the shift epilogue when
// c != NULL (after the full sum: the clamp reads the summed diagonal)
template <int TILE, bool COL>
int launch_slices(const float* a, float* g, int m, int n, long long lda,
                  int slices, int rows_per, const float* c, cudaStream_t s) {
  using S = SliceShape<TILE>;
  cudaError_t err = set_slices_smem<TILE, COL>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + TILE - 1) / TILE;
  const long long pairs = static_cast<long long>(tiles) * (tiles + 1) / 2;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec =
      lda % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pairs), slices, 1);
  cfg.blockDim = dim3(S::kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = slices > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, gram_slices<TILE, COL>, a, g, m, n, lda,
                           tiles, rows_per, vec);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || c == nullptr) return static_cast<int>(err);
  gram_shift<<<1, 1024, 0, s>>>(g, n, c);
  return static_cast<int>(cudaGetLastError());
}

template <int TILE, bool COL>
int resident_slices(int* blocks) {
  cudaError_t err = set_slices_smem<TILE, COL>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gram_slices<TILE, COL>, SliceShape<TILE>::kThreads,
      SliceShape<TILE>::kSmem));
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

// Plain C interface (loaded with ctypes).  Both routes launch on `stream`,
// allocate nothing, do not synchronise, and return a cudaError_t code (0
// on success).  g: (n, n) f32, written in full; c: device pointer to one
// f32 shift, or NULL for no shift.

// Route "simt": f32 a (m, n), m, n >= 0, row-major (a_col = 0: a[k, i] at
// a + k lda + i, lda >= n) or column-major (a_col = 1: at a + i lda + k,
// lda >= m); tiles of tile x tile (64 or 128); `slices` (1..8) blocks of
// `rows_per` rows (a multiple of 16) each on every tile, slice s = rows
// [s rows_per, min(m, (s + 1) rows_per)), covering [0, m), none empty
// (m = 0: one slice, G = c_eff I).  n = 0 launches nothing.
extern "C" int zolo_gram_f32_split(const void* a, int a_col, long long lda,
                                   void* g, int m, int n, int tile,
                                   int slices, int rows_per, const void* c,
                                   void* stream) {
  if (m < 0 || n < 0 || lda < (a_col ? m : n) || slices < 1 ||
      slices > kMaxCluster || rows_per <= 0 || rows_per % kChunk ||
      static_cast<long long>(slices) * rows_per < m ||
      static_cast<long long>(slices - 1) * rows_per >= (m > 0 ? m : 1) ||
      (tile != 64 && tile != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const float* ap = static_cast<const float*>(a);
  float* gp = static_cast<float*>(g);
  const float* cp = static_cast<const float*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 128)
    return a_col ? launch_slices<128, true>(ap, gp, m, n, lda, slices,
                                            rows_per, cp, st)
                 : launch_slices<128, false>(ap, gp, m, n, lda, slices,
                                             rows_per, cp, st);
  return a_col ? launch_slices<64, true>(ap, gp, m, n, lda, slices, rows_per,
                                         cp, st)
               : launch_slices<64, false>(ap, gp, m, n, lda, slices,
                                          rows_per, cp, st);
}

// The blocks of the split kernel (tile 64 or 128, either major) one SM
// holds at once, into *blocks: what kernels/gram.py's rule assumes.
extern "C" int zolo_gram_f32_resident(int tile, int a_col, int* blocks) {
  if (tile == 128)
    return a_col ? resident_slices<128, true>(blocks)
                 : resident_slices<128, false>(blocks);
  if (tile == 64)
    return a_col ? resident_slices<64, true>(blocks)
                 : resident_slices<64, false>(blocks);
  return static_cast<int>(cudaErrorInvalidValue);
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
