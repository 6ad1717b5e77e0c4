// K1: fused shifted Gram  G = A^T A + c_eff I  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py::_gram_kernel
// (gram_kernel_call).  A is (m, n) row-major with row stride lda, in f32
// or bf16; G is (n, n) row-major f32; every product and sum is a true
// f32 FFMA (no TF32: the f32 kappa envelope assumes f32 products, and a
// bf16 input is widened to f32 per element before the product).
//
// Bound on the H100: operations.  G needs m n (n + 1) flops (its upper
// triangle); at m = n = 11,999 that is 1.73 TFLOP, 26 ms at the 67 TFLOP/s
// f32 rate outside the tensor cores, against 0.58 GB of input (0.2 ms).
// Design for that bound, kept simple:
//   * one block per 128 x 128 output tile of the upper triangle only
//     (tile row <= tile column); an off-diagonal tile is also written
//     mirrored, so the kernel does half the products of A^T A;
//   * the TPU's sequential k grid axis becomes an in-block loop over
//     16-row chunks of A, double-buffered in shared memory with the next
//     chunk prefetched into registers while the current one is used;
//   * 256 threads, each accumulating an 8 x 8 sub-tile in f32 registers
//     from conflict-free float4 shared-memory reads;
//   * both operands are row slices of A (G[i][j] = sum_k A[k][i] A[k][j]),
//     so every global load is coalesced along n; ragged edges (n = 11,999
//     is no multiple of any tile) are masked loads and stores.
//
// Shift clamp, global semantics (the engine's zolo._clamp_shift): a
// positive c is raised to >= 8 eps(f32) max_i G[i][i] over the WHOLE
// diagonal.  The Pallas kernel clamped against its own 256 x 256 tile,
// which agrees only for n <= 256; here blocks run in parallel, so a
// one-block epilogue kernel reduces the diagonal after the tiles are
// done and then adds c_eff.  c == 0 and negative c are added unchanged.
// The epilogue runs only when the caller passes a shift (c != NULL).

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;    // output tile edge
constexpr int kChunk = 16;    // rows of A per pipeline stage
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLoads = kChunk * kTile / kThreads;  // 8 per operand

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a, int m,
                                           int n, long long lda, int k0,
                                           int c0, int tid, float* reg) {
  const int col = c0 + (tid % kTile);
  const int row0 = tid / kTile;
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int row = k0 + row0 + 2 * q;
    reg[q] = (row < m && col < n) ? to_f32(a[row * lda + col]) : 0.0f;
  }
}

__device__ __forceinline__ void store_chunk(float (*s)[kTile], int tid,
                                            const float* reg) {
  const int col = tid % kTile;
  const int row0 = tid / kTile;
#pragma unroll
  for (int q = 0; q < kLoads; ++q) s[row0 + 2 * q][col] = reg[q];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_tiles(const T* __restrict__ a, float* __restrict__ g, int m, int n,
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

template <typename T>
int launch(const void* a, void* g, int m, int n, long long lda,
           const void* c, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  const int blocks = tiles * (tiles + 1) / 2;
  gram_tiles<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(a),
                                            static_cast<float*>(g), m, n,
                                            lda, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || c == nullptr) return static_cast<int>(err);
  gram_shift<<<1, 1024, 0, s>>>(static_cast<float*>(g), n,
                                static_cast<const float*>(c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  a: (m, n) with row stride
// lda >= n; g: (n, n) f32, written in full; c: device pointer to one f32
// shift, or NULL for no shift.  Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError().
extern "C" int zolo_gram_f32(const void* a, void* g, int m, int n,
                             long long lda, const void* c, void* stream) {
  return launch<float>(a, g, m, n, lda, c, stream);
}

extern "C" int zolo_gram_bf16(const void* a, void* g, int m, int n,
                              long long lda, const void* c, void* stream) {
  return launch<__nv_bfloat16>(a, g, m, n, lda, c, stream);
}
