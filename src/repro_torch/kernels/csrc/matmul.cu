// K3: tiled matmul  C = alpha * (A @ B)  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py::_matmul_kernel
// (matmul_kernel_call).  A is (m, k) and B is (k, n), each f32 or bf16
// (they may differ), read through arbitrary element strides; C is (m, n)
// row-major f32.  Every product and sum is a true f32 FFMA (no TF32: a
// bf16 operand is widened to f32 per element before the product), and
// alpha multiplies the finished sum once, as the Pallas kernel's last-k
// `_scale` step does; it is never folded into A.
//
// Bound on the H100: operations.  C needs 2 m n k flops; at m = n = k =
// 11,999 that is 3.46 TFLOP, 51.6 ms at the 67 TFLOP/s f32 rate outside
// the tensor cores (3.5 ms at the 989 TFLOP/s bf16 tensor-core rate, which
// this SIMT kernel does not use), against 1.15 GB of f32 operands.
// Design for that bound, kept simple (the shape of K1, csrc/gram.cu):
//   * one block per 128 x 128 output tile, 256 threads, each accumulating
//     an 8 x 8 sub-tile in f32 registers from float4 shared-memory reads;
//   * the TPU's sequential k grid axis becomes an in-block loop over
//     16-deep chunks, double-buffered in shared memory with the next chunk
//     prefetched into registers (in the operand's own type, widened only
//     when stored) while the current one is multiplied;
//   * each operand is loaded along whichever of its axes has unit stride
//     (A row-major or a transposed view, the same for B), so the global
//     loads coalesce for both layouts; any other strides are still right,
//     only uncoalesced;
//   * ragged edges (11,999 is no multiple of any tile) are masked loads
//     and stores, so no shape needs padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;      // output tile edge (rows and columns)
constexpr int kChunk = 16;      // k depth per pipeline stage
constexpr int kThreads = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLoads = kChunk * kTile / kThreads;  // 8 per operand
constexpr int kLd = kTile + 4;  // padded shared row: float4-aligned, and
                                // k-fast stores spread over the banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Load the kChunk x kTile slice {(kk, i): k0 <= kk < k0 + kChunk,
// i0 <= i < i0 + kTile} of an operand whose element (i, kk) sits at
// p[i * s_i + kk * s_k] (A: i = row, B: i = column), into registers, in
// the operand's own type: the widening waits until store_chunk, so no
// instruction depends on a prefetch before the chunk in flight is
// multiplied.  `k_fast` picks the thread layout: consecutive threads
// walk kk (unit s_k) or i (unit s_i otherwise).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, int ni,
                                           int nk, long long s_i,
                                           long long s_k, bool k_fast,
                                           int i0, int k0, int tid,
                                           T* reg) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int e = tid + q * kThreads;
    const int kk = k_fast ? e % kChunk : e / kTile;
    const int i = k_fast ? e / kChunk : e % kTile;
    const int gi = i0 + i;
    const int gk = k0 + kk;
    reg[q] =
        (gi < ni && gk < nk) ? p[gi * s_i + gk * s_k] : zero_value<T>();
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(float (*s)[kLd], bool k_fast,
                                            int tid, const T* reg) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int e = tid + q * kThreads;
    const int kk = k_fast ? e % kChunk : e / kTile;
    const int i = k_fast ? e / kChunk : e % kTile;
    s[kk][i] = to_f32(reg[q]);
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
matmul_tiles(const TA* __restrict__ a, const TB* __restrict__ b,
             float* __restrict__ c, int m, int n, int k, long long sam,
             long long sak, long long sbk, long long sbn, float alpha_val,
             const float* __restrict__ alpha_ptr) {
  const int i0 = blockIdx.y * kTile;  // rows of C
  const int j0 = blockIdx.x * kTile;  // columns of C
  // A is read along k when its k stride is 1, else along its rows; B
  // along its columns when their stride is 1, else along k
  const bool a_kfast = sak == 1 && sam != 1;
  const bool b_kfast = sbn != 1 && sbk == 1;

  __shared__ __align__(16) float sa[2][kChunk][kLd];
  __shared__ __align__(16) float sb[2][kChunk][kLd];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / 16;  // rows    ty*4 .. +3 and 64 + ty*4 .. +3

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  TA ra[kLoads];
  TB rb[kLoads];
  const int chunks = (k + kChunk - 1) / kChunk;
  if (chunks > 0) {
    load_chunk(a, m, k, sam, sak, a_kfast, i0, 0, tid, ra);
    load_chunk(b, n, k, sbn, sbk, b_kfast, j0, 0, tid, rb);
    store_chunk(sa[0], a_kfast, tid, ra);
    store_chunk(sb[0], b_kfast, tid, rb);
  }
  __syncthreads();

  for (int kc = 0; kc < chunks; ++kc) {
    const int buf = kc & 1;
    const bool more = kc + 1 < chunks;
    if (more) {  // prefetch the next chunk while this one is multiplied
      load_chunk(a, m, k, sam, sak, a_kfast, i0, (kc + 1) * kChunk, tid, ra);
      load_chunk(b, n, k, sbn, sbk, b_kfast, j0, (kc + 1) * kChunk, tid, rb);
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
      store_chunk(sa[buf ^ 1], a_kfast, tid, ra);
      store_chunk(sb[buf ^ 1], b_kfast, tid, rb);
    }
    __syncthreads();
  }

  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < n) c[(long long)row * n + col] = alpha * acc[i][j];
    }
  }
}

template <typename TA, typename TB>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           long long sam, long long sak, long long sbk, long long sbn,
           float alpha_val, const void* alpha_ptr, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  matmul_tiles<TA, TB><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<float*>(c), m, n, k, sam, sak, sbk, sbn, alpha_val,
      static_cast<const float*>(alpha_ptr));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  a_bf16 / b_bf16 select each
// operand's type (0: f32, 1: bf16).  a: (m, k) with element strides
// (sam, sak); b: (k, n) with strides (sbk, sbn); c: (m, n) row-major f32,
// written in full.  alpha is *alpha_ptr when that is not NULL, else
// alpha_val.  m, n < 65,535 * 128 rows of tiles.  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
extern "C" int zolo_matmul(int a_bf16, int b_bf16, const void* a,
                           const void* b, void* c, int m, int n, int k,
                           long long sam, long long sak, long long sbk,
                           long long sbn, float alpha_val,
                           const void* alpha_ptr, void* stream) {
  using bf = __nv_bfloat16;
  if (!a_bf16 && !b_bf16)
    return launch<float, float>(a, b, c, m, n, k, sam, sak, sbk, sbn,
                                alpha_val, alpha_ptr, stream);
  if (!a_bf16)
    return launch<float, bf>(a, b, c, m, n, k, sam, sak, sbk, sbn,
                             alpha_val, alpha_ptr, stream);
  if (!b_bf16)
    return launch<bf, float>(a, b, c, m, n, k, sam, sak, sbk, sbn,
                             alpha_val, alpha_ptr, stream);
  return launch<bf, bf>(a, b, c, m, n, k, sam, sak, sbk, sbn, alpha_val,
                        alpha_ptr, stream);
}
