// K4: causal flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention_kernel_call).  q, k, v are (b, s, h, d) tensors of one
// type (f32 or bf16) read through their strides (the head dimension has
// unit stride; the wrapper's (b h, s, d) transposes are never made), GQA
// already expanded.  O = softmax(Q K^T / sqrt(d), causal) V is written to
// a row-major (b, s, h, d) tensor of q's type.
//
// Numerics follow the Pallas body: S = (Q K^T) * scale with f32 products
// and sums (a bf16 element is widened to f32 before the product), masked
// scores set to -1e30, the online softmax state (m, l, acc) kept in f32,
// l summed from the unrounded P, and P rounded to v's type before the PV
// product (a bf16 kernel therefore matches the Pallas kernel's rounding,
// not an f32-P kernel's), O = acc / max(l, 1e-30).
//
// Bound on the H100: operations.  The causal half needs 2 b h s^2 d flops
// (QK^T and PV over the lower triangle); at b = 1, h = 32, s = 4,096,
// d = 128 that is 1.37e11: 2.05 ms at the 67 TFLOP/s f32 rate outside the
// tensor cores (0.14 ms at the 989 TFLOP/s bf16 tensor-core rate, which
// this SIMT kernel does not use), against 0.13 GB (bf16) of q, k, v, o.
// Design for that bound, kept simple:
//   * one block of 256 threads per (64-query tile, batch-head); the
//     TPU's sequential kv grid axis becomes an in-block loop over 64-key
//     tiles, carrying (m, l, acc) in registers;
//   * kv tiles above the diagonal are skipped: each of them is fully
//     masked for every query of the tile, and every query sees key 0, so
//     the Pallas kernel's visit of those tiles changes nothing (p = 0,
//     correction 1); query tiles are issued longest-first;
//   * thread (ty, tx) owns query rows ty + 16 i and key columns tx + 16 j
//     (i, j < 4) of the score tile, and output columns tx + 16 g: the 16
//     threads that share a row are 16 consecutive lanes, so the row max
//     and row sum are 4 shuffles, and every shared-memory read is either
//     a broadcast or conflict-free;
//   * Q, K and V tiles live in shared memory as f32 (K's tile is reused
//     for P), with the head dimension padded to DP, a power of two, and
//     zero-filled; ragged sequence ends are masked loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;        // queries per block
constexpr int kBk = 64;        // keys per kv step
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPs = kBk + 4;   // P row stride (float4-aligned)
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}
// P rounded to v's type, as the Pallas body's p.astype(v.dtype)
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [r0, r0 + 64) of one (batch, head) slice into s[row][c] (row
// stride ld), columns c < DP, zero past the sequence end and past d
template <typename T, int DP>
__device__ __forceinline__ void load_tile(const T* __restrict__ p,
                                          long long s_row, int r0, int s,
                                          int d, float* __restrict__ sm,
                                          int ld, int tid) {
#pragma unroll 4
  for (int e = tid; e < 64 * DP; e += kThreads) {
    const int row = e / DP;
    const int c = e % DP;
    const int g = r0 + row;
    sm[row * ld + c] = (g < s && c < d) ? to_f32(p[g * s_row + c]) : 0.0f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int b, int s, int h,
          int d, long long sqb, long long sqs, long long sqh, long long skb,
          long long sks, long long skh, long long svb, long long svs,
          long long svh, float scale) {
  constexpr int kLd = DP + 4;  // Q/K row stride: float4-aligned, and the
                               // 8 lanes of a float4 phase hit 8 bank groups
  constexpr int kG = DP / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kBq][kLd]
  float* ks = qs + kBq * kLd;        // [kBk][kLd], reused as P [kBq][kPs]
  constexpr int kKsFloats = (kBk * kLd > kBq * kPs) ? kBk * kLd : kBq * kPs;
  float* vs = ks + kKsFloats;        // [kBk][DP]
  float* ps = ks;

  const int nq = (s + kBq - 1) / kBq;
  const int bh_count = b * h;
  const int qb = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = qb * kBq;

  const T* qp = q + bi * sqb + hi * sqh;
  const T* kp = k + bi * skb + hi * skh;
  const T* vp = v + bi * svb + hi * svh;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  load_tile<T, DP>(qp, sqs, q0, s, d, qs, kLd, tid);

  float m_i[4], l_i[4], acc[4][kG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kMasked;
    l_i[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < kG; ++g) acc[i][g] = 0.0f;
  }

  // kv tiles 0 .. qb: the last one holds the diagonal (and, for the last
  // query tile, the ragged end: a key past s is past every valid query)
  for (int kb = 0; kb <= qb; ++kb) {
    const int k0 = kb * kBk;
    __syncthreads();  // the previous step's P and V reads are done
    load_tile<T, DP>(kp, sks, k0, s, d, ks, kLd, tid);
    load_tile<T, DP>(vp, svs, k0, s, d, vs, DP, tid);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * kLd + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * kLd + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = sc[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          sc[i][j] = t;
        }
    }

    const bool diag = kb == qb;
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * scale;
        if (diag && k0 + tx + 16 * j > qpos) x = kMasked;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(sc[i][j] - m_new);
        sum += p[i][j];
      }
      l_i[i] = l_i[i] * corr + row_sum16(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[i][g] *= corr;
    }

    __syncthreads();  // every thread is done reading K before P lands there
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * kPs + tx + 16 * j] = round_to(p[i][j], T());
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBk; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * kPs + j]);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int c = tx + 16 * g;
        const float v0 = vs[(j + 0) * DP + c];
        const float v1 = vs[(j + 1) * DP + c];
        const float v2 = vs[(j + 2) * DP + c];
        const float v3 = vs[(j + 3) * DP + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = acc[i][g];
          t = fmaf(pv[i].x, v0, t);
          t = fmaf(pv[i].y, v1, t);
          t = fmaf(pv[i].z, v2, t);
          t = fmaf(pv[i].w, v3, t);
          acc[i][g] = t;
        }
      }
    }
  }

  // o is a fresh row-major (b, s, h, d) tensor
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float inv = 1.0f / fmaxf(l_i[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(bi) * s + row) * h + hi) * d;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int c = tx + 16 * g;
      if (c < d) from_f32(acc[i][g] * inv, &orow[c]);
    }
  }
}

template <int DP>
constexpr int smem_bytes() {
  constexpr int ld = DP + 4;
  constexpr int ks = (kBk * ld > kBq * kPs) ? kBk * ld : kBq * kPs;
  return static_cast<int>(sizeof(float)) * (kBq * ld + ks + kBk * DP);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int h, int d, const long long* st, float scale,
           void* stream) {
  auto kern = flash_fwd<T, DP>;
  constexpr int bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((s + kBq - 1) / kBq) * b * h;
  kern<<<static_cast<unsigned>(blocks), kThreads, bytes,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), b, s, h, d, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int s, int h, int d, const long long* st, float scale,
             void* stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, b, s, h, d, st, scale, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, o, b, s, h, d, st, scale, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, b, s, h, d, st, scale, stream);
  return launch<T, 256>(q, k, v, o, b, s, h, d, st, scale, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  bf16: 0 for f32, 1 for bf16
// (q, k, v and o share the type).  q, k, v: (b, s, h, d) with unit stride
// along d and element strides strides[0..8] = (q: batch, seq, head;
// k: ...; v: ...); o: a row-major (b, s, h, d) tensor.  1 <= d <= 256;
// scale multiplies Q K^T.  Launches on `stream`, allocates nothing, does
// not synchronise; returns cudaGetLastError() (or the attribute call's
// error).
extern "C" int zolo_flash_attention(int bf16, const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int h, int d, const long long* strides,
                                    float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, s, h, d, strides, scale,
                                   stream);
  return dispatch<float>(q, k, v, o, b, s, h, d, strides, scale, stream);
}
