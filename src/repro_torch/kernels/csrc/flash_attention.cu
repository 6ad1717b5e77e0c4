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
// Numerics follow the Pallas body: S = (Q K^T) * scale with f32 sums of the
// products, masked scores set to -1e30, the online softmax state (m, l,
// acc) kept in f32, l summed from the unrounded P, and P rounded to v's
// type before the PV product (a bf16 kernel therefore matches the Pallas
// kernel's rounding, not an f32-P kernel's), O = acc / max(l, 1e-30).
//
// Bound on the H100: operations.  The causal half needs 2 b h s^2 d flops
// (QK^T and PV over the lower triangle); at b = 1, h = 32, s = 4,096,
// d = 128 that is 1.37e11: 0.139 ms at the 989 TFLOP/s bf16 tensor-core
// rate, 2.05 ms at the 67 TFLOP/s f32 rate outside them, against 0.13 GB
// (bf16) of q, k, v, o.  Two kernels, one per route (the wrapper,
// kernels/flash_attention.py, picks the route from dtype, d and strides
// before the launch):
//
// * flash_bf16 (route "wgmma"): bf16 with d in {64, 128} whose strides over
//   s, h and b are multiples of 8 elements and whose bases are 16-byte
//   aligned, so that TMA can describe them (4-d tensor maps over (d, s, h,
//   b), 128-byte swizzle, zero fill past the sequence end).
//     - one block per (128-query tile, batch-head), issued longest-first:
//       two consumer warpgroups of 64 query rows and one producer warp;
//     - Q is loaded once; K and V tiles of 128 keys x d go through a
//       2-stage TMA ring (160 KB of shared memory at d = 128), with their
//       own barriers so that QK^T starts before V lands;
//     - S = Q K^T: wgmma m64n128k16 with both operands K-major as they lie;
//     - the online softmax in registers, in base 2 (one FFMA and one ex2
//       per score: 2^(S scale log2 e - m)): the row max is taken over the
//       4 lanes that share a row of the accumulator, l is kept per thread
//       and summed over those lanes at the end;
//     - P is rounded to bf16 in place: the m64n128 accumulator, packed in
//       pairs, is the register A fragment of O += P V (wgmma m64nDk16 with
//       V MN-major through the transpose bit);
//     - kv tiles above the diagonal are skipped, and only the diagonal
//       tile is masked (a key past s is past every valid query).
// * flash_fwd (route "simt"): every other input (f32, bf16 with another d
//   or other strides).  A SIMT FFMA kernel:
//     - one block of 256 threads per (128-query tile, batch-head) (64 at
//       d > 128, to fit shared memory); the TPU's sequential kv grid axis
//       becomes an in-block loop over 64-key tiles, carrying (m, l, acc) in
//       registers; query tiles are issued longest-first;
//     - kv tiles above the diagonal are skipped: each of them is fully
//       masked for every query of the tile, and every query sees key 0, so
//       the Pallas kernel's visit of those tiles changes nothing (p = 0,
//       correction 1); only the tiles that reach past the block's first
//       query are masked;
//     - thread (ty, tx) owns 8 query rows ty 8 + i and 4 keys tx + 16 j of
//       the score tile (12 float4 reads per 128 FFMA) and 8 output columns
//       (4 tx .. + 3 and 64 + 4 tx .. + 3); the 16 threads that share a row
//       are 16 consecutive lanes, so the row max and row sum are 4
//       shuffles; P goes to shared memory transposed, so P V reads a float4
//       of P and a float4 of V per 32 FFMA;
//     - f32 tiles arrive by cp.async (16-byte copies when rows are 16-byte
//       aligned), K of the next tile under the softmax and P V, V of the
//       next tile under the next QK^T; bf16 tiles are widened to f32 by
//       plain loads; the head dimension is padded to DP (64, 128 or 256)
//       and zero-filled, and ragged sequence ends are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBk = 64;        // keys per kv step
constexpr int kThreads = 256;  // 16 x 16
constexpr float kMasked = -1e30f;

// The shapes of the SIMT kernel for a padded head dimension DP (64, 128 or
// 256).  kBq queries a block (128, or 64 at DP = 256 to fit shared
// memory); thread (ty, tx) owns query rows ty kRq + i (i < kRq), keys
// tx + 16 j (j < 4) of the score tile and output columns 64 g + 4 tx +
// {0..3} (g < DP / 64).  Shared memory (floats): Q [kBq][kLd], K
// [kBk][kLd], V [kBk][DP], P transposed [kBk][kPs].
template <int DP>
struct SimtShape {
  static constexpr int kBq = DP <= 128 ? 128 : 64;
  static constexpr int kRq = kBq / 16;
  static constexpr int kCg = DP / 64;
  static constexpr int kLd = DP + 4;   // Q and K rows: float4-aligned, and
                                       // 16 keys' float4 reads spread over
                                       // the banks
  static constexpr int kPs = kBq + 4;  // P^T rows (one per key)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBq * kLd;
  static constexpr int kV = kK + kBk * kLd;
  static constexpr int kP = kV + kBk * DP;
  static constexpr int kBytes = 4 * (kP + kBk * kPs);
};

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

// rows [r0, r0 + R) of one (batch, head) slice (row stride s_row, unit
// stride along d) into sm[row * ld + c], c < DP, zero past the sequence end
// and past d.  f32 goes through cp.async (16-byte copies when `vec`: d,
// the strides and the base are multiples of 4 floats), so the copy runs
// under the next computation and lands at the next cp.async wait; bf16 is
// widened by plain loads and stores.
template <int R, int DP>
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          long long s_row, int r0, int s,
                                          int d, float* sm, int ld, int tid,
                                          bool vec) {
  if (vec) {
#pragma unroll 4
    for (int e = tid; e < R * DP / 4; e += kThreads) {
      const int row = e / (DP / 4), c = 4 * (e % (DP / 4));
      const bool in = r0 + row < s && c < d;
      hopper::cp_async16(hopper::smem_u32(&sm[row * ld + c]),
                         in ? p + (r0 + row) * s_row + c : p, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < R * DP; e += kThreads) {
      const int row = e / DP, c = e % DP;
      const bool in = r0 + row < s && c < d;
      hopper::cp_async4(hopper::smem_u32(&sm[row * ld + c]),
                        in ? p + (r0 + row) * s_row + c : p, in ? 4 : 0);
    }
  }
}
template <int R, int DP>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ p,
                                          long long s_row, int r0, int s,
                                          int d, float* sm, int ld, int tid,
                                          bool) {
#pragma unroll 4
  for (int e = tid; e < R * DP; e += kThreads) {
    const int row = e / DP, c = e % DP;
    sm[row * ld + c] = (r0 + row < s && c < d)
                           ? __bfloat162float(p[(r0 + row) * s_row + c])
                           : 0.0f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int b, int s, int h,
          int d, long long sqb, long long sqs, long long sqh, long long skb,
          long long sks, long long skh, long long svb, long long svs,
          long long svh, float scale_log2, bool vec) {
  using S = SimtShape<DP>;
  constexpr int BQ = S::kBq, RQ = S::kRq, CG = S::kCg;
  constexpr int LD = S::kLd, PS = S::kPs;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + S::kQ;
  float* ks = smem + S::kK;
  float* vs = smem + S::kV;
  float* pt = smem + S::kP;

  const int nq = (s + BQ - 1) / BQ;
  const int bh_count = b * h;
  const int qb = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = qb * BQ;
  // kv tiles 0 .. last: the last holds the block's last valid query
  const int last = (min(q0 + BQ, s) - 1) / kBk;

  const T* qp = q + bi * sqb + hi * sqh;
  const T* kp = k + bi * skb + hi * skh;
  const T* vp = v + bi * svb + hi * svh;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // groups in flight: {Q, K_0}, {V_0}; then K_{t+1} and V_{t+1} behind
  load_rows<BQ, DP>(qp, sqs, q0, s, d, qs, LD, tid, vec);
  load_rows<kBk, DP>(kp, sks, 0, s, d, ks, LD, tid, vec);
  hopper::cp_async_commit();
  load_rows<kBk, DP>(vp, svs, 0, s, d, vs, DP, tid, vec);
  hopper::cp_async_commit();

  float m_i[RQ], l_i[RQ], acc[RQ][4 * CG];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = kMasked;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t <= last; ++t) {
    const int k0 = t * kBk;
    hopper::cp_async_wait<1>();  // Q and K_t have landed (V_t may not have)
    __syncthreads();

    float sc[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < DP; c += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * LD + c]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qs[(ty * RQ + i) * LD + c]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sc[i][j];
          x = fmaf(qv.x, kv[j].x, x);
          x = fmaf(qv.y, kv[j].y, x);
          x = fmaf(qv.z, kv[j].z, x);
          x = fmaf(qv.w, kv[j].w, x);
          sc[i][j] = x;
        }
      }
    }
    __syncthreads();  // every read of K_t is done: fetch K_{t+1} under the
                      // softmax and P V
    if (t < last) load_rows<kBk, DP>(kp, sks, k0 + kBk, s, d, ks, LD, tid, vec);
    hopper::cp_async_commit();

    // mask (only tiles that reach past the block's first query), online
    // softmax in base 2 (one FFMA and one ex2 a score), P^T to shared
    const bool masked = k0 + kBk - 1 > q0;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty * RQ + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (masked && k0 + tx + 16 * j > qpos) sc[i][j] = kMasked;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx) * scale_log2);
      const float corr = exp2f(m_i[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(fmaf(sc[i][j], scale_log2, -m_new));
        sum += p;  // l from the unrounded P
        pt[(tx + 16 * j) * PS + ty * RQ + i] = round_to(p, T());
      }
      l_i[i] = l_i[i] * corr + row_sum16(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CG; ++c) acc[i][c] *= corr;
    }
    hopper::cp_async_wait<1>();  // V_t has landed (K_{t+1} may not have)
    __syncthreads();   // ... and P^T is written

#pragma unroll 4
    for (int kk = 0; kk < kBk; ++kk) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; i += 4) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(&pt[kk * PS + ty * RQ + i]);
        pv[i] = t4.x, pv[i + 1] = t4.y, pv[i + 2] = t4.z, pv[i + 3] = t4.w;
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[kk * DP + 64 * g + 4 * tx]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          acc[i][4 * g + 0] = fmaf(pv[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pv[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
    __syncthreads();  // every read of V_t and P^T is done
    if (t < last) load_rows<kBk, DP>(vp, svs, k0 + kBk, s, d, vs, DP, tid, vec);
    hopper::cp_async_commit();
  }

  // o is a fresh row-major (b, s, h, d) tensor
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= s) continue;
    const float inv = 1.0f / fmaxf(l_i[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(bi) * s + row) * h + hi) * d;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) {
      const int col = 64 * (c / 4) + 4 * tx + c % 4;
      if (col < d) from_f32(acc[i][c] * inv, &orow[col]);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int h, int d, const long long* st, float scale,
           bool vec, void* stream) {
  auto kern = flash_fwd<T, DP>;
  constexpr int bytes = SimtShape<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bq = SimtShape<DP>::kBq;
  const long long blocks = static_cast<long long>((s + bq - 1) / bq) * b * h;
  kern<<<static_cast<unsigned>(blocks), kThreads, bytes,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), b, s, h, d, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int s, int h, int d, const long long* st, float scale, bool vec,
             void* stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, b, s, h, d, st, scale, vec, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, b, s, h, d, st, scale, vec, stream);
  return launch<T, 256>(q, k, v, o, b, s, h, d, st, scale, vec, stream);
}

// ---- route "wgmma": bf16, d in {64, 128} ------------------------------------

constexpr int kWq = 128;         // queries per block: two warpgroups of 64
constexpr int kWk = 128;         // keys per kv tile
constexpr int kWThreads = 288;   // warps 0-7: consumers; warp 8: producer
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WLayout {
  static constexpr int kChunks = D / 64;                // 128-byte columns
  static constexpr int kChunkBytes = 128 * 128;         // 128 rows x 128 B
  static constexpr int kTileBytes = kChunks * kChunkBytes;  // Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;                 // 2 stages
  static constexpr int kV = 3 * kTileBytes;             // 2 stages
  static constexpr int kBars = 5 * kTileBytes;
  // qfull, kfull[2], vfull[2], empty[2]
  static constexpr int kSmem = kBars + 7 * 8 + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_bf16(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           __nv_bfloat16* __restrict__ o, int b, int s, int h,
           float scale_log2) {
  using namespace hopper;
  using L = WLayout<D>;
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  const uint32_t base = (smem_u32(fw_smem) + 1023u) & ~1023u;
  const uint32_t qfull = base + L::kBars;
  auto kfull = [&](int st) { return base + L::kBars + 8u * (1 + st); };
  auto vfull = [&](int st) { return base + L::kBars + 8u * (3 + st); };
  auto empty = [&](int st) { return base + L::kBars + 8u * (5 + st); };
  auto k_tile = [&](int st) { return base + L::kK + st * L::kTileBytes; };
  auto v_tile = [&](int st) { return base + L::kV + st * L::kTileBytes; };

  const int nq = (s + kWq - 1) / kWq;
  const int bh_count = b * h;
  const int qb = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = qb * kWq;
  const int ntiles = qb + 1;  // kv tiles 0 .. qb: the last holds the diagonal

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(kfull(st), 1);
      mbar_init(vfull(st), 1);
      mbar_init(empty(st), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 8) {  // producer
    if (lane == 0) {
      mbar_expect_tx(qfull, L::kTileBytes);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        tma_load_4d(base + L::kQ + c * L::kChunkBytes, &tq, qfull, 64 * c, q0,
                    hi, bi);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % 2;
        if (t >= 2) mbar_wait(empty(st), (t / 2 - 1) & 1);
        mbar_expect_tx(kfull(st), L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_4d(k_tile(st) + c * L::kChunkBytes, &tk, kfull(st), 64 * c,
                      t * kWk, hi, bi);
        mbar_expect_tx(vfull(st), L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_4d(v_tile(st) + c * L::kChunkBytes, &tv, vfull(st), 64 * c,
                      t * kWk, hi, bi);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // rows r[0] and r[1] = r[0] + 8 of them
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  float m_r[2] = {-1e30f, -1e30f};  // running max, base-2 scaled
  float l_r[2] = {0.0f, 0.0f};      // this thread's share of the row sums
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  mbar_wait(qfull, 0);
  const uint32_t q_s = base + L::kQ + wg * 8192;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % 2;
    const uint32_t par = (t / 2) & 1;
    mbar_wait(kfull(st), par);

    float sc[kWk / 2];
#pragma unroll
    for (int i = 0; i < kWk / 2; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int dk = 0; dk < D / 16; ++dk) {
      const int off = (dk / 4) * L::kChunkBytes + (dk % 4) * 32;
      wgmma_ss_n128<0, 0>(sc, desc_sw128(q_s + off, 16, 1024),
                          desc_sw128(k_tile(st) + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask above the diagonal, on the diagonal tile only
    if (t == qb) {
      const int key0 = t * kWk + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < kWk / 2; ++i) {
        const int e = i % 4;
        if (key0 + 8 * (i / 4) + (e % 2) > row0 + 8 * (e / 2)) sc[i] = -1e30f;
      }
    }
    // online softmax in base 2: scale > 0, so max(S) scale log2 e is the
    // max of the scaled scores, and P = 2^(S scale log2 e - m) is one FFMA
    // and one ex2 per score
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int i = 0; i < kWk / 2; ++i)
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
    float corr[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]) * scale_log2);
      corr[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      neg_m[r] = -m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kWk / 2; ++i) {
      const int r = (i % 4) / 2;
      const float p = exp2f(fmaf(sc[i], scale_log2, neg_m[r]));
      sc[i] = p;
      sum[r] += p;  // l from the unrounded P
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i % 4) / 2];

    // P rounded to bf16: accumulator column groups 2 kk and 2 kk + 1 are
    // the A fragment of keys 16 kk .. 16 kk + 15
    uint32_t pa[kWk / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWk / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    mbar_wait(vfull(st), par);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kWk / 16; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWk / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_tile(st) + kk * 2048, L::kChunkBytes,
                                     1024);
      if constexpr (D == 64)
        wgmma_rs_n64<1>(acc, pa[kk], dv, 1);
      else
        wgmma_rs_n128<1>(acc, pa[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kWk / 16; ++kk) fence_regs(pa[kk]);
    if (lane == 0) mbar_arrive(empty(st));  // K and V of stage st are read
  }

  // o is a fresh row-major (b, s, h, d) tensor
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.0f / fmaxf(quad_sum(l_r[r]), 1e-30f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s) continue;
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(bi) * s + row) * h + hi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(&orow[col]) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// one 4-d map over a (b, s, h, d) bf16 tensor: dims (d, s, h, b), boxes of
// 64 x 128 x 1 x 1
inline int encode_qkv(CUtensorMap* map, const void* p, int b, int s, int h,
                      int d, const long long* st) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d),
                            static_cast<uint64_t>(s),
                            static_cast<uint64_t>(h),
                            static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {64, 128, 1, 1};
  return hopper::encode_bf16_map(map, p, 4, dims, strides, box);
}

template <int D>
int launch_bf16(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tv, void* o, int b, int s, int h,
                float scale, cudaStream_t stream) {
  auto kern = flash_bf16<D>;
  constexpr int bytes = WLayout<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((s + kWq - 1) / kWq) * b * h;
  kern<<<static_cast<unsigned>(blocks), kWThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), b, s, h, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Both launch on `stream`,
// allocate nothing, do not synchronise, and return a cudaError_t code (0 on
// success, or the attribute call's or the tensor map's error).

// Route "simt".  bf16: 0 for f32, 1 for bf16
// (q, k, v and o share the type).  q, k, v: (b, s, h, d) with unit stride
// along d and element strides strides[0..8] = (q: batch, seq, head;
// k: ...; v: ...); o: a row-major (b, s, h, d) tensor.  1 <= d <= 256;
// scale multiplies Q K^T.
extern "C" int zolo_flash_attention(int bf16, const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int h, int d, const long long* strides,
                                    float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, s, h, d, strides, scale,
                                   false, stream);
  // 16-byte copies when every row of q, k and v starts 16-byte aligned
  bool vec = d % 4 == 0 &&
             (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 4 == 0;
  return dispatch<float>(q, k, v, o, b, s, h, d, strides, scale, vec,
                         stream);
}

// Route "wgmma": bf16 q, k, v (b, s, h, d) with d in {64, 128}, unit stride
// along d, element strides strides[0..8] as above, each a multiple of 8, and
// 16-byte aligned bases; o: a row-major (b, s, h, d) bf16 tensor.
extern "C" int zolo_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o, int b, int s,
                                         int h, int d,
                                         const long long* strides, float scale,
                                         void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = encode_qkv(&tq, q, b, s, h, d, strides);
  if (!err) err = encode_qkv(&tk, k, b, s, h, d, strides + 3);
  if (!err) err = encode_qkv(&tv, v, b, s, h, d, strides + 6);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bf16<64>(tq, tk, tv, o, b, s, h, scale, st);
  return launch_bf16<128>(tq, tk, tv, o, b, s, h, scale, st);
}
