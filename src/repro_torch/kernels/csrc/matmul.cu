// K3: tiled matmul  C = alpha * (A @ B)  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py::_matmul_kernel
// (matmul_kernel_call).  A is (m, k), B is (k, n), C is (m, n) row-major
// f32; every sum is f32, and alpha multiplies the finished sum once, as the
// Pallas kernel's last-k `_scale` step does (it is never folded into A).
// Two kernels, one per route (the wrapper, kernels/matmul.py, picks the
// route from the operands' dtypes before the launch):
//
// * matmul_f32 (route "simt"): f32 A and B, any element strides.  True f32
//   FFMA products (no TF32).  Bound on the H100: operations, 2 m n k flops:
//   51.6 ms at m = n = k = 11,999 at the 67 TFLOP/s f32 rate outside the
//   tensor cores.  Design: one block of 128 threads per 128 x 128 output
//   tile, four warps of 64 x 64, 8 x 16 f32 outputs a thread from float4
//   shared-memory reads (six reads per 128 FFMA, issued columns outer and
//   rows serpentine); the TPU's sequential k grid axis is an in-block loop
//   over 32-deep chunks fed by a 2-stage ring of 4-byte cp.async copies
//   (rows of 11,999 elements are not 16-byte aligned), zero-filled past the
//   ragged edges, with lanes laid out so that the copies' shared-memory
//   stores hit distinct banks; each operand is read along whichever of its
//   axes has unit stride, so both layouts coalesce; two blocks share an SM.
//   The depth, ring, thread layout, unroll, product order and copy layout
//   were chosen among measured variants (PERF.md).
//
// * matmul_bf16 (route "wgmma"): bf16 A and B, each K-major or MN-major
//   (row-major or a transposed view) with a leading dimension that is a
//   multiple of 8 elements and a 16-byte aligned base (the wrapper stages
//   any other operand into such a buffer).  bf16 products summed in f32 on
//   the tensor cores.  Bound: operations, 3.5 ms at 11,999^3 at the 989
//   TFLOP/s bf16 rate.  Design: one block per 128 x 256 output tile (tiles
//   visited in groups of 8 tile rows, so concurrent blocks share A and B in
//   L2), a 4-stage ring of 64-deep A and B tiles loaded by TMA with the
//   128-byte swizzle (one producer warp; the ragged edges are TMA's zero
//   fill), two consumer warpgroups that each multiply a 64 x 256 half with
//   wgmma m64n256k16 (the transpose bits take MN-major operands as they
//   lie), one wgmma group kept in flight while the previous stage is
//   released, and a masked f32 epilogue straight from the registers (C's
//   rows of 11,999 floats are not 16-byte aligned, so no TMA store).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ---- route "simt": f32 ------------------------------------------------------

constexpr int kTile = 128;      // output tile edge (rows and columns)
constexpr int kThreads = 128;   // warps of 64 x 64, lanes 8 x 4
constexpr int kTM = 8;          // rows a thread: r0 + {0..3}, r0 + 32 + {0..3}
constexpr int kTN = 16;         // columns: c0 + 16 g + {0..3}, g < 4
constexpr int kChunk = 32;      // k depth per pipeline stage
constexpr int kStages = 2;      // cp.async ring depth
constexpr int kUnroll = 4;      // of the 32-deep product loop (a wider body
                                // misses the instruction cache)
constexpr int kLd = kTile + 4;  // padded shared row: float4-aligned, and
                                // k-fast stores spread over the banks
constexpr int kStageFloats = kChunk * kLd;
constexpr int kSimtSmem = 2 * kStages * kStageFloats * 4;  // 67,584 bytes
constexpr int kGroupRows = 8;   // tile rows per L2 group (both kernels)

// block -> (first row, first column) of its output tile, kGroupRows tile
// rows at a time, so that concurrent blocks share A and B in L2
__device__ __forceinline__ void tile_origin(int id, int tiles_m, int tiles_n,
                                            int tm_size, int tn_size, int& m0,
                                            int& n0) {
  const int per_group = kGroupRows * tiles_n;
  const int first = (id / per_group) * kGroupRows;
  const int rows = min(tiles_m - first, kGroupRows);
  m0 = (first + (id % per_group) % rows) * tm_size;
  n0 = ((id % per_group) / rows) * tn_size;
}

// One operand's share of a stage: element (i, kk) of the kChunk x kTile
// slice {i0 <= i < i0 + kTile, k0 <= kk < k0 + kChunk} sits at
// p[i * s_i + kk * s_k] (A: i = row, B: i = column) and lands at
// s[kk * kLd + i].  Thread tid copies kLoads elements.  With K_FAST (unit
// s_k) the 32 lanes of a warp cover 8 k by 4 rows, so a copy instruction
// reads four 32-byte runs and its shared-memory stores (kk kLd + i: banks
// 4 kk + i) hit 32 distinct banks; copy q adds 8 (q % 4) to kk and
// 16 (q / 4) to the row.  Else thread tid owns row (column) tid and copy q
// is k + q: a warp reads 128 consecutive bytes and stores 32 consecutive
// words.  The layout is a template argument, so every per-copy offset is a
// constant.
template <bool K_FAST>
struct Loader {
  static constexpr int kLoads = kChunk * kTile / kThreads;  // 32
  static_assert(kThreads == kTile && kChunk == 32 && kLoads == kChunk,
                "the copy layouts below cover a 32 x 128 slice with 128 "
                "threads");
  const float* p;      // this thread's first element at k0 = 0
  long long step_k;    // K_FAST: 8 k; else 1 k (elements)
  long long step_i;    // K_FAST: 16 rows (elements)
  long long s_k;
  int i, kk, ni, nk;   // its first (global i, local kk); the extents
  uint32_t dst;        // its first shared-memory byte offset in a stage

  __device__ Loader(const float* base, int ni_, int nk_, long long s_i,
                    long long s_k_, int i0, int tid)
      : s_k(s_k_), ni(ni_), nk(nk_) {
    int il;
    if (K_FAST) {
      const int l = tid % 32, w = tid / 32;
      kk = l % 8;
      il = l / 8 + 4 * w;
      step_k = 8 * s_k;
      step_i = 16 * s_i;
    } else {
      kk = 0;
      il = tid;
      step_k = s_k;
      step_i = 0;
    }
    i = i0 + il;
    p = base + i * s_i + kk * s_k;
    dst = 4u * (kk * kLd + il);
  }

  __device__ __forceinline__ void load(uint32_t stage, int k0) const {
    const float* src = p + k0 * s_k;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int dk = K_FAST ? 8 * (q % 4) : q;
      const int di = K_FAST ? 16 * (q / 4) : 0;
      const bool in = i + di < ni && k0 + kk + dk < nk;
      const float* at = K_FAST ? src + (q % 4) * step_k + (q / 4) * step_i
                               : src + q * step_k;
      hopper::cp_async4(stage + dst + 4u * (dk * kLd + di), in ? at : p,
                        in ? 4 : 0);
    }
  }
};

template <bool A_KFAST, bool B_KFAST>
__global__ void __launch_bounds__(kThreads, 2)
matmul_f32(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ c, int m, int n, int k, long long sam,
           long long sak, long long sbk, long long sbn, float alpha_val,
           const float* __restrict__ alpha_ptr) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                               // [kStages][kChunk][kLd]
  float* sb = smem + kStages * kStageFloats;      // [kStages][kChunk][kLd]
  const uint32_t sa_u = hopper::smem_u32(sa);
  const uint32_t sb_u = hopper::smem_u32(sb);

  int i0, j0;  // the first row and column of this block's tile of C
  tile_origin(blockIdx.x, (m + kTile - 1) / kTile, (n + kTile - 1) / kTile,
              kTile, kTile, i0, j0);
  const int tid = threadIdx.x;
  const Loader<A_KFAST> la(a, m, k, sam, sak, i0, tid);
  const Loader<B_KFAST> lb(b, n, k, sbn, sbk, j0, tid);
  // warp w owns rows 64 (w / 2) .. + 63 and columns 64 (w % 2) .. + 63 of
  // the tile; a warp's float4 reads of A are one 128-byte wavefront, of B
  // half of one
  const int w = tid / 32, l = tid % 32;
  const int r0 = (w / 2) * 64 + (l / 4) * 4;
  const int c0 = (w % 2) * 64 + (l % 4) * 4;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  const int chunks = (k + kChunk - 1) / kChunk;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < chunks) {
      la.load(sa_u + 4u * st * kStageFloats, st * kChunk);
      lb.load(sb_u + 4u * st * kStageFloats, st * kChunk);
    }
    hopper::cp_async_commit();  // one group per stage, empty or not
  }

  for (int kc = 0; kc < chunks; ++kc) {
    hopper::cp_async_wait<kStages - 2>();  // chunk kc has landed (this
                                           // thread's part)
    __syncthreads();               // ... everyone's; and chunk kc - 1 is read
    const int nxt = kc + kStages - 1;
    if (nxt < chunks) {  // into the slot chunk kc - 1 used
      const int st = nxt % kStages;
      la.load(sa_u + 4u * st * kStageFloats, nxt * kChunk);
      lb.load(sb_u + 4u * st * kStageFloats, nxt * kChunk);
    }
    hopper::cp_async_commit();
    const float* as = sa + (kc % kStages) * kStageFloats;
    const float* bs = sb + (kc % kStages) * kStageFloats;
#pragma unroll kUnroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int g = 0; g < kTM / 4; ++g) {
        const float4 t =
            *reinterpret_cast<const float4*>(&as[kk * kLd + r0 + 32 * g]);
        av[4 * g] = t.x, av[4 * g + 1] = t.y, av[4 * g + 2] = t.z,
                av[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < kTN / 4; ++g) {
        const float4 t =
            *reinterpret_cast<const float4*>(&bs[kk * kLd + c0 + 16 * g]);
        bv[4 * g] = t.x, bv[4 * g + 1] = t.y, bv[4 * g + 2] = t.z,
                bv[4 * g + 3] = t.w;
      }
      // columns outer, rows serpentine: each B value is reused for 8
      // products, and each turn reuses the A value of the last one
#pragma unroll
      for (int j = 0; j < kTN; ++j)
#pragma unroll
        for (int ii = 0; ii < kTM; ++ii) {
          const int i = (j % 2) ? kTM - 1 - ii : ii;
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
  }
  hopper::cp_async_wait<0>();

  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = i0 + r0 + (i / 4) * 32 + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = j0 + c0 + (j / 4) * 16 + j % 4;
      if (col < n) c[(long long)row * n + col] = alpha * acc[i][j];
    }
  }
}

template <bool A_KFAST, bool B_KFAST>
int launch_f32(const float* a, const float* b, float* c, int m, int n, int k,
               long long sam, long long sak, long long sbk, long long sbn,
               float alpha_val, const float* alpha_ptr, cudaStream_t stream) {
  auto kern = matmul_f32<A_KFAST, B_KFAST>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSimtSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((m + kTile - 1) / kTile) *
                           ((n + kTile - 1) / kTile);
  kern<<<static_cast<unsigned>(blocks), kThreads, kSimtSmem, stream>>>(
      a, b, c, m, n, k, sam, sak, sbk, sbn, alpha_val, alpha_ptr);
  return static_cast<int>(cudaGetLastError());
}

// ---- route "wgmma": bf16 ----------------------------------------------------

constexpr int kBM = 128;  // output tile rows: two warpgroups of 64
constexpr int kBN = 256;  // output tile columns: one m64n256 per warpgroup
constexpr int kBK = 64;   // k depth of a stage: 128 bytes of bf16, one
                          // swizzle row
constexpr int kWgStages = 4;
constexpr int kABytes = kBM * kBK * 2;           // 16 KB
constexpr int kBBytes = kBN * kBK * 2;           // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;   // 48 KB
constexpr int kWgThreads = 288;  // warps 0-7: two consumer warpgroups;
                                 // warp 8: the TMA producer
constexpr int kWgSmem = kWgStages * kStageBytes + 2 * kWgStages * 8 + 1024;

// A_MN: A is MN-major (a transposed view: its m axis has unit stride);
// B_MN: B is MN-major (row-major (k, n): its n axis has unit stride)
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kWgThreads, 1)
matmul_bf16(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb, float* __restrict__ c,
            int m, int n, int k, float alpha_val,
            const float* __restrict__ alpha_ptr) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // swizzled tiles need 1,024-byte alignment
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t bars = base + kWgStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kWgStages + s); };

  int m0, n0;  // the first row and column of this block's tile of C
  tile_origin(blockIdx.x, (m + kBM - 1) / kBM, (n + kBN - 1) / kBN, kBM,
              kBN, m0, n0);
  const int ktiles = (k + kBK - 1) / kBK;

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
        mbar_expect_tx(full(s), kStageBytes);
        const uint32_t a_dst = base + s * kStageBytes;
        const uint32_t b_dst = a_dst + kABytes;
        const int k0 = kt * kBK;
        if (A_MN) {  // boxes of 64 (m) x 64 (k)
          tma_load_2d(a_dst, &ta, full(s), m0, k0);
          tma_load_2d(a_dst + 8192, &ta, full(s), m0 + 64, k0);
        } else {     // one box of 64 (k) x 128 (m)
          tma_load_2d(a_dst, &ta, full(s), k0, m0);
        }
        if (B_MN) {  // boxes of 64 (n) x 64 (k)
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load_2d(b_dst + 8192 * j, &tb, full(s), n0 + 64 * j, k0);
        } else {     // one box of 64 (k) x 256 (n)
          tma_load_2d(b_dst, &tb, full(s), k0, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies rows m0 + 64 wg .. + 63
  const int wg = warp / 4;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kWgStages;
    mbar_wait(full(s), (kt / kWgStages) & 1);
    const uint32_t a_s = base + s * kStageBytes + wg * 8192;
    const uint32_t b_s = base + s * kStageBytes + kABytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = A_MN ? desc_sw128(a_s + kk * 2048, 8192, 1024)
                               : desc_sw128(a_s + kk * 32, 16, 1024);
      const uint64_t db = B_MN ? desc_sw128(b_s + kk * 2048, 8192, 1024)
                               : desc_sw128(b_s + kk * 32, 16, 1024);
      wgmma_ss_n256<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done ...
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % kWgStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
  const int w4 = warp % 4;
  const bool pairs = (n % 2) == 0;  // then (row, even col) is 8-byte aligned
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * wg + 16 * w4 + lane / 4 + 8 * h;
      if (row >= m) continue;
      float* dst = c + static_cast<long long>(row) * n + col;
      const float v0 = alpha * acc[4 * j + 2 * h];
      const float v1 = alpha * acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < n) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (col < n) dst[0] = v0;
        if (col + 1 < n) dst[1] = v1;
      }
    }
  }
}

template <bool A_MN, bool B_MN>
int launch_bf16(const CUtensorMap& ta, const CUtensorMap& tb, float* c, int m,
                int n, int k, float alpha_val, const float* alpha_ptr,
                cudaStream_t stream) {
  auto kern = matmul_bf16<A_MN, B_MN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((m + kBM - 1) / kBM) *
                           ((n + kBN - 1) / kBN);
  kern<<<static_cast<unsigned>(blocks), kWgThreads, kWgSmem, stream>>>(
      ta, tb, c, m, n, k, alpha_val, alpha_ptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Both launch on `stream`, allocate
// nothing, do not synchronise, and return a cudaError_t code (0 on
// success).  c: (m, n) row-major f32, written in full.  alpha is *alpha_ptr
// when that is not NULL, else alpha_val.

// Route "simt": f32 a (m, k) with element strides (sam, sak), f32 b (k, n)
// with strides (sbk, sbn).  m, n < 65,535 * 128 rows of tiles.
extern "C" int zolo_matmul_f32(const void* a, const void* b, void* c, int m,
                               int n, int k, long long sam, long long sak,
                               long long sbk, long long sbn, float alpha_val,
                               const void* alpha_ptr, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* cp = static_cast<float*>(c);
  const float* al = static_cast<const float*>(alpha_ptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A is read along k when its k stride is 1, else along its rows; B
  // along its columns when their stride is 1, else along k
  const bool a_kfast = sak == 1 && sam != 1;
  const bool b_kfast = sbn != 1 && sbk == 1;
  if (a_kfast && b_kfast)
    return launch_f32<true, true>(ap, bp, cp, m, n, k, sam, sak, sbk, sbn,
                                  alpha_val, al, st);
  if (a_kfast)
    return launch_f32<true, false>(ap, bp, cp, m, n, k, sam, sak, sbk, sbn,
                                   alpha_val, al, st);
  if (b_kfast)
    return launch_f32<false, true>(ap, bp, cp, m, n, k, sam, sak, sbk, sbn,
                                   alpha_val, al, st);
  return launch_f32<false, false>(ap, bp, cp, m, n, k, sam, sak, sbk, sbn,
                                  alpha_val, al, st);
}

// Route "wgmma": bf16 a (m, k) and b (k, n), k >= 1.  a_mn = 0: a is
// row-major with leading dimension lda (a[i, kk] at a + i lda + kk);
// a_mn = 1: a is column-major (a[i, kk] at a + kk lda + i).  b_mn = 1: b is
// row-major (b[kk, j] at b + kk ldb + j); b_mn = 0: column-major (b[kk, j] at
// b + j ldb + kk).  lda and ldb are multiples of 8, a and b 16-byte aligned.
extern "C" int zolo_matmul_bf16(const void* a, int a_mn, long long lda,
                                const void* b, int b_mn, long long ldb,
                                void* c, int m, int n, int k, float alpha_val,
                                const void* alpha_ptr, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || lda % 8 || ldb % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  const uint64_t sa[1] = {static_cast<uint64_t>(lda) * 2};
  const uint64_t sb[1] = {static_cast<uint64_t>(ldb) * 2};
  int err;
  if (a_mn) {
    const uint64_t dims[2] = {static_cast<uint64_t>(m),
                              static_cast<uint64_t>(k)};
    const uint32_t box[2] = {64, 64};
    err = hopper::encode_bf16_map(&ta, a, 2, dims, sa, box);
  } else {
    const uint64_t dims[2] = {static_cast<uint64_t>(k),
                              static_cast<uint64_t>(m)};
    const uint32_t box[2] = {64, kBM};
    err = hopper::encode_bf16_map(&ta, a, 2, dims, sa, box);
  }
  if (err) return err;
  if (b_mn) {
    const uint64_t dims[2] = {static_cast<uint64_t>(n),
                              static_cast<uint64_t>(k)};
    const uint32_t box[2] = {64, 64};
    err = hopper::encode_bf16_map(&tb, b, 2, dims, sb, box);
  } else {
    const uint64_t dims[2] = {static_cast<uint64_t>(k),
                              static_cast<uint64_t>(n)};
    const uint32_t box[2] = {64, kBN};
    err = hopper::encode_bf16_map(&tb, b, 2, dims, sb, box);
  }
  if (err) return err;
  float* cp = static_cast<float*>(c);
  const float* ap = static_cast<const float*>(alpha_ptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_mn && b_mn)
    return launch_bf16<true, true>(ta, tb, cp, m, n, k, alpha_val, ap, st);
  if (a_mn)
    return launch_bf16<true, false>(ta, tb, cp, m, n, k, alpha_val, ap, st);
  if (b_mn)
    return launch_bf16<false, true>(ta, tb, cp, m, n, k, alpha_val, ap, st);
  return launch_bf16<false, false>(ta, tb, cp, m, n, k, alpha_val, ap, st);
}
