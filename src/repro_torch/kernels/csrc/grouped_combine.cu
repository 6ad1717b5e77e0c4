// K2: fused r-term combine  Y = mhat * (xw * X + sum_j a_j T_j)  for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/grouped_combine.py::_grouped_combine_kernel
// (grouped_combine_kernel_call; polar_update_kernel_call is its xw = 1
// form).  X and Y are (m, n), T is (r, m, n), all contiguous; X/Y and T
// are each f32 or bf16 (a bf16 iterate's terms are f32).  It reads X and
// T[0..r-1] once and writes Y once, accumulating in f32 and rounding once
// to Y's dtype.
//
// Bound on the H100: bytes.  At r = 4 and m = n = 11,999 in f32 it moves
// (r + 2) m n 4 B = 3.46 GB, 1.03 ms at 3.35 TB/s, for (2r + 2) m n flops
// — about 0.3 flop per byte.  Design for that bound: one grid-stride pass
// over the flat m n elements (the arrays are contiguous, so rows need no
// separate handling and coalescing is along n); the weights a are read
// from device memory, and mhat and xw each from device memory or by value
// (no host sync per launch, and no launch but this one per call); r + 1
// independent loads per element keep enough bytes in flight.  Where every base pointer is
// 16-byte (f32) or 8-byte (bf16) aligned and m n is a multiple of 4, each
// thread moves 4 elements per load; otherwise (e.g. n = 11,999, whose
// T[j] slices start at odd element offsets) it takes the scalar path.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive elements as one 16-byte (f32) or 8-byte (bf16) access
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static __device__ __forceinline__ void get(const float* p, float* v) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void put(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ void get(const __nv_bfloat16* p,
                                             float* v) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p,
                                             const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 r;
    r.x = *reinterpret_cast<uint32_t*>(&lo);
    r.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = r;
  }
};

// mhat and xw: each through a device pointer when it is non-null, else the
// value passed with the launch
struct Scalars {
  const float* mhat_p;
  const float* xw_p;
  float mhat_v;
  float xw_v;
  __device__ __forceinline__ float mhat() const {
    return mhat_p ? *mhat_p : mhat_v;
  }
  __device__ __forceinline__ float xw() const { return xw_p ? *xw_p : xw_v; }
};

template <typename TX, typename TT>
__global__ void __launch_bounds__(kThreads)
combine_scalar(const TX* __restrict__ x, const TT* __restrict__ t,
               TX* __restrict__ y, long long total, int r,
               const float* __restrict__ a, Scalars s) {
  float aj[kMaxR];
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) aj[j] = j < r ? a[j] : 0.0f;
  const float mhat = s.mhat();
  const float xw = s.xw();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    float acc = xw * to_f32(x[i]);
#pragma unroll
    for (int j = 0; j < kMaxR; ++j)
      if (j < r) acc += aj[j] * to_f32(t[j * total + i]);
    y[i] = from_f32<TX>(mhat * acc);
  }
}

template <typename TX, typename TT>
__global__ void __launch_bounds__(kThreads)
combine_vec4(const TX* __restrict__ x, const TT* __restrict__ t,
             TX* __restrict__ y, long long total, int r,
             const float* __restrict__ a, Scalars s) {
  float aj[kMaxR];
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) aj[j] = j < r ? a[j] : 0.0f;
  const float mhat = s.mhat();
  const float xw = s.xw();
  const long long groups = total / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long i = 4 * g;
    float acc[4], v[4];
    Vec4<TX>::get(x + i, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = xw * v[e];
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      if (j < r) {
        Vec4<TT>::get(t + j * total + i, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += aj[j] * v[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = mhat * acc[e];
    Vec4<TX>::put(y + i, acc);
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename TX, typename TT>
int launch(const void* xv, const void* tv, void* yv, long long total, int r,
           const void* a, Scalars sc, void* stream) {
  if (total <= 0) return 0;
  const TX* x = static_cast<const TX*>(xv);
  const TT* t = static_cast<const TT*>(tv);
  TX* y = static_cast<TX*>(yv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = total % 4 == 0 && aligned(x, 4 * sizeof(TX)) &&
                   aligned(y, 4 * sizeof(TX)) && aligned(t, 4 * sizeof(TT));
  const long long work = vec ? total / 4 : total;
  // enough resident threads to cover the latency of r + 1 streams of
  // loads, then grid-stride
  const long long cap = 132LL * 16;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  const float* af = static_cast<const float*>(a);
  if (vec)
    combine_vec4<TX, TT><<<(int)blocks, kThreads, 0, st>>>(x, t, y, total, r,
                                                           af, sc);
  else
    combine_scalar<TX, TT><<<(int)blocks, kThreads, 0, st>>>(x, t, y, total,
                                                             r, af, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  x_bf16 / t_bf16 select each
// operand's dtype (0: f32, 1: bf16; y has x's dtype).  total = m * n;
// t holds r (1..8) contiguous slices of `total` elements; a: r device
// f32 weights; mhat and xw: a device f32 pointer each, or NULL to take the
// value passed beside it.  Launches one kernel on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an r outside 1..8.
extern "C" int zolo_grouped_combine(int x_bf16, int t_bf16, const void* x,
                                    const void* t, void* y, long long total,
                                    int r, const void* a, const void* mhat_p,
                                    float mhat_v, const void* xw_p,
                                    float xw_v, void* stream) {
  if (r < 1 || r > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s{static_cast<const float*>(mhat_p),
                  static_cast<const float*>(xw_p), mhat_v, xw_v};
  if (!x_bf16 && !t_bf16)
    return launch<float, float>(x, t, y, total, r, a, s, stream);
  if (!x_bf16 && t_bf16)
    return launch<float, __nv_bfloat16>(x, t, y, total, r, a, s, stream);
  if (x_bf16 && !t_bf16)
    return launch<__nv_bfloat16, float>(x, t, y, total, r, a, s, stream);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, t, y, total, r, a, s,
                                              stream);
}
