// K5: batched blocked Cholesky  Z = L L^T  of a stack of f32 matrices for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference leaves Cholesky to XLA
// (jnp.linalg.cholesky).  It takes the place of torch.linalg.cholesky_ex
// (cuSOLVER's batched potrf) for large f32 stacks: core/linalg.py::cholesky
// routes an f32 (..., n, n) stack of two or more matrices with n >=
// CHOLESKY_MIN_N here (kernels/cholesky.py), above all the dense polar
// stage's r = 4 shifted Grams Z_j = G + c_j I at n = 11,999, three stacks a
// solve.
//
// Bound on the H100: operations, b n^3 / 3 flops at the 67 TFLOP/s f32 rate
// outside the tensor cores (every product a true f32 FFMA: no TF32), 34 ms
// for (4, 11,999, 11,999); the bytes (b 8 n^2: Z read, L written) take 7 ms.
// Nearly all the operations are the trailing updates A22 -= L21 L21^T, a
// Gram product; the diagonal blocks and the panels are a chain of small
// dependent steps that leaves most of the card idle unless the stack's
// matrices run side by side.
//
// Design.  The output L is column-major (LAPACK's layout, the strides
// cholesky_ex returns), so its bytes read row-major are M = L^T, upper
// triangular: the kernels factor M^T M = Z row by row, M[r][c] (c >= r) at
// m + r n + c, the stack's entries one after another (batch on the grid's z
// axis everywhere, so the 4 shifted matrices fill the card together).
// One C call issues every launch (no Python loop over the steps):
//
// * chol_prep: M[r][c] = Z[c][r] for c >= r (Z's lower triangle, read
//   through its strides in 32 x 32 tiles transposed in shared memory), 0
//   below; info = 0.
// * For each outer step o of kDepth = 512 columns, for each inner block s
//   of kNB = 128 columns inside it:
//   - chol_syrk on the strip (s > o): rows s .. s + 127 of M take the
//     updates of this outer step's earlier panels (depth s - o);
//   - chol_diag: one block of 128 threads a matrix factors the 128 x 128
//     diagonal block, thread c holding column c in registers; the first
//     pivot that is not positive and finite sets info = its 1-based
//     index, as LAPACK does, and every later launch skips that matrix;
//   - chol_panel: M12 <- U11^-T M12 by forward substitution, a thread a
//     column in registers (U11 in shared memory, read as broadcast
//     float4s), written to M and to the panel workspace W (kDepth x ldw a
//     matrix, ldw a multiple of 4 so the update reads float4s; it lies in
//     L2);
// * then chol_syrk on the trailing matrix (rows and columns past the outer
//   step): M22 -= W^T W over the kDepth rows of W, K1's f32 SIMT tile
//   machinery (csrc/gram.cu::gram_slices: 128 x 128 tiles of the upper
//   triangle only, 256 threads of 8 x 8 outputs; 16-row chunks of W
//   double-buffered in shared memory, fed by cp.async); the products are
//   summed from zero while cp.async fetches M's tile into shared memory,
//   and the sum is subtracted there once and written back as whole rows,
//   never below the diagonal.  kDepth > kNB makes the trailing updates
//   deeper than a block (fewer read-modify-writes of M, each one rounding,
//   for the same operations) at the cost of the strip updates: on an H100
//   at (4, 11,999, 11,999) K5 took 88.3 / 75.1 / 70.5 / 68.6 / 67.1 /
//   66.6 ms with 128 / 256 / 384 / 512 / 768 / 1,024 rows, and 512 is
//   kept (deeper ones were slower at (2, 4,096, 4,096)).
//
// No allocation and no host sync: the wrapper allocates M, W and info with
// torch.empty; every launch is on the caller's stream.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kNB = 128;       // columns of a diagonal block
constexpr int kDepth = 4 * kNB;  // rows of W, a trailing update's depth
// (kernels/ref.py's CHOLESKY_BLOCK and CHOLESKY_DEPTH: the wrapper sizes W)
constexpr int kTile = 128;     // the trailing update's tile edge
constexpr int kChunk = 16;     // rows of W a pipeline stage
constexpr int kThreads = 256;  // (kTile / 8)^2: 8 x 8 outputs a thread
constexpr int kVecs = kChunk * kTile / 4 / kThreads;  // float4s a chunk
constexpr int kRowPass = kThreads / (kTile / 4);  // rows a pass
constexpr int kPanelSmem = kNB * kNB * 4;         // U11: 64 KB
constexpr int kStages = 2;                        // W's chunks in flight
constexpr int kStage = 2 * kChunk * kTile;        // floats: a chunk, both
                                                  // operands
constexpr int kPipe = kStages * kStage;
constexpr int kSyrkSmem = (kPipe + kTile * kTile) * 4;  // + M's tile: 96 KB

// M[r][c] = Z[c][r] for c >= r, else 0; block (0, 0) of each matrix zeroes
// its info.  Grid (tiles, tiles, batch) of 32 x 32 tiles, 32 x 8 threads.
__global__ void __launch_bounds__(256)
chol_prep(const float* __restrict__ z, long long zsb, long long zsr,
          long long zsc, float* __restrict__ m, int n,
          int* __restrict__ info) {
  __shared__ float t[32][33];
  const int bz = blockIdx.z;
  const int r0 = blockIdx.y * 32;
  const int c0 = blockIdx.x * 32;
  float* mb = m + static_cast<long long>(bz) * n * n;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&
      threadIdx.y == 0)
    info[bz] = 0;
  const bool upper = c0 + 31 >= r0;  // the tile holds some c >= r
  if (upper) {
    const float* zb = z + static_cast<long long>(bz) * zsb;
    for (int cl = threadIdx.y; cl < 32; cl += 8) {
      const int c = c0 + cl;
      const int r = r0 + threadIdx.x;
      t[cl][threadIdx.x] = (c < n && r < n && c >= r)
                               ? zb[c * zsr + r * zsc]
                               : 0.0f;
    }
    __syncthreads();
  }
  for (int rl = threadIdx.y; rl < 32; rl += 8) {
    const int r = r0 + rl;
    const int c = c0 + threadIdx.x;
    if (r < n && c < n)
      mb[static_cast<long long>(r) * n + c] = upper ? t[threadIdx.x][rl]
                                                    : 0.0f;
  }
}

// The diagonal block and the panel hold a column a thread, its kNB rows in
// registers, and take the kNB pivots in a loop that is not unrolled: a
// register array is indexed by constants only, so after each pivot the
// column shifts up one row (a[r - 1] <- a[r] - ..., the same fused
// multiply-add that updates it) and the pivot row is always a[0].  The
// loop body is a few hundred instructions; unrolled over the pivots it was
// hundreds of KB of code, and fetching it, not the arithmetic, set the
// time.  32-row chunks past the rows still live are skipped.

// The nb x nb diagonal block at (s, s), one block of kNB threads a matrix:
// thread c holds column c of the block's upper triangle; columns and rows
// at or past nb are the identity (a ragged last block).  Row j of U is
// stored as pivot j is taken.  The first pivot that is not positive and
// finite sets info; the rest of the block runs on values nobody reads.
__global__ void __launch_bounds__(kNB, 1)
chol_diag(float* __restrict__ m, int n, int s, int nb,
          int* __restrict__ info) {
  const int bz = blockIdx.z;
  if (info[bz] != 0) return;  // failed before: the entry is NaN-filled
  // row j of the block from its diagonal on: rows[j & 1][r] = S[j][j + r]
  __shared__ __align__(16) float rows[2][kNB];
  float* mb = m + static_cast<long long>(bz) * n * n +
              static_cast<long long>(s) * n + s;
  const int c = threadIdx.x;
  const int cmax = c | 31;  // the last column of this thread's warp
  rows[0][c] = 0.0f;        // the shifted rows' tails: finite, read only
  rows[1][c] = 0.0f;        // for rows past the block
  float a[kNB];
#pragma unroll
  for (int r = 0; r < kNB; ++r)
    a[r] = (r <= c && c < nb) ? mb[static_cast<long long>(r) * n + c]
                              : (r == c ? 1.0f : 0.0f);
  int bad_at = -1;
#pragma unroll 1
  for (int j = 0; j < kNB; ++j) {
    float* rj = rows[j & 1];  // the other buffer was read before the last
                              // barrier
    if (c >= j) rj[c - j] = a[0];
    __syncthreads();
    const float piv = rj[0];  // the same value in every thread
    if ((!(piv > 0.0f) || isinf(piv)) && bad_at < 0) bad_at = j;
    const float d = sqrtf(piv);
    const float rd = 1.0f / d;
    const float u = c == j ? d : a[0] * rd;  // U[j][c]
    if (c >= j && c < nb && bad_at < 0)
      mb[static_cast<long long>(j) * n + c] = u;
    const float t = u * rd;  // S[j][c] / piv
    // S[j + r][c] -= S[j][j + r] S[j][c] / piv, shifted up one row; rows
    // past c - j (this warp's cmax - j) are not needed
    const int live = cmax - j;
#pragma unroll
    for (int r0 = 0; r0 < kNB; r0 += 32) {
      if (r0 <= live) {
#pragma unroll
        for (int r4 = r0; r4 < r0 + 32; r4 += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&rj[r4]);
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (r4 + e >= 1)
              a[r4 + e - 1] = fmaf(-vv[e], t, a[r4 + e]);
        }
      }
    }
    a[kNB - 1] = 0.0f;
  }
  if (bad_at >= 0 && c == 0) info[bz] = s + bad_at + 1;
}

// M12 <- U11^-T M12 for the columns right of the diagonal block at (s, s),
// a thread a column, kNB columns a block: pivot q divides row q (stored to
// M and to W row wrow + q, column col - wcol), then subtracts it from the
// rows below.  U11 sits in shared memory with its rows shifted, u[q][r] =
// U[q][q + r] (0 past the block), read as broadcast float4s.
__global__ void __launch_bounds__(kNB)
chol_panel(float* __restrict__ m, int n, int s, int nb, float* __restrict__ w,
           long long wsb, int ldw, int wrow, int wcol,
           const int* __restrict__ info) {
  const int bz = blockIdx.z;
  if (info[bz] != 0) return;
  extern __shared__ __align__(16) float u[];  // [kNB][kNB], shifted rows
  float* mb = m + static_cast<long long>(bz) * n * n;
  // every load in flight at once: a row of U11 a step
#pragma unroll
  for (int q = 0; q < kNB; ++q) {
    const int r = threadIdx.x;  // u[q][r] = U[q][q + r]
    u[q * kNB + r] = (q + r < nb)
                         ? mb[static_cast<long long>(s + q) * n + s + q + r]
                         : 0.0f;
  }
  __syncthreads();
  const int col = s + nb + blockIdx.x * kNB + threadIdx.x;
  if (col >= n) return;
  float x[kNB];
#pragma unroll
  for (int r = 0; r < kNB; ++r)
    x[r] = r < nb ? mb[static_cast<long long>(s + r) * n + col] : 0.0f;
  float* mc = mb + static_cast<long long>(s) * n + col;
  float* wc = w + static_cast<long long>(bz) * wsb +
              static_cast<long long>(wrow) * ldw + (col - wcol);
#pragma unroll 1
  for (int q = 0; q < nb; ++q) {
    const float* uq = u + q * kNB;
    const float y = x[0] / uq[0];
    mc[static_cast<long long>(q) * n] = y;
    wc[static_cast<long long>(q) * ldw] = y;
    const int live = nb - 1 - q;  // rows still to solve after this one
#pragma unroll
    for (int r0 = 0; r0 < kNB; r0 += 32) {
      if (r0 <= live) {
#pragma unroll
        for (int r4 = r0; r4 < r0 + 32; r4 += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&uq[r4]);
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (r4 + e >= 1)
              x[r4 + e - 1] = fmaf(-vv[e], y, x[r4 + e]);
        }
      }
    }
    x[kNB - 1] = 0.0f;
  }
}

// rows k0 .. k0 + 15 (below k_end) of W's columns c0 .. c0 + 127 (below nc)
// into one [kChunk][kTile] buffer by cp.async, 16 bytes a copy (W's rows are
// float4-aligned), zero past the ragged edge
__device__ __forceinline__ void panel_fetch(float* s,
                                            const float* __restrict__ w,
                                            int ldw, int nc, int k0,
                                            int k_end, int c0, int tid) {
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    const int r = tid / (kTile / 4) + kRowPass * q;
    const int row = k0 + r;
    const int col = c0 + 4 * (tid % (kTile / 4));
    int bytes = row < k_end ? 4 * (nc - col) : 0;
    bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
    const float* src =
        bytes > 0 ? w + static_cast<long long>(row) * ldw + col : w;
    hopper::cp_async16(
        hopper::smem_u32(&s[r * kTile + 4 * (tid % (kTile / 4))]), src,
        bytes);
  }
}

// M[g + i][g + j] -= sum_q W[q][i] W[q][j] for j >= i, i, j < nt, over
// the tiles (bi, bj) with bi < row_tiles, bi <= bj < tiles: row_tiles =
// tiles is the trailing update, 1 the strip of the next diagonal block.
// w points at W's column of index g; depth rows of W.  The products are
// summed from zero and subtracted from M's tile once at the end, as a
// GEMM with beta = 1 does: summed into the tile itself, each of the depth
// products rounds at the tile's magnitude, and the dense solve's
// residual and orthogonality came out ten times larger.
// The tile is fetched into shared memory by cp.async while the products
// run, the difference is taken there, and it is written back as whole
// rows, never below the diagonal.
__global__ void __launch_bounds__(kThreads, 2)
chol_syrk(float* __restrict__ m, int n, int g, int nt, int tiles,
          const float* __restrict__ w, long long wsb, int ldw, int depth,
          const int* __restrict__ info) {
  const int bz = blockIdx.z;
  if (info[bz] != 0) return;
  constexpr int kHalf = kTile / 2;
  extern __shared__ __align__(16) float sm[];
  float* cs = sm + kPipe;               // [kTile][kTile]: M's tile

  int rem = blockIdx.x;
  int bi = 0;
  while (rem >= tiles - bi) {
    rem -= tiles - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;
  float* mb = m + static_cast<long long>(bz) * n * n +
              static_cast<long long>(g) * n + g;
  const float* wb = w + static_cast<long long>(bz) * wsb;
  const int tid = threadIdx.x;

  // M's tile into cs, in flight until the epilogue (elements it will not
  // write are not fetched)
#pragma unroll 8
  for (int e = 0; e < kTile * kTile / kThreads; ++e) {
    const int idx = e * kThreads + tid;
    const int row = i0 + idx / kTile;
    const int col = j0 + idx % kTile;
    if (row < nt && col < nt && col >= row)
      hopper::cp_async4(hopper::smem_u32(cs + idx),
                        mb + static_cast<long long>(row) * n + col, 4);
  }
  hopper::cp_async_commit();

  const int tx = tid % (kTile / 8);  // columns tx*4 .. +3, kHalf + tx*4 ..
  const int ty = tid / (kTile / 8);  // rows    ty*4 .. +3, kHalf + ty*4 ..
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // a ring of kStages chunks of W (both operands) in shared memory, kept
  // kStages - 1 chunks ahead by cp.async; one group a chunk
  const int chunks = (depth + kChunk - 1) / kChunk;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < chunks) {
      panel_fetch(sm + st * kStage, wb, ldw, nt, st * kChunk, depth, i0,
                  tid);
      panel_fetch(sm + st * kStage + kChunk * kTile, wb, ldw, nt,
                  st * kChunk, depth, j0, tid);
    }
    hopper::cp_async_commit();
  }

  for (int kc = 0; kc < chunks; ++kc) {
    // chunk kc is in, for this thread and then for every thread, which all
    // left chunk kc - 1
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kc + kStages - 1;
    if (next < chunks) {  // into the stage chunk kc - 1 held
      float* st = sm + (next % kStages) * kStage;
      panel_fetch(st, wb, ldw, nt, next * kChunk, depth, i0, tid);
      panel_fetch(st + kChunk * kTile, wb, ldw, nt, next * kChunk, depth, j0,
                  tid);
    }
    hopper::cp_async_commit();
    const float* ca = sm + (kc % kStages) * kStage;
    const float* cb = ca + kChunk * kTile;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&ca[kk * kTile + ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&ca[kk * kTile + kHalf + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&cb[kk * kTile + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&cb[kk * kTile + kHalf + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // the tile minus the products, in shared memory (each thread its own
  // elements, once its fetches have landed and every thread's have)
  hopper::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i < 4 ? ty * 4 + i : kHalf + ty * 4 + (i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4* p = reinterpret_cast<float4*>(&cs[r * kTile + h * kHalf +
                                               tx * 4]);
      float4 v = *p;
      v.x -= acc[i][4 * h];
      v.y -= acc[i][4 * h + 1];
      v.z -= acc[i][4 * h + 2];
      v.w -= acc[i][4 * h + 3];
      *p = v;
    }
  }
  __syncthreads();
#pragma unroll 8
  for (int e = 0; e < kTile * kTile / kThreads; ++e) {
    const int idx = e * kThreads + tid;
    const int row = i0 + idx / kTile;
    const int col = j0 + idx % kTile;
    if (row < nt && col < nt && col >= row)
      mb[static_cast<long long>(row) * n + col] = cs[idx];
  }
}

// the update of M from origin (g, g) over nt columns: `row_tiles` tile rows
// (0: all), W's column g - o, `depth` rows of W
cudaError_t launch_syrk(float* m, int n, int g, int row_tiles, const float* w,
                        long long wsb, int ldw, int wcol, int depth,
                        int batch, int* info, cudaStream_t st) {
  const int nt = n - g;
  const int tiles = (nt + kTile - 1) / kTile;
  const int rows = row_tiles > 0 && row_tiles < tiles ? row_tiles : tiles;
  const long long blocks = static_cast<long long>(rows) * tiles -
                           static_cast<long long>(rows) * (rows - 1) / 2;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  chol_syrk<<<dim3(static_cast<unsigned>(blocks), 1, batch), kThreads,
              kSyrkSmem, st>>>(m, n, g, nt, tiles, w + wcol, wsb, ldw, depth,
                               info);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on `stream`, allocates
// nothing, does not synchronise; returns a cudaError_t code (0 on success).
//
// z: batch f32 (n, n) matrices, Z_b[i][j] at z + b zsb + i zsr + j zsc; only
// the lower triangle (i >= j) is read.  m: batch x n x n f32, written in
// full: L_b column-major (L_b[i][j] at m + b n^2 + j n + i, zero above the
// diagonal).  w: the panel workspace, batch x kDepth x ldw f32 (ldw >= n, a
// multiple of 4, w 16-byte aligned), scratch.  info: batch int32, 0 or the
// 1-based index of the first pivot that is not positive and finite.
// batch <= 65,535.
extern "C" int zolo_cholesky_f32(const void* z, long long zsb, long long zsr,
                                 long long zsc, void* m, int n, int batch,
                                 void* w, int ldw, void* info,
                                 void* stream) {
  if (n < 1 || batch < 0 || batch > 65535 || ldw < n || ldw % 4 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  float* mp = static_cast<float*>(m);
  float* wp = static_cast<float*>(w);
  int* ip = static_cast<int*>(info);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long wsb = static_cast<long long>(kDepth) * ldw;
  cudaError_t err = cudaFuncSetAttribute(
      chol_panel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPanelSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        chol_syrk, cudaFuncAttributeMaxDynamicSharedMemorySize, kSyrkSmem);
  if (err == cudaSuccess)  // two blocks an SM: all of it as shared memory
    err = cudaFuncSetAttribute(chol_syrk,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);

  const unsigned t32 = static_cast<unsigned>((n + 31) / 32);
  chol_prep<<<dim3(t32, t32, batch), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(z), zsb, zsr, zsc, mp, n, ip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  for (int o = 0; o < n; o += kDepth) {
    const int e = o + kDepth < n ? o + kDepth : n;
    for (int s = o; s < e; s += kNB) {
      const int nb = n - s < kNB ? n - s : kNB;
      if (s > o) {  // the strip takes this outer step's earlier panels
        err = launch_syrk(mp, n, s, 1, wp, wsb, ldw, s - o, s - o, batch, ip,
                          st);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      chol_diag<<<dim3(1, 1, batch), kNB, 0, st>>>(mp, n, s, nb, ip);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const int cols = n - s - nb;
      if (cols > 0) {
        chol_panel<<<dim3((cols + kNB - 1) / kNB, 1, batch), kNB, kPanelSmem,
                     st>>>(mp, n, s, nb, wp, wsb, ldw, s - o, o, ip);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    if (e < n) {  // the trailing matrix takes every panel of this step
      err = launch_syrk(mp, n, e, 0, wp, wsb, ldw, e - o, e - o, batch, ip,
                        st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
