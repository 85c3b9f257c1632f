// Block lower-triangular multiply O = lt(A B^T) C for NVIDIA Hopper
// (sm_90a), hand-written CUDA: the paper's Section 3.1 primitive.
//
// Replaces src/repro/kernels/lt_mult.py::lt_mult_pallas (the Pallas TPU
// kernel, body `_kernel`). A, B (bh, n, m), C (bh, n, k), diagonal
// included. For every block l of b rows:
//   O_l = tril(A_l B_l^T) C_l + A_l Z_l,   Z_l = H_0 + ... + H_{l-1},
//   H_l = B_l^T C_l                         (m, k) f32
//
// Why three passes, as in polysketch_causal.cu. The TPU walked the blocks
// of one bh row in order on one core and carried Z in VMEM. Z (8 KiB at
// m = 32, k = 64) would fit in one CTA's shared memory, but one CTA per bh
// row walking its blocks in order leaves ~128 of the 132 SMs idle at the
// benchmark's bh = 4. So:
//   pass 1  (bh, block, 32 x 64 tile of H) in parallel: H_l.
//   pass 2  elements of Z in parallel, blocks in order: the exclusive
//           prefix Z_l, written over H_l, added left to right.
//   pass 3  (bh, block, 64-row tile) in parallel: the block's own
//           triangle over 64-row tiles of B and C up to the diagonal, then
//           the cross term A_l Z_l from Z_l in shared memory.
// No atomics; every sum runs in a fixed order, so a run is deterministic.
//
// What bounds it. At the benchmark's shape (bh = 4, m = 32, k = 64,
// b = 256, n = 16384, f32) the block triangles are ~8.4 M pairs x (2m + 2k)
// ~ 1.6 GFLOP and the fold and cross terms ~0.5 GFLOP, against ~50 MB of
// A, B, C and O: bound by operations, ~0.03 ms at the f32 FMA peak, so
// near launch overhead at n = 2048. f32 FMA pipes, operand tiles in
// shared memory, a thread's outputs tiled in registers (4 x 2 in pass 1,
// 4 x 4 scores and 4 x k/16 outputs in pass 3).

#include <stddef.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                       // pass 3: rows per tile
constexpr int kSide = 16;                       // pass 3: 16 x 16 threads per tile
constexpr int kRowsPerThread = kTile / kSide;   // pass 3: rows (and keys) per thread
constexpr int kMaxM = 128;
constexpr int kMaxK = 128;
constexpr int kP1Rows = 32;                     // pass 1: rows of H per CTA
constexpr int kP1RowsPerThread = kP1Rows / (kThreads / 32);
constexpr int kP1ColsPerThread = 2;
constexpr int kP1Cols = 32 * kP1ColsPerThread;  // pass 1: columns of H per CTA

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows, int width,
                                          int stride) {
  load_rows<kThreads>(dst, src, rows, kTile, width, stride);
}

// Pass 1: hz[bh, l, i, c] = sum_{s in block l} b[s, i] c[s, c].
// grid (ceil(m/32) * ceil(k/64), t, bh). A thread owns rows warp + 8a
// (a < 4) and columns lane + 32j (j < 2) of its CTA's 32 x 64 tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_state_kernel(const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ hz,
                   int n, int m, int kk, int b) {
  const int col_tiles = (kk + kP1Cols - 1) / kP1Cols;
  const int rt = blockIdx.x / col_tiles, ct = blockIdx.x - rt * col_tiles;
  const int l = blockIdx.y, t = gridDim.y, bh = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  extern __shared__ float smem[];
  float* b_s = smem;              // kTile x m
  float* c_s = b_s + kTile * m;   // kTile x kk

  int ia[kP1RowsPerThread], cj[kP1ColsPerThread];
#pragma unroll
  for (int a = 0; a < kP1RowsPerThread; ++a) {
    const int i = rt * kP1Rows + warp + 8 * a;
    ia[a] = i < m ? i : 0;   // rows past m compute garbage and are not written
  }
#pragma unroll
  for (int j = 0; j < kP1ColsPerThread; ++j) {
    const int c = ct * kP1Cols + lane + 32 * j;
    cj[j] = c < kk ? c : 0;
  }
  float acc[kP1RowsPerThread][kP1ColsPerThread];
#pragma unroll
  for (int a = 0; a < kP1RowsPerThread; ++a)
#pragma unroll
    for (int j = 0; j < kP1ColsPerThread; ++j) acc[a][j] = 0.f;

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  for (int s0 = 0; s0 < b; s0 += kTile) {
    const int rows = min(kTile, b - s0);
    load_tile(b_s, bm + (row0 + s0) * m, rows, m, m);
    load_tile(c_s, cm + (row0 + s0) * kk, rows, kk, kk);
    __syncthreads();
    for (int s = 0; s < rows; ++s) {
      float x[kP1RowsPerThread], y[kP1ColsPerThread];
#pragma unroll
      for (int a = 0; a < kP1RowsPerThread; ++a) x[a] = b_s[s * m + ia[a]];
#pragma unroll
      for (int j = 0; j < kP1ColsPerThread; ++j) y[j] = c_s[s * kk + cj[j]];
#pragma unroll
      for (int a = 0; a < kP1RowsPerThread; ++a)
#pragma unroll
        for (int j = 0; j < kP1ColsPerThread; ++j) acc[a][j] = fmaf(x[a], y[j], acc[a][j]);
    }
    __syncthreads();
  }
  float* dst = hz + ((size_t)bh * t + l) * m * kk;
#pragma unroll
  for (int a = 0; a < kP1RowsPerThread; ++a) {
    const int i = rt * kP1Rows + warp + 8 * a;
    if (i >= m) continue;
#pragma unroll
    for (int j = 0; j < kP1ColsPerThread; ++j) {
      const int c = ct * kP1Cols + lane + 32 * j;
      if (c < kk) dst[(size_t)i * kk + c] = acc[a][j];
    }
  }
}

// Pass 2: in place over hz, H_l becomes Z_l = H_0 + ... + H_{l-1}, added
// left to right.
__global__ void __launch_bounds__(kThreads)
prefix_kernel(float* __restrict__ hz, int bh_count, int t, int mk) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)bh_count * mk) return;
  const size_t bh = idx / mk, e = idx - bh * mk;
  float* cur = hz + bh * t * mk + e;
  float z = 0.f;
  for (int l = 0; l < t; ++l) {
    const float h_l = cur[(size_t)l * mk];
    cur[(size_t)l * mk] = z;
    z = z + h_l;
  }
}

// Pass 3: outputs of one 64-row tile of block l. grid (ceil(b/64), t, bh).
// Thread (tr, tc) owns rows tr + 16a (a < 4); in the scores it owns keys
// tc + 16c, in the outputs columns tc + 16c (c < kCols).
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
output_kernel(const T* __restrict__ am, const T* __restrict__ bm, const T* __restrict__ cm,
              const float* __restrict__ zz, T* __restrict__ out, int n, int m, int kk, int b) {
  const int qt = blockIdx.x, l = blockIdx.y, bh = blockIdx.z, t = gridDim.y;
  const int tid = threadIdx.x, tr = tid / kSide, tc = tid % kSide;
  const int q0 = qt * kTile;
  const int qrows = min(kTile, b - q0);
  const int ms = m + 1;                // padded strides avoid bank conflicts
  const int ws = kTile + 1;

  extern __shared__ float smem[];
  float* a_s = smem;                   // kTile x ms
  float* b_s = a_s + kTile * ms;       // kTile x ms
  float* c_s = b_s + kTile * ms;       // kTile x kk
  float* w_s = c_s + kTile * kk;       // kTile x ws
  float* z_s = w_s + kTile * ws;       // m x kk

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  load_tile(a_s, am + (row0 + q0) * m, qrows, m, ms);

  float acc[kRowsPerThread][kCols];
  float no_den[kRowsPerThread];        // lt(A B^T) C has no denominator
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;

  // ---- the block's own triangle: tril(A_l B_l^T) C_l ----
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    const int krows = min(kTile, b - k0);
    __syncthreads();   // the previous tile's readers are done
    load_tile(b_s, bm + (row0 + k0) * m, krows, m, ms);
    load_tile(c_s, cm + (row0 + k0) * kk, krows, kk, kk);
    __syncthreads();
    tile_accumulate<kTile, kSide, kCols, false>(a_s, b_s, m, ms, c_s, kk, w_s, q0, qrows, k0,
                                                krows, true, PlainWeight{}, acc, no_den);
  }

  // ---- the earlier blocks through Z_l: A_l Z_l ----
  const float* zsrc = zz + ((size_t)bh * t + l) * m * kk;
  for (int idx = tid; idx < m * kk; idx += kThreads) z_s[idx] = zsrc[idx];
  __syncthreads();
  for (int e = 0; e < m; ++e) {
    float av[kRowsPerThread];
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a) av[a] = a_s[(tr + kSide * a) * ms + e];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tc + kSide * c;
      if (d < kk) {
        const float zv = z_s[e * kk + d];
#pragma unroll
        for (int a = 0; a < kRowsPerThread; ++a) acc[a][c] = fmaf(av[a], zv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int row = tr + kSide * a;
    if (row >= qrows) continue;
    T* orow = out + (row0 + q0 + row) * kk;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tc + kSide * c;
      if (d < kk) orow[d] = from_f32<T>(acc[a][c]);
    }
  }
}

template <typename T, int kCols>
cudaError_t launch_output(const void* a, const void* b, const void* c, const float* zz,
                          void* out, int bh, int n, int m, int kk, int blk,
                          cudaStream_t stream) {
  const size_t smem = ((size_t)2 * kTile * (m + 1) + (size_t)kTile * kk +
                       (size_t)kTile * (kTile + 1) + (size_t)m * kk) *
                      sizeof(float);
  auto kernel = output_kernel<T, kCols>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((blk + kTile - 1) / kTile, n / blk, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                           static_cast<const T*>(c), zz, static_cast<T*>(out),
                                           n, m, kk, blk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* a, const void* b, const void* c, void* out, float* hz, int bh,
                int n, int m, int kk, int blk, cudaStream_t stream) {
  const int t = n / blk;
  const size_t smem1 = (size_t)kTile * (m + kk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(block_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return err;
  const dim3 grid1(((m + kP1Rows - 1) / kP1Rows) * ((kk + kP1Cols - 1) / kP1Cols), t, bh);
  block_state_kernel<T><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), hz, n, m, kk, blk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t total = (size_t)bh * m * kk;
  prefix_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      hz, bh, t, m * kk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (kk <= 4 * kSide) {
    return launch_output<T, 4>(a, b, c, hz, out, bh, n, m, kk, blk, stream);
  }
  return launch_output<T, kMaxK / kSide>(a, b, c, hz, out, bh, n, m, kk, blk, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous tensors of one type (dtype 0 = float32, 1 = bfloat16):
// a, b (bh, n, m); c, out (bh, n, k); hz (bh, n/blk, m, k) float32
// scratch. Requires n % blk == 0, m <= 128 and k <= 128. Returns the first
// CUDA error (0 on success); launches on `stream` and does not synchronise.
extern "C" int lt_mult_forward(const void* a, const void* b, const void* c, void* out,
                               float* hz, int bh, int n, int m, int k, int blk, int dtype,
                               void* stream) {
  if (bh <= 0 || n <= 0 || blk <= 0 || n % blk != 0 || m < 1 || m > kMaxM || k < 1 ||
      k > kMaxK || bh > 65535 || n / blk > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(a, b, c, out, hz, bh, n, m, k, blk, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(a, b, c, out, hz, bh, n, m, k, blk, s);
  return (int)cudaErrorInvalidValue;
}
