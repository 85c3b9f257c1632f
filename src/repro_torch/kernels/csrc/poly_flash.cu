// Exact polynomial attention for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// Replaces src/repro/kernels/poly_flash.py::poly_flash_pallas (the Pallas
// TPU kernel, body `_kernel`): the paper's quadratic baseline,
//   out_i = sum_j w_ij v_j / (1 + sum_j w_ij),   w_ij = (<q_i, k_j> * scale)^p
// over j <= i (causal, n == t) or over every key (non-causal, any t).
//
// Layout. One CTA per (64-query tile, bh row), flash-style over 64-key
// tiles: load the key and value tile into shared memory, score it, mask it,
// take the power, and fold it into f32 accumulators held in registers.
// x^p needs no running max, so nothing is rescaled between tiles. In the
// causal mode the tiles above the diagonal are skipped and the diagonal
// tile is masked. out = acc / (1 + den) is written once. The tile code is
// common.cuh's tile_accumulate, which polysketch_causal.cu's pass 3 runs
// over the tiles of one semantic block and this kernel over every key
// tile. Rows past n (or t) are loaded as zeros and masked, so any n is
// taken: no padding.
//
// What bounds it. At the serving shape (bh = 48, n = 2040, h = 64, p = 4,
// f32) the causal pairs are ~2.08 M per row; at 2h + 2h + ~4 operations a
// pair that is ~26 GFLOP against ~100 MB of q, k, v and out: bound by
// operations, ~0.39 ms at the f32 FMA peak. This version runs on the f32
// FMA pipes (no tensor cores: f32 inputs, and TF32 is not held to the 1e-4
// tolerance), keeps every operand tile in shared memory and tiles each
// thread's outputs in registers: a thread owns 4 query rows x 4 keys of the
// scores and 4 query rows x h/16 columns of the output, so an inner step
// reads 8 shared values for 16 FMAs. wgmma, TMA staging and bf16 operands
// are later work.

#include <stddef.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                       // query rows / key rows per tile
constexpr int kSide = 16;                       // 16 x 16 threads per tile
constexpr int kRowsPerThread = kTile / kSide;   // query rows (and keys) per thread
constexpr int kMaxH = 128;

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows, int width,
                                          int stride) {
  load_rows<kTile, kThreads>(dst, src, rows, width, stride);
}

// grid (ceil(n / 64), bh). Thread (tr, tc) owns query rows tr + 16a
// (a < 4); in the scores it owns keys tc + 16c, in the output columns
// tc + 16c (c < kCols, kCols = ceil(h / 16) rounded to 4 or 8).
template <typename T, bool kCausal, int kCols>
__global__ void __launch_bounds__(kThreads)
poly_flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int n, int t, int h, int degree, float scale) {
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, tr = tid / kSide, tc = tid % kSide;
  const int q0 = qt * kTile;
  const int qrows = min(kTile, n - q0);
  const int hs = h + 1;                // padded stride avoids bank conflicts

  extern __shared__ float smem[];
  float* q_s = smem;                   // kTile x hs
  float* k_s = q_s + kTile * hs;       // kTile x hs
  float* v_s = k_s + kTile * hs;       // kTile x h
  float* w_s = v_s + kTile * h;        // kTile x (kTile + 1)

  load_tile(q_s, q + ((size_t)bh * n + q0) * h, qrows, h, hs);

  float acc[kRowsPerThread][kCols];
  float den[kRowsPerThread];
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    den[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
  }

  const int ktiles = kCausal ? qt + 1 : (t + kTile - 1) / kTile;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * kTile;
    const int krows = min(kTile, t - k0);
    __syncthreads();   // the previous tile's readers are done
    load_tile(k_s, k + ((size_t)bh * t + k0) * h, krows, h, hs);
    load_tile(v_s, v + ((size_t)bh * t + k0) * h, krows, h, h);
    __syncthreads();
    tile_accumulate<kTile, kSide, kCols, true>(q_s, k_s, h, hs, v_s, h, w_s, q0, qrows, k0,
                                               krows, kCausal, PowWeight{scale, degree}, acc,
                                               den);
  }

#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int row = tr + kSide * a;
    if (row >= qrows) continue;
    const float inv = 1.f / (1.f + den[a]);
    T* orow = out + ((size_t)bh * n + q0 + row) * h;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tc + kSide * c;
      if (d < h) orow[d] = from_f32<T>(acc[a][c] * inv);
    }
  }
}

template <typename T, bool kCausal, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int n,
                   int t, int h, int degree, float scale, cudaStream_t stream) {
  const size_t smem =
      ((size_t)2 * kTile * (h + 1) + (size_t)kTile * h + (size_t)kTile * (kTile + 1)) *
      sizeof(float);
  auto kernel = poly_flash_kernel<T, kCausal, kCols>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q),
                                           static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), n,
                                           t, h, degree, scale);
  return cudaGetLastError();
}

template <typename T, bool kCausal>
cudaError_t run(const void* q, const void* k, const void* v, void* out, int bh, int n, int t,
                int h, int degree, float scale, cudaStream_t stream) {
  if (h <= 4 * kSide) {
    return launch<T, kCausal, 4>(q, k, v, out, bh, n, t, h, degree, scale, stream);
  }
  return launch<T, kCausal, kMaxH / kSide>(q, k, v, out, bh, n, t, h, degree, scale, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous tensors of one type (dtype 0 = float32, 1 = bfloat16):
// q, out (bh, n, h); k, v (bh, t, h). causal requires n == t. Requires
// h <= 128. Returns the first CUDA error (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int poly_flash_forward(const void* q, const void* k, const void* v, void* out,
                                  int bh, int n, int t, int h, int degree, float scale,
                                  int causal, int dtype, void* stream) {
  if (bh <= 0 || n <= 0 || t <= 0 || h < 1 || h > kMaxH || degree < 1 || bh > 65535 ||
      (causal && n != t)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(causal ? run<float, true>(q, k, v, out, bh, n, t, h, degree, scale, s)
                        : run<float, false>(q, k, v, out, bh, n, t, h, degree, scale, s));
  }
  if (dtype == 1) {
    return (int)(causal
                     ? run<__nv_bfloat16, true>(q, k, v, out, bh, n, t, h, degree, scale, s)
                     : run<__nv_bfloat16, false>(q, k, v, out, bh, n, t, h, degree, scale, s));
  }
  return (int)cudaErrorInvalidValue;
}
