// Exact polynomial attention for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// Replaces src/repro/kernels/poly_flash.py::poly_flash_pallas (the Pallas
// TPU kernel, body `_kernel`): the paper's quadratic baseline,
//   out_i = sum_j w_ij v_j / (1 + sum_j w_ij),   w_ij = (<q_i, k_j> * scale)^p
// over j <= i (causal, n == t) or over every key (non-causal, any t).
//
// Layout. One CTA of 4 warps per (64-query tile, bh row), the last query
// tile (the one with most keys) first. It runs common.cuh's tc_flash_loop
// over the 64-key tiles: each key and value tile is staged with cp.async
// into a ring of two, and each warp scores its 16 rows against the tile on
// the tensor cores (Q K^T), takes the power and the mask on the
// accumulator in registers, and folds W V into f32 accumulators, also on
// the tensor cores. x^p needs no running max, so nothing is rescaled
// between tiles. In the causal mode the tiles above the diagonal are
// skipped and only the diagonal tile is masked. out = acc / (1 + den) is
// written once. polysketch_causal.cu's pass 3 runs the same routine over
// the tiles of one semantic block. Rows past n (or t) are staged as zeros
// (their weights are 0) and are not stored, so any n is taken: no padding.
// For training, den_out (when not null) also receives D = 1 + den of every
// row (f32), what the backward (poly_flash_bwd.cu) reads; the outputs are
// the same bits with it or without it.
//
// What bounds it. At the serving shape (bh = 48, n = 2040, h = 64, p = 4,
// f32) the causal pairs are ~2.08 M per row: 25.6 GFLOP of products (Q K^T
// and W V) and 0.4 GFLOP of scale, power and sums, against 100 MB of q, k,
// v and out. Both products run on the tensor cores in 3xTF32 (common.cuh),
// so the least time is 3 x 25.6 GFLOP at 495 TFLOP/s plus the rest at
// 67 TFLOP/s, 0.161 ms: bound by operations (0.388 ms on the f32 FMA
// pipes). bf16 inputs are staged as f32 and take the same path.
//
// Registers (nvcc -Xptxas -v, as chip_smoke.py prints it): 232-245 a
// thread for every instantiation (f32 causal h <= 64: 235), no spills, no
// stack. With 87 KB of shared memory at h = 64, two CTAs (8 warps) share
// an SM.

#include <stddef.h>

#include "common.cuh"

namespace {

constexpr int kMaxH = 128;

// grid (ceil(n / 64), bh), kTcThreads threads. kNT = output n-tiles of 8
// columns, 8 for h <= 64 and 16 for h <= 128.
template <typename T, bool kCausal, int kNT>
__global__ void __launch_bounds__(kTcThreads)
poly_flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, float* __restrict__ den_out, int n, int t, int h,
                  int degree, float scale) {
  // the last query tile (most key tiles) first, so the grid's tail is short
  const int qt = gridDim.x - 1 - blockIdx.x, bh = blockIdx.y;
  const int q0 = qt * kTcTile;
  const int qrows = min(kTcTile, n - q0);
  const int qs = row_frag_stride(h), vs = pair_frag_stride(h);

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                         // kTcTile x qs
  float* k_ring = q_s + kTcTile * qs;        // 2 x kKeyTile x qs
  float* v_ring = k_ring + 2 * kKeyTile * qs;   // 2 x kKeyTile x vs

  zero_pad_cols<kTcThreads>(q_s, kTcTile + 2 * kKeyTile, h, qs);
  zero_pad_cols<kTcThreads>(v_ring, 2 * kKeyTile, h, vs);
  stage_rows<kTcThreads>(q_s, q + ((size_t)bh * n + q0) * h, qrows, kTcTile, h, qs);

  float acc[kNT][4];
  float den[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < kNT; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  const int ktiles = ((kCausal ? q0 + qrows : t) + kKeyTile - 1) / kKeyTile;
  tc_flash_loop<kNT, kNT, 8 * kNT>(q_s, qs, k + (size_t)bh * t * h, v + (size_t)bh * t * h, h,
                                   h, t, ktiles, k_ring, qs, v_ring, vs, q0, qrows, kCausal,
                                   PowWeight{scale, degree}, acc, den);
  quad_sum(den);
  tc_store_rows<kNT>(out + ((size_t)bh * n + q0) * h, h, qrows, acc, den);
  if (den_out != nullptr && (threadIdx.x & 3) == 0) {
    const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row + 8 * i < qrows) den_out[(size_t)bh * n + q0 + row + 8 * i] = 1.f + den[i];
    }
  }
}

template <typename T, bool kCausal, int kNT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* den_out,
                   int bh, int n, int t, int h, int degree, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)(kTcTile + 2 * kKeyTile) * row_frag_stride(h) +
                       (size_t)2 * kKeyTile * pair_frag_stride(h)) *
                      sizeof(float);
  auto kernel = poly_flash_kernel<T, kCausal, kNT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTcTile - 1) / kTcTile, bh);
  kernel<<<grid, kTcThreads, smem, stream>>>(static_cast<const T*>(q),
                                             static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<T*>(out),
                                             den_out, n, t, h, degree, scale);
  return cudaGetLastError();
}

template <typename T, bool kCausal>
cudaError_t run(const void* q, const void* k, const void* v, void* out, float* den_out, int bh,
                int n, int t, int h, int degree, float scale, cudaStream_t stream) {
  if (h <= 64) {
    return launch<T, kCausal, 8>(q, k, v, out, den_out, bh, n, t, h, degree, scale, stream);
  }
  return launch<T, kCausal, kMaxH / 8>(q, k, v, out, den_out, bh, n, t, h, degree, scale,
                                       stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous tensors of one type (dtype 0 = float32, 1 = bfloat16):
// q, out (bh, n, h); k, v (bh, t, h); den_out (bh, n) float32, or null.
// causal requires n == t. Requires h <= 128. Returns the first CUDA error
// (0 on success); launches on `stream` and does not synchronise.
extern "C" int poly_flash_forward(const void* q, const void* k, const void* v, void* out,
                                  float* den_out, int bh, int n, int t, int h, int degree,
                                  float scale, int causal, int dtype, void* stream) {
  if (bh <= 0 || n <= 0 || t <= 0 || h < 1 || h > kMaxH || degree < 1 || bh > 65535 ||
      (causal && n != t)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(causal
                     ? run<float, true>(q, k, v, out, den_out, bh, n, t, h, degree, scale, s)
                     : run<float, false>(q, k, v, out, den_out, bh, n, t, h, degree, scale, s));
  }
  if (dtype == 1) {
    return (int)(causal ? run<__nv_bfloat16, true>(q, k, v, out, den_out, bh, n, t, h, degree,
                                                   scale, s)
                        : run<__nv_bfloat16, false>(q, k, v, out, den_out, bh, n, t, h,
                                                    degree, scale, s));
  }
  return (int)cudaErrorInvalidValue;
}
