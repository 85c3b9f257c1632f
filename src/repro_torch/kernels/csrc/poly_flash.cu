// Exact polynomial attention for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// Replaces src/repro/kernels/poly_flash.py::poly_flash_pallas (the Pallas
// TPU kernel, body `_kernel`): the paper's quadratic baseline,
//   out_i = sum_j w_ij v_j / (1 + sum_j w_ij),   w_ij = (<q_i, k_j> * scale)^p
// over j <= i (causal, n == t) or over every key (non-causal, any t).
//
// Layout. One CTA of 384 threads per (128-query tile, bh row), the last
// query tile (the one with most keys) first: two consumer warpgroups of 64
// query rows and a producer warpgroup. It runs wgmma_planes.cuh's forward
// flash diagonal over the key tiles (64 keys; 32 at h > 64): the producer
// bulk-copies each key and value tile into a ring of three slots
// (cp.async.bulk on mbarriers) and splits it once for the CTA into TF32
// planes; each consumer warpgroup scores its rows against the tile on
// wgmma (S = Q K^T, Q held in registers), takes the power and the mask on
// the accumulator, and folds W V into f32 accumulators, W going from the
// scores' accumulator into the A operand as it stands. x^p needs no running
// max, so nothing is rescaled between tiles. In the causal mode the tiles
// above the diagonal are skipped and only those that cross it are masked.
// out = acc / (1 + den) is written once. polysketch_causal.cu's pass 3 runs
// the same routine over the tiles of one semantic block. Rows past n (or t)
// are zero (their weights are 0) and are not stored, so any n is taken: no
// padding. For training, den_out (when not null) also receives D = 1 + den
// of every row (f32), what the backward (poly_flash_bwd.cu) reads; the
// outputs are the same bits with it or without it.
//
// What bounds it. At the serving shape (bh = 48, n = 2040, h = 64, p = 4,
// f32) the causal pairs are ~2.08 M per row: 25.6 GFLOP of products (Q K^T
// and W V) and 0.4 GFLOP of scale, power and sums, against 100 MB of q, k,
// v and out. Both products run on wgmma in 3xTF32 (common.cuh's split
// rule), so the least time is 3 x 25.6 GFLOP at 495 TFLOP/s plus the rest
// at 67 TFLOP/s, 0.161 ms: bound by operations (0.388 ms on the f32 FMA
// pipes). In bf16 Q, K and V have no lo half: S is one TF32 product and
// W V two. chip_smoke.py's b2_bound counts W V's two passes and S at the
// bf16 tensor cores' rate (half a TF32 pass): 0.44 of f32's bound.
//
// Registers and shared memory (nvcc -Xptxas -v, and chip_smoke.py's
// forward_occupancy, which prints each instantiation's): ptxas allocates
// 168 a thread, the bound of 384 threads and one CTA an SM, and the
// producers give the consumers theirs (setmaxnreg: 56 and 224 a thread).
// The widest instantiations still spill a little (PERF.md). Shared
// memory: 224 KB at h 64 in f32 (the ring 96 KB, two plane sets 128 KB),
// so one CTA an SM.

#include <stddef.h>

#include "wgmma_planes.cuh"

namespace {

constexpr int kMaxH = 128;

// grid (ceil(n / 128), bh), kFlashThreads threads. kNV = output n-tiles of
// 8 columns, 8 for h <= 64 and 16 for h <= 128. bulk: every key and value
// row starts 16-byte aligned (h * sizeof(T) a multiple of 16, aligned
// pointers), so the tiles are bulk-copied; otherwise the producers read
// them straight from device memory.
template <typename T, bool kCausal, int kNV>
__global__ void __launch_bounds__(kFlashThreads, 1)
poly_flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, float* __restrict__ den_out, int n, int t, int h,
                  int degree, float scale, int bulk) {
  using C = Flash<T, 8 * kNV, kNV>;
  extern __shared__ __align__(128) char smem[];
  // the last query tile (most key tiles) first, so the grid's tail is short
  const int qt = gridDim.x - 1 - blockIdx.x, bh = blockIdx.y;
  const int q0 = qt * kFlashRows, qrows = min(kFlashRows, n - q0);
  const int ktiles = ((kCausal ? q0 + qrows : t) + C::kKeys - 1) / C::kKeys;
  const DiagSrc<T> src{k + (size_t)bh * t * h, v + (size_t)bh * t * h, h, h, t};
  flash_init<C>(smem);
  if (threadIdx.x >= kFlashConsumers) {
    flash_producer<C>(
        smem, ktiles, bulk != 0,
        [&](int it, char* raw, uint64_t* bar) { issue_diag<C>(raw, bar, src, it); },
        [&](int it, const char* raw, float* pl, bool staged) {
          if (staged) {
            split_keys<C, true>(pl, src, it, raw);
          } else {
            split_keys<C, false>(pl, src, it, raw);
          }
        });
    return;
  }
  flash_consumer_regs();
  const int wg = threadIdx.x >> 7;
  const int row0 = q0 + 64 * wg, last = q0 + min(64 * wg + 63, qrows - 1);
  const bool active = 64 * wg < qrows;
  QFrags<C> qf;
  load_q<C>(qf, q + ((size_t)bh * n + q0) * h, h, qrows);
  float acc[kNV][4];
  float den[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < kNV; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;
  flash_consume<C>(smem, 0, ktiles, [&](int it, const float* pl) {
    if (active) {
      flash_tile<C>(pl, qf, it * C::kKeys, row0, last, kCausal, PowWeight{scale, degree}, acc,
                    den);
    }
  });
  quad_sum(den);
  tc_store_rows<kNV>(out + ((size_t)bh * n + q0) * h, h, qrows, acc, den);
  if (den_out != nullptr && (threadIdx.x & 3) == 0) {
    const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row + 8 * i < qrows) den_out[(size_t)bh * n + q0 + row + 8 * i] = 1.f + den[i];
    }
  }
}

template <typename T, bool kCausal, int kNV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* den_out,
                   int bh, int n, int t, int h, int degree, float scale, cudaStream_t stream) {
  using C = Flash<T, 8 * kNV, kNV>;
  auto kernel = poly_flash_kernel<T, kCausal, kNV>;
  cudaError_t err = flash_smem_limit<C>(kernel);
  if (err != cudaSuccess) return err;
  const int bulk = (h * sizeof(T)) % 16 == 0 && aligned16(k) && aligned16(v);
  const dim3 grid((n + kFlashRows - 1) / kFlashRows, bh);
  kernel<<<grid, kFlashThreads, Ring<C>::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), den_out, n, t, h, degree, scale, bulk);
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

// What B2's kernel holds on the card at head width h for operands of dtype
// (0 = float32, 1 = bfloat16), causal: five ints into out[5] (registers a
// thread, local memory bytes a thread, dynamic shared memory bytes a CTA,
// threads a CTA, CTAs resident an SM). Returns the first CUDA error (0 on
// success).
extern "C" int poly_flash_forward_occupancy(int h, int dtype, int* out) {
  if (h < 1 || h > kMaxH || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const void* fn;
  size_t smem;
  if (dtype == 0) {
    fn = h <= 64 ? (const void*)poly_flash_kernel<float, true, 8>
                 : (const void*)poly_flash_kernel<float, true, 16>;
    smem = h <= 64 ? Ring<Flash<float, 64, 8>>::kSmemBytes : Ring<Flash<float, 128, 16>>::kSmemBytes;
  } else {
    fn = h <= 64 ? (const void*)poly_flash_kernel<__nv_bfloat16, true, 8>
                 : (const void*)poly_flash_kernel<__nv_bfloat16, true, 16>;
    smem = h <= 64 ? Ring<Flash<__nv_bfloat16, 64, 8>>::kSmemBytes
                   : Ring<Flash<__nv_bfloat16, 128, 16>>::kSmemBytes;
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kFlashThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int row[5] = {a.numRegs, (int)a.localSizeBytes, (int)smem, kFlashThreads, ctas};
  for (int j = 0; j < 5; ++j) out[j] = row[j];
  return 0;
}
