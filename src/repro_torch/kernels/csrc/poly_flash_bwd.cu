// The backward of exact polynomial attention (B2) for NVIDIA Hopper
// (sm_90a), hand-written CUDA.
//
// The JAX package has no backward kernel for it: it trains the polynomial
// baseline through XLA's gradient of poly_attention_full
// (src/repro/core/poly_attention.py). This file gives B2's forward
// (poly_flash.cu) a backward of its own, so that training runs on kernels
// end to end. Causal (n == t), float32. Per bh, with the forward's output
// out and D_i = 1 + sum_j w_ij (its den_out), s_ij = <q_i, k_j> * scale and
// w_ij = s_ij^p:
//   dNum_i = dO_i / D_i,   dDen_i = -(dO_i . out_i) / D_i
//   dW_ij  = <dNum_i, v_j> + dDen_i,   dS_ij = p s_ij^(p-1) scale dW_ij   (j <= i)
//   dv_j = sum_{i >= j} w_ij dNum_i,   dk_j = sum_{i >= j} dS_ij q_i,
//   dq_i = sum_{j <= i} dS_ij k_j.
//
// Three launches, no atomics, every sum in a fixed order (two calls give
// the same bits):
//   poly_flash_bwd_prep_kernel   dNum and dDen from dO, out and D (one warp
//                                a row).
//   poly_flash_bwd_key_kernel    dk and dv of one 64-key tile a CTA, over
//                                the query stages from the diagonal on.
//   poly_flash_bwd_query_kernel  dq of one 64-query tile a CTA, over the
//                                key stages up to the diagonal.
// Both tile kernels recompute S and dW: the price of having no atomics.
// They launch the tiles with the most stages first (the first key tiles,
// the last query tiles), so that the grid's tail is short.
//
// Accuracy. The tensor cores add a product into their f32 accumulator with
// truncation (round toward zero), so a long chain of mma into one running
// sum drifts: with dk, dq and dv accumulated in place over every stage
// (~1,500 mma an element at n 4096), the gradients were 4-6e-5 of their
// max|.| off a float64 reference where the plain version (cuBLAS FMA) was
// 7e-7 off, on an NVIDIA H100 (PERF.md). So each stage's output products
// go to a fresh accumulator (12 mma), and the stages are summed in f32
// registers, rounded to nearest.
//
// Layout. A CTA of 4 warps (common.cuh's kTcThreads) owns 64 rows, 16 a
// warp, staged once into shared memory: the key kernel's K and V tiles,
// the query kernel's Q and dNum tiles. The other side streams through a
// cp.async ring of two stages of 32 rows each: Q, dNum and dDen for the
// key kernel, K and V for the query kernel. For each stage a warp takes
// on the tensor cores, in 3xTF32 (common.cuh's split rule, f32-accurate):
// its 16 x 32 scores (K Q^T, or Q K^T) and dW (V dNum^T, or dNum V^T),
// adds dDen, turns them into dS (and, in the key kernel, W) in registers,
// masks the diagonal and the ragged edge, and folds dS P (and W dNum) into
// f32 accumulators, with the scores' accumulator as the next product's A
// operand as it stands (the forward's key order within each 8). The power
// is taken over the whole fragment (p s^(p-1) is exactly p at p = 1, also
// where s = 0). Rows past n are staged as zeros, masked and not stored:
// any n, no padding.
//
// What bounds it. At the training shape (bh 24, n 4096, h 64, p 4, f32)
// the function needs five products over the 201.4 M causal pairs (S, dW,
// dv, dq, dk: 10h flops a pair, 128.9 GFLOP) and ~1.6 GFLOP of the rest
// (powers, scale, masks), against 201 MB of q, k, v, out, dO, dq, dk, dv.
// In 3xTF32 at 495 TFLOP/s that is ~0.81 ms, bound by operations (1.95 ms
// on the f32 FMA pipes); chip_smoke.py's b2_bwd_bound counts it. The two
// tile kernels compute S and dW twice (~51.6 GFLOP over the bound). The
// three kernels take 5.99 ms there on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 4, PERF.md), 13.4 % of that bound, the key kernel
// ~60 % of it: a first kernel, simple and right, not yet tuned.
//
// Registers (nvcc -Xptxas -v, as chip_smoke.py prints it): key kernel
// 244 a thread, query kernel 168, prep 32; no spills, no stack. With
// 69,888 B of shared memory a CTA at h = 64, two key CTAs (8 warps) or
// three query CTAs (12 warps) share an SM.

#include <stddef.h>

#include "common.cuh"

namespace {

constexpr int kMaxH = 64;            // head width, zero-padded (h <= 64)
constexpr int kNT = kMaxH / 8;       // output n-tiles of 8 columns
constexpr int kRows = kTcTile;       // own rows of a CTA, 16 a warp
constexpr int kStage = 32;           // the other side's rows a stage
constexpr int kST = kStage / 8;      // score n-tiles a stage
constexpr int kPrepWarps = 8;

// Row stride of every staged tile: read along its rows (scores, dW) and in
// pairs of rows (the output products), conflict-free for both at h = 64.
__host__ __device__ constexpr int tile_stride(int h) { return pair_frag_stride(h); }

// Floats of one ring slot: P and R (kStage rows each), then dDen.
__host__ __device__ constexpr int slot_floats(int h) {
  return 2 * kStage * tile_stride(h) + kStage;
}

__host__ __device__ constexpr size_t smem_bytes(int h) {
  return ((size_t)2 * kRows * tile_stride(h) + 2 * (size_t)slot_floats(h)) * sizeof(float);
}

template <int kN>
__device__ __forceinline__ void zero_frag(float (&x)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
}

template <int kN>
__device__ __forceinline__ void add_frag(float (&acc)[kN][4], const float (&x)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] += x[i][c];
}

// ---------------------------------------------------------------------------
// poly_flash_bwd_prep_kernel: dNum = dO / D, dDen = -(dO . out) / D, one
// warp a row.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * kPrepWarps)
poly_flash_bwd_prep_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                           const float* __restrict__ den, float* __restrict__ dnum,
                           float* __restrict__ dden, int rows, int h) {
  prep_row<kPrepWarps>(dout, out, den, dnum, dden, rows, h);
}

// ---------------------------------------------------------------------------
// One stage for the calling warp.
//
// Own rows (x_s, y_s: kRows x h at stride ss) are keys in the key kernel
// (X = K, Y = V) and queries in the query kernel (X = Q, Y = dNum); the
// warp owns rows wrow .. wrow + 15 (global r0 + row, row < rows). The
// stage's rows (p_s, r_s: kStage x h) are the other side (P = Q, R = dNum
// with dDen in dd_s; or P = K, R = V), global c0 + col, col < crows. Then
//   o1 += dS P   (dk, or dq), and in the key kernel o2 += W R (dv),
// where S, dW and dS are the warp's 16 x kStage scores in mma.sync's
// accumulator layout: row g (+8), column 8 nt + 2t (+1).
// ---------------------------------------------------------------------------

template <bool kKey>
__device__ __forceinline__ void stage_products(const float* x_s, const float* y_s,
                                               const float* p_s, const float* r_s,
                                               const float* dd_s, int ss, int h, int r0,
                                               int rows, int c0, int crows,
                                               const float (&dd_own)[2], int degree,
                                               float scale, float (&o1)[kNT][4],
                                               float (&o2)[kNT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;
  if (wrow >= rows) return;
  // causal reach of the warp's rows: keys see queries at or after them,
  // queries see keys at or before them
  if (kKey ? c0 + crows - 1 < r0 + wrow : c0 > r0 + min(wrow + 15, rows - 1)) return;

  float s[kST][4], w[kST][4];
  zero_frag(s);
  zero_frag(w);

  const float* xa = x_s + (wrow + g) * ss + t;
  const float* ya = y_s + (wrow + g) * ss + t;
#pragma unroll
  for (int kk = 0; kk < kMaxH; kk += 8) {
    if (kk >= h) break;
    const float* pb = p_s + g * ss + kk + t;
    const float* rb = r_s + g * ss + kk + t;
    FragB b[kST];
    const FragA a = split_a(xa[kk], xa[kk + 8 * ss], xa[kk + 4], xa[kk + 8 * ss + 4]);
#pragma unroll
    for (int nt = 0; nt < kST; ++nt) b[nt] = split_b(pb[nt * 8 * ss], pb[nt * 8 * ss + 4]);
    mma_3xtf32(s, 0, a, b, kST);
    const FragA ay = split_a(ya[kk], ya[kk + 8 * ss], ya[kk + 4], ya[kk + 8 * ss + 4]);
#pragma unroll
    for (int nt = 0; nt < kST; ++nt) b[nt] = split_b(rb[nt * 8 * ss], rb[nt * 8 * ss + 4]);
    mma_3xtf32(w, 0, ay, b, kST);
  }

  // dW += dDen (of the stage's queries, or of the warp's own), then dS and W
  float x[kST][4], y[kST][4];
#pragma unroll
  for (int nt = 0; nt < kST; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      w[nt][c] += kKey ? dd_s[nt * 8 + 2 * t + (c & 1)] : dd_own[c >> 1];
      x[nt][c] = s[nt][c] * scale;
    }
  pow_frag(y, x, degree - 1);
#pragma unroll
  for (int nt = 0; nt < kST; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) w[nt][c] = (float)degree * y[nt][c] * scale * w[nt][c];
  if (kKey) {
#pragma unroll
    for (int nt = 0; nt < kST; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[nt][c] = s[nt][c] * scale;
    pow_frag(s, x, degree);
  }
#pragma unroll
  for (int nt = 0; nt < kST; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nt * 8 + 2 * t + (c & 1);
      const int own = r0 + row, other = c0 + col;
      const bool keep = row < rows && col < crows && (kKey ? other >= own : other <= own);
      w[nt][c] = keep ? w[nt][c] : 0.f;
      if (kKey) s[nt][c] = keep ? s[nt][c] : 0.f;
    }

  // Each product of the stage goes to a fresh accumulator, added to the
  // running sum in f32 after it (see the header: the tensor cores' own
  // additions round toward zero).
  const int nv = (h + 7) / 8;
  float part[kNT][4];
  zero_frag(part);
#pragma unroll
  for (int kk = 0; kk < kST; ++kk) {
    const FragA a = split_a(w[kk][0], w[kk][2], w[kk][1], w[kk][3]);
    mma_3xtf32_cols(part, a, p_s + (kk * 8 + 2 * t) * ss + g, ss, nv);
  }
  add_frag(o1, part);
  if (kKey) {
    zero_frag(part);
#pragma unroll
    for (int kk = 0; kk < kST; ++kk) {
      const FragA a = split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      mma_3xtf32_cols(part, a, r_s + (kk * 8 + 2 * t) * ss + g, ss, nv);
    }
    add_frag(o2, part);
  }
}

// One CTA of either tile kernel: stage its own rows, stream the other
// side's stages through the ring, store o1 (and o2). smem: the CTA's
// dynamic shared memory, smem_bytes(h).
template <bool kKey>
__device__ __forceinline__ void tile_body(float* smem, const float* __restrict__ q,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float* __restrict__ dnum,
                                          const float* __restrict__ dden, float* __restrict__ out1,
                                          float* __restrict__ out2, int n, int h, int degree,
                                          float scale) {
  // heaviest tiles first: the first key tiles, the last query tiles
  const int tile = kKey ? blockIdx.x : gridDim.x - 1 - blockIdx.x, bh = blockIdx.y;
  const int r0 = tile * kRows, rows = min(kRows, n - r0);
  const int ss = tile_stride(h), slot = slot_floats(h);
  const size_t base = (size_t)bh * n * h;

  float* x_s = smem;                    // kRows x ss
  float* y_s = x_s + kRows * ss;        // kRows x ss
  float* ring = y_s + kRows * ss;       // 2 slots: P, R (kStage x ss each), dDen (kStage)

  zero_pad_cols<kTcThreads>(x_s, 2 * kRows, h, ss);
  zero_pad_cols<kTcThreads>(ring, 2 * kStage, h, ss);
  zero_pad_cols<kTcThreads>(ring + slot, 2 * kStage, h, ss);
  stage_rows<kTcThreads>(x_s, (kKey ? k : q) + base + (size_t)r0 * h, rows, kRows, h, ss);
  stage_rows<kTcThreads>(y_s, (kKey ? v : dnum) + base + (size_t)r0 * h, rows, kRows, h, ss);

  float dd_own[2] = {0.f, 0.f};
  if (!kKey) {
    const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row + 8 * i < rows) dd_own[i] = dden[(size_t)bh * n + r0 + row + 8 * i];
    }
  }

  const int c_begin = kKey ? r0 : 0, c_end = kKey ? n : r0 + rows;
  const int stages = (c_end - c_begin + kStage - 1) / kStage;
  const float* P = kKey ? q : k;
  const float* R = kKey ? dnum : v;
  const auto stage = [&](int st) {
    const int c0 = c_begin + st * kStage, crows = min(kStage, c_end - c0);
    float* d = ring + (st & 1) * slot;
    stage_rows<kTcThreads>(d, P + base + (size_t)c0 * h, crows, kStage, h, ss);
    stage_rows<kTcThreads>(d + kStage * ss, R + base + (size_t)c0 * h, crows, kStage, h, ss);
    if (kKey) {
      stage_rows<kTcThreads>(d + 2 * kStage * ss, dden + (size_t)bh * n + c0, crows, kStage,
                             1, 1);
    }
    cp_async_commit();
  };

  float o1[kNT][4], o2[kNT][4];
  zero_frag(o1);
  zero_frag(o2);

  stage(0);
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      stage(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = c_begin + st * kStage, crows = min(kStage, c_end - c0);
    const float* d = ring + (st & 1) * slot;
    stage_products<kKey>(x_s, y_s, d, d + kStage * ss, d + 2 * kStage * ss, ss, h, r0, rows,
                         c0, crows, dd_own, degree, scale, o1, o2);
    __syncthreads();
  }

  const float none[2] = {0.f, 0.f};
  tc_store_rows<kNT, false>(out1 + base + (size_t)r0 * h, h, rows, o1, none);
  if (kKey) tc_store_rows<kNT, false>(out2 + base + (size_t)r0 * h, h, rows, o2, none);
}

// poly_flash_bwd_key_kernel: dk and dv of one 64-key tile, grid
// (ceil(n / 64), bh).
__global__ void __launch_bounds__(kTcThreads)
poly_flash_bwd_key_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dnum,
                          const float* __restrict__ dden, float* __restrict__ dk,
                          float* __restrict__ dv, int n, int h, int degree, float scale) {
  extern __shared__ __align__(16) float smem[];
  tile_body<true>(smem, q, k, v, dnum, dden, dk, dv, n, h, degree, scale);
}

// poly_flash_bwd_query_kernel: dq of one 64-query tile, grid
// (ceil(n / 64), bh).
__global__ void __launch_bounds__(kTcThreads)
poly_flash_bwd_query_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dnum,
                            const float* __restrict__ dden, float* __restrict__ dq, int n, int h,
                            int degree, float scale) {
  extern __shared__ __align__(16) float smem[];
  tile_body<false>(smem, q, k, v, dnum, dden, dq, nullptr, n, h, degree, scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous float32 tensors: q, k, v, out, dout, dnum, dq, dk, dv
// (bh, n, h); den (the forward's 1 + den), dden (bh, n). dnum and dden are
// scratch. Requires h <= 64. Returns the first CUDA error (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int poly_flash_backward(const float* q, const float* k, const float* v,
                                   const float* out, const float* dout, const float* den,
                                   float* dnum, float* dden, float* dq, float* dk, float* dv,
                                   int bh, int n, int h, int degree, float scale, void* stream) {
  if (bh <= 0 || n <= 0 || h < 1 || h > kMaxH || degree < 1 || bh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = bh * n;
  poly_flash_bwd_prep_kernel<<<(rows + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps, 0, s>>>(
      dout, out, den, dnum, dden, rows, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(h);
  if ((err = allow_smem(poly_flash_bwd_key_kernel, smem)) != cudaSuccess ||
      (err = allow_smem(poly_flash_bwd_query_kernel, smem)) != cudaSuccess) {
    return (int)err;
  }
  const dim3 grid((n + kRows - 1) / kRows, bh);
  poly_flash_bwd_key_kernel<<<grid, kTcThreads, smem, s>>>(q, k, v, dnum, dden, dk, dv, n, h,
                                                           degree, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  poly_flash_bwd_query_kernel<<<grid, kTcThreads, smem, s>>>(q, k, v, dnum, dden, dq, n, h,
                                                             degree, scale);
  return (int)cudaGetLastError();
}

// What each kernel of the backward holds on the card, in launch order
// (prep, key, query) at head width h: five ints each into out[3 * 5]
// (registers a thread, local memory bytes a thread, dynamic shared memory
// bytes a CTA, threads a CTA, CTAs resident an SM). Returns the first CUDA
// error (0 on success).
extern "C" int poly_flash_backward_occupancy(int h, int* out) {
  if (h < 1 || h > kMaxH) return (int)cudaErrorInvalidValue;
  const struct {
    const void* fn;
    int threads;
    size_t smem;
  } kernels[3] = {{(const void*)poly_flash_bwd_prep_kernel, 32 * kPrepWarps, 0},
                  {(const void*)poly_flash_bwd_key_kernel, kTcThreads, smem_bytes(h)},
                  {(const void*)poly_flash_bwd_query_kernel, kTcThreads, smem_bytes(h)}};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = cudaFuncSetAttribute(kernels[i].fn,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kernels[i].smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, kernels[i].fn)) != cudaSuccess) return (int)err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernels[i].fn, kernels[i].threads,
                                                        kernels[i].smem);
    if (err != cudaSuccess) return (int)err;
    const int row[5] = {a.numRegs, (int)a.localSizeBytes, (int)kernels[i].smem,
                        kernels[i].threads, ctas};
    for (int j = 0; j < 5; ++j) out[5 * i + j] = row[j];
  }
  return 0;
}
