// Helpers shared by the port's CUDA kernels: dtype conversion to and from
// the f32 accumulators, and the integer power in XLA's order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x^p by repeated squaring, in the order of XLA's integer_pow (p >= 1).
__device__ __forceinline__ float int_pow(float x, int p) {
  float acc = 0.f;
  bool have = false;
  while (p > 0) {
    if (p & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    p >>= 1;
    if (p > 0) x = x * x;
  }
  return acc;
}

// Copy `rows` rows of `width` values (contiguous, row-major) into shared
// memory with row stride `stride`, zero-filling rows up to kRows.
template <int kRows, int kThreads, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int rows, int width,
                                          int stride) {
  for (int idx = threadIdx.x; idx < kRows * width; idx += kThreads) {
    const int row = idx / width, col = idx - row * width;
    dst[row * stride + col] = row < rows ? to_f32(src[(size_t)row * width + col]) : 0.f;
  }
}

// Weights applied to a tile's scores s = <x_row, y_j>.
struct PowWeight {   // (s * scale)^degree
  float scale;
  int degree;
  __device__ __forceinline__ float operator()(float s) const { return int_pow(s * scale, degree); }
};
struct SquareWeight {   // s^2
  __device__ __forceinline__ float operator()(float s) const { return s * s; }
};
struct PlainWeight {   // s
  __device__ __forceinline__ float operator()(float s) const { return s; }
};

// One key tile of the register-tiled product W V shared by the port's
// flash-style kernels. A CTA of kSide x kSide threads covers kTile query
// rows x kTile keys; thread (tr, tc) owns rows tr + kSide*a and keys
// tc + kSide*c of the scores (a, c < kTile / kSide), and columns
// tc + kSide*c (c < kCols) of the output. The query tile x_s and the key
// tile y_s hold f features each at row stride fs, the value tile v_s holds
// h columns at row stride h; the caller has loaded them and synchronised.
// Scores become w = weight(<x_row, y_j>), zeroed unless j < krows,
// row < qrows and (when causal) k0 + j <= q0 + row, are staged in w_s (row
// stride kTile + 1), and are folded into acc (and into den when kDen) key
// by key in order.
template <int kTile, int kSide, int kCols, bool kDen, typename Weight>
__device__ __forceinline__ void tile_accumulate(const float* x_s, const float* y_s, int f,
                                                int fs, const float* v_s, int h, float* w_s,
                                                int q0, int qrows, int k0, int krows,
                                                bool causal, Weight weight,
                                                float (&acc)[kTile / kSide][kCols],
                                                float (&den)[kTile / kSide]) {
  constexpr int kRows = kTile / kSide;
  constexpr int ws = kTile + 1;   // padded stride avoids bank conflicts
  const int tr = threadIdx.x / kSide, tc = threadIdx.x % kSide;
  float sc[kRows][kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < kRows; ++c) sc[a][c] = 0.f;
  for (int e = 0; e < f; ++e) {
    float xv[kRows], yv[kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a) xv[a] = x_s[(tr + kSide * a) * fs + e];
#pragma unroll
    for (int c = 0; c < kRows; ++c) yv[c] = y_s[(tc + kSide * c) * fs + e];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kRows; ++c) sc[a][c] = fmaf(xv[a], yv[c], sc[a][c]);
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
#pragma unroll
    for (int c = 0; c < kRows; ++c) {
      const int row = tr + kSide * a, j = tc + kSide * c;
      const bool keep = (j < krows) && (row < qrows) && (!causal || k0 + j <= q0 + row);
      w_s[row * ws + j] = keep ? weight(sc[a][c]) : 0.f;
    }
  }
  __syncthreads();
  for (int j = 0; j < krows; ++j) {
    float wv[kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      wv[a] = w_s[(tr + kSide * a) * ws + j];
      if (kDen) den[a] += wv[a];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tc + kSide * c;
      if (d < h) {
        const float vv = v_s[j * h + d];
#pragma unroll
        for (int a = 0; a < kRows; ++a) acc[a][c] = fmaf(wv[a], vv, acc[a][c]);
      }
    }
  }
}
