// Helpers shared by the port's CUDA kernels (sm_90a): polysketch_causal.cu
// (B1), polysketch_causal_bwd.cu (B1's backward), poly_flash.cu (B2),
// poly_flash_bwd.cu (B2's backward) and lt_mult.cu (B3).
//
// - dtype conversion to and from the f32 accumulators;
// - the powers over a whole fragment and the row preparation of the two
//   backwards;
// - f32 products as three TF32 products on mma.sync (3xTF32);
// - cp.async staging into rings of two;
// - B3's flash-style diagonal tile, tc_tile_accumulate, with the weight
//   applied to the scores in registers (none for B3; the power and the
//   square are also what B1's and B2's wgmma diagonal applies).
//
// Why three TF32 products. A TF32 operand keeps 10 of f32's 23 mantissa
// bits. One TF32 product per f32 product (PyTorch's allow_tf32) missed the
// 1e-4 gate by 2-4x at the slices' shapes once the scores are raised to
// the 4th power (chip_smoke.py's tolerance study, PERF.md). So every f32
// operand x is split in registers into x_hi = x rounded to TF32 (to
// nearest, ties away, as cvt.rna.tf32.f32 gives it, but with two integer
// operations as CUTLASS does) and x_lo = x - x_hi (exact in f32, rounded
// to TF32 by the tensor cores), and a*b is taken as a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, accumulated in f32 by the tensor cores (CUTLASS's "fast
// accurate f32"). Only a_lo*b_lo (~2^-22 of a*b) is dropped; errors stay
// within a few f32 ulps of an f32 product. A bf16 input is exact in TF32
// (its x_lo is 0). B1's and B2's forwards (wgmma_planes.cuh) convert it as
// it is written to its hi plane and skip the products with its zero lo
// half, which is exact; B3 and B1's fold convert it to f32 in shared
// memory and take the f32 path, lo terms included.
//
// Why mma.sync here, and wgmma in the others. mma.sync's m16n8k8 takes
// its fragments from registers, so B3's scores' accumulator becomes the A
// operand of its second product in place, and a split costs four ALU
// operations a value. wgmma takes B K-major from shared memory, split once
// into planes for the whole warpgroup (wgmma_planes.cuh), and A from
// registers in the same layout as mma.sync's: the rows of V's plane are
// permuted to match the accumulator's columns (perm8). The two backwards
// and B1's and B2's forwards run on wgmma, the only route to the card's
// full tensor-core rate; B3 and B1's fold, off the models' hot paths or
// small, are queued for it (ROADMAP.md).
//
// What the design does about latency. Each product's three mma go to one
// accumulator, so every helper issues them in three passes over 4 to 8
// independent accumulators. A tile whose keys all lie below the diagonal
// takes a straight-line path whose loops have compile-time trip counts
// and no guards (kFull), so the compiler interleaves the shared-memory
// loads and splits of one k-step with the products of the last.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy `rows` rows of `width` values (contiguous, row-major) into shared
// memory through registers, with row stride `stride`, zero-filling rows
// [rows, total).
template <int kThreads, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int rows, int total,
                                          int width, int stride) {
  for (int idx = threadIdx.x; idx < total * width; idx += kThreads) {
    const int row = idx / width, col = idx - row * width;
    dst[row * stride + col] = row < rows ? to_f32(src[(size_t)row * width + col]) : 0.f;
  }
}

// Weights applied to a warp's whole score fragment in place
// (tc_tile_accumulate), so that the power's loop over the bits of the
// degree runs once per tile. kDen: the kernel divides by 1 + the row sum of
// the weights, so tc_tile_accumulate sums them.
struct PowWeight {   // (s * scale)^degree, by repeated squaring in XLA's integer_pow order
  static constexpr bool kDen = true;
  float scale;
  int degree;
  template <int kN>
  __device__ __forceinline__ void operator()(float (&s)[kN][4]) const {
    float w[kN][4];
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] *= scale;
    bool have = false;
    for (int p = degree; p > 0;) {
      if (p & 1) {
#pragma unroll
        for (int i = 0; i < kN; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) w[i][c] = have ? w[i][c] * s[i][c] : s[i][c];
        have = true;
      }
      p >>= 1;
      if (p > 0) {
#pragma unroll
        for (int i = 0; i < kN; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] *= s[i][c];
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = w[i][c];
  }
};
struct SquareWeight {   // s^2
  static constexpr bool kDen = true;
  template <int kN>
  __device__ __forceinline__ void operator()(float (&s)[kN][4]) const {
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] *= s[i][c];
  }
};
struct IdentityWeight {   // s, with no denominator (B3)
  static constexpr bool kDen = false;
  template <int kN>
  __device__ __forceinline__ void operator()(float (&)[kN][4]) const {}
};

// y = x^p element by element for p >= 0 (x^0 = 1), by repeated squaring
// in PowWeight's order; x is consumed (the backward kernels' powers). The
// loop over the bits of p runs once for the whole fragment.
template <int kN>
__device__ __forceinline__ void pow_frag(float (&y)[kN][4], float (&x)[kN][4], int p) {
  bool have = false;
  for (; p > 0;) {
    if (p & 1) {
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) y[i][c] = have ? y[i][c] * x[i][c] : x[i][c];
      have = true;
    }
    p >>= 1;
    if (p > 0) {
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) x[i][c] *= x[i][c];
    }
  }
  if (!have) {
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) y[i][c] = 1.f;
  }
}

// The backwards' row preparation (B1's grad_prep, B2's prep kernel), one
// warp a row of a grid of kWarps-warp blocks: with D = 1 + den of the
// row, dNum = dO / D and dDen = -(dO . out) / D, the dot product summed
// in a fixed order; dO and out in T (f32 or bf16), the rest f32.
template <int kWarps, typename T>
__device__ __forceinline__ void prep_row(const T* __restrict__ dout, const T* __restrict__ out,
                                         const float* __restrict__ den, float* __restrict__ dnum,
                                         float* __restrict__ dden, int rows, int h) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float inv = 1.f / den[row];
  const size_t base = (size_t)row * h;
  float dot = 0.f;
  for (int d = lane; d < h; d += 32) {
    const float go = to_f32(dout[base + d]);
    dot += go * to_f32(out[base + d]);
    dnum[base + d] = go * inv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (lane == 0) dden[row] = -dot * inv;
}

// ---------------------------------------------------------------------------
// Tensor cores: mma.sync.m16n8k8 in 3xTF32.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, row) holds
// A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; B (8 x 8, col) holds B[t][g],
// B[t+4][g]; the accumulator holds C[g][2t], C[g][2t+1], C[g+8][2t],
// C[g+8][2t+1].
// ---------------------------------------------------------------------------

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// x = hi + lo + O(2^-22 x). hi is x rounded to TF32 (to nearest, ties away
// from zero) by adding half a TF32 ulp and clearing the 13 low bits, so
// x - hi is exact in f32. lo is x - hi plus half a TF32 ulp: the tensor
// cores read only a TF32 operand's top 19 bits, which rounds it to nearest.
// Integer and f32 ALU work, no conversion instruction.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[c0 + i] += a * b[i] in 3xTF32 for i < count (and c0 + i < kM), the two
// small terms first. Each pass runs over all the n-tiles before the next,
// so the three products into one accumulator are kN mma apart and the
// tensor cores do not wait on a result. c0 is known at compile time.
template <int kN, int kM>
__device__ __forceinline__ void mma_3xtf32(float (&c)[kM][4], int c0, const FragA& a,
                                           const FragB (&b)[kN], int count) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (i < count && c0 + i < kM) mma_tf32(c[c0 + i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (i < count && c0 + i < kM) mma_tf32(c[c0 + i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (i < count && c0 + i < kM) mma_tf32(c[c0 + i], a.hi, b[i].hi);
}

// Row strides (in floats) of the shared-memory tiles, chosen so that the
// fragment loads of one warp hit 32 different banks.
// A tile read along its rows (fragment element [g][t]: address g*s + t).
__host__ __device__ constexpr int row_frag_stride(int width) { return (width + 7) / 8 * 8 + 4; }
// A tile whose rows are the mma's k index (element [t][g]: t*s + g).
__host__ __device__ constexpr int k_frag_stride(int width) { return (width + 7) / 16 * 16 + 8; }
// W V's value tile, read at rows 2t and 2t+1 (element [2t][g]: 2t*s + g).
__host__ __device__ constexpr int pair_frag_stride(int width) { return (width + 15) / 16 * 16 + 4; }

// ---------------------------------------------------------------------------
// cp.async staging.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage rows [0, rows) of `width` values each, src_stride apart in global
// memory (a row-major (., width) matrix by default, or a column slice of
// a wider one, f32 only), into shared memory at row stride `stride`,
// zero-filling rows [rows, total). f32 goes through cp.async (16 bytes a
// copy where the widths and src allow it, else 4) and is in place after
// cp_async_wait and a __syncthreads; bf16 is converted through registers
// and is in place after the __syncthreads.
template <int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows, int total,
                                           int width, int stride, int src_stride = 0) {
  if (src_stride == 0) src_stride = width;
  if (((width | src_stride) & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vw = width >> 2;
    for (int idx = threadIdx.x; idx < total * vw; idx += kThreads) {
      const int row = idx / vw, c = 4 * (idx - row * vw);
      const bool ok = row < rows;
      cp_async16(dst + row * stride + c, ok ? src + (size_t)row * src_stride + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < total * width; idx += kThreads) {
      const int row = idx / width, col = idx - row * width;
      const bool ok = row < rows;
      cp_async4(dst + row * stride + col, ok ? src + (size_t)row * src_stride + col : src, ok);
    }
  }
}

template <int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const __nv_bfloat16* src, int rows,
                                           int total, int width, int stride) {
  load_rows<kThreads>(dst, src, rows, total, width, stride);
}

// Zero columns [width, stride) of `rows` rows: the padding the fragments
// read past a tile's width. Staging never writes there.
template <int kThreads>
__device__ __forceinline__ void zero_pad_cols(float* dst, int rows, int width, int stride) {
  const int pad = stride - width;
  for (int idx = threadIdx.x; idx < rows * pad; idx += kThreads) {
    const int row = idx / pad;
    dst[row * stride + width + (idx - row * pad)] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// B3's flash-style diagonal tile on mma.sync (its pass 3; B1 and B2 ran it
// until their forwards moved to wgmma_planes.cuh's diagonal).
//
// A CTA of kTcWarps warps owns kTcTile = 16 * kTcWarps query rows; warp w
// owns rows 16w .. 16w + 15. For every 64-key tile the warp computes its
// 16 x 64 scores S = Q K^T (3xTF32 mma, Q and K fragments loaded from
// shared memory and split in registers), applies weight() (the scale and
// the power, the square, or nothing) to the accumulator in registers,
// masks it on the tiles that cross the diagonal, adds each row's weights
// into den (when Weight::kDen), and folds W V into acc (3xTF32 mma). The scores' accumulator is W V's A
// operand as it stands: within each 8-key step the k index t of the mma
// stands for key 2t and t + 4 for key 2t + 1, and V's fragments are read
// in that order. On a masked tile, the 8-key groups that none of the
// warp's rows can see are skipped.
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcTile = 16 * kTcWarps;   // query rows of a CTA, keys of a tile
constexpr int kKeyTile = 64;

// acc[nd] += a * B for the n-tiles nd < count, B's fragment of n-tile nd
// being (p[8 nd], p[step + 8 nd]): mma_3xtf32 over groups of 4 n-tiles
// (and one of the 1 to 3 left, if any), each group into a fresh
// accumulator that is then added to acc with f32 adds. The tensor cores
// add a product into their accumulator with truncation, so a running sum
// kept there in place loses a little at every k-step, toward zero, and the
// more the longer the sum: the flash loop's W V over 512 key tiles at n
// 32768 drifted 5.4e-5 of B2's gradients' max through the output the
// backward reads. A fresh accumulator truncates only within one 8-wide
// k-step, and acc's adds round to nearest, in a fixed order.
template <int kNT>
__device__ __forceinline__ void mma_3xtf32_cols(float (&acc)[kNT][4], const FragA& a,
                                                const float* p, int step, int count) {
  constexpr int kG = 4;
#pragma unroll
  for (int g0 = 0; g0 < kNT; g0 += kG) {
    if (g0 >= count) break;
    const int m = min(min(kG, kNT - g0), count - g0);
    FragB b[kG];
    float part[kG][4];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (i < m) {
        b[i] = split_b(p[8 * (g0 + i)], p[step + 8 * (g0 + i)]);
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][c] = 0.f;
      }
    }
    mma_3xtf32(part, 0, a, b, m);
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (i < m) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g0 + i][c] += part[i][c];
      }
    }
  }
}

// One key tile for the calling warp. q_s: kTcTile query rows x f features
// (stride qs), k_s: kKeyTile keys x f (stride ks), v_s: kKeyTile keys x h
// (stride vs); every column past f or h reads as 0. Keys j < krows of the
// tile (global key k0 + j) meet query rows q0 + row, row < qrows. acc holds
// the warp's 16 x 8*kNT outputs (n-tile nd: columns 8nd .. 8nd + 7), of
// which W V writes the first ceil(h / 8) <= kNV; den[0] and den[1] its rows
// g and g + 8, summed over this thread's keys. f <= kF, a multiple of 8.
// kFull: no key of the tile lies above the diagonal for any row of the
// CTA, and f == kF, h == 8 kNV. Rows past qrows and keys past krows are
// staged as zeros, so their weights are 0 (and those rows are not
// stored): only the causal mask needs the guarded path. With kFull every
// loop has a trip count known at compile time and no guard, so the code is
// one straight line whose loads and splits the compiler interleaves with
// the products. kMask applies the mask; with kFull too (a tile that
// crosses the diagonal, taken whole), the products past the diagonal are
// computed and then masked, which costs less than guarding each mma.
template <int kNT, int kNV, int kF, bool kFull, bool kMask = !kFull, typename Weight>
__device__ __forceinline__ void tc_tile_accumulate(const float* q_s, int qs, const float* k_s,
                                                   int ks, int f, const float* v_s, int vs,
                                                   int h, int q0, int qrows, int k0,
                                                   int krows, bool causal, Weight weight,
                                                   float (&acc)[kNT][4], float (&den)[2]) {
  constexpr int kKT = kKeyTile / 8;   // n-tiles of the scores
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;
  int nkt = kKT, nv = kNV;
  if (!kFull) {
    if (wrow >= qrows) return;
    int kmax = krows;   // keys this warp's rows can see
    if (causal) kmax = min(kmax, q0 + min(wrow + 15, qrows - 1) - k0 + 1);
    if (kmax <= 0) return;
    nkt = (kmax + 7) / 8;
    nv = (h + 7) / 8;
  }

  float s[kKT][4];
#pragma unroll
  for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;

  const float* qa = q_s + (wrow + g) * qs + t;
#pragma unroll
  for (int kk = 0; kk < kF; kk += 8) {
    if (!kFull && kk >= f) break;
    const FragA a = split_a(qa[kk], qa[kk + 8 * qs], qa[kk + 4], qa[kk + 8 * qs + 4]);
    const float* kb = k_s + g * ks + kk + t;
    FragB b[kKT];
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt) {
      if (kFull || nt < nkt) b[nt] = split_b(kb[nt * 8 * ks], kb[nt * 8 * ks + 4]);
    }
    mma_3xtf32(s, 0, a, b, nkt);
  }

  weight(s);
  const int row0 = wrow + g;
#pragma unroll
  for (int nt = 0; nt < kKT; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (kMask) {
        const int row = row0 + 8 * (c >> 1), j = nt * 8 + 2 * t + (c & 1);
        const bool keep = j < krows && row < qrows && (!causal || k0 + j <= q0 + row);
        s[nt][c] = keep ? s[nt][c] : 0.f;
      }
      if (Weight::kDen) den[c >> 1] += s[nt][c];
    }
  }

#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) {
    if (kFull || kk < nkt) {
      const FragA a = split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      mma_3xtf32_cols(acc, a, v_s + (kk * 8 + 2 * t) * vs + g, vs, nv);
    }
  }
}

// den summed over the four threads of each row (fixed order: lanes
// 0+1, 2+3, then the pairs), so every thread of the quad holds the row's.
__device__ __forceinline__ void quad_sum(float (&den)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
  }
}

// Write a warp's 16 output rows (q0 + row for row < qrows), columns < h:
// out = acc / (1 + den) when kDen, else out = acc. out points at the
// tile's first row (stride h).
template <int kNT, bool kDen = true, typename T>
__device__ __forceinline__ void tc_store_rows(T* out, int h, int qrows,
                                              const float (&acc)[kNT][4], const float (&den)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16 + g;
  const float inv[2] = {1.f / (1.f + den[0]), 1.f / (1.f + den[1])};
#pragma unroll
  for (int nd = 0; nd < kNT; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = row0 + 8 * (c >> 1), d = nd * 8 + 2 * t + (c & 1);
      if (row < qrows && d < h) {
        out[(size_t)row * h + d] = from_f32<T>(kDen ? acc[nd][c] * inv[c >> 1] : acc[nd][c]);
      }
    }
  }
}
