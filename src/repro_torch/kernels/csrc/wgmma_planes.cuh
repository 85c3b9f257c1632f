// The wgmma toolkit of the port's two backward kernels (sm_90a):
// polysketch_causal_bwd.cu (B1's) and poly_flash_bwd.cu (B2's).
//
// - score_grads: the scores' transforms at the diagonal (dS and W from S
//   and dW, in registers, masked);
// - warpgroup products (wgmma m64n32k8 and m64n64k8 in TF32, A from
//   registers or from shared memory) with their fences and waits;
// - split planes: an operand staged once into shared memory as its TF32
//   high and low halves, in wgmma's K-major layout (Plane, plane_desc,
//   perm8), the chunk copy and split helpers that fill them, and wg_pair,
//   two 3xTF32 products at once with B read from the planes (n up to 128,
//   A from registers or read a k-step ahead).
#pragma once

#include "common.cuh"

// The scores' transforms at the diagonal, in place: s = S (or S^T), w =
// dW: with x = s * scale (local_exact) or s,
//   w <- dS = p x^(p-1) scale dW (or 2 x dW),
//   s <- W = x^p (or x^2) when kW,
// both zero where keep(nt, c) is false. Half the n-tiles at a time, so
// that the powers' temporaries take few registers.
template <bool kLocalExact, bool kW, int kN, typename Keep>
__device__ __forceinline__ void score_grads(float (&s)[kN][4], float (&w)[kN][4], int degree,
                                            float scale, Keep keep) {
  constexpr int kH = kN / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float(&sh)[kH][4] = *reinterpret_cast<float(*)[kH][4]>(&s[half * kH]);
    float(&wh)[kH][4] = *reinterpret_cast<float(*)[kH][4]>(&w[half * kH]);
    if (kLocalExact) {
      float x[kH][4], y[kH][4];
#pragma unroll
      for (int i = 0; i < kH; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) x[i][c] = sh[i][c] * scale;
      pow_frag(y, x, degree - 1);
#pragma unroll
      for (int i = 0; i < kH; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) wh[i][c] = (float)degree * y[i][c] * scale * wh[i][c];
      if (kW) {
#pragma unroll
        for (int i = 0; i < kH; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) x[i][c] = sh[i][c] * scale;
        pow_frag(sh, x, degree);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kH; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wh[i][c] = 2.f * sh[i][c] * wh[i][c];
          if (kW) sh[i][c] = sh[i][c] * sh[i][c];
        }
    }
#pragma unroll
    for (int i = 0; i < kH; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool k = keep(half * kH + i, c);
        wh[i][c] = k ? wh[i][c] : 0.f;
        if (kW) sh[i][c] = k ? sh[i][c] : 0.f;
      }
  }
}

// Warpgroup products (wgmma, sm_90a): d (this warp's 16 rows of the 64 x n
// result, in mma.sync's accumulator layout, n-tile j in d[j]) += A B^T, or
// d = A B^T when acc is 0, A (64 x 8) from registers in mma.sync's A
// fragment layout (warp w: rows 16w ..), B (n x 8, K-major) from shared
// memory by descriptor. Async: the results are in d after wg_commit,
// wg_wait and reg_fence.
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// The same with A (64 x 8, K-major) from shared memory by descriptor too.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t adesc, uint64_t bdesc,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "l"(adesc), "l"(bdesc), "r"(acc));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most one committed group is in flight: the A registers of
// the groups before it are free again.
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Orders this thread's earlier generic-proxy writes to shared memory before
// later async-proxy reads (wgmma's) of it.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving uses of d above wg_wait.
template <int kN>
__device__ __forceinline__ void reg_fence(float (&d)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[i][c])::"memory");
}

template <int kN>
__device__ __forceinline__ void wg_mma(float (&d)[kN][4], const uint32_t (&a)[4], uint64_t desc,
                                       bool acc = true) {
  static_assert(kN == 4 || kN == 8, "wgmma n32 or n64");
  if constexpr (kN == 4) {
    wgmma_n32(d, a, desc, acc);
  } else {
    wgmma_n64(d, a, desc, acc);
  }
}

// ---------------------------------------------------------------------------
// Split planes. An operand of kR rows (the mma's m or n index) by kC columns
// (its k index) is kept as two planes, its TF32 high halves and its low
// halves (split_tf32's bits), each in 8 x 4 core matrices of 128
// contiguous bytes: element (row, col) at
//   (col / 4) * kCS + (row / 8) * kGS + (row % 8) * 4 + col % 4.
// This is the canonical K-major layout of wgmma without swizzle (see
// plane_desc). A transposed plane (kT) is
// written one element at a time by lanes that hold 8 consecutive rows of
// 4 consecutive chunks of its source; kGS = 36 and kCS = 8 (mod 32) make
// those writes free of conflicts too. kPad >= 0 pads kCS to kPad (mod 32)
// instead, for a plane that other lanes read or write (poly_flash_bwd.cu).
// ---------------------------------------------------------------------------

template <int kR, int kC, bool kT, int kPad = -1>
struct Plane {
  static_assert(kR % 16 == 0 && kC % 8 == 0, "planes hold whole fragments");
  static_assert(kPad < 0 || (kPad < 32 && kPad % 4 == 0), "kCS stays a multiple of 16 bytes");
  static constexpr int kGS = kT ? 36 : 32;
  static constexpr int kCS0 = kR / 8 * kGS;
  static constexpr int kCS = kPad >= 0 ? kCS0 + (32 + kPad - kCS0 % 32) % 32
                             : kT ? kCS0 + (40 - kCS0 % 32) % 32 : kCS0;
  static constexpr int kFloats = kC / 4 * kCS;   // one plane
  __device__ static int off(int row, int col) {
    return (col >> 2) * kCS + (row >> 3) * kGS + (row & 7) * 4 + (col & 3);
  }
};

// The descriptor of a plane at p for wgmma: K-major, no swizzle; the
// leading byte offset is the step between the two core matrices of a
// k-step (kCS), the stride byte offset the step between 8-row groups (kGS).
template <class P>
__device__ __forceinline__ uint64_t plane_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3fff) | ((uint64_t)(P::kCS >> 2) << 16) |
         ((uint64_t)(P::kGS >> 2) << 32);
}

// The position of key j of a stage in a transposed plane: within each 8,
// key 2u at u and key 2u + 1 at u + 4, the order in which an accumulator
// of scores holds them as an A operand.
__device__ __forceinline__ int perm8(int j) {
  return (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
}

// Row stride of a raw staged tile of kNC 16-byte chunks a row: odd in
// chunks, so that 8 lanes reading one chunk of 8 rows hit distinct banks.
__host__ __device__ constexpr int raw_stride(int nc) { return 4 * (nc | 1); }

// The (row, chunk) pairs of a kRows x kNC tile that this thread copies and
// later splits: 8 consecutive rows of one chunk for each 8 lanes, 4 chunks
// a warp. Unrolled: a rolled loop between a wgmma's issue and its wait
// makes ptxas serialize the wgmma.
template <int kThreads, int kRows, int kNC, typename F>
__device__ __forceinline__ void for_chunks(F fn) {
  constexpr int kTotal = kRows * kNC;
#pragma unroll
  for (int i = 0; i < (kTotal + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (kTotal % kThreads == 0 || idx < kTotal) {
      const int u = idx >> 3;
      fn((u / kNC) * 8 + (idx & 7), u % kNC);
    }
  }
}

// Issue the copy of chunk `chunk` of one row (`width` values of `src`, a
// row of global memory) into `dst` (the row in the raw tile): 16 bytes
// when `vec`, else one value at a time; columns past width are not copied.
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, int chunk, int width,
                                           bool vec) {
  const int c0 = 4 * chunk;
  if (c0 >= width) return;
  if (vec) {
    cp_async16(dst + c0, src + c0, true);
  } else {
    for (int i = 0; i < 4 && c0 + i < width; ++i) cp_async4(dst + c0 + i, src + c0 + i, true);
  }
}

// The same from a bf16 row, converted to f32 through registers: in place
// once this thread's loads have returned, which its own later reads of the
// chunk (the split) wait for; the copy is not part of a cp.async group.
__device__ __forceinline__ void copy_chunk(float* dst, const __nv_bfloat16* src, int chunk,
                                           int width, bool) {
  const int c0 = 4 * chunk;
  for (int i = 0; i < 4 && c0 + i < width; ++i) dst[c0 + i] = __bfloat162float(src[c0 + i]);
}

// 16-byte copies are possible when every row starts 16-byte aligned.
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* src, int width) {
  return (width & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
}

// The chunk `chunk` of a raw row as 4 values: zero past `width` columns and
// for rows past the staged ones (their raw memory is stale).
__device__ __forceinline__ float4 read_chunk(const float* raw_row, int chunk, int width,
                                             bool valid) {
  const int c0 = 4 * chunk;
  if (!valid || c0 >= width) return make_float4(0.f, 0.f, 0.f, 0.f);
  float4 x = *reinterpret_cast<const float4*>(raw_row + c0);
  if (c0 + 4 > width) {
    if (c0 + 1 >= width) x.y = 0.f;
    if (c0 + 2 >= width) x.z = 0.f;
    x.w = 0.f;
  }
  return x;
}

// Split 4 values into the hi and lo planes at offset o (16 bytes each).
__device__ __forceinline__ void put4(float* hi, float* lo, int o, float4 x) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void put1(float* hi, float* lo, int o, float x) {
  uint32_t h, l;
  split_tf32(x, h, l);
  hi[o] = __uint_as_float(h);
  lo[o] = __uint_as_float(l);
}

// Split one chunk (4 columns c0 .. c0 + 3 of source row `row`) into the
// transposed plane PT: element (row, c) at PT row c, column perm8(row)
// (kPerm) or row.
template <class PT, bool kPerm>
__device__ __forceinline__ void put_t(float* hi, float* lo, int row, int c0, float4 x) {
  const int col = kPerm ? perm8(row) : row;
  put1(hi, lo, PT::off(c0, col), x.x);
  put1(hi, lo, PT::off(c0 + 1, col), x.y);
  put1(hi, lo, PT::off(c0 + 2, col), x.z);
  put1(hi, lo, PT::off(c0 + 3, col), x.w);
}

// d += A B^T as wg_mma, for n up to 128: at 16 n-tiles, two n64 products,
// the second reading B's rows 64 .. 127, eight 8-row groups of plane P
// further on.
template <class P, int kN>
__device__ __forceinline__ void wg_mma_p(float (&d)[kN][4], const uint32_t (&a)[4],
                                         uint64_t desc, bool acc = true) {
  if constexpr (kN == 16) {
    wgmma_n64(*reinterpret_cast<float(*)[8][4]>(&d[0]), a, desc, acc);
    wgmma_n64(*reinterpret_cast<float(*)[8][4]>(&d[8]), a, desc + (uint64_t)(2 * P::kGS), acc);
  } else {
    wg_mma(d, a, desc, acc);
  }
}

// A operand fragments (16 x 8, mma.sync's A layout) of k-step kk, from an
// array held in registers or from an object that reads them (OwnRows in
// polysketch_causal_bwd.cu).
struct Frag4 {
  float x[4];
};
template <int kK>
__device__ __forceinline__ Frag4 frag_of(const float (&a)[kK][4], int kk) {
  return Frag4{{a[kk][0], a[kk][1], a[kk][2], a[kk][3]}};
}
template <class F>
__device__ __forceinline__ Frag4 frag_of(const F& f, int kk) {
  return f(kk);
}

// Two products at once for the warpgroup: acc1 += A1 B1^T and acc2 += A2
// B2^T, the three products of each k-step wgmma over all n-tiles, B read
// from the planes by descriptor, the two products' wgmma alternating. A
// operands are split per k-step; each is an array of fragments or an
// object that reads them (frag_of), read one k-step ahead of its use so
// that a read from memory runs under the k-step before. kAcc: A is a 16 x 8
// kKS block of scores in accumulator layout, taken as the A operand in
// place (k index t stands for column 2t of each 8, t + 4 for 2t + 1),
// which B's transposed plane matches by its permuted columns (perm8). kKS2
// may be 0. With fresh, acc1 = A1 B1^T and acc2 = A2 B2^T (their old values
// are not read). Each k-step is a group of its own, and the one before it
// is waited for: a group's A registers stay allocated until it completes,
// so no more than two k-steps' fragments are live. The caller commits and
// waits for the last.
template <bool kAcc>
__device__ __forceinline__ FragA split_frag(const float (&x)[4]) {
  return kAcc ? split_a(x[0], x[2], x[1], x[3]) : split_a(x[0], x[1], x[2], x[3]);
}

template <bool kAcc, int kN1, int kKS1, class P1, int kN2, int kKS2, class P2, class A1,
          class A2>
__device__ __forceinline__ void wg_pair(float (&acc1)[kN1][4], const A1& a1, const float* hi1,
                                        const float* lo1, float (&acc2)[kN2][4], const A2& a2,
                                        const float* hi2, const float* lo2, bool fresh = false) {
  constexpr int kKS = kKS1 > kKS2 ? kKS1 : kKS2;
  Frag4 n1 = frag_of(a1, 0), n2 = {};
  if (kKS2 > 0) n2 = frag_of(a2, 0);
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    FragA f1, f2;
    uint64_t h1 = 0, l1 = 0, h2 = 0, l2 = 0;
    if (kk < kKS1) {
      f1 = split_frag<kAcc>(n1.x);
      h1 = plane_desc<P1>(hi1 + 2 * kk * P1::kCS);
      l1 = plane_desc<P1>(lo1 + 2 * kk * P1::kCS);
    }
    if (kk < kKS2) {
      f2 = split_frag<kAcc>(n2.x);
      h2 = plane_desc<P2>(hi2 + 2 * kk * P2::kCS);
      l2 = plane_desc<P2>(lo2 + 2 * kk * P2::kCS);
    }
    if (kk + 1 < kKS1) n1 = frag_of(a1, kk + 1);
    if (kk + 1 < kKS2) n2 = frag_of(a2, kk + 1);
    const bool acc = !fresh || kk > 0;
    wg_fence();
    if (kk < kKS1) wg_mma_p<P1>(acc1, f1.lo, h1, acc);
    if (kk < kKS2) wg_mma_p<P2>(acc2, f2.lo, h2, acc);
    if (kk < kKS1) wg_mma_p<P1>(acc1, f1.hi, l1);
    if (kk < kKS2) wg_mma_p<P2>(acc2, f2.hi, l2);
    if (kk < kKS1) wg_mma_p<P1>(acc1, f1.hi, h1);
    if (kk < kKS2) wg_mma_p<P2>(acc2, f2.hi, h2);
    wg_commit();
    wg_wait1();
  }
}
