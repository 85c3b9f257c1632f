// The wgmma toolkit of the port's kernels on Hopper (sm_90a): the two
// backwards, polysketch_causal_bwd.cu (B1's) and poly_flash_bwd.cu (B2's),
// and the two forwards, poly_flash.cu (B2) and polysketch_causal.cu (B1's
// fold and outputs).
//
// - score_grads: the scores' transforms at the diagonal (dS and W from S
//   and dW, in registers, masked);
// - warpgroup products (wgmma m64nNk8 in TF32 for N = 8, 32, 64, 72, A
//   from registers or from shared memory) with their fences and waits;
// - split planes: an operand staged once into shared memory as its TF32
//   high and low halves, in wgmma's K-major layout (Plane, plane_desc,
//   perm8), the chunk copy and split helpers that fill them, and wg_pair,
//   two 3xTF32 products at once with B read from the planes (n up to 128,
//   A from registers or read a k-step ahead);
// - the forwards' pipeline: mbarriers and bulk copies, a producer
//   warpgroup that stages and splits, two consumer warpgroups (Flash, Ring,
//   flash_producer, flash_consume), and the flash diagonal on it
//   (split_keys, flash_scores, flash_tile).
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

// m64n8k8: the one-column products (B1's cross term against Zd_l).
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// m64n72k8: 64 output columns and one more n-tile (B1's fold against
// [V | 1]^T, the ones column giving Zd beside Zv).
__device__ __forceinline__ void wgmma_n72(float (&d)[9][4], const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// ---------------------------------------------------------------------------
// The forward flash diagonal on wgmma, shared by B2 (poly_flash.cu) and B1's
// pass 3 (polysketch_causal.cu's output_kernel).
//
// A CTA owns kFlashRows = 128 query rows: two consumer warpgroups of 64 rows
// (threads 0 .. 255; warp w owns rows 16w .. 16w + 15, as tc_store_rows
// reads them) and one producer warpgroup (threads 256 .. 383). The CTA walks
// a stream of items: the key tiles of its sequence (kKeys keys each), then,
// for B1, the cross term's items of Z_l (kZC sketch columns of one sketch
// index e). For every item:
//   - the producer's first thread bulk-copies the item's spans from device
//     memory into a ring of kFlashStages raw slots (cp.async.bulk, completed
//     on the slot's mbarrier with the byte count), kFlashStages items ahead;
//     one key tile of K or V in (bh, n, f) is one contiguous span;
//   - the producer warpgroup splits the landed slot once for the CTA into
//     TF32 planes (wgmma's K-major layout, Plane): K as stored, V transposed
//     with its keys permuted (perm8), Z_l transposed; a bf16 operand is
//     converted as it is written and has no lo plane (its x_lo is 0). Two
//     plane sets alternate, each with a full and an empty mbarrier, so the
//     next item is split while the consumers run this one's products;
//   - each consumer warpgroup runs the item's products on wgmma: S = Q K^T
//     with Q held in registers, the weight and the mask on the accumulator,
//     then W V with W taken from the accumulator as the A operand as it
//     stands (the V plane's permuted keys match it), into a fresh
//     accumulator that is added to the output's in f32 (C.1: the tensor
//     cores' adds truncate, so no sum runs long inside them).
// Each f32 product is three TF32 products (lo hi, hi lo, hi hi, as
// common.cuh's split rule); a product with a bf16 operand drops the terms
// whose bf16 lo is exactly zero. Items run in one fixed order (key tiles
// ascending, then e, then the column block), so n, bh and the grid change
// no sum's order. B1's fold (polysketch_causal.cu's fold_kernel) runs its
// own items, chunks of a block's keys, on the same pipeline.
//
// What the measurements on the card taught (PERF.md's kernel table). The split
// reads its raw slot through a pointer the compiler sees as shared
// (split_keys' kRaw): through a generic pointer that may also be device
// memory, every read is a generic load, and B2 at 32k took 23 ms instead
// of 20. The consumers split Q and W at each k-step instead of holding
// them split: fewer registers, fewer spills (ptxas reports every
// instantiation at the 384-thread bound of 168 registers; the consumers'
// setmaxnreg raises their own). One producer warp instead of four took B2
// at 32k from 25 to 57 ms.
// ---------------------------------------------------------------------------

constexpr int kFlashConsumers = 256;
constexpr int kFlashProducers = 128;
constexpr int kFlashThreads = kFlashConsumers + kFlashProducers;
constexpr int kFlashRows = 128;
constexpr int kFlashStages = 3;
constexpr int kZC = 32;                   // sketch columns c of a cross-term item
constexpr int kProducerRegs = 56;         // setmaxnreg: 128 x 56 + 256 x 224 = 65,536
constexpr int kConsumerRegs = 224;
constexpr long long kWaitLimit = 1ll << 35;   // clock cycles (~19 s): a broken protocol traps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > kWaitLimit) {
      __trap();
    }
  }
}
// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T> struct IsBf16 { static constexpr bool value = false; };
template <> struct IsBf16<__nv_bfloat16> { static constexpr bool value = true; };

// One instantiation's tiling: T the operands' type, kF the padded feature
// width of Q and K, kNV the output's n-tiles of 8 (8: h <= 64, 16: h <= 128).
// A key tile is 64 keys, or 32 where kF or the output is 128 wide, so that
// the ring and the two plane sets fit 227 KB (224 KB at h 64 in f32: the
// ring 96 KB, the sets 128 KB).
template <typename T, int kF_, int kNV_>
struct Flash {
  static constexpr int kF = kF_, kNV = kNV_;
  static constexpr bool kBf = IsBf16<T>::value;
  static constexpr int kKeys = kF <= 64 && kNV <= 8 ? 64 : 32;
  static constexpr int kSN = kKeys / 8;   // n-tiles of S, k-steps of W V
  static constexpr int kFS = kF / 8;      // k-steps of S
  static constexpr int kPl = kBf ? 1 : 2;   // planes an operand: hi (and lo)
  using PK = Plane<kKeys, kF, false>;       // K: n = keys, k = features
  using PV = Plane<8 * kNV, kKeys, false>;  // V^T: n = d, k = perm8(key)
  using PZ = Plane<8 * kNV, kZC, false>;    // Z_l's item: n = d, k = c
  using PD = Plane<16, kZC, false>;         // Zd_l's item: row 0, k = c
  // a raw slot: K (kKeys x f of T) then V at kRawK bytes; or Zv (kZC x h
  // f32) then Zd at kZC h floats
  static constexpr int kRawK = kKeys * kF * (int)sizeof(T);
  static constexpr int kRawDiag = kKeys * (kF + 8 * kNV) * (int)sizeof(T);
  static constexpr int kRawCross = (kZC * 8 * kNV + kZC) * 4;
  static constexpr int kRawBytes = ((kRawDiag > kRawCross ? kRawDiag : kRawCross) + 127) / 128 * 128;
  static constexpr int kKHi = 0, kKLo = PK::kFloats;   // floats into a plane set
  static constexpr int kVHi = kPl * PK::kFloats, kVLo = kVHi + PV::kFloats;
  static constexpr int kZHi = 0, kZLo = PZ::kFloats, kDHi = 2 * PZ::kFloats,
                       kDLo = kDHi + PD::kFloats;
  static constexpr int kDiagFloats = kPl * (PK::kFloats + PV::kFloats);
  static constexpr int kCrossFloats = 2 * (PZ::kFloats + PD::kFloats);
  static constexpr int kSetFloats = kDiagFloats > kCrossFloats ? kDiagFloats : kCrossFloats;
};

// The shared memory of a pipeline whose configuration C gives kRawBytes (a
// raw slot) and kSetFloats (a plane set): kFlashStages raw slots, two plane
// sets, then the mbarriers (raw full [kFlashStages], set full [2], set
// empty [2]).
template <class C>
struct Ring {
  static constexpr int kPlanesOff = kFlashStages * C::kRawBytes;   // bytes
  static constexpr int kBarsOff = kPlanesOff + 2 * C::kSetFloats * 4;
  static constexpr size_t kSmemBytes = (size_t)kBarsOff + (kFlashStages + 4) * 8;
  static_assert(C::kRawBytes % 128 == 0, "raw slots stay 128-byte aligned");
  static_assert(kSmemBytes <= 232448, "one CTA's shared memory on sm_90");

  __device__ static char* raw(char* smem, int s) { return smem + s * C::kRawBytes; }
  __device__ static float* planes(char* smem, int p) {
    return reinterpret_cast<float*>(smem + kPlanesOff) + p * C::kSetFloats;
  }
  __device__ static uint64_t* bar(char* smem, int i) {
    return reinterpret_cast<uint64_t*>(smem + kBarsOff) + i;
  }
  __device__ static uint64_t* raw_full(char* smem, int s) { return bar(smem, s); }
  __device__ static uint64_t* set_full(char* smem, int p) { return bar(smem, kFlashStages + p); }
  __device__ static uint64_t* set_empty(char* smem, int p) {
    return bar(smem, kFlashStages + 2 + p);
  }
};

// Thread 0 sets up the barriers; every thread of the CTA waits for it.
template <class C>
__device__ __forceinline__ void flash_init(char* smem) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFlashStages; ++s) mbar_init(Ring<C>::raw_full(smem, s), 1);
    for (int p = 0; p < 2; ++p) {
      mbar_init(Ring<C>::set_full(smem, p), kFlashProducers);
      mbar_init(Ring<C>::set_empty(smem, p), kFlashConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warpgroup's whole life: items [0, nitems), issue(it, slot,
// bar) bulk-copying item it into a raw slot (its first thread only, when
// bulk) and split(it, slot, planes, bulk) writing its planes from the slot,
// or straight from device memory when the spans are not aligned for bulk
// copies (bulk false: then nothing is staged).
template <class C, class Issue, class Split>
__device__ __forceinline__ void flash_producer(char* smem, int nitems, bool bulk, Issue issue,
                                               Split split) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
  const bool leader = threadIdx.x == kFlashConsumers;
  if (bulk && leader) {
    for (int it = 0; it < kFlashStages && it < nitems; ++it) {
      issue(it, Ring<C>::raw(smem, it), Ring<C>::raw_full(smem, it));
    }
  }
  for (int it = 0; it < nitems; ++it) {
    const int s = it % kFlashStages, p = it & 1;
    if (bulk) mbar_wait(Ring<C>::raw_full(smem, s), (it / kFlashStages) & 1);
    mbar_wait(Ring<C>::set_empty(smem, p), ((it >> 1) & 1) ^ 1);
    split(it, Ring<C>::raw(smem, s), Ring<C>::planes(smem, p), bulk);
    fence_async_smem();   // the planes' generic writes before wgmma's reads
    mbar_arrive(Ring<C>::set_full(smem, p));
    if (bulk && it + kFlashStages < nitems) {
      named_sync(1, kFlashProducers);   // every producer is done reading the slot
      if (leader) {
        fence_async_smem();
        issue(it + kFlashStages, Ring<C>::raw(smem, s), Ring<C>::raw_full(smem, s));
      }
    }
  }
}

// The consumers' loop over items [begin, end): wait for the item's plane
// set, run fn(it, planes) (the warpgroup's products, all waited for), and
// release the set.
template <class C, class Fn>
__device__ __forceinline__ void flash_consume(char* smem, int begin, int end, Fn fn) {
  for (int it = begin; it < end; ++it) {
    const int p = it & 1;
    mbar_wait(Ring<C>::set_full(smem, p), (it >> 1) & 1);
    fn(it, static_cast<const float*>(Ring<C>::planes(smem, p)));
    mbar_arrive(Ring<C>::set_empty(smem, p));
  }
}

// Four values at columns c0 .. c0 + 3 of a row of `width` (zero past it):
// one 16- or 8-byte load when vec (the row is aligned and width a multiple
// of 4), else value by value.
__device__ __forceinline__ float4 load4(const float* row, int c0, int width, bool vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 >= width) return x;
  if (vec) return *reinterpret_cast<const float4*>(row + c0);
  x.x = row[c0];
  if (c0 + 1 < width) x.y = row[c0 + 1];
  if (c0 + 2 < width) x.z = row[c0 + 2];
  if (c0 + 3 < width) x.w = row[c0 + 3];
  return x;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c0, int width, bool vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 >= width) return x;
  if (vec) {   // a bf16's f32 bits are its own 16 bits shifted up
    const uint2 u = *reinterpret_cast<const uint2*>(row + c0);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  x.x = to_f32(row[c0]);
  if (c0 + 1 < width) x.y = to_f32(row[c0 + 1]);
  if (c0 + 2 < width) x.z = to_f32(row[c0 + 2]);
  if (c0 + 3 < width) x.w = to_f32(row[c0 + 3]);
  return x;
}

// Four values into the planes at offset o: split (f32), or into the hi
// plane as they are (a bf16 value is exact in TF32).
template <bool kBf>
__device__ __forceinline__ void put_planes(float* hi, float* lo, int o, float4 x) {
  if (kBf) {
    *reinterpret_cast<float4*>(hi + o) = x;
  } else {
    put4(hi, lo, o, x);
  }
}

// The key and value spans of one sequence, for the producer.
template <typename T>
struct DiagSrc {
  const T* k;   // keys' features, klen x f
  const T* v;   // values, klen x h
  int f, h, klen;
};

template <class C, typename T>
__device__ __forceinline__ void issue_diag(char* raw, uint64_t* bar, const DiagSrc<T>& s, int kt) {
  const int k0 = kt * C::kKeys, rows = min(C::kKeys, s.klen - k0);
  const unsigned kb = rows * s.f * sizeof(T), vb = rows * s.h * sizeof(T);
  mbar_arrive_tx(bar, kb + vb);
  bulk_load(raw, s.k + (size_t)k0 * s.f, kb, bar);
  bulk_load(raw + C::kRawK, s.v + (size_t)k0 * s.h, vb, bar);
}

// Split key tile kt into a plane set: K (key, 4q .. 4q + 3) as 16 bytes at
// PK::off(key, 4q), a producer thread taking chunk q = (item / kKeys + key)
// mod kF/4 of key item mod kKeys, so that 8 lanes read 8 banks of the raw
// rows and write 128 contiguous bytes; V^T (d, 4u .. 4u + 3), the keys
// 8(u/2) + u%2 + {0, 2, 4, 6} whose permuted columns those are, 32 lanes
// reading 32 consecutive d of a key. Keys past the sequence and columns past
// f or h are zero, so their weights and products are 0.
// kRaw: from the landed raw slot (a shared-memory address the compiler
// sees as such), else straight from device memory.
template <class C, bool kRaw, typename T>
__device__ __forceinline__ void split_keys(float* pl, const DiagSrc<T>& s, int kt,
                                           const char* raw) {
  constexpr int kNC = C::kF / 4, kD = 8 * C::kNV;
  constexpr bool vec = kRaw;
  const int pt = threadIdx.x - kFlashConsumers;
  const int k0 = kt * C::kKeys, rows = min(C::kKeys, s.klen - k0);
  const T* kr = kRaw ? reinterpret_cast<const T*>(raw) : s.k + (size_t)k0 * s.f;
  const T* vr = kRaw ? reinterpret_cast<const T*>(raw + C::kRawK) : s.v + (size_t)k0 * s.h;
#pragma unroll 1
  for (int idx = pt; idx < C::kKeys * kNC; idx += kFlashProducers) {
    const int key = idx % C::kKeys, q = (idx / C::kKeys + key) % kNC;
    const float4 x = key < rows ? load4(kr + (size_t)key * s.f, 4 * q, s.f, vec)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    put_planes<C::kBf>(pl + C::kKHi, pl + C::kKLo, C::PK::off(key, 4 * q), x);
  }
#pragma unroll 1
  for (int idx = pt; idx < kD * (C::kKeys / 4); idx += kFlashProducers) {
    const int d = idx % kD, u = idx / kD, key = 8 * (u >> 1) + (u & 1);
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] = d < s.h && key + 2 * i < rows ? to_f32(vr[(size_t)(key + 2 * i) * s.h + d]) : 0.f;
    }
    put_planes<C::kBf>(pl + C::kVHi, pl + C::kVLo, u * C::PV::kCS + 4 * d,
                       make_float4(y[0], y[1], y[2], y[3]));
  }
}

// Q's A fragments for S = Q K^T (k-step kk: rows g and g + 8 of the warp,
// columns 8kk + t and 8kk + t + 4): a bf16 Q as its TF32 bits (its hi half
// is all of it), an f32 Q as it is, split at each k-step of S.
template <class C>
struct QFrags {
  uint32_t hi[C::kBf ? C::kFS : 1][4];
  float x[C::kBf ? 1 : C::kFS][4];
};

// Load the calling thread's Q fragments from the CTA's first query row q
// (rows of f values; rows past qrows and columns past f are zero).
template <class C, typename T>
__device__ __forceinline__ void load_q(QFrags<C>& qf, const T* q, int f, int qrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + g;
#pragma unroll
  for (int kk = 0; kk < C::kFS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + 8 * (i & 1), c = 8 * kk + t4 + 4 * (i >> 1);
      const float x = r < qrows && c < f ? to_f32(q[(size_t)r * f + c]) : 0.f;
      if constexpr (C::kBf) {
        qf.hi[kk][i] = __float_as_uint(x);
      } else {
        qf.x[kk][i] = x;
      }
    }
  }
}

// s = Q K^T for the warpgroup's 64 rows against the plane set's key tile:
// bf16, one TF32 product a k-step in one group; f32, Q split at each
// k-step, a group a k-step with the one before it waited for, so that at
// most two k-steps' fragments are live.
template <class C>
__device__ __forceinline__ void flash_scores(float (&s)[C::kSN][4], const QFrags<C>& qf,
                                             const float* pl) {
  using PK = typename C::PK;
  if constexpr (C::kBf) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::kFS; ++kk) {
      wg_mma_p<PK>(s, qf.hi[kk], plane_desc<PK>(pl + C::kKHi + 2 * kk * PK::kCS), kk > 0);
    }
    wg_commit();
  } else {
#pragma unroll
    for (int kk = 0; kk < C::kFS; ++kk) {
      const FragA a = split_a(qf.x[kk][0], qf.x[kk][1], qf.x[kk][2], qf.x[kk][3]);
      const uint64_t kh = plane_desc<PK>(pl + C::kKHi + 2 * kk * PK::kCS);
      const uint64_t kl = plane_desc<PK>(pl + C::kKLo + 2 * kk * PK::kCS);
      wg_fence();
      wg_mma_p<PK>(s, a.lo, kh, kk > 0);
      wg_mma_p<PK>(s, a.hi, kl);
      wg_mma_p<PK>(s, a.hi, kh);
      wg_commit();
      wg_wait1();
    }
  }
  wg_wait();
  reg_fence(s);
}

// One key tile for the calling warpgroup: S = Q K^T, the weight, the mask
// (keys past the row `row0 + local row` where causal), den += the row sums
// of W, acc += W V through a fresh accumulator per 64 output columns.
// row0: the sequence index of the warpgroup's first row, last: of its last
// valid row; k0: of the tile's first key. Warpgroup-uniform.
template <class C, class Weight>
__device__ __forceinline__ void flash_tile(const float* pl, const QFrags<C>& qf, int k0,
                                           int row0, int last, bool causal, Weight weight,
                                           float (&acc)[C::kNV][4], float (&den)[2]) {
  using PV = typename C::PV;
  if (causal && k0 > last) return;   // no row of the warpgroup sees a key of it
  float s[C::kSN][4];
  flash_scores<C>(s, qf, pl);
  weight(s);
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int row = row0 + 16 * ((threadIdx.x >> 5) & 3) + g;
  const bool masked = causal && k0 + C::kKeys - 1 > row0;
#pragma unroll
  for (int nt = 0; nt < C::kSN; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (masked && k0 + 8 * nt + 2 * t4 + (c & 1) > row + 8 * (c >> 1)) s[nt][c] = 0.f;
      den[c >> 1] += s[nt][c];
    }
  }
#pragma unroll
  for (int ch = 0; ch < C::kNV / 8; ++ch) {
    float o[8][4];
#pragma unroll
    for (int kk = 0; kk < C::kSN; ++kk) {
      // W's k-step kk, split as it is issued: a group's A registers stay
      // allocated until it completes, so at most two k-steps' are live
      const FragA w = split_frag<true>(s[kk]);
      const int off = 2 * kk * PV::kCS + ch * 8 * PV::kGS;
      const uint64_t vh = plane_desc<PV>(pl + C::kVHi + off);
      wg_fence();
      wgmma_n64(o, w.lo, vh, kk > 0);
      if constexpr (!C::kBf) wgmma_n64(o, w.hi, plane_desc<PV>(pl + C::kVLo + off), 1);
      wgmma_n64(o, w.hi, vh, 1);
      wg_commit();
      wg_wait1();
    }
    wg_wait();
    reg_fence(o);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[8 * ch + i][c] += o[i][c];
  }
}

// The consumers' registers, once the producers have given theirs up.
__device__ __forceinline__ void flash_consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// Whether a span starts 16-byte aligned, as cp.async.bulk needs.
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The shared memory each instantiation needs, set as its dynamic limit
// before its first launch (and read by the occupancy entry points).
template <class C, class K>
cudaError_t flash_smem_limit(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Ring<C>::kSmemBytes);
}
