// Block lower-triangular multiply O = lt(A B^T) C for NVIDIA Hopper
// (sm_90a), hand-written CUDA: the paper's Section 3.1 primitive.
//
// Replaces src/repro/kernels/lt_mult.py::lt_mult_pallas (the Pallas TPU
// kernel, body `_kernel`). A, B (bh, n, m), C (bh, n, k), diagonal
// included. For every block l of b rows:
//   O_l = tril(A_l B_l^T) C_l + A_l Z_l,   Z_l = H_0 + ... + H_{l-1},
//   H_l = B_l^T C_l                         (m, k) f32
//
// Why three passes, as in polysketch_causal.cu (B1, of which this is the
// case without sketch, power or denominator). The TPU walked the blocks of
// one bh row in order on one core and carried Z in VMEM. One CTA per bh
// row walking its blocks in order would leave ~128 of the 132 SMs idle at
// the benchmark's bh = 4. So:
//   pass 1  fold_kernel, (32 x 64 tile of H, block, bh) in parallel: H_l
//           for the blocks l < t - 1 (the last block's is never read) as
//           one product B_l^T C_l (M = m, N = k, K = b), over chunks of 64
//           rows staged with cp.async into a ring of two. Each warp sums
//           its 32 x 16 outputs over the block's rows in order: no split-K.
//   pass 2  prefix_kernel, elements of Z in parallel (float4 a thread),
//           blocks in order: slot l of the scratch becomes Z_{l+1} =
//           ((H_0 + H_1) + ...) + H_l, in place. The loads of 16 blocks are
//           issued before their adds, so the chain of t - 1 steps waits on
//           memory once every 16 blocks, not at every block.
//   pass 3  (query tile, block, bh) in parallel: the block's own triangle
//           over its 64-key tiles, flash-style (A the queries, B the keys,
//           C the values; no weight, no denominator), then the cross term
//           A_l Z_l as one product with K = m from the A tile already in
//           shared memory. At m <= 32, k <= 64 (narrow_output_kernel) a
//           warp takes 32 query rows, so each K, V and Z fragment serves
//           two m-tiles; the tiles are zero-padded to those widths, so
//           every key tile, the diagonal's included, runs one masked
//           straight-line body; Z_l comes in with the query tiles; and on a
//           large grid a CTA takes two query tiles of its block, the
//           heaviest and the lightest, in one pipeline. At other widths
//           (output_kernel) a warp takes 16 rows through common.cuh's
//           tc_tile_accumulate, as B1 and B2 did before their wgmma
//           forwards.
// Every product runs on the tensor cores as mma.sync m16n8k8 in 3xTF32
// (common.cuh). No atomics; every sum runs in a fixed order that bh does
// not change, so two runs are bit-identical, and so is one bh row computed
// alone and in a batch. bf16 inputs are staged as f32 and take the same
// path.
//
// What bounds it. At the benchmark's shape (bh = 4, m = 32, k = 64,
// b = 256, n = 16384, f32) the block triangles are 8.4 M pairs x (2m + 2k)
// = 1.6 GFLOP and the fold and cross terms 0.5 GFLOP, against 50.3 MB of
// A, B, C and O: 3 x 2.15 GFLOP at 495 TFLOP/s is 0.013 ms, 50.3 MB at
// 3.35 TB/s 0.015 ms, so the least time is 0.015 ms, set by bytes (0.0019
// ms at n = 2048; 0.032 and 0.0040 ms on the f32 FMA pipes). What the
// design does about it: the passes move ~92 MB between them (pass 1 reads
// B and C, pass 3 A, B, C, Z and O), and the kernel is bound by the issue
// and latency of its mma chains, not by bytes (PERF.md).
//
// Registers (nvcc -Xptxas -v, as chip_smoke.py prints it), no spills and
// no stack in any instantiation: narrow_output_kernel 163 a thread (f32)
// and 152 (bf16), with 99 KB of shared memory (two CTAs an SM);
// output_kernel 246 and 236; fold_kernel 80 and 54; prefix_kernel 94
// (float4) and 48 (float).

#include <stddef.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kMaxM = 128;
constexpr int kMaxK = 128;
constexpr int kFoldRows = 32;   // pass 1: rows of H per CTA (2 m-tiles a warp)
constexpr int kFoldCols = 64;   // pass 1: columns of H per CTA (2 n-tiles a warp)
constexpr int kFoldKeys = 64;   // pass 1: block rows per staged chunk
constexpr int kFoldBs = k_frag_stride(kFoldRows);
constexpr int kFoldCs = k_frag_stride(kFoldCols);
constexpr size_t kFoldSmemBytes = (size_t)2 * kFoldKeys * (kFoldBs + kFoldCs) * sizeof(float);
constexpr int kPrefixThreads = 64;
constexpr int kPrefixBatch = 16;   // pass 2: loads issued before their adds
constexpr int kPairCtas = 2;       // pass 3: pair query tiles from this many CTAs an SM

// acc[i][j] += a[i] b[j] in 3xTF32 for a kM x kN grid of accumulators: the
// two small terms first, each pass over every accumulator, so that the
// three products into one accumulator are kM kN mma apart (see mma_3xtf32).
template <int kM, int kN>
__device__ __forceinline__ void mma_3xtf32_grid(float (&acc)[kM][kN][4], const FragA (&a)[kM],
                                                const FragB (&b)[kN]) {
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) mma_tf32(acc[i][j], a[i].lo, b[j].hi);
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) mma_tf32(acc[i][j], a[i].hi, b[j].lo);
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) mma_tf32(acc[i][j], a[i].hi, b[j].hi);
}

// Stage rows [0, rows) of `width` values, src_stride apart, into shared
// memory at row stride `stride`, zero-filling rows [rows, total), as
// common.cuh's stage_rows does, but for f32 with one integer division a
// call instead of one a copy: thread i copies the 16 bytes at column
// 4 (i % vw) of rows i / vw, i / vw + per, ... (vw = width / 4 copies a row,
// per = kTcThreads / vw rows a pass). Widths that are not a multiple of 4
// go to stage_rows.
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int rows, int total,
                                           int width, int stride, int src_stride) {
  if (((width | src_stride) & 3) != 0 || (reinterpret_cast<uintptr_t>(src) & 15) != 0) {
    stage_rows<kTcThreads>(dst, src, rows, total, width, stride, src_stride);
    return;
  }
  const int vw = width >> 2, per = kTcThreads / vw;
  const int r0 = threadIdx.x / vw, c = 4 * (threadIdx.x - r0 * vw);
  if (r0 >= per) return;
  for (int row = r0; row < total; row += per) {
    const bool ok = row < rows;
    cp_async16(dst + row * stride + c, ok ? src + (size_t)row * src_stride + c : src, ok);
  }
}

// bf16 through registers, converted to f32, a copy at a time: the loop is
// not unrolled, so that it holds no registers beside pass 3's accumulators.
__device__ __forceinline__ void stage_tile(float* dst, const __nv_bfloat16* src, int rows,
                                           int total, int width, int stride, int src_stride) {
#pragma unroll 1
  for (int idx = threadIdx.x; idx < total * width; idx += kTcThreads) {
    const int row = idx / width, col = idx - row * width;
    dst[row * stride + col] = row < rows ? to_f32(src[(size_t)row * src_stride + col]) : 0.f;
  }
}

// Pass 1: hz[bh, l, i, c] = sum_{s in block l} b[s, i] c[s, c], l < t - 1.
// grid (ceil(m/32) * ceil(k/64), t - 1, bh), kTcThreads threads. Warp w
// owns rows i0 .. i0 + 31 and columns c0 + 16w .. c0 + 16w + 15 of H:
// A = B_l^T from the staged B chunk (k index = row of the block), B = C_l
// from the staged C chunk, both split in registers. A chunk's rows past
// the block are staged as zeros, so every chunk runs all its k-steps.
template <typename T>
__global__ void __launch_bounds__(kTcThreads)
fold_kernel(const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ hz, int n,
            int m, int kk, int b) {
  const int col_tiles = (kk + kFoldCols - 1) / kFoldCols;
  const int i0 = blockIdx.x / col_tiles * kFoldRows;
  const int c0 = blockIdx.x % col_tiles * kFoldCols;
  const int l = blockIdx.y, t1 = gridDim.y, bh = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int mw = min(kFoldRows, m - i0), kw = min(kFoldCols, kk - c0);
  extern __shared__ __align__(16) float smem[];
  float* b_ring = smem;                               // 2 x kFoldKeys x kFoldBs
  float* c_ring = b_ring + 2 * kFoldKeys * kFoldBs;   // 2 x kFoldKeys x kFoldCs

  zero_pad_cols<kTcThreads>(b_ring, 2 * kFoldKeys, mw, kFoldBs);
  zero_pad_cols<kTcThreads>(c_ring, 2 * kFoldKeys, kw, kFoldCs);
  float acc[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const int chunks = (b + kFoldKeys - 1) / kFoldKeys;
  const auto stage = [&](int ch) {
    const int s0 = ch * kFoldKeys, rows = min(kFoldKeys, b - s0);
    stage_tile(b_ring + (ch & 1) * kFoldKeys * kFoldBs, bm + (row0 + s0) * m + i0, rows,
               kFoldKeys, mw, kFoldBs, m);
    stage_tile(c_ring + (ch & 1) * kFoldKeys * kFoldCs, cm + (row0 + s0) * kk + c0, rows,
               kFoldKeys, kw, kFoldCs, kk);
    cp_async_commit();
  };
  stage(0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bd = b_ring + (ch & 1) * kFoldKeys * kFoldBs;
    const float* cd = c_ring + (ch & 1) * kFoldKeys * kFoldCs + warp * 16;
#pragma unroll
    for (int s0 = 0; s0 < kFoldKeys; s0 += 8) {
      const float* ba = bd + (s0 + t4) * kFoldBs + g;
      FragA a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt] = split_a(ba[mt * 16], ba[mt * 16 + 8], ba[4 * kFoldBs + mt * 16],
                        ba[4 * kFoldBs + mt * 16 + 8]);
      }
      const float* cb = cd + (s0 + t4) * kFoldCs + g;
      FragB bf[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) bf[nt] = split_b(cb[nt * 8], cb[4 * kFoldCs + nt * 8]);
      mma_3xtf32_grid(acc, a, bf);
    }
    __syncthreads();
  }
  float* dst = hz + ((size_t)bh * t1 + l) * m * kk;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + mt * 16 + g + 8 * (c >> 1);
        const int col = c0 + warp * 16 + nt * 8 + 2 * t4 + (c & 1);
        if (i < m && col < kk) dst[(size_t)i * kk + col] = acc[mt][nt][c];
      }
    }
  }
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Pass 2: in place over the t1 = t - 1 slots of hz, slot l (H_l) becomes
// Z_{l+1} = ((H_0 + H_1) + ...) + H_l. grid (ceil(mk / (64 kVec)), bh):
// kVec consecutive elements a thread (V = float4 when m*k is a multiple of
// 4, else float).
template <typename V>
__global__ void __launch_bounds__(kPrefixThreads)
prefix_kernel(float* __restrict__ hz, int t1, int mk) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  const int e = (blockIdx.x * kPrefixThreads + threadIdx.x) * kVec;
  if (e >= mk) return;
  V* cur = reinterpret_cast<V*>(hz + (size_t)blockIdx.y * t1 * mk + e);
  const size_t vstride = mk / kVec;
  V z = cur[0];
  for (int l0 = 1; l0 < t1; l0 += kPrefixBatch) {
    V h[kPrefixBatch];
#pragma unroll
    for (int i = 0; i < kPrefixBatch; ++i) {
      if (l0 + i < t1) h[i] = cur[(l0 + i) * vstride];
    }
#pragma unroll
    for (int i = 0; i < kPrefixBatch; ++i) {
      if (l0 + i < t1) {
        z = vadd(z, h[i]);
        cur[(l0 + i) * vstride] = z;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3 at the narrow widths, m <= 32 and k <= 64 (the benchmark's): a CTA
// of 4 warps takes 128 query rows of block l, 32 a warp as two m-tiles,
// so that every fragment of K, V and Z loaded and split serves two m-tiles
// and each pass of three products runs over twice the accumulators. Tiles
// are staged at widths 32 and 64, zero-padded, so every stride is known at
// compile time and every key tile, the diagonal's included, runs one
// straight-line body (masked after the products): no mma is guarded.
// ---------------------------------------------------------------------------

constexpr int kNarrowRows = 128;   // query rows of a narrow CTA
constexpr int kNarrowM = 32, kNarrowNT = 8;   // padded m, and k / 8
constexpr int kNarrowFs = row_frag_stride(kNarrowM);
constexpr int kNarrowVs = pair_frag_stride(8 * kNarrowNT);
constexpr int kNarrowZs = k_frag_stride(8 * kNarrowNT);

// One 64-key tile for the calling warp, in two halves of 32 keys: S = Q Kᵀ
// (2 m-tiles x 4 n-tiles), the causal mask, then acc += W V (2 m-tiles x 8
// n-tiles). q_s: the warp's 32 query rows (block rows qrow0 .. qrow0 + 31);
// k_s, v_s: the tile's keys k0 .. k0 + 63. A half all of whose keys lie
// above the warp's last row is skipped (a branch the whole warp takes).
__device__ __forceinline__ void narrow_tile(float (&acc)[2][kNarrowNT][4], const float* q_s,
                                            const float* k_s, const float* v_s, int qrow0,
                                            int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (k0 + 32 * h > qrow0 + 31) break;
    float s[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][nt][c] = 0.f;
#pragma unroll
    for (int e = 0; e < kNarrowM; e += 8) {
      FragA a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* qa = q_s + (16 * mt + g) * kNarrowFs + e + t;
        a[mt] = split_a(qa[0], qa[8 * kNarrowFs], qa[4], qa[8 * kNarrowFs + 4]);
      }
      FragB b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* kb = k_s + (32 * h + 8 * nt + g) * kNarrowFs + e + t;
        b[nt] = split_b(kb[0], kb[4]);
      }
      mma_3xtf32_grid(s, a, b);
    }
    // key k0 + 32h + j meets row qrow0 + r only if it is not later; keys and
    // rows past the block are zero rows, whose products are 0
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = qrow0 + 16 * mt + g + 8 * (c >> 1);
          const int key = k0 + 32 * h + 8 * nt + 2 * t + (c & 1);
          s[mt][nt][c] = key <= row ? s[mt][nt][c] : 0.f;
        }
    // W V: the scores' accumulator is the A operand as it stands, its k
    // index t standing for key 2t and t + 4 for key 2t + 1 (as in
    // tc_tile_accumulate)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragA a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt] = split_a(s[mt][kk][0], s[mt][kk][2], s[mt][kk][1], s[mt][kk][3]);
      }
      const float* vb = v_s + (32 * h + 8 * kk + 2 * t) * kNarrowVs + g;
      FragB b[kNarrowNT];
#pragma unroll
      for (int nd = 0; nd < kNarrowNT; ++nd) b[nd] = split_b(vb[8 * nd], vb[kNarrowVs + 8 * nd]);
      mma_3xtf32_grid(acc, a, b);
    }
  }
}

// acc += A Z_l for the calling warp's 32 rows, K = 32 (q_s: the warp's rows;
// z_s: Z_l, rows past m and columns past k zero).
__device__ __forceinline__ void narrow_cross_term(float (&acc)[2][kNarrowNT][4],
                                                  const float* q_s, const float* z_s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < kNarrowM; e += 8) {
    FragA a[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* qa = q_s + (16 * mt + g) * kNarrowFs + e + t;
      a[mt] = split_a(qa[0], qa[8 * kNarrowFs], qa[4], qa[8 * kNarrowFs + 4]);
    }
    const float* zb = z_s + (e + t) * kNarrowZs + g;
    FragB b[kNarrowNT];
#pragma unroll
    for (int nd = 0; nd < kNarrowNT; ++nd) b[nd] = split_b(zb[8 * nd], zb[4 * kNarrowZs + 8 * nd]);
    mma_3xtf32_grid(acc, a, b);
  }
}

// grid (pair ? ceil(tiles / 2) : tiles, t, bh) over tiles = ceil(b / 128)
// query tiles of a block, kTcThreads threads; the heaviest tile first.
// pair: CTA x takes tiles tiles - 1 - x and then x (x < tiles - 1 - x), so
// that every CTA runs about the same number of key tiles, in one pipeline
// whose staging runs on from the first tile's keys into the second's. Z_l
// is staged once, with the query tiles, into shared memory of its own.
template <typename T>
__global__ void __launch_bounds__(kTcThreads)
narrow_output_kernel(const T* __restrict__ am, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ zz,
                     T* __restrict__ out, int n, int m, int kk, int b, int pair) {
  const int l = blockIdx.y, bh = blockIdx.z, t = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int tiles = (b + kNarrowRows - 1) / kNarrowRows;
  const int qa = tiles - 1 - blockIdx.x, qb = blockIdx.x;   // the CTA's query tiles
  const int nq = pair && qb < qa ? 2 : 1;
  const int ktiles_a = (min(b, (qa + 1) * kNarrowRows) + kKeyTile - 1) / kKeyTile;
  const int steps =
      ktiles_a + (nq == 2 ? (min(b, (qb + 1) * kNarrowRows) + kKeyTile - 1) / kKeyTile : 0);

  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                                   // 2 x kNarrowRows x kNarrowFs
  float* k_ring = a_s + 2 * kNarrowRows * kNarrowFs;   // 2 x kKeyTile x kNarrowFs
  float* v_ring = k_ring + 2 * kKeyTile * kNarrowFs;   // 2 x kKeyTile x kNarrowVs
  float* z_s = v_ring + 2 * kKeyTile * kNarrowVs;      // kNarrowM x kNarrowZs

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const T* kf = bm + row0 * m;
  const T* v = cm + row0 * kk;
  zero_pad_cols<kTcThreads>(a_s, 2 * kNarrowRows + 2 * kKeyTile, m, kNarrowFs);
  zero_pad_cols<kTcThreads>(v_ring, 2 * kKeyTile, kk, kNarrowVs);
  for (int i = 0; i < nq; ++i) {
    const int q0 = (i ? qb : qa) * kNarrowRows;
    stage_tile(a_s + i * kNarrowRows * kNarrowFs, am + (row0 + q0) * m, min(kNarrowRows, b - q0),
               kNarrowRows, m, kNarrowFs, m);
  }
  if (l > 0) {
    zero_pad_cols<kTcThreads>(z_s, kNarrowM, kk, kNarrowZs);
    stage_tile(z_s, zz + ((size_t)bh * (t - 1) + l - 1) * m * kk, m, kNarrowM, kk, kNarrowZs, kk);
  }

  float acc[2][kNarrowNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nd = 0; nd < kNarrowNT; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nd][c] = 0.f;

  const auto stage = [&](int s) {
    const int k0 = (s < ktiles_a ? s : s - ktiles_a) * kKeyTile, rows = min(kKeyTile, b - k0);
    stage_tile(k_ring + (s & 1) * kKeyTile * kNarrowFs, kf + (size_t)k0 * m, rows, kKeyTile, m,
               kNarrowFs, m);
    stage_tile(v_ring + (s & 1) * kKeyTile * kNarrowVs, v + (size_t)k0 * kk, rows, kKeyTile, kk,
               kNarrowVs, kk);
    cp_async_commit();
  };
  stage(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i = s < ktiles_a ? 0 : 1, kt = i ? s - ktiles_a : s;
    const int q0 = (i ? qb : qa) * kNarrowRows, qrows = min(kNarrowRows, b - q0);
    const int k0 = kt * kKeyTile;
    const float* q_s = a_s + (i * kNarrowRows + 32 * warp) * kNarrowFs;
    narrow_tile(acc, q_s, k_ring + (s & 1) * kKeyTile * kNarrowFs,
                v_ring + (s & 1) * kKeyTile * kNarrowVs, q0 + 32 * warp, k0);
    if (k0 + kKeyTile >= q0 + qrows) {   // the query tile's last key tile
      if (l > 0) narrow_cross_term(acc, q_s, z_s);
      T* o = out + (row0 + q0) * kk;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nd = 0; nd < kNarrowNT; ++nd)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = 32 * warp + 16 * mt + g + 8 * (c >> 1), d = 8 * nd + 2 * t4 + (c & 1);
            if (row < qrows && d < kk) o[(size_t)row * kk + d] = from_f32<T>(acc[mt][nd][c]);
            acc[mt][nd][c] = 0.f;
          }
    }
    __syncthreads();
  }
}

constexpr size_t kNarrowSmemBytes =
    ((size_t)2 * kNarrowRows * kNarrowFs + (size_t)2 * kKeyTile * (kNarrowFs + kNarrowVs) +
     (size_t)kNarrowM * kNarrowZs) * sizeof(float);

// ---------------------------------------------------------------------------
// Pass 3 at the other widths (m <= 128, k <= 128): a CTA of 4 warps takes
// one 64-row query tile of block l, 16 rows a warp, through common.cuh's
// tc_tile_accumulate at the input's own widths (the straight-line path,
// masked, at m = 128 and k = 128; the guarded path else), then stages Z_l
// into the rings, now free, for the cross term. grid (ceil(b / 64), t, bh).
// ---------------------------------------------------------------------------

// The cross term acc += A_tile Z_l for the calling warp's 16 rows, K = m:
// A's fragments from the staged query tile (a_s, stride fs; columns past m
// are zeros), Z_l's from z_s (stride zs; rows past m are zeros). kFull:
// m == kF and k == 8 kNT, so the loops run unguarded.
template <int kF, int kNT, bool kFull>
__device__ __forceinline__ void cross_term(float (&acc)[kNT][4], const float* a_s, int fs,
                                           const float* z_s, int zs, int m, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* qa = a_s + ((threadIdx.x >> 5) * 16 + g) * fs + t4;
  const int nv = kFull ? kNT : (kk + 7) / 8;
#pragma unroll
  for (int e = 0; e < kF; e += 8) {
    if (!kFull && e >= m) break;
    const FragA a = split_a(qa[e], qa[e + 8 * fs], qa[e + 4], qa[e + 8 * fs + 4]);
    mma_3xtf32_cols(acc, a, z_s + (e + t4) * zs + g, 4 * zs, nv);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads)
output_kernel(const T* __restrict__ am, const T* __restrict__ bm, const T* __restrict__ cm,
              const float* __restrict__ zz, T* __restrict__ out, int n, int m, int kk, int b) {
  constexpr int kF = kMaxM, kNT = kMaxK / 8;
  // the last tile (most key tiles) first, so the grid's tail is short
  const int qt = gridDim.x - 1 - blockIdx.x, l = blockIdx.y, bh = blockIdx.z, t = gridDim.y;
  const int q0 = qt * kTcTile;
  const int qrows = min(kTcTile, b - q0);
  const int fs = row_frag_stride(m), vs = pair_frag_stride(kk), zs = k_frag_stride(kk);
  const bool full_width = m == kF && kk == 8 * kNT;

  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                            // kTcTile x fs
  float* k_ring = a_s + kTcTile * fs;           // 2 x kKeyTile x fs
  float* v_ring = k_ring + 2 * kKeyTile * fs;   // 2 x kKeyTile x vs
  float* z_s = k_ring;                          // after the loop: m8 x zs

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  zero_pad_cols<kTcThreads>(a_s, kTcTile + 2 * kKeyTile, m, fs);
  zero_pad_cols<kTcThreads>(v_ring, 2 * kKeyTile, kk, vs);
  stage_tile(a_s, am + (row0 + q0) * m, qrows, kTcTile, m, fs, m);

  float acc[kNT][4];
  float no_den[2] = {0.f, 0.f};   // IdentityWeight sums no weights
#pragma unroll
  for (int nd = 0; nd < kNT; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  // ---- the block's own triangle: tril(A_l B_l^T) C_l ----
  const int ktiles = (q0 + qrows + kKeyTile - 1) / kKeyTile;
  const T* kf = bm + row0 * m;
  const T* v = cm + row0 * kk;
  const auto stage = [&](int kt) {
    const int k0 = kt * kKeyTile, rows = min(kKeyTile, b - k0);
    stage_tile(k_ring + (kt & 1) * kKeyTile * fs, kf + (size_t)k0 * m, rows, kKeyTile, m, fs, m);
    stage_tile(v_ring + (kt & 1) * kKeyTile * vs, v + (size_t)k0 * kk, rows, kKeyTile, kk, vs,
               kk);
    cp_async_commit();
  };
  stage(0);
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      stage(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * kKeyTile, krows = min(kKeyTile, b - k0);
    const float* k_s = k_ring + (kt & 1) * kKeyTile * fs;
    const float* v_s = v_ring + (kt & 1) * kKeyTile * vs;
    // one body of code a tile at full width: below the diagonal the mask
    // keeps every weight
    if (full_width) {
      tc_tile_accumulate<kNT, kNT, kF, true, true>(a_s, fs, k_s, fs, m, v_s, vs, kk, q0, qrows,
                                                   k0, krows, true, IdentityWeight{}, acc,
                                                   no_den);
    } else {
      tc_tile_accumulate<kNT, kNT, kF, false>(a_s, fs, k_s, fs, m, v_s, vs, kk, q0, qrows, k0,
                                              krows, true, IdentityWeight{}, acc, no_den);
    }
    __syncthreads();
  }

  // ---- the earlier blocks through Z_l (zero for l = 0): A_l Z_l ----
  if (l > 0) {
    const int m8 = (m + 7) / 8 * 8;
    zero_pad_cols<kTcThreads>(z_s, m8, kk, zs);
    stage_tile(z_s, zz + ((size_t)bh * (t - 1) + l - 1) * m * kk, m, m8, kk, zs, kk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if ((threadIdx.x >> 5) * 16 < qrows) {
      if (full_width) {
        cross_term<kF, kNT, true>(acc, a_s, fs, z_s, zs, m, kk);
      } else {
        cross_term<kF, kNT, false>(acc, a_s, fs, z_s, zs, m, kk);
      }
    }
  }
  tc_store_rows<kNT, false>(out + (row0 + q0) * kk, kk, qrows, acc, no_den);
}

size_t output_smem_bytes(int m, int kk) {
  const size_t fs = row_frag_stride(m), vs = pair_frag_stride(kk);
  const size_t rings = (size_t)2 * kKeyTile * (fs + vs);
  const size_t z = (size_t)(m + 7) / 8 * 8 * k_frag_stride(kk);   // in the rings, after
  return ((size_t)kTcTile * fs + (rings > z ? rings : z)) * sizeof(float);
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` once per device:
// `done` holds a bit for each device (below 64) where it is raised.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t bytes,
                             std::atomic<unsigned long long>& done, int dev) {
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T>
cudaError_t launch_output(const void* a, const void* b, const void* c, const float* zz,
                          void* out, int bh, int n, int m, int kk, int blk, int dev,
                          cudaStream_t stream) {
  const int t = n / blk;
  cudaError_t err;
  if (m <= kNarrowM && kk <= 8 * kNarrowNT) {
    static std::atomic<unsigned long long> raised{0};
    if ((err = raise_smem_limit(narrow_output_kernel<T>, kNarrowSmemBytes, raised, dev)) !=
        cudaSuccess) {
      return err;
    }
    // Pair the query tiles when the unpaired grid would fill every SM
    // kPairCtas times over: a large grid then gains more from CTAs of equal
    // length than a small one loses from having half as many.
    int sms = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess) {
      return err;
    }
    const int tiles = (blk + kNarrowRows - 1) / kNarrowRows;
    const int pair = (long long)tiles * t * bh >= (long long)kPairCtas * sms;
    const dim3 grid(pair ? (tiles + 1) / 2 : tiles, t, bh);
    narrow_output_kernel<T><<<grid, kTcThreads, kNarrowSmemBytes, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c), zz,
        static_cast<T*>(out), n, m, kk, blk, pair);
    return cudaGetLastError();
  }
  static std::atomic<unsigned long long> raised{0};
  if ((err = raise_smem_limit(output_kernel<T>, output_smem_bytes(kMaxM, kMaxK), raised, dev)) !=
      cudaSuccess) {
    return err;
  }
  const dim3 grid((blk + kTcTile - 1) / kTcTile, t, bh);
  output_kernel<T><<<grid, kTcThreads, output_smem_bytes(m, kk), stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c), zz,
      static_cast<T*>(out), n, m, kk, blk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* a, const void* b, const void* c, void* out, float* hz, int bh,
                int n, int m, int kk, int blk, cudaStream_t stream) {
  const int t = n / blk;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (t > 1) {   // Z_l for l >= 1; a single block needs no state
    static std::atomic<unsigned long long> raised{0};
    if ((err = raise_smem_limit(fold_kernel<T>, kFoldSmemBytes, raised, dev)) != cudaSuccess) {
      return err;
    }
    const dim3 grid1(((m + kFoldRows - 1) / kFoldRows) * ((kk + kFoldCols - 1) / kFoldCols),
                     t - 1, bh);
    fold_kernel<T><<<grid1, kTcThreads, kFoldSmemBytes, stream>>>(
        static_cast<const T*>(b), static_cast<const T*>(c), hz, n, m, kk, blk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int mk = m * kk;
    if (mk % 4 == 0 && (reinterpret_cast<uintptr_t>(hz) & 15) == 0) {
      const dim3 grid2((mk + 4 * kPrefixThreads - 1) / (4 * kPrefixThreads), bh);
      prefix_kernel<float4><<<grid2, kPrefixThreads, 0, stream>>>(hz, t - 1, mk);
    } else {
      const dim3 grid2((mk + kPrefixThreads - 1) / kPrefixThreads, bh);
      prefix_kernel<float><<<grid2, kPrefixThreads, 0, stream>>>(hz, t - 1, mk);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return launch_output<T>(a, b, c, hz, out, bh, n, m, kk, blk, dev, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous tensors of one type (dtype 0 = float32, 1 = bfloat16):
// a, b (bh, n, m); c, out (bh, n, k); hz (bh, n/blk - 1, m, k) float32
// scratch (unused when n == blk). Requires n % blk == 0, m <= 128 and
// k <= 128. Returns the first CUDA error (0 on success); launches on
// `stream` and does not synchronise.
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
