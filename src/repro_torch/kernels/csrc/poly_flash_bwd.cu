// The backward of exact polynomial attention (B2) for NVIDIA Hopper
// (sm_90a), hand-written CUDA.
//
// The JAX package has no backward kernel for it: it trains the polynomial
// baseline through XLA's gradient of poly_attention_full
// (src/repro/core/poly_attention.py). This file gives B2's forward
// (poly_flash.cu) a backward of its own, so that training runs on kernels
// end to end. Causal (n == t). Per bh, with the forward's output out and
// D_i = 1 + sum_j w_ij (its den_out), s_ij = <q_i, k_j> * scale and
// w_ij = s_ij^p:
//   dNum_i = dO_i / D_i,   dDen_i = -(dO_i . out_i) / D_i
//   dW_ij  = <dNum_i, v_j> + dDen_i,   dS_ij = p s_ij^(p-1) scale dW_ij   (j <= i)
//   dv_j = sum_{i >= j} w_ij dNum_i,   dk_j = sum_{i >= j} dS_ij q_i,
//   dq_i = sum_{j <= i} dS_ij k_j.
//
// Two launches:
//   poly_flash_bwd_prep_kernel  dNum and dDen from dO, out and D (one warp a
//                               row); zeroes the ordering counters.
//   poly_flash_bwd_kernel       one pass over key tiles: S and dW once a
//                               causal pair, dk, dv and dq from them.
//
// Head widths and types. The key-tile kernel is a template on the padded
// head width kH, 64 (h <= 64) or 128 (h <= 128), and on the operands' type
// T, float32 or bfloat16. bf16 operands (q, k, v, out, dO) are converted to
// f32 as they are staged (cp.async copies f32 only, so a bf16 chunk goes
// through the registers of the thread that later splits it); D and the
// scratch (dNum, dDen) are f32; every product is 3xTF32 as in f32 (a bf16
// value is exact in TF32, so its low half is zero), and the gradients are
// written in T from their f32 sums. dq, summed in place across key tiles,
// is summed in an f32 buffer (dq itself for f32) and written in T by the
// key tile that adds the last part of each stage.
//
// One pass. At kH = 64 a work item is one tile of 128 keys of one bh (8
// warps, two warpgroups of 64 keys). It streams the queries from its
// diagonal on, 32 a stage, and for each stage forms S^T = K Q^T and dW^T =
// V dNum^T (+ dDen) once, turns them into W and dS in registers
// (score_transform), folds W dNum into dv and dS Q into dk, and forms the
// stage's part of dq, dS K over its 128 keys. The accumulators hold dS^T
// by key rows, so dS goes through shared memory as a split plane (one a
// warpgroup) and each warpgroup forms dq^T = K^T dS over its own 64 keys;
// the two halves are added in shared memory. dk and dv are written once at
// the end of the item.
//
// At kH = 128 (kWide) neither the registers nor shared memory hold that
// item: the dk and dv accumulators of 64 keys x 128 columns take 128
// registers a thread beside their fresh stage accumulators, and the own K
// and V planes alone 256 KB. So a work item is 64 keys, and the two
// warpgroups split the columns: each forms S^T and dW^T over all 128 of h
// for the same 64 keys (the two products twice, ~1.4x the flops of one
// pass), and dv, dk and dq^T for its own 64 columns, so its registers are
// those of the kH = 64 item. The own K and V are not staged: S's and dW's
// A fragments, and dq^T's K^T fragments, are read from memory (L1) at each
// k-step, one k-step ahead (OwnA), and split in registers, as B1's
// backward does at h 128. Each warpgroup's dq^T is the item's whole part of
// its columns, so no halves are exchanged.
//
// dq, summed in place in a fixed order. dq_i collects a part from every key
// tile j at or before row i. A counter per (bh, 32-query stage) in scratch,
// zeroed by the prep kernel each call, says how many key tiles have added
// theirs. Key tile j adds to a stage only when its counter reads j. At the
// end of the stage, thread 0 reads the counter (ld.relaxed.gpu) before it
// splits the next stage, waits for j after, and fences (fence.acq_rel.gpu:
// the acquire), and the __syncthreads that closes the stage passes that on.
// Under the next stage's first products every thread reads its part of
// the stage's dq rows through L2 (ld.global.cg, all loads before any
// store), adds its part in f32 (rounded to nearest), and stores; after the
// next __syncthreads, once that stage's products are done, thread 0 fences
// and bumps the counter (fence.acq_rel.gpu, atomicAdd: the release); by
// then the stores have long been issued, so the fence does not wait for
// them. Key tile 0, the first contributor, stores without reading. So dq_i
// = ((part_0 + part_1) + ...) in ascending key order whatever the
// schedule, and no atomic adds into dq, dk or dv: two calls give the same
// bits. The key tile whose rows hold the stage's last query (tile (q0 +
// rows - 1) / tile rows, the last to add) writes the bf16 result. Both
// tile heights (128, 64) are multiples of the 32-query stage, so a tile's
// first stage lies inside it and the tile is that stage's last
// contributor. Between the issue of wgmma and their wait the code has no
// loop (a rolled loop there makes ptxas wait for the wgmma before it).
//
// Why it cannot deadlock. The grid is persistent (CTAs resident an SM, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the SMs) and each
// CTA claims work items by a ticket counter (atomicAdd), key-tile-major:
// tile 0 of every bh, then tile 1 of every bh, and so on, the heaviest
// tiles first. A CTA waits only for key tile j - 1 of its bh, whose ticket
// is lower; a ticket is held only by a CTA that claimed it, so by a CTA that
// is running; and that CTA in turn waits only on lower tickets, down to
// tile 0, which waits on none. So every wait ends, whatever order the
// hardware starts blocks in and however many are resident, at either tile
// height. (A wait that runs for seconds traps instead of hanging: that
// would be a broken invariant, not a slow card.) With ascending key order,
// tile j lags tile j - 1 by one stage only while both start together, in
// the first wave.
//
// Operands, split once. Every staged operand is split into its TF32 high
// and low halves once, into planes in wgmma's layout (wgmma_planes.cuh's
// Plane): at kH = 64 the item's own K and V when they are staged (S and dW
// take A from them by descriptor, wgmma SS mode; dq^T reads K^T's
// fragments from the same K plane, which is padded so that those reads are
// free of conflicts); each stage's Q and dNum, by the thread that copied it
// (cp.async into a raw slot while the stage before it runs), into the
// direct planes of S and dW and the transposed, key-permuted planes of dk
// and dv, whose A operand is the scores' accumulator as it stands (perm8).
// All products are wgmma m64n32k8 or m64n64k8 in 3xTF32 (common.cuh's
// split rule).
//
// Shared memory, and why one plane set. At h = 64 the own K and V planes
// take 128 KB, one stage's four planes 69 KB, the raw slot 17 KB: 230,672
// B of the 232,448 a CTA may hold. A second plane set (to split stage
// st + 1 under stage st's products, as B1's backward does) would not fit
// beside the own planes, nor would a K^T plane for dq's A; so the dS planes
// take the place of the stage's Q and dNum planes once S and dW are
// formed, and the next stage is split after the stage's products. At kH =
// 128 a stage's four planes take 135 KB and its raw slot 33 KB (173 KB in
// all). One CTA an SM.
//
// Accuracy. The tensor cores add a product into their f32 accumulator with
// truncation (round toward zero), so a long chain of wgmma into one sum
// drifts. Each stage's output products go to fresh accumulators (wgmma
// without the old value on their first k-step: 12 wgmma for dv and dk, 24
// for a warpgroup's part of dq), and the stages are summed in f32, rounded
// to nearest.
//
// Edges. Rows past n are staged (or read) as zeros, masked and not stored,
// any n; the diagonal's mask is applied on every stage that crosses it. The
// power is taken over the whole fragment (p s^(p-1) is exactly p at p = 1,
// also where s = 0). h is zero-padded to kH.
//
// What bounds it. At the training shape (bh 24, n 4096, h 64, p 4, f32)
// the function needs five products over the 201.4 M causal pairs (S, dW,
// dv, dq, dk: 10h flops a pair, 128.9 GFLOP) and ~1.6 GFLOP of the rest,
// against 201 MB of q, k, v, out, dO, dq, dk, dv; this kernel computes
// each product once (at kH = 128, S and dW twice). In 3xTF32 at 495
// TFLOP/s that is ~0.81 ms, bound by operations (1.95 ms on the f32 FMA
// pipes); chip_smoke.py's b2_bwd_bound counts it, with a product of two
// bf16 operands at the bf16 tensor cores' rate (half a TF32 product) and
// two TF32 products for a bf16 one beside an f32 one (0.519 ms in bf16; at
// h 128 1.587 ms in f32, 1.014 in bf16). On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md) the kernel
// takes 3.30-3.34 ms there in f32, 24 % of the bound (the design before
// it, key-tile and query-tile kernels that both formed S and dW on
// mma.sync, took 5.91 ms in the same call), 3.66 ms in bf16 (14 %), and
// at h 128 12.7-13.3 ms in f32 and 15.3 ms in bf16 (7-12 %: S and dW
// twice, their A read from L1 at every k-step, registers spilled).
// Leaving parts out, one at a time, at h 64 (PERF.md): the S and dW
// products with the scores' elementwise work cost the most, then dq's
// in-place add, the dq product and the dv and dk products; the wgmma at n
// 32 and 64 take several times the cycles their flops need. Registers:
// 255 a thread, no spills at kH = 64, 452-712 bytes spilled at kH = 128;
// 1 CTA an SM.

#include <stddef.h>

#include <type_traits>

#include "wgmma_planes.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWgRows = 64;             // keys of a warpgroup's products
constexpr int kOut = 64;                // dv's and dk's columns a warpgroup forms
constexpr int kOS = kOut / 8;           // their n-tiles
constexpr int kStage = 32;              // queries a stage
constexpr int kSN = kStage / 8;         // n-tiles of a stage's scores
constexpr int kPrepWarps = 8;
constexpr long long kSpinLimit = 1ll << 26;   // ~tens of seconds of waiting

// The shapes of the kH instantiation.
template <int kH>
struct Cfg {
  static constexpr bool kWide = kH == 128;   // columns split between the warpgroups
  static constexpr int kRows = kWide ? kWgRows : 2 * kWgRows;   // own keys of a work item
  static constexpr int kHS = kH / 8;          // k-steps of S and dW over h
  static constexpr int kNC = kH / 4;          // 16-byte chunks of a row
  static constexpr int kRs = raw_stride(kNC); // row stride of a raw staged row
  static constexpr int kDqN = kWide ? kSN : kSN / 2;   // dq's query n-tiles a thread adds
  using PK = Plane<kRows, kH, false, 16>;    // own K (kH = 64): S's A; K^T fragments by lds
  using PV = Plane<kRows, kH, false>;        // own V (kH = 64): dW's A
  using PQ = Plane<kStage, kH, false>;       // Q or dNum: S's or dW's B
  using PQt = Plane<kH, kStage, true>;       // Q^T or dNum^T, permuted: dk's or dv's B
  using PdS = Plane<kStage, kWgRows, false, 4>;   // a warpgroup's dS: dq^T's B
};

// Shared memory, in floats.
template <int kH>
struct Smem {
  using C = Cfg<kH>;
  static constexpr int kOwn = C::kWide ? 0 : 1;
  static constexpr int kK = 0;                                    // PK hi, lo (kH = 64)
  static constexpr int kV = kK + kOwn * 2 * C::PK::kFloats;       // PV hi, lo (kH = 64)
  static constexpr int kFront = kV + kOwn * 2 * C::PV::kFloats;   // PQ of Q hi, lo, of dNum hi, lo;
  static constexpr int kFrontFloats =                             // then a PdS hi, lo a warpgroup
      4 * C::PQ::kFloats > 4 * C::PdS::kFloats ? 4 * C::PQ::kFloats : 4 * C::PdS::kFloats;
  static constexpr int kBack = kFront + kFrontFloats;     // PQt of Q hi, lo, of dNum hi, lo
  static constexpr int kRaw = kBack + 4 * C::PQt::kFloats;   // raw Q, dNum (kStage x kRs), dDen
  static constexpr int kDd = kRaw + 2 * kStage * C::kRs + kStage;   // the stage's dDen
  static constexpr int kX = kDd + kStage;                 // dq^T halves, 2 x 8 x 128 (kH = 64)
  static constexpr int kTicket = kX + kOwn * 2 * 8 * 128;
  static constexpr int kFloats = kTicket + 4;
  static constexpr size_t kBytes = (size_t)kFloats * sizeof(float);
  static_assert(kBytes <= 232448, "one CTA's shared memory on sm_90");
};

template <int kN>
__device__ __forceinline__ void add_frag(float (&acc)[kN][4], const float (&x)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] += x[i][c];
}

// The scores' transforms, in place: with x = s * scale, w = dW + dDen,
//   w <- dS = p scale x^(p-1) w,   s <- W = x^(p-1) x,
// both zero where keep(nt, c) is false. x^(p-1) is taken once for both
// (W is not the forward's x^p to the bit, which nothing needs), over the
// whole fragment: faster on the card than wgmma_planes.cuh's score_grads,
// which takes x^(p-1) and x^p apart, half the fragment at a time, and
// whose bits B1's backward keeps.
template <int kN, typename Keep>
__device__ __forceinline__ void score_transform(float (&s)[kN][4], float (&w)[kN][4], int degree,
                                                float scale, Keep keep) {
  const float ps = (float)degree * scale;
  float x[kN][4], y[kN][4];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = s[i][c] = s[i][c] * scale;
  pow_frag(y, s, degree - 1);   // consumes s
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool k = keep(i, c);
      w[i][c] = k ? ps * y[i][c] * w[i][c] : 0.f;
      s[i][c] = k ? y[i][c] * x[i][c] : 0.f;
    }
}

// bar.sync of one warpgroup's 128 threads (barrier 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned x;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(x) : "l"(p) : "memory");
  return x;
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Four values of chunk `chunk` of a row of global memory: zero past
// `width` columns and for an invalid row.
__device__ __forceinline__ float4 load_chunk(const float* row, int chunk, int width, bool valid,
                                             bool vec) {
  const int c0 = 4 * chunk;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!valid || c0 >= width) return x;
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + c0));
  x.x = row[c0];
  if (c0 + 1 < width) x.y = row[c0 + 1];
  if (c0 + 2 < width) x.z = row[c0 + 2];
  if (c0 + 3 < width) x.w = row[c0 + 3];
  return x;
}

__device__ __forceinline__ float4 load_chunk(const __nv_bfloat16* row, int chunk, int width,
                                             bool valid, bool) {
  const int c0 = 4 * chunk;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!valid || c0 >= width) return x;
  x.x = __bfloat162float(row[c0]);
  if (c0 + 1 < width) x.y = __bfloat162float(row[c0 + 1]);
  if (c0 + 2 < width) x.z = __bfloat162float(row[c0 + 2]);
  if (c0 + 3 < width) x.w = __bfloat162float(row[c0 + 3]);
  return x;
}

// The warp's A fragments at k-step kk of its own rows `row` and `row + 8`
// of a row-major (., width) matrix in global memory (columns 8kk + t and
// 8kk + t + 4), zero past `rows` and `width`: S's and dW's A at kH = 128.
template <typename T>
struct OwnA {
  const T* src;
  int row, rows, width;
  __device__ __forceinline__ Frag4 operator()(int kk) const {
    const int t = threadIdx.x & 3;
    Frag4 f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = row + 8 * (i & 1), c = 8 * kk + t + 4 * (i >> 1);
      f.x[i] = rr < rows && c < width ? to_f32(src[(size_t)rr * width + c]) : 0.f;
    }
    return f;
  }
};

// ---------------------------------------------------------------------------
// poly_flash_bwd_prep_kernel: dNum = dO / D, dDen = -(dO . out) / D, one
// warp a row; and the ordering counters (`nsync` of them) set to zero.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * kPrepWarps)
poly_flash_bwd_prep_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                           const float* __restrict__ den, float* __restrict__ dnum,
                           float* __restrict__ dden, unsigned* __restrict__ sync, int nsync,
                           int rows, int h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nsync) sync[i] = 0u;
  prep_row<kPrepWarps>(dout, out, den, dnum, dden, rows, h);
}

// ---------------------------------------------------------------------------
// poly_flash_bwd_kernel. The thread's roles: at kH = 64 warp w (wg = w / 4)
// owns keys 16w .. 16w + 15 of the item and, in dq^T's accumulator,
// columns d = 16 (w % 4) + g (+ 8) and queries 8 nt + 2t (+ 1); it adds to
// dq the n-tiles 2 wg and 2 wg + 1 of them. At kH = 128 warp w owns keys
// 16 (w % 4) .. + 15 and columns 64 wg .. 64 wg + 63 of dv and dk; its dq
// columns are 64 wg + 16 (w % 4) + g (+ 8), and it adds all four n-tiles.
// ---------------------------------------------------------------------------

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const float* dnum;
  const float* dden;
  float* dqa;   // dq's f32 sums (dq itself for f32)
  T* dq;
  T* dk;
  T* dv;
  unsigned* sync;   // [0]: the ticket; [1 + b * nst + st]: stage st's counter
  int bh, n, h, degree;
  float scale;
};

// Issue the copies of query stage st (rows q0 .. q0 + qrows - 1 of bh
// row rb) into the raw slot, and commit them.
template <int kH, typename T>
__device__ __forceinline__ void issue_stage(float* raw, const Args<T>& a, size_t rb, int st,
                                            bool vec) {
  using C = Cfg<kH>;
  const int q0 = st * kStage, qrows = min(kStage, a.n - q0);
  const T* q = a.q + (rb + q0) * a.h;
  const float* g = a.dnum + (rb + q0) * a.h;
  for_chunks<kThreads, kStage, C::kNC>([&](int row, int chunk) {
    if (row < qrows) {
      copy_chunk(raw + row * C::kRs, q + (size_t)row * a.h, chunk, a.h, vec);
      copy_chunk(raw + (kStage + row) * C::kRs, g + (size_t)row * a.h, chunk, a.h, vec);
    }
  });
  if ((int)threadIdx.x < qrows) {
    cp_async4(raw + 2 * kStage * C::kRs + threadIdx.x, a.dden + rb + q0 + threadIdx.x, true);
  }
  cp_async_commit();
}

// Split this thread's chunks of the raw slot (stage of qrows rows) into the
// stage's planes, and its dDen.
template <int kH>
__device__ __forceinline__ void split_stage(float* smem, int qrows, int h) {
  using C = Cfg<kH>;
  using L = Smem<kH>;
  using PQ = typename C::PQ;
  using PQt = typename C::PQt;
  const float* raw = smem + L::kRaw;
  float* front = smem + L::kFront;
  float* back = smem + L::kBack;
  for_chunks<kThreads, kStage, C::kNC>([&](int row, int chunk) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {   // Q, then dNum
      const float4 x = read_chunk(raw + (m * kStage + row) * C::kRs, chunk, h, row < qrows);
      float* d = front + 2 * m * PQ::kFloats;
      float* t = back + 2 * m * PQt::kFloats;
      put4(d, d + PQ::kFloats, PQ::off(row, 4 * chunk), x);
      put_t<PQt, true>(t, t + PQt::kFloats, row, 4 * chunk, x);
    }
  });
  if (threadIdx.x < kStage) {
    smem[L::kDd + threadIdx.x] =
        (int)threadIdx.x < qrows ? raw[2 * kStage * C::kRs + threadIdx.x] : 0.f;
  }
}

// The ordering counter of stage st of bh row rb / n.
template <typename T>
__device__ __forceinline__ unsigned* stage_counter(const Args<T>& a, size_t rb, int st) {
  return a.sync + 1 + (rb / a.n) * ((a.n + kStage - 1) / kStage) + st;
}

// Thread 0, after reading `seen` from stage st's counter: wait until key
// tiles 0 .. j - 1 have added their parts of its dq, then make what they
// stored visible (the acquire half of the counter; a __syncthreads after
// it passes that on to the other threads).
__device__ __forceinline__ void acquire_stage(const unsigned* cnt, unsigned seen, unsigned j) {
  long long spins = 0;
  while (seen != j) {
    __nanosleep(128);
    if (++spins > kSpinLimit) __trap();
    seen = ld_relaxed(cnt);
  }
  fence_acq_rel();
}

// Thread 0, after a __syncthreads that follows every thread's add_dq of
// stage st: the release half, the counter bumped past this key tile.
__device__ __forceinline__ void release_stage(unsigned* cnt) {
  fence_acq_rel();
  atomicAdd(cnt, 1u);
}

// Add this thread's part of stage st's dq (x: its kDqN n-tiles) to the f32
// sums, every load (through L2) before every store; key tile 0 stores, and
// for bf16 the stage's last key tile writes dq in T instead. The caller
// has acquired the stage (key tile j > 0). No loop: it runs between the
// issue of wgmma and their wait.
template <int kH, typename T>
__device__ __forceinline__ void add_dq(const Args<T>& a, size_t rb, int j, int st,
                                       const float (&x)[4 * Cfg<kH>::kDqN]) {
  using C = Cfg<kH>;
  constexpr int kN = C::kDqN;
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x >> 5, wg = warp >> 2;
  const int nt0 = C::kWide ? 0 : 2 * wg, d0 = (C::kWide ? kOut * wg : 0) + 16 * (warp & 3) + g;
  const int q0 = st * kStage, qrows = min(kStage, a.n - q0);
  const bool last = (q0 + qrows - 1) / C::kRows == j;
  float* dqa = a.dqa + (rb + q0) * a.h;
  float old[4 * kN];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = 8 * (nt0 + i) + 2 * t4 + (c & 1), d = d0 + 8 * (c >> 1);
      const bool in = qi < qrows && d < a.h;
      old[4 * i + c] = j > 0 && in ? __ldcg(dqa + (size_t)qi * a.h + d) : 0.f;
    }
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = 8 * (nt0 + i) + 2 * t4 + (c & 1), d = d0 + 8 * (c >> 1);
      if (qi < qrows && d < a.h) {
        const float y = x[4 * i + c];
        const float sum = j > 0 ? old[4 * i + c] + y : y;
        const size_t o = (size_t)qi * a.h + d;
        if (kF32 || !last) {
          __stcg(dqa + o, sum);
        } else {
          a.dq[(rb + q0) * a.h + o] = from_f32<T>(sum);
        }
      }
    }
}

// One work item: key tile j of bh b.
template <int kH, typename T>
__device__ __forceinline__ void key_tile(float* smem, const Args<T>& a, int j, int b) {
  using C = Cfg<kH>;
  using L = Smem<kH>;
  using PK = typename C::PK;
  using PV = typename C::PV;
  using PQ = typename C::PQ;
  using PQt = typename C::PQt;
  using PdS = typename C::PdS;
  constexpr bool kWide = C::kWide;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kHS = C::kHS, kRows = C::kRows, kDqN = C::kDqN;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x >> 5, wg = warp >> 2;
  const int wq = 16 * (warp & 3);                   // the warp's rows within its warpgroup
  const int wrow = kWide ? wq : 16 * warp;          // ... within the item
  const int kwo = kWide ? 0 : kWgRows * wg;         // the warpgroup's first key in the item
  const int cwo = kWide ? kOut * wg : 0;            // its first column of dv, dk and dq
  const int n = a.n, h = a.h;
  const int k0 = j * kRows, krows = min(kRows, n - k0);
  const int nst = (n + kStage - 1) / kStage, s_begin = k0 / kStage;
  const size_t rb = (size_t)b * n;
  const bool vec = vec_ok(a.q, h) && vec_ok(a.dnum, h);

  float* kp = smem + L::kK;    // hi, lo (kH = 64)
  float* vp = smem + L::kV;
  float* front = smem + L::kFront;
  float* back = smem + L::kBack;
  float* raw = smem + L::kRaw;
  float* xb = smem + L::kX;

  // The item's own K and V, split once (kH = 64); the first stage.
  issue_stage<kH>(raw, a, rb, s_begin, vec);
  if constexpr (!kWide) {
    const T* kr = a.k + (rb + k0) * h;
    const T* vr = a.v + (rb + k0) * h;
    const bool kvec = vec_ok(a.k, h) && vec_ok(a.v, h);
    for_chunks<kThreads, kRows, C::kNC>([&](int row, int chunk) {
      const bool valid = row < krows;
      const int o = PK::off(row, 4 * chunk);
      put4(kp, kp + PK::kFloats, o, load_chunk(kr + (size_t)row * h, chunk, h, valid, kvec));
      const int ov = PV::off(row, 4 * chunk);
      put4(vp, vp + PV::kFloats, ov, load_chunk(vr + (size_t)row * h, chunk, h, valid, kvec));
    });
  }
  cp_async_wait<0>();
  split_stage<kH>(smem, min(kStage, n - s_begin * kStage), h);
  fence_async_smem();
  __syncthreads();

  // A of S and dW: the warpgroup's 64 rows of the own planes (kH = 64), or
  // the warp's own rows read from memory (kH = 128)
  const float* ka = kp + (kwo / 8) * PK::kGS;
  const float* va = vp + (kwo / 8) * PV::kGS;
  const OwnA<T> kown{a.k + (rb + k0 + wrow) * h, g, krows - wrow, h};
  const OwnA<T> vown{a.v + (rb + k0 + wrow) * h, g, krows - wrow, h};
  float* ds = front + wg * 2 * PdS::kFloats;   // the warpgroup's dS plane, hi then lo
  // the warpgroup's rows of dv's and dk's B planes (its columns)
  const int bo = (cwo / 8) * PQt::kGS;

  float dva[kOS][4], dka[kOS][4];
#pragma unroll
  for (int i = 0; i < kOS; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dva[i][c] = dka[i][c] = 0.f;
  float dqx[4 * kDqN];   // the last stage's dq part, added under the next stage's products
  int pending = -1;      // ... and its stage

  for (int st = s_begin; st < nst; ++st) {
    const int q0 = st * kStage, qrows = min(kStage, n - q0);
    // the next stage's copies: f32 by cp.async, ahead of this stage's
    // products; bf16 through registers, once they are issued
    if (kF32 && st + 1 < nst) issue_stage<kH>(raw, a, rb, st + 1, vec);
    // no query of the stage sees the warpgroup's keys (at kH = 128 the
    // warpgroups share the item's keys, whose first stage is its own)
    const bool skip = !kWide && (kwo >= krows || q0 + qrows - 1 < k0 + kwo);
    float s[kSN][4], w[kSN][4];
    if (!skip) {
      if constexpr (kWide) {
        // S^T = K Q^T beside dW^T = V dNum^T, A read from memory a k-step
        // ahead, B from the planes
        wg_pair<false, kSN, kHS, PQ, kSN, kHS, PQ>(s, kown, front, front + PQ::kFloats, w, vown,
                                                   front + 2 * PQ::kFloats,
                                                   front + 3 * PQ::kFloats, true);
        if (!kF32 && st + 1 < nst) issue_stage<kH>(raw, a, rb, st + 1, vec);
        // the last stage's dq, while the last k-step runs
        if (pending >= 0) add_dq<kH>(a, rb, j, pending, dqx);
      } else {
        // S^T = K Q^T beside dW^T = V dNum^T, A and B from the planes
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kHS; ++kk) {
          const int ko = 2 * kk * PK::kCS, vo = 2 * kk * PV::kCS, bq = 2 * kk * PQ::kCS;
          const uint64_t kh = plane_desc<PK>(ka + ko), kl = plane_desc<PK>(ka + PK::kFloats + ko);
          const uint64_t vh = plane_desc<PV>(va + vo), vl = plane_desc<PV>(va + PV::kFloats + vo);
          const uint64_t qh = plane_desc<PQ>(front + bq);
          const uint64_t ql = plane_desc<PQ>(front + PQ::kFloats + bq);
          const uint64_t gh = plane_desc<PQ>(front + 2 * PQ::kFloats + bq);
          const uint64_t gl = plane_desc<PQ>(front + 3 * PQ::kFloats + bq);
          wgmma_ss_n32(s, kl, qh, kk > 0);
          wgmma_ss_n32(w, vl, gh, kk > 0);
          wgmma_ss_n32(s, kh, ql, 1);
          wgmma_ss_n32(w, vh, gl, 1);
          wgmma_ss_n32(s, kh, qh, 1);
          wgmma_ss_n32(w, vh, gh, 1);
        }
        wg_commit();
        if (!kF32 && st + 1 < nst) issue_stage<kH>(raw, a, rb, st + 1, vec);
        // the last stage's dq, while they run
        if (pending >= 0) add_dq<kH>(a, rb, j, pending, dqx);
      }
      wg_wait();
      reg_fence(s);
      reg_fence(w);
      const float* dd = smem + L::kDd;
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) w[nt][c] += dd[8 * nt + 2 * t4 + (c & 1)];
      // every query of the stage at or after every key of the warp
      const bool full = q0 >= k0 + wrow + 15 && qrows == kStage;
      score_transform(s, w, a.degree, a.scale, [&](int nt, int c) {
        const int key = k0 + wrow + g + 8 * (c >> 1), i = nt * 8 + 2 * t4 + (c & 1);
        return full || (i < qrows && key <= q0 + i);
      });
    } else {
      if (!kF32 && st + 1 < nst) issue_stage<kH>(raw, a, rb, st + 1, vec);
      if (pending >= 0) add_dq<kH>(a, rb, j, pending, dqx);
    }
    __syncthreads();   // #1: Q and dNum planes free for dS; the last stage's dq added
    if (!skip) {
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          put1(ds, ds + PdS::kFloats, PdS::off(nt * 8 + 2 * t4 + (c & 1), wq + g + 8 * (c >> 1)),
               w[nt][c]);
        }
      fence_async_smem();
    }
    wg_barrier(wg);   // the warpgroup's dS plane is complete
    float dqp[kSN][4];
    if (!skip) {
      // dv = W dNum beside dk = dS Q over the warpgroup's columns, fresh
      // accumulators, B from the transposed planes
      float pv[kOS][4], pk[kOS][4];
      wg_pair<true, kOS, kSN, PQt, kOS, kSN, PQt>(pv, s, back + 2 * PQt::kFloats + bo,
                                                  back + 3 * PQt::kFloats + bo, pk, w, back + bo,
                                                  back + PQt::kFloats + bo, true);
      wg_commit();
      wg_wait();
      reg_fence(pv);
      reg_fence(pk);
      add_frag(dva, pv);
      add_frag(dka, pk);
      // dq^T = K^T dS over the warpgroup's keys: A's fragments (d = cwo +
      // wq + g (+ 8), key 8 kk + t (+ 4)) from the K plane or from memory,
      // B from the dS plane
#pragma unroll
      for (int kk = 0; kk < kWgRows / 8; ++kk) {
        const int key = kwo + 8 * kk + t4, d = cwo + wq + g;
        FragA f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = key + 4 * (i >> 1), dc = d + 8 * (i & 1);
          if constexpr (kWide) {
            const float x = kr < krows && dc < h ? to_f32(a.k[(rb + k0 + kr) * h + dc]) : 0.f;
            split_tf32(x, f.hi[i], f.lo[i]);
          } else {
            const int o = PK::off(kr, dc);
            f.hi[i] = __float_as_uint(kp[o]);
            f.lo[i] = __float_as_uint(kp[PK::kFloats + o]);
          }
        }
        const uint64_t sh = plane_desc<PdS>(ds + 2 * kk * PdS::kCS);
        const uint64_t sl = plane_desc<PdS>(ds + PdS::kFloats + 2 * kk * PdS::kCS);
        wg_fence();
        wg_mma(dqp, f.lo, sh, kk > 0);
        wg_mma(dqp, f.hi, sl);
        wg_mma(dqp, f.hi, sh);
        wg_commit();
        wg_wait1();
      }
      wg_wait();
      reg_fence(dqp);
    } else {
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) dqp[nt][c] = 0.f;
    }
    // kH = 64: the other warpgroup's half of dq^T to it, through shared memory
    const int ti = threadIdx.x & 127;
    if constexpr (!kWide) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          xb[((1 - wg) * 8 + 4 * i + c) * 128 + ti] = dqp[2 * (1 - wg) + i][c];
        }
    }
    cp_async_wait<0>();
    // the last stage's counter, released now that its stores have long
    // been issued (a release right after them waits for them)
    if (threadIdx.x == 0 && pending >= 0) release_stage(stage_counter(a, rb, pending));
    __syncthreads();   // #2: the stage's products done, its planes free; halves in place
#pragma unroll
    for (int i = 0; i < kDqN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (kWide) {
          dqx[4 * i + c] = dqp[i][c];
        } else {
          dqx[4 * i + c] = dqp[2 * wg + i][c] + xb[(wg * 8 + 4 * i + c) * 128 + ti];
        }
      }
    pending = st;
    // this stage's counter, read before the split and waited for after it
    unsigned* cnt = stage_counter(a, rb, st);
    const unsigned seen = threadIdx.x == 0 && j > 0 ? ld_relaxed(cnt) : 0u;
    if (st + 1 < nst) split_stage<kH>(smem, min(kStage, n - (st + 1) * kStage), h);
    if (threadIdx.x == 0 && j > 0) acquire_stage(cnt, seen, j);
    fence_async_smem();
    __syncthreads();   // #3: the next stage's planes complete; stage st acquired
  }
  add_dq<kH>(a, rb, j, pending, dqx);
  __syncthreads();
  if (threadIdx.x == 0) release_stage(stage_counter(a, rb, pending));

#pragma unroll
  for (int nd = 0; nd < kOS; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = cwo + nd * 8 + 2 * t4 + (c & 1);
      if (row < krows && col < h) {
        const size_t i = (rb + k0 + row) * h + col;
        a.dk[i] = from_f32<T>(dka[nd][c]);
        a.dv[i] = from_f32<T>(dva[nd][c]);
      }
    }
}

// The persistent loop: claim a ticket, run its work item (key tile j of bh
// b for ticket j * bh + b), until the tickets run out. key_tile's own
// barriers keep thread 0 from writing the next ticket before every thread
// has read this one.
template <int kH, typename T>
__global__ void __launch_bounds__(kThreads, 1)
poly_flash_bwd_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  int* ticket = reinterpret_cast<int*>(smem + Smem<kH>::kTicket);
  const int tiles = (a.n + Cfg<kH>::kRows - 1) / Cfg<kH>::kRows, items = tiles * a.bh;
  for (;;) {
    if (threadIdx.x == 0) *ticket = (int)atomicAdd(a.sync, 1u);
    __syncthreads();   // the ticket; the last item is done with every buffer
    const int item = *ticket;
    if (item >= items) return;
    key_tile<kH>(smem, a, item / a.bh, item % a.bh);
  }
}

template <int kH, typename T>
cudaError_t run(const Args<T>& args, const T* out, const T* dout, const float* den, int nsync,
                cudaStream_t s) {
  const int rows = args.bh * args.n;
  poly_flash_bwd_prep_kernel<T><<<(rows + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps, 0, s>>>(
      dout, out, den, const_cast<float*>(args.dnum), const_cast<float*>(args.dden), args.sync,
      nsync, rows, args.h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t kBytes = Smem<kH>::kBytes;
  if ((err = cudaFuncSetAttribute(poly_flash_bwd_kernel<kH, T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes)) !=
      cudaSuccess) {
    return err;
  }
  int dev = 0, sms = 0, ctas = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, poly_flash_bwd_kernel<kH, T>,
                                                           kThreads, kBytes)) != cudaSuccess) {
    return err;
  }
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  const long long items = (long long)((args.n + Cfg<kH>::kRows - 1) / Cfg<kH>::kRows) * args.bh;
  const int grid = (int)(items < (long long)ctas * sms ? items : (long long)ctas * sms);
  poly_flash_bwd_kernel<kH, T><<<grid, kThreads, kBytes, s>>>(args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_typed(void* const* p, float* const* f, unsigned* sync, int bh, int n, int h,
                      int degree, float scale, cudaStream_t s) {
  const Args<T> args{static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
                     static_cast<const T*>(p[2]), f[1], f[2], f[3],
                     static_cast<T*>(p[5]), static_cast<T*>(p[6]), static_cast<T*>(p[7]),
                     sync, bh, n, h, degree, scale};
  const int nsync = 1 + bh * ((n + kStage - 1) / kStage);
  const T* out = static_cast<const T*>(p[3]);
  const T* dout = static_cast<const T*>(p[4]);
  return h <= 64 ? run<64>(args, out, dout, f[0], nsync, s)
                 : run<128>(args, out, dout, f[0], nsync, s);
}

// Every kernel of the backward with its launch shape, in launch order.
struct KernelInfo {
  const void* fn;
  int threads;
  size_t smem;
};

template <int kH, typename T>
void kernel_table(KernelInfo (&k)[2]) {
  k[0] = {(const void*)poly_flash_bwd_prep_kernel<T>, 32 * kPrepWarps, 0};
  k[1] = {(const void*)poly_flash_bwd_kernel<kH, T>, kThreads, Smem<kH>::kBytes};
}

template <typename T>
void kernel_table_h(KernelInfo (&k)[2], int h) {
  if (h <= 64) {
    kernel_table<64, T>(k);
  } else {
    kernel_table<128, T>(k);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous tensors: q, k, v, out, dout, dq, dk, dv (bh, n, h) of one
// type T (dtype 0 = float32, 1 = bfloat16); the rest float32: den (the
// forward's 1 + den), dden (bh, n); dnum and dqa (bh, n, h); sync, 1 + bh *
// ceil(n / 32) uint32. dnum, dden, dqa and sync are scratch; for float32
// dqa is dq itself. Requires h <= 128. Returns the first CUDA error (0 on
// success); launches on `stream` and does not synchronise.
extern "C" int poly_flash_backward(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const float* den, float* dnum, float* dden,
                                   unsigned* sync, float* dqa, void* dq, void* dk, void* dv,
                                   int bh, int n, int h, int degree, float scale, int dtype,
                                   void* stream) {
  if (bh <= 0 || n <= 0 || h < 1 || h > 128 || degree < 1 ||
      (long long)bh * n > (1ll << 31) - 1 || dqa == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  void* const p[8] = {const_cast<void*>(q), const_cast<void*>(k), const_cast<void*>(v),
                      const_cast<void*>(out), const_cast<void*>(dout), dq, dk, dv};
  float* const f[4] = {const_cast<float*>(den), dnum, dden, dqa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (dqa != dq) return (int)cudaErrorInvalidValue;
    return (int)run_typed<float>(p, f, sync, bh, n, h, degree, scale, s);
  }
  if (dtype == 1) {
    return (int)run_typed<__nv_bfloat16>(p, f, sync, bh, n, h, degree, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// What each kernel of the backward holds on the card, in launch order
// (prep, the key-tile kernel) at head width h (the 64 or the 128
// instantiation) for operands of type dtype: five ints each into out[2 *
// 5] (registers a thread, local memory bytes a thread, dynamic shared
// memory bytes a CTA, threads a CTA, CTAs resident an SM). Returns the
// first CUDA error (0 on success).
extern "C" int poly_flash_backward_occupancy(int h, int dtype, int* out) {
  if (h < 1 || h > 128 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  KernelInfo k[2];
  if (dtype == 1) {
    kernel_table_h<__nv_bfloat16>(k, h);
  } else {
    kernel_table_h<float>(k, h);
  }
  for (int i = 0; i < 2; ++i) {
    cudaError_t err = cudaFuncSetAttribute(k[i].fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)k[i].smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, k[i].fn)) != cudaSuccess) return (int)err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, k[i].fn, k[i].threads, k[i].smem);
    if (err != cudaSuccess) return (int)err;
    const int row[5] = {a.numRegs, (int)a.localSizeBytes, (int)k[i].smem, k[i].threads, ctas};
    for (int j = 0; j < 5; ++j) out[5 * i + j] = row[j];
  }
  return 0;
}
