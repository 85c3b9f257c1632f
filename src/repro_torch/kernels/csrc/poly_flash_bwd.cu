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
// Two launches:
//   poly_flash_bwd_prep_kernel  dNum and dDen from dO, out and D (one warp a
//                               row); zeroes the ordering counters.
//   poly_flash_bwd_kernel       one pass over key tiles: S and dW once a
//                               causal pair, dk, dv and dq from them.
//
// One pass. A work item is one tile of 128 keys of one bh (8 warps, two
// warpgroups of 64 keys). It streams the queries from its diagonal on, 32
// a stage, and for each stage forms S^T = K Q^T and dW^T = V dNum^T (+ dDen)
// once, turns them into W and dS in registers (score_transform), folds
// W dNum into dv and dS Q into dk, and forms the
// stage's part of dq, dS K over its 128 keys. The accumulators hold dS^T
// by key rows, so dS goes through shared memory as a split plane (one a
// warpgroup) and each warpgroup forms dq^T = K^T dS over its own 64 keys;
// the two halves are added in shared memory. dk and dv are written once at
// the end of the item.
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
// bits. Between the issue of wgmma and their wait the code has no loop (a
// rolled loop there makes ptxas wait for the wgmma before it).
//
// Why it cannot deadlock. The grid is persistent (CTAs resident an SM, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the SMs) and each
// CTA claims work items by a ticket counter (atomicAdd), key-tile-major:
// tile 0 of every bh, then tile 1 of every bh, and so on, the heaviest
// tiles first. A CTA waits only for key tile j - 1 of its bh, whose ticket
// is lower; a ticket is held only by a CTA that claimed it, so by a CTA that
// is running; and that CTA in turn waits only on lower tickets, down to
// tile 0, which waits on none. So every wait ends, whatever order the
// hardware starts blocks in and however many are resident. (A wait that
// runs for seconds traps instead of hanging: that would be a broken
// invariant, not a slow card.) With ascending key order, tile j lags tile
// j - 1 by one stage only while both start together, in the first wave.
//
// Operands, split once. Every operand is split into its TF32 high and low
// halves once, into planes in wgmma's layout (wgmma_planes.cuh's Plane):
// the item's own K and V when they are staged (S and dW take A from them
// by descriptor, wgmma SS mode; dq^T reads K^T's fragments from the same K
// plane, which is padded so that those reads are free of conflicts); each
// stage's Q and dNum, by the thread that copied it (cp.async into a raw
// slot while the stage before it runs), into the direct planes of S and dW
// and the transposed, key-permuted planes of dk and dv, whose A operand is
// the scores' accumulator as it stands (perm8). All products are wgmma
// m64n32k8 or m64n64k8 in 3xTF32 (common.cuh's split rule).
//
// Shared memory, and why one plane set. At h = 64 the own K and V planes
// take 128 KB, one stage's four planes 69 KB, the raw slot 17 KB: 230,672
// B of the 232,448 a CTA may hold. A second plane set (to split stage
// st + 1 under stage st's products, as B1's backward does) would not fit
// beside the own planes, nor would a K^T plane for dq's A; so the dS planes
// take the place of the stage's Q and dNum planes once S and dW are
// formed, and the next stage is split after the stage's products. One CTA
// an SM.
//
// Accuracy. The tensor cores add a product into their f32 accumulator with
// truncation (round toward zero), so a long chain of wgmma into one sum
// drifts. Each stage's output products go to fresh accumulators (wgmma
// without the old value on their first k-step: 12 wgmma for dv and dk, 24
// for a warpgroup's part of dq), and the stages are summed in f32, rounded
// to nearest.
//
// Edges. Rows past n are staged as zeros, masked and not stored, any n;
// the diagonal's mask is applied on every stage that crosses it. The power
// is taken over the whole fragment (p s^(p-1) is exactly p at p = 1, also
// where s = 0). h <= 64 is zero-padded to 64.
//
// What bounds it. At the training shape (bh 24, n 4096, h 64, p 4, f32)
// the function needs five products over the 201.4 M causal pairs (S, dW,
// dv, dq, dk: 10h flops a pair, 128.9 GFLOP) and ~1.6 GFLOP of the rest,
// against 201 MB of q, k, v, out, dO, dq, dk, dv; this kernel computes
// each product once. In 3xTF32 at 495 TFLOP/s that is ~0.81 ms, bound by
// operations (1.95 ms on the f32 FMA pipes); chip_smoke.py's b2_bwd_bound
// counts it. The kernel takes 3.34 ms there on an NVIDIA H100 80GB HBM3
// at 700 W (scripts/port_b2_bwd_ab.py, PERF.md), 24 % of the bound; the
// design before it (key-tile and query-tile kernels that both formed S
// and dW, on mma.sync) took 5.91 ms in the same call. Leaving parts out,
// one at a time, on that card (PERF.md): the S and dW products with the
// scores' elementwise work cost the most, then dq's in-place add, the dq
// product and the dv and dk products; the wgmma at n 32 and 64 take
// several times the cycles their flops need. Registers: 255 a thread (12
// bytes spilled), 1 CTA an SM.

#include <stddef.h>

#include "wgmma_planes.cuh"

namespace {

constexpr int kMaxH = 64;               // head width, zero-padded (h <= 64)
constexpr int kHS = kMaxH / 8;          // k-steps over h
constexpr int kNC = kMaxH / 4;          // 16-byte chunks of a row
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;      // own keys of a work item
constexpr int kWgRows = 64;             // keys of a warpgroup
constexpr int kStage = 32;              // queries a stage
constexpr int kSN = kStage / 8;         // n-tiles of a stage's scores
constexpr int kRs = raw_stride(kNC);    // row stride of a raw staged row
constexpr int kPrepWarps = 8;
constexpr long long kSpinLimit = 1ll << 26;   // ~tens of seconds of waiting

using PK = Plane<kRows, kMaxH, false, 16>;   // own K: S's A; K^T fragments by lds
using PV = Plane<kRows, kMaxH, false>;       // own V: dW's A
using PQ = Plane<kStage, kMaxH, false>;      // Q or dNum: S's or dW's B
using PQt = Plane<kMaxH, kStage, true>;      // Q^T or dNum^T, permuted: dk's or dv's B
using PdS = Plane<kStage, kWgRows, false, 4>;   // a warpgroup's dS: dq^T's B

// Shared memory, in floats.
struct Smem {
  static constexpr int kK = 0;                              // PK hi, lo
  static constexpr int kV = kK + 2 * PK::kFloats;           // PV hi, lo
  static constexpr int kFront = kV + 2 * PV::kFloats;       // PQ of Q hi, lo, of dNum hi, lo;
  static constexpr int kFrontFloats =                       // then a PdS hi, lo a warpgroup
      4 * PQ::kFloats > 4 * PdS::kFloats ? 4 * PQ::kFloats : 4 * PdS::kFloats;
  static constexpr int kBack = kFront + kFrontFloats;       // PQt of Q hi, lo, of dNum hi, lo
  static constexpr int kRaw = kBack + 4 * PQt::kFloats;     // raw Q, dNum (kStage x kRs), dDen
  static constexpr int kDd = kRaw + 2 * kStage * kRs + kStage;   // the stage's dDen
  static constexpr int kX = kDd + kStage;                   // dq^T halves, 2 x 8 x 128
  static constexpr int kTicket = kX + 2 * 8 * 128;
  static constexpr int kFloats = kTicket + 4;
  static constexpr size_t kBytes = (size_t)kFloats * sizeof(float);
};
static_assert(Smem::kBytes <= 232448, "one CTA's shared memory on sm_90");

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

// ---------------------------------------------------------------------------
// poly_flash_bwd_prep_kernel: dNum = dO / D, dDen = -(dO . out) / D, one
// warp a row; and the ordering counters (`nsync` of them) set to zero.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * kPrepWarps)
poly_flash_bwd_prep_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                           const float* __restrict__ den, float* __restrict__ dnum,
                           float* __restrict__ dden, unsigned* __restrict__ sync, int nsync,
                           int rows, int h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nsync) sync[i] = 0u;
  prep_row<kPrepWarps>(dout, out, den, dnum, dden, rows, h);
}

// ---------------------------------------------------------------------------
// poly_flash_bwd_kernel. The thread's roles: warp w (wg = w / 4) owns keys
// 16w .. 16w + 15 of the item; in dq^T's accumulator it holds columns
// d = 16 (w % 4) + g (+ 8) and queries 8 nt + 2t (+ 1); it adds to dq the
// n-tiles 2 wg and 2 wg + 1 of them.
// ---------------------------------------------------------------------------

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dnum;
  const float* dden;
  float* dq;
  float* dk;
  float* dv;
  unsigned* sync;   // [0]: the ticket; [1 + b * nst + st]: stage st's counter
  int bh, n, h, degree;
  float scale;
};

// Issue the copies of query stage st (rows q0 .. q0 + qrows - 1 of bh
// row rb) into the raw slot, and commit them.
__device__ __forceinline__ void issue_stage(float* raw, const Args& a, size_t rb, int st,
                                            bool vec) {
  const int q0 = st * kStage, qrows = min(kStage, a.n - q0);
  const float* q = a.q + (rb + q0) * a.h;
  const float* g = a.dnum + (rb + q0) * a.h;
  for_chunks<kThreads, kStage, kNC>([&](int row, int chunk) {
    if (row < qrows) {
      copy_chunk(raw + row * kRs, q + (size_t)row * a.h, chunk, a.h, vec);
      copy_chunk(raw + (kStage + row) * kRs, g + (size_t)row * a.h, chunk, a.h, vec);
    }
  });
  if ((int)threadIdx.x < qrows) {
    cp_async4(raw + 2 * kStage * kRs + threadIdx.x, a.dden + rb + q0 + threadIdx.x, true);
  }
  cp_async_commit();
}

// Split this thread's chunks of the raw slot (stage of qrows rows) into the
// stage's planes, and its dDen.
__device__ __forceinline__ void split_stage(float* smem, int qrows, int h) {
  const float* raw = smem + Smem::kRaw;
  float* front = smem + Smem::kFront;
  float* back = smem + Smem::kBack;
  for_chunks<kThreads, kStage, kNC>([&](int row, int chunk) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {   // Q, then dNum
      const float4 x = read_chunk(raw + (m * kStage + row) * kRs, chunk, h, row < qrows);
      float* d = front + 2 * m * PQ::kFloats;
      float* t = back + 2 * m * PQt::kFloats;
      put4(d, d + PQ::kFloats, PQ::off(row, 4 * chunk), x);
      put_t<PQt, true>(t, t + PQt::kFloats, row, 4 * chunk, x);
    }
  });
  if (threadIdx.x < kStage) {
    smem[Smem::kDd + threadIdx.x] =
        (int)threadIdx.x < qrows ? raw[2 * kStage * kRs + threadIdx.x] : 0.f;
  }
}

// The ordering counter of stage st of bh row rb / n.
__device__ __forceinline__ unsigned* stage_counter(const Args& a, size_t rb, int st) {
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

// Add this thread's part of stage st's dq (x: n-tiles 2 wg, 2 wg + 1) to
// dq, every load (through L2) before every store; key tile 0 stores. The
// caller has acquired the stage (key tile j > 0). No loop: it runs
// between the issue of wgmma and their wait.
__device__ __forceinline__ void add_dq(const Args& a, size_t rb, int j, int st,
                                       const float (&x)[8]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x >> 5, wg = warp >> 2;
  const int q0 = st * kStage, qrows = min(kStage, a.n - q0);
  float* dq = a.dq + (rb + q0) * a.h;
  float old[8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = 8 * (2 * wg + i) + 2 * t4 + (c & 1), d = 16 * (warp & 3) + g + 8 * (c >> 1);
      const bool in = qi < qrows && d < a.h;
      old[4 * i + c] = j > 0 && in ? __ldcg(dq + (size_t)qi * a.h + d) : 0.f;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = 8 * (2 * wg + i) + 2 * t4 + (c & 1), d = 16 * (warp & 3) + g + 8 * (c >> 1);
      if (qi < qrows && d < a.h) {
        const float y = x[4 * i + c];
        __stcg(dq + (size_t)qi * a.h + d, j > 0 ? old[4 * i + c] + y : y);
      }
    }
}

// One work item: key tile j of bh b.
__device__ __forceinline__ void key_tile(float* smem, const Args& a, int j, int b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x >> 5, wg = warp >> 2, wrow = 16 * warp;
  const int wq = 16 * (warp & 3);   // the warp's rows within its warpgroup
  const int n = a.n, h = a.h;
  const int k0 = j * kRows, krows = min(kRows, n - k0);
  const int nst = (n + kStage - 1) / kStage, s_begin = k0 / kStage;
  const size_t rb = (size_t)b * n;
  const bool vec = vec_ok(a.q, h) && vec_ok(a.dnum, h);

  float* kp = smem + Smem::kK;    // hi, lo
  float* vp = smem + Smem::kV;
  float* front = smem + Smem::kFront;
  float* back = smem + Smem::kBack;
  float* raw = smem + Smem::kRaw;
  float* xb = smem + Smem::kX;

  // The item's own K and V, split once; the first stage.
  issue_stage(raw, a, rb, s_begin, vec);
  {
    const float* kr = a.k + (rb + k0) * h;
    const float* vr = a.v + (rb + k0) * h;
    const bool kvec = vec_ok(a.k, h) && vec_ok(a.v, h);
    for_chunks<kThreads, kRows, kNC>([&](int row, int chunk) {
      const bool valid = row < krows;
      const int o = PK::off(row, 4 * chunk);
      put4(kp, kp + PK::kFloats, o, load_chunk(kr + (size_t)row * h, chunk, h, valid, kvec));
      const int ov = PV::off(row, 4 * chunk);
      put4(vp, vp + PV::kFloats, ov, load_chunk(vr + (size_t)row * h, chunk, h, valid, kvec));
    });
  }
  cp_async_wait<0>();
  split_stage(smem, min(kStage, n - s_begin * kStage), h);
  fence_async_smem();
  __syncthreads();

  // A of S and dW: the warpgroup's 64 rows of the own planes
  const float* ka = kp + (kWgRows * wg / 8) * PK::kGS;
  const float* va = vp + (kWgRows * wg / 8) * PV::kGS;
  float* ds = front + wg * 2 * PdS::kFloats;   // the warpgroup's dS plane, hi then lo

  float dva[kHS][4], dka[kHS][4];
#pragma unroll
  for (int i = 0; i < kHS; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dva[i][c] = dka[i][c] = 0.f;
  float dqx[8];       // the last stage's dq part, added under the next stage's products
  int pending = -1;   // ... and its stage

  for (int st = s_begin; st < nst; ++st) {
    const int q0 = st * kStage, qrows = min(kStage, n - q0);
    if (st + 1 < nst) issue_stage(raw, a, rb, st + 1, vec);
    // no query of the stage sees the warpgroup's keys
    const bool skip = kWgRows * wg >= krows || q0 + qrows - 1 < k0 + kWgRows * wg;
    float s[kSN][4], w[kSN][4];
    if (!skip) {
      // S^T = K Q^T beside dW^T = V dNum^T, A and B from the planes
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHS; ++kk) {
        const int ko = 2 * kk * PK::kCS, vo = 2 * kk * PV::kCS, bo = 2 * kk * PQ::kCS;
        const uint64_t kh = plane_desc<PK>(ka + ko), kl = plane_desc<PK>(ka + PK::kFloats + ko);
        const uint64_t vh = plane_desc<PV>(va + vo), vl = plane_desc<PV>(va + PV::kFloats + vo);
        const uint64_t qh = plane_desc<PQ>(front + bo);
        const uint64_t ql = plane_desc<PQ>(front + PQ::kFloats + bo);
        const uint64_t gh = plane_desc<PQ>(front + 2 * PQ::kFloats + bo);
        const uint64_t gl = plane_desc<PQ>(front + 3 * PQ::kFloats + bo);
        wgmma_ss_n32(s, kl, qh, kk > 0);
        wgmma_ss_n32(w, vl, gh, kk > 0);
        wgmma_ss_n32(s, kh, ql, 1);
        wgmma_ss_n32(w, vh, gl, 1);
        wgmma_ss_n32(s, kh, qh, 1);
        wgmma_ss_n32(w, vh, gh, 1);
      }
      wg_commit();
      // the last stage's dq, while they run
      if (pending >= 0) add_dq(a, rb, j, pending, dqx);
      wg_wait();
      reg_fence(s);
      reg_fence(w);
      const float* dd = smem + Smem::kDd;
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
    } else if (pending >= 0) {
      add_dq(a, rb, j, pending, dqx);
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
      // dv = W dNum beside dk = dS Q, fresh accumulators, B from the
      // transposed planes
      float pv[kHS][4], pk[kHS][4];
      wg_pair<true, kHS, kSN, PQt, kHS, kSN, PQt>(pv, s, back + 2 * PQt::kFloats,
                                                  back + 3 * PQt::kFloats, pk, w, back,
                                                  back + PQt::kFloats, true);
      wg_commit();
      wg_wait();
      reg_fence(pv);
      reg_fence(pk);
      add_frag(dva, pv);
      add_frag(dka, pk);
      // dq^T = K^T dS over the warpgroup's keys: A's fragments from the K
      // plane (d = wq + g (+ 8), key 8 kk + t (+ 4)), B from the dS plane
#pragma unroll
      for (int kk = 0; kk < kWgRows / 8; ++kk) {
        const int key = kWgRows * wg + 8 * kk + t4, d = wq + g;
        FragA f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int o = PK::off(key + 4 * (i >> 1), d + 8 * (i & 1));
          f.hi[i] = __float_as_uint(kp[o]);
          f.lo[i] = __float_as_uint(kp[PK::kFloats + o]);
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
    // the other warpgroup's half of dq^T to it, through shared memory
    const int ti = threadIdx.x & 127;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xb[((1 - wg) * 8 + 4 * i + c) * 128 + ti] = dqp[2 * (1 - wg) + i][c];
      }
    cp_async_wait<0>();
    // the last stage's counter, released now that its stores have long
    // been issued (a release right after them waits for them)
    if (threadIdx.x == 0 && pending >= 0) release_stage(stage_counter(a, rb, pending));
    __syncthreads();   // #2: the stage's products done, its planes free; halves in place
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dqx[4 * i + c] = dqp[2 * wg + i][c] + xb[(wg * 8 + 4 * i + c) * 128 + ti];
      }
    pending = st;
    // this stage's counter, read before the split and waited for after it
    unsigned* cnt = stage_counter(a, rb, st);
    const unsigned seen = threadIdx.x == 0 && j > 0 ? ld_relaxed(cnt) : 0u;
    if (st + 1 < nst) split_stage(smem, min(kStage, n - (st + 1) * kStage), h);
    if (threadIdx.x == 0 && j > 0) acquire_stage(cnt, seen, j);
    fence_async_smem();
    __syncthreads();   // #3: the next stage's planes complete; stage st acquired
  }
  add_dq(a, rb, j, pending, dqx);
  __syncthreads();
  if (threadIdx.x == 0) release_stage(stage_counter(a, rb, pending));

#pragma unroll
  for (int nd = 0; nd < kHS; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
      if (row < krows && col < h) {
        const size_t i = (rb + k0 + row) * h + col;
        a.dk[i] = dka[nd][c];
        a.dv[i] = dva[nd][c];
      }
    }
}

// The persistent loop: claim a ticket, run its work item (key tile j of bh
// b for ticket j * bh + b), until the tickets run out. key_tile's own
// barriers keep thread 0 from writing the next ticket before every thread
// has read this one.
__global__ void __launch_bounds__(kThreads, 1)
poly_flash_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  int* ticket = reinterpret_cast<int*>(smem + Smem::kTicket);
  const int tiles = (a.n + kRows - 1) / kRows, items = tiles * a.bh;
  for (;;) {
    if (threadIdx.x == 0) *ticket = (int)atomicAdd(a.sync, 1u);
    __syncthreads();   // the ticket; the last item is done with every buffer
    const int item = *ticket;
    if (item >= items) return;
    key_tile(smem, a, item / a.bh, item % a.bh);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous float32 tensors: q, k, v, out, dout, dnum, dq, dk, dv
// (bh, n, h); den (the forward's 1 + den), dden (bh, n); sync, 1 + bh *
// ceil(n / 32) uint32. dnum, dden and sync are scratch. Requires h <= 64.
// Returns the first CUDA error (0 on success); launches on `stream` and
// does not synchronise.
extern "C" int poly_flash_backward(const float* q, const float* k, const float* v,
                                   const float* out, const float* dout, const float* den,
                                   float* dnum, float* dden, unsigned* sync, float* dq, float* dk,
                                   float* dv, int bh, int n, int h, int degree, float scale,
                                   void* stream) {
  if (bh <= 0 || n <= 0 || h < 1 || h > kMaxH || degree < 1 ||
      (long long)bh * n > (1ll << 31) - 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = bh * n, nsync = 1 + bh * ((n + kStage - 1) / kStage);
  poly_flash_bwd_prep_kernel<<<(rows + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps, 0, s>>>(
      dout, out, den, dnum, dden, sync, nsync, rows, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(poly_flash_bwd_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)Smem::kBytes)) != cudaSuccess) {
    return (int)err;
  }
  int dev = 0, sms = 0, ctas = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, poly_flash_bwd_kernel, kThreads,
                                                           Smem::kBytes)) != cudaSuccess) {
    return (int)err;
  }
  if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)((n + kRows - 1) / kRows) * bh;
  const int grid = (int)(items < (long long)ctas * sms ? items : (long long)ctas * sms);
  const Args args{q, k, v, dnum, dden, dq, dk, dv, sync, bh, n, h, degree, scale};
  poly_flash_bwd_kernel<<<grid, kThreads, Smem::kBytes, s>>>(args);
  return (int)cudaGetLastError();
}

// What each kernel of the backward holds on the card, in launch order
// (prep, the key-tile kernel) at head width h: five ints each into
// out[2 * 5] (registers a thread, local memory bytes a thread, dynamic
// shared memory bytes a CTA, threads a CTA, CTAs resident an SM). Returns
// the first CUDA error (0 on success).
extern "C" int poly_flash_backward_occupancy(int h, int* out) {
  if (h < 1 || h > kMaxH) return (int)cudaErrorInvalidValue;
  const struct {
    const void* fn;
    int threads;
    size_t smem;
  } kernels[2] = {{(const void*)poly_flash_bwd_prep_kernel, 32 * kPrepWarps, 0},
                  {(const void*)poly_flash_bwd_kernel, kThreads, Smem::kBytes}};
  for (int i = 0; i < 2; ++i) {
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
