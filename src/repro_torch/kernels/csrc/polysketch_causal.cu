// Causal PolySketch attention for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// Replaces src/repro/kernels/polysketch_causal.py::polysketch_causal_pallas
// (the Pallas TPU kernel, body `_kernel`). Same function, same factored
// prefix state:
//   Zv[i, j*h + d] = sum_s km_s[i] km_s[j] v_s[d]     (r, r*h) f32
//   Zd[i, j]       = sum_s km_s[i] km_s[j]            (r, r)   f32
// For every block l of b rows:
//   out = (W V + sum_j qm_j (qm Zv_l)_j) / (1 + rowsum W + qm^T Zd_l qm)
// with W = tril((Q K^T * scale)^p) (or tril((Qm Km^T)^2) without
// local_exact) and Z_l = z0 + H_0 + ... + H_{l-1}, H_l the block's own
// contribution Km_l^T (Km_l (x) V_l).
//
// Why three passes. The TPU ran the grid in order and kept Zv in VMEM. On
// Hopper the blocks of a grid run in no order, Zv at r=32, h=64 is 256 KiB
// (more than one SM's 227 KB of shared memory) and the diagonal block at
// b=1024 would be a 4 MiB W. So:
//   pass 1  fold_kernel, (128 rows (i, c), block, bh) in parallel: H_l as
//           one product Phi(Km_l)^T [V_l | 1] on wgmma (M = r^2, N = h + 1,
//           K = b; Phi(km)[s, i r + c] = km_si km_sc), through the same
//           pipeline as pass 3 (below); the ones column yields Zd. Each
//           CTA sums its rows over the b keys in order: no split-K, no
//           atomics. (The backward folds on polysketch_state.cuh's
//           mma.sync fold_block.)
//   pass 2  prefix_kernel (polysketch_state.cuh), state elements in
//           parallel (float4 a thread), blocks in order: the exclusive
//           prefix Z_l, written over H_l, plus the final state. Z_l stays
//           in hv/hd for the backward (polysketch_causal_bwd.cu).
//   pass 3  output_kernel, (128-query tile, block, bh) in parallel, the
//           last tile first: wgmma_planes.cuh's forward flash diagonal, as
//           poly_flash.cu runs it, over the key tiles of block l (exact
//           weights for every pair in the block, no running max since x^p
//           needs none), then the cross term Phi(qm) [Zv_l | Zd_l] with
//           K = r^2, Phi(qm)[i, e*r + c] = qm_ie qm_ic, on wgmma too: the
//           same producer warpgroup bulk-copies Z_l in items of kZC = 32
//           columns c of one sketch index e (Zv_l's rows e*r + c, r*h
//           contiguous floats, and Zd_l's) and splits each once for the CTA
//           into transposed planes, Zv_l's h columns and Zd_l's one; each
//           consumer warpgroup builds Phi's A fragments for the item in
//           registers, qm[:, e] (.) qm[:, c], and runs the numerator's and
//           the denominator's products (m64n64k8 and m64n8k8) into fresh
//           accumulators added in f32. Z_l is read once per 128 query rows
//           and serves both warpgroups. When asked (den_out), it also stores
//           1 + den of each row for the backward; the outputs are the same
//           bits either way.
// Every sum runs in a fixed order that n and bh do not change, and pass 2
// adds the blocks left to right from z0. A prefill resumed at a block
// boundary from the state this kernel returned is therefore bit-identical
// to a cold one, and a head computed alone equals the same head in a batch.
//
// What bounds it. At bh=48, n=2048, r=32, h=64, b=1024, f32 the three
// products (fold, diagonal, cross term) are ~13 GFLOP each, 39.1 GFLOP
// together, against 151 MB of inputs, state and outputs; the rest (scale,
// power, masks, km (x) v, the prefix) is 0.8 GFLOP. Every product runs on
// the tensor cores in 3xTF32 (common.cuh's split rule), on wgmma. So the
// least time is 3 x 39.1 GFLOP at 495 TFLOP/s plus 0.8 GFLOP at
// 67 TFLOP/s, 0.249 ms: bound by operations (0.595 ms on the f32 FMA
// pipes). The prefill's calls, n = b = 1024 and 1016, are bound at 0.125
// and 0.123 ms. In bf16 the diagonal's S is one TF32 product, W V two and
// the fold two (a bf16 operand has no lo half); the cross term stays three
// (Phi(qm) is a product of two bf16 values, Z_l f32): chip_smoke.py's
// b1_bound counts those passes, but S at the bf16 tensor cores' rate (half
// a TF32 pass), since the card has that rate for two bf16 operands.
//
// Registers and shared memory (nvcc -Xptxas -v, and chip_smoke.py's
// forward_occupancy, which prints each instantiation's): fold_kernel and
// output_kernel are 384-thread CTAs, one an SM, allocated 168 registers a
// thread, the producers giving the consumers theirs (setmaxnreg: 56 and
// 224); output_kernel's shared memory is ~224 KB at h 64 and 128 in f32,
// the fold's 145-217 KB; prefix_kernel 32 registers.

#include <stddef.h>

#include "polysketch_state.cuh"
#include "wgmma_planes.cuh"

namespace {

constexpr int kMaxH = 128;
constexpr int kMaxR = 64;

// ---------------------------------------------------------------------------
// Pass 1 on wgmma: H_l = Phi(Km_l)^T [V_l | 1], M = r^2 rows (i, c), N = h
// columns d and the ones column, K = b keys s, Phi(km)[s, i r + c] =
// km[s, i] km[s, c], for H_l = (Zv_l, Zd_l) of block l:
//   hv[bh, l, i, c*h + d] = sum_s km[s, i] km[s, c] v[s, d]
//   hd[bh, l, i, c]       = sum_s km[s, i] km[s, c]
// as the cross term of pass 3 takes Phi(qm) against Z_l. A CTA takes 128
// rows (i, c), 64 a consumer warpgroup, over the block's keys in chunks of
// kKeys, through the diagonal's pipeline: the producer bulk-copies each
// chunk of km and v and writes a plane set, [V | 1]^T split into TF32
// planes (the B operand: n = d with the ones at row 8 kNV, k = s) beside
// km as f32 rows, from which each consumer thread forms its A fragments in
// registers, km[s, i] km[s, c] for its two rows. Each chunk's products go
// to a fresh accumulator, added in f32 in key order (C.1).
// ---------------------------------------------------------------------------

// kNV: [V | 1]'s n-tiles of 8 before the ones (8: h <= 64, 16: h <= 128);
// kRN: r padded (32 or 64).
template <typename T, int kNV_, int kRN>
struct Fold {
  static constexpr bool kBf = IsBf16<T>::value;
  static constexpr int kNV = kNV_, kR = kRN;
  static constexpr int kKeys = kNV <= 8 ? 64 : 32;
  static constexpr int kPl = kBf ? 1 : 2;
  using PV = Plane<8 * kNV + 16, kKeys, false>;   // [V | 1]^T: n = d, k = s
  static constexpr int kKS = kRN + 8;              // km's f32 row stride, 8 (mod 32)
  static constexpr int kRawK = kKeys * kRN * (int)sizeof(T);   // V's offset (issue_diag)
  static constexpr int kRawBytes = (kKeys * (kRN + 8 * kNV) * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int kVHi = 0, kVLo = PV::kFloats, kKm = kPl * PV::kFloats;
  static constexpr int kSetFloats = kKm + kKeys * kKS;
};

// Write chunk ch of the block (s.k = km with f = r, s.v = v, klen = b) into
// a plane set: [V | 1]^T's planes ((d, s .. s + 3) as 16 bytes, 32 lanes on
// consecutive d; the ones at d = 8 kNV, zero elsewhere past h) and km's f32
// rows (zero past r, so column kRN reads as zero), 16 bytes a copy. Keys
// past the block are zero.
template <class C, bool kRaw, typename T>
__device__ __forceinline__ void split_fold(float* pl, const DiagSrc<T>& s, int ch,
                                           const char* raw) {
  constexpr int kD = 8 * C::kNV + 16, kKQ = C::kKS / 4;
  const int pt = threadIdx.x - kFlashConsumers;
  const int k0 = ch * C::kKeys, rows = min(C::kKeys, s.klen - k0);
  const int r = s.f, h = s.h;
  const T* kr = kRaw ? reinterpret_cast<const T*>(raw) : s.k + (size_t)k0 * r;
  const T* vr = kRaw ? reinterpret_cast<const T*>(raw + C::kRawK) : s.v + (size_t)k0 * h;
#pragma unroll 2
  for (int idx = pt; idx < kD * (C::kKeys / 4); idx += kFlashProducers) {
    const int d = idx % kD, u = idx / kD;
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 4 * u + j;
      y[j] = key >= rows ? 0.f
             : d < h     ? to_f32(vr[(size_t)key * h + d])
                         : (d == 8 * C::kNV ? 1.f : 0.f);
    }
    put_planes<C::kBf>(pl + C::kVHi, pl + C::kVLo, u * C::PV::kCS + 4 * d,
                       make_float4(y[0], y[1], y[2], y[3]));
  }
  float* km = pl + C::kKm;
#pragma unroll 2
  for (int idx = pt; idx < C::kKeys * kKQ; idx += kFlashProducers) {
    const int key = idx / kKQ, q = idx % kKQ;
    const float4 x = key < rows ? load4(kr + (size_t)key * r, 4 * q, r, kRaw)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(km + key * C::kKS + 4 * q) = x;
  }
}

// grid (ceil(r^2 / 128), t, bh), kFlashThreads threads; bulk as
// output_kernel's.
template <typename T, int kNV, int kRN>
__global__ void __launch_bounds__(kFlashThreads, 1)
fold_kernel(const T* __restrict__ km, const T* __restrict__ v, float* __restrict__ hv,
            float* __restrict__ hd, int n, int r, int h, int b, int bulk) {
  using C = Fold<T, kNV, kRN>;
  using PV = typename C::PV;
  extern __shared__ __align__(128) char smem[];
  const int l = blockIdx.y, t = gridDim.y, bh = blockIdx.z;
  const size_t row0 = (size_t)bh * n + (size_t)l * b, state = (size_t)bh * t + l;
  const int chunks = (b + C::kKeys - 1) / C::kKeys;
  const DiagSrc<T> src{km + row0 * r, v + row0 * h, r, h, b};
  flash_init<C>(smem);
  if (threadIdx.x >= kFlashConsumers) {
    flash_producer<C>(
        smem, chunks, bulk != 0,
        [&](int it, char* raw, uint64_t* bar) { issue_diag<C>(raw, bar, src, it); },
        [&](int it, const char* raw, float* pl, bool staged) {
          if (staged) {
            split_fold<C, true>(pl, src, it, raw);
          } else {
            split_fold<C, false>(pl, src, it, raw);
          }
        });
    return;
  }
  flash_consumer_regs();
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int rr = r * r, rh = r * h;
  const int m_wg = blockIdx.x * kFlashRows + 64 * (threadIdx.x >> 7);
  const bool active = m_wg < rr;
  // this thread's two rows m = i r + c (past r^2: c = kRN, a zero column)
  int ij[2], cj[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = blockIdx.x * kFlashRows + 16 * (threadIdx.x >> 5) + g + 8 * j;
    ij[j] = m < rr ? m / r : 0;
    cj[j] = m < rr ? m - ij[j] * r : kRN;
  }
  float acc[kNV + 1][4];
#pragma unroll
  for (int i = 0; i <= kNV; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  flash_consume<C>(smem, 0, chunks, [&](int, const float* pl) {
    if (!active) return;
    const float* kmr = pl + C::kKm;
    FragA a[C::kKeys / 8];
#pragma unroll
    for (int kk = 0; kk < C::kKeys / 8; ++kk) {
      const float* s0 = kmr + (8 * kk + t4) * C::kKS;
      const float* s1 = s0 + 4 * C::kKS;
      a[kk] = split_a(s0[ij[0]] * s0[cj[0]], s0[ij[1]] * s0[cj[1]], s1[ij[0]] * s1[cj[0]],
                      s1[ij[1]] * s1[cj[1]]);
    }
    // [V | 1] in chunks of 64 columns, the last of 72 with the ones
#pragma unroll
    for (int ch = 0; ch < kNV / 8; ++ch) {
      constexpr int kLast = kNV / 8 - 1;
      float o[9][4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < C::kKeys / 8; ++kk) {
        const int off = 2 * kk * PV::kCS + ch * 8 * PV::kGS;
        const uint64_t vh = plane_desc<PV>(pl + C::kVHi + off);
        const uint64_t vl = plane_desc<PV>(pl + C::kVLo + off);
        if (ch == kLast) {
          wgmma_n72(o, a[kk].lo, vh, kk > 0);
          if constexpr (!C::kBf) wgmma_n72(o, a[kk].hi, vl, 1);
          wgmma_n72(o, a[kk].hi, vh, 1);
        } else {
          float(&o8)[8][4] = *reinterpret_cast<float(*)[8][4]>(&o[0]);
          wgmma_n64(o8, a[kk].lo, vh, kk > 0);
          if constexpr (!C::kBf) wgmma_n64(o8, a[kk].hi, vl, 1);
          wgmma_n64(o8, a[kk].hi, vh, 1);
        }
      }
      wg_commit();
      wg_wait();
      reg_fence(o);
#pragma unroll
      for (int i = 0; i < (ch == kLast ? 9 : 8); ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[8 * ch + i][c] += o[i][c];
    }
  });
#pragma unroll
  for (int nt = 0; nt <= kNV; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = c >> 1, d = 8 * nt + 2 * t4 + (c & 1);
      const int m = blockIdx.x * kFlashRows + 16 * (threadIdx.x >> 5) + g + 8 * j;
      if (m >= rr) continue;
      const size_t row = state * r + ij[j];
      if (d < h) {
        hv[row * rh + cj[j] * h + d] = acc[nt][c];
      } else if (d == 8 * kNV) {
        hd[row * r + cj[j]] = acc[nt][c];
      }
    }
}

// Z_l's spans for the cross term: item i is sketch index e = i / ncb and
// column block i % ncb (kZC columns c each).
struct CrossSrc {
  const float* zv;   // Z_l's Zv, r x (r h)
  const float* zd;   // Z_l's Zd, r x r
  int r, h, ncb;
};

template <class C>
__device__ __forceinline__ void issue_cross(char* raw, uint64_t* bar, const CrossSrc& s,
                                            int item) {
  const int e = item / s.ncb, c0 = (item % s.ncb) * kZC, rows = min(kZC, s.r - c0);
  const unsigned zb = rows * s.h * 4, db = rows * 4;
  mbar_arrive_tx(bar, zb + db);
  bulk_load(raw, s.zv + ((size_t)e * s.r + c0) * s.h, zb, bar);
  bulk_load(raw + kZC * s.h * 4, s.zd + (size_t)e * s.r + c0, db, bar);
}

// Split a cross-term item into a plane set: Zv_l's (d, c) at PZ (n = d,
// k = c), 32 lanes reading 32 consecutive d of a row c; Zd_l's c at row 0
// of PD, its other rows zero. Columns past r or h are zero.
template <class C, bool kRaw>
__device__ __forceinline__ void split_cross(float* pl, const CrossSrc& s, int item,
                                            const char* raw) {
  constexpr int kD = 8 * C::kNV;
  const int pt = threadIdx.x - kFlashConsumers;
  const int e = item / s.ncb, c0 = (item % s.ncb) * kZC, rows = min(kZC, s.r - c0);
  const float* zr = kRaw ? reinterpret_cast<const float*>(raw)
                         : s.zv + ((size_t)e * s.r + c0) * s.h;
  const float* dr = kRaw ? reinterpret_cast<const float*>(raw + kZC * s.h * 4)
                         : s.zd + (size_t)e * s.r + c0;
#pragma unroll 2
  for (int idx = pt; idx < kD * (kZC / 4); idx += kFlashProducers) {
    const int d = idx % kD, u = idx / kD;
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] = d < s.h && 4 * u + i < rows ? zr[(size_t)(4 * u + i) * s.h + d] : 0.f;
    }
    put4(pl + C::kZHi, pl + C::kZLo, u * C::PZ::kCS + 4 * d, make_float4(y[0], y[1], y[2], y[3]));
  }
  for (int idx = pt; idx < 16 * (kZC / 4); idx += kFlashProducers) {
    const int row = idx % 16, u = idx / 16;
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = row == 0 && 4 * u + i < rows ? dr[4 * u + i] : 0.f;
    put4(pl + C::kDHi, pl + C::kDLo, u * C::PD::kCS + 4 * row,
         make_float4(y[0], y[1], y[2], y[3]));
  }
}

// One cross-term item for the calling warpgroup: acc += Phi_e Zv_l[e, cb],
// cden += Phi_e Zd_l[e, cb] (the denominator's column, at this thread's
// column 2t4: the quad's first thread holds it), with Phi_e[row, c] =
// qe[row] qmr[row, c] for the item's kZC columns c = 32 kCB + 8 kk + t4
// (+ 4): qmr[i][j] holds qm at rows g + 8i, column t4 + 4j. Fresh
// accumulators, added in f32.
template <class C, int kRK, int kCB>
__device__ __forceinline__ void cross_item(const float* pl, const float (&qmr)[2][2 * kRK],
                                           const float (&qe)[2], float (&acc)[C::kNV][4],
                                           float (&cden)[2]) {
  using PZ = typename C::PZ;
  using PD = typename C::PD;
  static_assert(8 * kCB + 2 * (kZC / 8) <= 2 * kRK, "the item's columns lie in qmr");
  FragA a[kZC / 8];
#pragma unroll
  for (int kk = 0; kk < kZC / 8; ++kk) {
    const int j = 8 * kCB + 2 * kk;
    a[kk] = split_a(qe[0] * qmr[0][j], qe[1] * qmr[1][j], qe[0] * qmr[0][j + 1],
                    qe[1] * qmr[1][j + 1]);
  }
#pragma unroll
  for (int ch = 0; ch < C::kNV / 8; ++ch) {
    float o[8][4], od[1][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kZC / 8; ++kk) {
      const int off = 2 * kk * PZ::kCS + ch * 8 * PZ::kGS;
      const uint64_t zh = plane_desc<PZ>(pl + C::kZHi + off);
      wgmma_n64(o, a[kk].lo, zh, kk > 0);
      wgmma_n64(o, a[kk].hi, plane_desc<PZ>(pl + C::kZLo + off), 1);
      wgmma_n64(o, a[kk].hi, zh, 1);
      if (ch == 0) {
        const uint64_t dh = plane_desc<PD>(pl + C::kDHi + 2 * kk * PD::kCS);
        wgmma_n8(od[0], a[kk].lo, dh, kk > 0);
        wgmma_n8(od[0], a[kk].hi, plane_desc<PD>(pl + C::kDLo + 2 * kk * PD::kCS), 1);
        wgmma_n8(od[0], a[kk].hi, dh, 1);
      }
    }
    wg_commit();
    wg_wait();
    reg_fence(o);
    if (ch == 0) {
      reg_fence(od);
      cden[0] += od[0][0];
      cden[1] += od[0][2];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[8 * ch + i][c] += o[i][c];
  }
}

// Pass 3: outputs of one 128-query tile of block l. grid (ceil(b/128), t,
// bh), kFlashThreads threads. kNV output n-tiles (8 for h <= 64, 16 for
// h <= 128); kRK = k-steps of r (4 for r <= 32, 8 for r <= 64). The
// diagonal's features are q and k (local_exact: f = h, the power) or qm and
// km (f = r, the square). bulk: every span is 16-byte aligned and a
// multiple of 16 bytes long (launch_output checks), so items are
// bulk-copied; otherwise the producers read them straight from device
// memory.
template <typename T, bool kLocalExact, int kNV, int kRK>
__global__ void __launch_bounds__(kFlashThreads, 1)
output_kernel(const T* __restrict__ qm, const T* __restrict__ km, const T* __restrict__ q,
              const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ zv,
              const float* __restrict__ zd, T* __restrict__ out, float* __restrict__ den_out,
              int n, int r, int h, int b, int degree, float scale, int bulk) {
  using C = Flash<T, kLocalExact ? 8 * kNV : 8 * kRK, kNV>;
  extern __shared__ __align__(128) char smem[];
  // the last query tile (most key tiles) first, so the grid's tail is short
  const int qt = gridDim.x - 1 - blockIdx.x, l = blockIdx.y, bh = blockIdx.z, t = gridDim.y;
  const int q0 = qt * kFlashRows, qrows = min(kFlashRows, b - q0);
  const int f = kLocalExact ? h : r;   // feature width of the diagonal scores
  const size_t row0 = (size_t)bh * n + (size_t)l * b, state = (size_t)bh * t + l;
  const int ktiles = (q0 + qrows + C::kKeys - 1) / C::kKeys;
  const int ncb = (r + kZC - 1) / kZC, nitems = ktiles + r * ncb;
  const DiagSrc<T> dsrc{(kLocalExact ? k : km) + row0 * f, v + row0 * h, f, h, b};
  const CrossSrc csrc{zv + state * r * r * h, zd + state * r * r, r, h, ncb};
  flash_init<C>(smem);
  if (threadIdx.x >= kFlashConsumers) {
    flash_producer<C>(
        smem, nitems, bulk != 0,
        [&](int it, char* raw, uint64_t* bar) {
          if (it < ktiles) {
            issue_diag<C>(raw, bar, dsrc, it);
          } else {
            issue_cross<C>(raw, bar, csrc, it - ktiles);
          }
        },
        [&](int it, const char* raw, float* pl, bool staged) {
          if (staged) {
            if (it < ktiles) {
              split_keys<C, true>(pl, dsrc, it, raw);
            } else {
              split_cross<C, true>(pl, csrc, it - ktiles, raw);
            }
          } else if (it < ktiles) {
            split_keys<C, false>(pl, dsrc, it, raw);
          } else {
            split_cross<C, false>(pl, csrc, it - ktiles, raw);
          }
        });
    return;
  }
  flash_consumer_regs();
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wg = threadIdx.x >> 7, wrow = 16 * (threadIdx.x >> 5) + g;
  const bool active = 64 * wg < qrows;
  float acc[kNV][4];
  float den[2] = {0.f, 0.f}, cden[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < kNV; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  // ---- diagonal block: exact weights for every pair inside block l ----
  {
    const int first = q0 + 64 * wg, last = q0 + min(64 * wg + 63, qrows - 1);
    QFrags<C> qf;
    load_q<C>(qf, (kLocalExact ? q : qm) + (row0 + q0) * f, f, qrows);
    flash_consume<C>(smem, 0, ktiles, [&](int it, const float* pl) {
      if (!active) return;
      if constexpr (kLocalExact) {
        flash_tile<C>(pl, qf, it * C::kKeys, first, last, true, PowWeight{scale, degree}, acc,
                      den);
      } else {
        flash_tile<C>(pl, qf, it * C::kKeys, first, last, true, SquareWeight{}, acc, den);
      }
    });
  }

  // ---- cross-block prefix: Phi(qm) [Zv_l | Zd_l], K = r^2 ----
  const T* qmt = qm + (row0 + q0) * r;
  float qmr[2][2 * kRK];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kRK; ++j) {
      const int row = wrow + 8 * i, c = t4 + 4 * j;
      qmr[i][j] = row < qrows && c < r ? to_f32(qmt[(size_t)row * r + c]) : 0.f;
    }
  // qm's column e at the thread's two rows, loaded an item ahead
  const auto qm_col = [&](int item, float (&x)[2]) {
    const int e = min(item, r * ncb - 1) / ncb;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + 8 * i;
      x[i] = row < qrows ? to_f32(qmt[(size_t)row * r + e]) : 0.f;
    }
  };
  float qe_next[2];
  qm_col(0, qe_next);
  flash_consume<C>(smem, ktiles, nitems, [&](int it, const float* pl) {
    if (!active) return;
    const int cb = (it - ktiles) % ncb;
    const float qe[2] = {qe_next[0], qe_next[1]};
    qm_col(it - ktiles + 1, qe_next);
    if constexpr (kRK > 4) {
      if (cb > 0) {
        cross_item<C, kRK, 1>(pl, qmr, qe, acc, cden);
      } else {
        cross_item<C, kRK, 0>(pl, qmr, qe, acc, cden);
      }
    } else {
      cross_item<C, kRK, 0>(pl, qmr, qe, acc, cden);
    }
  });

  // den = rowsum W (this thread's keys, summed over the quad) + the cross
  // term's column, held by the quad's first thread.
  quad_sum(den);
  den[0] += __shfl_sync(0xffffffffu, cden[0], lane & ~3);
  den[1] += __shfl_sync(0xffffffffu, cden[1], lane & ~3);
  tc_store_rows<kNV>(out + (row0 + q0) * h, h, qrows, acc, den);
  if (den_out != nullptr && t4 == 0) {   // 1 + den per row, for the backward
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + 8 * i;
      if (row < qrows) den_out[row0 + q0 + row] = 1.f + den[i];
    }
  }
}

template <typename T, bool kLocalExact, int kNV, int kRK>
using OutputCfg = Flash<T, kLocalExact ? 8 * kNV : 8 * kRK, kNV>;

template <typename T, bool kLocalExact, int kNV, int kRK>
cudaError_t launch_output(const void* qm, const void* km, const void* q, const void* k,
                          const void* v, const float* zv, const float* zd, void* out,
                          float* den_out, int bh, int n, int r, int h, int b, int degree,
                          float scale, cudaStream_t stream) {
  using C = OutputCfg<T, kLocalExact, kNV, kRK>;
  auto kernel = output_kernel<T, kLocalExact, kNV, kRK>;
  cudaError_t err = flash_smem_limit<C>(kernel);
  if (err != cudaSuccess) return err;
  const int f = kLocalExact ? h : r;
  const void* kf = kLocalExact ? k : km;
  const int bulk = (f * sizeof(T)) % 16 == 0 && (h * sizeof(T)) % 16 == 0 && h % 4 == 0 &&
                   r % 4 == 0 && aligned16(kf) && aligned16(v) && aligned16(zv) &&
                   aligned16(zd);
  const dim3 grid((b + kFlashRows - 1) / kFlashRows, n / b, bh);
  kernel<<<grid, kFlashThreads, Ring<C>::kSmemBytes, stream>>>(
      static_cast<const T*>(qm), static_cast<const T*>(km), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), zv, zd, static_cast<T*>(out),
      den_out, n, r, h, b, degree, scale, bulk);
  return cudaGetLastError();
}

template <typename T, bool kLocalExact>
cudaError_t run_output(const void* qm, const void* km, const void* q, const void* k,
                       const void* v, const float* zv, const float* zd, void* out,
                       float* den_out, int bh, int n, int r, int h, int b, int degree,
                       float scale, cudaStream_t stream) {
  if (h <= 64 && r <= 32) {
    return launch_output<T, kLocalExact, 8, 4>(qm, km, q, k, v, zv, zd, out, den_out, bh, n,
                                               r, h, b, degree, scale, stream);
  }
  return launch_output<T, kLocalExact, kMaxH / 8, kMaxR / 8>(
      qm, km, q, k, v, zv, zd, out, den_out, bh, n, r, h, b, degree, scale, stream);
}

template <typename T, int kNV, int kRN>
cudaError_t launch_fold(const void* km, const void* v, float* hv, float* hd, int bh, int n,
                        int r, int h, int b, cudaStream_t stream) {
  using C = Fold<T, kNV, kRN>;
  auto kernel = fold_kernel<T, kNV, kRN>;
  cudaError_t err = flash_smem_limit<C>(kernel);
  if (err != cudaSuccess) return err;
  const int bulk = (r * sizeof(T)) % 16 == 0 && (h * sizeof(T)) % 16 == 0 && aligned16(km) &&
                   aligned16(v);
  const dim3 grid((r * r + kFlashRows - 1) / kFlashRows, n / b, bh);
  kernel<<<grid, kFlashThreads, Ring<C>::kSmemBytes, stream>>>(
      static_cast<const T*>(km), static_cast<const T*>(v), hv, hd, n, r, h, b, bulk);
  return cudaGetLastError();
}

// The fold's instantiations: h <= 64 or 128, r <= 32 or 64.
template <typename T>
cudaError_t run_fold(const void* km, const void* v, float* hv, float* hd, int bh, int n, int r,
                     int h, int b, cudaStream_t stream) {
  if (h <= 64) {
    return r <= 32 ? launch_fold<T, 8, 32>(km, v, hv, hd, bh, n, r, h, b, stream)
                   : launch_fold<T, 8, kMaxR>(km, v, hv, hd, bh, n, r, h, b, stream);
  }
  return r <= 32 ? launch_fold<T, kMaxH / 8, 32>(km, v, hv, hd, bh, n, r, h, b, stream)
                 : launch_fold<T, kMaxH / 8, kMaxR>(km, v, hv, hd, bh, n, r, h, b, stream);
}

template <typename T>
cudaError_t run(const void* qm, const void* km, const void* q, const void* k, const void* v,
                const float* zv0, const float* zd0, void* out, float* den_out, float* hv,
                float* hd, float* zv_out, float* zd_out, int bh, int n, int r, int h, int b,
                int degree, float scale, int local_exact, cudaStream_t stream) {
  cudaError_t err = run_fold<T>(km, v, hv, hd, bh, n, r, h, b, stream);
  if (err != cudaSuccess) return err;
  err = launch_prefix<false>(hv, hd, zv0, zd0, zv_out, zd_out, bh, n / b, r, h, stream);
  if (err != cudaSuccess) return err;
  if (local_exact) {
    return run_output<T, true>(qm, km, q, k, v, hv, hd, out, den_out, bh, n, r, h, b, degree,
                               scale, stream);
  }
  return run_output<T, false>(qm, km, q, k, v, hv, hd, out, den_out, bh, n, r, h, b, degree,
                              scale, stream);
}

// The forward's kernels, their shared memory and threads, for the occupancy
// entry point below.
template <typename T, bool kLocalExact>
void forward_table(const void* (&fn)[3], size_t (&smem)[3], int (&threads)[3], int h) {
  const bool small = h <= 64;
  fn[0] = small ? (const void*)fold_kernel<T, 8, 32> : (const void*)fold_kernel<T, kMaxH / 8, 32>;
  smem[0] = small ? Ring<Fold<T, 8, 32>>::kSmemBytes : Ring<Fold<T, kMaxH / 8, 32>>::kSmemBytes;
  threads[0] = kFlashThreads;
  fn[1] = (const void*)prefix_kernel<float4, false>;
  smem[1] = 0;
  threads[1] = kPrefixThreads;
  fn[2] = small ? (const void*)output_kernel<T, kLocalExact, 8, 4>
                : (const void*)output_kernel<T, kLocalExact, kMaxH / 8, kMaxR / 8>;
  smem[2] = small ? Ring<OutputCfg<T, kLocalExact, 8, 4>>::kSmemBytes
                  : Ring<OutputCfg<T, kLocalExact, kMaxH / 8, kMaxR / 8>>::kSmemBytes;
  threads[2] = kFlashThreads;
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous tensors: qm, km (bh, n, r); q, k, v, out (bh, n, h) of one
// type (dtype 0 = float32, 1 = bfloat16); zv0, zv_out (bh, r, r*h) and zd0,
// zd_out (bh, r, r) float32; hv (bh, n/b, r, r*h) and hd (bh, n/b, r, r)
// float32, which hold the exclusive prefix Z_l of every block on return
// (what the backward reads); den_out (bh, n) float32, 1 + den of every row,
// or null (serving: not written). Requires n % b == 0, r <= 64 and
// h <= 128. Returns the first CUDA error (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int polysketch_causal_forward(const void* qm, const void* km, const void* q,
                                         const void* k, const void* v, const float* zv0,
                                         const float* zd0, void* out, float* den_out,
                                         float* hv, float* hd, float* zv_out, float* zd_out,
                                         int bh, int n, int r, int h, int b, int degree,
                                         float scale, int local_exact, int dtype,
                                         void* stream) {
  if (bh <= 0 || n <= 0 || b <= 0 || n % b != 0 || r <= 0 || r > kMaxR || h < 1 ||
      h > kMaxH || degree < 1 || bh > 65535 || n / b > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = run<float>(qm, km, q, k, v, zv0, zd0, out, den_out, hv, hd, zv_out, zd_out, bh, n,
                     r, h, b, degree, scale, local_exact, s);
  } else if (dtype == 1) {
    err = run<__nv_bfloat16>(qm, km, q, k, v, zv0, zd0, out, den_out, hv, hd, zv_out, zd_out,
                             bh, n, r, h, b, degree, scale, local_exact, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// What each forward kernel holds on the card, in launch order (fold_kernel,
// prefix_kernel, output_kernel) for local_exact, at head width h (the h <=
// 64, r <= 32 instantiations; at h <= 128 the fold's for r <= 32, the
// outputs' for r <= 64) and operands
// of dtype (0 = float32, 1 = bfloat16): five ints each into out[3 * 5]
// (registers a thread, local memory bytes a thread, dynamic shared memory
// bytes a CTA, threads a CTA, CTAs resident an SM). Returns the first CUDA
// error (0 on success).
extern "C" int polysketch_causal_forward_occupancy(int local_exact, int h, int dtype,
                                                   int* out) {
  if (h < 1 || h > kMaxH || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const void* fn[3];
  size_t smem[3];
  int threads[3];
  if (dtype == 1) {
    if (local_exact) {
      forward_table<__nv_bfloat16, true>(fn, smem, threads, h);
    } else {
      forward_table<__nv_bfloat16, false>(fn, smem, threads, h);
    }
  } else if (local_exact) {
    forward_table<float, true>(fn, smem, threads, h);
  } else {
    forward_table<float, false>(fn, smem, threads, h);
  }
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = cudaFuncSetAttribute(fn[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem[i]);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, fn[i])) != cudaSuccess) return (int)err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn[i], threads[i], smem[i]);
    if (err != cudaSuccess) return (int)err;
    const int row[5] = {a.numRegs, (int)a.localSizeBytes, (int)smem[i], threads[i], ctas};
    for (int j = 0; j < 5; ++j) out[5 * i + j] = row[j];
  }
  return 0;
}
