// The backward of causal PolySketch attention (B1) for NVIDIA Hopper
// (sm_90a), hand-written CUDA.
//
// The JAX package has no backward kernel: it trains through XLA's gradient
// of the jnp block path (src/repro/core/linear_attention.py). This file
// gives B1's forward (polysketch_causal.cu) a backward of its own, so that
// training runs on kernels end to end. Per bh and block l of b rows, with
// Phi(x) = x (x) x, Y1 = [Y | 1], the forward's exclusive prefix Z_l
// (r^2 x (h + 1): Zv_l beside Zd_l) and D = 1 + den of each row:
//   g_i  = [dNum_i | dDen_i],  dNum_i = dO_i / D_i,  dDen_i = -(dO_i . out_i) / D_i
//   dZ_l = sum_{i in l} Phi(qm_i) g_i^T,   dH_j = sum_{l > j} dZ_l,   dz0 = sum_l dZ_l
//   dqm_i = (M_i + M_i^T) qm_i,  M_i[e, c] = sum_d Z_l[e, c, d] g_i[d]   (Z need not be symmetric)
//   dkm_j = (N_j + N_j^T) km_j,  N_j[e, c] = sum_d dH_l[e, c, d] v1_j[d]
//   dv_j  = sum_{i >= j in l} W_ij dNum_i + Phi(km_j)^T dHv_l
// and on the diagonal block, S = Q K^T * scale, W = tril(S^p),
// dW = G V1^T, dS = p S^(p-1) dW (masked): dq = scale dS K, dk = scale
// dS^T Q. Without local_exact, S = Qm Km^T, W = S^2, and the diagonal's
// gradient goes to qm and km.
//
// Seven launches, no atomics, every sum in a fixed order (two calls give
// the same bits):
//   grad_prep         g from dO, out and D (one warp a row).
//   grad_fold         dZ_l = Qm_l^T [Qm_l (x) dNum_l | Qm_l (.) dDen_l]: the
//                     forward's fold (polysketch_state.cuh's fold_block)
//                     with the ones column replaced by dDen.
//   grad_suffix       right to left from zero: dH_l over dZ_l in place, and
//                     dz0 (prefix_scan).
//   grad_query_state  dqm's state part, (M + M^T) qm with M = G Z_l^T, a
//                     128-row tile of block l a CTA; writes dqm.
//   grad_key_state    dkm's state part, (N + N^T) km with N = V1 dH_l^T,
//                     and dv's, Phi(km) dHv_l, likewise; writes dkm and dv
//                     (zeros for the last block, whose dH is zero).
//   grad_query_diag   dq = dS K over the key stages up to the diagonal, a
//                     128-query tile a CTA, recomputing S and dW; writes dq
//                     (without local_exact, adds dS Km to dqm).
//   grad_key_diag     dk = dS^T Q and dv += W^T dNum over the query stages
//                     from the diagonal on, a 128-key tile a CTA,
//                     recomputing S and dW; writes dk and adds to dv
//                     (without local_exact, adds dS^T Qm to dkm).
// The state kernels run before the diagonal kernels, so that each output
// element is the state part plus the diagonal part, in that order.
//
// What bounds it. At the training shape (bh 24, n 4096, r 32, h 64, b 1024,
// f32) the function needs ~78 GFLOP of products: four r^2-wide ones (the
// fold, M, N and Phi(km) dHv; the last two only for the three blocks
// before the last) and five over the diagonal's pairs (S, dW, dq, dk, dv).
// In 3xTF32 at 495 TFLOP/s that is ~0.49 ms, bound by operations (1.2 ms
// on the f32 FMA pipes); chip_smoke.py's b1_bwd_bound counts it from the
// shapes. Each product is three TF32 products (common.cuh's split rule).
// The seven kernels take 2.63 ms there on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/port_b1_bwd_ab.py, PERF.md), 19 % of that bound. What holds a
// kernel back from it is less the tensor cores than the instructions
// around them: splitting operands, the scores' powers and masks, staging.
// The design:
// - Every CTA has 8 warps (two warpgroups of 64 own rows) and one CTA an
//   SM: the other side's rows stream through shared memory in stages that
//   both warpgroups share, so each stage is copied and split once for 128
//   own rows.
// - The state work has kernels of its own, tiled for it: a 266 KB Z_l or
//   dH_l crosses L2 into shared memory 8 times per (bh, block), one sketch
//   row e (r x (h + 1)) a stage, through a cp.async ring of 3 stages; the
//   warp's own rows of G (or V1) stay split in registers for all r stages.
// - Every staged operand is split into its TF32 high and low halves once,
//   by the thread that copied it, into "planes" of 8 x 4 core matrices, in
//   the layout each product reads (see Plane). An operand read along both
//   of its axes (K for S and for dq; Q for S^T and for dk; dNum for dW^T
//   and for dv) gets a second, transposed plane whose key order is
//   permuted within each 8, so that the scores' accumulator is the next
//   product's A operand as it stands.
// - The products are wgmma (m64n32k8 and m64n64k8, B from the planes by
//   descriptor, A from registers), each k-step its own group so that few
//   A fragments are live. Two plane sets: stage st + 1 is split while
//   stage st's last wgmma run.
// - The scores' powers are taken over the whole fragment, the loop over
//   the degree's bits outside (as the forward's PowWeight).
// - The query and the key kernel each rebuild S and dW (~13 GFLOP over the
//   bound), the price of having no atomics.
//
// Head widths and types. Every kernel is a template on the padded head
// width kH, 64 (h <= 64) or 128 (h <= 128), and on the operands' type T,
// float32 or bfloat16. bf16 operands (qm, km, q, k, v, out, dout) are
// converted to f32 as they are staged (cp.async copies f32 only, so a bf16
// chunk goes through the registers of the thread that later splits it);
// the forward's saved state and D, and the scratch (dNum, dDen, dH), are
// f32; every product is 3xTF32 as in f32 (a bf16 value is exact in TF32),
// and the gradients are written in T from their f32 sums: an output that
// two kernels add to (dv, and dqm and dkm without local_exact) is summed
// in an f32 buffer (the output itself for f32) and written in T by the
// second. At kH = 128 the registers would not hold the warp's own rows
// beside the accumulators (dq's 16 x 128, or dv's and dk's), so the
// diagonal kernels read those A operands from memory at each k-step, one
// k-step ahead (OwnRows), and hold one plane set where two do not fit in
// shared memory (a stage is then split after the last one's products);
// the state kernels keep the rows unsplit and split them at each use.

#include <stddef.h>

#include "common.cuh"
#include "polysketch_state.cuh"
#include "wgmma_planes.cuh"

namespace {

constexpr int kBwdR = 32;             // sketch width r, zero-padded (r <= 32)
constexpr int kPrepWarps = 8;
constexpr int kDiagWarps = 8;         // a diagonal CTA: 128 own rows, 16 a warp
constexpr int kDiagThreads = 32 * kDiagWarps;
constexpr int kDiagRows = 16 * kDiagWarps;
constexpr int kStage = 32;            // the other side's rows a stage
constexpr int kStateWarps = 8;        // a state CTA: 128 own rows, 16 a warp
constexpr int kStateThreads = 32 * kStateWarps;
constexpr int kStateRows = 16 * kStateWarps;
constexpr int kZRing = 3;             // cp.async stages of the state kernels
constexpr int kSks = kBwdR + 4;       // row stride of a state CTA's sketch tile
constexpr int kDxs = kBwdR + 1;       // row stride of the dx scratch
constexpr size_t kMaxSmem = 232448;   // a CTA's shared memory on sm_90

// [Y | y | 0] of a head width kH: y at column kH, kKg columns in all.
template <int kH>
__host__ __device__ constexpr int kg_width() { return kH + 8; }

template <int kN>
__device__ __forceinline__ void zero(float (&x)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
}

// The warp's A fragments at k-step kk of its rows `row` and `row + 8` of a
// row-major matrix `width` wide (columns 8kk + t and 8kk + t + 4), zero
// past `rows` and `width`; when ycol >= 0, column ycol is y: from `last`
// (f32), or 1 when last is null.
template <typename T>
struct RowsA {
  const T* src;
  const float* last;
  int row, rows, width, ycol;
  __device__ __forceinline__ Frag4 operator()(int kk) const {
    const int t = threadIdx.x & 3;
    Frag4 f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = row + 8 * (i & 1), c = 8 * kk + t + 4 * (i >> 1);
      float x = 0.f;
      if (rr < rows) {
        if (c < width) {
          x = to_f32(src[(size_t)rr * width + c]);
        } else if (c == ycol) {
          x = last == nullptr ? 1.f : last[rr];
        }
      }
      f.x[i] = x;
    }
    return f;
  }
};

// The warp's own rows as wg_pair's A operand: held in registers (kHold,
// read once), or read from memory at each use (RowsA).
template <bool kHold, int kKS, typename T>
struct OwnRows {
  RowsA<T> rd;
  float a[kHold ? kKS : 1][4];
  __device__ __forceinline__ explicit OwnRows(RowsA<T> r) : rd(r) {
    if constexpr (kHold) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        const Frag4 f = rd(kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[kk][i] = f.x[i];
      }
    }
  }
  __device__ __forceinline__ Frag4 operator()(int kk) const {
    if constexpr (kHold) {
      return Frag4{{a[kk][0], a[kk][1], a[kk][2], a[kk][3]}};
    } else {
      return rd(kk);
    }
  }
};

// ---------------------------------------------------------------------------
// grad_prep: g = [dO / D | -(dO . out) / D], one warp a row.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * kPrepWarps)
grad_prep(const T* __restrict__ dout, const T* __restrict__ out,
          const float* __restrict__ den1, float* __restrict__ dnum, float* __restrict__ dden,
          int rows, int h) {
  prep_row<kPrepWarps>(dout, out, den1, dnum, dden, rows, h);
}

// grad_fold and grad_suffix: the forward's fold and prefix scan under the
// backward's own names (see the header).
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
grad_fold(const T* __restrict__ qm, const float* __restrict__ dnum,
          const float* __restrict__ dden, float* __restrict__ dhv, float* __restrict__ dhd,
          int n, int r, int h, int b) {
  fold_block<T, float, 2>(qm, dnum, dden, dhv, dhd, n, r, h, b);
}

template <typename V>
__global__ void __launch_bounds__(kPrefixThreads)
grad_suffix(float* __restrict__ hv, float* __restrict__ hd, float* __restrict__ zv_out,
            float* __restrict__ zd_out, int t, int rrh, int rr) {
  prefix_scan<V, true>(hv, hd, nullptr, nullptr, zv_out, zd_out, t, rrh, rr);
}

// ---------------------------------------------------------------------------
// The state kernels: one sketch row e of Z_l (or dH_l) a stage, r stages.
// Stage e is Yv[e] (r rows c of h values) beside Yd[e] (r values, column
// kH): the raw tile kBwdR x raw_stride(kZNC), split into the direct plane
// PZ (c x d, for N = W Y[e]^T) and, for the key side, the transposed PZt
// (d x c, for Phi_e(x) Yv[e]).
// ---------------------------------------------------------------------------

template <bool kKey, int kH>
struct StateSmem {
  using PZ = Plane<kBwdR, kg_width<kH>(), false>;
  using PZt = Plane<kH, kBwdR, true>;
  static constexpr int kZNC = kH / 4 + 1;            // raw chunks a row: Yv, then Yd
  static constexpr int kZRs = raw_stride(kZNC);
  static constexpr int kZRaw = kBwdR * kZRs;
  static constexpr int kPlanes = 2 * PZ::kFloats + (kKey ? 2 * PZt::kFloats : 0);
  static constexpr int kFloats =
      kZRing * kZRaw + 2 * kPlanes + kStateRows * (kSks + kDxs);
  static constexpr size_t kBytes = (size_t)kFloats * sizeof(float);
  static_assert(kBytes <= kMaxSmem, "one CTA's shared memory on sm_90");
};

// Issue the copies of stage e of a state (zv (., r, r*h), zd (., r, r); state
// index `state`) into raw slot `raw`, and commit them as one group.
template <int kH>
__device__ __forceinline__ void issue_state(float* raw, const float* zv, const float* zd,
                                            size_t state, int e, int r, int h, bool vec) {
  using L = StateSmem<false, kH>;
  const size_t zrow = state * r + e;
  const float* yv = zv + zrow * r * h;
  const float* yd = zd + zrow * r;
  for_chunks<kStateThreads, kBwdR, L::kZNC>([&](int c, int chunk) {
    if (c >= r) return;
    if (chunk < L::kZNC - 1) {
      copy_chunk(raw + c * L::kZRs, yv + (size_t)c * h, chunk, h, vec);
    } else {
      cp_async4(raw + c * L::kZRs + kH, yd + c, true);
    }
  });
  cp_async_commit();
}

// Split this thread's chunks of a raw state stage into the planes.
template <bool kKey, int kH>
__device__ __forceinline__ void split_state(const float* raw, float* p, int r, int h) {
  using L = StateSmem<kKey, kH>;
  using PZ = typename L::PZ;
  using PZt = typename L::PZt;
  float* z_hi = p;
  float* z_lo = z_hi + PZ::kFloats;
  float* t_hi = z_lo + PZ::kFloats;
  float* t_lo = t_hi + PZt::kFloats;
  for_chunks<kStateThreads, kBwdR, L::kZNC>([&](int c, int chunk) {
    const float* row = raw + c * L::kZRs;
    if (chunk < L::kZNC - 1) {
      const float4 x = read_chunk(row, chunk, h, c < r);
      put4(z_hi, z_lo, PZ::off(c, 4 * chunk), x);
      if (kKey) put_t<PZt, false>(t_hi, t_lo, c, 4 * chunk, x);
    } else {
      put4(z_hi, z_lo, PZ::off(c, kH), make_float4(c < r ? row[kH] : 0.f, 0.f, 0.f, 0.f));
    }
  });
}

// The gradient of x through one row block e, for the warp's 16 rows: with
// N[row, c] = nb (accumulator layout),
//   dx[row, e] = sum_c N[row, c] x[row, c]   -> dx_s[row][e] (the quad's first thread)
//   dx[row, c] += x[row, e] N[row, c]        -> acc
// xs: the warp's first row of the staged x tile (stride kSks); xe: x[row,
// e] of rows g and g + 8.
__device__ __forceinline__ void sym_contract(float (&acc)[kBwdR / 8][4],
                                             const float (&nb)[kBwdR / 8][4], float* dx_s,
                                             int e, const float* xs, const float (&xe)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kBwdR / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = g + 8 * (c >> 1), col = nt * 8 + 2 * t + (c & 1);
      part[c >> 1] += nb[nt][c] * xs[row * kSks + col];
      acc[nt][c] += xe[c >> 1] * nb[nt][c];
    }
  }
  quad_sum(part);
  if (t == 0) {
    dx_s[g * kDxs + e] = part[0];
    dx_s[(g + 8) * kDxs + e] = part[1];
  }
}

// grad_query_state (kKey false): dqm = (M + M^T) qm, M = G Z_l^T.
// grad_key_state (kKey true): dkm = (N + N^T) km, N = V1 dH_l^T, and
// dv = Phi(km) dHv_l; zeros for the last block.
// grid (ceil(b / 128), t, bh); warp w owns rows 16w .. 16w + 15 of the tile.
// dx is written in T to dx (final) when it is not null, else in f32 to
// dx_part (a diagonal kernel adds to it); dv in f32 to dv_part.
template <bool kKey, int kH, typename T, typename W>
__device__ __forceinline__ void state_tile(const T* __restrict__ x, const W* __restrict__ w,
                                           const float* __restrict__ wlast,
                                           const float* __restrict__ zv,
                                           const float* __restrict__ zd, T* __restrict__ dx,
                                           float* __restrict__ dx_part,
                                           float* __restrict__ dv_part, int n, int r, int h,
                                           int b) {
  using L = StateSmem<kKey, kH>;
  using PZ = typename L::PZ;
  using PZt = typename L::PZt;
  constexpr int kKg = kg_width<kH>();
  constexpr bool kHoldSplit = kH <= 64;   // the rows of W split once, or at each use
  const int l = blockIdx.y, t = gridDim.y, bh = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;
  const int r0 = blockIdx.x * kStateRows, rows = min(kStateRows, b - r0);
  const size_t row0 = (size_t)bh * n + (size_t)l * b + r0;
  const auto put_dx = [&](size_t i, float val) {
    if (dx != nullptr) {
      dx[i] = from_f32<T>(val);
    } else {
      dx_part[i] = val;
    }
  };
  if (kKey && l + 1 == t) {   // dH of the last block is zero
    for (int i = threadIdx.x; i < rows * r; i += kStateThreads) put_dx(row0 * r + i, 0.f);
    for (int i = threadIdx.x; i < rows * h; i += kStateThreads) dv_part[row0 * h + i] = 0.f;
    return;
  }
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                                   // kZRing x kZRaw
  float* planes = raw + kZRing * L::kZRaw;             // 2 x L::kPlanes
  float* x_s = planes + 2 * L::kPlanes;                // kStateRows x kSks
  float* dx_s = x_s + kStateRows * kSks;               // kStateRows x kDxs

  // PZ's last chunk (columns kH + 4 ..) and x_s's columns past r stay
  // zero: no copy or split writes them.
  for (int i = threadIdx.x; i < 4 * PZ::kCS; i += kStateThreads) {
    const int j = i / PZ::kCS;   // buffer j / 2, hi or lo plane j % 2
    planes[(j >> 1) * L::kPlanes + (j & 1) * PZ::kFloats + (kKg / 4 - 1) * PZ::kCS +
           i % PZ::kCS] = 0.f;
  }
  zero_pad_cols<kStateThreads>(x_s, kStateRows, r, kSks);
  stage_rows<kStateThreads>(x_s, x + row0 * r, rows, kStateRows, r, kSks);
  const size_t state = (size_t)bh * t + l;
  const bool vec = vec_ok(zv, h);
  issue_state<kH>(raw, zv, zd, state, 0, r, h, vec);       // closes the group of x_s
  if (r > 1) issue_state<kH>(raw + L::kZRaw, zv, zd, state, 1, r, h, vec);

  // The warp's rows of W = [w | wlast or 1], split once for all r stages
  // (kHoldSplit), else kept unsplit.
  FragA wa[kHoldSplit ? kKg / 8 : 1];
  float wraw[kHoldSplit ? 1 : kKg / 8][4];
  {
    const RowsA<W> rd{w + row0 * h + (size_t)wrow * h,
                      wlast == nullptr ? nullptr : wlast + row0 + wrow, g, rows - wrow, h, kH};
#pragma unroll
    for (int kk = 0; kk < kKg / 8; ++kk) {
      const Frag4 f = rd(kk);
      if constexpr (kHoldSplit) {
        wa[kk] = split_a(f.x[0], f.x[1], f.x[2], f.x[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) wraw[kk][i] = f.x[i];
      }
    }
  }

  // Stage 0 into planes 0; then, each stage e, stage e + 1 is split into
  // the other planes while the products of stage e run, and stage e + 3 is
  // copied.
  if (r > 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  split_state<kKey, kH>(raw, planes, r, h);
  if (r > 2) issue_state<kH>(raw + 2 * L::kZRaw, zv, zd, state, 2, r, h, vec);
  fence_async_smem();
  __syncthreads();
  const float* xs = x_s + wrow * kSks;   // the warp's rows of x
  float acc[kBwdR / 8][4], dva[kH / 8][4];
  zero(acc);
  zero(dva);
  for (int e = 0; e < r; ++e) {
    const float* p = planes + (e & 1) * L::kPlanes;
    const float* t_hi = p + 2 * PZ::kFloats;
    const float xe[2] = {xs[g * kSks + e], xs[(g + 8) * kSks + e]};
    // N = W Y[e]^T beside dv += Phi_e(km) dHv[e], the two chains' wgmma
    // alternating; Phi_e(km) as the cross product's A operand: A[row, c] =
    // km[row, e] km[row, c]
    float nb[kBwdR / 8][4];
    zero(nb);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKg / 8; ++kk) {
      const uint64_t dh = plane_desc<PZ>(p + 2 * kk * PZ::kCS);
      const uint64_t dl = plane_desc<PZ>(p + PZ::kFloats + 2 * kk * PZ::kCS);
      const int kc = kk >> 1;   // the cross product's k-step beside this pair
      const bool cross = kKey && (kk & 1) == 0 && kc < kBwdR / 8;
      const uint64_t th = cross ? plane_desc<PZt>(t_hi + 2 * kc * PZt::kCS) : 0;
      const uint64_t tl = cross ? plane_desc<PZt>(t_hi + PZt::kFloats + 2 * kc * PZt::kCS) : 0;
      FragA wf, phi;
      if constexpr (kHoldSplit) {
        wf = wa[kk];
      } else {
        wf = split_a(wraw[kk][0], wraw[kk][1], wraw[kk][2], wraw[kk][3]);
      }
      if (cross) {
        const float* x0 = xs + g * kSks + t4 + 8 * kc;
        const float* x1 = x0 + 8 * kSks;
        phi = split_a(xe[0] * x0[0], xe[1] * x1[0], xe[0] * x0[4], xe[1] * x1[4]);
      }
      wg_mma_p<PZ>(nb, wf.lo, dh);
      if (cross) wg_mma_p<PZt>(dva, phi.lo, th);
      wg_mma_p<PZ>(nb, wf.hi, dl);
      if (cross) wg_mma_p<PZt>(dva, phi.hi, tl);
      wg_mma_p<PZ>(nb, wf.hi, dh);
      if (cross) wg_mma_p<PZt>(dva, phi.hi, th);
    }
    wg_commit();
    if (e + 1 < r) {
      if (e + 2 < r) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      split_state<kKey, kH>(raw + ((e + 1) % kZRing) * L::kZRaw,
                            planes + ((e + 1) & 1) * L::kPlanes, r, h);
      if (e + 3 < r) {
        issue_state<kH>(raw + ((e + 3) % kZRing) * L::kZRaw, zv, zd, state, e + 3, r, h, vec);
      }
    }
    wg_wait();
    reg_fence(nb);
    if (kKey) reg_fence(dva);
    sym_contract(acc, nb, dx_s + wrow * kDxs, e, xs, xe);
    fence_async_smem();
    __syncthreads();   // planes (e + 1) & 1 complete; planes e & 1 free
  }
  __syncwarp();
#pragma unroll
  for (int nd = 0; nd < kBwdR / 8; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
      if (row < rows && col < r) put_dx((row0 + row) * r + col, acc[nd][c] + dx_s[row * kDxs + col]);
    }
  }
  if (kKey) {
#pragma unroll
    for (int nd = 0; nd < kH / 8; ++nd) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
        if (row < rows && col < h) dv_part[(row0 + row) * h + col] = dva[nd][c];
      }
    }
  }
}

template <int kH, typename T>
__global__ void __launch_bounds__(kStateThreads)
grad_query_state(const T* __restrict__ qm, const float* __restrict__ dnum,
                 const float* __restrict__ dden, const float* __restrict__ zv,
                 const float* __restrict__ zd, T* __restrict__ dqm, float* __restrict__ dqm_part,
                 int n, int r, int h, int b) {
  state_tile<false, kH>(qm, dnum, dden, zv, zd, dqm, dqm_part, nullptr, n, r, h, b);
}

template <int kH, typename T>
__global__ void __launch_bounds__(kStateThreads)
grad_key_state(const T* __restrict__ km, const T* __restrict__ v,
               const float* __restrict__ dhv, const float* __restrict__ dhd,
               T* __restrict__ dkm, float* __restrict__ dkm_part, float* __restrict__ dv_part,
               int n, int r, int h, int b) {
  state_tile<true, kH>(km, v, static_cast<const float*>(nullptr), dhv, dhd, dkm, dkm_part,
                       dv_part, n, r, h, b);
}

// ---------------------------------------------------------------------------
// The diagonal kernels. A CTA owns 128 rows of block l (its A operands in
// registers, split per k-step, or read from memory at each k-step at kH
// 128) and streams the other side's rows of the block kStage at a time: a
// raw tile copied with cp.async (two slots), then split into one of two
// plane sets while the last products of the stage before run on the other
// (one set where two do not fit: the split then waits for them); one
// __syncthreads a stage.
// ---------------------------------------------------------------------------

template <bool kLocalExact, int kH>
struct DiagSmem {
  static constexpr int kF = kLocalExact ? kH : kBwdR;   // the scores' features
  static constexpr int kKg = kg_width<kH>();
  using PF = Plane<kStage, kF, false>;       // the other side's features: S's B
  using PFt = Plane<kF, kStage, true>;       // transposed, permuted: dq's / dk's B
  using PY = Plane<kStage, kKg, false>;      // [V | 1] or [dNum | dDen]: dW's B
  using PYt = Plane<kH, kStage, true>;       // dNum transposed, permuted: dv's B
  static constexpr int kFNC = kF / 4, kYNC = kH / 4 + 1;
  static constexpr int kFRs = raw_stride(kFNC), kYRs = raw_stride(kYNC);
  static constexpr int kRaw = kStage * (kFRs + kYRs);
  static constexpr int kQPlanes = 2 * (PF::kFloats + PFt::kFloats + PY::kFloats);
  static constexpr int kKPlanes = kQPlanes + 2 * PYt::kFloats;
  // two sets of planes (the next stage is split under this one's products)
  // where they fit, and two raw slots
  static constexpr size_t kRawBytes = (size_t)2 * kRaw * sizeof(float);
  static constexpr int kQSets = 2 * kQPlanes * sizeof(float) + kRawBytes <= kMaxSmem ? 2 : 1;
  static constexpr int kKSets = 2 * kKPlanes * sizeof(float) + kRawBytes <= kMaxSmem ? 2 : 1;
  static constexpr size_t kQBytes = kQSets * kQPlanes * sizeof(float) + kRawBytes;
  static constexpr size_t kKBytes = kKSets * kKPlanes * sizeof(float) + kRawBytes;
  static_assert(kKBytes <= kMaxSmem, "one CTA's shared memory on sm_90");
};

// Issue the copies of stage rows [s0, s0 + rows) into a raw slot: the
// features (f wide) and Y (h wide) beside y (from `last`, or nothing when
// y is the ones column).
template <bool kLocalExact, int kH, typename TF, typename TY>
__device__ __forceinline__ void issue_diag(float* raw, const TF* feat, int f, bool fvec,
                                           const TY* y, const float* last, int h, bool yvec,
                                           int rows) {
  using L = DiagSmem<kLocalExact, kH>;
  float* rf = raw;
  float* ry = raw + kStage * L::kFRs;
  for_chunks<kDiagThreads, kStage, L::kFNC>([&](int row, int chunk) {
    if (row < rows) copy_chunk(rf + row * L::kFRs, feat + (size_t)row * f, chunk, f, fvec);
  });
  for_chunks<kDiagThreads, kStage, L::kYNC>([&](int row, int chunk) {
    if (row >= rows) return;
    if (chunk < L::kYNC - 1) {
      copy_chunk(ry + row * L::kYRs, y + (size_t)row * h, chunk, h, yvec);
    } else if (last != nullptr) {
      cp_async4(ry + row * L::kYRs + kH, last + row, true);
    }
  });
  cp_async_commit();
}

// Split this thread's chunks of a raw slot into the planes at p: PF and
// PFt from the features, PY from [Y | y] (y the ones column when `ones`),
// and PYt from Y when kYt.
template <bool kLocalExact, int kH, bool kYt>
__device__ __forceinline__ void split_diag(const float* raw, float* p, int f, int h, int rows,
                                           bool ones) {
  using L = DiagSmem<kLocalExact, kH>;
  using PF = typename L::PF;
  using PFt = typename L::PFt;
  using PY = typename L::PY;
  using PYt = typename L::PYt;
  float* f_hi = p;
  float* f_lo = f_hi + PF::kFloats;
  float* ft_hi = f_lo + PF::kFloats;
  float* ft_lo = ft_hi + PFt::kFloats;
  float* y_hi = ft_lo + PFt::kFloats;
  float* y_lo = y_hi + PY::kFloats;
  float* yt_hi = y_lo + PY::kFloats;
  float* yt_lo = yt_hi + PYt::kFloats;
  const float* rf = raw;
  const float* ry = raw + kStage * L::kFRs;
  for_chunks<kDiagThreads, kStage, L::kFNC>([&](int row, int chunk) {
    const float4 x = read_chunk(rf + row * L::kFRs, chunk, f, row < rows);
    put4(f_hi, f_lo, PF::off(row, 4 * chunk), x);
    put_t<PFt, true>(ft_hi, ft_lo, row, 4 * chunk, x);
  });
  for_chunks<kDiagThreads, kStage, L::kYNC>([&](int row, int chunk) {
    if (chunk < L::kYNC - 1) {
      const float4 x = read_chunk(ry + row * L::kYRs, chunk, h, row < rows);
      put4(y_hi, y_lo, PY::off(row, 4 * chunk), x);
      if (kYt) put_t<PYt, true>(yt_hi, yt_lo, row, 4 * chunk, x);
    } else {
      const float y = row < rows ? (ones ? 1.f : ry[row * L::kYRs + kH]) : 0.f;
      put4(y_hi, y_lo, PY::off(row, kH), make_float4(y, 0.f, 0.f, 0.f));
    }
  });
}

// grad_query_diag: dq (or dqm's diagonal part) of one 128-query tile of
// block l. grid (ceil(b / 128), t, bh), the last tile (most key stages)
// first; warp w owns query rows 16w .. 16w + 15. Without local_exact, dqm
// = dqm_part + this part.
template <bool kLocalExact, int kH, typename T>
__global__ void __launch_bounds__(kDiagThreads, 1)
grad_query_diag(const T* __restrict__ qm, const T* __restrict__ km, const T* __restrict__ q,
                const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ dnum,
                const float* __restrict__ dden, const float* __restrict__ dqm_part,
                T* __restrict__ dqm, T* __restrict__ dq, int n, int r, int h, int b, int degree,
                float scale) {
  using L = DiagSmem<kLocalExact, kH>;
  constexpr int kF = L::kF, kKg = L::kKg, kSets = L::kQSets;
  constexpr bool kHold = kH <= 64;
  const int qt = gridDim.x - 1 - blockIdx.x, l = blockIdx.y, bh = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16, wg0 = (threadIdx.x >> 7) * 64;
  const int q0 = qt * kDiagRows, qrows = min(kDiagRows, b - q0);
  const int f = kLocalExact ? h : r;
  extern __shared__ __align__(16) float smem[];
  float* planes = smem;                        // kSets sets of L::kQPlanes
  float* raw = smem + kSets * L::kQPlanes;     // 2 slots of L::kRaw

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const T* kf = (kLocalExact ? k : km) + row0 * f;
  const T* vb = v + row0 * h;
  const bool fvec = vec_ok(kf, f), yvec = vec_ok(vb, h);
  const auto issue = [&](int st) {   // key stage st into raw slot st & 1
    const int k0 = st * kStage;
    issue_diag<kLocalExact, kH>(raw + (st & 1) * L::kRaw, kf + (size_t)k0 * f, f, fvec,
                                vb + (size_t)k0 * h, static_cast<const float*>(nullptr), h,
                                yvec, min(kStage, b - k0));
  };
  const auto split = [&](int st) {   // raw slot st & 1 into plane set st % kSets
    split_diag<kLocalExact, kH, false>(raw + (st & 1) * L::kRaw,
                                       planes + (st % kSets) * L::kQPlanes, f, h,
                                       min(kStage, b - st * kStage), true);
  };
  for (int i = threadIdx.x; i < kSets * L::kQPlanes; i += kDiagThreads) planes[i] = 0.f;
  issue(0);

  const size_t own = row0 + q0 + wrow;
  const OwnRows<kHold, kF / 8, T> qa(
      RowsA<T>{(kLocalExact ? q : qm) + own * f, nullptr, g, qrows - wrow, f, -1});
  const OwnRows<kHold, kKg / 8, float> ga(
      RowsA<float>{dnum + own * h, dden + own, g, qrows - wrow, h, kH});

  float acc[kF / 8][4];
  zero(acc);
  const int nst = (q0 + qrows + kStage - 1) / kStage;   // key stages up to the diagonal
  cp_async_wait<0>();
  __syncthreads();   // the zeroed planes, before any split writes them
  split(0);
  if (nst > 1) issue(1);
  fence_async_smem();
  __syncthreads();
  for (int st = 0; st < nst; ++st) {
    const int k0 = st * kStage, krows = min(kStage, b - k0);
    const float* k_hi = planes + (st % kSets) * L::kQPlanes;
    const float* k_lo = k_hi + L::PF::kFloats;
    const float* kt_hi = k_lo + L::PF::kFloats;
    const float* kt_lo = kt_hi + L::PFt::kFloats;
    const float* v_hi = kt_lo + L::PFt::kFloats;
    const float* v_lo = v_hi + L::PY::kFloats;
    // no key of the stage is visible to the warpgroup's rows
    const bool skip = wg0 >= qrows || k0 > q0 + wg0 + 63;
    float s[kStage / 8][4], w[kStage / 8][4];
    zero(s);
    zero(w);
    if (!skip) {
      // S = Q K^T beside dW = G V1^T
      wg_pair<false, kStage / 8, kF / 8, typename L::PF, kStage / 8, kKg / 8,
              typename L::PY>(s, qa, k_hi, k_lo, w, ga, v_hi, v_lo);
      wg_commit();
      wg_wait();
      reg_fence(s);
      reg_fence(w);
      const bool full = k0 + kStage - 1 <= q0 + wrow && krows == kStage;
      score_grads<kLocalExact, false>(s, w, degree, scale, [&](int nt, int c) {
        const int row = wrow + g + 8 * (c >> 1), j = nt * 8 + 2 * t4 + (c & 1);
        return full || (j < krows && k0 + j <= q0 + row);
      });
      // dq += dS K, waited for below
      wg_pair<true, kF / 8, kStage / 8, typename L::PFt, kF / 8, 0, typename L::PFt>(
          acc, w, kt_hi, kt_lo, acc, w, kt_hi, kt_lo);
      wg_commit();
    }
    if (st + 1 < nst) {   // the next stage, split while dq's last products run
      if (kSets == 1) {   // (one plane set: after them)
        if (!skip) {
          wg_wait();
          reg_fence(acc);
        }
        __syncthreads();
      }
      cp_async_wait<0>();
      split(st + 1);
      if (st + 2 < nst) issue(st + 2);   // into the slot split at st - 1
    }
    if (!skip) {
      wg_wait();
      reg_fence(acc);
    }
    fence_async_smem();
    __syncthreads();   // plane set st + 1 complete; set st free for stage st + 2
  }

#pragma unroll
  for (int nd = 0; nd < kF / 8; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
      if (row < qrows && col < f) {
        const size_t i = (row0 + q0 + row) * f + col;
        if (kLocalExact) {
          dq[i] = from_f32<T>(acc[nd][c]);
        } else {
          dqm[i] = from_f32<T>(dqm_part[i] + acc[nd][c]);
        }
      }
    }
  }
}

// grad_key_diag: dk (or dkm's diagonal part) and dv's diagonal part of one
// 128-key tile of block l. grid (ceil(b / 128), t, bh), the first tile (most
// query stages) first; warp w owns keys 16w .. 16w + 15. dv = dv_part +
// this part; without local_exact, dkm = dkm_part + this part.
template <bool kLocalExact, int kH, typename T>
__global__ void __launch_bounds__(kDiagThreads, 1)
grad_key_diag(const T* __restrict__ qm, const T* __restrict__ km, const T* __restrict__ q,
              const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ dnum,
              const float* __restrict__ dden, const float* __restrict__ dkm_part,
              const float* __restrict__ dv_part, T* __restrict__ dkm, T* __restrict__ dk,
              T* __restrict__ dv, int n, int r, int h, int b, int degree, float scale) {
  using L = DiagSmem<kLocalExact, kH>;
  constexpr int kF = L::kF, kKg = L::kKg, kSets = L::kKSets;
  constexpr bool kHold = kH <= 64;
  const int kt = blockIdx.x, l = blockIdx.y, bh = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16, wg0 = (threadIdx.x >> 7) * 64;
  const int k0 = kt * kDiagRows, krows = min(kDiagRows, b - k0);
  const int f = kLocalExact ? h : r;
  extern __shared__ __align__(16) float smem[];
  float* planes = smem;                        // kSets sets of L::kKPlanes
  float* raw = smem + kSets * L::kKPlanes;     // 2 slots of L::kRaw

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const T* qf = (kLocalExact ? q : qm) + row0 * f;
  const float* gb = dnum + row0 * h;
  const float* db = dden + row0;
  const bool fvec = vec_ok(qf, f), yvec = vec_ok(gb, h);
  const int st0 = k0 / kStage, nst = (b + kStage - 1) / kStage;
  const auto issue = [&](int st) {   // query stage st into raw slot (st - st0) & 1
    const int s0 = st * kStage;
    issue_diag<kLocalExact, kH>(raw + ((st - st0) & 1) * L::kRaw, qf + (size_t)s0 * f, f, fvec,
                                gb + (size_t)s0 * h, db + s0, h, yvec, min(kStage, b - s0));
  };
  const auto split = [&](int st) {   // raw slot (st - st0) & 1 into plane set (st - st0) % kSets
    split_diag<kLocalExact, kH, true>(raw + ((st - st0) & 1) * L::kRaw,
                                      planes + ((st - st0) % kSets) * L::kKPlanes, f, h,
                                      min(kStage, b - st * kStage), false);
  };
  for (int i = threadIdx.x; i < kSets * L::kKPlanes; i += kDiagThreads) planes[i] = 0.f;
  issue(st0);

  const size_t own = row0 + k0 + wrow;
  const OwnRows<kHold, kF / 8, T> ka(
      RowsA<T>{(kLocalExact ? k : km) + own * f, nullptr, g, krows - wrow, f, -1});

  float dva[kH / 8][4], dka[kF / 8][4];
  zero(dva);
  zero(dka);
  cp_async_wait<0>();
  __syncthreads();   // the zeroed planes, before any split writes them
  split(st0);
  if (st0 + 1 < nst) issue(st0 + 1);
  fence_async_smem();
  __syncthreads();
  for (int st = st0; st < nst; ++st) {
    const int s0 = st * kStage, qrows = min(kStage, b - s0);
    const float* q_hi = planes + ((st - st0) % kSets) * L::kKPlanes;
    const float* q_lo = q_hi + L::PF::kFloats;
    const float* qt_hi = q_lo + L::PF::kFloats;
    const float* qt_lo = qt_hi + L::PFt::kFloats;
    const float* g_hi = qt_lo + L::PFt::kFloats;
    const float* g_lo = g_hi + L::PY::kFloats;
    const float* gt_hi = g_lo + L::PY::kFloats;
    const float* gt_lo = gt_hi + L::PYt::kFloats;
    // no query of the stage sees the warpgroup's keys
    const bool skip = wg0 >= krows || s0 + kStage - 1 < k0 + wg0;
    float s[kStage / 8][4], w[kStage / 8][4];
    zero(s);
    zero(w);
    if (!skip) {
      // S^T = K Q^T beside dW^T = V1 G^T. The own rows of V1 are read again
      // each stage (from L1): kept in registers for the whole loop, they
      // would make this kernel spill.
      const OwnRows<kHold, kKg / 8, T> va(
          RowsA<T>{v + own * h, nullptr, g, krows - wrow, h, kH});
      wg_pair<false, kStage / 8, kF / 8, typename L::PF, kStage / 8, kKg / 8,
              typename L::PY>(s, ka, q_hi, q_lo, w, va, g_hi, g_lo);
      wg_commit();
      wg_wait();
      reg_fence(s);
      reg_fence(w);
      const bool full = s0 >= k0 + wrow + 15 && qrows == kStage;
      score_grads<kLocalExact, true>(s, w, degree, scale, [&](int nt, int c) {
        const int key = wrow + g + 8 * (c >> 1), i = nt * 8 + 2 * t4 + (c & 1);
        return full || (i < qrows && k0 + key <= s0 + i);
      });
      // dv += W^T dNum beside dk += dS^T Q, waited for below
      wg_pair<true, kH / 8, kStage / 8, typename L::PYt, kF / 8, kStage / 8,
              typename L::PFt>(dva, s, gt_hi, gt_lo, dka, w, qt_hi, qt_lo);
      wg_commit();
    }
    if (st + 1 < nst) {   // the next stage, split while dv's and dk's last products run
      if (kSets == 1) {   // (one plane set: after them)
        if (!skip) {
          wg_wait();
          reg_fence(dva);
          reg_fence(dka);
        }
        __syncthreads();
      }
      cp_async_wait<0>();
      split(st + 1);
      if (st + 2 < nst) issue(st + 2);   // into the slot split at st - 1
    }
    if (!skip) {
      wg_wait();
      reg_fence(dva);
      reg_fence(dka);
    }
    fence_async_smem();
    __syncthreads();   // plane set st + 1 complete; set st free for stage st + 2
  }

#pragma unroll
  for (int nd = 0; nd < kH / 8; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
      if (row < krows && col < h) {
        const size_t i = (row0 + k0 + row) * h + col;
        dv[i] = from_f32<T>(dv_part[i] + dva[nd][c]);
        if (kLocalExact) dk[i] = from_f32<T>(dka[nd][c]);
      }
    }
  }
  if (!kLocalExact) {
#pragma unroll
    for (int nd = 0; nd < kF / 8; ++nd) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
        if (row < krows && col < r) {
          const size_t i = (row0 + k0 + row) * r + col;
          dkm[i] = from_f32<T>(dkm_part[i] + dka[nd][c]);
        }
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Every kernel of the backward with its launch shape, in launch order
// (grad_suffix's float4 form stands for both).
struct KernelInfo {
  const void* fn;
  int threads;
  size_t smem;
};

template <bool kLocalExact, int kH, typename T>
void kernel_table(KernelInfo (&k)[7], int h) {
  using L = DiagSmem<kLocalExact, kH>;
  k[0] = {(const void*)grad_prep<T>, 32 * kPrepWarps, 0};
  k[1] = {(const void*)grad_fold<T>, kFoldThreads, fold_smem_bytes<2>(h)};
  k[2] = {(const void*)grad_suffix<float4>, kPrefixThreads, 0};
  k[3] = {(const void*)grad_query_state<kH, T>, kStateThreads, StateSmem<false, kH>::kBytes};
  k[4] = {(const void*)grad_key_state<kH, T>, kStateThreads, StateSmem<true, kH>::kBytes};
  k[5] = {(const void*)grad_query_diag<kLocalExact, kH, T>, kDiagThreads, L::kQBytes};
  k[6] = {(const void*)grad_key_diag<kLocalExact, kH, T>, kDiagThreads, L::kKBytes};
}

// The pointers of one call, typed.
template <typename T>
struct Args {
  const T *qm, *km, *q, *k, *v, *out, *dout;
  const float *den1, *zv, *zd;
  float *dnum, *dden, *dhv, *dhd;
  T *dqm, *dkm, *dq, *dk, *dv;
  float *dqm_part, *dkm_part, *dv_part, *dzv0, *dzd0;
};

template <bool kLocalExact, int kH, typename T>
cudaError_t run_tiles(const Args<T>& a, int bh, int n, int r, int h, int b, int degree,
                      float scale, cudaStream_t stream) {
  using L = DiagSmem<kLocalExact, kH>;
  cudaError_t err;
  if ((err = allow_smem(grad_query_state<kH, T>, StateSmem<false, kH>::kBytes)) != cudaSuccess ||
      (err = allow_smem(grad_key_state<kH, T>, StateSmem<true, kH>::kBytes)) != cudaSuccess ||
      (err = allow_smem(grad_query_diag<kLocalExact, kH, T>, L::kQBytes)) != cudaSuccess ||
      (err = allow_smem(grad_key_diag<kLocalExact, kH, T>, L::kKBytes)) != cudaSuccess) {
    return err;
  }
  // with local_exact the state kernels write dqm and dkm whole; else a
  // diagonal kernel adds its part to theirs
  T* dqm_final = kLocalExact ? a.dqm : nullptr;
  T* dkm_final = kLocalExact ? a.dkm : nullptr;
  const dim3 sgrid((b + kStateRows - 1) / kStateRows, n / b, bh);
  grad_query_state<kH, T><<<sgrid, kStateThreads, StateSmem<false, kH>::kBytes, stream>>>(
      a.qm, a.dnum, a.dden, a.zv, a.zd, dqm_final, a.dqm_part, n, r, h, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  grad_key_state<kH, T><<<sgrid, kStateThreads, StateSmem<true, kH>::kBytes, stream>>>(
      a.km, a.v, a.dhv, a.dhd, dkm_final, a.dkm_part, a.dv_part, n, r, h, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 dgrid((b + kDiagRows - 1) / kDiagRows, n / b, bh);
  grad_query_diag<kLocalExact, kH, T><<<dgrid, kDiagThreads, L::kQBytes, stream>>>(
      a.qm, a.km, a.q, a.k, a.v, a.dnum, a.dden, a.dqm_part, a.dqm, a.dq, n, r, h, b, degree,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  grad_key_diag<kLocalExact, kH, T><<<dgrid, kDiagThreads, L::kKBytes, stream>>>(
      a.qm, a.km, a.q, a.k, a.v, a.dnum, a.dden, a.dkm_part, a.dv_part, a.dkm, a.dk, a.dv, n, r,
      h, b, degree, scale);
  return cudaGetLastError();
}

cudaError_t run_suffix(float* dhv, float* dhd, float* dzv0, float* dzd0, int bh, int t, int r,
                       int h, cudaStream_t stream) {
  const int rrh = r * r * h, rr = r * r;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dhv) | reinterpret_cast<uintptr_t>(dhd) |
                         reinterpret_cast<uintptr_t>(dzv0) | reinterpret_cast<uintptr_t>(dzd0);
  if (rr % 4 == 0 && (addr & 15) == 0) {   // rr % 4 == 0 makes rrh one too
    const dim3 grid((rrh + rr + 4 * kPrefixThreads - 1) / (4 * kPrefixThreads), bh);
    grad_suffix<float4><<<grid, kPrefixThreads, 0, stream>>>(dhv, dhd, dzv0, dzd0, t, rrh, rr);
  } else {
    const dim3 grid((rrh + rr + kPrefixThreads - 1) / kPrefixThreads, bh);
    grad_suffix<float><<<grid, kPrefixThreads, 0, stream>>>(dhv, dhd, dzv0, dzd0, t, rrh, rr);
  }
  return cudaGetLastError();
}

template <int kH, typename T>
cudaError_t run(const Args<T>& a, int bh, int n, int r, int h, int b, int degree, float scale,
                int local_exact, cudaStream_t s) {
  const int rows = bh * n, t = n / b;
  grad_prep<T><<<(rows + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps, 0, s>>>(
      a.dout, a.out, a.den1, a.dnum, a.dden, rows, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t fold_smem = fold_smem_bytes<2>(h);
  if ((err = allow_smem(grad_fold<T>, fold_smem)) != cudaSuccess) return err;
  grad_fold<T><<<dim3((r * h + r + kFoldCols - 1) / kFoldCols, t, bh), kFoldThreads, fold_smem,
                 s>>>(a.qm, a.dnum, a.dden, a.dhv, a.dhd, n, r, h, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = run_suffix(a.dhv, a.dhd, a.dzv0, a.dzd0, bh, t, r, h, s)) != cudaSuccess) return err;
  return local_exact ? run_tiles<true, kH>(a, bh, n, r, h, b, degree, scale, s)
                     : run_tiles<false, kH>(a, bh, n, r, h, b, degree, scale, s);
}

template <typename T>
cudaError_t run_typed(void* const* p, float* const* f, int bh, int n, int r, int h, int b,
                      int degree, float scale, int local_exact, cudaStream_t s) {
  const Args<T> a{static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
                  static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
                  static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
                  static_cast<const T*>(p[6]), f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                  static_cast<T*>(p[7]), static_cast<T*>(p[8]), static_cast<T*>(p[9]),
                  static_cast<T*>(p[10]), static_cast<T*>(p[11]), f[7], f[8], f[9], f[10],
                  f[11]};
  return h <= 64 ? run<64>(a, bh, n, r, h, b, degree, scale, local_exact, s)
                 : run<128>(a, bh, n, r, h, b, degree, scale, local_exact, s);
}

template <bool kLocalExact, typename T>
void kernel_table_h(KernelInfo (&k)[7], int h) {
  if (h <= 64) {
    kernel_table<kLocalExact, 64, T>(k, h);
  } else {
    kernel_table<kLocalExact, 128, T>(k, h);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous tensors: qm, km, dqm, dkm (bh, n, r); q, k, v, out, dout,
// dq, dk, dv (bh, n, h) of one type T (dtype 0 = float32, 1 = bfloat16);
// the rest float32: den1 (bh, n); zv (bh, n/b, r, r*h) and zd (bh, n/b, r,
// r), the forward's exclusive prefix of every block; dnum (bh, n, h), dden
// (bh, n), dhv and dhd (as zv and zd), dv_part (bh, n, h) and, without
// local_exact, dqm_part and dkm_part (bh, n, r), all scratch (for float32
// the three parts may be dv, dqm and dkm themselves); dzv0 (bh, r, r*h),
// dzd0 (bh, r, r). Without local_exact, dq and dk are not written.
// Requires n % b == 0, r <= 32, h <= 128. Returns the first CUDA error (0
// on success); launches on `stream` and does not synchronise.
extern "C" int polysketch_causal_backward(
    const void* qm, const void* km, const void* q, const void* k, const void* v,
    const void* out, const void* dout, const float* den1, const float* zv, const float* zd,
    float* dnum, float* dden, float* dhv, float* dhd, void* dqm, void* dkm, void* dq, void* dk,
    void* dv, float* dqm_part, float* dkm_part, float* dv_part, float* dzv0, float* dzd0,
    int bh, int n, int r, int h, int b, int degree, float scale, int local_exact, int dtype,
    void* stream) {
  if (bh <= 0 || n <= 0 || b <= 0 || n % b != 0 || r <= 0 || r > kBwdR || h < 1 || h > 128 ||
      degree < 1 || bh > 65535 || n / b > 65535 || dv_part == nullptr ||
      (!local_exact && (dqm_part == nullptr || dkm_part == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  void* const p[12] = {const_cast<void*>(qm), const_cast<void*>(km), const_cast<void*>(q),
                       const_cast<void*>(k), const_cast<void*>(v), const_cast<void*>(out),
                       const_cast<void*>(dout), dqm, dkm, dq, dk, dv};
  float* const f[12] = {const_cast<float*>(den1), const_cast<float*>(zv),
                        const_cast<float*>(zd), dnum, dden, dhv, dhd, dqm_part, dkm_part,
                        dv_part, dzv0, dzd0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)run_typed<float>(p, f, bh, n, r, h, b, degree, scale, local_exact, s);
  }
  if (dtype == 1) {
    return (int)run_typed<__nv_bfloat16>(p, f, bh, n, r, h, b, degree, scale, local_exact, s);
  }
  return (int)cudaErrorInvalidValue;
}

// What each kernel of the backward holds on the card, in launch order
// (grad_prep, grad_fold, grad_suffix, grad_query_state, grad_key_state,
// grad_query_diag, grad_key_diag) at head width h (the 64 or the 128
// instantiation) for operands of type dtype: five ints each into out[7 *
// 5] (registers a thread, local memory bytes a thread, dynamic shared
// memory bytes a CTA, threads a CTA, CTAs resident an SM). Returns the
// first CUDA error (0 on success).
extern "C" int polysketch_causal_backward_occupancy(int local_exact, int h, int dtype, int* out) {
  KernelInfo k[7];
  if (dtype == 1) {
    if (local_exact) {
      kernel_table_h<true, __nv_bfloat16>(k, h);
    } else {
      kernel_table_h<false, __nv_bfloat16>(k, h);
    }
  } else if (local_exact) {
    kernel_table_h<true, float>(k, h);
  } else {
    kernel_table_h<false, float>(k, h);
  }
  for (int i = 0; i < 7; ++i) {
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
