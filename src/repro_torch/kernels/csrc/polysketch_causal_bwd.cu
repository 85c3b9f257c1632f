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
// Only float32 is taken in this slice.

#include <stddef.h>

#include "common.cuh"
#include "polysketch_state.cuh"
#include "wgmma_planes.cuh"

namespace {

constexpr int kBwdR = 32;             // sketch width r, zero-padded (r <= 32)
constexpr int kBwdH = 64;             // head width h, zero-padded (h <= 64)
constexpr int kBwdKg = kBwdH + 8;     // [Y | y | 0]: y at column kBwdH
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

template <int kN>
__device__ __forceinline__ void zero(float (&x)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
}

// The warp's A fragments of rows `row` and `row + 8` of a tile, columns
// 8kk + t and 8kk + t + 4 of a `width`-wide row-major matrix (stride
// `width`), zero past `rows` and `width`.
template <int kKS>
__device__ __forceinline__ void load_a(float (&a)[kKS][4], const float* src, int row, int rows,
                                       int width) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = row + 8 * (i & 1), c = 8 * kk + t + 4 * (i >> 1);
      a[kk][i] = rr < rows && c < width ? src[(size_t)rr * width + c] : 0.f;
    }
  }
}

// The warp's A fragments of [Y | y | 0] (kBwdKg columns): Y `width` wide,
// y at column kBwdH from `last` or, when last is null, 1 for rows < rows.
__device__ __forceinline__ void load_a_y1(float (&a)[kBwdKg / 8][4], const float* y,
                                          const float* last, int row, int rows, int width) {
  load_a<kBwdH / 8>(reinterpret_cast<float(&)[kBwdH / 8][4]>(a), y, row, rows, width);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = row + 8 * (i & 1);
    const bool at_y = t == 0 && i < 2;   // column kBwdH = 8 * 8 + 0
    a[kBwdKg / 8 - 1][i] =
        at_y && rr < rows ? (last == nullptr ? 1.f : last[rr]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// grad_prep: g = [dO / D | -(dO . out) / D], one warp a row.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * kPrepWarps)
grad_prep(const float* __restrict__ dout, const float* __restrict__ out,
          const float* __restrict__ den1, float* __restrict__ dnum, float* __restrict__ dden,
          int rows, int h) {
  prep_row<kPrepWarps>(dout, out, den1, dnum, dden, rows, h);
}

// grad_fold and grad_suffix: the forward's fold and prefix scan under the
// backward's own names (see the header).
__global__ void __launch_bounds__(kFoldThreads)
grad_fold(const float* __restrict__ qm, const float* __restrict__ dnum,
          const float* __restrict__ dden, float* __restrict__ dhv, float* __restrict__ dhd,
          int n, int r, int h, int b) {
  fold_block<float, 2>(qm, dnum, dden, dhv, dhd, n, r, h, b);
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
// kBwdH): the raw tile kBwdR x raw_stride(17), split into the direct plane
// PZ (c x d, for N = W Y[e]^T) and, for the key side, the transposed PZt
// (d x c, for Phi_e(x) Yv[e]).
// ---------------------------------------------------------------------------

using PZ = Plane<kBwdR, kBwdKg, false>;
using PZt = Plane<kBwdH, kBwdR, true>;
constexpr int kZNC = kBwdH / 4 + 1;            // raw chunks a row: Yv, then Yd
constexpr int kZRs = raw_stride(kZNC);
constexpr int kZRaw = kBwdR * kZRs;

template <bool kKey>
struct StateSmem {
  static constexpr int kPlanes = 2 * PZ::kFloats + (kKey ? 2 * PZt::kFloats : 0);
  static constexpr int kFloats =
      kZRing * kZRaw + 2 * kPlanes + kStateRows * (kSks + kDxs);
  static constexpr size_t kBytes = (size_t)kFloats * sizeof(float);
};

// Issue the copies of stage e of a state (zv (., r, r*h), zd (., r, r); state
// index `state`) into raw slot `raw`, and commit them as one group.
__device__ __forceinline__ void issue_state(float* raw, const float* zv, const float* zd,
                                            size_t state, int e, int r, int h, bool vec) {
  const size_t zrow = state * r + e;
  const float* yv = zv + zrow * r * h;
  const float* yd = zd + zrow * r;
  for_chunks<kStateThreads, kBwdR, kZNC>([&](int c, int chunk) {
    if (c >= r) return;
    if (chunk < kZNC - 1) {
      copy_chunk(raw + c * kZRs, yv + (size_t)c * h, chunk, h, vec);
    } else {
      cp_async4(raw + c * kZRs + kBwdH, yd + c, true);
    }
  });
  cp_async_commit();
}

// Split this thread's chunks of a raw state stage into the planes.
template <bool kKey>
__device__ __forceinline__ void split_state(const float* raw, float* p, int r, int h) {
  float* z_hi = p;
  float* z_lo = z_hi + PZ::kFloats;
  float* t_hi = z_lo + PZ::kFloats;
  float* t_lo = t_hi + PZt::kFloats;
  for_chunks<kStateThreads, kBwdR, kZNC>([&](int c, int chunk) {
    const float* row = raw + c * kZRs;
    if (chunk < kZNC - 1) {
      const float4 x = read_chunk(row, chunk, h, c < r);
      put4(z_hi, z_lo, PZ::off(c, 4 * chunk), x);
      if (kKey) put_t<PZt, false>(t_hi, t_lo, c, 4 * chunk, x);
    } else {
      put4(z_hi, z_lo, PZ::off(c, kBwdH), make_float4(c < r ? row[kBwdH] : 0.f, 0.f, 0.f, 0.f));
    }
  });
}

// The gradient of x through one row block e, for the warp's 16 rows: with
// N[row, c] = nb (accumulator layout),
//   dx[row, e] = sum_c N[row, c] x[row, c]   -> dx_s[row][e] (the quad's first thread)
//   dx[row, c] += x[row, e] N[row, c]        -> acc
// xa: the thread's x[row, 8 (j / 2) + 2t + (j & 1)], rows g and g + 8;
// xe: x[row, e].
__device__ __forceinline__ void sym_contract(float (&acc)[kBwdR / 8][4],
                                             const float (&nb)[kBwdR / 8][4], float* dx_s,
                                             int e, const float (&xa)[2][kBwdR / 4],
                                             const float (&xe)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kBwdR / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      part[c >> 1] += nb[nt][c] * xa[c >> 1][2 * nt + (c & 1)];
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
template <bool kKey>
__device__ __forceinline__ void state_tile(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           const float* __restrict__ wlast,
                                           const float* __restrict__ zv,
                                           const float* __restrict__ zd, float* __restrict__ dx,
                                           float* __restrict__ dv, int n, int r, int h, int b) {
  const int l = blockIdx.y, t = gridDim.y, bh = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;
  const int r0 = blockIdx.x * kStateRows, rows = min(kStateRows, b - r0);
  const size_t row0 = (size_t)bh * n + (size_t)l * b + r0;
  if (kKey && l + 1 == t) {   // dH of the last block is zero
    for (int i = threadIdx.x; i < rows * r; i += kStateThreads) dx[row0 * r + i] = 0.f;
    for (int i = threadIdx.x; i < rows * h; i += kStateThreads) dv[row0 * h + i] = 0.f;
    return;
  }
  using L = StateSmem<kKey>;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                                   // kZRing x kZRaw
  float* planes = raw + kZRing * kZRaw;                // 2 x L::kPlanes
  float* x_s = planes + 2 * L::kPlanes;                // kStateRows x kSks
  float* dx_s = x_s + kStateRows * kSks;               // kStateRows x kDxs

  // PZ's last chunk (columns kBwdH + 4 ..) and x_s's columns past r stay
  // zero: no copy or split writes them.
  for (int i = threadIdx.x; i < 4 * PZ::kCS; i += kStateThreads) {
    const int j = i / PZ::kCS;   // buffer j / 2, hi or lo plane j % 2
    planes[(j >> 1) * L::kPlanes + (j & 1) * PZ::kFloats + (kBwdKg / 4 - 1) * PZ::kCS +
           i % PZ::kCS] = 0.f;
  }
  zero_pad_cols<kStateThreads>(x_s, kStateRows, r, kSks);
  stage_rows<kStateThreads>(x_s, x + row0 * r, rows, kStateRows, r, kSks);
  const size_t state = (size_t)bh * t + l;
  const bool vec = vec_ok(zv, h);
  issue_state(raw, zv, zd, state, 0, r, h, vec);       // closes the group of x_s
  if (r > 1) issue_state(raw + kZRaw, zv, zd, state, 1, r, h, vec);

  // The warp's rows of W = [w | wlast or 1], split once for all r stages.
  FragA wa[kBwdKg / 8];
  {
    float a[kBwdKg / 8][4];
    load_a_y1(a, w + row0 * h + (size_t)wrow * h, wlast == nullptr ? nullptr : wlast + row0 + wrow,
              g, rows - wrow, h);
#pragma unroll
    for (int kk = 0; kk < kBwdKg / 8; ++kk) {
      wa[kk] = split_a(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
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
  split_state<kKey>(raw, planes, r, h);
  if (r > 2) issue_state(raw + 2 * kZRaw, zv, zd, state, 2, r, h, vec);
  fence_async_smem();
  __syncthreads();
  float xa[2][kBwdR / 4], xk[2][kBwdR / 4];   // accumulator layout; A layout (c = t + 4j)
#pragma unroll
  for (int j = 0; j < kBwdR / 4; ++j) {
    const int c = (j >> 1) * 8 + 2 * t4 + (j & 1);
    xa[0][j] = x_s[(wrow + g) * kSks + c];
    xa[1][j] = x_s[(wrow + g + 8) * kSks + c];
    xk[0][j] = x_s[(wrow + g) * kSks + t4 + 4 * j];
    xk[1][j] = x_s[(wrow + g + 8) * kSks + t4 + 4 * j];
  }
  float acc[kBwdR / 8][4], dva[kBwdH / 8][4];
  zero(acc);
  zero(dva);
  for (int e = 0; e < r; ++e) {
    const float* p = planes + (e & 1) * L::kPlanes;
    const float* t_hi = p + 2 * PZ::kFloats;
    const float xe[2] = {x_s[(wrow + g) * kSks + e], x_s[(wrow + g + 8) * kSks + e]};
    // Phi_e(km) as the cross product's A operand: A[row, c] = km[row, e] km[row, c]
    FragA phi[kBwdR / 8];
    if (kKey) {
#pragma unroll
      for (int kk = 0; kk < kBwdR / 8; ++kk) {
        phi[kk] = split_a(xe[0] * xk[0][2 * kk], xe[1] * xk[1][2 * kk],
                          xe[0] * xk[0][2 * kk + 1], xe[1] * xk[1][2 * kk + 1]);
      }
    }
    // N = W Y[e]^T beside dv += Phi_e(km) dHv[e], the two chains' wgmma
    // alternating
    float nb[kBwdR / 8][4];
    zero(nb);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdKg / 8; ++kk) {
      const uint64_t dh = plane_desc<PZ>(p + 2 * kk * PZ::kCS);
      const uint64_t dl = plane_desc<PZ>(p + PZ::kFloats + 2 * kk * PZ::kCS);
      const int kc = kk >> 1;   // the cross product's k-step beside this pair
      const bool cross = kKey && (kk & 1) == 0 && kc < kBwdR / 8;
      const uint64_t th = cross ? plane_desc<PZt>(t_hi + 2 * kc * PZt::kCS) : 0;
      const uint64_t tl = cross ? plane_desc<PZt>(t_hi + PZt::kFloats + 2 * kc * PZt::kCS) : 0;
      wg_mma(nb, wa[kk].lo, dh);
      if (cross) wg_mma(dva, phi[kc].lo, th);
      wg_mma(nb, wa[kk].hi, dl);
      if (cross) wg_mma(dva, phi[kc].hi, tl);
      wg_mma(nb, wa[kk].hi, dh);
      if (cross) wg_mma(dva, phi[kc].hi, th);
    }
    wg_commit();
    if (e + 1 < r) {
      if (e + 2 < r) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      split_state<kKey>(raw + ((e + 1) % kZRing) * kZRaw, planes + ((e + 1) & 1) * L::kPlanes,
                        r, h);
      if (e + 3 < r) {
        issue_state(raw + ((e + 3) % kZRing) * kZRaw, zv, zd, state, e + 3, r, h, vec);
      }
    }
    wg_wait();
    reg_fence(nb);
    if (kKey) reg_fence(dva);
    sym_contract(acc, nb, dx_s + wrow * kDxs, e, xa, xe);
    fence_async_smem();
    __syncthreads();   // planes (e + 1) & 1 complete; planes e & 1 free
  }
  __syncwarp();
#pragma unroll
  for (int nd = 0; nd < kBwdR / 8; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
      if (row < rows && col < r) dx[(row0 + row) * r + col] = acc[nd][c] + dx_s[row * kDxs + col];
    }
  }
  if (kKey) {
#pragma unroll
    for (int nd = 0; nd < kBwdH / 8; ++nd) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
        if (row < rows && col < h) dv[(row0 + row) * h + col] = dva[nd][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kStateThreads)
grad_query_state(const float* __restrict__ qm, const float* __restrict__ dnum,
                 const float* __restrict__ dden, const float* __restrict__ zv,
                 const float* __restrict__ zd, float* __restrict__ dqm, int n, int r, int h,
                 int b) {
  state_tile<false>(qm, dnum, dden, zv, zd, dqm, nullptr, n, r, h, b);
}

__global__ void __launch_bounds__(kStateThreads)
grad_key_state(const float* __restrict__ km, const float* __restrict__ v,
               const float* __restrict__ dhv, const float* __restrict__ dhd,
               float* __restrict__ dkm, float* __restrict__ dv, int n, int r, int h, int b) {
  state_tile<true>(km, v, nullptr, dhv, dhd, dkm, dv, n, r, h, b);
}

// ---------------------------------------------------------------------------
// The diagonal kernels. A CTA owns 128 rows of block l (its A operands stay
// in registers, split per k-step) and streams the other side's rows of the
// block kStage at a time: a raw tile copied with cp.async (two slots), then
// split into one of two plane sets while the last products of the stage
// before run on the other; one __syncthreads a stage.
// ---------------------------------------------------------------------------

template <bool kLocalExact>
struct DiagSmem {
  static constexpr int kF = kLocalExact ? kBwdH : kBwdR;   // the scores' features
  using PF = Plane<kStage, kF, false>;       // the other side's features: S's B
  using PFt = Plane<kF, kStage, true>;       // transposed, permuted: dq's / dk's B
  using PY = Plane<kStage, kBwdKg, false>;   // [V | 1] or [dNum | dDen]: dW's B
  using PYt = Plane<kBwdH, kStage, true>;    // dNum transposed, permuted: dv's B
  static constexpr int kFNC = kF / 4, kYNC = kBwdH / 4 + 1;
  static constexpr int kFRs = raw_stride(kFNC), kYRs = raw_stride(kYNC);
  static constexpr int kRaw = kStage * (kFRs + kYRs);
  static constexpr int kQPlanes = 2 * (PF::kFloats + PFt::kFloats + PY::kFloats);
  static constexpr int kKPlanes = kQPlanes + 2 * PYt::kFloats;
  // two sets of planes (the next stage is split under this one's products)
  // and two raw slots
  static constexpr size_t kQBytes = (size_t)(2 * kQPlanes + 2 * kRaw) * sizeof(float);
  static constexpr size_t kKBytes = (size_t)(2 * kKPlanes + 2 * kRaw) * sizeof(float);
};

// Issue the copies of stage rows [s0, s0 + rows) into a raw slot: the
// features (f wide) and Y (h wide) beside y (from `last`, or nothing when
// y is the ones column).
template <bool kLocalExact>
__device__ __forceinline__ void issue_diag(float* raw, const float* feat, int f, bool fvec,
                                           const float* y, const float* last, int h, bool yvec,
                                           int rows) {
  using L = DiagSmem<kLocalExact>;
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
      cp_async4(ry + row * L::kYRs + kBwdH, last + row, true);
    }
  });
  cp_async_commit();
}

// Split this thread's chunks of a raw slot into the planes at p: PF and
// PFt from the features, PY from [Y | y] (y the ones column when `ones`),
// and PYt from Y when kYt.
template <bool kLocalExact, bool kYt>
__device__ __forceinline__ void split_diag(const float* raw, float* p, int f, int h, int rows,
                                           bool ones) {
  using L = DiagSmem<kLocalExact>;
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
      const float y = row < rows ? (ones ? 1.f : ry[row * L::kYRs + kBwdH]) : 0.f;
      put4(y_hi, y_lo, PY::off(row, kBwdH), make_float4(y, 0.f, 0.f, 0.f));
    }
  });
}

// grad_query_diag: dq (or dqm's diagonal part) of one 128-query tile of
// block l. grid (ceil(b / 128), t, bh), the last tile (most key stages)
// first; warp w owns query rows 16w .. 16w + 15.
template <bool kLocalExact>
__global__ void __launch_bounds__(kDiagThreads, 1)
grad_query_diag(const float* __restrict__ qm, const float* __restrict__ km,
                const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dnum,
                const float* __restrict__ dden, float* __restrict__ dqm, float* __restrict__ dq,
                int n, int r, int h, int b, int degree, float scale) {
  using L = DiagSmem<kLocalExact>;
  constexpr int kF = L::kF;
  const int qt = gridDim.x - 1 - blockIdx.x, l = blockIdx.y, bh = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16, wg0 = (threadIdx.x >> 7) * 64;
  const int q0 = qt * kDiagRows, qrows = min(kDiagRows, b - q0);
  const int f = kLocalExact ? h : r;
  extern __shared__ __align__(16) float smem[];
  float* planes = smem;                    // 2 sets of L::kQPlanes
  float* raw = smem + 2 * L::kQPlanes;     // 2 slots of L::kRaw

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const float* kf = (kLocalExact ? k : km) + row0 * f;
  const float* vb = v + row0 * h;
  const bool fvec = vec_ok(kf, f), yvec = vec_ok(vb, h);
  const auto issue = [&](int st) {   // key stage st into raw slot st & 1
    const int k0 = st * kStage;
    issue_diag<kLocalExact>(raw + (st & 1) * L::kRaw, kf + (size_t)k0 * f, f, fvec,
                            vb + (size_t)k0 * h, nullptr, h, yvec, min(kStage, b - k0));
  };
  const auto split = [&](int st) {   // raw slot st & 1 into plane set st & 1
    split_diag<kLocalExact, false>(raw + (st & 1) * L::kRaw, planes + (st & 1) * L::kQPlanes, f,
                                   h, min(kStage, b - st * kStage), true);
  };
  for (int i = threadIdx.x; i < 2 * L::kQPlanes; i += kDiagThreads) planes[i] = 0.f;
  issue(0);

  float qa[kF / 8][4], ga[kBwdKg / 8][4];
  load_a<kF / 8>(qa, (kLocalExact ? q : qm) + (row0 + q0 + wrow) * f, g, qrows - wrow, f);
  load_a_y1(ga, dnum + (row0 + q0 + wrow) * h, dden + row0 + q0 + wrow, g, qrows - wrow, h);

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
    const float* k_hi = planes + (st & 1) * L::kQPlanes;
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
      wg_pair<false, kStage / 8, kF / 8, typename L::PF, kStage / 8, kBwdKg / 8,
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
          dq[i] = acc[nd][c];
        } else {
          dqm[i] += acc[nd][c];
        }
      }
    }
  }
}

// grad_key_diag: dk (or dkm's diagonal part) and dv's diagonal part of one
// 128-key tile of block l. grid (ceil(b / 128), t, bh), the first tile (most
// query stages) first; warp w owns keys 16w .. 16w + 15.
template <bool kLocalExact>
__global__ void __launch_bounds__(kDiagThreads, 1)
grad_key_diag(const float* __restrict__ qm, const float* __restrict__ km,
              const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dnum,
              const float* __restrict__ dden, float* __restrict__ dkm, float* __restrict__ dk,
              float* __restrict__ dv, int n, int r, int h, int b, int degree, float scale) {
  using L = DiagSmem<kLocalExact>;
  constexpr int kF = L::kF;
  const int kt = blockIdx.x, l = blockIdx.y, bh = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16, wg0 = (threadIdx.x >> 7) * 64;
  const int k0 = kt * kDiagRows, krows = min(kDiagRows, b - k0);
  const int f = kLocalExact ? h : r;
  extern __shared__ __align__(16) float smem[];
  float* planes = smem;                    // 2 sets of L::kKPlanes
  float* raw = smem + 2 * L::kKPlanes;     // 2 slots of L::kRaw

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const float* qf = (kLocalExact ? q : qm) + row0 * f;
  const float* gb = dnum + row0 * h;
  const float* db = dden + row0;
  const bool fvec = vec_ok(qf, f), yvec = vec_ok(gb, h);
  const int st0 = k0 / kStage, nst = (b + kStage - 1) / kStage;
  const auto issue = [&](int st) {   // query stage st into raw slot (st - st0) & 1
    const int s0 = st * kStage;
    issue_diag<kLocalExact>(raw + ((st - st0) & 1) * L::kRaw, qf + (size_t)s0 * f, f, fvec,
                            gb + (size_t)s0 * h, db + s0, h, yvec, min(kStage, b - s0));
  };
  const auto split = [&](int st) {   // raw slot (st - st0) & 1 into plane set (st - st0) & 1
    split_diag<kLocalExact, true>(raw + ((st - st0) & 1) * L::kRaw,
                                  planes + ((st - st0) & 1) * L::kKPlanes, f, h,
                                  min(kStage, b - st * kStage), false);
  };
  for (int i = threadIdx.x; i < 2 * L::kKPlanes; i += kDiagThreads) planes[i] = 0.f;
  issue(st0);

  float ka[kF / 8][4];
  load_a<kF / 8>(ka, (kLocalExact ? k : km) + (row0 + k0 + wrow) * f, g, krows - wrow, f);

  float dva[kBwdH / 8][4], dka[kF / 8][4];
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
    const float* q_hi = planes + ((st - st0) & 1) * L::kKPlanes;
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
      float va[kBwdKg / 8][4];
      load_a_y1(va, v + (row0 + k0 + wrow) * h, nullptr, g, krows - wrow, h);
      wg_pair<false, kStage / 8, kF / 8, typename L::PF, kStage / 8, kBwdKg / 8,
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
      wg_pair<true, kBwdH / 8, kStage / 8, typename L::PYt, kF / 8, kStage / 8,
              typename L::PFt>(dva, s, gt_hi, gt_lo, dka, w, qt_hi, qt_lo);
      wg_commit();
    }
    if (st + 1 < nst) {   // the next stage, split while dv's and dk's last products run
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
  for (int nd = 0; nd < kBwdH / 8; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
      if (row < krows && col < h) {
        const size_t i = (row0 + k0 + row) * h + col;
        dv[i] += dva[nd][c];
        if (kLocalExact) dk[i] = dka[nd][c];
      }
    }
  }
  if (!kLocalExact) {
#pragma unroll
    for (int nd = 0; nd < kF / 8; ++nd) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
        if (row < krows && col < r) dkm[(row0 + k0 + row) * r + col] += dka[nd][c];
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

template <bool kLocalExact>
void kernel_table(KernelInfo (&k)[7], int h) {
  using L = DiagSmem<kLocalExact>;
  k[0] = {(const void*)grad_prep, 32 * kPrepWarps, 0};
  k[1] = {(const void*)grad_fold, kFoldThreads, fold_smem_bytes<2>(h)};
  k[2] = {(const void*)grad_suffix<float4>, kPrefixThreads, 0};
  k[3] = {(const void*)grad_query_state, kStateThreads, StateSmem<false>::kBytes};
  k[4] = {(const void*)grad_key_state, kStateThreads, StateSmem<true>::kBytes};
  k[5] = {(const void*)grad_query_diag<kLocalExact>, kDiagThreads, L::kQBytes};
  k[6] = {(const void*)grad_key_diag<kLocalExact>, kDiagThreads, L::kKBytes};
}

template <bool kLocalExact>
cudaError_t run_tiles(const float* qm, const float* km, const float* q, const float* k,
                      const float* v, const float* dnum, const float* dden, const float* zv,
                      const float* zd, const float* dhv, const float* dhd, float* dqm,
                      float* dkm, float* dq, float* dk, float* dv, int bh, int n, int r, int h,
                      int b, int degree, float scale, cudaStream_t stream) {
  using L = DiagSmem<kLocalExact>;
  cudaError_t err;
  if ((err = allow_smem(grad_query_state, StateSmem<false>::kBytes)) != cudaSuccess ||
      (err = allow_smem(grad_key_state, StateSmem<true>::kBytes)) != cudaSuccess ||
      (err = allow_smem(grad_query_diag<kLocalExact>, L::kQBytes)) != cudaSuccess ||
      (err = allow_smem(grad_key_diag<kLocalExact>, L::kKBytes)) != cudaSuccess) {
    return err;
  }
  const dim3 sgrid((b + kStateRows - 1) / kStateRows, n / b, bh);
  grad_query_state<<<sgrid, kStateThreads, StateSmem<false>::kBytes, stream>>>(
      qm, dnum, dden, zv, zd, dqm, n, r, h, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  grad_key_state<<<sgrid, kStateThreads, StateSmem<true>::kBytes, stream>>>(
      km, v, dhv, dhd, dkm, dv, n, r, h, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 dgrid((b + kDiagRows - 1) / kDiagRows, n / b, bh);
  grad_query_diag<kLocalExact><<<dgrid, kDiagThreads, L::kQBytes, stream>>>(
      qm, km, q, k, v, dnum, dden, dqm, dq, n, r, h, b, degree, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  grad_key_diag<kLocalExact><<<dgrid, kDiagThreads, L::kKBytes, stream>>>(
      qm, km, q, k, v, dnum, dden, dkm, dk, dv, n, r, h, b, degree, scale);
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

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous float32 tensors: qm, km, dqm, dkm (bh, n, r); q, k, v, out,
// dout, dq, dk, dv, dnum (bh, n, h); den1, dden (bh, n); zv, dhv (bh, n/b,
// r, r*h) and zd, dhd (bh, n/b, r, r), zv/zd the forward's exclusive prefix
// of every block; dzv0 (bh, r, r*h), dzd0 (bh, r, r). dnum, dden, dhv and
// dhd are scratch. Without local_exact, dq and dk are not written. Requires
// n % b == 0, r <= 32, h <= 64. Returns the first CUDA error (0 on
// success); launches on `stream` and does not synchronise.
extern "C" int polysketch_causal_backward(
    const float* qm, const float* km, const float* q, const float* k, const float* v,
    const float* out, const float* dout, const float* den1, const float* zv, const float* zd,
    float* dnum, float* dden, float* dhv, float* dhd, float* dqm, float* dkm, float* dq,
    float* dk, float* dv, float* dzv0, float* dzd0, int bh, int n, int r, int h, int b,
    int degree, float scale, int local_exact, void* stream) {
  if (bh <= 0 || n <= 0 || b <= 0 || n % b != 0 || r <= 0 || r > kBwdR || h < 1 ||
      h > kBwdH || degree < 1 || bh > 65535 || n / b > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = bh * n, t = n / b;
  grad_prep<<<(rows + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps, 0, s>>>(
      dout, out, den1, dnum, dden, rows, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t fold_smem = fold_smem_bytes<2>(h);
  if ((err = allow_smem(grad_fold, fold_smem)) != cudaSuccess) return (int)err;
  grad_fold<<<dim3((r * h + r + kFoldCols - 1) / kFoldCols, t, bh), kFoldThreads, fold_smem, s>>>(
      qm, dnum, dden, dhv, dhd, n, r, h, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = run_suffix(dhv, dhd, dzv0, dzd0, bh, t, r, h, s)) != cudaSuccess) return (int)err;
  err = local_exact
            ? run_tiles<true>(qm, km, q, k, v, dnum, dden, zv, zd, dhv, dhd, dqm, dkm, dq, dk,
                              dv, bh, n, r, h, b, degree, scale, s)
            : run_tiles<false>(qm, km, q, k, v, dnum, dden, zv, zd, dhv, dhd, dqm, dkm, dq,
                               dk, dv, bh, n, r, h, b, degree, scale, s);
  return (int)err;
}

// What each kernel of the backward holds on the card, in launch order
// (grad_prep, grad_fold, grad_suffix, grad_query_state, grad_key_state,
// grad_query_diag, grad_key_diag) at head width h: five ints each into
// out[7 * 5] (registers a thread, local memory bytes a thread, dynamic
// shared memory bytes a CTA, threads a CTA, CTAs resident an SM). Returns
// the first CUDA error (0 on success).
extern "C" int polysketch_causal_backward_occupancy(int local_exact, int h, int* out) {
  KernelInfo k[7];
  if (local_exact) {
    kernel_table<true>(k, h);
  } else {
    kernel_table<false>(k, h);
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
