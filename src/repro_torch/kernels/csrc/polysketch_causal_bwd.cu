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
// Five launches, no atomics, every sum in a fixed order (two calls give
// the same bits):
//   pass 0  prep_kernel: g from dO, out and D (one warp a row).
//   pass 1  fold_kernel (polysketch_state.cuh, shared with the forward):
//           dZ_l = Qm_l^T [Qm_l (x) dNum_l | Qm_l (.) dDen_l], the forward's
//           fold with the ones column replaced by dDen.
//   pass 2  prefix_kernel, right to left from zero: dH_l over dZ_l in
//           place, and dz0.
//   pass 3  query_kernel, (64-query tile, block, bh): dq (or the
//           diagonal's part of dqm) FlashAttention-2 style over the key
//           tiles up to the diagonal, recomputing S; then dqm through Z_l,
//           one row block e at a time: N = G Z_l[e]^T (16 x r a warp, K =
//           h + 1) on the tensor cores, contracted with qm in registers.
//           key_kernel, (64-key tile, block, bh): dk and dv over the query
//           tiles from the diagonal on; then, through dH_l (blocks before
//           the last), dv += Phi(km) dHv (the forward's cross term) and dkm
//           as dqm is made.
// Every product is mma.sync m16n8k8 in 3xTF32 (common.cuh). Tiles are
// zero-padded to compile-time widths (r <= 32, h <= 64), so each loop has a
// fixed trip count; dNum and V carry dDen and the ones column at column 64,
// so dW = G V1^T is one product of K = 72. Z_l and dH_l (r^2 (h + 1) f32,
// 266 KB at r 32, h 64: more than an SM's 227 KB) are streamed two row
// blocks at a time through a ring that reuses the diagonal's tile rings.
//
// What bounds it. At the training shape (bh 24, n 4096, r 32, h 64, b 1024,
// f32) the function needs ~78 GFLOP of products: four r^2-wide ones (the
// fold, M, N and Phi(km) dHv; the last two only for the three blocks
// before the last) and five over the diagonal's pairs (S, dW, dq, dk, dv).
// In 3xTF32 at 495 TFLOP/s that is ~0.49 ms, bound by operations (1.2 ms
// on the f32 FMA pipes); chip_smoke.py's b1_bwd_bound counts it from the
// shapes. This design does ~13 GFLOP more: the query and the key kernel
// each rebuild S and dW, so that neither needs atomics.
// Only float32 is taken in this slice.

#include <stddef.h>

#include "common.cuh"
#include "polysketch_state.cuh"

namespace {

constexpr int kBwdR = 32;             // sketch width r, zero-padded (r <= 32)
constexpr int kBwdH = 64;             // head width h, zero-padded (h <= 64)
constexpr int kBwdKg = kBwdH + 8;     // [Y | y | 0]: y at column kBwdH
constexpr int kZPer = 2;              // state row blocks per staged chunk
constexpr int kDxs = kBwdR + 1;       // row stride of the dx scratch
constexpr int kPrepWarps = 8;
constexpr int kGs = pair_frag_stride(kBwdKg);   // stride of G, V1 and state tiles
constexpr int kMs = pair_frag_stride(kBwdR);    // stride of sketch tiles

template <int kN>
__device__ __forceinline__ void zero(float (&x)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
}

// x^p for p >= 0 by repeated squaring (x^0 = 1), in PowWeight's order.
__device__ __forceinline__ float pow_int(float x, int p) {
  float w = 1.f;
  bool have = false;
  while (p > 0) {
    if (p & 1) {
      w = have ? w * x : x;
      have = true;
    }
    p >>= 1;
    if (p > 0) x *= x;
  }
  return w;
}

// s[nt] += A B^T for the calling warp in 3xTF32: A = 16 rows at a (stride
// as), B = 8 kN rows at b (stride bs), over kK columns (a multiple of 8,
// zero past the data in both). s[nt][c] is element (g + 8 (c >> 1),
// 8 nt + 2t + (c & 1)).
template <int kN, int kK>
__device__ __forceinline__ void warp_abt(float (&s)[kN][4], const float* a, int as,
                                         const float* b, int bs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* pa = a + g * as + t;
  const float* pb = b + g * bs + t;
#pragma unroll
  for (int kk = 0; kk < kK; kk += 8) {
    const FragA fa = split_a(pa[kk], pa[kk + 8 * as], pa[kk + 4], pa[kk + 8 * as + 4]);
    FragB fb[kN];
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) {
      fb[nt] = split_b(pb[nt * 8 * bs + kk], pb[nt * 8 * bs + kk + 4]);
    }
    mma_3xtf32(s, 0, fa, fb, kN);
  }
}

// acc[nd] += S B for the calling warp: S is the 16 x 64 accumulator s taken
// as the A operand in place (k index t stands for column 2t of each group of
// 8, t + 4 for 2t + 1, as tc_tile_accumulate takes W), B = 64 rows at b
// (stride bs), n-tiles nd < kNO.
template <int kNO>
__device__ __forceinline__ void warp_sb(float (&acc)[kNO][4], const float (&s)[8][4],
                                        const float* b, int bs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const FragA a = split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
    mma_3xtf32_cols(acc, a, b + (kk * 8 + 2 * t) * bs + g, bs, kNO);
  }
}

// The gradient of x through row block e of a state Y (rows c < kBwdR at
// slot, columns d < kBwdKg, stride kGs), for the warp's 16 rows: with
// N[row, c] = sum_d Y[e, c, d] w[row, d] (w: the warp's rows of [W | w],
// stride kGs),
//   dx[row, e] = sum_c N[row, c] x[row, c]   -> dx_s[row][e] (the quad's first thread)
//   dx[row, c] += x[row, e] N[row, c]        -> acc (accumulator layout)
// xa: the thread's x[row, 8 (j / 2) + 2t + (j & 1)], rows g and g + 8;
// xe: x[row, e].
__device__ __forceinline__ void sym_block(float (&acc)[kBwdR / 8][4], float* dx_s, int e,
                                          const float* w, const float* slot,
                                          const float (&xa)[2][kBwdR / 4],
                                          const float (&xe)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float nb[kBwdR / 8][4];
  zero(nb);
  warp_abt<kBwdR / 8, kBwdKg>(nb, w, kGs, slot, kGs);
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

// Stage the r row blocks [e0, e0 + ne) of a state (zv (., r, r*h), zd
// (., r, r), state index `state`) into slots of kBwdR x kGs: [c][d] = Yv[e,
// c*h + d], [c][kBwdH] = Yd[e, c]. The rest of each slot stays as zeroed.
__device__ __forceinline__ void stage_state(float* zb, const float* zv, const float* zd,
                                            size_t state, int e0, int ne, int r, int h) {
  for (int i = 0; i < ne; ++i) {
    const size_t zrow = state * r + e0 + i;
    float* slot = zb + i * kBwdR * kGs;
    stage_rows<kTcThreads>(slot, zv + zrow * r * h, r, r, h, kGs);
    for (int c = threadIdx.x; c < r; c += kTcThreads) {
      cp_async4(slot + c * kGs + kBwdH, zd + zrow * r + c, true);
    }
  }
  cp_async_commit();
}

// Stage `rows` rows of dNum and dDen (from row `row0`) as a kTcTile x kGs
// tile [dNum | dDen at kBwdH], zero past `rows`.
__device__ __forceinline__ void stage_g(float* gd, const float* dnum, const float* dden,
                                        size_t row0, int rows, int h) {
  stage_rows<kTcThreads>(gd, dnum + row0 * h, rows, kTcTile, h, kGs);
  for (int s = threadIdx.x; s < kTcTile; s += kTcThreads) {
    cp_async4(gd + s * kGs + kBwdH, dden + row0 + (s < rows ? s : 0), s < rows);
  }
}

// dS (or W) of one score and its dW at the diagonal: x = s * scale
// (local_exact) or s; dS = p x^(p-1) scale dW, or 2 x dW.
template <bool kLocalExact>
__device__ __forceinline__ float dscore(float s, float dw, int degree, float scale) {
  if (kLocalExact) return (float)degree * pow_int(s * scale, degree - 1) * scale * dw;
  return 2.f * s * dw;
}

// Pass 0: g = [dO / D | -(dO . out) / D], one warp a row.
__global__ void __launch_bounds__(32 * kPrepWarps)
prep_kernel(const float* __restrict__ dout, const float* __restrict__ out,
            const float* __restrict__ den1, float* __restrict__ dnum, float* __restrict__ dden,
            int rows, int h) {
  const int row = blockIdx.x * kPrepWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float inv = 1.f / den1[row];
  const size_t base = (size_t)row * h;
  float dot = 0.f;
  for (int d = lane; d < h; d += 32) {
    const float go = dout[base + d];
    dot += go * out[base + d];
    dnum[base + d] = go * inv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (lane == 0) dden[row] = -dot * inv;
}

// The shared-memory layout of both tile kernels: the CTA's own tile (G or
// V1, the sketch x, the scores' features, dx scratch) and a ring of two of
// the other side's tiles, reused as the state ring after the diagonal.
template <bool kLocalExact>
struct TileSmem {
  static constexpr int kF = kLocalExact ? kBwdH : kBwdR;   // the scores' features
  static constexpr int kFs = pair_frag_stride(kF);
  static constexpr int kOwn = kTcTile * (kGs + kMs + (kLocalExact ? kFs : 0) + kDxs);
  static constexpr int kRing = 2 * kKeyTile * (kFs + kGs);
  static constexpr int kZRing = 2 * kZPer * kBwdR * kGs;
  static constexpr size_t kBytes =
      (size_t)(kOwn + (kRing > kZRing ? kRing : kZRing)) * sizeof(float);
};

// Zero the own tiles' padding and the rings, then wait for every thread:
// the staging that follows rewrites some of the zeroed columns (dDen, the
// ones) with cp.async or plain stores of other threads.
template <bool kLocalExact>
__device__ __forceinline__ void zero_tiles(float* smem) {
  using L = TileSmem<kLocalExact>;
  for (int idx = threadIdx.x; idx < L::kOwn + L::kRing; idx += kTcThreads) smem[idx] = 0.f;
  __syncthreads();
}

// Pass 3a: dqm (and dq) of one 64-query tile of block l. grid (ceil(b/64),
// t, bh), the last tile first; warp w owns rows 16w .. 16w + 15.
template <bool kLocalExact>
__global__ void __launch_bounds__(kTcThreads)
query_kernel(const float* __restrict__ qm, const float* __restrict__ km,
             const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dnum,
             const float* __restrict__ dden, const float* __restrict__ zv,
             const float* __restrict__ zd, float* __restrict__ dqm, float* __restrict__ dq,
             int n, int r, int h, int b, int degree, float scale) {
  using L = TileSmem<kLocalExact>;
  constexpr int kF = L::kF, kFs = L::kFs;
  const int qt = gridDim.x - 1 - blockIdx.x, l = blockIdx.y, bh = blockIdx.z, t = gridDim.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;
  const int q0 = qt * kTcTile, qrows = min(kTcTile, b - q0);
  const int f = kLocalExact ? h : r;
  extern __shared__ __align__(16) float smem[];
  float* g_s = smem;                                        // kTcTile x kGs
  float* qm_s = g_s + kTcTile * kGs;                        // kTcTile x kMs
  float* qf_s = kLocalExact ? qm_s + kTcTile * kMs : qm_s;  // kTcTile x kFs
  float* dx_s = qf_s + kTcTile * kFs;                       // kTcTile x kDxs
  float* k_ring = dx_s + kTcTile * kDxs;                    // 2 x kKeyTile x kFs
  float* v_ring = k_ring + 2 * kKeyTile * kFs;              // 2 x kKeyTile x kGs
  float* z_ring = k_ring;                                   // after the diagonal

  zero_tiles<kLocalExact>(smem);
  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const float* kf_src = kLocalExact ? k : km;
  stage_g(g_s, dnum, dden, row0 + q0, qrows, h);
  stage_rows<kTcThreads>(qm_s, qm + (row0 + q0) * r, qrows, kTcTile, r, kMs);
  if (kLocalExact) stage_rows<kTcThreads>(qf_s, q + (row0 + q0) * h, qrows, kTcTile, h, kFs);

  // ---- diagonal block: dq = dS K over the key tiles up to the diagonal ----
  float acc[kF / 8][4];
  zero(acc);
  const int ktiles = (q0 + qrows + kKeyTile - 1) / kKeyTile;
  const auto stage = [&](int kt) {
    const int k0 = kt * kKeyTile, rows = min(kKeyTile, b - k0);
    float* kd = k_ring + (kt & 1) * kKeyTile * kFs;
    float* vd = v_ring + (kt & 1) * kKeyTile * kGs;
    stage_rows<kTcThreads>(kd, kf_src + (row0 + k0) * f, rows, kKeyTile, f, kFs);
    stage_rows<kTcThreads>(vd, v + (row0 + k0) * h, rows, kKeyTile, h, kGs);
    for (int s = threadIdx.x; s < kKeyTile; s += kTcThreads) {
      vd[s * kGs + kBwdH] = s < rows ? 1.f : 0.f;
    }
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
    const float* k_s = k_ring + (kt & 1) * kKeyTile * kFs;
    const float* v_s = v_ring + (kt & 1) * kKeyTile * kGs;
    float s[8][4], w[8][4];
    zero(s);
    zero(w);
    warp_abt<8, kF>(s, qf_s + wrow * kFs, kFs, k_s, kFs);        // S = Q K^T
    warp_abt<8, kBwdKg>(w, g_s + wrow * kGs, kGs, v_s, kGs);     // dW = G V1^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = wrow + g + 8 * (c >> 1), j = nt * 8 + 2 * t4 + (c & 1);
        const bool keep = row < qrows && j < krows && k0 + j <= q0 + row;
        s[nt][c] = keep ? dscore<kLocalExact>(s[nt][c], w[nt][c], degree, scale) : 0.f;
      }
    }
    warp_sb<kF / 8>(acc, s, k_s, kFs);
    __syncthreads();
  }

  // ---- through the prefix: dqm = (M + M^T) qm, M = Z_l g ----
  float xa[2][kBwdR / 4];
#pragma unroll
  for (int j = 0; j < kBwdR / 4; ++j) {
    const int c = (j >> 1) * 8 + 2 * t4 + (j & 1);
    xa[0][j] = qm_s[(wrow + g) * kMs + c];
    xa[1][j] = qm_s[(wrow + g + 8) * kMs + c];
  }
  float acc2[kBwdR / 8][4];
  zero(acc2);
  for (int idx = threadIdx.x; idx < L::kZRing; idx += kTcThreads) z_ring[idx] = 0.f;
  __syncthreads();
  const size_t state = (size_t)bh * t + l;
  const int zchunks = (r + kZPer - 1) / kZPer;
  const auto stage_z = [&](int ch) {
    const int e0 = ch * kZPer;
    stage_state(z_ring + (ch & 1) * kZPer * kBwdR * kGs, zv, zd, state, e0,
                min(kZPer, r - e0), r, h);
  };
  stage_z(0);
  for (int ch = 0; ch < zchunks; ++ch) {
    if (ch + 1 < zchunks) {
      stage_z(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int e0 = ch * kZPer, ne = min(kZPer, r - e0);
    for (int i = 0; i < ne; ++i) {
      const int e = e0 + i;
      const float xe[2] = {qm_s[(wrow + g) * kMs + e], qm_s[(wrow + g + 8) * kMs + e]};
      sym_block(acc2, dx_s + wrow * kDxs, e, g_s + wrow * kGs,
                z_ring + ((ch & 1) * kZPer + i) * kBwdR * kGs, xa, xe);
    }
    __syncthreads();
  }

#pragma unroll
  for (int nd = 0; nd < kBwdR / 8; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
      if (row < qrows && col < r) {
        float x = acc2[nd][c] + dx_s[row * kDxs + col];
        if (!kLocalExact) x += acc[nd][c];
        dqm[(row0 + q0 + row) * r + col] = x;
      }
    }
  }
  if (kLocalExact) {
#pragma unroll
    for (int nd = 0; nd < kF / 8; ++nd) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
        if (row < qrows && col < h) dq[(row0 + q0 + row) * h + col] = acc[nd][c];
      }
    }
  }
}

// Pass 3b: dkm, dv (and dk) of one 64-key tile of block l. grid
// (ceil(b/64), t, bh), the first tile (most query tiles) first; warp w owns
// keys 16w .. 16w + 15.
template <bool kLocalExact>
__global__ void __launch_bounds__(kTcThreads)
key_kernel(const float* __restrict__ qm, const float* __restrict__ km,
           const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dnum,
           const float* __restrict__ dden, const float* __restrict__ dhv,
           const float* __restrict__ dhd, float* __restrict__ dkm, float* __restrict__ dk,
           float* __restrict__ dv, int n, int r, int h, int b, int degree, float scale) {
  using L = TileSmem<kLocalExact>;
  constexpr int kF = L::kF, kFs = L::kFs;
  const int kt = blockIdx.x, l = blockIdx.y, bh = blockIdx.z, t = gridDim.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;
  const int k0 = kt * kKeyTile, krows = min(kKeyTile, b - k0);
  const int f = kLocalExact ? h : r;
  extern __shared__ __align__(16) float smem[];
  float* v1_s = smem;                                       // kTcTile x kGs
  float* km_s = v1_s + kTcTile * kGs;                       // kTcTile x kMs
  float* kf_s = kLocalExact ? km_s + kTcTile * kMs : km_s;  // kTcTile x kFs
  float* dx_s = kf_s + kTcTile * kFs;                       // kTcTile x kDxs
  float* q_ring = dx_s + kTcTile * kDxs;                    // 2 x kTcTile x kFs
  float* g_ring = q_ring + 2 * kTcTile * kFs;               // 2 x kTcTile x kGs
  float* z_ring = q_ring;                                   // after the diagonal

  zero_tiles<kLocalExact>(smem);
  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const float* qf_src = kLocalExact ? q : qm;
  stage_rows<kTcThreads>(v1_s, v + (row0 + k0) * h, krows, kTcTile, h, kGs);
  for (int s = threadIdx.x; s < kTcTile; s += kTcThreads) {
    v1_s[s * kGs + kBwdH] = s < krows ? 1.f : 0.f;
  }
  stage_rows<kTcThreads>(km_s, km + (row0 + k0) * r, krows, kTcTile, r, kMs);
  if (kLocalExact) stage_rows<kTcThreads>(kf_s, k + (row0 + k0) * h, krows, kTcTile, h, kFs);

  // ---- diagonal block: dv = W^T dNum, dk = dS^T Q from the diagonal on ----
  float dva[kBwdH / 8][4], dka[kF / 8][4];
  zero(dva);
  zero(dka);
  const int nqt = (b + kTcTile - 1) / kTcTile;
  const auto stage = [&](int qt) {
    const int q0 = qt * kTcTile, rows = min(kTcTile, b - q0);
    float* qd = q_ring + (qt & 1) * kTcTile * kFs;
    stage_rows<kTcThreads>(qd, qf_src + (row0 + q0) * f, rows, kTcTile, f, kFs);
    stage_g(g_ring + (qt & 1) * kTcTile * kGs, dnum, dden, row0 + q0, rows, h);
    cp_async_commit();
  };
  stage(kt);
  for (int qt = kt; qt < nqt; ++qt) {
    if (qt + 1 < nqt) {
      stage(qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * kTcTile, qrows = min(kTcTile, b - q0);
    const float* q_s = q_ring + (qt & 1) * kTcTile * kFs;
    const float* g_s = g_ring + (qt & 1) * kTcTile * kGs;
    float s[8][4], w[8][4];
    zero(s);
    zero(w);
    warp_abt<8, kF>(s, kf_s + wrow * kFs, kFs, q_s, kFs);       // S^T = K Q^T
    warp_abt<8, kBwdKg>(w, v1_s + wrow * kGs, kGs, g_s, kGs);   // dW^T = V1 G^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = wrow + g + 8 * (c >> 1), i = nt * 8 + 2 * t4 + (c & 1);
        const bool keep = key < krows && i < qrows && k0 + key <= q0 + i;
        const float x = kLocalExact ? s[nt][c] * scale : s[nt][c];
        const float wgt = kLocalExact ? pow_int(x, degree) : x * x;
        w[nt][c] = keep ? dscore<kLocalExact>(s[nt][c], w[nt][c], degree, scale) : 0.f;
        s[nt][c] = keep ? wgt : 0.f;
      }
    }
    warp_sb<kBwdH / 8>(dva, s, g_s, kGs);   // the first h columns of G: dNum
    warp_sb<kF / 8>(dka, w, q_s, kFs);
    __syncthreads();
  }

  // ---- through dH_l (zero for the last block) ----
  float acc2[kBwdR / 8][4];
  zero(acc2);
  const bool through_dh = l + 1 < t;
  if (through_dh) {
    float xa[2][kBwdR / 4], xk[2][kBwdR / 4];   // accumulator layout; A layout (c = t + 4j)
#pragma unroll
    for (int j = 0; j < kBwdR / 4; ++j) {
      const int c = (j >> 1) * 8 + 2 * t4 + (j & 1);
      xa[0][j] = km_s[(wrow + g) * kMs + c];
      xa[1][j] = km_s[(wrow + g + 8) * kMs + c];
      xk[0][j] = km_s[(wrow + g) * kMs + t4 + 4 * j];
      xk[1][j] = km_s[(wrow + g + 8) * kMs + t4 + 4 * j];
    }
    for (int idx = threadIdx.x; idx < L::kZRing; idx += kTcThreads) z_ring[idx] = 0.f;
    __syncthreads();
    const size_t state = (size_t)bh * t + l;
    const int zchunks = (r + kZPer - 1) / kZPer;
    const auto stage_z = [&](int ch) {
      const int e0 = ch * kZPer;
      stage_state(z_ring + (ch & 1) * kZPer * kBwdR * kGs, dhv, dhd, state, e0,
                  min(kZPer, r - e0), r, h);
    };
    stage_z(0);
    for (int ch = 0; ch < zchunks; ++ch) {
      if (ch + 1 < zchunks) {
        stage_z(ch + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int e0 = ch * kZPer, ne = min(kZPer, r - e0);
      for (int i = 0; i < ne; ++i) {
        const int e = e0 + i;
        const float xe[2] = {km_s[(wrow + g) * kMs + e], km_s[(wrow + g + 8) * kMs + e]};
        const float* slot = z_ring + ((ch & 1) * kZPer + i) * kBwdR * kGs;
        cross_block<kBwdR / 8, true>(dva, xk, xe, slot + t4 * kGs + g, kGs, r);
        sym_block(acc2, dx_s + wrow * kDxs, e, v1_s + wrow * kGs, slot, xa, xe);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int nd = 0; nd < kBwdR / 8; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
      if (row < krows && col < r) {
        float x = acc2[nd][c];
        if (through_dh) x += dx_s[row * kDxs + col];
        if (!kLocalExact) x += dka[nd][c];
        dkm[(row0 + k0 + row) * r + col] = x;
      }
    }
  }
#pragma unroll
  for (int nd = 0; nd < kBwdH / 8; ++nd) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = wrow + g + 8 * (c >> 1), col = nd * 8 + 2 * t4 + (c & 1);
      if (row < krows && col < h) {
        dv[(row0 + k0 + row) * h + col] = dva[nd][c];
        if (kLocalExact) dk[(row0 + k0 + row) * h + col] = dka[nd][c];
      }
    }
  }
}

template <bool kLocalExact>
cudaError_t run_tiles(const float* qm, const float* km, const float* q, const float* k,
                      const float* v, const float* dnum, const float* dden, const float* zv,
                      const float* zd, const float* dhv, const float* dhd, float* dqm,
                      float* dkm, float* dq, float* dk, float* dv, int bh, int n, int r, int h,
                      int b, int degree, float scale, cudaStream_t stream) {
  const size_t smem = TileSmem<kLocalExact>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(query_kernel<kLocalExact>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(key_kernel<kLocalExact>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kTcTile - 1) / kTcTile, n / b, bh);
  query_kernel<kLocalExact><<<grid, kTcThreads, smem, stream>>>(
      qm, km, q, k, v, dnum, dden, zv, zd, dqm, dq, n, r, h, b, degree, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  key_kernel<kLocalExact><<<grid, kTcThreads, smem, stream>>>(
      qm, km, q, k, v, dnum, dden, dhv, dhd, dkm, dk, dv, n, r, h, b, degree, scale);
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
  prep_kernel<<<(rows + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps, 0, s>>>(
      dout, out, den1, dnum, dden, rows, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_fold<float, 2>(qm, dnum, dden, dhv, dhd, bh, n, r, h, b, s)) != cudaSuccess) {
    return (int)err;
  }
  if ((err = launch_prefix<true>(dhv, dhd, nullptr, nullptr, dzv0, dzd0, bh, t, r, h, s)) !=
      cudaSuccess) {
    return (int)err;
  }
  err = local_exact
            ? run_tiles<true>(qm, km, q, k, v, dnum, dden, zv, zd, dhv, dhd, dqm, dkm, dq, dk,
                              dv, bh, n, r, h, b, degree, scale, s)
            : run_tiles<false>(qm, km, q, k, v, dnum, dden, zv, zd, dhv, dhd, dqm, dkm, dq,
                               dk, dv, bh, n, r, h, b, degree, scale, s);
  return (int)err;
}
