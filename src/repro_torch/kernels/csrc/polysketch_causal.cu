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
//   pass 1  fold_kernel (polysketch_state.cuh, shared with the backward),
//           (256 state columns, block, bh) in parallel: H_l
//           as one product Km_l^T [Km_l (x) V_l | Km_l] (M = r,
//           N = r*h + r, K = b); the ones column of V yields Zd. Each warp
//           sums its 32 columns over the b keys in order: no split-K, no
//           atomics.
//   pass 2  prefix_kernel (polysketch_state.cuh), state elements in
//           parallel (float4 a thread), blocks in order: the exclusive
//           prefix Z_l, written over H_l, plus the final state. Z_l stays
//           in hv/hd for the backward (polysketch_causal_bwd.cu).
//   pass 3  output_kernel, (64-query tile, block, bh) in parallel, the last
//           tile first: the diagonal block flash-style over the 64-key
//           tiles of block l (common.cuh's tc_flash_loop, as in
//           poly_flash.cu: exact weights for every pair in the block, no
//           running max since x^p needs none), then the cross term as one
//           product with K = r^2: Phi(qm) [Zv_l | Zd_l], Phi(qm)[i, e*r + c]
//           = qm_ie qm_ic, built one sketch index e at a time as
//           qm[:, e] (.) qm (a 64 x r chunk, in registers) against row
//           block e of Z_l taken as r x (h + 1), staged with cp.async. The
//           numerator and the denominator come out of that one product
//           (Zd_l is the column after the numerator's n-tiles). When
//           asked (den_out), it also stores 1 + den of each row for the
//           backward; the outputs are the same bits either way.
// Every sum runs in a fixed order that n and bh do not change, and pass 2
// adds the blocks left to right from z0. A prefill resumed at a block
// boundary from the state this kernel returned is therefore bit-identical
// to a cold one, and a head computed alone equals the same head in a batch.
//
// What bounds it. At bh=48, n=2048, r=32, h=64, b=1024, f32 the three
// products (fold, diagonal, cross term) are ~13 GFLOP each, 39.1 GFLOP
// together, against 151 MB of inputs, state and outputs; the rest (scale,
// power, masks, km (x) v, the prefix) is 0.8 GFLOP. Every product runs on
// the tensor cores as mma.sync m16n8k8 in 3xTF32 (common.cuh), so the
// least time is 3 x 39.1 GFLOP at 495 TFLOP/s plus 0.8 GFLOP at
// 67 TFLOP/s, 0.249 ms: bound by operations (0.595 ms on the f32 FMA
// pipes). The prefill's calls, n = b = 1024 and 1016, are bound at 0.125
// and 0.123 ms. bf16 inputs are staged as f32 and take the same path.
//
// Registers (nvcc -Xptxas -v, as chip_smoke.py prints it), no spills and
// no stack in any instantiation: output_kernel 212-252 a thread (f32,
// local_exact: 239 and 245; 96 KB of shared memory, so two CTAs share an
// SM), fold_kernel 119-163 (f32, r <= 32: 121), prefix_kernel 32.

#include <stddef.h>

#include "common.cuh"
#include "polysketch_state.cuh"

namespace {

constexpr int kMaxH = 128;
constexpr int kMaxR = 64;
constexpr int kZRows = 64;                   // rows of Z_l per staged chunk

// Pass 3: outputs of one 64-query tile of block l. grid (ceil(b/64), t, bh),
// kTcThreads threads; warp w owns query rows 16w .. 16w + 15. acc holds
// kNT n-tiles (9 for h <= 64, 17 for h <= 128): the numerator's h columns,
// and the denominator's in column 8 (kNT - 1), a place known at compile
// time; kRK = k-steps of r (4 for r <= 32, 8 for r <= 64).
template <typename T, bool kLocalExact, int kNT, int kRK>
__global__ void __launch_bounds__(kTcThreads)
output_kernel(const T* __restrict__ qm, const T* __restrict__ km, const T* __restrict__ q,
              const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ zv,
              const float* __restrict__ zd, T* __restrict__ out, float* __restrict__ den_out,
              int n, int r, int h, int b, int degree, float scale) {
  // the last query tile (most key tiles) first, so the grid's tail is short
  const int qt = gridDim.x - 1 - blockIdx.x, l = blockIdx.y, bh = blockIdx.z, t = gridDim.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16;
  const int q0 = qt * kTcTile;
  const int qrows = min(kTcTile, b - q0);
  const int f = kLocalExact ? h : r;   // feature width of the diagonal scores
  const int fs = row_frag_stride(f), ms = row_frag_stride(r);
  const int vs = pair_frag_stride(h);
  constexpr int kDenCol = 8 * (kNT - 1), zs = k_frag_stride(8 * kNT);

  extern __shared__ __align__(16) float smem[];
  float* qf_s = smem;                                       // kTcTile x fs
  float* qm_s = kLocalExact ? qf_s + kTcTile * fs : qf_s;   // kTcTile x ms
  float* k_ring = qm_s + kTcTile * ms;                      // 2 x kKeyTile x fs
  float* v_ring = k_ring + 2 * kKeyTile * fs;               // 2 x kKeyTile x vs
  float* z_ring = k_ring;   // after the diagonal block: 2 x kZRows x zs

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const T* qf_src = kLocalExact ? q : qm;
  const T* kf_src = kLocalExact ? k : km;
  zero_pad_cols<kTcThreads>(qf_s, kTcTile, f, fs);
  if (kLocalExact) zero_pad_cols<kTcThreads>(qm_s, kTcTile, r, ms);
  zero_pad_cols<kTcThreads>(k_ring, 2 * kKeyTile, f, fs);
  zero_pad_cols<kTcThreads>(v_ring, 2 * kKeyTile, h, vs);
  stage_rows<kTcThreads>(qf_s, qf_src + (row0 + q0) * f, qrows, kTcTile, f, fs);
  if (kLocalExact) stage_rows<kTcThreads>(qm_s, qm + (row0 + q0) * r, qrows, kTcTile, r, ms);

  float acc[kNT][4];
  float den[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < kNT; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  // ---- diagonal block: exact weights for every pair inside block l ----
  const int ktiles = (q0 + qrows + kKeyTile - 1) / kKeyTile;
  if (kLocalExact) {
    tc_flash_loop<kNT, kNT - 1, 8 * (kNT - 1)>(
        qf_s, fs, kf_src + row0 * f, v + row0 * h, f, h, b, ktiles, k_ring, fs, v_ring, vs, q0,
        qrows, true, PowWeight{scale, degree}, acc, den);
  } else {
    tc_flash_loop<kNT, kNT - 1, 8 * kRK>(qf_s, fs, kf_src + row0 * f, v + row0 * h, f, h, b,
                                         ktiles, k_ring, fs, v_ring, vs, q0, qrows, true,
                                         SquareWeight{}, acc, den);
  }

  // ---- cross-block prefix: Phi(qm) [Zv_l | Zd_l], K = r^2 ----
  // Row block e of Z_l is r x 8 kNT: [c, d] = Zv_l[e, c*h + d] for d < h,
  // [c, kDenCol] = Zd_l[e, c], zero elsewhere. A chunk of kZRows rows holds
  // e_per such blocks, each padded with zero rows to rp8.
  const size_t state = (size_t)bh * t + l;
  const int rh = r * h, rp8 = (r + 7) / 8 * 8;
  const int e_per = max(1, kZRows / rp8);
  const int zchunks = (r + e_per - 1) / e_per;
  for (int idx = threadIdx.x; idx < 2 * kZRows * zs; idx += kTcThreads) {
    const int row = idx / zs, col = idx - row * zs;
    if ((col >= h && col != kDenCol) || row % kZRows % rp8 >= r) z_ring[idx] = 0.f;
  }
  const auto stage_z = [&](int ch) {
    float* zb = z_ring + (ch & 1) * kZRows * zs;
    const int e0 = ch * e_per, ne = min(e_per, r - e0);
    for (int i = 0; i < ne; ++i) {
      const size_t zrow = state * r + e0 + i;
      float* slot = zb + i * rp8 * zs;
      stage_rows<kTcThreads>(slot, zv + zrow * rh, r, r, h, zs);
      for (int c = threadIdx.x; c < r; c += kTcThreads) {
        cp_async4(slot + c * zs + kDenCol, zd + zrow * r + c, true);
      }
    }
    cp_async_commit();
  };

  // qm[row, c] for the thread's rows g and g + 8 and its k columns t4 + 4j.
  float qmr[2][2 * kRK];
#pragma unroll
  for (int j = 0; j < 2 * kRK; ++j) {
    const int c = t4 + 4 * j;
    qmr[0][j] = c < rp8 ? qm_s[(wrow + g) * ms + c] : 0.f;
    qmr[1][j] = c < rp8 ? qm_s[(wrow + g + 8) * ms + c] : 0.f;
  }
  stage_z(0);
  for (int ch = 0; ch < zchunks; ++ch) {
    if (ch + 1 < zchunks) {
      stage_z(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (wrow < qrows) {
      const int e0 = ch * e_per, ne = min(e_per, r - e0);
      for (int i = 0; i < ne; ++i) {
        const int e = e0 + i;
        const float qe[2] = {qm_s[(wrow + g) * ms + e], qm_s[(wrow + g + 8) * ms + e]};
        const float* slot = z_ring + (ch & 1) * kZRows * zs + (i * rp8 + t4) * zs + g;
        if (r == 8 * kRK) {
          cross_block<kRK, true>(acc, qmr, qe, slot, zs, r);
        } else {
          cross_block<kRK, false>(acc, qmr, qe, slot, zs, r);
        }
      }
    }
    __syncthreads();
  }

  // den = rowsum W (this thread's keys, summed over the quad) + column
  // kDenCol, held by the quad's first thread.
  quad_sum(den);
  den[0] += __shfl_sync(0xffffffffu, acc[kNT - 1][0], lane & ~3);
  den[1] += __shfl_sync(0xffffffffu, acc[kNT - 1][2], lane & ~3);
  tc_store_rows<kNT>(out + (row0 + q0) * h, h, qrows, acc, den);
  if (den_out != nullptr && t4 == 0) {   // 1 + den per row, for the backward
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + g + 8 * i;
      if (row < qrows) den_out[row0 + q0 + row] = 1.f + den[i];
    }
  }
}

size_t output_smem_bytes(int r, int h, bool local_exact, int nt) {
  const int f = local_exact ? h : r;
  const size_t tiles = (size_t)kTcTile * row_frag_stride(f) +
                       (local_exact ? (size_t)kTcTile * row_frag_stride(r) : 0);
  const size_t rings = (size_t)2 * kKeyTile * (row_frag_stride(f) + pair_frag_stride(h));
  const size_t zring = (size_t)2 * kZRows * k_frag_stride(8 * nt);
  return (tiles + (rings > zring ? rings : zring)) * sizeof(float);
}

template <typename T, bool kLocalExact, int kNT, int kRK>
cudaError_t launch_output(const void* qm, const void* km, const void* q, const void* k,
                          const void* v, const float* zv, const float* zd, void* out,
                          float* den_out, int bh, int n, int r, int h, int b, int degree,
                          float scale, cudaStream_t stream) {
  const size_t smem = output_smem_bytes(r, h, kLocalExact, kNT);
  auto kernel = output_kernel<T, kLocalExact, kNT, kRK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kTcTile - 1) / kTcTile, n / b, bh);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(qm), static_cast<const T*>(km), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), zv, zd, static_cast<T*>(out),
      den_out, n, r, h, b, degree, scale);
  return cudaGetLastError();
}

template <typename T, bool kLocalExact>
cudaError_t run_output(const void* qm, const void* km, const void* q, const void* k,
                       const void* v, const float* zv, const float* zd, void* out,
                       float* den_out, int bh, int n, int r, int h, int b, int degree,
                       float scale, cudaStream_t stream) {
  if (h <= 64 && r <= 32) {
    return launch_output<T, kLocalExact, 9, 4>(qm, km, q, k, v, zv, zd, out, den_out, bh, n,
                                               r, h, b, degree, scale, stream);
  }
  return launch_output<T, kLocalExact, (kMaxH + 8) / 8, kMaxR / 8>(
      qm, km, q, k, v, zv, zd, out, den_out, bh, n, r, h, b, degree, scale, stream);
}

template <typename T>
cudaError_t run(const void* qm, const void* km, const void* q, const void* k, const void* v,
                const float* zv0, const float* zd0, void* out, float* den_out, float* hv,
                float* hd, float* zv_out, float* zd_out, int bh, int n, int r, int h, int b,
                int degree, float scale, int local_exact, cudaStream_t stream) {
  cudaError_t err =
      r <= 32 ? launch_fold<T, 2>(km, v, nullptr, hv, hd, bh, n, r, h, b, stream)
              : launch_fold<T, kMaxR / 16>(km, v, nullptr, hv, hd, bh, n, r, h, b, stream);
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
