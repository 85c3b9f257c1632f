// The factored polysketch state's passes, shared by B1's forward
// (polysketch_causal.cu) and its backward (polysketch_causal_bwd.cu).
//
// - fold_block: per block l, H_l = X_l^T [X_l (x) Y_l | X_l (.) y_l] as one
//   product on the tensor cores (mma.sync, 3xTF32), y_l being a given
//   column: the backward launches it as grad_fold (X = qm, Y = dNum,
//   y = dDen, so H_l is dZ_l). The forward's fold (X = km, Y = v and a
//   ones column, so H_l is the block's Zv and Zd) is polysketch_causal.cu's
//   fold_kernel, on wgmma.
// - prefix_scan: the exclusive prefix over blocks, left to right from z0
//   (the forward's Z_l, as prefix_kernel), or the exclusive suffix, right
//   to left from zero (the backward's dH_l, as grad_suffix); the full sum
//   is the returned state (or dz0).
#pragma once

#include <stddef.h>

#include "common.cuh"

constexpr int kPrefixThreads = 256;
constexpr int kFoldWarps = 8;
constexpr int kFoldThreads = 32 * kFoldWarps;
constexpr int kFoldCols = 32 * kFoldWarps;   // state columns per CTA: 4 n-tiles a warp
constexpr int kFoldKeys = 64;                // rows per staged chunk

// One staged chunk of the fold for the calling warp: acc[mt][nt] +=
// X_chunk^T U_chunk over the chunk's first `rows` rows (all kFoldKeys when
// kFull: no guard, so the k-steps are one straight line). The chunk's
// products go into a fresh accumulator, added to acc in f32: the tensor
// cores' adds truncate, and a sum kept in place over a block's 1024 keys
// would lose a little at every k-step (as common.cuh's mma_3xtf32_cols).
template <int kMT, bool kFull>
__device__ __forceinline__ void fold_chunk(float (&sum)[kMT][4][4], const float* kd, int kms,
                                           const float* vd, int vs, const int (&cj)[4],
                                           const int (&dj)[4], int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
#pragma unroll
  for (int s0 = 0; s0 < kFoldKeys; s0 += 8) {
    if (!kFull && s0 >= rows) break;
    const float* ka = kd + (s0 + t4) * kms + g;
    FragA a[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      a[mt] = split_a(ka[mt * 16], ka[mt * 16 + 8], ka[4 * kms + mt * 16],
                      ka[4 * kms + mt * 16 + 8]);
    }
    const float* kb = kd + (s0 + t4) * kms;
    const float* vb = vd + (s0 + t4) * vs;
    FragB bf[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      bf[nt] = split_b(kb[cj[nt]] * vb[dj[nt]], kb[4 * kms + cj[nt]] * vb[4 * vs + dj[nt]]);
    }
    // three passes over the 4 kMT accumulators (see mma_3xtf32)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], a[mt].lo, bf[nt].hi);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], a[mt].hi, bf[nt].lo);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], a[mt].hi, bf[nt].hi);
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[mt][nt][c] += acc[mt][nt][c];
}

// H_l as one product. Column col of the output is c*h + d for the
// Zv part and r*h + c for the Zd part, against a last column y appended
// to Y:
//   hv[bh, l, i, c*h + d] = sum_s x[s, i] * (x[s, c] * Y[s, d])
//   hd[bh, l, i, c]       = sum_s x[s, i] * (x[s, c] * y[s])
// grid (ceil((r*h + r) / 256), t, bh). Warp w owns 32 columns and all r
// rows (kMT m-tiles of 16: 2 for r <= 32, 4 for r <= 64). A = X^T from
// the staged x chunk, B = x (x) [Y | y] formed in registers from the
// staged chunks, both split in registers. X and Y may differ in type (the
// backward's qm in the operands' type, dNum in f32); bf16 is converted to
// f32 as it is staged.
template <typename T, typename U, int kMT>
__device__ __forceinline__ void fold_block(const T* __restrict__ km, const U* __restrict__ v,
                                           const float* __restrict__ last,
                                           float* __restrict__ hv, float* __restrict__ hd,
                                           int n, int r, int h, int b) {
  const int l = blockIdx.y, t = gridDim.y, bh = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int rh = r * h, ncols = rh + r;
  constexpr int kms = k_frag_stride(16 * kMT);
  const int vs = k_frag_stride(h + 1);
  extern __shared__ __align__(16) float smem[];
  float* km_ring = smem;                           // 2 x kFoldKeys x kms
  float* v_ring = km_ring + 2 * kFoldKeys * kms;   // 2 x kFoldKeys x vs, column h = y

  zero_pad_cols<kFoldThreads>(km_ring, 2 * kFoldKeys, r, kms);
  zero_pad_cols<kFoldThreads>(v_ring, 2 * kFoldKeys, h + 1, vs);

  // The columns of this thread's B fragments: U[s, col] = x[s, cj] * Y1[s, dj],
  // Y1 = [Y | y]. Columns past the state compute garbage and are not written.
  const int col0 = blockIdx.x * kFoldCols + warp * 32;
  int cj[4], dj[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + nt * 8 + g;
    cj[nt] = col < rh ? col / h : (col < ncols ? col - rh : 0);
    dj[nt] = col < rh ? col - cj[nt] * h : h;
  }
  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const int chunks = (b + kFoldKeys - 1) / kFoldKeys;
  const auto stage = [&](int ch) {
    const int s0 = ch * kFoldKeys, rows = min(kFoldKeys, b - s0);
    float* kd = km_ring + (ch & 1) * kFoldKeys * kms;
    float* vd = v_ring + (ch & 1) * kFoldKeys * vs;
    stage_rows<kFoldThreads>(kd, km + (row0 + s0) * r, rows, kFoldKeys, r, kms);
    stage_rows<kFoldThreads>(vd, v + (row0 + s0) * h, rows, kFoldKeys, h, vs);
    for (int s = threadIdx.x; s < kFoldKeys; s += kFoldThreads) {
      vd[s * vs + h] = s < rows ? last[row0 + s0 + s] : 0.f;
    }
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
    const float* kd = km_ring + (ch & 1) * kFoldKeys * kms;
    const float* vd = v_ring + (ch & 1) * kFoldKeys * vs;
    const int rows = min(kFoldKeys, b - ch * kFoldKeys);
    if (col0 < ncols) {
      if (rows == kFoldKeys) {
        fold_chunk<kMT, true>(acc, kd, kms, vd, vs, cj, dj, rows);
      } else {
        fold_chunk<kMT, false>(acc, kd, kms, vd, vs, cj, dj, rows);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = mt * 16 + g + 8 * (c >> 1), col = col0 + nt * 8 + 2 * t4 + (c & 1);
        if (i >= r || col >= ncols) continue;
        const size_t state_row = ((size_t)bh * t + l) * r + i;
        if (col < rh) {
          hv[state_row * rh + col] = acc[mt][nt][c];
        } else {
          hd[state_row * r + (col - rh)] = acc[mt][nt][c];
        }
      }
    }
  }
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Pass 2: in place over hv/hd, H_l becomes the exclusive prefix Z_l = z0 +
// H_0 + ... + H_{l-1}, added left to right (kReverse: the exclusive suffix
// H_{t-1} + ... + H_{l+1}, added right to left from zero, z0 unread); the
// sum over all t blocks goes to zv_out/zd_out.
// grid (ceil((rrh + rr) / (256 kVec)), bh): kVec consecutive state elements
// a thread (V = float4 when r*r*h and r*r are multiples of 4, else float),
// so that enough bytes are in flight to keep device memory busy.
template <typename V, bool kReverse>
__device__ __forceinline__ void prefix_scan(float* __restrict__ hv, float* __restrict__ hd,
                                            const float* __restrict__ zv0,
                                            const float* __restrict__ zd0,
                                            float* __restrict__ zv_out,
                                            float* __restrict__ zd_out, int t, int rrh, int rr) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  const int e = (blockIdx.x * kPrefixThreads + threadIdx.x) * kVec;
  if (e >= rrh + rr) return;
  const size_t bh = blockIdx.y;
  const bool zv_part = e < rrh;
  const int stride = zv_part ? rrh : rr, e2 = zv_part ? e : e - rrh;
  const size_t off = bh * stride + e2;
  V* cur = reinterpret_cast<V*>((zv_part ? hv : hd) + bh * t * stride + e2);
  V z = kReverse ? vzero<V>() : *reinterpret_cast<const V*>((zv_part ? zv0 : zd0) + off);
  const int vstride = stride / kVec;
  for (int i = 0; i < t; ++i) {
    const int l = kReverse ? t - 1 - i : i;
    const V h_l = cur[(size_t)l * vstride];
    cur[(size_t)l * vstride] = z;
    z = vadd(z, h_l);
  }
  *reinterpret_cast<V*>((zv_part ? zv_out : zd_out) + off) = z;
}

template <typename V, bool kReverse>
__global__ void __launch_bounds__(kPrefixThreads)
prefix_kernel(float* __restrict__ hv, float* __restrict__ hd, const float* __restrict__ zv0,
              const float* __restrict__ zd0, float* __restrict__ zv_out,
              float* __restrict__ zd_out, int t, int rrh, int rr) {
  prefix_scan<V, kReverse>(hv, hd, zv0, zd0, zv_out, zd_out, t, rrh, rr);
}

// Dynamic shared memory of a fold CTA (the two rings).
template <int kMT>
size_t fold_smem_bytes(int h) {
  return (size_t)2 * kFoldKeys * (k_frag_stride(16 * kMT) + k_frag_stride(h + 1)) * sizeof(float);
}

// Pass 2 over t blocks of state (see prefix_kernel); float4 a thread when
// the widths and every pointer allow it.
template <bool kReverse>
cudaError_t launch_prefix(float* hv, float* hd, const float* zv0, const float* zd0,
                          float* zv_out, float* zd_out, int bh, int t, int r, int h,
                          cudaStream_t stream) {
  const int rrh = r * r * h, rr = r * r;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(hv) | reinterpret_cast<uintptr_t>(hd) |
                         reinterpret_cast<uintptr_t>(zv0) | reinterpret_cast<uintptr_t>(zd0) |
                         reinterpret_cast<uintptr_t>(zv_out) | reinterpret_cast<uintptr_t>(zd_out);
  if (rr % 4 == 0 && (addr & 15) == 0) {   // rr % 4 == 0 makes rrh one too
    const dim3 grid((rrh + rr + 4 * kPrefixThreads - 1) / (4 * kPrefixThreads), bh);
    prefix_kernel<float4, kReverse><<<grid, kPrefixThreads, 0, stream>>>(
        hv, hd, zv0, zd0, zv_out, zd_out, t, rrh, rr);
  } else {
    const dim3 grid((rrh + rr + kPrefixThreads - 1) / kPrefixThreads, bh);
    prefix_kernel<float, kReverse><<<grid, kPrefixThreads, 0, stream>>>(
        hv, hd, zv0, zd0, zv_out, zd_out, t, rrh, rr);
  }
  return cudaGetLastError();
}
