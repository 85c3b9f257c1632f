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
//   pass 1  (bh, block, 32 x 256 tile of the state) in parallel: H_l.
//   pass 2  state elements in parallel, blocks in order: the exclusive
//           prefix Z_l, written over H_l, plus the final state.
//   pass 3  (bh, block, 64-query tile) in parallel: the diagonal block
//           flash-style over 64-key tiles of the same block (exact weights
//           for every pair in it, no running max since x^p needs none),
//           then the cross term, streaming Z_l one row at a time through
//           shared memory.
// No atomics; every sum runs in a fixed order, and pass 2 adds the blocks
// left to right from z0. A prefill resumed at a block boundary from the
// state this kernel returned is therefore bit-identical to a cold one.
//
// What bounds it. At the serving shapes (bh=48, n=2048, r=32, h=64,
// b=1024, f32) the three terms are ~13 GFLOP each against ~125 MB of
// inputs and outputs, i.e. ~300 FLOP per byte: the kernel is bound by
// operations. This version runs them on the f32 FMA pipes (no tensor
// cores: f32 inputs, and TF32 is untested against the 1e-4 tolerance). It
// keeps every operand tile in shared memory, so device memory is read
// once per tile, and tiles each thread's outputs in registers (4 x 8 in
// pass 1, 4 x 4 in pass 3) so that an FMA costs well under one shared
// memory read. wgmma on bf16/TF32 and TMA staging are later work.

#include <stddef.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                         // query rows / key rows per tile
constexpr int kSide = 16;                         // pass 3: 16 x 16 threads per tile
constexpr int kRowsPerThread = kTile / kSide;     // pass 3: query rows (and keys) per thread
constexpr int kMaxH = 128;
constexpr int kMaxR = 64;
constexpr int kMaxCols = kMaxH / kSide;           // pass 3: output columns per thread
constexpr int kP1Rows = 32;                       // pass 1: state rows per CTA
constexpr int kP1RowsPerThread = kP1Rows / (kThreads / 32);
constexpr int kP1ColsPerThread = 8;
constexpr int kP1Cols = 32 * kP1ColsPerThread;    // pass 1: state columns per CTA

// Copy `rows` rows of `width` values into shared memory with row stride
// `stride`, zero-filling rows up to kTile.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows, int width,
                                          int stride) {
  load_rows<kTile, kThreads>(dst, src, rows, width, stride);
}

// Pass 1: H_l as one product. Column n of the output is c*h + d for the
// Zv part and r*h + c for the Zd part, against a ones column appended to v:
//   hv[bh, l, i, c*h + d] = sum_s km[s, i] * (km[s, c] * v[s, d])
//   hd[bh, l, i, c]       = sum_s km[s, i] * (km[s, c] * 1)
// grid (ceil((r*h + r) / 256), t, bh * ceil(r / 32)). A CTA owns 32 rows i
// x 256 columns; a thread owns rows warp + 8k (k < 4) and columns
// lane + 32j (j < 8), so each step s reads 12 shared values for 32 FMAs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_state_kernel(const T* __restrict__ km, const T* __restrict__ v, float* __restrict__ hv,
                   float* __restrict__ hd, int n, int r, int h, int b) {
  const int row_tiles = (r + kP1Rows - 1) / kP1Rows;
  const int l = blockIdx.y, t = gridDim.y;
  const int bh = blockIdx.z / row_tiles, rt = blockIdx.z - bh * row_tiles;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rh = r * h, ncols = rh + r, hs = h + 1;
  extern __shared__ float smem[];
  float* km_s = smem;              // kTile x r
  float* v_s = km_s + kTile * r;   // kTile x (h + 1), last column 1

  int cj[kP1ColsPerThread], dj[kP1ColsPerThread];
#pragma unroll
  for (int j = 0; j < kP1ColsPerThread; ++j) {
    const int col = blockIdx.x * kP1Cols + lane + 32 * j;
    const bool zv_part = col < rh;
    cj[j] = col >= ncols ? 0 : (zv_part ? col / h : col - rh);
    dj[j] = col >= ncols ? 0 : (zv_part ? col - (col / h) * h : h);
  }
  int ik[kP1RowsPerThread];
#pragma unroll
  for (int k = 0; k < kP1RowsPerThread; ++k) {
    const int i = rt * kP1Rows + warp + 8 * k;
    ik[k] = i < r ? i : 0;   // rows past r compute garbage and are not written
  }
  float acc[kP1RowsPerThread][kP1ColsPerThread];
#pragma unroll
  for (int k = 0; k < kP1RowsPerThread; ++k)
#pragma unroll
    for (int j = 0; j < kP1ColsPerThread; ++j) acc[k][j] = 0.f;

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  for (int s0 = 0; s0 < b; s0 += kTile) {
    const int rows = min(kTile, b - s0);
    load_tile(km_s, km + (row0 + s0) * r, rows, r, r);
    load_tile(v_s, v + (row0 + s0) * h, rows, h, hs);
    for (int s = threadIdx.x; s < kTile; s += kThreads) v_s[s * hs + h] = s < rows ? 1.f : 0.f;
    __syncthreads();
    for (int s = 0; s < rows; ++s) {
      float a[kP1RowsPerThread], u[kP1ColsPerThread];
#pragma unroll
      for (int k = 0; k < kP1RowsPerThread; ++k) a[k] = km_s[s * r + ik[k]];
#pragma unroll
      for (int j = 0; j < kP1ColsPerThread; ++j) u[j] = km_s[s * r + cj[j]] * v_s[s * hs + dj[j]];
#pragma unroll
      for (int k = 0; k < kP1RowsPerThread; ++k)
#pragma unroll
        for (int j = 0; j < kP1ColsPerThread; ++j) acc[k][j] = fmaf(a[k], u[j], acc[k][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kP1RowsPerThread; ++k) {
    const int i = rt * kP1Rows + warp + 8 * k;
    if (i >= r) continue;
    const size_t state_row = ((size_t)bh * t + l) * r + i;
#pragma unroll
    for (int j = 0; j < kP1ColsPerThread; ++j) {
      const int col = blockIdx.x * kP1Cols + lane + 32 * j;
      if (col < rh) {
        hv[state_row * rh + col] = acc[k][j];
      } else if (col < ncols) {
        hd[state_row * r + (col - rh)] = acc[k][j];
      }
    }
  }
}

// Pass 2: in place over hv/hd, H_l becomes Z_l = z0 + H_0 + ... + H_{l-1},
// added left to right; the sum over all t blocks is the returned state.
__global__ void __launch_bounds__(kThreads)
prefix_kernel(float* __restrict__ hv, float* __restrict__ hd, const float* __restrict__ zv0,
              const float* __restrict__ zd0, float* __restrict__ zv_out,
              float* __restrict__ zd_out, int bh_count, int t, int rrh, int rr) {
  const size_t per = (size_t)rrh + rr;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= per * bh_count) return;
  const size_t bh = idx / per, e = idx - bh * per;
  float* cur;
  size_t stride;
  float z;
  float* out;
  if (e < (size_t)rrh) {
    cur = hv + bh * t * rrh + e;
    stride = rrh;
    z = zv0[bh * rrh + e];
    out = zv_out + bh * rrh + e;
  } else {
    const size_t e2 = e - rrh;
    cur = hd + bh * t * rr + e2;
    stride = rr;
    z = zd0[bh * rr + e2];
    out = zd_out + bh * rr + e2;
  }
  for (int l = 0; l < t; ++l) {
    const float h_l = cur[l * stride];
    cur[l * stride] = z;
    z = z + h_l;
  }
  *out = z;
}

// Pass 3: outputs of one 64-query tile of block l. grid (ceil(b/64), t, bh).
// Thread (tr, tc) owns query rows tr + 16a (a < 4); in the scores it owns
// keys tc + 16c, in the outputs columns tc + 16c, so every inner step reads
// 8 shared values for 16 FMAs.
template <typename T, bool kLocalExact>
__global__ void __launch_bounds__(kThreads)
output_kernel(const T* __restrict__ qm, const T* __restrict__ km, const T* __restrict__ q,
              const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ zv,
              const float* __restrict__ zd, T* __restrict__ out, int n, int r, int h, int b,
              int degree, float scale) {
  const int qt = blockIdx.x, l = blockIdx.y, bh = blockIdx.z, t = gridDim.y;
  const int tid = threadIdx.x, tr = tid / kSide, tc = tid % kSide;
  const int q0 = qt * kTile;
  const int qrows = min(kTile, b - q0);
  const int f = kLocalExact ? h : r;   // feature width of the diagonal scores
  const int fs = f + 1;                // padded strides avoid bank conflicts
  const int rs = r + 1;
  const int ws = kTile + 1;

  extern __shared__ float smem[];
  float* qf_s = smem;                  // kTile x fs
  float* kf_s = qf_s + kTile * fs;     // kTile x fs
  float* v_s = kf_s + kTile * fs;      // kTile x h
  float* w_s = v_s + kTile * h;        // kTile x ws
  float* qm_s = w_s + kTile * ws;      // kTile x rs
  float* z_s = qm_s + kTile * rs;      // r x h: one row of Zv_l
  float* zd_s = z_s + r * h;           // r x r

  const size_t row0 = (size_t)bh * n + (size_t)l * b;
  const T* qf_src = kLocalExact ? q : qm;
  const T* kf_src = kLocalExact ? k : km;
  load_tile(qf_s, qf_src + (row0 + q0) * f, qrows, f, fs);
  load_tile(qm_s, qm + (row0 + q0) * r, qrows, r, rs);

  float acc[kRowsPerThread][kMaxCols];
  float den[kRowsPerThread];
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    den[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[a][c] = 0.f;
  }

  // ---- diagonal block: exact weights for every pair inside block l ----
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    const int krows = min(kTile, b - k0);
    __syncthreads();   // the previous tile's readers are done
    load_tile(kf_s, kf_src + (row0 + k0) * f, krows, f, fs);
    load_tile(v_s, v + (row0 + k0) * h, krows, h, h);
    __syncthreads();
    if (kLocalExact) {
      tile_accumulate<kTile, kSide, kMaxCols, true>(qf_s, kf_s, f, fs, v_s, h, w_s, q0, qrows,
                                                    k0, krows, true, PowWeight{scale, degree},
                                                    acc, den);
    } else {
      tile_accumulate<kTile, kSide, kMaxCols, true>(qf_s, kf_s, f, fs, v_s, h, w_s, q0, qrows,
                                                    k0, krows, true, SquareWeight{}, acc, den);
    }
  }

  // ---- cross-block prefix through Z_l: sum_{e,c} qm_e qm_c Z[e, c, :] ----
  const size_t state = (size_t)bh * t + l;
  const int rh = r * h;
  for (int idx = tid; idx < r * r; idx += kThreads) zd_s[idx] = zd[state * r * r + idx];
  for (int e = 0; e < r; ++e) {
    __syncthreads();
    const float* zrow = zv + (state * r + e) * rh;
    for (int idx = tid; idx < rh; idx += kThreads) z_s[idx] = zrow[idx];
    __syncthreads();
    float qe[kRowsPerThread];
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a) qe[a] = qm_s[(tr + kSide * a) * rs + e];
    for (int c = 0; c < r; ++c) {
      const float zdv = zd_s[e * r + c];
      float coef[kRowsPerThread];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a) {
        coef[a] = qe[a] * qm_s[(tr + kSide * a) * rs + c];
        den[a] = fmaf(coef[a], zdv, den[a]);
      }
#pragma unroll
      for (int cc = 0; cc < kMaxCols; ++cc) {
        const int d = tc + kSide * cc;
        if (d < h) {
          const float zz = z_s[c * h + d];
#pragma unroll
          for (int a = 0; a < kRowsPerThread; ++a) acc[a][cc] = fmaf(coef[a], zz, acc[a][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int row = tr + kSide * a;
    if (row >= qrows) continue;
    const float inv = 1.f / (1.f + den[a]);
    T* orow = out + (row0 + q0 + row) * h;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int d = tc + kSide * c;
      if (d < h) orow[d] = from_f32<T>(acc[a][c] * inv);
    }
  }
}

size_t output_smem_bytes(int r, int h, bool local_exact) {
  const int f = local_exact ? h : r;
  const size_t floats = (size_t)2 * kTile * (f + 1) + (size_t)kTile * h +
                        (size_t)kTile * (kTile + 1) + (size_t)kTile * (r + 1) +
                        (size_t)r * h + (size_t)r * r;
  return floats * sizeof(float);
}

template <typename T, bool kLocalExact>
cudaError_t launch_output(const void* qm, const void* km, const void* q, const void* k,
                          const void* v, const float* zv, const float* zd, void* out, int bh,
                          int n, int r, int h, int b, int degree, float scale,
                          cudaStream_t stream) {
  const size_t smem = output_smem_bytes(r, h, kLocalExact);
  cudaError_t err = cudaFuncSetAttribute(output_kernel<T, kLocalExact>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kTile - 1) / kTile, n / b, bh);
  output_kernel<T, kLocalExact><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qm), static_cast<const T*>(km), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), zv, zd, static_cast<T*>(out), n, r,
      h, b, degree, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* qm, const void* km, const void* q, const void* k, const void* v,
                const float* zv0, const float* zd0, void* out, float* hv, float* hd,
                float* zv_out, float* zd_out, int bh, int n, int r, int h, int b, int degree,
                float scale, int local_exact, cudaStream_t stream) {
  const int t = n / b;
  const size_t smem1 = (size_t)kTile * (r + h + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(block_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return err;
  const dim3 grid1((r * h + r + kP1Cols - 1) / kP1Cols, t,
                   bh * ((r + kP1Rows - 1) / kP1Rows));
  block_state_kernel<T><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(km), static_cast<const T*>(v), hv, hd, n, r, h, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t total = (size_t)bh * ((size_t)r * r * h + (size_t)r * r);
  prefix_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      hv, hd, zv0, zd0, zv_out, zd_out, bh, t, r * r * h, r * r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (local_exact) {
    return launch_output<T, true>(qm, km, q, k, v, hv, hd, out, bh, n, r, h, b, degree, scale,
                                  stream);
  }
  return launch_output<T, false>(qm, km, q, k, v, hv, hd, out, bh, n, r, h, b, degree, scale,
                                 stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous tensors: qm, km (bh, n, r); q, k, v, out (bh, n, h) of one
// type (dtype 0 = float32, 1 = bfloat16); zv0, zv_out (bh, r, r*h) and zd0,
// zd_out (bh, r, r) float32; hv (bh, n/b, r, r*h) and hd (bh, n/b, r, r)
// float32 scratch. Requires n % b == 0, r <= 64 and h <= 128. Returns the
// first CUDA error (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int polysketch_causal_forward(const void* qm, const void* km, const void* q,
                                         const void* k, const void* v, const float* zv0,
                                         const float* zd0, void* out, float* hv, float* hd,
                                         float* zv_out, float* zd_out, int bh, int n, int r,
                                         int h, int b, int degree, float scale,
                                         int local_exact, int dtype, void* stream) {
  if (bh <= 0 || n <= 0 || b <= 0 || n % b != 0 || r <= 0 || r > kMaxR || h < 1 ||
      h > kMaxH || degree < 1 || bh > 32767 || n / b > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = run<float>(qm, km, q, k, v, zv0, zd0, out, hv, hd, zv_out, zd_out, bh, n, r, h, b,
                     degree, scale, local_exact, s);
  } else if (dtype == 1) {
    err = run<__nv_bfloat16>(qm, km, q, k, v, zv0, zd0, out, hv, hd, zv_out, zd_out, bh, n, r,
                             h, b, degree, scale, local_exact, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
