"""Cycles a TF32 wgmma instruction takes on the card, by width.

    python3 scripts/wgmma_tf32_bench.py

Builds (nvcc, sm_90a, into the git-ignored build/wgmma_bench/) a kernel
that issues chains of m64nNk8 TF32 wgmma (A from registers, B from shared
memory) in a loop, one CTA on each of 132 SMs with one or two
warpgroups, and prints the clock64 cycles a wgmma of one warpgroup takes
beside the ideal for the SM (64 N 8 2 flops at 2048 TF32 flops a cycle),
for N = 32, 64, 128, 256 in chains of 24 and N = 32, 64 in chains of 4,
after the card's name and power limit. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "wgmma_bench")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
# (N, chain length, iterations) in the order the kernel's measure() runs them
CASES = ((32, 24, 2000), (64, 24, 2000), (128, 24, 1000), (256, 24, 500), (32, 4, 4000),
         (64, 4, 4000))


def wrapper(n: int) -> str:
    """mma_n<n>: one m64n<n>k8 TF32 wgmma accumulating into d."""
    nd = n // 2   # f32 accumulator registers a thread
    outs = ", ".join(f"%{i}" for i in range(nd))
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(nd))
    return f'''
__device__ __forceinline__ void mma_n{n}(float (&d)[{nd}], const uint32_t (&a)[4],
                                         uint64_t desc) {{
  asm volatile("wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 {{{outs}}}, "
               "{{%{nd}, %{nd + 1}, %{nd + 2}, %{nd + 3}}}, %{nd + 4}, 1, 1, 1;\\n"
               : {cons} : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}}'''


BODY = r'''
// B: N rows of 8 TF32 values, K-major without swizzle, zeros.
__device__ __forceinline__ uint64_t desc_of(const float* p, int rows) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3fff) | ((uint64_t)((rows / 8 * 32) >> 2) << 16) |
         ((uint64_t)(32 >> 2) << 32);
}

template <int N, int CHAIN>
__global__ void __launch_bounds__(256, 1) bench(int iters, float* out, long long* cycles) {
  extern __shared__ __align__(128) float sm[];
  for (int i = threadIdx.x; i < N * 8; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  const uint64_t desc = desc_of(sm, N);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < CHAIN; ++k) {
      if constexpr (N == 32) mma_n32(d, a, desc);
      if constexpr (N == 64) mma_n64(d, a, desc);
      if constexpr (N == 128) mma_n128(d, a, desc);
      if constexpr (N == 256) mma_n256(d, a, desc);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int N, int CHAIN>
float run(int wgs, int iters) {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 132 * 256 * 4);
  cudaMalloc(&cyc, 132 * 8);
  cudaFuncSetAttribute(bench<N, CHAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  bench<N, CHAIN><<<132, 128 * wgs, 65536>>>(iters, out, cyc);
  long long c[132];
  cudaDeviceSynchronize();
  cudaMemcpy(c, cyc, sizeof(c), cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(cyc);
  return (float)c[0] / (iters * CHAIN);
}

extern "C" void measure(float* res) {
  int i = 0;
  for (int wgs = 1; wgs <= 2; ++wgs) {
    res[i++] = run<32, 24>(wgs, 2000);
    res[i++] = run<64, 24>(wgs, 2000);
    res[i++] = run<128, 24>(wgs, 1000);
    res[i++] = run<256, 24>(wgs, 500);
    res[i++] = run<32, 4>(wgs, 4000);
    res[i++] = run<64, 4>(wgs, 4000);
  }
}
'''


def build() -> str:
    """Write and compile the benchmark; returns the shared library's path."""
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "wgmma_bench.cu")
    lib = os.path.join(OUT, "libwgmma_bench.so")
    with open(src, "w") as f:
        f.write("#include <cuda_runtime.h>\n#include <stdint.h>\n")
        f.write("".join(wrapper(n) for n in (32, 64, 128, 256)))
        f.write(BODY)
    subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    return lib


def main() -> int:
    if not os.path.exists(NVCC):
        print("wgmma_tf32_bench: nvcc not found", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}")
    lib = ctypes.CDLL(build())
    res = (ctypes.c_float * (2 * len(CASES)))()
    lib.measure(res)
    for w in range(2):
        for j, (n, chain, _) in enumerate(CASES):
            ideal = 64 * n * 8 * 2 / 2048.0
            print(f"{w + 1} warpgroup(s), n{n} chain {chain}: {res[w * len(CASES) + j]:.1f} "
                  f"cycles a wgmma of one warpgroup (ideal for the SM {ideal:.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
