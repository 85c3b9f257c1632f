"""Block lower-triangular multiply lt(A B^T) C: the CUDA kernel and its
plain version.

Replaces the JAX package's Pallas TPU kernel
``kernels/lt_mult.py::lt_mult_pallas``, the paper's Section 3.1
primitive: O = lt(A B^T) C with the diagonal included, for A, B
(bh, n, m) and C (bh, n, k), without forming the n x n product.

- ``lt_mult_torch``: plain PyTorch, the block algorithm of the reference's
  ``ops._lt_mult_blocked_xla``. The CPU path, and the yardstick the kernel
  is held to.
- ``lt_mult_cuda``: the hand-written Hopper kernel in ``csrc/lt_mult.cu``
  (design and bound in its header), bound through ctypes.
  ``lt_mult_cuda.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _check(a, b, c, block_size):
    if a.dim() != 3 or b.shape != a.shape or c.dim() != 3 \
            or c.shape[:2] != a.shape[:2]:
        raise ValueError(f"want a, b (bh, n, m) and c (bh, n, k); got a "
                         f"{tuple(a.shape)} b {tuple(b.shape)} c "
                         f"{tuple(c.shape)}")
    n = a.shape[1]
    if block_size < 1 or n % block_size:
        raise ValueError(f"n={n} is not a multiple of the block "
                         f"{block_size}")
    return n // block_size


def lt_mult_torch(a, b, c, *, block_size: int):
    """a, b: (bh, n, m); c: (bh, n, k) -> (bh, n, k) in c's dtype, f32
    accumulation; n % block_size == 0."""
    t = _check(a, b, c, block_size)
    bh, n, m = a.shape
    kk = c.shape[-1]
    blk = block_size
    f32 = torch.float32
    ab = a.to(f32).reshape(bh, t, blk, m)
    bb = b.to(f32).reshape(bh, t, blk, m)
    cb = c.to(f32).reshape(bh, t, blk, kk)
    h = bb.transpose(-1, -2) @ cb                  # (bh, t, m, k)
    z = torch.cumsum(h, dim=1) - h                 # exclusive prefix
    tri = torch.ones(blk, blk, dtype=f32, device=a.device).tril()
    w = (ab @ bb.transpose(-1, -2)) * tri
    out = w @ cb + ab @ z
    return out.reshape(bh, n, kk).to(c.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("lt_mult")
    fn = lib.lt_mult_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return lib


def lt_mult_cuda(a, b, c, *, block_size: int):
    """The CUDA kernel; same contract as lt_mult_torch.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) with
    m <= 128 and k <= 128; raises on anything else. Launches on the
    current stream and does not synchronise.
    """
    xs = (a, b, c)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"lt_mult_cuda takes CUDA tensors, got {dev}")
    if any(x.device != dev for x in xs):
        raise ValueError("all inputs must be on one device")
    if a.dtype not in _DTYPES or any(x.dtype != a.dtype for x in xs):
        raise TypeError("inputs must all be float32 or all bfloat16, got "
                        f"{[x.dtype for x in xs]}")
    t = _check(a, b, c, block_size)
    bh, n, m = a.shape
    kk = c.shape[-1]
    if m > 128 or kk > 128:
        raise ValueError(f"kernel takes m <= 128 and k <= 128, got m={m}, "
                         f"k={kk}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("inputs must be contiguous")
    out = torch.empty_like(c)
    hz = torch.empty(bh, t, m, kk, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().lt_mult_forward(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
            hz.data_ptr(), bh, n, m, kk, block_size, _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"lt_mult_forward failed: CUDA error {err} "
                           f"(bh={bh}, n={n}, m={m}, k={kk}, b={block_size})")
    lt_mult_cuda.launches += 1
    return out


lt_mult_cuda.launches = 0
