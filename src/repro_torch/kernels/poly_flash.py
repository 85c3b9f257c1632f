"""Exact polynomial attention: the CUDA kernel and its plain version.

Replaces the JAX package's Pallas TPU kernel
``kernels/poly_flash.py::poly_flash_pallas``, the paper's quadratic
baseline (Polynomial p=4/8):

   out_i = sum_j w_ij v_j / (1 + sum_j w_ij),  w_ij = (<q_i, k_j> * scale)^p

over j <= i (causal, n == t) or over every key (non-causal).

- ``poly_flash_torch``: plain PyTorch, one query block at a time against
  the keys it may see. The CPU path, and the yardstick the kernel is held
  to.
- ``poly_flash_cuda``: the hand-written Hopper kernel in
  ``csrc/poly_flash.cu`` (design and bound in its header), bound through
  ctypes. ``poly_flash_cuda.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.utils import int_pow


def _check_shapes(q, k, v, causal):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("inputs must be (bh, seq, h)")
    bh, n, h = q.shape
    t = k.shape[1]
    if k.shape != (bh, t, h) or v.shape != (bh, t, h):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if causal and n != t:
        raise ValueError(f"causal attention needs n == t, got n={n}, t={t}")
    return bh, n, t, h


def poly_flash_torch(q, k, v, *, degree: int, scale: float,
                     causal: bool = True, block_q: int = 256):
    """q: (bh, n, h); k, v: (bh, t, h) -> (bh, n, h) in v's dtype.

    f32 accumulators; out = num / (1 + den), as the kernel computes it.
    """
    _, n, t, _ = _check_shapes(q, k, v, causal)
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    outs = []
    for q0 in range(0, n, block_q):
        q1 = min(n, q0 + block_q)
        kend = q1 if causal else t
        w = int_pow(q[:, q0:q1].to(f32) @ kf[:, :kend].transpose(1, 2) * scale,
                    degree)
        if causal:
            rows = torch.arange(q0, q1, device=q.device)[:, None]
            cols = torch.arange(kend, device=q.device)[None, :]
            w = w.masked_fill(cols > rows, 0.0)
        num = w @ vf[:, :kend]
        den = w.sum(-1, keepdim=True)
        outs.append((num / (1.0 + den)).to(v.dtype))
    return torch.cat(outs, dim=1)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("poly_flash")
    fn = lib.poly_flash_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 5 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def poly_flash_cuda(q, k, v, *, degree: int, scale: float,
                    causal: bool = True):
    """The CUDA kernel; same contract as poly_flash_torch, any n.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) with
    h <= 128; raises on anything else. Launches on the current stream and
    does not synchronise.
    """
    xs = (q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"poly_flash_cuda takes CUDA tensors, got {dev}")
    if any(x.device != dev for x in xs):
        raise ValueError("all inputs must be on one device")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in xs):
        raise TypeError("inputs must all be float32 or all bfloat16, got "
                        f"{[x.dtype for x in xs]}")
    bh, n, t, h = _check_shapes(q, k, v, causal)
    if h > 128:
        raise ValueError(f"kernel takes h <= 128, got h={h}")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("inputs must be contiguous")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().poly_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, n,
            t, h, degree, scale, int(causal), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"poly_flash_forward failed: CUDA error {err} "
                           f"(bh={bh}, n={n}, t={t}, h={h})")
    poly_flash_cuda.launches += 1
    return out


poly_flash_cuda.launches = 0
