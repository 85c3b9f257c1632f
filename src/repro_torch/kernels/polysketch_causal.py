"""Fused causal PolySketch attention: the CUDA kernel and its plain version.

Replaces the JAX package's Pallas TPU kernel
``kernels/polysketch_causal.py::polysketch_causal_pallas``. Both versions
here compute its function on the factored prefix state

   Zv[i, j*h + d] = sum_s m_s[i] m_s[j] v_s[d]     (bh, r, r*h) f32
   Zd[i, j]       = sum_s m_s[i] m_s[j]            (bh, r, r)   f32

- ``polysketch_causal_torch``: plain PyTorch, block by block like the
  Pallas grid. The CPU path, and the yardstick the kernel is held to.
- ``polysketch_causal_cuda``: the hand-written Hopper kernel in
  ``csrc/polysketch_causal.cu`` (design and bound in its header), bound
  through ctypes. ``polysketch_causal_cuda.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.utils import int_pow


def z_to_factored(z):
    """(..., r^2, h+1) combined state -> factored (zv (..., r, r*h), zd (..., r, r)).

    z[..., i*r + j, d] = Zv[..., i, j*h + d] for d < h; z[..., i*r + j, h] = Zd[..., i, j].
    """
    *lead, rr, h1 = z.shape
    r = int(round(rr ** 0.5))
    h = h1 - 1
    zf = z.reshape(*lead, r, r, h1)
    return zf[..., :h].reshape(*lead, r, r * h), zf[..., h]


def factored_to_z(zv, zd):
    """Inverse of z_to_factored."""
    *lead, r, rh = zv.shape
    h = rh // r
    zf = torch.cat([zv.reshape(*lead, r, r, h), zd[..., None]], dim=-1)
    return zf.reshape(*lead, r * r, h + 1)


def _check_block(n, block_size):
    blk = min(block_size, n)
    if n % blk:
        raise ValueError(f"n={n} is not a multiple of the block {blk}; "
                         "pad at the ops layer")
    return blk


def polysketch_causal_torch(qm, km, q, k, v, zv0=None, zd0=None, *,
                            degree: int, scale: float,
                            local_exact: bool = True, block_size: int = 256,
                            return_state: bool = False):
    """qm, km: (bh, n, r); q, k, v: (bh, n, h) -> (bh, n, h) in v's dtype.

    zv0 (bh, r, r*h) / zd0 (bh, r, r): optional factored initial state.
    With return_state, also returns (zv, zd) after folding every block.
    The arithmetic of the Pallas kernel's body, one block at a time.
    """
    bh, n, r = qm.shape
    h = v.shape[-1]
    blk = _check_block(n, block_size)
    f32 = torch.float32
    dev = qm.device
    zv = (torch.zeros(bh, r, r * h, dtype=f32, device=dev) if zv0 is None
          else zv0.to(f32))
    zd = (torch.zeros(bh, r, r, dtype=f32, device=dev) if zd0 is None
          else zd0.to(f32))
    tri = torch.ones(blk, blk, dtype=f32, device=dev).tril()
    outs = []
    for t in range(n // blk):
        sl = slice(t * blk, (t + 1) * blk)
        qm_l, km_l, v_l = qm[:, sl].to(f32), km[:, sl].to(f32), v[:, sl].to(f32)
        # ---- diagonal block (exact local polynomial attention, S3.2) ----
        if local_exact:
            w = int_pow(q[:, sl].to(f32) @ k[:, sl].to(f32).transpose(1, 2)
                        * scale, degree)
        else:
            w = qm_l @ km_l.transpose(1, 2)
            w = w * w
        w = w * tri
        num = w @ v_l
        den = w.sum(-1)
        # ---- cross-block sketched prefix ----
        tv = (qm_l @ zv).reshape(bh, blk, r, h)
        num = num + (qm_l[..., None] * tv).sum(2)
        den = den + (qm_l * (qm_l @ zd)).sum(-1)
        outs.append((num / (1.0 + den)[..., None]).to(v.dtype))
        # ---- state update: fold this block's keys into the prefix ----
        u = (km_l[..., None] * v_l[:, :, None, :]).reshape(bh, blk, r * h)
        zv = zv + km_l.transpose(1, 2) @ u
        zd = zd + km_l.transpose(1, 2) @ km_l
    out = torch.cat(outs, dim=1)
    return (out, zv, zd) if return_state else out


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("polysketch_causal")
    fn = lib.polysketch_causal_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 6 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def polysketch_causal_cuda(qm, km, q, k, v, zv0=None, zd0=None, *,
                           degree: int, scale: float,
                           local_exact: bool = True, block_size: int = 256,
                           return_state: bool = False):
    """The CUDA kernel; same contract as polysketch_causal_torch.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16), with
    r <= 64 and h <= 128; raises on anything else.
    Launches on the current stream and does not synchronise.
    """
    xs = (qm, km, q, k, v)
    dev = qm.device
    if dev.type != "cuda":
        raise ValueError(f"polysketch_causal_cuda takes CUDA tensors, got {dev}")
    if any(x.device != dev for x in xs):
        raise ValueError("all inputs must be on one device")
    if qm.dtype not in _DTYPES or any(x.dtype != qm.dtype for x in xs):
        raise TypeError("inputs must all be float32 or all bfloat16, got "
                        f"{[x.dtype for x in xs]}")
    if any(x.dim() != 3 for x in xs):
        raise ValueError("inputs must be (bh, n, features)")
    bh, n, r = qm.shape
    h = v.shape[-1]
    if km.shape != qm.shape or q.shape != v.shape or k.shape != v.shape \
            or v.shape[:2] != (bh, n):
        raise ValueError(f"shape mismatch: qm {tuple(qm.shape)} km "
                         f"{tuple(km.shape)} q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if r > 64 or h > 128:
        raise ValueError(f"kernel takes r <= 64 and h <= 128, got r={r}, "
                         f"h={h}")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("inputs must be contiguous")
    blk = _check_block(n, block_size)
    f32 = torch.float32
    if zv0 is None:
        zv0 = torch.zeros(bh, r, r * h, dtype=f32, device=dev)
    if zd0 is None:
        zd0 = torch.zeros(bh, r, r, dtype=f32, device=dev)
    for z, shape in ((zv0, (bh, r, r * h)), (zd0, (bh, r, r))):
        if tuple(z.shape) != shape or z.dtype != f32 or z.device != dev \
                or not z.is_contiguous():
            raise ValueError(f"initial state must be contiguous float32 "
                             f"{shape} on {dev}, got {z.dtype} "
                             f"{tuple(z.shape)} on {z.device}")
    t = n // blk
    out = torch.empty_like(v)
    hv = torch.empty(bh, t, r, r * h, dtype=f32, device=dev)
    hd = torch.empty(bh, t, r, r, dtype=f32, device=dev)
    zv = torch.empty(bh, r, r * h, dtype=f32, device=dev)
    zd = torch.empty(bh, r, r, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (*xs, zv0, zd0, out, hv, hd, zv, zd)]
    with torch.cuda.device(dev):
        err = _lib().polysketch_causal_forward(
            *ptrs, bh, n, r, h, blk, degree, scale, int(local_exact),
            _DTYPES[qm.dtype], stream)
    if err != 0:
        raise RuntimeError(f"polysketch_causal_forward failed: CUDA error "
                           f"{err} (bh={bh}, n={n}, r={r}, h={h}, b={blk})")
    polysketch_causal_cuda.launches += 1
    return (out, zv, zd) if return_state else out


polysketch_causal_cuda.launches = 0
