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

The backward (the JAX package has none: it trains the polynomial
baseline through XLA's gradient of ``core/poly_attention.py``'s
``poly_attention_full``) comes in the same two forms, causal, float32 or
bfloat16, h <= 128: ``poly_flash_backward_torch`` and
``poly_flash_backward_cuda`` (``csrc/poly_flash_bwd.cu``). Both read the
forward's output and its D_i = 1 + sum_j w_ij (float32), which the
forward returns with ``return_den``, compute in float32 and return the
gradients in the inputs' dtype, as ``jax.grad`` of the reference does.
``poly_flash_autograd`` joins a forward and a backward in a
``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.utils import int_pow, int_pow0


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
                     causal: bool = True, return_den: bool = False,
                     block_q: int = 256):
    """q: (bh, n, h); k, v: (bh, t, h) -> (bh, n, h) in v's dtype.

    f32 accumulators; out = num / (1 + den), as the kernel computes it.
    With return_den, returns (out, D) with D = 1 + den (bh, n) float32,
    what the backward reads. float64 inputs are computed in float64: the
    reference the f32 paths' errors are measured against.
    """
    _, n, t, _ = _check_shapes(q, k, v, causal)
    f32 = torch.float64 if q.dtype == torch.float64 else torch.float32
    kf, vf = k.to(f32), v.to(f32)
    outs, dens = [], []
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
        dens.append(1.0 + w.sum(-1, keepdim=True))
        outs.append((num / dens[-1]).to(v.dtype))
    out = torch.cat(outs, dim=1)
    return (out, torch.cat(dens, dim=1)[..., 0]) if return_den else out


def poly_flash_backward_torch(dout, q, k, v, out, den, *, degree: int,
                              scale: float, block_q: int = 256):
    """Gradients (dq, dk, dv) of causal poly_flash_torch (n == t), from its
    output and D = 1 + den (return_den, float32), one query block at a
    time. dout, q, k, v and out share one dtype, float32 or bfloat16: the
    sums run in float32 and the gradients come back in that dtype. float64
    throughout computes in float64, as a reference.

    With Delta_i = <do_i, out_i>, s_ij = <q_i, k_j> scale, w_ij = s_ij^p,
    dW_ij = (<do_i, v_j> - Delta_i) / D_i and dS_ij = dW_ij p s_ij^(p-1):
      dv_j = sum_{i>=j} (w_ij / D_i) do_i,
      dq_i = scale sum_{j<=i} dS_ij k_j,   dk_j = scale sum_{i>=j} dS_ij q_i.
    """
    bh, n, _, _ = _check_shapes(q, k, v, True)
    dt = q.dtype
    f64 = dt == torch.float64
    if (dt not in (torch.float32, torch.bfloat16, torch.float64)
            or any(x.dtype != dt for x in (dout, k, v, out))
            or den.dtype != (torch.float64 if f64 else torch.float32)):
        raise TypeError("the backward takes dout, q, k, v and out of one dtype "
                        "(float32 or bfloat16) with a float32 den, or float64 "
                        f"throughout; got {[x.dtype for x in (dout, q, k, v, out, den)]}")
    if dout.shape != q.shape or out.shape != q.shape or den.shape != (bh, n):
        raise ValueError(f"shape mismatch: dout {tuple(dout.shape)} out "
                         f"{tuple(out.shape)} den {tuple(den.shape)}")
    f32 = torch.float64 if f64 else torch.float32
    dout, q, k, v, out = (x.to(f32) for x in (dout, q, k, v, out))
    inv = 1.0 / den
    dnum = dout * inv[..., None]                        # do_i / D_i
    dden = -(dout * out).sum(-1) * inv                  # -Delta_i / D_i
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, n, block_q):
        q1 = min(n, q0 + block_q)
        x = q[:, q0:q1] @ k[:, :q1].transpose(1, 2) * scale
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(q1, device=q.device)[None, :]
        above = cols > rows
        w = int_pow(x, degree).masked_fill(above, 0.0)
        dw = dnum[:, q0:q1] @ v[:, :q1].transpose(1, 2) + dden[:, q0:q1, None]
        ds = (degree * int_pow0(x, degree - 1) * scale * dw).masked_fill(above, 0.0)
        dv[:, :q1] += w.transpose(1, 2) @ dnum[:, q0:q1]
        dq[:, q0:q1] = ds @ k[:, :q1]
        dk[:, :q1] += ds.transpose(1, 2) @ q[:, q0:q1]
    return dq.to(dt), dk.to(dt), dv.to(dt)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("poly_flash")
    fn = lib.poly_flash_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 5 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def poly_flash_cuda(q, k, v, *, degree: int, scale: float,
                    causal: bool = True, return_den: bool = False):
    """The CUDA kernel; same contract as poly_flash_torch, any n. With
    return_den the kernel also writes D = 1 + den (its den_out); the
    outputs are the same bits either way.

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
    den = (torch.empty(bh, n, dtype=torch.float32, device=dev) if return_den
           else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().poly_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if den is None else den.data_ptr(), bh, n, t, h, degree,
            scale, int(causal), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"poly_flash_forward failed: CUDA error {err} "
                           f"(bh={bh}, n={n}, t={t}, h={h})")
    poly_flash_cuda.launches += 1
    return (out, den) if return_den else out


poly_flash_cuda.launches = 0

# The forward's kernel (csrc/poly_flash.cu).
FWD_KERNELS = ("poly_flash_kernel",)


def forward_occupancy(h: int = 64, dtype=torch.float32) -> dict:
    """What the forward kernel (causal) holds on the current card at head
    width h (its 64 or its 128 instantiation) for operands of `dtype`:
    {name: {"registers", "local_bytes", "smem_bytes", "threads",
    "ctas_per_sm", "warps_per_sm"}} (build.occupancy). Needs a CUDA card."""
    return build.occupancy(_lib().poly_flash_forward_occupancy, FWD_KERNELS, h,
                           _DTYPES[dtype])

BWD_MAX_H = 128  # the backward kernel's widest head (csrc/poly_flash_bwd.cu)
BWD_STAGE = 32   # queries a stage of the backward kernel, one ordering counter each
# The backward's kernels in launch order (csrc/poly_flash_bwd.cu).
BWD_KERNELS = ("poly_flash_bwd_prep_kernel", "poly_flash_bwd_kernel")


def _bwd_lib():
    lib = build.load("poly_flash_bwd")
    fn = lib.poly_flash_backward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 4 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def check_backward_shapes(h: int):
    """Raise for a head width the CUDA backward does not take."""
    if h > BWD_MAX_H:
        raise ValueError(f"the CUDA backward takes h <= {BWD_MAX_H}, got h={h}")


def poly_flash_backward_cuda(dout, q, k, v, out, den, *, degree: int,
                             scale: float):
    """The CUDA backward; same contract as poly_flash_backward_torch.

    Takes contiguous CUDA tensors, dout, q, k, v and out all float32 or
    all bfloat16 and den float32, with h <= 128, causal (n == t); raises
    on anything else. Returns dq, dk and dv in the inputs' dtype. Launches
    on the current stream and does not synchronise.
    """
    xs = (dout, q, k, v, out, den)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"poly_flash_backward_cuda takes CUDA tensors, got {dev}")
    if any(x.device != dev for x in xs):
        raise ValueError("all inputs must be on one device")
    dt = q.dtype
    if (dt not in _DTYPES or any(x.dtype != dt for x in (dout, k, v, out))
            or den.dtype != torch.float32):
        raise TypeError("the backward takes dout, q, k, v and out all float32 "
                        "or all bfloat16 and a float32 den, got "
                        f"{[x.dtype for x in xs]}")
    bh, n, _, h = _check_shapes(q, k, v, True)
    check_backward_shapes(h)
    if dout.shape != q.shape or out.shape != q.shape or den.shape != (bh, n):
        raise ValueError(f"shape mismatch: dout {tuple(dout.shape)} out "
                         f"{tuple(out.shape)} den {tuple(den.shape)}")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("inputs must be contiguous")
    f32 = dict(dtype=torch.float32, device=dev)
    dnum = torch.empty(q.shape, **f32)
    dden = torch.empty_like(den)
    # the work-item ticket and one counter per (bh, query stage), which the
    # kernel's prep launch zeroes
    sync = torch.empty(1 + bh * -(-n // BWD_STAGE), dtype=torch.int32, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # dq's f32 sums across key tiles: dq itself in f32
    dqa = dq if dt == torch.float32 else torch.empty(q.shape, **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (q, k, v, out, dout, den, dnum, dden, sync, dqa,
                                   dq, dk, dv)]
    with torch.cuda.device(dev):
        err = _bwd_lib().poly_flash_backward(*ptrs, bh, n, h, degree, scale,
                                             _DTYPES[dt], stream)
    if err != 0:
        raise RuntimeError(f"poly_flash_backward failed: CUDA error {err} "
                           f"(bh={bh}, n={n}, h={h}, {dt})")
    poly_flash_backward_cuda.launches += 1
    return dq, dk, dv


poly_flash_backward_cuda.launches = 0


def backward_occupancy(h: int = 64, dtype=torch.float32) -> dict:
    """What each backward kernel holds on the current card at head width h
    (its 64 or its 128 instantiation) for operands of `dtype`: {name:
    {"registers", "local_bytes", "smem_bytes", "threads", "ctas_per_sm",
    "warps_per_sm"}} (build.occupancy). Needs a CUDA card."""
    return build.occupancy(_bwd_lib().poly_flash_backward_occupancy, BWD_KERNELS,
                           h, _DTYPES[dtype])


class _PolyFlash(torch.autograd.Function):
    """Causal B2 with a gradient: `fwd` returns D = 1 + den beside its
    output, and `bwd` (the kernel or its plain version) turns q, k, v,
    the output and D into the inputs' gradients."""

    @staticmethod
    def forward(ctx, q, k, v, kw, fwd, bwd):
        out, den = fwd(q, k, v, causal=True, return_den=True, **kw)
        ctx.save_for_backward(q, k, v, out, den)
        ctx.kw, ctx.bwd = kw, bwd
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, den = ctx.saved_tensors
        grads = ctx.bwd(dout.contiguous(), q, k, v, out, den, **ctx.kw)
        grads = [g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad)]
        return (*grads, None, None, None)


def poly_flash_autograd(q, k, v, *, fwd, bwd, degree: int, scale: float):
    """Causal out of `fwd` (poly_flash_cuda or _torch) with a gradient
    from `bwd` (poly_flash_backward_cuda or _torch) to q, k and v, in
    their dtype (float32 or bfloat16)."""
    if bwd is poly_flash_backward_cuda:
        check_backward_shapes(q.shape[-1])
    return _PolyFlash.apply(q, k, v, dict(degree=degree, scale=scale), fwd, bwd)
