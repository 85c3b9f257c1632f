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

The backward (the JAX package has none: it trains through XLA's gradient
of the jnp block path) comes in the same two forms:
``polysketch_causal_backward_torch`` and ``polysketch_causal_backward_cuda``
(``csrc/polysketch_causal_bwd.cu``). Both read what the forward saves with
``return_saved``: the exclusive prefix state Z_l of every block and
1 + den of every row. ``polysketch_causal_autograd`` joins a forward and a
backward in a ``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.utils import int_pow, int_pow0


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


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_block(n, block_size):
    blk = min(block_size, n)
    if n % blk:
        raise ValueError(f"n={n} is not a multiple of the block {blk}; "
                         "pad at the ops layer")
    return blk


def polysketch_causal_torch(qm, km, q, k, v, zv0=None, zd0=None, *,
                            degree: int, scale: float,
                            local_exact: bool = True, block_size: int = 256,
                            return_state: bool = False,
                            return_saved: bool = False):
    """qm, km: (bh, n, r); q, k, v: (bh, n, h) -> (bh, n, h) in v's dtype.

    zv0 (bh, r, r*h) / zd0 (bh, r, r): optional factored initial state.
    With return_state, also returns (zv, zd) after folding every block.
    With return_saved, returns (out, zv, zd, saved) where saved = (hv
    (bh, t, r, r*h), hd (bh, t, r, r), den1 (bh, n)): the exclusive prefix
    state each block read and 1 + den of each row, what the backward needs.
    The arithmetic of the Pallas kernel's body, one block at a time, in
    f32 (float64 for float64 inputs: the reference the f32 paths' errors
    are measured against).
    """
    bh, n, r = qm.shape
    h = v.shape[-1]
    blk = _check_block(n, block_size)
    f32 = torch.float64 if v.dtype == torch.float64 else torch.float32
    dev = qm.device
    zv = (torch.zeros(bh, r, r * h, dtype=f32, device=dev) if zv0 is None
          else zv0.to(f32))
    zd = (torch.zeros(bh, r, r, dtype=f32, device=dev) if zd0 is None
          else zd0.to(f32))
    tri = torch.ones(blk, blk, dtype=f32, device=dev).tril()
    outs, hvs, hds, dens = [], [], [], []
    for t in range(n // blk):
        sl = slice(t * blk, (t + 1) * blk)
        qm_l, km_l, v_l = qm[:, sl].to(f32), km[:, sl].to(f32), v[:, sl].to(f32)
        hvs.append(zv)
        hds.append(zd)
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
        dens.append(1.0 + den)
        outs.append((num / dens[-1][..., None]).to(v.dtype))
        # ---- state update: fold this block's keys into the prefix ----
        u = (km_l[..., None] * v_l[:, :, None, :]).reshape(bh, blk, r * h)
        zv = zv + km_l.transpose(1, 2) @ u
        zd = zd + km_l.transpose(1, 2) @ km_l
    out = torch.cat(outs, dim=1)
    if return_saved:
        saved = (torch.stack(hvs, 1), torch.stack(hds, 1), torch.cat(dens, 1))
        return out, zv, zd, saved
    return (out, zv, zd) if return_state else out


def polysketch_causal_backward_torch(dout, qm, km, q, k, v, out, saved, *,
                                     degree: int, scale: float,
                                     local_exact: bool = True,
                                     block_size: int = 256):
    """Gradients of polysketch_causal_torch's output, in the kernel's three
    passes, from what the forward saved (float32).

    dout, out: (bh, n, h); saved = (hv, hd, den1) from return_saved, float32.
    The operands are float32 or bfloat16, one type; bfloat16 ones are
    taken to float32, as the kernel stages them, the arithmetic is float32,
    and the gradients are returned in the operands' type (dzv0, dzd0 in
    float32).
    Returns (dqm, dkm, dq, dk, dv, dzv0, dzd0); dq and dk are zero without
    local_exact (q and k are not read then).

    With g = [dO / D | -(dO . out) / D] (D = 1 + den) and Phi(x) = x (x) x:
      pass 1  dZ_l = sum_{i in l} Phi(qm_i) g_i^T, block by block;
      pass 2  dH_l = sum_{l' > l} dZ_l', right to left; dz0 = sum_l dZ_l;
      pass 3  per block: the diagonal's dq, dk, dv (and dqm, dkm without
              local_exact); dqm = (M + M^T) qm with M = Z_l g; dkm =
              (N + N^T) km with N = dH_l [v | 1]; dv += Phi(km) dHv_l.
    """
    dt = qm.dtype
    if dt not in _DTYPES or any(x.dtype != dt for x in (dout, km, q, k, v, out)):
        raise TypeError("the backward takes float32 or bfloat16 operands of "
                        f"one type, got {[x.dtype for x in (dout, qm, km, q, k, v, out)]}")
    if any(x.dtype != torch.float32 for x in saved):
        raise TypeError("the forward's saved state and 1 + den are float32")
    dout, qm, km, q, k, v, out = (x.to(torch.float32)
                                  for x in (dout, qm, km, q, k, v, out))
    grads = _backward_f32(dout, qm, km, q, k, v, out, saved, degree=degree,
                          scale=scale, local_exact=local_exact,
                          block_size=block_size)
    return tuple(g.to(dt) for g in grads[:5]) + grads[5:]


def _backward_f32(dout, qm, km, q, k, v, out, saved, *, degree, scale,
                  local_exact, block_size):
    bh, n, r = qm.shape
    h = v.shape[-1]
    blk = _check_block(n, block_size)
    t = n // blk
    f32 = torch.float32
    hv, hd, den1 = saved
    z = factored_to_z(hv, hd)                                # (bh, t, r*r, h+1)
    inv = 1.0 / den1
    dnum = dout * inv[..., None]
    g = torch.cat([dnum, (-(dout * out).sum(-1) * inv)[..., None]], -1)
    ones = torch.ones(bh, n, 1, dtype=f32, device=qm.device)
    v1 = torch.cat([v, ones], -1)

    def blocks(x):
        return x.reshape(bh, t, blk, x.shape[-1])

    qmb, kmb, gb, v1b = blocks(qm), blocks(km), blocks(g), blocks(v1)
    # pass 1: dZ_l = Qm_l^T [Qm_l (x) g_l]
    u = (qmb[..., None] * gb[..., None, :]).reshape(bh, t, blk, r * (h + 1))
    dz = (qmb.transpose(-1, -2) @ u).reshape(bh, t, r * r, h + 1)
    # pass 2: the exclusive suffix, right to left from zero
    acc = torch.zeros(bh, r * r, h + 1, dtype=f32, device=qm.device)
    dh = [None] * t
    for l in reversed(range(t)):
        dh[l] = acc
        acc = acc + dz[:, l]
    dzv0, dzd0 = z_to_factored(acc)
    # pass 3: block by block
    tri = torch.ones(blk, blk, dtype=f32, device=qm.device).tril()
    dqm, dkm, dq, dk, dv = ([] for _ in range(5))
    for l in range(t):
        sl = slice(l * blk, (l + 1) * blk)
        qm_l, km_l, g_l, v1_l = qmb[:, l], kmb[:, l], gb[:, l], v1b[:, l]
        if local_exact:
            x = q[:, sl] @ k[:, sl].transpose(1, 2) * scale
            w = int_pow(x, degree) * tri
            dx = degree * int_pow0(x, degree - 1) * scale
        else:
            x = qm_l @ km_l.transpose(1, 2)
            w = x * x * tri
            dx = 2.0 * x
        ds = dx * (g_l @ v1_l.transpose(1, 2)) * tri          # dS, masked
        dv_l = w.transpose(1, 2) @ g_l[..., :h]
        m = (g_l @ z[:, l].transpose(1, 2)).reshape(bh, blk, r, r)
        dqm_l = ((m @ qm_l[..., None]) + (m.transpose(-1, -2) @ qm_l[..., None]))[..., 0]
        nn = (v1_l @ dh[l].transpose(1, 2)).reshape(bh, blk, r, r)
        dkm_l = ((nn @ km_l[..., None]) + (nn.transpose(-1, -2) @ km_l[..., None]))[..., 0]
        phi = (km_l[..., None] * km_l[..., None, :]).reshape(bh, blk, r * r)
        dv_l = dv_l + phi @ dh[l][..., :h]
        if local_exact:
            dq.append(ds @ k[:, sl])
            dk.append(ds.transpose(1, 2) @ q[:, sl])
        else:
            dqm_l = dqm_l + ds @ km_l
            dkm_l = dkm_l + ds.transpose(1, 2) @ qm_l
        dqm.append(dqm_l)
        dkm.append(dkm_l)
        dv.append(dv_l)
    cat = lambda xs: torch.cat(xs, 1)  # noqa: E731
    if local_exact:
        dq, dk = cat(dq), cat(dk)
    else:
        dq, dk = torch.zeros_like(q), torch.zeros_like(k)
    return cat(dqm), cat(dkm), dq, dk, cat(dv), dzv0, dzd0


def _lib():
    lib = build.load("polysketch_causal")
    fn = lib.polysketch_causal_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 6 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def polysketch_causal_cuda(qm, km, q, k, v, zv0=None, zd0=None, *,
                           degree: int, scale: float,
                           local_exact: bool = True, block_size: int = 256,
                           return_state: bool = False,
                           return_saved: bool = False):
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
    den1 = torch.empty(bh, n, dtype=f32, device=dev) if return_saved else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (*xs, zv0, zd0, out)]
    ptrs += [None if den1 is None else den1.data_ptr()]
    ptrs += [x.data_ptr() for x in (hv, hd, zv, zd)]
    with torch.cuda.device(dev):
        err = _lib().polysketch_causal_forward(
            *ptrs, bh, n, r, h, blk, degree, scale, int(local_exact),
            _DTYPES[qm.dtype], stream)
    if err != 0:
        raise RuntimeError(f"polysketch_causal_forward failed: CUDA error "
                           f"{err} (bh={bh}, n={n}, r={r}, h={h}, b={blk})")
    polysketch_causal_cuda.launches += 1
    if return_saved:
        return out, zv, zd, (hv, hd, den1)
    return (out, zv, zd) if return_state else out


polysketch_causal_cuda.launches = 0

# The forward's kernels in launch order: the fold and the prefix
# (csrc/polysketch_state.cuh), the outputs (csrc/polysketch_causal.cu).
FWD_KERNELS = ("fold_kernel", "prefix_kernel", "output_kernel")


def forward_occupancy(local_exact: bool = True, h: int = 64,
                      dtype=torch.float32) -> dict:
    """What each forward kernel holds on the current card at head width h
    (the h <= 64, r <= 32 instantiations; at h <= 128 the fold's for
    r <= 32, the outputs' for r <= 64) for operands of `dtype`: {name: {"registers", "local_bytes",
    "smem_bytes", "threads", "ctas_per_sm", "warps_per_sm"}}
    (build.occupancy). Needs a CUDA card."""
    return build.occupancy(_lib().polysketch_causal_forward_occupancy,
                           FWD_KERNELS, int(local_exact), h, _DTYPES[dtype])


def _bwd_lib():
    lib = build.load("polysketch_causal_bwd")
    fn = lib.polysketch_causal_backward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 24 + [i] * 6 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return lib


BWD_MAX_R, BWD_MAX_H = 32, 128   # the backward kernel's widths (csrc/polysketch_causal_bwd.cu)


def check_backward_shapes(r: int, h: int):
    """Raise for widths the CUDA backward does not take."""
    if r > BWD_MAX_R or h > BWD_MAX_H:
        raise ValueError(f"the CUDA backward takes r <= {BWD_MAX_R} and "
                         f"h <= {BWD_MAX_H}, got r={r}, h={h}")


def polysketch_causal_backward_cuda(dout, qm, km, q, k, v, out, saved, *,
                                    degree: int, scale: float,
                                    local_exact: bool = True,
                                    block_size: int = 256):
    """The CUDA backward; same contract as polysketch_causal_backward_torch.

    Takes contiguous CUDA tensors, the operands all float32 or all
    bfloat16 (the saved state float32), with r <= 32 and h <= 128; raises
    on anything else. Launches on the current stream and does not
    synchronise.
    """
    hv, hd, den1 = saved
    xs = (dout, qm, km, q, k, v, out, hv, hd, den1)
    dev = qm.device
    if dev.type != "cuda":
        raise ValueError(f"polysketch_causal_backward_cuda takes CUDA tensors, "
                         f"got {dev}")
    if any(x.device != dev for x in xs):
        raise ValueError("all inputs must be on one device")
    dt = qm.dtype
    if dt not in _DTYPES or any(x.dtype != dt for x in xs[:7]) \
            or any(x.dtype != torch.float32 for x in xs[7:]):
        raise TypeError("the backward takes float32 or bfloat16 operands of "
                        "one type and the float32 saved state, got "
                        f"{[x.dtype for x in xs]}")
    bh, n, r = qm.shape
    h = v.shape[-1]
    check_backward_shapes(r, h)
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    blk = _check_block(n, block_size)
    t = n // blk
    shapes = {"dout": (dout, (bh, n, h)), "km": (km, (bh, n, r)),
              "q": (q, (bh, n, h)), "k": (k, (bh, n, h)), "v": (v, (bh, n, h)),
              "out": (out, (bh, n, h)), "hv": (hv, (bh, t, r, r * h)),
              "hd": (hd, (bh, t, r, r)), "den1": (den1, (bh, n))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(x.shape)}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("inputs must be contiguous")
    f32 = torch.float32
    dnum = torch.empty(bh, n, h, dtype=f32, device=dev)
    dden = torch.empty(bh, n, dtype=f32, device=dev)
    dhv, dhd = torch.empty_like(hv), torch.empty_like(hd)
    dqm, dkm = torch.empty_like(qm), torch.empty_like(km)
    make = torch.empty_like if local_exact else torch.zeros_like
    dq, dk, dv = make(q), make(k), torch.empty_like(v)
    dzv0 = torch.empty(bh, r, r * h, dtype=f32, device=dev)
    dzd0 = torch.empty(bh, r, r, dtype=f32, device=dev)
    # the f32 sums of the outputs two kernels add to: the outputs
    # themselves in float32
    part = (lambda x: x) if dt == f32 else (
        lambda x: torch.empty(x.shape, dtype=f32, device=dev))
    dv_part = part(dv)
    dqm_part, dkm_part = (None, None) if local_exact else (part(dqm), part(dkm))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (qm, km, q, k, v, out, dout, den1, hv, hd, dnum,
                                   dden, dhv, dhd, dqm, dkm, dq, dk, dv)]
    ptrs += [None if x is None else x.data_ptr()
             for x in (dqm_part, dkm_part, dv_part)]
    ptrs += [dzv0.data_ptr(), dzd0.data_ptr()]
    with torch.cuda.device(dev):
        err = _bwd_lib().polysketch_causal_backward(
            *ptrs, bh, n, r, h, blk, degree, scale, int(local_exact),
            _DTYPES[dt], stream)
    if err != 0:
        raise RuntimeError(f"polysketch_causal_backward failed: CUDA error "
                           f"{err} (bh={bh}, n={n}, r={r}, h={h}, b={blk}, "
                           f"{dt})")
    polysketch_causal_backward_cuda.launches += 1
    return dqm, dkm, dq, dk, dv, dzv0, dzd0


polysketch_causal_backward_cuda.launches = 0

# The backward's kernels in launch order (csrc/polysketch_causal_bwd.cu).
BWD_KERNELS = ("grad_prep", "grad_fold", "grad_suffix", "grad_query_state",
               "grad_key_state", "grad_query_diag", "grad_key_diag")


def backward_occupancy(local_exact: bool = True, h: int = 64,
                       dtype=torch.float32) -> dict:
    """What each backward kernel holds on the current card at head width h
    (its 64 or its 128 instantiation) for operands of `dtype`: {name:
    {"registers", "local_bytes", "smem_bytes", "threads", "ctas_per_sm",
    "warps_per_sm"}} (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor). Needs a CUDA card."""
    return build.occupancy(_bwd_lib().polysketch_causal_backward_occupancy,
                           BWD_KERNELS, int(local_exact), h, _DTYPES[dtype])


class _PolysketchCausal(torch.autograd.Function):
    """B1 with a gradient: `fwd` saves the prefix states and 1 + den, and
    `bwd` (the kernel or its plain version) turns them into the inputs'
    gradients. A gradient through the returned state raises."""

    @staticmethod
    def forward(ctx, qm, km, q, k, v, zv0, zd0, kw, fwd, bwd):
        out, zv, zd, saved = fwd(qm, km, q, k, v, zv0, zd0, return_saved=True,
                                 **kw)
        ctx.save_for_backward(qm, km, q, k, v, out, *saved)
        ctx.kw, ctx.bwd = kw, bwd
        ctx.set_materialize_grads(False)
        return out, zv, zd

    @staticmethod
    def backward(ctx, dout, dzv, dzd):
        if dzv is not None or dzd is not None:
            raise NotImplementedError(
                "no gradient flows through polysketch attention's returned "
                "state; use its output")
        qm, km, q, k, v, out, *saved = ctx.saved_tensors
        grads = ctx.bwd(dout.contiguous(), qm, km, q, k, v, out, tuple(saved),
                        **ctx.kw)
        grads = [g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad)]
        return (*grads, None, None, None)


def polysketch_causal_autograd(qm, km, q, k, v, zv0, zd0, *, fwd, bwd,
                               degree: int, scale: float,
                               local_exact: bool = True,
                               block_size: int = 256):
    """(out, zv, zd) of `fwd` (polysketch_causal_cuda or _torch) with a
    gradient from `bwd` (polysketch_causal_backward_cuda or _torch) to qm,
    km, q, k, v and, when given, zv0 and zd0. float32 or bfloat16 (the
    state and its gradient float32)."""
    if bwd is polysketch_causal_backward_cuda:
        check_backward_shapes(qm.shape[-1], v.shape[-1])
    kw = dict(degree=degree, scale=scale, local_exact=local_exact,
              block_size=block_size)
    return _PolysketchCausal.apply(qm, km, q, k, v, zv0, zd0, kw, fwd, bwd)
