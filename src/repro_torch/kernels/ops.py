"""Public wrappers around the port's kernels.

Port of the JAX package's ``kernels/ops.py`` (``lt_mult``,
``polysketch_attention``, ``poly_attention``, ``REFS``). The device of
the inputs picks the implementation: a CUDA tensor goes to the
hand-written kernel (which raises if it cannot run; there is no
fallback), a CPU tensor to the kernel's plain PyTorch version.
``impl="torch"`` asks for the plain version on any device, so a kernel
can be held against it on the card.

Batching convention: leading dims (B, H, ...) are flattened to one `bh`
axis before the kernel and restored after. GQA repeats kv heads to query
heads, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.lt_mult import lt_mult_cuda, lt_mult_torch
from repro_torch.kernels.poly_flash import poly_flash_cuda, poly_flash_torch
from repro_torch.kernels.polysketch_causal import (factored_to_z,
                                                   polysketch_causal_cuda,
                                                   polysketch_causal_torch,
                                                   z_to_factored)
from repro_torch.utils import pad_to_multiple


def _flatten_bh(*xs):
    lead = xs[0].shape[:-2]
    return lead, [x.reshape(-1, *x.shape[-2:]).contiguous() for x in xs]


def _pick(impl, x, cuda_fn, torch_fn):
    if impl not in (None, "torch"):
        raise ValueError(f"impl must be None or 'torch', got {impl!r}")
    return cuda_fn if impl is None and x.is_cuda else torch_fn


def lt_mult(a, b, c, *, block_size: int = 256, impl: str | None = None):
    """lt(A B^T) C over the last two axes; leading dims are batch.

    a, b: (..., n, m); c: (..., n, k). n must be a multiple of
    min(block_size, n), as the reference asserts.
    """
    fn = _pick(impl, c, lt_mult_cuda, lt_mult_torch)
    lead, (af, bf, cf) = _flatten_bh(a, b, c)
    out = fn(af, bf, cf, block_size=min(block_size, a.shape[-2]))
    return out.reshape(*lead, *out.shape[-2:])


def polysketch_attention(qm, km, q, k, v, *, degree: int, scale: float,
                         local_exact: bool = True, block_size: int = 256,
                         z0=None, return_state: bool = False,
                         impl: str | None = None):
    """Fused causal polysketch attention.

    qm, km: (B, Hq|Hkv, S, r) sketched (pre-scaled) q/k; q: (B, Hq, S, h);
    k, v: (B, Hkv, S, h). Returns (B, Hq, S, h).

    z0: optional (B, Hq|Hkv, r^2, h+1) initial prefix state (kv heads are
    repeated like km). With return_state, returns (out, z) where z
    (B, Hq, r^2, h+1) is the state after folding ALL tokens, a final
    partial block included (padded keys add exact zeros).
    impl: None picks by device (the CUDA kernel for CUDA tensors, the
    plain PyTorch version on the CPU); "torch" asks for the plain version.
    """
    fn = _pick(impl, q, polysketch_causal_cuda, polysketch_causal_torch)
    hq, hkv = q.shape[-3], k.shape[-3]
    if hkv != hq:  # GQA: repeat kv to query heads
        g = hq // hkv
        if km.shape[-3] != hq:
            km = km.repeat_interleave(g, dim=-3)
        k = k.repeat_interleave(g, dim=-3)
        v = v.repeat_interleave(g, dim=-3)
        if z0 is not None and z0.shape[-3] != hq:
            z0 = z0.repeat_interleave(g, dim=-3)
    n = q.shape[-2]
    blk = min(block_size, n)
    qm, km, q, k, v = (pad_to_multiple(x, blk, axis=-2)[0]
                       for x in (qm, km, q, k, v))
    lead, (qmf, kmf, qf, kf, vf) = _flatten_bh(qm, km, q, k, v)
    zv0 = zd0 = None
    if z0 is not None:
        zv0, zd0 = z_to_factored(z0.to(torch.float32).expand(
            *lead, *z0.shape[-2:]))
        zv0 = zv0.reshape(-1, *zv0.shape[-2:]).contiguous()
        zd0 = zd0.reshape(-1, *zd0.shape[-2:]).contiguous()
    out = fn(qmf, kmf, qf, kf, vf, zv0, zd0, degree=degree, scale=scale,
             local_exact=local_exact, block_size=blk,
             return_state=return_state)
    if return_state:
        out, zv, zd = out
        z = factored_to_z(zv.reshape(*lead, *zv.shape[-2:]),
                          zd.reshape(*lead, *zd.shape[-2:]))
        return out.reshape(*lead, *out.shape[-2:])[..., :n, :], z
    return out.reshape(*lead, *out.shape[-2:])[..., :n, :]


def poly_attention(q, k, v, *, degree: int, scale: float | None = None,
                   causal: bool = True, impl: str | None = None):
    """Exact (quadratic) polynomial attention. q: (B, Hq, S, h); k, v:
    (B, Hkv, T, h) -> (B, Hq, S, h). Causal needs S == T.

    Any S: the kernel masks a ragged last tile itself, so nothing is
    padded.
    """
    fn = _pick(impl, q, poly_flash_cuda, poly_flash_torch)
    if scale is None:
        scale = 1.0 / q.shape[-1]
    hq, hkv = q.shape[-3], k.shape[-3]
    if hkv != hq:  # GQA: repeat kv to query heads
        g = hq // hkv
        k = k.repeat_interleave(g, dim=-3)
        v = v.repeat_interleave(g, dim=-3)
    lead, (qf, kf, vf) = _flatten_bh(q, k, v)
    out = fn(qf, kf, vf, degree=degree, scale=scale, causal=causal)
    return out.reshape(*lead, *out.shape[-2:])


REFS = {
    "lt_mult": _ref.lt_mult_ref,
    "polysketch_causal": _ref.polysketch_causal_ref,
    "poly_flash": _ref.poly_flash_ref,
}
