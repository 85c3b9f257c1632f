"""Exact polynomial attention (paper Section 2.1), the port's oracle.

A^(p)_{ij} = <q'_i, k'_j>^p / (1 + sum_j' <q'_i, k'_j'>^p)   (causal: j <= i)

where q', k' are LayerNorm'd queries/keys and scale = 1/h sits inside the
power (the paper's beta). Port of the JAX package's
``core/poly_attention.py`` (``qk_layernorm``, ``poly_attention_full``).
"""
from __future__ import annotations

import torch

from repro_torch.utils import int_pow


def qk_layernorm(x, scale, bias, eps: float = 1e-6):
    """Paper Section 2.1: LayerNorm on q and k before the polynomial
    (population variance, as jnp.var)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def poly_attention_full(q, k, v, *, degree: int, scale: float | None = None,
                        causal: bool = True):
    """Naive O(n^2) polynomial attention. q,k,v: (..., S, h) / (..., T, h).

    Returns (..., S, h). Accumulates in f32.
    """
    h = q.shape[-1]
    if scale is None:
        scale = 1.0 / h
    logits = torch.einsum("...sh,...th->...st", q.float(), k.float()) * scale
    weights = int_pow(logits, degree)
    if causal:
        s, t = weights.shape[-2], weights.shape[-1]
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        weights = torch.where(mask, weights, torch.zeros((), device=q.device))
    denom = 1.0 + weights.sum(-1, keepdim=True)
    out = torch.einsum("...st,...th->...sh", weights / denom, v.float())
    return out.to(v.dtype)
