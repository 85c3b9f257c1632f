"""Exact polynomial attention (paper Section 2.1), the port's oracle, and
the softmax baseline.

A^(p)_{ij} = <q'_i, k'_j>^p / (1 + sum_j' <q'_i, k'_j'>^p)   (causal: j <= i)

where q', k' are LayerNorm'd queries/keys and scale = 1/h sits inside the
power (the paper's beta). Port of the JAX package's
``core/poly_attention.py`` (``qk_layernorm``, ``poly_attention_full``,
``softmax_attention_full``, and the sliding-window
``sliding_attention_blocked`` of local attention).
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


def softmax_attention_full(q, k, v, *, scale: float | None = None,
                           causal: bool = True, window: int | None = None):
    """Reference softmax attention (optionally sliding-window), in plain
    ops as the JAX package computes it: f32 logits, masked entries set to
    the f32 minimum (not -inf), the causal mask offset by t - s.
    q: (..., S, h); k, v: (..., T, h) -> (..., S, h) in v's dtype."""
    h = q.shape[-1]
    if scale is None:
        scale = 1.0 / h ** 0.5
    f32 = torch.float32
    logits = torch.einsum("...sh,...th->...st", q.to(f32), k.to(f32)) * scale
    s, t = logits.shape[-2], logits.shape[-1]
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        if window is not None:
            rows = torch.arange(s, device=q.device)[:, None] + (t - s)
            cols = torch.arange(t, device=q.device)[None, :]
            mask = mask & (cols > rows - window)
        logits = logits.masked_fill(~mask, torch.finfo(f32).min)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("...st,...th->...sh", weights, v.to(f32))
    return out.to(v.dtype)


def sliding_attention_blocked(q, k, v, *, window: int,
                              scale: float | None = None):
    """Banded causal softmax attention in O(S * 2w) memory.

    Queries run in blocks of w = min(window, S); each block attends to
    itself (masked) and the previous block, which is exactly the sliding
    window. When S <= w or S is not a multiple of w, the windowed
    ``softmax_attention_full``. q, k, v: (..., S, h) -> (..., S, h) in
    v's dtype."""
    *lead, s, h = q.shape
    w = min(window, s)
    if scale is None:
        scale = 1.0 / float(h) ** 0.5
    if s <= w or s % w:
        return softmax_attention_full(q, k, v, causal=True, window=window,
                                      scale=scale)
    t = s // w
    f32 = torch.float32
    dev = q.device
    qb = q.reshape(*lead, t, w, h).to(f32)
    kb = k.reshape(*lead, t, w, h).to(f32)
    vb = v.reshape(*lead, t, w, h).to(f32)
    # the previous block (zeros before block 0)
    kprev = torch.cat([torch.zeros_like(kb[..., :1, :, :]), kb[..., :-1, :, :]],
                      dim=-3)
    vprev = torch.cat([torch.zeros_like(vb[..., :1, :, :]), vb[..., :-1, :, :]],
                      dim=-3)
    kcat = torch.cat([kprev, kb], dim=-2)               # (..., t, 2w, h)
    vcat = torch.cat([vprev, vb], dim=-2)
    logits = torch.einsum("...tqh,...tkh->...tqk", qb, kcat) * scale
    rows = torch.arange(w, device=dev)[:, None] + w     # absolute pos in 2w
    cols = torch.arange(2 * w, device=dev)[None, :]
    mask = (cols <= rows) & (cols > rows - window)
    first = cols >= w                                   # block 0 has no prev
    m = torch.where(torch.arange(t, device=dev)[:, None, None] == 0,
                    mask & first, mask)
    logits = torch.where(m, logits, torch.finfo(f32).min)
    wts = torch.softmax(logits, dim=-1)
    out = torch.einsum("...tqk,...tkh->...tqh", wts, vcat)
    return out.reshape(*lead, s, h).to(v.dtype)
