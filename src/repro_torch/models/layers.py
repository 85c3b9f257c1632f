"""Shared model layers: norms, dense/embedding init, RoPE, GLU feed-forward.

Port of the JAX package's ``models/layers.py``. Weights keep the JAX
layouts (a dense weight is (d_in, *d_out)), so the parameter bridge moves
arrays without transposing them. Init draws from a CPU
``torch.Generator`` with the reference's distributions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.utils import const_param, normal_param


def dense_init(d_in, d_out_dims, *, generator=None, device="cpu", scale=None):
    """Weight of shape (d_in, *d_out_dims), N(0, 1) * scale (fan-in init)."""
    shape = (d_in, *d_out_dims)
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return normal_param(shape, scale, generator=generator, device=device)


class Norm(nn.Module):
    """LayerNorm (scale + bias) or RMSNorm (scale only), eps 1e-6."""

    def __init__(self, dim, kind="rmsnorm", *, device="cpu"):
        super().__init__()
        self.scale = const_param((dim,), 1.0, device=device)
        self.bias = (const_param((dim,), 0.0, device=device)
                     if kind == "layernorm" else None)

    def forward(self, x):
        return norm_apply(self, x)


def norm_apply(norm: Norm, x, eps=1e-6):
    x32 = x.float()
    if norm.bias is not None:
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * norm.scale + norm.bias
    else:
        ms = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * norm.scale
    return y.to(x.dtype)


class Embedding(nn.Module):
    def __init__(self, vocab, d_model, *, generator=None, device="cpu"):
        super().__init__()
        self.table = normal_param((vocab, d_model), 0.02, generator=generator,
                                  device=device)


def rope(x, positions, theta=10000.0):
    """Rotary embeddings on split halves. x: (B, H, S, h), positions: (S,)."""
    h = x.shape[-1]
    half = h // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), -idx / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)             # (S, half)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


class GLUFFN(nn.Module):
    def __init__(self, d_model, d_ff, *, generator=None, device="cpu"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.wi = dense_init(d_model, (d_ff,), **kw)
        self.wg = dense_init(d_model, (d_ff,), **kw)
        self.wo = dense_init(d_ff, (d_model,), **kw)

    def forward(self, x):
        return glu_ffn_apply(self, x)


def glu_ffn_apply(ffn: GLUFFN, x):
    dt = x.dtype
    h = F.gelu(x @ ffn.wg.to(dt), approximate="tanh") * (x @ ffn.wi.to(dt))
    return h @ ffn.wo.to(dt)
