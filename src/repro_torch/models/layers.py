"""Shared model layers: norms, dense/embedding init, RoPE, sinusoidal
positions (Whisper's encoder), GLU feed-forward,
the recurrent mixers' causal depthwise conv and the reference's softplus.

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

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import shard_act
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
    if norm.bias is None:
        return rms(x, norm.scale, eps)
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * norm.scale + norm.bias
    return y.to(x.dtype)


def rms(x, scale, eps=1e-6):
    """RMS norm over the last axis in float32, times `scale`, in x's dtype
    (the reference's RMSNorm and its attention's per-head q/k norm)."""
    x32 = x.float()
    ms = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


class Embedding(nn.Module):
    def __init__(self, vocab, d_model, *, generator=None, device="cpu"):
        super().__init__()
        self.table = normal_param((vocab, d_model), 0.02, generator=generator,
                                  device=device)


def rope(x, positions, theta=10000.0):
    """Rotary embeddings on split halves. x: (B, H, S, h), positions: (S,)
    shared by the batch, or (B, S), one row each (the serve engine's slots
    at their own depths)."""
    h = x.shape[-1]
    half = h // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), -idx / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    if ang.dim() == 3:
        ang = ang[:, None]                                # (B, 1, S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(n, d, *, device="cpu"):
    """The (n, d) float32 table of sinusoidal positions, as the reference
    builds it: sin of pos / 10000^(2i/d) in the even columns, cos in the
    odd ones, the cos half taken as ang[:, :d - d // 2]. An odd d above 1
    raises, as it does in the reference: that slice is one column wider
    than the odd columns (at d 1 it is one column against none, which
    broadcasts)."""
    if d % 2 and d > 1:
        raise ValueError(f"sinusoidal positions need an even width, got {d}: "
                         f"the cos half has {d - d // 2} columns for {d // 2} slots")
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d, 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.full((), 10000.0, device=device), dim / d)
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : (d - d // 2)])
    return pe


class GLUFFN(nn.Module):
    def __init__(self, d_model, d_ff, *, generator=None, device="cpu"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.d_ff = d_ff
        self.wi = dense_init(d_model, (d_ff,), **kw)
        self.wg = dense_init(d_model, (d_ff,), **kw)
        self.wo = dense_init(d_ff, (d_model,), **kw)

    def forward(self, x):
        return glu_ffn_apply(self, x)


def glu_ffn_apply(ffn: GLUFFN, x):
    """Over a "model" axis that divides d_ff, each rank computes its own
    mlp columns (wi/wg hold its block, as placed), which meet at the
    reference's gather point "act_mlp": gathered whole under the serving
    rules and contracted with the whole wo, or kept split under the
    training rules, contracted with this rank's rows of wo and summed over
    "model"."""
    dt = x.dtype
    split = tp.local_count(ffn.d_ff) != ffn.d_ff
    partial = split and tp.keeps("act_mlp")
    if partial:
        x = tp.enter(x)
    h = F.gelu(x @ ffn.wg.to(dt), approximate="tanh") * (x @ ffn.wi.to(dt))
    if split:
        h = shard_act(h, "batch", "seq", "act_mlp")
    y = h @ ffn.wo.to(dt)
    return tp.reduce(y) if partial else y


def softplus(x):
    """jax.nn.softplus, logaddexp(x, 0): F.softplus turns into the identity
    above its threshold of 20, the reference does not."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(conv_w, conv_b, x, state=None):
    """Causal depthwise conv over the sequence, as the reference's `_conv`
    and `_conv4` compute it (in x's dtype). x: (B, S, C); state: (B, K-1, C)
    trailing inputs of the previous call (zeros when None). Returns (the
    conv plus its bias, the new trailing inputs)."""
    kw = conv_w.shape[0]
    pad = (x.new_zeros((x.shape[0], kw - 1, x.shape[-1])) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    w = conv_w.to(x.dtype)
    out = sum(w[i] * xp[:, i:i + x.shape[1]] for i in range(kw))
    return out + conv_b.to(x.dtype), xp[:, -(kw - 1):].clone()
