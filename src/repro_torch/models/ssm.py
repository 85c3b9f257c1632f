"""Mamba-2 SSD (state-space duality) mixer.

Port of the JAX package's ``models/ssm.py``. The chunked algorithm has
the paper's Section 3.1 block lower-triangular structure with a decay
factor: inside a chunk a masked quadratic product, across chunks a
prefix state updated in order (here the (N x P) SSM state in place of the
(r^2 x h) sketch state).

Recurrence (per head; state N, head width P):
  dt_t = softplus(dt_raw_t + dt_bias)
  a_t  = -exp(A_log) * dt_t
  h_t  = exp(a_t) h_{t-1} + dt_t * B_t x_t^T        (N x P)
  y_t  = C_t^T h_t + D * x_t

The SSD runs in f32 whatever the compute dtype, and its state h stays f32
in the cache; the conv window takes the compute dtype. Plain PyTorch ops:
the reference computes this mixer with jnp and lax.scan, no Pallas
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.decode import RecurrentCache, recurrent_update
from repro_torch.core.state import StateSpec, batch_shard_axes, register_state
from repro_torch.distributed.sharding import shard_act
from repro_torch.models.layers import causal_conv, dense_init, softplus
from repro_torch.utils import (const_param, normal_param, pad_to_multiple,
                               tensor_param)


def ssd_chunked(x, b, c, dt, a_log, *, chunk: int = 64, h0=None,
                return_state: bool = False, fixed_grid: bool = False):
    """x: (B,S,H,P); b, c: (B,S,N); dt: (B,S,H) post-softplus.

    Returns y (B,S,H,P), or (y, h_final) with return_state, h_final the
    exact (B,H,N,P) state after the last token (what a resumed call passes
    back as h0). f32 inside. The sequence is padded to a chunk multiple
    with dt = 0 steps (decay 1, contribution 0), after every real token.

    Two lowerings of the same math:
    - training (no h0, state or fixed grid): the masked quadratic of every
      chunk in one batched product, and only the small cross-chunk state
      update run chunk by chunk;
    - prefill and resume (h0, return_state or fixed_grid): the whole
      chunk computation runs chunk by chunk on fixed shapes, so a prefill
      resumed from h_final at a chunk boundary equals the longer cold
      prefill bit for bit. fixed_grid pins the chunk width when s < chunk.
    """
    f32 = torch.float32
    bs, s, h, p = x.shape
    n = b.shape[-1]
    grid_stable = fixed_grid or return_state or h0 is not None
    l = chunk if fixed_grid else min(chunk, s)
    x, b, c, dt = (pad_to_multiple(v, l, 1)[0] for v in (x, b, c, dt))
    nc = x.shape[1] // l
    x = x.reshape(bs, nc, l, h, p).to(f32)
    b = b.reshape(bs, nc, l, n).to(f32)
    c = c.reshape(bs, nc, l, n).to(f32)
    dt = dt.reshape(bs, nc, l, h).to(f32)
    tri = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    neg_a = torch.exp(a_log.to(f32))                             # (H,)

    if not grid_stable:
        return _ssd_batched(x, b, c, dt, neg_a, tri, s)

    hstate = (x.new_zeros((bs, h, n, p)) if h0 is None else h0.to(f32))
    ys = []
    for k in range(nc):
        x_l, b_l, c_l, dt_l = x[:, k], b[:, k], c[:, k], dt[:, k]
        acum = torch.cumsum(-neg_a * dt_l, dim=1)                 # (B,l,H)
        # within the chunk (masked quadratic, the paper's diagonal block)
        cb = torch.einsum("bin,bjn->bij", c_l, b_l)
        diff = acum[:, :, None, :] - acum[:, None, :, :]          # (B,i,j,H)
        # mask before exp: j > i has diff > 0 and overflows to inf, whose
        # gradient through the mask is NaN
        diff = torch.where(tri[None, :, :, None], diff, -1e30)
        w = cb[..., None] * torch.exp(diff)
        y = torch.einsum("bijh,bjhp->bihp", w, x_l * dt_l[..., None])
        # across chunks, through the carried prefix state
        y = y + torch.einsum("bln,bhnp->blhp", c_l, hstate) \
            * torch.exp(acum)[..., None]
        decay_to_end = torch.exp(acum[:, -1:, :] - acum)          # (B,l,H)
        st = torch.einsum("bln,blhp->bhnp", b_l,
                          (decay_to_end * dt_l)[..., None] * x_l)
        hstate = torch.exp(acum[:, -1, :])[..., None, None] * hstate + st
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bs, nc * l, h, p)[:, :s]
    return (y, hstate) if return_state else y


def _ssd_batched(x, b, c, dt, neg_a, tri, s):
    """The training lowering: the quadratic of all chunks at once, the
    cross-chunk recurrence chunk by chunk. Inputs chunked (B, nc, l, ...)
    f32; returns y (B, s, H, P)."""
    bs, nc, l, h, p = x.shape
    acum = torch.cumsum(-neg_a * dt, dim=2)                       # (B,nc,l,H)
    cb = torch.einsum("bkin,bkjn->bkij", c, b)
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]        # (B,nc,i,j,H)
    diff = torch.where(tri[None, None, :, :, None], diff, -1e30)
    w = cb[..., None] * torch.exp(diff)
    y = torch.einsum("bkijh,bkjhp->bkihp", w, x * dt[..., None])
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)
    states = torch.einsum("bkln,bklhp->bkhnp", b,
                          (decay_to_end * dt)[..., None] * x)
    chunk_decay = torch.exp(acum[:, :, -1, :])                    # (B,nc,H)
    hstate = x.new_zeros((bs, h, b.shape[-1], p))
    starts = []
    for k in range(nc):
        starts.append(hstate)
        hstate = chunk_decay[:, k, :, None, None] * hstate + states[:, k]
    h0 = torch.stack(starts, dim=1)                               # (B,nc,H,N,P)
    y = y + torch.einsum("bkln,bkhnp->bklhp", c, h0) * torch.exp(acum)[..., None]
    return y.reshape(bs, nc * l, h, p)[:, :s]


class SSM(nn.Module):
    """The Mamba-2 mixer; parameters as the reference's ``ssm_init``:
    in_proj (d, 2 d_inner + 2n + heads) for z, (x, B, C) and dt; conv_w
    (K, d_inner + 2n), conv_b; A_log, dt_bias, D (heads,); norm_scale
    (d_inner,); out_proj (d_inner, d)."""

    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_inner = cfg.ssm_expand * d
        n, p = cfg.ssm_state, cfg.ssm_head_dim
        heads = d_inner // p
        conv_dim = d_inner + 2 * n
        kw = dict(generator=generator, device=device)
        self.in_proj = dense_init(d, (d_inner + conv_dim + heads,), **kw)
        self.conv_w = normal_param((cfg.ssm_conv, conv_dim), 0.1, **kw)
        self.conv_b = const_param((conv_dim,), 0.0, device=device)
        self.A_log = tensor_param(torch.log(torch.linspace(1.0, 16.0, heads)),
                                  device)
        self.dt_bias = const_param((heads,), 0.0, device=device)
        self.D = const_param((heads,), 1.0, device=device)
        self.norm_scale = const_param((d_inner,), 1.0, device=device)
        self.out_proj = dense_init(d_inner, (d,), **kw)

    def forward(self, x, *, positions=None, mode: str, cache=None,
                inplace: bool = False):
        """x: (B,S,D) -> (y (B,S,D), new cache or None). In prefill mode
        `cache` is the state the sequence continues from (zeros for a cold
        start): the conv replays its trailing inputs and the SSD scan
        starts at cache.h, on the fixed cfg.lt_block_size chunk grid.
        `inplace` writes a decode step's state into `cache`'s buffers."""
        del positions                       # position-free: no RoPE
        cfg = self.cfg
        d_inner = cfg.ssm_expand * cfg.d_model
        n, p = cfg.ssm_state, cfg.ssm_head_dim
        heads = d_inner // p
        f32 = torch.float32
        proj = shard_act(x @ self.in_proj.to(x.dtype), "batch", "seq", "rnn")
        z = proj[..., :d_inner]
        xbc = proj[..., d_inner:2 * d_inner + 2 * n]
        dt_raw = proj[..., -heads:]
        state = cache.conv if mode in ("decode", "prefill") else None
        xbc, conv_state = causal_conv(self.conv_w, self.conv_b, xbc, state)
        xbc = F.silu(xbc)
        xin = xbc[..., :d_inner]
        bmat = xbc[..., d_inner:d_inner + n]
        cmat = xbc[..., d_inner + n:]
        dt = softplus(dt_raw.to(f32) + self.dt_bias)

        if mode == "decode":
            a = -torch.exp(self.A_log.to(f32)) * dt[:, 0]               # (B,H)
            xh = xin[:, 0].reshape(-1, heads, p).to(f32)
            hs = torch.exp(a)[..., None, None] * cache.h + \
                dt[:, 0, :, None, None] * torch.einsum(
                    "bn,bhp->bhnp", bmat[:, 0].to(f32), xh)
            y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].to(f32), hs)
            y = y + self.D[None, :, None] * xh
            y = y.reshape(-1, 1, d_inner)
            new_cache = recurrent_update(cache, hs, conv_state, inplace)
        elif mode in ("prefill", "train"):
            xh = xin.reshape(*xin.shape[:2], heads, p)
            if mode == "prefill":
                y, h_final = ssd_chunked(
                    xh, bmat, cmat, dt, self.A_log, chunk=cfg.lt_block_size,
                    h0=cache.h, return_state=True, fixed_grid=True)
                new_cache = RecurrentCache(h=h_final, conv=conv_state)
            else:
                y = ssd_chunked(xh, bmat, cmat, dt, self.A_log,
                                chunk=min(64, x.shape[1]))
                new_cache = None
            y = y + self.D[None, None, :, None] * xh.to(f32)
            y = y.reshape(*x.shape[:2], d_inner)
        else:
            raise ValueError(f"unknown mode {mode!r}")

        # gated RMS norm, in f32
        y = y.to(x.dtype) * F.silu(z)
        y32 = y.to(f32)
        y = (y32 * torch.rsqrt((y32 * y32).mean(-1, keepdim=True) + 1e-6)
             * self.norm_scale).to(x.dtype)
        return y @ self.out_proj.to(x.dtype), new_cache


def ssm_init_cache(cfg, batch, dtype=torch.float32, device="cpu") -> RecurrentCache:
    d_inner = cfg.ssm_expand * cfg.d_model
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    return RecurrentCache(
        h=torch.zeros((batch, d_inner // p, n, p), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * n),
                         dtype=dtype, device=device))


register_state(StateSpec(
    kind="ssd", node_type=RecurrentCache, granularity="token", resumable=True,
    init=lambda cfg, batch, max_len, dtype, device: ssm_init_cache(
        cfg, batch, dtype, device),
    shard_axes=batch_shard_axes))


def ssd_sequential_ref(x, b, c, dt, a_log):
    """Token-by-token oracle for tests: y (B,S,H,P) in f32."""
    f32 = torch.float32
    bs, s, h, p = x.shape
    n = b.shape[-1]
    dt = dt.to(f32)
    a = -torch.exp(a_log.to(f32))[None, None, :] * dt
    hstate = torch.zeros((bs, h, n, p), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        hstate = torch.exp(a[:, t])[..., None, None] * hstate + \
            dt[:, t, :, None, None] * torch.einsum(
                "bn,bhp->bhnp", b[:, t].to(f32), x[:, t].to(f32))
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t].to(f32), hstate))
    return torch.stack(ys, dim=1)
