"""RecurrentGemma recurrent block: gated branches, temporal conv, RG-LRU.

Port of the JAX package's ``models/rglru.py``. RG-LRU per channel:
  r_t = sigmoid(W_a xc_t + b_a)
  i_t = sigmoid(W_x xc_t + b_x)
  log a_t = -c * softplus(Lambda) * r_t
  h_t = exp(log a_t) h_{t-1} + sqrt(1 - exp(2 log a_t)) * (i_t * xc_t)

The linear recurrence h_t = a_t h_{t-1} + b_t is a prefix over the
associative pairs (a, b). The reference evaluates it with
``lax.associative_scan``; PyTorch has none, so ``prefix_scan`` doubles its
stride over log2(S) steps (a Hillis-Steele scan) with the same combine.
The recurrence runs in f32 whatever the compute dtype, and h stays f32 in
the cache. Plain PyTorch ops: the reference has no Pallas kernel here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.decode import RecurrentCache, recurrent_update
from repro_torch.core.state import StateSpec, batch_shard_axes, register_state
from repro_torch.distributed.sharding import shard_act
from repro_torch.models.layers import causal_conv, dense_init, softplus
from repro_torch.utils import const_param, normal_param, tensor_param


def prefix_scan(a, b):
    """Inclusive prefix of the pairs (a_t, b_t) along axis 1 under the
    reference's combine (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): returns
    (A, B) with h_t = B_t + A_t h_{-1}. a, b: (B, S, W)."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def rglru_chunked(a, b, h0, chunk: int):
    """h_t = a_t h_{t-1} + b_t from h0 on a fixed grid: chunk by chunk
    (padded with the identity pair (1, 0)), a parallel prefix inside each.
    Every chunk runs on the same shapes whatever the call's length, so a
    prefill resumed from h0 at a chunk boundary equals the longer cold
    prefill bit for bit. Returns (h (B,S,W), h_last (B,W))."""
    bs, s, w = a.shape
    pad = (-s) % chunk
    if pad:
        a = torch.cat([a, a.new_ones((bs, pad, w))], dim=1)
        b = torch.cat([b, b.new_zeros((bs, pad, w))], dim=1)
    hc, hs = h0, []
    for k in range(a.shape[1] // chunk):
        sl = slice(k * chunk, (k + 1) * chunk)
        prod, zero_resp = prefix_scan(a[:, sl], b[:, sl])
        h = zero_resp + prod * hc[:, None, :]
        # pad steps are the identity: the last column is the state after
        # the chunk's last real token
        hc = h[:, -1, :]
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :s], hc


class RGLRU(nn.Module):
    """The recurrent block; parameters as the reference's ``rglru_init``:
    w_gate, w_in (d, w); conv_w (4, w), conv_b; w_a, w_x (w, w), b_a, b_x;
    lambda (w,), with a^c in [0.9, 0.999] at init; w_out (w, d)."""

    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        w = cfg.rglru_width or d
        kw = dict(generator=generator, device=device)
        self.w_gate = dense_init(d, (w,), **kw)
        self.w_in = dense_init(d, (w,), **kw)
        self.conv_w = normal_param((4, w), 0.1, **kw)
        self.conv_b = const_param((w,), 0.0, device=device)
        self.w_a = dense_init(w, (w,), **kw)
        self.b_a = const_param((w,), 0.0, device=device)
        self.w_x = dense_init(w, (w,), **kw)
        self.b_x = const_param((w,), 0.0, device=device)
        lam = torch.linspace(0.9, 0.999, w)
        self.register_parameter("lambda", tensor_param(
            torch.log(torch.expm1(-torch.log(lam) / cfg.rglru_c)), device))
        self.w_out = dense_init(w, (d,), **kw)

    def coeffs(self, xc):
        """(a, b) of the recurrence from the conv's output, in f32."""
        x32 = xc.to(torch.float32)
        r = torch.sigmoid(x32 @ self.w_a + self.b_a)
        i = torch.sigmoid(x32 @ self.w_x + self.b_x)
        log_a = -self.cfg.rglru_c * softplus(getattr(self, "lambda")) * r
        a = torch.exp(log_a)
        # a floor only, as the reference's clip(., 1e-12)
        b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
            * (i * x32)
        return a, b

    def forward(self, x, *, positions=None, mode: str, cache=None,
                inplace: bool = False):
        """x: (B,S,D) -> (y (B,S,D), new cache or None). In prefill mode
        `cache` (zeros for a cold start) is the state the sequence
        continues from, and the recurrence runs on the fixed
        cfg.lt_block_size chunk grid. `inplace` writes a decode step's
        state into `cache`'s buffers."""
        del positions                       # position-free: no RoPE
        dt = x.dtype
        gate = F.gelu(shard_act(x @ self.w_gate.to(dt), "batch", "seq", "rnn"),
                      approximate="tanh")
        xin = shard_act(x @ self.w_in.to(dt), "batch", "seq", "rnn")
        state = cache.conv if mode in ("decode", "prefill") else None
        xc, conv_state = causal_conv(self.conv_w, self.conv_b, xin, state)
        if mode == "decode":
            a, b = self.coeffs(xc[:, 0])
            h = a * cache.h + b
            y = h[:, None].to(dt)
            new_cache = recurrent_update(cache, h, conv_state, inplace)
        elif mode == "prefill":
            a, b = self.coeffs(xc)
            h, h_last = rglru_chunked(a, b, cache.h, self.cfg.lt_block_size)
            y = h.to(dt)
            new_cache = RecurrentCache(h=h_last, conv=conv_state)
        elif mode == "train":
            a, b = self.coeffs(xc)
            _, h = prefix_scan(a, b)
            y = h.to(dt)
            new_cache = None
        else:
            raise ValueError(f"unknown mode {mode!r}")
        y = y * gate
        return y @ self.w_out.to(dt), new_cache


def rglru_init_cache(cfg, batch, dtype=torch.float32, device="cpu") -> RecurrentCache:
    w = cfg.rglru_width or cfg.d_model
    return RecurrentCache(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, 3, w), dtype=dtype, device=device))


register_state(StateSpec(
    kind="rglru", node_type=RecurrentCache, granularity="token",
    resumable=True,
    init=lambda cfg, batch, max_len, dtype, device: rglru_init_cache(
        cfg, batch, dtype, device),
    shard_axes=batch_shard_axes))


def rglru_sequential_ref(block: RGLRU, x):
    """Token-by-token oracle for tests (the conv and the recurrence, no
    gate): h (B,S,W) in f32."""
    xc, _ = causal_conv(block.conv_w, block.conv_b, x)
    a, b = block.coeffs(xc)
    h = torch.zeros((x.shape[0], a.shape[-1]), dtype=torch.float32,
                    device=x.device)
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
