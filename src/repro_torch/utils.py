"""Small shared utilities: self-tensoring, padding, integer powers, devices."""
from __future__ import annotations

import math

import torch
from torch import nn


def self_kron(x: torch.Tensor) -> torch.Tensor:
    """Self-tensoring x^{(x)2} over the last axis: (..., r) -> (..., r*r).

    <self_kron(a), self_kron(b)> == <a, b>**2 >= 0, the paper's
    non-negativity trick (Theorem 2.4).
    """
    r = x.shape[-1]
    out = x[..., :, None] * x[..., None, :]
    return out.reshape(*x.shape[:-1], r * r)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int
                    ) -> tuple[torch.Tensor, int]:
    """Zero-pad `axis` of x up to a multiple. Returns (padded, original_len)."""
    n = x.shape[axis]
    target = math.ceil(n / multiple) * multiple
    if target == n:
        return x, n
    shape = list(x.shape)
    shape[axis] = target - n
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def int_pow(x: torch.Tensor, p: int) -> torch.Tensor:
    """x**p for an integer p >= 1 by repeated squaring, in the order of
    XLA's integer_pow (x**4 == (x*x)*(x*x)), so the two frameworks round
    alike."""
    if p < 1:
        raise ValueError(f"int_pow needs p >= 1, got {p}")
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p > 0:
            x = x * x
    return acc


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and there is
    no card; never drops to the CPU on its own.

    Also pins float32 matrix products and convolutions to full float32
    (no TF32), the precision the port is held to.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def const_param(shape, value, *, device="cpu") -> nn.Parameter:
    """A float32 parameter filled with `value` (norm scales and biases)."""
    return nn.Parameter(torch.full(shape, float(value), dtype=torch.float32,
                                   device=device))


def normal_param(shape, std, *, generator=None, device="cpu") -> nn.Parameter:
    """N(0, 1) * std, drawn from a CPU `generator` and moved to `device`,
    so a seed gives the same weights on every device. Nothing is drawn on
    the meta device."""
    device = torch.device(device)
    if device.type == "meta":
        return nn.Parameter(torch.empty(shape, device=device))
    w = torch.empty(shape, dtype=torch.float32).normal_(generator=generator)
    return nn.Parameter((w * std).to(device))


def uniform_param(shape, bound, *, generator=None, device="cpu") -> nn.Parameter:
    """U(-bound, bound), drawn like normal_param."""
    device = torch.device(device)
    if device.type == "meta":
        return nn.Parameter(torch.empty(shape, device=device))
    w = torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound,
                                                         generator=generator)
    return nn.Parameter(w.to(device))
