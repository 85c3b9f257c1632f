"""Polynomial sketches (paper Algorithms 1 & 2, Theorems 1.1 / 2.2 / 2.4).

The port of the JAX package's ``core/sketches.py``. The recursive sketch
tree is an ``nn.Module`` tree whose parameter names are the JAX tree paths
(``left``/``right``/``proj1``/``proj2``, then ``w1``, ``ln0_scale``, ...),
so a parameter's dotted name is its JAX path with ``/`` for ``.``.

- ``degree`` is the attention polynomial degree ``p`` (even, ``p/2`` a
  power of two); the recursion runs at ``p/2``.
- ``sketch_half`` returns m(x) in R^r with <m(q), m(k)>^2 ~= <q, k>^p.
- All attention heads share one sketch per layer (paper Section 4).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.utils import const_param, normal_param, uniform_param


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


# ---------------------------------------------------------------------------
# projections (Algorithm 1: random; Algorithm 2 / Appendix D: learned)
# ---------------------------------------------------------------------------


class RandomProjection(nn.Module):
    """x @ g with a frozen Gaussian g (the paper's "random" variant)."""

    def __init__(self, in_dim: int, r: int, *, generator=None, device="cpu"):
        super().__init__()
        self.g = normal_param((in_dim, r), 1.0, generator=generator,
                              device=device)
        self.g.requires_grad_(False)

    def forward(self, x):
        return x @ self.g.to(x.dtype)


def _ln(x, scale, bias, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class LearnedProjection(nn.Module):
    """f(x): LN -> Dense(8r) -> gelu -> Dense(r) -> LN -> Dense(8r) -> gelu
    -> Dense(r). Gelu is the tanh form, as jax.nn.gelu's default."""

    def __init__(self, in_dim: int, r: int, *, generator=None, device="cpu"):
        super().__init__()
        dense = lambda d_in, d_out: uniform_param(  # noqa: E731
            (d_in, d_out), 1.0 / math.sqrt(d_in), generator=generator,
            device=device)
        const = lambda dim, value: const_param(  # noqa: E731
            (dim,), value, device=device)
        self.ln0_scale = const(in_dim, 1.0)
        self.ln0_bias = const(in_dim, 0.0)
        self.w1 = dense(in_dim, 8 * r)
        self.b1 = const(8 * r, 0.0)
        self.w2 = dense(8 * r, r)
        self.b2 = const(r, 0.0)
        self.ln1_scale = const(r, 1.0)
        self.ln1_bias = const(r, 0.0)
        self.w3 = dense(r, 8 * r)
        self.b3 = const(8 * r, 0.0)
        self.w4 = dense(8 * r, r)
        self.b4 = const(r, 0.0)

    def forward(self, x):
        dt = x.dtype
        c = lambda p: p.to(dt)  # noqa: E731
        h = _ln(x, c(self.ln0_scale), c(self.ln0_bias))
        h = F.gelu(h @ c(self.w1) + c(self.b1), approximate="tanh")
        h = h @ c(self.w2) + c(self.b2)
        h = _ln(h, c(self.ln1_scale), c(self.ln1_bias))
        h = F.gelu(h @ c(self.w3) + c(self.b3), approximate="tanh")
        return h @ c(self.w4) + c(self.b4)


# ---------------------------------------------------------------------------
# recursive sketch tree
# ---------------------------------------------------------------------------


class SketchNode(nn.Module):
    """POLYSKETCH[WITH]NEGATIVITY (or its learned variant) at degree q:
    x -> x^{(x)q} S in R^r. A q == 1 node is the identity and holds no
    parameters (the empty dicts of the JAX tree)."""

    def __init__(self, in_dim: int, r: int, q: int, learned: bool, *,
                 generator=None, device="cpu"):
        super().__init__()
        self.q, self.learned = q, learned
        if q == 1:
            return
        kw = dict(generator=generator, device=device)
        self.left = SketchNode(in_dim, r, q // 2, learned, **kw)
        self.right = SketchNode(in_dim, r, q // 2, learned, **kw)
        proj_in = in_dim if q == 2 else r
        proj = LearnedProjection if learned else RandomProjection
        self.proj1 = proj(proj_in, r, **kw)
        self.proj2 = proj(proj_in, r, **kw)

    def forward(self, x):
        if self.q == 1:
            return x
        m1 = self.left(x)
        m2 = self.right(x)
        f1 = self.proj1(m1)
        f2 = self.proj2(m2)
        r = f1.shape[-1]
        if self.learned:
            z = math.sqrt(1.0 / r) * (f1 * f2)
            return math.sqrt(float(r)) * torch.tanh(z)
        return math.sqrt(1.0 / r) * (f1 * f2)


def init_sketch(h: int, r: int, degree: int, learned: bool, *,
                generator: torch.Generator | None = None,
                device="cpu") -> SketchNode:
    """The sketch tree at attention degree p (recursion at q = p/2)."""
    if degree % 2 or degree < 2:
        raise ValueError(f"degree must be even and >= 2, got {degree}")
    q = degree // 2
    if not _is_pow2(q):
        raise ValueError(f"degree/2 must be a power of two, got {q}")
    return SketchNode(h, r, q, learned, generator=generator, device=device)


def sketch_half(sketch: SketchNode, x, degree: int, learned: bool):
    """Degree-p/2 sketch m(x) in R^r with <m(q),m(k)>^2 ~= <q,k>^p."""
    if sketch.q != degree // 2 or sketch.learned != learned:
        raise ValueError(
            f"sketch built for q={sketch.q}, learned={sketch.learned}; "
            f"asked for degree={degree}, learned={learned}")
    return sketch(x)


def sketch_param_count(h: int, r: int, degree: int, learned: bool) -> int:
    q = degree // 2
    # projections with input dim h live at the q==2 recursion leaves; all
    # other (inner) nodes project r -> r.
    n_leaf_nodes = q // 2
    n_inner_nodes = (q - 1) - n_leaf_nodes
    n_proj_h = 2 * n_leaf_nodes
    n_proj_r = 2 * n_inner_nodes
    if learned:
        per_h = 2 * h + 8 * h * r + 8 * r + 8 * r * r + r + 2 * r + r * 8 * r + 8 * r + 8 * r * r + r
        per_r = 2 * r + 8 * r * r + 8 * r + 8 * r * r + r + 2 * r + r * 8 * r + 8 * r + 8 * r * r + r
        return n_proj_h * per_h + n_proj_r * per_r
    return n_proj_h * h * r + n_proj_r * r * r
