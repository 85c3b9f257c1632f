"""O(n^2) oracles for the port's kernels.

Port of the JAX package's ``kernels/ref.py`` (``lt_mult_ref``,
``polysketch_causal_ref``, ``poly_flash_ref``): written for clarity, not
speed.
"""
from __future__ import annotations

import torch

from repro_torch.core.poly_attention import poly_attention_full
from repro_torch.utils import int_pow


def lt_mult_ref(a, b, c):
    """lt(A B^T) C, the paper's Section 3.1 contract (diagonal included).

    a, b: (..., n, m); c: (..., n, k) -> (..., n, k), f32 accumulation.
    """
    w = a.float() @ b.float().transpose(-1, -2)
    w = w.tril()
    return (w @ c.float()).to(c.dtype)


def polysketch_causal_ref(qm, km, q, k, v, *, degree: int, scale: float,
                          block_size: int, local_exact: bool = True):
    """Same-block pairs use exact (<q,k>*scale)^degree weights (if
    local_exact) else the (L R^T)^2 sketched weights; cross-block pairs
    always use the sketched weights. qm, km: (..., n, r); q, k, v: (..., n, h).
    """
    n = qm.shape[-2]
    dev = qm.device
    sk = qm.float() @ km.float().transpose(-1, -2)
    sk = sk * sk
    if local_exact:
        ex = int_pow(q.float() @ k.float().transpose(-1, -2) * scale, degree)
    else:
        ex = sk
    blk = torch.arange(n, device=dev) // block_size
    same = blk[:, None] == blk[None, :]
    tri = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    w = torch.where(same, ex, sk) * tri
    den = 1.0 + w.sum(-1)
    out = (w @ v.float()) / den[..., None]
    return out.to(v.dtype)


def poly_flash_ref(q, k, v, *, degree: int, scale: float | None = None,
                   causal: bool = True):
    """Exact polynomial attention oracle (== core.poly_attention_full)."""
    return poly_attention_full(q, k, v, degree=degree, scale=scale,
                               causal=causal)
