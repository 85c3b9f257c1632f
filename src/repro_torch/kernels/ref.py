"""O(n^2) oracle for the port's causal polysketch kernel.

Port of ``polysketch_causal_ref`` in the JAX package's ``kernels/ref.py``:
written for clarity, not speed.
"""
from __future__ import annotations

import torch

from repro_torch.utils import int_pow


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
