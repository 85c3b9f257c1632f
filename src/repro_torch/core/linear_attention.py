"""Block-based causal linear attention (paper Sections 3.1 / 3.2).

Port of the JAX package's ``core/linear_attention.py``: the paper-faithful
block algorithm on the combined (r^2, h+1) prefix state. It is the plain
reference of what the port's CUDA kernel computes
(``kernels/polysketch_causal.py``). tests/test_torch_core.py holds it to
the JAX package; tests/test_torch_kernels.py holds the kernel's own
plain version (factored state) to it, z0 and returned state included.

Contract (single head; batched via leading dims):
  out_i = [ sum_{j<=i} w_ij v_j ] / (1 + sum_{j<=i} w_ij)
  w_ij  = (<q_i, k_j> * scale)^degree            if i,j in same block & local_exact
        = <m(q_i), m(k_j)>^2                     otherwise (sketched, scaled inputs)
"""
from __future__ import annotations

import torch

from repro_torch.utils import int_pow, self_kron


def _blockify(x, b):
    """(..., S, d) -> (..., t, b, d); S must be divisible by b."""
    *lead, s, d = x.shape
    if s % b:
        raise ValueError(f"seq {s} not divisible by block {b}")
    return x.reshape(*lead, s // b, b, d)


def block_causal_linear_attention(qm, km, v, q=None, k=None, *,
                                  degree: int = 4,
                                  scale: float | None = None,
                                  block_size: int = 256,
                                  local_exact: bool = True,
                                  z0=None,
                                  return_state: bool = False):
    """Causal polysketch attention via the paper's block algorithm (S3.1).

    qm, km: (..., S, r) degree-p/2 sketches (already include the scale).
    v:      (..., S, h)
    q, k:   (..., S, h) raw (post-LN) vectors; required iff local_exact.
    z0:     optional (..., r^2, h+1) initial prefix state Z_0.
    Returns (..., S, h), or (out, z_final) when return_state; z_final is
    the state after folding all blocks, added block by block, so resuming
    from it reproduces a one-shot run bit for bit.
    """
    *lead, s, r = qm.shape
    h = v.shape[-1]
    b = min(block_size, s)
    if local_exact:
        if q is None or k is None:
            raise ValueError("local_exact needs the raw q and k")
        if scale is None:
            scale = 1.0 / q.shape[-1]
    f32 = torch.float32
    qm_b = _blockify(qm, b)
    km_b = _blockify(km, b)
    v_b = _blockify(v, b)
    ones = v_b.new_ones((*v_b.shape[:-1], 1))
    vv_b = torch.cat([v_b, ones], dim=-1)                  # (..., t, b, h+1)
    if local_exact:
        q_b, k_b = _blockify(q, b), _blockify(k, b)
    tri = torch.ones(b, b, dtype=f32, device=qm.device).tril()

    if z0 is None:
        z = torch.zeros((*lead, r * r, h + 1), dtype=f32, device=qm.device)
    else:
        z = z0.to(f32).expand(*lead, r * r, h + 1)
    accs = []
    for i in range(s // b):
        qm_l, km_l = qm_b[..., i, :, :], km_b[..., i, :, :]
        vv_l = vv_b[..., i, :, :]
        # diagonal block P_l (exact local polynomial attention, S3.2)
        if local_exact:
            w = int_pow(q_b[..., i, :, :].float()
                        @ k_b[..., i, :, :].float().transpose(-1, -2) * scale,
                        degree)
        else:
            w = qm_l.float() @ km_l.float().transpose(-1, -2)
            w = w * w
        w = w * tri
        acc = w @ vv_l.float()
        # cross-block prefix through Z_l
        acc = acc + self_kron(qm_l.float()) @ z
        # state update
        z = z + self_kron(km_l.float()).transpose(-1, -2) @ vv_l.float()
        accs.append(acc)
    acc = torch.stack(accs, dim=-3)                        # (..., t, b, h+1)
    num, den = acc[..., :h], acc[..., h]
    out = num / (1.0 + den)[..., None]
    out = out.reshape(*lead, s, h).to(v.dtype)
    return (out, z) if return_state else out
