"""Mamba2-780m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060] 48L, d_model=1536, ssm_state=128, vocab=50280.

The port's copy of the JAX package's ``configs/mamba2_780m.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_ff=0, vocab_size=50280, block_pattern=("ssd",),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, use_rope=False,
    attention="softmax", compute_dtype="bfloat16", remat="dots",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, vocab_size=128,
    ssm_state=16, ssm_head_dim=16, compute_dtype="float32", remat="none")
