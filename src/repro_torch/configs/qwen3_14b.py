"""Qwen3-14B [dense]: GQA + per-head q/k RMS norm. [hf:Qwen/Qwen3-*]
40L, d_model=5120, 40H (GQA kv=8, head_dim 128), d_ff=17408, vocab=151936.

The port's copy of the JAX package's ``configs/qwen3_14b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=17408, vocab_size=151936, qk_norm=True,
    attention="polysketch", poly_degree=4, sketch_size=32,
    compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, sketch_size=8, lt_block_size=16,
    compute_dtype="float32", remat="none")
