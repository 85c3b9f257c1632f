"""StarCoder2-3B [dense]: GQA kv=2, RoPE. [arXiv:2402.19173]
30L, d_model=3072, 24H (head_dim 128), d_ff=12288, vocab=49152.

The port's copy of the JAX package's ``configs/starcoder2_3b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, head_dim=128, d_ff=12288, vocab_size=49152,
    norm="layernorm", attention="polysketch", poly_degree=4, sketch_size=32,
    compute_dtype="bfloat16", remat="dots",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, sketch_size=8, lt_block_size=16,
    compute_dtype="float32", remat="none")
