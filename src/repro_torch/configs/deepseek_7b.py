"""DeepSeek-7B [dense]: llama-arch MHA (kv=32). [arXiv:2401.02954]
30L, d_model=4096, 32H (head_dim 128), d_ff=11008, vocab=102400.

The port's copy of the JAX package's ``configs/deepseek_7b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense", n_layers=30, d_model=4096, n_heads=32,
    n_kv_heads=32, head_dim=128, d_ff=11008, vocab_size=102400,
    attention="polysketch", poly_degree=4, sketch_size=32,
    compute_dtype="bfloat16", remat="dots",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=128, sketch_size=8, lt_block_size=16,
    compute_dtype="float32", remat="none")
