"""Yi-34B [dense]: llama-arch GQA. [arXiv:2403.04652]
60L, d_model=7168, 56H (GQA kv=8, head_dim 128), d_ff=20480, vocab=64000.

The port's copy of the JAX package's ``configs/yi_34b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168, n_heads=56,
    n_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
    attention="polysketch", poly_degree=4, sketch_size=32,
    compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, sketch_size=8, lt_block_size=16,
    compute_dtype="float32", remat="none")
