"""RecurrentGemma-9B [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427] 38L, d_model=4096, 16 heads (GQA kv=1, head_dim 256),
d_ff=12288, vocab=256000, sliding window 2048.

The port's copy of the JAX package's ``configs/recurrentgemma_9b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"), sliding_window=2048,
    attention="softmax", compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    vocab_size=128, sliding_window=32, compute_dtype="float32", remat="none")
