"""DBRX-132B [moe]: fine-grained MoE, 16 experts top-4, every layer.
[hf:databricks/dbrx-base] 40L, d_model=6144, 48H (GQA kv=8), d_ff=10752,
vocab=100352.

The port's copy of the JAX package's ``configs/dbrx_132b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=10752, vocab_size=100352, ffn="moe", n_experts=16,
    moe_top_k=4, moe_period=1, capacity_factor=1.25,
    attention="polysketch", poly_degree=4, sketch_size=32,
    compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=128,
    n_experts=4, moe_top_k=2, sketch_size=8, lt_block_size=16,
    compute_dtype="float32", remat="none")
