"""Llama-4 Maverick 400B-A17B [moe]: 128 routed experts, top-1, interleaved
MoE every 2nd layer (matches 400B total / 17B active).
[hf:meta-llama/Llama-4-*] 48L, d_model=5120, 40H (GQA kv=8), d_ff=8192,
vocab=202048.

The port's copy of the JAX package's
``configs/llama4_maverick_400b_a17b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202048, ffn="moe",
    n_experts=128, moe_top_k=1, moe_period=2, capacity_factor=1.25,
    attention="polysketch", poly_degree=4, sketch_size=32,
    compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=128,
    n_experts=8, moe_top_k=1, sketch_size=8, lt_block_size=16,
    compute_dtype="float32", remat="none")
