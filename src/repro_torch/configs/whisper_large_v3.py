"""Whisper-large-v3 [audio]: encoder-decoder; conv/mel frontend STUBBED
(the caller supplies precomputed frame embeddings, ``frames``).
[arXiv:2212.04356] 32+32L, d_model=1280, 20H (head_dim 64), d_ff=5120,
vocab=51866. Decoder self-attention uses the paper's polysketch
mechanism; cross/encoder attention stays softmax (fixed 1500-frame
memory).

The port's copy of the JAX package's ``configs/whisper_large_v3.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_len=1500, cross_attention=True,
    use_rope=False, norm="layernorm",
    attention="polysketch", poly_degree=4, sketch_size=32,
    compute_dtype="bfloat16", remat="dots",
)

SMOKE = CONFIG.replace(
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=128, encoder_len=24, sketch_size=8,
    lt_block_size=16, compute_dtype="float32", remat="none")
