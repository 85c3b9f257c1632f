"""LLaVA-NeXT (Mistral-7B backbone) [vlm]: anyres tiling frontend STUBBED —
the caller supplies precomputed patch embeddings (``image_embeds``). Backbone:
[hf:llava-hf/llava-v1.6-mistral-7b-hf] 32L, d_model=4096, 32H (GQA kv=8),
d_ff=14336, vocab=32000.

The port's copy of the JAX package's ``configs/llava_next_mistral_7b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
    n_image_tokens=576, attention="polysketch", poly_degree=4, sketch_size=32,
    compute_dtype="bfloat16", remat="full",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
    n_image_tokens=8, sketch_size=8, lt_block_size=16,
    compute_dtype="float32", remat="none")
