"""The paper's own GPT-2-style Transformer++ configs (Appendix H/I).

Small: 12L x 768 (110M); +1 layer for kernel-based attention variants as in
the paper. The port's copy of the JAX package's ``configs/gpt2_paper.py``.
"""
from repro_torch.configs.base import ArchConfig

_BASE = dict(family="dense", d_model=768, n_heads=12, n_kv_heads=12,
             head_dim=64, d_ff=3072, vocab_size=32000, use_rope=True,
             norm="layernorm", tie_embeddings=True)

GPT2_SMALL_SOFTMAX = ArchConfig(name="gpt2s-softmax", n_layers=12,
                                attention="softmax", **_BASE)
GPT2_SMALL_POLY4 = ArchConfig(name="gpt2s-poly4", n_layers=12,
                              attention="polynomial", poly_degree=4, **_BASE)
GPT2_SMALL_POLY8 = ArchConfig(name="gpt2s-poly8", n_layers=12,
                              attention="polynomial", poly_degree=8, **_BASE)
GPT2_SMALL_POLYSKETCH = ArchConfig(
    name="gpt2s-polysketch", n_layers=13, attention="polysketch",
    poly_degree=4, sketch_size=32, learned_sketch=True, local_exact=True,
    lt_block_size=1024, **_BASE)

CONFIG = GPT2_SMALL_POLYSKETCH
SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, vocab_size=128, sketch_size=8,
                       lt_block_size=16)
