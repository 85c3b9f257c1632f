"""Architecture configuration for the PyTorch port.

The port's own copy of ``ArchConfig`` (the JAX package's
``repro/configs/base.py``), cut to the fields the port reads, with the
reference's names and defaults: one value means the same model in both
packages. A field the port does not serve is not here, so setting it
raises (``replace`` takes no unknown field); family, block pattern, FFN
and attention kinds other than the dense polysketch ones are rejected by
``models.transformer.check_supported``. The port imports nothing from
the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # the port serves "dense"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # block structure: cycle of mixer kinds over layers
    block_pattern: tuple[str, ...] = ("attn",)

    # attention mechanism for "attn" mixers (the paper's knob)
    attention: str = "polysketch"
    poly_degree: int = 4
    sketch_size: int = 32
    learned_sketch: bool = True
    local_exact: bool = True
    lt_block_size: int = 256
    qk_norm: bool = False          # per-head RMS q/k-norm (not ported)
    use_rope: bool = True
    rope_theta: float = 10000.0

    ffn: str = "glu"

    # numerics
    compute_dtype: str = "float32"
    tie_embeddings: bool = True
    norm: str = "rmsnorm"          # rmsnorm|layernorm

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attn_scale(self) -> float:
        """Scale applied inside the polynomial: (<q,k> * scale)^p."""
        return 1.0 / self.resolved_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
