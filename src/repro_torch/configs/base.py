"""Architecture and training configuration for the PyTorch port.

The port's own copies of ``ArchConfig`` and ``TrainConfig`` (the JAX
package's ``repro/configs/base.py``). ``ArchConfig`` is cut to the fields
the port reads, with the
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
    family: str                    # the port serves dense|ssm|hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # block structure: cycle of mixer kinds over layers
    block_pattern: tuple[str, ...] = ("attn",)   # attn|local_attn|rglru|ssd

    # attention mechanism for "attn" mixers (the paper's knob)
    attention: str = "polysketch"
    poly_degree: int = 4
    sketch_size: int = 32
    learned_sketch: bool = True
    local_exact: bool = True
    lt_block_size: int = 256
    qk_norm: bool = False          # per-head RMS q/k-norm over head_dim, before RoPE
    sliding_window: int = 2048     # for local_attn mixers
    use_rope: bool = True
    rope_theta: float = 10000.0

    ffn: str = "glu"

    # ssm (mamba2)
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # rglru (recurrentgemma)
    rglru_width: int = 0           # 0 -> d_model
    rglru_c: float = 8.0

    # numerics
    compute_dtype: str = "float32"
    remat: str = "none"            # none|dots|full
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


@dataclass
class TrainConfig:
    """Training-run hyperparameters (paper Section 4 recipe defaults), as
    the reference's. Its checkpoint and logging fields, which no step
    reads, are the launcher's flags here; its two sharded-gradient options
    wait for the port's data-parallel step."""
    seq_len: int = 512
    global_batch: int = 8
    steps: int = 100
    warmup_frac: float = 0.1
    peak_lr: float = 7e-4
    b1: float = 0.95
    b2: float = 0.98
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1
    seed: int = 0
