"""Architecture and training configuration for the PyTorch port.

The port's own copies of ``ArchConfig`` and ``TrainConfig`` (the JAX
package's ``repro/configs/base.py``). ``ArchConfig`` has the
reference's fields, names and defaults (but ``param_dtype``, which no
reference code reads: the port keeps every parameter in float32): one
value means the same model in both packages. A field the port does not
have raises (``replace`` takes no unknown field); block pattern, FFN and
attention kinds the port lacks are rejected by
``models.transformer.check_supported``. ``effective_pattern`` is the
reference's per-layer (mixer, FFN) cycle (``models/transformer.py``),
kept beside the config so that the bridge and the snapshot layout read
it too. The port imports nothing from the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
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

    # ffn
    ffn: str = "glu"               # glu|moe
    n_experts: int = 0
    moe_top_k: int = 0
    moe_period: int = 1            # MoE every k-th layer (llama4: 2)
    capacity_factor: float = 1.25
    moe_dispatch_groups: int = 1   # DP-shard-aligned dispatch groups (EP)

    # ssm (mamba2)
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # rglru (recurrentgemma)
    rglru_width: int = 0           # 0 -> d_model
    rglru_c: float = 8.0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_len: int = 1500
    cross_attention: bool = False

    # vlm
    n_image_tokens: int = 0

    # numerics
    compute_dtype: str = "float32"
    remat: str = "none"            # none|dots|full
    # the reference's lax.scan / Python-loop switch; the port's layers are
    # always a Python loop, so it changes nothing here
    unroll_layers: bool = False
    tie_embeddings: bool = True
    norm: str = "rmsnorm"          # rmsnorm|layernorm

    # router aux loss weights (MoE)
    router_aux_weight: float = 0.01
    router_z_weight: float = 0.001

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attn_scale(self) -> float:
        """Scale applied inside the polynomial: (<q,k> * scale)^p."""
        return 1.0 / self.resolved_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def effective_pattern(cfg) -> tuple[tuple[str, str], ...]:
    """Per-layer (mixer, ffn) cycle of length lcm(|pattern|, moe_period):
    with an MoE FFN, every moe_period-th layer's FFN is "moe" (llama4: the
    odd layers), the others' "glu"."""
    mixers = cfg.block_pattern
    period = cfg.moe_period if cfg.ffn == "moe" else 1
    g = math.lcm(len(mixers), period)
    return tuple((mixers[i % len(mixers)],
                  "moe" if cfg.ffn == "moe" and i % period == period - 1 else "glu")
                 for i in range(g))


@dataclass
class TrainConfig:
    """Training-run hyperparameters (paper Section 4 recipe defaults), as
    the reference's. Its checkpoint and logging fields, which no step
    reads, are the launcher's flags here, and so is its zero_grad_sync,
    which nothing reads; grad_compression picks the manual-DP step's
    gradient sync ("none": a mean all-reduce, "int8": the compressed one)."""
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
    grad_compression: str = "none"   # none|int8
