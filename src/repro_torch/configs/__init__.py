"""Config registry of the port: --arch <id> resolves here.

Every configuration of the JAX package's registry: the paper's model,
the dense polysketch models (GLU FFN, head width 128, bf16 at full
width), the two recurrent families (mamba2's SSD, and recurrentgemma's
RG-LRU with sliding-window attention), the two mixture-of-experts models
(dbrx's 16 experts top-4 in every layer, llama4-maverick's 128 experts
top-1 in every second layer), the VLM (llava-next-mistral-7b, image
embeddings over the first tokens) and the encoder-decoder
(whisper-large-v3, ``models/whisper.py``).
"""
from repro_torch.configs.base import ArchConfig, TrainConfig, effective_pattern

_MODULES = {
    "qwen3-14b": "qwen3_14b",
    "yi-34b": "yi_34b",
    "starcoder2-3b": "starcoder2_3b",
    "deepseek-7b": "deepseek_7b",
    "mamba2-780m": "mamba2_780m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-large-v3": "whisper_large_v3",
    "gpt2s-polysketch": "gpt2_paper",
}


def _module(name):
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, smoke: bool = False, **overrides) -> ArchConfig:
    mod = _module(name)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg


__all__ = ["ArchConfig", "TrainConfig", "effective_pattern", "get_config"]
