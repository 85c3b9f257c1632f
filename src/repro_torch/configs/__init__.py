"""Config registry of the port: --arch <id> resolves here.

Only the configurations the port serves are registered: the paper's
model, the registry's dense polysketch models (GLU FFN, head width 128,
bf16 at full width), its two recurrent families (mamba2's SSD, and
recurrentgemma's RG-LRU with sliding-window attention) and its two
mixture-of-experts models (dbrx's 16 experts top-4 in every layer,
llama4-maverick's 128 experts top-1 in every second layer).
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
