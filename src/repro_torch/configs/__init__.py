"""Config registry of the port: --arch <id> resolves here.

Only the configurations the port serves are registered.
"""
from repro_torch.configs.base import ArchConfig, TrainConfig

_MODULES = {
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


__all__ = ["ArchConfig", "TrainConfig", "get_config"]
