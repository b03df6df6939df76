"""Architecture registry: the 10 assigned archs + the paper's own models."""
from repro_torch.configs.base import ModelConfig, ParallelConfig  # noqa: F401

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "qwen1.5-4b": "qwen1_5_4b",
    "deepseek-67b": "deepseek_67b",
    "qwen3-14b": "qwen3_14b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-base": "whisper_base",
    "llama3.3-70b": "llama3_70b",
    "qwen2.5-72b": "qwen2_5_72b",
    "mixtral-8x22b": "mixtral_8x22b",
}

ASSIGNED = list(_MODULES)[:10]
PAPER_MODELS = list(_MODULES)[10:]


def get_config(name: str) -> ModelConfig:
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_configs():
    return list(_MODULES)
