"""Model presets the torch port serves: plain Llama-family GQA shapes."""

from __future__ import annotations

from dynamo_tpu_torch.engine.config import ModelConfig

PRESETS = {
    "tiny": ModelConfig.tiny,
    "llama3_1b": ModelConfig.llama3_1b,
    "llama3_8b": ModelConfig.llama3_8b,
}


def get_model_config(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]()
    raise KeyError(f"unknown model preset '{name}' (have {sorted(PRESETS)})")
