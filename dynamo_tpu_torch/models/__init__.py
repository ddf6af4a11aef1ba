"""Model presets the torch port serves: Llama-family GQA shapes and the
DeepSeek MLA + MoE shapes, copied from ``dynamo_tpu/models``."""

from __future__ import annotations

from dynamo_tpu_torch.engine.config import ModelConfig


def mla_tiny() -> ModelConfig:
    """Small MLA+MoE (DeepSeek-V3 shaped) for tests of the latent-cache path."""
    return ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=3,
        num_heads=4, num_kv_heads=4, dtype="float32",
        max_position_embeddings=512,
        kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
        n_shared_experts=1, first_k_dense_replace=1, scoring_func="sigmoid",
        norm_topk_prob=True, routed_scaling_factor=2.5, n_group=2,
        topk_group=1, moe_capacity_factor=4.0)


def deepseek_v2_lite() -> ModelConfig:
    """DeepSeek-V2-Lite (15.7B total / 2.4B active): MLA without q
    compression, softmax routing, 2 shared experts."""
    return ModelConfig(
        vocab_size=102400, hidden_size=2048, intermediate_size=10944,
        num_layers=27, num_heads=16, num_kv_heads=16, rope_theta=10000.0,
        max_position_embeddings=4096,
        kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128,
        num_experts=64, num_experts_per_tok=6, moe_intermediate_size=1408,
        n_shared_experts=2, first_k_dense_replace=1,
        scoring_func="softmax", norm_topk_prob=False,
        routed_scaling_factor=1.0)


PRESETS = {
    "tiny": ModelConfig.tiny,
    "llama3_1b": ModelConfig.llama3_1b,
    "llama3_8b": ModelConfig.llama3_8b,
    "mla_tiny": mla_tiny,
    "deepseek_v2_lite": deepseek_v2_lite,
}


def get_model_config(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]()
    raise KeyError(f"unknown model preset '{name}' (have {sorted(PRESETS)})")
