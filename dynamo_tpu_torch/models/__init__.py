"""Model presets the torch port serves, copied from ``dynamo_tpu/models``:
Llama-family GQA shapes (Llama, Mistral's sliding window, Qwen2's q/k/v
biases, Qwen3's q/k norms, Mixtral and Qwen3-MoE experts) and the DeepSeek
MLA + MoE shapes. The JAX package has no Gemma preset; Gemma checkpoints
come through ``ModelConfig.from_hf_config``."""

from __future__ import annotations

from dynamo_tpu_torch.engine.config import ModelConfig


def mistral_7b() -> ModelConfig:
    return ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=10000.0,
        max_position_embeddings=32768, sliding_window=4096)


def qwen2_7b() -> ModelConfig:
    return ModelConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, rope_theta=1000000.0,
        max_position_embeddings=32768, qkv_bias=True)


def qwen3_8b() -> ModelConfig:
    return ModelConfig(
        vocab_size=151936, hidden_size=4096, intermediate_size=12288,
        num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, max_position_embeddings=40960, qk_norm=True)


def qwen3_moe_30b_a3b() -> ModelConfig:
    """Qwen3-30B-A3B: 128 experts, 8 active."""
    return ModelConfig(
        vocab_size=151936, hidden_size=2048, intermediate_size=6144,
        num_layers=48, num_heads=32, num_kv_heads=4, head_dim=128,
        rope_theta=1000000.0, max_position_embeddings=40960, qk_norm=True,
        num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
        norm_topk_prob=True)


def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1000000.0,
        max_position_embeddings=32768, num_experts=8, num_experts_per_tok=2,
        norm_topk_prob=True)  # Mixtral renormalizes the top-k gate probs


def moe_tiny() -> ModelConfig:
    """Small MoE for tests."""
    return ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, dtype="float32",
        num_experts=4, num_experts_per_tok=2, max_position_embeddings=512,
        norm_topk_prob=True)


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
    "llama3_70b": ModelConfig.llama3_70b,
    "mistral_7b": mistral_7b,
    "qwen2_7b": qwen2_7b,
    "qwen3_8b": qwen3_8b,
    "qwen3_moe_30b_a3b": qwen3_moe_30b_a3b,
    "mixtral_8x7b": mixtral_8x7b,
    "moe_tiny": moe_tiny,
    "mla_tiny": mla_tiny,
    "deepseek_v2_lite": deepseek_v2_lite,
}


def get_model_config(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]()
    raise KeyError(f"unknown model preset '{name}' (have {sorted(PRESETS)})")
